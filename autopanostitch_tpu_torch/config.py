"""Configuration of the stitcher: the JAX package's dataclass tree, copied.

The port keeps its own copy so that it imports nothing of `autopanostitch_tpu`;
names, fields and defaults are identical (the tests hold `dataclasses.asdict`
of both equal), and `convert.config` carries a JAX-side config across.

One frozen dataclass tree mirroring the reference's flat ``input.*`` struct
(reference: `Procedural Program/inputs.m:1-126`), grouped per stage. Field
names follow the reference where sensible so a user of the MATLAB pipeline
can map their configuration 1:1.

TPU-specific fields (capacities for fixed-shape/masked tensors, RANSAC batch
sizes, mesh axes) have no reference equivalent and are grouped in
:class:`TPUConfig`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _frozen(cls):
    return dataclasses.dataclass(frozen=True)(cls)


@_frozen
class DetectorConfig:
    """SIFT / feature-detector parameters (reference `inputs.m:31-41`)."""

    detector: str = "SIFT"  # 'SIFT' | 'HARRIS' | 'ORB' | 'BRISK' | 'FAST' | 'SURF'
    sigma: float = 1.6  # inputs.m:34
    num_layers_in_octave: int = 4  # inputs.m:35 (s: DoG layers usable per octave)
    contrast_threshold: float = 0.00133  # inputs.m:36
    edge_threshold: float = 6.0  # inputs.m:40
    # TPU capacities (no reference equivalent: MATLAB returns ragged lists)
    max_keypoints: int = 2048  # per-image keypoint capacity
    num_octaves: int = 5
    # descriptor geometry (Lowe's defaults, matching detectSIFTFeatures)
    descriptor_width: int = 4  # 4x4 spatial bins
    descriptor_bins: int = 8  # 8 orientation bins -> 128-d
    # run octave -1 (2x upsampled base). The reference's detectSIFTFeatures
    # (OpenCV/VLFeat lineage) always upsamples; None = auto — one 2x level
    # (octave -1) when the largest valid image dimension is below
    # `upsample_below` px, and a SECOND level (octave -2) below
    # `upsample_second_below` px. The extra octaves are what make small
    # real photos (capture-rig thumbnails, low-res sets) yield enough
    # keypoints to verify — measured on the reference's Rio sheet (56 real
    # ~78 px photos): one level connects 41/56 images, two levels 52/56 —
    # while 800px-limit inputs keep the cheaper non-upsampled path
    # (measured equal acceptance on 800px sets, ~4x extraction cost per
    # level if upsampled). The second level is reserved for the
    # thumbnail regime: it costs 4x the first, and at >=100 px one level
    # already resolves the verification-limiting scales.
    upsample_input: Optional[bool] = None
    upsample_below: int = 300
    upsample_second_below: int = 100


@_frozen
class MatchingConfig:
    """Feature matching (reference `inputs.m:44-59`)."""

    k: int = 4  # Brown-Lowe k=4 nearest neighbours (inputs.m:44)
    match_pairwise: bool = False  # inputs.m:46 matchFeaturesPairwise
    # automatic escape hatch for the global matcher's repeated-structure
    # failure mode: when panorama discovery fragments (more than one
    # component), re-match every pair with the per-pair matcher and keep
    # whichever graph connects more images. The reference offers the same
    # remedy only as the manual matchFeaturesPairwise flag. Bounded by
    # pairwise_rescue_max_images (the pairwise matcher is O(N^2) pairs).
    pairwise_rescue: bool = True
    pairwise_rescue_max_images: int = 64
    # above pairwise_rescue_max_images the rescue does NOT give up: it
    # switches from all-pairs re-matching to a bounded candidate set —
    # the top pairwise_rescue_m neighbours per image ranked by raw
    # global-kNN votes (ops/matching.knn_votes; the pre-ratio-test signal
    # stays strong exactly when the ratio test starves) plus every
    # already-accepted pair — keeping the rescue O(N*m) pairs at any N
    pairwise_rescue_m: int = 8
    # Lowe ratio used by the rescue's per-pair re-match. The rescue runs
    # precisely when the strict pooled test starved the graph, so it
    # matches at Lowe's classic per-pair operating point (0.8, the IJCV
    # paper's value) instead of the pooled threshold: on low-texture
    # scenes (~60 keypoints/view) the extra true matches are what lift a
    # 10-match boundary past the `ni > 8 + 0.3 nf` acceptance floor.
    # False matches stay RANSAC/acceptance-gated, and the rescued graph
    # is still adopted only if it connects more images.
    pairwise_rescue_ratio: float = 0.8
    # second per-component matching pass (imageMatchingPanoramaConComps
    # re-extract/re-match, inputs.m:105 resizeImagePanoramaCluster): after
    # panorama discovery, re-match each component's members pairwise (the
    # global ratio test starves repeated-structure pairs; pairwise recovers
    # denser match lists for BA)
    second_pass: bool = True
    # full reference second pass: re-resize each component's ORIGINAL
    # images to the render height/width limits, re-extract features and
    # re-verify (`imageMatchingPanoramaConComps.m:48-90`). Requires the
    # ImageSet to carry originals or paths (load_image_set
    # keep_originals=True); falls back to re-matching existing features.
    resize_panorama_cluster: bool = True
    # 'exhaustive' (exact MXU all-pairs) | 'approximate' (inputs.m:48): the
    # FLANN analog — 32-d random-projection sketch prefilter + exact
    # re-rank of the top sketch candidates (ops/matching.global_knn).
    # Applies to the pooled global matcher; the pairwise matcher is always
    # exact. Measured at 50k-500k pooled descriptors on the chip
    # (docs/results/approx_match.json): the sketch path is 4-5x SLOWER
    # than exact at 96-97% accepted-match recall — the flag exists for
    # API parity with the reference; 'exhaustive' is strictly dominant.
    method: str = "exhaustive"
    # Match threshold (inputs.m:52, matchFeaturesScratch.m:177-178): for
    # float descriptors a raw-SSD cut (unit-norm SIFT -> SSD in [0,4]); for
    # binary descriptors percent mismatched bits. None = the scratch
    # matcher's per-type defaults (float: no cut; binary: 10 percent,
    # matchFeaturesScratch.m:93-100). Applies to the PAIRWISE matcher only,
    # like the reference (the global path is ratio-test only).
    threshold: Optional[float] = None
    ratio_threshold: float = 0.6  # Lowe ratio (inputs.m:56)
    max_matches_per_pair: int = 512  # TPU capacity for per-pair match lists


@_frozen
class ImageMatchConfig:
    """Geometric verification (reference `inputs.m:61-74`)."""

    method: str = "ransac"  # 'ransac' | 'mlesac' (inputs.m:63)
    m_brown_lowe: int = 6  # candidate matches per image (inputs.m:65)
    # RANSAC hypothesis budget: total trials = min(max_iter, N(confidence))
    # where N is the log(1-p)/log(1-w^s) trial-count formula at the design
    # inlier ratio 0.3 (estimateTransformationRANSAC.m:124-131; see
    # ops/ransac.num_trials). Trials run in sub-batches of ransac_batch.
    max_iter: int = 500  # inputs.m:68
    max_distance: float = 5.5  # inlier distance in px (inputs.m:69)
    inliers_confidence: float = 99.9  # inputs.m:72
    transformation_type: str = "projective"  # inputs.m:73
    # Brown-Lowe probabilistic match acceptance: ni > alpha + beta * nf.
    # None = auto-dispatch on transformation_type (imageMatching.m:38-42):
    # projective (8, 0.3); affine (5, 0.15);
    # rigid/similarity/translation (5, 0.025).
    accept_alpha: Optional[float] = None
    accept_beta: Optional[float] = None
    # Small-sample perfect-consensus acceptance (beyond the reference): a
    # pair ALSO passes when ni >= accept_small_min AND
    # ni >= accept_small_ratio * nf. The Brown-Lowe linear rule is the
    # exact binomial likelihood-ratio test at p1=0.6/p0=0.1 (IJCV'07
    # Sec 3.2; the linearized constants 8 + 0.3nf ARE the exact test), so
    # its +8 intercept rejects starved-texture pairs whose evidence is
    # overwhelming — e.g. 10 matches, 10 inliers: P(Binom(10, p0) >= 10)
    # ~ 1e-10 yet 10 < 8 + 0.3*10. The branch only matters for nf <= 13
    # (above that, 0.9*nf exceeds 8 + 0.3*nf). Evidence counting (ADVICE
    # r3): the minimal sample fits min_pts inliers EXACTLY and RANSAC
    # maximizes over hundreds of hypotheses, so only ni - min_pts inliers
    # are independent evidence — the verifier enforces an effective floor
    # of model_min_pts + 5 (projective: 9) regardless of this setting.
    # accept_small_min=None disables (exact reference behavior,
    # imageMatching.m:150).
    accept_small_min: Optional[int] = 8
    accept_small_ratio: float = 0.9
    ransac_batch: int = 512  # hypotheses evaluated in parallel (TPU)
    refine_irls_iters: int = 3  # weighted-DLT refit iterations on inliers
    # Two-phase adaptive budget (the batched analog of the reference's
    # adaptive trial count via computeLoopNumber,
    # `estimateTransformationRANSAC.m:124-131`): every pair gets
    # adaptive_first_batch hypotheses; only pairs whose
    # log(1-p)/log(1-w^s) requirement at the OBSERVED inlier ratio w
    # exceeds it get the rest of the budget, continuing the same
    # hypothesis stream (ops/ransac.verify_pairs). None = single phase.
    # Default None: on the relay-attached bench the per-DISPATCH overhead
    # (~0.15-0.2 s) dwarfs the hypothesis compute it saves — measured
    # pano100: single-phase one-chunk 0.42 s vs adaptive 0.94 s despite
    # 45% fewer trials (docs/ROUND5.md). On a directly-attached chip the
    # trial savings win; flip this to ~64 there.
    adaptive_first_batch: Optional[int] = None


@_frozen
class BundleConfig:
    """Bundle adjustment (reference `inputs.m:76-86`)."""

    max_iter_lm: int = 40  # inputs.m:77
    lambda0: float = 1e-3  # inputs.m:78
    sigma_huber: float = 2.0  # inputs.m:79
    focal_estimate_method: str = "shumSzeliskiOneHPaper"  # inputs.m:82
    residual_one_direction: bool = False  # inputs.m:84
    max_matches: int = 300  # per-edge match cap (inputs.m:85)
    # over-cap match subsampling (`bundleAdjustmentRKf.m subsampleMatches`
    # :1047-1352): 'random' (deterministic per-pair stream, default) |
    # 'grid' (stratified over a rows x cols grid on image i) |
    # 'polar' (stratified by angle/radius around the principal point) —
    # stratification keeps subsampled matches covering the whole overlap
    subsample_mode: str = "random"
    subsample_grid_bins: Tuple[int, int] = (4, 4)  # [rows, cols]
    subsample_polar_bins: Tuple[int, int] = (12, 5)  # [nAngles, nRadii]
    incremental_lm_iters: int = 8  # LM iters per incremental step (TPU)
    # Per-iteration focal step cap DURING incremental growth (beyond the
    # reference, which lets every incremental LM move f 0.5-2%/iter like
    # the final passes and documents the consequence as BA-divergence
    # artifacts, README.md:194): on partial graphs — open yaw chains
    # before loop closure / cross-row edges activate — f is nearly
    # unobservable and random-walks (measured: a clean 2-row rig drifted
    # f 399 -> 558 at 100x the attainable cost). Growth phases are for
    # placing ROTATIONS; the staged final passes (focal_step_fracs, full
    # graph) own the focal estimate and allow ~50% cumulative movement.
    incremental_focal_frac: float = 0.001
    # priors (bundleAdjustmentRKf.m buildBrownLowePrior :1503-1637)
    theta_prior: float = 3.141592653589793 / 16.0
    focal_prior_frac: float = 20.0  # prior sigma = mean_f / 20
    # focal-smoothness coupling between index-adjacent cameras; None = the
    # reference's 'auto' rule (bundleAdjustmentRKf.m:485-497): short chains
    # (f0/20)^2*0.5, long chains (f0/50)^2*2.0. 0 disables.
    focal_smoothness_weight: Optional[float] = None
    focal_mean_weight: float = 50.0  # global focal-mean coupling (:77)
    focal_clamp: Tuple[float, float] = (100.0, 5000.0)
    max_rotation_step_deg: float = 5.0
    focal_step_fracs: Tuple[float, float, float] = (0.005, 0.01, 0.02)
    # Estimate per-camera radial distortion k1 jointly with R, f (a 5th
    # BA parameter; see models/bundle.Cameras.k1). Beyond the reference:
    # without it a barrel lens biases f (the sweep's dominant artifact
    # class — near-360 arcs whose ends collide). DEFAULT ON since round 4
    # (VERDICT r3 item 5): with it off the default pipeline exceeds 3%
    # focal error on 29/56 randomized scenes with consumer-lens barrel
    # distortion (docs/results/robustness_r3_baseline.json), while on
    # clean pinhole scenes k1 estimates ~0 at unchanged fidelity
    # (tests/test_bundle.py). Cost: one extra BA parameter (pd=5) and the
    # distortion-aware sampler in bounds/render/gain — quantified in
    # docs/ROUND4.md. False = the reference's exact pinhole model and
    # bit-identical render paths.
    estimate_distortion: bool = True
    # homography-BA (planar path) options, `bundleAdjustmentH.m`:
    # L2 penalty on the projective row H31/H32 (RegProj, default 1e-4,
    # parseOpts :997) and on log|det| of the top-left 2x2 (RegDet, :30,
    # default 0) — both true residuals in the objective, not damping.
    reg_proj: float = 1e-4
    reg_det: float = 0.0
    # True (reference default, :123 and parseOpts :1001): unidirectional
    # canvas-space residual Pi(G_i u_i) - Pi(G_j u_j); False: bidirectional
    # chain residual through G_j^-1 G_i (`computeBidirResiduals` :592-683).
    h_one_direction: bool = True


@_frozen
class StraightenConfig:
    """Straightening (reference `inputs.m:88-91`)."""

    enabled: bool = True
    up_angle_thresholds: Tuple[float, float, float] = (60.0, 60.0, 105.0)
    theta_threshold: float = 90.0
    force_planar_scan: bool = False


@_frozen
class GainConfig:
    """Gain compensation (reference `inputs.m:93-96`)."""

    enabled: bool = True
    sigma_n: float = 10.0
    sigma_g: float = 0.1
    grid_stride: int = 5  # gainCompensationRKf.m:100-109 subsample stride
    clamp: Tuple[float, float] = (0.25, 4.0)


@_frozen
class BlendConfig:
    """Blending (reference `inputs.m:98-101`)."""

    mode: str = "multiband"  # 'multiband' | 'linear' | 'none'
    bands: int = 3
    mbb_sigma: float = 1.0
    compose_none_policy: str = "last"  # 'last' | 'first' | 'maxangle'


@_frozen
class RenderConfig:
    """Rendering (reference `inputs.m:103-113` and renderPanorama.m:41-71)."""

    projections: Tuple[str, ...] = ("spherical",)
    # resize inputs into (height_limit, width_limit) at load (inputs.m:104
    # resizeImage); False = stitch at native resolution (CLI --no-resize)
    resize_image: bool = True
    height_limit: int = 800
    width_limit: int = 800
    angle_power: float = 1.0
    margin: float = 0.01
    max_megapixel: float = 50.0
    # percentile clip for planar/stereographic bounds (`planarBounds`)
    robust_pct: Tuple[float, float] = (1.0, 99.0)
    uv_abs_cap: float = 8.0
    pixel_pad: float = 24.0
    auto_ref: bool = True
    crop_border: bool = True
    # FIXED render tile shape (canvas padded up to tile multiples; the
    # padding tiles are skipped on device and trimmed on host). Fixed —
    # not fitted to the canvas — so the expensive tile-render executable
    # is shared across datasets/canvases (utils/buckets.py rationale);
    # (96, 384) keeps the worst-case dead fraction of typical panorama
    # extents under ~10%
    tile: Tuple[int, int] = (96, 384)
    # per-tile contributor cap: only the C best-overlapping images are
    # sampled per canvas tile (render cost is O(canvas x C)). None (the
    # default) sizes C automatically from the tiles' needs — a yaw ring
    # settles near 6 (which also measured BETTER PSNR than 8: far
    # off-axis cameras add misregistration blur), a 4-row rig gets the
    # ~12 it needs for full coverage. Set an int to pin it.
    max_contributors: Optional[int] = None
    # 'black' | 'white' fill for uncovered canvas (inputs.m canvasColor)
    canvas_color: str = "black"
    # resampling filter in the compositing gather ('nearest' | 'bilinear' |
    # 'bicubic' | 'bicubic2x'), mirroring `imageWarp.m:108-302`. Bicubic
    # costs ~4x the gather work of bilinear but noticeably sharpens
    # resampled texture (the round-1 PSNR blocker was bilinear softness).
    # 'bicubic2x' (default) = bicubic-upsample the contributors 2x (dense,
    # gather-free) then take 4 bilinear taps on the fine grid: measured
    # PSNR-identical to 'bicubic' (50.60 dB both, pano100 render) at
    # 0.35 s vs 0.74 s — gather cost scales with tap positions.
    interpolation: str = "bicubic2x"


@_frozen
class PostConfig:
    """Post-processing (reference `inputs.m:115-125`)."""

    black_range: int = 0
    white_range: int = 250
    crop_panorama: bool = False
    image_write: bool = False
    image_save_folder: str = "./results"
    show_keypoints_plot: bool = False  # inputs.m:119 (keypoint overlays)
    show_adjacency_graph: bool = False  # inputs.m:74 (match-graph plot)
    show_panorama_imgs_nums: bool = False  # inputs.m:121
    show_crop_bounding_box: bool = False  # inputs.m:122


@_frozen
class TPUConfig:
    """TPU-native execution knobs (no reference equivalent)."""

    # dtype of the descriptor-distance cross-term matmuls ('float32' |
    # 'bfloat16'); bf16 halves MXU time and HBM traffic for matching at a
    # small distance-precision cost (accumulation is always f32)
    compute_dtype: str = "float32"
    match_block: int = 1024  # query block in streaming top-k matching
    mesh_axis: str = "data"  # mesh axis name for image/pair sharding


@_frozen
class StitchConfig:
    """Top-level configuration (mirrors `inputs.m` as a whole)."""

    detector: DetectorConfig = DetectorConfig()
    matching: MatchingConfig = MatchingConfig()
    image_match: ImageMatchConfig = ImageMatchConfig()
    bundle: BundleConfig = BundleConfig()
    straighten: StraightenConfig = StraightenConfig()
    gain: GainConfig = GainConfig()
    blend: BlendConfig = BlendConfig()
    render: RenderConfig = RenderConfig()
    post: PostConfig = PostConfig()
    tpu: TPUConfig = TPUConfig()

    def replace(self, **kw) -> "StitchConfig":
        return dataclasses.replace(self, **kw)


def default_config() -> StitchConfig:
    return StitchConfig()
