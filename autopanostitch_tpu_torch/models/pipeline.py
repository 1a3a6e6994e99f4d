"""End-to-end stitching pipeline on PyTorch (port of `models/pipeline.py`).

Features (SIFT, the corner detectors with 256-bit binary descriptors, SURF's
determinant of Hessian or KAZE) -> pooled k-NN matching + ratio test (or
pairwise matching; binary descriptors take Hamming semantics) -> top-m
candidate pairs -> batched RANSAC or MLESAC of any of the five
transformation models, with the adaptive two-phase budget as an option,
and Brown-Lowe acceptance -> connected
components -> the pairwise rescue of a suspiciously fragmented graph ->
per component: the second matching pass (re-resize + re-extract +
re-match, or a pairwise re-match) -> incremental R, f, k1 bundle adjustment
-> straightening -> gain compensation -> render in every configured
projection -> crop; or, for a planar scan, 8-DOF homography bundle
adjustment -> planar gains -> planar compositing -> crop.

Every pairwise re-match runs on kernel B1's pair-list mode. Randomness:
the first verification draws from a torch.Generator seeded with `seed`;
where the reference folds its key with a tag (1: the pairwise second pass,
2: the re-extracting second pass, 3: the rescue), the port seeds a fresh
generator from (seed, tag) (`derived_generator`), so each of those draws
starts from the same state for every component, as the reference's folded
keys do.

Every matcher takes `cfg.tpu.compute_dtype` ("float32" or "bfloat16") for
its distances' cross term, as the reference does. With `cache_dir`, the
features, the post-rescue match graph and each component's bundle
adjustment are saved to and resumed from npz files under the reference's
keys (`utils/cache.py`). `cfg.post.show_panorama_imgs_nums` adds each
projection drawn with the images' outlines and numbers
(`projections_annotated`, `models/annotate.py`). `_check_supported`
refuses, before any work, what neither package takes (a matching method or
compute dtype) and what the card's kernels do not take (k > 16, widths
above 256, descriptor grids beyond B2's).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List

import numpy as np
import torch

from autopanostitch_tpu_torch import device as device_mod
from autopanostitch_tpu_torch.config import StitchConfig
from autopanostitch_tpu_torch.kernels import knn, sift_window
from autopanostitch_tpu_torch.models import annotate as annotate_stage
from autopanostitch_tpu_torch.models import bundle as bundle_stage
from autopanostitch_tpu_torch.models import bundle_h as bundle_h_stage
from autopanostitch_tpu_torch.models import crop as crop_stage
from autopanostitch_tpu_torch.models import features as features_stage
from autopanostitch_tpu_torch.models import gain as gain_stage
from autopanostitch_tpu_torch.models import planar as planar_stage
from autopanostitch_tpu_torch.models import render as render_stage
from autopanostitch_tpu_torch.models import straighten as straighten_stage
from autopanostitch_tpu_torch.ops import matching as mt
from autopanostitch_tpu_torch.ops import ransac as rs
from autopanostitch_tpu_torch.ops import sampling as samp_ops
from autopanostitch_tpu_torch.ops.sift import SiftFeatures
from autopanostitch_tpu_torch.parallel import sharded
from autopanostitch_tpu_torch.utils import image_io, trace
from autopanostitch_tpu_torch.utils.cache import StageCache, fingerprint
from autopanostitch_tpu_torch.utils.image_io import ImageSet


@dataclasses.dataclass
class MatchGraph:
    """Verified image-match graph (numpy arrays)."""

    pairs: np.ndarray  # (P, 2) candidate pairs (i < j)
    pair_idx: np.ndarray  # (P, M, 2) local feature index pairs
    pair_mask: np.ndarray  # (P, M)
    H: np.ndarray  # (P, 3, 3) homography i -> j
    inliers: np.ndarray  # (P, M) bool
    num_inliers: np.ndarray  # (P,)
    accepted: np.ndarray  # (P,) bool
    counts: np.ndarray  # (N, N) putative counts


@dataclasses.dataclass
class StitchResult:
    panoramas: List[Dict]
    graph: MatchGraph
    components: np.ndarray
    features: SiftFeatures


class StageTimer:
    """Seconds per named stage, read from the tracer's stage spans
    (`utils/trace.stage`). On a CUDA device a stage's seconds are the
    stream time between CUDA events recorded where the host enters and
    leaves it, so the timer adds no synchronize and the stitch overlaps as
    it does untimed; they are resolved when read, after the caller's own
    sync at the end of the stitch. Without a device, host seconds."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.spans: List[trace.Span] = []

    @contextlib.contextmanager
    def stage(self, name: str):
        with trace.stage(name, self.device) as sp:
            yield
        self.spans.append(sp)

    @property
    def durations(self) -> List[tuple]:
        return [(sp.name, sp.seconds()) for sp in self.spans]

    def report(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self.durations:
            out[name] = out.get(name, 0.0) + dt
        return out


def _stage(timer, name: str):
    return timer.stage(name) if timer is not None else trace.span(name)


def derived_generator(device, seed: int, tag: int) -> torch.Generator:
    """A torch.Generator on `device` seeded from (seed, tag): the port's
    counterpart of the reference's `jax.random.fold_in(key, tag)`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([int(seed), int(tag)]).generate_state(1, np.uint64)[0]))
    return g


def _matcher_semantics(cfg: StitchConfig):
    """(threshold, binary) for the descriptor type of cfg.detector: binary
    corner descriptors take linear-ratio and percent-bits semantics, and a
    threshold of None means no cut for float descriptors, 10 percent of the
    bits for binary ones."""
    binary = cfg.detector.detector.upper() in features_stage.BINARY_DETECTORS
    threshold = cfg.matching.threshold
    if threshold is None:
        threshold = 10.0 if binary else float("inf")
    return float(threshold), binary


def _all_pairs_graph(desc, mask, cfg: StitchConfig, ratio: float):
    """Pairwise-match every i < j image pair on B1's pair mode. Returns
    (pairs, pair_idx, pair_mask, counts (P,)) numpy."""
    threshold, binary = _matcher_semantics(cfg)
    with trace.span("matching.knn"):
        pairs, idx, m, n = mt.match_all_pairs(desc, mask, ratio=ratio,
                                              max_matches=cfg.matching.max_matches_per_pair,
                                              threshold=threshold, binary=binary,
                                              compute_dtype=cfg.tpu.compute_dtype)
        return pairs, idx.cpu().numpy(), m.cpu().numpy(), n.cpu().numpy()


def match_features(feats: SiftFeatures, cfg: StitchConfig, mesh=None):
    """Feature matching: (pairs, pair_idx, pair_mask, counts, votes). Global
    pooled mode (default): votes is a lazy zero-argument callable giving the
    raw (N, N) kNN votes. Pairwise mode (`match_pairwise`): every pair on
    B1's pair mode, and votes are the putative counts. With a
    `parallel.mesh.Mesh`, the pooled mode always, its queries split across
    the ranks (`sharded_global_knn`: exhaustive float32, as the
    reference's)."""
    N, K, D = feats.desc.shape
    if cfg.matching.match_pairwise and mesh is None:
        pairs, idx, m, n = _all_pairs_graph(feats.desc, feats.mask, cfg,
                                            cfg.matching.ratio_threshold)
        counts = np.zeros((N, N), np.int32)
        counts[pairs[:, 0], pairs[:, 1]] = n
        counts += counts.T
        keep = n > 0
        return pairs[keep], idx[keep], m[keep], counts, counts
    binary = _matcher_semantics(cfg)[1]
    F = N * K
    with trace.span("matching.knn"):
        if mesh is None:
            nn_idx, nn_dist, best, accepted = mt.global_match_stack(
                feats.desc, feats.mask, k=cfg.matching.k, method=cfg.matching.method,
                ratio=cfg.matching.ratio_threshold, binary=binary,
                compute_dtype=cfg.tpu.compute_dtype, block=cfg.tpu.match_block,
            )
        else:
            ids = torch.arange(N, dtype=torch.int32, device=feats.desc.device).repeat_interleave(K)
            nn_idx, nn_dist = sharded.sharded_global_knn(
                feats.desc.reshape(N * K, D), feats.mask.reshape(N * K), ids, mesh,
                k=cfg.matching.k)
            best, accepted = mt.global_ratio_test(nn_idx, nn_dist,
                                                  ratio=cfg.matching.ratio_threshold,
                                                  binary=binary)
        best_h = np.clip(best.cpu().numpy(), 0, max(F - 1, 0))
        accepted_h = accepted.cpu().numpy()
    image_id = np.repeat(np.arange(N, dtype=np.int32), K)
    local_idx = np.tile(np.arange(K, dtype=np.int32), N)
    with trace.span("matching.select"):
        out = mt.global_matches_to_pairs(best_h, accepted_h, image_id, local_idx, N,
                                         cfg.matching.max_matches_per_pair)
    memo = {}

    def votes_fn():
        if "v" not in memo:
            memo["v"] = mt.knn_votes(np.clip(nn_idx.cpu().numpy(), 0, max(F - 1, 0)),
                                     nn_dist.cpu().numpy(), image_id, N)
        return memo["v"]

    return out + (votes_fn,)


def select_candidate_pairs(pairs, pair_idx, pair_mask, counts, m: int):
    """Brown-Lowe top-m candidate pair filter."""
    n = counts.shape[0]
    sym = counts.copy()
    np.fill_diagonal(sym, 0)
    cand = np.zeros((n, n), bool)
    top = np.argsort(-sym, axis=1)[:, : min(m, n - 1)]
    for i in range(n):
        for j in top[i]:
            if sym[i, j] > 0:
                cand[i, j] = True
    cand = cand | cand.T
    keep = np.array([bool(cand[i, j]) for i, j in pairs])
    return pairs[keep], pair_idx[keep], pair_mask[keep]


_ACCEPT_CONSTANTS = {
    "projective": (8.0, 0.3),
    "affine": (5.0, 0.15),
    "similarity": (5.0, 0.025),
    "rigid": (5.0, 0.025),
    "translation": (5.0, 0.025),
}


def _acceptance(im) -> tuple:
    a, b = _ACCEPT_CONSTANTS[im.transformation_type]
    if im.accept_alpha is not None:
        a = im.accept_alpha
    if im.accept_beta is not None:
        b = im.accept_beta
    return a, b


def verify_matches(feats: SiftFeatures, pairs, pair_idx, pair_mask, counts,
                   cfg: StitchConfig, generator: torch.Generator, mesh=None) -> MatchGraph:
    """RANSAC verification of the candidate pairs -> MatchGraph. With a
    `parallel.mesh.Mesh`, the pairs split across its ranks
    (`sharded_verify_pairs`: a fixed budget, as the reference's)."""
    xy = feats.xy.cpu().numpy()
    src = xy[pairs[:, 0][:, None], pair_idx[:, :, 0]]
    dst = xy[pairs[:, 1][:, None], pair_idx[:, :, 1]]
    im = cfg.image_match
    alpha, beta = _acceptance(im)
    kw = dict(threshold=im.max_distance, model=im.transformation_type, method=im.method,
              batch=im.ransac_batch, accept_alpha=alpha, accept_beta=beta,
              accept_small_min=im.accept_small_min, accept_small_ratio=im.accept_small_ratio,
              total=rs.num_trials(im.inliers_confidence, im.transformation_type, im.max_iter))
    if mesh is None:
        out = rs.verify_pairs(src, dst, np.asarray(pair_mask), generator=generator,
                              adaptive_first=im.adaptive_first_batch,
                              confidence=im.inliers_confidence, device=feats.xy.device, **kw)
    else:
        out = sharded.sharded_verify_pairs(src, dst, pair_mask, generator, mesh, **kw)
    return MatchGraph(pairs=pairs, pair_idx=pair_idx, pair_mask=pair_mask, H=out["H"],
                      inliers=out["inliers"], num_inliers=out["num_inliers"],
                      accepted=out["accepted"], counts=counts)


def _votes_arr(votes):
    return votes() if callable(votes) else votes


def _vote_candidate_pairs(votes: np.ndarray, m: int) -> np.ndarray:
    """Top-m neighbours per image by kNN votes -> (P, 2) i < j pair list."""
    n = votes.shape[0]
    cand = np.zeros((n, n), bool)
    top = np.argsort(-votes, axis=1)[:, : min(m, n - 1)]
    rows = np.repeat(np.arange(n), top.shape[1])
    cols = top.ravel()
    sel = votes[rows, cols] > 0
    cand[rows[sel], cols[sel]] = True
    cand = cand | cand.T
    iu, ju = np.nonzero(np.triu(cand, 1))
    return np.stack([iu, ju], 1).astype(np.int32)


def _rescue_suspicious(comps: np.ndarray, votes, graph: MatchGraph) -> bool:
    """True when the component split looks like ratio starvation (a weak
    shard, or strong kNN votes across the split) — where the reference
    runs its pairwise rescue."""
    _, cnt = np.unique(comps, return_counts=True)
    if len(cnt) <= 1:
        return False
    if bool((cnt <= 2).any()):
        return True
    votes = _votes_arr(votes)
    if votes is None:
        return False
    cross = comps[:, None] != comps[None, :]
    inter_max = int(votes[cross].max()) if cross.any() else 0
    acc = np.asarray(graph.pairs)[np.asarray(graph.accepted, bool)]
    if len(acc) == 0:
        return inter_max >= 8
    med = float(np.median(votes[acc[:, 0], acc[:, 1]]))
    return inter_max >= max(8.0, 0.5 * med)


def pairwise_rescue(feats: SiftFeatures, graph: MatchGraph, comps: np.ndarray, n: int,
                    cfg: StitchConfig, generator: torch.Generator, votes=None):
    """Re-match a suspiciously fragmented graph with the per-pair matcher at
    the rescue ratio and keep the union with the first graph if it connects
    more images (reference `pairwise_rescue`). Up to
    pairwise_rescue_max_images every pair is re-matched; above it the
    candidates are each image's top pairwise_rescue_m kNN-vote neighbours
    plus the accepted pairs. Every re-match is one B1 pair-list launch.
    Returns (graph, comps, adopted)."""
    if not (cfg.matching.pairwise_rescue and not cfg.matching.match_pairwise
            and _rescue_suspicious(comps, votes, graph)):
        return graph, comps, False
    ratio = cfg.matching.pairwise_rescue_ratio
    if n <= cfg.matching.pairwise_rescue_max_images:
        cfg_pw = cfg.replace(matching=dataclasses.replace(
            cfg.matching, match_pairwise=True, ratio_threshold=ratio))
        p2, pi2, pm2, c2, _ = match_features(feats, cfg_pw)
    else:
        votes_a = _votes_arr(votes)
        if votes_a is None:
            return graph, comps, False
        cand = _vote_candidate_pairs(votes_a, cfg.matching.pairwise_rescue_m)
        acc = np.asarray(graph.pairs)[np.asarray(graph.accepted, bool)]
        if len(acc):
            cand = np.unique(np.concatenate([cand, acc.astype(np.int32)]), axis=0)
        if len(cand) == 0:
            return graph, comps, False
        threshold, binary = _matcher_semantics(cfg)
        idx, m_, nm = (t.cpu().numpy() for t in mt.match_pair_list(
            feats.desc, feats.mask, cand, ratio=ratio,
            max_matches=cfg.matching.max_matches_per_pair, threshold=threshold, binary=binary,
            compute_dtype=cfg.tpu.compute_dtype))
        c2 = np.zeros((n, n), np.int32)
        c2[cand[:, 0], cand[:, 1]] = nm
        c2 += c2.T
        keep = nm > 0
        p2, pi2, pm2 = cand[keep], idx[keep], m_[keep]
    if len(p2) == 0:
        return graph, comps, False
    p2, pi2, pm2 = select_candidate_pairs(p2, pi2, pm2, c2, cfg.image_match.m_brown_lowe)
    graph2 = _merge_graphs(graph, verify_matches(feats, p2, pi2, pm2, c2, cfg, generator))
    comps2 = connected_components(n, graph2.pairs, graph2.accepted)

    def stitched(c):
        _, k = np.unique(c, return_counts=True)
        return int(k[k >= 2].sum())

    better = stitched(comps2) > stitched(comps) or (
        stitched(comps2) == stitched(comps) and len(np.unique(comps2)) < len(np.unique(comps)))
    return (graph2, comps2, True) if better else (graph, comps, False)


def _merge_graphs(g1: MatchGraph, g2: MatchGraph) -> MatchGraph:
    """Union of two verified graphs: all of g2, plus g1's accepted pairs that
    g2 did not accept (their H and inliers ride along); putative counts take
    the elementwise max."""
    acc2 = {(int(i), int(j)) for (i, j), a in zip(np.asarray(g2.pairs), np.asarray(g2.accepted))
            if a}
    g1_acc = np.asarray(g1.accepted, bool)
    keep = [q for q in range(len(g1.pairs))
            if g1_acc[q] and (int(g1.pairs[q][0]), int(g1.pairs[q][1])) not in acc2]
    if not keep:
        return g2
    M = max(g1.pair_idx.shape[1], g2.pair_idx.shape[1])

    def padM(x):
        x = np.asarray(x)
        pads = [(0, 0)] * x.ndim
        pads[1] = (0, M - x.shape[1])
        return np.pad(x, pads)

    def cat(a, b):
        return np.concatenate([np.asarray(a), np.asarray(b)])

    return MatchGraph(
        pairs=cat(g2.pairs, np.asarray(g1.pairs)[keep]),
        pair_idx=cat(padM(g2.pair_idx), padM(np.asarray(g1.pair_idx)[keep])),
        pair_mask=cat(padM(g2.pair_mask), padM(np.asarray(g1.pair_mask)[keep])),
        H=cat(g2.H, np.asarray(g1.H)[keep]),
        inliers=cat(padM(g2.inliers), padM(np.asarray(g1.inliers)[keep])),
        num_inliers=cat(g2.num_inliers, np.asarray(g1.num_inliers)[keep]),
        accepted=cat(g2.accepted, np.ones(len(keep), bool)),
        counts=np.maximum(np.asarray(g1.counts), np.asarray(g2.counts)),
    )


def connected_components(n: int, pairs: np.ndarray, accepted: np.ndarray) -> np.ndarray:
    """Union-find panorama discovery: (n,) component label per image."""
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for (i, j), ok in zip(pairs, accepted):
        if ok:
            ri, rj = find(int(i)), find(int(j))
            if ri != rj:
                parent[ri] = rj
    return np.array([find(i) for i in range(n)])


def _check_supported(cfg: StitchConfig, dev: torch.device) -> None:
    """Raise ValueError, before any work, for a matching method or compute
    dtype that neither package takes, and on the card for what its kernels
    do not take: B2's descriptor grid, B1's width (<= 256) and, where the
    pooled matcher runs B1, its k (<= 16, ROADMAP section 3)."""
    mt.check_method(cfg.matching.method)
    knn.check_compute_dtype(cfg.tpu.compute_dtype)
    if dev.type == "cuda":
        det = cfg.detector
        if det.detector.upper() not in features_stage.BINARY_DETECTORS:  # B2's grid
            sift_window.check_grid(det.descriptor_width, det.descriptor_bins)
        D = features_stage.descriptor_width(det)
        knn.check_width(D)
        pooled_b1 = cfg.matching.method == "exhaustive" or D <= mt.SKETCH_DIM
        if pooled_b1 and not cfg.matching.match_pairwise:
            knn.check_k(cfg.matching.k)


def _upload(stack, dev):
    with trace.span("upload"):
        images = torch.as_tensor(np.asarray(stack)).to(dev)
        return images.float() / 255.0 if images.dtype == torch.uint8 else images


def _feathers(sizes, images):
    with trace.span("upload"):
        return samp_ops.feather_stack(
            torch.as_tensor(np.asarray(sizes), dtype=torch.int32, device=images.device),
            images.shape[1], images.shape[2])


def stitch(image_set: ImageSet, cfg: StitchConfig = StitchConfig(), seed: int = 0,
           device="cuda", timer=None, *, cache_dir=None) -> StitchResult:
    """Stitch an unordered image set into one or more panoramas on `device`
    (no fallback: a CUDA device that is missing raises). Randomness comes
    from torch.Generators seeded from `seed` (see the module doc). With
    `cache_dir`, the features, the post-rescue graph and each component's
    bundle adjustment are resumed from (or saved to) npz files there under
    the reference's fingerprints of the image names, sizes, the config
    sections each stage reads and the seed. The stitch is the root span of
    the tracer (`utils/trace.py`), recorded where something subscribed."""
    with trace.stitch(image_set.names, image_set.sizes):
        return _stitch(image_set, cfg, seed, device, timer, cache_dir)


def _stitch(image_set: ImageSet, cfg: StitchConfig, seed: int, device, timer,
            cache_dir) -> StitchResult:
    _check_supported(cfg, torch.device(device))
    dev = device_mod.resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n = image_set.n
    cache = key_feat = key_graph = key_ba = None
    if cache_dir:
        cache = StageCache(cache_dir)
        names, sizes = image_set.names, image_set.sizes
        key_feat = fingerprint(names, sizes, repr(cfg.detector))
        key_graph = fingerprint(names, sizes, repr(cfg.detector) + repr(cfg.matching)
                                + repr(cfg.image_match) + str(seed))
        key_ba = fingerprint(names, sizes, repr(cfg.detector) + repr(cfg.matching)
                             + repr(cfg.image_match) + repr(cfg.bundle) + str(seed))
    with _stage(timer, "features"):
        images = _upload(image_set.images, dev)
        cached = cache.load(key_feat, "features") if cache is not None else None
        if cached is not None:
            feats = SiftFeatures(**{k: torch.as_tensor(v, device=dev) for k, v in cached.items()})
        else:
            feats = features_stage.extract_features(images, image_set.sizes, cfg.detector)
            if cache is not None:
                cache.save(key_feat, "features",
                           **{f: getattr(feats, f).cpu().numpy() for f in feats._fields})
    feathers = _feathers(image_set.sizes, images)
    graph = None
    if cache is not None:
        cg = cache.load(key_graph, "graph")
        if cg is not None:
            graph = MatchGraph(**{k: cg[k] for k in MatchGraph.__dataclass_fields__})
    fresh_graph = graph is None
    votes = None
    if fresh_graph:
        with _stage(timer, "matching"):
            pairs, pair_idx, pair_mask, counts, votes = match_features(feats, cfg)
            if len(pairs):
                with trace.span("matching.select"):
                    pairs, pair_idx, pair_mask = select_candidate_pairs(
                        pairs, pair_idx, pair_mask, counts, cfg.image_match.m_brown_lowe)
        with _stage(timer, "ransac"):
            graph = verify_matches(feats, pairs, pair_idx, pair_mask, counts, cfg, gen)
    with trace.span("components"):
        comps = connected_components(n, graph.pairs, graph.accepted)
    rescue_adopted = False
    if fresh_graph:
        with _stage(timer, "pairwise_rescue"):
            graph, comps, rescue_adopted = pairwise_rescue(
                feats, graph, comps, n, cfg, derived_generator(dev, seed, 3), votes=votes)
        if cache is not None:  # the post-rescue graph: a resumed run skips the rescue
            cache.save(key_graph, "graph", **{k: np.asarray(getattr(graph, k))
                                              for k in MatchGraph.__dataclass_fields__})
    # a per-pair dense graph (pairwise mode, or an adopted rescue) would only
    # recompute the same matcher in the pairwise second pass: skip that one;
    # the re-extracting second pass still applies (it changes the features)
    graph_is_pairwise = cfg.matching.match_pairwise or rescue_adopted
    panoramas = stitch_components(image_set, graph, comps, feats, images, feathers, cfg, seed,
                                  graph_is_pairwise, timer=timer, cache=cache, cache_key=key_ba)
    return StitchResult(panoramas=panoramas, graph=graph, components=comps, features=feats)


def stitch_components(image_set: ImageSet, graph: MatchGraph, comps: np.ndarray,
                      feats: SiftFeatures, images, feathers, cfg: StitchConfig, seed: int,
                      graph_is_pairwise: bool, timer=None, cache=None, cache_key=None,
                      mesh=None) -> List[Dict]:
    """Every component of two or more images through its second pass (when
    it is not the whole set) and `stitch_component`: the panoramas' list.
    `mesh` goes on to `stitch_component` (the multi-GPU path; no cache)."""
    dev = images.device
    n = image_set.n
    panoramas = []
    for label in np.unique(comps):
        members = np.nonzero(comps == label)[0]
        if len(members) < 2:
            continue
        result = None
        if cfg.matching.second_pass and len(members) < n:
            if cfg.matching.resize_panorama_cluster:
                with _stage(timer, "second_pass"):
                    sp = second_pass_component(image_set, members, cfg,
                                               derived_generator(dev, seed, 2), dev)
                    trace.count("second_pass.runs", int(sp is not None))
                if sp is not None and np.asarray(sp[3].accepted).any():
                    trace.count("second_pass.adopted")
                    comp_set, comp_images, comp_feats, comp_graph = sp
                    result = stitch_component(
                        comp_set, comp_graph, comp_feats, np.arange(len(members)), cfg,
                        comp_images, _feathers(comp_set.sizes, comp_images), timer=timer,
                        mesh=mesh)
                    result["members"] = members
            if result is None and not graph_is_pairwise:
                with _stage(timer, "second_pass"):
                    comp_graph = second_pass_matching(feats, members, graph, cfg,
                                                      derived_generator(dev, seed, 1))
                    trace.count("second_pass.runs")
                    trace.count("second_pass.adopted")
                result = stitch_component(image_set, comp_graph, feats, members, cfg, images,
                                          feathers, timer=timer, mesh=mesh)
        if result is None:
            result = stitch_component(image_set, graph, feats, members, cfg, images, feathers,
                                      timer=timer, cache=cache, cache_key=cache_key,
                                      cache_label=int(label), mesh=mesh)
        panoramas.append(result)
    return panoramas


def second_pass_component(image_set: ImageSet, members: np.ndarray, cfg: StitchConfig,
                          generator: torch.Generator, device):
    """The full second pass (`imageMatchingPanoramaConComps.m:48-90`):
    re-resize the component's original images into the render limits
    (`image_io.resize_fit`, shared with the reference), re-extract, match
    every member pair on B1's pair mode, and re-verify. Returns (comp_set,
    comp_images (tensor on `device`), comp_feats, comp_graph) with
    member-local indices, or None when the set carries no originals or the
    re-resize reproduces the first-pass sizes."""
    if image_set.originals is None and image_set.paths is None:
        return None
    if cfg.render.resize_image:
        limits = (cfg.render.height_limit, cfg.render.width_limit)
    else:
        limits = (1 << 30, 1 << 30)
    with trace.span("second_pass.resize"):
        orig = [image_set.original(int(k)) for k in members]
        if any(o is None for o in orig):
            return None
        imgs = [image_io.resize_fit(o, *limits) for o in orig]
        sizes = np.array([im.shape[:2] for im in imgs], np.int32)
        if np.array_equal(sizes, image_set.sizes[members]):
            return None
        H = int(np.ceil(sizes[:, 0].max() / 32) * 32)
        W = int(np.ceil(sizes[:, 1].max() / 32) * 32)
        stack = np.stack([image_io._pad_to(im, H, W) for im in imgs])
    comp_set = ImageSet(images=stack, sizes=sizes,
                        names=[image_set.names[int(k)] for k in members])
    with trace.span("second_pass.upload"):
        images = _upload(stack, device)
    with trace.span("second_pass.features"):
        feats = features_stage.extract_features(images, sizes, cfg.detector)
    nc = len(members)
    with trace.span("second_pass.matching"):
        pairs_l, idx, m, nm = _all_pairs_graph(feats.desc, feats.mask, cfg,
                                               cfg.matching.ratio_threshold)
        keep = nm >= 4
        counts = np.zeros((nc, nc), np.int32)
        for p in np.nonzero(keep)[0]:
            i, j = pairs_l[p]
            counts[i, j] = counts[j, i] = int(nm[p])
        sub_pairs, sub_idx, sub_mask = select_candidate_pairs(
            pairs_l[keep], idx[keep], m[keep], counts, cfg.image_match.m_brown_lowe)
    with trace.span("second_pass.ransac"):
        comp_graph = verify_matches(feats, sub_pairs, sub_idx, sub_mask, counts, cfg, generator)
    return comp_set, images, feats, comp_graph


def second_pass_matching(feats: SiftFeatures, members: np.ndarray, graph: MatchGraph,
                         cfg: StitchConfig, generator: torch.Generator) -> MatchGraph:
    """The pairwise second pass: re-match every member pair of a component
    on its first-pass features (B1's pair mode) and re-verify. Returns a
    MatchGraph in global image indices restricted to the member pairs."""
    mem_d = torch.as_tensor(members, device=feats.desc.device)
    with trace.span("second_pass.matching"):
        pairs_l, idx, m, n = _all_pairs_graph(feats.desc[mem_d], feats.mask[mem_d], cfg,
                                              cfg.matching.ratio_threshold)
        keep = n >= 4
        pairs_g = members[pairs_l[keep]]
        counts = graph.counts.copy()
        for p, (i, j) in enumerate(pairs_g):
            counts[i, j] = counts[j, i] = int(n[keep][p])
        sub_pairs, sub_idx, sub_mask = select_candidate_pairs(
            pairs_g, idx[keep], m[keep], counts, cfg.image_match.m_brown_lowe)
    with trace.span("second_pass.ransac"):
        return verify_matches(feats, sub_pairs, sub_idx, sub_mask, counts, cfg, generator)


def _planar_pair_coords(graph: MatchGraph, keep, xy, sizes_all, cfg: StitchConfig):
    """Inlier coordinates (u_i, u_j, w) of the accepted pairs `keep` for the
    homography BA, subsampled per pair as the rotational BA does."""
    P = len(keep)
    M = min(cfg.bundle.max_matches, graph.pair_mask.shape[1])
    u_i = np.zeros((P, M, 2), np.float32)
    u_j = np.zeros((P, M, 2), np.float32)
    w = np.zeros((P, M), np.float32)
    for k, p in enumerate(keep):
        idxs = np.nonzero(graph.pair_mask[p] & graph.inliers[p])[0]
        gi, gj = int(graph.pairs[p, 0]), int(graph.pairs[p, 1])
        if len(idxs) > M:
            rng = np.random.default_rng(1000003 * gi + gj)
            pick = bundle_stage.stratified_subsample(
                xy[gi, graph.pair_idx[p, idxs, 0]], sizes_all[gi], M, cfg.bundle.subsample_mode,
                rng, grid_bins=cfg.bundle.subsample_grid_bins,
                polar_bins=cfg.bundle.subsample_polar_bins)
            idxs = idxs[pick]
        u_i[k, : len(idxs)] = xy[gi, graph.pair_idx[p, idxs, 0]]
        u_j[k, : len(idxs)] = xy[gj, graph.pair_idx[p, idxs, 1]]
        w[k, : len(idxs)] = 1.0
    return u_i, u_j, w


def _load_ba(cache: StageCache, key: str, label, dev):
    """A component's cached bundle adjustment (the reference's record, and
    k1 where the run estimated it), or None."""
    c = cache.load(key, f"ba{label}")
    if c is None:
        return None

    def t(name):
        return torch.as_tensor(c[name], device=dev)

    return {
        "members": c["members"], "pairs": c["pairs"], "pair_sel": c["pair_sel"],
        "focal_init": float(c["focal_init"]), "seed": int(c["seed"]),
        "no_rotation": bool(c["no_rotation"]),
        "rot_consistency_deg": tuple(c["rot_consistency_deg"]),
        "cameras": bundle_stage.Cameras(R=t("cam_R"), f=t("cam_f"), cx=t("cam_cx"),
                                        cy=t("cam_cy"), k1=t("cam_k1") if "cam_k1" in c else None),
    }


def _save_ba(cache: StageCache, key: str, label, ba: Dict) -> None:
    cams = ba["cameras"]
    extra = {} if cams.k1 is None else {"cam_k1": cams.k1.cpu().numpy()}
    cache.save(key, f"ba{label}", members=np.asarray(ba["members"]),
               pairs=np.asarray(ba["pairs"]), pair_sel=np.asarray(ba["pair_sel"]),
               focal_init=np.float64(ba["focal_init"]), seed=np.int64(ba["seed"]),
               no_rotation=np.bool_(ba["no_rotation"]),
               rot_consistency_deg=np.asarray(ba["rot_consistency_deg"]),
               cam_R=cams.R.cpu().numpy(), cam_f=cams.f.cpu().numpy(),
               cam_cx=cams.cx.cpu().numpy(), cam_cy=cams.cy.cpu().numpy(), **extra)


def stitch_component(image_set: ImageSet, graph: MatchGraph, feats: SiftFeatures,
                     members: np.ndarray, cfg: StitchConfig, images, feathers,
                     timer=None, cache=None, cache_key=None, cache_label=None,
                     mesh=None) -> Dict:
    """Bundle-adjust and render one component: the rotational body
    (straighten, gains, every projection) or, for a planar scan
    (`force_planar_scan` or BA's no-rotation verdict), homography BA and
    planar compositing. With a StageCache, the bundle adjustment is resumed
    from (or saved to) its record under (cache_key, cache_label). With a
    `parallel.mesh.Mesh`, the rotational gain statistics and each
    projection's tiles split across its ranks (`parallel/sharded.py`); the
    bundle adjustment and the planar path run whole on every rank."""
    dev = images.device
    acc = graph.accepted
    ba = _load_ba(cache, cache_key, cache_label, dev) if cache is not None else None
    if ba is None:
        with _stage(timer, "bundle_adjustment"):
            ba = bundle_stage.run_bundle_adjustment(
                members, graph.pairs[acc], graph.pair_idx[acc], graph.pair_mask[acc],
                graph.inliers[acc], graph.H[acc], feats.xy.cpu().numpy(), graph.counts,
                image_set.sizes, cfg.bundle, force_planar=cfg.straighten.force_planar_scan,
                device=dev,
            )
        if cache is not None:
            _save_ba(cache, cache_key, cache_label, ba)
    sizes = image_set.sizes[members]
    mem_d = torch.as_tensor(members, device=dev)
    images_m, feathers_m = images[mem_d], feathers[mem_d]
    result: Dict = {"members": members, "ba": ba}

    if ba["no_rotation"] or cfg.straighten.force_planar_scan:
        remap = {int(g): k for k, g in enumerate(members)}
        keep = [p for p in range(len(graph.pairs))
                if acc[p] and int(graph.pairs[p, 0]) in remap and int(graph.pairs[p, 1]) in remap]
        loc_pairs = np.array([[remap[int(i)], remap[int(j)]] for i, j in graph.pairs[keep]], int)
        with _stage(timer, "bundle_adjustment_h"):
            with trace.span("ba_h.coords"):
                coords = _planar_pair_coords(graph, keep, feats.xy.cpu().numpy(),
                                             image_set.sizes, cfg)
            hba = bundle_h_stage.run_bundle_adjustment_h(
                loc_pairs, graph.H[keep], coords, len(members), cfg.bundle, device=dev)
        with _stage(timer, "render"):
            planar = planar_stage.composite_from_abs(
                images_m, feathers_m, sizes, hba["H_abs"], hba["reachable"],
                blend_mode=cfg.blend.mode, bands=cfg.blend.bands,
                max_megapixel=cfg.render.max_megapixel, gain_cfg=cfg.gain,
                interp=cfg.render.interpolation)
        result.update(planar)
        result["hba"] = {k: hba[k] for k in ("H_abs", "anchor", "final_cost")}
        result["H_abs"] = hba["H_abs"]
        result["reachable"] = hba["reachable"]
        result["anchor"] = hba["anchor"]
        result["projections"] = {"planar": planar["panorama"]}
        result["coverage_by_mode"] = {"planar": planar["coverage"]}
        with trace.span("crop"):
            _apply_crop(result, cfg)
        if cfg.post.show_panorama_imgs_nums:
            with trace.span("annotate"):
                boxes, centers = annotate_stage.warped_boxes_planar(
                    hba["H_abs"], sizes, planar["offset"], planar["scale"])
                result["projections_annotated"] = {
                    "planar": annotate_stage.draw_annotations(planar["panorama"], boxes, centers)}
        return result

    with trace.span("straighten"):  # the cameras read back, then straightened
        cams = ba["cameras"]
        R = cams.R.cpu().numpy()
        f = cams.f.cpu().numpy()
        K = np.zeros((len(f), 3, 3), np.float32)
        K[:, 0, 0] = f
        K[:, 1, 1] = f
        K[:, 0, 2] = cams.cx.cpu().numpy()
        K[:, 1, 2] = cams.cy.cpu().numpy()
        K[:, 2, 2] = 1.0
        k1 = None if cams.k1 is None else cams.k1.cpu().numpy().astype(np.float32)
        R, straightened, _ = straighten_stage.straighten_rotations(R, cfg.straighten)
    result["straightened"] = straightened
    result["R_render"] = R

    with _stage(timer, "gain"):
        if mesh is not None and cfg.gain.enabled:
            Nij, sumC = sharded.sharded_gain_stats_imagespace(
                images_m, feathers_m, sizes, R, K, mesh, stride=int(cfg.gain.grid_stride), k1=k1)
            gains = gain_stage.solve_gains(Nij.cpu().numpy(), sumC.cpu().numpy(), cfg.gain)
        else:
            gains = gain_stage.compute_gains_rotational(
                images_m, feathers_m, R.astype(np.float32), K, sizes, cfg.gain, k1=k1)
    projections: Dict[str, np.ndarray] = {}
    blend_mode = cfg.blend.mode
    if blend_mode == "none":
        blend_mode = f"none-{cfg.blend.compose_none_policy}"
    for mode in cfg.render.projections:
        with trace.span("canvas"):
            canvas = render_stage.compute_canvas(R, K, sizes, mode, cfg.render, k1=k1,
                                                 device=dev)
        render = render_stage.render_rotational if mesh is None else functools.partial(
            sharded.sharded_render_tiles, mesh=mesh)
        with _stage(timer, "render"):
            pano, cover = render(
                images_m, feathers_m, R, K, canvas=canvas, gains=gains, blend_mode=blend_mode,
                bands=cfg.blend.bands, tile=cfg.render.tile,
                angle_power=cfg.render.angle_power, sizes=sizes,
                interp=cfg.render.interpolation,
                max_contributors=cfg.render.max_contributors, k1=k1,
            )
        projections[mode] = pano
        result.setdefault("canvas", {})[mode] = canvas
        result.setdefault("gains", {})[mode] = gains
        result.setdefault("coverage_by_mode", {})[mode] = cover
    result["projections"] = projections
    result["panorama"] = next(iter(projections.values()))
    result["coverage"] = result["coverage_by_mode"][cfg.render.projections[0]]
    with trace.span("crop"):
        _apply_crop(result, cfg)
    if cfg.post.show_panorama_imgs_nums:
        with trace.span("annotate"):
            annotated = {}
            for mode, pano_img in projections.items():
                boxes, centers = annotate_stage.warped_boxes_rotational(
                    result["canvas"][mode], R, K, sizes, k1=k1)
                annotated[mode] = annotate_stage.draw_annotations(pano_img, boxes, centers)
            result["projections_annotated"] = annotated
    return result


def _apply_crop(result: Dict, cfg: StitchConfig) -> None:
    """Border/bbox crop + optional inscribed-rectangle crop."""
    by_mode = result["coverage_by_mode"]
    cropped, bbox_vis = {}, {}
    for mode, pano in result["projections"].items():
        cover = by_mode[mode]
        if cfg.render.canvas_color != "black":
            pano = crop_stage.fill_canvas_color(pano, cover, cfg.render.canvas_color)
            result["projections"][mode] = pano
        if cfg.render.crop_border:
            pano_c, rect = crop_stage.crop_bbox(pano, cover)
        else:
            pano_c, rect = pano, None
        if cfg.post.crop_panorama:
            r = rect or (0, pano.shape[0], 0, pano.shape[1])
            sub_mask = cover[r[0] : r[1], r[2] : r[3]] if rect else cover
            pano_uncropped = pano_c
            pano_c, inner = crop_stage.crop_panorama(pano_c, sub_mask)
            if cfg.post.show_crop_bounding_box and inner is not None:
                bbox_vis[mode] = crop_stage.draw_rect(pano_uncropped, inner)
        cropped[mode] = pano_c
    result["projections_cropped"] = cropped
    if bbox_vis:
        result["projections_crop_bbox"] = bbox_vis
