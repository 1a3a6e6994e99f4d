#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`autopanostitch_tpu_torch`) on one CUDA GPU.

    python3 chip_smoke.py            # the full run; needs one CUDA GPU
    python3 chip_smoke.py --rehearse # the same phases on the CPU at a tiny
                                     # size (plain kernel versions); always
                                     # exits 3 and prints no result

Phases, each printing its own lines:
  1. environment: the card's name and power limit (nvidia-smi), torch, CUDA;
  2. build the CUDA kernels from `autopanostitch_tpu_torch/csrc/`; fail on a
     register spill or a wgmma that ptxas serialised (warnings C7514/C7515);
  3. B1 (pooled exact k-NN) against its plain version at the slice's shapes,
     and at phase 11's: each half of the queries sliced from the pool;
  3b. B1's pair-list mode against its plain version at the pairwise
     rescue's shape (25 images x 2048 slots, all 300 pairs, both ways);
  3c. B1 on {0,1} descriptors (the corner detectors' 256 bits): pooled
     k = 4 at F = 12 x 2048 and the pair list of 66 pairs x 2048 slots at
     D = 256, and both at D = 160 on 6 images, through the 3xTF32 and the
     bf16 instance; indices and distances identical to the plain version
     (binary descriptors then run on the bf16 instance);
  3d. B1's bf16 instance (compute_dtype="bfloat16") against the plain bf16
     version at phase 3's and 3b's shapes: indices identical outside 1e-5
     ties, distances within 1e-5 relative; bound by one bf16 product, with
     its epilogue's issue time beside it (as in 3c and 3e: EPILOGUE_OPS
     CUDA-core instructions a (query, target) pair);
  3e. B1 at the widths it takes zero-padded (D = 16, 72) and at k = 12
     (its K = 16 instance), both operand types, against the plain version;
  4. B2's first port (the SIFT window gather alone, off the main path now)
     against its plain version, bit-exact;
  4b. B2 fused (`sift_window.cu`: the orientation histogram and the
     descriptor, reading windows straight from the stack) against its plain
     versions at the ring's octave-0 shape (a (20 x 7, 600, 800, 2) stack,
     40,960 keypoints, 40 and 80 px windows; TMA copies) and at an odd-W
     coarse octave (32 px windows; cp.async copies) and at the DoH/KAZE
     shape (a (8 x 8, 600, 800, 2) stack of full-resolution levels, 8 x
     2048 keypoints, 80 px windows for both phases): raw histograms within
     1e-5 of each row's max, descriptors within 1e-4 (max) and 1e-6 (mean),
     a repeat launch bit-identical;
  Every kernel time is the device's: CUDA events around a call with the
  card kept busy by a sleep while the host enqueues it (`time_ms`), or a
  CUDA graph of back-to-back calls (`graph_ms`, phase 9b).
  Phases 3-4b time each kernel in turns with its plain version, its library
  yardstick (3/3b: `torch.cdist` + `torch.topk`, Euclidean and without the
  masks; 4: the advanced indexing `src[L, Y, X]`; 4b: none, no PyTorch call
  computes these functions, so the unfused path, B2's gather kernel and the
  PyTorch binning in 1,024-keypoint chunks, stands in) and, for B1, the
  bare `torch.mm` / `torch.bmm` of the same product, and print the kernel's
  bound (operations for B1: 3xTF32 on the tensor cores, for {0,1}
  descriptors one bf16 product, which is exact on them; bytes for B2;
  for 4b the larger of bytes, the stack pixels the windows cover, counted
  as their union level by level, and float32 + tensor-core operations) and
  its share of it;
  5. the default-config `stitch` of a synthetic 20-view 800x600 360-degree
     yaw ring (f = 600 px): one panorama, focal error, PSNR; then the
     feature stage again, split into its orientation and descriptor phases
     and the rest (`features_split`);
  5b. the ring's pooled matcher in float32, bf16 and the approximate method
     (times, nn_idx agreement with the exhaustive run), then the ring
     stitched with compute_dtype="bfloat16" and with the approximate
     matcher: one panorama of 20, focal error < 1 %, PSNR >= 40 dB;
  6. a multi-panorama folder: two interleaved 12-view 800x600 rings and a
     distractor view, ingested at 400 px with the originals kept, stitched
     with the default config in the spherical and cylindrical projections
     (pairwise rescue + re-extracting second pass): two panoramas, their
     members, focal errors and PSNRs; 6b. the same with
     compute_dtype="bfloat16" (the pair list on B1's bf16 instance);
  7. a planar scan: a 3x3 grid of 800x600 crops with ~35 % overlap,
     `force_planar_scan` and the linear blend: one panorama of 9, the
     corner error of the homographies, PSNR against the texture sampled as
     the renderer samples (`planar_metrics`);
  7b. the planar scan again with the translation and the affine model: one
     panorama of 9, corner error < 1 px, PSNR at phase 7's gate;
  8. the detectors: a 12-view 800x600 ring (f = 600 px) of a sharper
     `synthdata.smooth_texture` (cutoff 0.2) stitched with ORB + MLESAC + the adaptive RANSAC budget, with SURF
     and with KAZE, each held to the JAX package's result on the same scene
     (JAX_PHASE8, from tools/jax_gates.py): the same panoramas, focal error
     < 1 %, PSNR at least the JAX figure less 3 dB; ORB must launch B1 and
     not B2, SURF and KAZE both;
  9. the 100-view ring of `bench.build_pano` (384x288, f = 350 px) with its
     config: one panorama of 100, focal error < 1 %, PSNR >= 40 dB and >=
     the JAX package's CPU result less 3 dB (JAX_PANO100), the stage split;
  9b. the bundle adjustment of phases 5 and 9 again from their recorded
     inputs: the `ba_system` kernel (csrc/ba_system.cu, the LM's whole
     linearisation: the dense H, g and cost) and, off the main path, the
     `ba_normals` kernel (csrc/ba_normals.cu, per-pair blocks) against their
     plain versions at each one's largest LM phase (the ring: nb 64, pb 64,
     M 300; pano100: nb 128, pb 128, M 256; pd 5), each entry's difference
     over its Cauchy-Schwarz scale: to the plain version run in float64 no
     larger than twice the float32 plain version's own (or 1e-5; at a
     converged state the residuals are small differences of pixel
     coordinates, and float32 alone errs by ~1e-5 of the cost there), a
     repeat launch bit-identical; `ba_system`, the per-pair linearisation
     (`ba_normals` + one-hot einsums + the cost's sum) and `ba_normals`
     timed on the device, each a launch from a CUDA graph of 20, beside an
     empty kernel's (the launch floor) and the bound (the larger of float32
     operations at 67 TFLOP/s and bytes; no PyTorch call computes it); then
     each whole BA run eagerly and replayed from the cached CUDA graphs of
     its LM phases: R, f, k1 and cost bit-identical to each other and to the
     stitch's own;
  10. the command line, `python -m autopanostitch_tpu_torch.cli` on a
     folder of a 12-view ring, twice with one `--cache`: the second run
     resumes and writes the same files and panorama; then a stitch with
     `show_panorama_imgs_nums` adds the annotated panorama;
  11. the multi-GPU path, `api.stitch_multichip`, on this one card: 11a
     phase 9's ring on an NCCL mesh of world size 1 in this process, with
     the LM phase graph cache emptied first, so that its graphs are
     captured with the NCCL process group alive (it fails if none was); 11b the
     same on two ranks spawned over gloo that share the card (each prints
     its stage split and the card, and writes its result for this process);
     11c phase 6's folder at world size 1. Phase 9's and phase 6's gates,
     and 11a and each rank of 11b held to phase 9's single-device result
     and to each other with tests/test_parallel.py's tolerances (the same
     members, pairs and accepted pairs, f within 5e-4, panoramas within 1
     LSB on average); a failing rank fails the phase. The rehearsal runs
     11a and 11c over gloo on the CPU and 11b as two CPU ranks.
  12. the render kernels (`csrc/render.cu`, `csrc/render_pyramid.cu`)
     against their plain versions
     on the ring's recorded render inputs (phase 5's images, cameras, gains
     and k1; run last, so that no stitch's timing follows its large plain
     runs): `render_sample` in all five projections x {nearest, bicubic2x}
     x {multiband, linear, none-maxangle} x {with k1, without} (up to 96
     tiles of each canvas, nearest its centre; 3 in the rehearsal), the
     multiband pyramid (`mb_reduce`, `mb_collapse`) on the sampler's output
     and on an odd-sized 301 x 1003 band: float outputs (the sampler's
     colours and weights, the pyramid's levels, the collapse's float blend)
     within 1e-5, uint8 at most 1 apart on at most 0.1 % of the covered
     pixels, coverage equal, a repeat launch bit-identical; the pyramid
     also on the middle band of phase 7's planar canvas, where
     `composite_band`'s multiband must launch 2 + 1 kernels and no plain
     version; then each kernel timed beside its plain version (and the
     reduce beside a depthwise `F.conv2d` blur with the resize products)
     and its bound at the ring's and the folder's whole canvases, and the
     pyramid at the planar band.
Phases 5-11 each count the kernels' launches from 0 and fail if a kernel of
the path never launched (in 11b on either rank) or if `ba_normals`, off the
main path, did, or if a plain version of a render kernel ran on the card;
every rotational stitch must launch the render kernels (`render_sample`,
`mb_reduce`, `mb_collapse`) and prints its render stage seconds and their
launches; every rotational stitch must launch `ba_system` (its count
includes the launches that the LM phase graphs replay), and each prints
its bundle_adjustment seconds and the graphs it captured and replayed. Then a JSON line of the kernels, the nvidia-smi
line, and as the last line {"ok": true, "device": {...}}. Any failure exits
non-zero without that line. This script imports nothing of JAX.

The PSNR gates of phases 6 and 7 are the JAX package's own results on the
same scenes (on a CPU) less 3 dB: the lowest of 49.74 / 50.50 dB spherical
and 49.81 / 50.36 dB cylindrical (JAX_MULTIPANO_PSNR), and 57.08 dB planar
(JAX_PLANAR_PSNR). That planar record was read against a bilinear ground
truth; the gate reads the bicubic one, which is what the phase-free
comparison measures (`autopanostitch_tpu_torch/tools/planar_probe.py`
splits the two on the card).
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

REHEARSE = "--rehearse" in sys.argv[1:]
# one H100 SXM's published peaks at 700 W: TF32 and bf16 tensor cores
# (dense), the float32 FMA pipes, HBM3
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
# ba_normals / ba_system: float32 operations a match as `csrc/ba_direction.cuh`
# and `csrc/ba_normals.cu` write them
# (an FMA counts 2), by pd: both directions' residual and closed-form
# Jacobian (180 / 134 each), the weights (21) and the sums into JtJ's upper
# triangle, Jtg and the cost (572 / 396)
BA_FLOPS_PER_MATCH = {5: 953, 4: 685}
# B1's bf16 epilogue: CUDA-core instructions a (query, target) pair (the
# add qn + tn, the fma, the compare, the candidate bit), issued at 128 lanes
# an SM a clock (`epilogue_bound`, printed beside the bf16 rows' bounds)
EPILOGUE_OPS = 4
JAX_MULTIPANO_PSNR = 49.74  # lowest ring/projection PSNR of the JAX package, dB
JAX_PLANAR_PSNR = 57.08
# phase 8: the ring of 12 views (800x600, f = 600 px) stitched with other
# detector and estimator options, each given as StitchConfig fields by
# section (`phase8_config` builds it in either package)
PHASE8 = {
    "orb_mlesac_adaptive": {"detector": {"detector": "ORB"},
                            "image_match": {"method": "mlesac", "adaptive_first_batch": 64}},
    "surf": {"detector": {"detector": "SURF"}},
    "kaze": {"detector": {"detector": "KAZE"}},
}
PHASE8_RING = (12, 600.0, 800, 600, (1024, 2048), 0.2)  # n, f, w, h, texture (h, w), cutoff
# the JAX package's results on phase 8's scenes, on a CPU:
#   python3 tools/jax_gates.py
# panoramas (sorted member lists), max focal error %, spherical PSNR dB
JAX_PHASE8 = {  # accepted / candidate pairs in the comments
    "orb_mlesac_adaptive": {"panoramas": [list(range(12))], "focal_err": 0.0947367325425148,
                            "psnr": 42.179099469406054},  # 15/30
    "surf": {"panoramas": [list(range(12))], "focal_err": 0.0465494766831398,
             "psnr": 47.56458037006152},  # 24/24
    "kaze": {"panoramas": [list(range(12))], "focal_err": 0.02681477926671505,
             "psnr": 47.63786152976782},  # 24/24
}


# phase 5's 20-view ring stitched again with the reference's bf16 cross
# term, and with the approximate matcher (phase 5b)
RING = (20, 600.0, 800, 600, (1024, 2048))  # n, f, w, h, texture (h, w)
RING_OPTIONS = {"bf16": {"tpu": {"compute_dtype": "bfloat16"}},
                "approximate": {"matching": {"method": "approximate"}}}
# phase 9: the 100-view ring of `bench.build_pano` (bench.py:153-189):
# 384x288 views, f = 350 px, smooth_texture(7, 768, 2048), and its config
PANO100_RING = (100, 350.0, 384, 288, (768, 2048))
PANO100 = {"detector": {"max_keypoints": 512, "num_octaves": 3},
           "matching": {"max_matches_per_pair": 256},
           "image_match": {"ransac_batch": 256, "max_iter": 256},
           "straighten": {"enabled": False},
           "render": {"projections": ("spherical",)},
           "blend": {"mode": "multiband"}}
PANO100_TPU_PSNR = 46.57  # the JAX package's pano100 on TPU v5e (docs/ROUND5.md): history only
# the JAX package's results on phases 5b and 9's scenes, on a CPU:
#   python3 tools/jax_gates.py ring_bf16 ring_approximate pano100
JAX_RING_OPTIONS = {  # accepted / candidate pairs in the comments
    "bf16": {"panoramas": [list(range(20))], "focal_err": 0.0522766076028347,
             "psnr": 49.230004081773345},  # 42/60
    "approximate": {"panoramas": [list(range(20))], "focal_err": 0.0510152205824852,
                    "psnr": 49.40713565836275},  # 41/60
}
JAX_PANO100 = {"panoramas": [list(range(100))], "focal_err": 0.1348702609539032,
               "psnr": 46.44466983609692}  # 100/260


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_ms() -> float:
    """The card's `torch.cuda._sleep` cycles a millisecond, read once."""
    import torch

    torch.cuda._sleep(1000)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(2_000_000)
    b.record()
    b.synchronize()
    return 2e6 / a.elapsed_time(b)


def time_ms(fn, dev, reps: int = 5) -> float:
    """Median of `reps` timed calls, ms. On the card the device's time from
    CUDA events: ahead of the start event a `torch.cuda._sleep` keeps the
    card busy for twice the host's time to enqueue one call (at most 200
    ms), so the wrapper's host work (checks, allocations, the launch) runs
    while the card sleeps and not inside the timed span. The host clock on
    the CPU."""
    import torch

    fn()  # warm-up
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        cycles = int(min(2.0 * host_ms + 0.05, 200.0) * sleep_cycles_per_ms())
    for _ in range(reps):
        if dev.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(cycles)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


GRAPH_LAUNCHES = 20  # calls a CUDA graph of `graph_ms` holds


def graph_ms(fn, dev) -> float:
    """Device time a call, ms: `utils.timing.graph_ms` (a CUDA graph of
    GRAPH_LAUNCHES back-to-back calls, replay time over their number); the
    host clock a call on the CPU (`time_ms`)."""
    if dev.type != "cuda":
        return time_ms(fn, dev)
    from autopanostitch_tpu_torch.utils import timing

    return timing.graph_ms(fn, GRAPH_LAUNCHES)


@functools.lru_cache(maxsize=None)
def issue_rate():
    """(CUDA-core instructions a second, how it was read): 128 lanes an SM a
    clock at the card's highest SM clock (nvidia-smi clocks.max.sm) on its
    SMs, both read in this run; None where either cannot be read."""
    import torch

    if not torch.cuda.is_available():
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout
        mhz = float(out.strip().splitlines()[0].split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
    return sms * 128 * mhz * 1e6, f"{sms} SMs x 128 lanes x {mhz:.0f} MHz"


def epilogue_bound(pairs: float) -> str:
    """The bf16 epilogue's issue time, as printed: EPILOGUE_OPS instructions
    a (query, target) pair at the card's CUDA-core issue rate. It runs beside
    the products, so it caps the share of the product bound any design
    keeping this epilogue can reach."""
    rate = issue_rate()
    if rate is None:
        return "epilogue issue bound not measured (the SM clock was not read)"
    return (f"epilogue issue bound {pairs * EPILOGUE_OPS / rate[0] * 1e3:.3f} ms ({pairs:.3e} "
            f"pairs x {EPILOGUE_OPS} instructions at {rate[1]})")


def bound_ms(flop: float, nbytes: float, flop_rate: float = TF32_FLOPS):
    """(least time in ms, "operations" | "bytes"): the larger of flop at
    `flop_rate` and nbytes at HBM_BYTES."""
    t_ops, t_bytes = flop / flop_rate * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def b1_record(label: str, flop: float, nbytes: float, err: float, bad: int, times: dict,
              one_product: bool = False, D: int = 128) -> dict:
    """Print B1's agreement, times, bound and share; return its record. The
    product of float descriptors in float32 needs 3xTF32 (3 tensor-core flop
    a float32 flop). The bf16 instance does one product at the bf16 rate
    (`one_product`), which is also all {0,1} descriptors need: there it is
    exact with bf16 operands and float32 sums. Beside the bound of the bf16
    instance stands its epilogue's issue time over the (query, target)
    pairs, flop / 2 D of them (`epilogue_bound`)."""
    ops, rate, unit = (flop, BF16_FLOPS, "bf16") if one_product else (3 * flop, TF32_FLOPS, "3xTF32")
    bound, by = bound_ms(ops, nbytes, rate)
    epi = f", {epilogue_bound(flop / (2 * D))}" if one_product else ""
    log(f"B1 {label}: max|dist diff|={err:.3e} idx mismatches outside ties={bad} "
        + " ".join(f"{k} {v:.3f} ms" for k, v in times.items())
        + f" | bound {bound:.3f} ms ({by}: {ops:.3e} flop at {rate / 1e12:.0f} TFLOP/s {unit},"
        f" {nbytes / 1e6:.1f} MB), share {bound / times['kernel']:.1%}{epi}; one TF32 pass "
        f"{flop / TF32_FLOPS * 1e3:.3f} ms, float32 FMA bound {flop / FP32_FLOPS * 1e3:.3f} ms")
    return dict(err=err, ms=times["kernel"], plain_ms=times["plain"], library_ms=times["library"],
                mm_ms=times["mm"], bound_ms=bound, bound_by=by)


def knn_agreement(idx_k, d_k, idx_p, d_p, tie: float = 1e-5):
    """(max |dist diff|, # index mismatches outside distance ties). The plain
    result carries one neighbour more than the kernel's, so a tie between the
    k-th and the (k+1)-th neighbour counts as a tie too."""
    idx_k, d_k, idx_p, d_p = (x.cpu().numpy() for x in (idx_k, d_k, idx_p, d_p))
    k = d_k.shape[1]
    err = float(np.abs(d_k - d_p[:, :k]).max())
    gaps = np.abs(np.diff(d_p, axis=1))  # (F, k): gap to the next neighbour
    gap_prev = np.full(d_k.shape, np.inf)
    gap_prev[:, 1:] = gaps[:, : k - 1]
    distinct = (gap_prev > tie) & (gaps[:, :k] > tie)
    bad = (idx_k != idx_p[:, :k]) & distinct
    for r in np.nonzero(bad.any(1))[0][:3]:
        log(f"  mismatch row {r}: kernel {idx_k[r].tolist()} {d_k[r].tolist()} "
            f"plain {idx_p[r].tolist()} {d_p[r].tolist()}")
    return err, int(bad.sum())


def pooled_inputs(dev, F: int, n_img: int, D: int = 128, seed: int = 0):
    """Unit descriptors (F, D) of n_img images: (desc, qid with ~10 %
    invalid rows at -2, the plain image ids, self indices)."""
    import torch

    rng = np.random.default_rng(seed)
    d = rng.standard_normal((F, D)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ids = np.repeat(np.arange(n_img, dtype=np.int32), -(-F // n_img))[:F]
    ids_m = np.where(rng.random(F) < 0.1, -2, ids).astype(np.int32)
    return (torch.as_tensor(d, device=dev), torch.as_tensor(ids_m, device=dev),
            torch.as_tensor(ids, device=dev), torch.arange(F, dtype=torch.int32, device=dev))


def pair_inputs(dev, n_img: int, K: int, seed: int = 1):
    """n_img images of K unit descriptor slots that re-observe one base set
    with noise, ~10 % invalid slots, and every pair: (desc, valid, pairs)."""
    import torch

    rng = np.random.default_rng(seed)
    base = rng.standard_normal((K, 128)).astype(np.float32)
    d = np.stack([base[rng.permutation(K)] + 0.6 * rng.standard_normal((K, 128)).astype(np.float32)
                  for _ in range(n_img)])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.as_tensor(d, device=dev), torch.as_tensor(rng.random((n_img, K)) > 0.1, device=dev),
            torch.as_tensor(np.stack(np.triu_indices(n_img, 1), -1).astype(np.int32), device=dev))


def bf16_agreement(idx_k, d_k, idx_p, d_p, rel: float = 1e-5, tie: float = 1e-5):
    """(max relative distance difference over the finite neighbours, # index
    mismatches outside ties, # distances off by more than `rel` relative) of
    a bf16-instance result against the plain bf16 version with one
    neighbour more."""
    err, bad = knn_agreement(idx_k, d_k, idx_p, d_p, tie)
    k = d_k.shape[1]
    dk, dp = d_k.cpu().numpy(), d_p[:, :k].cpu().numpy()
    real = dp < 1e17
    diff = np.abs(dk - dp)[real]
    ref = np.abs(dp)[real]
    over = int((diff > rel * ref).sum())
    return float((diff / np.maximum(ref, 1e-30)).max()) if diff.size else 0.0, bad, over


def phase_b1(dev, F: int, n_img: int):
    """B1 kernel vs plain at the slice's pooled shape. Returns a record
    (as `b1_record`) for each of k = 4 and k = 2 with self exclusion."""
    import torch

    from autopanostitch_tpu_torch.kernels import knn as K

    desc, qid, idq, self_idx = pooled_inputs(dev, F, n_img)

    rec = {}
    for label, args in (("k4", (desc, qid, desc, qid, 4)),
                        ("k2_self", (desc, idq, desc, idq, 2, self_idx))):
        k = args[4]
        out_k = K.knn(*args)
        wider = args[:4] + (k + 1,) + args[5:]
        out_p = K.knn_plain(*wider)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        err, bad = knn_agreement(out_k[0], out_k[1], out_p[0], out_p[1])
        del out_p
        times = {"kernel": time_ms(lambda: K.knn(*args), dev),
                 "library": time_ms(lambda: library_knn(desc, desc, k), dev),
                 "mm": time_ms(lambda: torch.mm(desc, desc.T), dev),
                 "plain": time_ms(lambda: K.knn_plain(*args), dev)}
        # bytes: descriptors and ids read once, (F, k) indices and distances written
        nbytes = F * 128 * 4 + F * 4 * (1 + len(args[5:])) + F * k * 8
        rec[label] = b1_record(f"{label}: F={F} D=128", 2.0 * F * F * 128, nbytes, err, bad, times)
        if bad or not err <= 1e-4:
            raise AssertionError(f"B1 {label} disagrees with its plain version")
    # the multi-GPU path's shape (phase 11): a rank's half of the queries,
    # sliced from the pool (the first half shares the pool's address)
    half = F // 2
    for r, (lo, hi) in enumerate(((0, half), (half, F))):
        sl = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        args = (desc[lo:hi], qid[lo:hi], desc, qid, 4, sl)
        out_k = K.knn(*args)
        out_p = K.knn_plain(*(args[:4] + (5, sl)))
        sync(dev)
        err, bad = knn_agreement(out_k[0], out_k[1], out_p[0], out_p[1])
        ms = time_ms(lambda: K.knn(*args), dev)
        log(f"B1 k4 rank {r} of 2: queries {lo}:{hi} of the pool F={F}: max|dist diff|={err:.3e} "
            f"idx mismatches outside ties={bad}, kernel {ms:.3f} ms")
        if bad or not err <= 1e-4:
            raise AssertionError(f"B1 on rank {r}'s slice of the queries disagrees with its plain "
                                 "version")
        rec["k4"][f"rank{r}_of_2_ms"] = ms
        rec["k4"]["err"] = max(rec["k4"]["err"], err)
    return rec


def library_knn(q, t, k: int):
    """B1's library yardstick: `cdist` (the matmul form) and `topk`. It
    computes Euclidean (not squared) distances and leaves the masks out."""
    import torch

    return torch.topk(torch.cdist(q, t, compute_mode="use_mm_for_euclid_dist"), k, largest=False)


def phase_b1_pairs(dev, n_img: int, K: int):
    """B1 pair-list mode vs plain on every pair of n_img images of K slots,
    both directions. Returns a record as `b1_record`."""
    import torch

    from autopanostitch_tpu_torch.kernels import knn as KN

    desc, valid, pairs = pair_inputs(dev, n_img, K)
    idx_k, d_k = KN.knn_pairs(desc, valid, pairs, 2)
    idx_p, d_p = KN.knn_pairs_plain(desc, valid, pairs, 3)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    err, bad = knn_agreement(idx_k.reshape(-1, 2), d_k.reshape(-1, 2), idx_p.reshape(-1, 3),
                             d_p.reshape(-1, 3))
    del idx_p, d_p
    pl = pairs.long()
    qs = torch.cat([desc[pl[:, 0]], desc[pl[:, 1]]])  # (2P, K, D): both directions
    ts = torch.cat([desc[pl[:, 1]], desc[pl[:, 0]]])
    times = {"kernel": time_ms(lambda: KN.knn_pairs(desc, valid, pairs, 2), dev),
             "library": time_ms(lambda: library_knn(qs, ts, 2), dev),
             "mm": time_ms(lambda: torch.bmm(qs, ts.transpose(1, 2)), dev),
             "plain": time_ms(lambda: KN.knn_pairs_plain(desc, valid, pairs, 2), dev)}
    del qs, ts
    P = pairs.shape[0]
    # bytes: descriptors, validity and pairs read once, (P, 2, K, 2) written
    nbytes = n_img * K * (128 * 4 + 1) + P * 8 + P * 2 * K * 2 * 8
    rec = b1_record(f"pairs: {n_img} images x {K} slots, {P} pairs x 2 directions, k=2",
                    2.0 * 2 * P * K * K * 128, nbytes, err, bad, times)
    if bad or not err <= 1e-4:
        raise AssertionError("B1 pair mode disagrees with its plain version")
    return rec


def phase_b1_wide(dev, n_img: int, K: int, narrow: int):
    """B1 on {0,1} descriptors, the corner detectors' binary bits: pooled
    k = 4 over n_img images of K rows and the pair list of all their pairs
    at D = 256, and both modes at D = 160 (a width that is neither 128 nor
    256) on `narrow` images, each through the 3xTF32 and the bf16 instance.
    Every distance is an integer, so indices and distances of both must
    EQUAL the plain version's; the matcher then runs binary descriptors on
    the bf16 instance (`ops/matching._kernel_dtype`). Returns records as
    `b1_record` for the D = 256 pooled and pair-list runs of the bf16
    instance, with the 3xTF32 instance's time beside it."""
    import torch

    from autopanostitch_tpu_torch.kernels import knn as KN

    rng = np.random.default_rng(2)
    rec = {}
    for D, n in ((256, n_img), (160, narrow)):
        F = n * K
        desc = torch.as_tensor((rng.random((F, D)) < 0.5).astype(np.float32), device=dev)
        ids = np.repeat(np.arange(n, dtype=np.int32), K)
        qid = torch.as_tensor(np.where(rng.random(F) < 0.1, -2, ids).astype(np.int32), device=dev)
        valid = torch.as_tensor(rng.random((n, K)) > 0.1, device=dev)
        pairs = torch.as_tensor(np.stack(np.triu_indices(n, 1), -1).astype(np.int32), device=dev)
        slots = desc.reshape(n, K, D)
        pooled_p, pair_p = KN.knn_plain(desc, qid, desc, qid, 4), KN.knn_pairs_plain(slots, valid, pairs, 2)
        for cd in ("float32", "bfloat16"):
            pooled_k = KN.knn(desc, qid, desc, qid, 4, compute_dtype=cd)
            pair_k = KN.knn_pairs(slots, valid, pairs, 2, compute_dtype=cd)
            sync(dev)
            for mode, got, ref in (("pooled", pooled_k, pooled_p), ("pairs", pair_k, pair_p)):
                same_i, same_d = bool(torch.equal(got[0], ref[0])), bool(torch.equal(got[1], ref[1]))
                log(f"B1 binary D={D} {mode} {cd} instance: indices identical={same_i} "
                    f"distances identical={same_d}")
                if not (same_i and same_d):
                    raise AssertionError(f"B1 D={D} {mode} {cd} on binary descriptors differs "
                                         "from plain")
        del pooled_k, pooled_p, pair_k, pair_p
        if D != 256:
            continue
        P = pairs.shape[0]
        pl = pairs.long()
        qs = torch.cat([slots[pl[:, 0]], slots[pl[:, 1]]])
        ts = torch.cat([slots[pl[:, 1]], slots[pl[:, 0]]])
        bf = "bfloat16"
        runs = {
            "pooled": (lambda: KN.knn(desc, qid, desc, qid, 4, compute_dtype=bf),
                       lambda: KN.knn(desc, qid, desc, qid, 4),
                       lambda: library_knn(desc, desc, 4), lambda: torch.mm(desc, desc.T),
                       lambda: KN.knn_plain(desc, qid, desc, qid, 4),
                       2.0 * F * F * D, F * D * 4 + F * 4 + F * 4 * 8,
                       f"binary pooled: F={F} ({n} x {K}) D={D} k=4"),
            "pairs": (lambda: KN.knn_pairs(slots, valid, pairs, 2, compute_dtype=bf),
                      lambda: KN.knn_pairs(slots, valid, pairs, 2),
                      lambda: library_knn(qs, ts, 2), lambda: torch.bmm(qs, ts.transpose(1, 2)),
                      lambda: KN.knn_pairs_plain(slots, valid, pairs, 2),
                      2.0 * 2 * P * K * K * D, n * K * (D * 4 + 1) + P * 8 + P * 2 * K * 2 * 8,
                      f"binary pairs: {n} images x {K} slots, {P} pairs x 2 directions, D={D}"),
        }
        for mode, (kern, tf32, lib, mm, plain, flop, nbytes, label) in runs.items():
            times = {"kernel": time_ms(kern, dev), "tf32": time_ms(tf32, dev),
                     "library": time_ms(lib, dev), "mm": time_ms(mm, dev),
                     "plain": time_ms(plain, dev, reps=3)}
            rec[mode] = b1_record(label + " (bf16 instance)", flop, nbytes, 0.0, 0, times,
                                  one_product=True, D=D)
            rec[mode]["tf32_ms"] = times["tf32"]
        del qs, ts
    return rec


def phase_b1_bf16(dev, F: int, n_img: int, pairs_shape):
    """Phase 3d: B1's bf16 instance (compute_dtype="bfloat16") against the
    plain bf16 version at phase 3's pooled shape (k = 4) and phase 3b's pair
    list: indices identical outside 1e-5 ties, distances within 1e-5
    relative. Timed beside `cdist` + `topk` and a bare bf16 `mm` / `bmm`,
    bound by one bf16 product at 989 TFLOP/s. Returns {"pooled": record,
    "pairs": record} as `b1_record`."""
    import torch

    from autopanostitch_tpu_torch.kernels import knn as KN

    bf = "bfloat16"
    desc, qid, _, _ = pooled_inputs(dev, F, n_img)
    pdesc, valid, pairs = pair_inputs(dev, *pairs_shape)
    n_p, Kc = pairs_shape
    P = pairs.shape[0]
    pl = pairs.long()
    rec = {}
    for mode in ("pooled", "pairs"):
        if mode == "pooled":
            kern = lambda: KN.knn(desc, qid, desc, qid, 4, compute_dtype=bf)  # noqa: E731
            plain = lambda k=4: KN.knn_plain(desc, qid, desc, qid, k, compute_dtype=bf)  # noqa: E731
            q = t = desc
            flop, nbytes = 2.0 * F * F * 128, F * 128 * 4 + F * 4 + F * 4 * 8
            label = f"bf16 pooled: F={F} D=128 k=4"
        else:
            kern = lambda: KN.knn_pairs(pdesc, valid, pairs, 2, compute_dtype=bf)  # noqa: E731
            plain = lambda k=2: KN.knn_pairs_plain(pdesc, valid, pairs, k, compute_dtype=bf)  # noqa: E731
            q = torch.cat([pdesc[pl[:, 0]], pdesc[pl[:, 1]]])
            t = torch.cat([pdesc[pl[:, 1]], pdesc[pl[:, 0]]])
            flop = 2.0 * 2 * P * Kc * Kc * 128
            nbytes = n_p * Kc * (128 * 4 + 1) + P * 8 + P * 2 * Kc * 2 * 8
            label = f"bf16 pairs: {n_p} images x {Kc} slots, {P} pairs x 2 directions, k=2"
        idx_k, d_k = kern()
        k = idx_k.shape[-1]
        idx_p, d_p = plain(k + 1)
        sync(dev)
        rel, bad, over = bf16_agreement(idx_k.reshape(-1, k), d_k.reshape(-1, k),
                                        idx_p.reshape(-1, k + 1), d_p.reshape(-1, k + 1))
        del idx_p, d_p
        qb, tb = q.to(torch.bfloat16), t.to(torch.bfloat16)
        mm = ((lambda: torch.mm(qb, tb.T)) if mode == "pooled"
              else (lambda: torch.bmm(qb, tb.transpose(1, 2))))
        times = {"kernel": time_ms(kern, dev), "library": time_ms(lambda: library_knn(q, t, k), dev),
                 "mm": time_ms(mm, dev), "plain": time_ms(plain, dev, reps=3)}
        del qb, tb
        log(f"B1 {label}: max relative distance difference {rel:.3e} (gate 1e-5), distances "
            f"beyond it {over}, idx mismatches outside ties {bad}; mm is a bare bf16 product")
        rec[mode] = b1_record(label, flop, nbytes, rel, bad, times, one_product=True)
        if bad or over:
            raise AssertionError(f"B1's bf16 instance ({mode}) disagrees with its plain version")
    return rec


def phase_b1_shapes(dev, F: int, n_img: int):
    """Phase 3e: descriptor widths the kernel takes zero-padded (D = 16, a
    2x2x4 SIFT grid, and 72, a 3x3x8 one) and k = 12 (the K = 16 instance),
    each in both operand types, against the plain version: 3xTF32 with
    distances within 1e-4, bf16 within 1e-5 relative, indices identical
    outside ties. Returns {label: kernel ms}."""
    from autopanostitch_tpu_torch.kernels import knn as KN

    out = {}
    for D, k in ((16, 4), (72, 4), (128, 12)):
        desc, qid, _, _ = pooled_inputs(dev, F, n_img, D=D, seed=D + k)
        for cd in ("float32", "bfloat16"):
            idx_k, d_k = KN.knn(desc, qid, desc, qid, k, compute_dtype=cd)
            idx_p, d_p = KN.knn_plain(desc, qid, desc, qid, k + 1, compute_dtype=cd)
            sync(dev)
            if cd == "bfloat16":
                err, bad, over = bf16_agreement(idx_k, d_k, idx_p, d_p)
                gate = f"max relative distance difference {err:.3e} (gate 1e-5)"
                ok = not (bad or over)
            else:
                err, bad = knn_agreement(idx_k, d_k, idx_p, d_p)
                gate = f"max |dist diff| {err:.3e} (gate 1e-4)"
                ok = not bad and err <= 1e-4
            ms = time_ms(lambda: KN.knn(desc, qid, desc, qid, k, compute_dtype=cd), dev)
            label = f"D={D} k={k} {cd}"
            extra = ""
            if cd == "bfloat16":  # the card pads D to a multiple of 32 columns
                Dp = -(-D // 32) * 32
                nbytes = F * D * 4 + F * 4 + F * k * 8
                bound = bound_ms(2.0 * F * F * D, nbytes, BF16_FLOPS)[0]
                padded = bound_ms(2.0 * F * F * Dp, nbytes, BF16_FLOPS)[0]
                extra = (f", bound {bound:.3f} ms (one bf16 product at D={D}), share "
                         f"{bound / ms:.1%}; the same at the padded D={Dp} {padded:.3f} ms; "
                         f"{epilogue_bound(float(F) * F)}")
            log(f"B1 shapes {label}: F={F} {gate}, idx mismatches outside ties {bad}, "
                f"kernel {ms:.3f} ms{extra}")
            if not ok:
                raise AssertionError(f"B1 at {label} disagrees with its plain version")
            out[label] = ms
    return out


def phase_b2(dev, G: int, S3: int, H: int, W: int):
    """B2 kernel vs plain at the slice's window shapes (bit-exact)."""
    import torch

    from autopanostitch_tpu_torch.kernels import window_gather as WG

    g = torch.Generator(device=dev)
    g.manual_seed(0)
    src = torch.randn((G * S3, H, W, 2), generator=g, device=dev)
    rec = {}
    launches0 = WG.launches
    K = 1024  # the chunk of the unfused path
    for win in (40, 80):
        lev = torch.randint(0, G * S3, (K,), generator=g, device=dev, dtype=torch.int32)
        ys = torch.randint(0, H - win + 1, (K,), generator=g, device=dev, dtype=torch.int32)
        xs = torch.randint(0, W - win + 1, (K,), generator=g, device=dev, dtype=torch.int32)
        out_k = WG.gather_windows(src, lev, ys, xs, win, win)
        out_p = WG.gather_windows_plain(src, lev, ys, xs, win, win)
        exact = bool(torch.equal(out_k, out_p))
        err = float((out_k - out_p).abs().max())
        r = torch.arange(win, device=dev)
        L = lev.long()[:, None, None]
        Y = ys.long()[:, None, None] + r[None, :, None]
        X = xs.long()[:, None, None] + r[None, None, :]
        ms = time_ms(lambda: WG.gather_windows(src, lev, ys, xs, win, win), dev)
        library_ms = time_ms(lambda: src[L, Y, X], dev)
        plain_ms = time_ms(lambda: WG.gather_windows_plain(src, lev, ys, xs, win, win), dev)
        nbytes = 2 * K * win * win * 2 * 4 + 3 * K * 4  # windows read + written, starts read
        bound, by = bound_ms(0.0, nbytes)
        log(f"B2 win={win}: K={K} src={tuple(src.shape)} bit-exact={exact} "
            f"kernel {ms:.3f} ms library (src[L, Y, X]) {library_ms:.3f} ms plain {plain_ms:.3f} ms"
            f" | bound {bound:.4f} ms ({by}: {nbytes / 1e6:.1f} MB at {HBM_BYTES / 1e12:.2f} TB/s),"
            f" share {bound / ms:.1%}")
        if not exact:
            raise AssertionError(f"B2 win={win} is not bit-exact with its plain version")
        rec[win] = dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound,
                        bound_by=by)
    del src
    rec["launches"] = WG.launches - launches0
    return rec


# float32 operations per window pixel of the reference's arithmetic (counted
# in csrc/sift_window.cu's note) and the descriptor's tensor-core flops
ORI_OPS_PER_PX = 20
DESC_OPS_PER_PX = 57
DESC_MMA_FLOPS_PER_PX = 2 * 16 * 8


def b2_fused_inputs(dev, n_lev: int, H: int, W: int, K: int, win: int, seed: int):
    """A (n_lev, H, W, 2) magnitude/angle stack (mag >= 0, angle in
    (-pi, pi]) and K keypoints: windows sorted by level (the main path
    walks keypoints image by image), random in-window positions, sigma_rel
    in [1.6, 3.5], theta in [0, 2 pi)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    u = lambda *shape: torch.rand(shape, generator=g, device=dev)  # noqa: E731
    src = torch.stack([torch.randn((n_lev, H, W), generator=g, device=dev).abs(),
                       math.pi - 2 * math.pi * u(n_lev, H, W)], -1).contiguous()
    i32 = lambda x: x.to(torch.int32).contiguous()  # noqa: E731
    lev = i32(torch.sort(torch.randint(0, n_lev, (K,), generator=g, device=dev))[0])
    ys = i32(torch.randint(0, H - win + 1, (K,), generator=g, device=dev))
    xs = i32(torch.randint(0, W - win + 1, (K,), generator=g, device=dev))
    lx, ly = (win - 1) * u(K), (win - 1) * u(K)
    return src, lev, ys, xs, lx, ly, 1.6 + 1.9 * u(K), 2 * math.pi * u(K)


def window_cover_bytes(n_lev: int, H: int, W: int, lev, ys, xs, win: int) -> int:
    """Bytes of the (n_lev, H, W, 2) float32 stack that K (win, win) windows
    cover: the union of the windows, level by level (a 2-D difference array
    summed up), at 8 bytes a pixel."""
    import torch

    diff = torch.zeros((n_lev, H + 1, W + 1), dtype=torch.int32, device=lev.device)
    L, Y, X = lev.long(), ys.long(), xs.long()
    one = torch.ones(L.shape, dtype=torch.int32, device=lev.device)
    for dy, dx, sign in ((0, 0, 1), (0, win, -1), (win, 0, -1), (win, win, 1)):
        diff.index_put_((L, Y + dy, X + dx), sign * one, accumulate=True)
    cover = diff.cumsum(1, dtype=torch.int32).cumsum(2, dtype=torch.int32)[:, :H, :W] > 0
    return int(cover.sum()) * 8


def phase_b2_fused(dev, cases):
    """The fused B2 kernels against their plain versions on each case
    (label, levels, H, W, K, orientation win, descriptor win). Returns
    {"orient_hist": record, "descriptor": record} of the first case, with
    every case's error folded into max_abs_err."""
    import torch

    from autopanostitch_tpu_torch.kernels import sift_window as SW
    from autopanostitch_tpu_torch.kernels import window_gather as WG

    recs = {}
    for ci, (label, n_lev, H, W, K, win_o, win_d) in enumerate(cases):
        src, lev, ys, xs, lx, ly, srel, theta = b2_fused_inputs(dev, n_lev, H, W, K, win_d, ci)
        for name, win in (("orient_hist", win_o), ("descriptor", win_d)):
            # the orientation window sits inside the descriptor's
            args = (src, lev, ys, xs, lx * (win - 1) / (win_d - 1), ly * (win - 1) / (win_d - 1), srel)
            if name == "descriptor":
                args += (theta,)
            kern = getattr(SW, name)
            plain = getattr(SW, name + "_plain")
            out_k = kern(*args, win)
            again = kern(*args, win)
            out_p = plain(*args, win, chunk=1024)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            same = bool(torch.equal(out_k, again))
            diff = (out_k - out_p).abs()
            err = float(diff.max()) if K else 0.0
            if name == "orient_hist":
                scale = out_p.abs().amax(1, keepdim=True).clamp(min=1e-30)
                rel = float((diff / scale).max()) if K else 0.0
                ok, gate = rel <= 1e-5, f"max |diff| / row max {rel:.3e} (gate 1e-5)"
                n_out, ops = 36, ORI_OPS_PER_PX * K * win * win / FP32_FLOPS
            else:
                mean = float(diff.mean()) if K else 0.0
                ok = err <= 1e-4 and mean <= 1e-6
                gate = f"max |diff| {err:.3e} (gate 1e-4) mean {mean:.3e} (gate 1e-6)"
                n_out = 128
                ops = (DESC_OPS_PER_PX * K * win * win / FP32_FLOPS
                       + DESC_MMA_FLOPS_PER_PX * K * win * win / BF16_FLOPS)
            del out_p, again
            ms = time_ms(lambda: kern(*args, win), dev)
            unfused_ms = time_ms(lambda: plain(*args, win, chunk=1024, gather=WG.gather_windows),
                                 dev, reps=3)
            plain_ms = time_ms(lambda: plain(*args, win, chunk=1024), dev, reps=3)
            # the stack pixels the windows cover, read once; the per-keypoint
            # inputs read and the outputs written once
            covered = window_cover_bytes(n_lev, H, W, lev, ys, xs, win)
            nbytes = covered + K * 4 * len(args[1:]) + K * n_out * 4
            t_bytes = nbytes / HBM_BYTES * 1e3
            bound, by = (ops * 1e3, "operations") if ops * 1e3 >= t_bytes else (t_bytes, "bytes")
            route = SW.copy_route(src, win, name)
            log(f"B2 fused {name} {label}: K={K} win={win} src={tuple(src.shape)} copy {route}"
                f" | {gate} repeat bit-identical={same} | kernel {ms:.3f} ms unfused (B2 gather +"
                f" PyTorch binning) {unfused_ms:.3f} ms plain {plain_ms:.3f} ms | bound "
                f"{bound:.4f} ms ({by}; bytes {nbytes / 1e6:.1f} MB at {HBM_BYTES / 1e12:.2f} TB/s"
                f" {t_bytes:.4f} ms, of which the windows' union {covered / 1e6:.1f} MB of "
                f"{src.numel() * 4 / 1e6:.1f} MB; operations {ops * 1e3:.4f} ms), "
                f"share {bound / ms:.1%}")
            if not (ok and same):
                raise AssertionError(f"B2 fused {name} {label} disagrees with its plain version "
                                     f"or is not deterministic")
            if name in recs:
                recs[name]["err"] = max(recs[name]["err"], err)
                recs[name][label] = dict(err=err, ms=ms, unfused_ms=unfused_ms, plain_ms=plain_ms,
                                         bound_ms=bound, bound_by=by, K=K, win=win, copy=route)
            else:
                recs[name] = dict(err=err, ms=ms, plain_ms=plain_ms, unfused_ms=unfused_ms,
                                  library_ms=None, bound_ms=bound, bound_by=by, K=K, win=win,
                                  copy=route, window_union_bytes=covered)
        del src
    return recs


def config_with(config, fields: dict):
    """The default StitchConfig of a config module (the port's, or the JAX
    package's for its gates) with `fields` ({section: {field: value}})
    replaced."""
    import dataclasses

    base = config.StitchConfig()
    return base.replace(**{sec: dataclasses.replace(getattr(base, sec), **f)
                           for sec, f in fields.items()})


def ring_scene(n: int, f: float, w: int, h: int, env_hw, cutoff: float = 0.08):
    """n views of a 360-degree yaw ring of `synthdata.smooth_texture(7,
    *env_hw, cutoff)`. Phase 8 takes cutoff 0.2: at the default 0.08 FAST
    finds no corner, and on the blocky `synthdata.texture` BRIEF's matches
    are mostly wrong. Returns (ImageSet, env, true R)."""
    import synthdata

    from autopanostitch_tpu_torch.api import ImageSet

    env = synthdata.smooth_texture(7, *env_hw, cutoff=cutoff)
    views, Rs = [], []
    for i in range(n):
        R = synthdata.rot_y(i * 2 * np.pi / n).T
        views.append(synthdata.render_pinhole_from_equirect(env, R, f, w, h, "bicubic"))
        Rs.append(R)
    stack = (np.stack(views) * 255).astype(np.uint8)
    sizes = np.tile(np.array([h, w], np.int32), (n, 1))
    iset = ImageSet(images=stack, sizes=sizes, names=[f"v{k}" for k in range(n)])
    return iset, env, np.stack(Rs)


def _np(x):
    """numpy view of a torch tensor (any device) or an array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def pano_psnr(pr, env, Rs, f_true: float, mode: str = "spherical"):
    """(PSNR dB of panorama `pr` in `mode` against the gauge-aligned ground
    truth, max focal error %), computed as bench._pano_psnr does. Rs are
    the true rotations of the panorama's members, in member order."""
    import synthdata

    pano = pr["projections"][mode]
    cover = pr["coverage_by_mode"][mode]
    canvas = pr["canvas"][mode]
    R_est = np.asarray(pr["R_render"])
    M = sum(R_est[i].T @ Rs[i] for i in range(len(Rs)))
    U, _, Vt = np.linalg.svd(M)
    G = U @ Vt
    if np.linalg.det(G) < 0:
        U[:, -1] *= -1
        G = U @ Vt
    ys, xs = np.nonzero(cover)
    sub = np.random.default_rng(0).choice(len(ys), min(400000, len(ys)), replace=False)
    ys, xs = ys[sub], xs[sub]
    u = canvas["x0"] + xs / canvas["f_pan"]
    v = canvas["y0"] + ys / canvas["f_pan"]
    if mode == "cylindrical":
        d = np.stack([np.sin(u), v, np.cos(u)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    else:
        d = np.stack([np.cos(v) * np.sin(u), np.sin(v), np.cos(v) * np.cos(u)], -1)
    gt = synthdata.env_lookup(env, d @ G, interp="bicubic")
    err = pano[ys, xs].astype(np.float64) / 255.0 - gt
    psnr = 10 * np.log10(1.0 / max(np.mean(err**2), 1e-12))
    f_est = _np(pr["ba"]["cameras"].f)
    return psnr, float(np.abs(f_est - f_true).max() / f_true * 100)


def view_ring(env, n: int, f: float, w: int, h: int):
    """n pinhole views of a 360-degree yaw ring: (views, true R (n, 3, 3))."""
    import synthdata

    Rs = [synthdata.rot_y(i * 2 * np.pi / n).T for i in range(n)]
    return [synthdata.render_pinhole_from_equirect(env, R, f, w, h, "bicubic") for R in Rs], \
        np.stack(Rs)


def multipano_scene(n: int, f: float, w: int, h: int, env_hw, limit: int):
    """Two interleaved n-view rings (textures 7 and 8) and one distractor
    view (texture 9), ingested at `limit` px with the originals kept, as
    `api.image_set_from_arrays` does for a mixed-resolution folder.
    Returns (ImageSet, truth) with truth = [(global indices, env, Rs)] per
    ring."""
    import synthdata

    from autopanostitch_tpu_torch import api

    envs = [synthdata.smooth_texture(s, *env_hw) for s in (7, 8)]
    rings = [view_ring(e, n, f, w, h) for e in envs]
    views = [v for pair in zip(rings[0][0], rings[1][0]) for v in pair]
    env_c = synthdata.smooth_texture(9, *env_hw)
    views.append(synthdata.render_pinhole_from_equirect(env_c, synthdata.rot_x(0.4).T, f, w, h,
                                                        "bicubic"))
    iset = api.image_set_from_arrays(views, height_limit=limit, width_limit=limit,
                                          keep_originals=True)
    truth = [(np.arange(r, 2 * n, 2), envs[r], rings[r][1]) for r in range(2)]
    return iset, truth


def multipano_metrics(res, truth, f_true: float, modes):
    """Per ring: (members equal, focal error %, {mode: PSNR dB})."""
    out = []
    for idx, env, Rs in truth:
        pr = next((p for p in res.panoramas if set(np.asarray(p["members"])) == set(idx)), None)
        if pr is None:
            out.append((False, None, {}))
            continue
        psnr = {}
        for mode in modes:
            psnr[mode], ferr = pano_psnr(pr, env, Rs, f_true, mode)
        out.append((True, ferr, psnr))
    return out


def planar_scene(w: int, h: int, overlap: float, seed: int = 5):
    """3x3 grid of w x h crops of `synthdata.texture` overlapping by
    `overlap` in each direction. Returns (ImageSet, texture, offsets (9, 2))."""
    import synthdata

    from autopanostitch_tpu_torch.api import ImageSet

    sx, sy = round(w * (1 - overlap)), round(h * (1 - overlap))
    env = synthdata.texture(seed, h + 2 * sy, w + 2 * sx)
    offs = np.array([(c * sx, r * sy) for r in range(3) for c in range(3)], np.float64)
    views = synthdata.planar_crops(env, [(int(x), int(y), w, h) for x, y in offs])
    stack = (np.stack(views) * 255 + 0.5).astype(np.uint8)
    sizes = np.tile(np.array([h, w], np.int32), (9, 1))
    return ImageSet(images=stack, sizes=sizes, names=[f"p{k}" for k in range(9)]), env, offs


def planar_metrics(pr, env, offs, w: int, h: int):
    """(max corner error px of H_abs against the true translations, PSNR dB
    of the planar panorama against the texture over covered pixels, the
    same with the texture sampled bilinearly). The gated PSNR samples the
    texture as the renderer samples the crops (Keys bicubic): the texture
    is piecewise constant, and where the canvas origin sits a sub-pixel
    phase off the texture's grid a bilinear ground truth differs from any
    bicubic render by up to ~4 dB of PSNR, whatever the registration."""
    import synthdata

    H = np.asarray(pr["H_abs"], np.float64)
    a = int(pr["anchor"])
    corners = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]], np.float64)
    err = 0.0
    for k in range(len(offs)):
        p = corners @ H[k].T
        p = p[:, :2] / p[:, 2:]
        err = max(err, float(np.abs(p - (corners[:, :2] + offs[k] - offs[a])).max()))
    pano, cover = pr["projections"]["planar"], pr["coverage_by_mode"]["planar"]
    x0, y0 = pr["offset"]
    s = pr["scale"]
    ys, xs = np.nonzero(cover)
    got = pano[ys, xs].astype(np.float64) / 255.0
    x, y = (xs + x0) / s + offs[a][0], (ys + y0) / s + offs[a][1]
    psnr = [10 * np.log10(1.0 / max(np.mean((got - fn(env, x, y)) ** 2), 1e-12))
            for fn in (synthdata._bicubic_np, synthdata._bilinear_np)]
    return err, psnr[0], psnr[1]


def phase_slice(dev, n: int, f_true: float, w: int, h: int, env_hw):
    from autopanostitch_tpu_torch.api import StitchConfig

    t0 = time.perf_counter()
    iset, env, Rs = ring_scene(n, f_true, w, h, env_hw)
    log(f"slice: scene {n} views {w}x{h} f={f_true} built in {time.perf_counter() - t0:.1f} s")
    with record_ba({}) as ba_call, record_render([]) as renders:
        res, counts = run_stitch("slice", iset, StitchConfig(), dev)
    if len(res.panoramas) != 1 or len(res.panoramas[0]["members"]) != n:
        raise AssertionError(f"expected one {n}-view panorama, got components {res.components}")
    pano = res.panoramas[0]["panorama"]
    if not (pano.ndim == 3 and pano.shape[2] == 3 and pano.dtype == np.uint8):
        raise AssertionError(f"bad panorama {pano.shape} {pano.dtype}")
    psnr, ferr = pano_psnr(res.panoramas[0], env, Rs, f_true)
    acc = int(np.asarray(res.graph.accepted).sum())
    log(f"slice: 1 panorama of {n}, canvas {pano.shape[:2]}, accepted pairs {acc}/"
        f"{len(res.graph.pairs)}, max focal error {ferr:.4f} %, PSNR {psnr:.3f} dB")
    if not ferr < 1.0:
        raise AssertionError(f"focal error {ferr:.3f} % >= 1 %")
    if not psnr >= 40.0:
        raise AssertionError(f"PSNR {psnr:.2f} dB < 40 dB")
    require_launches("slice", counts, ("knn", "orient_hist", "descriptor", "ba_system"), dev)
    split = features_split(iset.images, iset.sizes, dev)
    log("slice: features stage split s " + json.dumps(split))
    return counts, res.features, ba_call, renders[0]


def ring_gates(label: str, res, env, Rs, n: int, f_true: float, psnr_min: float, jax=None):
    """One panorama of all n views, focal error < 1 %, PSNR >= psnr_min."""
    panos = sorted(sorted(np.asarray(p["members"]).tolist()) for p in res.panoramas)
    full = [p for p in res.panoramas if len(p["members"]) == n]
    psnr, ferr = pano_psnr(full[0], env, Rs, f_true) if full else (float("nan"),) * 2
    log(f"{label}: panoramas of {[len(p) for p in panos]} views, accepted pairs "
        f"{int(np.asarray(res.graph.accepted).sum())}/{len(res.graph.pairs)}, max focal error "
        f"{ferr:.4f} %, PSNR {psnr:.3f} dB (gate {psnr_min:.2f})"
        + (f" (JAX on a CPU: {json.dumps(jax)})" if jax else ""))
    if panos != [list(range(n))]:
        raise AssertionError(f"{label}: expected one panorama of {n}, got components "
                             f"{np.asarray(res.components).tolist()}")
    if not (ferr < 1.0 and psnr >= psnr_min):
        raise AssertionError(f"{label}: focal error {ferr:.3f} % or PSNR {psnr:.2f} dB")
    return psnr, ferr


def phase_ring_options(dev, n: int, f_true: float, w: int, h: int, env_hw, feats, gates):
    """Phase 5b: the pooled matcher on phase 5's ring features, exhaustive
    float32 (B1), compute_dtype="bfloat16" (B1's bf16 instance) and the
    approximate method (plain PyTorch), each timed (median of 3 on the host
    clock, ending in a synchronize) with its `nn_idx` agreement with the
    exhaustive run; then the ring stitched with each option set of
    RING_OPTIONS: one panorama of n, focal error < 1 %, PSNR >= 40 dB.
    `gates` (None in the rehearsal) holds the JAX package's results.
    Returns {name: launch counts}."""
    from autopanostitch_tpu_torch import config
    from autopanostitch_tpu_torch.ops import matching as mt

    valid = feats.mask.reshape(-1).cpu().numpy()
    ref = None
    for name, kw in (("exhaustive", {}), ("bf16", {"compute_dtype": "bfloat16"}),
                     ("approximate", {"method": "approximate"})):
        def run():
            out = mt.global_match_stack(feats.desc, feats.mask, k=4, **kw)
            sync(dev)
            return out

        out = run()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            walls.append((time.perf_counter() - t0) * 1e3)
        nn = out[0].cpu().numpy()
        ref = nn if ref is None else ref
        rows = (nn == ref).all(1)[valid]
        first = (nn[:, 0] == ref[:, 0])[valid]
        log(f"ring matcher {name}: {float(np.median(walls)):.3f} ms (host clock, median of 3), "
            f"nn_idx rows equal to the exhaustive run {rows.mean():.4%}, first neighbour "
            f"{first.mean():.4%} of {int(valid.sum())} valid queries, accepted "
            f"{int(out[3].sum())}")
    iset, env, Rs = ring_scene(n, f_true, w, h, env_hw)
    out = {}
    for name, fields in RING_OPTIONS.items():
        res, counts = run_stitch(f"ring_{name}", iset, config_with(config, fields), dev)
        ring_gates(f"ring_{name}", res, env, Rs, n, f_true, 40.0, gates and gates[name])
        need = ("orient_hist", "descriptor", "ba_system") + (("knn_bf16",) if name == "bf16"
                                                            else ())
        require_launches(f"ring_{name}", counts, need, dev)
        if name == "approximate" and counts["knn"]:
            raise AssertionError(f"the approximate matcher launched B1: {counts}")
        out[name] = counts
    return out


def phase_cli(dev, n: int, f_true: float, w: int, h: int, env_hw):
    """Phase 10: the command line on a folder of the n-view ring (PNG
    files), twice with one stage cache: `python -m
    autopanostitch_tpu_torch.cli <folder> --device <dev> --cache <dir>
    --show-adjacency --show-keypoints`. The second run resumes from the
    cache and must write the same file names and the same panorama within
    40 dB PSNR of the first run's. Then a config-driven stitch of the ring
    with `show_panorama_imgs_nums` must add the annotated panorama."""
    import subprocess
    import tempfile

    from autopanostitch_tpu_torch import config
    from autopanostitch_tpu_torch.utils import image_io

    iset, env, Rs = ring_scene(n, f_true, w, h, env_hw)
    with tempfile.TemporaryDirectory(prefix="apst_cli_") as tmp:
        folder = os.path.join(tmp, "ring")
        os.makedirs(folder)
        for k in range(n):
            image_io.save_image(os.path.join(folder, f"v{k:02d}.png"), iset.images[k])
        files, panos = [], []
        for r in range(2):
            out = os.path.join(tmp, f"out{r}")
            cmd = [sys.executable, "-m", "autopanostitch_tpu_torch.cli", folder, "--device", dev.type,
                   "--cache", os.path.join(tmp, "cache"), "--show-adjacency", "--show-keypoints",
                   "--out", out]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=900)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"cli run {r} exited {proc.returncode}:\n{proc.stdout[-3000:]}"
                                     f"\n{proc.stderr[-3000:]}")
            stages = [ln.strip() for ln in proc.stdout.splitlines() if "execution time" in ln]
            files.append(sorted(os.listdir(out)))
            panos.append(image_io.load_image(os.path.join(out, "spherical_ring_0.png")))
            log(f"cli run {r}: {wall:.1f} s of process wall time, {len(files[-1])} files "
                f"{files[-1][:3]}..., {'; '.join(stages)}")
        cached = sorted(f.split("_", 1)[1] for f in os.listdir(os.path.join(tmp, "cache")))
    same = panos[0].shape == panos[1].shape
    mse = float(np.mean((panos[0] - panos[1]) ** 2)) if same else float("nan")
    psnr = 10 * np.log10(1.0 / max(mse, 1e-12)) if same else float("nan")
    log(f"cli: cache {cached}; second run's panorama {panos[1].shape} against the first's "
        f"{panos[0].shape}: identical={same and mse == 0.0}, PSNR {psnr:.2f} dB (gate 40)")
    want = {"spherical_ring_0.png", "adjacency_ring.png"} | {f"keypoints_ring_v{k:02d}.png"
                                                              for k in range(n)}
    if files[0] != files[1] or set(files[0]) != want:
        raise AssertionError(f"cli files {files}")
    if not psnr >= 40.0:
        raise AssertionError(f"cli: the resumed panorama differs from the first ({psnr:.2f} dB)")
    res, counts = run_stitch("annotated", iset,
                             config_with(config, {"post": {"show_panorama_imgs_nums": True}}), dev)
    pr = res.panoramas[0]
    ann, pano = pr["projections_annotated"]["spherical"], pr["projections"]["spherical"]
    drawn = int((ann != pano).any(-1).sum())
    log(f"annotated: panorama {pano.shape}, annotated {ann.shape}, {drawn} pixels drawn")
    if ann.shape != pano.shape or drawn < 1000:
        raise AssertionError("the annotated panorama is missing or empty")
    require_launches("annotated", counts, ("knn", "orient_hist", "descriptor", "ba_system"), dev)
    return counts


def phase_pano100(dev, n: int, f_true: float, w: int, h: int, env_hw, gate):
    """Phase 9: the 100-view ring of `bench.build_pano` with its config
    (PANO100): one panorama of n, focal error < 1 %, PSNR >= 40 dB and >=
    the JAX package's on a CPU less 3 dB (`gate`, None in the rehearsal).
    Prints the stage split and the gap to the TPU record (history)."""
    from autopanostitch_tpu_torch import config

    t0 = time.perf_counter()
    iset, env, Rs = ring_scene(n, f_true, w, h, env_hw)
    log(f"pano100: scene {n} views {w}x{h} f={f_true} built in {time.perf_counter() - t0:.1f} s")
    if dev.type == "cuda":
        import torch

        torch.cuda.reset_peak_memory_stats(dev)
    with record_ba({}) as ba_call:
        res, counts = run_stitch("pano100", iset, config_with(config, PANO100), dev)
    if dev.type == "cuda":
        from autopanostitch_tpu_torch.utils import timing

        log(f"pano100: device memory MB {json.dumps(timing.report_device_memory(device=dev))}")
    psnr_min = max(40.0, gate["psnr"] - 3.0) if gate else 35.0
    psnr, _ = ring_gates("pano100", res, env, Rs, n, f_true, psnr_min, gate)
    log(f"pano100: PSNR {psnr:.3f} dB, {psnr - PANO100_TPU_PSNR:+.3f} dB from the JAX package's "
        f"TPU v5e record {PANO100_TPU_PSNR} dB (history, not a target)")
    require_launches("pano100", counts, ("knn", "orient_hist", "descriptor", "ba_system"), dev)
    return counts, stitch_record(res), ba_call


def stitch_record(res) -> dict:
    """What phase 11 holds a stitch of one panorama to: its graph, members,
    focals and spherical panorama, numpy."""
    pr = res.panoramas[0]
    return {"pairs": np.asarray(res.graph.pairs), "accepted": np.asarray(res.graph.accepted),
            "H": np.asarray(res.graph.H), "members": np.asarray(pr["members"]),
            "f": _np(pr["ba"]["cameras"].f), "pano": pr["projections"]["spherical"]}


def same_stitch(label: str, got: dict, ref: dict, ref_label: str) -> bool:
    """tests/test_parallel.py's end-to-end tolerances: the same members,
    pairs and accepted pairs, f within 5e-4 relative, the panoramas of one
    shape and within 1 uint8 LSB on average. Prints the comparison; returns
    whether the two are bit-identical (graph, f and panorama)."""
    shape_ok = got["pano"].shape == ref["pano"].shape
    mad = (float(np.abs(got["pano"].astype(np.int16) - ref["pano"].astype(np.int16)).mean())
           if shape_ok else float("inf"))
    f_rel = float(np.abs(got["f"] / ref["f"] - 1).max()) if got["f"].shape == ref["f"].shape \
        else float("inf")
    same = {k: got[k].shape == ref[k].shape and bool((got[k] == ref[k]).all())
            for k in ("members", "pairs", "accepted", "H", "f", "pano")}
    log(f"{label} vs {ref_label}: members/pairs/accepted equal {same['members']}/{same['pairs']}/"
        f"{same['accepted']}, max |f rel diff| {f_rel:.3e} (gate 5e-4), panorama mean |diff| "
        f"{mad:.4f} LSB (gate 1), bit-identical {all(same.values())}")
    if not (same["members"] and same["pairs"] and same["accepted"] and f_rel <= 5e-4
            and mad < 1.0):
        raise AssertionError(f"{label} differs from {ref_label}")
    return all(same.values())


def sync(dev) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def phase_timers(dev, spent: dict):
    """Wrap SIFT's window phases (`ops.sift._orientation_phase` /
    `_descriptor_phase`) with synchronising timers that add their seconds
    to spent["orientation"] / spent["descriptor"]."""
    from autopanostitch_tpu_torch.ops import sift

    def timed(fn, key):
        def run(*args, **kw):
            sync(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync(dev)
            spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
            return out
        return run

    names = {"_orientation_phase": "orientation", "_descriptor_phase": "descriptor"}
    saved = {n: getattr(sift, n) for n in names}
    try:
        for n, key in names.items():
            setattr(sift, n, timed(saved[n], key))
        yield
    finally:
        for n, fn in saved.items():
            setattr(sift, n, fn)


def features_split(images, sizes, dev, reps: int = 3) -> dict:
    """The feature stage of (N, H, W, 3) uint8 `images` on `dev`, seconds:
    its wall time with no timers inside, then the same run split into the
    orientation phase, the descriptor phase and the rest (pyramid,
    gradients, detection, selection), each phase ending in a synchronize;
    medians of `reps` runs after a warm-up, and the window phases' kernel
    launches of one run."""
    import torch

    from autopanostitch_tpu_torch import kernels
    from autopanostitch_tpu_torch.config import DetectorConfig
    from autopanostitch_tpu_torch.models import features

    imgs = torch.as_tensor(images, device=dev)

    def run():
        sync(dev)
        t0 = time.perf_counter()
        features.extract_features(imgs, sizes, DetectorConfig())
        sync(dev)
        return time.perf_counter() - t0

    run()  # warm-up
    walls = [run() for _ in range(reps)]
    splits = []
    for _ in range(reps):
        spent = {}
        with phase_timers(dev, spent):
            kernels.reset_launch_counts()
            total = run()
        splits.append(dict(total=total, **spent))
    counts = {k: v for k, v in kernels.launch_counts().items() if not k.startswith("knn")}
    med = {k: float(np.median([s[k] for s in splits])) for k in splits[0]}
    return dict(features=float(np.median(walls)), orientation=med["orientation"],
                descriptor=med["descriptor"],
                rest=med["total"] - med["orientation"] - med["descriptor"], launches=counts)


def run_stitch(label: str, iset, cfg, dev, mesh=None):
    """`api.stitch` (with a mesh `api.stitch_multichip`) with the kernels'
    launch counts taken from 0; prints the stage times and counts. Returns
    (result, counts)."""
    from autopanostitch_tpu_torch import api, kernels
    from autopanostitch_tpu_torch.models import bundle
    from autopanostitch_tpu_torch.models.pipeline import StageTimer

    timer = StageTimer(dev)
    kernels.reset_launch_counts()
    bundle.graph_captures = bundle.graph_replays = 0
    t0 = time.perf_counter()
    if mesh is None:
        res = api.stitch(iset, cfg, seed=0, device=str(dev), timer=timer)
    else:
        res = api.stitch_multichip(iset, cfg, mesh=mesh, seed=0, timer=timer)
    wall = time.perf_counter() - t0
    counts = dict(kernels.launch_counts(), ba_graph_captures=bundle.graph_captures,
                  ba_graph_replays=bundle.graph_replays)
    log(f"{label}: stage s (stream) " + json.dumps({k: round(v, 4) for k, v in timer.report().items()})
        + f" total {wall:.3f}")
    log(f"{label}: kernel launches in the stitch {json.dumps(counts)}")
    log(f"{label}: render {timer.report().get('render', 0.0):.4f} s, launches "
        + ", ".join(f"{k} {counts[k]}" for k in RENDER_KERNELS)
        + f", plain render versions on the card {counts['render_plain_on_cuda']}")
    log(f"{label}: bundle_adjustment {timer.report().get('bundle_adjustment', 0.0):.4f} s, "
        f"ba_system launches {counts['ba_system']}, LM phase graphs captured "
        f"{counts['ba_graph_captures']}, replayed {counts['ba_graph_replays']}")
    return res, counts


@contextlib.contextmanager
def record_ba(store: dict):
    """Record, in `store`, the arguments and the result of the last call of
    the bundle adjustment's `run_incremental_ba` made inside."""
    from autopanostitch_tpu_torch.models import bundle

    saved = bundle.run_incremental_ba

    def run(*args, **kw):
        out = saved(*args, **kw)
        store.update(args=args, kw=kw, out=out)
        return out

    bundle.run_incremental_ba = run
    try:
        yield store
    finally:
        bundle.run_incremental_ba = saved


@contextlib.contextmanager
def record_render(store: list):
    """Append (args, kwargs) of every `models.render.render_rotational` call
    made inside to `store`."""
    from autopanostitch_tpu_torch.models import render

    saved = render.render_rotational

    def run(*args, **kw):
        store.append((args, kw))
        return saved(*args, **kw)

    render.render_rotational = run
    try:
        yield store
    finally:
        render.render_rotational = saved


@contextlib.contextmanager
def record_bands(store: list):
    """Append the arguments (by name, defaults applied) of every
    `models.planar.composite_band` call made inside to `store`."""
    import inspect

    from autopanostitch_tpu_torch.models import planar

    saved = planar.composite_band
    sig = inspect.signature(saved)

    def run(*args, **kw):
        bound = sig.bind(*args, **kw)
        bound.apply_defaults()
        store.append(dict(bound.arguments))
        return saved(*args, **kw)

    planar.composite_band = run
    try:
        yield store
    finally:
        planar.composite_band = saved


def ba_phase_inputs(rec: dict, dev):
    """The inputs of the last (largest) LM phase of a recorded bundle
    adjustment, all its cameras, linearized at its result: (spec, inputs,
    pd, cfg)."""
    import torch

    from autopanostitch_tpu_torch.models import bundle as tba

    _, f_init, cx, cy, u_i, u_j, w, loc_pairs, order, seed, cfg = rec["args"]
    spec = tba._phase_spec(len(f_init), loc_pairs, tba.pair_extents(w), order, seed, None,
                           cfg.focal_step_fracs[-1], tba._K1_STEP_CAP, float(cfg.lambda0), 0)
    R, f, k1, _ = rec["out"]

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    inp = tba._phase_inputs(spec, t(spec.ints, torch.long), t(spec.floats), R, f,
                            torch.zeros_like(f) if k1 is None else k1, t(cx), t(cy), t(u_i),
                            t(u_j), t(w))
    return spec, inp, 5 if rec["kw"].get("with_k1") else 4, cfg


def ba_normals_error(got, ref) -> float:
    """`ba_normals`' largest difference to a reference, each entry over its
    Cauchy-Schwarz scale: sqrt(JtJ_aa JtJ_bb) for JtJ, sqrt(JtJ_aa cost)
    for Jtg, the cost for the cost."""
    JtJ, Jtg, cost = (x.double().cpu() for x in got)
    rJ, rg, rc = (x.double().cpu() for x in ref)
    d = (rJ.diagonal(dim1=1, dim2=2).clamp(min=0) + 1e-30).sqrt()
    return float(max(((JtJ - rJ).abs() / (d[:, :, None] * d[:, None, :])).max(),
                     ((Jtg - rg).abs() / (d * (rc.clamp(min=0) + 1e-30).sqrt()[:, None])).max(),
                     ((cost - rc).abs() / (rc.abs() + 1e-30)).max()))


def ba_system_error(got, ref) -> float:
    """`ba_system`'s largest difference to a reference, each entry over its
    Cauchy-Schwarz scale: sqrt(H_aa H_bb) for H, sqrt(H_aa cost) for g, the
    cost for the cost."""
    H, g, cost = (x.double().cpu() for x in got)
    rH, rg, rc = (x.double().cpu() for x in ref)
    d = (rH.diagonal().clamp(min=0) + 1e-30).sqrt()
    return float(max(((H - rH).abs() / (d[:, None] * d[None, :])).max(),
                     ((g - rg).abs() / (d * (rc.clamp(min=0) + 1e-30).sqrt())).max(),
                     (cost - rc).abs() / (rc.abs() + 1e-30)))


def phase_ba(dev, recs: dict) -> dict:
    """Phase 9b: the bundle adjustment of phases 5 (the ring) and 9
    (pano100), from their recorded inputs, at each one's largest LM phase
    (the ring: nb 64, pb 64, M 300; pano100: nb 128, pb 128, M 256; pd 5).
    `ba_system` (the LM's linearisation: H, g, cost) and, off the main path,
    `ba_normals` (per-pair blocks), each against its plain version and both
    against the plain version in float64 (`ba_system_error`,
    `ba_normals_error`: no more than twice the float32 plain version's own
    error, or 1e-5), a repeat launch bit-identical. Times on the device:
    `ba_system`, the per-pair linearisation (`ba_normals` + the one-hot einsum
    assembly + the cost's sum) and `ba_normals` alone, each a launch from a
    CUDA graph of GRAPH_LAUNCHES (`graph_ms`), beside an empty kernel's (the
    launch floor) and the bound; the same kernels and the plain versions
    with `time_ms`. Then each whole BA again, eagerly and replayed from the
    cached CUDA graphs: R, f, k1 and cost bit-identical to each other and to
    the stitch's own, each wall-timed (host clock, ending in a synchronize).
    Returns {scene: record}."""
    import torch

    from autopanostitch_tpu_torch.kernels import ba as kba
    from autopanostitch_tpu_torch.models import bundle as tba

    def f64(args):
        return tuple(a.double() if torch.is_tensor(a) and a.dtype == torch.float32 else a
                     for a in args)

    smi = nvidia_smi()
    if dev.type == "cuda":
        from autopanostitch_tpu_torch.utils import timing

        floor = timing.launch_floor_ms(GRAPH_LAUNCHES)
    else:
        floor = None
    out = {}
    for name, rec in recs.items():
        spec, inp, pd, cfg = ba_phase_inputs(rec, dev)
        pair_args = tuple(inp[k] for k in ("Rb", "f", "k1", "cx", "cy", "u_i", "u_j", "w", "pij"))
        opts = (pd, float(cfg.sigma_huber), bool(cfg.residual_one_direction))
        sys_args = pair_args + (inp["ext"], inp["inc_off"], inp["inc"]) + opts
        nrm_args = pair_args + opts
        checks = {}
        for label, kern, plain, error in (
                ("ba_system", kba.ba_system, kba.ba_system_plain, ba_system_error),
                ("ba_normals", kba.ba_normals, kba.ba_normals_plain, ba_normals_error)):
            args = sys_args if label == "ba_system" else nrm_args
            got, again, ref, ref64 = kern(*args), kern(*args), plain(*args), plain(*f64(args))
            sync(dev)
            checks[label] = dict(repeat=all(torch.equal(a, b) for a, b in zip(got, again)),
                                 err=error(got, ref), err64=error(got, ref64),
                                 plain_err64=error(ref, ref64))
        E = kba.camera_map(inp["pij"], spec.nb, torch.float32)
        times = {"ba_system": graph_ms(lambda: kba.ba_system(*sys_args), dev),
                 "per_pair_path": graph_ms(lambda: kba.assemble_plain(*kba.ba_normals(*nrm_args), E),
                                       dev),
                 "ba_normals": graph_ms(lambda: kba.ba_normals(*nrm_args), dev),
                 "ba_system_events": time_ms(lambda: kba.ba_system(*sys_args), dev),
                 "ba_normals_events": time_ms(lambda: kba.ba_normals(*nrm_args), dev),
                 "plain": time_ms(lambda: kba.ba_system_plain(*sys_args), dev),
                 "normals_plain": time_ms(lambda: kba.ba_normals_plain(*nrm_args), dev)}
        M = inp["w"].shape[1]
        real = int((inp["w"] > 0).sum())
        slots = int(inp["ext"].sum())
        n2, n = 2 * pd, pd * spec.nb
        flop = real * BA_FLOPS_PER_MATCH[pd]
        # ba_system: the slots within the extents, cameras, pairs, extents and lists in;
        # H, g, cost out; plus the assembly's adds (each pair's four blocks and g parts)
        sys_bytes = (slots * (8 + 8 + 4) + spec.nb * 13 * 4 + spec.pb * (16 + 8 + 16)
                     + (spec.nb + 1) * 8 + (n * n + n + 1) * 4)
        sys_bound, sys_by = bound_ms(flop + spec.npair * (n2 * n2 + n2 + 1), sys_bytes,
                                     FP32_FLOPS)
        nrm_bytes = (spec.pb * M * (8 + 8 + 4) + spec.pb * 16 + spec.nb * 13 * 4
                     + spec.pb * (n2 * n2 + n2 + 1) * 4)
        nrm_bound, nrm_by = bound_ms(flop, nrm_bytes, FP32_FLOPS)
        c, cn = checks["ba_system"], checks["ba_normals"]
        log(f"ba_system {name}: phase (nb {spec.nb}, pb {spec.pb}, M {M}, pd {pd}), {real} real "
            f"matches of {spec.pb * M} slots ({slots} within the extents): max scaled diff to "
            f"plain {c['err']:.3e}, to the plain version in float64 {c['err64']:.3e} (the plain "
            f"version's own {c['plain_err64']:.3e}; gate: the larger of twice that and 1e-5), "
            f"repeat launch bit-identical {c['repeat']} | device ms a launch (a CUDA graph of "
            f"{GRAPH_LAUNCHES}): ba_system {times['ba_system']:.5f}, the per-pair path (ba_normals + "
            f"einsums + sum) {times['per_pair_path']:.5f}, ba_normals alone {times['ba_normals']:.5f}, "
            f"launch floor (empty kernel) {floor if floor is None else f'{floor:.5f}'}; "
            f"events after a sleep: ba_system {times['ba_system_events']:.5f}, ba_normals "
            f"{times['ba_normals_events']:.5f}; plain {times['plain']:.4f} | bound "
            f"{sys_bound * 1e3:.3f} us ({sys_by}: {sys_bytes / 1e6:.3f} MB at 3.35 TB/s, "
            f"{flop:.3e} float32 flop at 67 TFLOP/s), share {sys_bound / times['ba_system']:.3%} "
            f"| {smi}")
        log(f"ba_normals {name} (off the main path): max scaled diff to plain {cn['err']:.3e}, "
            f"to float64 {cn['err64']:.3e} (plain's own {cn['plain_err64']:.3e}), repeat "
            f"bit-identical {cn['repeat']}, bound {nrm_bound * 1e3:.3f} us ({nrm_by}), share "
            f"{nrm_bound / times['ba_normals']:.3%}")
        for label, ck in checks.items():
            if not (ck["repeat"] and ck["err64"] <= max(2 * ck["plain_err64"], 1e-5)):
                raise AssertionError(f"{label} {name}: differs from its plain version or itself")
        out[name] = dict(err=c["err"], err64=c["err64"], plain_err64=c["plain_err64"],
                         ms=times["ba_system"], events_ms=times["ba_system_events"],
                         plain_ms=times["plain"], library_ms=None, bound_ms=sys_bound,
                         bound_by=sys_by, per_pair_path_ms=times["per_pair_path"], launch_floor_ms=floor,
                         shape=[spec.nb, spec.pb, M, pd], matches=real,
                         normals=dict(err=cn["err"], err64=cn["err64"],
                                      plain_err64=cn["plain_err64"], ms=times["ba_normals"],
                                      events_ms=times["ba_normals_events"],
                                      plain_ms=times["normals_plain"], library_ms=None,
                                      bound_ms=nrm_bound, bound_by=nrm_by))
    for name, rec in recs.items():
        runs, walls = {}, {}
        for label, graphs in (("eager", False), ("graph", True)):
            sync(dev)
            t0 = time.perf_counter()
            runs[label] = tba.run_incremental_ba(*rec["args"], **dict(rec["kw"], graphs=graphs))
            sync(dev)
            walls[label] = time.perf_counter() - t0
        same = all((a is None and b is None and c is None) or (torch.equal(a, b) and torch.equal(b, c))
                   for a, b, c in zip(runs["eager"], runs["graph"], rec["out"]))
        log(f"ba {name}: the whole bundle adjustment eager {walls['eager']:.4f} s, replayed from "
            f"the cached graphs {walls['graph']:.4f} s; R, f, k1, cost bit-identical (eager, "
            f"graphs, the stitch) {same}; cost {float(runs['graph'][3]):.6g}")
        if not same:
            raise AssertionError(f"ba {name}: the graph-replayed BA differs from the eager one")
        out[name].update(eager_ba_s=walls["eager"], graph_ba_s=walls["graph"])
    return out


RENDER_KERNELS = ("render_sample", "mb_reduce", "mb_collapse")


def require_launches(label: str, counts: dict, names, dev, render=RENDER_KERNELS) -> None:
    """Fail unless every kernel of `names` and `render` (the rotational
    multiband render's kernels; none for the planar stitches' linear blend)
    launched in a run, or if `ba_normals`, off the main path since
    `ba_system`, did, or if a plain version of a render kernel ran on the
    card."""
    if dev.type == "cuda" and not all(counts[k] > 0 for k in tuple(names) + tuple(render)):
        raise AssertionError(f"{label}: a kernel of the path never launched: {counts}")
    if counts["ba_normals"]:
        raise AssertionError(f"{label}: ba_normals launched on the main path: {counts}")
    if dev.type == "cuda" and counts["render_plain_on_cuda"]:
        raise AssertionError(f"{label}: a plain render function ran on the card: {counts}")


def phase_multipano(dev, n: int, f_true: float, w: int, h: int, env_hw, limit: int,
                    psnr_min: float, compute_dtype: str = "float32", mesh=None):
    """Phase 6 (6b: with compute_dtype="bfloat16", the pair list on B1's
    bf16 instance; 11c: through `stitch_multichip` on `mesh`)."""
    from autopanostitch_tpu_torch import config

    label = "multipano" if compute_dtype == "float32" else "multipano_bf16"
    label += "" if mesh is None else "_multichip"
    t0 = time.perf_counter()
    iset, truth = multipano_scene(n, f_true, w, h, env_hw, limit)
    log(f"{label}: scene 2 x {n} views + 1 distractor, {w}x{h} ingested at "
        f"{iset.images.shape[2]}x{iset.images.shape[1]}, built in {time.perf_counter() - t0:.1f} s")
    modes = ("spherical", "cylindrical")
    cfg = config_with(config, {"render": {"projections": modes},
                               "tpu": {"compute_dtype": compute_dtype}})
    with record_render([]) as renders:
        res, counts = run_stitch(label, iset, cfg, dev, mesh)
    got = sorted(sorted(np.asarray(p["members"]).tolist()) for p in res.panoramas)
    log(f"{label}: components {np.asarray(res.components).tolist()}, panoramas {got}, "
        f"accepted pairs {int(np.asarray(res.graph.accepted).sum())}/{len(res.graph.pairs)}")
    for p in res.panoramas:
        log(f"{label}: panorama of {len(p['members'])} canvases "
            + str({m: p["projections"][m].shape[:2] for m in modes}))
    metrics = multipano_metrics(res, truth, f_true, modes)
    for r, (found, ferr, psnr) in enumerate(metrics):
        log(f"{label}: ring {r} found={found} focal error {ferr} % PSNR "
            + json.dumps({m: round(v, 3) for m, v in psnr.items()}))
    if len(res.panoramas) != 2 or not all(m[0] for m in metrics):
        raise AssertionError(f"expected the two rings as two panoramas, got {got}")
    if n * 2 in set(np.concatenate([np.asarray(p["members"]) for p in res.panoramas])):
        raise AssertionError("the distractor was stitched into a panorama")
    for found, ferr, psnr in metrics:
        if not ferr < 1.0:
            raise AssertionError(f"focal error {ferr:.3f} % >= 1 %")
        if not min(psnr.values()) >= psnr_min:
            raise AssertionError(f"PSNR {psnr} below {psnr_min} dB")
    need = ("knn", "knn_pairs", "orient_hist", "descriptor", "ba_system")
    if compute_dtype == "bfloat16":
        need += ("knn_bf16", "knn_pairs_bf16")
    require_launches(label, counts, need, dev)
    return counts, renders


def phase_planar(dev, w: int, h: int, psnr_min: float):
    """Phase 7: the 3x3 planar scan, linear blend. Returns the stitch's
    launch counts and the arguments of its middle `composite_band` call."""
    from autopanostitch_tpu_torch.api import BlendConfig, StitchConfig, StraightenConfig

    iset, env, offs = planar_scene(w, h, 0.35)
    cfg = StitchConfig(straighten=StraightenConfig(force_planar_scan=True),
                       blend=BlendConfig(mode="linear"))
    with record_bands([]) as bands:
        res, counts = run_stitch("planar", iset, cfg, dev)
    if len(res.panoramas) != 1 or len(res.panoramas[0]["members"]) != 9:
        raise AssertionError(f"expected one planar panorama of 9, got components {res.components}")
    pr = res.panoramas[0]
    err, psnr, psnr_bilinear = planar_metrics(pr, env, offs, w, h)
    log(f"planar: 1 panorama of 9, canvas {pr['panorama'].shape[:2]}, accepted pairs "
        f"{int(np.asarray(res.graph.accepted).sum())}/{len(res.graph.pairs)}, anchor "
        f"{pr['anchor']}, max corner error {err:.4f} px, PSNR {psnr:.3f} dB "
        f"(texture sampled bilinearly: {psnr_bilinear:.3f} dB)")
    if not err < 1.0:
        raise AssertionError(f"corner error {err:.3f} px >= 1 px")
    if not psnr >= psnr_min:
        raise AssertionError(f"PSNR {psnr:.2f} dB < {psnr_min} dB")
    require_launches("planar", counts, ("knn", "orient_hist", "descriptor"), dev, render=())
    return counts, bands[len(bands) // 2]


def phase_planar_models(dev, w: int, h: int, psnr_min: float):
    """Phase 7b: the 3x3 planar scan is a pure translation, so the
    translation and the affine model must stitch it as the projective one
    does (one panorama of 9, corner error < 1 px, PSNR at phase 7's gate)."""
    from autopanostitch_tpu_torch.api import BlendConfig, StitchConfig, StraightenConfig

    iset, env, offs = planar_scene(w, h, 0.35)
    out = []
    import dataclasses

    for model in ("translation", "affine"):
        cfg = StitchConfig(straighten=StraightenConfig(force_planar_scan=True),
                           blend=BlendConfig(mode="linear"))
        cfg = cfg.replace(image_match=dataclasses.replace(cfg.image_match,
                                                          transformation_type=model))
        res, counts = run_stitch(f"planar_{model}", iset, cfg, dev)
        if len(res.panoramas) != 1 or len(res.panoramas[0]["members"]) != 9:
            raise AssertionError(f"{model}: expected one planar panorama of 9, got components "
                                 f"{res.components}")
        err, psnr, _ = planar_metrics(res.panoramas[0], env, offs, w, h)
        log(f"planar_{model}: 1 panorama of 9, accepted pairs "
            f"{int(np.asarray(res.graph.accepted).sum())}/{len(res.graph.pairs)}, max corner error "
            f"{err:.4f} px, PSNR {psnr:.3f} dB (gate {psnr_min:.2f})")
        if not (err < 1.0 and psnr >= psnr_min):
            raise AssertionError(f"planar {model}: corner error {err:.3f} px or PSNR {psnr:.2f} dB")
        require_launches(f"planar_{model}", counts, ("knn", "orient_hist", "descriptor"), dev,
                         render=())
        out.append(counts)
    return out


def phase_detectors(dev, n: int, f_true: float, w: int, h: int, env_hw, cutoff: float, gates):
    """Phase 8: the ring stitched three times, with ORB + MLESAC + the
    adaptive RANSAC budget, with SURF and with KAZE. `gates` (None in the
    rehearsal) holds the JAX package's panoramas, focal errors and PSNRs
    (JAX_PHASE8): the same panoramas, focal error < 1 % and PSNR at least
    the JAX figure less 3 dB. ORB launches B1 and not B2; SURF and KAZE
    launch both. Returns {name: counts}."""
    from autopanostitch_tpu_torch import config
    from autopanostitch_tpu_torch.ops import ransac

    iset, env, Rs = ring_scene(n, f_true, w, h, env_hw, cutoff)
    out = {}
    for name in PHASE8:
        res, counts = run_stitch(name, iset, config_with(config, PHASE8[name]), dev)
        if name.startswith("orb"):
            log(f"{name}: verify_pairs.last_stats {json.dumps(ransac.verify_pairs.last_stats)}")
        panos = sorted(sorted(np.asarray(p["members"]).tolist()) for p in res.panoramas)
        full = [p for p in res.panoramas if len(p["members"]) == n]
        psnr, ferr = pano_psnr(full[0], env, Rs, f_true) if full else (float("nan"),) * 2
        log(f"{name}: panoramas {panos}, accepted pairs {int(np.asarray(res.graph.accepted).sum())}"
            f"/{len(res.graph.pairs)}, max focal error {ferr:.4f} %, PSNR {psnr:.3f} dB"
            + (f" (JAX on a CPU: {json.dumps(gates[name])})" if gates else ""))
        want = gates[name]["panoramas"] if gates else [list(range(n))]
        psnr_min = gates[name]["psnr"] - 3.0 if gates else 35.0
        if panos != want:
            raise AssertionError(f"{name}: panoramas {panos}, expected {want}")
        if not (ferr < 1.0 and psnr >= psnr_min):
            raise AssertionError(f"{name}: focal error {ferr:.3f} % or PSNR {psnr:.2f} dB "
                                 f"(gate {psnr_min:.2f})")
        runs_b2 = not name.startswith("orb")  # binary descriptors: no window phase
        if dev.type == "cuda" and not (counts["knn"] > 0 and counts["ba_system"] > 0 and all(
                (counts[k] > 0) == runs_b2 for k in ("orient_hist", "descriptor"))):
            raise AssertionError(f"{name}: unexpected kernel launches {counts}")
        require_launches(name, counts, (), dev)
        out[name] = counts
    return out


def multichip_pano100(label: str, dev, mesh, pano100, gate) -> tuple:
    """The pano100 ring through `stitch_multichip` on `mesh` with phase 9's
    gates (one panorama of n, focal error < 1 %, PSNR >= the JAX package's
    less 3 dB). Returns (record as `stitch_record`, launch counts)."""
    from autopanostitch_tpu_torch import config

    n, f_true, w, h, env_hw = pano100
    iset, env, Rs = ring_scene(n, f_true, w, h, env_hw)
    res, counts = run_stitch(label, iset, config_with(config, PANO100), dev, mesh)
    psnr_min = max(40.0, gate["psnr"] - 3.0) if gate else 35.0
    ring_gates(label, res, env, Rs, n, f_true, psnr_min, gate)
    return stitch_record(res), counts


def multichip_rank(rank: int, world: int, store: str, out_dir: str, dev_type: str, pano100,
                   gate) -> None:
    """One rank of phase 11b (spawned): the pano100 ring through
    `stitch_multichip` on a gloo mesh of `world` ranks that share cuda:0 (the
    CPU in the rehearsal). Prints its stage split, launch counts and the
    card; writes its record and counts to out_dir/rank{rank}.npz."""
    import torch
    import torch.distributed as dist

    from autopanostitch_tpu_torch.parallel import mesh as pmesh

    if dev_type == "cpu":
        torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        dev = torch.device("cuda", 0) if dev_type == "cuda" else torch.device("cpu")
        mesh = pmesh.make_mesh(dev, backend="gloo")
        label = f"multichip_gloo{world}_rank{rank}"
        log(f"{label}: {nvidia_smi() if dev_type == 'cuda' else 'the CPU'}, mesh rank {mesh.rank} "
            f"of {mesh.size} on {mesh.device} over {mesh.backend}")
        rec, counts = multichip_pano100(label, dev, mesh, pano100, gate)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), counts=json.dumps(counts), **rec)
    finally:
        dist.destroy_process_group()


def phase_multichip(dev, pano100, gate, single: dict, multi):
    """Phase 11, `stitch_multichip` (the multi-GPU path) on one card.
    11a: pano100 on an NCCL mesh of world size 1 in this process (gloo on
    the CPU), capturing its LM phase graphs anew under the process group;
    11b: the same on two ranks spawned over gloo, sharing the
    card; 11c: phase 6's folder at world size 1 (the second pass and two
    projections through the sharded render). Each run gets phase 9's or
    phase 6's gates; 11a and each rank of 11b are held to phase 9's
    single-device result and to each other with tests/test_parallel.py's
    tolerances (`same_stitch`); B1 and B2 must launch in every run and on
    every rank. Returns the runs' launch counts (11a, 11c, each rank)."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from autopanostitch_tpu_torch.models import bundle
    from autopanostitch_tpu_torch.parallel import mesh as pmesh

    need = ("knn", "orient_hist", "descriptor", "ba_system")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory(prefix="apst_mesh_") as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store1", rank=0, world_size=1)
        try:
            mesh = pmesh.make_mesh(dev, backend=backend)
            log(f"multichip: mesh rank {mesh.rank} of {mesh.size} on {mesh.device} over "
                f"{mesh.backend}")
            # a new multi-GPU process's first BA: its LM graphs are captured with the
            # process group (NCCL's watchdog thread) alive
            bundle._graphs.clear()
            rec_a, counts_a = multichip_pano100(f"multichip_{backend}1", dev, mesh, pano100, gate)
            same_stitch(f"multichip_{backend}1", rec_a, single, "pano100 (phase 9)")
            require_launches(f"multichip_{backend}1", counts_a, need, dev)
            log(f"multichip_{backend}1: LM phase graphs captured under the {backend} process "
                f"group {counts_a['ba_graph_captures']}, replayed "
                f"{counts_a['ba_graph_replays']}")
            if dev.type == "cuda" and counts_a["ba_graph_captures"] == 0:
                raise AssertionError(f"multichip_{backend}1: no LM phase graph was captured")
            counts_c, _ = phase_multipano(dev, *multi, mesh=mesh)
        finally:
            dist.destroy_process_group()
        t0 = time.perf_counter()
        mp.spawn(multichip_rank, args=(2, f"{tmp}/store2", tmp, dev.type, pano100, gate),
                 nprocs=2, join=True)
        log(f"multichip_gloo2: both ranks done in {time.perf_counter() - t0:.1f} s of wall time "
            "(spawn, start-up and stitch)")
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(2)]
    out = [counts_a, counts_c]
    for r, rec in enumerate(ranks):
        counts = json.loads(str(rec.pop("counts")))
        label = f"multichip_gloo2_rank{r}"
        same_stitch(label, rec, single, "pano100 (phase 9)")
        same_stitch(label, rec, rec_a, f"multichip_{backend}1")
        require_launches(label, counts, need, dev)
        out.append(counts)
    same_stitch("multichip_gloo2_rank1", ranks[1], ranks[0], "multichip_gloo2_rank0")
    return out


# float32 operations (a product and a sum count 1 each, a square root, a
# division or a sine 1) as `csrc/render.cu` writes them: the sampler's ray a
# pixel (RENDER_RAY_OPS) and each slot's camera, k1 fixed point (6 steps),
# bilinear taps on the 2x stack, weight and gain (RENDER_SLOT_OPS, the main
# path's bicubic2x with k1). `csrc/render_pyramid.cu`'s reduce does 2
# operations a folded tap (`pyramid_ops`); its collapse a contributor's
# pixel: the weight, three channels' up2 (2 taps along the rows, 2 along
# the columns), Laplacian and weighted sum (MB_COLLAPSE_SLOT_OPS), and a
# pixel the coarser result's up2, the division and the finish
# (MB_COLLAPSE_PIXEL_OPS)
RENDER_RAY_OPS = 25
RENDER_SLOT_OPS = 140
MB_COLLAPSE_SLOT_OPS = 29
MB_COLLAPSE_PIXEL_OPS = 30
RENDER_MODES = ("planar", "cylindrical", "spherical", "equirectangular", "stereographic")
ODD_BAND = (301, 1003)  # th, tw of the odd-sized multiband band


def render_inputs(call, dev, mode: str, interp: str, with_k1: bool, max_tiles: int | None,
                  tile=None):
    """`kernels.render.render_sample`'s arguments for a recorded
    `render_rotational` call (its images, cameras, gains and k1) in `mode`
    (the call's own canvas in its mode, else `compute_canvas` with the
    default RenderConfig), its tiles (or `tile`) and contributors, up to
    `max_tiles` of them nearest the canvas's centre (None: all)."""
    import torch

    from autopanostitch_tpu_torch.config import RenderConfig
    from autopanostitch_tpu_torch.models import render as rstage
    from autopanostitch_tpu_torch.ops import sampling as samp

    args, kw = call
    images, feathers, R, K = args[:4]
    k1 = kw["k1"] if with_k1 else None
    tile = tuple(tile or kw["tile"])
    canvas = kw["canvas"]
    # a planar or stereographic canvas holds the cameras within 40 degrees
    # of the first one's axis (a 360-degree ring has no such canvas)
    part = np.arange(len(R))
    if mode in ("planar", "perspective", "stereographic"):
        part = np.nonzero(np.asarray(R)[:, 2] @ np.asarray(R)[0, 2] > np.cos(np.radians(40)))[0]
    Rp, Kp, sizes = np.asarray(R)[part], np.asarray(K)[part], np.asarray(kw["sizes"])[part]
    k1p = None if kw["k1"] is None else np.asarray(kw["k1"])[part]
    if canvas["mode"] != mode:
        canvas = rstage.compute_canvas(Rp, Kp, sizes, mode, RenderConfig(), k1=k1p, device=dev)
    C_arg = kw.get("max_contributors")
    sel, ok, org = rstage.tile_contributors(canvas, Rp, Kp, sizes, tile,
                                            None if C_arg is None else min(C_arg, len(part)),
                                            k1=k1p, device=dev)
    sel = part[sel].astype(np.int32)
    if max_tiles is not None and len(sel) > max_tiles:
        centre = np.array([canvas["Wc"] - tile[1], canvas["Hc"] - tile[0]]) / 2
        pick = np.sort(np.argsort(np.abs(org - centre).sum(1), kind="stable")[:max_tiles])
        sel, ok, org = sel[pick], ok[pick], org[pick]
    t = lambda a, dtype=torch.float32: torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    images4 = torch.cat([images, feathers[..., None]], -1)
    fine4 = samp.upsample2x_cubic(images4) if interp == "bicubic2x" else None
    gains = kw["gains"] if kw.get("gains") is not None else np.ones((len(R), 3), np.float32)
    return (images4, fine4, t(R), t(K), t(gains), None if k1 is None else t(k1),
            t(sel, torch.int32), t(ok, torch.bool), t(org), canvas, tile[0], tile[1])


def u8_agreement(u8_k, cov_k, u8_p, cov_p) -> dict:
    """Largest uint8 difference, the share of covered pixels that differ,
    and whether the coverage is equal."""
    diff = (u8_k.int() - u8_p.int()).abs()
    covered = max(int(cov_p.sum()), 1)
    return {"u8_max": int(diff.max()) if diff.numel() else 0,
            "u8_share": int((diff.amax(-1) > 0).sum()) / covered,
            "coverage_equal": bool(torch_equal(cov_k, cov_p))}


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a, b))


def render_gate(label: str, rec: dict) -> None:
    """The render kernels' gates: float outputs within 1e-5, uint8 at most 1
    apart on at most 0.1 % of the covered pixels, coverage equal."""
    if not rec.get("float_err", 0.0) <= 1e-5:
        raise AssertionError(f"render {label}: float outputs {rec['float_err']:.3g} apart")
    if "u8_max" in rec and not (rec["u8_max"] <= 1 and rec["u8_share"] <= 1e-3
                                and rec["coverage_equal"]):
        raise AssertionError(f"render {label}: uint8 or coverage gate failed {rec}")


def render_checks(dev, call, max_tiles: int) -> dict:
    """Each render kernel against its plain version on the ring's recorded
    render inputs: five projections x {nearest, bicubic2x} x {multiband,
    linear, none-maxangle} x {with k1, without}, and the multiband pyramid
    on an odd-sized band; up to `max_tiles` tiles of each canvas, nearest
    its centre. Returns the largest differences: the sampler's
    colours and weights (sample_err), the pyramid's levels (reduce_err), the
    collapse's float blend from the same levels (collapse_err), and the
    share of covered pixels whose uint8 value differs (u8_share)."""
    import torch

    from autopanostitch_tpu_torch.kernels import render as kr

    errs = {"sample_err": 0.0, "u8_share": 0.0, "u8_max": 0}
    for mode in RENDER_MODES:
        for with_k1 in (True, False):
            for interp in ("nearest", "bicubic2x"):
                inp = render_inputs(call, dev, mode, interp, with_k1, max_tiles)
                for blend in ("multiband", "linear", "none-maxangle"):
                    args = inp + (blend, 1.0, interp)
                    got = kr.render_sample(*args)
                    ref = kr.render_sample_plain(*args)
                    if blend == "multiband":
                        rec = {"float_err": max(float((a - b).abs().max()) for a, b in
                                                zip(got, ref))}
                        errs["sample_err"] = max(errs["sample_err"], rec["float_err"])
                        rec.update(u8_agreement(*kr.multiband(*got, to_u8=True),
                                                *kr.multiband_plain(*got, to_u8=True)))
                    else:
                        rec = u8_agreement(*got, *ref)
                    label = f"{mode} {interp} {blend} k1={with_k1} ({len(inp[6])} tiles)"
                    log(f"render: {label}: {json.dumps(rec)}")
                    render_gate(label, rec)
                    errs["u8_share"] = max(errs["u8_share"], rec["u8_share"])
                    errs["u8_max"] = max(errs["u8_max"], rec["u8_max"])
    inp = render_inputs(call, dev, "spherical", "bicubic2x", True, max_tiles=1, tile=ODD_BAND)
    cols, ws = kr.render_sample(*inp, "multiband", 1.0, "bicubic2x")
    plan = kr.pyramid_plan(*ODD_BAND, 3, 1.0, dev)
    levels = kr.mb_reduce(cols, ws, plan)
    plain_levels = kr.mb_reduce_plain(cols, ws, plan)
    errs["reduce_err"] = max(float((a - b).abs().max()) for a, b in zip(levels, plain_levels))
    errs["collapse_err"] = float((kr.mb_collapse(cols, ws, levels, plan)
                                  - kr.mb_collapse_plain(cols, ws, levels, plan)).abs().max())
    rec = {"float_err": max(errs["reduce_err"], errs["collapse_err"]),
           "reduce_err": errs["reduce_err"], "collapse_err": errs["collapse_err"]}
    rec.update(u8_agreement(*kr.multiband(cols, ws, to_u8=True),
                            *kr.multiband_plain(cols, ws, to_u8=True)))
    log(f"render: odd band {ODD_BAND} of {cols.shape[1]} slots, levels {plan.sizes}: "
        f"{json.dumps(rec)}")
    render_gate("odd band", rec)
    errs["u8_share"] = max(errs["u8_share"], rec["u8_share"])
    first = kr.multiband(cols, ws, to_u8=True)
    if not all(torch_equal(a, b) for a, b in zip(first, kr.multiband(cols, ws, to_u8=True))):
        raise AssertionError("render: a repeat multiband launch differs")
    return errs


def planar_band_check(dev, band: dict) -> tuple:
    """The multiband kernels at the planar path's rank and shape: a band of
    phase 7's canvas ((N, 512, Wc), every image of the scan a contributor,
    no leading dims), warped as `composite_band` warps it. Each kernel
    against its plain version, and `composite_band`'s own multiband (through
    `ops/blend`, which must launch the kernels and no plain version) against
    the plain multiband of the same band, at the render gates. Returns the
    record and the band's (colours, weights)."""
    from autopanostitch_tpu_torch.kernels import render as kr
    from autopanostitch_tpu_torch.models import planar

    band = dict(band, blend_mode="multiband")
    cols, ws = planar.warp_band(*(band[k] for k in (
        "images", "feathers", "H_inv_canvas", "valid", "gains", "band_h", "out_w", "x0", "y0",
        "interp")))
    plan = kr.pyramid_plan(cols.shape[-3], cols.shape[-2], band["bands"], 1.0, dev)
    levels = kr.mb_reduce(cols, ws, plan)
    rec = {"reduce_err": max(float((a - b).abs().max())
                             for a, b in zip(levels, kr.mb_reduce_plain(cols, ws, plan))),
           "collapse_err": float((kr.mb_collapse(cols, ws, levels, plan)
                                  - kr.mb_collapse_plain(cols, ws, levels, plan)).abs().max())}
    rec["float_err"] = max(rec["reduce_err"], rec["collapse_err"])
    before = (kr.reduce_launches, kr.collapse_launches, kr.plain_on_cuda)
    got = planar.composite_band(**band)
    launched = (kr.reduce_launches - before[0], kr.collapse_launches - before[1],
                kr.plain_on_cuda - before[2])
    if dev.type == "cuda" and launched != (plan.bands - 1, 1, 0):
        raise AssertionError(f"render planar band: composite_band launched (mb_reduce, "
                             f"mb_collapse, plain versions) {launched}")
    rec.update(u8_agreement(*got, *kr.multiband_plain(cols, ws, band["bands"], to_u8=True)))
    log(f"render: planar band {tuple(cols.shape)}, levels {plan.sizes}, covered "
        f"{float(got[1].float().mean()):.3f}: {json.dumps(rec)}")
    render_gate("planar band", rec)
    return rec, (cols, ws)


def render_times(dev, label: str, call) -> dict:
    """Device times (`time_ms`) of the render kernels, their plain versions
    and, for the pyramid's reduce, the library's depthwise convolution and
    resize products, with their bounds, at a recorded call's whole canvas
    (the main path: its projection, bicubic2x, k1, multiband)."""
    from autopanostitch_tpu_torch.kernels import render as kr

    args, kw = call
    interp, bands = kw["interp"], kw["bands"]
    inp = render_inputs(call, dev, kw["canvas"]["mode"], interp, kw["k1"] is not None,
                        max_tiles=None)
    sargs = inp + ("multiband", kw["angle_power"], interp)
    images4, fine4, sel = inp[0], inp[1], inp[6]
    T, C = sel.shape
    th, tw = inp[10], inp[11]
    P = T * th * tw
    out = {"shape": {"tiles": T, "slots": C, "tile": [th, tw], "images": list(images4.shape)}}
    stack = fine4 if fine4 is not None else images4
    small = sum(x.numel() * x.element_size() for x in inp[2:9] if x is not None)
    t_k = time_ms(lambda: kr.render_sample(*sargs), dev)
    t_p = time_ms(lambda: kr.render_sample_plain(*sargs), dev)
    b, by = bound_ms(P * RENDER_RAY_OPS + P * C * RENDER_SLOT_OPS,
                     stack.numel() * 4 + small + P * C * 16, FP32_FLOPS)
    out["render_sample"] = dict(ms=t_k, plain_ms=t_p, library_ms=None, bound_ms=b, bound_by=by)
    cols, ws = kr.render_sample(*sargs)
    out.update(pyramid_times(dev, cols, ws, bands))
    # a cross-check of time_ms: back-to-back launches in a graph
    out["render_sample"]["graph_ms"] = graph_ms(lambda: kr.render_sample(*sargs), dev)
    log_times(label, out, RENDER_KERNELS)
    return out


def log_times(label: str, out: dict, names) -> None:
    for name in names:
        r = out[name]
        log(f"render {label} {name}: {r['ms']:.4f} ms (from a graph {r['graph_ms']:.4f} ms), "
            f"plain {r['plain_ms']:.4f} ms"
            + (f", library {r['library_ms']:.4f} ms" if r["library_ms"] is not None else "")
            + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"{100 * r['bound_ms'] / r['ms']:.1f} % of it")
    log(f"render {label}: {json.dumps(out['shape'])}; the whole multiband "
        f"{out['multiband_ms']:.4f} ms, plain {out['multiband_plain_ms']:.4f} ms")


def pyramid_ops(plan, planes: int) -> float:
    """The reduce's float32 operations: per plane and level, 2 a folded tap
    along the rows at every (source row, coarser column), then along the
    columns at every coarser pixel."""
    ops = 0.0
    for (h, _), (h2, w2), lv in zip(plan.sizes, plan.sizes[1:], plan.down):
        ops += planes * 2 * (h * w2 * lv.x[3] + h2 * w2 * lv.y[3])
    return ops


def pyramid_times(dev, cols, ws, bands: int) -> dict:
    """Device times (`time_ms`, and `graph_ms`) of `mb_reduce` and
    `mb_collapse` (uint8 finish), their plain versions and, for the reduce,
    the library's depthwise convolution and resize products, with their
    bounds, on (..., C, H, W) contributors; the whole multiband's times."""
    from autopanostitch_tpu_torch.kernels import render as kr
    from autopanostitch_tpu_torch.ops import sampling as samp

    C, th, tw = ws.shape[-3:]
    B = ws.numel() // (C * th * tw)
    plan = kr.pyramid_plan(th, tw, bands, 1.0, dev)
    levels = kr.mb_reduce(cols, ws, plan)
    g0 = kr._level0_plain(cols, ws)

    def library_reduce():
        g = g0
        for _ in range(plan.bands - 1):
            g = samp.down2(samp.gaussian_blur(g, plan.sigma))

    lvl_px = [h * w for h, w in plan.sizes]
    planes = B * C * 4
    lvl_bytes = sum(planes * n * 4 for n in lvl_px[1:])
    out = {}
    b, by = bound_ms(pyramid_ops(plan, planes), B * C * lvl_px[0] * 16 + lvl_bytes, FP32_FLOPS)
    out["mb_reduce"] = dict(ms=time_ms(lambda: kr.mb_reduce(cols, ws, plan), dev),
                            plain_ms=time_ms(lambda: kr.mb_reduce_plain(cols, ws, plan), dev),
                            library_ms=time_ms(library_reduce, dev), bound_ms=b, bound_by=by,
                            graph_ms=graph_ms(lambda: kr.mb_reduce(cols, ws, plan), dev))
    col_ops = sum(B * n * (C * MB_COLLAPSE_SLOT_OPS + MB_COLLAPSE_PIXEL_OPS) for n in lvl_px)
    b, by = bound_ms(col_ops, B * C * lvl_px[0] * 16 + lvl_bytes + B * lvl_px[0] * 4, FP32_FLOPS)
    out["mb_collapse"] = dict(
        ms=time_ms(lambda: kr.mb_collapse(cols, ws, levels, plan, True), dev),
        plain_ms=time_ms(lambda: kr.mb_collapse_plain(cols, ws, levels, plan, True), dev),
        library_ms=None, bound_ms=b, bound_by=by,
        graph_ms=graph_ms(lambda: kr.mb_collapse(cols, ws, levels, plan, True), dev))
    out["multiband_ms"] = time_ms(lambda: kr.multiband(cols, ws, bands, to_u8=True), dev)
    out["multiband_plain_ms"] = time_ms(
        lambda: kr.multiband_plain(cols, ws, bands, to_u8=True), dev)
    return out


def phase_render(dev, ring_call, folder_call, planar_band, max_tiles: int) -> dict:
    """Phase 12: the render kernels (`csrc/render.cu`,
    `csrc/render_pyramid.cu`) against their plain versions on the ring's
    recorded render inputs (`render_checks`) and on a band of the planar
    canvas (`planar_band_check`), then timed at the ring's and the folder's
    whole canvases (`render_times`) and the pyramid at the planar band
    (`pyramid_times`)."""
    errs = render_checks(dev, ring_call, max_tiles)
    band, (cols, ws) = planar_band_check(dev, planar_band)
    for k in ("reduce_err", "collapse_err", "u8_share", "u8_max"):
        errs[k] = max(errs[k], band[k])
    out = {"errors": errs}
    out["ring"] = render_times(dev, "ring", ring_call)
    out["folder"] = render_times(dev, "folder", folder_call)
    out["planar_band"] = dict(pyramid_times(dev, cols, ws, planar_band["bands"]),
                              shape={"band": list(ws.shape)})
    log_times("planar band", out["planar_band"], ("mb_reduce", "mb_collapse"))
    return out


def main() -> int:
    import torch

    if REHEARSE:
        dev = torch.device("cpu")
        sizes = dict(F=2048, n_img=4, pairs=(6, 256), b1w=(4, 256, 3), shapes_F=1024,
                     b2=(2, 8, 96, 128),
                     b2f=[("octave0", 2 * 7, 96, 128, 64, 40, 80),
                          ("odd_w_coarse", 2 * 7, 38, 51, 16, 32, 32),
                          ("doh", 2 * 8, 96, 128, 2 * 64, 80, 80)],
                     ring=(12, 240.0, 320, 240, (512, 1024)),
                     multi=(10, 240.0, 320, 240, (512, 1024), 200, 35.0), planar=(320, 240, 40.0),
                     detectors=(8, 240.0, 320, 240, (512, 1024), 0.2, None),
                     ring_gates=None, pano100=(16, 175.0, 192, 144, (384, 1024), None),
                     cli=(8, 240.0, 320, 240, (512, 1024)), render_tiles=3)
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA GPU",
                  file=sys.stderr)
            return 1
        dev = torch.device("cuda", 0)
        sizes = dict(F=20 * 2048, n_img=20, pairs=(25, 2048), b1w=(12, 2048, 6),
                     shapes_F=8 * 2048, b2=(20, 8, 600, 800),
                     b2f=[("octave0", 20 * 7, 600, 800, 20 * 2048, 40, 80),
                          ("odd_w_coarse", 20 * 7, 38, 51, 20 * 128, 32, 32),
                          ("doh", 8 * 8, 600, 800, 8 * 2048, 80, 80)],
                     ring=RING,
                     multi=(12, 600.0, 800, 600, (1024, 2048), 400, JAX_MULTIPANO_PSNR - 3.0),
                     planar=(800, 600, JAX_PLANAR_PSNR - 3.0),
                     detectors=PHASE8_RING + (JAX_PHASE8,), ring_gates=JAX_RING_OPTIONS,
                     pano100=PANO100_RING + (JAX_PANO100,), cli=(12, 600.0, 800, 600, (1024, 2048)),
                     render_tiles=96)

    import autopanostitch_tpu_torch  # noqa: F401  (fails outside the repo)
    from autopanostitch_tpu_torch.kernels import _build

    smi = nvidia_smi()
    log(f"env: {smi}")
    log(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {dev}"
        + (f" ({torch.cuda.get_device_name(0)})" if dev.type == "cuda" else ""))
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    if dev.type == "cuda":
        t0 = time.perf_counter()
        path = _build.build()
        _build.library()
        log(f"build: {path.name} in {time.perf_counter() - t0:.1f} s "
            f"(nvcc {'ran' if _build.build_seconds is not None else 'skipped, cached'})")
        if "bytes spill" not in _build.build_log:  # a cached library without its report
            raise AssertionError(f"no ptxas register report beside {path.name}: delete it")
        spills = []
        for line in _build.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and (int(m.group(1)) or int(m.group(2))):
                spills.append(line.strip())
        if spills:
            raise AssertionError(f"register spills: {spills}")
        serial = [line.strip() for line in _build.build_log.splitlines()
                  if "C7514" in line or "C7515" in line]
        if serial:  # ptxas serialised a kernel's wgmma: its products no longer overlap
            raise AssertionError(f"wgmma serialised: {serial[:3]}")

    b1 = phase_b1(dev, sizes["F"], sizes["n_img"])
    b1p = phase_b1_pairs(dev, *sizes["pairs"])
    b1w = phase_b1_wide(dev, *sizes["b1w"])
    b1bf = phase_b1_bf16(dev, sizes["F"], sizes["n_img"], sizes["pairs"])
    phase_b1_shapes(dev, sizes["shapes_F"], sizes["n_img"])
    b2 = phase_b2(dev, *sizes["b2"])
    b2f = phase_b2_fused(dev, sizes["b2f"])
    ring_counts, ring_feats, ring_ba, ring_render = phase_slice(dev, *sizes["ring"])
    runs = [ring_counts]
    runs += phase_ring_options(dev, *sizes["ring"], ring_feats, sizes["ring_gates"]).values()
    del ring_feats
    multi_counts, folder_renders = phase_multipano(dev, *sizes["multi"])
    runs += [multi_counts, phase_multipano(dev, *sizes["multi"], compute_dtype="bfloat16")[0]]
    planar_counts, planar_band = phase_planar(dev, *sizes["planar"])
    runs.append(planar_counts)
    runs += phase_planar_models(dev, *sizes["planar"])
    det = phase_detectors(dev, *sizes["detectors"])
    runs += list(det.values())
    pano100_counts, pano100_rec, pano100_ba = phase_pano100(dev, *sizes["pano100"])
    ba = phase_ba(dev, {"ring": ring_ba, "pano100": pano100_ba})
    runs += [pano100_counts, phase_cli(dev, *sizes["cli"])]
    multichip = phase_multichip(dev, sizes["pano100"][:5], sizes["pano100"][5], pano100_rec,
                                sizes["multi"])
    runs += multichip
    render = phase_render(dev, ring_render, folder_renders[0], planar_band, sizes["render_tiles"])
    del ring_render, folder_renders, planar_band
    counts = {k: sum(c[k] for c in runs) for k in runs[0]}
    mc_counts = {k: sum(c[k] for c in multichip) for k in runs[0]}
    log(f"multichip: kernel launches of phase 11 (11a, 11c and both ranks of 11b) "
        f"{json.dumps(mc_counts)}")
    orb = det["orb_mlesac_adaptive"]
    doh_runs = [det["surf"], det["kaze"]]
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")

    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    b1_unit = "3xTF32 tensor-core flop (3 x 2 Fq Ft D) at 495 TFLOP/s TF32"
    kernels = {"kernels": [
        {"name": "pooled_knn", "route": "cuda", "source": "autopanostitch_tpu_torch/csrc/knn.cu",
         "replaces": "autopanostitch_tpu/ops/pallas/match_kernel.py:129",
         "launches": counts["knn"] - counts["knn_bf16"],
         "multichip_launches": mc_counts["knn"] - mc_counts["knn_bf16"],
         "max_abs_err": max(b1["k4"]["err"], b1["k2_self"]["err"]),
         **{k: b1["k4"][k] for k in keys}, "bound_unit": b1_unit, "mm_ms": b1["k4"]["mm_ms"],
         "k2_self_ms": b1["k2_self"]["ms"], "rank0_of_2_ms": b1["k4"]["rank0_of_2_ms"],
         "rank1_of_2_ms": b1["k4"]["rank1_of_2_ms"]},
        {"name": "pair_knn", "route": "cuda", "source": "autopanostitch_tpu_torch/csrc/knn.cu",
         "replaces": "autopanostitch_tpu/ops/pallas/match_kernel.py:129",
         "launches": counts["knn_pairs"] - counts["knn_pairs_bf16"], "max_abs_err": b1p["err"],
         "multichip_launches": mc_counts["knn_pairs"] - mc_counts["knn_pairs_bf16"],
         **{k: b1p[k] for k in keys}, "bound_unit": b1_unit, "mm_ms": b1p["mm_ms"]},
        {"name": "window_gather", "route": "cuda",
         "source": "autopanostitch_tpu_torch/csrc/window_gather.cu",
         "replaces": "autopanostitch_tpu/ops/pallas/window_gather.py:78",
         "launches": counts["window_gather"], "phase4_launches": b2["launches"],
         "max_abs_err": max(b2[40]["err"], b2[80]["err"]),
         **{k: b2[80][k] for k in keys},
         "bound_unit": "bytes (80 px windows read once and written once) at 3.35 TB/s"},
    ] + [
        {"name": name, "route": "cuda", "source": "autopanostitch_tpu_torch/csrc/sift_window.cu",
         "replaces": "autopanostitch_tpu/ops/pallas/window_gather.py:78",
         "launches": counts[name], "max_abs_err": b2f[name]["err"],
         "multichip_launches": mc_counts[name],
         **{k: b2f[name][k] for k in keys + ("unfused_ms", "K", "win", "copy",
                                             "window_union_bytes")},
         "odd_w_coarse": b2f[name]["odd_w_coarse"],
         "bound_unit": "the larger of bytes (the stack pixels the windows cover read once, "
                       "per-keypoint inputs and outputs) at 3.35 TB/s and float32 operations "
                       "at 67 TFLOP/s"
                       + (" plus 2 x 16 x 8 bf16 tensor-core flops a pixel at 989 TFLOP/s"
                          if name == "descriptor" else "")}
        for name in ("orient_hist", "descriptor")
    ] + [
        {"name": f"{mode}_knn_bf16", "route": "cuda",
         "source": "autopanostitch_tpu_torch/csrc/knn_bf16.cu",
         "replaces": "autopanostitch_tpu/ops/pallas/match_kernel.py:129",
         "launches": counts["knn_bf16" if mode == "pooled" else "knn_pairs_bf16"],
         "max_abs_err": b1bf[mode]["err"], "max_err_is": "relative distance difference",
         **{k: b1bf[mode][k] for k in keys}, "mm_ms": b1bf[mode]["mm_ms"],
         "mm_is": "a bare bf16 mm / bmm of the same product",
         "bound_unit": "one bf16 tensor-core product (2 Fq Ft D flop) at 989 TFLOP/s",
         "launches_note": "the ring in bf16 (phase 5b), the folder in bf16 (phase 6b) and the "
                          "ORB stitch (phase 8: binary descriptors run this instance)"}
        for mode in ("pooled", "pairs")
    ] + [
        {"name": f"{mode}_knn_binary256", "route": "cuda",
         "source": "autopanostitch_tpu_torch/csrc/knn_bf16.cu",
         "replaces": "autopanostitch_tpu/ops/pallas/match_kernel.py:129",
         "launches": orb["knn" if mode == "pooled" else "knn_pairs"], "max_abs_err": 0.0,
         **{k: b1w[mode][k] for k in keys}, "mm_ms": b1w[mode]["mm_ms"],
         "tf32_ms": b1w[mode]["tf32_ms"],
         "bound_unit": "one tensor-core product (2 Fq Ft D flop) at 989 TFLOP/s bf16: exact on "
                       "{0,1} descriptors",
         "launches_note": "phase 8's ORB stitch (D = 256) on the bf16 instance; indices and "
                          "distances of both instances identical to the plain version at D = 256 "
                          "and 160 (tf32_ms: the 3xTF32 instance)"}
        for mode in ("pooled", "pairs")
    ] + [
        {"name": f"{name}_doh", "route": "cuda", "source": "autopanostitch_tpu_torch/csrc/sift_window.cu",
         "replaces": "autopanostitch_tpu/ops/pallas/window_gather.py:78",
         "launches": sum(r[name] for r in doh_runs), "max_abs_err": b2f[name]["doh"]["err"],
         **{k: b2f[name]["doh"][k] for k in keys + ("unfused_ms", "K", "win", "copy")
            if k != "library_ms"}, "library_ms": None,
         "launches_note": "phase 8's SURF and KAZE stitches"}
        for name in ("orient_hist", "descriptor")
    ] + [
        {"name": "ba_system", "route": "cuda", "source": "autopanostitch_tpu_torch/csrc/ba_system.cu",
         "replaces": "autopanostitch_tpu/models/bundle.py:715",
         "replaces_note": "build_normal_eqns with pair_system (:682), XLA fusions in the JAX "
                          "package's LM phase program: a hand kernel with no Pallas counterpart",
         "launches": counts["ba_system"], "multichip_launches": mc_counts["ba_system"],
         "graph_captures": counts["ba_graph_captures"],
         "graph_replays": counts["ba_graph_replays"],
         "max_abs_err": max(r["err"] for r in ba.values()),
         "max_err_is": "largest |kernel - plain| of H, g, cost over each entry's Cauchy-Schwarz "
                       "scale",
         "err_vs_float64": max(r["err64"] for r in ba.values()),
         "plain_err_vs_float64": max(r["plain_err64"] for r in ba.values()),
         **{k: ba["ring"][k] for k in keys + ("events_ms", "per_pair_path_ms", "launch_floor_ms",
                                              "shape")},
         "pano100": {k: ba["pano100"][k] for k in keys + ("events_ms", "per_pair_path_ms", "shape")},
         "ms_is": f"device time a launch: a CUDA graph of {GRAPH_LAUNCHES} launches, replay time "
                  f"/ {GRAPH_LAUNCHES} (events_ms: CUDA events around one launch after a sleep; "
                  "per_pair_path_ms: ba_normals + the one-hot einsum assembly + the cost's sum, the "
                  "same graph method; launch_floor_ms: an empty kernel's)",
         "ba_s": {name: {"eager": r["eager_ba_s"], "graph": r["graph_ba_s"]}
                  for name, r in ba.items()},
         "bound_unit": "the larger of float32 operations (BA_FLOPS_PER_MATCH x the real "
                       "matches, + the assembly's adds) at 67 TFLOP/s and bytes (the match slots "
                       "within the extents, cameras, pairs, lists in; H, g, cost out) at 3.35 TB/s",
         "launches_note": "every rotational stitch of phases 5-11, counting the launches the "
                          "LM phase graphs replay"},
        {"name": "ba_normals", "route": "cuda", "source": "autopanostitch_tpu_torch/csrc/ba_normals.cu",
         "replaces": "autopanostitch_tpu/models/bundle.py:682",
         "replaces_note": "pair_system, an XLA fusion in the JAX package's LM phase program: a "
                          "hand kernel with no Pallas counterpart",
         "on_main_path": False,
         "launches": counts["ba_normals"], "multichip_launches": mc_counts["ba_normals"],
         "max_abs_err": max(r["normals"]["err"] for r in ba.values()),
         "max_err_is": "largest |kernel - plain| over each entry's Cauchy-Schwarz scale",
         "err_vs_float64": max(r["normals"]["err64"] for r in ba.values()),
         "plain_err_vs_float64": max(r["normals"]["plain_err64"] for r in ba.values()),
         **{k: ba["ring"]["normals"][k] for k in keys + ("events_ms",)},
         "shape": ba["ring"]["shape"],
         "pano100": {k: ba["pano100"]["normals"][k] for k in keys + ("events_ms",)},
         "ms_is": "phase 9b: device time a launch from a CUDA graph, as ba_system's",
         "bound_unit": "the larger of float32 operations (BA_FLOPS_PER_MATCH x the real "
                       "matches) at 67 TFLOP/s and bytes (matches, cameras, pairs in; blocks "
                       "out) at 3.35 TB/s",
         "launches_note": "off the main path since ba_system: the launches are phase 9b's "
                          "checks only, which no count includes"}
    ] + [
        {"name": name, "route": "cuda",
         "source": "autopanostitch_tpu_torch/csrc/" + ("render.cu" if name == "render_sample"
                                                       else "render_pyramid.cu"),
         "replaces": ("autopanostitch_tpu/models/render.py:292" if name == "render_sample"
                      else "autopanostitch_tpu/ops/blend.py:80"),
         "replaces_note": ("_render_tile_impl's sampling and its linear / none-* scans"
                           if name == "render_sample" else
                           "multiband_blend's " + ("blur (_blur_nc :39) and 2x down (_down2 :69)"
                                                   if name == "mb_reduce" else
                                                   "Laplacian blend and collapse (_up2 :75)"))
                          + ", XLA fusions in the JAX package: a hand kernel with no Pallas "
                            "counterpart",
         "launches": counts[name], "multichip_launches": mc_counts[name],
         "max_abs_err": render["errors"][{"render_sample": "sample_err",
                                          "mb_reduce": "reduce_err",
                                          "mb_collapse": "collapse_err"}[name]],
         "max_err_is": {"render_sample": "colours and weights (multiband), phase 12's 60 cases",
                        "mb_reduce": "the Gaussian levels of phase 12's odd band and planar band",
                        "mb_collapse": "those bands' float blends from the same levels"}[name],
         "u8_share": render["errors"]["u8_share"],
         **{k: render["ring"][name][k] for k in keys + ("graph_ms",)},
         "shape": render["ring"]["shape"],
         "folder": dict({k: render["folder"][name][k] for k in keys + ("graph_ms",)},
                        shape=render["folder"]["shape"]),
         **({} if name == "render_sample" else {"planar_band": dict(
             {k: render["planar_band"][name][k] for k in keys + ("graph_ms",)},
             shape=render["planar_band"]["shape"])}),
         "ms_is": "device time (time_ms, median of 5) at the ring's whole canvas; folder: the "
                  f"folder's first panorama's spherical canvas; planar_band: the middle band "
                  f"of phase 7's canvas; graph_ms: a CUDA graph of "
                  f"{GRAPH_LAUNCHES} launches, replay time / {GRAPH_LAUNCHES}",
         "library_note": ("a depthwise F.conv2d blur (cuDNN) and the resize products (cuBLAS) "
                          "of the same levels" if name == "mb_reduce"
                          else "none computes this function"),
         "bound_unit": "the larger of bytes (inputs read once, outputs written once) at 3.35 "
                       "TB/s and float32 operations (RENDER_* / MB_* constants, pyramid_ops) at "
                       "67 TFLOP/s",
         "launches_note": "every rotational stitch of phases 5-11 (the planar stitches' linear "
                          "blend runs none)"}
        for name in RENDER_KERNELS
    ]}
    if REHEARSE:
        log(json.dumps(kernels))
        log("rehearsal on the CPU finished: no result is printed")
        return 3
    log(json.dumps(kernels))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
