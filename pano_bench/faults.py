"""Faults planted underneath the timed path, to show that the check
catches each fault a stitching cell can have (`tests/test_bench_faults.py`
on the CPU, `calibrate.py --fault` on the card at a cell's own size):

- `knn_swap`: an answer altered where it is produced: B1 returns, for every
  tenth query, its second nearest neighbour as the first;
- `half_views`: half of the batch left out: every other view's features are
  dropped after extraction;
- `ba_unchanged`: a step that returns its state unchanged: every LM phase of
  the rotational bundle adjustment, and the homography bundle adjustment,
  hand back the cameras they were given.

The exchange between chips is no fault of these one-chip cells. Each
`plant` returns the undo."""

from __future__ import annotations

import torch


def _swap(out):
    idx, dist = out
    idx = idx.clone()
    rows = torch.arange(0, idx.shape[0], 10, device=idx.device)
    first = idx[rows, 0].clone()
    idx[rows, 0] = idx[rows, 1]
    idx[rows, 1] = first
    return idx, dist


def plant(name: str):
    from autopanostitch_tpu_torch.kernels import knn
    from autopanostitch_tpu_torch.models import bundle, bundle_h, pipeline

    if name == "knn_swap":
        plain, cuda = knn.knn_plain, knn._knn_cuda
        knn.knn_plain = lambda *a, **k: _swap(plain(*a, **k))
        knn._knn_cuda = lambda *a, **k: _swap(cuda(*a, **k))

        def undo():
            knn.knn_plain, knn._knn_cuda = plain, cuda
    elif name == "half_views":
        extract = pipeline.features_stage.extract_features

        def half(images, sizes, cfg):
            f = extract(images, sizes, cfg)
            mask = f.mask.clone()
            mask[1::2] = False
            return f._replace(mask=mask)

        pipeline.features_stage.extract_features = half

        def undo():
            pipeline.features_stage.extract_features = extract
    elif name == "ba_unchanged":
        lm, lm_h = bundle._lm_phase, bundle_h.bundle_adjust_h

        def lm_unchanged(inp, pd, iters, st):
            cost = bundle._normal_eqns(inp["Rb"], inp["f"], inp["k1"], inp, pd, st)[2]
            return inp["Rb"], inp["f"], inp["k1"], cost

        def h_unchanged(params0, *args, **kwargs):
            return params0, torch.zeros((), dtype=params0.dtype, device=params0.device)

        bundle._lm_phase, bundle_h.bundle_adjust_h = lm_unchanged, h_unchanged
        bundle._graphs.clear()  # graphs captured from the sound phases

        def undo():
            bundle._lm_phase, bundle_h.bundle_adjust_h = lm, lm_h
            bundle._graphs.clear()
    else:
        raise ValueError(f"no fault {name!r}")
    return undo
