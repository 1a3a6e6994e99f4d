"""Hand-written CUDA kernels of the port, each beside its plain version.

- `knn`: B1, exact k-NN (replaces `ops/pallas/match_kernel.py`), in a
  pooled mode (`knn.knn`) and a pair-list mode (`knn.knn_pairs`), each with
  a 3xTF32 and a bf16-operand instance.
- `sift_window`: B2 fused with the SIFT phases that consume its windows:
  the orientation histogram (`sift_window.orient_hist`) and the descriptor
  (`sift_window.descriptor`), reading windows straight from the stack
  (replaces `ops/pallas/window_gather.py` and the dense binning of
  `ops/sift.py`). SIFT's main path runs these.
- `ba`: `ba_system`, the rotational bundle adjustment's whole
  linearisation, the dense normal equations of an LM iteration with
  closed-form Jacobians (replaces `pair_system` + `build_normal_eqns` of
  `models/bundle.py`, XLA fusions in the JAX package: a hand kernel with no
  Pallas counterpart). The LM phases run it inside CUDA graphs. Its first
  port, `ba_normals` (per-pair blocks, assembled by one-hot einsums), stays
  off the main path as its yardstick.
- `render`: the rotational render stage (replaces `_render_tile_impl` of
  `models/render.py` and `multiband_blend` of `ops/blend.py`, XLA fusions
  in the JAX package: hand kernels with no Pallas counterpart): the tile
  sampler `render_sample` and the multiband pyramid's `mb_reduce` and
  `mb_collapse` (`render.multiband`).
- `window_gather`: B2's first port, the window gather alone (replaces
  `ops/pallas/window_gather.py`); off the main path, it is the unfused
  yardstick of `sift_window`.

Each wrapper launches its kernel for CUDA tensors (or raises) and uses the
plain PyTorch version for CPU tensors only; each counts its launches in a
module-level integer (`launches`, `pair_launches` for B1's pair mode, and
of those `bf16_launches` / `bf16_pair_launches` of its bf16 instance,
`orient_launches` and `descriptor_launches` for the fused B2,
`sample_launches`, `reduce_launches` and `collapse_launches` for the render
kernels (and `plain_on_cuda`, their plain versions' calls on CUDA tensors), `launches`
of `ba` (`ba_system`) also counting the launches that the LM phases' CUDA
graphs replay, `normals_launches` for `ba_normals`;
`models/bundle` counts those graphs' captures and replays).
"""

from autopanostitch_tpu_torch.kernels import ba, knn, render, sift_window, window_gather  # noqa: F401


def reset_launch_counts() -> None:
    knn.launches = 0
    knn.pair_launches = 0
    knn.bf16_launches = 0
    knn.bf16_pair_launches = 0
    window_gather.launches = 0
    sift_window.orient_launches = 0
    sift_window.descriptor_launches = 0
    ba.launches = 0
    ba.normals_launches = 0
    render.sample_launches = 0
    render.reduce_launches = 0
    render.collapse_launches = 0
    render.plain_on_cuda = 0


def launch_counts() -> dict:
    return {"knn": knn.launches, "knn_pairs": knn.pair_launches,
            "knn_bf16": knn.bf16_launches, "knn_pairs_bf16": knn.bf16_pair_launches,
            "window_gather": window_gather.launches, "orient_hist": sift_window.orient_launches,
            "descriptor": sift_window.descriptor_launches, "ba_system": ba.launches,
            "ba_normals": ba.normals_launches, "render_sample": render.sample_launches,
            "mb_reduce": render.reduce_launches, "mb_collapse": render.collapse_launches,
            "render_plain_on_cuda": render.plain_on_cuda}
