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
  Pallas counterpart). The LM phases run it inside CUDA graphs.
- `render`: the rotational render stage (replaces `_render_tile_impl` of
  `models/render.py` and `multiband_blend` of `ops/blend.py`, XLA fusions
  in the JAX package: hand kernels with no Pallas counterpart): the tile
  sampler `render_sample` and the multiband pyramid's `mb_reduce` and
  `mb_collapse` (`render.multiband`); and bicubic2x's 2x upsample
  `upsample2x` (replaces `jax.image.resize(..., "cubic")` of
  `models/render.py:350`, XLA: no Pallas counterpart).
- `kaze`: KAZE's FED diffusion step `fed_step`, one launch a step of the
  nonlinear scale space (replaces `_diffusion_step` of `ops/kaze.py`, XLA
  in the JAX package: no Pallas counterpart).
- `window_gather`: B2's first port, the window gather alone (replaces
  `ops/pallas/window_gather.py`); off the main path, it is the unfused
  yardstick of `sift_window`.

Each wrapper launches its kernel for CUDA tensors (or raises) and uses the
plain PyTorch version for CPU tensors only, and adds its launches to the
tracer's tally under the kernel's name (`utils/trace.launched`; read with
`trace.launch_counts`): `knn`, `knn_pairs` and, of those, `knn_bf16` /
`knn_pairs_bf16` of the bf16 instance; `window_gather`; `orient_hist` and
`descriptor`; `ba_system`, also the launches that the LM phases' CUDA
graphs replay; `render_sample`, `mb_reduce`, `mb_collapse`, `upsample2x`,
and `render_plain_on_cuda`, the render plain versions' calls on CUDA
tensors; `fed_step`. `models/bundle` counts those graphs' captures and replays.
"""

# imported in this order so that `trace.launch_counts()` lists B1, B2, the BA, the render, KAZE
from autopanostitch_tpu_torch.kernels import (  # noqa: F401
    knn, window_gather, sift_window, ba, render, kaze)
