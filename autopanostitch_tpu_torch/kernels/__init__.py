"""Hand-written CUDA kernels of the port, each beside its plain version.

- `knn`: B1, exact k-NN (replaces `ops/pallas/match_kernel.py`), in a
  pooled mode (`knn.knn`) and a pair-list mode (`knn.knn_pairs`).
- `window_gather`: B2, SIFT keypoint window gather (replaces
  `ops/pallas/window_gather.py`).

Each wrapper launches its kernel for CUDA tensors (or raises) and uses the
plain PyTorch version for CPU tensors only; each counts its launches in a
module-level integer (`launches`, and `pair_launches` for B1's pair mode).
"""

from autopanostitch_tpu_torch.kernels import knn, window_gather  # noqa: F401


def reset_launch_counts() -> None:
    knn.launches = 0
    knn.pair_launches = 0
    window_gather.launches = 0


def launch_counts() -> dict:
    return {"knn": knn.launches, "knn_pairs": knn.pair_launches,
            "window_gather": window_gather.launches}
