"""Device policy and float32 numerics of the port.

The reference computes in full float32 (its geometry passes
`Precision.HIGHEST` everywhere, `DESIGN.md` "Numerics"). On a GPU, PyTorch
keeps float32 matmuls exact by default but runs float32 convolutions
through cuDNN in TF32, which would put SIFT's separable Gaussian
(`ops/sampling.gaussian_blur`) at ~3 decimal digits. Both switches are set
off at import.

There is no fallback between devices: asking for CUDA on a machine
without it raises instead of running on the CPU.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve(device) -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
