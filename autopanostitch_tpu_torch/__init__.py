"""autopanostitch_tpu_torch — the stitcher on PyTorch and CUDA.

A port of `autopanostitch_tpu` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper GPU. The JAX package stays the reference: every module here mirrors
the module of the same name there, and the tests hold each one against it.
The two TPU (Pallas) kernels of the main path are written by hand in CUDA
(`csrc/`), built at first use (`kernels/_build.py`).

The port imports nothing of the JAX package: its configuration dataclasses,
image I/O, straightening and cropping are copies (`config.py`,
`utils/image_io.py`, `models/straighten.py`, `models/crop.py`) with the same
names and defaults.
"""

from autopanostitch_tpu_torch import device as _device  # noqa: F401  (sets TF32 off)
from autopanostitch_tpu_torch.config import StitchConfig, default_config

__version__ = "0.1.0"

__all__ = ["StitchConfig", "default_config", "__version__"]
