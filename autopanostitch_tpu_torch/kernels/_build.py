"""Build the CUDA kernels of `csrc/` at first use and load them with ctypes.

All `csrc/*.cu` compile in ONE `nvcc` call into a shared library with a
plain C interface (no PyTorch headers: the build takes seconds, where a
`torch.utils.cpp_extension` build takes minutes). The library lands in
`autopanostitch_tpu_torch/_build/`, named by a hash of the sources and the
flags, so a changed source rebuilds and an unchanged one loads at once.

`nvcc` is looked up as `$CUDA_HOME/bin/nvcc`, then on `PATH`, then in the
toolkit's default install location.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the last nvcc run (None = loaded from cache)
build_log = ""  # nvcc's output of the last build (-Xptxas -v register report)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = []
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + FLAGS).encode())
    return BUILD_DIR / f"libapst_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless the hashed library exists. Returns its path."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc()] + ARCH_FLAGS + FLAGS + ["-I", str(CSRC), "-o", tmp] + cu
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def _declare(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.apst_knn.argtypes = [P, P, P, I, P, P, I, I, I, P, P, P, P, P]
    lib.apst_knn.restype = I
    lib.apst_knn_pairs.argtypes = [P, P, I, I, I, P, I, I, P, P, P, P]
    lib.apst_knn_pairs.restype = I
    lib.apst_gather_windows.argtypes = [P, I, I, I, P, P, P, I, I, I, P, P]
    lib.apst_gather_windows.restype = I
    lib.apst_error_string.argtypes = [I]
    lib.apst_error_string.restype = ctypes.c_char_p


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({library().apst_error_string(err).decode()})")
