"""Build the CUDA kernels of `csrc/` at first use and load them with ctypes.

Each `csrc/*.cu` compiles in its own `nvcc` process, all started together,
and one more `nvcc` links the objects into a shared library with a plain C
interface (no PyTorch headers: the build takes about a minute, most of it
B1's template instances, split over `knn.cu`, `knn_wide.cu` and
`knn_bf16.cu` so that three `nvcc`s share them, where a
`torch.utils.cpp_extension` build of one small file took minutes). A source
may add flags of its own (`SOURCE_FLAGS`). The library lands in
`autopanostitch_tpu_torch/_build/`, named by a hash of the sources (every
`*.cu` and every header, `*.cuh`, they include) and the flags, so a changed
source rebuilds and an unchanged one loads at once. nvcc's output (ptxas's
register and spill report) is kept beside the library, `<name>.log`, so that
a cached load reports it too.

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

from autopanostitch_tpu_torch.utils import trace

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# flags of one source only: the tile sampler rounds every product and sum on
# its own, as PyTorch's elementwise operators of its plain version do (the
# pyramid's `render_pyramid.cu` keeps FMA contraction)
SOURCE_FLAGS = {"render.cu": ["-fmad=false"]}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the last nvcc run (None = loaded from cache)
build_log = ""  # nvcc's output of the library's build (-Xptxas -v register report)


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
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    return BUILD_DIR / f"libapst_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless the hashed library exists. Returns its path."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        log = out.with_suffix(".log")
        build_log = log.read_text() if log.exists() else ""
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            objs.append(os.path.join(work, src.stem + ".o"))
            procs.append(subprocess.Popen(
                [nvcc()] + ARCH_FLAGS + FLAGS + SOURCE_FLAGS.get(src.name, [])
                + ["-I", str(CSRC), "-c", "-o", objs[-1], str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        build_log = "".join(logs)
        failed = [p.returncode for p in procs if p.returncode != 0]
        if not failed:
            tmp = os.path.join(work, "lib.so")
            link = subprocess.run([nvcc()] + ARCH_FLAGS + ["-shared", "-o", tmp] + objs,
                                  capture_output=True, text=True)
            build_log += link.stdout + link.stderr
            failed = [link.returncode] if link.returncode != 0 else []
        build_seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError(f"nvcc failed ({failed[0]}):\n{build_log}")
        with open(os.path.join(work, "lib.log"), "w") as f:
            f.write(build_log)
        # atomic, the log first: a concurrent process never loads a partial
        # file and finds the log of any library it loads
        os.replace(os.path.join(work, "lib.log"), out.with_suffix(".log"))
        os.replace(tmp, out)
    return out


def _declare(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.apst_knn.argtypes = [P, P, P, I, P, P, I, I, I, I, P, P, P, P, P]
    lib.apst_knn.restype = I
    lib.apst_knn_pairs.argtypes = [P, P, I, I, I, P, I, I, I, P, P, P, P]
    lib.apst_knn_pairs.restype = I
    lib.apst_gather_windows.argtypes = [P, I, I, I, P, P, P, I, I, I, P, P]
    lib.apst_gather_windows.restype = I
    lib.apst_orient_hist.argtypes = [P, I, I, I, P, P, P, P, P, P, I, I, I, P, P]
    lib.apst_orient_hist.restype = I
    lib.apst_sift_descriptor.argtypes = [P, I, I, I, P, P, P, P, P, P, P, I, I, I, I, I, P, P]
    lib.apst_sift_descriptor.restype = I
    lib.apst_ba_normals.argtypes = [P] * 9 + [I, I, I, ctypes.c_float, I, P, P, P, P]
    lib.apst_ba_normals.restype = I
    lib.apst_ba_system.argtypes = [P] * 12 + [I, I, I, I, ctypes.c_float, I, P, P, P, P, P]
    lib.apst_ba_system.restype = I
    lib.apst_render_sample.argtypes = ([P, I, I, I, I, I] + [P] * 7 + [I] * 7 + [F] * 3
                                       + [P, F] + [P] * 5)
    lib.apst_render_sample.restype = I
    lib.apst_mb_reduce.argtypes = [P, P, P] + [I] * 6 + [P, P, P, I] * 2 + [I, I, P, I, P]
    lib.apst_mb_reduce.restype = I
    lib.apst_mb_collapse.argtypes = [P, P, I, I, I, P, P, I, P, P, P, I, P]
    lib.apst_mb_collapse.restype = I
    lib.apst_noop.argtypes = [P]
    lib.apst_noop.restype = I
    lib.apst_error_string.argtypes = [I]
    lib.apst_error_string.restype = ctypes.c_char_p


def library():
    """The loaded kernel library (built on first call, in the span
    `kernels.load`)."""
    global _lib
    if _lib is not None:
        return _lib
    with trace.span("kernels.load"), _lock:
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
