"""Native host kernels (C++ / OpenMP), ctypes-bound (port of the JAX
package's `native/`, same `kernels.cpp`).

Compiled with g++ at first use into `native/_build/` (git-ignored), named by
a hash of the source, so an edited source rebuilds and an unchanged one
loads at once; a finished library appears under its name atomically. No
Python headers or pybind11. These are host code, as in the reference:

- `max_rectangle`: the largest all-true rectangle of a mask, the host path
  of `models/crop.largest_inscribed_rect` (which keeps its numpy form for a
  machine without g++).
- `hamming_2nn`: exact 2-NN under Hamming distance of packed bytes, for
  CPU-only deployments and as a cross-check; no pipeline calls it (binary
  matching runs on kernel B1 on the card).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_SRC), "_build")
_lock = threading.Lock()
_LIB = None


def _build_lib() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"kernels_{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp", _SRC,
                            "-o", tmp], check=True, capture_output=True)
        except subprocess.CalledProcessError:  # without OpenMP / arch flags
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", tmp], check=True,
                           capture_output=True)
        os.replace(tmp, so)  # a concurrent process never loads a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def _lib():
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(_build_lib())
            lib.hamming_2nn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.hamming_2nn.restype = None
            lib.max_rectangle.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.max_rectangle.restype = None
            _LIB = lib
        return _LIB


def hamming_2nn(A: np.ndarray, B: np.ndarray):
    """Exact 2-NN Hamming over packed uint8 descriptors.

    Args: A (na, nbytes) uint8, B (nb, nbytes) uint8.
    Returns (idx (na,) int32 into B, d1 (na,) int32, d2 (na,) int32).
    """
    A = np.ascontiguousarray(A, np.uint8)
    B = np.ascontiguousarray(B, np.uint8)
    if A.ndim != 2 or B.ndim != 2 or A.shape[1] != B.shape[1]:
        raise ValueError(f"hamming_2nn: shapes {A.shape} and {B.shape}")
    na, nbytes = A.shape
    nb = B.shape[0]
    idx = np.empty(na, np.int32)
    d1 = np.empty(na, np.int32)
    d2 = np.empty(na, np.int32)
    _lib().hamming_2nn(
        A.ctypes.data, na, B.ctypes.data, nb, nbytes,
        idx.ctypes.data, d1.ctypes.data, d2.ctypes.data,
    )
    return idx, d1, d2


def max_rectangle(mask: np.ndarray):
    """Largest all-true rectangle. Returns (r0, r1, c0, c1) or None."""
    m = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    if m.ndim != 2:
        raise ValueError(f"max_rectangle: mask of shape {m.shape}")
    out = np.zeros(4, np.int32)
    _lib().max_rectangle(m.ctypes.data, m.shape[0], m.shape[1], out.ctypes.data)
    if out[1] <= out[0] or out[3] <= out[2]:
        return None
    return tuple(int(v) for v in out)
