"""The approximate matcher's projection, drawn again for the reference.

The configuration's `matching.method = "approximate"` ranks every target by
its squared distance in a 32-d sketch, desc @ G, with G =
normal(key 12345, (D, 32)) / sqrt(32): JAX's `jax.random.normal` of
`PRNGKey(12345)`, which the program draws without JAX. This file draws the
same matrix, bit for bit, and imports nothing of the program:

- the key of a 32-bit seed s: (0, s);
- the bits: Threefry-2x32 with 20 rounds (Salmon, Moraes, Dror and Shaw,
  "Parallel random numbers: as easy as 1, 2, 3", SC'11) of each element's
  flat index as a 64-bit counter split into (high, low) words, the two
  output words XORed;
- uniforms on [nextafter(-1, 0), 1): the top 23 bits as a mantissa in [1,
  2), less 1, scaled and shifted in float32;
- normals: sqrt(2) erfinv(u) by XLA's float32 erfinv (Giles' polynomials in
  w = -log1p(-u^2), below 5 in w - 2.5, else in sqrt(w) - 3), each step a
  float64 multiply-add rounded once to float32, log1p taken in float64
  and rounded.
"""

from __future__ import annotations

import numpy as np

SEED = 12345
DIM = 32  # the sketch's width; the sketch applies where D > DIM

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32, 20 rounds, of the counter words (x0, x1) under the key
    (k0, k1): the output words (y0, y1), uint32."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def random_bits(seed: int, shape) -> np.ndarray:
    """uint32 bits of the key of `seed`, one an element of `shape`."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32((0, seed), (idx >> np.uint64(32)).astype(np.uint32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (y0 ^ y1).reshape(shape)


def _erfinv32(x: np.ndarray) -> np.ndarray:
    f = np.float32
    x = np.asarray(x, f)
    w = (-np.log1p((-x * x).astype(np.float64))).astype(f)
    lt = w < f(5.0)
    w = np.where(lt, w - f(2.5), np.sqrt(w) - f(3.0)).astype(f)
    p = np.where(lt, f(_ERFINV_LT5[0]), f(_ERFINV_GE5[0])).astype(f)
    w64 = w.astype(np.float64)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, f(a), f(b)).astype(np.float64)
        p = (c + p.astype(np.float64) * w64).astype(f)
    return np.where(np.abs(x) == f(1.0), x * np.finfo(f).max, p * x).astype(f)


def normal(seed: int, shape) -> np.ndarray:
    """float32 standard normals of the key of `seed`."""
    bits = random_bits(seed, shape)
    one = np.array(1.0, np.float32)
    floats = ((bits >> np.uint32(9)) | one.view(np.uint32)).view(np.float32) - one
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, floats * (one - lo) + lo).astype(np.float32)
    return (np.float32(np.sqrt(2)) * _erfinv32(u)).astype(np.float32)


def matrix(D: int) -> np.ndarray:
    """G (D, 32) float32: normal(12345, (D, 32)) / sqrt(32), the division in
    float32."""
    return (normal(SEED, (D, DIM)) / np.sqrt(np.float32(DIM))).astype(np.float32)
