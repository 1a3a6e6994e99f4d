"""`jax.random.normal` of a seed's key, float32, in numpy.

The approximate matcher of the reference projects descriptors onto a fixed
Gaussian matrix, `jax.random.normal(jax.random.PRNGKey(12345), (D, 32))`
(`autopanostitch_tpu/ops/matching.py` `global_knn`). The port draws the same
matrix without JAX, for any shape, by the same steps:

- the key of `PRNGKey(seed)` for a 32-bit seed: (seed >> 32 = 0, seed);
- the bits: Threefry-2x32 (20 rounds) of the flattened element index as a
  64-bit counter split into (high, low) words, the two output words XORed
  (`jax_threefry_partitionable=True`, JAX's default);
- `uniform(lo, 1)` with lo = nextafter(-1, 0): the top 23 bits as a
  mantissa in [1, 2), less 1, scaled and shifted in float32;
- `sqrt(2) * erfinv(u)`: XLA's float32 erfinv (Giles' polynomials with
  log1p), in float32.

The bits and the uniforms are bit-equal to JAX's; about 99 % of the normals
are too, and the rest lie within 3 ulp (XLA's log1p rounds differently on
some inputs; `tests/test_torch_approx.py` holds the bound).
"""

from __future__ import annotations

import numpy as np

_ROT = (np.array([13, 15, 26, 6], np.uint32), np.array([17, 29, 16, 24], np.uint32))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds of the counter words (x0, x1) under the
    key (k0, k1), as `jax._src.prng.threefry_2x32`. Returns (y0, y1)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], int(r)) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def random_bits(seed: int, shape) -> np.ndarray:
    """uint32 bits of `jax.random.bits(PRNGKey(seed), shape)`."""
    if not 0 <= seed < 2**31:
        raise ValueError(f"seed {seed} outside [0, 2^31)")
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32((0, seed), (idx >> np.uint64(32)).astype(np.uint32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return (y0 ^ y1).reshape(shape)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erfinv: w = -log1p(-x^2); below 5 a degree-8
    polynomial in w - 2.5, else one in sqrt(w) - 3 (its steps fused
    multiply-adds, as XLA's CPU code contracts them; here exact float64
    products and sums rounded once to float32); times x. log1p is taken in
    float64 and rounded: XLA's own log1p differs from it by an ulp on some
    inputs."""
    x = np.asarray(x, np.float32)
    f = np.float32
    w = (-np.log1p((-x * x).astype(np.float64))).astype(np.float32)
    lt = w < f(5.0)
    w = np.where(lt, w - f(2.5), np.sqrt(w) - f(3.0)).astype(np.float32)
    p = np.where(lt, f(_ERFINV_LT5[0]), f(_ERFINV_GE5[0])).astype(np.float32)
    w64 = w.astype(np.float64)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = np.where(lt, f(a), f(b)).astype(np.float64)
        p = (c + p.astype(np.float64) * w64).astype(np.float32)
    out = p * x
    return np.where(np.abs(x) == f(1.0), x * np.finfo(np.float32).max, out).astype(np.float32)


def normal(seed: int, shape) -> np.ndarray:
    """float32 `jax.random.normal(jax.random.PRNGKey(seed), shape)`."""
    bits = random_bits(seed, shape)
    one = np.array(1.0, np.float32)
    floats = ((bits >> np.uint32(9)) | one.view(np.uint32)).view(np.float32) - one
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, floats * (one - lo) + lo).astype(np.float32)
    return (np.float32(np.sqrt(2)) * erfinv32(u)).astype(np.float32)
