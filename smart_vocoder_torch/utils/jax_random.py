"""The part of ``jax.random`` that the fidelity recipe draws from, in numpy.

JAX's default generator is Threefry-2x32, a counter-based hash of 32-bit
integer arithmetic, so its bits are the same on every platform and can be
computed here without JAX. A key is two uint32 words. This module follows
JAX's "partitionable" counter layout (``jax_threefry_partitionable``, the
default since JAX 0.5): element i of a draw hashes the counter pair
(i >> 32, i & 0xffffffff) and keeps the xor of the two output words.

``uniform`` forms ``u * (hi - lo) + lo`` with one rounding, as XLA's fused
multiply-add does (a product of two f32 values is exact in f64), so it
matches ``jax.random.uniform`` bit for bit. ``normal`` evaluates XLA's f32
inverse error function (M. Giles' single-precision polynomial, the
expansion of ``chlo.erf_inv``) with fused steps; numpy's ``log1p`` inside it
may sit an ulp from XLA's, so a value may differ from JAX's by an ulp.
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)
# erfinv(x) = x * p(w), w = -log1p(-x^2): p's coefficients, highest first,
# for w < 5 (evaluated at w - 2.5) and for w >= 5 (at sqrt(w) - 3)
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                        0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                        1.50140941], np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                        0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                        2.83297682], np.float32)


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x0, x1)``,
    uint32 arrays of one shape, under ``key``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))`` for a seed below 2**32."""
    return np.array([0, seed], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the counter pair (0, data)."""
    y0, y1 = threefry2x32(k, np.zeros(1, np.uint32), np.array([data], np.uint32))
    return np.concatenate([y0, y1])


def random_bits(k: np.ndarray, n: int) -> np.ndarray:
    """``n`` 32-bit words, element i from the counter (i >> 32, i & 0xffffffff)."""
    i = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(k, (i >> np.uint64(32)).astype(np.uint32),
                          (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    return y0 ^ y1


def uniform(k: np.ndarray, shape, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, lo, hi)``, bit for bit."""
    shape = tuple(shape)
    bits = random_bits(k, math.prod(shape))
    u = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo32, hi32 = np.float32(lo), np.float32(hi)
    span = np.float32(hi32 - lo32)
    x = (u.astype(np.float64) * np.float64(span) + np.float64(lo32)).astype(np.float32)
    return np.maximum(lo32, x).reshape(shape)


def erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``erf_inv`` on ``x`` in (-1, 1), each Horner step one
    rounding."""
    x = x.astype(np.float32)
    w = -np.log1p(-x * x)
    lt5 = w < np.float32(5)
    w = np.where(lt5, w - np.float32(2.5), np.sqrt(w) - np.float32(3)).astype(np.float64)
    p = np.where(lt5, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for lt, ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = (np.where(lt5, lt, ge).astype(np.float64) + p.astype(np.float64) * w).astype(np.float32)
    return p * x


def normal(k: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``: ``sqrt(2) * erfinv(u)`` with
    ``u`` uniform on [nextafter(-1, 0), 1)."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    return np.float32(math.sqrt(2)) * erfinv(uniform(k, shape, lo, 1.0))
