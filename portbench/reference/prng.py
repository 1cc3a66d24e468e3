"""The power iteration's start matrix, drawn without the program.

GEAR's low-rank step starts its power iteration from
``jax.random.normal(PRNGKey(0), (d, rank))`` in the JAX reference, and the
port draws the same values (``repro_torch.core.prng``).  This is a frozen,
plain copy of that draw for the benchmark's reference: threefry-2x32 (20
rounds) over the flat index in JAX's partitionable mode, the top 23 bits
as a uniform in [nextafter(-1, 0), 1), and ``sqrt(2) * erfinv(u)``.  The
bits are exact; the normal is evaluated in float64 and rounded to float32,
so a value may differ from XLA's float32 polynomial in its last bit, which
moves the span the power iteration finds by far less than the comparison's
limit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & np.uint64(_M32)


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 of the counter words ``x0``, ``x1`` (uint64 arrays
    holding 32-bit values) under ``key``; returns the two output words."""
    m = np.uint64(_M32)
    k0, k1 = key
    ks = [np.uint64(k0), np.uint64(k1), np.uint64(k0 ^ k1 ^ 0x1BD11BDA)]
    x0 = (x0 + ks[0]) & m
    x1 = (x1 + ks[1]) & m
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & m
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & m
        x1 = (x1 + ((ks[(i + 2) % 3] + np.uint64(i + 1)) & m)) & m
    return x0, x1


def normal(key: tuple[int, int], shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on the host, as float32."""
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(key, idx >> np.uint64(32), idx & np.uint64(_M32))
    bits = (y0 ^ y1).astype(np.uint32)
    unit = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    lo = np.float32(np.nextafter(np.float32(-1), np.float32(0)))
    u = np.maximum(unit * (np.float32(1.0) - lo) + lo, lo).astype(np.float64)
    z = math.sqrt(2.0) * torch.special.erfinv(torch.from_numpy(u))
    return z.to(torch.float32).reshape(shape)


def pi_start(d: int, rank: int) -> torch.Tensor:
    """The start matrix [d, rank] of every power iteration (key 0)."""
    return normal((0, 0), (d, rank))
