"""The reference's counter-based PRNG (``jax.random``) in torch, without jax.

The reference draws its power-iteration start matrices, its sampled tokens
and its synthetic training batches from ``jax.random``: threefry2x32 (20
rounds) in JAX's partitionable mode.  This module gives the same bits and
the same f32 values, bit for bit, on any torch device:

- A key is the reference's raw key data, two uint32 words as a ``(2,)``
  ``np.uint32`` array: ``np.asarray(jax.random.PRNGKey(s))``.
  ``PRNGKey(s)`` is ``(0, s mod 2**32)``; ``fold_in(key, n)`` is threefry of
  the counter pair ``(0, n)``; ``split(key, n)[i]`` is threefry of ``(0,
  i)``.  Keys live on the host, as Python integers: two words a step.
- The bits of a draw of shape ``shape`` are, for the flat index ``i``,
  threefry of ``(i >> 32, i & 0xffffffff)`` with its two output words
  xor-ed.  They are computed as int64 tensors masked to 32 bits (a
  rotation is two shifts and an or), so a draw on the card never crosses
  PCIe.  ``device=None`` draws on the host's CPU; the host path is the same
  code, so both give the same bits.
- ``uniform`` puts the top 23 bits under the exponent of 1.0, subtracts 1
  and scales to ``[lo, hi)`` with one fused multiply-add, as XLA's compiled
  ``_uniform`` does.
- ``normal`` is ``sqrt(2) * erf_inv(uniform(nextafter(-1, 0), 1))`` with
  XLA's f32 ``erf_inv`` (Giles' polynomial in ``w = -log1p(-x*x)``, each
  Horner step one FMA) and XLA's CPU ``log1p`` / ``log`` (Cephes-style
  polynomials, contracted into FMAs as LLVM does).  ``torch.special.erfinv``
  and ``torch.log`` are not used: the former is up to 89 ulps off XLA's,
  the latter is not the same approximation on every device.
- ``gumbel`` is ``-log(-log(uniform(tiny, 1)))`` (JAX's default
  ``mode="low"``) and ``categorical`` is the argmax of ``logits +
  gumbel(key, logits.shape)`` on the last axis, as
  ``jax.random.categorical``.

Every float step is an IEEE-rounded f32 operation (add, multiply, divide:
the same result on every device), a square root corrected to the rounded
one (:func:`_sqrt`) or an emulated FMA (:func:`_fma`), so the values do not
depend on the device's math library.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["PRNGKey", "fold_in", "split", "key_words", "threefry2x32", "bits",
           "uniform", "normal", "normal_bf16", "gumbel", "categorical"]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32 = torch.float32
_F64 = torch.float64
_TINY = float(np.finfo(np.float32).tiny)
_ABOVE_MINUS_ONE = float(np.nextafter(np.float32(-1), np.float32(0)))


# -- keys (host) ---------------------------------------------------------------

def key_words(key) -> tuple[int, int]:
    """The two uint32 words of ``key`` as Python ints."""
    k = np.asarray(key, dtype=np.uint32).reshape(-1)
    if k.shape != (2,):
        raise ValueError(f"a key is two uint32 words, got shape {np.shape(key)}")
    return int(k[0]), int(k[1])


def _key(k0: int, k1: int) -> np.ndarray:
    return np.array([k0, k1], dtype=np.uint32)


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 - the reference's name
    """``jax.random.PRNGKey(seed)`` (32-bit seeds: ``(0, seed mod 2**32)``)."""
    return _key(0, int(seed) & _M32)


def _check_u32(n: int, what: str) -> int:
    n = int(n)
    if not 0 <= n <= _M32:
        raise OverflowError(f"{what} {n} out of bounds for uint32")
    return n


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for ``data`` in ``[0, 2**32)``."""
    return _key(*threefry2x32(key_words(key), 0, _check_u32(data, "fold_in data")))


def split(key, n: int = 2) -> np.ndarray:
    """``jax.random.split(key, n)``: [n, 2] uint32 key words."""
    words = key_words(key)
    return np.array([threefry2x32(words, 0, i) for i in range(n)], dtype=np.uint32)


# -- bits ----------------------------------------------------------------------

def _rotl(x, r: int):
    # the low 32 - r bits move up (masked first, so nothing passes bit 31 of
    # the int64), the high r bits come down
    return ((x & ((1 << (32 - r)) - 1)) << r) | (x >> (32 - r))


def threefry2x32(key: tuple[int, int], x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``x0``, ``x1`` (int64
    tensors of one shape holding uint32 values, or Python ints: a key's
    ``fold_in`` and ``split`` take a few microseconds that way) under ``key``
    (two uint32 words).  Returns the two output words, in ``[0, 2**32)``."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ((ks[(i + 2) % 3] + i + 1) & _M32)) & _M32
    return x0, x1


def bits(key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as an int64 tensor on
    ``device`` (the host's CPU when None) holding the 32 bits."""
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device="cpu" if device is None else device)
    y0, y1 = threefry2x32(key_words(key), idx >> 32, idx & _M32)
    return (y0 ^ y1).reshape(shape)


# -- f32 arithmetic that rounds as XLA's compiled code -------------------------

def _c(x: float) -> float:
    """``x`` rounded to f32, as a Python float: a constant of an f32 op (a
    Python scalar operand is converted to the tensor's f32 exactly, and
    needs no tensor of its own on the device)."""
    return float(np.float32(x))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` with one rounding (an FMA), on any device; ``b`` and
    ``c`` are f32 tensors or f32 constants (:func:`_c`).

    The product of two f32 values is exact in f64; the f64 sum is then
    rounded to odd (its last bit set when the sum was inexact and the bit
    is clear), which keeps enough of the exact sum that the final rounding
    to f32 (53 >= 24 + 2 bits) is the correctly rounded FMA.  Each step is
    an IEEE f64 operation, so every device gives the same bits (a plain f64
    product and sum could round twice)."""
    b, c = (t.to(_F64) if isinstance(t, torch.Tensor) else t for t in (b, c))
    p = a.to(_F64) * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)             # Knuth's two-sum: s + err = p + c
    bump = (err != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    return torch.where(bump, torch.nextafter(s, err * math.inf), s).to(_F32)


def _sqrt(w: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on any device (torch's vectorised
    CPU root is within an ulp, not correctly rounded): the f64 root rounded
    to f32, then moved one ulp where the square of the midpoint beside it
    (25 bits, so its square is exact in f64) shows it rounded the wrong way.
    A midpoint's square never equals an f32, so there are no ties."""
    w64 = w.to(_F64)
    r = torch.sqrt(w64).to(_F32)
    r64 = r.to(_F64)
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    down = torch.nextafter(r, torch.zeros_like(r))
    hi = (r64 + up.to(_F64)) * 0.5
    lo = (r64 + down.to(_F64)) * 0.5
    live = (w > 0) & torch.isfinite(w)
    r = torch.where(live & (hi * hi < w64), up, r)
    return torch.where(live & (lo * lo > w64), down, r)


_LOG_P = tuple(_c(v) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))


def _log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 ``log`` (Cephes ``logf``: the mantissa in [sqrt(1/2),
    sqrt(2)) - 1, a degree-8 polynomial in three FMA chains, the exponent
    times ln 2 in two parts); 0 -> -inf, inf -> inf, negative or NaN ->
    NaN.  A denormal input reads as 0, as XLA's CPU code runs with
    denormals flushed."""
    xin = torch.where(x.abs() < _TINY, 0.0, x)
    xi = torch.clamp_min(xin, _TINY).view(torch.int32)
    e = (xi >> 23).to(_F32) - 126.0
    x = ((xi & 0x007FFFFF) | 0x3F000000).view(_F32)     # mantissa in [0.5, 1)
    small = x < _c(0.707106781186547524)
    x = x - 1.0 + torch.where(small, x, 0.0)
    e = e - small.to(_F32)
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = _fma(x, p[0], p[1])
    y1 = _fma(x, p[3], p[4])
    y2 = _fma(x, p[6], p[7])
    y = _fma(y, x, p[2])
    y1 = _fma(y1, x, p[5])
    y2 = _fma(y2, x, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _c(-2.12194440e-4))
    x = _fma(x2, -0.5, x)
    x = x + y
    x = _fma(e, _c(0.693359375), x)
    x = torch.where(xin == 0, -math.inf, x)
    x = torch.where(xin == math.inf, math.inf, x)
    return torch.where((xin < 0) | torch.isnan(xin), math.nan, x)


_LOG1P_NUM = tuple(_c(v) for v in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
    2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_c(v) for v in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
    3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1))


def _poly(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, c)
    return p


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 ``log1p``: ``log(1 + x)`` for ``|x| >= sqrt(2) - 1``,
    else Cephes' rational ``x - x²/2 + x³ P(x)/Q(x)``."""
    x2 = x * x
    r = _poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN)
    small = x + _fma(x2, -0.5, (x * x2) * r)
    return torch.where(x.abs() < _c(0.41421356237309504880), small, _log(x + 1.0))


_ERFINV_W_LT_5 = tuple(_c(v) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_W_GE_5 = tuple(_c(v) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` (Giles' single-precision polynomial)."""
    w = -_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, _sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_W_LT_5[0], _ERFINV_W_GE_5[0])
    for a, b in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p = _fma(p, w, torch.where(lt, a, b))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


# -- draws -----------------------------------------------------------------------

def _unit(key, shape, device) -> torch.Tensor:
    """f32 in [0, 1): the top 23 bits of each draw under 1.0's exponent, less 1."""
    b = bits(key, shape, device)
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(_F32) - 1.0


def uniform(key, shape, lo: float = 0.0, hi: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, lo, hi)`` on ``device``."""
    lo32 = _c(lo)
    span = _c(_c(hi) - lo32)                          # rounded in f32, as the reference
    return torch.clamp_min(_fma(_unit(key, shape, device), span, lo32), lo32)


def normal(key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on ``device``."""
    u = uniform(key, shape, _ABOVE_MINUS_ONE, 1.0, device)
    return _erf_inv(u) * _c(np.sqrt(2))


def normal_bf16(key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, bfloat16)``: a bf16 uniform on
    (-1, 1) whose 7 mantissa bits are the top 7 of each draw's low byte
    (JAX draws 8 bits for a dtype with fewer than 8 mantissa bits), then
    ``sqrt(2) erf_inv``.  XLA evaluates the bf16 ``erf_inv`` in f32 and
    rounds once; the port computes ``erfinv`` in f64 and rounds once, which
    equalled the reference's on every element the tests drew (a one-ulp
    difference would be possible where the f32 approximation lands beside
    a bf16 rounding edge)."""
    byte = bits(key, shape, device) & 0xFF
    one = torch.tensor(1.0, dtype=torch.bfloat16, device=byte.device)
    f = ((byte >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16) - one
    lo = torch.nextafter(-one, one)             # the bf16 just above -1
    u = torch.maximum(lo, (f.float() * (one - lo).float() + lo.float()).to(torch.bfloat16))
    z = torch.special.erfinv(u.double()).to(torch.bfloat16)
    return z * torch.tensor(np.sqrt(2.0), dtype=torch.bfloat16, device=byte.device)


def gumbel(key, shape, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (``mode="low"``):
    ``-log(-log(uniform(tiny, 1)))``."""
    return -_log(-_log(uniform(key, shape, _TINY, 1.0, device)))


def categorical(key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax (first on ties) of ``logits + gumbel(key, logits.shape)``, drawn
    on the logits' device.  Returns int64 ids of shape ``logits.shape[:-1]``."""
    g = gumbel(key, logits.shape, logits.device)
    return torch.argmax(g + logits.to(_F32), dim=-1)
