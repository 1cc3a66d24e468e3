"""Deterministic synthetic data pipeline (port of ``repro.data.synthetic``).

Every batch is a pure function of (seed, step), so a restarted job replays
the exact token stream.  Tokens are Zipf-ish draws with short-range
repetition (some positions copy the token 8 back), so losses are learnable.

The reference draws from ``jax.random``; torch cannot reproduce that, so
this module carries its generator in numpy: threefry2x32 (20 rounds) in JAX's
partitionable mode.  A key is two uint32 words; ``PRNGKey(s)`` is ``(0, s)``;
``fold_in(key, n)`` is threefry of the counter pair ``(0, n)``; ``split(key,
n)[i]`` is threefry of ``(0, i)``; the bits of a draw of shape ``shape`` are,
for the flat index ``i``, threefry of ``(i >> 32, i & 0xffffffff)`` with its
two output words xor-ed.  ``uniform`` puts the top 23 bits under the
exponent of 1.0, subtracts 1 and scales to ``[lo, hi)`` with one rounding
(XLA fuses the product and the sum into an FMA; the f64 sum of the exact
f32 product rounds the same way at these magnitudes).  So text and audio
tokens equal the reference's bit for bit.  A VLM's bf16 ``img_embeds`` come
from ``jax.random.normal`` through an f32 ``erf_inv`` rounded to bf16; the
port computes ``erfinv`` in f64 and rounds once, which equalled the
reference's on every element the tests drew (a one-ulp difference would be
possible where the f32 approximation lands beside a bf16 rounding edge).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import resolve_device

__all__ = ["DataConfig", "make_batch", "host_batch"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    zipf_alpha: float = 1.1
    repeat_p: float = 0.3  # probability a token copies one from 8 back


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: tuple, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 (20 rounds) of the counter words ``x0``, ``x1`` (uint32
    arrays of one shape) under ``key`` (two uint32 words)."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _U32(0x1BD11BDA))
    x0 = np.asarray(x0, _U32) + ks[0]
    x1 = np.asarray(x1, _U32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def _key(seed: int) -> tuple:
    return (_U32(0), _U32(seed))


def _fold_in(key: tuple, data: int) -> tuple:
    y0, y1 = threefry2x32(key, np.array([0], _U32), np.array([data], _U32))
    return (y0[0], y1[0])


def _split(key: tuple, n: int) -> list:
    y0, y1 = threefry2x32(key, np.zeros(n, _U32), np.arange(n, dtype=_U32))
    return [(y0[i], y1[i]) for i in range(n)]


def _bits(key: tuple, shape) -> np.ndarray:
    """32 random bits per element (``jax.random.bits``, partitionable mode)."""
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    y0, y1 = threefry2x32(key, (idx >> np.uint64(32)).astype(_U32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(_U32))
    return (y0 ^ y1).reshape(shape)


def _uniform(key: tuple, shape, lo: float = 0.0, hi: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, lo, hi)``."""
    lo32, hi32 = np.float32(lo), np.float32(hi)
    f = ((_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - np.float32(1)
    scaled = (f.astype(np.float64) * np.float64(hi32 - lo32) + np.float64(lo32)).astype(np.float32)
    return np.maximum(lo32, scaled)


def _normal_bf16(key: tuple, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, bfloat16)``: a bf16 uniform on
    (-1, 1) whose 7 mantissa bits are the top 7 of each draw's low byte
    (JAX draws 8 bits for a dtype with fewer than 8 mantissa bits), then
    ``sqrt(2) erfinv``."""
    byte = (_bits(key, shape) & _U32(0xFF)).astype(np.uint16)
    one = torch.tensor(1.0, dtype=torch.bfloat16)
    f = torch.from_numpy(((byte >> np.uint16(1)) | np.uint16(0x3F80)).view(np.int16))
    f = f.view(torch.bfloat16) - one
    lo = torch.nextafter(-one, one)             # the bf16 just above -1
    u = torch.maximum(lo, (f.float() * (one - lo).float() + lo.float()).to(torch.bfloat16))
    z = torch.special.erfinv(u.double()).to(torch.bfloat16)
    sqrt2 = torch.tensor(np.sqrt(2.0), dtype=torch.bfloat16)
    return z * sqrt2


def _tokens(key: tuple, cfg: DataConfig, shape) -> np.ndarray:
    # Zipf via inverse-CDF on uniform; learnable short-range structure by
    # rewriting some positions with the token 8 steps earlier.
    k1, k2, _ = _split(key, 3)
    u = _uniform(k1, shape, 1e-6, 1.0)
    with np.errstate(over="ignore"):
        ranks = np.power(u, np.float32(-1.0 / (cfg.zipf_alpha - 1.0 + 1e-6))) - np.float32(1.0)
    toks = np.clip(ranks, 0, cfg.vocab_size - 1).astype(np.int32) % cfg.vocab_size
    rep = _uniform(k2, shape) < np.float32(cfg.repeat_p)
    return np.where(rep, np.roll(toks, 8, axis=-1), toks)


def host_batch(cfg: DataConfig, model_cfg: ModelConfig, step: int) -> dict:
    """The global batch of ``step`` as numpy arrays: ``tokens`` [B, S] int32
    ([B, S, K] for audio; [B, S - P] for a VLM, beside ``img_embeds`` [B, P,
    d] as a bf16 torch tensor, which numpy cannot hold)."""
    key = _fold_in(_key(cfg.seed), step)
    B, S = cfg.global_batch, cfg.seq_len
    if model_cfg.modality == "audio":
        return {"tokens": _tokens(key, cfg, (B, S, model_cfg.num_codebooks))}
    if model_cfg.modality == "vlm":
        p = model_cfg.num_prefix_tokens
        k1, k2 = _split(key, 2)
        return {"tokens": _tokens(k1, cfg, (B, S - p)),
                "img_embeds": _normal_bf16(k2, (B, p, model_cfg.d_model))}
    return {"tokens": _tokens(key, cfg, (B, S))}


def make_batch(cfg: DataConfig, model_cfg: ModelConfig, step: int, device=None) -> dict:
    """:func:`host_batch` as tensors on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(v).to(dev) for k, v in host_batch(cfg, model_cfg, step).items()}
