"""Deterministic synthetic data pipeline (port of ``repro.data.synthetic``).

Every batch is a pure function of (seed, step), so a restarted job replays
the exact token stream.  Tokens are Zipf-ish draws with short-range
repetition (some positions copy the token 8 back), so losses are learnable.

The reference draws from ``jax.random``; the port draws the same bits and
values from :mod:`repro_torch.core.prng` (threefry2x32 in JAX's
partitionable mode, without jax), so text and audio tokens equal the
reference's bit for bit.  A VLM's bf16 ``img_embeds`` come from
:func:`repro_torch.core.prng.normal_bf16`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import prng
from repro_torch.models.common import resolve_device

__all__ = ["DataConfig", "make_batch", "host_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    zipf_alpha: float = 1.1
    repeat_p: float = 0.3  # probability a token copies one from 8 back


def _tokens(key, cfg: DataConfig, shape) -> np.ndarray:
    # Zipf via inverse-CDF on uniform; learnable short-range structure by
    # rewriting some positions with the token 8 steps earlier.
    k1, k2, _ = prng.split(key, 3)
    u = prng.uniform(k1, shape, 1e-6, 1.0).numpy()
    with np.errstate(over="ignore"):
        ranks = np.power(u, np.float32(-1.0 / (cfg.zipf_alpha - 1.0 + 1e-6))) - np.float32(1.0)
    toks = np.clip(ranks, 0, cfg.vocab_size - 1).astype(np.int32) % cfg.vocab_size
    rep = prng.uniform(k2, shape).numpy() < np.float32(cfg.repeat_p)
    return np.where(rep, np.roll(toks, 8, axis=-1), toks)


def host_batch(cfg: DataConfig, model_cfg: ModelConfig, step: int) -> dict:
    """The global batch of ``step`` as numpy arrays: ``tokens`` [B, S] int32
    ([B, S, K] for audio; [B, S - P] for a VLM, beside ``img_embeds`` [B, P,
    d] as a bf16 torch tensor, which numpy cannot hold)."""
    key = prng.fold_in(prng.PRNGKey(cfg.seed), step)
    B, S = cfg.global_batch, cfg.seq_len
    if model_cfg.modality == "audio":
        return {"tokens": _tokens(key, cfg, (B, S, model_cfg.num_codebooks))}
    if model_cfg.modality == "vlm":
        p = model_cfg.num_prefix_tokens
        k1, k2 = prng.split(key, 2)
        return {"tokens": _tokens(k1, cfg, (B, S - p)),
                "img_embeds": prng.normal_bf16(k2, (B, p, model_cfg.d_model))}
    return {"tokens": _tokens(key, cfg, (B, S))}


def make_batch(cfg: DataConfig, model_cfg: ModelConfig, step: int, device=None) -> dict:
    """:func:`host_batch` as tensors on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(v).to(dev) for k, v in host_batch(cfg, model_cfg, step).items()}
