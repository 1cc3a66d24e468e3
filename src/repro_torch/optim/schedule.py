"""LR schedules: cosine (default) and WSD (warmup-stable-decay, MiniCPM)
(port of ``repro.optim.schedule``).

The rate is an f32 scalar computed on the host in the order of f32
operations of the reference's compiled step: a Python constant meets an f32
value as an f32 constant (JAX's weak types), a division by a constant is a
product with its f32 reciprocal, and ``a * b + c`` rounds once (XLA's
rewrite and its FMA contraction; the f64 sum of an exact f32 product rounds
the same way).  The cosine is computed in f64 and rounded, where XLA's f32
cosine may differ by an ulp.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["lr_at"]

_F = np.float32


def _fma(a, b, c) -> np.float32:
    """``a * b + c`` in f32 with one rounding."""
    return _F(np.float64(_F(a)) * np.float64(_F(b)) + np.float64(_F(c)))


def lr_at(step, *, peak: float, total_steps: int, warmup: int = 100,
          kind: str = "cosine", stable_frac: float = 0.8,
          final_frac: float = 0.1) -> torch.Tensor:
    """The rate at ``step``: linear warmup to ``peak``, then a cosine decay to
    ``final_frac * peak`` at ``total_steps``, or (``kind="wsd"``) a plateau
    for ``stable_frac`` of the steps after warmup and a linear decay to
    ``final_frac * peak``.  Returns a 0-d f32 CPU tensor."""
    s = _F(int(step))
    if s < _F(warmup):
        lr = _F(peak) * min(_F(1.0), s * (_F(1.0) / _F(max(warmup, 1))))
    elif kind == "wsd":
        stable_end = warmup + stable_frac * (total_steps - warmup)
        if s < _F(stable_end):
            lr = _F(peak)
        else:
            span = _F(max(total_steps - stable_end, 1.0))
            frac = min(max((s - _F(stable_end)) * (_F(1.0) / span), _F(0.0)), _F(1.0))
            lr = _F(peak) * _fma(-(1.0 - final_frac), frac, 1.0)
    else:
        prog = (s - _F(warmup)) * (_F(1.0) / _F(max(total_steps - warmup, 1)))
        prog = min(max(prog, _F(0.0)), _F(1.0))
        cos = _F(math.cos(np.float64(_F(math.pi) * prog)))
        lr = _fma((1 - final_frac) * peak * 0.5, _F(1.0) + cos, final_frac * peak)
    return torch.tensor(lr, dtype=torch.float32)
