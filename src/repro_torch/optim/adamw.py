"""Minimal AdamW with global-norm clipping (port of ``repro.optim.adamw``).

The update follows the reference step for step: the global norm of the
gradients in f32, a clip scale ``min(1, clip_norm / max(gnorm, 1e-9))``,
f32 moments, f32 bias corrections ``1 - b ** count``, and decoupled decay
``p - lr * (step + wd * p)`` on every parameter (norm scales and biases
too), the result cast back to the parameter's dtype.  ``torch.optim.AdamW``
is not this update: it decays before the step and keeps bf16 moments for
bf16 parameters.

Parameters, gradients and moments are dicts keyed by the model's parameter
names (``Transformer.named_parameters()``).  :func:`adamw_update` writes the
new parameters and moments into the given tensors: at minicpm-2b's 2.7 B
parameters the f32 masters, gradients and moments take 44 GB, and a second
copy of them would not fit one 80 GB card.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


@dataclasses.dataclass
class AdamWState:
    mu: dict        # name -> f32 first moment
    nu: dict        # name -> f32 second moment
    count: int      # updates applied


def adamw_init(params: dict) -> AdamWState:
    """Zero f32 moments for ``params`` (name -> tensor)."""
    zeros = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    return AdamWState(mu=zeros, nu={n: torch.zeros_like(z) for n, z in zeros.items()}, count=0)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every element of every tensor, in f32."""
    total = sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree.values())
    return torch.sqrt(total)


# elements of one leaf updated per pass: bounds the f64 temporaries of
# :func:`_fma` to a few GB on the largest leaf (an embedding table)
_CHUNK = 1 << 26


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` in f32 with one rounding, as XLA's FMA contraction of
    the reference's update computes it (the f64 sum of the exact f32
    product rounds the same way)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict, state: AdamWState, params: dict, lr,
                 gnorm: torch.Tensor | None = None):
    """One AdamW step of ``params`` from ``grads`` (name -> tensor) at rate
    ``lr`` (an f32 scalar: :func:`repro_torch.optim.schedule.lr_at`).
    ``params`` and ``state``'s moments are updated in place (they must be
    contiguous).  ``gnorm`` is the global norm to clip by, when ``grads``
    are slices of the gradient (ZeRO-1: each process updates its slice);
    None computes it from ``grads``.  Returns (params, the new
    :class:`AdamWState`, {"grad_norm": the unclipped global norm}).

    The arithmetic is the reference's compiled step: ``mu = fma(b1, mu, (1 -
    b1) g)``, ``nu = fma(b2, nu, (1 - b2) g g)`` and ``p = fma(-lr, step +
    wd p, p)``, each rounded once."""
    f32 = torch.float32
    if gnorm is None:
        gnorm = global_norm(grads)
    dev = gnorm.device

    def const(v):
        return torch.tensor(v, dtype=f32, device=dev)

    scale = torch.clamp(const(cfg.clip_norm) / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state.count + 1
    b1, b2 = const(cfg.b1), const(cfg.b2)
    c1, c2 = const(1 - cfg.b1), const(1 - cfg.b2)
    b1c = 1 - b1 ** float(count)
    b2c = 1 - b2 ** float(count)
    neg_lr = -torch.as_tensor(lr, dtype=f32).to(dev)
    for name, p in params.items():
        m, n = state.mu[name], state.nu[name]
        for t, what in ((p, "parameter"), (m, "first moment"), (n, "second moment")):
            if not t.is_contiguous():
                raise ValueError(f"adamw_update: the {what} of {name} is not contiguous")
        flat = [t.reshape(-1) for t in (p, grads[name], m, n)]
        for i in range(0, flat[0].numel(), _CHUNK):
            pc, gc, mc, nc = (t[i:i + _CHUNK] for t in flat)
            g = gc.to(f32) * scale
            mc.copy_(_fma(b1, mc, c1 * g))
            nc.copy_(_fma(b2, nc, c2 * g * g))
            step = (mc / b1c) / (torch.sqrt(nc / b2c) + cfg.eps)
            pf = pc.to(f32)
            pc.copy_(_fma(neg_lr, step + cfg.weight_decay * pf, pf).to(p.dtype))
    return params, AdamWState(mu=state.mu, nu=state.nu, count=count), {"grad_norm": gnorm}
