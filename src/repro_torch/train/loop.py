"""Training step and host loop on one device (port of ``repro.train.loop``).

* gradient accumulation over ``run.microbatches`` row slices of the batch,
  summed in f32 (each parameter's ``.grad``), then divided by their count;
* remat per layer (``torch.utils.checkpoint``, ``run.remat_policy``);
* AdamW with the schedule of the model's config (``cfg.lr_schedule``);
* checkpoint and restart: deterministic batches (``make_batch(data_cfg,
  cfg, step)``), resume from the latest committed checkpoint, an
  asynchronous save every ``ckpt_every`` steps, and on SIGTERM the current
  step finishes, the state is saved and the loop returns.

There is no mesh: ZeRO-1 and sequence parallelism have nothing to shard on
one device, and PowerSGD acts only across a ``pod`` axis, so
``grad_compression="powersgd"`` leaves the step as it is, as the
reference's one-device mesh does (sharding is ROADMAP queue 1, item 10).
The gradient never passes through a CUDA kernel: attention trains through
``attention_train``; the RWKV6 and hybrid scans raise on the card
(``linear_scan_chunked`` has no backward).
"""

from __future__ import annotations

import signal
import time
from typing import Callable

import torch

from repro_torch.ckpt import checkpoint as ckpt_lib
from repro_torch.data.synthetic import DataConfig, make_batch
from repro_torch.models.common import resolve_device
from repro_torch.models.model import Model
from repro_torch.optim.adamw import adamw_update
from repro_torch.optim.schedule import lr_at
from repro_torch.train.state import RunConfig, TrainState, init_train_state

__all__ = ["make_train_step", "train_loop"]


def _microbatch(batch: dict, m: int, i: int) -> dict:
    """Rows ``[i * B / m, (i + 1) * B / m)`` of every leaf of ``batch``."""
    out = {}
    for k, x in batch.items():
        mb = x.shape[0] // m
        out[k] = x[i * mb:(i + 1) * mb]
    return out


def _accum_grads(model: Model, params, batch: dict, run: RunConfig):
    """Mean loss and gradients over ``run.microbatches`` sequential row
    slices.  The gradients are f32 sums over the slices (each parameter's
    ``.grad``; f32 masters give f32 gradients) divided by the count; the
    metrics are the last slice's.  Returns (loss, metrics, grads by name)."""
    m = run.microbatches
    named = dict(params.named_parameters())
    for p in named.values():
        p.grad = None
    loss_sum, metrics = None, None
    for i in range(m):
        loss, metrics = model.loss_fn(params, _microbatch(batch, m, i), remat=run.remat,
                                      remat_policy=run.remat_policy)
        loss.backward()
        loss = loss.detach()
        loss_sum = loss if loss_sum is None else loss_sum + loss
    grads = {}
    for n, p in named.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if g.dtype != torch.float32:
            g = g.to(torch.float32)
        grads[n] = g if m == 1 else g.div_(m)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss_sum / m, metrics, grads


def make_train_step(model: Model, run: RunConfig) -> Callable:
    """The ``(state, batch) -> (state, metrics)`` step: gradients
    (:func:`_accum_grads`), the rate ``lr_at(state.step)`` of the config's
    schedule, and AdamW (in place).  Metrics: ``ce``, ``aux``, ``loss``,
    ``lr`` and ``grad_norm``."""

    def step(state: TrainState, batch: dict):
        loss, metrics, grads = _accum_grads(model, state.params, batch, run)
        lr = lr_at(state.step, peak=run.optimizer.lr_peak, total_steps=run.total_steps,
                   warmup=run.warmup_steps, kind=model.cfg.lr_schedule)
        named = dict(state.params.named_parameters())
        _, opt, om = adamw_update(run.optimizer, grads, state.opt,
                                  {n: p.detach() for n, p in named.items()}, lr)
        for p in named.values():
            p.grad = None
        metrics = dict(metrics, loss=loss, lr=lr, **om)
        return TrainState(params=state.params, opt=opt, step=state.step + 1, ef=state.ef), metrics

    return step


class _Preemption:
    """SIGTERM -> finish the current step, checkpoint, return.  The previous
    handler comes back on :meth:`close`."""

    def __init__(self):
        self.flagged = False
        self._previous = None
        try:
            self._previous = signal.signal(signal.SIGTERM, self._handle)
        except ValueError:
            pass  # not on the main thread: no handler

    def _handle(self, *_):
        self.flagged = True

    def close(self) -> None:
        if self._previous is not None:
            signal.signal(signal.SIGTERM, self._previous)


def train_loop(model: Model, run: RunConfig, data_cfg: DataConfig, steps: int | None = None,
               log_fn=print, device=None) -> TrainState:
    """Run (or resume from ``run.ckpt_dir``) training to ``steps`` (default
    ``run.total_steps``) on ``device`` (CUDA unless named); returns the
    final state.  The weights start from ``model.init(seed=0)`` in f32."""
    dev = resolve_device(device)
    cfg = model.cfg
    state = init_train_state(model.init(seed=0, device=dev, dtype=torch.float32), run)
    start = ckpt_lib.latest_step(run.ckpt_dir)
    if start is not None:
        state = ckpt_lib.restore(run.ckpt_dir, start, state)
        log_fn(f"[restore] resumed from step {start}")
    step_fn = make_train_step(model, run)
    pre = _Preemption()
    total = steps or run.total_steps
    t0 = time.time()
    try:
        while state.step < total:
            s = state.step
            state, metrics = step_fn(state, make_batch(data_cfg, cfg, s, dev))
            if s % run.log_every == 0:
                m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
                log_fn(f"[step {s}] " + " ".join(f"{k}={v:.4g}" for k, v in sorted(m.items()))
                       + f" ({time.time() - t0:.1f}s)")
            if run.ckpt_every and s > 0 and s % run.ckpt_every == 0:
                ckpt_lib.save_async(run.ckpt_dir, s, state)
            if pre.flagged:
                log_fn("[preempt] SIGTERM received — checkpointing and exiting")
                ckpt_lib.save(run.ckpt_dir, state.step, state)
                break
    finally:
        pre.close()
        ckpt_lib.wait_pending()
    return state
