"""Training step and host loop, on one device or on a device mesh (port of
``repro.train.loop``).

* gradient accumulation over ``run.microbatches`` row slices of the batch,
  summed in f32 (each parameter's ``.grad``), then divided by their count;
* remat per layer (``torch.utils.checkpoint``, ``run.remat_policy``);
* AdamW with the schedule of the model's config (``cfg.lr_schedule``);
* on a mesh (:mod:`repro_torch.launch.mesh`): the batch split over the data
  axes, ZeRO-1 optimizer moments, and PowerSGD across a ``pod`` axis
  (:func:`make_train_step`);
* checkpoint and restart: deterministic batches (``make_batch(data_cfg,
  cfg, step)``), resume from the latest committed checkpoint, an
  asynchronous save every ``ckpt_every`` steps, and on SIGTERM the current
  step finishes, the state is saved and the loop returns.  Checkpoints hold
  global arrays, so a job restarts on any mesh.

Attention trains through ``attention_train``; an RWKV6 or hybrid model's
scan runs ``linear_scan_chunked`` and its backward kernel on the card.
"""

from __future__ import annotations

import signal
import time
from typing import Callable

import torch

import torch.distributed as dist

from repro_torch.ckpt import checkpoint as ckpt_lib
from repro_torch.data.synthetic import DataConfig, make_batch
from repro_torch.dist import sharding as shd
from repro_torch.dist.compat import all_reduce_mean_, axis_group
from repro_torch.dist.whole import WholeModel
from repro_torch.launch.mesh import DATA, POD, axis_sizes, dp_axes, mesh_device
from repro_torch.models.common import resolve_device
from repro_torch.models.model import Model
from repro_torch.optim.adamw import adamw_update, global_norm
from repro_torch.optim.grad_compress import CompressorConfig, compressed_psum, draw_inits
from repro_torch.optim.schedule import lr_at
from repro_torch.train.state import (RunConfig, TrainState, global_shapes, init_train_state,
                                    train_state_shardings)

__all__ = ["make_train_step", "train_state_shardings", "train_loop"]


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


def make_train_step(model: Model, run: RunConfig, mesh=None) -> Callable:
    """The ``(state, batch) -> (state, metrics)`` step: gradients
    (:func:`_accum_grads`), the rate ``lr_at(state.step)`` of the config's
    schedule, and AdamW (in place).  Metrics: ``ce``, ``aux``, ``loss``,
    ``lr`` and ``grad_norm``; with PowerSGD on a mesh also
    ``exact_bytes``, ``compressed_bytes`` and ``n_dev``.

    With ``mesh``, the state is :func:`init_train_state`'s on that mesh and
    ``batch`` the global batch; see :class:`_MeshStep`."""
    if mesh is not None:
        return _MeshStep(model, run, mesh)

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


class _MeshStep:
    """The train step of one process on a mesh: the values of the unsharded
    step, whatever the layout ("layout, not semantics").

    * The batch's rows split over the data axes (``batch_pspecs``); every
      ``model`` process of a data group sees the same rows.  Each process's
      loss and gradients are the means over its rows, then averaged in f32
      over the data axes (with PowerSGD: exactly over ``data``, then
      :func:`~repro_torch.optim.grad_compress.compressed_psum` over ``pod``).
    * Each process stores its shard of every parameter (``param_pspecs``).
      At the step, a parameter's shards are gathered over ``model`` into a
      whole-model module that the forward runs on
      (:class:`~repro_torch.dist.whole.WholeModel`), so the forward, attention
      and the scan kernels see plain tensors; a parameter the layout does not
      split is that module's own parameter, shared, never copied.  The
      gathered copies are dropped after the step.
    * Every process then holds the whole mean gradient, and takes its
      global norm.  AdamW updates the moments' slice (``zero1_pspecs`` with
      ``run.zero1``, else the parameter's) of each parameter, and the updated
      slices are gathered back over the data axes into the stored shard.

    A mesh axis of size 1 issues no collective, so on a one-process mesh
    the step computes what the one-device step does, bit for bit.
    """

    def __init__(self, model: Model, run: RunConfig, mesh):
        self.model, self.run, self.mesh = model, run, mesh
        self.sh = train_state_shardings(model.cfg, mesh, run)
        self.powersgd = run.grad_compression == "powersgd" and POD in axis_sizes(mesh)
        self.ccfg = CompressorConfig(rank=run.powersgd_rank, axis=POD,
                                     min_size=run.powersgd_min_size)
        self.shapes = global_shapes(model.cfg)
        # decided once per parameter: whether the layout splits it (gathered
        # at each step), and over which data axes the moments' slice is
        # narrower than the stored shard (ZeRO-1: gathered back after AdamW)
        self.whole = WholeModel(model.cfg, self.sh.params, requires_grad=True)
        self.split = self.whole.split
        self.zero1_axes = {n: tuple(_spec_axes(osh.spec) - _spec_axes(self.sh.params[n].spec))
                           for n, osh in self.sh.opt.mu.items()
                           if not osh.same_slices(self.sh.params[n])}

    def __call__(self, state: TrainState, batch: dict):
        run, mesh, cfg = self.run, self.mesh, self.model.cfg
        bsh = shd.shardings_for(mesh, shd.batch_pspecs(cfg, batch, mesh))
        local = {k: v if bsh[k].trivial else bsh[k].local(v) for k, v in batch.items()}
        whole = self.whole.gather(state.params)
        try:
            loss, metrics, grads = _accum_grads(self.model, whole, local, run)
            extra = {}
            exact_axes = (DATA,) if self.powersgd else dp_axes(mesh)
            for g in grads.values():
                all_reduce_mean_(g, mesh, exact_axes)
            all_reduce_mean_(loss, mesh, dp_axes(mesh))
            ef = state.ef
            if self.powersgd:
                inits = draw_inits(self.shapes, self.ccfg, state.step, device=loss.device)
                grads, ef, extra = compressed_psum(grads, state.ef, self.ccfg,
                                                   axis_group(mesh, POD), inits)
            lr = lr_at(state.step, peak=run.optimizer.lr_peak, total_steps=run.total_steps,
                       warmup=run.warmup_steps, kind=cfg.lr_schedule)
            gnorm = global_norm(grads)
            stored = dict(state.params.named_parameters())
            whole_params = dict(whole.named_parameters())
            slices, slice_grads = {}, {}
            for n, p in stored.items():
                if n in self.zero1_axes:
                    osh = self.sh.opt.mu[n]
                    slices[n] = osh.local(whole_params[n].detach()).contiguous()
                    slice_grads[n] = osh.local(grads[n]).contiguous()
                else:
                    slices[n] = p.detach()
                    slice_grads[n] = (self.sh.params[n].local(grads[n]).contiguous()
                                      if n in self.split else grads[n])
            _, opt, om = adamw_update(run.optimizer, slice_grads, state.opt, slices, lr,
                                      gnorm=gnorm)
            with torch.no_grad():
                for n, axes in self.zero1_axes.items():
                    stored[n].copy_(self.sh.opt.mu[n].full(slices[n], axes=axes))
        finally:
            for p in whole.parameters():
                p.grad = None
            self.whole.release()
        metrics = dict(metrics, loss=loss, lr=lr, **om, **extra)
        return TrainState(params=state.params, opt=opt, step=state.step + 1, ef=ef), metrics


def _spec_axes(spec) -> set:
    return {a for e in spec for a in shd._axes_of(e)}


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
               log_fn=print, device=None, mesh=None) -> TrainState:
    """Run (or resume from ``run.ckpt_dir``) training to ``steps`` (default
    ``run.total_steps``) on ``device`` (CUDA unless named), or on ``mesh``
    (a :mod:`repro_torch.launch.mesh` mesh: every process of the job calls
    this; each trains on the device it drives, and only rank 0 logs);
    returns the final state.  The weights start from ``model.init(seed=0)``
    in f32."""
    if mesh is None:
        dev = resolve_device(device)
    else:
        dev = mesh_device(mesh)
        if device is not None and resolve_device(device).type != dev.type:
            raise ValueError(f"train_loop: device {device!r} is not the mesh's "
                             f"{mesh.device_type!r}")
    cfg = model.cfg
    lead = mesh is None or dist.get_rank() == 0
    log = log_fn if lead else (lambda *_: None)
    state = init_train_state(model.init(seed=0, device=dev, dtype=torch.float32), run, mesh)
    shardings = None if mesh is None else train_state_shardings(cfg, mesh, run)
    start = ckpt_lib.latest_step(run.ckpt_dir)
    if start is not None:
        state = ckpt_lib.restore(run.ckpt_dir, start, state, shardings)
        log(f"[restore] resumed from step {start}")
    step_fn = make_train_step(model, run, mesh)
    pre = _Preemption()
    total = steps or run.total_steps
    t0 = time.time()
    try:
        while state.step < total:
            s = state.step
            state, metrics = step_fn(state, make_batch(data_cfg, cfg, s, dev))
            if s % run.log_every == 0:
                m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
                log(f"[step {s}] " + " ".join(f"{k}={v:.4g}" for k, v in sorted(m.items()))
                    + f" ({time.time() - t0:.1f}s)")
            if run.ckpt_every and s > 0 and s % run.ckpt_every == 0:
                ckpt_lib.save_async(run.ckpt_dir, s, state, shardings)
            if _preempted(pre, mesh):
                log("[preempt] SIGTERM received — checkpointing and exiting")
                ckpt_lib.save(run.ckpt_dir, state.step, state, shardings)
                break
    finally:
        pre.close()
        ckpt_lib.wait_pending()
        if mesh is not None and dist.get_world_size() > 1:
            dist.barrier()
    return state


def _preempted(pre: _Preemption, mesh) -> bool:
    """Whether any process of the job got SIGTERM (all of them stop at the
    same step)."""
    if mesh is None or dist.get_world_size() == 1:
        return pre.flagged
    flag = torch.tensor([float(pre.flagged)], device=mesh_device(mesh))
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())
