"""Train state and run configuration (port of ``repro.train.state``).

:class:`RunConfig` keeps the reference's fields and defaults.  Without a
mesh there is one process and nothing to shard: ``zero1`` and
``seq_parallel`` change nothing, and PowerSGD (``grad_compression=
"powersgd"``), which compresses only across a mesh's ``pod`` axis, leaves
the step as it is, as the reference's one-device mesh does; its error
feedback is still allocated, as the reference allocates it.  On a mesh
(:func:`init_train_state` with ``mesh``) each process keeps its share of
the state: every parameter as :func:`repro_torch.dist.sharding.param_pspecs`
lays it out, the AdamW moments as ``zero1_pspecs`` does (``zero1``) or as
the parameters, the error feedback whole (:func:`train_state_shardings`).
``ckpt_dir``'s default sits in the temporary directory
(``tempfile.gettempdir()``: ``/tmp`` unless ``TMPDIR`` names another).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as shd
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_init

__all__ = ["RunConfig", "TrainState", "init_train_state", "train_state_shardings",
           "global_shapes"]


@dataclasses.dataclass(frozen=True)
class RunConfig:
    total_steps: int = 1000
    warmup_steps: int = 100
    microbatches: int = 1          # gradient accumulation
    remat: bool = True
    remat_policy: str = "full"     # full | dots (save matrix-product outputs)
    zero1: bool = True             # shard optimizer moments over the data axes
    grad_compression: str = "none"  # none | powersgd  (cross-pod axis)
    powersgd_rank: int = 8
    powersgd_min_size: int = 65536
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ckpt_every: int = 200
    log_every: int = 10
    optimizer: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    seq_parallel: bool = False


@dataclasses.dataclass
class TrainState:
    params: Transformer      # the model's weights (f32 masters), updated in place
    opt: AdamWState
    step: int
    ef: dict | None          # PowerSGD error feedback (name -> f32 zeros) or None


def global_shapes(cfg: ModelConfig) -> dict:
    """``{name: shape}`` of every parameter of ``cfg``'s model, unsharded
    (from a model on the meta device: nothing is allocated)."""
    return {n: tuple(p.shape) for n, p in Transformer(cfg, "meta").named_parameters()}


def train_state_shardings(cfg: ModelConfig, mesh, run: RunConfig) -> TrainState:
    """The :class:`~repro_torch.dist.sharding.Sharding` of every sharded leaf
    of a train state on ``mesh``, as a :class:`TrainState` of them by name:
    parameters by ``param_pspecs``, moments by ``zero1_pspecs`` (``run.zero1``)
    or ``param_pspecs``.  The error feedback is whole on every process
    (``ef`` None), and ``opt.count`` and ``step`` are host integers."""
    shapes = global_shapes(cfg)
    pspec = shd.param_pspecs(cfg, shapes, mesh)
    opt_spec = shd.zero1_pspecs(cfg, shapes, mesh) if run.zero1 else pspec
    params = shd.shardings_for(mesh, pspec)
    moments = shd.shardings_for(mesh, opt_spec)
    return TrainState(params=params, opt=AdamWState(mu=moments, nu=dict(moments), count=0),
                      step=0, ef=None)


def init_train_state(params: Transformer, run: RunConfig, mesh=None) -> TrainState:
    """A fresh state at step 0 with zero moments; every parameter of
    ``params`` is set to require grad.  With ``mesh``, ``params`` holds the
    whole model (the same on every process) and keeps only this process's
    shard of each parameter (:func:`train_state_shardings`)."""
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    ef = None
    if run.grad_compression == "powersgd":
        # the reference's CompressorConfig.compressible: matrices of min_size or more
        ef = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()
              if p.dim() >= 2 and p.numel() >= run.powersgd_min_size}
    if mesh is None:
        return TrainState(params=params, opt=adamw_init({n: p.detach() for n, p in named.items()}),
                          step=0, ef=ef)
    shapes = {n: tuple(p.shape) for n, p in named.items()}
    sh = train_state_shardings(params.cfg, mesh, run)
    with torch.no_grad():
        for n, p in named.items():
            if not sh.params[n].trivial:
                p.data = sh.params[n].local(p.detach()).clone()

    def zeros(n):
        shape = sh.opt.mu[n].local(torch.empty(shapes[n], device="meta")).shape
        return torch.zeros(shape, dtype=torch.float32, device=params.device)

    opt = AdamWState(mu={n: zeros(n) for n in named}, nu={n: zeros(n) for n in named}, count=0)
    return TrainState(params=params, opt=opt, step=0, ef=ef)
