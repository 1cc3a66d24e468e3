"""Train state and run configuration (port of ``repro.train.state``).

:class:`RunConfig` keeps the reference's fields and defaults.  On one device
``zero1`` and ``seq_parallel`` have nothing to shard, and PowerSGD
(``grad_compression="powersgd"``), which compresses only across a mesh's
``pod`` axis, leaves the step as it is, as the reference's one-device mesh
does; its error feedback is still allocated, as the reference allocates it.
``ckpt_dir``'s default sits in the temporary directory
(``tempfile.gettempdir()``: ``/tmp`` unless ``TMPDIR`` names another).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile

import torch

from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_init

__all__ = ["RunConfig", "TrainState", "init_train_state"]


@dataclasses.dataclass(frozen=True)
class RunConfig:
    total_steps: int = 1000
    warmup_steps: int = 100
    microbatches: int = 1          # gradient accumulation
    remat: bool = True
    remat_policy: str = "full"     # full | dots (save matrix-product outputs)
    zero1: bool = True             # shards optimizer moments over a data axis (none here)
    grad_compression: str = "none"  # none | powersgd (cross-pod axis; none here)
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


def init_train_state(params: Transformer, run: RunConfig) -> TrainState:
    """A fresh state at step 0 with zero moments; every parameter of
    ``params`` is set to require grad."""
    params.requires_grad_(True)
    named = dict(params.named_parameters())
    ef = None
    if run.grad_compression == "powersgd":
        # the reference's CompressorConfig.compressible: matrices of min_size or more
        ef = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in named.items()
              if p.dim() >= 2 and p.numel() >= run.powersgd_min_size}
    return TrainState(params=params, opt=adamw_init({n: p.detach() for n, p in named.items()}),
                      step=0, ef=ef)
