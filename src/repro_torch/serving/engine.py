"""Serving engine: monolithic prefill + GEAR-cached decode on one device.

Port of ``repro.serving.engine.Engine``'s dense path with ``EngineConfig``'s
defaults: ``fused="auto"`` (the ``gear_decode`` / ``flash_prefill`` kernels
on a card, their plain versions for CPU tensors), ``prefill_mode=
"monolithic"``, ``layout="dense"``, no prefix cache, no telemetry.  Other
values raise ``NotImplementedError`` naming the ROADMAP queue item that
brings them.

The cache tree is a list of per-layer caches that the engine updates in
place: ``decode``, ``prefill_slot`` and ``reset_slot`` return the same tree
they were given (the reference donates and rebuilds it).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core import cache as cache_lib
from repro_torch.core.policy import CompressionPolicy
from repro_torch.kernels import ops
from repro_torch.models.common import resolve_device
from repro_torch.models.model import Model
from repro_torch.models.transformer import cache_cfg_for
from repro_torch.serving.views import DenseCacheView

__all__ = ["EngineConfig", "Engine"]

_CHOICES = {
    "fused": ("auto", "interpret", "off"),
    "prefill_mode": ("monolithic", "streaming"),
    "layout": ("dense", "paged"),
}
_NOT_PORTED = {
    ("fused", "off"): "the portable attend path (ROADMAP queue item 3)",
    ("fused", "interpret"): "the Pallas interpret lane; CUDA has no interpret mode "
                            "(CPU tensors take the plain versions; ROADMAP queue item 3)",
    ("prefill_mode", "streaming"): "streaming prefill (ROADMAP queue item 6)",
    ("layout", "paged"): "the paged pool (ROADMAP queue item 8)",
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    batch: int
    capacity: int                  # max total tokens per sequence
    policy: CompressionPolicy
    temperature: float = 0.0
    top_k: int = 0
    eos_id: int = -1               # -1: never stop early
    fused: str = "auto"
    prefill_mode: str = "monolithic"
    prefix_cache: bool = False
    numeric_guard: bool = True
    layout: str = "dense"
    obs: Any = None

    def __post_init__(self):
        for knob, options in _CHOICES.items():
            value = str(getattr(self, knob))
            if value not in options:
                raise ValueError(f"{knob} must be {'/'.join(options)}, got {value!r}")
            if (knob, value) in _NOT_PORTED:
                raise NotImplementedError(f"{knob}={value!r}: {_NOT_PORTED[knob, value]}")
            object.__setattr__(self, knob, value)
        if self.prefix_cache:
            raise NotImplementedError("prefix_cache: the prefix trie (ROADMAP queue item 7)")
        if self.obs:
            raise NotImplementedError("obs: serving telemetry (ROADMAP queue item 9)")


class Engine:
    def __init__(self, model: Model, params, ecfg: EngineConfig, device=None):
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"weights live on {params.device}, engine device is {self.device}")
        self.model = model
        self.cfg = model.cfg
        self.ecfg = ecfg
        self.params = params
        self._ccfg = cache_cfg_for(self.cfg, ecfg.policy, ecfg.batch, self._cap())
        if not ops.fused_supported(self._ccfg):
            raise NotImplementedError(
                f"policy {ecfg.policy} needs the portable attend path "
                "(ROADMAP queue item 3)")

    def _cap(self) -> int:
        nb = self.ecfg.policy.buffer_size
        return (self.ecfg.capacity + nb - 1) // nb * nb

    @property
    def attend_path(self) -> str:
        return "fused"

    def _guard_one(self, one: list) -> list:
        """Numeric guard on one request's batch-1 cache before it is spliced
        into the shared tree: raises :class:`NumericFault` on NaN/Inf, with
        the shared tree untouched."""
        if self.ecfg.numeric_guard and not bool(cache_lib.tree_finite(one)):
            raise cache_lib.NumericFault(
                "prefill produced NaN/Inf in a compressed chunk; shared cache state untouched")
        return one

    # ------------------------------------------------------------------
    def _cold_prefill(self, batch1: dict):
        """Batch-1 monolithic prefill at the prompt's raw length."""
        return self.model.prefill(self.params, batch1, self.ecfg.policy, self._cap())

    def decode(self, token_batch: dict, caches: list, pos):
        """One decode step over all slots (``pos``: scalar or per-slot [B])."""
        return self.model.decode_step(self.params, token_batch, caches, pos,
                                      self.ecfg.policy, self._cap())

    def prefill_slot(self, batch1: dict, caches: list, slot: int):
        """Prefill ONE request (batch-1, raw prompt) and splice it into
        ``slot`` of ``caches`` (in place).  Returns (logits [1, 1, V], caches).
        The batch-1 prefill is what a solo run computes, so the request
        decodes as it would alone."""
        logits, one = self._cold_prefill(batch1)
        one = self._guard_one(one)
        for full, one_layer in zip(caches, one):
            cache_lib.splice_slot(full, one_layer, slot)
        return logits, caches

    def reset_slot(self, caches: list, slot: int) -> list:
        for layer in caches:
            cache_lib.reset_slot(layer, slot)
        return caches

    def init_caches(self) -> list:
        return self.model.init_caches(self.ecfg.policy, self.ecfg.batch, self._cap(),
                                      self.device)

    def new_view(self) -> DenseCacheView:
        return DenseCacheView(self, self.init_caches())
