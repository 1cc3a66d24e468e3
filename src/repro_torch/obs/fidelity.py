"""Online compression-fidelity probes (port of ``repro.obs.fidelity``).

The engine calls :meth:`FidelityProbe.maybe_probe` right after each
prefill's numeric guard, on the guarded batch-1 cache tree and before the
splice, so a probe can never change serving state: it reads the tree and
writes nothing into it (probes on equal probes off, bit for bit, in logits
and caches).

Per sampled request:

1. **Shadow reference.** The streaming prefill never keeps the raw K/V, so
   the probe reruns the prompt through the port's monolithic prefill of the
   same model and weights under the :data:`~repro_torch.core.policy.FP16`
   policy at the engine's capacity (``ref_prefill``, built by the engine).
   Its FP16 cache holds exactly the uncompressed K/V, position for position
   with the compressed tree.
2. **Reconstruction compare.** Per GEAR layer,
   :func:`repro_torch.core.cache.dense_kv` of the compressed cache against
   the shadow's K/V over the closed region (``tok < (length // n_b) * n_b``;
   the buffer tail is stored FP16 and exact): the relative Frobenius error
   of K̂ and V̂, the low-rank share and the outlier mass of the
   reconstruction (:mod:`repro_torch.core.metrics`), and the max-abs
   last-position logit drift against the shadow.
3. **Budget throttle.** A probe costs a full FP16 prefill, so once probes
   have spent more than ``budget_frac`` of the real time since the probe
   was created, sampling is skipped (``fidelity_probe_skipped_total``);
   the first due probe always runs.  The throttle reads
   ``time.perf_counter``, not the serving clock, because it compares real
   costs.

Sampling is every Nth closed chunk: a running count of closed chunks that
crosses a multiple of ``every_n`` triggers a probe.  A probe that raises
increments ``fidelity_probe_errors_total`` and is swallowed, as in the
reference: telemetry never takes serving down.

A hybrid layer's cache is the pair (attention cache, SSM state); the port
probes its attention cache.  (The reference's compare reads the pair as one
cache and counts a probe error there.)
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from repro_torch.core import cache as cache_lib
from repro_torch.core.metrics import masked_rel_frobenius, masked_share

__all__ = ["FidelityProbe"]


class FidelityProbe:
    """See the module docstring.

    ref_prefill: callable(batch1 dict) -> (logits, caches), the FP16
        monolithic prefill of the engine's model and weights.
    cache_cfgs: one batch-1 ``CacheConfig`` per layer (``None`` for a
        layer without one, e.g. RWKV6); only ``kind == "gear"`` layers are
        probed.
    registry: the obs :class:`~repro_torch.obs.registry.Registry`.
    every_n: probe each time the running closed-chunk count crosses a
        multiple of this (0 disables).
    budget_frac: ceiling on the probes' share of real elapsed time.
    """

    def __init__(self, ref_prefill, cache_cfgs, policy, registry, every_n: int,
                 budget_frac: float = 0.05, max_reports: int = 256):
        self._ref_prefill = ref_prefill
        self._ccfgs = list(cache_cfgs)
        self._pol = policy
        self._reg = registry
        self.every_n = int(every_n)
        self.budget_frac = float(budget_frac)
        self._gear_layers = [i for i, c in enumerate(self._ccfgs)
                             if c is not None and c.kind == "gear"]
        self._chunks_seen = 0
        self._spent_s = 0.0
        self._born = time.perf_counter()
        self.reports: collections.deque = collections.deque(maxlen=max_reports)

    # -- sampling ----------------------------------------------------------
    def _due(self, n_closed: int) -> bool:
        if self.every_n <= 0 or n_closed <= 0 or not self._gear_layers:
            return False
        before = self._chunks_seen // self.every_n
        self._chunks_seen += n_closed
        return self._chunks_seen // self.every_n > before

    def _within_budget(self) -> bool:
        if self._spent_s == 0.0:
            return True                  # the first probe always runs
        elapsed = time.perf_counter() - self._born
        return self._spent_s <= self.budget_frac * max(elapsed, 1e-9)

    # -- the probe ---------------------------------------------------------
    def maybe_probe(self, batch1: dict, logits, one) -> dict | None:
        """Sample and measure; returns the report when a probe ran, else
        None.  Reads its arguments only."""
        try:
            n_tok = int(np.asarray(batch1["tokens"]).shape[-1])
            n_closed = n_tok // self._pol.buffer_size
            if not self._due(n_closed):
                return None
            if not self._within_budget():
                self._reg.get("fidelity_probe_skipped_total").inc()
                return None
            t0 = time.perf_counter()
            report = self._probe(batch1, logits, one, n_tok, n_closed)
            dt = time.perf_counter() - t0
            self._spent_s += dt
            self._reg.get("fidelity_probe_seconds").observe(dt)
            self._reg.get("fidelity_probes_total").inc()
            self.reports.append(report)
            return report
        except Exception:
            try:
                self._reg.get("fidelity_probe_errors_total").inc()
            except Exception:
                pass
            return None

    @torch.inference_mode()
    def _probe(self, batch1, logits, one, n_tok, n_closed) -> dict:
        ref_logits, ref_caches = self._ref_prefill(batch1)
        drift = float((logits.float().reshape(-1) - ref_logits.float().reshape(-1))
                      .abs().max())
        self._reg.get("fidelity_logits_drift").observe(drift)
        layers = []
        for i in self._gear_layers:
            row = {"layer": i, **self._compare(self._ccfgs[i], cache_lib._parts(one[i])[0],
                                               cache_lib._parts(ref_caches[i])[0])}
            layers.append(row)
            lab = str(i)
            self._reg.get("fidelity_sampled_chunks_total").inc(n_closed, layer=lab)
            for field in ("k", "v"):
                self._reg.get("fidelity_rel_err").observe(row[f"{field}_rel_err"],
                                                          field=field, layer=lab)
                if f"{field}_lowrank_share" in row:
                    self._reg.get("fidelity_lowrank_share").observe(
                        row[f"{field}_lowrank_share"], field=field, layer=lab)
                if f"{field}_outlier_mass" in row:
                    self._reg.get("fidelity_outlier_mass").observe(
                        row[f"{field}_outlier_mass"], field=field, layer=lab)
        return {"prompt_tokens": n_tok, "closed_chunks": n_closed,
                "logits_drift": drift, "layers": layers}

    def _compare(self, ccfg, lyr, ref) -> dict:
        """One layer's statistics over the closed region of the batch-1
        compressed cache ``lyr`` against the FP16 shadow cache ``ref``."""
        pol = self._pol
        nb = ccfg.chunk
        n_comp = (lyr.length.long() // nb) * nb                       # [1]
        tok = torch.arange(ccfg.capacity, device=n_comp.device)
        mask = (tok[None, :] < n_comp[:, None])[:, None, :, None]
        k_hat, v_hat = cache_lib.dense_kv(ccfg, lyr)
        k_ref, v_ref = ref.k.to(torch.float32), ref.v.to(torch.float32)
        out = {"k_rel_err": masked_rel_frobenius(k_hat, k_ref, mask),
               "v_rel_err": masked_rel_frobenius(v_hat, v_ref, mask)}
        if pol.use_lowrank:
            out["k_lowrank_share"] = masked_share(
                cache_lib._lowrank_dense(ccfg, lyr.k_a, lyr.k_b), k_hat, mask)
            out["v_lowrank_share"] = masked_share(
                cache_lib._lowrank_dense(ccfg, lyr.v_a, lyr.v_b), v_hat, mask)
        if pol.use_sparse:
            out["k_outlier_mass"] = masked_share(
                cache_lib._sparse_dense(ccfg, lyr.k_sp_val, lyr.k_sp_idx, "k"), k_hat, mask)
            out["v_outlier_mass"] = masked_share(
                cache_lib._sparse_dense(ccfg, lyr.v_sp_val, lyr.v_sp_idx, "v"), v_hat, mask)
        return {key: float(val) for key, val in out.items()}
