"""Three-term roofline of a step on H100 SXM cards (port of
``repro.perf.roofline``; the formulas and the API are the reference's).

    compute    = flops / (chips · 989e12)            [dense bf16 peak / card]
    memory     = bytes / (chips · 3.35e12)           [HBM3 bandwidth / card]
    collective = coll_operand_bytes / (chips · 450e9)  [NVLink, one direction]

The dominant term is the bottleneck; the roofline fraction of the compute
term is the useful compute time over the largest term.  ``model_flops`` is
6·N·D for training, 2·N·D for prefill and 2·N_active per decoded token plus
the attention reads, with N from the analytic parameter count
(:meth:`~repro_torch.configs.base.ModelConfig.active_param_count`).
The reference's first two arguments are XLA's HLO counts; here a caller
passes its own count of the operations and bytes a step executes.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["HW", "RooflineTerms", "roofline", "model_flops"]

HW = {
    # dense bf16 tensor-core FLOP/s of one H100 SXM (NVIDIA H100 data sheet;
    # 1,979e12 is the 2:4-sparse figure)
    "peak_flops": 989e12,
    # HBM3 bytes/s of one H100 SXM (NVIDIA H100 data sheet)
    "hbm_bw": 3.35e12,
    # NVLink 4 bytes/s each way of one H100 SXM (900 GB/s both ways, NVIDIA
    # data sheet).  The reference's key names the TPU's inter-chip link; here
    # it is the card's link to the others of its host, which a collective
    # over the host's cards crosses
    "ici_bw": 450e9,
}


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower-bound step time (no overlap assumption = max of terms)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def compute_fraction(self) -> float:
        """Fraction of roofline: useful compute time / bound step time."""
        useful = self.model_flops / (self.chips * HW["peak_flops"])
        return useful / max(self.step_time_s, 1e-30)

    @property
    def flops_efficiency(self) -> float:
        """model_flops / executed FLOPs: how much of the executed compute is useful."""
        return self.model_flops / max(self.hlo_flops, 1e-30)

    def row(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bottleneck": self.bottleneck,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "flops_eff": self.flops_efficiency,
            "roofline_frac": self.compute_fraction,
        }


def roofline(hlo_flops: float, hlo_bytes: float, collective_bytes: float,
             chips: int, model_flops_total: float) -> RooflineTerms:
    return RooflineTerms(
        compute_s=hlo_flops / (chips * HW["peak_flops"]),
        memory_s=hlo_bytes / (chips * HW["hbm_bw"]),
        collective_s=collective_bytes / (chips * HW["ici_bw"]),
        chips=chips,
        hlo_flops=hlo_flops,
        hlo_bytes=hlo_bytes,
        collective_bytes=collective_bytes,
        model_flops=model_flops_total,
    )


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic useful FLOPs for one step of this cell."""
    n_active = cfg.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence + attention reads over each layer's
    # effective context (full cache for global layers, window for locals,
    # zero for attention-free recurrent archs).
    if cfg.rwkv:
        kv_read = 0.0
    else:
        per_unit = 0.0
        for kind in cfg.layer_pattern:
            ctx = min(shape.seq_len, cfg.local_window) if kind == "local" else shape.seq_len
            per_unit += 2.0 * cfg.kv_dim * ctx * 2  # QKᵀ + PV, 2 flops/MAC
        kv_read = per_unit * cfg.pattern_repeats
    return (2.0 * n_active + kv_read) * shape.global_batch
