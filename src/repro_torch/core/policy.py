"""Compression policy configuration for the GEAR framework."""

from __future__ import annotations

import dataclasses

__all__ = ["CompressionPolicy", "FP16", "GEAR_DEFAULT", "named_policy"]


@dataclasses.dataclass(frozen=True)
class CompressionPolicy:
    """Everything that defines how a KV cache is compressed.

    method:
      "fp16"          — no compression (baseline)
      "quant"         — backbone quantization only
      "outlier_quant" — quantization + sparse outliers (Table 8 baseline)
      "gear_l"        — quantization + low-rank residual (GEAR-L)
      "gear"          — quantization + low-rank + sparse (full GEAR)
    backbone:
      "kcvt"            — per-channel K / per-token V, coarse per-vector groups
      "kivi"            — per-channel K / per-token V, fine groups of ``group``
      "per_token_group" — FlexGen-style per-token grouping for both K and V
    """

    method: str = "gear"
    backbone: str = "kcvt"
    bits: int = 4
    group: int = 64          # fine-grained group size (kivi / per_token_group)
    rank: int = 4            # r_p: prefill rank
    rank_decode: int = 2     # r_g: per-decode-chunk rank
    sparsity: float = 0.02   # s
    power_iters: int = 4
    buffer_size: int = 64    # n_b streaming buffer / chunk size
    stat_dtype: str = "bfloat16"  # scale/zero storage dtype

    def __post_init__(self):
        if self.method not in ("fp16", "quant", "outlier_quant", "gear_l", "gear"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.backbone not in ("kcvt", "kivi", "per_token_group"):
            raise ValueError(f"unknown backbone {self.backbone!r}")
        if self.bits not in (2, 4, 8):
            raise ValueError(f"bits must be 2/4/8, got {self.bits}")
        if self.backbone in ("kivi", "per_token_group") and self.buffer_size % self.group:
            raise ValueError("buffer_size must be a multiple of group for fine-grained backbones")

    @property
    def use_lowrank(self) -> bool:
        return self.method in ("gear_l", "gear")

    @property
    def use_sparse(self) -> bool:
        return self.method in ("outlier_quant", "gear")

    @property
    def is_fp16(self) -> bool:
        return self.method == "fp16"

    def scheme_for(self, kind: str) -> tuple[str, int | None]:
        """(quant scheme, group) for tensor kind 'k' or 'v'."""
        if self.backbone == "per_token_group":
            return "per_token_group", self.group
        if kind == "k":
            return "per_channel", None if self.backbone == "kcvt" else self.group
        if kind == "v":
            return "per_token", None if self.backbone == "kcvt" else self.group
        raise ValueError(f"kind must be 'k' or 'v', got {kind!r}")


FP16 = CompressionPolicy(method="fp16")
# The paper's recommended settings: KCVT backbone at 4-bit, KIVI at 2-bit.
GEAR_DEFAULT = CompressionPolicy(method="gear", backbone="kcvt", bits=4)


def named_policy(name: str) -> CompressionPolicy:
    """Policies used throughout the paper's tables."""
    table = {
        "fp16": FP16,
        "per_token_q4": CompressionPolicy("quant", "per_token_group", bits=4),
        "per_token_q2": CompressionPolicy("quant", "per_token_group", bits=2),
        "kcvt4": CompressionPolicy("quant", "kcvt", bits=4),
        "kivi4": CompressionPolicy("quant", "kivi", bits=4),
        "kivi2": CompressionPolicy("quant", "kivi", bits=2),
        "outlier_kivi2": CompressionPolicy("outlier_quant", "kivi", bits=2),
        "gear_l_kcvt4": CompressionPolicy("gear_l", "kcvt", bits=4),
        "gear_kcvt4": CompressionPolicy("gear", "kcvt", bits=4),
        "gear_l_kivi2": CompressionPolicy("gear_l", "kivi", bits=2),
        "gear_kivi2": CompressionPolicy("gear", "kivi", bits=2),
    }
    if name not in table:
        raise KeyError(f"unknown policy {name!r}; options: {sorted(table)}")
    return table[name]
