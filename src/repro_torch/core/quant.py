"""Uniform asymmetric quantization backbones for KV caches.

Port of ``repro.core.quant``.  Tensors are laid out ``[..., n, d]`` (n =
tokens, d = channels) under three schemes:

* ``per_token_group`` — each token row split into groups of ``g`` channels;
* ``per_channel``     — K orientation: groups of ``g`` tokens per channel
  (``g = n`` is the coarse KCVT grouping, ``g = 64`` KIVI);
* ``per_token``       — V orientation: groups of ``g`` channels per token.

Order matters for parity with the reference: codes come from the **f32**
scale, and only then are scale and zero rounded to ``stat_dtype``;
dequantization uses the rounded stats.  ``torch.round`` rounds half to even,
as ``jnp.round`` does.  The scale is ``(max - min) * f32(1 / (2**b - 1))``,
the form XLA compiles the reference's division into, so codes match the
reference's jitted programs bit for bit.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import packing

__all__ = ["QuantizedTensor", "quantize", "dequantize", "quant_error", "SCHEMES", "as_dtype"]

SCHEMES = ("per_token_group", "per_channel", "per_token")

_EPS = 1e-8


def as_dtype(dtype) -> torch.dtype:
    """``torch.dtype`` from a dtype or its name (``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """Packed codes [..., n, d // (32/bits)] plus per-group scale and zero."""

    packed: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int
    scheme: str
    group: int
    n: int
    d: int

    @property
    def nbytes_packed(self) -> int:
        return self.packed.numel() * 4

    def size_bytes(self) -> int:
        """Compressed bytes as the reference counts them: int32 codes, and 2
        bytes for each scale and zero (whatever ``stat_dtype`` holds them)."""
        return self.nbytes_packed + self.scale.numel() * 2 + self.zero.numel() * 2


def _group_minmax(x: torch.Tensor, scheme: str, group: int):
    """(min, max) broadcast back to x's shape for the given scheme."""
    n, d = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    if scheme in ("per_token_group", "per_token"):
        if d % group != 0:
            raise ValueError(f"d={d} not divisible by group={group}")
        xg = x.reshape(lead + (n, d // group, group))
        mn = xg.amin(dim=-1, keepdim=True).expand(xg.shape).reshape(x.shape)
        mx = xg.amax(dim=-1, keepdim=True).expand(xg.shape).reshape(x.shape)
        return mn, mx
    if scheme == "per_channel":
        if n % group != 0:
            raise ValueError(f"n={n} not divisible by group={group}")
        xg = x.reshape(lead + (n // group, group, d))
        mn = xg.amin(dim=-2, keepdim=True).expand(xg.shape).reshape(x.shape)
        mx = xg.amax(dim=-2, keepdim=True).expand(xg.shape).reshape(x.shape)
        return mn, mx
    raise ValueError(f"unknown scheme {scheme!r}; expected one of {SCHEMES}")


def _compact_groups(full: torch.Tensor, scheme: str, group: int) -> torch.Tensor:
    """Collapse a broadcast per-entry stat down to one value per group."""
    n, d = full.shape[-2], full.shape[-1]
    lead = full.shape[:-2]
    if scheme in ("per_token_group", "per_token"):
        return full.reshape(lead + (n, d // group, group))[..., 0]
    return full.reshape(lead + (n // group, group, d))[..., 0, :]


def _expand_groups(compact: torch.Tensor, scheme: str, group: int, n: int, d: int) -> torch.Tensor:
    lead = compact.shape[:-2]
    if scheme in ("per_token_group", "per_token"):
        return compact.repeat_interleave(group, dim=-1).reshape(lead + (n, d))
    return compact.repeat_interleave(group, dim=-2).reshape(lead + (n, d))


def quantize(x: torch.Tensor, bits: int, scheme: str, group: int | None = None,
             stat_dtype=torch.float32) -> QuantizedTensor:
    """Quantize ``x`` [..., n, d]; ``group=None`` is the coarse per-vector
    grouping (whole channel column for ``per_channel``, whole token row
    otherwise)."""
    n, d = x.shape[-2], x.shape[-1]
    if group is None:
        group = n if scheme == "per_channel" else d
    xf = x.to(torch.float32)
    mn_full, mx_full = _group_minmax(xf, scheme, group)
    # XLA rewrites the reference's ``/ (2**bits - 1)`` into a multiply by the
    # f32 reciprocal; doing the same keeps codes bit-equal to its jitted path
    scale_full = torch.clamp_min((mx_full - mn_full) * (1.0 / (2**bits - 1)), _EPS)
    codes = torch.clamp(torch.round((xf - mn_full) / scale_full), 0, 2**bits - 1).to(torch.int32)
    sd = as_dtype(stat_dtype)
    return QuantizedTensor(
        packed=packing.pack(codes, bits),
        scale=_compact_groups(scale_full, scheme, group).to(sd),
        zero=_compact_groups(mn_full, scheme, group).to(sd),
        bits=bits, scheme=scheme, group=group, n=n, d=d,
    )


def dequantize(qt: QuantizedTensor, dtype=torch.float32) -> torch.Tensor:
    codes = packing.unpack(qt.packed, qt.bits, qt.d).to(torch.float32)
    scale = _expand_groups(qt.scale.to(torch.float32), qt.scheme, qt.group, qt.n, qt.d)
    zero = _expand_groups(qt.zero.to(torch.float32), qt.scheme, qt.group, qt.n, qt.d)
    return (codes * scale + zero).to(dtype)


def quant_error(x: torch.Tensor, bits: int, scheme: str, group: int | None = None) -> torch.Tensor:
    """Relative Frobenius error of plain quantization, a 0-d tensor on
    ``x``'s device (the reference's ``_EPS`` floor on the norm)."""
    xh = dequantize(quantize(x, bits, scheme, group))
    return torch.linalg.vector_norm(x - xh) / torch.clamp_min(torch.linalg.vector_norm(x), _EPS)
