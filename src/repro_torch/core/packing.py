"""Bit-packing of low-precision integer codes into int32 carrier lanes.

Same layout as ``repro.core.packing``: the **last axis** is packed; for
bit-width ``b`` and ``per = 32 // b``, code ``x[..., lane * per + j]`` lives
in bits ``[j*b, (j+1)*b)`` of ``packed[..., lane]``.

The reference packs through uint32.  Torch has no uint32 arithmetic, so the
words are built in int64 and wrapped into int32 two's complement, which makes
them bit-equal to the reference's; unpacking masks the word to 32 bits first,
because an int32 ``>>`` sign-extends.
"""

from __future__ import annotations

import torch

__all__ = ["codes_per_lane", "packed_width", "pack", "unpack"]


def codes_per_lane(bits: int) -> int:
    if bits not in (2, 4, 8):
        raise ValueError(f"unsupported bit-width {bits}; expected 2, 4 or 8")
    return 32 // bits


def packed_width(d: int, bits: int) -> int:
    per = codes_per_lane(bits)
    if d % per != 0:
        raise ValueError(f"last axis {d} not divisible by {per} ({bits}-bit)")
    return d // per


def _shifts(per: int, bits: int, device) -> torch.Tensor:
    return torch.arange(per, dtype=torch.int64, device=device) * bits


def pack(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack unsigned codes in [0, 2**bits) along the last axis.

    codes: integer tensor [..., D]  ->  int32 tensor [..., D // (32//bits)].
    """
    per = codes_per_lane(bits)
    lanes = packed_width(codes.shape[-1], bits)
    x = codes.to(torch.int64) & ((1 << bits) - 1)
    x = x.reshape(codes.shape[:-1] + (lanes, per))
    words = (x << _shifts(per, bits, codes.device)).sum(dim=-1)   # in [0, 2**32)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack(packed: torch.Tensor, bits: int, d: int | None = None) -> torch.Tensor:
    """Inverse of :func:`pack`.  Returns int32 codes [..., D]."""
    per = codes_per_lane(bits)
    lanes = packed.shape[-1]
    d_out = lanes * per if d is None else d
    x = packed.to(torch.int64) & 0xFFFFFFFF
    codes = (x.unsqueeze(-1) >> _shifts(per, bits, packed.device)) & ((1 << bits) - 1)
    codes = codes.reshape(packed.shape[:-1] + (lanes * per,))
    return codes[..., :d_out].to(torch.int32)
