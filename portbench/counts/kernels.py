"""Least bytes and operations of the port's kernels, from shapes and policy.

Frozen copies of ``chip_smoke.py``'s ``decode_bytes_flops`` /
``chunk_bytes`` and ``flash_bytes_flops``, rewritten to count from the
call's shapes and the compression policy instead of from the operand
tensors a kernel is handed: every input byte is counted read once and
every output byte written once, whatever a kernel reads again.  A kernel's
least time is the larger of its bytes over HBM bandwidth and its operations
over the rate of the units it runs on.
"""

from __future__ import annotations

import math

from portbench.counts import peaks


def outlier_count(vec_len: int, sparsity: float) -> int:
    """Entries kept per extreme of a vector of ``vec_len`` (GEAR's Filter_s)."""
    return max(1, math.ceil(vec_len * sparsity / 2.0))


def gear_chunk_bytes(policy: dict, head_dim: int) -> int:
    """Bytes of one (batch row, KV head, chunk)'s compressed history as the
    cache stores it: packed K and V codes, per-token V stats and per-chunk K
    stats (2 bytes each), the low-rank factors (bf16, ``rank`` columns), and
    the outliers (bf16 values, int32 indices)."""
    nb, dh, bits = policy["chunk"], head_dim, policy["bits"]
    k_group = policy["k_group"] or nb            # tokens per K stat row
    v_group = policy["v_group"] or dh            # channels per V stat
    per_token = 2 * dh * bits // 8 + 2 * 2 * (dh // v_group)
    per_chunk = 2 * 2 * (nb // k_group) * dh
    r = policy["rank"]
    if policy["lowrank"]:
        per_token += 2 * r * 2                   # k_a, v_a
        per_chunk += 2 * dh * r * 2              # k_b, v_b
    if policy["sparse"]:
        kv = outlier_count(dh, policy["sparsity"])
        ks = outlier_count(nb, policy["sparsity"])
        per_token += 2 * kv * (2 + 4)
        per_chunk += dh * 2 * ks * (2 + 4)
    return nb * per_token + per_chunk


def gear_decode_bytes_flops(policy: dict, rows: int, q_rows: int, head_dim: int,
                            n_comp: int) -> tuple[float, float]:
    """One ``gear_decode`` launch over ``rows`` (batch x KV head) rows of
    ``q_rows`` query heads each, every row with ``n_comp`` compressed tokens:
    q (f32) and the extents read, (acc, m, l) written (f32), each live
    chunk's compressed fields read once; the operations dequantise each
    chunk once and score and weight it for every query row."""
    nb, dh = policy["chunk"], head_dim
    r = policy["rank"] if policy["lowrank"] else 0
    live = rows * -(-n_comp // nb)
    nbytes = (live * gear_chunk_bytes(policy, dh) + rows * q_rows * dh * 4 + rows * 4
              + rows * q_rows * (dh + 2) * 4)
    flops = live * (4 * nb * dh + q_rows * (4 * nb * dh + 4 * dh * r + 4 * nb * r))
    return float(nbytes), float(flops)


def gear_decode_least_s(policy: dict, rows: int, q_rows: int, head_dim: int,
                        n_comp: int) -> float:
    """Least time of that launch: its bytes at HBM bandwidth or its
    operations at the f32 rate (the kernel dequantises on the CUDA cores)."""
    nbytes, flops = gear_decode_bytes_flops(policy, rows, q_rows, head_dim, n_comp)
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.F32_FLOPS)


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal mask keeps over ``s`` positions."""
    return s * (s + 1) // 2


def flash_prefill_bytes_flops(s: int, q_rows: int, kv_repeat: int,
                              head_dim: int) -> tuple[float, float]:
    """One causal ``flash_prefill`` launch over ``q_rows`` (batch x query
    head) rows of ``s`` positions: q, k, v read once and o written once in
    bf16; 4 operations per kept pair and channel (QK and PV)."""
    nbytes = 2.0 * head_dim * s * (2 * q_rows + 2 * q_rows // kv_repeat)
    flops = 4.0 * causal_pairs(s) * head_dim * q_rows
    return nbytes, flops


def flash_prefill_least_s(s: int, q_rows: int, kv_repeat: int, head_dim: int) -> float:
    """Least time of that launch at the bf16 tensor-core rate or HBM bandwidth."""
    nbytes, flops = flash_prefill_bytes_flops(s, q_rows, kv_repeat, head_dim)
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.BF16_FLOPS)
