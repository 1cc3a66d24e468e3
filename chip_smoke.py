#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N] [--parent-scan OLD/linear_scan.cu]
                          [--parent-kernels OLD_CSRC_DIR]

Phases, each of which fails the run (non-zero exit) on any error:

1. environment: torch / CUDA versions and the card's name and power limit;
2. build: ``nvcc`` compiles every ``src/repro_torch/kernels/csrc/*.cu``, one
   process per source, in parallel;
3. ``gear_decode`` against its plain PyTorch version at the main path's
   shapes (4 slots, 32 kv heads, head_dim 128, capacity 1152) for
   gear_kcvt4 and gear_kivi2, with ragged extents and a constant
   channel / token whose outlier index is stored twice; again at hymba's
   shape (5 kv heads with G = 5 query rows each, head_dim 64); then at the
   streaming history scorer's shape (G * T = 64 query rows per row of a
   batch-1 cache, one shared extent: the kernel's tensor-core regime); then
   ``gear_decode_history`` over request 0's 14 in-flight blocks in one
   launch (its layer-0 history work), against its plain version and, bit
   for bit, the 14 per-block calls, timed (``ms_history_per_layer_synthetic``);
4. ``flash_prefill`` against its plain version (S = 1024, a ragged S = 1000,
   kv_repeat = 4, window + softcap, a bidirectional prefix, and hymba's
   25 query heads over 5 kv heads at head_dim 64), with
   ``torch.nn.functional.scaled_dot_product_attention`` timed beside it;
5. ``gear_compress`` against its plain version, bit for bit (packed codes,
   stats, outlier values and indices, residual; two calls bitwise equal),
   for both policies, K and V orientation, over the B * H * C' = 448
   [64, 128] tiles a 900-token prompt closes per layer, each timed (for
   gear_kcvt4's K, also without outliers and beside a device copy of x);
6. ``flash_prefill_block`` against its plain version (two calls bitwise
   equal): 448 row-groups of T = 64 (kv_len = 64), kv_repeat 4, and a
   ragged tail (T = 37, random kv_len), each timed; at T = 64 beside
   ``torch.ops.aten._scaled_dot_product_efficient_attention`` with the
   causal and kv_len mask as an additive bias (its (out, lse) held against
   (acc / l, m + log l) first), a yardstick the port never calls, and
   on one full wave of row groups (3 per SM) and on one row group alone;
   with ``--parent-kernels``, a parent tree's ``flash_prefill_block.cu``,
   ``gear_compress.cu`` and ``quant_pack.cu`` are built too and timed in
   turns p1, c1, c2, p2 here, in phases 5 and 9 and at phase 11's live
   calls;
7. ``gear_decode_paged`` against its plain version, and bit for bit against
   ``gear_decode`` on the gathered operands, over a shuffled pool of the
   main path's shapes whose tables name the zero page past each extent;
8. ``linear_scan_chunked`` against its plain version (y and final state):
   hymba's SSM heads (25 rows, Dk 16, Dv 64, one decay per head) at an
   aligned S = 1024 in chunks of 64, at the live S = chunk = 859, per-Dk
   decay at S = chunk = 200, and the ``bonus`` mode at RWKV6-3b's head
   shape (Dk = Dv = 64, per-Dk decay): 40 rows in chunks of 64, the live
   prefill's S = chunk = 859, and the decode step's S = chunk = 1 over 160
   rows (4 slots x 40 heads) from a non-zero initial state (the step
   regime; the others run the chunked regime's three launches); each case
   held globally and per row, two calls bit for bit, timed beside its f32
   bound and, where products run on the tensor cores, its TF32 bound, with
   the CUDA kernels one call launches (with ``--parent-scan``, an older
   ``linear_scan.cu`` is built too and timed in turns p1, c1, c2, p2 here
   and at the live scans of phases 13 and 15);
9. ``quant_pack`` through its entry point ``repro_torch.kernels.quantize_chunk``
   on the 448 [64, 128] tiles of phase 5, at 2, 4 and 8 bits, f32 and bf16
   input: launches counted, packed codes, scale and zero bit for bit equal
   to the plain version, also on non-finite input (NaN, +-inf, an all-NaN
   tile; NaN compared as equal) and across two calls; timed at 448 [64,
   128] tiles (4 bits f32 and bf16, 2 and 8 bits f32) and 448 [64, 64]
   (hymba's head_dim) beside its byte bound, the profiler's kernel time, the
   plain version and ``torch.aminmax`` (a read-side yardstick); with
   ``--parent-kernels`` the parent's ``quant_pack.cu`` in turns too;
10. serving, path 1: llama2-7b at full width (``--layers`` of its 32 layers)
   with random bf16 weights from a seeded generator, gear_kcvt4,
   ``Engine(batch=4, capacity=1152)`` (monolithic prefill, dense layout) and
   ``Scheduler.run_continuous`` over 8 requests; the launch counters must
   show ``gear_decode`` and ``flash_prefill`` on the path, and the live
   layer-0 cache of one decode step is held against the plain version, and
   the timer's own check runs on it (CUDA events beside the profiler's
   kernel time); then ``torch.profiler`` windows over one prefill and 8 decode steps say
   where the time goes (tables under ``build/profile/``);
11. serving, path 2: the same requests through llama2-7b at all its 32
    layers with ``prefill_mode="streaming", layout="paged"`` and a pool of
    two thirds of the dense-equivalent pages, so that a decode step runs
    while a request waits for pages (``--layers`` does not cut it); the
    counters must show ``gear_compress``, ``flash_prefill_block``,
    ``gear_decode`` (exactly one history launch per prefill and layer,
    ``gear_decode_history``) and ``gear_decode_paged`` on the path, each
    kernel's live layer-0 call is held against its plain version and timed
    (``gear_compress``: the K and the V event of request 0's layer 0, bit
    for bit; ``flash_prefill_block`` also beside the efficient-attention
    yardstick; request 0's layer-0 history call as ``ms_history_per_layer``),
    and profiler windows cover one streaming prefill and 8 paged decode
    steps;
12. serving, path 5: the prefix trie, on phase 11's llama2-7b (all 32
    layers) with ``prefill_mode="streaming", layout="paged",
    prefix_cache=True`` (first, layer 0's row-wise products checked for
    rows that do not depend on the row count): 8 requests sharing one 512-token system prompt,
    each with its own user suffix of raw length 40-400 (numpy seed 0), over
    a pool of 32 allocatable pages, small enough that the trie's retained
    pages block the queue head on an idle engine; request 1 must hit all 8
    system-prompt chunks, ``reclaim_pages`` must free pages at least once,
    the pool check and the engine audit (with the trie's retained pages)
    must pass, request 1's warm prefill must launch ``gear_compress`` only
    for its suffix's closed chunks, one history launch and one
    ``flash_prefill_block`` launch per layer and no ``flash_prefill``, and
    the same requests on an engine without the trie must give the same
    greedy tokens, and for request 1 the same prefill logits and pool
    chunks bit for bit; request 1's layer-0 history call (extents from 512)
    and ``flash_prefill_block`` call are held against their plain versions
    and timed, cold and warm prefill times are printed, and a profiler
    window covers one warm prefill;
13. serving, path 3: hymba-1.5b (GEAR attention beside Mamba-2 SSM heads)
    at its 32 layers and published widths, random bf16 weights with the
    reference's SSM constants, the same 8 requests (ids from its vocab),
    monolithic prefill on the dense layout; the counters must show 32
    ``linear_scan_chunked`` and 32 ``flash_prefill`` launches per prefill
    and 32 ``gear_decode`` launches per step; the live layer-0 scan (S =
    chunk = 859) and decode step are held against their plain versions and
    timed, and profiler windows cover one unaligned prefill and 8 decode
    steps;
14. serving, path 6: the same hymba-1.5b with streaming prefill (unbucketed,
    as the reference serves a hybrid) on the dense layout, 16 new tokens per
    request (cut from 96 for time); every prefill must launch 32
    ``flash_prefill_block``, 32 history, 32 ``linear_scan_chunked`` and 64
    ``gear_compress`` kernels and no ``flash_prefill``, every decode step 32
    ``gear_decode``; the live layer-0 K and V ``gear_compress`` calls
    (head_dim 64 tiles, bit for bit), ``flash_prefill_block`` call
    (kv_repeat 5, head_dim 64) and history call (5 heads x 64 = 320 query
    rows) are held against their plain versions and timed, and profiler
    windows cover one prefill and 8 decode steps;
15. serving, path 4: rwkv6-3b (attention-free RWKV6, no KV cache) at its 32
    layers and published widths, random bf16 weights with the reference's
    constants, the same 8 requests (ids from its vocab), monolithic prefill
    on the dense layout; the counters must show exactly 32
    ``linear_scan_chunked`` launches per prefill and 32 per decode step (the
    step scans one token from each layer's state) and no attention kernel;
    the live layer-0 prefill scan (S = chunk = 859) and decode scan (S = 1,
    from the slots' states) are held against their plain versions and
    timed, and profiler windows cover one unaligned prefill and 8 decode
    steps;
16. serving, path 7: wave mode on phase 10's llama2-7b (``--layers`` cuts
    it too): ``Engine(batch=4, capacity=1152)`` dense and ``Scheduler.run``
    over the 8 requests in two waves, left-padded to 859 and 899 tokens,
    each prefilled at batch 4 (``flash_prefill`` at BHq = 128) and decoded
    in lockstep; every request must end ``OK`` with 96 in-vocab tokens, each
    wave prefill launch exactly 32 ``flash_prefill`` and each decode step 32
    ``gear_decode``; the live layer-0 ``flash_prefill`` call (BHq 128) is
    held against its plain version and timed beside SDPA, one live decode
    step's layer-0 cache against the plain version, and each wave row's
    last-position prefill logits against a batch-1 prefill of the same
    left-padded prompt, bit for bit; a profiler window covers one wave
    prefill;
17. serving, path 8: path 5's engine and traffic (all 32 layers) with
    ``obs=ObsConfig()`` and a seeded ``FaultInjector`` on a ``FakeClock``
    whose schedule fires ``pool_exhausted``, ``prefill_error``,
    ``nan_chunk``, ``decode_error`` and ``trie_evict`` once each: exactly one
    result per rid and ``Scheduler.audit`` clean, the quarantined request
    ``FAILED``, every ``OK`` / ``DEGRADED`` request's greedy tokens bit for
    bit path 5's, one complete trace per rid, and the metrics counting each
    fired site;
18. the launcher: ``python -m repro_torch.launch.serve`` at full width as
    subprocesses, once in wave mode (batch 4, prompt 512, 16 tokens) and once
    in continuous + paged mode with ``--obs``, ``--metrics-json`` and
    ``--trace-out`` under ``build/serve/``; each must exit 0 and print the
    reference launcher's lines, and both JSON files must parse;
19. summary: one ``{"kernels": [...]}`` JSON line (each kernel's launches
    by path), the card's name and power limit, and the final
    ``{"ok": true, "device": {...}}`` line.

Kernel times come from ``time_ms``: the median over launches of CUDA
events around one launch with a cold L2, behind a device-side wait that
keeps the host's enqueue time out of the window (device time only).

It imports nothing of JAX and nothing of the JAX package.  Without a CUDA
device, or without the repository beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import dataclasses as dc
import gc
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import torch

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE / "src"

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor cores
F32_FLOPS = 67e12                # f32 outside the tensor cores
TF32_FLOPS = 495e12              # dense TF32 tensor cores

DEV = torch.device("cuda")

DECODE_TOL = 1e-3      # merged decode output, kernel vs plain (f32 both; sum order differs)
PREFILL_TOL = 3e-2     # bf16 output; the kernel rounds P to bf16 before P.V
BLOCK_TOL = 1e-4       # flash_prefill_block normalized output and score max (f32 both)
# gear_compress and quant_pack: bit for bit

B_SERVE, CAP_SERVE, N_REQUESTS, NEW_TOKENS = 4, 1152, 8, 96
# raw prompt lengths of the 8 requests (numpy seed 0), as requests() draws them
PROMPT_LENGTHS = [int(n) for n in np.random.RandomState(0).randint(300, 901, size=N_REQUESTS)]


PHASE_S = {}           # phase header -> seconds from the run's start when it began
_T0 = time.perf_counter()


def phase(header: str) -> None:
    """Print a phase header and note when the phase began."""
    PHASE_S[header.split("]")[0] + "]"] = time.perf_counter() - _T0
    print(header)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


WAIT_MS = 0.5          # least device-side wait ahead of each timed launch
_cycles_per_ms = None


def device_wait(ms: float) -> None:
    """Hold the current stream busy for ~``ms`` on the device
    (``torch.cuda._sleep``, calibrated once against CUDA events)."""
    global _cycles_per_ms
    if _cycles_per_ms is None:
        n = 1 << 20
        torch.cuda._sleep(n)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(n)
        end.record()
        torch.cuda.synchronize()
        _cycles_per_ms = n / start.elapsed_time(end)
    torch.cuda._sleep(int(ms * _cycles_per_ms))


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Device time of ``fn`` with a cold L2: the median of ``iters``
    launches, each timed on its own between CUDA events after a write of a
    buffer larger than L2.  A device-side wait after that write, sized to
    outlast the host's enqueue of the start event, ``fn`` and the end event
    (twice ``fn``'s measured host time, at least ``WAIT_MS``), keeps the
    stream busy until all three are queued, so the window holds device time
    only and no host time of the wrapper.  The median drops the rare launch
    whose enqueue the host stalled past the wait (such a window can only
    read long)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    wait = max(WAIT_MS, 2.0 * host_ms)
    times = []
    for _ in range(iters):
        flush.zero_()
        device_wait(wait)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_breakdown(fn, iters: int, flush: torch.Tensor) -> dict:
    """Device time per call of each CUDA kernel that ``fn`` launches, from a
    ``torch.profiler`` window of ``iters`` cold-L2 calls (the flush's fill
    kernels left out): {kernel name: ms}."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and "Fill" not in e.key:
            name = e.key.replace("(anonymous namespace)::", "").replace("void ", "").split("(")[0]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / iters / 1e3
    return out


def timer_check(fn, label: str, flush: torch.Tensor, report: dict) -> None:
    """The timer's own check, once per run: ``time_ms`` of one short call
    beside the kernel time a profiler window reports for it."""
    ev = time_ms(fn, 50, flush)
    kernels = kernel_breakdown(fn, 50, flush)
    prof = sum(kernels.values())
    print(f"  timer check, {label}: CUDA events {ev:.4f} ms, profiler kernel time "
          f"{prof:.4f} ms per call ({kernels})")
    report["timer_check"] = {"what": label, "events_ms": ev, "profiler_ms": prof}


def turns(tree_fn, parent_fn, iters: int, flush: torch.Tensor) -> dict:
    """``time_ms`` of this tree's kernel (c1, c2) and, where a parent tree's
    version is given, of that one (p1, p2), in turns p1, c1, c2, p2 on the
    same operands; c1 alone without a parent."""
    out = {}
    if parent_fn is not None:
        out["p1"] = time_ms(parent_fn, iters, flush)
    out["c1"] = time_ms(tree_fn, iters, flush)
    if parent_fn is not None:
        out["c2"] = time_ms(tree_fn, iters, flush)
        out["p2"] = time_ms(parent_fn, iters, flush)
    return out


def times_text(timed: dict) -> str:
    return ", ".join(f"{key} {val:.4f} ms" for key, val in timed.items())


# ---------------------------------------------------------------------------
# gear_decode


TOKEN_ROWS = ("k_packed", "v_packed", "v_scale", "v_zero", "k_a", "v_a", "v_sp_val", "v_sp_idx")
CHUNK_ROWS = ("k_scale", "k_zero", "k_b", "v_b", "k_sp_val", "k_sp_idx")


def chunk_bytes(operands: dict, chunk: int) -> int:
    """Bytes of one (row, chunk)'s compressed fields."""
    per_chunk = sum(operands[n][0, :chunk].numel() * operands[n].element_size()
                    for n in TOKEN_ROWS if operands.get(n) is not None)
    return per_chunk + sum(operands[n][0, 0].numel() * operands[n].element_size()
                           for n in CHUNK_ROWS if operands.get(n) is not None)


def decode_bytes_flops(operands: dict, n_comp: torch.Tensor, chunk: int):
    """Least bytes and f32 operations of one ``gear_decode`` call: q and
    n_comp read, (acc, m, l) written, and each live (row, chunk)'s
    compressed fields read once, counted from this call's extents."""
    q = operands["q"]
    BH, G, Dh = q.shape
    live = int(((n_comp.long() + chunk - 1) // chunk).clamp(min=0).sum())
    nbytes = (live * chunk_bytes(operands, chunk) + q.numel() * 4 + n_comp.numel() * 4
              + BH * G * (Dh + 2) * 4)
    r = operands["k_a"].shape[-1] if operands.get("k_a") is not None else 0
    flops = live * (4 * chunk * Dh + G * (4 * chunk * Dh + 4 * Dh * r + 4 * chunk * r))
    return nbytes, flops


def pol_half(idx: torch.Tensor) -> int:
    return idx.shape[-1] // 2


def decode_case(policy_name: str, flush, report: dict, H: int = 32, Dh: int = 128,
                G: int = 1) -> None:
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import gear_decode as gd
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_ref

    dev = DEV
    B, cap = 4, 1152
    pol = named_policy(policy_name)
    cfg = cache_lib.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=cap, policy=pol)
    gen = torch.Generator(device=dev).manual_seed(1)
    k = torch.randn(B, H, cap, Dh, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, H, cap, Dh, generator=gen, device=dev).to(torch.bfloat16)
    k[0, 0, :cfg.chunk, 5] = 3.0        # constant channel: top-k and bottom-k pick one index
    v[0, 0, 10, :] = 2.0                # constant token, likewise on the V side
    cache = cache_lib.prefill_layer_cache(
        cfg, cache_lib.init_layer_cache(cfg, torch.bfloat16, dev), k, v)
    # top-k fill the first half of the outlier slots, bottom-k the second
    dup_k = bool((cache.k_sp_idx[..., 0] == cache.k_sp_idx[..., pol_half(cache.k_sp_idx)]).any())
    dup_v = bool((cache.v_sp_idx[..., 0] == cache.v_sp_idx[..., pol_half(cache.v_sp_idx)]).any())
    if not (dup_k and dup_v):
        fail(f"{policy_name}: the constant-vector fixture stored no duplicate outlier index")
    cache.buf_k.copy_(torch.randn(cache.buf_k.shape, generator=gen, device=dev))
    cache.buf_v.copy_(torch.randn(cache.buf_v.shape, generator=gen, device=dev))
    # ragged slots: empty history, one chunk, mid-cache, full
    cache.length.copy_(torch.tensor([5, 67, 586, cap], dtype=torch.int32, device=dev))
    BH = B * H
    qf = torch.randn(BH, G, Dh, generator=gen, device=dev)
    len_bh = cache.length.repeat_interleave(H)
    n_comp = (len_bh // cfg.chunk * cfg.chunk).to(torch.int32)
    arrays, lr, sp = ops._gear_operands(cfg, cache, BH)
    kw = dict(bits=pol.bits, chunk=cfg.chunk, scale_factor=Dh ** -0.5, **lr, **sp)

    triple_k = gd.gear_decode(qf, *arrays, n_comp, **kw)
    triple_p = gear_decode_ref(qf, *arrays, n_comp, **kw)
    torch.cuda.synchronize()
    out_k = ops._merge_buffer(cfg, cache, qf, *triple_k, len_bh - n_comp, Dh ** -0.5)
    out_p = ops._merge_buffer(cfg, cache, qf, *triple_p, len_bh - n_comp, Dh ** -0.5)
    err = float((out_k - out_p).abs().max())
    print(f"  gear_decode {policy_name} H={H} G={G} Dh={Dh}: merged max_abs_err={err:.3e} "
          f"(tol {DECODE_TOL}) "
          f"n_comp per slot {[int(x) for x in n_comp[::H]]}, duplicate outlier index "
          f"K={dup_k} V={dup_v}")
    if not err <= DECODE_TOL:
        fail(f"gear_decode {policy_name} disagrees with its plain version: {err}")
    report["err"] = max(report.get("err", 0.0), err)


# ---------------------------------------------------------------------------
# flash_prefill


FLASH_CASES = [
    # (S, BHq, kv_repeat, window, prefix_len, softcap, head_dim)
    (1024, 32, 1, 0, 0, 0.0, 128),
    (1000, 32, 1, 0, 0, 0.0, 128),
    (1000, 32, 4, 0, 0, 0.0, 128),
    (1000, 32, 1, 256, 0, 30.0, 128),
    (777, 16, 2, 0, 100, 0.0, 128),
    (1000, 25, 5, 0, 0, 0.0, 64),
]
# timed cases: S = 1000 lies in the serving paths' prompt range; llama2-7b
# (path 1) reports as "ms", hymba (path 3) as "ms_hymba"
TIMED_FLASH_CASES = {1: "", 5: "_hymba"}


def flash_bytes_flops(S: int, BH: int, rep: int, Dh: int):
    """Bytes (q, k, v read once, o written once, bf16) and causal operations
    of one ``flash_prefill`` call."""
    pairs = S * (S + 1) // 2
    return 2.0 * Dh * S * (2 * BH + 2 * BH // rep), 4.0 * pairs * Dh * BH


def flash_case(case, flush, report: dict, suffix) -> None:
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels.ref import flash_prefill_ref

    S, BH, rep, window, prefix, cap, Dh = case
    dev = DEV
    gen = torch.Generator(device=dev).manual_seed(S + rep)
    q = torch.randn(BH, S, Dh, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(BH // rep, S, Dh, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(BH // rep, S, Dh, generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(window=window, prefix_len=prefix, softcap=cap, kv_repeat=rep)
    o_k = fp.flash_prefill(q, k, v, **kw)
    o_p = flash_prefill_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((o_k.float() - o_p.float()).abs().max())
    line = (f"  flash_prefill S={S} BHq={BH} kv_repeat={rep} Dh={Dh} window={window} "
            f"prefix={prefix} softcap={cap}: max_abs_err={err:.3e} (tol {PREFILL_TOL})")
    if not err <= PREFILL_TOL:
        fail(line)
    report["err"] = max(report.get("err", 0.0), err)
    if suffix is not None:
        ms = time_ms(lambda: fp.flash_prefill(q, k, v, **kw), 20, flush)
        plain = time_ms(lambda: flash_prefill_ref(q, k, v, **kw), 3, flush)
        qs = q[None]
        ks = k[None].repeat_interleave(rep, dim=1)
        vs = v[None].repeat_interleave(rep, dim=1)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), 20, flush)
        nbytes, flops = flash_bytes_flops(S, BH, rep, Dh)
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        timed = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=max(t_ops, t_bytes),
                     bound_by="operations" if t_ops >= t_bytes else "bytes")
        report.update({key + suffix: value for key, value in timed.items()})
        line += (f" | kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, "
                 f"bound {timed['bound_ms']:.4f} ms ({timed['bound_by']})")
    print(line)


# ---------------------------------------------------------------------------
# gear_decode at the streaming history scorer's shape


def history_case(flush, report: dict) -> None:
    """``gear_decode`` as the streaming prefill's history scorer: a batch-1
    cache of llama2-7b's 32 kv heads, G * T = 64 query rows per row (the
    tensor-core regime), one extent n_comp = c * 64 shared by all rows; then
    ``gear_decode_history`` over request 0's 14 in-flight blocks in one
    launch, against its plain version and the per-block calls, timed."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import gear_decode as gd
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_history_ref, gear_decode_ref

    H, Dh = 32, 128
    pol = named_policy("gear_kcvt4")
    cfg = cache_lib.CacheConfig(batch=1, kv_heads=H, head_dim=Dh, capacity=CAP_SERVE,
                                policy=pol)
    gen = torch.Generator(device=DEV).manual_seed(2)
    k = torch.randn(1, H, CAP_SERVE, Dh, generator=gen, device=DEV).to(torch.bfloat16)
    v = torch.randn(1, H, CAP_SERVE, Dh, generator=gen, device=DEV).to(torch.bfloat16)
    cache = cache_lib.prefill_layer_cache(
        cfg, cache_lib.init_layer_cache(cfg, torch.bfloat16, DEV), k, v)
    arrays, lr, sp = ops._gear_operands(cfg, cache, H)
    q = torch.randn(H, 64, Dh, generator=gen, device=DEV)
    kw = dict(bits=pol.bits, chunk=cfg.chunk, scale_factor=Dh ** -0.5, **lr, **sp)
    for c in (1, 7, 13):
        acc_k, m_k, l_k = gd.gear_decode(q, *arrays, c * cfg.chunk, **kw)
        acc_p, m_p, l_p = gear_decode_ref(q, *arrays, c * cfg.chunk, **kw)
        torch.cuda.synchronize()
        err = max(float((acc_k / l_k[..., None] - acc_p / l_p[..., None]).abs().max()),
                  float((m_k - m_p).abs().max()))
        print(f"  gear_decode G*T=64, n_comp={c * cfg.chunk}: max_abs_err={err:.3e} "
              f"(tol {DECODE_TOL})")
        if not err <= DECODE_TOL:
            fail(f"gear_decode at 64 query rows disagrees with its plain version: {err}")
        report["err"] = max(report.get("err", 0.0), err)

    # request 0's layer-0 history work in one launch: its 859 tokens bucket
    # to 14 blocks of 64 query rows; block i sees the i * 64 tokens before it
    n_blocks = -(-PROMPT_LENGTHS[0] // cfg.chunk)
    extents = [i * cfg.chunk for i in range(n_blocks)]
    qb = torch.randn(H, n_blocks, 64, Dh, generator=gen, device=DEV)
    gd.gear_decode.launches = 0
    acc_k, m_k, l_k = gd.gear_decode_history(qb, *arrays, extents, **kw)
    launches = gd.gear_decode.launches
    acc_p, m_p, l_p = gear_decode_history_ref(qb, *arrays, extents, **kw)
    per_block = [gd.gear_decode(qb[:, i].contiguous(), *arrays, e, **kw)
                 for i, e in enumerate(extents)]
    torch.cuda.synchronize()
    live = slice(1, None)                                     # block 0 has no history
    err = max(float((acc_k / l_k[..., None] - acc_p / l_p[..., None])[:, live].abs().max()),
              float((m_k - m_p)[:, live].abs().max()))
    bitwise = all(torch.equal(a[:, i], b) for i, one in enumerate(per_block)
                  for a, b in zip((acc_k, m_k, l_k), one))
    ms = time_ms(lambda: gd.gear_decode_history(qb, *arrays, extents, **kw), 20, flush)
    plain = time_ms(lambda: gear_decode_history_ref(qb, *arrays, extents, **kw), 3, flush)
    nbytes, flops = history_bytes_flops(qb, dict(zip(DECODE_NAMES[1:7], arrays)) | lr | sp,
                                        extents, cfg.chunk)
    print(f"  gear_decode_history, request 0's layer-0 shape ({n_blocks} blocks x 64 query rows, "
          f"extents 0..{extents[-1]}): {launches} launch, max_abs_err={err:.3e} (tol "
          f"{DECODE_TOL}), equal to {n_blocks} per-block gear_decode calls bit for bit = "
          f"{bitwise} | kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
          f"{max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3:.4f} ms")
    if launches != 1 or not err <= DECODE_TOL or not bitwise:
        fail("gear_decode_history disagrees with its plain version or its per-block calls")
    report["err"] = max(report.get("err", 0.0), err)
    report["ms_history_per_layer_synthetic"] = ms


def history_bytes_flops(q, operands: dict, extents, chunk: int):
    """Least bytes and operations of one ``gear_decode_history`` call: q
    read and (acc, m, l) written once, each row's chunks up to the largest
    extent read once; 4 Dh (+ low-rank) operations per (query row, live
    token) of every block.  The operations are counted at the bf16
    tensor-core rate, the rate of the products the kernel runs."""
    BH, NB, R, Dh = q.shape
    ext = [int(e) for e in extents]
    live = -(-max(ext) // chunk)
    r = operands["k_a"].shape[-1] if operands.get("k_a") is not None else 0
    nbytes = BH * live * chunk_bytes(operands, chunk) + q.numel() * 4 + BH * NB * R * (Dh + 2) * 4
    tokens = sum(-(-e // chunk) * chunk for e in ext)
    flops = BH * R * tokens * (4 * Dh + 4 * r) + BH * R * sum(-(-e // chunk) for e in ext) * 4 * Dh * r
    return nbytes, flops


def history_call_bytes_flops(args, kwargs):
    operands = dict(zip(DECODE_NAMES[1:7], args[1:7])) | {
        k: v for k, v in kwargs.items() if isinstance(v, torch.Tensor)}
    return history_bytes_flops(args[0], operands, args[7], kwargs["chunk"])


# ---------------------------------------------------------------------------
# gear_compress


COMPRESS_OUTPUTS = ("packed", "scale", "zero", "sp_val", "sp_idx", "resid")


def compress_check(x, kw, label: str, report: dict) -> None:
    """Kernel vs plain version on ``x``: every output bit for bit, and two
    calls of the kernel bitwise equal."""
    from repro_torch.kernels import gear_compress as gc
    from repro_torch.kernels.ref import gear_compress_ref

    got = gc.gear_compress(x, **kw)
    again = gc.gear_compress(x, **kw)
    want = gear_compress_ref(x, **kw)
    torch.cuda.synchronize()
    differ, unstable = {}, []
    for name, a, b, w in zip(COMPRESS_OUTPUTS, got, again, want):
        if a is None or w is None:
            if (a is None) != (w is None):
                differ[name] = "missing"
            continue
        if not torch.equal(a, b):
            unstable.append(name)
        w = w.to(a.dtype)
        if not torch.equal(a, w):
            differ[name] = int((a != w).sum())
    resid_err = float((got[5] - want[5]).abs().max())
    print(f"  gear_compress {label}: equal to the plain version bit for bit = {not differ}"
          + (f" (entries that differ: {differ})" if differ else "")
          + f", two calls bitwise equal = {not unstable}")
    if differ or unstable:
        fail(f"gear_compress {label} differs from its plain version {differ} or across two "
             f"calls {unstable}")
    report["err"] = max(report.get("err", 0.0), resid_err)


def compress_time(x, kw, label: str, flush, report: dict) -> dict:
    """The kernel (with ``--parent-kernels``, the parent's in turns), its
    plain version and the call's bound; the row is appended to the report's
    cases and returned."""
    from repro_torch.kernels import gear_compress as gc
    from repro_torch.kernels.ref import gear_compress_ref

    parent = PARENT_KERNELS.get("gear_compress")
    timed = turns(lambda: gc.gear_compress(x, **kw),
                  None if parent is None else lambda: parent(x, **kw), 50, flush)
    plain = time_ms(lambda: gear_compress_ref(x, **kw), 5, flush)
    nbytes, flops = compress_bytes_flops(x, kw)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    row = {"what": label, **{f"ms_{key}": val for key, val in timed.items()}, "plain_ms": plain,
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"    {label}: kernel {times_text(timed)}, plain {plain:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {nbytes / 1e6:.2f} MB)")
    report.setdefault("cases", []).append(row)
    return row


def compress_kwargs(pol, kind: str, nb: int, d: int) -> dict:
    from repro_torch.core.outlier import outlier_count

    scheme, group = pol.scheme_for(kind)
    vec = nb if scheme == "per_channel" else d
    n_out = outlier_count(vec, pol.sparsity) if pol.use_sparse else 0
    return dict(bits=pol.bits, scheme=scheme, group=group, n_out=n_out,
                stat_dtype=pol.stat_dtype)


def compress_case(policy_name: str, flush, report: dict) -> None:
    """Both orientations over 448 [64, 128] tiles (32 kv heads x 14 chunks),
    with a constant channel and a constant token (top and bottom outliers
    share an index), each timed."""
    from repro_torch.core.policy import named_policy

    pol = named_policy(policy_name)
    gen = torch.Generator(device=DEV).manual_seed(3)
    x = torch.randn(448, 64, 128, generator=gen, device=DEV).to(torch.bfloat16).float()
    x[0, :, 5] = 1.25
    x[1, 9, :] = -0.75
    for kind in ("k", "v"):
        kw = compress_kwargs(pol, kind, 64, 128)
        label = (f"{policy_name} {kind.upper()} ({kw['scheme']}, group {kw['group']}, "
                 f"{kw['n_out']} outliers per extreme)")
        compress_check(x, kw, label, report)
        compress_time(x, kw, label, flush, report)
        if policy_name == "gear_kcvt4" and kind == "k":
            compress_probes(x, kw, flush, report)
        compress_nan_check(kw, label)


def compress_nan_check(kw: dict, label: str) -> None:
    """A K channel (V token) with more NaNs than its outlier count, one with
    a single NaN, and an all-NaN tile: every output equal to the plain
    version's, a NaN equal to any NaN, and NaN stats in those tiles.  With
    ``--parent-kernels`` the parent's kernel is held on the same input and
    reported, not failed."""
    from repro_torch.kernels import gear_compress as gc
    from repro_torch.kernels.ref import gear_compress_ref

    x = torch.randn(448, 64, 128, generator=torch.Generator(device=DEV).manual_seed(4),
                    device=DEV).to(torch.bfloat16).float()
    many = torch.arange(2 * kw["n_out"] + 1, device=DEV) * 5
    if kw["scheme"] == "per_channel":
        x[0, many, 7] = float("nan")
        x[1, 30, 9] = float("nan")
    else:
        x[0, 7, many] = float("nan")
        x[1, 30, 100] = float("nan")
    x[2] = float("nan")
    want = gear_compress_ref(x, **kw)

    def equal(got) -> dict:
        return {name: nan_equal(a, w.to(a.dtype)) for name, a, w in
                zip(COMPRESS_OUTPUTS, got, want) if a is not None and w is not None}

    got = gc.gear_compress(x, **kw)
    same = equal(got)
    nan_stats = bool(torch.isnan(got[1][0]).any()) and bool(torch.isnan(got[1][2]).all())
    print(f"    NaN tiles ({2 * kw['n_out'] + 1} NaNs in one vector, 1 in another, an all-NaN "
          f"tile): equal to the plain version = {same}, NaN stats = {nan_stats}")
    if not (all(same.values()) and nan_stats):
        fail(f"gear_compress {label} on NaN tiles differs from its plain version {same}")
    parent = PARENT_KERNELS.get("gear_compress")
    if parent is not None:
        print(f"    parent's kernel on the NaN tiles: equal = {equal(parent(x, **kw))}")


def compress_probes(x, kw, flush, report: dict) -> None:
    """What bounds the event, probed on the same tiles: the kernel without
    its outlier search (n_out = 0), and a device copy of the bytes it reads
    and writes most of (x into a residual-sized buffer), which no kernel
    that reads and writes those bytes can beat."""
    from repro_torch.kernels import gear_compress as gc

    resid = torch.empty_like(x)
    probes = {"no_outliers_ms": time_ms(lambda: gc.gear_compress(x, **{**kw, "n_out": 0}), 50,
                                        flush),
              "copy_ms": time_ms(lambda: resid.copy_(x), 50, flush)}
    print(f"    probes: the kernel without outliers {probes['no_outliers_ms']:.4f} ms; a device "
          f"copy of x ({x.numel() * 8 / 1e6:.2f} MB read and written) {probes['copy_ms']:.4f} ms")
    report["probes"] = probes


def compress_bytes_flops(x: torch.Tensor, kw: dict):
    """Least bytes and f32 operations of one ``gear_compress`` call: x read
    once; packed codes, stats, outliers and the residual written once; per
    element, 2 compares per outlier sweep of each extreme, the group
    min/max, and the quantize / dequantize / residual arithmetic (~10)."""
    N, nb, d = x.shape
    per = 32 // kw["bits"]
    group = kw["group"] or (nb if kw["scheme"] == "per_channel" else d)
    n_stat = (nb // group) * d if kw["scheme"] == "per_channel" else nb * (d // group)
    sp_rows = d if kw["scheme"] == "per_channel" else nb
    out = N * (nb * d // per + 2 * n_stat + 2 * sp_rows * 2 * kw["n_out"] + nb * d) * 4
    nbytes = x.numel() * 4 + out
    flops = x.numel() * (2 * 2 * kw["n_out"] + 2 + 10)
    return nbytes, flops


# ---------------------------------------------------------------------------
# flash_prefill_block


def block_bytes_flops(q, k, kv_len):
    """Least bytes and f32 operations of one ``flash_prefill_block`` call:
    q, k, v and kv_len read once, (acc, m, l) written once; 4 Dh operations
    (q.k and p.v) per visible (query, key) pair of this call's masks."""
    N, T, Dh = q.shape
    t = torch.arange(T, device=q.device)
    pairs = int(torch.minimum(t[None, :] + 1, kv_len.long()[:, None]).sum())
    nbytes = (q.numel() + 2 * k.numel() + N * T * (Dh + 2) + N) * 4
    return nbytes, 4 * Dh * pairs


def block_library(args, kwargs, flush) -> dict:
    """The library yardstick of a ``flash_prefill_block`` call:
    ``torch.ops.aten._scaled_dot_product_efficient_attention`` on the same
    f32 operands (K/V repeated for GQA and the causal and kv_len mask built
    as an additive bias, both outside the timed window; the call reads the
    bias, N T^2 f32, besides q, k and v), returning (out, lse) = (acc / l,
    m + log l).  It is held against the plain version within BLOCK_TOL
    first; where the op refuses the operands or disagrees, its error is
    returned instead of a time.  The port never calls it."""
    from repro_torch.kernels.ref import flash_block_ref

    q, k, v, kv_len = args[:4]
    scale, rep = kwargs["scale"], kwargs.get("kv_repeat", 1)
    N, T, _ = q.shape
    note = ("reads an additive [N, 1, T, T] f32 mask bias "
            f"({N * T * T * 4 / 1e6:.2f} MB) besides q, k and v")
    try:
        kx = k.repeat_interleave(rep, dim=0)[:, None]
        vx = v.repeat_interleave(rep, dim=0)[:, None]
        t = torch.arange(T, device=q.device)
        ok = (t[None, :] <= t[:, None])[None] & (t[None, None, :] < kv_len.long()[:, None, None])
        bias = torch.zeros(N, 1, T, -(-T // 16) * 16, device=q.device)   # 16-aligned rows
        bias[..., :T].masked_fill_(~ok[:, None], float("-inf"))
        bias = bias[..., :T]
        qx = q[:, None]

        def call():
            return torch.ops.aten._scaled_dot_product_efficient_attention(
                qx, kx, vx, bias, True, scale=scale)

        out, lse = call()[:2]
        acc_p, m_p, l_p = flash_block_ref(*args, **kwargs)
        torch.cuda.synchronize()
        err = max(float((out[:, 0] - acc_p / l_p[..., None]).abs().max()),
                  float((lse[:, 0, :T] - (m_p + torch.log(l_p))).abs().max()))
        if not err <= BLOCK_TOL:
            return {"library_ms": None, "library_note": f"efficient attention disagrees with "
                    f"the plain version: max_abs_err {err:.3e} > {BLOCK_TOL}"}
        return {"library_ms": time_ms(call, 50, flush), "library_err": err, "library_note": note}
    except (RuntimeError, TypeError, ValueError) as exc:   # its error is the finding
        return {"library_ms": None, "library_note": f"{type(exc).__name__}: {exc}"[:400]}


def block_check(fn, args, kwargs, label: str, flush, report: dict, library: bool) -> dict:
    """Kernel vs plain version (normalized output and score max within
    BLOCK_TOL), two calls bitwise equal; then the kernel's times (with
    ``--parent-kernels``, the parent's in turns), the plain version's, the
    call's bound and, with ``library``, the efficient-attention yardstick."""
    from repro_torch.kernels.ref import flash_block_ref

    acc_k, m_k, l_k = fn(*args, **kwargs)
    again = fn(*args, **kwargs)
    acc_p, m_p, l_p = flash_block_ref(*args, **kwargs)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip((acc_k, m_k, l_k), again))
    err = max(float((acc_k / l_k[..., None] - acc_p / l_p[..., None]).abs().max()),
              float((m_k - m_p).abs().max()))
    print(f"  {label}: max_abs_err={err:.3e} (tol {BLOCK_TOL}), two calls bitwise equal: "
          f"{bitwise}")
    if not (err <= BLOCK_TOL and bitwise):
        fail(f"{label} disagrees with its plain version ({err}) or across two calls")
    report["err"] = max(report.get("err", 0.0), err)
    parent = PARENT_KERNELS.get("flash_prefill_block")
    timed = turns(lambda: fn(*args, **kwargs),
                  None if parent is None else lambda: parent(*args, **kwargs), 50, flush)
    plain = time_ms(lambda: flash_block_ref(*args, **kwargs), 5, flush)
    nbytes, flops = block_bytes_flops(args[0], args[1], args[3])
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    row = {"what": label, **{f"ms_{key}": val for key, val in timed.items()}, "plain_ms": plain,
           "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if library:
        row.update(block_library(args, kwargs, flush))
    lib = ""
    if library:
        lib = (f", efficient attention {row['library_ms']:.4f} ms ({row['library_note']})"
               if row["library_ms"] is not None else f", efficient attention: {row['library_note']}")
    print(f"    kernel {times_text(timed)}, plain {plain:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}, {nbytes / 1e6:.2f} MB; {flops / 1e9:.3f} GFLOP of visible pairs)"
          + lib)
    report.setdefault("cases", []).append(row)
    return row


def block_case(T: int, rep: int, flush, report: dict) -> None:
    from repro_torch.kernels import flash_prefill as fp

    N, Dh = 448, 128
    gen = torch.Generator(device=DEV).manual_seed(T + rep)
    q = torch.randn(N, T, Dh, generator=gen, device=DEV)
    k = torch.randn(N // rep, T, Dh, generator=gen, device=DEV)
    v = torch.randn(N // rep, T, Dh, generator=gen, device=DEV)
    kv_len = (torch.full((N,), T, dtype=torch.int32, device=DEV) if T == 64 else
              torch.randint(1, T + 1, (N,), generator=gen, device=DEV, dtype=torch.int32))
    kw = dict(scale=Dh ** -0.5, kv_repeat=rep)
    block_check(fp.flash_prefill_block, (q, k, v, kv_len), kw,
                f"flash_prefill_block N={N} T={T} kv_repeat={rep} kv_len "
                f"{'= T' if T == 64 else 'random in [1, T]'}", flush, report,
                library=T == 64 and rep == 1)
    if T == 64 and rep == 1:
        # the wave structure: three blocks (row groups) fit an SM at Dh 128
        wave = 3 * torch.cuda.get_device_properties(0).multi_processor_count
        one = time_ms(lambda: fp.flash_prefill_block(q[:wave], k[:wave], v[:wave],
                                                     kv_len[:wave], **kw), 50, flush)
        alone = time_ms(lambda: fp.flash_prefill_block(q[:1], k[:1], v[:1], kv_len[:1], **kw),
                        50, flush)
        print(f"    probes: one full wave ({wave} row groups, 3 per SM) {one:.4f} ms; "
              f"one row group alone {alone:.4f} ms")
        report["probes"] = {"one_wave_rows": wave, "one_wave_ms": one, "one_block_ms": alone}


# ---------------------------------------------------------------------------
# gear_decode_paged


def paged_case(policy_name: str, report: dict) -> None:
    """A 4-slot cache of the main path's shapes scattered into a shuffled
    pool; table entries past each slot's extent name the zero page.  The
    paged kernel must equal ``gear_decode`` on the gathered operands bit for
    bit and its plain version within DECODE_TOL."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import gear_decode as gd
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gather_paged_operands, gear_decode_paged_ref

    B, H, Dh = B_SERVE, 32, 128
    pol = named_policy(policy_name)
    cfg = cache_lib.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=CAP_SERVE, policy=pol)
    cfg1 = cache_lib.CacheConfig(batch=1, kv_heads=H, head_dim=Dh, capacity=CAP_SERVE, policy=pol)
    nb, C = cfg.chunk, cfg.n_chunks
    gen = torch.Generator(device=DEV).manual_seed(4)
    lengths = [5, 67, 586, CAP_SERVE]
    live = [n // nb for n in lengths]
    n_pages = 1 + sum(live)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator().manual_seed(0)) + 1
    pool = cache_lib.init_paged_layer_cache(cfg, n_pages, torch.bfloat16, DEV)
    bt = torch.zeros((B, C), dtype=torch.int32)
    used = 0
    for b in range(B):
        k = torch.randn(1, H, CAP_SERVE, Dh, generator=gen, device=DEV).to(torch.bfloat16)
        v = torch.randn(1, H, CAP_SERVE, Dh, generator=gen, device=DEV).to(torch.bfloat16)
        one = cache_lib.prefill_layer_cache(
            cfg1, cache_lib.init_layer_cache(cfg1, torch.bfloat16, DEV), k, v)
        pages = perm[used:used + live[b]]
        used += live[b]
        bt[b, :live[b]] = pages
        cache_lib.scatter_pool_chunks(cfg1, pool, pages.to(DEV),
                                      cache_lib.extract_prefix_chunks(cfg1, one, live[b]))
    bt = bt.to(DEV)
    BH = B * H
    n_comp = torch.tensor(lengths, dtype=torch.int32, device=DEV).repeat_interleave(H) // nb * nb
    q = torch.randn(BH, 1, Dh, generator=gen, device=DEV)
    arrays, lr, sp = ops._paged_operands(cfg, pool)
    kw = dict(bits=pol.bits, chunk=nb, scale_factor=Dh ** -0.5)
    paged = gd.gear_decode_paged(q, *arrays, n_comp, bt, **kw, **lr, **sp)
    plain = gear_decode_paged_ref(q, *arrays, n_comp, bt, **kw, **lr, **sp)
    names = ("k_packed", "k_scale", "k_zero", "v_packed", "v_scale", "v_zero")
    g = gather_paged_operands(bt, BH, dict(zip(names, arrays)) | lr | sp)
    flat = gd.gear_decode(q, *[g[n] for n in names], n_comp, **kw,
                          **{n: g[n] for n in list(lr) + list(sp)})
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for a, b in zip(paged, flat))
    rows = n_comp > 0
    err = max(float((paged[0] / paged[2][..., None] - plain[0] / plain[2][..., None])[rows]
                    .abs().max()), float((paged[1] - plain[1])[rows].abs().max()))
    print(f"  gear_decode_paged {policy_name}: {n_pages} pages, n_comp per slot "
          f"{[int(x) for x in n_comp[::H]]}: bitwise equal to gear_decode on gathered operands "
          f"= {bitwise}; vs plain max_abs_err={err:.3e} (tol {DECODE_TOL})")
    if not bitwise:
        fail(f"gear_decode_paged {policy_name} differs from gear_decode on gathered operands")
    if not err <= DECODE_TOL:
        fail(f"gear_decode_paged {policy_name} disagrees with its plain version: {err}")
    report["err"] = max(report.get("err", 0.0), err)


# ---------------------------------------------------------------------------
# linear_scan_chunked


SCAN_CASES = [
    # (mode, BH, S, Dk, Dv, log_w columns, chunk, initial state)
    ("inclusive", 25, 1024, 16, 64, 1, 64, False),   # hymba heads, aligned: 16 chunks
    ("inclusive", 25, 859, 16, 64, 1, 859, False),   # hymba's live shape: chunk = S
    ("inclusive", 4, 200, 16, 64, 16, 200, False),   # per-Dk decay, chunk = S
    ("bonus", 40, 1024, 64, 64, 64, 64, False),      # RWKV6-3b's heads, u nonzero
    ("bonus", 40, 859, 64, 64, 64, 859, False),      # RWKV6-3b's live prefill: chunk = S
    ("bonus", 160, 1, 64, 64, 64, 1, True),          # RWKV6-3b's decode step, 4 slots
]


PARENT_SCAN = None     # the parent tree's kernel, set by --parent-scan
PARENT_KERNELS = {}    # kernel name -> the parent tree's version, set by --parent-kernels
# kernels --parent-kernels builds: (wrapper module, its launcher, the C entry point)
PARENT_SOURCES = {"flash_prefill_block": ("flash_prefill", "_block_launcher", "flash_block_launch"),
                  "gear_compress": ("gear_compress", "_launcher", "gear_compress_launch"),
                  "quant_pack": ("quant_pack", "_launcher", "quant_pack_launch")}


def kernel_name(mangled: str) -> str:
    """``name<template args>`` of a mangled kernel in an anonymous namespace
    (bool, int, float and bf16 arguments); the mangled name otherwise."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)", mangled)
    if m is None:
        return mangled
    start = m.end()
    name = mangled[start:start + int(m.group(1))]
    rest = mangled[start + len(name):]
    if not rest.startswith("I"):
        return name
    args = re.findall(r"Lb([01])E|Li(-?\d+)E|(13__nv_bfloat16)|^I(f)E", rest[:rest.find("Ev") + 1])
    words = [("true" if b == "1" else "false") if b else i or ("bf16" if h else "float")
             for b, i, h, f in args]
    return f"{name}<{', '.join(words)}>"


def ptxas_summary(log: str) -> str:
    """Each entry function's registers and spilled bytes from an ``nvcc
    -Xptxas -v`` log, as "kernel<args> R regs[, S B spilled]"."""
    out, fn, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = kernel_name(m.group(1)), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append(f"{fn} {m.group(1)} regs" + (f", {spill} B spilled" if spill else ""))
            fn = None
    return "; ".join(out)


def start_parent_build(src: pathlib.Path):
    """Start ``nvcc`` on a parent tree's ``<name>.cu`` beside this tree's
    build; returns (process, library path)."""
    from repro_torch.kernels import _build

    out = _build.BUILD / "parent" / f"lib{src.stem}_parent.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc(), *_build.FLAGS, "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out


def parent_kernel(name: str, proc, lib_path: pathlib.Path):
    """A parent tree's kernel ``name`` as a function of its wrapper's
    signature: this tree's wrapper checks the operands and allocates the
    outputs, the parent's library launches (its C entry point takes the same
    arguments); it counts nothing."""
    import ctypes
    import importlib

    mod_name, attr, entry = PARENT_SOURCES[name]
    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"the parent's {name}.cu did not build:\n{log}")
    module = importlib.import_module(f"repro_torch.kernels.{mod_name}")
    wrapper = getattr(module, name)
    tree = getattr(module, attr)()
    launch = getattr(ctypes.CDLL(str(lib_path)), entry)
    launch.argtypes, launch.restype = tree.argtypes, tree.restype

    def call(*args, **kwargs):
        real, launches = getattr(module, attr), wrapper.launches
        setattr(module, attr, lambda: launch)
        try:
            return wrapper(*args, **kwargs)
        finally:
            setattr(module, attr, real)
            wrapper.launches = launches

    print(f"  parent {name}.cu built; {ptxas_summary(log)}")
    return call


def parent_scan(proc, lib_path: pathlib.Path):
    """The parent's kernel as a function of ``linear_scan_chunked``'s
    signature (operands as the wrapper checks them; it counts nothing).  A
    library that exports ``linear_scan_workspace_bytes`` takes a workspace
    after the state pointer; an older one takes none."""
    import ctypes

    log, _ = proc.communicate()
    if proc.returncode != 0:
        fail(f"the parent's linear_scan.cu did not build:\n{log}")
    lib = ctypes.CDLL(str(lib_path))
    ws_bytes = getattr(lib, "linear_scan_workspace_bytes", None)
    launch = lib.linear_scan_launch
    launch.argtypes = ([ctypes.c_void_p] * (8 if ws_bytes is None else 9) + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
    launch.restype = ctypes.c_int
    if ws_bytes is not None:
        ws_bytes.argtypes = [ctypes.c_int] * 5
        ws_bytes.restype = ctypes.c_longlong

    def call(r, k, v, log_w, u=None, *, chunk, mode, state0=None):
        BH, S, Dk = r.shape
        Dv = v.shape[-1]
        y = torch.empty_like(v)
        state = torch.empty((BH, Dk, Dv), dtype=torch.float32, device=r.device)
        ws = []
        if ws_bytes is not None:
            n = ws_bytes(BH, S, Dk, Dv, chunk)
            buf = torch.empty(n, dtype=torch.uint8, device=r.device) if n else None
            ws = [None if buf is None else buf.data_ptr()]
        code = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                      None if u is None else u.data_ptr(),
                      None if state0 is None else state0.data_ptr(), y.data_ptr(),
                      state.data_ptr(), *ws, BH, S, Dk, Dv, log_w.shape[-1], chunk,
                      int(mode == "bonus"), torch.cuda.current_stream().cuda_stream)
        if code:
            fail(f"the parent's linear_scan kernel: CUDA error {code}")
        return y, state

    print(f"  parent linear_scan.cu built; {ptxas_summary(log)}")
    return call


def scan_inputs(mode, BH, S, Dk, Dv, lw_cols, seed: int):
    """Hymba-like inputs: one decay per head near the reference's init
    (-softplus(x - 1), x ~ N(0, 0.5^2)); RWKV-like: per-Dk log w = -exp(x)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    r = torch.randn(BH, S, Dk, generator=gen, device=DEV)
    k = torch.randn(BH, S, Dk, generator=gen, device=DEV)
    v = torch.randn(BH, S, Dv, generator=gen, device=DEV)
    x = torch.randn(BH, S, lw_cols, generator=gen, device=DEV) * 0.5
    lw = (-torch.exp(x - 2.0) if mode == "bonus"
          else -torch.nn.functional.softplus(x - 1.0))
    u = torch.randn(BH, Dk, generator=gen, device=DEV) * 0.5 if mode == "bonus" else None
    return r, k, v, lw, u


def scan_bytes_flops(r, k, v, lw, u, chunk: int, mode: str, state0=None):
    """Least bytes and f32 operations of one ``linear_scan_chunked`` call:
    r, k, v, log w (and u, and the initial state) read once, y and the final
    state written once.  Per chunk of W tokens: 2 (Dk + Dv) operations per
    visible (query, key) pair of the causal intra product (W (W + 1) / 2
    pairs, or W (W - 1) / 2 for ``bonus``) and 2 Dk Dv per token for the
    state update; per token, the cumsum and 3 exponentials per log w column
    and 3 Dk factor products, and the bonus term.  From a zero state the
    cross-chunk read (2 Dk Dv per token) and the state's decay (Dk Dv) do
    work only in the chunks after the first; from an initial state, in
    every chunk.  Returns (bytes, operations, the operations of these that
    the kernel runs on the tensor cores): at chunk > 1 the intra products,
    the state increments and the cross terms."""
    BH, S, Dk = r.shape
    Dv, L = v.shape[-1], lw.shape[-1]
    W = chunk
    n = S // W
    pairs = W * (W + 1) // 2 if mode == "inclusive" else W * (W - 1) // 2
    per_chunk = pairs * 2 * (Dk + Dv) + W * (2 * Dk * Dv + 4 * L + 3 * Dk)
    if mode == "bonus":
        per_chunk += W * (3 * Dk + 2 * Dv)
    cross = W * 2 * Dk * Dv + Dk * Dv
    flops = BH * (n * per_chunk + (n if state0 is not None else n - 1) * cross)
    mma = 0
    if W > 1:
        mma = BH * (n * (pairs * 2 * (Dk + Dv) + W * 2 * Dk * Dv)
                    + (n if state0 is not None else n - 1) * W * 2 * Dk * Dv)
    inputs = r.numel() + k.numel() + v.numel() + lw.numel() + (0 if u is None else u.numel())
    inputs += 0 if state0 is None else state0.numel()
    nbytes = 4 * (inputs + BH * S * Dv + BH * Dk * Dv)
    return nbytes, flops, mma


def row_err(got: torch.Tensor, want: torch.Tensor):
    """Largest error over the rows of the last dim, each against 2e-3 x max(1,
    max |want| of that row): (worst ratio err / limit, median |want|)."""
    limit = 2e-3 * want.abs().amax(-1).clamp_min(1.0)
    ratio = float(((got - want).abs().amax(-1) / limit).max())
    return ratio, float(want.abs().median())


def scan_check(fn, args: tuple, kw: dict, label: str, flush, report: dict, iters: int = 20,
               list_kernels: bool = False):
    """Kernel vs plain version (y and final state) within 2e-3 x max(1,
    max |plain|), and within 2e-3 x max(1, max |plain| of the row) for every
    row (token of y, Dk row of the state), so a wrong ordinary-sized entry
    fails even where the clamp has blown a few late rows up; two calls
    equal bit for bit.  Then the times (with ``--parent-scan``, the parent
    tree's kernel in turns p1, c1, c2, p2 on the same operands), with
    ``list_kernels`` the CUDA kernels one call launches and their device
    times (a profiler window),
    and the call's bounds: f32 operations at the
    SIMT rate, and with the tensor-core products at the TF32 rate, three
    passes each.  Returns (ms, plain_ms, bound_ms, bound_by)."""
    from repro_torch.kernels.ref import linear_scan_ref

    y_k, st_k = fn(*args, **kw)
    y_k2, st_k2 = fn(*args, **kw)
    y_p, st_p = linear_scan_ref(*args, **kw)
    torch.cuda.synchronize()
    bitwise = torch.equal(y_k, y_k2) and torch.equal(st_k, st_k2)
    scale_y = max(1.0, float(y_p.abs().max()))
    scale_s = max(1.0, float(st_p.abs().max()))
    err_y = float((y_k - y_p).abs().max())
    err_s = float((st_k - st_p).abs().max())
    row_y, med_y = row_err(y_k, y_p)
    row_s, med_s = row_err(st_k, st_p)
    ok = (err_y <= 2e-3 * scale_y and err_s <= 2e-3 * scale_s
          and row_y <= 1.0 and row_s <= 1.0 and bitwise)
    timed = turns(lambda: fn(*args, **kw),
                  None if PARENT_SCAN is None else lambda: PARENT_SCAN(*args, **kw), iters, flush)
    ms = timed["c1"]
    plain_ms = time_ms(lambda: linear_scan_ref(*args, **kw), 3, flush)
    names = kernel_breakdown(lambda: fn(*args, **kw), 10, flush) if list_kernels else None
    nbytes, flops, mma = scan_bytes_flops(*args, kw["chunk"], kw["mode"], kw.get("state0"))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    bound, by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
    t_tc = max(t_bytes, (3 * mma / TF32_FLOPS + (flops - mma) / F32_FLOPS) * 1e3)
    times = times_text(timed)
    print(f"  {label}: y max_abs_err={err_y:.3e} (tol 2e-3 x {scale_y:.3g}; median |y| "
          f"{med_y:.3g}; worst row at {row_y:.3g} of its limit), state max_abs_err="
          f"{err_s:.3e} (tol 2e-3 x {scale_s:.3g}; median {med_s:.3g}; worst row at "
          f"{row_s:.3g} of its limit), two calls bitwise equal: {bitwise}")
    print(f"    kernel {times}, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP at f32 {F32_FLOPS / 1e12:.0f} "
          f"TFLOP/s)" + (f"; with its {mma / 1e9:.3f} GFLOP of products on the TF32 tensor "
                         f"cores ({TF32_FLOPS / 1e12:.0f} TFLOP/s, 3 passes) {t_tc:.4f} ms"
                         if mma else "") + ("; CUDA kernels per call (ms): " + ", ".join(
                             f"{key} {val:.4f}" for key, val in names.items()) if names else ""))
    if not ok:
        fail(f"{label} disagrees with its plain version")
    report["err"] = max(report.get("err", 0.0), err_y, err_s)
    report["err_over_scale"] = max(report.get("err_over_scale", 0.0), err_y / scale_y,
                                   err_s / scale_s)
    report.setdefault("cases", []).append(
        {"what": label, **{f"ms_{key}": val for key, val in timed.items()}, "plain_ms": plain_ms,
         "bound_ms": bound, "bound_by": by, "bound_ms_tf32x3": t_tc if mma else None}
        | ({"kernels": names} if names else {}))
    return ms, plain_ms, bound, by


def scan_case(case, flush, report: dict) -> None:
    from repro_torch.kernels import linear_scan_kernel as lsk

    mode, BH, S, Dk, Dv, lw_cols, chunk, with_state = case
    r, k, v, lw, u = scan_inputs(mode, BH, S, Dk, Dv, lw_cols, S + Dk)
    kw = dict(chunk=chunk, mode=mode)
    if with_state:
        kw["state0"] = torch.randn(BH, Dk, Dv, generator=torch.Generator(device=DEV).manual_seed(S),
                                   device=DEV)
    scan_check(lsk.linear_scan_chunked, (r, k, v, lw, u), kw,
               f"linear_scan_chunked {mode} BH={BH} S={S} Dk={Dk} Dv={Dv} log_w[..,{lw_cols}] "
               f"chunk={chunk}" + (" from a non-zero state0" if with_state else ""), flush, report,
               list_kernels=True)


# ---------------------------------------------------------------------------
# quant_pack


QP_CASES = [  # (N, n, d, bits, dtype): phase 5's tiles, the other widths, hymba's head_dim
    (448, 64, 128, 4, torch.float32), (448, 64, 128, 4, torch.bfloat16),
    (448, 64, 128, 2, torch.float32), (448, 64, 128, 8, torch.float32),
    (448, 64, 64, 4, torch.float32)]


def nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equal, a NaN equal to any NaN (its payload and sign aside)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a.masked_fill(na, 0), b.masked_fill(nb, 0))


def non_finite(x: torch.Tensor) -> torch.Tensor:
    """x with a NaN in column 0, +inf in column 1, -inf in column 2 and both
    in column 4 of tile 0, and a last tile that is all NaN."""
    x = x.clone()
    n = x.shape[1]
    x[0, n // 2, 0] = float("nan")
    x[0, 0, 1] = float("inf")
    x[0, n - 1, 2] = -float("inf")
    x[0, 0, 4], x[0, n - 1, 4] = float("inf"), -float("inf")
    x[-1] = float("nan")
    return x


def quant_pack_bytes(x: torch.Tensor, bits: int) -> int:
    """x read once; packed codes and the two f32 stats written once."""
    N, n, d = x.shape
    return x.numel() * x.element_size() + N * n * d * bits // 8 + 2 * N * d * 4


def quant_pack_phase(flush, report: dict) -> None:
    """``quant_pack`` driven through ``repro_torch.kernels.quantize_chunk``
    (its launch counter set to 0 just before and read just after), then held
    bit for bit against its plain version, also on non-finite input (NaN,
    +-inf, an all-NaN tile; NaN compared as equal) and across two calls, and
    timed at ``QP_CASES`` beside its byte bound (x read once, codes and
    stats written once; ~8 f32 operations per element), the profiler's
    kernel time, the plain version and ``torch.aminmax(x, dim=1)``, a
    read-side yardstick (the port never calls it; no PyTorch call quantizes
    and packs, so there is no library time).  With ``--parent-kernels``
    the parent's kernel is timed in turns and held on the same inputs; its
    mismatch on non-finite input is reported, not failed."""
    from repro_torch import kernels as port_kernels
    from repro_torch.kernels import quant_pack as qp
    from repro_torch.kernels.ref import quant_pack_ref

    x32 = torch.randn(448, 64, 128, generator=torch.Generator(device=DEV).manual_seed(5),
                      device=DEV)
    inputs = {"f32": x32, "bf16": x32.to(torch.bfloat16)}
    cases = [(bits, dt) for bits in (2, 4, 8) for dt in inputs]
    qp.quant_pack.launches = 0
    outs = {case: port_kernels.quantize_chunk(inputs[case[1]], case[0]) for case in cases}
    torch.cuda.synchronize()
    launches = qp.quant_pack.launches
    if launches != len(cases):
        fail(f"quant_pack launches {launches} != {len(cases)} quantize_chunk calls")
    parent = PARENT_KERNELS.get("quant_pack")
    for (bits, dt), got in outs.items():
        x = inputs[dt]
        want = quant_pack_ref(x, bits)
        exact = [torch.equal(a, b) for a, b in zip(got, want)]
        stable = all(torch.equal(a, b) for a, b in zip(got, qp.quant_pack(x, bits)))
        xn = non_finite(x)
        got_n, want_n = qp.quant_pack(xn, bits), quant_pack_ref(xn, bits)
        exact_n = [nan_equal(a, b) for a, b in zip(got_n, want_n)]
        nan_cols = torch.isnan(xn.float()).any(dim=1)
        where = (torch.equal(torch.isnan(got_n[1]), nan_cols)
                 and torch.equal(torch.isnan(got_n[2]), nan_cols))
        print(f"  quant_pack {dt} {bits} bits, {tuple(x.shape)}: packed / scale / zero equal "
              f"to the plain version bit for bit = {exact}, two calls equal = {stable}; "
              f"non-finite input = {exact_n}, NaN stats exactly in the NaN columns = {where}")
        if not (all(exact) and stable and all(exact_n) and where):
            fail(f"quant_pack {dt} {bits} bits differs from its plain version")
        if parent is not None:
            par = [torch.equal(a, b) for a, b in zip(parent(x, bits), want)]
            par_n = [nan_equal(a, b) for a, b in zip(parent(xn, bits), want_n)]
            print(f"    parent's kernel: finite input equal = {par}, non-finite input equal = "
                  f"{par_n}" + ("" if all(par_n) else " (the NaN fault this tree repairs)"))
    report.update(err=0.0, launches=launches, library_ms=None)

    rows = []
    for i, (N, n, d, bits, dtype) in enumerate(QP_CASES):
        x = torch.randn(N, n, d, generator=torch.Generator(device=DEV).manual_seed(6 + i),
                        device=DEV).to(dtype)
        label = f"{N} x [{n}, {d}] {'f32' if dtype == torch.float32 else 'bf16'} {bits} bits"
        tree_fn = lambda: qp.quant_pack(x, bits)                         # noqa: E731
        parent_fn = None if parent is None else (lambda: parent(x, bits))
        timed = turns(tree_fn, parent_fn, 50, flush)
        prof = {"c": sum(kernel_breakdown(tree_fn, 50, flush).values())}
        if parent_fn is not None:
            prof["p"] = sum(kernel_breakdown(parent_fn, 50, flush).values())
        plain = time_ms(lambda: quant_pack_ref(x, bits), 5, flush)
        aminmax = time_ms(lambda: torch.aminmax(x, dim=1), 50, flush)
        aminmax_prof = sum(kernel_breakdown(lambda: torch.aminmax(x, dim=1), 50, flush).values())
        nbytes = quant_pack_bytes(x, bits)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 8 * x.numel() / F32_FLOPS * 1e3
        row = {"what": label, **{f"ms_{k}": v for k, v in timed.items()},
               **{f"profiler_ms_{k}": v for k, v in prof.items()}, "plain_ms": plain,
               "aminmax_ms": aminmax, "aminmax_profiler_ms": aminmax_prof,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations", "mb": nbytes / 1e6}
        print(f"  quant_pack {label}: kernel {times_text(timed)}; profiler kernel time "
              + ", ".join(f"{'this tree' if k == 'c' else 'parent'} {v:.4f} ms"
                          for k, v in prof.items())
              + f"; plain {plain:.4f} ms; bound {row['bound_ms']:.4f} ms ({row['bound_by']}, "
              f"{nbytes / 1e6:.2f} MB); torch.aminmax(x, dim=1) {aminmax:.4f} ms, profiler "
              f"{aminmax_prof:.4f} ms (read-side yardstick, not a library time: no PyTorch call "
              f"quantizes and packs)")
        rows.append(row)
    x = torch.randn(448, 64, 128, generator=torch.Generator(device=DEV).manual_seed(6),
                    device=DEV)
    copy = torch.empty_like(x)
    probe = time_ms(lambda: copy.copy_(x), 50, flush)
    probe_prof = sum(kernel_breakdown(lambda: copy.copy_(x), 50, flush).values())
    print(f"    probe: a device copy of the f32 tiles ({2 * x.numel() * 4 / 1e6:.2f} MB read and "
          f"written) {probe:.4f} ms, profiler {probe_prof:.4f} ms")
    report["cases"] = rows
    report["copy_probe_ms"], report["copy_probe_profiler_ms"] = probe, probe_prof
    for suffix, row in (("", rows[0]), ("_bf16", rows[1])):
        report.update({"ms" + suffix: row["ms_c1"], "plain_ms" + suffix: row["plain_ms"],
                       "bound_ms" + suffix: row["bound_ms"], "bound_by" + suffix: row["bound_by"]})


# ---------------------------------------------------------------------------
# serving


class Capture:
    """Stand-in for ``module.name`` that keeps a copy of the arguments of its
    ``index``-th call (0-based; ``args`` / ``kwargs``) and of each of the
    ``more`` indices (``seen[i]``), and forwards every call."""

    def __init__(self, module, name: str, index: int, *more: int):
        self.module, self.name, self.index = module, name, index
        self.indices = (index,) + more
        self.real = getattr(module, name)
        self.calls = 0
        self.seen = {}
        setattr(module, name, self)

    def __call__(self, *args, **kwargs):
        if self.calls in self.indices:
            self.seen[self.calls] = (
                [a.clone() if isinstance(a, torch.Tensor) else a for a in args],
                {k: (v.clone() if isinstance(v, torch.Tensor) else v) for k, v in kwargs.items()})
        self.calls += 1
        return self.real(*args, **kwargs)

    @property
    def args(self):
        return self.seen.get(self.index, (None, None))[0]

    @property
    def kwargs(self):
        return self.seen.get(self.index, (None, None))[1]

    def restore(self) -> None:
        setattr(self.module, self.name, self.real)


def requests(cfg) -> list:
    """The 8 prompts both serving paths answer: raw lengths drawn from
    300-900 and token ids from numpy seed 0."""
    rng = np.random.RandomState(0)
    lengths = rng.randint(300, 901, size=N_REQUESTS)
    return [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32) for n in lengths]


def kernel_fns() -> dict:
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import gear_compress as gc
    from repro_torch.kernels import gear_decode as gd
    from repro_torch.kernels import linear_scan_kernel as lsk

    from repro_torch.kernels import quant_pack as qp

    return {"gear_decode": gd.gear_decode, "flash_prefill": fp.flash_prefill,
            "gear_compress": gc.gear_compress, "flash_prefill_block": fp.flash_prefill_block,
            "gear_decode_paged": gd.gear_decode_paged,
            "linear_scan_chunked": lsk.linear_scan_chunked, "quant_pack": qp.quant_pack}


def drive(eng, cfg, prompts: list, captures: list, new_tokens: int = NEW_TOKENS,
          keep: dict | None = None) -> dict:
    """Serve the 8 requests through ``Scheduler.run_continuous`` with every
    launch counter set to 0 just before and read just after (``keep``, when
    given, receives the results by rid)."""
    from repro_torch.serving.scheduler import Request, Scheduler

    sched = Scheduler(eng)
    for rid, toks in enumerate(prompts):
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=new_tokens))
    fns = kernel_fns()
    torch.cuda.reset_peak_memory_stats()
    try:
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        results = sched.run_continuous()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in fns.items()}
    finally:
        for c in captures:
            c.restore()
    stats = sched.last_stats
    peak = torch.cuda.max_memory_allocated()
    if len(results) != N_REQUESTS or any(str(r.status) != "ok" or len(r.tokens) != new_tokens
                                         for r in results):
        fail(f"serving results: {[(r.rid, str(r.status), len(r.tokens)) for r in results]}")
    for r in results:
        if r.tokens.min() < 0 or r.tokens.max() >= cfg.vocab_size:
            fail(f"request {r.rid}: token ids out of range")
    for c in captures:
        if len(c.seen) != len(c.indices):
            fail(f"no live {c.name} call was captured (calls {c.indices} of {c.calls})")
    if keep is not None:
        keep["results"] = {r.rid: r for r in results}
    decode_tokens = sum(len(r.tokens) - 1 for r in results)
    summary = {
        "requests": len(results), "prompt_lengths": [len(p) for p in prompts],
        "decode_steps": stats["decode_steps"], "launches": launches,
        "prefill_ms_per_request": [round(r.prefill_s * 1e3, 3) for r in results],
        "decode_tok_per_s": decode_tokens / stats["decode_s"],
        "wall_s": wall, "max_memory_allocated_gb": peak / 1e9,
        "waited_for_pages": stats["waited_for_pages"],
        "page_wait_steps": stats["page_wait_steps"],
    }
    if "pool" in stats:
        summary["pool"] = stats["pool"].as_dict()
    if "prefix" in stats:
        summary["prefix"] = stats["prefix"].as_dict()
        for key in ("prefix_hit_rate", "prefill_toks_saved", "prefix_evictions"):
            summary[key] = stats[key]
    print(f"  served {len(results)} requests, {decode_tokens} decode tokens in "
          f"{stats['decode_steps']} steps: decode {summary['decode_tok_per_s']:.1f} tok/s, "
          f"prefill ms/request {summary['prefill_ms_per_request']}, "
          f"peak memory {summary['max_memory_allocated_gb']:.2f} GB, launches {launches}")
    return summary


def live_check(cap: Capture, plain, label: str, flush, report: dict, bytes_flops,
               rows_of=None, ops_rate: float = F32_FLOPS) -> tuple:
    """Kernel vs plain version on one captured live call's operands, then
    the kernel's and the plain version's times and the call's bound (its
    operations at ``ops_rate``).  (``block_check`` does this for
    ``flash_prefill_block``.)"""
    args, kwargs = cap.args, cap.kwargs
    acc_k, m_k, l_k = cap.real(*args, **kwargs)
    acc_p, m_p, l_p = plain(*args, **kwargs)
    torch.cuda.synchronize()
    rows = slice(None) if rows_of is None else rows_of(args)
    err = max(float((acc_k / l_k[..., None] - acc_p / l_p[..., None])[rows].abs().max()),
              float((m_k - m_p)[rows].abs().max()))
    print(f"  {label}: kernel vs plain max_abs_err={err:.3e} (tol {DECODE_TOL})")
    if not err <= DECODE_TOL:
        fail(f"live {label} disagrees with its plain version: {err}")
    report["err"] = max(report.get("err", 0.0), err)
    ms = time_ms(lambda: cap.real(*args, **kwargs), 50, flush)
    plain_ms = time_ms(lambda: plain(*args, **kwargs), 5, flush)
    nbytes, flops = bytes_flops(args, kwargs)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / ops_rate * 1e3
    bound = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
          f"({by}, {nbytes / 1e6:.2f} MB)")
    return ms, plain_ms, bound, by


DECODE_NAMES = ["q", "k_packed", "k_scale", "k_zero", "v_packed", "v_scale", "v_zero", "n_comp"]


def decode_call_bytes_flops(args, kwargs):
    ops_ = dict(zip(DECODE_NAMES, args)) | {k: v for k, v in kwargs.items()
                                            if isinstance(v, torch.Tensor)}
    n_comp = args[7]
    if not isinstance(n_comp, torch.Tensor):
        n_comp = torch.full((args[0].shape[0],), int(n_comp), dtype=torch.int32)
    nbytes, flops = decode_bytes_flops(ops_, n_comp, kwargs["chunk"])
    if len(args) > 8:                                # block tables
        nbytes += args[8].numel() * 4
    return nbytes, flops


def serving(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 1: monolithic prefill, dense layout."""
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_ref
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("gear_kcvt4")
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=CAP_SERVE, policy=pol),
                 device=DEV)
    # layer 0 of decode step 40 (all 4 slots live)
    cap = Capture(ops, "gear_decode", 40 * layers)
    summary = drive(eng, cfg, requests(cfg), [cap])
    launches, steps = summary["launches"], summary["decode_steps"]
    if launches["flash_prefill"] != N_REQUESTS * layers:
        fail(f"flash_prefill launches {launches['flash_prefill']} != 8 prefills x {layers}")
    if launches["gear_decode"] < steps * layers:
        fail(f"gear_decode launches {launches['gear_decode']} < {steps} steps x {layers}")
    print(f"  live layer-0 step: n_comp per slot "
          f"{[int(x) for x in cap.args[7][::cfg.num_kv_heads]]}")
    rep = reports["gear_decode"]
    rep["ms"], rep["plain_ms"], rep["bound_ms"], rep["bound_by"] = live_check(
        cap, gear_decode_ref, "gear_decode live decode step", flush, rep,
        decode_call_bytes_flops, rows_of=lambda a: a[7] > 0)
    rep["library_ms"] = None
    timer_check(lambda: cap.real(*cap.args, **cap.kwargs), "gear_decode live decode step", flush,
                rep)
    reports["gear_decode"]["launches_by_path"] = {"monolithic_dense": launches["gear_decode"]}
    reports["flash_prefill"]["launches_by_path"] = {"monolithic_dense": launches["flash_prefill"]}
    summary["layers"] = layers
    profile(eng, cfg, HERE / "build" / "profile", "monolithic_dense")
    return summary


def serving_paged(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 2: streaming prefill into the paged pool."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_history_ref, gear_decode_paged_ref
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("gear_kcvt4")
    dense_pages = B_SERVE * (CAP_SERVE // pol.buffer_size)
    pool_pages = dense_pages * 2 // 3 + 1
    eng = Engine(model, params, EngineConfig(
        batch=B_SERVE, capacity=CAP_SERVE, policy=pol, prefill_mode="streaming", layout="paged",
        pool_pages=pool_pages), device=DEV)
    prompts = requests(cfg)
    lengths = [len(p) for p in prompts]
    print(f"  pool: {pool_pages - 1} allocatable pages of {eng.pool.page_bytes / 1e6:.3f} MB "
          f"(the dense layout holds {dense_pages}); lifetime pages per request "
          f"{[-(-(int(n) + NEW_TOKENS - 1) // pol.buffer_size) for n in lengths]}")
    # request 0, layer 0: the K (call 0) and the V (call 1) compression event
    caps = {"gear_compress": Capture(cache_lib, "gear_compress", 0, 1),
            "flash_prefill_block": Capture(ops, "flash_prefill_block", 0),
            # request 0, layer 0: the history call of its last block (largest extent)
            # request 0, layer 0: every in-flight block's history in one launch
            "gear_decode": Capture(ops, "gear_decode_history", 0),
            "gear_decode_paged": Capture(ops, "gear_decode_paged", 40 * layers)}
    summary = drive(eng, cfg, prompts, list(caps.values()))
    launches, steps = summary["launches"], summary["decode_steps"]
    for name, least in (("gear_compress", 2 * N_REQUESTS * layers),
                        ("flash_prefill_block", N_REQUESTS * layers),
                        ("gear_decode", N_REQUESTS * layers),
                        ("gear_decode_paged", steps * layers)):
        if launches[name] < least:
            fail(f"{name} launches {launches[name]} < {least} on the streaming + paged path")
    if launches["gear_decode"] != N_REQUESTS * layers:
        fail(f"gear_decode launches {launches['gear_decode']} != 8 prefills x {layers}: the "
             f"history of a layer's in-flight blocks is one launch")
    if summary["waited_for_pages"] < 1:
        fail("no decode step ran while a request waited for pages; the pool is not under pressure")
    print(f"  {summary['waited_for_pages']} requests waited for pages, over "
          f"{summary['page_wait_steps']} decode steps; pool {summary['pool']}")
    eng.pool.check()

    c = caps["gear_compress"]
    rep = reports["gear_compress"]
    for index, kind, scheme in ((0, "K", "per_channel"), (1, "V", "per_token")):
        (x, *_), kw = c.seen[index]
        print(f"  live gear_compress {kind} call: {tuple(x.shape)} tiles, {kw}")
        if kw["scheme"] != scheme:
            fail(f"gear_compress call {index} is not the {kind} event ({kw['scheme']})")
        label = f"live layer-0 {kind} event"
        compress_check(x, kw, label, rep)
        row = compress_time(x, kw, label, flush, rep)
        suffix = "" if kind == "K" else "_v"
        rep.update({f"ms{suffix}": row["ms_c1"], f"plain_ms{suffix}": row["plain_ms"],
                    f"bound_ms{suffix}": row["bound_ms"], f"bound_by{suffix}": row["bound_by"]})
    rep["library_ms"] = None

    c = caps["flash_prefill_block"]
    rep = reports["flash_prefill_block"]
    print(f"  live flash_prefill_block call: q {tuple(c.args[0].shape)}, kv_repeat "
          f"{c.kwargs['kv_repeat']}, kv_len in [{int(c.args[3].min())}, {int(c.args[3].max())}]")
    row = block_check(c.real, c.args, c.kwargs, "flash_prefill_block live layer-0 blocks", flush,
                      rep, library=True)
    rep.update(ms=row["ms_c1"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
               bound_by=row["bound_by"], library_ms=row["library_ms"],
               library_note=row["library_note"])

    c = caps["gear_decode"]
    rep = reports["gear_decode"]
    BH, NB, R, _ = c.args[0].shape
    print(f"  live history call (request 0, layer 0): q {tuple(c.args[0].shape)}, extents "
          f"{list(c.args[7])}")
    rep["ms_history"], rep["plain_ms_history"], rep["bound_ms_history"], _ = live_check(
        c, gear_decode_history_ref, f"gear_decode_history live layer-0 history ({NB} blocks x "
        f"{R} query rows, one launch)", flush, rep, history_call_bytes_flops,
        rows_of=lambda a: (torch.as_tensor(list(a[7]), device=DEV) > 0)[None, :, None].expand(
            BH, NB, R), ops_rate=BF16_FLOPS)
    rep["ms_history_per_layer"] = rep["ms_history"]

    c = caps["gear_decode_paged"]
    rep = reports["gear_decode_paged"]
    print(f"  live paged layer-0 step: n_comp per slot "
          f"{[int(x) for x in c.args[7][::cfg.num_kv_heads]]}, block tables "
          f"{c.args[8].tolist()}")
    rep["ms"], rep["plain_ms"], rep["bound_ms"], rep["bound_by"] = live_check(
        c, gear_decode_paged_ref, "gear_decode_paged live decode step", flush, rep,
        decode_call_bytes_flops, rows_of=lambda a: a[7] > 0)
    rep["library_ms"] = None

    for name in ("gear_compress", "flash_prefill_block", "gear_decode_paged"):
        reports[name]["launches_by_path"] = {"streaming_paged": launches[name]}
    reports["gear_decode"]["launches_by_path"]["streaming_paged"] = launches["gear_decode"]
    summary["layers"] = layers
    profile(eng, cfg, HERE / "build" / "profile", "streaming_paged")
    return summary


def serving_hybrid(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 3: hymba-1.5b, monolithic prefill, dense layout."""
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_ref
    from repro_torch.models import linear_scan as ls_mod
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("gear_kcvt4")
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=CAP_SERVE, policy=pol),
                 device=DEV)
    prompts = requests(cfg)
    # request 0's layer-0 scan (S = chunk = 859); layer 0 of decode step 40
    caps = {"linear_scan_chunked": Capture(ls_mod, "linear_scan_chunked", 0),
            "gear_decode": Capture(ops, "gear_decode", 40 * layers)}
    summary = drive(eng, cfg, prompts, list(caps.values()))
    launches, steps = summary["launches"], summary["decode_steps"]
    for name, want in (("linear_scan_chunked", N_REQUESTS * layers),
                       ("flash_prefill", N_REQUESTS * layers)):
        if launches[name] != want:
            fail(f"{name} launches {launches[name]} != 8 prefills x {layers} on the hybrid path")
    if launches["gear_decode"] < steps * layers:
        fail(f"gear_decode launches {launches['gear_decode']} < {steps} steps x {layers}")
    print(f"  per prefill: {launches['linear_scan_chunked'] // N_REQUESTS} linear_scan_chunked, "
          f"{launches['flash_prefill'] // N_REQUESTS} flash_prefill; per decode step: "
          f"{launches['gear_decode'] / steps:.1f} gear_decode")

    c = caps["linear_scan_chunked"]
    rep = reports["linear_scan_chunked"]
    r, k, v, lw, u = c.args
    print(f"  live linear_scan_chunked call: r {tuple(r.shape)}, v {tuple(v.shape)}, log_w "
          f"{tuple(lw.shape)}, {c.kwargs}")
    rep["ms"], rep["plain_ms"], rep["bound_ms"], rep["bound_by"] = scan_check(
        c.real, tuple(c.args), c.kwargs, "linear_scan_chunked live layer-0 scan", flush, rep,
        iters=50)
    rep["library_ms"] = None
    rep["launches_by_path"] = {"hybrid_dense": launches["linear_scan_chunked"]}

    c = caps["gear_decode"]
    rep = reports["gear_decode"]
    _, G, Dh = c.args[0].shape
    print(f"  live hymba layer-0 step: q {tuple(c.args[0].shape)}, n_comp per slot "
          f"{[int(x) for x in c.args[7][::cfg.num_kv_heads]]}")
    rep["ms_hymba"], rep["plain_ms_hymba"], rep["bound_ms_hymba"], _ = live_check(
        c, gear_decode_ref, f"gear_decode live hymba decode step (G = {G}, Dh = {Dh})", flush,
        rep, decode_call_bytes_flops, rows_of=lambda a: a[7] > 0)
    reports["gear_decode"]["launches_by_path"]["hybrid_dense"] = launches["gear_decode"]
    reports["flash_prefill"]["launches_by_path"]["hybrid_dense"] = launches["flash_prefill"]
    summary["layers"] = layers
    profile(eng, cfg, HERE / "build" / "profile", "hybrid_dense", prompt_len=659)
    return summary


def serving_rwkv(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 4: rwkv6-3b, monolithic prefill, dense layout; every layer of
    every prefill and decode step is one ``linear_scan_chunked`` launch."""
    from repro_torch.core.policy import named_policy
    from repro_torch.models import linear_scan as ls_mod
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("gear_kcvt4")                  # touches no RWKV layer
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=CAP_SERVE, policy=pol),
                 device=DEV)
    # request 0's layer-0 prefill scan (S = chunk = 859); layer 0 of decode
    # step 40, after the first B_SERVE prefills and before any request ends
    caps = {"prefill": Capture(ls_mod, "linear_scan_chunked", 0),
            "decode": Capture(ls_mod, "linear_scan_chunked", (B_SERVE + 40) * layers)}
    summary = drive(eng, cfg, requests(cfg), list(caps.values()))
    launches, steps = summary["launches"], summary["decode_steps"]
    want = (N_REQUESTS + steps) * layers
    if launches["linear_scan_chunked"] != want:
        fail(f"linear_scan_chunked launches {launches['linear_scan_chunked']} != (8 prefills + "
             f"{steps} steps) x {layers} on the rwkv path")
    others = {k: n for k, n in launches.items() if k != "linear_scan_chunked" and n}
    if others:
        fail(f"kernels other than linear_scan_chunked launched on the rwkv path: {others}")
    if eng.attend_path != "xla":
        fail(f"rwkv engine reports attend path {eng.attend_path!r}, not 'xla'")
    print(f"  {layers} linear_scan_chunked launches per prefill and per decode step "
          f"({launches['linear_scan_chunked']} = (8 + {steps}) x {layers}); attend path "
          f"{eng.attend_path}")
    rep = reports["linear_scan_chunked"]
    for phase, c in caps.items():
        r, k, v, lw, u = c.args
        s0 = c.kwargs.get("state0")
        print(f"  live rwkv {phase} scan: r {tuple(r.shape)}, log_w {tuple(lw.shape)}, chunk "
              f"{c.kwargs['chunk']}, mode {c.kwargs['mode']}, state0 "
              f"{None if s0 is None else tuple(s0.shape)} (max |state0| "
              f"{0.0 if s0 is None else float(s0.abs().max()):.3g})")
        if (phase == "decode") != (s0 is not None and r.shape[1] == 1):
            fail(f"the captured rwkv {phase} scan is not the expected call")
        timed = scan_check(c.real, tuple(c.args), c.kwargs,
                           f"linear_scan_chunked live rwkv layer-0 {phase} scan", flush, rep,
                           iters=50)
        rep.update({f"{key}_rwkv_{phase}": val for key, val in
                    zip(("ms", "plain_ms", "bound_ms", "bound_by"), timed)})
    rep["launches_by_path"]["rwkv_dense"] = launches["linear_scan_chunked"]
    summary["layers"] = layers
    profile(eng, cfg, HERE / "build" / "profile", "rwkv_dense", prompt_len=659)
    return summary


LIVE = {}                    # what a later phase holds against: path 5's tokens
PREFIX_SYSTEM = 512          # path 5: tokens of the shared system prompt (8 chunks)
PREFIX_SUFFIX = (40, 400)    # path 5: raw length range of each request's own suffix
# path 5's pool: two thirds of the dense-equivalent pages (48 allocatable, as
# path 2) cannot force a reclaim, because the trie's byte budget (256 MiB,
# 17 pages of 15.47 MB at full width) leaves 31 pages free on an idle engine
# and no request needs more than 16.  Shrunk by a third, to 32 allocatable
# pages, the trie's retained pages block the queue head on an idle engine
# (the gate below fails unless a reclaim frees pages).
PREFIX_POOL_PAGES = 33
HYBRID_STREAM_TOKENS = 16    # path 6's budget per request, cut from 96 for time


def prefix_requests(cfg) -> list:
    """Path 5's traffic: one 512-token system prompt (8 chunks) shared by the
    8 requests, each followed by its own user suffix of raw length 40-400,
    all from numpy seed 0 (``bench_prefix.py``'s shared-prefix traffic at
    the main path's scale)."""
    rng = np.random.RandomState(0)
    system = rng.randint(0, cfg.vocab_size, size=PREFIX_SYSTEM)
    lengths = rng.randint(PREFIX_SUFFIX[0], PREFIX_SUFFIX[1] + 1, size=N_REQUESTS)
    return [np.concatenate([system, rng.randint(0, cfg.vocab_size, size=n)]).astype(np.int32)
            for n in lengths]


def watch_prefills(eng, keep_index: int) -> dict:
    """Wrap ``eng.prefill_slot``: per prefill (in admission order), the trie
    chunks it hit, the kernel launches it made, its device-synchronized ms
    and its logits; for the ``keep_index``-th prefill also its slot's
    closed-chunk pool pages of every layer (copied)."""
    from repro_torch.core.cache import POOLED_FIELDS

    fns = kernel_fns()
    real = eng.prefill_slot
    nb = eng.ecfg.policy.buffer_size
    rec = {"hits": [], "launches": [], "ms": [], "logits": []}

    def wrapped(batch1, caches, slot, admit=True, reserve_tokens=None):
        index = len(rec["ms"])
        pc = eng.prefix_cache
        h0 = pc.stats["hit_chunks"] if pc is not None else 0
        l0 = {name: fn.launches for name, fn in fns.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = real(batch1, caches, slot, admit=admit, reserve_tokens=reserve_tokens)
        torch.cuda.synchronize()
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["launches"].append({name: fn.launches - l0[name] for name, fn in fns.items()})
        rec["hits"].append(pc.stats["hit_chunks"] - h0 if pc is not None else 0)
        rec["logits"].append(logits.clone())
        if index == keep_index:
            n_closed = int(np.asarray(batch1["tokens"]).shape[1]) // nb
            pages = torch.as_tensor(eng.pool.block_tables[slot, :n_closed].astype(np.int64),
                                    device=DEV)
            rec["chunks"] = [{f: t[pages].clone() for f, t in lyr.tensors().items()
                              if f in POOLED_FIELDS} for lyr in caches]
        return logits, caches

    eng.prefill_slot = wrapped
    return rec


def row_count_check(params) -> dict:
    """Layer 0's row-wise prefill products (``wo``, ``w_gate``, ``w_up``,
    ``w_down``; bf16) on the card: the row counts M (64 to the capacity, by
    64) at which a row of ``x[:, :M] @ W`` is not the same row of the
    capacity-row product bit for bit, printed; and the gate: through
    ``common.rowwise`` a suffix's rows equal the cold product's."""
    from repro_torch.models.common import MIN_GEMM_ROWS, rowwise

    gen = torch.Generator(device=DEV).manual_seed(3)
    out = {}
    for name in ("wo", "w_gate", "w_up", "w_down"):
        w = getattr(params.blocks[0], name)
        x = torch.randn(1, CAP_SERVE, w.shape[0], generator=gen, device=DEV).to(torch.bfloat16)
        cold = x @ w
        out[name] = [m for m in range(64, CAP_SERVE + 1, 64)
                     if not torch.equal(x[:, :m] @ w, cold[:, :m])]
        suffixes = ((512, 576), (512, 832), (1088, 1152), (0, 64))
        bad = [(lo, hi) for lo, hi in suffixes
               if not torch.equal(rowwise(lambda t: t @ w, x[:, lo:hi]), cold[:, lo:hi])]
        print(f"  row counts whose {name} {tuple(w.shape)} rows differ from the {CAP_SERVE}-row "
              f"product's: {out[name]}; rowwise (>= {MIN_GEMM_ROWS} rows) suffixes "
              f"{suffixes} equal the cold rows: {not bad}")
        if bad:
            fail(f"rowwise {name} rows of suffixes {bad} differ from the cold product's")
    return out


def serving_prefix(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 5: the prefix trie on the streaming + paged path (phase 11's
    llama2-7b), against the same engine without it."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_history_ref
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("gear_kcvt4")
    nb = pol.buffer_size
    prompts = prefix_requests(cfg)

    def engine(prefix_cache: bool):
        return Engine(model, params, EngineConfig(
            batch=B_SERVE, capacity=CAP_SERVE, policy=pol, prefill_mode="streaming",
            layout="paged", pool_pages=PREFIX_POOL_PAGES, prefix_cache=prefix_cache), device=DEV)

    rows_differ = row_count_check(params)
    warm = engine(True)
    print(f"  raw prompt lengths {[len(p) for p in prompts]} ({PREFIX_SYSTEM}-token system "
          f"prompt + suffix); pool: {PREFIX_POOL_PAGES - 1} allocatable pages of "
          f"{warm._page_bytes / 1e6:.3f} MB (path 2: {B_SERVE * (CAP_SERVE // nb) * 2 // 3}); "
          f"trie budget {warm.ecfg.prefix_cache_bytes / 2**20:.0f} MiB = "
          f"{warm.ecfg.prefix_cache_bytes // warm._page_bytes} pages")
    reclaims = []
    real_reclaim = warm.reclaim_pages
    warm.reclaim_pages = lambda n: reclaims.append((n, real_reclaim(n))) or reclaims[-1][1]
    rec = watch_prefills(warm, keep_index=1)
    # request 1, layer 0: its K compression event and its in-flight and
    # history calls (request 0 made 2 x 32, 32 and 32 of them before)
    caps = {"gear_compress": Capture(cache_lib, "gear_compress", 2 * layers),
            "flash_prefill_block": Capture(ops, "flash_prefill_block", layers),
            "gear_decode": Capture(ops, "gear_decode_history", layers)}
    kept = {}
    summary = drive(warm, cfg, prompts, list(caps.values()), keep=kept)
    launches, steps = summary["launches"], summary["decode_steps"]
    print(f"  hits per request (admission order): {rec['hits']}; hit rate "
          f"{summary['prefix_hit_rate']:.4f}, prefill tokens saved "
          f"{summary['prefill_toks_saved']}, trie evictions {summary['prefix_evictions']}; "
          f"reclaims (pages asked, freed) {reclaims}; {summary['waited_for_pages']} requests "
          f"waited for pages over {summary['page_wait_steps']} decode steps")
    if rec["hits"][1] != PREFIX_SYSTEM // nb:
        fail(f"request 1 hit {rec['hits'][1]} chunks, not the system prompt's {PREFIX_SYSTEM // nb}")
    if not any(freed > 0 for _, freed in reclaims):
        fail(f"reclaim_pages never freed a page ({reclaims}); the pool is not small enough")
    warm.pool.check()
    audit = warm.audit()
    if not audit["ok"]:
        fail(f"engine audit: {audit['issues'][:5]}")
    print(f"  pool check and engine audit pass with {len(warm.prefix_cache.live_handles())} "
          f"pages retained by the trie; pool {summary['pool']}")
    n1 = len(prompts[1])
    suffix_closed = n1 // nb - rec["hits"][1]
    hit_l = rec["launches"][1]
    want = {"gear_decode": layers, "flash_prefill_block": layers, "flash_prefill": 0,
            "gear_compress": 2 * layers if suffix_closed else 0, "gear_decode_paged": 0}
    got = {name: hit_l[name] for name in want}
    print(f"  request 1's warm prefill ({n1} tokens, {rec['hits'][1]} chunks hit, "
          f"{suffix_closed} closed by its suffix) launched {got}")
    if got != want:
        fail(f"launches of request 1's warm prefill {got} != {want}")
    (x, *_), kw = caps["gear_compress"].seen[caps["gear_compress"].index]
    if kw["scheme"] != "per_channel" or x.shape[0] != cfg.num_kv_heads * suffix_closed:
        fail(f"request 1's layer-0 K event compressed {x.shape[0]} tiles, not "
             f"{cfg.num_kv_heads} heads x {suffix_closed} suffix chunks")
    if launches["gear_decode_paged"] < steps * layers or launches["flash_prefill"]:
        fail(f"gear_decode_paged launches {launches['gear_decode_paged']} < {steps} steps x "
             f"{layers}, or flash_prefill launched ({launches['flash_prefill']})")

    c = caps["gear_decode"]
    rep = reports["gear_decode"]
    ext = [int(e) for e in c.args[7]]
    print(f"  live history call (request 1, layer 0): q {tuple(c.args[0].shape)}, extents {ext}")
    if ext[0] != PREFIX_SYSTEM:
        fail(f"request 1's first suffix block sees {ext[0]} history tokens, not {PREFIX_SYSTEM}")
    BH, NB, R, _ = c.args[0].shape
    rep["ms_history_prefix"], rep["plain_ms_history_prefix"], rep["bound_ms_history_prefix"], _ = (
        live_check(c, gear_decode_history_ref, f"gear_decode_history live warm layer-0 history "
                   f"({NB} suffix blocks x {R} query rows over a {ext[0]}-token cached prefix)",
                   flush, rep, history_call_bytes_flops, ops_rate=BF16_FLOPS))
    c = caps["flash_prefill_block"]
    row = block_check(c.real, c.args, c.kwargs, "flash_prefill_block live warm layer-0 blocks "
                      f"(request 1's {c.args[0].shape[0] // cfg.num_heads} suffix blocks)", flush,
                      reports["flash_prefill_block"], library=True)
    reports["flash_prefill_block"].update(
        ms_prefix=row["ms_c1"], plain_ms_prefix=row["plain_ms"], bound_ms_prefix=row["bound_ms"],
        library_ms_prefix=row["library_ms"])

    # warm == cold: the same requests without the trie
    cold = engine(False)
    rec_c = watch_prefills(cold, keep_index=1)
    kept_c = {}
    summary_c = drive(cold, cfg, prompts, [], keep=kept_c)
    diff = [rid for rid in kept["results"] if not np.array_equal(
        kept["results"][rid].tokens, kept_c["results"][rid].tokens)]
    logits_diff = [rid for rid in range(N_REQUESTS)
                   if not torch.equal(rec["logits"][rid], rec_c["logits"][rid])]
    same_logits = 1 not in logits_diff
    same_chunks = all(torch.equal(a[f], b[f]) for a, b in zip(rec["chunks"], rec_c["chunks"])
                      for f in a)
    print(f"  warm vs cold engine: greedy tokens differ for rids {diff}, prefill logits for rids "
          f"{logits_diff}; request 1's prefill logits bitwise equal {same_logits}; its "
          f"{n1 // nb} closed chunks of all {layers} layers gathered from the pool bitwise "
          f"equal {same_chunks}")
    if diff or not same_logits or not same_chunks:
        fail("the prefix-cache engine differs from the cold engine (ROADMAP §3)")
    LIVE["path5_tokens"] = {rid: r.tokens for rid, r in kept["results"].items()}
    print(f"  prefill ms per request (admission order), warm engine: "
          f"{[round(t, 1) for t in rec['ms']]} (request 0 cold); cold engine: "
          f"{[round(t, 1) for t in rec_c['ms']]}")
    summary.update(prefill_ms_warm_engine=rec["ms"][:N_REQUESTS],
                   prefill_ms_cold_engine=rec_c["ms"], hits_per_request=rec["hits"][:N_REQUESTS],
                   reclaims=list(reclaims),
                   cold_decode_tok_per_s=summary_c["decode_tok_per_s"],
                   launches_warm_prefill_request1=hit_l, layers=layers,
                   gemm_rows_differ=rows_differ)
    for name in ("gear_decode", "flash_prefill_block", "gear_compress", "gear_decode_paged"):
        reports[name]["launches_by_path"]["prefix_paged"] = launches[name]
    profile_warm(warm, prompts, HERE / "build" / "profile", "prefix_paged")
    return summary


def serving_hybrid_streaming(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 6: hymba-1.5b with streaming prefill on the dense layout."""
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_history_ref
    from repro_torch.serving.engine import Engine, EngineConfig

    pol = named_policy("gear_kcvt4")
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=CAP_SERVE, policy=pol,
                                             prefill_mode="streaming"), device=DEV)
    if eng._can_bucket:
        fail("the hybrid engine buckets its prompts; the reference prefills a hybrid unbucketed")
    prompts = requests(cfg)
    # request 0, layer 0: the K (call 0) and the V (call 1) compression event
    # at head_dim 64, its in-flight blocks and its history call
    caps = {"gear_compress": Capture(cache_lib, "gear_compress", 0, 1),
            "flash_prefill_block": Capture(ops, "flash_prefill_block", 0),
            "gear_decode": Capture(ops, "gear_decode_history", 0)}
    rec = watch_prefills(eng, keep_index=-1)
    summary = drive(eng, cfg, prompts, list(caps.values()), new_tokens=HYBRID_STREAM_TOKENS)
    launches, steps = summary["launches"], summary["decode_steps"]
    want = {"flash_prefill_block": layers, "gear_decode": layers, "linear_scan_chunked": layers,
            "flash_prefill": 0, "gear_compress": 2 * layers}
    for i, got_all in enumerate(rec["launches"]):
        got = {name: got_all[name] for name in want}
        if got != want:
            fail(f"hybrid streaming prefill {i} launched {got} != {want}")
    if launches["gear_decode"] != (N_REQUESTS + steps) * layers:
        fail(f"gear_decode launches {launches['gear_decode']} != (8 prefills + {steps} steps) x "
             f"{layers}: one history launch per prefill layer, one decode launch per step layer")
    print(f"  per prefill: {want}; per decode step: {layers} gear_decode "
          f"({launches['gear_decode']} = (8 + {steps}) x {layers})")
    c = caps["gear_compress"]
    rep = reports["gear_compress"]
    for index, kind, scheme in ((0, "K", "per_channel"), (1, "V", "per_token")):
        (x, *_), kw = c.seen[index]
        print(f"  live hymba gear_compress {kind} call: {tuple(x.shape)} tiles, {kw}")
        if kw["scheme"] != scheme or x.shape[-1] != cfg.head_dim:
            fail(f"hymba gear_compress call {index} is not the {kind} event at head_dim "
                 f"{cfg.head_dim} ({kw['scheme']}, {tuple(x.shape)})")
        label = f"live hymba layer-0 {kind} event (head_dim {x.shape[-1]})"
        compress_check(x, kw, label, rep)
        row = compress_time(x, kw, label, flush, rep)
        suffix = "_hymba_k" if kind == "K" else "_hymba_v"
        rep.update({f"ms{suffix}": row["ms_c1"], f"plain_ms{suffix}": row["plain_ms"],
                    f"bound_ms{suffix}": row["bound_ms"]})
    c = caps["flash_prefill_block"]
    print(f"  live flash_prefill_block call: q {tuple(c.args[0].shape)}, kv_repeat "
          f"{c.kwargs['kv_repeat']}")
    row = block_check(c.real, c.args, c.kwargs, "flash_prefill_block live hymba layer-0 blocks "
                      f"(kv_repeat {c.kwargs['kv_repeat']}, Dh {c.args[0].shape[-1]})", flush,
                      reports["flash_prefill_block"], library=True)
    reports["flash_prefill_block"].update(
        ms_hymba=row["ms_c1"], plain_ms_hymba=row["plain_ms"], bound_ms_hymba=row["bound_ms"],
        library_ms_hymba=row["library_ms"])
    c = caps["gear_decode"]
    BH, NB, R, Dh = c.args[0].shape
    print(f"  live hymba history call: q {tuple(c.args[0].shape)} ({R} query rows = "
          f"{cfg.num_heads // cfg.num_kv_heads} heads x 64), extents {list(c.args[7])}")
    rep = reports["gear_decode"]
    (rep["ms_history_hymba"], rep["plain_ms_history_hymba"], rep["bound_ms_history_hymba"],
     _) = live_check(c, gear_decode_history_ref, f"gear_decode_history live hymba layer-0 "
                     f"history ({NB} blocks x {R} query rows, Dh {Dh})", flush, rep,
                     history_call_bytes_flops,
                     rows_of=lambda a: (torch.as_tensor(list(a[7]), device=DEV) > 0)[
                         None, :, None].expand(BH, NB, R), ops_rate=BF16_FLOPS)
    for name in ("flash_prefill_block", "gear_decode", "linear_scan_chunked", "gear_compress"):
        reports[name]["launches_by_path"]["hybrid_streaming"] = launches[name]
    summary.update(layers=layers, prefill_ms_by_admission=rec["ms"][:N_REQUESTS])
    profile(eng, cfg, HERE / "build" / "profile", "hybrid_streaming", prompt_len=659)
    return summary


def watch_waves(eng) -> dict:
    """Wrap ``eng.prefill`` and ``eng.generate``: per wave, the prefill's
    kernel launches and logits and ``generate``'s stats."""
    fns = kernel_fns()
    real_prefill, real_generate = eng.prefill, eng.generate
    rec = {"launches": [], "logits": [], "stats": []}

    def prefill(batch):
        l0 = {name: fn.launches for name, fn in fns.items()}
        logits, caches = real_prefill(batch)
        rec["launches"].append({name: fn.launches - l0[name] for name, fn in fns.items()})
        rec["logits"].append(logits.clone())
        return logits, caches

    def generate(*args, **kwargs):
        toks, stats = real_generate(*args, **kwargs)
        rec["stats"].append(stats)
        return toks, stats

    eng.prefill, eng.generate = prefill, generate
    return rec


def serving_wave(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 7: wave mode (``Scheduler.run`` / ``Engine.generate``) on phase
    10's llama2-7b: monolithic prefill of a whole wave at batch 4, dense
    layout, lockstep decode."""
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_prefill_ref, gear_decode_ref
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.scheduler import Request, Scheduler, _pad

    pol = named_policy("gear_kcvt4")
    eng = Engine(model, params, EngineConfig(batch=B_SERVE, capacity=CAP_SERVE, policy=pol),
                 device=DEV)
    prompts = requests(cfg)
    waves = [list(range(w, w + B_SERVE)) for w in range(0, N_REQUESTS, B_SERVE)]
    pads = [max(len(prompts[r]) for r in wave) for wave in waves]
    padded = [np.stack([_pad(prompts[r], pad) for r in wave]) for wave, pad in zip(waves, pads)]
    rec = watch_waves(eng)
    # wave 0's layer-0 attention (BHq = 4 x 32 = 128 rows); layer 0 of its decode step 40
    caps = {"flash_prefill": Capture(ops, "flash_prefill", 0),
            "gear_decode": Capture(ops, "gear_decode", 40 * layers)}
    sched = Scheduler(eng)
    for rid, toks in enumerate(prompts):
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=NEW_TOKENS))
    fns = kernel_fns()
    torch.cuda.reset_peak_memory_stats()
    try:
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        results = sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in fns.items()}
    finally:
        for c in caps.values():
            c.restore()
        del eng.prefill, eng.generate
    peak = torch.cuda.max_memory_allocated()
    if len(results) != N_REQUESTS or any(str(r.status) != "ok" or len(r.tokens) != NEW_TOKENS
                                         for r in results):
        fail(f"wave results: {[(r.rid, str(r.status), len(r.tokens)) for r in results]}")
    if sorted(r.rid for r in results) != list(range(N_REQUESTS)):
        fail(f"wave results' rids {[r.rid for r in results]}")
    for r in results:
        if r.tokens.min() < 0 or r.tokens.max() >= cfg.vocab_size:
            fail(f"request {r.rid}: token ids out of range")
    steps = len(waves) * (NEW_TOKENS - 1)
    per_wave = [lw["flash_prefill"] for lw in rec["launches"]]
    if per_wave != [layers] * len(waves) or launches["flash_prefill"] != len(waves) * layers:
        fail(f"flash_prefill launches per wave prefill {per_wave} != {layers} each")
    if launches["gear_decode"] != steps * layers:
        fail(f"gear_decode launches {launches['gear_decode']} != {steps} steps x {layers}")
    for c in caps.values():
        if len(c.seen) != len(c.indices):
            fail(f"no live {c.name} call was captured (calls {c.indices} of {c.calls})")
    prefill_s = [st["prefill_s"] for st in rec["stats"]]
    tok_s = [st["decode_tok_per_s"] for st in rec["stats"]]
    print(f"  {len(waves)} waves left-padded to {pads} tokens: prefill s per wave "
          f"{[round(t, 3) for t in prefill_s]}, decode tok/s per wave "
          f"{[round(t, 1) for t in tok_s]}, wall {wall:.1f} s, peak memory {peak / 1e9:.2f} GB; "
          f"launches {launches} ({layers} flash_prefill per wave prefill, {layers} gear_decode "
          f"per step over {steps} steps)")

    # the live BHq-128 flash_prefill call against its plain version, timed beside SDPA
    c = caps["flash_prefill"]
    (q, k, v), kw = c.args, c.kwargs
    BH, S, Dh = q.shape
    rep = reports["flash_prefill"]
    if (BH, S) != (B_SERVE * cfg.num_heads, pads[0]):
        fail(f"the captured flash_prefill call is [{BH}, {S}, {Dh}], not wave 0's layer 0")
    o_k, o_p = c.real(q, k, v, **kw), flash_prefill_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((o_k.float() - o_p.float()).abs().max())
    print(f"  flash_prefill live wave layer-0 call (BHq {BH}, S {S}, Dh {Dh}, {kw}): kernel vs "
          f"plain max_abs_err={err:.3e} (tol {PREFILL_TOL})")
    if not err <= PREFILL_TOL:
        fail(f"live wave flash_prefill disagrees with its plain version: {err}")
    rep["err"] = max(rep.get("err", 0.0), err)
    rep_k = kw.get("kv_repeat", 1)
    qs, ks, vs = q[None], k[None].repeat_interleave(rep_k, 1), v[None].repeat_interleave(rep_k, 1)
    ms = time_ms(lambda: c.real(q, k, v, **kw), 20, flush)
    plain = time_ms(lambda: flash_prefill_ref(q, k, v, **kw), 3, flush)
    lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, is_causal=True), 20, flush)
    nbytes, flops = flash_bytes_flops(S, BH, rep_k, Dh)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    rep.update(ms_wave=ms, plain_ms_wave=plain, library_ms_wave=lib,
               bound_ms_wave=max(t_bytes, t_ops),
               bound_by_wave="operations" if t_ops >= t_bytes else "bytes")
    print(f"  flash_prefill live wave call: kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA "
          f"{lib:.4f} ms, bound {rep['bound_ms_wave']:.4f} ms ({rep['bound_by_wave']})")

    # the live decode step's layer-0 cache against the plain version
    c = caps["gear_decode"]
    print(f"  live wave layer-0 step: q {tuple(c.args[0].shape)}, n_comp per slot "
          f"{[int(x) for x in c.args[7][::cfg.num_kv_heads]]}")
    rep = reports["gear_decode"]
    rep["ms_wave"], rep["plain_ms_wave"], rep["bound_ms_wave"], _ = live_check(
        c, gear_decode_ref, "gear_decode live wave decode step", flush, rep,
        decode_call_bytes_flops, rows_of=lambda a: a[7] > 0)

    # batch 4 computes what batch 1 does: each wave row's last-position
    # prefill logits against a batch-1 prefill of the same padded prompt, bit
    # for bit (every GEMM of the prefill gives a row the same bits at 859 and
    # 4 x 859 rows on the H100; a row that reads another row or a shifted
    # mask would not)
    row_err, equal_rows = 0.0, 0
    for w, rows in enumerate(padded):
        for i in range(B_SERVE):
            one, _ = eng.prefill({"tokens": rows[i:i + 1]})
            diff = float((one[0].float() - rec["logits"][w][i].float()).abs().max())
            row_err = max(row_err, diff)
            equal_rows += int(torch.equal(one[0], rec["logits"][w][i]))
    print(f"  wave rows vs batch-1 prefills of the same padded prompts: last-position logits "
          f"max_abs_err={row_err:.4e}; {equal_rows} of {N_REQUESTS} rows bit for bit")
    if equal_rows != N_REQUESTS:
        fail(f"a batch-{B_SERVE} wave row differs from its batch-1 prefill by {row_err}")
    reports["flash_prefill"]["launches_by_path"]["wave_dense"] = launches["flash_prefill"]
    reports["gear_decode"]["launches_by_path"]["wave_dense"] = launches["gear_decode"]
    torch.cuda.synchronize()
    profile_window(lambda: eng.prefill({"tokens": padded[0]}), HERE / "build" / "profile",
                   "wave_dense", "prefill")
    return {"layers": layers, "wave_pads": pads, "prefill_s_per_wave": prefill_s,
            "decode_tok_per_s_per_wave": tok_s, "decode_steps": steps, "launches": launches,
            "wall_s": wall, "max_memory_allocated_gb": peak / 1e9,
            "row_vs_batch1_max_abs_err": row_err, "rows_bit_equal": equal_rows}


# path 8's fault schedule: each site fires once, at a visit every run reaches
# (admissions, splice attempts and guarded prefills number at least 8, decode
# steps and scheduler iterations hundreds)
RESILIENCE_EVENTS = (("pool_exhausted", 1), ("prefill_error", 2), ("nan_chunk", 3),
                     ("decode_error", 10), ("trie_evict", 20))


def serving_resilience(model, params, cfg, layers: int, flush, reports: dict) -> dict:
    """Path 8: path 5's engine and traffic with telemetry on and a seeded
    fault injector on a fake clock; every request that completes gives path
    5's tokens bit for bit."""
    from repro_torch.core.policy import named_policy
    from repro_torch.serving import (Engine, EngineConfig, FakeClock, FaultEvent, FaultInjector,
                                     ObsConfig, Request, RetryPolicy, Scheduler)

    pol = named_policy("gear_kcvt4")
    clock = FakeClock()
    eng = Engine(model, params, EngineConfig(
        batch=B_SERVE, capacity=CAP_SERVE, policy=pol, prefill_mode="streaming", layout="paged",
        pool_pages=PREFIX_POOL_PAGES, prefix_cache=True, obs=ObsConfig()), device=DEV,
        clock=clock)
    inj = FaultInjector(seed=0, clock=clock,
                        schedule=[FaultEvent(site, at) for site, at in RESILIENCE_EVENTS])
    sched = Scheduler(eng, faults=inj, retry=RetryPolicy(max_attempts=3))
    prompts = prefix_requests(cfg)
    for rid, toks in enumerate(prompts):
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=NEW_TOKENS))
    fns = kernel_fns()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = sched.run_continuous()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in fns.items()}
    stats = sched.last_stats
    statuses = {r.rid: str(r.status) for r in results}
    print(f"  injector log {inj.log}; statuses {stats['statuses']} "
          f"({dict(sorted(statuses.items()))}); attempts "
          f"{ {r.rid: r.attempts for r in results} }; {stats['decode_steps']} decode steps, "
          f"wall {wall:.1f} s, launches {launches}")
    audit = sched.audit(results)
    if len(results) != N_REQUESTS or not audit["ok"]:
        fail(f"path 8: {len(results)} results, audit {audit['issues'][:5]}")
    missing = [site for site, _ in RESILIENCE_EVENTS if inj.fired[site] < 1]
    if missing:
        fail(f"fault sites that never fired: {missing} (log {inj.log})")
    victims = [r.rid for r in results if str(r.status) == "failed" and "quarantine" in r.error]
    if len(victims) != inj.fired["nan_chunk"]:
        fail(f"nan_chunk fired {inj.fired['nan_chunk']}x but FAILED by quarantine: {victims}")
    done = [r for r in results if str(r.status) in ("ok", "degraded")]
    if len(done) + len(victims) != N_REQUESTS:
        fail(f"unexpected statuses {statuses}")
    want = LIVE["path5_tokens"]
    diff = [r.rid for r in done if not np.array_equal(r.tokens, want[r.rid])]
    if diff:
        fail(f"completed requests {diff} differ from path 5's tokens")
    cov = eng.obs.tracer.coverage(range(N_REQUESTS))
    if not cov["complete"] or cov["statuses"] != statuses:
        fail(f"trace coverage {cov}")
    fired = {s["labels"]["site"]: s["value"]
             for s in eng.obs.registry.get("serving_faults_injected_total").series()}
    if fired != {site: float(n) for site, n in inj.fired.items() if n}:
        fail(f"the metrics count fired sites {fired}, the injector {inj.fired}")
    by_status = {s["labels"]["status"]: s["value"]
                 for s in eng.obs.registry.get("serving_results_total").series()}
    if by_status != {k: float(v) for k, v in stats["statuses"].items()}:
        fail(f"serving_results_total {by_status} != {stats['statuses']}")
    print(f"  one result per rid and the audit pass; the quarantine victim {victims} FAILED; "
          f"{len(done)} completed requests equal path 5's tokens bit for bit; traces complete "
          f"for all {N_REQUESTS} rids; serving_faults_injected_total {fired}")
    for name in ("gear_decode", "flash_prefill_block", "gear_compress", "gear_decode_paged"):
        reports[name]["launches_by_path"]["resilience_paged"] = launches[name]
    return {"layers": layers, "injector_log": inj.log, "statuses": stats["statuses"],
            "attempts": {r.rid: r.attempts for r in results}, "decode_steps": stats["decode_steps"],
            "launches": launches, "wall_s": wall, "faults_metric": fired}


LAUNCHER_RUNS = {
    "wave": ["--arch", "llama2-7b", "--batch", "4", "--prompt", "512", "--gen", "16"],
    "continuous": ["--arch", "llama2-7b", "--batch", "4", "--prompt", "512", "--gen", "16",
                   "--mode", "continuous", "--layout", "paged", "--requests", "8", "--obs",
                   "--metrics-json", "build/serve/metrics.json",
                   "--trace-out", "build/serve/trace.json"],
}
LAUNCHER_LINES = {
    "wave": [r"generated \(4, 16\); prefill [0-9.]+s, decode [0-9.]+s \([0-9.]+ tok/s\), "
             r"cache [0-9.]+ MB"],
    "continuous": [r"served 8 requests \(128 tokens\) in [0-9.]+s; attend=fused layout=paged; "
                   r"pool \d+/\d+ pages used, \d+ shared",
                   r"obs: traces 8/8 rids complete=True",
                   r"obs: metrics snapshot -> build/serve/metrics\.json",
                   r"obs: chrome trace -> build/serve/trace\.json"],
}


def launcher_runs(extra: tuple = ()) -> dict:
    """``python -m repro_torch.launch.serve`` at full width, as a user runs
    it, once in wave mode and once in continuous + paged + telemetry mode;
    each must exit 0 and print the reference launcher's lines, and the
    metrics and trace JSON must parse."""
    import os

    out_dir = HERE / "build" / "serve"
    for f in ("metrics.json", "trace.json"):
        (out_dir / f).unlink(missing_ok=True)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    summary = {}
    for name, argv in LAUNCHER_RUNS.items():
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", *argv, *extra]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=HERE, env=env, capture_output=True, text=True,
                              timeout=600)
        sec = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        print(f"  {' '.join(cmd[1:])}: exit {proc.returncode} in {sec:.1f} s")
        for line in lines:
            print(f"    {line}")
        if proc.returncode != 0:
            fail(f"the launcher ({name}) exited {proc.returncode}: {proc.stderr[-2000:]}")
        want = LAUNCHER_LINES[name]
        if len(lines) != len(want) or not all(re.fullmatch(w, line)
                                              for w, line in zip(want, lines)):
            fail(f"the launcher ({name}) printed {lines}, not {want}")
        summary[name] = {"seconds": sec, "stdout": lines}
    metrics = json.loads((out_dir / "metrics.json").read_text())
    trace = json.loads((out_dir / "trace.json").read_text())
    series = {m["name"]: m["series"] for m in metrics["metrics"]}
    submitted = series["serving_requests_submitted_total"][0]["value"]
    rids = sorted({e["tid"] for e in trace["traceEvents"] if e["name"] == "request"})
    print(f"  metrics JSON ({metrics['schema']}, {len(series)} metrics, {submitted:.0f} "
          f"submitted) and trace JSON ({trace['schema']}, {len(trace['traceEvents'])} events, "
          f"rids {rids}) parse")
    if submitted != 8 or rids != list(range(8)):
        fail(f"the launcher's telemetry counts {submitted} submits, traces rids {rids}")
    return summary



def profile_warm(eng, prompts: list, out_dir: pathlib.Path, tag: str) -> None:
    """A ``torch.profiler`` window over one warm prefill: a new view (fresh
    pool and trie), request 0 seeds the trie, and request 1's prefill (its
    system prompt hit) runs in the window."""
    view = eng.new_view()
    view.prefill_slot({"tokens": prompts[0][None]}, 0, reserve_tokens=len(prompts[0]))
    torch.cuda.synchronize()
    profile_window(lambda: view.prefill_slot({"tokens": prompts[1][None]}, 1,
                                             reserve_tokens=len(prompts[1])),
                   out_dir, tag, "warm_prefill")


def profile(eng, cfg, out_dir: pathlib.Path, tag: str, prompt_len: int = 640) -> None:
    """Where the time goes: ``torch.profiler`` over one ``prompt_len``-token
    prefill and over 8 decode steps of 4 live slots (after warm-up).  Prints
    each window's wall time, device-busy share (summed kernel time / wall)
    and top operators by device time; full tables go to ``out_dir``."""
    rng = np.random.RandomState(1)
    view = eng.new_view()
    prompts = [rng.randint(0, cfg.vocab_size, size=prompt_len).astype(np.int32)[None]
               for _ in range(4)]
    reserve = prompt_len + 16                                # paged: 11 steps' pages
    for s, p in enumerate(prompts):
        view.prefill_slot({"tokens": p}, s, reserve_tokens=reserve)
    pos = np.full(4, prompt_len, np.int32)
    tok = np.zeros((4, 1), np.int32)
    for _ in range(3):                                       # warm-up steps
        view.decode({"tokens": tok}, pos)
        pos += 1
    torch.cuda.synchronize()
    profile_window(lambda: view.prefill_slot({"tokens": prompts[0]}, 0, reserve_tokens=reserve),
                   out_dir, tag, "prefill")
    profile_window(lambda: [view.decode({"tokens": tok}, pos + i) for i in range(8)],
                   out_dir, tag, "decode")


def profile_window(fn, out_dir: pathlib.Path, tag: str, name: str) -> None:
    """One ``torch.profiler`` window over ``fn``: its wall time, device-busy
    share (summed kernel time / wall), launches and top operators by device
    and host time; the full table goes to ``out_dir``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    out_dir.mkdir(parents=True, exist_ok=True)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    n_launch = sum(e.count for e in kernels)
    (out_dir / f"profile_{tag}_{name}.txt").write_text(
        events.table(sort_by="self_device_time_total", row_limit=40) + "\n"
        + events.table(sort_by="cpu_time_total", row_limit=40))
    print(f"  profile {tag} {name}: wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
          f"({100 * busy / wall:.1f}%), {n_launch} kernel launches, profiler on")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.key[:70]:70s} {e.self_device_time_total / 1e3:9.3f} ms x{e.count}")
    for e in sorted(events, key=lambda e: -e.cpu_time_total)[:12]:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            print(f"    host {e.key[:65]:65s} {e.cpu_time_total / 1e3:9.3f} ms x{e.count}")
    print(f"  profiler table in {out_dir / f'profile_{tag}_{name}.txt'}")


def main() -> int:
    global PARENT_SCAN
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32,
                    help="model depth of serving path 1, monolithic + dense (of 32); "
                         "paths 2-4 always run every layer")
    ap.add_argument("--parent-scan", type=pathlib.Path, default=None,
                    help="a parent tree's csrc/linear_scan.cu: build it too and time it in "
                         "turns (parent, this tree, this tree, parent) beside every "
                         "linear_scan_chunked case and live call")
    ap.add_argument("--parent-kernels", type=pathlib.Path, default=None,
                    help="a parent tree's csrc directory: build its flash_prefill_block.cu, "
                         "gear_compress.cu and quant_pack.cu too and time them in turns "
                         "(parent, this tree, this tree, parent) beside every case of phases "
                         "5, 6 and 9 and at phase 11's live calls")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it from the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("[1] environment")
    card = smi()
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"  {card}")

    phase("[2] build")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    parent = None if args.parent_scan is None else start_parent_build(args.parent_scan)
    parents = ({} if args.parent_kernels is None else
               {name: start_parent_build(args.parent_kernels / f"{name}.cu")
                for name in PARENT_SOURCES})
    built = _build.build_all()
    for name, (sec, log) in sorted(built.items()):
        print(f"  {name}: built in {sec:.1f} s; {ptxas_summary(log)}")
    if parent is not None:
        PARENT_SCAN = parent_scan(*parent)
    for name, (proc, lib) in parents.items():
        PARENT_KERNELS[name] = parent_kernel(name, proc, lib)
    print(f"  build wall {time.perf_counter() - t0:.1f} s")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)  # > 50 MB L2
    reports = {
        "gear_decode": {"name": "gear_decode", "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/gear_decode.cu",
                        "replaces": "src/repro/kernels/gear_decode.py:183"},
        "flash_prefill": {"name": "flash_prefill", "route": "cuda",
                          "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
                          "replaces": "src/repro/kernels/flash_prefill.py:101"},
        "gear_compress": {"name": "gear_compress", "route": "cuda",
                          "source": "src/repro_torch/kernels/csrc/gear_compress.cu",
                          "replaces": "src/repro/kernels/gear_compress.py:174"},
        "flash_prefill_block": {"name": "flash_prefill_block", "route": "cuda",
                                "source": "src/repro_torch/kernels/csrc/flash_prefill_block.cu",
                                "replaces": "src/repro/kernels/flash_prefill.py:160"},
        "gear_decode_paged": {"name": "gear_decode_paged", "route": "cuda",
                              "source": "src/repro_torch/kernels/csrc/gear_decode_paged.cu",
                              "replaces": "src/repro/kernels/gear_decode.py:316"},
        "linear_scan_chunked": {"name": "linear_scan_chunked", "route": "cuda",
                                "source": "src/repro_torch/kernels/csrc/linear_scan.cu",
                                "replaces": "src/repro/kernels/linear_scan_kernel.py:94"},
        "quant_pack": {"name": "quant_pack", "route": "cuda",
                       "source": "src/repro_torch/kernels/csrc/quant_pack.cu",
                       "replaces": "src/repro/kernels/quant_pack.py:53"},
    }
    phase("[3] gear_decode vs plain")
    for pol in ("gear_kcvt4", "gear_kivi2"):
        decode_case(pol, flush, reports["gear_decode"])
        decode_case(pol, flush, reports["gear_decode"], H=5, Dh=64, G=5)     # hymba
    history_case(flush, reports["gear_decode"])
    phase("[4] flash_prefill vs plain")
    for i, case in enumerate(FLASH_CASES):
        flash_case(case, flush, reports["flash_prefill"], TIMED_FLASH_CASES.get(i))
    phase("[5] gear_compress vs plain")
    for pol in ("gear_kcvt4", "gear_kivi2"):
        compress_case(pol, flush, reports["gear_compress"])
    phase("[6] flash_prefill_block vs plain")
    for T, rep in ((64, 1), (64, 4), (37, 1)):
        block_case(T, rep, flush, reports["flash_prefill_block"])
    phase("[7] gear_decode_paged vs plain and vs gear_decode")
    for pol in ("gear_kcvt4", "gear_kivi2"):
        paged_case(pol, reports["gear_decode_paged"])

    phase("[8] linear_scan_chunked vs plain")
    for case in SCAN_CASES:
        scan_case(case, flush, reports["linear_scan_chunked"])
    phase("[9] quant_pack through kernels.quantize_chunk vs plain")
    quant_pack_phase(flush, reports["quant_pack"])

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    def build(cfg, full_layers: int):
        model = build_model(cfg)
        t0 = time.perf_counter()
        params = model.init(seed=0, device=DEV)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in params.parameters())
        print(f"  {cfg.name} width (d_model {cfg.d_model}, {cfg.num_heads} heads / "
              f"{cfg.num_kv_heads} kv heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab_size}), depth {cfg.num_layers} of {full_layers}: "
              f"{n_params / 1e9:.2f} B params, init {time.perf_counter() - t0:.1f} s")
        return model, params, cfg

    full = get_config("llama2-7b")
    built_models, summaries = {}, {}
    for num, key, layers, fn, title in (
            (10, "monolithic_dense", args.layers, serving, "monolithic prefill, dense layout"),
            (11, "streaming_paged", full.num_layers, serving_paged,
             "streaming prefill, paged pool"),
            (12, "prefix_paged", full.num_layers, serving_prefix,
             "streaming prefill, paged pool, prefix trie")):
        phase(f"[{num}] serving llama2-7b, gear_kcvt4, {title}, depth {layers}"
              + ("" if layers == full.num_layers else
                 f" (cut from {full.num_layers} by --layers)"))
        if layers not in built_models:
            built_models[layers] = build(dc.replace(full, num_layers=layers), full.num_layers)
        summaries[key] = fn(*built_models[layers], layers, flush, reports)
    built_models.clear()                  # free llama2-7b before hymba's peak is read
    torch.cuda.empty_cache()

    hymba = get_config("hymba-1.5b")
    phase(f"[13] serving hymba-1.5b, gear_kcvt4, monolithic prefill, dense layout, depth "
          f"{hymba.num_layers}")
    built_hymba = build(hymba, hymba.num_layers)
    summaries["hybrid_dense"] = serving_hybrid(*built_hymba, hymba.num_layers, flush, reports)
    phase(f"[14] serving hymba-1.5b, gear_kcvt4, streaming prefill (unbucketed), dense layout, "
          f"depth {hymba.num_layers}, {HYBRID_STREAM_TOKENS} new tokens per request")
    summaries["hybrid_streaming"] = serving_hybrid_streaming(*built_hymba, hymba.num_layers,
                                                             flush, reports)
    del built_hymba
    gc.collect()                          # free hymba before rwkv6-3b's peak is read
    torch.cuda.empty_cache()

    rwkv6 = get_config("rwkv6-3b")
    phase(f"[15] serving rwkv6-3b, monolithic prefill, dense layout (no KV cache), depth "
          f"{rwkv6.num_layers}; {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated before")
    summaries["rwkv_dense"] = serving_rwkv(*build(rwkv6, rwkv6.num_layers), rwkv6.num_layers,
                                           flush, reports)
    gc.collect()                          # free rwkv6-3b before llama2-7b is built again
    torch.cuda.empty_cache()

    phase(f"[16] serving llama2-7b, gear_kcvt4, wave mode (Scheduler.run: monolithic prefill of "
          f"each wave at batch {B_SERVE}, dense layout), depth {args.layers}"
          + ("" if args.layers == full.num_layers else
             f" (cut from {full.num_layers} by --layers)"))
    built_models[args.layers] = build(dc.replace(full, num_layers=args.layers), full.num_layers)
    summaries["wave_dense"] = serving_wave(*built_models[args.layers], args.layers, flush,
                                           reports)
    phase(f"[17] serving llama2-7b, gear_kcvt4, streaming prefill, paged pool, prefix trie, "
          f"telemetry and injected faults, depth {full.num_layers}")
    if full.num_layers not in built_models:
        built_models.clear()
        gc.collect()
        torch.cuda.empty_cache()
        built_models[full.num_layers] = build(full, full.num_layers)
    summaries["resilience_paged"] = serving_resilience(*built_models[full.num_layers],
                                                       full.num_layers, flush, reports)
    built_models.clear()                  # the launcher builds its own model
    gc.collect()
    torch.cuda.empty_cache()
    phase("[18] the launcher, python -m repro_torch.launch.serve, llama2-7b at full width")
    summaries["launcher"] = launcher_runs()

    phase("[19] summary")
    keys = ("name", "route", "source", "replaces", "launches", "err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    for rep in reports.values():
        if "launches_by_path" in rep:
            rep["launches"] = sum(rep["launches_by_path"].values())
    kernels = []
    for rep in reports.values():
        row = {("max_abs_err" if k == "err" else k): rep[k] for k in keys}
        row.update({k: v for k, v in rep.items() if k not in keys})
        kernels.append(row)
    marks = list(PHASE_S.items())
    spans = {name: round(nxt - t, 1) for (name, t), (_, nxt) in zip(marks, marks[1:])}
    print(f"  seconds per phase {spans}; {time.perf_counter() - _T0:.1f} s since the start")
    summaries["phase_seconds"] = spans
    print(json.dumps({"serving": summaries}))
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
