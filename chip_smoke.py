#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--layers N]

Phases, each of which fails the run (non-zero exit) on any error:

1. environment: torch / CUDA versions and the card's name and power limit;
2. build: ``nvcc`` compiles every ``src/repro_torch/kernels/csrc/*.cu``;
3. ``gear_decode`` against its plain PyTorch version at the main path's
   shapes (4 slots, 32 kv heads, head_dim 128, capacity 1152) for
   gear_kcvt4 and gear_kivi2, with ragged extents and a constant
   channel / token whose outlier index is stored twice;
4. ``flash_prefill`` against its plain version (S = 1024, a ragged S = 1000,
   kv_repeat = 4, window + softcap, a bidirectional prefix), with
   ``torch.nn.functional.scaled_dot_product_attention`` timed beside it;
5. serving: llama2-7b at full width (``--layers`` of its 32 layers) with
   random bf16 weights from a seeded generator, gear_kcvt4,
   ``Engine(batch=4, capacity=1152)`` and ``Scheduler.run_continuous`` over 8
   requests; the launch counters must show both kernels on the path, and the
   live layer-0 cache of one decode step is held against the plain version;
   then ``torch.profiler`` windows over one prefill and 8 decode steps say
   where the time goes (tables under ``build/profile/``);
6. summary: one ``{"kernels": [...]}`` JSON line, the card's name and power
   limit, and the final ``{"ok": true, "device": {...}}`` line.

It imports nothing of JAX and nothing of the JAX package.  Without a CUDA
device, or without the repository beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import pathlib
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

DEV = torch.device("cuda")

DECODE_TOL = 1e-3      # merged decode output, kernel vs plain (f32 both; sum order differs)
PREFILL_TOL = 3e-2     # bf16 output; the kernel rounds P to bf16 before P.V


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean device time of ``fn`` with a cold L2: each launch is timed on
    its own between CUDA events, after a write of a buffer larger than L2."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# ---------------------------------------------------------------------------
# gear_decode


TOKEN_ROWS = ("k_packed", "v_packed", "v_scale", "v_zero", "k_a", "v_a", "v_sp_val", "v_sp_idx")
CHUNK_ROWS = ("k_scale", "k_zero", "k_b", "v_b", "k_sp_val", "k_sp_idx")


def decode_bytes_flops(operands: dict, n_comp: torch.Tensor, chunk: int):
    """Least bytes and f32 operations of one ``gear_decode`` call: q and
    n_comp read, (acc, m, l) written, and each live (row, chunk)'s
    compressed fields read once, counted from this call's extents."""
    q = operands["q"]
    BH, G, Dh = q.shape
    live = int(((n_comp.long() + chunk - 1) // chunk).clamp(min=0).sum())
    per_chunk = sum(operands[n][0, :chunk].numel() * operands[n].element_size()
                    for n in TOKEN_ROWS if operands.get(n) is not None)
    per_chunk += sum(operands[n][0, 0].numel() * operands[n].element_size()
                     for n in CHUNK_ROWS if operands.get(n) is not None)
    nbytes = live * per_chunk + q.numel() * 4 + n_comp.numel() * 4 + BH * G * (Dh + 2) * 4
    r = operands["k_a"].shape[-1] if operands.get("k_a") is not None else 0
    flops = live * (4 * chunk * Dh + G * (4 * chunk * Dh + 4 * Dh * r + 4 * chunk * r))
    return nbytes, flops


def pol_half(idx: torch.Tensor) -> int:
    return idx.shape[-1] // 2


def decode_case(policy_name: str, flush, report: dict) -> None:
    from repro_torch.core import cache as cache_lib
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import gear_decode as gd
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_ref

    dev = DEV
    B, H, Dh, cap = 4, 32, 128, 1152
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
    q = torch.randn(B, H, Dh, generator=gen, device=dev)
    BH = B * H
    qf = q.reshape(BH, 1, Dh)
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
    print(f"  gear_decode {policy_name}: merged max_abs_err={err:.3e} (tol {DECODE_TOL}) "
          f"n_comp per slot {[int(x) for x in n_comp[::H]]}, duplicate outlier index "
          f"K={dup_k} V={dup_v}")
    if not err <= DECODE_TOL:
        fail(f"gear_decode {policy_name} disagrees with its plain version: {err}")
    report["err"] = max(report.get("err", 0.0), err)


# ---------------------------------------------------------------------------
# flash_prefill


FLASH_CASES = [
    # (S, BHq, kv_repeat, window, prefix_len, softcap)
    (1024, 32, 1, 0, 0, 0.0),
    (1000, 32, 1, 0, 0, 0.0),
    (1000, 32, 4, 0, 0, 0.0),
    (1000, 32, 1, 256, 0, 30.0),
    (777, 16, 2, 0, 100, 0.0),
]
MAIN_FLASH_CASE = 1          # S = 1000 lies in the main path's prompt range


def flash_case(case, flush, report: dict, main: bool) -> None:
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels.ref import flash_prefill_ref

    S, BH, rep, window, prefix, cap = case
    dev = DEV
    gen = torch.Generator(device=dev).manual_seed(S + rep)
    Dh = 128
    q = torch.randn(BH, S, Dh, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(BH // rep, S, Dh, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(BH // rep, S, Dh, generator=gen, device=dev).to(torch.bfloat16)
    kw = dict(window=window, prefix_len=prefix, softcap=cap, kv_repeat=rep)
    o_k = fp.flash_prefill(q, k, v, **kw)
    o_p = flash_prefill_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((o_k.float() - o_p.float()).abs().max())
    line = (f"  flash_prefill S={S} BHq={BH} kv_repeat={rep} window={window} "
            f"prefix={prefix} softcap={cap}: max_abs_err={err:.3e} (tol {PREFILL_TOL})")
    if not err <= PREFILL_TOL:
        fail(line)
    report["err"] = max(report.get("err", 0.0), err)
    if main:
        ms = time_ms(lambda: fp.flash_prefill(q, k, v, **kw), 20, flush)
        plain = time_ms(lambda: flash_prefill_ref(q, k, v, **kw), 3, flush)
        qs = q[None]
        ks = k[None].repeat_interleave(rep, dim=1)
        vs = v[None].repeat_interleave(rep, dim=1)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True), 20, flush)
        pairs = S * (S + 1) // 2
        flops = 4.0 * pairs * Dh * BH
        nbytes = 2.0 * Dh * S * (2 * BH + 2 * BH // rep)
        t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        report.update(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=max(t_ops, t_bytes),
                      bound_by="operations" if t_ops >= t_bytes else "bytes")
        line += (f" | kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, "
                 f"bound {report['bound_ms']:.4f} ms ({report['bound_by']})")
    print(line)


# ---------------------------------------------------------------------------
# serving


def serving(layers: int, flush, reports: dict) -> dict:
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.core.policy import named_policy
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import gear_decode as gd
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import gear_decode_ref
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.scheduler import Request, Scheduler

    cfg = dc.replace(get_config("llama2-7b"), num_layers=layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=DEV)
    torch.cuda.synchronize()
    print(f"  llama2-7b width (d_model {cfg.d_model}, {cfg.num_heads} heads, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size}), depth {layers} of 32: "
          f"{cfg.param_count() / 1e9:.2f} B params bf16, init {time.perf_counter() - t0:.1f} s")
    pol = named_policy("gear_kcvt4")
    eng = Engine(model, params, EngineConfig(batch=4, capacity=1152, policy=pol), device=DEV)
    sched = Scheduler(eng)
    rng = np.random.RandomState(0)
    lengths = rng.randint(300, 901, size=8)
    for rid, n in enumerate(lengths):
        sched.submit(Request(rid=rid, tokens=rng.randint(0, cfg.vocab_size, size=n)
                             .astype(np.int32), max_new_tokens=96))

    # hold one decode step's live layer-0 operands for the plain-version check
    captured = {}
    real = ops.gear_decode
    target_call = 40 * layers            # layer 0 of decode step 40 (all 4 slots live)
    calls = [0]

    def capturing(*args, **kwargs):
        if calls[0] == target_call:
            captured["args"] = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
            captured["kwargs"] = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                                  for k, v in kwargs.items()}
        calls[0] += 1
        return real(*args, **kwargs)

    ops.gear_decode = capturing
    torch.cuda.reset_peak_memory_stats()
    try:
        gd.gear_decode.launches = 0
        fp.flash_prefill.launches = 0
        t0 = time.perf_counter()
        results = sched.run_continuous()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"gear_decode": gd.gear_decode.launches,
                    "flash_prefill": fp.flash_prefill.launches}
    finally:
        ops.gear_decode = real
    stats = sched.last_stats
    peak = torch.cuda.max_memory_allocated()

    if len(results) != 8 or any(str(r.status) != "ok" or len(r.tokens) != 96 for r in results):
        fail(f"serving results: {[(r.rid, str(r.status), len(r.tokens)) for r in results]}")
    for r in results:
        if r.tokens.min() < 0 or r.tokens.max() >= cfg.vocab_size:
            fail(f"request {r.rid}: token ids out of range")
    steps = stats["decode_steps"]
    if launches["flash_prefill"] != 8 * layers:
        fail(f"flash_prefill launches {launches['flash_prefill']} != 8 prefills x {layers}")
    if launches["gear_decode"] < steps * layers:
        fail(f"gear_decode launches {launches['gear_decode']} < {steps} steps x {layers}")
    if "args" not in captured:
        fail("no live decode step was captured")

    # live layer-0 operands: kernel vs plain version on rows with history
    args, kwargs = captured["args"], captured["kwargs"]
    acc_k, m_k, l_k = gd.gear_decode(*args, **kwargs)
    acc_p, m_p, l_p = gear_decode_ref(*args, **kwargs)
    live = args[7] > 0
    err = float((acc_k / l_k[..., None] - acc_p / l_p[..., None])[live].abs().max())
    err = max(err, float((m_k - m_p)[live].abs().max()))
    print(f"  live layer-0 step: n_comp per slot {[int(x) for x in args[7][::cfg.num_kv_heads]]}, "
          f"kernel vs plain max_abs_err={err:.3e} (tol {DECODE_TOL})")
    if not err <= DECODE_TOL:
        fail(f"live gear_decode disagrees with its plain version: {err}")
    rep = reports["gear_decode"]
    rep["err"] = max(rep.get("err", 0.0), err)
    rep["ms"] = time_ms(lambda: gd.gear_decode(*args, **kwargs), 50, flush)
    rep["plain_ms"] = time_ms(lambda: gear_decode_ref(*args, **kwargs), 5, flush)
    names = ["q", "k_packed", "k_scale", "k_zero", "v_packed", "v_scale", "v_zero", "n_comp"]
    op_args = dict(zip(names, args)) | {k: v for k, v in kwargs.items()
                                        if isinstance(v, torch.Tensor)}
    nbytes, flops = decode_bytes_flops(op_args, args[7], kwargs["chunk"])
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    rep.update(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
               library_ms=None)
    print(f"  gear_decode live step: kernel {rep['ms']:.4f} ms, plain {rep['plain_ms']:.4f} ms, "
          f"bound {rep['bound_ms']:.4f} ms ({rep['bound_by']}, {nbytes / 1e6:.2f} MB)")

    decode_tokens = sum(len(r.tokens) - 1 for r in results)
    summary = {
        "requests": len(results), "prompt_lengths": [int(x) for x in lengths],
        "decode_steps": steps, "launches": launches,
        "prefill_ms_per_request": [round(r.prefill_s * 1e3, 3) for r in results],
        "decode_tok_per_s": decode_tokens / stats["decode_s"],
        "wall_s": wall, "max_memory_allocated_gb": peak / 1e9, "layers": layers,
    }
    print(f"  served {len(results)} requests, {decode_tokens} decode tokens in {steps} steps: "
          f"decode {summary['decode_tok_per_s']:.1f} tok/s, prefill ms/request "
          f"{summary['prefill_ms_per_request']}, "
          f"peak memory {summary['max_memory_allocated_gb']:.2f} GB, "
          f"launches {launches}")
    reports["gear_decode"]["launches"] = launches["gear_decode"]
    reports["flash_prefill"]["launches"] = launches["flash_prefill"]
    profile(eng, cfg, HERE / "build" / "profile")
    return summary


def profile(eng, cfg, out_dir: pathlib.Path) -> None:
    """Where the time goes: ``torch.profiler`` over one 640-token prefill and
    over 8 decode steps of 4 live slots (after warm-up).  Prints each
    window's wall time, device-busy share (summed kernel time / wall) and
    top operators by device time; full tables go to ``out_dir``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    rng = np.random.RandomState(1)
    view = eng.new_view()
    prompts = [rng.randint(0, cfg.vocab_size, size=640).astype(np.int32)[None] for _ in range(4)]
    for s, p in enumerate(prompts):
        view.prefill_slot({"tokens": p}, s)
    pos = np.full(4, 640, np.int32)
    tok = np.zeros((4, 1), np.int32)
    for _ in range(3):                                       # warm-up steps
        view.decode({"tokens": tok}, pos)
        pos += 1
    torch.cuda.synchronize()
    out_dir.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    windows = {
        "prefill": lambda: view.prefill_slot({"tokens": prompts[0]}, 0),
        "decode": lambda: [view.decode({"tokens": tok}, pos + i) for i in range(8)],
    }
    for name, fn in windows.items():
        with torch_profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        n_launch = sum(e.count for e in kernels)
        (out_dir / f"profile_{name}.txt").write_text(
            events.table(sort_by="self_device_time_total", row_limit=40) + "\n"
            + events.table(sort_by="cpu_time_total", row_limit=40))
        print(f"  profile {name}: wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
              f"({100 * busy / wall:.1f}%), {n_launch} kernel launches, profiler on")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"    {e.key[:70]:70s} {e.self_device_time_total / 1e3:9.3f} ms x{e.count}")
        for e in sorted(events, key=lambda e: -e.cpu_time_total)[:12]:
            if e.device_type != torch.autograd.DeviceType.CUDA:
                print(f"    host {e.key[:65]:65s} {e.cpu_time_total / 1e3:9.3f} ms x{e.count}")
    print(f"  profiler tables in {out_dir}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=32, help="model depth to serve (of 32)")
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

    print("[1] environment")
    card = smi()
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"  {card}")

    print("[2] build")
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all()
    for name, (sec, log) in sorted(built.items()):
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"  {name}: built in {sec:.1f} s; " + " | ".join(regs))
    print(f"  build wall {time.perf_counter() - t0:.1f} s")

    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)  # > 50 MB L2
    reports = {
        "gear_decode": {"name": "gear_decode", "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/gear_decode.cu",
                        "replaces": "src/repro/kernels/gear_decode.py:138"},
        "flash_prefill": {"name": "flash_prefill", "route": "cuda",
                          "source": "src/repro_torch/kernels/csrc/flash_prefill.cu",
                          "replaces": "src/repro/kernels/flash_prefill.py:80"},
    }
    print("[3] gear_decode vs plain")
    for pol in ("gear_kcvt4", "gear_kivi2"):
        decode_case(pol, flush, reports["gear_decode"])
    print("[4] flash_prefill vs plain")
    for i, case in enumerate(FLASH_CASES):
        flash_case(case, flush, reports["flash_prefill"], main=i == MAIN_FLASH_CASE)
    print(f"[5] serving llama2-7b, gear_kcvt4, depth {args.layers}")
    summary = serving(args.layers, flush, reports)

    print("[6] summary")
    keys = ("name", "route", "source", "replaces", "launches", "err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kernels = []
    for rep in reports.values():
        row = {("max_abs_err" if k == "err" else k): rep[k] for k in keys}
        kernels.append(row)
    print(json.dumps({"serving": summary}))
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
