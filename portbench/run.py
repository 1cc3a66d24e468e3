#!/usr/bin/env python3
"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload minicpm-2b.batch-decode \
        --seed 1234 --seconds 40 --trace 0

From the checkout's root.  Set-up makes the weights on the card from the
seed, builds the engine, warms up every shape the cell's traffic uses (the
first run in a checkout also builds the CUDA kernels) and ends where the
measured window starts.  The window runs whole waves of
``Engine.generate`` (:mod:`portbench.traffic`).  After it, a sample of the
served requests goes through the plain reference (:mod:`portbench.check`).
The last line of standard output is one JSON object; the numbers compared
for ``correct`` are also the last lines of standard error.

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` runs the
same window under the profiler and reports its per-layer metrics, each read
by ``portbench/metrics/<name>.py``, with the device's busy time and a
breakdown.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench-cache"
# fixed cache paths inside the checkout: only a checkout's first run builds
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["USE_FLAX"] = "0"
# one host thread for PyTorch's CPU pool: the served path is host-bound, and idle pool
# threads spinning beside the dispatching thread slow it by 8-27% and widen its spread
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, spec, traffic as traffic_lib, weights as weights_lib  # noqa: E402
from portbench.metrics import reader  # noqa: E402
from portbench.trace import HostMarks, device_profile, reduce  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is, whole,
    one of :data:`FORBIDDEN`: ``repro_torch`` is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader sees of a traced run."""

    model: dict
    traffic: dict
    waves: list
    window_s: float
    marks: HostMarks
    events: list
    reduced: dict | None


def program_config(model: dict):
    """The program's ``ModelConfig`` from the configuration file's ``model``."""
    from repro_torch.configs.base import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in model.items() if k in names})


def program_policy(policy: dict):
    """The program's policy of that name, checked field by field against the
    traffic file's description, which the reference follows."""
    from repro_torch.core.policy import named_policy

    pol = named_policy(policy["name"])
    have = {"bits": pol.bits, "k_group": pol.scheme_for("k")[1],
            "v_group": pol.scheme_for("v")[1], "sparsity": pol.sparsity, "rank": pol.rank,
            "rank_decode": pol.rank_decode, "power_iters": pol.power_iters,
            "chunk": pol.buffer_size, "stat_dtype": pol.stat_dtype,
            "lowrank": pol.use_lowrank, "sparse": pol.use_sparse}
    if pol.scheme_for("k")[0] != "per_channel" or pol.scheme_for("v")[0] != "per_token":
        raise ValueError(f"policy {policy['name']}: the reference takes per-channel K and "
                         "per-token V stats")
    diff = {k: (v, policy[k]) for k, v in have.items() if policy[k] != v}
    if diff:
        raise ValueError(f"policy {policy['name']} differs from the traffic file: {diff}")
    return pol


def build_engine(cell: dict, params, device):
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Engine, EngineConfig

    t = cell["traffic"]
    ecfg = EngineConfig(batch=t["batch"], capacity=t["capacity"],
                        policy=program_policy(t["policy"]), prefill_mode=t["prefill_mode"],
                        layout=t["layout"], eos_id=-1)
    return Engine(Model(params.cfg), params, ecfg, device=device)


def warm_up(engine, cell: dict, vocab: int, device) -> None:
    """Every shape the window uses: a wave's prefill at the cell's batch and
    prompt and its first decode steps; where the waves close chunks while
    they decode, a batch-1 close (each slot closes alone at batch 1)."""
    t = cell["traffic"]
    warm = traffic_lib.prompts(t, vocab, seed=0, wave=0)
    engine.generate({"tokens": warm}, min(3, t["new_tokens"]))
    if traffic_lib.closing_steps(t):
        nb = t["policy"]["chunk"]
        engine.generate({"tokens": warm[:1, :nb - 1]}, 2)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def traced_generate(engine, cell: dict, marks: HostMarks):
    """``generate`` with the harness's host ranges around each call into
    the engine: the wave, its prefill, and each decode step (the step in
    which every slot closes a chunk as ``decode_close``)."""
    closes = set(traffic_lib.closing_steps(cell["traffic"]))
    prefill, decode = engine.prefill, engine.decode
    step = [0]

    def wrapped_prefill(batch):
        with marks.span("prefill", 1):
            return prefill(batch)

    def wrapped_decode(token_batch, caches, pos, lengths=None):
        name = "decode_close" if step[0] in closes else "decode"
        step[0] += 1
        with marks.span(name, 1):
            return decode(token_batch, caches, pos, lengths)

    engine.prefill, engine.decode = wrapped_prefill, wrapped_decode

    def generate(tokens, n):
        step[0] = 0
        with marks.span("generate", 0):
            return engine.generate({"tokens": tokens}, n)

    return generate


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START) -> dict:
    """One run of ``cell`` on ``device``: set-up, the window, the check.
    Returns the result (without the import check)."""
    model, t = cell["config"]["model"], cell["traffic"]
    traffic_lib.check(t)
    cuda = device.type == "cuda"
    cfg = program_config(model)
    weights = weights_lib.make(model, seed, device, cell["config"].get("draw"))
    engine = build_engine(cell, weights_lib.to_program(weights, cfg), device)
    vocab = model["vocab_size"]
    t_weights = time.perf_counter()
    warm_up(engine, cell, vocab, device)
    t_warm = time.perf_counter()

    marks = HostMarks()
    generate = ((lambda tokens, n: engine.generate({"tokens": tokens}, n)) if not trace
                else traced_generate(engine, cell, marks))
    events: list = []
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    with (device_profile() if trace else contextlib.nullcontext()) as prof_events:
        t0_ns = time.time_ns()
        t_window = time.perf_counter()
        waves, window_s = traffic_lib.run_window(generate, t, vocab, seed, seconds)
        t1_ns = time.time_ns()
    if trace:
        events = prof_events
    setup_s = t_window - t_start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del generate, engine                  # the reference runs on a freed card
    if cuda:
        torch.cuda.empty_cache()

    n_tokens = sum(int(w["tokens"].size) for w in waves)
    attempted = sum(int(w["tokens"].shape[0]) for w in waves)
    failed = sum(_failed(w["tokens"], t["new_tokens"], vocab) for w in waves)

    t_check = time.perf_counter()
    pairs = check.sample(waves, t["check"]["requests"], seed)
    gaps = check.served_gaps(weights, model, t, waves, pairs, device, t["check"]["batch"])
    ok, shown = check.verdict(check.numbers(gaps["gap"], t["new_tokens"]), cell["limits"])
    ok = ok and failed == 0

    metrics = {}
    print(f"phases: to weights and engine {t_weights - t_start:.2f} s, warm-up "
          f"{t_warm - t_weights:.2f} s, window {window_s:.2f} s, check "
          f"{time.perf_counter() - t_check:.2f} s", file=sys.stderr)
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": ok, "attempted": attempted, "failed": failed}
    if not trace:
        e2e = {"gen_tok_per_s": n_tokens / window_s, "peak_mem_gib": peak / 2 ** 30,
               "setup_s": setup_s}
        for m in cell["end_to_end"]:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        t_red = time.perf_counter()
        red = reduce(events, marks.ranges, t0_ns, t1_ns)
        ctx = Context(model=model, traffic=t, waves=waves, window_s=window_s, marks=marks,
                      events=events, reduced=red)
        for m in cell["per_layer"]:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=red["busy_s"], window_s=red["window_s"])
        result["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
        first = min((e[1] for e in events), default=t0_ns)
        print(f"trace: {len(events)} device events, the first {(first - t0_ns) / 1e6:.3f} ms "
              f"after the window's start; reduced in {time.perf_counter() - t_red:.2f} s",
              file=sys.stderr)
    result["metrics"] = metrics
    result["device"] = dev
    result["waves"] = [{"wall_s": w["t1"] - w["t0"], "prefill_s": w["stats"]["prefill_s"],
                        "decode_s": w["stats"]["decode_s"]} for w in waves]
    result["window_s"] = window_s
    result["agree"] = gaps["agree"] / max(gaps["tokens"], 1)
    result["compared_tokens"] = gaps["tokens"]
    result["check"] = shown
    return result


def _failed(tokens: np.ndarray, new_tokens: int, vocab: int) -> int:
    """Requests of a wave that did not serve ``new_tokens`` ids of the vocabulary."""
    if tokens.shape[1] != new_tokens:
        return int(tokens.shape[0])
    return int(((tokens < 0) | (tokens >= vocab)).any(axis=1).sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    need = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: needs {need} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    result["card"] = card()
    check_line = result.pop("check")
    result["check"] = check_line
    print(f"card: {result['card']}", file=sys.stderr)
    for name, v in check_line.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
