#!/usr/bin/env python3
"""Readings behind a cell's correctness limit, on the card.

    python3 portbench/calibrate.py --workload minicpm-2b.batch-decode \
        --seeds 11,12,13 --control 3

For each seed: the cell's weights and one wave of its traffic through the
timed path (``Engine.generate`` at the cell's batch and lengths), then the
check's sample of that wave's requests through the reference.  It prints
the numbers the check could compare (the widest and the mean gap of the
served tokens, their agreement with the reference's best, the gap of the
prefill's token alone) and, for the first ``--control`` seeds, the same
numbers for the control: the token the reference computed in float8 puts
first at each of those positions.  The limits in ``portbench/limits/`` are
set from these readings; the benchmark's own runs never run the control.
"""

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from portbench import check, spec, traffic as traffic_lib, weights as weights_lib  # noqa: E402
from portbench import run  # noqa: E402


def calibrate(cell: dict, seed: int, control: bool, device) -> dict:
    model, t = cell["config"]["model"], cell["traffic"]
    weights = weights_lib.make(model, seed, device, cell["config"].get("draw"))
    engine = run.build_engine(cell, weights_lib.to_program(weights, run.program_config(model)),
                              device)
    waves, _ = traffic_lib.run_window(lambda tok, n: engine.generate({"tokens": tok}, n),
                                      t, model["vocab_size"], seed, 0.0)
    del engine
    t0 = time.perf_counter()
    pairs = check.sample(waves, t["check"]["requests"], seed)
    res = check.served_gaps(weights, model, t, waves, pairs, device, t["check"]["batch"],
                            control=control)
    out = {"seed": seed, "check_s": time.perf_counter() - t0,
           "program": check.numbers(res["gap"], t["new_tokens"])}
    if control:
        out["control"] = check.numbers(res["ctl_gap"], t["new_tokens"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        rows.append(calibrate(cell, seed, i < args.control, device))
        print(json.dumps(rows[-1]), flush=True)
    summary = {"workload": args.workload, "seeds": len(rows), "card": run.card()}
    for side in ("program", "control"):
        got = [r[side] for r in rows if side in r]
        if got:
            summary[side] = {k: {"min": min(g[k] for g in got), "max": max(g[k] for g in got)}
                             for k in got[0]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
