#!/usr/bin/env python3
"""Faults planted in the timed path, to see the check come out not correct.

    python3 portbench/faults.py --workload starcoder2-3b.batch-prefill \
        --seeds 11,12,13 --faults flash_prefill_scaled,gear_decode_drops_a_chunk

Each fault replaces one call of the program for the length of a run:

* ``altered_token``: the sampled token of the first request is one id off,
  where it is produced;
* ``state_unchanged``: a decode step's cache never takes the new token;
* ``flash_prefill_scaled``: the prefill attention's output is 0.9 of what it
  should be;
* ``gear_decode_drops_a_chunk``: the decode attention leaves the newest
  compressed chunk of every slot out of the history.

The tests (``tests/test_portbench_faults.py``) plant them at smoke size on
the CPU; this command plants them in a cell at its own size on the card,
one wave a run (``run.run_cell`` with a window of 0 s), and prints what the
check compared for each fault and seed.
"""

import argparse
import contextlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


@contextlib.contextmanager
def _patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def altered_token():
    from repro_torch.serving import engine

    def make(sample):
        def altered(logits, key, temperature=0.0, top_k=0):
            tok = sample(logits, key, temperature, top_k).clone()
            tok[0] = (tok[0] + 1) % logits.shape[-1]
            return tok
        return altered
    return _patched(engine, "sample", make)


def state_unchanged():
    from repro_torch.core import cache

    return _patched(cache, "append_token",
                    lambda orig: lambda cfg, c, k_t, v_t, lengths, key=None: c)


def flash_prefill_scaled():
    from repro_torch.kernels import ops

    return _patched(ops, "flash_prefill",
                    lambda orig: lambda *a, **k: orig(*a, **k) * 0.9)


def gear_decode_drops_a_chunk():
    import torch

    from repro_torch.kernels import ops

    def make(orig):
        def dropped(q, kp, ks, kz, vp, vs, vz, n_comp, *a, chunk, **k):
            n = torch.clamp_min(n_comp - chunk, 0).to(n_comp.dtype)
            return orig(q, kp, ks, kz, vp, vs, vz, n, *a, chunk=chunk, **k)
        return dropped
    return _patched(ops, "gear_decode", make)


FAULTS = {f.__name__: f for f in (altered_token, state_unchanged, flash_prefill_scaled,
                                   gear_decode_drops_a_chunk)}


def main(argv=None) -> int:
    import torch

    from portbench import run, spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--faults", default=",".join(FAULTS), help="comma-separated faults")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    for fault in args.faults.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            with FAULTS[fault]():
                res = run.run_cell(cell, seed, 0.0, False, device)
            print(json.dumps({"workload": args.workload, "fault": fault, "seed": seed,
                              "correct": res["correct"], "agree": res["agree"],
                              "check": res["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
