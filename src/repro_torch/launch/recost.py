"""Re-derive the loop cost and roofline of existing dry-run records by
re-tracing each cell (port of ``repro.launch.recost``).

For every JSON record of :mod:`repro_torch.launch.dryrun` in ``--out``
(default ``experiments/dryrun_torch/``), the cell is traced again
(:func:`~repro_torch.launch.dryrun.dryrun_cell`), its ``loop_cost`` taken
from the new trace and its ``roofline`` re-derived with the record's own
collective bytes.  Records with an ``error`` are left alone.

  PYTHONPATH=src python -m repro_torch.launch.recost [--out DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.launch import dryrun
from repro_torch.perf.roofline import model_flops, roofline

__all__ = ["main"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.abspath(dryrun.OUT_DIR))
    args = ap.parse_args(argv)
    cache = {}
    for path in sorted(glob.glob(os.path.join(args.out, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if "error" in rec:
            continue
        key = (rec["arch"], rec["shape"], rec["mesh"] == "2x16x16",
               rec.get("policy", "gear_kcvt4"), rec.get("microbatches", 8))
        if key not in cache:
            cache[key] = dryrun.dryrun_cell(*key)["loop_cost"]
        lc = cache[key]
        mf = model_flops(dryrun.get_config(rec["arch"]), dryrun.SHAPES[rec["shape"]])
        chips = rec["chips"]
        rl = roofline(lc["flops"] * chips, lc["bytes"] * chips, rec["collective_bytes"], chips, mf)
        rec["loop_cost"] = lc
        rec["roofline"] = rl.row()
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        r = rl.row()
        print(f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s} "
              f"c={r['compute_s']:.2e} m={r['memory_s']:.2e} "
              f"x={r['collective_s']:.2e} -> {r['bottleneck']} eff={r['flops_eff']:.2f}")


if __name__ == "__main__":
    main()
