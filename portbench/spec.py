"""The benchmark's manifest and the data files it names.

``BENCHMARK.json`` at the checkout's root lists the configurations, cells
(``workloads``) and metrics.  Everything that belongs to one of them is a
file found by its name:

* ``portbench/configs/<config>.json``: the model as it is run (``model``),
  its published source and what the port does not model;
* ``portbench/traffic/<traffic>.json``: one traffic mix (batch, lengths,
  policy, how many served requests the check compares);
* ``portbench/limits/<cell>.json``: the correctness limits of one cell and
  the readings they were set from;
* ``portbench/metrics/<metric>.py``: the reader of one per-layer metric.
"""

from __future__ import annotations

import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def valid_name(s: str) -> bool:
    return isinstance(s, str) and NAME_RE.fullmatch(s) is not None


def valid_unit(s: str) -> bool:
    return isinstance(s, str) and UNIT_RE.fullmatch(s) is not None


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def cell(name: str, root: pathlib.Path = ROOT) -> dict:
    """Everything one cell needs: its manifest entry, configuration,
    traffic, limits, and the metrics it reports (end-to-end and per-layer,
    each with its manifest entry)."""
    man = manifest(root)
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"have {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in man["configs"]}
    cfg_entry = configs[w["config"]]
    here = root / "portbench"

    def listed(metric: dict) -> bool:
        return "workloads" not in metric or name in metric["workloads"]

    return {
        "name": name,
        "workload": w,
        "config": _json(root / cfg_entry["file"]),
        "traffic": _json(here / "traffic" / f"{w['traffic']}.json"),
        "limits": _json(here / "limits" / f"{name}.json"),
        "end_to_end": [m for m in man["end_to_end"] if listed(m)],
        "per_layer": [m for m in man["per_layer"] if listed(m)],
    }
