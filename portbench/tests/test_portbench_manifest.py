"""BENCHMARK.json against the benchmark's contract, and every file it names."""

import json
import math

import pytest

from portbench import spec
from portbench.metrics import reader

ROOT = spec.ROOT
MAN = spec.manifest()
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(MAN) == TOP
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(MAN["command"]) <= 32
    for word in MAN["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        assert not word.startswith("/") and ".." not in word.split("/")
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert len(p) <= 200 and (ROOT / p).is_dir() and not p.endswith("_torch")
        assert all(c.isalnum() or c in "_.-/" for c in p)
    assert MAN["command"][1].startswith(MAN["paths"][0] + "/")
    assert (ROOT / MAN["command"][1]).is_file()


def _one_line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s and "\t" not in s


def test_names_units_and_lines():
    names = []
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert spec.valid_name(c["name"]) and _one_line(c["source"]) and _one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(spec.valid_name(k) for k in c["reduced"])
        names.append(c["name"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert spec.valid_name(w["name"]) and spec.valid_name(w["traffic"])
        assert w["chips"] in (1, 4) and _one_line(w["why"])
        names.append(w["name"])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert spec.valid_name(m["name"]) and spec.valid_unit(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(set(names)) == len(names)
    assert not spec.valid_name("has space") and not spec.valid_name("a/b")
    assert not spec.valid_unit("tokens per second") and spec.valid_unit("tokens/s")


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25


def test_per_layer_metrics():
    e2e = {m["name"] for m in MAN["end_to_end"]}
    cells = {w["name"] for w in MAN["workloads"]}
    layers = {}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _one_line(m["layer"])
        assert set(m.get("workloads", cells)) <= cells
        for w in m.get("workloads", cells):          # each of its cells reports what it moves
            assert any(e["name"] == m["moves"] for e in spec.cell(w)["end_to_end"]), (m, w)
        assert callable(reader(m["name"]))
        if m["name"].endswith("_roofline") or "mfu" in m["name"].split("_"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_resolves():
    for w in MAN["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["config"]["name"] == w["config"]
        assert cell["config"]["model"]["name"] == w["config"]
        compared = set(cell["limits"]) - {"readings"}
        assert compared and compared <= {"gap_max", "gap_mean", "agree", "gap_first_max"}
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    with pytest.raises(KeyError):
        spec.cell("no-such.cell")


def test_configs_are_used_and_files_are_distinct():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(set(files)) == len(files)
    for c in MAN["configs"]:
        assert c["file"].startswith(MAN["paths"][0] + "/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert sorted(body["reduced"]) == sorted(c["reduced"])


def test_pairs_unique_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_check_budget_fits_with_24_cells():
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    cells = 24
    total = (2 + 14 * cells) * (rs + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
    assert math.isfinite(total)
