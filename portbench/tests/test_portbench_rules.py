"""BENCHMARK.json against the benchmark contract's rules, and every file a
cell needs found by name."""

from __future__ import annotations

import importlib
import json
import math
import re
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_shape():
    assert set(BENCH) == TOP_KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(one_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51


def test_check_fits_the_budget_at_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs():
    assert 1 <= len(BENCH["configs"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and one_line(c["source"]) and one_line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        data = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert data["reduced"] == c["reduced"] and data["name"] == c["name"]
        assert {"source", "assumed", "mode", "scene"} <= set(data)
        assert data["mode"] in ("parity", "fixed")


def test_workloads():
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs))
    four = [w for w in cells if w["chips"] == 4]
    assert len(four) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_metrics():
    e2e = BENCH["end_to_end"]
    assert 1 <= len(e2e) <= 16 and "setup_s" in {m["name"] for m in e2e}
    assert 1 <= len(BENCH["per_layer"]) <= 128
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = next(m for m in e2e if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    e2e_names = {m["name"] for m in e2e}
    all_names = [m["name"] for m in e2e + BENCH["per_layer"]]
    assert len(all_names) == len(set(all_names))
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and one_line(m["layer"]) and m["moves"] in e2e_names
        moved = next(e for e in e2e if e["name"] == m["moves"])
        # each cell that reads it reports the metric it moves
        assert set(m.get("workloads", cells)) <= set(moved.get("workloads", cells))
    for m in e2e + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m for m in e2e if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(cell):
    spec = run.cell_spec(cell, ROOT)
    traffic = spec["traffic"]
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    for fn in ("setup", "call", "proposals", "steps", "record", "expected", "objective"):
        assert callable(getattr(entry, fn))
    assert set(traffic["limits"]) == {"chains_apart_pct", "cost_gap"}
    assert traffic["check_calls"] >= 1 and traffic["trace_calls"] >= 1
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(run.load_reader(m["name"]))
    assert spec["config"]["scene"]["positions"]


def test_limits_are_finite_and_positive():
    for path in (ROOT / "portbench" / "traffic").glob("*.json"):
        limits = json.loads(path.read_text())["limits"]
        assert all(math.isfinite(v) and v > 0 for v in limits.values())
