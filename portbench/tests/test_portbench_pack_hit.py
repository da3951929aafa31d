"""The reader of ``host.pack.hit_pct`` on synthetic traces, where the answer
is known: ``mh.pack_hit`` ranges over ``mh.pack_scene`` ranges, x 100."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import run
from portbench.tests.test_portbench_imports import JAX, top_level_imports
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READER = ROOT / "portbench" / "metrics" / "host.pack.hit_pct.py"


def packs(hits: list[bool], calls=((0, 1000),)) -> Trace:
    """One ``mh.pack_scene`` range a flag, inside the first call, with an
    ``mh.pack_hit`` inside it where the flag is set."""
    host = [("mh.suggest_layouts", 0, 1000)]
    for k, hit in enumerate(hits):
        host.append(("mh.pack_scene", 10 + 100 * k, 60 + 100 * k))
        if hit:
            host.append(("mh.pack_hit", 20 + 100 * k, 21 + 100 * k))
    return Trace(list(calls), [("k", 0, 900, 950)], host, cards=1)


def hit_pct(trace: Trace):
    return run.load_reader("host.pack.hit_pct")(SimpleNamespace(trace=trace))


@pytest.mark.parametrize("hits, want", [([True] * 4, 100.0), ([False] * 4, 0.0),
                                        ([True, True, False, True], 75.0), ([], None)])
def test_pack_hit_pct_counts_hits_over_packs(hits, want):
    assert hit_pct(packs(hits)) == want


def test_pack_hit_pct_reads_only_the_traced_calls():
    assert hit_pct(packs([False, True], calls=((100, 1000),))) == 100.0
    assert hit_pct(Trace([], [], [], 1)) is None


def test_pack_hit_pct_entry():
    m = next(m for m in BENCH["per_layer"] if m["name"] == "host.pack.hit_pct")
    assert (m["unit"], m["better"], m["moves"]) == ("%", "higher", "proposals_per_s")
    assert m["source"] == "program_counter"
    pack = next(m for m in BENCH["per_layer"] if m["name"] == "host.pack.ms_per_call")
    assert m["layer"] == pack["layer"]
    assert set(m["workloads"]) == {w["name"] for w in BENCH["workloads"]}
    assert '"mh.pack_hit"' in READER.read_text()


def test_pack_hit_reader_imports_nothing_of_the_program():
    assert not top_level_imports(READER) & (JAX | {"mh_tpu_torch"})
