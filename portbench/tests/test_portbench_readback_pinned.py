"""The reader of ``host.readback.pinned_pct`` on synthetic traces, where the
answer is known: ``mh.readback_pinned`` ranges over ``mh.readback``
ranges, x 100; None where the program opens no ``mh.readback_pinned``."""

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
READER = ROOT / "portbench" / "metrics" / "host.readback.pinned_pct.py"


def readbacks(pinned: list[bool], calls=((0, 1000),)) -> Trace:
    """One ``mh.readback`` range a flag, inside the first call, with an
    ``mh.readback_pinned`` inside it where the flag is set."""
    host = [("mh.suggest_layouts", 0, 1000)]
    for k, p in enumerate(pinned):
        host.append(("mh.readback", 10 + 100 * k, 60 + 100 * k))
        if p:
            host.append(("mh.readback_pinned", 50 + 100 * k, 51 + 100 * k))
    return Trace(list(calls), [("k", 0, 900, 950)], host, cards=1)


def pinned_pct(trace: Trace):
    return run.load_reader("host.readback.pinned_pct")(SimpleNamespace(trace=trace))


@pytest.mark.parametrize("pinned, want", [([True] * 4, 100.0), ([False] * 4, None),
                                          ([True, False, True, True], 75.0), ([], None)])
def test_pinned_pct_counts_pinned_over_readbacks(pinned, want):
    assert pinned_pct(readbacks(pinned)) == want


def test_pinned_pct_reads_only_the_traced_calls():
    assert pinned_pct(readbacks([False, True], calls=((100, 1000),))) == 100.0
    assert pinned_pct(readbacks([True, False], calls=((100, 1000),))) is None
    assert pinned_pct(Trace([], [], [], 1)) is None


def test_pinned_pct_entry():
    m = next(m for m in BENCH["per_layer"] if m["name"] == "host.readback.pinned_pct")
    assert (m["unit"], m["better"], m["moves"]) == ("%", "higher", "proposals_per_s")
    assert m["source"] == "program_counter"
    readback = next(m for m in BENCH["per_layer"] if m["name"] == "host.readback.ms_per_call")
    assert m["layer"] == readback["layer"]
    assert set(m["workloads"]) == {w["name"] for w in BENCH["workloads"]}
    assert '"mh.readback_pinned"' in READER.read_text()


def test_pinned_reader_imports_nothing_of_the_program():
    assert not top_level_imports(READER) & (JAX | {"mh_tpu_torch"})
