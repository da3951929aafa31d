"""The reader of ``host.copies_per_call`` on synthetic traces, where the
answer is known: the ``Memcpy`` device events that start inside the traced
calls, over the number of calls; sets are not copies."""

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
READER = ROOT / "portbench" / "metrics" / "host.copies_per_call.py"
CALLS = [(0, 1000), (2000, 3000)]


def copies_per_call(device, calls=CALLS, cards: int = 1):
    return run.load_reader("host.copies_per_call")(
        SimpleNamespace(trace=Trace(list(calls), device, [], cards)))


def test_counts_the_copies_inside_the_calls_per_call():
    device = [("Memcpy HtoD (Pinned -> Device)", 0, 10, 20),
              ("fused_mh_kernel", 0, 20, 900),
              ("Memcpy DtoH (Device -> Pinned)", 0, 900, 910),
              ("Memcpy HtoD (Pageable -> Device)", 0, 2100, 2110),
              ("Memcpy DtoD (Device -> Device)", 0, 2200, 2210),
              ("Memcpy DtoH (Device -> Pinned)", 0, 2990, 3010)]
    assert copies_per_call(device) == 5 / 2


@pytest.mark.parametrize("start", [-50, 1500, 3001, 4000])
def test_a_copy_starting_outside_every_call_is_not_counted(start):
    device = [("Memcpy HtoD (Pageable -> Device)", 0, 10, 20),
              ("Memcpy HtoD (Pageable -> Device)", 0, start, start + 10)]
    assert copies_per_call(device) == 1 / 2


def test_sets_and_kernels_are_not_copies():
    device = [("Memset (Device)", 0, 10, 20), ("fused_mh_kernel", 0, 20, 900),
              ("void at::native::elementwise_kernel<128, 2>", 0, 2100, 2110)]
    assert copies_per_call(device) == 0.0


def test_copies_on_every_card_count():
    device = [("Memcpy PtoP (Device -> Device)", c, 100 + c, 110 + c) for c in range(4)]
    device += [("Memcpy DtoH (Device -> Pinned)", 0, 2500, 2510)]
    assert copies_per_call(device, cards=4) == 5 / 2


def test_no_traced_call_reads_nothing():
    assert copies_per_call([("Memcpy HtoD (Pinned -> Device)", 0, 10, 20)], calls=[]) is None
    assert copies_per_call([], calls=[]) is None


def test_copies_entry():
    m = next(m for m in BENCH["per_layer"] if m["name"] == "host.copies_per_call")
    assert (m["unit"], m["better"], m["moves"], m["source"]) == (
        "count", "lower", "proposals_per_s", "device_trace")
    host = next(m for m in BENCH["per_layer"] if m["name"] == "host.ms_per_call")
    assert m["layer"] == host["layer"]
    assert set(m["workloads"]) == {w["name"] for w in BENCH["workloads"]}
    assert BENCH["per_layer"][-1] is m


def test_copies_reader_imports_nothing_of_the_program():
    assert not top_level_imports(READER) & (JAX | {"mh_tpu_torch"})
