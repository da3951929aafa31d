"""The readers of the program's spans (``portbench/spans.py`` and the
``host.*.ms_per_call`` metrics that read it) on synthetic traces, where the
answer is known."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import run, spans
from portbench.tests.test_portbench_imports import JAX, top_level_imports
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READERS = {m["name"]: m for m in BENCH["per_layer"] if m["source"] == "program_span"}
SPAN_OF = {"host.dispatch.ms_per_call": "mh.suggest_layouts",
           "host.scene_build.ms_per_call": "mh.scene_build",
           "host.pack.ms_per_call": "mh.pack_scene", "host.launch.ms_per_call": "mh.launch",
           "host.split.ms_per_call": "mh.split", "host.gather.ms_per_call": "mh.gather",
           "host.readback.ms_per_call": "mh.readback"}


def two_calls() -> Trace:
    """Two calls of 1000 us. The first: spans nested in ``mh.suggest_layouts``
    from 10 to 990 us, card 0 busy from 350 to 700 us; the second: no
    packing, the top span as long as the call, no card busy."""
    host = [("mh.suggest_layouts", 10, 990), ("mh.pack_scene", 100, 300),
            ("aten::copy_", 150, 160), ("mh.launch", 300, 400), ("mh.readback", 600, 980),
            ("mh.suggest_layouts", 2000, 3000), ("mh.launch", 2100, 2200),
            ("cudaLaunchKernel", 2110, 2120), ("mh.readback", 2500, 2900)]
    device = [("fused_mh_kernel", 0, 350, 600), ("Memcpy DtoH", 0, 600, 700)]
    return Trace([(0, 1000), (2000, 3000)], device, host, cards=1)


def test_idle_time_goes_to_the_innermost_span():
    got = spans.idle_ms_per_call(two_calls())
    # us per call, halved: suggest self 10-100, 980-990 and 500; pack 100-300;
    # launch 300-350 and 100; readback 700-980 and 400; uncovered 0-10, 990-1000
    want = {"mh.suggest_layouts": 0.3, "mh.pack_scene": 0.1, "mh.launch": 0.075,
            "mh.readback": 0.34, None: 0.01}
    assert set(got) == set(want)
    for name, ms in want.items():
        assert got[name] == pytest.approx(ms, abs=1e-12), name


def test_readers_add_up_to_host_ms_per_call_less_the_uncovered_time():
    tr = two_calls()
    ctx = SimpleNamespace(trace=tr)
    values = {m: run.load_reader(m)(ctx) for m in READERS}
    assert values["host.scene_build.ms_per_call"] is None
    assert values["host.split.ms_per_call"] is None and values["host.gather.ms_per_call"] is None
    host = run.load_reader("host.ms_per_call")(ctx)
    assert host == pytest.approx(0.825)
    total = sum(v for v in values.values() if v is not None)
    assert total == pytest.approx(host - spans.idle_ms_per_call(tr)[None])


@pytest.mark.parametrize("seed", range(6))
def test_split_covers_host_ms_per_call_on_random_traces(seed):
    """Random nested spans over two cards: every instant the cards are
    idle inside a call goes to exactly one key."""
    rng = np.random.default_rng(seed)
    calls, host, device = [], [], []
    for k in range(3):
        lo = k * 10_000.0
        calls.append((lo, lo + 9_000))
        a, b = sorted(rng.uniform(lo, lo + 9_000, 2))
        host.append(("mh.suggest_layouts", a, b))
        for name in ("mh.pack_scene", "mh.launch", "mh.readback", "aten::empty"):
            s, e = sorted(rng.uniform(a, b, 2))
            host.append((name, s, e))
        for _ in range(20):
            s = rng.uniform(lo - 500, lo + 9_500)
            device.append(("k", int(rng.integers(2)), s, s + rng.uniform(0, 400)))
    tr = Trace(calls, device, host, cards=2)
    got = spans.idle_ms_per_call(tr)
    host_ms = run.load_reader("host.ms_per_call")(SimpleNamespace(trace=tr))
    assert sum(got.values()) == pytest.approx(host_ms, rel=1e-12)
    assert {n for n in got if n} == {"mh.suggest_layouts", "mh.pack_scene", "mh.launch",
                                     "mh.readback"}


def test_a_span_opened_with_no_idle_time_reads_zero():
    tr = Trace([(0, 100)], [("k", 0, 0, 100)], [("mh.launch", 10, 20)], cards=1)
    assert spans.idle_ms_per_call(tr) == {"mh.launch": 0.0}


def test_of_two_spans_starting_together_the_shorter_is_innermost():
    tr = Trace([(0, 100)], [], [("mh.suggest_layouts", 0, 100), ("mh.scene_build", 0, 40)],
               cards=1)
    got = spans.idle_ms_per_call(tr)
    assert got["mh.scene_build"] == pytest.approx(0.04)
    assert got["mh.suggest_layouts"] == pytest.approx(0.06)


def test_a_trace_without_spans_gives_every_reader_nothing():
    tr = Trace([(0, 100)], [("k", 0, 20, 50)], [("aten::copy_", 10, 30)], cards=1)
    ctx = SimpleNamespace(trace=tr)
    assert all(run.load_reader(m)(ctx) is None for m in READERS)
    assert all(run.load_reader(m)(SimpleNamespace(trace=Trace([], [], [], 1))) is None
               for m in READERS)


def test_the_idle_gaps_are_named_by_the_spans():
    names = {n for n, _ in two_calls().idle_gaps()}
    assert "python" not in names and "mh.pack_scene" in names


def test_each_span_reader_reads_its_span():
    assert set(READERS) == set(SPAN_OF)
    for metric, span in SPAN_OF.items():
        assert f'"{span}"' in (ROOT / "portbench" / "metrics" / f"{metric}.py").read_text()
        m = READERS[metric]
        assert m["moves"] == "proposals_per_s" and m["unit"] == "ms"


def test_spans_reader_imports_nothing_of_the_program():
    assert not top_level_imports(ROOT / "portbench" / "spans.py") & (JAX | {"mh_tpu_torch"})
