"""The dense-guideline deployment ``scene100_guidelines`` and its cell: the
configuration against the headline scene, the guideline count against a
count made move by move, the table-at-once reference against the frozen
one, a toy cell judged on the CPU (sound runs correct, the bfloat16
control not), and the readers of ``kernel.fused_guidelines_roofline`` and
``kernel.fused_blocks_per_sm``."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import run
from portbench.counts import fused_guidelines, fused_single
from portbench.entries import suggest_layouts_tables as tables_entry
from portbench.reference import fused as rf
from portbench.reference import guidelines as rg
from portbench.reference import scene as rs
from portbench.reference.counter_hash import uniform_lanes_np
from portbench.tests import toys
from portbench.tests.test_portbench_imports import JAX, top_level_imports
from portbench.tests.test_portbench_reference import SEEDS
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "scene100_guidelines.batch"
CONFIG = json.loads((ROOT / "portbench" / "configs" / "scene100_guidelines.json").read_text())
PARITY = json.loads((ROOT / "portbench" / "configs" / "scene100_parity.json").read_text())
NEW_METRICS = ("kernel.fused_guidelines_roofline", "kernel.fused_blocks_per_sm")
QUADS = ([[2.0, 2.0], [2.0, 0.0], [0.0, 0.0], [0.0, 2.0]],
         [[3.0, 2.0], [3.0, 0.0], [1.0, 0.0], [1.0, 2.0]])
SEED = 2**31 + 41
KERNEL = "fused_mh_kernel(anonymous)"


def guideline_config(n: int, mode: str = "parity", **weights) -> dict:
    """A toy configuration laid out as ``scene100_guidelines``: object i
    anchors clearance quad i mod 2, each pair (2i, 2i + 1) a distance and
    an angle row."""
    conf = toys.config(n, mode, **weights)
    conf["scene"].update(
        relationships=[[2 * i, 2 * i + 1, 2.0, 4.0] for i in range(n // 2)],
        angle_relationships=[[2 * i, 2 * i + 1, 0.7854, 1.9635] for i in range(n // 2)],
        clearances=[[QUADS[i % 2], i] for i in range(n)])
    return conf


def toy_traffic(**sizes) -> dict:
    """``batch_tables`` cut to toy sizes, as ``toys.traffic`` cuts ``batch``."""
    t = toys.traffic("batch")
    tables = json.loads((ROOT / "portbench" / "traffic" / "batch_tables.json").read_text())
    return {**t, "entry": tables["entry"], "sampler": {**t["sampler"], **sizes}}


def test_configuration_is_the_headline_scene_with_dense_tables():
    scene = CONFIG["scene"]
    assert {k for k in scene if scene[k] != PARITY["scene"][k]} == {
        "relationships", "angle_relationships", "clearances"}
    assert guideline_config(100)["scene"] == scene
    assert (CONFIG["mode"], CONFIG["precision"], CONFIG["reduced"]) == ("parity", "float32", [])
    assert {"pairing", "counts", "clearances", "reuse"} <= set(CONFIG["assumed"])
    assert "one card" in CONFIG["deployment"]


def test_cell_and_metrics_entries():
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "scene100_guidelines", "batch_tables", 1)
    conf = next(c for c in BENCH["configs"] if c["name"] == "scene100_guidelines")
    assert conf["file"] == "portbench/configs/scene100_guidelines.json" and conf["reduced"] == []
    layer = next(m for m in BENCH["per_layer"] if m["name"] == "kernel.fused_roofline")["layer"]
    want = {"kernel.fused_guidelines_roofline": ("%", "device_trace", [CELL]),
            "kernel.fused_blocks_per_sm": ("count", "program_counter", [
                "scene100_parity.batch", "scene100_fixed.batch", CELL])}
    for name, (unit, source, cells) in want.items():
        m = next(m for m in BENCH["per_layer"] if m["name"] == name)
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"], m["workloads"]) == (
            unit, "higher", source, layer, "proposals_per_s", cells)
    spec = run.cell_spec(CELL, ROOT)
    assert set(NEW_METRICS) <= {m["name"] for m in spec["per_layer"]}
    assert {m["name"] for m in spec["end_to_end"]} == {"proposals_per_s", "call_p50_ms",
                                                        "call_p95_ms", "setup_s"}


def test_traffic_is_the_batch_traffic_judged_by_the_table_reference():
    batch = json.loads((ROOT / "portbench" / "traffic" / "batch.json").read_text())
    tables = json.loads((ROOT / "portbench" / "traffic" / "batch_tables.json").read_text())
    assert {k for k in batch if batch[k] != tables[k]} == {"why", "entry"}
    assert tables["entry"] == "suggest_layouts_tables"


def test_count_of_a_tiny_configuration_is_pinned():
    got = fused_guidelines.count(guideline_config(8)["scene"], True, n_chains=4, iterations=20,
                                 seed=SEED)
    assert (got["operations"], got["bytes"], got["guideline_operations"]) == (
        86_399, 2_592, 36_567)
    assert got["bound_by"] == "operations"
    assert got["bound_s"] == pytest.approx(got["operations"] / fused_single.F32_PEAK_FLOPS)


def moves_of(n_unf: int, n_chains: int, iterations: int, seed: int):
    """(kind, first, second) movable-object ranks of every step of every
    chain, one at a time, from the draws."""
    for t in range(iterations):
        u = uniform_lanes_np(seed, t // 4, np.arange(n_chains), [8 * (t % 4) + k
                                                                   for k in (0, 6, 7)])
        for c in range(n_chains):
            kind = min(int(u[c, 0] * np.float32(3.0)), 2)
            k1, k2 = (int(min(np.floor(v * np.float32(n_unf)), max(n_unf - 1.0, 0.0)))
                      for v in u[c, 1:])
            yield kind, k1, k2


def changed_by_hand(scene: dict, parity: bool, n_chains: int, iterations: int, seed: int):
    """The terms the moves change, from the sets of moved boxes and
    rotations step by step."""
    n = len(scene["positions"])
    unf = [i for i in range(n) if not scene["frozen"][i]]
    src = [s for _, s in scene["clearances"]]
    anchor = [min(c, n - 1) for c in range(len(src))] if parity else src
    out = dict(pairs=0, surf=0, rel=0, ang=0)
    for kind, k1, k2 in moves_of(len(unf), n_chains, iterations, seed):
        a, b = unf[k1], unf[k2]
        boxes = {a} if kind == 0 else {a, b} if kind == 2 and k1 != k2 else set()
        turns = {a} if kind == 1 else boxes if kind == 2 else set()
        out["pairs"] += sum(1 for c in range(len(src)) for j in range(n)
                            if src[c] in boxes or j in boxes)
        out["surf"] += sum(1 for a_ in anchor if a_ in boxes)
        out["rel"] += sum(1 for s, t, *_ in scene["relationships"] if {s, t} & boxes)
        out["ang"] += sum(1 for s, t, *_ in scene["angle_relationships"]
                          if {s, t} & boxes or t in turns)
    return out


@pytest.mark.parametrize("parity", [True, False])
def test_changed_terms_equal_a_count_made_move_by_move(parity):
    """Uneven tables: a self row, two rows on one pair, frozen objects, an
    object with three clearances and one with none."""
    scene = guideline_config(9)["scene"]
    scene["frozen"][4] = scene["frozen"][7] = True
    scene["relationships"] += [[3, 3, 1.0, 2.0], [1, 0, 1.0, 3.0]]
    scene["angle_relationships"] += [[5, 2, 0.1, 0.2], [2, 5, 0.3, 0.4]]
    scene["clearances"] = [[QUADS[0], s] for s in (0, 0, 0, 2, 3, 5, 8)]
    tab = fused_guidelines.tables(scene, parity)
    got = fused_guidelines.changed(tab, 5, 30, SEED)
    assert got == changed_by_hand(scene, parity, 5, 30, SEED)
    assert min(got.values()) > 0


def test_with_no_rows_the_count_adds_only_the_anchored_clearances():
    scene = guideline_config(8)["scene"]
    scene["relationships"], scene["angle_relationships"] = [], []
    got = fused_guidelines.count(scene, True, n_chains=4, iterations=20, seed=SEED)
    base = fused_single.count(**fused_single.sizes(scene), n_chains=4, iterations=20, seed=SEED)
    moved = changed_by_hand(scene, True, 4, 20, SEED)
    ends = 2 * 4
    assert moved["rel"] == moved["ang"] == 0
    assert got["operations"] - base["operations"] == (
        (moved["pairs"] + ends * 8 * 8) * fused_guidelines.CLEARANCE_OPS[True]
        + (moved["surf"] + ends * 8) * fused_guidelines.SURFACE_OPS[True])
    assert got["bytes"] == base["bytes"]


def test_count_applies_to_single_move_launches_without_the_off_limits_term():
    traffic = toy_traffic()
    assert fused_guidelines.launch(guideline_config(8), traffic, 3) is not None
    assert fused_guidelines.launch(guideline_config(8, "fixed"), traffic, 3) is not None
    assert fused_guidelines.launch(guideline_config(8, "fixed", w_offlimits=-1.5), traffic,
                                   3) is None
    for sizes in ({"n_moves_per_step": 4}, {"accept_draws": 4}):
        assert fused_guidelines.launch(guideline_config(8), toy_traffic(**sizes),
                                       3) is None


@pytest.mark.parametrize("name,mode,weights", [
    ("guidelines_16", "parity", {}), ("guidelines_16_fixed", "fixed", {"w_offlimits": -1.5}),
    ("demo_8", "parity", {})])
@pytest.mark.parametrize("seed", SEEDS)
def test_table_reference_is_the_frozen_reference_bitwise(name, mode, weights, seed):
    conf = (guideline_config(16, mode, **weights) if name.startswith("guidelines")
            else toys.config(8, mode, **weights))
    cfg = rf.Sampler(iterations=25, parity=mode == "parity")
    pk = rf.pack(rs.build(conf["scene"], "cpu"), cfg)
    n = len(conf["scene"]["positions"])
    pose0 = rs.initial_pose(conf["scene"], "cpu").expand(6, n, 6)
    seeds, ids = torch.full((6,), seed, dtype=torch.int64), torch.arange(6)
    want = rf.chains(pk, pose0, seeds, ids, 25)
    got = rg.chains(pk, pose0, seeds, ids, 25)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.numpy().tobytes() == w.numpy().tobytes()
    assert (want[2] > 0).all()
    pose = want[0] + 0.25
    assert torch.equal(rg.breakdown(pk, pose), rf.breakdown(pk, pose))


def guideline_cell(n: int = 8, trace: bool = False) -> dict:
    per_layer = [m for m in BENCH["per_layer"] if CELL in m.get("workloads", [CELL])]
    return toys.cell(f"toy{n}_guidelines.batch", guideline_config(n),
                     toy_traffic(), BENCH["end_to_end"],
                     per_layer if trace else [])


@pytest.mark.parametrize("trace", [False, True])
def test_sound_toy_cell_is_correct(trace):
    out = run.run_cell(guideline_cell(trace=trace), SEED, 0.3, trace, "cpu")
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert all(c["value"] == 0.0 for c in out["checks"].values())
    if trace:  # the CPU runs no kernel and opens no blocks-per-SM range
        assert not set(NEW_METRICS) & set(out["metrics"])
        assert out["metrics"]["host.pack.hit_pct"]["value"] == 100.0
    else:
        assert {"proposals_per_s", "call_p50_ms", "call_p95_ms", "setup_s"} <= set(out["metrics"])


def test_the_bfloat16_control_is_not_correct(monkeypatch):
    spec = guideline_cell()

    def control(program, key):
        return tables_entry.expected(spec["config"], spec["traffic"], [key], "cpu",
                                     torch.bfloat16)[0]

    monkeypatch.setattr(tables_entry, "call", control)
    monkeypatch.setattr(tables_entry, "record", lambda traffic, result: result)
    out = run.run_cell(spec, SEED, 0.3, False, "cpu")
    assert not out["correct"]
    assert out["checks"]["chains_apart_pct"]["value"] > out["checks"]["chains_apart_pct"]["limit"]


def traced(config: dict, traffic: dict, keys: list, kernel_us: list, host=()):
    device = [(KERNEL, 0, 100.0 + 1000 * i, 100.0 + 1000 * i + t)
              for i, t in enumerate(kernel_us)]
    calls = [(1000.0 * i, 1000.0 * i + 999) for i in range(len(keys))]
    return run.TraceContext(Trace(calls, device, list(host), cards=1), config, traffic, keys,
                            traffic["sampler"]["iterations"], None)


def test_roofline_is_the_summed_bound_over_the_summed_kernel_time():
    conf, traffic = guideline_config(8), toy_traffic()
    keys, times = [11, 2**31 + 3], [250.0, 150.0]
    read = run.load_reader("kernel.fused_guidelines_roofline")
    bound = sum(fused_guidelines.launch(conf, traffic, k)["bound_s"] for k in keys)
    assert read(traced(conf, traffic, keys, times)) == pytest.approx(
        100.0 * bound / 400e-6, rel=1e-12)
    assert read(traced(conf, traffic, keys, times[:1])) is None  # a launch not traced
    assert read(traced(conf, traffic, keys, [])) is None  # no kernel: a CPU run
    weighted = guideline_config(8, "fixed", w_offlimits=-1.5)
    assert read(traced(weighted, traffic, keys, times)) is None
    compound = toy_traffic(n_moves_per_step=4, accept_draws=4)
    assert read(traced(conf, compound, keys, times)) is None


@pytest.mark.parametrize("names, want", [
    (["mh.blocks_per_sm.3"] * 5, 3.0), (["mh.blocks_per_sm.8", "mh.blocks_per_sm.4"], 6.0),
    (["mh.blocks_per_sm.16", "mh.blocks_per_sm.x", "mh.blocks_per_sm."], 16.0),
    (["mh.off_state", "mh.launch"], None), ([], None)])
def test_blocks_per_sm_is_the_mean_k_of_the_ranges_in_the_calls(names, want):
    host = [("mh.launch", 0, 1000)] + [(n, 10 + 100 * k, 11 + 100 * k)
                                       for k, n in enumerate(names)]
    read = run.load_reader("kernel.fused_blocks_per_sm")
    assert read(SimpleNamespace(trace=Trace([(0, 1000)], [], host, cards=1))) == want
    assert read(SimpleNamespace(trace=Trace([(2000, 3000)], [], host, cards=1))) is None


def test_count_of_the_cells_call_is_pinned():
    """One call of the cell at one key: ~18.5 G operations, ~197 clearance
    pairs and ~2.1 rows a step."""
    got = fused_guidelines.launch(CONFIG, toy_traffic(iterations=1000, n_chains=1024), 3100000001)
    assert got["operations"] == 18_535_675_814 and got["bytes"] == 4_965_888
    assert 197 < got["clearance_pairs_per_step"] < 198 and 2.1 < got["rows_per_step"] < 2.2


@pytest.mark.parametrize("path", [
    "metrics/kernel.fused_guidelines_roofline.py", "metrics/kernel.fused_blocks_per_sm.py",
    "counts/fused_guidelines.py", "reference/guidelines.py", "entries/suggest_layouts_tables.py"])
def test_new_files_import_no_jax_and_the_yardstick_nothing_of_the_program(path):
    names = top_level_imports(ROOT / "portbench" / path)
    assert not names & JAX
    if not path.startswith("entries/"):
        assert "mh_tpu_torch" not in names

