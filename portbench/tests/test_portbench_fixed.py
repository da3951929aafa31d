"""The weighted FIXED deployment ``scene100_fixed`` and its cell: the
configuration against the port's ``demo_scene``, the off-limits count
against ``chip_smoke.fused_bound``, a toy cell judged on the CPU (sound
runs correct, the bfloat16 control not), and the readers of
``kernel.off_state_pct`` and ``kernel.fused_fixed_roofline``."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mh_tpu_torch.kernels import fused_mh as F
from mh_tpu_torch.models.scene import demo_scene
from portbench import run
from portbench.counts import fused_fixed, fused_single
from portbench.entries import suggest_layouts as layouts_entry
from portbench.entries.suggest_layouts import scene_spec
from portbench.tests import toys
from portbench.tests.test_portbench_imports import JAX, top_level_imports
from portbench.tests.test_portbench_reference import SEEDS, port_config
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIG = json.loads((ROOT / "portbench" / "configs" / "scene100_fixed.json").read_text())
NEW_METRICS = ("kernel.fused_fixed_roofline", "kernel.off_state_pct")
SEED = 2**31 + 29
KERNEL = "fused_mh_kernel(anonymous)"


def test_configuration_is_the_headline_scene_with_the_off_limits_weight():
    spec = dataclasses.replace(demo_scene(100), w_offlimits=-1.5)
    assert toys.scene_of(spec) == CONFIG["scene"]
    want = spec.build().to_numpy()
    got = scene_spec(CONFIG["scene"]).build().to_numpy()

    def flat(d, pre=""):
        for k, v in d.items():
            yield from flat(v, pre + k + ".") if isinstance(v, dict) else [(pre + k, v)]

    for (k, a), (_, b) in zip(flat(want), flat(got)):
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    parity = json.loads((ROOT / "portbench" / "configs" / "scene100_parity.json").read_text())
    assert {k for k in CONFIG["scene"] if CONFIG["scene"][k] != parity["scene"][k]} == {
        "w_offlimits"}
    assert (CONFIG["mode"], CONFIG["precision"], CONFIG["reduced"]) == ("fixed", "float32", [])
    assert CONFIG["assumed"]["n_objs"] == parity["assumed"]["n_objs"]
    assert CONFIG["assumed"]["w_offlimits"].startswith("-1.5")


def test_cell_and_metrics_entries():
    cell = next(w for w in BENCH["workloads"] if w["name"] == "scene100_fixed.batch")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("scene100_fixed", "batch", 1)
    conf = next(c for c in BENCH["configs"] if c["name"] == "scene100_fixed")
    assert conf["file"] == "portbench/configs/scene100_fixed.json" and conf["reduced"] == []
    layer = next(m for m in BENCH["per_layer"] if m["name"] == "kernel.fused_roofline")["layer"]
    for name, source in zip(NEW_METRICS, ("device_trace", "program_counter")):
        m = next(m for m in BENCH["per_layer"] if m["name"] == name)
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"], m["workloads"]) == (
            "%", "higher", source, layer, "proposals_per_s", ["scene100_fixed.batch"])
    spec = run.cell_spec("scene100_fixed.batch", ROOT)
    assert set(NEW_METRICS) <= {m["name"] for m in spec["per_layer"]}


@pytest.mark.parametrize("seed", SEEDS)
def test_count_equals_chip_smokes_fused_bound_with_the_off_limits_term(seed):
    import chip_smoke

    conf = toys.config(8, "fixed", w_offlimits=-1.5)
    cfg = port_config("fixed", 1, 1, iterations=40, n_chains=16)
    pk = F.pack_scene(scene_spec(conf["scene"]).build(), cfg)
    assert pk.track_off
    want = chip_smoke.fused_bound(F, pk, seed, 40, 16, "cpu")
    got = fused_fixed.count(**fused_single.sizes(conf["scene"]), n_chains=16, iterations=40,
                            seed=seed)
    assert (got["operations"], got["bytes"], got["bound_by"]) == (
        want["operations"], want["bytes"], want["bound_by"])
    assert got["off_pairs_per_step"] == want["off_pairs_per_step"] > 0
    assert got["bound_s"] * 1e3 == pytest.approx(want["bound_ms"], rel=1e-12)
    assert got["moved_lanes_per_step"] == want["moved_lanes_per_step"]


def test_count_applies_to_single_move_weighted_fixed_launches_only():
    weighted = toys.config(8, "fixed", w_offlimits=-1.5)
    traffic = toys.traffic("batch")
    got = fused_fixed.launch(weighted, traffic, 3)
    single = fused_single.launch(toys.config(8), traffic, 3)
    assert got is not None and got["operations"] > single["operations"]
    assert fused_fixed.launch(toys.config(8), traffic, 3) is None
    assert fused_fixed.launch(toys.config(8, "fixed"), traffic, 3) is None
    for sizes in ({"n_moves_per_step": 4}, {"accept_draws": 4}):
        assert fused_fixed.launch(weighted, toys.traffic("batch", **sizes), 3) is None


def fixed_cell(n: int = 8, trace: bool = False) -> dict:
    per_layer = [m for m in BENCH["per_layer"] if "scene100_fixed.batch" in m.get("workloads", [])
                 or "workloads" not in m]
    return toys.cell(f"toy{n}_fixed.batch", toys.config(n, "fixed", w_offlimits=-1.5),
                     toys.traffic("batch"), BENCH["end_to_end"], per_layer if trace else [])


def outcome(spec: dict, trace: bool = False) -> dict:
    out = run.run_cell(spec, SEED, 0.3, trace, "cpu")
    assert out["attempted"] >= 1 and out["failed"] == 0
    return out


def test_sound_weighted_fixed_batch_is_correct():
    out = outcome(fixed_cell())
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0.0 for c in out["checks"].values())
    assert {"proposals_per_s", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("n,state", [(8, 0.0), (64, 100.0)])
def test_traced_cell_reads_which_off_limits_path_ran(n, state):
    """At 8 objects (one slab) the kernel's plain version sums the rows from
    scratch, at 64 (8 slabs, 512 cells) it keeps the slab state. The CPU
    runs no ``fused_mh_kernel(``, so the roofline has nothing to read."""
    assert F.off_incremental(1, n, len(demo_scene(n).clearances)) is bool(state)
    out = outcome(fixed_cell(n, trace=True), trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"]["kernel.off_state_pct"]["value"] == state
    assert "kernel.fused_fixed_roofline" not in out["metrics"]
    assert out["metrics"]["host.pack.hit_pct"]["value"] == 100.0


def test_the_bfloat16_control_is_not_correct(monkeypatch):
    spec = fixed_cell()

    def control(program, key):
        return layouts_entry.expected(spec["config"], spec["traffic"], [key], "cpu",
                                      torch.bfloat16)[0]

    monkeypatch.setattr(layouts_entry, "call", control)
    monkeypatch.setattr(layouts_entry, "record", lambda traffic, result: result)
    out = outcome(spec)
    assert not out["correct"]
    assert out["checks"]["chains_apart_pct"]["value"] > out["checks"]["chains_apart_pct"]["limit"]


def traced(config: dict, traffic: dict, keys: list, kernel_us: list):
    device = [(KERNEL, 0, 100.0 + 1000 * i, 100.0 + 1000 * i + t)
              for i, t in enumerate(kernel_us)]
    calls = [(1000.0 * i, 1000.0 * i + 999) for i in range(len(keys))]
    return run.TraceContext(Trace(calls, device, [], cards=1), config, traffic, keys,
                            traffic["sampler"]["iterations"], None)


def test_roofline_is_the_summed_bound_over_the_summed_kernel_time():
    weighted = toys.config(8, "fixed", w_offlimits=-1.5)
    traffic = toys.traffic("batch")
    keys, times = [11, 2**31 + 3], [250.0, 150.0]
    read = run.load_reader("kernel.fused_fixed_roofline")
    bound = sum(fused_fixed.launch(weighted, traffic, k)["bound_s"] for k in keys)
    assert read(traced(weighted, traffic, keys, times)) == pytest.approx(
        100.0 * bound / 400e-6, rel=1e-12)
    assert read(traced(weighted, traffic, keys, times[:1])) is None  # a launch not traced
    assert read(traced(toys.config(8), traffic, keys, times)) is None  # PARITY: no count
    assert read(traced(weighted, traffic, keys, [])) is None


@pytest.mark.parametrize("names, want", [
    (["mh.off_state"] * 3, 100.0), (["mh.off_rows"] * 2, 0.0),
    (["mh.off_state", "mh.off_rows", "mh.off_state", "mh.off_state"], 75.0), ([], None)])
def test_off_state_pct_counts_state_ranges_over_off_ranges(names, want):
    host = [("mh.launch", 0, 1000)] + [(n, 10 + 100 * k, 11 + 100 * k)
                                       for k, n in enumerate(names)]
    ctx = SimpleNamespace(trace=Trace([(0, 1000)], [], host, cards=1))
    assert run.load_reader("kernel.off_state_pct")(ctx) == want
    outside = SimpleNamespace(trace=Trace([(2000, 3000)], [], host, cards=1))
    assert run.load_reader("kernel.off_state_pct")(outside) is None


@pytest.mark.parametrize("name", NEW_METRICS)
def test_new_readers_import_nothing_of_the_program(name):
    path = ROOT / "portbench" / "metrics" / f"{name}.py"
    assert not top_level_imports(path) & (JAX | {"mh_tpu_torch"})
