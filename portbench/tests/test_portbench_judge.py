"""The comparison that decides ``correct``, driven through whole runs on the
CPU at toy size: sound runs pass; the control (the reference in bfloat16
in the program's place) and each fault a cell can have, planted under the
timed path, fail.

``run.run_cell`` is the benchmark's run without its look for a card; the
fused kernel's plain version stands in for the kernel here.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pytest
import torch

import mh_tpu_torch.kernels.fused_mh as F
import mh_tpu_torch.sampler.tempering as T
from portbench import judge, run
from portbench.entries import run_tempered as tempered_entry
from portbench.entries import suggest_layouts as layouts_entry
from portbench.tests import toys

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SEED = 2**31 + 17
ENTRIES = {"suggest_layouts": layouts_entry, "run_tempered": tempered_entry}


def cell(mix: str, trace: bool = False, **sizes) -> dict:
    return toys.cell(f"toy.{mix}", toys.config(8), toys.traffic(mix, **sizes),
                     BENCH["end_to_end"], [] if not trace else BENCH["per_layer"])


def outcome(spec: dict, trace: bool = False) -> dict:
    out = run.run_cell(spec, SEED, 0.3, trace, "cpu")
    assert out["attempted"] >= 1 and out["failed"] == 0
    return out


@pytest.mark.parametrize("mix", ["batch", "interactive", "tempering", "batch_cards4"])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_runs_are_correct(mix, trace):
    out = outcome(cell(mix, trace), trace)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0.0 for c in out["checks"].values())
    assert list(out)[-1] == "checks"
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert {"proposals_per_s", "setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("mix", ["batch", "interactive", "tempering", "batch_cards4"])
def test_the_bfloat16_control_is_not_correct(mix, monkeypatch):
    spec = cell(mix)
    entry = ENTRIES[spec["traffic"]["entry"]]

    def control(program, key):
        return entry.expected(spec["config"], spec["traffic"], [key], "cpu", torch.bfloat16)[0]

    monkeypatch.setattr(entry, "call", control)
    monkeypatch.setattr(entry, "record", lambda traffic, result: result)
    out = outcome(spec)
    assert not out["correct"]
    assert out["checks"]["chains_apart_pct"]["value"] > out["checks"]["chains_apart_pct"]["limit"]


def _fused_fault(kind: str):
    run_plain = F._run

    def faulty(pk, pose0, seed, iterations, first_chain):
        c = pose0.shape[0]
        if kind == "state_unchanged":
            return run_plain(pk, pose0, seed, 0, first_chain)
        if kind == "half_batch":
            half = run_plain(pk, pose0[:c // 2], seed, iterations, first_chain)
            return tuple(torch.cat([t, t]) for t in half)
        if kind == "shards_not_exchanged":  # every shard keyed as global chain 0
            parts = [run_plain(pk, p, seed, iterations, 0) for p in pose0.chunk(4)]
            return tuple(torch.cat(ts) for ts in zip(*parts))
        pose, *rest = run_plain(pk, pose0, seed, iterations, first_chain)
        pose = pose.clone()
        pose[c // 2, 0, 0] += 0.5  # one answer altered where it is produced
        return (pose, *rest)

    return faulty


LAYOUT_FAULTS = [(mix, fault) for mix in ("batch", "interactive", "batch_cards4")
                 for fault in ("state_unchanged", "half_batch", "answer_altered")]
LAYOUT_FAULTS.append(("batch_cards4", "shards_not_exchanged"))  # the every-card cell alone


@pytest.mark.parametrize("mix,fault", LAYOUT_FAULTS)
def test_layout_faults_are_not_correct(mix, fault, monkeypatch):
    monkeypatch.setattr(F, "_run", _fused_fault(fault))
    out = outcome(cell(mix, n_chains=8))
    assert not out["correct"], (fault, out["checks"])


def _tempering_fault(kind: str, monkeypatch):
    if kind == "state_unchanged":
        monkeypatch.setattr(T, "advance", lambda steps, states, n, **kw: states)
    elif kind == "exchange_left_out":
        monkeypatch.setattr(T, "with_rows", lambda states, rows, accept: states)
    elif kind == "half_batch":
        advance = T.advance

        def half(steps, states, n, **kw):
            out = advance(steps, states, n, **kw)
            k = out[0].pose.shape[0] // 2
            return [s.map(lambda t: torch.cat([t[:k], t[:k]])) for s in out]

        monkeypatch.setattr(T, "advance", half)
    else:
        concat = T.concat_states

        def altered(parts):
            st = concat(parts)
            pose = st.pose.clone()
            pose[1, 0, 0] += 0.5
            return dataclasses.replace(st, pose=pose)

        monkeypatch.setattr(T, "concat_states", altered)


@pytest.mark.parametrize("fault", ["state_unchanged", "exchange_left_out", "half_batch",
                                   "answer_altered"])
def test_tempering_faults_are_not_correct(fault, monkeypatch):
    _tempering_fault(fault, monkeypatch)
    out = outcome(cell("tempering"))
    assert not out["correct"], (fault, out["checks"])


def test_judge_counts_chains_apart_and_the_widest_gap():
    want = dict(pose=torch.zeros(4, 3, 6).numpy(), costs=torch.ones(4, 8).numpy(),
                accepts=torch.zeros(4, dtype=torch.int64).numpy())
    got = {k: v.copy() for k, v in want.items()}
    got["pose"][1, 2, 0] = 1e-3
    got["costs"][3, 5] = 1.5
    values, rows = judge.numbers([got], [want], [want["costs"].astype("float64")])
    assert rows == 4 and values["chains_apart_pct"] == 50.0
    assert values["cost_gap"] == pytest.approx(0.5)
    got["costs"][0, 0] = float("nan")
    values, _ = judge.numbers([got], [want], [want["costs"].astype("float64")])
    assert values["chains_apart_pct"] == 75.0 and values["cost_gap"] == judge.NOT_FINITE
    ok, checks = judge.verdict(values, {"chains_apart_pct": 80.0, "cost_gap": 1.0})
    assert not ok and checks["cost_gap"]["limit"] == 1.0
