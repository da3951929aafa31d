"""Scenes with many design guidelines, on the CPU: a clearance on every
object and a distance and an angle relationship on each pair of objects
(2i, 2i + 1), as the benchmark's ``scene100_guidelines`` configuration
lays them out at 100 objects (``portbench/configs/scene100_guidelines.json``).

At 16 objects (16 clearances, 8 + 8 rows) the fused chain's plain version,
called through ``suggest_layouts``, is held bitwise to the frozen plain
reference in ``portbench/reference`` (pose, breakdown and accept count of
every chain). The torch engine's breakdown is held bitwise to the port's
own objective at the returned pose, and to the frozen reference's within
the benchmark judge's ``cost_gap`` limit: the two sum the rows in another
order. Tests/test_torch_cuda.py holds the CUDA kernel to the plain
version at 100 objects.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import mh_tpu_torch
from mh_tpu_torch.api import auto_engine
from mh_tpu_torch.config import SamplerConfig
from mh_tpu_torch.kernels import fused_mh as TF
from portbench.entries import suggest_layouts as layouts_entry
from portbench.reference import fused as rf
from portbench.reference import scene as rs
from portbench.tests.toys import scene_of

import test_torch_threads  # noqa: F401

QUADS = (np.array([[2.0, 2.0], [2.0, 0.0], [0.0, 0.0], [0.0, 2.0]]),
         np.array([[3.0, 2.0], [3.0, 0.0], [1.0, 0.0], [1.0, 2.0]]))
CHAINS, ITERS = 8, 30
COST_GAP = 1e-4  # portbench/traffic/batch.json's limit


def guideline_spec(n: int, n_clr: int | None = None):
    """The harness scene at ``n`` objects with the harness's clearance quad
    i mod 2 anchored at every object i (at the first ``n_clr``, if given),
    and its distance row [2, 4] and angle row [0.7854, 1.9635] on each pair
    (2i, 2i + 1)."""
    return dataclasses.replace(
        mh_tpu_torch.demo_scene(n),
        relationships=[(2 * i, 2 * i + 1, 2.0, 4.0) for i in range(n // 2)],
        angle_relationships=[(2 * i, 2 * i + 1, 0.7854, 1.9635) for i in range(n // 2)],
        clearances=[(QUADS[i % 2], i) for i in range(n if n_clr is None else n_clr)])


SPEC = guideline_spec(16)
CONFIG = dict(mode="parity", scene=scene_of(SPEC))
TRAFFIC = dict(sampler=dict(iterations=ITERS, n_chains=CHAINS))


def call(engine: str, key: int):
    cfg = SamplerConfig(iterations=ITERS, n_chains=CHAINS)
    return mh_tpu_torch.suggest_layouts(SPEC.build(), cfg, key, SPEC.initial_pose(),
                                        engine=engine, device="cpu")


def test_the_scene_is_the_configurations_layout():
    import json
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "portbench" / "configs"
    config = json.loads((path / "scene100_guidelines.json").read_text())
    assert scene_of(guideline_spec(100)) == config["scene"]
    assert (len(SPEC.relationships), len(SPEC.angle_relationships), len(SPEC.clearances)) == (
        8, 8, 16)


@pytest.mark.parametrize("key", [3, 2**31 + 11])
def test_fused_call_equals_the_frozen_reference_bitwise(key):
    got = layouts_entry.record(TRAFFIC, call("fused", key))
    want = layouts_entry.expected(CONFIG, TRAFFIC, [key], "cpu", torch.float32)[0]
    for field in ("pose", "costs", "accepts"):
        assert got[field].dtype == want[field].dtype, field
        assert got[field].tobytes() == want[field].tobytes(), field
    # chains that never accept test nothing
    assert (got["accepts"] > 0).sum() >= CHAINS // 2, got["accepts"]


@pytest.mark.parametrize("key", [3, 2**31 + 11])
def test_torch_engine_breakdown_is_the_objective_at_its_pose(key):
    res = call("torch", key)
    pose = torch.as_tensor(res.points)
    own = mh_tpu_torch.cost_terms(pose, SPEC.build()).as_vector().numpy()
    assert res.costs.tobytes() == own.tobytes()
    ref = rf.breakdown(rf.pack(rs.build(CONFIG["scene"], "cpu"), layouts_entry.sampler(
        CONFIG, TRAFFIC)), pose).numpy()
    gap = np.abs(res.costs.astype(np.float64) - ref) / np.maximum(np.abs(ref), 1.0)
    assert gap.max() <= COST_GAP, gap.max()
    assert (res.accept_rate > 0).sum() >= CHAINS // 2, res.accept_rate


def test_shared_memory_and_the_auto_engine_at_many_clearances():
    """22 N + 6 + C + 6 x 128 words a block (a clearance row's partials
    stay in its warp's registers, so a clearance takes one word, its sum):
    12,296 B at 100 objects and 100 clearances (the 8 blocks an SM that the
    kernel's registers allow on an H100), so ``auto`` takes the kernel on a
    card; past 54,882 clearances at 100 objects a block no longer fits and
    ``auto`` takes ``torch_graph``."""
    cfg = SamplerConfig()
    assert TF.smem_bytes(100, 100, 1, False) == 4 * (22 * 100 + 106 + 6 * 128) == 12_296
    assert TF.kernel_takes(cfg, 100, 54_882, False)
    assert not TF.kernel_takes(cfg, 100, 54_883, False)
    assert auto_engine("cuda", cfg, 100, 100, False) == "fused"
    assert auto_engine("cuda", cfg, 100, 54_883, False) == "torch_graph"
    assert auto_engine("cpu", cfg, 100, 100, False) == "torch"


def _took_before(cfg, n, n_clr, track_off):
    """``kernel_takes`` with the layout in which every reduced row, the
    clearance rows too, kept THREADS strided partials in shared memory:
    22 N + (6 + C) x 129 words, the move table, and the off-limits state
    where it then fitted."""
    moves = cfg.n_moves_per_step
    table = TF.N_MOVE_ROWS * TF.THREADS if moves > 1 else 0
    base = 22 * n + (6 + n_clr) * (1 + TF.THREADS) + table
    state = TF._off_state_words(n, moves)
    s = TF.off_slabs(n)
    keeps = (track_off and 2 * moves < s and s * n > 3 * TF.THREADS
             and 4 * (base + state) <= TF.MAX_SMEM)
    return (1 <= cfg.accept_draws <= TF.MAX_ACCEPT_DRAWS
            and 4 * (base + (state if keeps else 0)) <= TF.MAX_SMEM)


@pytest.mark.parametrize("track_off", [False, True])
@pytest.mark.parametrize("moves", [1, 4, 64])
def test_kernel_takes_every_scene_it_took_with_the_partials_in_shared_memory(moves, track_off):
    """Taking the clearance rows' partials out of shared memory loses no
    scene: every (objects, clearances) the kernel took with them it takes
    now, and the largest of each grid line it took is not its limit now."""
    cfg = SamplerConfig(n_moves_per_step=moves, accept_draws=moves)
    took = 0
    for n in (32, 100, 512, 1455, 1461, 2548, 2582):
        for n_clr in (2, 100, 425):
            if _took_before(cfg, n, n_clr, track_off):
                took += 1
                assert TF.kernel_takes(cfg, n, n_clr, track_off), (n, n_clr)
    assert took >= 12
    assert TF.kernel_takes(cfg, 2548 if moves > 1 else 2582, 102, track_off)
    assert TF.kernel_takes(cfg, 100, 426, track_off)
