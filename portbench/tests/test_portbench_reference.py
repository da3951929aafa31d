"""The frozen reference against the port's own CPU runs at toy size, bit for
bit; the configurations' scenes against the port's ``demo_scene``; and the
kernel count against ``chip_smoke.fused_bound``."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from mh_tpu_torch.config import CostMode, SamplerConfig
from mh_tpu_torch.kernels import fused_mh as F
from mh_tpu_torch.models.scene import demo_scene
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.mh import run_chains
from mh_tpu_torch.sampler.tempering import run_tempered
from portbench.counts import fused_single
from portbench.entries.suggest_layouts import scene_spec
from portbench.reference import engine as re
from portbench.reference import fused as rf
from portbench.reference import scene as rs
from portbench.reference import threefry as tf
from portbench.tests import toys

ROOT = Path(__file__).resolve().parents[2]
SEEDS = (7, 2**31 + 5)
CASES = {  # (mode, weights, moves per step, accept draws)
    "parity": ("parity", {}, 1, 1),
    "fixed_offlimits": ("fixed", {"w_offlimits": -1.5}, 1, 1),
    "fixed": ("fixed", {}, 1, 1),
    "compound": ("parity", {}, 4, 4),
    "accept_draws": ("parity", {}, 1, 16),
}


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.contiguous(), b.contiguous()
    if a.dtype.is_floating_point:
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def port_config(mode: str, moves: int, draws: int, iterations: int = 20, n_chains: int = 4):
    return SamplerConfig(iterations=iterations, n_chains=n_chains, n_moves_per_step=moves,
                         accept_draws=draws, mode=CostMode(mode))


@pytest.mark.parametrize("n", [32, 100])
def test_configuration_scene_is_the_ports_demo_scene(n):
    name = {32: "harness32_parity", 100: "scene100_parity"}[n]
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())
    want = demo_scene(n).build().to_numpy()
    got = scene_spec(cfg["scene"]).build().to_numpy()

    def flat(d, pre=""):
        for k, v in d.items():
            yield from flat(v, pre + k + ".") if isinstance(v, dict) else [(pre + k, v)]

    for (k, a), (_, b) in zip(flat(want), flat(got)):
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert toys.scene_of(demo_scene(n)) == cfg["scene"]


@pytest.mark.parametrize("case", CASES)
def test_reference_scene_and_pack_match_the_port(case):
    mode, weights, moves, draws = CASES[case]
    conf = toys.config(8, mode, **weights)
    scene = scene_spec(conf["scene"]).build()
    pk = F.pack_scene(scene, port_config(mode, moves, draws))
    ref = rf.pack(rs.build(conf["scene"]), rf.Sampler(n_moves_per_step=moves, accept_draws=draws,
                                                      parity=mode == "parity"))
    for name in ("planes", "scalars", "rel_idx", "rel_p", "ang_idx", "ang_p", "clr_idx", "clr_p"):
        assert same_bits(getattr(pk, name), getattr(ref, name)), name
    assert (pk.track_off, pk.parity) == (ref.track_off, ref.parity)


@pytest.mark.parametrize("case", CASES)
def test_fused_reference_equals_the_ports_plain_version(case):
    mode, weights, moves, draws = CASES[case]
    conf = toys.config(8, mode, **weights)
    spec = scene_spec(conf["scene"])
    cfg = port_config(mode, moves, draws)
    pk = F.pack_scene(spec.build(), cfg)
    pose0 = spec.initial_pose()
    rpk = rf.pack(rs.build(conf["scene"]), rf.Sampler(n_moves_per_step=moves, accept_draws=draws,
                                                      parity=mode == "parity"))
    # two runs of 4 chains each, the second from global chain 4, in one batch
    want = [F.fused_chains_reference(pk, pose0.expand(4, -1, -1), seed, 20, first)
            for seed, first in zip(SEEDS, (0, 4))]
    seeds = torch.tensor([SEEDS[0]] * 4 + [SEEDS[1]] * 4)
    got = rf.chains(rpk, pose0.expand(8, -1, -1), seeds, torch.arange(8), 20)
    for w, g in zip(zip(*want), got):
        assert same_bits(torch.cat(w), g)
    assert int(got[2].sum()) > 0  # some chains accepted, so the moves were tested


@pytest.mark.parametrize("case", CASES)
def test_engine_reference_equals_the_ports_torch_engine(case):
    mode, weights, moves, draws = CASES[case]
    conf = toys.config(8, mode, **weights)
    spec = scene_spec(conf["scene"])
    cfg = port_config(mode, moves, draws)
    states, _ = run_chains(prng.key(SEEDS[1]), spec.initial_pose(), spec.build(), cfg)
    step = re.Step(rs.build(conf["scene"]), rf.Sampler(n_moves_per_step=moves, accept_draws=draws,
                                                       parity=mode == "parity"))
    st = step.init(*re.chain_starts(tf.key(SEEDS[1]), rs.initial_pose(conf["scene"]), 4))
    for _ in range(20):
        st = step(st)
    st = step.finalize(st)
    assert same_bits(states.pose, st.pose)
    assert same_bits(states.costs.as_vector(), st.costs)
    assert same_bits(states.n_accept, st.n_accept)
    assert int(st.n_accept.sum()) > 0


@pytest.mark.parametrize("mode", ["parity", "fixed"])
def test_tempering_reference_equals_the_ports_run_tempered(mode):
    conf = toys.config(8, mode)
    spec = scene_spec(conf["scene"])
    kw = dict(n_replicas=8, exchange_every=2, rounds=3)
    states, rates = run_tempered(prng.key(SEEDS[0]), spec.initial_pose(), spec.build(),
                                 SamplerConfig(mode=CostMode(mode)), **kw)
    st, ref_rates = re.tempered(tf.key(SEEDS[0]), rs.initial_pose(conf["scene"]),
                                rs.build(conf["scene"]), rf.Sampler(parity=mode == "parity"), **kw)
    assert same_bits(states.pose, st.pose)
    assert same_bits(states.costs.as_vector(), st.costs)
    assert same_bits(states.n_accept, st.n_accept)
    assert same_bits(rates, ref_rates) and float(rates.sum()) > 0  # some replicas swapped


@pytest.mark.parametrize("seed", SEEDS)
def test_count_equals_chip_smokes_fused_bound(seed):
    import chip_smoke

    conf = toys.config(8)
    cfg = port_config("parity", 1, 1, iterations=40, n_chains=16)
    pk = F.pack_scene(scene_spec(conf["scene"]).build(), cfg)
    want = chip_smoke.fused_bound(F, pk, seed, 40, 16, "cpu")
    got = fused_single.count(**fused_single.sizes(conf["scene"]), n_chains=16, iterations=40,
                             seed=seed)
    assert (got["operations"], got["bytes"], got["bound_by"]) == (
        want["operations"], want["bytes"], want["bound_by"])
    assert got["bound_s"] * 1e3 == pytest.approx(want["bound_ms"], rel=1e-12)
    assert got["moved_lanes_per_step"] == want["moved_lanes_per_step"]


def test_count_is_left_out_where_it_does_not_apply():
    conf = toys.config(8, "fixed", w_offlimits=-1.5)
    traffic = toys.traffic("batch")
    assert fused_single.launch(conf, traffic, 3) is None
    traffic["sampler"]["n_moves_per_step"] = 4
    assert fused_single.launch(toys.config(8), traffic, 3) is None
