"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports neither JAX nor mh_tpu, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The fused kernel sums in the plain version's order and is built without
contracted multiply-adds, so on one card the two agree exactly; the pi
kernel counts exactly the plain version's hits.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mh_tpu_torch
from mh_tpu_torch.kernels import _build
from mh_tpu_torch.kernels import fused_mh as TF
from mh_tpu_torch.kernels import pi_kernel as TP

pytestmark = pytest.mark.cuda
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def every_card_launches(n_chains: int) -> int:
    """The fused launches of one ``suggest_layouts`` call on the card: one
    per card where the host's cards divide the chains (the call spans them
    all), else one."""
    k = torch.cuda.device_count()
    return k if k > 1 and n_chains % k == 0 else 1


def test_uniform_block_bits(cuda):
    for seed, counter, first in ((0, 0, 0), (7, 3, 40), (-5, 999, 1 << 20)):
        got = TF.uniform_block_cuda(seed, counter, first, 64, cuda)
        want = TF.uniform_block(seed, counter, first, 64, cuda)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("mode,w_off", [("PARITY", 0.0), ("FIXED", 0.0), ("FIXED", -1.5)])
def test_kernel_matches_reference(cuda, mode, w_off):
    spec = mh_tpu_torch.demo_scene(32)
    scene = dataclasses.replace(
        spec.build(device=cuda), w_offlimits=torch.tensor(w_off, device=cuda))
    cfg = mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode[mode], adapt=mode == "FIXED")
    pk = TF.pack_scene(scene, cfg)
    pose0 = spec.initial_pose(device=cuda).expand(64, 32, 6).contiguous()
    launches = TF.fused_mh_cuda.launches
    got = TF.fused_mh_cuda(pk, pose0, 5, 50)
    assert TF.fused_mh_cuda.launches == launches + 1
    want = TF.fused_chains_reference(pk, pose0, 5, 50)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("moves,draws", [(4, 1), (4, 4), (1, 16), (1, 30)])
@pytest.mark.parametrize("mode,w_off", [("PARITY", 0.0), ("FIXED", -1.5)])
def test_compound_kernel_matches_reference(cuda, moves, draws, mode, w_off):
    spec = mh_tpu_torch.demo_scene(32)
    scene = dataclasses.replace(
        spec.build(device=cuda), w_offlimits=torch.tensor(w_off, device=cuda))
    cfg = mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode[mode], adapt=mode == "FIXED",
                                     n_moves_per_step=moves, accept_draws=draws)
    pk = TF.pack_scene(scene, cfg)
    pose0 = spec.initial_pose(device=cuda).expand(64, 32, 6).contiguous()
    got = TF.fused_mh_cuda(pk, pose0, 9, 40)
    want = TF.fused_chains_reference(pk, pose0, 9, 40)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case,n,moves,draws", [
    ("ragged", 37, 1, 1), ("ragged", 37, 4, 4), ("frozen", 32, 1, 1), ("neg_zero", 32, 1, 1),
    ("wide", 256, 1, 1), ("full_rescan", 3, 1, 1)])
def test_symmetry_state_matches_reference(cuda, case, n, moves, draws):
    """The kernel's O(N) symmetry state (rescanning every row where that is
    cheaper: 3 objects) against the plain version's full match, in every
    chain, at beta = 1e-3 where most steps commit."""
    spec = mh_tpu_torch.demo_scene(n)
    if case == "frozen":
        spec.frozen = [i % 3 == 0 for i in range(n)]
    cfg = mh_tpu_torch.SamplerConfig(beta=1e-3, adapt=True, n_moves_per_step=moves,
                                     accept_draws=draws)
    pk = TF.pack_scene(spec.build(device=cuda), cfg)
    pose0 = spec.initial_pose(device=cuda).expand(64, n, 6).clone()
    if case == "neg_zero":
        pose0[:, ::2, 2:] = -0.0
        pose0[:, 0, :2] = -0.0
    got = TF.fused_mh_cuda(pk, pose0, 3, 60)
    want = TF.fused_chains_reference(pk, pose0, 3, 60)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert (got[2] > 0).all()


@pytest.mark.parametrize("n,moves,draws,chains", [
    (37, 1, 1, 64), (61, 1, 1, 64), (100, 1, 1, 64), (100, 4, 4, 64), (32, 64, 64, 64),
    (512, 1, 1, 16), (1100, 1, 1, 4), (1500, 1, 1, 2)])
def test_off_state_matches_reference(cuda, n, moves, draws, chains):
    """Weighted FIXED: the kernel's off-limits slab sums (the state's
    updated cells, or rows from scratch where 2 M >= S, the cells are few
    or, past 1,461 objects, the state does not fit in shared memory)
    against the plain version's from-scratch slab sums, in every chain,
    hot."""
    spec = mh_tpu_torch.demo_scene(n)
    scene = dataclasses.replace(spec.build(device=cuda),
                                w_offlimits=torch.tensor(-1.5, device=cuda))
    cfg = mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode.FIXED, beta=1e-3, adapt=True,
                                     n_moves_per_step=moves, accept_draws=draws)
    pk = TF.pack_scene(scene, cfg)
    assert pk.track_off
    pose0 = spec.initial_pose(device=cuda).expand(chains, n, 6).contiguous()
    got = TF.fused_mh_cuda(pk, pose0, 3, 40)
    want = TF.fused_chains_reference(pk, pose0, 3, 40)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert (got[2] > 0).all()


@pytest.mark.parametrize("mode,w_off", [("PARITY", 0.0), ("FIXED", -1.5)])
def test_compound_neg_zero_matches_reference(cuda, mode, w_off):
    """A start pose holding -0.0 through (M, K) = (4, 4) steps: the kernel
    applies each move to every lane, as the reference's plane expressions
    do, so the zeros' signs equal the plain version's in every chain."""
    spec = mh_tpu_torch.demo_scene(32)
    scene = dataclasses.replace(spec.build(device=cuda),
                                w_offlimits=torch.tensor(w_off, device=cuda))
    cfg = mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode[mode], beta=1e-3,
                                     n_moves_per_step=4, accept_draws=4)
    pk = TF.pack_scene(scene, cfg)
    pose0 = spec.initial_pose(device=cuda).expand(64, 32, 6).clone()
    pose0[:, ::2, 2:] = -0.0
    pose0[:, 0, :2] = -0.0
    got = TF.fused_mh_cuda(pk, pose0, 3, 60)
    want = TF.fused_chains_reference(pk, pose0, 3, 60)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert (got[2] > 0).all()
    assert not torch.signbit(got[0][got[0] == 0]).all()


def test_accept_count_exact_past_2_24(cuda):
    """One chain accepting every one of 2^24 + 1 steps (beta = 0, and the
    minimum of 2 accept draws is never 1.0): the count comes back exact,
    where f32 would have rounded it to 2^24."""
    spec = mh_tpu_torch.demo_scene(2)
    cfg = mh_tpu_torch.SamplerConfig(beta=0.0, accept_draws=2)
    pk = TF.pack_scene(spec.build(device=cuda), cfg)
    steps = (1 << 24) + 1
    _, _, n_acc, _ = TF.fused_mh_cuda(pk, spec.initial_pose(device=cuda)[None].contiguous(), 0,
                                      steps)
    assert n_acc.dtype == torch.int32 and n_acc.tolist() == [steps]


@pytest.mark.parametrize("seed,total", [(0, 1 << 24), (7, 12345), (-3, (1 << 22) + 1), (1, 0)])
def test_pi_hits_equal_reference(cuda, seed, total):
    launches = TP.pi_hits_cuda.launches
    assert TP.pi_hits_cuda(seed, total, cuda) == TP.pi_hits_reference(seed, total, cuda)
    assert TP.pi_hits_cuda.launches == launches + 1


def test_estimate_pi_fused_on_card(cuda):
    calls = TP.pi_hits_reference.calls
    est, total = TP.estimate_pi_fused(0, 1 << 28, device=cuda)
    assert total == 1 << 28
    sigma = 4 * math.sqrt((math.pi / 4) * (1 - math.pi / 4) / total)
    assert abs(est - math.pi) < 6 * sigma
    assert (est, total) == TP.estimate_pi_fused(0, 1 << 28, device=cuda)
    assert TP.pi_hits_reference.calls == calls


def test_estimate_pi_defaults_to_cuda(cuda):
    n = 1 << 20
    sigma = 4 * math.sqrt((math.pi / 4) * (1 - math.pi / 4) / n)
    assert abs(mh_tpu_torch.estimate_pi(0, n_samples=n) - math.pi) < 6 * sigma


@pytest.mark.parametrize("seed", [0, 7])
def test_estimate_pi_on_card_equals_cpu(cuda, seed):
    """The plain estimator draws the threefry stream, whose bits are the
    same on the card and the CPU: the same hits, the same estimate."""
    assert mh_tpu_torch.estimate_pi(seed, 1 << 22) == mh_tpu_torch.estimate_pi(
        seed, 1 << 22, device="cpu")


def test_spec_runs_on_cuda_by_default(cuda):
    launches, calls = TF.fused_mh_cuda.launches, TF.fused_chains_reference.calls
    res = mh_tpu_torch.suggest_layouts(
        mh_tpu_torch.demo_scene(10), mh_tpu_torch.SamplerConfig(iterations=20, n_chains=4))
    assert TF.fused_mh_cuda.launches == launches + every_card_launches(4)
    assert TF.fused_chains_reference.calls == calls
    assert res.costs.shape == (4, 8)


def test_traced_call_leaves_no_span_on_the_cards(cuda):
    """The call path's spans are host ops: a traced batch call (a built
    scene, the fused kernel) records them on the CPU and puts none of them,
    nor any copy of them, on a card's timeline beside its kernels."""
    spec = mh_tpu_torch.demo_scene(32)
    scene, pose0 = spec.build(device=cuda), spec.initial_pose(device=cuda)
    cfg = mh_tpu_torch.SamplerConfig(iterations=50, n_chains=64)
    mh_tpu_torch.suggest_layouts(scene, cfg, 1, pose0)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        mh_tpu_torch.suggest_layouts(scene, cfg, 2, pose0)
    on_card = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [e for e in prof.events() if e.name.startswith("mh.")]
    assert any("fused_mh" in e.name for e in on_card)
    assert {e.name for e in spans} >= {"mh.suggest_layouts", "mh.pack_scene", "mh.launch",
                                       "mh.readback"}
    assert not [e.name for e in spans if e.device_type == torch.autograd.DeviceType.CUDA]


def test_run_chains_fused_launches_the_kernel(cuda):
    spec = mh_tpu_torch.demo_scene(12)
    launches, calls = TF.fused_mh_cuda.launches, TF.fused_chains_reference.calls
    out = TF.run_chains_fused(1, spec.initial_pose(), spec.build(),
                              mh_tpu_torch.SamplerConfig(), 16, 40, device=cuda)
    assert TF.fused_mh_cuda.launches == launches + 1
    assert TF.fused_chains_reference.calls == calls
    assert all(t.device.type == "cuda" for t in out)
    ref = mh_tpu_torch.cost_terms(out[0], spec.build(device=cuda)).as_vector()
    torch.testing.assert_close(out[1], ref, rtol=2e-4, atol=2e-3)


def test_too_many_objects_for_shared_memory_raise(cuda):
    spec = mh_tpu_torch.demo_scene(6000)
    pk = TF.pack_scene(spec.build(device=cuda), mh_tpu_torch.SamplerConfig())
    with pytest.raises(ValueError, match="shared"):
        TF.fused_mh_cuda(pk, spec.initial_pose(device=cuda)[None].contiguous(), 0, 1)


def test_threefry_bits_equal_on_card_and_cpu(cuda):
    from mh_tpu_torch.sampler import prng

    steps = torch.arange(256) * 7919 + 2**31  # data >= 2^31
    for seed in (0, -1, 2**31 + 5):
        got = prng.fold_in(prng.fold_in(prng.key(seed, cuda), torch.arange(256, device=cuda)),
                           steps.to(cuda))
        want = prng.fold_in(prng.fold_in(prng.key(seed), torch.arange(256)), steps)
        assert torch.equal(got.cpu(), want)
        for shape in ((64, 8), (64,)):
            u, uc = prng.uniform(got, shape), prng.uniform(want, shape)
            assert torch.equal(u.cpu().view(torch.int32), uc.view(torch.int32))


@pytest.mark.parametrize("kw", [dict(), dict(n_moves_per_step=8, accept_draws=8, adapt=True,
                                              beta=0.01)])
def test_graph_engine_bitwise_equals_eager_and_logged(cuda, kw):
    """torch_graph (one step captured as a CUDA graph) and a run logged in
    rounds both give the one-shot torch engine's bits, and launch no
    kernel of the port."""
    import io

    spec = mh_tpu_torch.demo_scene(24)
    cfg = mh_tpu_torch.SamplerConfig(iterations=40, n_chains=64, **kw)
    launches = TF.fused_mh_cuda.launches
    eager = mh_tpu_torch.suggest_layouts(spec, cfg, key=3, engine="torch")
    graph = mh_tpu_torch.suggest_layouts(spec, cfg, key=3, engine="torch_graph")
    logs = {e: io.StringIO() for e in ("torch", "torch_graph")}
    logged = [mh_tpu_torch.suggest_layouts(spec, cfg, key=3, engine=e, log=log, log_every=15)
              for e, log in logs.items()]
    assert TF.fused_mh_cuda.launches == launches
    for other in (graph, *logged):
        for field in ("points", "costs", "accept_rate", "step_scale"):
            assert getattr(other, field).tobytes() == getattr(eager, field).tobytes(), field
    for log in logs.values():
        events = [json.loads(line)["event"] for line in log.getvalue().splitlines()]
        assert events.count("round") == 3 and events[-1] == "result"
    assert (eager.accept_rate > 0).sum() > 32


def test_auto_on_card_launches_the_fused_kernel(cuda):
    launches = TF.fused_mh_cuda.launches
    res = mh_tpu_torch.suggest_layouts(
        mh_tpu_torch.demo_scene(16), mh_tpu_torch.SamplerConfig(iterations=10, n_chains=8))
    assert TF.fused_mh_cuda.launches == launches + every_card_launches(8)
    assert res.accept_rate.dtype.name == "float64"


def test_tempering_and_smc_run_on_card(cuda):
    from mh_tpu_torch.sampler import prng, run_smc, run_tempered

    spec = mh_tpu_torch.demo_scene(16)
    cfg = mh_tpu_torch.SamplerConfig()
    states, rates, betas = run_tempered(prng.key(0, cuda), spec.initial_pose(device=cuda),
                                        spec.build(device=cuda), cfg, None, 16, rounds=6,
                                        adapt_ladder=True)
    assert states.pose.device.type == "cuda" and rates.shape == (6,) and betas.shape == (16,)
    states, diag = run_smc(prng.key(0, cuda), spec.initial_pose(device=cuda),
                           spec.build(device=cuda), cfg, None, 16, n_stages=4, mutate_steps=2,
                           adaptive=True, init="prior")
    assert states.pose.device.type == "cuda" and torch.isfinite(diag["log_evidence"])


@pytest.mark.parametrize("mode,w_off,moves", [("PARITY", 0.0, 1), ("FIXED", -1.5, 1),
                                               ("PARITY", 0.0, 8)])
def test_fused_sharded_on_one_card_equals_one_launch(cuda, mode, w_off, moves):
    """Four shards of one card: four launches, each keyed by its first
    global chain, bitwise equal to one launch in every chain."""
    from mh_tpu_torch.parallel.mesh import chain_mesh

    spec = mh_tpu_torch.demo_scene(24)
    scene = dataclasses.replace(spec.build(device=cuda),
                                w_offlimits=torch.tensor(w_off, device=cuda))
    cfg = mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode[mode], beta=1e-3, adapt=True,
                                     n_moves_per_step=moves, accept_draws=moves)
    pose0 = spec.initial_pose(device=cuda)
    want = TF.run_chains_fused(4, pose0, scene, cfg, 64, 40)
    launches, calls = TF.fused_mh_cuda.launches, TF.fused_chains_reference.calls
    got = TF.run_chains_fused_sharded(4, pose0, scene, cfg, 64, 40,
                                      chain_mesh(devices=[cuda] * 4))
    assert TF.fused_mh_cuda.launches == launches + 4
    assert TF.fused_chains_reference.calls == calls
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert (got[2] > 0).all()


def test_kernels_launch_on_the_tensors_card(cuda):
    """Each wrapper makes its tensors' device current before it launches:
    with card 0 current, the kernels run on card 1 and match card 0."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    from mh_tpu_torch.parallel.mesh import chain_mesh

    one = torch.device("cuda", 1)
    spec = mh_tpu_torch.demo_scene(16)
    cfg = mh_tpu_torch.SamplerConfig()
    with torch.cuda.device(0):
        got = TF.run_chains_fused(2, spec.initial_pose(), spec.build(), cfg, 32, 30, device=one)
        uni = TF.uniform_block_cuda(7, 3, 40, 64, one)
        hits = TP.pi_hits_cuda(0, 1 << 22, one)
        both = TF.run_chains_fused_sharded(2, spec.initial_pose(), spec.build(), cfg, 32, 30,
                                           chain_mesh(devices=[cuda, one]))
    torch.cuda.synchronize()
    assert got[0].device == one and uni.device == one
    want = TF.run_chains_fused(2, spec.initial_pose(), spec.build(), cfg, 32, 30,
                               device=torch.device("cuda", 0))
    for g, b, w in zip(got, both, want):
        assert torch.equal(g.cpu(), w.cpu()) and torch.equal(b.cpu(), w.cpu())
    assert torch.equal(uni.cpu(), TF.uniform_block(7, 3, 40, 64))
    assert hits == TP.pi_hits_reference(0, 1 << 22)


@pytest.mark.parametrize("mode,w_off", [("PARITY", 0.0), ("FIXED", -1.5)])
def test_objsharded_over_every_card_equals_one_card(cuda, mode, w_off):
    """The row-sharded objective with one objs shard per card equals the
    same mesh shape on card 0 alone bit for bit: each card scores its rows,
    the partials add in shard order on the row's first card."""
    k = torch.cuda.device_count()
    if k < 2:
        pytest.skip("needs a second card")
    from mh_tpu_torch.parallel.objshard import chain_obj_mesh, run_chains_objsharded
    from mh_tpu_torch.sampler import prng

    spec = dataclasses.replace(mh_tpu_torch.demo_scene(64 * k), w_offlimits=w_off)
    scene, pose0 = spec.build(device=cuda), spec.initial_pose(device=cuda)
    cfg = mh_tpu_torch.SamplerConfig(iterations=20, n_chains=4, mode=mh_tpu_torch.CostMode[mode],
                                     beta=1e-3)
    every = run_chains_objsharded(prng.key(3, cuda), pose0, scene, cfg, chain_obj_mesh(1, k))
    one = run_chains_objsharded(prng.key(3, cuda), pose0, scene, cfg,
                                chain_obj_mesh(1, k, devices=[torch.device("cuda", 0)] * k))
    for f in ("pose", "n_accept", "step", "key", "log_scale"):
        assert torch.equal(getattr(every, f), getattr(one, f)), f
    assert torch.equal(every.costs.as_vector(), one.costs.as_vector())
    assert (one.n_accept > 0).all()


def test_checkpoint_on_card_resumes_bitwise(cuda, tmp_path):
    """A CUDA state saved, restored onto the card (its template's device),
    and continued: bitwise the uninterrupted run."""
    from mh_tpu_torch.sampler import prng
    from mh_tpu_torch.sampler.mh import continue_chains, run_chains
    from mh_tpu_torch.utils.checkpoint import restore_state, save_state

    spec = mh_tpu_torch.demo_scene(32)
    scene, p0 = spec.build(device=cuda), spec.initial_pose(device=cuda)
    cfg = mh_tpu_torch.SamplerConfig(iterations=20, n_chains=64)
    mid, _ = run_chains(prng.key(3, cuda), p0, scene, cfg)
    path = str(tmp_path / "ck")
    save_state(path, mid)
    restored = restore_state(path, mid.map(torch.zeros_like))
    assert restored.pose.device.type == "cuda" and torch.equal(restored.key, mid.key)
    got = continue_chains(restored, scene, cfg)
    want = continue_chains(mid, scene, cfg)
    whole, _ = run_chains(prng.key(3, cuda), p0, scene,
                          dataclasses.replace(cfg, iterations=40))
    for s in (want, whole):
        assert torch.equal(got.pose, s.pose) and torch.equal(got.n_accept, s.n_accept)
    assert (got.n_accept > 0).any()


def test_summarize_chains_on_card_matches_cpu(cuda):
    """ESS, R-hat, mean and std of 1,024 chains x 1,000 steps on the card
    against the CPU, rtol 1e-4 (float32 sums in another order)."""
    import numpy as np

    from mh_tpu_torch.utils.metrics import summarize_chains

    rng = np.random.default_rng(0)
    noise = rng.standard_normal((1024, 1000)).astype(np.float32)
    phi = np.linspace(0.0, 0.95, 1024, dtype=np.float32)
    x = np.zeros_like(noise)
    for t in range(1, 1000):
        x[:, t] = phi * x[:, t - 1] + noise[:, t]
    cpu = summarize_chains(torch.as_tensor(x))
    got = summarize_chains(torch.as_tensor(x, device=cuda))
    for k, v in cpu.items():
        assert got[k].device.type == "cuda"
        torch.testing.assert_close(got[k].cpu(), v, rtol=1e-4, atol=1e-6)


def test_normal_on_card_matches_cpu(cuda):
    """prng.normal takes float32 steps rounded once each (the multiply-adds
    through float64), so the card gives the CPU's draws within 2 ulps."""
    import numpy as np

    from mh_tpu_torch.sampler import prng

    keys = prng.fold_in(prng.key(4), torch.arange(64))
    got = prng.normal(keys.to(cuda), (300,)).cpu().numpy()
    want = prng.normal(keys, (300,)).numpy()

    def ordered(a):
        i = a.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    assert np.abs(ordered(got) - ordered(want)).max() <= 2


def test_layout_gradient_on_card_matches_cpu(cuda):
    """beta * total_cost and its autograd gradient at 64 chains of
    demo_scene(32) (FIXED, positive weights) on the card against the CPU,
    rtol 1e-3 (transcendentals and sums round apart by ulps)."""
    from mh_tpu_torch.sampler import prng
    from mh_tpu_torch.sampler.generic import layout_logdensity, theta_from_pose, value_and_grad

    spec = dataclasses.replace(
        mh_tpu_torch.demo_scene(32), w_pairwise=2.0, w_visual_balance=1.0, w_focal=2.0,
        w_symmetry=2.0, w_clearance=2.0, w_offlimits=1.0, w_surface_area=2.0)
    theta = theta_from_pose(spec.initial_pose()) + 0.5 * prng.normal(
        prng.fold_in(prng.key(8), torch.arange(64)), (96,))
    out = {}
    for dev in (torch.device("cpu"), cuda):
        fn = layout_logdensity(spec.build(device=dev), spec.initial_pose(device=dev), 2.0,
                               mh_tpu_torch.CostMode.FIXED)
        lp, g = value_and_grad(fn, theta.to(dev))
        out[dev.type] = (lp.cpu(), g.cpu())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-3, atol=1e-3)
    scale = float(out["cpu"][1].abs().max())
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-3, atol=1e-3 * scale)


@pytest.mark.parametrize("name,args,line", [
    ("demo_layout", ["--chains", "64", "--iters", "50", "--objects", "32"], "proposals in"),
    ("huge_scene", ["--objects", "512", "--chains", "2", "--iters", "3", "--objs-devices", "2"],
     "proposals over a 512x512 objective"),
    ("advanced_sampling", ["--objects", "8", "--replicas", "8", "--draws", "10"], "ELBO: start"),
])
def test_example_runs_on_the_card(cuda, name, args, line):
    """Each example without ``--device`` runs on the card to the end."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-m", f"mh_tpu_torch.examples.{name}", *args],
                         cwd=repo, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(repo)})
    assert run.returncode == 0, run.stderr[-2000:]
    assert line in run.stdout


@pytest.mark.parametrize("path", ["run_chains", "block_4x4", "incremental"])
def test_zero_signs_on_card_equal_cpu(cuda, path):
    """A start pose whose x and rotation columns are -0.0, on the card and
    on the CPU: the chains agree (at most 2 of 16 may part where an ulp of
    a transcendental flips an accept), and in those that do every zero
    coordinate carries the same sign bit."""
    from mh_tpu_torch.sampler import incremental as TI
    from mh_tpu_torch.sampler import mh as TM
    from mh_tpu_torch.sampler import prng

    spec = mh_tpu_torch.demo_scene(32)
    kw = dict(n_moves_per_step=4, accept_draws=4) if path == "block_4x4" else {}
    cfg = mh_tpu_torch.SamplerConfig(iterations=30, n_chains=16, **kw)
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        pose0 = spec.initial_pose(device=dev).clone()
        pose0[:, [0, 4]] = -0.0
        if path == "incremental":
            runs[dev.type], _ = TI.run_chains_incremental(prng.key(5, dev), pose0,
                                                          spec.build(device=dev), cfg, n_groups=8)
        else:
            runs[dev.type], _ = TM.run_chains(prng.key(5, dev), pose0, spec.build(device=dev), cfg)
    g, w = runs["cuda"].pose.cpu(), runs["cpu"].pose
    same = (runs["cuda"].n_accept.cpu() == runs["cpu"].n_accept) & (
        (g - w).abs().flatten(1).amax(1) <= 1e-4)
    assert int((~same).sum()) <= 2
    g, w = g[same], w[same]
    zero = (g == 0) | (w == 0)
    assert bool(zero.any()) and bool((g[zero] == 0).all()) and bool((w[zero] == 0).all())
    assert torch.equal(torch.signbit(g[zero]), torch.signbit(w[zero]))


def test_incremental_state_on_card_equals_fresh_bitwise(cuda):
    """100 objects x 1024 chains, 10 column groups, 40 steps on the card:
    the carried matrix, group maxima and total equal a fresh evaluation of
    the final poses bit for bit."""
    from mh_tpu_torch.sampler import incremental as TI
    from mh_tpu_torch.sampler import prng

    spec = mh_tpu_torch.demo_scene(100)
    scene = spec.build(device=cuda)
    cfg = mh_tpu_torch.SamplerConfig(iterations=40, n_chains=1024)
    state, _ = TI.run_chains_incremental(prng.key(0, cuda), spec.initial_pose(device=cuda),
                                         scene, cfg, n_groups=10)
    assert state.a_mat.device.type == "cuda" and int((state.n_accept > 0).sum()) > 512
    fresh = TI.full_val_matrix(state.pose, scene, mh_tpu_torch.CostMode.PARITY.pi)
    gmax = TI._group_max(fresh, 10)
    total = TI._cheap_total(state.pose, scene, mh_tpu_torch.CostMode.PARITY,
                            TI._sym_from_gmax(gmax, scene))
    for carried, want in ((state.a_mat, fresh), (state.gmax, gmax), (state.total, total)):
        assert torch.equal(carried.view(torch.int32), want.view(torch.int32))


def test_memoised_calls_equal_fresh_ones_on_one_card(cuda):
    """A scene passed call after call is packed once; every call gives the
    bits of a freshly built scene. 66 chains run on one card on any host
    (no host's cards divide them)."""
    spec = dataclasses.replace(mh_tpu_torch.demo_scene(32), w_offlimits=-1.5)
    scene, pose0 = spec.build(device=cuda), spec.initial_pose(device=cuda)
    for mode in ("PARITY", "FIXED"):
        cfg = mh_tpu_torch.SamplerConfig(iterations=50, n_chains=66,
                                         mode=mh_tpu_torch.CostMode[mode])
        first = mh_tpu_torch.suggest_layouts(scene, cfg, 3, pose0)
        packs = TF.pack_scene.packs
        again = mh_tpu_torch.suggest_layouts(scene, cfg, 3, pose0)
        assert TF.pack_scene.packs == packs
        fresh = mh_tpu_torch.suggest_layouts(spec.build(device=cuda), cfg, 3, pose0)
        for field in ("points", "costs", "accept_rate", "step_scale"):
            assert getattr(again, field).tobytes() == getattr(first, field).tobytes()
            assert getattr(again, field).tobytes() == getattr(fresh, field).tobytes()
        out = TF.run_chains_fused(4, pose0, scene, cfg, 64, 40)
        want = TF.run_chains_fused(4, pose0, spec.build(device=cuda), cfg, 64, 40)
        assert all(torch.equal(g, w) for g, w in zip(out, want))


def test_a_memo_hit_reads_nothing_back(cuda):
    """On a hit, ``Scene.to``, ``tracks_off`` and ``pack_scene`` make no
    call that waits on the card."""
    spec = dataclasses.replace(mh_tpu_torch.demo_scene(32), w_offlimits=-1.5)
    scene = spec.build(device=cuda)
    cfg = mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode.FIXED)
    pk = TF.pack_scene(scene.to("cuda"), cfg)
    assert TF.tracks_off(scene, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert scene.to("cuda") is scene and scene.to(cuda) is scene
        assert TF.tracks_off(scene, cfg)
        assert TF.pack_scene(scene, cfg) is pk
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_every_card_calls_reuse_each_cards_copy_and_see_writes(cuda):
    """On the every-card path the copy and the packing on each other card
    are made once; an in-place write to card 0's scene reaches them in the
    next call, which equals a fresh build with the written value."""
    k = torch.cuda.device_count()
    if k < 2:
        pytest.skip("needs a second card")
    spec = mh_tpu_torch.demo_scene(32)
    scene, pose0 = spec.build(device=cuda), spec.initial_pose(device=cuda)
    cfg = mh_tpu_torch.SamplerConfig(iterations=50, n_chains=16 * k)

    def call(s):
        launches = TF.fused_mh_cuda.launches
        res = mh_tpu_torch.suggest_layouts(s, cfg, 8, pose0)
        assert TF.fused_mh_cuda.launches == launches + k
        return res

    def assert_bitwise(got, want):
        for field in ("points", "costs", "accept_rate", "step_scale"):
            assert getattr(got, field).tobytes() == getattr(want, field).tobytes(), field

    first = call(scene)
    copies = [scene.to(torch.device("cuda", i)) for i in range(1, k)]
    packs = TF.pack_scene.packs
    assert_bitwise(call(scene), first)
    assert TF.pack_scene.packs == packs
    assert all(scene.to(f"cuda:{i}") is c for i, c in enumerate(copies, 1))
    assert_bitwise(first, call(spec.build(device=cuda)))
    packs = TF.pack_scene.packs
    scene.w_symmetry.fill_(-0.5)
    written = call(scene)
    assert TF.pack_scene.packs == packs + k
    assert all(scene.to(f"cuda:{i}") is not c for i, c in enumerate(copies, 1))
    assert_bitwise(written, call(dataclasses.replace(spec, w_symmetry=-0.5).build(device=cuda)))


@pytest.mark.parametrize("n,mode,w_off,want", [
    (100, "FIXED", -1.5, ["mh.off_state"]), (8, "FIXED", -1.5, ["mh.off_rows"]),
    (100, "FIXED", 0.0, []), (100, "PARITY", -1.5, [])])
def test_launch_names_its_off_limits_path_and_reads_nothing_back(cuda, n, mode, w_off, want):
    """On the card a weighted FIXED launch opens one range of no work inside
    ``mh.launch``: ``mh.off_state`` where the kernel keeps its off-limits
    slab state (100 objects), ``mh.off_rows`` where it sums the rows from
    scratch (8 objects); PARITY and unweighted FIXED open neither. Deciding
    makes no call that waits on the card."""
    spec = dataclasses.replace(mh_tpu_torch.demo_scene(n), w_offlimits=w_off)
    cfg = mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode[mode])
    pk = TF.pack_scene(spec.build(device=cuda), cfg)
    pose0 = spec.initial_pose(device=cuda).expand(64, n, 6).contiguous()
    TF._run(pk, pose0, 1, 20, 0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            TF._run(pk, pose0, 2, 20, 0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    off = [e for e in prof.events() if e.name.startswith("mh.off_")]
    assert [e.name for e in off] == want
    launch = next(e for e in prof.events() if e.name == "mh.launch")
    for e in off:
        assert launch.time_range.start <= e.time_range.start <= e.time_range.end \
            <= launch.time_range.end


def test_guideline_scene_matches_reference_and_names_its_blocks_per_sm(cuda):
    """The benchmark's ``scene100_guidelines`` scene (100 objects, a
    clearance on each, 50 + 50 distance and angle rows): the kernel gives
    the plain version's bits in PARITY, and each launch opens one
    ``mh.blocks_per_sm.<k>`` inside ``mh.launch`` with the k that CUDA's
    occupancy calculator gives at its shared memory, asked once."""
    from portbench.entries.suggest_layouts import scene_spec

    config = json.loads((ROOT / "portbench" / "configs" / "scene100_guidelines.json").read_text())
    spec = scene_spec(config["scene"])
    pk = TF.pack_scene(spec.build(device=cuda), mh_tpu_torch.SamplerConfig())
    assert (pk.n, pk.n_clr, pk.rel_idx.shape[0], pk.ang_idx.shape[0]) == (100, 100, 50, 50)
    pose0 = spec.initial_pose(device=cuda).expand(64, 100, 6).contiguous()
    got = TF.fused_mh_cuda(pk, pose0, 3, 50)
    want = TF.fused_chains_reference(pk, pose0, 3, 50)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert (got[2] > 0).sum() >= 32
    smem = TF.smem_bytes(100, 100, 1, False)
    k = ctypes.c_int(0)
    assert _build.load().mh_fused_blocks_per_sm(smem, ctypes.byref(k)) == 0 and k.value >= 1
    misses = TF.blocks_per_sm.cache_info().misses
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        TF._run(pk, pose0, 4, 10, 0)
        TF._run(pk, pose0, 5, 10, 0)
    torch.cuda.synchronize()
    assert TF.blocks_per_sm.cache_info().misses == misses
    ranges = [e for e in prof.events() if e.name.startswith("mh.blocks_per_sm.")]
    assert [e.name for e in ranges] == [f"mh.blocks_per_sm.{k.value}"] * 2
    launches = [e for e in prof.events() if e.name == "mh.launch"]
    for e, launch in zip(ranges, launches):
        assert launch.time_range.start <= e.time_range.start <= e.time_range.end \
            <= launch.time_range.end


def guideline_run(cuda, spec, mode, w_off, chains, steps, pose0=None, **kw):
    """The kernel against the plain version on ``spec``, bitwise in every
    chain at beta = 1e-3, where most steps commit; the kernel's result."""
    scene = dataclasses.replace(spec.build(device=cuda),
                                w_offlimits=torch.tensor(w_off, device=cuda))
    cfg = mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode[mode], beta=1e-3, adapt=True,
                                     **kw)
    pk = TF.pack_scene(scene, cfg)
    assert pk.track_off == (w_off != 0.0)
    if pose0 is None:
        pose0 = spec.initial_pose(device=cuda).expand(chains, pk.n, 6).contiguous()
    got = TF.fused_mh_cuda(pk, pose0, 11, steps)
    want = TF.fused_chains_reference(pk, pose0, 11, steps)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert (got[2] > 0).sum() >= chains // 2
    return got


@pytest.mark.parametrize("mode,w_off", [("PARITY", 0.0), ("FIXED", -1.5)])
@pytest.mark.parametrize("n_clr", [150, 151, 1])
def test_clearance_rows_past_128_objects_match_reference(cuda, n_clr, mode, w_off):
    """200 objects and 150 clearances: lane l of a clearance row's warp
    sums objects l + 32 h and l + 32 h + 128 into one partial for h < 2 and
    one object for h >= 2, as the block's 128 strided partials did; bitwise
    the plain version in PARITY and in weighted FIXED (slab state kept).
    With an odd count (151, 1) a warp's last pair holds one row, and the
    word past the last row's sum, the first of the partials, is not
    written."""
    from test_torch_guidelines import guideline_spec

    spec = guideline_spec(200, n_clr)
    assert TF.off_incremental(1, 200, n_clr)
    guideline_run(cuda, spec, mode, w_off, 32, 40)


@pytest.mark.parametrize("case", ["neg_zero", "compound", "compound_neg_zero"])
@pytest.mark.parametrize("mode,w_off", [("PARITY", 0.0), ("FIXED", -1.5)])
def test_guideline_scene_zero_signs_and_compound_steps_match_reference(cuda, case, mode, w_off):
    """The guideline scene (100 objects, 100 clearances, 50 + 50 rows) from
    a start pose holding -0.0 (single moves commit through every lane), and
    with (M, K) = (4, 4) compound steps, whose move table lies after the 6
    rows' partials: bitwise the plain version, zero signs included."""
    from test_torch_guidelines import guideline_spec

    spec = guideline_spec(100)
    moves = 4 if case.startswith("compound") else 1
    pose0 = spec.initial_pose(device=cuda).expand(64, 100, 6).clone()
    if case.endswith("neg_zero"):
        pose0[:, ::2, 2:] = -0.0
        pose0[:, 0, :2] = -0.0
    got = guideline_run(cuda, spec, mode, w_off, 64, 40, pose0, n_moves_per_step=moves,
                        accept_draws=moves)
    if case.endswith("neg_zero"):
        assert not torch.signbit(got[0][got[0] == 0]).all()


def test_guideline_scene_fits_eight_blocks_an_sm(cuda):
    """100 objects take 12,296 B a block with 100 clearances (11,904 with
    2): both fit the 8 blocks an SM that the kernel's 64 registers a thread
    allow, 1024 chains in one wave on 132 SMs."""
    for n_clr, smem in ((2, 11_904), (100, 12_296)):
        assert TF.smem_bytes(100, n_clr, 1, False) == smem
        k = ctypes.c_int(0)
        assert _build.load().mh_fused_blocks_per_sm(smem, ctypes.byref(k)) == 0
        assert k.value == 8, (n_clr, k.value)


@pytest.mark.parametrize("path", ["one_card", "every_card"])
def test_results_are_read_into_held_pinned_memory(cuda, path):
    """On the card a call's result goes into page-locked host memory with
    one wait, inside ``mh.readback`` (one ``mh.readback_pinned`` a call):
    bitwise the ``.cpu().numpy()`` readback of the same outputs, and a held
    result unchanged by the next calls with other keys. 66 chains run on
    one card on any host; ``16 k`` span every card where there are 2+."""
    k = torch.cuda.device_count()
    if path == "every_card" and k < 2:
        pytest.skip("needs a second card")
    spec = dataclasses.replace(mh_tpu_torch.demo_scene(32), w_offlimits=-1.5)
    scene, pose0 = spec.build(device=cuda), spec.initial_pose(device=cuda)
    cfg = mh_tpu_torch.SamplerConfig(iterations=50, n_chains=66 if path == "one_card" else 16 * k,
                                     mode=mh_tpu_torch.CostMode.FIXED)
    fields = ("points", "costs", "accept_rate", "step_scale")
    first = mh_tpu_torch.suggest_layouts(scene, cfg, 1, pose0)
    kept = {f: getattr(first, f).copy() for f in fields}
    launches = TF.fused_mh_cuda.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        later = [mh_tpu_torch.suggest_layouts(scene, cfg, key, pose0) for key in (2, 3)]
    assert TF.fused_mh_cuda.launches == launches + 2 * every_card_launches(cfg.n_chains)
    for field in fields:
        assert getattr(first, field).tobytes() == kept[field].tobytes(), field
    assert all(r.points.tobytes() != kept["points"].tobytes() for r in later)
    for res in [first, *later]:
        for field in ("points", "costs", "step_scale"):
            assert torch.from_numpy(getattr(res, field)).is_pinned(), field
        assert res.points.flags["C_CONTIGUOUS"] and res.costs.flags["C_CONTIGUOUS"]
    pose, breakdown, n_acc, scale = TF.run_chains_fused(1, pose0, scene, cfg, cfg.n_chains,
                                                        cfg.iterations)
    want = {"points": pose[:, :32, :].cpu().numpy(), "costs": breakdown.cpu().numpy(),
            "accept_rate": n_acc.cpu().numpy().astype("float64") / cfg.iterations,
            "step_scale": scale.cpu().numpy()}
    for field in fields:
        g, w = getattr(first, field), want[field]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), field
        assert g.tobytes() == w.tobytes(), field
    reads = [e for e in prof.events() if e.name == "mh.readback"]
    pinned = [e for e in prof.events() if e.name == "mh.readback_pinned"]
    assert len(reads) == len(pinned) == 2
    for outer, inner in zip(sorted(reads, key=lambda e: e.time_range.start),
                            sorted(pinned, key=lambda e: e.time_range.start)):
        assert outer.time_range.start <= inner.time_range.start <= inner.time_range.end \
            <= outer.time_range.end


def spec_call_cfg(mode: str) -> mh_tpu_torch.SamplerConfig:
    """67 chains: one card on any host (no host's cards divide them)."""
    return mh_tpu_torch.SamplerConfig(iterations=100, n_chains=67,
                                      mode=mh_tpu_torch.CostMode[mode])


@pytest.mark.parametrize("mode,w_off", [("PARITY", 0.0), ("FIXED", -1.5)])
def test_a_spec_is_built_and_packed_with_no_sync(cuda, mode, w_off):
    """A spec's scene (with its start pose, in one copy) and its packing are
    made on the host and sent without a call that waits on the card; the
    packing is bitwise that of the same scene's tensors read back."""
    from mh_tpu_torch import api
    from mh_tpu_torch.models.scene import build_with_pose, scene_from_numpy

    spec = dataclasses.replace(mh_tpu_torch.demo_scene(32), w_offlimits=w_off)
    cfg = spec_call_cfg(mode)
    TF.pack_scene(build_with_pose(spec, cuda)[0], cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        scene = spec.build(device=cuda)
        pk = TF.pack_scene(scene, cfg)
        with_pose, pose0 = build_with_pose(spec, cuda)
        TF.pack_scene(with_pose, cfg)
        counts = api._mask_counts(with_pose)
        track = TF.tracks_off(with_pose, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert counts == (32, 2) and track == (mode == "FIXED")
    assert pose0.device == scene.device and pose0.shape == (32, 6)
    want = TF._pack(scene_from_numpy(spec.build().to_numpy(), device=cuda), cfg)
    for f in dataclasses.fields(TF.PackedScene):
        g, w = getattr(pk, f.name), getattr(want, f.name)
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g.view(torch.uint8), w.view(torch.uint8))
        else:
            assert g == w, f.name


def test_a_spec_call_makes_two_host_to_card_copies(cuda):
    """The scene with its start pose, then the packing: two copies to the
    card in a call that passes a spec. Profiled in a process of its own: in
    a process that has run other profiled tests the card's activity may
    not be recorded."""
    code = (
        "import json, torch, mh_tpu_torch\n"
        "spec = mh_tpu_torch.demo_scene(32)\n"
        "cfg = mh_tpu_torch.SamplerConfig(iterations=100, n_chains=67)\n"
        "mh_tpu_torch.suggest_layouts(spec, cfg, 1)\n"
        "acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]\n"
        "with torch.profiler.profile(activities=acts) as prof:\n"
        "    mh_tpu_torch.suggest_layouts(spec, cfg, 2)\n"
        "print(json.dumps([e.name for e in prof.events()\n"
        "                  if e.device_type == torch.autograd.DeviceType.CUDA]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, check=True)
    on_card = json.loads(out.stdout.strip().splitlines()[-1])
    assert any("fused_mh" in n for n in on_card), on_card
    assert 1 <= len([n for n in on_card if n.startswith("Memcpy HtoD")]) <= 2, on_card


@pytest.mark.parametrize("mode,w_off", [("PARITY", 0.0), ("FIXED", -1.5)])
def test_a_spec_call_equals_the_built_scene_path(cuda, mode, w_off):
    """A call on a spec gives the bits of a call on the built scene with its
    start pose, and of one on a scene of the same tensors (no host twin:
    packed from its tensors read back)."""
    from mh_tpu_torch.models.scene import scene_from_numpy

    spec = dataclasses.replace(mh_tpu_torch.demo_scene(32), w_offlimits=w_off)
    cfg = spec_call_cfg(mode)
    pose0 = spec.initial_pose(device=cuda)
    got = mh_tpu_torch.suggest_layouts(spec, cfg, 5)
    built = mh_tpu_torch.suggest_layouts(spec.build(device=cuda), cfg, 5, pose0)
    read = mh_tpu_torch.suggest_layouts(
        scene_from_numpy(spec.build().to_numpy(), device=cuda), cfg, 5, pose0)
    assert (got.accept_rate > 0).any()
    for field in ("points", "costs", "accept_rate", "step_scale"):
        assert getattr(got, field).tobytes() == getattr(built, field).tobytes(), field
        assert getattr(got, field).tobytes() == getattr(read, field).tobytes(), field
