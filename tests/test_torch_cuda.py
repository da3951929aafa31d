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

import dataclasses
import json
import math

import pytest
import torch

import mh_tpu_torch
from mh_tpu_torch.kernels import fused_mh as TF
from mh_tpu_torch.kernels import pi_kernel as TP

pytestmark = pytest.mark.cuda


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
    or, past 1,455 objects, the state does not fit in shared memory)
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
