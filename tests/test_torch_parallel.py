"""The port's sharded runners (mh_tpu_torch.parallel) against one shard and mh_tpu's.

Mirrors tests/test_parallel.py. The port's CPU mesh names the CPU device 8
times (``chain_mesh(devices=["cpu"] * 8)``), as mh_tpu's tests run on 8
virtual CPU devices. Within the port, 1 shard against 8 is bitwise for the
sharded, collective and tempering runners and for SMC's poses (SMC's sums
in shard order move its ESS and evidence by float rounding, rtol 1e-6, as
tests/test_parallel.py allows). Against mh_tpu's runners on its 8-device
mesh, the chain engine's tolerance holds (tests/test_torch_mh.py): accept
counts equal and poses within 1e-4 in all but at most 2 of 8 chains.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mh_tpu
import mh_tpu_torch
from mh_tpu.parallel.mesh import chain_mesh as J_mesh
from mh_tpu.parallel.sharded import continue_chains_sharded as J_continue
from mh_tpu.parallel.sharded import run_chains_collective as J_collective
from mh_tpu.parallel.sharded import run_chains_sharded as J_sharded
from mh_tpu.sampler.smc import run_smc as J_smc
from mh_tpu.sampler.tempering import run_tempered as J_tempered
from mh_tpu_torch.kernels.fused_mh import run_chains_fused_sharded
from mh_tpu_torch.parallel import mesh as PM
from mh_tpu_torch.parallel.sharded import (
    continue_chains_sharded, run_chains_collective, run_chains_sharded,
)
from mh_tpu_torch.sampler import mh as TM
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.smc import run_smc
from mh_tpu_torch.sampler.tempering import run_tempered
import test_torch_threads  # noqa: F401
from test_torch_mh import assert_chains_agree, jax_state_numpy, scenes

MAX_DIVERGENT, MAX_ROUNDS_DIFFERENT = 2, 2


def cpu_mesh(k: int) -> PM.Mesh:
    return PM.chain_mesh(devices=["cpu"] * k)


def cfgs(**kw):
    return mh_tpu.SamplerConfig(**kw), mh_tpu_torch.SamplerConfig(**kw)


@pytest.fixture(scope="module")
def scene8():
    return scenes(8)


def test_mesh_shape_and_collectives():
    m = PM.Mesh(np.array([["cpu"] * 4] * 2, dtype=object), ("chains", "objs"))
    assert m.shape == {"chains": 2, "objs": 4}
    assert m.axis_devices("chains") == [torch.device("cpu")] * 2
    assert m.axis_devices("other") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="axis names"):
        PM.Mesh(np.array(["cpu"] * 2, dtype=object), ("chains", "objs"))
    assert cpu_mesh(8).shape == {"chains": 8}
    assert PM.chain_mesh(2, devices=["cpu"] * 8).shape == {"chains": 2}
    parts = [torch.tensor([1.0, -2.0]) * (d + 1) for d in range(4)]
    summed = PM.psum(parts)
    assert all(torch.equal(s, torch.tensor([10.0, -20.0])) for s in summed)
    assert all(torch.equal(s, torch.tensor([4.0, -2.0])) for s in PM.pmax(parts))
    assert PM.psum(parts[:1])[0] is parts[0]  # one shard: its own tensor
    gathered = PM.all_gather(parts)
    assert all(torch.equal(g, torch.cat(parts)) for g in gathered)
    moved = PM.ppermute(parts, [(i, (i + 1) % 4) for i in range(4)])
    assert [torch.equal(m_, parts[(i - 1) % 4]) for i, m_ in enumerate(moved)] == [True] * 4
    assert torch.equal(PM.ppermute(parts, [(0, 1)])[2], torch.zeros(2))
    shards = PM.split_rows(torch.arange(8), [torch.device("cpu")] * 4)
    assert [s.tolist() for s in shards] == [[0, 1], [2, 3], [4, 5], [6, 7]]


def test_cpu_atan2_rounds_every_element_alike():
    """geometry.atan2 gives each element the same bits whatever the batch
    around it (torch.atan2 on a contiguous CPU tensor rounds whole vectors
    and the rest apart, so 16 chains and 8 shards of 2 parted)."""
    from mh_tpu_torch.ops import geometry

    g = torch.Generator().manual_seed(0)
    y, x = torch.randn(2, 100, 37, generator=g)
    whole = geometry.atan2(y, x)
    assert torch.equal(whole, torch.cat([geometry.atan2(y[i:i + 1], x[i:i + 1])
                                         for i in range(100)]))
    np.testing.assert_allclose(whole.numpy(), np.arctan2(y.numpy(), x.numpy()), atol=1e-6)


def test_chain_mesh_needs_a_card_without_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PM.chain_mesh()
    assert "chain mesh: none" in PM.device_report()


def test_sharded_chains_device_count_invariant(scene8):
    """1 and 8 shards, and run_chains, bitwise equal; then mh_tpu's
    sharded runner on its 8-device mesh, to the engine's tolerance."""
    js, ts, pose0 = scene8
    jc, tc = cfgs(iterations=15, n_chains=16)
    p0 = torch.as_tensor(pose0)
    s1 = run_chains_sharded(prng.key(0), p0, ts, tc, cpu_mesh(1))
    s8 = run_chains_sharded(prng.key(0), p0, ts, tc, cpu_mesh(8))
    one, _ = TM.run_chains(prng.key(0), p0, ts, tc)
    for a, b in ((s1, s8), (one, s8)):
        for f, v in a.to_numpy().items():
            if f != "costs":
                np.testing.assert_array_equal(v, b.to_numpy()[f], err_msg=f)
        assert torch.equal(a.costs.as_vector(), b.costs.as_vector())
    want = J_sharded(jax.random.key(0), jnp.asarray(pose0), js, jc, J_mesh(8))
    same = assert_chains_agree(s8.to_numpy(), jax_state_numpy(want))
    assert same.sum() >= 14 and (s8.n_accept > 0).all()


def test_continue_sharded_carries_an_mh_tpu_state(scene8):
    """An mh_tpu sharded state continues on 8 port shards as on mh_tpu's
    mesh, and a port run split in two equals one run bitwise."""
    js, ts, pose0 = scene8
    jc, tc = cfgs(iterations=15, n_chains=16)
    first = J_sharded(jax.random.key(4), jnp.asarray(pose0), js, jc, J_mesh(8))
    want = J_continue(first, js, jc, J_mesh(8))
    got = continue_chains_sharded(TM.mh_state_from_numpy(jax_state_numpy(first)), ts, tc,
                                  cpu_mesh(8))
    assert_chains_agree(got.to_numpy(), jax_state_numpy(want))
    half = run_chains_sharded(prng.key(4), torch.as_tensor(pose0), ts, tc, cpu_mesh(2))
    two = continue_chains_sharded(half, ts, tc, cpu_mesh(4))
    whole = run_chains_sharded(prng.key(4), torch.as_tensor(pose0), ts,
                               mh_tpu_torch.SamplerConfig(iterations=30, n_chains=16),
                               cpu_mesh(8))
    assert torch.equal(two.pose, whole.pose) and torch.equal(two.n_accept, whole.n_accept)


@pytest.mark.parametrize("runner", ["sharded", "collective", "tempering", "smc", "fused"])
def test_bad_divisibility(scene8, runner):
    _, ts, pose0 = scene8
    p0, mesh = torch.as_tensor(pose0), cpu_mesh(8)
    cfg = mh_tpu_torch.SamplerConfig(iterations=2, n_chains=3)
    calls = {
        "sharded": lambda: run_chains_sharded(prng.key(0), p0, ts, cfg, mesh),
        "collective": lambda: run_chains_collective(prng.key(0), p0, ts, cfg, mesh, 1, 1),
        "tempering": lambda: run_tempered(prng.key(0), p0, ts, cfg, mesh, n_replicas=12),
        "smc": lambda: run_smc(prng.key(0), p0, ts, cfg, mesh, n_particles=12),
        "fused": lambda: run_chains_fused_sharded(0, p0, ts, cfg, 12, 2, mesh),
    }
    with pytest.raises(ValueError, match="divisible"):
        calls[runner]()


def test_collective_adaptation(scene8):
    """Rates and the shared scale bitwise equal on 1 and 8 shards, in
    [0, 1], the scale moved; against mh_tpu's collective runner on its
    8-device mesh."""
    js, ts, pose0 = scene8
    kw = dict(iterations=0, n_chains=32, adapt_rate=0.3, target_accept=0.3)
    jc, tc = cfgs(**kw)
    p0 = torch.as_tensor(pose0)
    s1, r1, l1 = run_chains_collective(prng.key(1), p0, ts, tc, cpu_mesh(1), 12, 6)
    s8, r8, l8 = run_chains_collective(prng.key(1), p0, ts, tc, cpu_mesh(8), 12, 6)
    assert torch.equal(r1, r8) and torch.equal(l1, l8) and torch.equal(s1.pose, s8.pose)
    assert r8.shape == (12,) and r8.dtype == torch.float32
    assert ((r8 >= 0) & (r8 <= 1)).all() and float(l8) != 0.0
    ws, wr, wl = J_collective(jax.random.key(1), jnp.asarray(pose0), js, jc, J_mesh(8),
                              rounds=12, steps_per_round=6)
    # a chain that parts moves the global rate by 1/192 of a step a round
    np.testing.assert_allclose(r8.numpy(), np.asarray(wr), atol=2.0 / (32 * 6))
    np.testing.assert_allclose(float(l8), float(wl), atol=0.3 * 12 * 2.0 / (32 * 6))
    same = assert_chains_agree(s8.to_numpy(), jax_state_numpy(ws))
    assert same.sum() >= 30


@pytest.mark.parametrize("adapt", [False, True])
def test_tempering_shard_count_invariant(scene8, adapt):
    """16 replicas on 1, 2, 4, 8 and 16 shards: bitwise equal to no mesh
    (with one replica a shard both partners come from other shards, and
    the cyclic transport hands shards 0 and 15 a replica that is no
    partner); the adapted ladder against mh_tpu on its 8-device mesh."""
    js, ts, pose0 = scene8
    jc, tc = cfgs(iterations=0)
    args = dict(n_replicas=16, exchange_every=3, rounds=8, adapt_ladder=adapt)
    p0 = torch.as_tensor(pose0)
    want = run_tempered(prng.key(2), p0, ts, tc, None, **args)
    for k in (1, 2, 4, 8, 16):
        got = run_tempered(prng.key(2), p0, ts, tc, cpu_mesh(k), **args)
        assert torch.equal(got[0].pose, want[0].pose), k
        assert torch.equal(got[0].costs.as_vector(), want[0].costs.as_vector()), k
        for g, w in zip(got[1:], want[1:]):
            assert torch.equal(g, w), k
    assert want[1].mean() > 0.05
    if not adapt:
        return
    jax_out = J_tempered(jax.random.key(2), jnp.asarray(pose0), js, jc, J_mesh(8), **args)
    assert (got[1].numpy() != np.asarray(jax_out[1])).sum() <= MAX_ROUNDS_DIFFERENT
    gap = np.abs(got[0].pose.numpy() - np.asarray(jax_out[0].pose)).max(axis=(1, 2))
    assert (gap > 1e-4).sum() <= MAX_DIVERGENT
    np.testing.assert_allclose(got[2].numpy(), np.asarray(jax_out[2]), rtol=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(adaptive=True, init="prior")],
                         ids=["pose0", "adaptive_prior"])
def test_smc_shard_count_invariant(scene8, kw):
    """Poses bitwise on 1 and 8 shards, ESS and evidence within rtol 1e-6;
    against mh_tpu's SMC on its 8-device mesh."""
    js, ts, pose0 = scene8
    jc, tc = cfgs(iterations=0)
    args = dict(n_particles=16, n_stages=5, mutate_steps=2, **kw)
    p0 = torch.as_tensor(pose0)
    s1, d1 = run_smc(prng.key(2), p0, ts, tc, cpu_mesh(1), **args)
    s8, d8 = run_smc(prng.key(2), p0, ts, tc, cpu_mesh(8), **args)
    assert torch.equal(s1.pose, s8.pose)
    np.testing.assert_array_equal(d1["resampled"].numpy(), d8["resampled"].numpy())
    for k in ("ess", "log_evidence", "betas"):
        np.testing.assert_allclose(d8[k].numpy(), d1[k].numpy(), rtol=1e-6, err_msg=k)
    assert tuple(s8.pose.shape) == (16, 8, 6) and d8["log_weights"].shape == (16,)
    ws, wd = J_smc(jax.random.key(2), jnp.asarray(pose0), js, jc, J_mesh(8), **args)
    np.testing.assert_array_equal(d8["resampled"].numpy(), np.asarray(wd["resampled"]))
    np.testing.assert_allclose(d8["ess"].numpy(), np.asarray(wd["ess"]), rtol=1e-4)
    np.testing.assert_allclose(float(d8["log_evidence"]), float(wd["log_evidence"]), rtol=1e-5)
    gap = np.abs(s8.pose.numpy() - np.asarray(ws.pose)).max(axis=(1, 2))
    assert (gap > 1e-4).sum() <= MAX_DIVERGENT
