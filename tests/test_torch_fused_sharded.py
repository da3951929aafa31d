"""The fused kernel once per shard (mh_tpu_torch.kernels.fused_mh.run_chains_fused_sharded).

Mirrors tests/test_fused_sharded.py. On the CPU each shard runs the
kernel's plain version with its first global chain index, which keys the
counter-based stream, so any shard count gives one launch's bits. Against
``mh_tpu``'s sharded kernel (the Pallas interpreter on its 2-device mesh)
the tolerance of tests/test_torch_fused.py holds: accept counts equal and
poses within 5e-7 (every chain agrees at this size).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mh_tpu
import mh_tpu_torch
from mh_tpu.kernels import fused_mh as JF
from mh_tpu.parallel.mesh import chain_mesh as J_mesh
import mh_tpu_torch.api as api
from mh_tpu_torch.kernels import fused_mh as TF
from mh_tpu_torch.parallel.mesh import chain_mesh
from test_torch_scene import to_torch_scene


@pytest.fixture(scope="module")
def scene8():
    spec = mh_tpu.demo_scene(8)
    js = spec.build()
    return js, to_torch_scene(js), np.array(spec.initial_pose())


def _run(ts, pose0, shards, n_chains=8, iters=5, **cfg_kw):
    cfg = mh_tpu_torch.SamplerConfig(**cfg_kw)
    p0 = torch.as_tensor(pose0)
    if shards == 0:
        return TF.run_chains_fused(3, p0, ts, cfg, n_chains, iters)
    return TF.run_chains_fused_sharded(3, p0, ts, cfg, n_chains, iters,
                                       chain_mesh(devices=["cpu"] * shards))


@pytest.mark.parametrize("cfg_kw", [dict(), dict(n_moves_per_step=4, accept_draws=4)],
                         ids=["single", "compound_4x4"])
def test_plain_version_shard_count_invariant(scene8, cfg_kw):
    """One launch, 1, 2 and 4 shards: bitwise equal poses, breakdowns,
    accept counts and step scales, one plain call per shard."""
    _, ts, pose0 = scene8
    want = _run(ts, pose0, 0, iters=10, beta=1e-3, **cfg_kw)
    for shards in (1, 2, 4):
        calls = TF.fused_chains_reference.calls
        got = _run(ts, pose0, shards, iters=10, beta=1e-3, **cfg_kw)
        assert TF.fused_chains_reference.calls == calls + shards
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), shards
    assert (want[2] > 0).all()


def test_per_chain_starts_shard_by_global_chain(scene8):
    """A per-chain pose0 f32[C, N, 6]: shard d starts its chains from rows
    d n_local .. of it, as one launch does."""
    _, ts, pose0 = scene8
    starts = torch.as_tensor(pose0).expand(8, 8, 6).clone()
    starts[:, :, 0] += torch.arange(8.0)[:, None] * 0.1
    cfg = mh_tpu_torch.SamplerConfig()
    want = TF.run_chains_fused(5, starts, ts, cfg, 8, 6)
    got = TF.run_chains_fused_sharded(5, starts, ts, cfg, 8, 6, chain_mesh(devices=["cpu"] * 4))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_matches_mh_tpu_sharded_kernel(scene8):
    """Against mh_tpu's sharded kernel in interpret mode on its 2-device
    mesh: accept counts equal, poses within 5e-7."""
    js, ts, pose0 = scene8
    want = JF.run_chains_fused_sharded(3, jnp.asarray(pose0), js, mh_tpu.SamplerConfig(), 8, 6,
                                       J_mesh(2), interpret=True)
    got = _run(ts, pose0, 2, iters=6)
    wp, wb, wa, ws = (np.asarray(a) for a in want)
    gp, gb, ga, gs = (a.numpy() for a in got)
    np.testing.assert_array_equal(ga, wa.astype(np.int32))
    np.testing.assert_allclose(gp, wp, atol=5e-7)
    np.testing.assert_allclose(gb, wb, rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(gs, ws, rtol=1e-5)
    assert ga.mean() > 1


def test_api_fused_engine_with_a_mesh_takes_the_sharded_runner(monkeypatch):
    """engine="fused" with a mesh reaches run_chains_fused_sharded and
    returns the one-launch result; auto on a CPU mesh is the torch engine."""
    seen = {}
    orig = api.run_chains_fused_sharded

    def spy(*a, **k):
        seen["mesh"] = a[6]
        return orig(*a, **k)

    monkeypatch.setattr(api, "run_chains_fused_sharded", spy)
    spec = mh_tpu_torch.demo_scene(8)
    cfg = mh_tpu_torch.SamplerConfig(iterations=3, n_chains=8)
    mesh = chain_mesh(devices=["cpu"] * 2)
    res = mh_tpu_torch.suggest_layouts(spec, cfg, engine="fused", mesh=mesh)
    assert seen["mesh"] is mesh
    assert res.points.shape == (8, 8, 6) and np.isfinite(res.costs).all()
    one = mh_tpu_torch.suggest_layouts(spec, cfg, engine="fused", device="cpu")
    for f in ("points", "costs", "accept_rate", "step_scale"):
        np.testing.assert_array_equal(getattr(res, f), getattr(one, f))
    seen.clear()
    mh_tpu_torch.suggest_layouts(spec, cfg, mesh=mesh)
    assert not seen
