"""The port's parallel tempering against mh_tpu.sampler.tempering on one device.

mh_tpu runs with ``chain_mesh(1)``; the port with ``mesh=None``, one shard
(tests/test_torch_parallel.py holds wider meshes). Both draw the same threefry stream for the MH
steps and the pair decisions, so the swap-rate traces agree and each
replica ends at the same pose, to the chain engine's tolerance
(tests/test_torch_mh.py): poses within 1e-4 in all but at most 2 of 8
replicas, at most 2 rounds with another swap rate; adapted ladders
within 1e-5 relative (XLA's and PyTorch's exp/log/pow differ by ulps).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

import mh_tpu
import mh_tpu_torch
from mh_tpu.parallel.mesh import chain_mesh as J_mesh
from mh_tpu.sampler.tempering import geometric_ladder as J_ladder
from mh_tpu.sampler.tempering import run_tempered as J_tempered
from mh_tpu_torch.parallel.mesh import chain_mesh
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.tempering import geometric_ladder, run_tempered
from test_torch_scene import to_torch_scene

POSE_ATOL, MAX_DIVERGENT, MAX_ROUNDS_DIFFERENT = 1e-4, 2, 2
ARGS = dict(n_replicas=8, exchange_every=3, rounds=12)


@pytest.fixture(scope="module")
def scene8():
    spec = mh_tpu.demo_scene(8)
    js = spec.build()
    return js, to_torch_scene(js), np.array(spec.initial_pose())


@pytest.mark.parametrize("adapt", [False, True])
@pytest.mark.parametrize("mode", ["PARITY", "FIXED"])
def test_tempering_matches_mh_tpu(scene8, adapt, mode):
    js, ts, pose0 = scene8
    want = J_tempered(jax.random.key(5), pose0, js,
                      mh_tpu.SamplerConfig(iterations=0, mode=mh_tpu.CostMode[mode]),
                      J_mesh(1), adapt_ladder=adapt, **ARGS)
    got = run_tempered(prng.key(5), torch.as_tensor(pose0), ts,
                       mh_tpu_torch.SamplerConfig(iterations=0,
                                                  mode=mh_tpu_torch.CostMode[mode]),
                       None, adapt_ladder=adapt, **ARGS)
    assert len(got) == len(want) == (3 if adapt else 2)
    rates_w, rates_g = np.asarray(want[1]), got[1].numpy()
    assert rates_g.shape == rates_w.shape == (12,) and rates_g.dtype == np.float32
    assert (rates_g != rates_w).sum() <= MAX_ROUNDS_DIFFERENT
    gap = np.abs(got[0].pose.numpy() - np.asarray(want[0].pose)).max(axis=(1, 2))
    assert (gap > POSE_ATOL).sum() <= MAX_DIVERGENT
    same = gap <= POSE_ATOL
    np.testing.assert_allclose(got[0].costs.as_vector().numpy()[same],
                               np.asarray(want[0].costs.as_vector())[same],
                               rtol=2e-4, atol=2e-3)
    assert rates_w.mean() > 0.05  # neighbouring temperatures do exchange
    if adapt:
        b = got[2].numpy()
        np.testing.assert_allclose(b, np.asarray(want[2]), rtol=1e-5)
        assert b[-1] == pytest.approx(2.0) and np.all(np.diff(b) > 0)
        assert np.abs(b - geometric_ladder(8, 0.1, 2.0).numpy()).max() > 1e-4


def test_ladder_matches_mh_tpu():
    for n in (2, 8, 16, 64):
        np.testing.assert_allclose(geometric_ladder(n, 0.1, 2.0).numpy(),
                                   np.asarray(J_ladder(n, 0.1, 2.0)), rtol=1e-6)
    b = geometric_ladder(8, 0.1, 2.0).numpy()
    assert b[0] == pytest.approx(0.1) and b[-1] == pytest.approx(2.0)
    assert np.all(np.diff(b) > 0)


def test_explicit_betas_and_target_replica(scene8):
    _, ts, pose0 = scene8
    betas = torch.linspace(0.5, 2.0, 4)
    states, rates = run_tempered(prng.key(1), torch.as_tensor(pose0), ts,
                                 mh_tpu_torch.SamplerConfig(iterations=0), None, n_replicas=4,
                                 betas=betas, exchange_every=2, rounds=5)
    assert tuple(states.pose.shape) == (4, 8, 6) and tuple(rates.shape) == (5,)
    assert np.all((rates.numpy() >= 0) & (rates.numpy() <= 1))
    assert torch.isfinite(states.costs.total).all()
    ref = mh_tpu_torch.cost_terms(states.pose, ts).as_vector()
    torch.testing.assert_close(states.costs.as_vector(), ref, rtol=2e-4, atol=2e-3)


def test_mesh_of_one_device_and_wider_equal_no_mesh(scene8):
    """The port's own mesh: one CPU shard, and 4 (one replica each), give
    the bits of mesh=None (tests/test_torch_parallel.py holds every shard
    count)."""
    _, ts, pose0 = scene8
    cfg = mh_tpu_torch.SamplerConfig(iterations=0)
    want = run_tempered(prng.key(0), torch.as_tensor(pose0), ts, cfg, None, n_replicas=4,
                        rounds=2)
    for k in (1, 4):
        got = run_tempered(prng.key(0), torch.as_tensor(pose0), ts, cfg,
                           chain_mesh(devices=["cpu"] * k), n_replicas=4, rounds=2)
        assert torch.equal(got[0].pose, want[0].pose) and torch.equal(got[1], want[1])
