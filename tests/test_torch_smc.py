"""The port's annealed SMC against mh_tpu.sampler.smc on one device.

mh_tpu runs with ``chain_mesh(1)``, the port with ``mesh=None``
(tests/test_torch_parallel.py holds wider meshes). Both draw the same threefry stream
(particle keys, prior draws, resample keys), so the stage traces agree:
the resample decisions equal, ESS within 1e-4 relative, the schedule and
the log-evidence within 1e-5 relative, and each particle's pose within
1e-4 in all but at most 2 of 16. They part only by ulps: XLA's and
PyTorch's exp/log/softmax/cumsum round differently, and a point of the
systematic resample that falls within an ulp of a CDF step can pick the
neighbouring particle.
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
from mh_tpu.sampler.smc import run_smc as J_smc
from mh_tpu.sampler.smc import systematic_resample_indices as J_resample
from mh_tpu_torch.parallel.mesh import chain_mesh
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.smc import run_smc, systematic_resample_indices
from test_torch_scene import to_torch_scene

POSE_ATOL, MAX_DIVERGENT = 1e-4, 2
ARGS = dict(n_particles=16, n_stages=6, mutate_steps=3)


@pytest.fixture(scope="module")
def scene8():
    spec = mh_tpu.demo_scene(8)
    js = spec.build()
    return js, to_torch_scene(js), np.array(spec.initial_pose())


@pytest.mark.parametrize("kw", [
    dict(), dict(init="prior"), dict(adaptive=True, init="prior"),
    dict(adaptive=True), dict(mode="FIXED", init="prior"),
], ids=["pose0", "prior", "adaptive_prior", "adaptive_pose0", "fixed_prior"])
def test_smc_matches_mh_tpu(scene8, kw):
    kw = dict(kw)
    mode = kw.pop("mode", "PARITY")
    js, ts, pose0 = scene8
    want_s, want = J_smc(jax.random.key(3), pose0, js,
                         mh_tpu.SamplerConfig(iterations=0, mode=mh_tpu.CostMode[mode]),
                         J_mesh(1), **ARGS, **kw)
    got_s, got = run_smc(prng.key(3), torch.as_tensor(pose0), ts,
                         mh_tpu_torch.SamplerConfig(iterations=0,
                                                    mode=mh_tpu_torch.CostMode[mode]),
                         None, **ARGS, **kw)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["resampled"].numpy(), np.asarray(want["resampled"]))
    np.testing.assert_allclose(got["ess"].numpy(), np.asarray(want["ess"]), rtol=1e-4)
    np.testing.assert_allclose(got["betas"].numpy(), np.asarray(want["betas"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["log_evidence"]), float(want["log_evidence"]),
                               rtol=1e-5)
    gap = np.abs(got_s.pose.numpy() - np.asarray(want_s.pose)).max(axis=(1, 2))
    assert (gap > POSE_ATOL).sum() <= MAX_DIVERGENT
    same = gap <= POSE_ATOL
    np.testing.assert_allclose(got_s.costs.as_vector().numpy()[same],
                               np.asarray(want_s.costs.as_vector())[same], rtol=2e-4, atol=2e-3)
    for k in ("ess", "betas", "resampled"):
        assert tuple(got[k].shape) == (6,)


def test_resample_indices_match_mh_tpu():
    rng = np.random.default_rng(0)
    for seed in range(20):
        log_w = rng.normal(0.0, 2.0, 32).astype(np.float32)
        want = np.asarray(J_resample(jax.random.key(seed), jnp.asarray(log_w), 32))
        got = systematic_resample_indices(prng.key(seed), torch.as_tensor(log_w), 32)
        assert (got.numpy() != want).sum() <= 1
        assert int(got.max()) < 32


def test_systematic_resample_statistics():
    log_w = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4]))
    counts = np.zeros(4)
    for s in range(200):
        counts += np.bincount(systematic_resample_indices(prng.key(s), log_w, 4).numpy(),
                              minlength=4)
    np.testing.assert_allclose(counts / counts.sum(), [0.1, 0.2, 0.3, 0.4], atol=0.05)


def test_log_evidence_telescopes_exactly(scene8):
    """No resampling and no mutation: the staged evidence equals beta * S of
    the (identical) initial particles."""
    _, ts, pose0 = scene8
    cfg = mh_tpu_torch.SamplerConfig(iterations=0)
    _, diag = run_smc(prng.key(7), torch.as_tensor(pose0), ts, cfg, None, n_particles=16,
                      n_stages=5, mutate_steps=0, ess_threshold=0.0)
    assert not diag["resampled"].any()
    s0 = float(mh_tpu_torch.total_cost(torch.as_tensor(pose0), ts, cfg.mode))
    assert float(diag["log_evidence"]) == pytest.approx(cfg.beta * s0, rel=1e-5)


def test_adaptive_schedule_is_monotone_and_ess_controlled(scene8):
    _, ts, pose0 = scene8
    cfg = mh_tpu_torch.SamplerConfig(iterations=0)
    states, diag = run_smc(prng.key(3), torch.as_tensor(pose0), ts, cfg, None, n_particles=16,
                           n_stages=8, mutate_steps=2, adaptive=True, init="prior")
    betas, ess = diag["betas"].numpy(), diag["ess"].numpy()
    assert np.all(np.diff(np.concatenate([[0.0], betas])) >= -1e-7)
    assert 0.0 < betas[0] < cfg.beta * 0.99
    assert abs(ess[0] - 8.0) < 1.5
    assert np.all((ess >= 1.0) & (ess <= 16.0 + 1e-3))
    assert np.isfinite(diag["log_weights"].numpy()).all()
    assert tuple(states.pose.shape) == (16, 8, 6)


def test_bad_init_raises_and_wider_mesh_equals_no_mesh(scene8):
    _, ts, pose0 = scene8
    cfg = mh_tpu_torch.SamplerConfig(iterations=0)
    with pytest.raises(ValueError, match="init"):
        run_smc(prng.key(0), torch.as_tensor(pose0), ts, cfg, None, n_particles=4, init="x")
    want_s, want = run_smc(prng.key(0), torch.as_tensor(pose0), ts, cfg, None, n_particles=4,
                           n_stages=2, mutate_steps=1)
    got_s, got = run_smc(prng.key(0), torch.as_tensor(pose0), ts, cfg,
                         chain_mesh(devices=["cpu"] * 2), n_particles=4, n_stages=2,
                         mutate_steps=1)
    assert torch.equal(got_s.pose, want_s.pose)
    np.testing.assert_allclose(got["ess"].numpy(), want["ess"].numpy(), rtol=1e-6)
