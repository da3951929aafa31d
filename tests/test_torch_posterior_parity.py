"""Posterior-moment parity of the port's chain engine against the NumPy oracle.

The port's counterpart of tests/test_posterior_parity.py, case for case and
with the same bands: ``mh_tpu_torch``'s ``run_chains`` (the torch engine,
on the CPU) against tests/oracle_mh.py, the reference sampling process in
float64 NumPy with an independent RNG. Agreement of the cost and pose
moments is evidence that the port targets the same posterior as the
reference. The oracle takes ``mh_tpu``'s demo scene, which holds the same
values as the port's.
"""

import numpy as np

import mh_tpu
import oracle_mh
import test_torch_threads  # noqa: F401
from mh_tpu_torch.config import SamplerConfig
from mh_tpu_torch.models.scene import demo_scene
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.mh import run_chains, run_chains_streaming


def port_scene(n: int):
    spec = demo_scene(n)
    return spec, spec.build(device="cpu"), spec.initial_pose(device="cpu")


def oracle_traces(n: int, steps: int, seeds, **kw) -> np.ndarray:
    spec = mh_tpu.demo_scene(n)
    return np.stack([oracle_mh.run_chain(spec, steps, seed=s, **kw) for s in seeds])


def test_posterior_cost_moments_match_oracle():
    steps, burn = 1500, 500
    o_samples = oracle_traces(6, steps, range(100, 104))[:, burn:].reshape(-1)

    _, scene, pose0 = port_scene(6)
    cfg = SamplerConfig(iterations=steps, n_chains=16)
    _, traces = run_chains(prng.key(0), pose0, scene, cfg, trace_costs=True)
    m_samples = traces.numpy()[:, burn:].reshape(-1)

    o_mean, o_std = o_samples.mean(), o_samples.std()
    m_mean, m_std = m_samples.mean(), m_samples.std()
    assert abs(m_mean - o_mean) < 0.25 * o_std, (m_mean, o_mean, o_std)
    assert 0.5 < m_std / o_std < 2.0, (m_std, o_std)


def test_posterior_pose_moments_match_oracle():
    """Scene-level posterior mean and spread of (x, y), from the streaming
    Welford statistics."""
    steps, burn = 1500, 500
    _, oposes = oracle_mh.run_chain(mh_tpu.demo_scene(6), steps, seed=7, collect_poses=True)
    o_xy = oposes[burn:, :, :2]

    _, scene, pose0 = port_scene(6)
    cfg = SamplerConfig(iterations=steps, n_chains=8)
    _, mom = run_chains_streaming(prng.key(3), pose0, scene, cfg, burn=burn)
    m_mean_xy = mom.pose_mean.numpy()[:, :, :2]
    m_var_xy = mom.pose_var.numpy()[:, :, :2]

    o_mean = o_xy.mean(axis=(0, 1))
    m_mean = m_mean_xy.mean(axis=(0, 1))
    o_spread = o_xy.std()
    np.testing.assert_allclose(m_mean, o_mean, atol=0.35 * o_spread)
    m_total_var = m_var_xy.mean() + m_mean_xy.var(axis=0).mean()
    assert 0.25 < m_total_var / o_spread**2 < 4.0


def test_streaming_moments_match_trace():
    """The streaming Welford moments equal the trace-computed moments."""
    _, scene, pose0 = port_scene(6)
    burn = 50
    cfg = SamplerConfig(iterations=200, n_chains=4)
    key = prng.key(9)
    _, (costs, poses) = run_chains(key, pose0, scene, cfg, trace_costs=True, trace_poses=True)
    _, mom = run_chains_streaming(key, pose0, scene, cfg, burn=burn)
    costs, poses = costs.numpy(), poses.numpy()
    assert np.all(mom.n.numpy() == cfg.iterations - burn)
    np.testing.assert_allclose(mom.pose_mean.numpy(), poses[:, burn:].mean(axis=1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(mom.pose_var.numpy(), poses[:, burn:].var(axis=1, ddof=1),
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(mom.cost_mean.numpy(), costs[:, burn:].mean(axis=1), rtol=1e-5)
    np.testing.assert_allclose(mom.cost_var.numpy(), costs[:, burn:].var(axis=1, ddof=1),
                               rtol=2e-3)


def test_thinned_trace_matches_full_trace():
    """thin=k keeps exactly every k-th step of the full trace (same chains)."""
    _, scene, pose0 = port_scene(6)
    cfg = SamplerConfig(iterations=120, n_chains=3)
    key = prng.key(11)
    sf, full = run_chains(key, pose0, scene, cfg, trace_poses=True)
    st, thin = run_chains(key, pose0, scene, cfg, trace_poses=True, thin=4)
    assert thin.shape[1] == 30
    np.testing.assert_array_equal(thin.numpy(), full.numpy()[:, 3::4])
    np.testing.assert_array_equal(sf.pose.numpy(), st.pose.numpy())


def test_posterior_cost_moments_match_oracle_block_proposals():
    """Compound K-move proposals track the K-move oracle's transient cost
    process (band calibration: tests/test_posterior_parity.py)."""
    steps, burn, k = 1200, 400, 4
    o_samples = oracle_traces(6, steps, range(200, 212), moves_per_step=k)[:, burn:].reshape(-1)

    _, scene, pose0 = port_scene(6)
    cfg = SamplerConfig(iterations=steps, n_chains=16, n_moves_per_step=k)
    _, traces = run_chains(prng.key(1), pose0, scene, cfg, trace_costs=True)
    m_samples = traces.numpy()[:, burn:].reshape(-1)

    o_mean, o_std = o_samples.mean(), o_samples.std()
    m_mean, m_std = m_samples.mean(), m_samples.std()
    assert abs(m_mean - o_mean) < 0.5 * o_std, (m_mean, o_mean, o_std)
    assert 0.5 < m_std / o_std < 2.0, (m_std, o_std)


def test_reference_default_config_accept_draws():
    """The reference's default launch (32 objects, 1 block x 64 threads, 100
    iterations, ``Kernel.cu:1189-1194``) as M = K = 64: acceptance near the
    oracle's ~1% and the cost drift within the oracle's band."""
    steps, k = 100, 64
    otraces = oracle_traces(32, steps, range(300, 306), moves_per_step=k, accept_draws=k)

    _, scene, pose0 = port_scene(32)
    cfg = SamplerConfig(iterations=steps, n_chains=16, n_moves_per_step=k, accept_draws=k)
    states, traces = run_chains(prng.key(2), pose0, scene, cfg, trace_costs=True)
    m = traces.numpy()

    acc = states.accept_rate.numpy()
    o_acc = np.mean(otraces[:, 1:] != otraces[:, :-1])
    assert 0.001 < acc.mean() < 0.05, acc.mean()
    assert abs(acc.mean() - 0.01) < 0.01, (acc.mean(), o_acc)

    o_drift = otraces[:, -1] - otraces[:, 0]
    m_drift = m[:, -1] - m[:, 0]
    band = 3.0 * o_drift.std() / np.sqrt(16) + 3.0 * o_drift.std() / np.sqrt(6)
    assert abs(m_drift.mean() - o_drift.mean()) < band, (m_drift.mean(), o_drift.mean(), band)


def test_accept_draws_transient_tracks_oracle():
    """accept_draws = K = 8 at 6 objects: the acceptance rate within 0.05 of
    the K-draw oracle's and the stationary-window cost moments within its
    bands."""
    steps, k = 800, 8
    otraces = oracle_traces(6, steps, range(400, 412), moves_per_step=k, accept_draws=k)

    _, scene, pose0 = port_scene(6)
    cfg = SamplerConfig(iterations=steps, n_chains=16, n_moves_per_step=k, accept_draws=k)
    states, traces = run_chains(prng.key(4), pose0, scene, cfg, trace_costs=True)
    m = traces.numpy()

    o_acc = np.mean(otraces[:, 1:] != otraces[:, :-1])
    acc = float(states.accept_rate.numpy().mean())
    assert abs(acc - o_acc) < 0.05, (acc, o_acc)

    burn = 300
    o_s, m_s = otraces[:, burn:].reshape(-1), m[:, burn:].reshape(-1)
    o_mean, o_std = o_s.mean(), o_s.std()
    assert abs(m_s.mean() - o_mean) < 0.75 * o_std, (m_s.mean(), o_mean, o_std)
    assert 0.5 < m_s.std() / o_std < 2.0, (m_s.std(), o_std)
