"""The port's MALA and HMC against mh_tpu on the same threefry draws.

Each step function starts from a state that mh_tpu produced and takes the
same per-chain keys; whole runs start from the same key. On the Gaussian
every accept must match. On the layout objective a chain may part: its
gradients differ from JAX's by float32 ulps (autograd and XLA sum in other
orders), and one accept ratio within an ulp of its uniform is enough to
send a chain down another path, so at most one of four may part.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mh_tpu
import mh_tpu_torch
from mh_tpu.models import densities as JD
from mh_tpu.sampler import generic as JG
from mh_tpu.sampler import hmc as JH
from mh_tpu.sampler import mala as JM
from mh_tpu_torch.models import densities as TD
from mh_tpu_torch.sampler import generic as TG
from mh_tpu_torch.sampler import hmc as TH
from mh_tpu_torch.sampler import mala as TM
from mh_tpu_torch.sampler import prng

import test_torch_threads  # noqa: F401

SANE = dict(w_pairwise=2.0, w_visual_balance=1.0, w_focal=2.0, w_symmetry=2.0,
            w_clearance=2.0, w_offlimits=1.0, w_surface_area=2.0)
MEAN, VAR = [1.5, -0.5, 0.0], [1.0, 0.25, 2.0]


def jkeys(seed: int, n: int):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(jnp.arange(n))


def tkeys(jk) -> torch.Tensor:
    return prng.wrap_key_data(jax.random.key_data(jk))


def state_numpy(state) -> dict:
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


def layout_targets(n: int = 8):
    """The example's proper layout target (FIXED, positive weights) in both
    packages, and its start theta."""
    out = []
    for pkg, gen in ((mh_tpu, JG), (mh_tpu_torch, TG)):
        spec = dataclasses.replace(pkg.demo_scene(n), **SANE)
        out.append(gen.layout_logdensity(spec.build(), spec.initial_pose(), 2.0,
                                         pkg.CostMode.FIXED))
    theta0 = np.asarray(JG.theta_from_pose(mh_tpu.demo_scene(n).initial_pose()))
    return out[0], out[1], theta0


def gaussians():
    return JD.gaussian(jnp.array(MEAN), jnp.array(VAR)), TD.gaussian(MEAN, VAR)


def assert_states_close(got, want, rtol=1e-5):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=rtol * max(1.0, np.abs(w).max()),
                                       err_msg=f.name)


def chains_parted(got_samples, got_accept, want_samples, want_accept, atol) -> np.ndarray:
    """Chains whose accept count or samples differ from the reference's."""
    far = np.abs(got_samples - want_samples).max(axis=(1, 2)) > atol
    return far | (got_accept != want_accept)


# --- one step from mh_tpu's state ------------------------------------------


@pytest.mark.parametrize("step_size", [0.02, 0.08])
def test_mala_step_from_mh_tpu_state(step_size):
    jfn, tfn, theta0 = layout_targets()
    theta = theta0 + np.random.default_rng(1).normal(size=(8, 24)).astype(np.float32) * 0.2
    jstate = jax.jit(jax.vmap(lambda t: JM.mala_init(jfn, t)))(jnp.asarray(theta))
    keys = jkeys(3, 8)
    want = jax.jit(jax.vmap(lambda k, s: JM.mala_step(k, s, jfn, jnp.float32(step_size))))(
        keys, jstate)
    got = TM.mala_step(tkeys(keys), TM.mala_state_from_numpy(state_numpy(jstate)), tfn,
                       step_size)
    assert_states_close(got, want)
    assert 0 < int(got.n_accept.sum())


@pytest.mark.parametrize("adapt", [True, False])
def test_hmc_step_from_mh_tpu_state(adapt):
    """One transition (5 leapfrog steps) from a state mh_tpu warmed up for
    3 steps, so the dual-averaging fields are its own."""
    jfn, tfn, theta0 = layout_targets()
    theta = jnp.asarray(theta0 + np.random.default_rng(2).normal(size=(8, 24)).astype(
        np.float32) * 0.2)
    keys = jkeys(5, 8)

    def warm(k, t):
        s = JH.hmc_init(jfn, t, 0.02)
        for i in range(3):
            s = JH.hmc_step(jax.random.fold_in(k, i), s, jfn, 5, jnp.int32(i))
        return s

    jstate = jax.jit(jax.vmap(warm))(keys, theta)
    want = jax.jit(jax.vmap(lambda k, s: JH.hmc_step(jax.random.fold_in(k, 3), s, jfn, 5,
                                                     jnp.int32(3), adapt=adapt)))(keys, jstate)
    got = TH.hmc_step(prng.fold_in(tkeys(keys), 3),
                      TH.hmc_state_from_numpy(state_numpy(jstate)), tfn, 5, 3, adapt=adapt)
    assert_states_close(got, want)
    assert not np.array_equal(np.asarray(jstate.h_avg), 0)


# --- whole runs --------------------------------------------------------------


def test_mala_sample_gaussian_matches_mh_tpu():
    jfn, tfn = gaussians()
    js, jf = JM.mala_sample(jax.random.key(6), jfn, jnp.zeros(3), n_samples=60, n_chains=4,
                            step_size=0.45)
    ts, tf = TM.mala_sample(prng.key(6), tfn, np.zeros(3, np.float32), n_samples=60,
                            n_chains=4, step_size=0.45, device="cpu")
    np.testing.assert_array_equal(tf.n_accept.numpy(), np.asarray(jf.n_accept))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    assert 0 < int(tf.n_accept.min()) and int(tf.n_accept.max()) < 60


def test_hmc_sample_gaussian_matches_mh_tpu():
    """5 warmup draws, then 30 at the frozen step size. Dual averaging
    feeds the energy error back into the step size, so an ulp of the
    trajectory (XLA fuses the multiply-adds of some lanes and not of
    others) grows every warmup step, through step sizes up to 10x the
    start where the leapfrog is unstable, even with every accept equal;
    the samples part by the step sizes' difference. So the warmup is cut
    to 5 draws, after which the chains stay within 1e-4."""
    jfn, tfn = gaussians()
    js, jf = JH.hmc_sample(jax.random.key(1), jfn, jnp.zeros(3), n_samples=30, n_warmup=5,
                           n_leapfrog=8, n_chains=4)
    ts, tf = TH.hmc_sample(prng.key(1), tfn, np.zeros(3, np.float32), n_samples=30,
                           n_warmup=5, n_leapfrog=8, n_chains=4, device="cpu")
    np.testing.assert_array_equal(tf.n_accept.numpy(), np.asarray(jf.n_accept))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    np.testing.assert_allclose(tf.log_eps.numpy(), np.asarray(jf.log_eps), rtol=1e-5)
    assert int(tf.n_accept.min()) > 0


@pytest.mark.parametrize("sampler", ["mala", "hmc"])
def test_layout_runs_match_mh_tpu(sampler):
    """demo_scene(8), FIXED with the example's weights, 4 chains: at most
    one chain parts (module docstring); the rest within 1e-3."""
    jfn, tfn, theta0 = layout_targets()
    if sampler == "mala":
        kw = dict(n_samples=30, n_chains=4, step_size=0.03)
        js, jf = JM.mala_sample(jax.random.key(9), jfn, jnp.asarray(theta0), **kw)
        ts, tf = TM.mala_sample(prng.key(9), tfn, theta0, device="cpu", **kw)
    else:
        kw = dict(n_samples=15, n_warmup=5, n_leapfrog=5, n_chains=4, step_size=0.02)
        js, jf = JH.hmc_sample(jax.random.key(4), jfn, jnp.asarray(theta0), **kw)
        ts, tf = TH.hmc_sample(prng.key(4), tfn, theta0, device="cpu", **kw)
    parted = chains_parted(ts.numpy(), tf.n_accept.numpy(), np.asarray(js),
                           np.asarray(jf.n_accept), 1e-3)
    assert parted.sum() <= 1, parted
    assert np.isfinite(ts.numpy()).all() and int(tf.n_accept.sum()) > 0


def test_mala_gaussian_moments():
    """The port's own MALA on a Gaussian (the pattern of mh_tpu's test,
    tests/test_samplers_generic.py, at a smaller size)."""
    target = TD.gaussian([1.5, -0.5], [1.0, 0.25])
    samples, final = TM.mala_sample(prng.key(6), target, np.zeros(2, np.float32),
                                    n_samples=600, n_chains=8, step_size=0.45, thin=2,
                                    device="cpu")
    rate = final.n_accept.numpy() / 1200
    assert 0.3 < rate.mean() < 0.95, rate
    s = samples.numpy()[:, 100:, :].reshape(-1, 2)
    np.testing.assert_allclose(s.mean(0), [1.5, -0.5], atol=0.15)
    np.testing.assert_allclose(s.var(0), [1.0, 0.25], rtol=0.3)
