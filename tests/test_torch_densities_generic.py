"""The port's normals, densities, layout log-density and RW-MH against
mh_tpu on the same threefry draws.

``prng.normal`` follows XLA's float32 ``erf_inv`` on the CPU step by step
(bitwise on every draw measured); the tests hold it within 2 ulps in at
most 2% of draws. Gradients come from autograd against
``jax.value_and_grad``, with the subgradients of ties (``jnp.maximum``,
``jnp.abs``) split as JAX splits them.
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
from mh_tpu.ops import costs as JC
from mh_tpu.sampler import generic as JG
from mh_tpu_torch.models import densities as TD
from mh_tpu_torch.ops import costs as TC
from mh_tpu_torch.ops import geometry as geo
from mh_tpu_torch.sampler import generic as TG
from mh_tpu_torch.sampler import prng

import test_torch_threads  # noqa: F401

# the example's proper target: FIXED mode with positive weights
# (examples/advanced_sampling.py:104-110)
SANE = dict(w_pairwise=2.0, w_visual_balance=1.0, w_focal=2.0, w_symmetry=2.0,
            w_clearance=2.0, w_offlimits=1.0, w_surface_area=2.0)


def ulps(a, b) -> np.ndarray:
    """Distance in float32 ulps (the two's-complement ordering of the bits)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def jkeys(seed: int, n: int):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(jnp.arange(n))


def tkeys(jk) -> torch.Tensor:
    return prng.wrap_key_data(jax.random.key_data(jk))


def state_numpy(state) -> dict:
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


# --- normals ---------------------------------------------------------------


@pytest.mark.parametrize("seed,shape", [(0, (200000,)), (1, (300, 301)), (42, (7, 11, 13)),
                                        (2**31 + 5, (50000,)), (-3, ())])
def test_normal_matches_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = prng.normal(prng.key(seed), shape).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    d = ulps(got, want)
    assert d.max() <= 2 and (d > 0).mean() <= 0.02, (d.max(), (d > 0).mean())


def test_normal_batched_keys():
    """One key per chain, as the samplers draw: each row is that key's draw."""
    jk = jax.random.split(jax.random.key(5), 6)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (40, 3)))(jk))
    got = prng.normal(tkeys(jk), (40, 3)).numpy()
    assert got.shape == (6, 40, 3)
    d = ulps(got, want)
    assert d.max() <= 2 and (d > 0).mean() <= 0.02


def test_erf_inv_matches_xla_and_not_torch_erfinv():
    u = prng.uniform(prng.key(11), (100000,), -1.0, 1.0)
    u = torch.cat([u, torch.tensor([-1.0, 1.0, 0.0, -0.0, 0.5, 0.99999994])])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u.numpy())))
    got = prng.erf_inv(u).numpy()
    np.testing.assert_array_equal(got[-6:-2], want[-6:-2])  # +-inf, +-0
    d = ulps(got, want)
    assert d.max() <= 2 and (d > 0).mean() <= 0.02
    # the library's erfinv is another approximation: it parts in most inputs
    d_lib = ulps(torch.erfinv(u).numpy(), want)
    assert (d_lib > 0).mean() > 0.3 and d_lib.max() > 8


def test_sqrt_is_correctly_rounded():
    """``erf_inv``'s tail branch takes ``sqrt(w)`` for w in [5, 17): the
    port's root is XLA's bit for bit. With ``torch.sqrt`` in its place this
    fails on the CPU: PyTorch's vectorised float32 root is 1 ulp off in
    about 0.6% of these inputs."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(5.0, 17.0, 200000),
                        np.exp2(rng.uniform(-120.0, 120.0, 50000)), [0.0, 1.0, 4.0]])
    x = x.astype(np.float32)
    got = prng._sqrt(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.sqrt(jnp.asarray(x))))
    np.testing.assert_array_equal(got, np.sqrt(x))


# --- densities -------------------------------------------------------------


def _density_pairs():
    means = np.array([[0.0, 1.0, -1.0], [2.0, -1.0, 0.5], [-1.5, 0.0, 3.0]], np.float32)
    return {
        "gaussian": (JD.gaussian(jnp.array([1.0, -2.0, 0.5]), jnp.array([1.0, 0.25, 4.0])),
                     TD.gaussian([1.0, -2.0, 0.5], [1.0, 0.25, 4.0]), 3),
        "banana": (JD.banana(), TD.banana(), 2),
        "banana_wide": (JD.banana(1.7, 0.6), TD.banana(1.7, 0.6), 2),
        "mixture": (JD.gaussian_mixture(jnp.asarray(means), 0.8),
                    TD.gaussian_mixture(means, 0.8), 3),
    }


@pytest.mark.parametrize("name", ["gaussian", "banana", "banana_wide", "mixture"])
def test_density_value_and_grad(name):
    jfn, tfn, dim = _density_pairs()[name]
    theta = np.random.default_rng(3).normal(size=(16, dim)).astype(np.float32) * 2
    lp_j, g_j = jax.vmap(jax.value_and_grad(jfn))(jnp.asarray(theta))
    lp_t, g_t = TG.value_and_grad(tfn, torch.as_tensor(theta))
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-6, atol=1e-6)


# --- the layout objective as a density -------------------------------------


def _scenes(n: int, variant: str):
    """Both packages' scene (one object frozen, 4 padded slots) and pose0."""
    specs = []
    for pkg in (mh_tpu, mh_tpu_torch):
        spec = pkg.demo_scene(n)
        frozen = np.zeros(n, bool)
        frozen[2] = True
        spec = dataclasses.replace(spec, frozen=frozen, **(SANE if variant == "sane" else {}))
        specs.append(spec)
    pad = n + 4
    return (specs[0].build(pad_objs=pad), specs[0].initial_pose(pad_objs=pad),
            specs[1].build(pad_objs=pad), specs[1].initial_pose(pad_objs=pad))


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("mode,variant", [("PARITY", "demo"), ("FIXED", "demo"),
                                          ("FIXED", "sane")])
def test_layout_logdensity_value_and_grad(n, mode, variant):
    """beta * total_cost through autograd against jax.value_and_grad at the
    start pose (rotations 0: the |drot| ties) and 15 random poses."""
    js, jp, ts, tp = _scenes(n, variant)
    jfn = JG.layout_logdensity(js, jp, 2.0, mh_tpu.CostMode[mode])
    tfn = TG.layout_logdensity(ts, tp, 2.0, mh_tpu_torch.CostMode[mode])
    theta0 = np.asarray(JG.theta_from_pose(jp))
    rng = np.random.default_rng(n)
    noise = rng.normal(size=(15, theta0.size)) * np.repeat([1.5, 1.5, 0.8], n + 4)
    theta = np.concatenate([theta0[None], theta0 + noise]).astype(np.float32)
    lp_j, g_j = jax.vmap(jax.value_and_grad(jfn))(jnp.asarray(theta))
    lp_t, g_t = TG.value_and_grad(tfn, torch.as_tensor(theta))
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-4, atol=1e-4 * np.abs(g_j).max())
    # the frozen object's and the padded slots' parameters have no gradient
    held = [k * (n + 4) + i for k in range(3) for i in [2, *range(n, n + 4)]]
    assert not g_t.numpy()[:, held].any()


def test_pose_theta_round_trip_holds_frozen_and_padding():
    _, _, scene, pose0 = _scenes(6, "demo")
    theta = TG.theta_from_pose(pose0)
    assert theta.shape == (30,)
    torch.testing.assert_close(TG.pose_from_theta(theta, pose0, scene), pose0, rtol=0, atol=0)
    moved = TG.pose_from_theta(torch.stack([theta + 100.0, theta - 1.0]), pose0, scene)
    assert moved.shape == (2, 10, 6)
    torch.testing.assert_close(moved[:, 2], pose0[2].expand(2, 6))  # frozen held
    torch.testing.assert_close(moved[:, 6:], pose0[6:].expand(2, 4, 6))  # padding held
    assert moved[0, 0, 0] == pose0[0, 0] + 100.0 and moved[1, 1, 4] == pose0[1, 4] - 1.0
    torch.testing.assert_close(moved[:, :, [2, 3, 5]], pose0[:, [2, 3, 5]].expand(2, 10, 3))


def test_symmetry_tie_at_zero_splits_the_gradient():
    """A pose whose object 7 has best match exactly 0: itself, its
    reflection across x = 5 lying 25 away at rotation 0 (5 - sqrt(25) -
    0.4 * 0). jnp.maximum(best, 0) and jnp.abs(0) give the reference's
    subgradients (0.5 and +1); clamp_min and torch.abs gave 1 and 0."""
    pose = np.array(mh_tpu.demo_scene(8).initial_pose())
    pose[7, [0, 1, 4]] = [17.5, 30.0, 0.0]
    js = mh_tpu.demo_scene(8).build()
    ts = mh_tpu_torch.demo_scene(8).build()
    mode_j, mode_t = mh_tpu.CostMode.FIXED, mh_tpu_torch.CostMode.FIXED
    want = np.asarray(jax.grad(lambda p: JC.symmetry_costs(p, js, mode_j))(jnp.asarray(pose)))
    p = torch.tensor(pose, requires_grad=True)
    TC.symmetry_costs(p, ts, mode_t).backward()
    np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-5, atol=1e-6)
    # the tie is there: object 7's gradient is half its row max's
    # (d/dx of -sqrt|2x - 10| is -1/5; d/drot of -0.4 |2 rot| is -0.8)
    assert p.grad[7, 0] == pytest.approx(0.5 * 0.2, rel=1e-5)
    assert p.grad[7, 4] == pytest.approx(0.5 * 0.4 * 2.0, rel=1e-5)


def test_absolute_has_jax_derivative_at_zero():
    x = torch.tensor([-2.0, -0.0, 0.0, 3.0], requires_grad=True)
    y = geo.absolute(x)
    assert torch.equal(y.detach(), torch.abs(x.detach()))
    assert torch.equal(torch.signbit(y.detach()), torch.zeros(4, dtype=torch.bool))
    y.sum().backward()
    want = jax.vmap(jax.grad(jnp.abs))(jnp.array([-2.0, -0.0, 0.0, 3.0]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))


# --- random-walk Metropolis ------------------------------------------------


def test_rw_step_from_mh_tpu_state():
    """One step from mh_tpu's state with the same per-chain keys."""
    js, jp, ts, tp = _scenes(8, "sane")
    jfn = JG.layout_logdensity(js, jp, 2.0, mh_tpu.CostMode.FIXED)
    tfn = TG.layout_logdensity(ts, tp, 2.0, mh_tpu_torch.CostMode.FIXED)
    theta0 = np.asarray(JG.theta_from_pose(jp))[None] + np.random.default_rng(0).normal(
        size=(8, 36)).astype(np.float32) * 0.3
    jstate = jax.vmap(JG.rw_init, in_axes=(None, 0))(jfn, jnp.asarray(theta0))
    keys = jkeys(9, 8)
    for step_size in (0.05, 0.3):
        jnext = jax.vmap(JG.rw_step, in_axes=(0, 0, None, None))(
            keys, jstate, jfn, jnp.float32(step_size))
        tnext = TG.rw_step(tkeys(keys), TG.rw_state_from_numpy(state_numpy(jstate)), tfn,
                           step_size)
        np.testing.assert_array_equal(tnext.n_accept.numpy(), np.asarray(jnext.n_accept))
        np.testing.assert_array_equal(tnext.step.numpy(), np.asarray(jnext.step))
        np.testing.assert_allclose(tnext.theta.numpy(), np.asarray(jnext.theta), atol=1e-6)
        np.testing.assert_allclose(tnext.logprob.numpy(), np.asarray(jnext.logprob),
                                   rtol=1e-5)
    assert 0 < int(tnext.n_accept.sum()) < 8


@pytest.mark.parametrize("name,step_size", [("gaussian", 0.8), ("banana", 0.6)])
def test_rw_metropolis_matches_mh_tpu(name, step_size):
    jfn, tfn, dim = _density_pairs()[name]
    theta0 = np.zeros(dim, np.float32)
    js, jf = JG.rw_metropolis(jax.random.key(4), jfn, jnp.asarray(theta0), n_samples=50,
                              n_chains=4, step_size=step_size, thin=2)
    ts, tf = TG.rw_metropolis(prng.key(4), tfn, theta0, n_samples=50, n_chains=4,
                              step_size=step_size, thin=2, device="cpu")
    assert ts.shape == (4, 50, dim)
    np.testing.assert_array_equal(tf.n_accept.numpy(), np.asarray(jf.n_accept))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)
    assert 0 < int(tf.n_accept.min()) and int(tf.n_accept.max()) < 100


def test_state_numpy_round_trip():
    state = TG.rw_init(TD.banana(), torch.zeros(3, 2))
    back = TG.rw_state_from_numpy(state.to_numpy())
    for f in dataclasses.fields(state):
        assert torch.equal(getattr(back, f.name), getattr(state, f.name)), f.name
