"""The port's NUTS and mean-field VI against mh_tpu on the same threefry
draws, and the reference's flushed-subnormal Gumbel draw.

NUTS runs at max_depth 4 here (mh_tpu compiles every doubling of the
static tree under vmap). Its warmup adapts the step size with the dual
averaging of HMC, which doubles an ulp of difference every few steps
(tests/test_torch_mala_hmc.py), so whole runs keep the warmup short.
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
from mh_tpu.sampler import nuts as JN
from mh_tpu.sampler import vi as JV
from mh_tpu_torch.models import densities as TD
from mh_tpu_torch.sampler import generic as TG
from mh_tpu_torch.sampler import nuts as TN
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler import vi as TV

SANE = dict(w_pairwise=2.0, w_visual_balance=1.0, w_focal=2.0, w_symmetry=2.0,
            w_clearance=2.0, w_offlimits=1.0, w_surface_area=2.0)
MEAN, VAR = [1.5, -0.5, 0.0], [1.0, 0.25, 2.0]


def jkeys(seed: int, n: int):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(jnp.arange(n))


def tkeys(jk) -> torch.Tensor:
    return prng.wrap_key_data(jax.random.key_data(jk))


def state_numpy(state) -> dict:
    return {f.name: np.asarray(getattr(state, f.name)) for f in dataclasses.fields(state)}


def gaussians():
    return JD.gaussian(jnp.array(MEAN), jnp.array(VAR)), TD.gaussian(MEAN, VAR)


@pytest.mark.parametrize("target", ["gaussian", "layout"])
def test_nuts_step_from_mh_tpu_state(target):
    """One adapting transition at max_depth 4 from mh_tpu's state after 2
    transitions at the start step size, with the same per-chain keys."""
    if target == "gaussian":
        jfn, tfn = gaussians()
        theta = np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)
        step_size = 0.3
    else:
        fns = []
        for pkg, gen in ((mh_tpu, JG), (mh_tpu_torch, TG)):
            spec = dataclasses.replace(pkg.demo_scene(8), **SANE)
            fns.append(gen.layout_logdensity(spec.build(), spec.initial_pose(), 2.0,
                                             pkg.CostMode.FIXED))
        jfn, tfn = fns
        theta0 = np.asarray(JG.theta_from_pose(mh_tpu.demo_scene(8).initial_pose()))
        theta = theta0 + np.random.default_rng(1).normal(size=(8, 24)).astype(np.float32) * 0.2
        step_size = 0.01
    keys = jkeys(7, 8)

    def warm(k, t):
        s = JN.nuts_init(jfn, t, step_size)
        for i in range(2):
            s = JN.nuts_step(jax.random.fold_in(k, i), s, jfn, 4, jnp.int32(i), adapt=False)
        return s

    jstate = jax.jit(jax.vmap(warm))(keys, jnp.asarray(theta))
    want = jax.jit(jax.vmap(lambda k, s: JN.nuts_step(jax.random.fold_in(k, 2), s, jfn, 4,
                                                      jnp.int32(2))))(keys, jstate)
    got = TN.nuts_step(prng.fold_in(tkeys(keys), 2),
                       TN.nuts_state_from_numpy(state_numpy(jstate)), tfn, 4, 2)
    for f in ("n_divergent", "sum_depth"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    for f in ("theta", "logprob", "grad", "log_eps", "log_eps_avg", "h_avg"):
        w = np.asarray(getattr(want, f))
        np.testing.assert_allclose(getattr(got, f).numpy(), w, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(w).max()), err_msg=f)
    depth = got.sum_depth.numpy() - np.asarray(jstate.sum_depth)
    assert depth.min() >= 1 and depth.max() > 1  # trees of more than one leaf


def test_nuts_sample_gaussian_matches_mh_tpu():
    """4 chains, 5 warmup and 20 sampling transitions at max_depth 4."""
    jfn, tfn = gaussians()
    js, jf = JN.nuts_sample(jax.random.key(0), jfn, jnp.zeros(3), n_samples=20, n_warmup=5,
                            max_depth=4, n_chains=4)
    ts, tf = TN.nuts_sample(prng.key(0), tfn, np.zeros(3, np.float32), n_samples=20,
                            n_warmup=5, max_depth=4, n_chains=4, device="cpu")
    np.testing.assert_array_equal(tf.sum_depth.numpy(), np.asarray(jf.sum_depth))
    np.testing.assert_array_equal(tf.n_divergent.numpy(), np.asarray(jf.n_divergent))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
    assert tf.sum_depth.numpy().min() > 20  # deeper than one doubling on average


def test_gumbel_leaf_with_zero_uniform_is_never_drawn():
    """The reference's -log(-log(u + 1e-38) + 1e-38) in float32 flushes the
    subnormal guard: u == 0 gives -inf and that leaf loses even with the
    largest log-weight. A naive port keeping the subnormal would give it
    -log(87.5) and draw it here."""
    u = np.array([[0.0, 0.5, 0.25, 0.999], [0.3, 0.0, 0.0, 0.7]], np.float32)
    ws = np.array([[50.0, 0.0, 0.1, -1.0], [-3.0, 40.0, 39.0, -2.0]], np.float32)
    want_g = np.asarray(jax.jit(lambda x: -jnp.log(-jnp.log(x + 1e-38) + 1e-38))(u))
    got_g = TN.gumbel(torch.as_tensor(u)).numpy()
    np.testing.assert_array_equal(np.isneginf(got_g), u == 0)
    np.testing.assert_array_equal(np.isneginf(want_g), u == 0)
    np.testing.assert_allclose(got_g[u > 0], want_g[u > 0], rtol=1e-6)
    idx = TN._pick(torch.as_tensor(ws), torch.as_tensor(u)).numpy()
    np.testing.assert_array_equal(idx, np.argmax(ws + want_g, -1))
    assert idx[0] != 0 and idx[1] not in (1, 2)
    # the guard kept as a subnormal would have drawn leaf 0 of row 0
    kept = -torch.log(-torch.log(torch.as_tensor(u) + 1e-38) + 1e-38)
    assert torch.isfinite(kept).all() and int(torch.argmax(torch.as_tensor(ws) + kept, -1)[0]) == 0


def test_gumbel_ties_go_to_the_first_leaf():
    ws = torch.tensor([[1.0, 3.0, 3.0, 0.0]])
    u = torch.full((1, 4), 0.5)
    assert int(TN._pick(ws, u)[0]) == 1
    assert int(jnp.argmax(jnp.asarray(ws.numpy()) + jnp.full((1, 4), 0.0), -1)[0]) == 1


def test_meanfield_vi_matches_mh_tpu():
    jfn, tfn = gaussians()
    mu_j, sig_j, tr_j = JV.meanfield_vi(jax.random.key(3), jfn, jnp.zeros(3), n_steps=50,
                                        n_mc=16, learning_rate=0.05)
    mu_t, sig_t, tr_t = TV.meanfield_vi(prng.key(3), tfn, np.zeros(3, np.float32), n_steps=50,
                                        n_mc=16, learning_rate=0.05, device="cpu")
    assert tr_t.shape == (50,)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(sig_t.numpy(), np.asarray(sig_j), rtol=1e-4)
    np.testing.assert_allclose(tr_t.numpy(), np.asarray(tr_j), rtol=1e-4)
    assert tr_t[-10:].mean() > tr_t[:10].mean()


def test_adam_follows_optax_order():
    """The port's Adam against optax.adam on fixed gradients, 20 steps."""
    import optax

    rng = np.random.default_rng(5)
    grads = rng.normal(size=(20, 6)).astype(np.float32)
    opt = optax.adam(0.05)
    p_j = jnp.asarray(rng.normal(size=6).astype(np.float32))
    state = opt.init(p_j)
    adam = TV.Adam(0.05)
    p_t = torch.tensor(np.asarray(p_j))
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state)
        p_j = optax.apply_updates(p_j, upd)
        (p_t,) = adam.update([p_t], [torch.as_tensor(g)])
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-6, atol=1e-7)
