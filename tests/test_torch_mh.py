"""The port's chain engine (mh_tpu_torch.sampler.mh) against mh_tpu's.

Both draw the same threefry stream, so each chain takes the same moves and
the same accept uniforms. XLA and PyTorch still round log/sqrt/sin/cos/exp
by ulps apart (and XLA fuses multiply-adds on the CPU), so an accept ratio
that falls within an ulp of its uniform can go the other way and part a
chain for good. Tolerance (tests/test_torch_api.py states the same):
accept counts equal and poses within 1e-4 in all but at most 2 of 8
chains; the costs of the rest within rtol 2e-4 / atol 2e-3 (the objective's
own tolerance, tests/test_torch_costs.py). Within the port, the invariants
mh_tpu pins bit for bit hold bit for bit.
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
from mh_tpu.sampler import mh as JM
from mh_tpu_torch.sampler import mh as TM
from mh_tpu_torch.sampler import prng
import test_torch_threads  # noqa: F401
from test_torch_scene import to_torch_scene

RTOL, ATOL, POSE_ATOL, MAX_DIVERGENT = 2e-4, 2e-3, 1e-4, 2

CASES = {
    "parity": dict(),
    "fixed": dict(mode="FIXED"),
    "fixed_weighted": dict(mode="FIXED", w_off=-1.5),
    "block_4x4_adapt": dict(n_moves_per_step=4, accept_draws=4, adapt=True),
}


def configs(iterations=30, n_chains=8, mode="PARITY", **kw):
    kw.pop("w_off", None)
    return (mh_tpu.SamplerConfig(iterations=iterations, n_chains=n_chains,
                                 mode=mh_tpu.CostMode[mode], **kw),
            mh_tpu_torch.SamplerConfig(iterations=iterations, n_chains=n_chains,
                                       mode=mh_tpu_torch.CostMode[mode], **kw))


def scenes(n=16, w_off=0.0):
    spec = mh_tpu.demo_scene(n)
    js = dataclasses.replace(spec.build(), w_offlimits=jnp.float32(w_off))
    return js, to_torch_scene(js), np.array(spec.initial_pose())


def jax_state_numpy(s) -> dict:
    """An mh_tpu MHState as the port's numpy layout (key as its words)."""
    return {
        "pose": np.asarray(s.pose),
        "costs": {f.name: np.asarray(getattr(s.costs, f.name))
                  for f in dataclasses.fields(s.costs)},
        "key": np.asarray(jax.random.key_data(s.key)),
        "step": np.asarray(s.step),
        "n_accept": np.asarray(s.n_accept),
        "log_scale": np.asarray(s.log_scale),
    }


def assert_chains_agree(got: dict, want: dict):
    """The module docstring's tolerance, on two numpy state layouts."""
    same = (got["n_accept"] == want["n_accept"]) & (
        np.abs(got["pose"] - want["pose"]).max(axis=(-2, -1)) <= POSE_ATOL)
    assert (~same).sum() <= MAX_DIVERGENT, (got["n_accept"], want["n_accept"])
    for f in want["costs"]:
        np.testing.assert_allclose(got["costs"][f][same], want["costs"][f][same],
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    np.testing.assert_array_equal(got["step"], want["step"])
    np.testing.assert_allclose(got["log_scale"][same], want["log_scale"][same], atol=1e-5)
    return same


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_chains_matches_mh_tpu(case):
    kw = dict(CASES[case])
    js, ts, pose0 = scenes(w_off=kw.get("w_off", 0.0))
    jc, tc = configs(**kw)
    want, _ = JM.run_chains(jax.random.key(3), jnp.asarray(pose0), js, jc)
    got, _ = TM.run_chains(prng.key(3), torch.as_tensor(pose0), ts, tc)
    same = assert_chains_agree(got.to_numpy(), jax_state_numpy(want))
    assert same.sum() >= 6 and (got.n_accept > 0).all()


def test_mh_step_from_an_mh_tpu_state():
    """One step from the same carried state, chain by chain."""
    js, ts, pose0 = scenes()
    jc, tc = configs(iterations=7, **CASES["block_4x4_adapt"])
    start, _ = JM.run_chains(jax.random.key(1), jnp.asarray(pose0), js, jc)
    want = jax.jit(jax.vmap(lambda s: JM.mh_step(s, js, jc)))(start)
    got = TM.mh_step(TM.mh_state_from_numpy(jax_state_numpy(start)), ts, tc)
    assert_chains_agree(got.to_numpy(), jax_state_numpy(want))
    np.testing.assert_array_equal(prng.key_data(got.key), jax.random.key_data(want.key))


def test_continue_an_mh_tpu_state_in_the_port():
    """A state from mh_tpu.run_chains, carried over as numpy (key as its
    two uint32 words), continues in the port as in mh_tpu."""
    js, ts, pose0 = scenes()
    jc, tc = configs(iterations=15)
    first, _ = JM.run_chains(jax.random.key(2), jnp.asarray(pose0), js, jc)
    carried = TM.mh_state_from_numpy(jax_state_numpy(first))
    for f, v in carried.to_numpy().items():
        if f != "costs":
            np.testing.assert_array_equal(v, jax_state_numpy(first)[f], err_msg=f)
    want = JM.continue_chains(first, js, jc)
    got = TM.continue_chains(carried, ts, tc)
    assert_chains_agree(got.to_numpy(), jax_state_numpy(want))


def test_traces_and_thin_match_mh_tpu():
    js, ts, pose0 = scenes()
    jc, tc = configs(iterations=30)
    want, (wc, wp) = JM.run_chains(jax.random.key(4), jnp.asarray(pose0), js, jc,
                                   trace_costs=True, trace_poses=True, thin=3)
    got, (gc, gp) = TM.run_chains(prng.key(4), torch.as_tensor(pose0), ts, tc,
                                  trace_costs=True, trace_poses=True, thin=3)
    assert tuple(gc.shape) == np.shape(wc) == (8, 10)
    assert tuple(gp.shape) == np.shape(wp) == (8, 10, 16, 6)
    same = assert_chains_agree(got.to_numpy(), jax_state_numpy(want))
    np.testing.assert_allclose(gc.numpy()[same], np.asarray(wc)[same], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gp.numpy()[same], np.asarray(wp)[same], atol=POSE_ATOL)
    # the trace-free run ends in the same bits; a cost-only trace is the
    # first element of the pair, a pose-only trace the second
    plain, _ = TM.run_chains(prng.key(4), torch.as_tensor(pose0), ts, tc)
    assert torch.equal(plain.pose, got.pose)
    _, only_c = TM.run_chains(prng.key(4), torch.as_tensor(pose0), ts, tc, trace_costs=True,
                              thin=3)
    _, only_p = TM.run_chains(prng.key(4), torch.as_tensor(pose0), ts, tc, trace_poses=True,
                              thin=3)
    assert torch.equal(only_c, gc) and torch.equal(only_p, gp)


def test_streaming_moments_match_mh_tpu():
    js, ts, pose0 = scenes()
    jc, tc = configs(iterations=40)
    want_s, want = JM.run_chains_streaming(jax.random.key(5), jnp.asarray(pose0), js, jc,
                                           burn=10)
    got_s, got = TM.run_chains_streaming(prng.key(5), torch.as_tensor(pose0), ts, tc, burn=10)
    same = assert_chains_agree(got_s.to_numpy(), jax_state_numpy(want_s))
    np.testing.assert_array_equal(got.n.numpy(), np.asarray(want.n))
    for name in ("pose_mean", "pose_var"):
        np.testing.assert_allclose(getattr(got, name).numpy()[same],
                                   np.asarray(getattr(want, name))[same], rtol=1e-4, atol=1e-4)
    for name in ("cost_mean", "cost_var"):
        np.testing.assert_allclose(getattr(got, name).numpy()[same],
                                   np.asarray(getattr(want, name))[same], rtol=RTOL, atol=ATOL)


def test_boltzmann_accept_matches_mh_tpu():
    for seed in range(20):
        cur, star = np.float32(-3.0), np.float32(-3.0 - 0.1 * seed)
        want = bool(JM.boltzmann_accept(jax.random.key(seed), star, cur, 2.0))
        got = bool(TM.boltzmann_accept(prng.key(seed), torch.tensor(star), torch.tensor(cur),
                                       2.0))
        assert got == want, seed


def test_run_chain_single_matches_batched_chain():
    """Chain c of run_chains == run_chain keyed by fold_in(key, c), bitwise."""
    _, ts, pose0 = scenes(n=8)
    _, tc = configs(iterations=40, n_chains=4)
    states, _ = TM.run_chains(prng.key(6), torch.as_tensor(pose0), ts, tc)
    assert torch.any(states.pose[0] != states.pose[1])
    one, trace = TM.run_chain(prng.fold_in(prng.key(6), 2), torch.as_tensor(pose0), ts,
                              dataclasses.replace(tc, n_chains=1), trace_costs=True)
    assert torch.equal(one.pose, states.pose[2]) and torch.equal(one.n_accept, states.n_accept[2])
    assert tuple(trace.shape) == (40,) and float(trace[-1]) == float(one.costs.total)


def test_compile_chains_and_continue_bitwise_equal_run_chains():
    _, ts, pose0 = scenes(n=12)
    for kw in (dict(), dict(n_moves_per_step=3, accept_draws=5, adapt=True)):
        _, tc = configs(iterations=24, n_chains=4, **kw)
        key, p0 = prng.key(3), torch.as_tensor(pose0)
        ref, _ = TM.run_chains(key, p0, ts, tc)
        runner = TM.compile_chains(ts, tc)
        fast, _ = runner(key, p0)
        half, _ = runner(key, p0, iterations=10)
        assert int(half.step.max()) == 10
        resumed = TM.continue_chains(half, ts, dataclasses.replace(tc, iterations=14))
        for other in (fast, resumed):
            for g, w in zip(other.to_numpy().values(), ref.to_numpy().values()):
                if isinstance(w, dict):
                    for f in w:
                        np.testing.assert_array_equal(g[f], w[f])
                else:
                    np.testing.assert_array_equal(g, w)


def test_thin_validation_and_iterations_override():
    _, ts, pose0 = scenes(n=8)
    _, tc = configs(iterations=10, n_chains=2)
    key, p0 = prng.key(0), torch.as_tensor(pose0)
    with pytest.raises(ValueError, match="thin"):
        TM.run_chain(key, p0, ts, tc, thin=3)
    with pytest.raises(ValueError, match="thin"):
        TM.run_chains(key, p0, ts, tc, thin=3)
    with pytest.raises(ValueError, match="thin"):
        TM.compile_chains(ts, tc, thin=3)
    with pytest.raises(ValueError, match="iterations"):
        TM.compile_chains(ts, tc, trace_costs=True, thin=2)(key, p0, iterations=4)
    runner = TM.compile_chains(ts, dataclasses.replace(tc, iterations=8), thin=2)
    states, _ = runner(key, p0, iterations=4)
    ref, _ = TM.run_chains(key, p0, ts, dataclasses.replace(tc, iterations=4))
    assert int(states.step.max()) == 4 and torch.equal(states.pose, ref.pose)
    with pytest.raises(ValueError, match="thin"):
        runner(key, p0, iterations=5)


# --- the invariants of tests/test_mh.py, on the port ------------------------

def _chain(n, iterations, seed, **kw):
    spec = mh_tpu_torch.demo_scene(n)
    scene = spec.build()
    cfg = mh_tpu_torch.SamplerConfig(iterations=iterations, **kw)
    state, trace = TM.run_chain(prng.key(seed), spec.initial_pose(), scene, cfg,
                                trace_costs=True)
    return spec, scene, cfg, state, trace


def test_beta_zero_accepts_everything():
    *_, state, _ = _chain(8, 64, 0, beta=0.0)
    assert int(state.n_accept) == 64


def test_acceptance_improvement_and_adaptation():
    spec, scene, cfg, state, trace = _chain(16, 200, 1)
    assert 0.01 < float(state.accept_rate) <= 1.0
    initial = float(mh_tpu_torch.total_cost(spec.initial_pose(), scene, cfg.mode))
    assert float(state.costs.total) > initial
    fresh = float(mh_tpu_torch.total_cost(state.pose, scene, cfg.mode))
    np.testing.assert_allclose(float(state.costs.total), fresh, rtol=1e-4, atol=1e-4)
    assert np.isfinite(trace.numpy()).all() and float(trace[-1]) == float(state.costs.total)
    *_, adapted, _ = _chain(8, 300, 8, adapt=True)
    assert float(adapted.log_scale) != 0.0


def test_deterministic_replay():
    *_, s1, _ = _chain(8, 50, 3)
    *_, s2, _ = _chain(8, 50, 3)
    *_, s3, _ = _chain(8, 50, 4)
    assert torch.equal(s1.pose, s2.pose) and not torch.equal(s1.pose, s3.pose)


def test_finalize_fills_offlimits_in_parity():
    """PARITY leaves OffLimits out of the loop and refills it on the final
    pose; the weighted term then equals cost_terms' on every path."""
    spec = mh_tpu_torch.demo_scene(10)
    scene = dataclasses.replace(spec.build(), w_offlimits=torch.tensor(-1.0))
    cfg = mh_tpu_torch.SamplerConfig(iterations=20, n_chains=3)
    states, _ = TM.run_chains(prng.key(0), spec.initial_pose(), scene, cfg)
    ref = mh_tpu_torch.cost_terms(states.pose, scene, cfg.mode).off_limits
    assert torch.equal(states.costs.off_limits, ref) and (ref != 0).any()
    resumed = TM.continue_chains(states, scene, dataclasses.replace(cfg, iterations=5))
    ref = mh_tpu_torch.cost_terms(resumed.pose, scene, cfg.mode).off_limits
    assert torch.equal(resumed.costs.off_limits, ref)


# --- no host reads inside a step (the precondition of CUDA-graph capture) ----

class NoHostRead(torch.Tensor):
    """A tensor that raises on every read back to the host. Ops on it return
    NoHostRead again, so anything computed from it is guarded too."""

    def _refuse(self, *args, **kwargs):
        raise AssertionError("host read inside the step")

    __float__ = __int__ = __bool__ = __index__ = _refuse
    item = tolist = numpy = _refuse


def _guard(obj):
    if isinstance(obj, torch.Tensor):
        return obj.as_subclass(NoHostRead)
    return type(obj)(**{f.name: _guard(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


@pytest.mark.parametrize("mode,moves,draws,adapt", [
    ("PARITY", 1, 1, False), ("FIXED", 4, 4, True),
])
def test_mh_step_reads_nothing_to_the_host(mode, moves, draws, adapt):
    spec = mh_tpu_torch.demo_scene(8)
    scene = dataclasses.replace(spec.build(), w_offlimits=torch.tensor(-1.0))
    cfg = mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode[mode], n_chains=3,
                                     n_moves_per_step=moves, accept_draws=draws, adapt=adapt)
    state = TM.mh_init(spec.initial_pose().expand(3, 8, 6), scene,
                       prng.fold_in(prng.key(1), torch.arange(3)), cfg.mode)
    guarded_scene = _guard(scene)
    with pytest.raises(AssertionError, match="host read"):
        float(guarded_scene.w_offlimits)  # the guard works
    guarded = _guard(state)
    for _ in range(3):
        guarded = TM.mh_step(guarded, guarded_scene, cfg)
        state = TM.mh_step(state, scene, cfg)
    assert isinstance(guarded.pose, NoHostRead)
    assert torch.equal(guarded.pose.as_subclass(torch.Tensor), state.pose)
    # a runner's step decides the off-limits gate once, outside the steps
    step = TM.ChainStep(scene, cfg)
    step.scene = guarded_scene
    step.tables = TM.MoveTables.build(guarded_scene, cfg)
    step(guarded)


def test_offlimits_gate_decided_once_per_scene():
    """FIXED at a zero off-limits weight skips the term in the loop and
    gives the same totals as evaluating it."""
    spec = mh_tpu_torch.demo_scene(10)
    cfg = mh_tpu_torch.SamplerConfig(iterations=15, n_chains=3, mode=mh_tpu_torch.CostMode.FIXED)
    scene = spec.build()
    assert TM.ChainStep(scene, cfg).with_off is False
    assert TM.ChainStep(dataclasses.replace(scene, w_offlimits=torch.tensor(-1.0)),
                        cfg).with_off is True
    states, _ = TM.run_chains(prng.key(2), spec.initial_pose(), scene, cfg)
    keys = prng.fold_in(prng.key(2), torch.arange(3))
    state = TM.mh_init(spec.initial_pose().expand(3, 10, 6), scene, keys, cfg.mode)
    for _ in range(15):
        state = TM.mh_step(state, scene, cfg)  # evaluates the zero-weight term
    assert torch.equal(state.pose, states.pose)
    assert torch.equal(state.costs.total, states.costs.total)


@pytest.mark.parametrize("case", ["parity", "block_4x4_adapt", "compiled"])
def test_zero_signs_match_mh_tpu(case):
    """A start pose with its x and rotation columns at -0.0: the chains
    that agree end with mh_tpu's sign bits on every zero (mh_tpu's moves
    write every row, which turns an untouched -0.0 into +0.0 unless every
    zero they add is -0.0)."""
    js, ts, pose0 = scenes()
    pose0[:, [0, 4]] = np.float32(-0.0)
    jc, tc = configs(iterations=20, **CASES.get(case, {}))
    want, _ = JM.run_chains(jax.random.key(6), jnp.asarray(pose0), js, jc)
    if case == "compiled":
        got, _ = TM.compile_chains(ts, tc)(prng.key(6), torch.as_tensor(pose0))
    else:
        got, _ = TM.run_chains(prng.key(6), torch.as_tensor(pose0), ts, tc)
    same = assert_chains_agree(got.to_numpy(), jax_state_numpy(want))
    assert same.sum() >= 6
    gp, wp = got.pose.numpy()[same], np.asarray(want.pose)[same]
    np.testing.assert_array_equal(np.signbit(gp), np.signbit(wp))
    assert np.array_equal(gp == 0, wp == 0) and (wp == 0).any()
