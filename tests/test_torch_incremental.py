"""mh_tpu_torch.sampler.incremental against mh_tpu.sampler.incremental.

The same inputs (made with numpy) go into both. Tolerances: the val
matrix and its group maxima within 1e-5 (``tests/test_incremental.py``'s
own), totals within rtol 1e-4 / atol 1e-3, a proposal's candidate within
1e-6 with its touched rows ``(k1, k2)`` and every zero's sign bit equal;
whole runs by ``test_torch_mh``'s rule (accept counts equal and poses
within 1e-4 in all but at most 2 chains). Inside the port the carried
state equals a fresh evaluation of the pose bit for bit.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mh_tpu
import mh_tpu_torch
from mh_tpu.sampler import incremental as JI
from mh_tpu_torch.sampler import incremental as TI
from mh_tpu_torch.sampler import prng
import test_torch_threads  # noqa: F401
from test_torch_mh import ATOL, MAX_DIVERGENT, POSE_ATOL, RTOL, NoHostRead, _guard
from test_torch_scene import to_torch_scene

PI = mh_tpu.CostMode.PARITY.pi
MAT_ATOL = 1e-5
TOTAL = dict(rtol=1e-4, atol=1e-3)
TOL = dict(rtol=1e-6, atol=1e-6)


def scene_pair(n: int, frozen=()):
    spec = mh_tpu.demo_scene(n)
    if frozen:
        spec.frozen = np.isin(np.arange(n), frozen)
    js = spec.build()
    return js, to_torch_scene(js), np.array(spec.initial_pose())


def neg_zero(pose: np.ndarray) -> np.ndarray:
    """The pose with its x and rotation columns set to -0.0."""
    pose = pose.copy()
    pose[..., [0, 4]] = np.float32(-0.0)
    return pose


def configs(**kw):
    return mh_tpu.SamplerConfig(**kw), mh_tpu_torch.SamplerConfig(**kw)


@pytest.mark.parametrize("n", [8, 16, 40])
def test_full_val_matrix_and_init_match_mh_tpu(n):
    js, ts, pose = scene_pair(n)
    pose = np.stack([pose, pose + np.float32(0.25)])  # two chains
    want = np.asarray(jax.jit(jax.vmap(lambda p: JI.full_val_matrix(p, js, PI)))(
        jnp.asarray(pose)))
    got = TI.full_val_matrix(torch.as_tensor(pose), ts, PI).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=MAT_ATOL)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(jnp.arange(2))
    ws = jax.jit(jax.vmap(lambda p, k: JI.inc_init(p, js, k, 4)))(jnp.asarray(pose), keys)
    gs = TI.inc_init(torch.as_tensor(pose), ts, prng.fold_in(prng.key(0), torch.arange(2)), 4)
    np.testing.assert_allclose(gs.a_mat.numpy(), np.asarray(ws.a_mat), rtol=1e-5, atol=MAT_ATOL)
    np.testing.assert_allclose(gs.gmax.numpy(), np.asarray(ws.gmax), rtol=1e-5, atol=MAT_ATOL)
    np.testing.assert_allclose(gs.total.numpy(), np.asarray(ws.total), **TOTAL)
    np.testing.assert_array_equal(prng.key_data(gs.key), jax.random.key_data(ws.key))
    assert gs.step.dtype == gs.n_accept.dtype == torch.int32 and int(gs.step.sum()) == 0


@pytest.mark.parametrize("n", [16, 40])
def test_val_rounds_every_element_correctly(n):
    """``_val`` equals the same float32 expression in numpy (whose square
    root is correctly rounded, as XLA's and CUDA's are) bit for bit, in the
    N x N matrix and in a row block alike. PyTorch's own CPU ``torch.sqrt``
    is an ulp off in some of these elements."""
    _, ts, pose = scene_pair(n)
    rng = np.random.default_rng(n)
    pose = np.stack([pose, pose + rng.normal(0.0, 0.5, pose.shape).astype(np.float32)])
    tp = torch.as_tensor(pose)
    rx, ry, rrot = (t.numpy() for t in TI._refl(tp, ts, PI))
    xj, yj, rotj = pose[..., None, :, 0], pose[..., None, :, 1], pose[..., None, :, 4]
    dp = np.sqrt(np.square(xj - rx[..., None]) + np.square(yj - ry[..., None]))
    dt = rotj - rrot[..., None]
    dt = np.where(dt > PI, dt - 2 * PI, dt)
    want = np.where(ts.obj_mask.numpy() > 0, 5.0 - np.sqrt(dp) - 0.4 * np.abs(dt),
                    np.float32(-1e30)).astype(np.float32)
    got = TI.full_val_matrix(tp, ts, PI)
    assert got.numpy().tobytes() == want.tobytes()
    ks = torch.tensor([[0, n - 1], [n // 2, 3]])
    rows = TI._val(*(torch.gather(t, 1, ks)[..., None] for t in TI._refl(tp, ts, PI)),
                   tp[:, None, :, 0], tp[:, None, :, 1], tp[:, None, :, 4], ts.obj_mask, PI)
    assert torch.equal(rows, torch.gather(got, 1, ks[..., None].expand(2, 2, n)))


# --- one move and one step from the same state ------------------------------

MOVES = {"translate": 0.1, "rotate": 0.5, "swap": 0.9}
SCENES = {"plain": (), "frozen": (1, 4, 6), "none_movable": tuple(range(8))}


@pytest.mark.parametrize("scene_case", sorted(SCENES))
@pytest.mark.parametrize("move", sorted(MOVES))
def test_propose_with_info_matches_mh_tpu(move, scene_case):
    """The same uniforms give the same candidate, zero signs included, and
    the same touched rows."""
    js, ts, pose = scene_pair(8, SCENES[scene_case])
    pose = np.stack([pose, neg_zero(pose)])
    rng = np.random.default_rng(len(move) + 10 * len(scene_case))
    jc, tc = configs()
    fn = jax.jit(jax.vmap(lambda u, p: JI._propose_with_info(u, p, js, jc)))
    for _ in range(12):
        u = rng.uniform(0.0, 1.0, (2, 8)).astype(np.float32)
        u[:, 0] = MOVES[move]
        if rng.random() < 0.25:
            u[:, 7] = u[:, 6]  # the same object picked twice
        w_star, w_k1, w_k2 = (np.asarray(t) for t in fn(jnp.asarray(u), jnp.asarray(pose)))
        g_star, g_k1, g_k2 = (t.numpy() for t in TI._propose_with_info(
            torch.as_tensor(u), torch.as_tensor(pose), ts, tc))
        np.testing.assert_allclose(g_star, w_star, **TOL)
        np.testing.assert_array_equal(np.signbit(g_star), np.signbit(w_star))
        np.testing.assert_array_equal(g_k1, w_k1)
        np.testing.assert_array_equal(g_k2, w_k2)
        if scene_case == "none_movable":
            assert g_star.tobytes() == pose.tobytes()


def _jax_state(js, pose, seed, n_groups, steps):
    """mh_tpu's incremental state of 3 chains after ``steps`` steps."""
    jc, _ = configs(iterations=0)
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(jnp.arange(3))
    step = jax.jit(jax.vmap(lambda s: JI.inc_step(s, js, jc, n_groups)))
    state = jax.jit(jax.vmap(lambda k: JI.inc_init(jnp.asarray(pose), js, k, n_groups)))(keys)
    for _ in range(steps):
        state = step(state)
    return state, step


def _to_port(s) -> TI.IncState:
    return TI.IncState(
        pose=torch.as_tensor(np.array(s.pose)), a_mat=torch.as_tensor(np.array(s.a_mat)),
        gmax=torch.as_tensor(np.array(s.gmax)), total=torch.as_tensor(np.array(s.total)),
        key=prng.wrap_key_data(jax.random.key_data(s.key)),
        step=torch.as_tensor(np.array(s.step)), n_accept=torch.as_tensor(np.array(s.n_accept)))


@pytest.mark.parametrize("steps", [0, 5, 13])
def test_inc_step_from_an_mh_tpu_state(steps):
    """One step from the same carried state: the same uniforms bit for bit,
    then the same candidate, symmetry state, total and accept."""
    js, ts, pose = scene_pair(16)
    start, step = _jax_state(js, pose, 7, 4, steps)
    want = step(start)
    carried = _to_port(start)
    _, tc = configs()
    got = TI.inc_step(carried, ts, tc, 4)
    k_step = jax.vmap(jax.random.fold_in)(start.key, start.step)
    want_u = jax.vmap(lambda k: jax.random.uniform(jax.random.split(k)[0], (8,)))(k_step)
    got_u = prng.uniform(prng.split(prng.fold_in(carried.key, carried.step))[:, 0], (8,))
    assert got_u.numpy().tobytes() == np.asarray(want_u).tobytes()
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), **TOL)
    np.testing.assert_allclose(got.a_mat.numpy(), np.asarray(want.a_mat), rtol=1e-5,
                               atol=MAT_ATOL)
    np.testing.assert_allclose(got.gmax.numpy(), np.asarray(want.gmax), rtol=1e-5, atol=MAT_ATOL)
    np.testing.assert_allclose(got.total.numpy(), np.asarray(want.total), **TOTAL)
    np.testing.assert_array_equal(got.n_accept.numpy(), np.asarray(want.n_accept))
    np.testing.assert_array_equal(got.step.numpy(), np.asarray(want.step))
    assert got.step.dtype == got.n_accept.dtype == torch.int32


# --- whole runs ---------------------------------------------------------------

@pytest.mark.parametrize("n,chains,trace,start", [
    (8, 3, True, "demo"), (16, 8, False, "demo"), (16, 5, True, "neg_zero"),
])
def test_run_chains_incremental_matches_mh_tpu(n, chains, trace, start):
    js, ts, pose = scene_pair(n)
    if start == "neg_zero":
        pose = neg_zero(pose)
    jc, tc = configs(iterations=40, n_chains=chains)
    want, wt = JI.run_chains_incremental(jax.random.key(1), jnp.asarray(pose), js, jc,
                                         n_groups=4, trace_costs=trace)
    got, gt = TI.run_chains_incremental(prng.key(1), torch.as_tensor(pose), ts, tc,
                                        n_groups=4, trace_costs=trace)
    wp, gp = np.asarray(want.pose), got.pose.numpy()
    same = (got.n_accept.numpy() == np.asarray(want.n_accept)) & (
        np.abs(gp - wp).max(axis=(1, 2)) <= POSE_ATOL)
    assert (~same).sum() <= MAX_DIVERGENT and same.sum() >= chains - 1
    assert (got.n_accept > 0).all()
    np.testing.assert_allclose(got.total.numpy()[same], np.asarray(want.total)[same], **TOTAL)
    np.testing.assert_array_equal(np.signbit(gp[same]), np.signbit(wp[same]))
    np.testing.assert_array_equal(got.step.numpy(), np.asarray(want.step))
    np.testing.assert_array_equal(prng.key_data(got.key), jax.random.key_data(want.key))
    if trace:
        assert tuple(gt.shape) == np.shape(wt) == (chains, 40)
        np.testing.assert_allclose(gt.numpy()[same], np.asarray(wt)[same], **TOTAL)
        assert torch.equal(gt[:, -1], got.total)
    else:
        assert gt is None and wt is None
    # the incremental total tracks the engine's objective on the final pose
    np.testing.assert_allclose(got.total.numpy(),
                               mh_tpu_torch.total_cost(got.pose, ts).numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,n_groups,start", [(16, 4, "demo"), (40, 8, "demo"),
                                              (40, 5, "neg_zero")])
def test_carried_state_equals_a_fresh_evaluation_bitwise(n, n_groups, start):
    """After 60 steps the carried matrix, group maxima and total equal a
    fresh evaluation of the final poses bit for bit, past 32 objects too."""
    _, ts, pose = scene_pair(n)
    if start == "neg_zero":
        pose = neg_zero(pose)
    _, tc = configs(iterations=60, n_chains=4)
    got, _ = TI.run_chains_incremental(prng.key(2), torch.as_tensor(pose), ts, tc,
                                       n_groups=n_groups)
    assert (got.n_accept > 0).all()
    fresh = TI.full_val_matrix(got.pose, ts, PI)
    assert got.a_mat.numpy().tobytes() == fresh.numpy().tobytes()
    gmax = TI._group_max(fresh, n_groups)
    assert got.gmax.numpy().tobytes() == gmax.numpy().tobytes()
    total = TI._cheap_total(got.pose, ts, mh_tpu_torch.CostMode.PARITY,
                            TI._sym_from_gmax(gmax, ts))
    assert got.total.numpy().tobytes() == total.numpy().tobytes()


def test_chain_is_independent_of_the_chain_count():
    _, ts, pose = scene_pair(12)
    runs = {}
    for chains in (3, 8):
        _, tc = configs(iterations=30, n_chains=chains)
        runs[chains], _ = TI.run_chains_incremental(prng.key(4), torch.as_tensor(pose), ts, tc,
                                                    n_groups=4)
    for f in dataclasses.fields(TI.IncState):
        a, b = getattr(runs[3], f.name), getattr(runs[8], f.name)[:3]
        assert a.numpy().tobytes() == b.numpy().tobytes(), f.name
    assert not torch.equal(runs[8].pose[0], runs[8].pose[1])
    assert runs[3].pose.device.type == "cpu"


def test_per_chain_start_poses():
    """A per-chain pose0 f32[n_chains, N, 6] starts chain c at row c."""
    js, ts, pose = scene_pair(8)
    pose = np.stack([pose, neg_zero(pose)])
    jc, tc = configs(iterations=10, n_chains=2)
    want, _ = JI.run_chains_incremental(jax.random.key(5), jnp.asarray(pose), js, jc,
                                        n_groups=2)
    got, _ = TI.run_chains_incremental(prng.key(5), torch.as_tensor(pose), ts, tc, n_groups=2)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=POSE_ATOL)
    np.testing.assert_array_equal(got.n_accept.numpy(), np.asarray(want.n_accept))


def test_inc_step_reads_nothing_to_the_host():
    """A step reads no tensor back to the host (the precondition of
    capturing it as a CUDA graph)."""
    _, ts, pose = scene_pair(8)
    _, tc = configs(n_chains=3)
    state = TI.inc_init(torch.as_tensor(pose).expand(3, 8, 6),
                        ts, prng.fold_in(prng.key(1), torch.arange(3)), 4)
    guarded, guarded_scene = _guard(state), _guard(ts)
    for _ in range(3):
        guarded = TI.inc_step(guarded, guarded_scene, tc, 4)
        state = TI.inc_step(state, ts, tc, 4)
    assert isinstance(guarded.a_mat, NoHostRead)
    for f in dataclasses.fields(TI.IncState):
        assert torch.equal(getattr(guarded, f.name).as_subclass(torch.Tensor),
                           getattr(state, f.name)), f.name


@pytest.mark.parametrize("n,kw,n_groups,match", [
    (4, dict(mode="FIXED"), 2, "PARITY"),
    (4, dict(n_moves_per_step=2), 2, "single-move"),
    (8, dict(), 3, "divisible"),
    (100, dict(), 8, "divisible"),  # demo_scene(100) pads to 100 objects
])
def test_errors_match_mh_tpu(n, kw, n_groups, match):
    js, ts, pose = scene_pair(n)
    kw = dict(kw)
    mode = kw.pop("mode", "PARITY")
    jc = mh_tpu.SamplerConfig(iterations=1, mode=mh_tpu.CostMode[mode], **kw)
    tc = mh_tpu_torch.SamplerConfig(iterations=1, mode=mh_tpu_torch.CostMode[mode], **kw)
    args = {} if n_groups == 8 else dict(n_groups=n_groups)
    with pytest.raises(ValueError, match=match):
        JI.run_chains_incremental(jax.random.key(0), jnp.asarray(pose), js, jc, **args)
    with pytest.raises(ValueError, match=match):
        TI.run_chains_incremental(prng.key(0), torch.as_tensor(pose), ts, tc, **args)
    assert ts.n_pad_objs == js.n_pad_objs


def test_incremental_module_imports_no_jax():
    code = (
        "import sys\n"
        "import mh_tpu_torch.sampler.incremental as I\n"
        "from mh_tpu_torch import demo_scene, SamplerConfig\n"
        "from mh_tpu_torch.sampler import prng\n"
        "spec = demo_scene(8)\n"
        "s, t = I.run_chains_incremental(prng.key(0), spec.initial_pose(), spec.build(),\n"
        "    SamplerConfig(iterations=3, n_chains=2), n_groups=4, trace_costs=True)\n"
        "assert tuple(t.shape) == (2, 3)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'jaxlib', 'mh_tpu.'))\n"
        "               or m == 'mh_tpu' for m in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
