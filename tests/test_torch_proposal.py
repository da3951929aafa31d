"""mh_tpu_torch.sampler.proposal against mh_tpu.sampler.proposal.

The same uniforms (made with numpy) go into both; the poses must agree to
1e-6 (relative and absolute). They part by ulps only: the Box-Muller
log/sqrt/cos/sin of XLA and of PyTorch round differently, and mh_tpu's
one-hot arithmetic and the port's indexed rows compute the touched rows
with the same expressions. Plus the invariants of tests/test_proposal.py.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mh_tpu
import mh_tpu_torch
from mh_tpu.sampler import proposal as JP
from mh_tpu_torch.sampler import proposal as TP
import test_torch_threads  # noqa: F401
from test_costs import random_spec
from test_torch_scene import to_torch_scene

TOL = dict(rtol=1e-6, atol=1e-6)


@partial(jax.jit, static_argnames=("cfg",))
def _jax_block(u, pose, scene, cfg, scale):
    return JP.block_propose_from_uniforms(u, pose, scene, cfg, scale)


def configs(mode: str, **kw):
    return (mh_tpu.SamplerConfig(mode=mh_tpu.CostMode[mode], **kw),
            mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode[mode], **kw))


def scene_pair(seed: int, n_frozen: int, n: int = 12, pad: int = 16):
    """A random scene padded to ``pad`` lanes with ``n_frozen`` frozen objects."""
    rng = np.random.default_rng(seed)
    spec = random_spec(rng, n=n)
    frozen = np.zeros(n, bool)
    frozen[rng.choice(n, size=n_frozen, replace=False)] = True
    spec.frozen = frozen
    js = spec.build(pad_objs=pad)
    return js, to_torch_scene(js), np.array(spec.initial_pose(pad_objs=pad)), rng


def compare(u, pose, js, ts, mode, scale=1.0, **kw):
    jc, tc = configs(mode, **kw)
    want = np.asarray(_jax_block(jnp.asarray(u), jnp.asarray(pose), js, jc, jnp.float32(scale)))
    got = TP.block_propose_from_uniforms(torch.as_tensor(u), torch.as_tensor(pose), ts, tc,
                                         torch.tensor(scale, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    return got


@pytest.mark.parametrize("mode", ["PARITY", "FIXED"])
@pytest.mark.parametrize("seed,n_frozen,moves", [(0, 0, 1), (1, 3, 1), (2, 5, 6), (3, 1, 6)])
def test_same_uniforms_same_poses(seed, n_frozen, moves, mode):
    js, ts, pose, rng = scene_pair(seed, n_frozen)
    for _ in range(20):
        u = rng.uniform(0.0, 1.0, (moves, 8)).astype(np.float32)
        compare(u, pose, js, ts, mode, scale=float(rng.uniform(0.5, 2.0)))


def test_every_move_type_and_clamp():
    """Translate (clamped to the surface at a huge sigma), rotate (wrapped)
    and swap, each forced through u[0]."""
    js, ts, pose, rng = scene_pair(4, 2)
    for kind in (0.1, 0.5, 0.9):
        for _ in range(10):
            u = rng.uniform(0.0, 1.0, (4, 8)).astype(np.float32)
            u[:, 0] = kind
            got = compare(u, pose, js, ts, "PARITY", sigma_xy_override=50.0)
            assert np.all(got[:, :2] >= -1e-6) and np.all(got[:, :2] <= 10.0 + 1e-6)


@pytest.mark.parametrize("n_unfrozen", [0, 1])
def test_zero_or_one_movable_object(n_unfrozen):
    """No movable object: nothing moves. One: swaps are no-ops, the others
    move only that object."""
    js, ts, pose, rng = scene_pair(5, 12 - n_unfrozen)
    for _ in range(20):
        u = rng.uniform(0.0, 1.0, (3, 8)).astype(np.float32)
        got = compare(u, pose, js, ts, "FIXED")
        movable = ~np.asarray(js.frozen) & (np.asarray(js.obj_mask) > 0)
        np.testing.assert_array_equal(got[~movable], pose[~movable])
        if n_unfrozen == 0:
            np.testing.assert_array_equal(got, pose)


def test_single_object_scene_never_swaps():
    spec = mh_tpu.demo_scene(1)
    js = spec.build(pad_objs=4)
    ts = to_torch_scene(js)
    assert int(ts.n_objs) == int(js.n_objs) == 1
    pose = np.array(spec.initial_pose(pad_objs=4))
    u = np.full((2, 8), 0.95, np.float32)  # move type 2 (swap) twice
    np.testing.assert_array_equal(compare(u, pose, js, ts, "PARITY"), pose)


# --- invariants of tests/test_proposal.py, on the port alone -----------------

def _port_scene(n=8, frozen_idx=()):
    spec = mh_tpu_torch.demo_scene(n)
    frozen = np.zeros(n, bool)
    frozen[list(frozen_idx)] = True
    spec.frozen = frozen
    return spec.build(), spec.initial_pose()


def _forced(rng, kind: float, moves: int = 1) -> torch.Tensor:
    u = rng.uniform(0.0, 1.0, (moves, 8)).astype(np.float32)
    if kind >= 0:
        u[:, 0] = kind
    return torch.as_tensor(u)


def test_translate_clamps_and_rotate_wraps():
    scene, pose = _port_scene()
    rng = np.random.default_rng(0)
    cfg = mh_tpu_torch.SamplerConfig(sigma_xy_override=50.0)
    for _ in range(50):
        pose = TP.block_propose_from_uniforms(_forced(rng, 0.1), pose, scene, cfg, 1.0)
        pose = TP.block_propose_from_uniforms(_forced(rng, 0.5), pose, scene, cfg, 1.0)
    xy, rot = pose[:, :2].numpy(), pose[:, 4].numpy()
    assert np.all(xy >= 0.0) and np.all(xy <= 10.0)
    assert np.all(rot >= 0.0) and np.all(rot <= 2 * mh_tpu_torch.CostMode.PARITY.pi + 1e-6)


def test_swap_preserves_pose_multiset():
    scene, pose = _port_scene()
    rng = np.random.default_rng(1)
    before = np.sort(pose.numpy(), axis=0)
    cfg = mh_tpu_torch.SamplerConfig()
    for _ in range(20):
        pose = TP.block_propose_from_uniforms(_forced(rng, 0.9), pose, scene, cfg, 1.0)
    np.testing.assert_array_equal(np.sort(pose.numpy(), axis=0), before)


def test_frozen_objects_never_move_and_all_frozen_is_noop():
    scene, pose = _port_scene(frozen_idx=(2, 5))
    orig = pose.clone()
    cfg = mh_tpu_torch.SamplerConfig()
    key = mh_tpu_torch.sampler.prng.key(0)
    for s in range(200):
        pose = TP.propose(mh_tpu_torch.sampler.prng.fold_in(key, s), pose, scene, cfg, 1.0)
    assert torch.equal(pose[2], orig[2]) and torch.equal(pose[5], orig[5])
    assert not torch.equal(pose, orig)
    scene, pose = _port_scene(n=4, frozen_idx=(0, 1, 2, 3))
    out = TP.propose(key, pose, scene, cfg, 1.0)
    assert torch.equal(out, pose)


def test_block_propose_moves_multiple_objects():
    scene, pose = _port_scene(n=16)
    cfg = mh_tpu_torch.SamplerConfig(n_moves_per_step=8)
    out = TP.block_propose(mh_tpu_torch.sampler.prng.key(1), pose, scene, cfg, 1.0)
    assert int(torch.any(out != pose, dim=1).sum()) >= 2


def test_rank_pick_exact_uniform_and_edges():
    """Every movable object owns an equal share of a dense u grid; frozen
    and padded lanes are never picked; u = 0 and u = 1 hit the ends."""
    spec = mh_tpu_torch.demo_scene(6)
    spec.frozen = np.array([False, True, False, False, True, False])
    scene = spec.build(pad_objs=8)
    tables = TP.MoveTables.build(scene, mh_tpu_torch.SamplerConfig())
    grid = 400
    u = torch.zeros(grid, 1, 8)
    u[:, 0, 6] = (torch.arange(grid, dtype=torch.float64) + 0.5).float() / grid
    picks = TP.decode_moves(u, tables, 1.0)[4][:, 0]
    counts = np.bincount(picks.numpy(), minlength=8)
    np.testing.assert_array_equal(counts, [100, 0, 100, 100, 0, 100, 0, 0])
    edge = torch.zeros(2, 1, 8)
    edge[1, 0, 6] = 1.0
    np.testing.assert_array_equal(TP.decode_moves(edge, tables, 1.0)[4][:, 0].numpy(), [0, 5])


def test_scale_and_sigma_follow_mh_tpu():
    js, ts, _, _ = scene_pair(6, 0)
    for override in (0.0, 0.7):
        jc, tc = configs("PARITY", sigma_xy_override=override)
        for a, b in zip(JP.translation_sigmas(js, jc), TP.translation_sigmas(ts, tc)):
            assert float(a) == float(b)
    assert dataclasses.is_dataclass(TP.MoveTables.build(ts, tc))


# --- the single-move wrappers against mh_tpu's, on jax.random's keys ---------

N_KEYS = 32


@pytest.mark.parametrize("shape", [(1000,), (4, 7)])
def test_gumbel_matches_jax(shape):
    from mh_tpu_torch.sampler import prng

    for seed in (0, 5, 2**31 + 3):
        want = np.asarray(jax.random.gumbel(jax.random.key(seed), shape))
        got = prng.gumbel(prng.key(seed), shape).numpy()
        assert got.dtype == np.float32 and got.shape == want.shape
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
        assert ulps.max() <= 2, ulps.max()


@pytest.mark.parametrize("seed,n_frozen", [(7, 4), (8, 0), (9, 11)])
def test_pick_unfrozen_matches_mh_tpu(seed, n_frozen):
    """The same index for every key; never a frozen or padded object."""
    from mh_tpu_torch.sampler import prng

    js, ts, _, _ = scene_pair(seed, n_frozen)
    pick = jax.jit(JP.pick_unfrozen)
    movable = ~np.asarray(js.frozen) & (np.asarray(js.obj_mask) > 0)
    picks = []
    for k in range(N_KEYS):
        want = int(pick(jax.random.key(k), js))
        got = TP.pick_unfrozen(prng.key(k), ts)
        assert got.dtype == torch.int64 and int(got) == want
        assert movable[want]
        picks.append(want)
    assert len(set(picks)) >= min(3, int(movable.sum()))


@pytest.mark.parametrize("mode", ["PARITY", "FIXED"])
@pytest.mark.parametrize("move", ["translate", "rotate", "swap"])
def test_single_move_wrappers_match_mh_tpu(move, mode):
    """From the same key data the wrappers give poses within 1e-6."""
    from mh_tpu_torch.sampler import prng

    js, ts, pose, _ = scene_pair(10, 3)
    jc, tc = configs(mode, sigma_xy_override=3.0 if mode == "FIXED" else 0.0)
    if move == "swap":
        jfn = jax.jit(JP.swap_move)
        run_j = lambda k: jfn(k, jnp.asarray(pose), js)  # noqa: E731
        run_t = lambda k: TP.swap_move(k, torch.as_tensor(pose), ts)  # noqa: E731
    else:
        jfn = jax.jit(getattr(JP, f"{move}_move"), static_argnames=("cfg",))
        tfn = getattr(TP, f"{move}_move")
        run_j = lambda k: jfn(k, jnp.asarray(pose), js, jc, jnp.float32(1.5))  # noqa: E731
        run_t = lambda k: tfn(k, torch.as_tensor(pose), ts, tc, 1.5)  # noqa: E731
    changed = 0
    for k in range(N_KEYS):
        want = np.asarray(run_j(jax.random.key(k)))
        got = run_t(prng.key(k)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        changed += int(np.any(got != pose))
    assert changed >= N_KEYS // 2


# --- zero signs: mh_tpu writes every row, so a -0.0 it does not move can turn +0.0

def _with_zeros(pose: np.ndarray, rng) -> np.ndarray:
    """``pose`` with about half its coordinates set to -0.0 and a tenth to
    +0.0, in every column."""
    pose = np.where(rng.random(pose.shape) < 0.5, np.float32(-0.0), pose)
    return np.where(rng.random(pose.shape) < 0.1, np.float32(0.0), pose).astype(np.float32)


def assert_same_bits_of_zeros(got: np.ndarray, want: np.ndarray):
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    assert np.array_equal(got == 0, want == 0)


@pytest.mark.parametrize("mode", ["PARITY", "FIXED"])
@pytest.mark.parametrize("seed,n_frozen,moves", [(20, 0, 1), (21, 3, 1), (22, 2, 6),
                                                 (23, 12, 3), (24, 11, 2)])
def test_zero_signs_match_mh_tpu(seed, n_frozen, moves, mode):
    """Single moves and the block layout from a pose holding -0.0 and +0.0
    give mh_tpu's values and sign bits: translate, rotate and swap, the
    same object picked twice, frozen objects, none or one movable."""
    js, ts, pose, rng = scene_pair(seed, n_frozen)
    pose = _with_zeros(pose, rng)
    jc, tc = configs(mode)
    for i in range(16):
        u = rng.uniform(0.0, 1.0, (moves, 8)).astype(np.float32)
        u[:, 0] = (i % 3 + 0.5) / 3.0 if i < 12 else u[:, 0]
        if i % 4 == 3:
            u[:, 7] = u[:, 6]
        want = np.asarray(_jax_block(jnp.asarray(u), jnp.asarray(pose), js, jc, jnp.float32(1.0)))
        got = TP.block_propose_from_uniforms(torch.as_tensor(u), torch.as_tensor(pose), ts, tc,
                                             1.0).numpy()
        assert_same_bits_of_zeros(got, want)


@pytest.mark.parametrize("move", ["translate", "rotate", "swap"])
def test_single_move_wrappers_keep_mh_tpu_zero_signs(move):
    from mh_tpu_torch.sampler import prng

    js, ts, pose, rng = scene_pair(12, 2)
    pose = _with_zeros(pose, rng)
    pose[:, [0, 4]] = np.float32(-0.0)
    jc, tc = configs("PARITY")
    if move == "swap":
        jfn = jax.jit(JP.swap_move)
        run_j = lambda k: jfn(k, jnp.asarray(pose), js)  # noqa: E731
        run_t = lambda k: TP.swap_move(k, torch.as_tensor(pose), ts)  # noqa: E731
    else:
        jfn = jax.jit(getattr(JP, f"{move}_move"), static_argnames=("cfg",))
        tfn = getattr(TP, f"{move}_move")
        run_j = lambda k: jfn(k, jnp.asarray(pose), js, jc, jnp.float32(1.5))  # noqa: E731
        run_t = lambda k: tfn(k, torch.as_tensor(pose), ts, tc, 1.5)  # noqa: E731
    for k in range(N_KEYS // 2):
        assert_same_bits_of_zeros(run_t(prng.key(k)).numpy(), np.asarray(run_j(jax.random.key(k))))
