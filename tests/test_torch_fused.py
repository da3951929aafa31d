"""The port's fused chain (mh_tpu_torch.kernels.fused_mh) against mh_tpu's.

On the CPU the port runs its plain PyTorch version of the CUDA kernel; it
is held against the JAX kernel run by the Pallas interpreter
(``run_chains_fused(..., interpret=True)``) on the same scene, start pose
and seed:

- random bits: exactly equal to ``_uniform_sw``;
- trajectories: accept counts equal and poses within 1e-4, except for at
  most 2 of 8 chains. Both sides compute in float32, but XLA's and
  PyTorch's CPU log/cos/sin differ by an ulp and their sums run in other
  orders, so a total can differ by a few ulps (~1e-3 at 32 objects); an
  accept decision flips when its uniform falls that close to the
  acceptance ratio, and that chain then follows another path;
- every chain's reported breakdown matches mh_tpu's ``cost_terms`` on its
  final pose at rtol=2e-4, atol=2e-3 (tests/test_fused_kernel.py:38).

tests/test_torch_cuda.py holds the CUDA kernel against the plain version
on a card.
"""

from __future__ import annotations

import dataclasses
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mh_tpu
from mh_tpu.kernels import fused_mh as JF
from mh_tpu.ops.costs import cost_terms as jax_cost_terms
import mh_tpu_torch
from mh_tpu_torch.kernels import _build
from mh_tpu_torch.kernels import counter_rng
from mh_tpu_torch.kernels import fused_mh as TF
from test_costs import random_spec
from test_torch_scene import to_torch_scene

RTOL, ATOL = 2e-4, 2e-3
POSE_ATOL = 1e-4
MAX_DIVERGENT = 2


def configs(mode: str, **kw):
    return (mh_tpu.SamplerConfig(mode=mh_tpu.CostMode[mode], **kw),
            mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode[mode], **kw))


def run_both(js, pose0, mode, n_chains, iterations, seed, **cfg_kw):
    jcfg, tcfg = configs(mode, **cfg_kw)
    jout = JF.run_chains_fused(
        seed, jnp.asarray(pose0), js, jcfg, n_chains, iterations, interpret=True
    )
    tout = TF.run_chains_fused(
        seed, torch.as_tensor(pose0), to_torch_scene(js), tcfg, n_chains, iterations
    )
    return [np.asarray(a) for a in jout], [a.numpy() for a in tout]


def assert_chains_agree(jout, tout, n_chains):
    jp, jb, ja, js = jout
    tp, tb, ta, ts = tout
    assert tp.shape == jp.shape and tb.shape == jb.shape
    assert ta.dtype == np.int32 and ta.shape == ja.shape == ts.shape
    same = (ja == ta) & (np.abs(jp - tp).max(axis=(1, 2)) <= POSE_ATOL)
    assert (~same).sum() <= MAX_DIVERGENT, (ja, ta)
    np.testing.assert_allclose(tb[same], jb[same], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ts[same], js[same], rtol=1e-5)
    return same


def assert_breakdowns_self_consistent(js, pose, breakdown, mode):
    for c in range(pose.shape[0]):
        ref = np.asarray(jax_cost_terms(jnp.asarray(pose[c]), js, mh_tpu.CostMode[mode])
                         .as_vector())
        np.testing.assert_allclose(breakdown[c], ref, rtol=RTOL, atol=ATOL)


# ---- random stream ----------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 7, -3, 2**31 - 1])
@pytest.mark.parametrize("counter,row_offset", [(0, 0), (5, 40), (1000, 1 << 20)])
def test_uniform_block_bits_equal_uniform_sw(seed, counter, row_offset):
    base = (jnp.int32(seed) * JF._i32c(0x9E3779B9)) ^ (
        jnp.int32(counter) * JF._i32c(0x85EBCA6B))
    want = np.asarray(JF._uniform_sw(base, (16, TF.DRAW_LANES), row_offset=row_offset))
    got = TF.uniform_block(seed, counter, row_offset, 16).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() > 0.0 and got.max() < 1.0


def test_mul32_wraps_like_uint32():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, size=4096, dtype=np.uint64)
    for c in (0xED5AD4BB, 0xAC4C1B51, 0x31848BAB, 0xFFFFFFFF, 1):
        want = (x * np.uint64(c)) & np.uint64(0xFFFFFFFF)  # uint64 wraps mod 2^64
        got = counter_rng.mul32(torch.as_tensor(x.astype(np.int64)), c).numpy()
        np.testing.assert_array_equal(got.astype(np.uint64), want)


def test_block_sum_is_the_kernel_order():
    """Thread t sums lanes t, t+128, ...; then partials fold by halving."""
    rng = np.random.default_rng(1)
    v = rng.normal(size=(3, 300)).astype(np.float32) * 1e3
    want = np.zeros(3, np.float32)
    for c in range(3):
        part = np.zeros(TF.THREADS, np.float32)
        for i in range(300):
            part[i % TF.THREADS] = np.float32(part[i % TF.THREADS] + v[c, i])
        s = TF.THREADS // 2
        while s:
            part[:s] = part[:s] + part[s:2 * s]
            s //= 2
        want[c] = part[0]
    got = TF._block_sum(torch.as_tensor(v)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, v.sum(axis=1), rtol=1e-5, atol=1e-2)


# ---- trajectories against the JAX kernel --------------------------------------
@pytest.mark.parametrize("mode,w_off", [("PARITY", 0.0), ("FIXED", 0.0), ("FIXED", -1.5)])
def test_reference_matches_jax_kernel(mode, w_off):
    spec = mh_tpu.demo_scene(32)
    js = dataclasses.replace(spec.build(), w_offlimits=jnp.float32(w_off))
    pose0 = np.array(spec.initial_pose())
    jout, tout = run_both(js, pose0, mode, 8, 60, seed=3)
    same = assert_chains_agree(jout, tout, 8)
    assert same.sum() >= 6
    assert 0 < tout[2].mean() < 60
    assert_breakdowns_self_consistent(js, tout[0], tout[1], mode)


@pytest.mark.parametrize("seed", [2**31 - 1, 2**31, 2**32 + 5, -1])
def test_int64_seeds_match_jax_kernel_on_their_low_32_bits(seed):
    """A wire seed is int64. The port's kernel takes its low 32 bits, as
    mh_tpu's does for an int32 seed; mh_tpu's fused path packs the seed as
    int32 and raises outside that range (ROADMAP Queue 3), where the port
    equals mh_tpu at the int32 with the same bits."""
    spec = mh_tpu.demo_scene(8)
    js, pose0 = spec.build(), np.array(spec.initial_pose())
    low = int(np.array(seed & 0xFFFFFFFF, np.uint32).view(np.int32))
    jcfg, tcfg = configs("PARITY")
    if low != seed:
        with pytest.raises(OverflowError):
            JF.run_chains_fused(seed, jnp.asarray(pose0), js, jcfg, 8, 30, interpret=True)
    jout, _ = run_both(js, pose0, "PARITY", 8, 30, seed=low)
    tout = [a.numpy() for a in TF.run_chains_fused(seed, torch.as_tensor(pose0),
                                                   to_torch_scene(js), tcfg, 8, 30)]
    assert assert_chains_agree(jout, tout, 8).sum() >= 6
    assert tout[2].any()


def test_reference_matches_jax_kernel_random_scene():
    """Random geometry, both angle regimes, 3 clearances, frozen objects and
    a weighted off-limits term (tracked in FIXED mode)."""
    rng = np.random.default_rng(23)
    spec = random_spec(rng)
    spec.frozen = rng.uniform(size=spec.n_objs) < 0.3
    js = spec.build()
    pose0 = np.array(spec.initial_pose())
    jout, tout = run_both(js, pose0, "FIXED", 8, 48, seed=11)
    assert_chains_agree(jout, tout, 8)
    frozen = np.asarray(spec.frozen)
    np.testing.assert_array_equal(tout[0][:, frozen], np.broadcast_to(pose0[frozen], (8,) + pose0[frozen].shape))
    assert_breakdowns_self_consistent(js, tout[0], tout[1], "FIXED")


def test_reference_matches_jax_kernel_with_adaptation():
    spec = mh_tpu.demo_scene(16)
    pose0 = np.array(spec.initial_pose())
    jout, tout = run_both(spec.build(), pose0, "PARITY", 8, 40, seed=5, adapt=True)
    assert_chains_agree(jout, tout, 8)
    assert not np.allclose(tout[3], 1.0)


@pytest.mark.parametrize("moves,draws", [(4, 1), (4, 4), (1, 16), (1, 30)])
@pytest.mark.parametrize("mode,w_off", [("PARITY", 0.0), ("FIXED", -1.5)])
def test_compound_moves_and_accept_draws_match_jax_kernel(moves, draws, mode, w_off):
    """Compound block proposals (``iter_body_multi``) and the min-of-K accept
    rule, in both draw layouts: K accept lanes beside each single move
    (K=30 is 38 lanes a step, 3 steps a counter) and one counter per accept
    block plus one per move."""
    spec = mh_tpu.demo_scene(32)
    js = dataclasses.replace(spec.build(), w_offlimits=jnp.float32(w_off))
    pose0 = np.array(spec.initial_pose())
    jout, tout = run_both(js, pose0, mode, 8, 40, seed=13,
                          n_moves_per_step=moves, accept_draws=draws)
    same = assert_chains_agree(jout, tout, 8)
    assert same.sum() >= 6
    assert 0 < tout[2].mean() < 40
    assert_breakdowns_self_consistent(js, tout[0], tout[1], mode)


@pytest.mark.parametrize("accept_draws,lanes,unroll",
                         [(1, 8, 4), (16, 24, 4), (30, 38, 3), (64, 72, 1), (120, 128, 1)])
def test_step_layout(accept_draws, lanes, unroll):
    assert TF.step_layout(accept_draws) == (lanes, unroll)


@pytest.mark.parametrize("moves", [1, 4])
def test_accept_draws_lifts_acceptance(moves):
    """K accept draws (the Kernel.cu:819 per-thread accept) lift the realized
    acceptance toward 1 - (1 - p)^K, as tests/test_fused_kernel.py:218-245
    holds the JAX kernel to."""
    spec = mh_tpu_torch.demo_scene(32)
    scene, pose0 = spec.build(), spec.initial_pose()
    iters, n_chains = 300, 64
    rates = []
    for draws in (1, 16):
        cfg = mh_tpu_torch.SamplerConfig(n_moves_per_step=moves, accept_draws=draws)
        _, _, acc, _ = TF.run_chains_fused(5, pose0, scene, cfg, n_chains, iters)
        rates.append(acc.double().mean().item() / iters)
    r1, rk = rates
    min_lift = 0.08 if moves == 1 else 0.05
    assert rk > r1 + min_lift, (r1, rk)
    assert rk <= 1.0


def test_zero_iterations_is_identity():
    spec = mh_tpu.demo_scene(16)
    js = spec.build()
    pose0 = np.array(spec.initial_pose())
    _, tcfg = configs("PARITY")
    pose, bd, acc, scale = TF.run_chains_fused(
        7, torch.as_tensor(pose0), to_torch_scene(js), tcfg, 8, 0)
    np.testing.assert_array_equal(pose.numpy(), np.broadcast_to(pose0, (8, 16, 6)))
    assert (acc.numpy() == 0).all() and (scale.numpy() == 1.0).all()
    assert_breakdowns_self_consistent(js, pose.numpy(), bd.numpy(), "PARITY")


def test_per_chain_start_poses():
    """f32[C, N, 6] starts: chain c of a batch equals a run started alone
    from its own pose (the stream is keyed by global chain id)."""
    spec = mh_tpu_torch.demo_scene(12)
    scene = spec.build()
    rng = np.random.default_rng(2)
    starts = torch.as_tensor(
        spec.initial_pose().numpy()[None] + rng.normal(size=(4, 12, 6)).astype(np.float32) * 0.1)
    cfg = mh_tpu_torch.SamplerConfig()
    batch = TF.run_chains_fused(9, starts, scene, cfg, 4, 30)
    shared = TF.run_chains_fused(9, starts[2], scene, cfg, 4, 30)
    torch.testing.assert_close(batch[0][2], shared[0][2], rtol=0, atol=0)
    assert torch.equal(batch[2][2], shared[2][2])


# ---- packing and the wrapper's contract -------------------------------------
def test_pack_scene_ranks_anchors_and_gates():
    rng = np.random.default_rng(4)
    spec = random_spec(rng, n=10, r=3, c=3)
    spec.frozen = np.zeros(10, bool)
    spec.frozen[[1, 4]] = True
    ts = to_torch_scene(spec.build(pad_objs=12, pad_clearances=5))
    parity = TF.pack_scene(ts, mh_tpu_torch.SamplerConfig())
    np.testing.assert_array_equal(parity.unf_idx.numpy(), [0, 2, 3, 5, 6, 7, 8, 9])
    rank = parity.planes[TF.P_RANK].numpy()
    ok = parity.planes[TF.P_OK].numpy() > 0
    np.testing.assert_array_equal(rank[ok], np.arange(1, 9))
    assert parity.scalars[TF.S_NUNF] == 8 and parity.scalars[TF.S_NOBJ] == 10
    src = [s for _, s in spec.clearances]
    np.testing.assert_array_equal(parity.clr_idx.numpy(), np.stack([src, [0, 1, 2]], 1))
    assert not parity.track_off
    fixed = TF.pack_scene(ts, mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode.FIXED))
    np.testing.assert_array_equal(fixed.clr_idx.numpy(), np.stack([src, src], 1))
    assert fixed.track_off  # random_spec weights off-limits at -1
    zero_w = dataclasses.replace(ts, w_offlimits=torch.tensor(0.0))
    assert not TF.pack_scene(zero_w, mh_tpu_torch.SamplerConfig(
        mode=mh_tpu_torch.CostMode.FIXED)).track_off


@pytest.mark.parametrize("field", ["rel_src", "ang_tgt", "clr_src"])
def test_pack_scene_rejects_out_of_range_indices(field):
    scene = mh_tpu_torch.demo_scene(6).build()
    bad = dataclasses.replace(scene, **{field: torch.full_like(getattr(scene, field), 6)})
    with pytest.raises(ValueError, match="out of range"):
        TF.pack_scene(bad, mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode.FIXED))


@pytest.mark.parametrize("draws", [0, 121])
def test_accept_draws_out_of_range_raise(draws):
    """One draw counter holds 8 proposal lanes and at most 120 accept lanes
    (mh_tpu/kernels/fused_mh.py:2356); the config refuses K < 1 itself."""
    spec = mh_tpu_torch.demo_scene(8)
    with pytest.raises(ValueError, match="accept_draws"):
        TF.run_chains_fused(0, spec.initial_pose(), spec.build(),
                            mh_tpu_torch.SamplerConfig(accept_draws=draws), 4, 10)


def test_cuda_wrapper_refuses_cpu_tensors():
    spec = mh_tpu_torch.demo_scene(8)
    pk = TF.pack_scene(spec.build(), mh_tpu_torch.SamplerConfig())
    with pytest.raises(ValueError, match="CUDA"):
        TF.fused_mh_cuda(pk, spec.initial_pose().expand(4, 8, 6).contiguous(), 0, 10)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "isfile", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()


def test_library_path_tracks_sources(tmp_path, monkeypatch):
    """One library for every source, keyed by their text and the shared headers."""
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path == _build.library_path()
    assert [p.name for p in _build._sources()] == ["fused_mh.cu", "pi_kernel.cu"]

    src = tmp_path / "csrc"
    shutil.copytree(_build.SRC_DIR, src)
    monkeypatch.setattr(_build, "SRC_DIR", src)
    assert _build.library_path() == path
    for name in ("pi_kernel.cu", "counter_rng.cuh"):
        before = _build.library_path()
        (src / name).write_text((src / name).read_text() + "\n")
        assert _build.library_path() != before
