"""The fused kernel's O(N) symmetry state and its reduction order, on the CPU.

The CUDA kernel keeps, per chain, each reflection's best symmetry match
and the lowest candidate that reaches it, and rescans only the rows a move
can change (``csrc/fused_mh.cu``). ``fused_chains_reference(...,
incremental=True)`` keeps the same state in plain PyTorch. A max is exact
in any order, so the state must give the full recompute's bits in every
chain: that is held here bitwise, and against ``mh_tpu``'s own incremental
kernel (Pallas interpreter) at the tolerances of tests/test_torch_fused.py.
The kernel's warp reduction must sum in ``_block_sum``'s order: an exact
emulation of it is held to ``_block_sum`` bit for bit.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mh_tpu
from mh_tpu.kernels import fused_mh as JF
import mh_tpu_torch
from mh_tpu_torch.kernels import fused_mh as TF
import test_torch_threads  # noqa: F401
from test_torch_fused import assert_breakdowns_self_consistent, assert_chains_agree, configs
from test_torch_scene import to_torch_scene

H100_SMEM_PER_SM = 233472  # 228 KB, of which a block may take 227 KB
BLOCK_RESERVED_SMEM = 1024  # the runtime's share of each block


def run_pair(n, mode="PARITY", w_off=0.0, iters=200, chains=12, seed=3, frozen=False,
             **cfg_kw):
    """The plain version with and without the symmetry state, same inputs."""
    spec = mh_tpu_torch.demo_scene(n)
    if frozen:
        spec.frozen = np.arange(n) % 3 == 0
    scene = dataclasses.replace(spec.build(), w_offlimits=torch.tensor(w_off))
    cfg = mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode[mode], **cfg_kw)
    pk = TF.pack_scene(scene, cfg)
    pose0 = spec.initial_pose().expand(chains, n, 6).contiguous()
    full = TF.fused_chains_reference(pk, pose0, seed, iters)
    inc = TF.fused_chains_reference(pk, pose0, seed, iters, incremental=True)
    return full, inc


@pytest.mark.parametrize("case", [
    dict(n=32),
    dict(n=32, mode="FIXED"),
    dict(n=32, mode="FIXED", w_off=-1.5),
    dict(n=37),  # ragged: not a multiple of a warp
    dict(n=37, frozen=True),
    dict(n=32, beta=1e-3, adapt=True),  # hot: most steps accept and commit
    dict(n=24, sigma_xy_override=1e-4, sigma_t=1e-4, beta=1e-3),  # swaps carry the moves
    dict(n=32, n_moves_per_step=4, accept_draws=4),
    dict(n=24, n_moves_per_step=4, beta=1e-3, adapt=True),
], ids=["parity", "fixed", "fixed_weighted", "ragged_37", "frozen", "hot", "swap_heavy",
        "compound_4x4", "compound_hot"])
def test_incremental_equals_full_bitwise(case):
    full, inc = run_pair(**case)
    for a, b in zip(full, inc):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    accepts = full[2].double().mean().item() / 200
    assert accepts > 0.05, accepts  # the chains moved, so the state was exercised


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sym_update_follows_swaps_and_moves(seed):
    """Step the bookkeeping over random swaps and translations of a
    symmetric layout (argbests move often) without any accept/reject, and
    hold best and argbest to the full match after every step."""
    rng = np.random.default_rng(seed)
    n, chains = 20, 6
    spec = mh_tpu_torch.demo_scene(n)
    spec.frozen = np.zeros(n, bool)
    spec.frozen[[3, 11]] = True  # frozen objects stay candidates
    pk = TF.pack_scene(spec.build(), mh_tpu_torch.SamplerConfig())
    obj = TF._Objective(pk)
    ps = spec.initial_pose().expand(chains, n, 6).permute(2, 0, 1).contiguous()
    ps[0] += torch.as_tensor(rng.normal(size=(chains, n)).astype(np.float32)) * 0.05
    best, arg, _ = obj.sym_rows(ps[0], ps[1], ps[4])
    for _ in range(40):
        moved = torch.zeros(chains, n, dtype=torch.bool)
        star = ps.clone()
        for c in range(chains):
            i, j = rng.choice(n, 2, replace=False)
            if rng.uniform() < 0.6:
                star[:, c, [i, j]] = star[:, c, [j, i]]
                moved[c, [i, j]] = True
            else:
                star[0, c, i] += float(rng.normal()) * 0.5
                star[4, c, i] = float(rng.uniform(-3.0, 3.0))
                moved[c, i] = True
        best, arg = TF._sym_update(obj, star, moved, best, arg)
        want_b, want_a, _ = obj.sym_rows(star[0], star[1], star[4])
        np.testing.assert_array_equal(best.numpy().view(np.int32), want_b.numpy().view(np.int32))
        np.testing.assert_array_equal(arg.numpy(), want_a.numpy())
        ps = star


@pytest.mark.parametrize("mode,w_off", [("PARITY", 0.0), ("FIXED", -1.5)])
def test_incremental_matches_jax_incremental_kernel(mode, w_off):
    """Both packages' incremental forms on one scene, start and seed."""
    spec = mh_tpu.demo_scene(32)
    js = dataclasses.replace(spec.build(), w_offlimits=jnp.float32(w_off))
    pose0 = np.array(spec.initial_pose())
    jcfg, tcfg = configs(mode)
    jout = JF.run_chains_fused(3, jnp.asarray(pose0), js, jcfg, 8, 60, interpret=True,
                               incremental=True)
    pk = TF.pack_scene(to_torch_scene(js), tcfg)
    tout = TF.fused_chains_reference(pk, torch.as_tensor(pose0).expand(8, 32, 6).contiguous(),
                                     3, 60, incremental=True)
    jout, tout = [np.asarray(a) for a in jout], [a.numpy() for a in tout]
    same = assert_chains_agree(jout, tout, 8)
    assert same.sum() >= 6
    assert 0 < tout[2].mean() < 60
    assert_breakdowns_self_consistent(js, tout[0], tout[1], mode)


def warp_tree_sum(v: np.ndarray) -> np.ndarray:
    """``reduce_rows`` of csrc/fused_mh.cu in float32: lane l of one warp
    sums objects l + 32 h, l + 32 h + 128, ... into partial h (h < 4), forms
    (q0 + q2) + (q1 + q3), then adds __shfl_down_sync at 16, 8, 4, 2, 1."""
    c, n = v.shape
    out = np.zeros(c, np.float32)
    for r in range(c):
        q = np.zeros((4, 32), np.float32)
        for i in range(n):
            q[(i % 128) // 32, i % 32] = np.float32(q[(i % 128) // 32, i % 32] + v[r, i])
        t = (q[0] + q[2]) + (q[1] + q[3])
        for o in (16, 8, 4, 2, 1):
            t = t + np.concatenate([t[o:], np.zeros(o, np.float32)])
        out[r] = t[0]
    return out


@pytest.mark.parametrize("n", [1, 37, 100, 128, 300, 512])
def test_warp_reduction_is_the_block_sum_order(n):
    rng = np.random.default_rng(n)
    v = (rng.normal(size=(4, n)) * rng.choice([1e-3, 1.0, 1e4], size=(4, n))).astype(np.float32)
    got = warp_tree_sum(v)
    want = TF._block_sum(torch.as_tensor(v)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("moves,n,incremental", [
    (1, 100, True), (1, 512, True), (1, 4, False), (4, 32, True), (8, 32, False),
    (64, 100, False), (16, 100, True)])
def test_sym_incremental_picks_the_cheaper_scheme(moves, n, incremental):
    """~4 N evaluations a moved move against N^2 for the full match."""
    assert TF.sym_incremental(moves, n) is incremental


@pytest.mark.parametrize("n,n_clr,blocks,track_off", [
    pytest.param(100, 2, 8, False, id="100-2-8"), pytest.param(512, 2, 2, False, id="512-2-2"),
    pytest.param(100, 2, 8, True, id="100-2-8-fixed_weighted"),
    pytest.param(512, 2, 2, True, id="512-2-2-fixed_weighted"),
    pytest.param(100, 100, 8, False, id="100-100-8")])
def test_shared_memory_keeps_blocks_per_sm(n, n_clr, blocks, track_off):
    """At 100 objects shared memory leaves room for the 8 blocks an SM's
    registers hold (1024 chains in one wave on 132 SMs), with 2 clearances
    and with 100 (a clearance row's partials take none); at 512 objects at
    least 2 blocks fit an SM; also with the FIXED off-limits slab state
    (``track_off``)."""
    for moves in (1, 64):
        per_block = TF.smem_bytes(n, n_clr, moves, track_off) + BLOCK_RESERVED_SMEM
        assert H100_SMEM_PER_SM // per_block >= blocks
