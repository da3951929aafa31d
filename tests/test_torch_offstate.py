"""The fused kernel's FIXED off-limits slab state and the port's two repairs, on the CPU.

FIXED mode with a nonzero off-limits weight sums that term in the loop
slab by slab (``mh_tpu/kernels/fused_mh.py:1208-1355``): cell (s, i) holds
object i's overlaps with the objects j > i of slab s. The CUDA kernel keeps
the cells and recomputes only the slab rows and columns a step's moves
change (``csrc/fused_mh.cu``); ``fused_chains_reference(...,
incremental=True)`` keeps the same state in plain PyTorch. A recomputed
cell has a from-scratch cell's bits, so the state must give the
from-scratch slab sums' bits in every chain: that is held here bitwise.
The slab order re-associates the sum, so against the unslabbed sum and
``mh_tpu``'s ``cost_terms`` the term is held at rtol 2e-4 / atol 2e-3.

The repairs: a start pose holding -0.0 keeps the JAX kernel's zero signs
through compound steps (the plain version's plane expressions are the
reference's, so the kernel follows them; tests/test_torch_cuda.py holds the
kernel to the plain version), and the accept count comes back exact past
2^24.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mh_tpu
from mh_tpu.kernels import fused_mh as JF
from mh_tpu.ops.costs import cost_terms as jax_cost_terms
import mh_tpu_torch
from mh_tpu_torch.api import auto_engine
from mh_tpu_torch.kernels import fused_mh as TF
import test_torch_threads  # noqa: F401
from test_torch_fused import RTOL, ATOL, assert_chains_agree, configs, run_both
from test_torch_scene import to_torch_scene
from test_torch_symstate import run_pair


def assert_bitwise(full, inc):
    for a, b in zip(full, inc):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [
    dict(n=64),
    dict(n=64, beta=1e-3, adapt=True),  # hot: most steps accept and commit
    dict(n=64, sigma_xy_override=1e-4, sigma_t=1e-4, beta=1e-3),  # swaps carry the moves
    dict(n=61, frozen=True),
    dict(n=61, beta=1e-3),  # ragged: 8 slabs of 8, the last one of 5
    dict(n=100, n_moves_per_step=4, beta=1e-3, iters=40),  # compound, 4 moves' slots
    dict(n=100, n_moves_per_step=4, accept_draws=4, beta=1e-3, iters=40),
    # no state (2 M >= S, or S N <= 3 THREADS): every cell from scratch
    dict(n=32, n_moves_per_step=4, accept_draws=4, beta=1e-3, state=False),
    dict(n=32, n_moves_per_step=64, accept_draws=64, beta=1e-3, adapt=True, iters=30,
         state=False),
    dict(n=37, beta=1e-3, state=False),
], ids=["single", "hot", "swap_heavy", "frozen", "ragged_61", "compound_4x1_100",
        "compound_4x4_100", "compound_4x4_no_state", "compound_64x64_no_state",
        "single_37_no_state"])
def test_incremental_off_state_equals_from_scratch_bitwise(case):
    """Weighted FIXED: the carried cells give the from-scratch slab sums'
    bits in every output of every chain (on the pattern of
    tests/test_torch_symstate.py::test_incremental_equals_full_bitwise).
    The ``no_state`` cases are sizes where the kernel keeps no cell (its
    rows are summed from scratch), so they hold the rest of the
    incremental step there."""
    case = {"iters": 100, "chains": 6, "state": True, **case}
    iters, state = case["iters"], case.pop("state")
    assert TF.off_incremental(case.get("n_moves_per_step", 1), case["n"], 2) is state
    full, inc = run_pair(mode="FIXED", w_off=-1.5, **case)
    assert_bitwise(full, inc)
    accepts = full[2].double().mean().item() / iters
    assert accepts > 0.05, accepts  # the chains moved, so the state was exercised


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_off_update_follows_moves_and_swaps(seed):
    """Step the bookkeeping over random translations, rotations and swaps
    (including moves inside one slab and across slabs) without any
    accept/reject, and hold the cells to a from-scratch computation after
    every step, bit for bit."""
    rng = np.random.default_rng(seed)
    n, chains = 61, 6  # 8 slabs of 8, the last one of 5: the state is kept
    assert TF.off_incremental(1, n, 2)
    spec = mh_tpu_torch.demo_scene(n)
    scene = dataclasses.replace(spec.build(), w_offlimits=torch.tensor(-1.5))
    pk = TF.pack_scene(scene, mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode.FIXED))
    obj = TF._Objective(pk)
    ps = spec.initial_pose().expand(chains, n, 6).permute(2, 0, 1).contiguous()
    ps[:2] += torch.as_tensor(rng.normal(size=(2, chains, n)).astype(np.float32)) * 0.3
    cells = obj.off_cells(ps[0], ps[1])
    for _ in range(40):
        box_moved = torch.zeros(chains, n, dtype=torch.bool)
        star = ps.clone()
        for c in range(chains):
            i, j = rng.choice(n, 2, replace=False)
            kind = rng.integers(3)
            if kind == 0:
                star[:, c, [i, j]] = star[:, c, [j, i]]
                box_moved[c, [i, j]] = True
            elif kind == 1:
                star[0, c, i] += float(rng.normal())
                star[1, c, i] += float(rng.normal())
                box_moved[c, i] = True
            else:  # a rotation moves no box
                star[4, c, i] = float(rng.uniform(-3.0, 3.0))
        cells = TF._off_update(obj, star, box_moved, cells)
        want = obj.off_cells(star[0], star[1])
        np.testing.assert_array_equal(cells.numpy().view(np.int32), want.numpy().view(np.int32))
        ps = star


@pytest.mark.parametrize("n", [8, 32, 37, 100, 200])
def test_slab_order_off_term_matches_unslabbed_and_cost_terms(n):
    """The loop's slab-order off-limits term against the final report's
    unslabbed row sums and mh_tpu's cost_terms, on overlapping layouts."""
    rng = np.random.default_rng(n)
    spec = mh_tpu.demo_scene(n)
    js = dataclasses.replace(spec.build(), w_offlimits=jnp.float32(-1.5))
    ts = to_torch_scene(js)
    pk = TF.pack_scene(ts, mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode.FIXED))
    obj = TF._Objective(pk)
    base = np.array(spec.initial_pose())
    poses = np.repeat(base[None], 4, 0)
    poses[:, :, :2] = rng.uniform(0.0, 10.0, size=(4, n, 2)).astype(np.float32)
    x, y, rot = (torch.as_tensor(poses[:, :, k]) for k in (0, 1, 4))
    slab = obj(x, y, rot, True, cells=obj.off_cells(x, y))[1][5].numpy()
    unslabbed = obj(x, y, rot, True)[1][5].numpy()
    assert (np.abs(unslabbed) > 1.0).all()  # the layouts overlap
    np.testing.assert_allclose(slab, unslabbed, rtol=RTOL, atol=ATOL)
    ref = np.array([float(jax_cost_terms(jnp.asarray(p), js, mh_tpu.CostMode.FIXED)
                          .as_vector()[6]) for p in poses])
    np.testing.assert_allclose(slab, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,width,slabs", [
    (1, 8, 1), (32, 8, 4), (37, 8, 5), (100, 8, 13), (128, 8, 16), (129, 16, 9), (256, 16, 16),
    (512, 32, 16), (1024, 64, 16), (1025, 128, 9), (2300, 256, 9)])
def test_off_slab_width(n, width, slabs):
    """8 objects a slab, doubled to keep at most 16 slabs."""
    assert TF.off_slab_width(n) == width and TF.off_slabs(n) == slabs


@pytest.mark.parametrize("moves,n,incremental", [
    (1, 100, True), (1, 55, True), (1, 54, False), (1, 37, False), (1, 32, False), (6, 100, True),
    (7, 100, False), (4, 32, False), (64, 100, False), (1, 8, False), (1, 2000, False),
    (1, 512, True), (1, 1100, True), (1, 1461, True), (1, 1462, False), (4, 1280, True),
    (4, 1281, False)])
def test_off_incremental_picks_the_cheaper_scheme(moves, n, incremental):
    """A step's moves touch at most 2 M of the S slabs: from 2 M >= S on,
    each object's row is summed from scratch, and so it is where the S N
    cells are at most three a thread (54 objects: 7 x 54) and where the
    state does not fit in a block's shared memory (past 1,461 objects with
    2 clearances and one move, 1,280 with four). The update reads the
    symmetry state's list of moved lanes, so it implies sym_incremental."""
    assert TF.off_incremental(moves, n, 2) is incremental
    if incremental:
        assert TF.sym_incremental(moves, n)
        assert TF.smem_bytes(n, 2, moves, True) <= TF.MAX_SMEM


@pytest.mark.parametrize("n,n_clr", [(32, 2), (100, 2), (256, 2), (512, 2), (100, 5)])
def test_shared_memory_without_the_off_state_is_unchanged(n, n_clr):
    """PARITY and unweighted FIXED keep the layout without the slab state:
    22 words an object, the reduced rows' sums, the strided partials of the
    6 rows before the clearance rows, the move table; so does weighted FIXED
    where it keeps no state (64 moves a step)."""
    for moves in (1, 64):
        want = 4 * (22 * n + 6 + n_clr + 6 * 128 + (6 * 128 if moves > 1 else 0))
        assert TF.smem_bytes(n, n_clr, moves, False) == want
    assert TF.smem_bytes(n, n_clr, 64, True) == want
    assert TF.smem_bytes(100, 2, 1, False) == 11904 and TF.smem_bytes(512, 2, 1, False) == 48160


def test_kernel_takes_weighted_fixed_scenes_up_to_its_limit():
    """Weighted FIXED keeps the slab state up to 1,461 objects (2
    clearances, one move) and past them sums the slab rows from scratch
    with no shared memory, so it takes the scenes PARITY takes: 2,594
    objects with 2 clearances; auto hands larger ones to the CUDA graph."""
    fixed = mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode.FIXED)
    assert TF.kernel_takes(fixed, 2594, 2, True)
    assert not TF.kernel_takes(fixed, 2595, 2, True)
    assert TF.kernel_takes(fixed, 2594, 2, False) and not TF.kernel_takes(fixed, 2595, 2, False)
    assert auto_engine("cuda", fixed, 2594, 2, True) == "fused"
    assert auto_engine("cuda", fixed, 2595, 2, True) == "torch_graph"
    for n in (100, 512, 1024, 1025, 1461, 1462):
        assert TF.kernel_takes(fixed, n, 2, True)
    assert TF.smem_bytes(1461, 2, 1, True) > TF.smem_bytes(1461, 2, 1, False)
    assert TF.smem_bytes(1462, 2, 1, True) == TF.smem_bytes(1462, 2, 1, False)


def test_tracks_off_follows_mode_and_weight():
    scene = mh_tpu_torch.demo_scene(8).build()
    fixed = mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode.FIXED)
    weighted = dataclasses.replace(scene, w_offlimits=torch.tensor(-1.5))
    assert TF.tracks_off(weighted, fixed)
    assert not TF.tracks_off(scene, fixed)
    assert not TF.tracks_off(weighted, mh_tpu_torch.SamplerConfig())


# ---- the repairs ------------------------------------------------------------
@pytest.mark.parametrize("mode,w_off", [("PARITY", 0.0), ("FIXED", -1.5)])
def test_compound_steps_keep_the_jax_kernels_zero_signs(mode, w_off):
    """A start pose holding -0.0 (as chip_smoke.py's neg_zero row builds it)
    through (M, K) = (4, 4) steps: on every chain whose accept count agrees,
    the sign of every zero coordinate equals the JAX kernel's. The
    reference's plane expressions add a signed zero to every lane, so the
    start's -0.0 become +0.0; a kernel that writes only the picked lanes
    keeps them."""
    spec = mh_tpu.demo_scene(32)
    js = dataclasses.replace(spec.build(), w_offlimits=jnp.float32(w_off))
    pose0 = np.array(spec.initial_pose())
    pose0[::2, 2:] = -0.0
    pose0[0, :2] = -0.0
    jout, tout = run_both(js, pose0, mode, 8, 30, seed=3, n_moves_per_step=4, accept_draws=4,
                          beta=1e-3)
    same = assert_chains_agree(jout, tout, 8)
    assert same.sum() >= 6 and (tout[2][same] > 0).all()
    jp, tp = jout[0][same], tout[0][same]
    zero = jp == 0
    np.testing.assert_array_equal(np.signbit(tp[zero]), np.signbit(jp[zero]))
    start_neg = np.signbit(np.broadcast_to(pose0, jp.shape)) & (np.broadcast_to(pose0, jp.shape) == 0)
    assert (start_neg & zero & ~np.signbit(jp)).any()  # the reference turned -0.0 into +0.0


def test_stats_decode_keeps_accept_counts_past_2_24():
    """The kernel stores the accept count's int32 bits in its f32 stats row;
    2^24 + 1, which f32 rounds to 2^24, comes back exact."""
    counts = torch.tensor([(1 << 24) + 1, 0, 7, (1 << 31) - 1], dtype=torch.int32)
    stats = torch.rand(4, TF.N_STATS)
    stats[:, 8] = counts.view(torch.float32)
    breakdown, n_acc, scale = TF.decode_stats(stats)
    assert n_acc.dtype == torch.int32 and torch.equal(n_acc, counts)
    assert torch.equal(breakdown, stats[:, :8]) and torch.equal(scale, stats[:, 9])
    assert float(torch.tensor(float((1 << 24) + 1), dtype=torch.float32)) == 1 << 24


def test_plain_version_counts_accepts_in_int32():
    spec = mh_tpu_torch.demo_scene(8)
    cfg = mh_tpu_torch.SamplerConfig(beta=0.0)
    _, _, n_acc, _ = TF.run_chains_fused(0, spec.initial_pose(), spec.build(), cfg, 4, 30)
    assert n_acc.dtype == torch.int32 and (n_acc == 30).all()


@pytest.mark.parametrize("n,moves,draws", [(64, 1, 1), (72, 4, 4)])
def test_weighted_fixed_matches_jax_incremental_kernel(n, moves, draws):
    """The plain version's slab state, at sizes where the kernel keeps it,
    against mh_tpu's own incremental kernel (Pallas interpreter), whose
    slab sums re-associate differently."""
    assert TF.off_incremental(moves, n, 2)
    spec = mh_tpu.demo_scene(n)
    js = dataclasses.replace(spec.build(), w_offlimits=jnp.float32(-1.5))
    pose0 = np.array(spec.initial_pose())
    jcfg, tcfg = configs("FIXED", n_moves_per_step=moves, accept_draws=draws)
    jout = JF.run_chains_fused(3, jnp.asarray(pose0), js, jcfg, 8, 40, interpret=True,
                               incremental=True)
    pk = TF.pack_scene(to_torch_scene(js), tcfg)
    tout = TF.fused_chains_reference(pk, torch.as_tensor(pose0).expand(8, n, 6).contiguous(),
                                     3, 40, incremental=True)
    same = assert_chains_agree([np.asarray(a) for a in jout], [a.numpy() for a in tout], 8)
    assert same.sum() >= 6 and (tout[2][torch.as_tensor(same)] > 0).any()


# ---- the off-limits path's marker in the launch -----------------------------
def launch_spans(n: int, mode: str, w_off: float) -> list[list[str]]:
    """The ``mh.off_*`` ranges one ``_run`` opens on the CPU, each with the
    names of the ``mh.*`` ranges that enclose it."""
    spec = dataclasses.replace(mh_tpu_torch.demo_scene(n), w_offlimits=w_off)
    cfg = mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode[mode])
    pk = TF.pack_scene(spec.build(), cfg)
    pose0 = spec.initial_pose().expand(2, n, 6)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        TF._run(pk, pose0, 5, 3, 0)
    spans = [e for e in prof.events() if e.name.startswith("mh.")]
    return [[e.name] + [o.name for o in spans if o is not e
                        and o.time_range.start <= e.time_range.start
                        and e.time_range.end <= o.time_range.end]
            for e in spans if e.name.startswith("mh.off_")]


@pytest.mark.parametrize("n,mode,w_off,want", [
    (64, "FIXED", -1.5, "mh.off_state"),  # 8 slabs of 8: the state is kept
    (100, "FIXED", -1.5, "mh.off_state"),
    (8, "FIXED", -1.5, "mh.off_rows"),  # one slab: rows from scratch
    (32, "FIXED", -1.5, "mh.off_rows"),
    (64, "FIXED", 0.0, None),
    (64, "PARITY", -1.5, None),
    (8, "PARITY", 0.0, None)])
def test_launch_names_its_off_limits_path(n, mode, w_off, want):
    """A weighted FIXED launch opens exactly one range of no work inside
    ``mh.launch`` that names its off-limits path: ``mh.off_state`` where
    ``off_incremental`` holds, ``mh.off_rows`` where it does not; PARITY
    and unweighted FIXED open neither."""
    got = launch_spans(n, mode, w_off)
    if want is None:
        assert got == []
    else:
        assert got == [[want, "mh.launch"]]
        assert (want == "mh.off_state") is TF.off_incremental(1, n, len(
            mh_tpu_torch.demo_scene(n).clearances))
