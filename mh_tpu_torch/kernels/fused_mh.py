"""The fused MH chain: one CUDA kernel runs every step of every chain.

Counterpart of ``mh_tpu.kernels.fused_mh`` (the Pallas ``_fused_kernel``).
``run_chains_fused`` packs the scene once and runs ``iterations`` steps of
propose -> score -> Boltzmann accept -> commit per chain, then reports the
weighted breakdown of each final pose:

- on CUDA tensors it launches ``csrc/fused_mh.cu`` (built by ``nvcc`` at
  first use) and raises if the launch fails;
- on CPU tensors it runs :func:`fused_chains_reference`, the plain
  PyTorch version of the same algorithm, batched over chains.

:func:`run_chains_fused_sharded` (``mh_tpu``'s section i) runs it once per
shard of a mesh, each launch keyed by its shard's first global chain.

Both follow the JAX kernel's semantics: the same counter-based random
stream keyed by (seed, global chain, draw counter, lane) in the same draw
layout, the same proposal (one move, or ``n_moves_per_step`` sequential
moves scored once), the same objective formulas (polynomial ``atan2``,
angle-addition focal term, area-minus-overlap outside area) and the same
accept rule (one uniform, or the minimum of ``accept_draws``). The plain
version also reproduces the CUDA kernel's summation order (a per-thread
strided sum over ``THREADS`` lanes, then a halving tree), so on one card
the two agree to the last bit unless the math library differs.

The kernel keeps O(N) symmetry state per chain (each reflection's best
match and the lowest candidate reaching it) and rescans only the rows a
move can change; where a compound step moves so many lanes that this costs
more than the full match (:func:`sym_incremental`), it rescans every row.
A max is exact in any order, so both give the bits of the full recompute,
which the plain version does by default; ``incremental=True`` makes it
keep the same state (the counterpart of the JAX kernel's
``incremental=True``).

FIXED mode with a nonzero off-limits weight sums that term in the loop
slab by slab, as the JAX kernel does (``off_state_init`` / ``off_from_so``,
``fused_mh.py:1208-1355``): cell (s, i) is the overlap of object i with
the later objects of slab s. The kernel keeps the cells and recomputes,
with one function, only the rows of the slabs whose boxes moved and the
columns of the moved objects, or, where that costs more or the cells do
not fit in shared memory (:func:`off_incremental`), sums each object's
slab row from scratch. A recomputed cell has the bits of a from-scratch
one, so the state never drifts and the plain version may recompute every
cell each step. The final report keeps the unslabbed sum.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from mh_tpu_torch.config import CostMode, SamplerConfig
from mh_tpu_torch.kernels import _build
from mh_tpu_torch.kernels.counter_rng import M32, counter_bits
from mh_tpu_torch.models.scene import Scene
from mh_tpu_torch.ops import geometry as geo
from mh_tpu_torch.ops.costs import floor_mod
from mh_tpu_torch.parallel.mesh import chain_shards, concat, local_count

Tensor = torch.Tensor

THREADS = 128  # CUDA block size: one block per chain, lanes strided over threads
DRAW_LANES = 128  # uniforms per (chain, draw counter): flat = chain * 128 + lane
PROPOSAL_LANES = 8  # uniforms one move consumes
MAX_ACCEPT_DRAWS = DRAW_LANES - PROPOSAL_LANES  # 120 (mh_tpu/kernels/fused_mh.py:2356)
N_MOVE_ROWS = 6  # compound step: dx, dy, drot, kind, i1, i2 per move, THREADS moves
N_STATS = 10  # breakdown[8], n_accept, step_scale
SMEM_WORDS_PER_OBJECT = 22  # csrc/fused_mh.cu: pose 6 + star 6 + 10 per-object arrays
MAX_SMEM = 232448 - 1024  # sm_90 per-block shared memory, less the static part
OFF_MAX_SLABS = 16  # slabs of the FIXED off-limits state

_NEG_HUGE = -1e30

# per-object planes (f32[N_PLANES, N])
P_MASK, P_OK, P_RANK, P_AREA = 0, 1, 2, 3
P_OV0X, P_OTAILX, P_OMINX, P_OMINY, P_OMAXX, P_OMAXY = 4, 5, 6, 7, 8, 9
N_PLANES = 10

# scalar slots (f32[N_SCALARS]); csrc/fused_mh.cu keeps the same numbering
(S_WPW, S_WVB, S_WFP, S_WSY, S_WCL, S_WOL, S_WSA,
 S_CX2, S_CY2, S_FX, S_FY, S_FROT, S_UX, S_UY,
 S_MNX, S_MNY, S_MXX, S_MXY,
 S_SIGX, S_SIGY, S_SIGT, S_BETA, S_NOBJ, S_NUNF,
 S_ADAPTR, S_TARGET, S_PI, S_DENOM) = range(28)
N_SCALARS = 32


@dataclasses.dataclass(frozen=True)
class PackedScene:
    """A Scene packed for the fused kernel (done once per call, on its device)."""

    planes: Tensor  # f32[N_PLANES, N]
    unf_idx: Tensor  # i32[max(n_unf, 1)] — lane of the r-th movable object
    scalars: Tensor  # f32[N_SCALARS]
    rel_idx: Tensor  # i32[R, 2] (src, tgt)
    rel_p: Tensor  # f32[R, 3] (lo, hi, mask)
    ang_idx: Tensor  # i32[A, 2] (src, tgt)
    ang_p: Tensor  # f32[A, 3] (amin, amax, mask)
    clr_idx: Tensor  # i32[Cr, 2] (src, surface-area anchor) — real clearances
    clr_p: Tensor  # f32[Cr, 6] (v0x, tailx, minx, miny, maxx, maxy)
    parity: bool
    track_off: bool  # FIXED with a nonzero off-limits weight: off enters the loop
    adapt: bool
    moves: int  # moves per step; > 1 is a compound block proposal
    accept_draws: int  # K: accept iff the minimum of K uniforms < ratio

    @property
    def n(self) -> int:
        return self.planes.shape[1]

    @property
    def n_clr(self) -> int:
        return self.clr_idx.shape[0]


def step_layout(accept_draws: int) -> tuple[int, int]:
    """``(lanes, unroll)`` of a single-move step (``fused_mh.py:1868-1875``).

    A step reads ``lanes`` uniforms: the 8 of its move, then its K accept
    draws when K > 1. One draw counter serves ``unroll`` steps: step t
    reads lanes ``lanes * (t % unroll) + [0, lanes)`` of counter
    ``t // unroll``.
    """
    lanes = PROPOSAL_LANES if accept_draws == 1 else PROPOSAL_LANES + accept_draws
    return lanes, min(4, max(1, DRAW_LANES // lanes))


def tracks_off(scene: Scene, cfg: SamplerConfig) -> bool:
    """Whether the off-limits term enters the loop's totals: FIXED mode with
    a nonzero weight (PARITY scores it only in the final report)."""
    return cfg.mode is not CostMode.PARITY and float(scene.w_offlimits) != 0.0


def off_slab_width(n: int) -> int:
    """Objects per slab of the FIXED off-limits state at ``n`` objects: 8,
    doubled until at most ``OFF_MAX_SLABS`` slabs cover them (the cells then
    take at most 16 words per object of shared memory). The summation order
    follows the width, so it depends on ``n`` alone."""
    w = 8
    while w * OFF_MAX_SLABS < n:
        w *= 2
    return w


def off_slabs(n: int) -> int:
    return -(-n // off_slab_width(n))


def pack_scene(scene: Scene, cfg: SamplerConfig) -> PackedScene:
    """Pack a Scene into the kernel's inputs on the scene's device.

    Keeps the JAX packing's scalars (``mh_tpu/kernels/fused_mh.py:226-252``),
    its cumulative rank of movable objects (``:217``) and the PARITY
    clearance anchor ``min(i, N-1)`` (``:275``); entity gathers become index
    arrays. Raises for ``accept_draws`` outside ``[1, 120]`` (``:2356``):
    one draw counter holds 8 proposal lanes and at most 120 accept lanes.
    """
    if not 1 <= cfg.accept_draws <= MAX_ACCEPT_DRAWS:
        raise ValueError(f"fused kernel supports accept_draws in [1, {MAX_ACCEPT_DRAWS}], "
                         f"got {cfg.accept_draws}")
    dev = scene.device
    n0 = scene.n_pad_objs

    def npf(t):
        return t.detach().cpu().numpy().astype(np.float32)

    def npi(t):
        return t.detach().cpu().numpy().astype(np.int32)

    mask = npf(scene.obj_mask)
    ok = mask * (np.float32(1.0) - npf(scene.frozen))
    sizes = npf(scene.sizes)
    planes = np.zeros((N_PLANES, n0), np.float32)
    planes[P_MASK] = mask
    planes[P_OK] = ok
    planes[P_RANK] = np.cumsum(ok, dtype=np.float32)
    planes[P_AREA] = sizes[:, 0] * sizes[:, 1]
    for p, name in ((P_OV0X, "v0x"), (P_OTAILX, "tail_min_x"), (P_OMINX, "min_x"),
                    (P_OMINY, "min_y"), (P_OMAXX, "max_x"), (P_OMAXY, "max_y")):
        planes[p] = npf(getattr(scene.off_rects, name))
    unf = np.flatnonzero(ok > 0).astype(np.int32)

    mnx, mny, mxx, mxy = (float(v) for v in scene.surface_bounds())
    sigx = (mxx - mnx) / 16.0
    sigy = (mxy - mny) / 16.0
    if cfg.sigma_xy_override > 0:
        sigx = sigy = cfg.sigma_xy_override
    frot = np.float32(float(scene.focal_rot))
    denom = _block_sum(torch.as_tensor(planes[P_AREA] * mask)[None])[0].item()
    s = np.zeros(N_SCALARS, np.float32)
    s[S_WPW] = float(scene.w_pairwise)
    s[S_WVB] = float(scene.w_visual_balance)
    s[S_WFP] = float(scene.w_focal)
    s[S_WSY] = float(scene.w_symmetry)
    s[S_WCL] = float(scene.w_clearance)
    s[S_WOL] = float(scene.w_offlimits)
    s[S_WSA] = float(scene.w_surface_area)
    s[S_CX2] = float(scene.centroid[0]) / 2.0
    s[S_CY2] = float(scene.centroid[1]) / 2.0
    s[S_FX] = float(scene.focal[0])
    s[S_FY] = float(scene.focal[1])
    s[S_FROT] = frot
    s[S_UX] = np.cos(frot)
    s[S_UY] = np.sin(frot)
    s[S_MNX], s[S_MNY], s[S_MXX], s[S_MXY] = mnx, mny, mxx, mxy
    s[S_SIGX], s[S_SIGY], s[S_SIGT] = sigx, sigy, cfg.sigma_t
    s[S_BETA] = cfg.beta
    s[S_NOBJ] = float(np.sum(mask > 0))
    s[S_NUNF] = float(np.sum(ok))
    s[S_ADAPTR] = cfg.adapt_rate
    s[S_TARGET] = cfg.target_accept
    s[S_PI] = cfg.mode.pi
    s[S_DENOM] = denom if denom > 0 else 1.0

    parity = cfg.mode is CostMode.PARITY
    clr_real = np.flatnonzero(npf(scene.clr_mask) > 0)
    clr_src = npi(scene.clr_src)[clr_real]
    # Kernel.cu:456 quirk: PARITY surface area anchors clearance i to object i
    anchor = np.minimum(clr_real, n0 - 1).astype(np.int32) if parity else clr_src
    clr_p = np.stack(
        [npf(getattr(scene.clr_rects, f))[clr_real]
         for f in ("v0x", "tail_min_x", "min_x", "min_y", "max_x", "max_y")],
        axis=1,
    ).reshape(-1, 6)

    rel_idx = np.stack([npi(scene.rel_src), npi(scene.rel_tgt)], 1)
    ang_idx = np.stack([npi(scene.ang_src), npi(scene.ang_tgt)], 1)
    clr_idx = np.stack([clr_src, anchor], 1).reshape(-1, 2)
    # the kernel loads pose lanes at these indices unchecked
    for name, idx in (("relationship", rel_idx), ("angle", ang_idx), ("clearance", clr_idx)):
        if idx.size and (idx.min() < 0 or idx.max() >= n0):
            raise ValueError(f"{name} object index out of range [0, {n0}): {idx.tolist()}")

    def ti(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)

    def tf(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)

    return PackedScene(
        planes=tf(planes),
        unf_idx=ti(unf if unf.size else np.zeros(1, np.int32)),
        scalars=tf(s),
        rel_idx=ti(rel_idx),
        rel_p=tf(np.stack([npf(scene.rel_lo), npf(scene.rel_hi), npf(scene.rel_mask)], 1)),
        ang_idx=ti(ang_idx),
        ang_p=tf(np.stack([npf(scene.ang_min), npf(scene.ang_max), npf(scene.ang_mask)], 1)),
        clr_idx=ti(clr_idx),
        clr_p=tf(clr_p),
        parity=parity,
        track_off=tracks_off(scene, cfg),
        adapt=cfg.adapt,
        moves=cfg.n_moves_per_step,
        accept_draws=cfg.accept_draws,
    )


# ---------------------------------------------------------------------------
# counter-based random stream (mh_tpu/kernels/fused_mh.py:357-402, :1403-1408)
# ---------------------------------------------------------------------------
def uniform_block(seed: int, counter: int, first_chain: int, n_chains: int,
                  device=None) -> Tensor:
    """f32[n_chains, DRAW_LANES] uniforms in (0, 1) for one draw counter.

    Bit-equal to ``_uniform_sw`` for every (seed, global chain, counter,
    lane): ``u = (mix(mix(flat ^ base)) >>> 9) * 2^-23 + 1e-7`` with
    ``base = seed * 0x9E3779B9 ^ counter * 0x85EBCA6B`` (uint32).
    """
    chains = torch.arange(n_chains, dtype=torch.int64, device=device) + first_chain
    lanes = torch.arange(DRAW_LANES, dtype=torch.int64, device=device)
    bits = counter_bits(seed, counter, chains[:, None] * DRAW_LANES + lanes)
    return bits.to(torch.float32) * (1.0 / (1 << 23)) + 1e-7


# ---------------------------------------------------------------------------
# the plain PyTorch version of the kernel
# ---------------------------------------------------------------------------
def _block_sum(v: Tensor) -> Tensor:
    """Sum over the last dim of ``[C, N]`` in the CUDA kernel's order.

    Thread t accumulates lanes t, t+THREADS, ... from 0; the THREADS
    partials then fold by halving (t += t + s for s = THREADS/2 .. 1).
    """
    c, n = v.shape
    k = -(-n // THREADS)
    v = F.pad(v, (0, k * THREADS - n))
    acc = torch.zeros(c, THREADS, dtype=v.dtype, device=v.device)
    for i in range(k):
        acc = acc + v[:, i * THREADS:(i + 1) * THREADS]
    s = THREADS // 2
    while s:
        acc = acc[:, :s] + acc[:, s:2 * s]
        s //= 2
    return acc[:, 0]


def atan2_poly(y: Tensor, x: Tensor) -> Tensor:
    """The JAX kernel's branchless f32 atan2 (``fused_mh.py:319``): minimax
    polynomial on [0, 1] plus quadrant folding, max error ~1e-6 rad."""
    ax = torch.abs(x)
    ay = torch.abs(y)
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    a = mn / torch.clamp_min(mx, 1e-30)
    s = a * a
    p = -0.0117212 * s + 0.05265332
    p = p * s + -0.11643287
    p = p * s + 0.19354346
    p = p * s + -0.33262347
    p = p * s + 0.99997726
    r = a * p
    r = torch.where(ay > ax, (math.pi / 2) - r, r)
    r = torch.where(x < 0, math.pi - r, r)
    return torch.where(y < 0, -r, r)


def _inter_area(amnx, amny, amxx, amxy, bmnx, bmny, bmxx, bmxy):
    x5 = torch.maximum(amnx, bmnx)
    y5 = torch.maximum(amny, bmny)
    x6 = torch.minimum(amxx, bmxx)
    y6 = torch.minimum(amxy, bmxy)
    return torch.where((x5 >= x6) | (y5 >= y6), 0.0, (x6 - x5) * (y6 - y5))


class _Objective:
    """``costs_of`` (``fused_mh.py:675-1067``) for pose planes ``[C, N]``."""

    def __init__(self, pk: PackedScene):
        self.pk = pk
        sc = pk.scalars  # 0-d device tensors below, never CPU scalars
        self.sc = [sc[i] for i in range(N_SCALARS)]
        pl = pk.planes
        self.mask = pl[P_MASK]
        self.area = pl[P_AREA]
        self.pi = float(sc[S_PI])
        self.rel = [(int(s), int(t)) for s, t in pk.rel_idx.tolist()]
        self.ang = [(int(s), int(t)) for s, t in pk.ang_idx.tolist()]
        self.clr = [(int(s), int(a)) for s, a in pk.clr_idx.tolist()]

    def aabb_minx(self, v0x, tailx, minx, tx):
        if self.pk.parity:
            return torch.minimum(v0x, tailx + tx)
        return minx + tx

    def outside_area(self, mnx, mny, mxx, mxy):
        sc = self.sc
        ov = _inter_area(mnx, mny, mxx, mxy, sc[S_MNX], sc[S_MNY], sc[S_MXX], sc[S_MXY])
        return torch.clamp_min((mxx - mnx) * (mxy - mny) - ov, 0.0)

    def theta(self, xi, yi, xj, yj, ti):
        pi = self.pi
        t = atan2_poly(yi - yj, xi - xj)
        t = torch.where(t < 0, 2 * pi + t, t)
        t = t - ti
        return torch.where(t < 0, 2 * pi + t, t)

    def reflections(self, x, y, rot):
        sc, pi = self.sc, self.pi
        ux, uy = sc[S_UX], sc[S_UY]
        s = 2.0 * (sc[S_FX] * ux + sc[S_FY] * uy - (x * ux + y * uy))
        rrot = 2.0 * sc[S_FROT] - rot
        return x + s * ux, y + s * uy, torch.where(rrot < -pi, rrot + 2 * pi, rrot)

    def sym_val(self, cx, cy, cr, rx, ry, rr):
        pi = self.pi
        dp = torch.sqrt(torch.square(cx - rx) + torch.square(cy - ry))
        dt = cr - rr
        dt = torch.where(dt > pi, dt - 2 * pi, dt)
        return 5.0 - torch.sqrt(dp) - 0.4 * torch.abs(dt)

    def sym_rows(self, x, y, rot):
        """``(best, arg)`` [C, N] of the symmetry match (Kernel.cu:283-318):
        reflection i's best value over the unmasked candidates j and the
        lowest j that reaches it (-1 and -1e30 where there is none)."""
        rx, ry, rrot = self.reflections(x, y, rot)
        val = self.sym_val(x[:, None, :], y[:, None, :], rot[:, None, :],
                           rx[:, :, None], ry[:, :, None], rrot[:, :, None])
        val = torch.where(self.mask > 0, val, _NEG_HUGE)
        best = torch.amax(val, 2)
        arg = torch.where((self.mask > 0).any(), torch.argmax(val, 2), -1)
        return best, arg, val

    def boxes(self, x, y):
        """Every object's off-limits AABB at (x, y): (minx, miny, maxx, maxy)."""
        pl = self.pk.planes
        return (self.aabb_minx(pl[P_OV0X], pl[P_OTAILX], pl[P_OMINX], x), pl[P_OMINY] + y,
                pl[P_OMAXX] + x, pl[P_OMAXY] + y)

    def off_overlaps(self, x, y):
        """[C, i, j] overlap of object i with a later object j, times mask_j
        (Kernel.cu:485-514); 0 where j <= i."""
        omnx, omny, omxx, omxy = self.boxes(x, y)
        ar = _inter_area(omnx[:, :, None], omny[:, :, None], omxx[:, :, None], omxy[:, :, None],
                         omnx[:, None, :], omny[:, None, :], omxx[:, None, :], omxy[:, None, :])
        n = x.shape[1]
        return ar * torch.triu(torch.ones(n, n, device=x.device), 1) * self.mask

    def off_cells(self, x, y) -> Tensor:
        """[C, S, N] cells of the FIXED off-limits slab state (``off_cell_at``
        in csrc/fused_mh.cu; ``off_slab_row``, fused_mh.py:1217): cell (s, i)
        sums object i's overlaps with the objects j > i of slab s, in
        ascending j from 0."""
        c, n = x.shape
        w = off_slab_width(n)
        s = -(-n // w)
        contrib = F.pad(self.off_overlaps(x, y), (0, s * w - n)).reshape(c, n, s, w)
        cells = torch.zeros(c, n, s, dtype=x.dtype, device=x.device)
        for k in range(w):
            cells = cells + contrib[..., k]
        return cells.transpose(1, 2)

    def __call__(self, x, y, rot, with_off: bool, best=None, cells=None):
        """(total[C], terms) with terms = (pair, vb, fp, sym, clr, off, sa),
        each weighted, in the stats-lane order after ``total``. ``best``
        [C, N], where given, is each reflection's best symmetry match (the
        incremental state); else the full match is computed. ``cells``
        [C, S, N], where given, is the off-limits slab state of the loop
        (each object's row sums its cells over s ascending); else, with
        ``with_off``, the final report's unslabbed j > i row sums."""
        sc, pk, pi, mask = self.sc, self.pk, self.pi, self.mask
        zero = torch.zeros_like(x[:, 0])

        # pairwise distance + angle (Kernel.cu:210-263), sequential entity sums
        pw = zero
        for r, (s, t) in enumerate(self.rel):
            lo, hi, rm = pk.rel_p[r, 0], pk.rel_p[r, 1], pk.rel_p[r, 2]
            d = torch.sqrt(torch.square(x[:, s] - x[:, t]) + torch.square(y[:, s] - y[:, t]))
            lo_safe = torch.where(lo > 0, lo, 1.0)
            d_safe = torch.where(d > 0, d, 1.0)
            pen = torch.where(
                d < lo, -torch.square(d / lo_safe),
                torch.where(d > hi, -torch.square(hi / d_safe), 0.0),
            )
            pw = pw + pen * rm
        pwa = zero
        for a, (s, t) in enumerate(self.ang):
            amin, amax, am = pk.ang_p[a, 0], pk.ang_p[a, 1], pk.ang_p[a, 2]
            th = self.theta(x[:, s], y[:, s], x[:, t], y[:, t], rot[:, t])
            dev = torch.minimum(torch.abs(th - amin), torch.abs(th - amax))
            wrap_case = amin > amax
            norm_wrap = torch.where(wrap_case, (amin - amax) / 2.0, 1.0)
            cond_wrap = floor_mod(amin + th, 2 * pi) > amax
            npl_raw = (2 * pi - (amax - amin)) / 2.0
            npl = torch.where(npl_raw != 0, npl_raw, 1.0)
            if pk.parity:
                cond_plain = (amin < th) | (th < amax)
            else:
                cond_plain = (th < amin) | (th > amax)
            apen = torch.where(
                wrap_case,
                torch.where(cond_wrap, -dev / norm_wrap, 0.0),
                torch.where(cond_plain, -dev / npl, 0.0),
            )
            pwa = pwa + apen * am
        pair = pw * pwa if pk.parity else pw + pwa

        # visual balance (Kernel.cu:191-207)
        nx = _block_sum(self.area * (x * mask)) / sc[S_DENOM]
        ny = _block_sum(self.area * (y * mask)) / sc[S_DENOM]
        vb = -torch.sqrt(torch.square(nx - sc[S_CX2]) + torch.square(ny - sc[S_CY2]))

        # focal point by angle addition: cos(atan2(dy,dx) - rot + pi/2)
        # == (dx sin(rot) - dy cos(rot)) / r; r == 0 gives sin(rot)
        dxf = sc[S_FX] - x
        dyf = sc[S_FY] - y
        rf = torch.sqrt(torch.square(dxf) + torch.square(dyf))
        srot = torch.sin(rot)
        cph = (dxf * srot - dyf * torch.cos(rot)) / torch.where(rf > 0, rf, 1.0)
        cph = torch.where(rf > 0, cph, srot)
        fp = _block_sum(-cph * mask)

        # off-limits AABBs, shared by the off-limits/clearance/surface terms
        omnx, omny, omxx, omxy = self.boxes(x, y)

        # symmetry (Kernel.cu:283-318): [C, i, j] reflection i vs candidate j
        if best is None:
            best = self.sym_rows(x, y, rot)[0]
        sym = -_block_sum(torch.clamp_min(best, 0.0) * mask)

        # off-limits i < j overlap: the loop's rows sum the slab cells over
        # s; the final report's rows run j = 0..N-1
        off = zero
        if with_off:
            row = torch.zeros_like(x)
            if cells is None:
                contrib = self.off_overlaps(x, y)
                for j in range(x.shape[1]):
                    row = row + contrib[:, :, j]
            else:
                for s in range(cells.shape[1]):
                    row = row + cells[:, s]
            off = -_block_sum(row * mask)

        # clearances (Kernel.cu:404-434) and their surface areas (:437-467)
        clr = zero
        sa_acc = zero
        for c, (s, a) in enumerate(self.clr):
            v0x, tlx, mnx_, mny_, mxx_, mxy_ = (pk.clr_p[c, k] for k in range(6))
            cax, cay = x[:, s:s + 1], y[:, s:s + 1]
            ar = _inter_area(self.aabb_minx(v0x, tlx, mnx_, cax), mny_ + cay,
                             mxx_ + cax, mxy_ + cay, omnx, omny, omxx, omxy)
            clr = clr - _block_sum(ar * mask)
            pax, pay = x[:, a], y[:, a]
            sa_acc = sa_acc + self.outside_area(
                self.aabb_minx(v0x, tlx, mnx_, pax), mny_ + pay, mxx_ + pax, mxy_ + pay)
        sa = -sa_acc + (-_block_sum(self.outside_area(omnx, omny, omxx, omxy) * mask))

        # aggregate (Kernel.cu:516-550); sym after the others, off last
        pair_w = sc[S_WPW] * pair
        vb_w = sc[S_WVB] * vb
        fp_w = sc[S_WFP] * fp
        sym_w = sc[S_WSY] * sym
        clr_w = sc[S_WCL] * clr
        sa_w = sc[S_WSA] * sa
        total = pair_w + vb_w + fp_w + clr_w + sa_w
        total = total + sym_w
        off_w = sc[S_WOL] * off if with_off else zero
        if with_off and not pk.parity:
            total = total + off_w
        return total, (pair_w, vb_w, fp_w, sym_w, clr_w, off_w, sa_w)


def _moved_lanes(is_t, is_r, is_s, sel1, sel2) -> Tensor:
    """The lanes one move writes (``apply_move`` in csrc/fused_mh.cu): the
    first pick of a translate or rotate, both picks of a swap of two."""
    return (((is_t + is_r) > 0) & (sel1 > 0)) | ((is_s > 0) & (sel1 != sel2))


def _sym_update(objective, star, moved, best_c, arg_c):
    """The kernel's symmetry bookkeeping for one step, ``(best, arg)`` at
    the star pose: rows of moved reflections, and rows whose argbest moved,
    are rescanned; every other row keeps its best over the unmoved
    candidates and meets the moved ones. Ties go to the lower index."""
    best_f, arg_f, val = objective.sym_rows(star[0], star[1], star[4])
    n = moved.shape[1]
    rescan = moved | (torch.gather(moved, 1, arg_c.clamp_min(0)) & (arg_c >= 0))
    cand = moved[:, None, :] & (objective.mask > 0)
    vm = torch.where(cand, val, -math.inf)
    bm = torch.amax(vm, 2)
    am = torch.argmax(vm, 2)
    key = torch.where(arg_c < 0, n, arg_c)
    upd = (bm > best_c) | ((bm == best_c) & (am < key))
    best = torch.where(rescan, best_f, torch.where(upd, bm, best_c))
    arg = torch.where(rescan, arg_f, torch.where(upd, am, arg_c))
    return best, arg


def _off_update(objective, star, box_moved, cells_c):
    """The kernel's off-limits bookkeeping for one step: the star cells.
    The slabs of the lanes whose box moved (a rotation moves none) are
    touched: their rows are recomputed for every object, and the columns of
    those lanes for every slab; every other cell keeps the current one.
    Past :func:`off_incremental` every cell is recomputed."""
    full = objective.off_cells(star[0], star[1])
    c, s, n = full.shape
    w = off_slab_width(n)
    if not off_incremental(objective.pk.moves, n, objective.pk.n_clr):
        return full
    touched = F.pad(box_moved, (0, s * w - n)).reshape(c, s, w).any(2)  # [C, S]
    stale = touched[:, :, None] | box_moved[:, None, :]
    return torch.where(stale, full, cells_c)


def fused_chains_reference(
    pk: PackedScene, pose0: Tensor, seed: int, iterations: int, first_chain: int = 0,
    incremental: bool = False,
):
    """The plain PyTorch version of the fused kernel, batched over chains.

    ``pose0`` is f32[C, N, 6]. Returns ``(pose f32[C, N, 6], breakdown
    f32[C, 8], n_accept i32[C], step_scale f32[C])``. A Python loop runs
    the steps in the JAX kernel's draw layout:

    - one move per step: step t reads the lanes :func:`step_layout` gives
      (``fused_mh.py:1899-1922``); its accept uniform is lane 1, or with
      K > 1 the minimum of lanes 8 .. 8+K-1 of its slice (``:1660-1667``);
    - a compound step of M > 1 moves (``iter_body_multi``, ``:1444-1575``):
      the accept draw comes from counter ``t (M+1)`` (lane 1, or the minimum
      of lanes 1 .. K), move m from lanes 0-7 of counter ``t (M+1) + 1 + m``.
      The step scale is taken once per step, the moves apply in order as
      plane expressions, and the result is scored and accepted once.

    ``incremental=True`` carries the kernel's symmetry state (each
    reflection's best match and argbest, :func:`_sym_update`) and, in
    FIXED mode with an off-limits weight, its off-limits slab cells
    (:func:`_off_update`) from step to step instead of taking the full
    match and every cell from scratch; the bits are the same. The default,
    as the main path calls it, recomputes both.
    """
    fused_chains_reference.calls += 1
    sc = [pk.scalars[i] for i in range(N_SCALARS)]
    pi = float(sc[S_PI])
    two_pi = 2.0 * math.pi
    n_chains = pose0.shape[0]
    objective = _Objective(pk)
    ps = pose0.permute(2, 0, 1).contiguous()  # [6, C, N] pose planes
    ok = pk.planes[P_OK]
    rank = pk.planes[P_RANK]
    n_unf, n_objs = sc[S_NUNF], sc[S_NOBJ]
    gate = torch.where(n_unf > 0.0, 1.0, 0.0)
    n_unf_m1 = torch.clamp_min(n_unf - 1.0, 0.0)
    n_moves, n_draws = pk.moves, pk.accept_draws

    def uniforms(counter):
        return uniform_block(seed, counter, first_chain, n_chains, pose0.device)

    def move_of(us, scale):
        """The move 8 uniforms drive (fused_mh.py:1478-1491, :1657-1693)."""
        move = torch.clamp_max((us[:, 0] * 3.0).to(torch.int32), 2)
        r1 = torch.sqrt(-2.0 * torch.log(us[:, 2]))
        r2 = torch.sqrt(-2.0 * torch.log(us[:, 4]))
        dx = (r1 * torch.cos(two_pi * us[:, 3]) * sc[S_SIGX] * scale)[:, None]
        dy = (r1 * torch.sin(two_pi * us[:, 3]) * sc[S_SIGY] * scale)[:, None]
        drot = (r2 * torch.cos(two_pi * us[:, 5]) * sc[S_SIGT] * scale)[:, None]
        k1 = torch.minimum(torch.floor(us[:, 6] * n_unf), n_unf_m1) + 1.0
        k2 = torch.minimum(torch.floor(us[:, 7] * n_unf), n_unf_m1) + 1.0
        is_t = (move == 0).float()[:, None]
        is_r = (move == 1).float()[:, None]
        is_s = ((move == 2) & (n_objs >= 2)).float()[:, None]
        sel1 = ((rank == k1[:, None]) & (ok > 0)).float()
        sel2 = ((rank == k2[:, None]) & (ok > 0)).float()
        return dx, dy, drot, is_t, is_r, is_s, sel1, sel2

    def single_move(ps, dx, dy, drot, is_t, is_r, is_s, sel1, sel2):
        """The star pose of one move (fused_mh.py:1695-1723)."""
        x, y, rot = ps[0], ps[1], ps[4]
        w_t = is_t * sel1
        tdx = w_t * (torch.clamp(x + dx, sc[S_MNX], sc[S_MXX]) - x)
        tdy = w_t * (torch.clamp(y + dy, sc[S_MNY], sc[S_MXY]) - y)
        tdr = (is_r * sel1) * (geo.wrap_angle_once(rot + drot, pi) - rot)
        sw = is_s * gate
        dsel = sel1 - sel2
        r1v = torch.sum(sel1 * ps, 2, keepdim=True)  # [6, C, 1] exact one-hot picks
        r2v = torch.sum(sel2 * ps, 2, keepdim=True)
        zero_d = torch.zeros_like(x)
        tdelta = torch.stack([tdx, tdy, zero_d, zero_d, tdr, zero_d])
        return ps + gate * (tdelta + (sw * dsel) * (r2v - r1v))

    def compound_move(st, dx, dy, drot, is_t, is_r, is_s, sel1, sel2):
        """One move of a compound step on the star planes (fused_mh.py:1493-1512)."""
        xc, yc, rc = st[0], st[1], st[4]
        w_t = is_t * sel1 * gate
        x_n = xc + w_t * (torch.clamp(xc + dx, sc[S_MNX], sc[S_MXX]) - xc)
        y_n = yc + w_t * (torch.clamp(yc + dy, sc[S_MNY], sc[S_MXY]) - yc)
        rot_n = rc + (is_r * sel1 * gate) * (geo.wrap_angle_once(rc + drot, pi) - rc)
        st = torch.stack([x_n, y_n, st[2], st[3], rot_n, st[5]])
        # a swap moves all six planes; on the other moves sw == 0
        sw = is_s * gate
        r1v = torch.sum(sel1 * st, 2, keepdim=True)
        r2v = torch.sum(sel2 * st, 2, keepdim=True)
        return st + (sw * (sel1 - sel2)) * (r2v - r1v)

    cells_c = objective.off_cells(ps[0], ps[1]) if pk.track_off else None
    cur, _ = objective(ps[0], ps[1], ps[4], pk.track_off, cells=cells_c)
    if incremental:
        best_c, arg_c, _ = objective.sym_rows(ps[0], ps[1], ps[4])
    n_acc = torch.zeros(n_chains, dtype=torch.int32, device=cur.device)
    log_scale = torch.zeros_like(cur)
    lanes, unroll = step_layout(n_draws)
    us_blk = None
    for t in range(iterations):
        scale = torch.exp(log_scale) if pk.adapt else 1.0
        if n_moves == 1:
            if t % unroll == 0:
                us_blk = uniforms(t // unroll)
            us = us_blk[:, lanes * (t % unroll):lanes * (t % unroll + 1)]
            u_acc = us[:, 1] if n_draws == 1 else torch.amin(us[:, PROPOSAL_LANES:], 1)
            mv = move_of(us, scale)
            star = single_move(ps, *mv)
            moved = _moved_lanes(*mv[3:])
            box_moved = _moved_lanes(mv[3], 0.0, *mv[5:])
        else:
            c0 = t * (n_moves + 1)
            us0 = uniforms(c0)
            u_acc = us0[:, 1] if n_draws == 1 else torch.amin(us0[:, 1:1 + n_draws], 1)
            star = ps
            moved = torch.zeros_like(ps[0], dtype=torch.bool)
            box_moved = moved
            for m in range(n_moves):
                mv = move_of(uniforms(c0 + 1 + m), scale)
                star = compound_move(star, *mv)
                moved = moved | _moved_lanes(*mv[3:])
                box_moved = box_moved | _moved_lanes(mv[3], 0.0, *mv[5:])

        best_s = cells_s = None
        if incremental:
            best_s, arg_s = _sym_update(objective, star, moved, best_c, arg_c)
            if pk.track_off:
                cells_s = _off_update(objective, star, box_moved, cells_c)
        elif pk.track_off:
            cells_s = objective.off_cells(star[0], star[1])
        total_star, _ = objective(star[0], star[1], star[4], pk.track_off, best_s, cells_s)
        ratio = torch.exp(torch.clamp_max(sc[S_BETA] * (total_star - cur), 0.0))
        acc_b = (u_acc < ratio) & (gate > 0)
        acc = acc_b.float()
        ps = torch.where(acc_b[:, None], star, ps)
        cur = torch.where(acc_b, total_star, cur)
        n_acc = n_acc + acc_b.to(torch.int32)
        if incremental:
            best_c = torch.where(acc_b[:, None], best_s, best_c)
            arg_c = torch.where(acc_b[:, None], arg_s, arg_c)
            if pk.track_off:
                cells_c = torch.where(acc_b[:, None, None], cells_s, cells_c)
        if pk.adapt:
            log_scale = log_scale + sc[S_ADAPTR] * (acc - sc[S_TARGET])

    total, terms = objective(ps[0], ps[1], ps[4], True)
    breakdown = torch.stack([total, *terms], 1)
    return ps.permute(1, 2, 0).contiguous(), breakdown, n_acc, torch.exp(log_scale)


fused_chains_reference.calls = 0


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------
def smem_bytes(n: int, n_clr: int, moves: int, track_off: bool) -> int:
    """Dynamic shared memory of one block, as csrc/fused_mh.cu lays it out:
    22 words per object (the current and star pose planes, the mask, the
    cached focal term and the symmetry state, current and star, the
    moved-lane and rescan lists), the 6 + clearances reduced rows' sums and
    THREADS strided partials each, a compound step's move table and, with
    ``track_off`` (:func:`tracks_off`) where the kernel keeps the off-limits
    state (:func:`off_incremental`), the state's words. Without the state
    the rows are summed from scratch and take no shared memory."""
    off = _off_state_words(n, moves) if track_off and off_incremental(moves, n, n_clr) else 0
    return 4 * (_base_words(n, n_clr, moves) + off)


def _base_words(n: int, n_clr: int, moves: int) -> int:
    return (SMEM_WORDS_PER_OBJECT * n + (6 + n_clr) * (1 + THREADS)
            + (N_MOVE_ROWS * THREADS if moves > 1 else 0))


def _off_state_words(n: int, moves: int) -> int:
    """The off-limits state: its cells (S x N), the star slots of a step's
    moves (2 M rows of N cells, 2 M columns of S cells with their targets),
    the row sums (current and star), each slab's and lane's slot and the
    slot lists."""
    s = off_slabs(n)
    return s * n + 2 * moves * (n + 2 * s + 4) + 3 * n + s


def sym_incremental(moves: int, n: int) -> bool:
    """Whether the kernel keeps its symmetry state for steps of ``moves``
    moves at ``n`` objects. The state costs ~4 N sym_val evaluations per
    moved lane pair (each moved candidate against every reflection, and
    the rows it rescans), so past 4 M >= N a full N^2 rescan is cheaper;
    both give the same bits."""
    return 4 * moves < n


def off_incremental(moves: int, n: int, n_clr: int) -> bool:
    """Whether the kernel keeps its off-limits slab state for steps of
    ``moves`` moves at ``n`` objects and ``n_clr`` clearances and updates
    the cells the moves change, or has each thread sum its objects' slab
    rows from scratch. A step touches at most 2 ``moves`` slabs, each a row
    of N cells, plus the moved columns and their rows' sums, so from 2 M >=
    S slabs on the rows from scratch cost less; so they do where the S N
    cells are no more than 3 THREADS, up to 54 objects (``chip_smoke.py
    --phases kernel_variants`` times both). Past the shared memory a block
    may take (1,455 objects with 2 clearances, one move) the rows are
    summed from scratch too. Both give the same bits. It implies
    :func:`sym_incremental`, whose moved-lane list the update reads."""
    s = off_slabs(n)
    return (2 * moves < s and s * n > 3 * THREADS
            and 4 * (_base_words(n, n_clr, moves) + _off_state_words(n, moves)) <= MAX_SMEM)


def kernel_takes(cfg: SamplerConfig, n: int, n_clr: int, track_off: bool) -> bool:
    """Whether :func:`fused_mh_cuda` takes this config and scene size (``n``
    object lanes, ``n_clr`` real clearances, ``track_off`` as
    :func:`tracks_off` gives it): the checks it makes before launching,
    decided without building anything."""
    return (1 <= cfg.accept_draws <= MAX_ACCEPT_DRAWS
            and smem_bytes(n, n_clr, cfg.n_moves_per_step, track_off) <= MAX_SMEM)


def fused_mh_cuda(pk: PackedScene, pose0: Tensor, seed: int, iterations: int,
                  first_chain: int = 0):
    """Launch ``csrc/fused_mh.cu`` on ``pose0`` f32[C, N, 6] (a CUDA tensor).

    Same contract as :func:`fused_chains_reference`. Raises on anything the
    kernel does not take and on a failed launch.
    """
    n_chains, n = pose0.shape[0], pose0.shape[1]
    if pose0.device.type != "cuda" or pose0.dtype != torch.float32:
        raise ValueError(f"pose0 must be a CUDA f32 tensor, got {pose0.dtype} on {pose0.device}")
    if pose0.shape != (n_chains, pk.n, 6):
        raise ValueError(f"pose0 shape {tuple(pose0.shape)} != ({n_chains}, {pk.n}, 6)")
    if pk.planes.device != pose0.device:
        raise ValueError("packed scene and pose0 are on different devices")
    smem = smem_bytes(n, pk.n_clr, pk.moves, pk.track_off)
    if smem > MAX_SMEM:
        raise ValueError(f"{n} objects x {pk.n_clr} clearances need {smem} B of shared "
                         f"memory per block; the limit is {MAX_SMEM}")
    if not 0 <= iterations < 2**31 or not 0 <= first_chain < 2**31 - n_chains:
        raise ValueError(f"iterations={iterations} / chains {first_chain} + {n_chains} "
                         "out of range")
    lib = _build.load()
    pose_in = pose0.contiguous()
    pose_out = torch.empty_like(pose_in)
    stats = torch.empty(n_chains, N_STATS, dtype=torch.float32, device=pose0.device)
    args = [pose_in, pose_out, stats, pk.planes, pk.unf_idx, pk.scalars,
            pk.rel_idx, pk.rel_p, pk.ang_idx, pk.ang_p, pk.clr_idx, pk.clr_p]
    for a in args:
        if not a.is_contiguous():
            raise ValueError("fused kernel inputs must be contiguous")
    # the C entry point launches into the current device's context: make it
    # the tensors' device, whose stream it is handed
    with torch.cuda.device(pose0.device):
        err = lib.mh_fused_run(
            *[ctypes.c_void_p(a.data_ptr()) for a in args],
            pk.rel_idx.shape[0], pk.ang_idx.shape[0], pk.n_clr, n, n_chains,
            ctypes.c_uint32(seed & M32), iterations, first_chain,
            int(pk.parity), int(pk.track_off), int(pk.adapt), pk.moves, pk.accept_draws,
            int(sym_incremental(pk.moves, n)), off_slab_width(n),
            int(pk.track_off and off_incremental(pk.moves, n, pk.n_clr)),
            ctypes.c_void_p(torch.cuda.current_stream(pose0.device).cuda_stream),
        )
    fused_mh_cuda.launches += 1
    if err:
        raise RuntimeError(f"fused_mh kernel launch failed: {_build.error_string(err)}")
    return (pose_out, *decode_stats(stats))


fused_mh_cuda.launches = 0


def decode_stats(stats: Tensor):
    """``(breakdown f32[C, 8], n_accept i32[C], step_scale f32[C])`` of the
    kernel's stats rows f32[C, N_STATS]. Lane 8 holds the accept count's
    int32 bits, so counts past 2^24 come back exact."""
    return stats[:, :8], stats[:, 8].contiguous().view(torch.int32), stats[:, 9]


def uniform_block_cuda(seed: int, counter: int, first_chain: int, n_chains: int,
                       device="cuda") -> Tensor:
    """:func:`uniform_block` drawn by the kernel's own device function."""
    lib = _build.load()
    out = torch.empty(n_chains, DRAW_LANES, dtype=torch.float32, device=device)
    with torch.cuda.device(out.device):
        err = lib.mh_uniform_block(
            ctypes.c_void_p(out.data_ptr()), ctypes.c_uint32(seed & M32),
            ctypes.c_uint32(counter & M32), first_chain, n_chains,
            ctypes.c_void_p(torch.cuda.current_stream(out.device).cuda_stream),
        )
    if err:
        raise RuntimeError(f"uniform_block launch failed: {_build.error_string(err)}")
    return out


def run_chains_fused(
    seed: int,
    pose0: Tensor,
    scene: Scene,
    cfg: SamplerConfig,
    n_chains: int,
    iterations: int,
    device=None,
):
    """Run ``n_chains`` MH chains through the fused kernel.

    ``pose0`` is f32[N, 6] (shared start) or f32[n_chains, N, 6]. The run
    happens on ``device`` (default: ``pose0``'s device): the CUDA kernel
    on a CUDA device, :func:`fused_chains_reference` on the CPU.

    Returns ``(pose f32[n_chains, N, 6], breakdown f32[n_chains, 8],
    n_accept i32[n_chains], step_scale f32[n_chains])``.
    """
    device = torch.device(device) if device is not None else pose0.device
    pk = pack_scene(scene.to(device), cfg)
    return _run(pk, _chain_poses(pose0, n_chains, device), seed, iterations, 0)


def _chain_poses(pose0: Tensor, n_chains: int, device) -> Tensor:
    """f32[n_chains, N, 6] on ``device`` from a shared f32[N, 6] or a
    per-chain start."""
    pose0 = pose0.to(device=device, dtype=torch.float32)
    return pose0.expand(n_chains, *pose0.shape) if pose0.ndim == 2 else pose0


def _run(pk: PackedScene, pose0: Tensor, seed: int, iterations: int, first_chain: int):
    """Chains ``first_chain ..`` of ``pose0`` on the packed scene's device:
    the CUDA kernel there, or on the CPU its plain version."""
    device = pk.planes.device
    pose0 = pose0.contiguous()
    if device.type == "cuda":
        return fused_mh_cuda(pk, pose0, seed, iterations, first_chain)
    if device.type == "cpu":
        return fused_chains_reference(pk, pose0, seed, iterations, first_chain)
    raise ValueError(f"unsupported device {device}")


def run_chains_fused_sharded(
    seed: int,
    pose0: Tensor,
    scene: Scene,
    cfg: SamplerConfig,
    n_chains: int,
    iterations: int,
    mesh,
):
    """The fused kernel once per shard of ``mesh``'s chains axis.

    Each process packs the scene once on each of its distinct devices and
    launches its own shards: shard ``d`` runs chains ``d n_local .. (d + 1)
    n_local - 1`` with its first global chain index, which keys the
    kernel's counter-based stream, so the result is bitwise that of one
    launch on any number of shards and processes. Every shard is launched
    before any result is read; this process's outputs are joined, chains in
    shard order, on its first shard's device (every chain on a mesh within
    one process). Same returns as :func:`run_chains_fused`.
    """
    ids, devices, n_shards = chain_shards(mesh, pose0.device)
    n_local = local_count(n_chains, n_shards, "n_chains")
    packs = {}
    for d in devices:
        if d not in packs:
            packs[d] = pack_scene(scene.to(d), cfg)
    poses = _chain_poses(pose0, n_chains, devices[0])
    outs = [_run(packs[dev], poses[d * n_local:(d + 1) * n_local].to(dev), seed, iterations,
                 d * n_local)
            for d, dev in zip(ids, devices)]
    return tuple(concat(list(parts)) for parts in zip(*outs))
