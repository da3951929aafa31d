"""The fused MH chain's plain version (frozen from
``mh_tpu_torch/kernels/fused_mh.py``, commit 97f1de5: ``pack_scene``,
``_block_sum``, ``atan2_poly``, ``_Objective``, ``off_cells`` and
``fused_chains_reference`` with the symmetry match and off-limits cells
recomputed each step, which gives the bits of the kernel's incremental
states).

Rows are batched over calls: row ``r`` is chain ``chains[r]`` of the run
keyed ``seeds[r]``, so the chains of several calls replay in one batch.
Every step follows the kernel's draw layout and summation order (a
per-thread strided sum over 128 lanes, then a halving tree), so in
float32 on the card each row has the kernel's bits.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.counter_hash import DRAW_LANES, uniform_rows
from portbench.reference.scene import Scene

THREADS = 128
PROPOSAL_LANES = 8
OFF_MAX_SLABS = 16
_NEG_HUGE = -1e30
REF_PI = 3.1416  # Kernel.cu:31, PARITY's truncated pi

P_MASK, P_OK, P_RANK, P_AREA = 0, 1, 2, 3
P_OV0X, P_OTAILX, P_OMINX, P_OMINY, P_OMAXX, P_OMAXY = 4, 5, 6, 7, 8, 9
N_PLANES = 10
(S_WPW, S_WVB, S_WFP, S_WSY, S_WCL, S_WOL, S_WSA,
 S_CX2, S_CY2, S_FX, S_FY, S_FROT, S_UX, S_UY,
 S_MNX, S_MNY, S_MXX, S_MXY,
 S_SIGX, S_SIGY, S_SIGT, S_BETA, S_NOBJ, S_NUNF,
 S_ADAPTR, S_TARGET, S_PI, S_DENOM) = range(28)
N_SCALARS = 32


@dataclasses.dataclass(frozen=True)
class Sampler:
    """The sampler settings a run states (the port's ``SamplerConfig``)."""

    iterations: int = 100
    n_moves_per_step: int = 1
    accept_draws: int = 1
    beta: float = 2.0
    sigma_t: float = 15.0 / 90.0 * REF_PI
    sigma_xy_override: float = 0.0
    parity: bool = True
    adapt: bool = False
    target_accept: float = 0.44
    adapt_rate: float = 0.05

    @property
    def pi(self) -> float:
        return REF_PI if self.parity else math.pi


@dataclasses.dataclass(frozen=True)
class Packed:
    planes: torch.Tensor
    scalars: torch.Tensor
    rel_idx: torch.Tensor
    rel_p: torch.Tensor
    ang_idx: torch.Tensor
    ang_p: torch.Tensor
    clr_idx: torch.Tensor
    clr_p: torch.Tensor
    parity: bool
    track_off: bool
    adapt: bool
    moves: int
    accept_draws: int

    @property
    def n(self) -> int:
        return self.planes.shape[1]


def tracks_off(scene: Scene, cfg: Sampler) -> bool:
    return not cfg.parity and float(scene.w_offlimits) != 0.0


def off_slab_width(n: int) -> int:
    w = 8
    while w * OFF_MAX_SLABS < n:
        w *= 2
    return w


def step_layout(accept_draws: int) -> tuple[int, int]:
    """``(lanes, unroll)``: a single-move step reads ``lanes`` uniforms;
    one draw counter serves ``unroll`` steps."""
    lanes = PROPOSAL_LANES if accept_draws == 1 else PROPOSAL_LANES + accept_draws
    return lanes, min(4, max(1, DRAW_LANES // lanes))


def block_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim of ``[C, N]`` in the kernel's order."""
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


def pack(scene: Scene, cfg: Sampler, dtype=torch.float32) -> Packed:
    """The kernel's inputs, worked out from the scene (the port's
    ``pack_scene``): per-object planes, scalars and entity tables."""
    dev = scene.device

    def npf(t):
        return t.detach().cpu().float().numpy().astype(np.float32)

    def npi(t):
        return t.detach().cpu().numpy().astype(np.int32)

    n0 = scene.n
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

    mnx, mny, mxx, mxy = (float(v) for v in scene.surface_bounds())
    sigx = (mxx - mnx) / 16.0
    sigy = (mxy - mny) / 16.0
    if cfg.sigma_xy_override > 0:
        sigx = sigy = cfg.sigma_xy_override
    frot = np.float32(float(scene.focal_rot))
    denom = block_sum(torch.as_tensor(planes[P_AREA] * mask)[None])[0].item()
    s = np.zeros(N_SCALARS, np.float32)
    for slot, w in ((S_WPW, "w_pairwise"), (S_WVB, "w_visual_balance"), (S_WFP, "w_focal"),
                    (S_WSY, "w_symmetry"), (S_WCL, "w_clearance"), (S_WOL, "w_offlimits"),
                    (S_WSA, "w_surface_area")):
        s[slot] = float(getattr(scene, w))
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
    s[S_PI] = cfg.pi
    s[S_DENOM] = denom if denom > 0 else 1.0

    clr_real = np.flatnonzero(npf(scene.clr_mask) > 0)
    clr_src = npi(scene.clr_src)[clr_real]
    # Kernel.cu:456 quirk: PARITY surface area anchors clearance i to object i
    anchor = np.minimum(clr_real, n0 - 1).astype(np.int32) if cfg.parity else clr_src
    clr_p = np.stack([npf(getattr(scene.clr_rects, f))[clr_real]
                      for f in ("v0x", "tail_min_x", "min_x", "min_y", "max_x", "max_y")],
                     axis=1).reshape(-1, 6)

    def ti(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=dev)

    def tf(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev).to(dtype)

    return Packed(
        planes=tf(planes), scalars=tf(s),
        rel_idx=ti(np.stack([npi(scene.rel_src), npi(scene.rel_tgt)], 1)),
        rel_p=tf(np.stack([npf(scene.rel_lo), npf(scene.rel_hi), npf(scene.rel_mask)], 1)),
        ang_idx=ti(np.stack([npi(scene.ang_src), npi(scene.ang_tgt)], 1)),
        ang_p=tf(np.stack([npf(scene.ang_min), npf(scene.ang_max), npf(scene.ang_mask)], 1)),
        clr_idx=ti(np.stack([clr_src, anchor], 1).reshape(-1, 2)),
        clr_p=tf(clr_p),
        parity=cfg.parity, track_off=tracks_off(scene, cfg), adapt=cfg.adapt,
        moves=cfg.n_moves_per_step, accept_draws=cfg.accept_draws,
    )


def atan2_poly(y, x):
    """The kernel's branchless atan2: minimax polynomial plus quadrant folding."""
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


def floor_mod(a, b: float):
    """``jnp.mod``: the truncated remainder moved onto the divisor's sign."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def inter_area(amnx, amny, amxx, amxy, bmnx, bmny, bmxx, bmxy):
    x5 = torch.maximum(amnx, bmnx)
    y5 = torch.maximum(amny, bmny)
    x6 = torch.minimum(amxx, bmxx)
    y6 = torch.minimum(amxy, bmxy)
    return torch.where((x5 >= x6) | (y5 >= y6), 0.0, (x6 - x5) * (y6 - y5))


class Objective:
    """The kernel's ``costs_of`` for pose planes ``[C, N]``."""

    def __init__(self, pk: Packed):
        self.pk = pk
        sc = pk.scalars
        self.sc = [sc[i] for i in range(N_SCALARS)]
        self.mask = pk.planes[P_MASK]
        self.area = pk.planes[P_AREA]
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
        ov = inter_area(mnx, mny, mxx, mxy, sc[S_MNX], sc[S_MNY], sc[S_MXX], sc[S_MXY])
        return torch.clamp_min((mxx - mnx) * (mxy - mny) - ov, 0.0)

    def theta(self, xi, yi, xj, yj, ti):
        pi = self.pi
        t = atan2_poly(yi - yj, xi - xj)
        t = torch.where(t < 0, 2 * pi + t, t)
        t = t - ti
        return torch.where(t < 0, 2 * pi + t, t)

    def sym_best(self, x, y, rot):
        """[C, N]: reflection i's best match over the unmasked candidates."""
        sc, pi = self.sc, self.pi
        ux, uy = sc[S_UX], sc[S_UY]
        s = 2.0 * (sc[S_FX] * ux + sc[S_FY] * uy - (x * ux + y * uy))
        rx, ry = x + s * ux, y + s * uy
        rrot = 2.0 * sc[S_FROT] - rot
        rrot = torch.where(rrot < -pi, rrot + 2 * pi, rrot)
        cx, cy, cr = x[:, None, :], y[:, None, :], rot[:, None, :]
        rx, ry, rr = rx[:, :, None], ry[:, :, None], rrot[:, :, None]
        dp = torch.sqrt(torch.square(cx - rx) + torch.square(cy - ry))
        dt = cr - rr
        dt = torch.where(dt > pi, dt - 2 * pi, dt)
        val = 5.0 - torch.sqrt(dp) - 0.4 * torch.abs(dt)
        val = torch.where(self.mask > 0, val, _NEG_HUGE)
        return torch.amax(val, 2)

    def boxes(self, x, y):
        pl = self.pk.planes
        return (self.aabb_minx(pl[P_OV0X], pl[P_OTAILX], pl[P_OMINX], x), pl[P_OMINY] + y,
                pl[P_OMAXX] + x, pl[P_OMAXY] + y)

    def off_overlaps(self, x, y):
        """[C, i, j] overlap of object i with a later object j, times mask_j."""
        omnx, omny, omxx, omxy = self.boxes(x, y)
        ar = inter_area(omnx[:, :, None], omny[:, :, None], omxx[:, :, None], omxy[:, :, None],
                        omnx[:, None, :], omny[:, None, :], omxx[:, None, :], omxy[:, None, :])
        n = x.shape[1]
        return ar * torch.triu(torch.ones(n, n, dtype=x.dtype, device=x.device), 1) * self.mask

    def off_cells(self, x, y):
        """[C, S, N]: cell (s, i) sums object i's overlaps with the j > i of
        slab s, in ascending j."""
        c, n = x.shape
        w = off_slab_width(n)
        s = -(-n // w)
        contrib = F.pad(self.off_overlaps(x, y), (0, s * w - n)).reshape(c, n, s, w)
        cells = torch.zeros(c, n, s, dtype=x.dtype, device=x.device)
        for k in range(w):
            cells = cells + contrib[..., k]
        return cells.transpose(1, 2)

    def __call__(self, x, y, rot, with_off: bool, cells=None):
        """(total [C], the seven weighted terms in the stats-lane order)."""
        sc, pk, pi, mask = self.sc, self.pk, self.pi, self.mask
        zero = torch.zeros_like(x[:, 0])

        pw = zero
        for r, (s, t) in enumerate(self.rel):
            lo, hi, rm = pk.rel_p[r, 0], pk.rel_p[r, 1], pk.rel_p[r, 2]
            d = torch.sqrt(torch.square(x[:, s] - x[:, t]) + torch.square(y[:, s] - y[:, t]))
            lo_safe = torch.where(lo > 0, lo, 1.0)
            d_safe = torch.where(d > 0, d, 1.0)
            pen = torch.where(d < lo, -torch.square(d / lo_safe),
                              torch.where(d > hi, -torch.square(hi / d_safe), 0.0))
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
            apen = torch.where(wrap_case, torch.where(cond_wrap, -dev / norm_wrap, 0.0),
                               torch.where(cond_plain, -dev / npl, 0.0))
            pwa = pwa + apen * am
        pair = pw * pwa if pk.parity else pw + pwa

        nx = block_sum(self.area * (x * mask)) / sc[S_DENOM]
        ny = block_sum(self.area * (y * mask)) / sc[S_DENOM]
        vb = -torch.sqrt(torch.square(nx - sc[S_CX2]) + torch.square(ny - sc[S_CY2]))

        dxf = sc[S_FX] - x
        dyf = sc[S_FY] - y
        rf = torch.sqrt(torch.square(dxf) + torch.square(dyf))
        srot = torch.sin(rot)
        cph = (dxf * srot - dyf * torch.cos(rot)) / torch.where(rf > 0, rf, 1.0)
        cph = torch.where(rf > 0, cph, srot)
        fp = block_sum(-cph * mask)

        omnx, omny, omxx, omxy = self.boxes(x, y)
        best = self.sym_best(x, y, rot)
        sym = -block_sum(torch.clamp_min(best, 0.0) * mask)

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
            off = -block_sum(row * mask)

        clr = zero
        sa_acc = zero
        for c, (s, a) in enumerate(self.clr):
            v0x, tlx, mnx_, mny_, mxx_, mxy_ = (pk.clr_p[c, k] for k in range(6))
            cax, cay = x[:, s:s + 1], y[:, s:s + 1]
            ar = inter_area(self.aabb_minx(v0x, tlx, mnx_, cax), mny_ + cay,
                            mxx_ + cax, mxy_ + cay, omnx, omny, omxx, omxy)
            clr = clr - block_sum(ar * mask)
            pax, pay = x[:, a], y[:, a]
            sa_acc = sa_acc + self.outside_area(
                self.aabb_minx(v0x, tlx, mnx_, pax), mny_ + pay, mxx_ + pax, mxy_ + pay)
        sa = -sa_acc + (-block_sum(self.outside_area(omnx, omny, omxx, omxy) * mask))

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


def breakdown(pk: Packed, pose: torch.Tensor) -> torch.Tensor:
    """[C, 8]: the final report's breakdown (total first) of poses [C, N, 6]."""
    total, terms = Objective(pk)(pose[..., 0], pose[..., 1], pose[..., 4], True)
    return torch.stack([total, *terms], 1)


def chains(pk: Packed, pose0: torch.Tensor, seeds: torch.Tensor, chain_ids: torch.Tensor,
           iterations: int):
    """Replay rows of fused runs: row ``r`` starts at ``pose0[r]`` ([R, N,
    6], in the packed dtype) as chain ``chain_ids[r]`` of the run seeded
    ``seeds[r]``. Returns ``(pose [R, N, 6], breakdown [R, 8], n_accept
    i32[R], step_scale [R])``."""
    dtype = pk.planes.dtype
    sc = [pk.scalars[i] for i in range(N_SCALARS)]
    pi = float(sc[S_PI])
    two_pi = 2.0 * math.pi
    objective = Objective(pk)
    ps = pose0.permute(2, 0, 1).contiguous()  # [6, R, N] pose planes
    ok = pk.planes[P_OK]
    rank = pk.planes[P_RANK]
    n_unf, n_objs = sc[S_NUNF], sc[S_NOBJ]
    gate = torch.where(n_unf > 0.0, 1.0, 0.0).to(dtype)
    n_unf_m1 = torch.clamp_min(n_unf - 1.0, 0.0)
    n_moves, n_draws = pk.moves, pk.accept_draws

    def uniforms(counter):
        return uniform_rows(seeds, chain_ids, counter, dtype)

    def wrap_once(a):
        a = torch.where(a < 0, a + 2 * pi, a)
        return torch.where(a > 2 * pi, a - 2 * pi, a)

    def move_of(us, scale):
        move = torch.clamp_max((us[:, 0] * 3.0).to(torch.int32), 2)
        r1 = torch.sqrt(-2.0 * torch.log(us[:, 2]))
        r2 = torch.sqrt(-2.0 * torch.log(us[:, 4]))
        dx = (r1 * torch.cos(two_pi * us[:, 3]) * sc[S_SIGX] * scale)[:, None]
        dy = (r1 * torch.sin(two_pi * us[:, 3]) * sc[S_SIGY] * scale)[:, None]
        drot = (r2 * torch.cos(two_pi * us[:, 5]) * sc[S_SIGT] * scale)[:, None]
        k1 = torch.minimum(torch.floor(us[:, 6] * n_unf), n_unf_m1) + 1.0
        k2 = torch.minimum(torch.floor(us[:, 7] * n_unf), n_unf_m1) + 1.0
        is_t = (move == 0).to(dtype)[:, None]
        is_r = (move == 1).to(dtype)[:, None]
        is_s = ((move == 2) & (n_objs >= 2)).to(dtype)[:, None]
        sel1 = ((rank == k1[:, None]) & (ok > 0)).to(dtype)
        sel2 = ((rank == k2[:, None]) & (ok > 0)).to(dtype)
        return dx, dy, drot, is_t, is_r, is_s, sel1, sel2

    def single_move(ps, dx, dy, drot, is_t, is_r, is_s, sel1, sel2):
        x, y, rot = ps[0], ps[1], ps[4]
        w_t = is_t * sel1
        tdx = w_t * (torch.clamp(x + dx, sc[S_MNX], sc[S_MXX]) - x)
        tdy = w_t * (torch.clamp(y + dy, sc[S_MNY], sc[S_MXY]) - y)
        tdr = (is_r * sel1) * (wrap_once(rot + drot) - rot)
        sw = is_s * gate
        dsel = sel1 - sel2
        r1v = torch.sum(sel1 * ps, 2, keepdim=True)
        r2v = torch.sum(sel2 * ps, 2, keepdim=True)
        zero_d = torch.zeros_like(x)
        tdelta = torch.stack([tdx, tdy, zero_d, zero_d, tdr, zero_d])
        return ps + gate * (tdelta + (sw * dsel) * (r2v - r1v))

    def compound_move(st, dx, dy, drot, is_t, is_r, is_s, sel1, sel2):
        xc, yc, rc = st[0], st[1], st[4]
        w_t = is_t * sel1 * gate
        x_n = xc + w_t * (torch.clamp(xc + dx, sc[S_MNX], sc[S_MXX]) - xc)
        y_n = yc + w_t * (torch.clamp(yc + dy, sc[S_MNY], sc[S_MXY]) - yc)
        rot_n = rc + (is_r * sel1 * gate) * (wrap_once(rc + drot) - rc)
        st = torch.stack([x_n, y_n, st[2], st[3], rot_n, st[5]])
        sw = is_s * gate
        r1v = torch.sum(sel1 * st, 2, keepdim=True)
        r2v = torch.sum(sel2 * st, 2, keepdim=True)
        return st + (sw * (sel1 - sel2)) * (r2v - r1v)

    cells = objective.off_cells(ps[0], ps[1]) if pk.track_off else None
    cur, _ = objective(ps[0], ps[1], ps[4], pk.track_off, cells=cells)
    n_acc = torch.zeros(cur.shape[0], dtype=torch.int32, device=cur.device)
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
            star = single_move(ps, *move_of(us, scale))
        else:
            c0 = t * (n_moves + 1)
            us0 = uniforms(c0)
            u_acc = us0[:, 1] if n_draws == 1 else torch.amin(us0[:, 1:1 + n_draws], 1)
            star = ps
            for m in range(n_moves):
                star = compound_move(star, *move_of(uniforms(c0 + 1 + m), scale))
        cells_s = objective.off_cells(star[0], star[1]) if pk.track_off else None
        total_star, _ = objective(star[0], star[1], star[4], pk.track_off, cells_s)
        ratio = torch.exp(torch.clamp_max(sc[S_BETA] * (total_star - cur), 0.0))
        acc_b = (u_acc < ratio) & (gate > 0)
        ps = torch.where(acc_b[:, None], star, ps)
        cur = torch.where(acc_b, total_star, cur)
        n_acc = n_acc + acc_b.to(torch.int32)
        if pk.adapt:
            log_scale = log_scale + sc[S_ADAPTR] * (acc_b.to(dtype) - sc[S_TARGET])

    pose = ps.permute(1, 2, 0).contiguous()
    return pose, breakdown(pk, pose), n_acc, torch.exp(log_scale)
