"""The torch chain engine and its replica exchange (frozen from
``mh_tpu_torch``, commit 97f1de5): the objective of ``ops/costs.py`` and
``ops/geometry.py`` (``weighted_terms``), the move of
``sampler/proposal.py`` (``MoveTables``, ``decode_moves``,
``move_weights``, ``apply_move``, ``block_apply``), the step of
``sampler/mh.py`` (``ChainStep``, ``chain_starts``, ``finalize_costs``)
and ``sampler/tempering.py``'s ``run_tempered`` on one shard with a fixed
geometric ladder.

Chain ``c`` is keyed ``fold_in(key, c)``; step ``t`` draws ``uniform(
fold_in(chain_key, t), (M, 8))``. On the card each op here is the engine's
own op on the same shapes, so a float32 replay has the engine's bits.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from portbench.reference import threefry as tf
from portbench.reference.fused import Sampler, floor_mod
from portbench.reference.scene import BIG, Scene

UNIFORMS_PER_MOVE = 8
_EPS = tf.f32(1e-7)
_TWO_PI = tf.f32(2.0 * math.pi)
_NEG_HUGE = -1e30


# --- objective (ops/geometry.py, ops/costs.py) -----------------------------
def distance(xi, yi, xj, yj):
    dx = xi - xj
    dy = yi - yj
    return torch.sqrt(dx * dx + dy * dy)


def atan2(y, x):
    """``torch.atan2`` with one rounding for every element: on the CPU a
    contiguous input takes SLEEF's vectorised atan2 for whole vectors and
    the C library's for the tail; a strided one takes the latter alone."""
    if y.device.type != "cpu":
        return torch.atan2(y, x)
    pair = torch.stack(torch.broadcast_tensors(y, x), -1)
    return torch.atan2(pair[..., 0], pair[..., 1])


def theta(xi, yi, xj, yj, ti, pi):
    t = atan2(yi - yj, xi - xj)
    t = torch.where(t < 0, 2 * pi + t, t)
    t = t - ti
    return torch.where(t < 0, 2 * pi + t, t)


def phi(xi, yi, xj, yj, tj, pi):
    return atan2(yi - yj, xi - xj) - tj + pi / 2.0


def intersection_area(a_min_x, a_min_y, a_max_x, a_max_y, b_min_x, b_min_y, b_max_x, b_max_y):
    x5 = torch.maximum(a_min_x, b_min_x)
    y5 = torch.maximum(a_min_y, b_min_y)
    x6 = torch.minimum(a_max_x, b_max_x)
    y6 = torch.minimum(a_max_y, b_max_y)
    empty = (x5 >= x6) | (y5 >= y6)
    return torch.where(empty, 0.0, (x6 - x5) * (y6 - y5))


def outside_surface_area(r_min_x, r_min_y, r_max_x, r_max_y, s_min_x, s_min_y, s_max_x, s_max_y):
    big = torch.full_like(s_min_x, BIG)
    a1 = intersection_area(r_min_x, r_min_y, r_max_x, r_max_y, -big, -big, big, s_min_y)
    a2 = intersection_area(r_min_x, r_min_y, r_max_x, r_max_y, -big, s_min_y, s_min_x, s_max_y)
    a3 = intersection_area(r_min_x, r_min_y, r_max_x, r_max_y, -big, s_max_y, big, big)
    a4 = intersection_area(r_min_x, r_min_y, r_max_x, r_max_y, s_max_x, s_min_y, big, s_max_y)
    return a1 + a2 + a3 + a4


def weighted_terms(pose, scene: Scene, parity: bool, with_off: bool) -> torch.Tensor:
    """[..., 8]: total, pair, balance, focal, symmetry, clearance,
    off-limits, surface area, each weighted, of poses [..., N, 6]."""
    pi = 3.1416 if parity else math.pi
    x, y, rot = pose[..., 0], pose[..., 1], pose[..., 4]

    # pairwise distance (Kernel.cu:210-233)
    d = distance(pose[..., scene.rel_src, 0], pose[..., scene.rel_src, 1],
                 pose[..., scene.rel_tgt, 0], pose[..., scene.rel_tgt, 1])
    lo = torch.where(scene.rel_lo > 0, scene.rel_lo, 1.0)
    d_safe = torch.where(d > 0, d, 1.0)
    pen = torch.where(d < scene.rel_lo, -torch.square(d / lo),
                      torch.where(d > scene.rel_hi, -torch.square(scene.rel_hi / d_safe), 0.0))
    pw = torch.sum(pen * scene.rel_mask, -1)

    # pairwise angle (Kernel.cu:236-263)
    th = theta(pose[..., scene.ang_src, 0], pose[..., scene.ang_src, 1],
               pose[..., scene.ang_tgt, 0], pose[..., scene.ang_tgt, 1],
               pose[..., scene.ang_tgt, 4], pi)
    amin, amax = scene.ang_min, scene.ang_max
    dev = torch.minimum(torch.abs(th - amin), torch.abs(th - amax))
    wrap_case = amin > amax
    norm_wrap = torch.where(wrap_case, (amin - amax) / 2.0, 1.0)
    cond_wrap = floor_mod(amin + th, 2 * pi) > amax
    norm_plain_raw = (2 * pi - (amax - amin)) / 2.0
    norm_plain = torch.where(norm_plain_raw != 0, norm_plain_raw, 1.0)
    cond_plain = (amin < th) | (th < amax) if parity else (th < amin) | (th > amax)
    apen = torch.where(wrap_case, torch.where(cond_wrap, -dev / norm_wrap, 0.0),
                       torch.where(cond_plain, -dev / norm_plain, 0.0))
    pwa = torch.sum(apen * scene.ang_mask, -1)
    pair = scene.w_pairwise * (pw * pwa) if parity else scene.w_pairwise * (pw + pwa)

    # visual balance (Kernel.cu:191-207)
    area = scene.sizes[:, 0] * scene.sizes[:, 1] * scene.obj_mask
    denom = torch.sum(area)
    denom = torch.where(denom > 0, denom, 1.0)
    nx = torch.sum(area * x, -1) / denom
    ny = torch.sum(area * y, -1) / denom
    vb = scene.w_visual_balance * -distance(nx, ny, scene.centroid[0] / 2.0,
                                            scene.centroid[1] / 2.0)

    # focal point (Kernel.cu:266-281)
    ph = phi(scene.focal[0], scene.focal[1], x, y, rot, pi)
    fp = scene.w_focal * torch.sum(-torch.cos(ph) * scene.obj_mask, -1)

    # symmetry (Kernel.cu:283-318)
    ux = torch.cos(scene.focal_rot)
    uy = torch.sin(scene.focal_rot)
    s = 2.0 * (scene.focal[0] * ux + scene.focal[1] * uy - (x * ux + y * uy))
    rx = x + s * ux
    ry = y + s * uy
    rrot = 2.0 * scene.focal_rot - rot
    rrot = torch.where(rrot < -pi, rrot + 2 * pi, rrot)
    dp = distance(x[..., None, :], y[..., None, :], rx[..., :, None], ry[..., :, None])
    dt = rot[..., None, :] - rrot[..., :, None]
    dt = torch.where(dt > pi, dt - 2 * pi, dt)
    val = 5.0 - torch.sqrt(dp) - 0.4 * torch.abs(dt)
    val = torch.where(scene.obj_mask > 0, val, _NEG_HUGE)
    row_max = torch.amax(val, -1)
    best = torch.maximum(row_max, torch.zeros_like(row_max))
    sym = scene.w_symmetry * -torch.sum(best * scene.obj_mask, -1)

    omnx, omny, omxx, omxy = scene.off_rects.aabb(x, y, parity)
    # off-limits i < j overlap (Kernel.cu:485-514)
    if with_off:
        area_o = intersection_area(
            omnx[..., :, None], omny[..., :, None], omxx[..., :, None], omxy[..., :, None],
            omnx[..., None, :], omny[..., None, :], omxx[..., None, :], omxy[..., None, :])
        n = pose.shape[-2]
        upper = torch.triu(torch.ones((n, n), dtype=area_o.dtype, device=area_o.device), 1)
        m = scene.obj_mask
        off = scene.w_offlimits * -torch.sum(area_o * upper * m[:, None] * m, (-2, -1))
    else:
        off = torch.zeros_like(pair)

    # clearance (Kernel.cu:404-434)
    cmnx, cmny, cmxx, cmxy = scene.clr_rects.aabb(pose[..., scene.clr_src, 0],
                                                  pose[..., scene.clr_src, 1], parity)
    area_c = intersection_area(
        cmnx[..., :, None], cmny[..., :, None], cmxx[..., :, None], cmxy[..., :, None],
        omnx[..., None, :], omny[..., None, :], omxx[..., None, :], omxy[..., None, :])
    clr = scene.w_clearance * -torch.sum(area_c * scene.clr_mask[:, None] * scene.obj_mask,
                                         (-2, -1))

    # surface area (Kernel.cu:437-483); PARITY anchors clearance i to object i
    smnx, smny, smxx, smxy = scene.surface_bounds()
    if parity:
        c = scene.clr_src.shape[0]
        idx = torch.clamp_max(torch.arange(c, device=pose.device), scene.n - 1)
    else:
        idx = scene.clr_src
    amnx, amny, amxx, amxy = scene.clr_rects.aabb(pose[..., idx, 0], pose[..., idx, 1], parity)
    clr_out = outside_surface_area(amnx, amny, amxx, amxy, smnx, smny, smxx, smxy)
    obj_out = outside_surface_area(omnx, omny, omxx, omxy, smnx, smny, smxx, smxy)
    sa = scene.w_surface_area * -(torch.sum(clr_out * scene.clr_mask, -1)
                                  + torch.sum(obj_out * scene.obj_mask, -1))

    total = pair + vb + fp + sym + clr + sa
    if not parity:
        total = total + off
    return torch.stack([total, pair, vb, fp, sym, clr, off, sa], -1)


# --- the move (sampler/proposal.py) ----------------------------------------
@dataclasses.dataclass(frozen=True)
class MoveTables:
    rank: torch.Tensor
    n_unf: torch.Tensor
    has_unf: torch.Tensor
    can_swap: torch.Tensor
    bounds: tuple
    sigmas: tuple
    sigma_t: float
    pi: float
    neg_zero_row: torch.Tensor

    @classmethod
    def build(cls, scene: Scene, cfg: Sampler) -> "MoveTables":
        dtype = scene.obj_mask.dtype
        ok = scene.obj_mask * (1.0 - scene.frozen.to(dtype))
        rank = torch.cumsum(ok, 0)
        mnx, mny, mxx, mxy = scene.surface_bounds()
        if cfg.sigma_xy_override > 0:
            s = torch.full((), cfg.sigma_xy_override, dtype=dtype, device=scene.device)
            sigmas = (s, s)
        else:
            sigmas = ((mxx - mnx) / 16.0, (mxy - mny) / 16.0)
        return cls(rank=rank, n_unf=rank[-1], has_unf=rank[-1] > 0,
                   can_swap=torch.sum(scene.obj_mask).to(torch.int32) >= 2,
                   bounds=(mnx, mny, mxx, mxy), sigmas=sigmas, sigma_t=tf.f32(cfg.sigma_t),
                   pi=cfg.pi, neg_zero_row=torch.full((1, 1, 6), -0.0, dtype=dtype,
                                                      device=scene.device))


def decode_moves(u, tables: MoveTables, scale):
    """(move, dx, dy, drot, i1, i2) of every move of ``u`` [..., M, 8]."""
    move = torch.clamp_max((u[..., 0] * 3.0).to(torch.int32), 2)
    r1 = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u[..., 2], _EPS)))
    r2 = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u[..., 4], _EPS)))
    n0 = r1 * torch.cos(_TWO_PI * u[..., 3])
    n1 = r1 * torch.sin(_TWO_PI * u[..., 3])
    n2 = r2 * torch.cos(_TWO_PI * u[..., 5])
    scale = torch.as_tensor(scale, dtype=u.dtype, device=u.device)[..., None]
    sx, sy = tables.sigmas
    dx = n0 * sx * scale
    dy = n1 * sy * scale
    drot = n2 * tables.sigma_t * scale

    def pick(v):
        target = torch.minimum(torch.floor(v * tables.n_unf), tables.n_unf - 1.0) + 1.0
        return torch.searchsorted(tables.rank, target.contiguous())

    return move, dx, dy, drot, pick(u[..., 6]), pick(u[..., 7])


def move_weights(move, i1, i2, tables: MoveTables, dtype):
    same = (i1 == i2).to(dtype)
    one, zero = torch.ones_like(same), torch.zeros_like(same)
    sel1 = torch.stack([one, same, zero], -1)
    sel2 = torch.stack([same, one, zero], -1)
    is_t = (move == 0).to(dtype)[..., None]
    is_r = (move == 1).to(dtype)[..., None]
    can_swap = ((move == 2) & tables.can_swap).to(dtype)[..., None]
    return torch.stack([is_t * sel1, is_r * sel1, can_swap * (sel1 - sel2)], -2)


def wrap_angle_once(a, pi):
    a = torch.where(a < 0, a + 2 * pi, a)
    return torch.where(a > 2 * pi, a - 2 * pi, a)


def apply_move(pose, tables: MoveTables, dx, dy, drot, i1, i2, weights):
    """One decoded move on ``pose`` [B, N, 6]: the picked rows and a row of
    -0.0 through the move's plane expressions, the latter added to every
    row for its zero signs."""
    mnx, mny, mxx, mxy = tables.bounds
    b = pose.shape[0]
    idx = torch.stack([i1, i2], 1)[:, :, None].expand(-1, 2, 6)
    rows = torch.cat([torch.gather(pose, 1, idx), tables.neg_zero_row.expand(b, 1, 6)], 1)
    w_t, w_r, w_s = weights.unbind(-2)
    x, y, rot = rows[..., 0], rows[..., 1], rows[..., 4]
    new_x = x + w_t * (torch.clamp(x + dx[:, None], mnx, mxx) - x)
    new_y = y + w_t * (torch.clamp(y + dy[:, None], mny, mxy) - y)
    new_rot = rot + w_r * (wrap_angle_once(rot + drot[:, None], tables.pi) - rot)
    star = torch.stack([new_x, new_y, rows[..., 2], rows[..., 3], new_rot, rows[..., 5]], -1)
    picked = star[:, :2] + 0.0
    out = star + w_s[..., None] * (picked[:, 1] - picked[:, 0])[:, None]
    out = torch.where(tables.has_unf, out, rows)
    new = pose + out[:, 2:]
    return new.scatter_(1, idx, out[:, :2])


def block_apply(u, pose, tables: MoveTables, scale):
    """M sequential moves from ``u`` [..., M, 8] on ``pose`` [..., N, 6]."""
    lead = pose.shape[:-2]
    b = math.prod(lead)
    flat = pose.reshape(b, *pose.shape[-2:])
    move, *fields = (t.expand(*lead, u.shape[-2]).reshape(b, -1)
                     for t in decode_moves(u, tables, scale))
    weights = move_weights(move, fields[3], fields[4], tables, pose.dtype)
    for m in range(u.shape[-2]):
        flat = apply_move(flat, tables, *(t[:, m] for t in fields), weights[:, m])
    return flat.reshape(pose.shape)


# --- the step (sampler/mh.py) ----------------------------------------------
@dataclasses.dataclass(frozen=True)
class State:
    pose: torch.Tensor  # [C, N, 6]
    costs: torch.Tensor  # [C, 8]
    key: torch.Tensor  # int64 [C, 2]
    step: torch.Tensor  # int32 [C]
    n_accept: torch.Tensor  # int32 [C]
    log_scale: torch.Tensor  # [C]


class Step:
    """One MH iteration of every chain (``ChainStep``); PARITY leaves the
    off-limits term out of the loop and fills it in at :meth:`finalize`."""

    def __init__(self, scene: Scene, cfg: Sampler):
        self.scene, self.cfg = scene, cfg
        self.with_off = not (cfg.parity or float(scene.w_offlimits) == 0.0)
        self.tables = MoveTables.build(scene, cfg)
        self.beta = tf.f32(cfg.beta)

    def costs(self, pose):
        return weighted_terms(pose, self.scene, self.cfg.parity, self.with_off)

    def init(self, pose, keys) -> State:
        c = pose.shape[0]
        dev = pose.device
        return State(pose, self.costs(pose), keys, torch.zeros(c, dtype=torch.int32, device=dev),
                     torch.zeros(c, dtype=torch.int32, device=dev),
                     torch.zeros(c, dtype=pose.dtype, device=dev))

    def __call__(self, st: State, beta=None) -> State:
        cfg = self.cfg
        key_step = tf.fold_in(st.key, st.step)
        u = tf.uniform(key_step, (cfg.n_moves_per_step, UNIFORMS_PER_MOVE)).to(st.pose.dtype)
        star = block_apply(u, st.pose, self.tables, torch.exp(st.log_scale))
        star_costs = self.costs(star)
        b = self.beta if beta is None else beta
        ratio = torch.exp(torch.clamp_max(b * (star_costs[:, 0] - st.costs[:, 0]), 0.0))
        if cfg.accept_draws == 1:
            u_acc = u[..., 0, 1]
        else:
            u_acc = torch.amin(tf.uniform(tf.fold_in(key_step, 1), (cfg.accept_draws,)), -1)
        acc = u_acc < ratio
        log_scale = st.log_scale
        if cfg.adapt:
            log_scale = log_scale + tf.f32(cfg.adapt_rate) * (
                acc.to(log_scale.dtype) - tf.f32(cfg.target_accept))
        return State(pose=torch.where(acc[..., None, None], star, st.pose),
                     costs=torch.where(acc[:, None], star_costs, st.costs),
                     key=st.key, step=st.step + 1,
                     n_accept=st.n_accept + acc.to(torch.int32), log_scale=log_scale)

    def finalize(self, st: State) -> State:
        """PARITY's off-limits term, scored once on the final pose."""
        if not self.cfg.parity:
            return st
        full = weighted_terms(st.pose, self.scene, True, True)
        costs = torch.cat([st.costs[:, :6], full[:, 6:7], st.costs[:, 7:]], 1)
        return dataclasses.replace(st, costs=costs)


def chain_starts(key, pose0, n_chains: int):
    """(poses [C, N, 6], keys [C, 2]): chain ``c`` keyed ``fold_in(key, c)``."""
    keys = tf.fold_in(key, torch.arange(n_chains, device=key.device))
    return pose0.expand(n_chains, *pose0.shape).contiguous(), keys


# --- parallel tempering (sampler/tempering.py, one shard) ------------------
def geometric_ladder(n: int, beta_min: float, beta_max: float, device=None):
    frac = np.arange(n, dtype=np.float32) * (np.float32(1.0) / np.float32(max(n - 1, 1)))
    ladder = np.float32(beta_min) * np.float32(beta_max / beta_min) ** frac
    return torch.as_tensor(ladder.astype(np.float32), device=device)


def tempered(key, pose0, scene: Scene, cfg: Sampler, n_replicas: int, exchange_every: int,
             rounds: int):
    """``run_tempered`` without a mesh and without ladder adaptation:
    (final :class:`State` of the K replicas, swap rate of each round)."""
    dev = scene.device
    betas = geometric_ladder(n_replicas, 0.1, cfg.beta).to(dev).to(pose0.dtype)
    step = Step(scene, cfg)
    st = step.init(*chain_starts(key, pose0, n_replicas))
    g = torch.arange(n_replicas, device=dev)
    pair_key = tf.fold_in(key, 0x7E3)
    rates = []
    for rnd in range(rounds):
        for _ in range(exchange_every):
            st = step(st, beta=betas[g])
        is_lower = (g % 2) == (rnd % 2)  # pair (g, g+1), g the lower member
        partner = torch.where(is_lower, g + 1, g - 1)
        valid = (partner >= 0) & (partner < n_replicas)
        p = torch.clamp(partner, 0, n_replicas - 1)
        u = tf.uniform(tf.fold_in(pair_key, rnd * n_replicas + torch.minimum(g, partner)))
        log_ratio = (betas[g] - betas[p]) * (st.costs[p, 0] - st.costs[:, 0])
        accept = valid & (u < torch.exp(torch.clamp_max(log_ratio, 0.0)))
        st = dataclasses.replace(st, pose=torch.where(accept[:, None, None], st.pose[p], st.pose),
                                 costs=torch.where(accept[:, None], st.costs[p], st.costs))
        own = valid & is_lower
        swapped = (accept & own).to(torch.float32)
        rates.append(torch.sum(swapped) / torch.clamp_min(torch.sum(own.to(torch.float32)), 1.0))
    return step.finalize(st), torch.stack(rates)
