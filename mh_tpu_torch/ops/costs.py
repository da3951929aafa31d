"""The layout objective: seven masked cost terms + aggregator.

Counterpart of ``mh_tpu.ops.costs`` (reference cost library,
``Kernel.cu:191-564``). Each term is a function of ``(pose f32[..., N, 6],
Scene)`` returning the raw (unweighted) error over the leading batch
dims; the O(N^2) terms evaluate full N x N matrices by broadcasting.

This module is written independently of the fused kernel (it keeps the
reference's own formulas: ``atan2``, the four-piece outside area, the
``cos(phi)`` focal term), so it doubles as the check on the kernel's
reported breakdowns.
"""

from __future__ import annotations

import dataclasses

import torch

from mh_tpu_torch.config import CostMode
from mh_tpu_torch.models.scene import Scene
from mh_tpu_torch.ops import geometry as geo

Tensor = torch.Tensor

_NEG_HUGE = -1e30


@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    """Weighted per-term costs + total (mirrors ``resultCosts``, Kernel.cu:134-144)."""

    total: Tensor
    pair_wise: Tensor
    visual_balance: Tensor
    focal_point: Tensor
    symmetry: Tensor
    clearance: Tensor
    off_limits: Tensor
    surface_area: Tensor

    def as_vector(self) -> Tensor:
        return torch.stack([getattr(self, f.name) for f in dataclasses.fields(self)], -1)


def pair_wise_costs(pose: Tensor, scene: Scene) -> Tensor:
    """Distance-relationship penalty (``Kernel.cu:210-233``).

    d < lo: -(d/lo)^2; d > hi: -(hi/d)^2; in range: 0.
    """
    sx, sy = pose[..., scene.rel_src, 0], pose[..., scene.rel_src, 1]
    tx, ty = pose[..., scene.rel_tgt, 0], pose[..., scene.rel_tgt, 1]
    d = geo.distance(sx, sy, tx, ty)
    lo = torch.where(scene.rel_lo > 0, scene.rel_lo, 1.0)
    d_safe = torch.where(d > 0, d, 1.0)
    near = -torch.square(d / lo)
    far = -torch.square(scene.rel_hi / d_safe)
    pen = torch.where(d < scene.rel_lo, near, torch.where(d > scene.rel_hi, far, 0.0))
    return torch.sum(pen * scene.rel_mask, -1)


def floor_mod(a: Tensor, b: float) -> Tensor:
    """``jnp.mod``: the truncated remainder moved onto the divisor's sign."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def pair_wise_angle_costs(pose: Tensor, scene: Scene, mode: CostMode) -> Tensor:
    """Angle-relationship penalty (``Kernel.cu:236-263``).

    theta = bearing source->target re-oriented by the target's rotY. A
    zero-crossing range (amin > amax) penalizes ``fmod(amin + theta, 2pi) >
    amax``; a plain range uses the reference's ``||`` test in parity mode
    (almost always true) and a genuine outside-range test in fixed mode.
    """
    pi = mode.pi
    sx, sy = pose[..., scene.ang_src, 0], pose[..., scene.ang_src, 1]
    tx, ty = pose[..., scene.ang_tgt, 0], pose[..., scene.ang_tgt, 1]
    trot = pose[..., scene.ang_tgt, 4]
    th = geo.theta(sx, sy, tx, ty, trot, pi)

    amin, amax = scene.ang_min, scene.ang_max
    dev = torch.minimum(torch.abs(th - amin), torch.abs(th - amax))

    wrap_case = amin > amax
    norm_wrap = torch.where(wrap_case, (amin - amax) / 2.0, 1.0)
    cond_wrap = floor_mod(amin + th, 2 * pi) > amax

    norm_plain_raw = (2 * pi - (amax - amin)) / 2.0
    norm_plain = torch.where(norm_plain_raw != 0, norm_plain_raw, 1.0)
    if mode is CostMode.PARITY:
        cond_plain = (amin < th) | (th < amax)  # Kernel.cu:251 — quirky OR
    else:
        cond_plain = (th < amin) | (th > amax)

    pen = torch.where(
        wrap_case,
        torch.where(cond_wrap, -dev / norm_wrap, 0.0),
        torch.where(cond_plain, -dev / norm_plain, 0.0),
    )
    return torch.sum(pen * scene.ang_mask, -1)


def visual_balance_costs(pose: Tensor, scene: Scene) -> Tensor:
    """Area-weighted centroid vs half-centroid (``Kernel.cu:191-207``)."""
    area = scene.sizes[:, 0] * scene.sizes[:, 1] * scene.obj_mask
    denom = torch.sum(area)
    denom = torch.where(denom > 0, denom, 1.0)
    nx = torch.sum(area * pose[..., 0], -1) / denom
    ny = torch.sum(area * pose[..., 1], -1) / denom
    return -geo.distance(nx, ny, scene.centroid[0] / 2.0, scene.centroid[1] / 2.0)


def focal_point_costs(pose: Tensor, scene: Scene, mode: CostMode) -> Tensor:
    """Sum of -cos(phi) toward the focal point (``Kernel.cu:266-281``)."""
    ph = geo.phi(
        scene.focal[0], scene.focal[1], pose[..., 0], pose[..., 1], pose[..., 4], mode.pi
    )
    return torch.sum(-torch.cos(ph) * scene.obj_mask, -1)


def symmetry_costs(pose: Tensor, scene: Scene, mode: CostMode) -> Tensor:
    """Best-match reflection symmetry score (``Kernel.cu:283-318``).

    Object i is reflected across the axis through the focal point with
    direction (cos focal_rot, sin focal_rot); its best match over j
    maximizes ``5 - sqrt(dist) - 0.4*|drot|`` floored at 0; the term is
    -sum of best matches. Padded j columns are masked before the row max.
    """
    pi = mode.pi
    x, y, rot = pose[..., 0], pose[..., 1], pose[..., 4]
    ux = torch.cos(scene.focal_rot)
    uy = torch.sin(scene.focal_rot)
    s = 2.0 * (scene.focal[0] * ux + scene.focal[1] * uy - (x * ux + y * uy))
    rx = x + s * ux
    ry = y + s * uy
    rrot = 2.0 * scene.focal_rot - rot
    rrot = torch.where(rrot < -pi, rrot + 2 * pi, rrot)

    # [..., i, j]: reflection of i vs candidate j
    dp = geo.distance(x[..., None, :], y[..., None, :], rx[..., :, None], ry[..., :, None])
    dt = rot[..., None, :] - rrot[..., :, None]
    dt = torch.where(dt > pi, dt - 2 * pi, dt)
    val = 5.0 - torch.sqrt(dp) - 0.4 * torch.abs(dt)
    val = torch.where(scene.obj_mask > 0, val, _NEG_HUGE)
    best = torch.clamp_min(torch.amax(val, -1), 0.0)
    return -torch.sum(best * scene.obj_mask, -1)


def _obj_aabbs(pose: Tensor, scene: Scene, mode: CostMode):
    """Per-object off-limits AABBs translated by each object's position."""
    return scene.off_rects.aabb(pose[..., 0], pose[..., 1], mode)


def clearance_costs(pose: Tensor, scene: Scene, mode: CostMode) -> Tensor:
    """Clearance-vs-off-limits overlap (``Kernel.cu:404-434``).

    Clearance rect c is translated by its source object's position
    (``Kernel.cu:414-415``) and compared against every object's off-limits
    AABB as a C x N area matrix.
    """
    cmnx, cmny, cmxx, cmxy = scene.clr_rects.aabb(
        pose[..., scene.clr_src, 0], pose[..., scene.clr_src, 1], mode
    )
    omnx, omny, omxx, omxy = _obj_aabbs(pose, scene, mode)
    area = geo.intersection_area(
        cmnx[..., :, None], cmny[..., :, None], cmxx[..., :, None], cmxy[..., :, None],
        omnx[..., None, :], omny[..., None, :], omxx[..., None, :], omxy[..., None, :],
    )
    return -torch.sum(area * scene.clr_mask[:, None] * scene.obj_mask, (-2, -1))


def off_limits_costs(pose: Tensor, scene: Scene, mode: CostMode) -> Tensor:
    """Pairwise (i < j) off-limits AABB overlap (``Kernel.cu:485-514``)."""
    mnx, mny, mxx, mxy = _obj_aabbs(pose, scene, mode)
    area = geo.intersection_area(
        mnx[..., :, None], mny[..., :, None], mxx[..., :, None], mxy[..., :, None],
        mnx[..., None, :], mny[..., None, :], mxx[..., None, :], mxy[..., None, :],
    )
    n = pose.shape[-2]
    upper = torch.triu(torch.ones((n, n), dtype=area.dtype, device=area.device), 1)
    m = scene.obj_mask
    return -torch.sum(area * upper * m[:, None] * m, (-2, -1))


def surface_area_costs(pose: Tensor, scene: Scene, mode: CostMode) -> Tensor:
    """Out-of-surface area of clearance + off-limits rects (``Kernel.cu:437-483``).

    Parity quirk: clearance rect i is translated by object i's pose — the
    loop index, not its SourceIndex (``Kernel.cu:456``); fixed mode uses
    SourceIndex.
    """
    smnx, smny, smxx, smxy = scene.surface_bounds()
    if mode is CostMode.PARITY:
        c = scene.clr_src.shape[0]
        idx = torch.clamp_max(torch.arange(c, device=pose.device), scene.n_pad_objs - 1)
    else:
        idx = scene.clr_src
    cmnx, cmny, cmxx, cmxy = scene.clr_rects.aabb(pose[..., idx, 0], pose[..., idx, 1], mode)
    clr_out = geo.outside_surface_area(cmnx, cmny, cmxx, cmxy, smnx, smny, smxx, smxy)

    omnx, omny, omxx, omxy = _obj_aabbs(pose, scene, mode)
    obj_out = geo.outside_surface_area(omnx, omny, omxx, omxy, smnx, smny, smxx, smxy)

    return -(torch.sum(clr_out * scene.clr_mask, -1) + torch.sum(obj_out * scene.obj_mask, -1))


def cost_terms(
    pose: Tensor,
    scene: Scene,
    mode: CostMode = CostMode.PARITY,
    skip_unused_offlimits: bool = False,
) -> CostBreakdown:
    """Weighted breakdown + total — the ``Costs`` aggregator (``Kernel.cu:516-550``).

    Parity: pair term = w_pairwise * (PairWise * PairWiseAngle) (``:518``);
    the total excludes OffLimits (``:547``). Fixed: pair term =
    w_pairwise * (PairWise + PairWiseAngle); the total includes OffLimits.

    ``skip_unused_offlimits``: skip the O(N^2) off-limits matrix where it
    cannot change the total — always in PARITY, and in FIXED when the
    weight is exactly 0. The breakdown then reports 0 for it.
    """
    pw = pair_wise_costs(pose, scene)
    pwa = pair_wise_angle_costs(pose, scene, mode)
    if mode is CostMode.PARITY:
        pair = scene.w_pairwise * (pw * pwa)
    else:
        pair = scene.w_pairwise * (pw + pwa)
    vb = scene.w_visual_balance * visual_balance_costs(pose, scene)
    fp = scene.w_focal * focal_point_costs(pose, scene, mode)
    sym = scene.w_symmetry * symmetry_costs(pose, scene, mode)
    if skip_unused_offlimits and (
        mode is CostMode.PARITY or float(scene.w_offlimits) == 0.0
    ):
        off = torch.zeros_like(pair)
    else:
        off = scene.w_offlimits * off_limits_costs(pose, scene, mode)
    clr = scene.w_clearance * clearance_costs(pose, scene, mode)
    sa = scene.w_surface_area * surface_area_costs(pose, scene, mode)
    total = pair + vb + fp + sym + clr + sa
    if mode is CostMode.FIXED:
        total = total + off
    return CostBreakdown(
        total=total,
        pair_wise=pair,
        visual_balance=vb,
        focal_point=fp,
        symmetry=sym,
        clearance=clr,
        off_limits=off,
        surface_area=sa,
    )


def total_cost(pose: Tensor, scene: Scene, mode: CostMode = CostMode.PARITY) -> Tensor:
    """Scalar objective — the quantity the Boltzmann rule compares (``Kernel.cu:712``)."""
    return cost_terms(pose, scene, mode).total
