"""Object-axis sharded costs: the row-sharded objective for huge scenes.

Counterpart of ``mh_tpu.parallel.objshard``. The O(N^2) terms (symmetry's
best matches, ``Kernel.cu:283-318``; FIXED off-limits overlaps,
``:485-514``) are split by rows over a mesh's objs axis: every objs shard
holds a copy of the pose (O(N)) and the scene, and evaluates its
``N / k``-row slice of each pairwise matrix; the per-chain partial sums
are reduced with :func:`~mh_tpu_torch.parallel.mesh.psum` in shard order.
The O(N) terms are computed once per chain shard, on its first objs
shard's device. This is the path past the fused kernel's shared-memory
limit (2,582 objects with 2 clearances): no shard holds a chain's whole
N x N matrices. Results equal :func:`~mh_tpu_torch.ops.costs.cost_terms`
up to the order of the row sums. It runs in one process: a mesh that
spans processes raises.
"""

from __future__ import annotations

import numpy as np
import torch

from mh_tpu_torch.config import CostMode, SamplerConfig
from mh_tpu_torch.models.scene import Scene
from mh_tpu_torch.ops import costs as C
from mh_tpu_torch.ops import geometry as geo
from mh_tpu_torch.ops.costs import CostBreakdown, offlimits_unused
from mh_tpu_torch.parallel.mesh import (
    CHAINS_AXIS, Mesh, cuda_devices, local_count, psum,
)
from mh_tpu_torch.parallel.sharded import advance, concat_states, shard_starts, shard_steps

Tensor = torch.Tensor

OBJS_AXIS = "objs"


def _symmetry_rows(pose: Tensor, scene: Scene, mode: CostMode, start: int, rows: int) -> Tensor:
    """Rows ``[start, start + rows)`` of the symmetry best-match sum, per chain."""
    pi = mode.pi
    x, y, rot = pose[..., 0], pose[..., 1], pose[..., 4]
    ux = torch.cos(scene.focal_rot)
    uy = torch.sin(scene.focal_rot)
    sl = slice(start, start + rows)
    xs, ys, rs = x[..., sl], y[..., sl], rot[..., sl]
    s = 2.0 * (scene.focal[0] * ux + scene.focal[1] * uy - (xs * ux + ys * uy))
    rx = xs + s * ux
    ry = ys + s * uy
    rrot = 2.0 * scene.focal_rot - rs
    rrot = torch.where(rrot < -pi, rrot + 2 * pi, rrot)
    dp = geo.distance(x[..., None, :], y[..., None, :], rx[..., :, None], ry[..., :, None])
    dt = rot[..., None, :] - rrot[..., :, None]
    dt = torch.where(dt > pi, dt - 2 * pi, dt)
    val = 5.0 - torch.sqrt(dp) - 0.4 * torch.abs(dt)
    val = torch.where(scene.obj_mask > 0, val, C._NEG_HUGE)
    best = torch.clamp_min(torch.amax(val, -1), 0.0)
    return -torch.sum(best * scene.obj_mask[sl], -1)


def _off_limits_rows(pose: Tensor, scene: Scene, mode: CostMode, start: int,
                     rows: int) -> Tensor:
    """Rows ``[start, start + rows)`` of the pairwise (i < j) off-limits
    overlap sum, per chain."""
    mnx, mny, mxx, mxy = C._obj_aabbs(pose, scene, mode)
    sl = slice(start, start + rows)
    area = geo.intersection_area(
        mnx[..., sl, None], mny[..., sl, None], mxx[..., sl, None], mxy[..., sl, None],
        mnx[..., None, :], mny[..., None, :], mxx[..., None, :], mxy[..., None, :],
    )
    n = pose.shape[-2]
    gid = torch.arange(start, start + rows, device=pose.device)
    upper = (torch.arange(n, device=pose.device)[None, :] > gid[:, None]).to(area.dtype)
    m = scene.obj_mask
    return -torch.sum(area * upper * m[sl, None] * m, (-2, -1))


class RowShards:
    """The objs shards of one chain shard: shard ``o`` holds the scene on
    ``devices[o]`` and owns object rows ``[o rows, (o + 1) rows)``; called
    on a pose, it is ``mh_tpu``'s ``rowsharded_breakdown``.

    ``with_off`` says whether the off-limits term is evaluated (FIXED only;
    PARITY leaves it out of the total and reports 0, as the unsharded
    loop does).
    """

    def __init__(self, scene: Scene, mode: CostMode, devices, with_off: bool):
        n = scene.n_pad_objs
        self.rows = local_count(n, len(devices), "padded object count")
        self.devices = list(devices)
        scenes = {}
        for d in self.devices:
            if d not in scenes:
                scenes[d] = scene.to(d)
        self.scenes = [scenes[d] for d in self.devices]
        self.mode, self.with_off = mode, with_off and mode is CostMode.FIXED

    def _reduced(self, fn, pose: Tensor) -> Tensor:
        return psum([fn(pose.to(d), sc, self.mode, o * self.rows, self.rows)
                     for o, (d, sc) in enumerate(zip(self.devices, self.scenes))])[0]

    def __call__(self, pose: Tensor) -> CostBreakdown:
        """The weighted breakdown of ``pose`` f32[..., N, 6] (on the first
        shard's device), the O(N^2) terms row-sharded."""
        cs, mode = self.scenes[0], self.mode
        sym = self._reduced(_symmetry_rows, pose)
        off = self._reduced(_off_limits_rows, pose) if self.with_off else None
        pw = C.pair_wise_costs(pose, cs)
        pwa = C.pair_wise_angle_costs(pose, cs, mode)
        pair = cs.w_pairwise * (pw * pwa if mode is CostMode.PARITY else pw + pwa)
        vb = cs.w_visual_balance * C.visual_balance_costs(pose, cs)
        fp = cs.w_focal * C.focal_point_costs(pose, cs, mode)
        clr = cs.w_clearance * C.clearance_costs(pose, cs, mode)
        sa = cs.w_surface_area * C.surface_area_costs(pose, cs, mode)
        sym_w = cs.w_symmetry * sym
        total = pair + vb + fp + sym_w + clr + sa
        if off is None:
            off_w = torch.zeros_like(pair)
        else:
            off_w = cs.w_offlimits * off
            total = total + off_w
        return CostBreakdown(total=total, pair_wise=pair, visual_balance=vb, focal_point=fp,
                             symmetry=sym_w, clearance=clr, off_limits=off_w, surface_area=sa)


def _one_process(mesh: Mesh) -> Mesh:
    if mesh.spans_processes:
        raise ValueError("the row-sharded objective runs in one process; this mesh spans "
                         "processes (split chains across processes with run_chains_sharded)")
    return mesh


def _grid(mesh: Mesh) -> np.ndarray:
    """The mesh's devices as [chains, objs]; a mesh of the objs axis alone
    is one chain shard."""
    devs, names = _one_process(mesh).devices, mesh.axis_names
    if CHAINS_AXIS not in names:
        devs, names = devs[None], (CHAINS_AXIS, *names)
    if set(names) != {CHAINS_AXIS, OBJS_AXIS} or len(names) != 2:
        raise ValueError(f"a (chains x objs) mesh has exactly those axes, got {mesh.axis_names}")
    return np.moveaxis(devs, [names.index(CHAINS_AXIS), names.index(OBJS_AXIS)], [0, 1])


def cost_terms_sharded(pose: Tensor, scene: Scene, mesh: Mesh,
                       mode: CostMode = CostMode.PARITY) -> CostBreakdown:
    """:func:`~mh_tpu_torch.ops.costs.cost_terms` with the O(N^2) terms
    row-sharded over ``mesh``'s objs axis (the off-limits term evaluated in
    FIXED, as ``cost_terms`` does). Raises where the axis does not divide
    the padded object count. The result lies on the first shard's device."""
    shards = RowShards(scene, mode, _one_process(mesh).axis_devices(OBJS_AXIS), with_off=True)
    return shards(pose.to(shards.devices[0]))


def obj_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh with object rows split along the objs axis (devices as
    :func:`~mh_tpu_torch.parallel.mesh.chain_mesh` takes them)."""
    devices = cuda_devices(n_devices) if devices is None else list(devices)[:n_devices]
    return Mesh(np.array(devices, dtype=object), (OBJS_AXIS,))


def chain_obj_mesh(n_chain: int, n_obj: int, devices=None) -> Mesh:
    """A 2-D (chains x objs) mesh: chains split on one axis, the O(N^2)
    objective row-sharded on the other. ``devices``: ``n_chain * n_obj``
    devices in row-major order (repeats allowed); default the first CUDA
    devices, raising where there is no card."""
    devices = cuda_devices(n_chain * n_obj) if devices is None else list(devices)
    if len(devices) != n_chain * n_obj:
        raise ValueError(f"a {n_chain} x {n_obj} mesh needs {n_chain * n_obj} devices, "
                         f"got {len(devices)}")
    return Mesh(np.array(devices, dtype=object).reshape(n_chain, n_obj), (CHAINS_AXIS, OBJS_AXIS))


def run_chains_objsharded(key: Tensor, pose0: Tensor, scene: Scene, cfg: SamplerConfig,
                          mesh: Mesh):
    """MH chains on a 2-D (chains x objs) mesh: huge-scene sampling.

    Chains split over the chains axis as in
    :func:`~mh_tpu_torch.parallel.sharded.run_chains_sharded` (chain ``c``
    keyed ``fold_in(key, c)``); within a chain shard each step's star pose
    is copied to every objs shard, which scores its row slice of the N x N
    matrices (:class:`RowShards`, the ``cost_fn`` of the step). Proposals
    and accept draws come from the chain's key, so only the order of the
    row sums differs from the unsharded run. Returns the final
    :class:`~mh_tpu_torch.sampler.mh.MHState` (off-limits term filled on
    the final pose, as the unsharded path does) on the first device.
    """
    grid = _grid(mesh)
    n_local = local_count(cfg.n_chains, grid.shape[0], "n_chains")
    steps = shard_steps(scene, cfg, list(grid[:, 0]))
    with_off = not offlimits_unused(scene, cfg.mode)
    cost_fns = [RowShards(scene, cfg.mode, list(row), with_off) for row in grid]
    states = shard_starts(key, pose0, steps, n_local, list(range(len(steps))),
                          cost_fns=cost_fns)
    states = advance(steps, states, cfg.iterations, cost_fns=cost_fns)
    return concat_states([st.finalize(s) for st, s in zip(steps, states)])
