"""Object-axis sharded costs: the row-sharded objective for huge scenes.

Counterpart of ``mh_tpu.parallel.objshard``. The O(N^2) terms (symmetry's
best matches, ``Kernel.cu:283-318``; FIXED off-limits overlaps,
``:485-514``) are split by rows over a mesh's objs axis: every objs shard
holds a copy of the pose (O(N)) and the scene, and evaluates its
``N / k``-row slice of each pairwise matrix; the per-chain partial sums
are reduced with :func:`~mh_tpu_torch.parallel.mesh.psum` in global shard
order. The O(N) terms are computed once per chain row in each process
that holds a shard of it, on its first objs shard's device. This is the
path past the fused kernel's shared-memory limit (2,594 objects with 2
clearances): no shard holds a chain's whole N x N matrices. Results equal
:func:`~mh_tpu_torch.ops.costs.cost_terms` up to the order of the row sums.

After :func:`~mh_tpu_torch.parallel.multihost.initialize`, :func:`obj_mesh`
and :func:`chain_obj_mesh` span every process's devices, process-major,
as ``mh_tpu``'s span ``jax.devices()``; either axis may cross processes.
A chain row whose shards live in several processes reduces its partials
within the process group of those processes (one ``dist.new_group`` per
such row, made in every process in row order, so each process issues its
rows' collectives in one order and two rows never wait on each other),
gathered with ``dist.all_gather`` and added in global shard order. Every
process holding a shard of the row gets the same sums, so its copy of the
row's poses stays in lockstep with the others' (proposals and accepts are
keyed by global chain id), as ``mh_tpu``'s replicas do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from mh_tpu_torch.config import CostMode, SamplerConfig
from mh_tpu_torch.models.scene import Scene
from mh_tpu_torch.ops import costs as C
from mh_tpu_torch.ops import geometry as geo
from mh_tpu_torch.ops.costs import CostBreakdown, offlimits_unused
from mh_tpu_torch.parallel.mesh import (
    CHAINS_AXIS, Mesh, cuda_devices, local_count, process_group, process_index, psum,
)
from mh_tpu_torch.parallel.multihost import global_devices
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
    """This process's objs shards of one chain row: objs shard ``o`` (its
    global index along the row) holds the scene on its device and owns
    object rows ``[o rows, (o + 1) rows)``; called on a pose, it is
    ``mh_tpu``'s ``rowsharded_breakdown``.

    ``row`` is the chain row as a 1-D objs :class:`Mesh` (with the owning
    process of each shard where it spans processes), ``group`` the process
    group of its processes (:func:`~mh_tpu_torch.parallel.mesh.process_group`).
    ``with_off`` says whether the off-limits term is evaluated (FIXED only;
    PARITY leaves it out of the total and reports 0, as the unsharded
    loop does).
    """

    def __init__(self, scene: Scene, mode: CostMode, row: Mesh, with_off: bool, group=None):
        n = scene.n_pad_objs
        self.rows = local_count(n, row.shape[OBJS_AXIS], "padded object count")
        self.row, self.group = row, group
        self.devices = row.axis_devices(OBJS_AXIS)
        self.starts = [o * self.rows for o in row.axis_shards(OBJS_AXIS)]
        scenes = {}
        for d in self.devices:
            if d not in scenes:
                scenes[d] = scene.to(d)
        self.scenes = [scenes[d] for d in self.devices]
        self.mode, self.with_off = mode, with_off and mode is CostMode.FIXED

    def _reduced(self, pose: Tensor) -> Tensor:
        """The row's O(N^2) sums, [1 or 2, ...]: symmetry, then off-limits
        where evaluated; one reduction over the row's shards for both."""
        fns = (_symmetry_rows, _off_limits_rows) if self.with_off else (_symmetry_rows,)
        parts = []
        for start, d, sc in zip(self.starts, self.devices, self.scenes):
            p = pose.to(d)
            parts.append(torch.stack([fn(p, sc, self.mode, start, self.rows) for fn in fns]))
        return psum(parts, self.row, OBJS_AXIS, self.group)[0]

    def __call__(self, pose: Tensor) -> CostBreakdown:
        """The weighted breakdown of ``pose`` f32[..., N, 6] (on the first
        shard's device), the O(N^2) terms row-sharded."""
        cs, mode = self.scenes[0], self.mode
        reduced = self._reduced(pose)
        sym = reduced[0]
        pw = C.pair_wise_costs(pose, cs)
        pwa = C.pair_wise_angle_costs(pose, cs, mode)
        pair = cs.w_pairwise * (pw * pwa if mode is CostMode.PARITY else pw + pwa)
        vb = cs.w_visual_balance * C.visual_balance_costs(pose, cs)
        fp = cs.w_focal * C.focal_point_costs(pose, cs, mode)
        clr = cs.w_clearance * C.clearance_costs(pose, cs, mode)
        sa = cs.w_surface_area * C.surface_area_costs(pose, cs, mode)
        sym_w = cs.w_symmetry * sym
        total = pair + vb + fp + sym_w + clr + sa
        if not self.with_off:
            off_w = torch.zeros_like(pair)
        else:
            off_w = cs.w_offlimits * reduced[1]
            total = total + off_w
        return CostBreakdown(total=total, pair_wise=pair, visual_balance=vb, focal_point=fp,
                             symmetry=sym_w, clearance=clr, off_limits=off_w, surface_area=sa)


def _grid(mesh: Mesh) -> tuple[np.ndarray, np.ndarray | None]:
    """The mesh's devices and their owning processes (None within one
    process) as [chains, objs]; a mesh of the objs axis alone is one chain
    row. Raises where a row mixes device types (its shards would round
    apart), or where a mesh that spans processes leaves one out."""
    devs, procs, names = mesh.devices, mesh.processes, mesh.axis_names
    if CHAINS_AXIS not in names:
        devs, names = devs[None], (CHAINS_AXIS, *names)
        procs = None if procs is None else procs[None]
    if set(names) != {CHAINS_AXIS, OBJS_AXIS} or len(names) != 2:
        raise ValueError(f"a (chains x objs) mesh has exactly those axes, got {mesh.axis_names}")
    order = [names.index(CHAINS_AXIS), names.index(OBJS_AXIS)]
    devs = np.moveaxis(devs, order, [0, 1])
    procs = None if procs is None else np.moveaxis(procs, order, [0, 1])
    for r, row in enumerate(devs):
        if len({d.type for d in row}) > 1:
            raise ValueError(f"chain row {r} mixes device types {[str(d) for d in row]}: "
                             "its shards must be of one type to round alike")
    if mesh.spans_processes:
        left_out = sorted(set(range(dist.get_world_size())) - set(procs.ravel().tolist()))
        if left_out:
            raise ValueError(f"the mesh leaves out processes {left_out}: every process of "
                             "the group must own a shard")
    return devs, procs


def chain_rows(mesh: Mesh) -> list[int]:
    """The chain rows (global indices along the chains axis) that this
    process holds a shard of, in order: :func:`run_chains_objsharded`
    returns their chains, ``n_chains / rows`` each."""
    devs, procs = _grid(mesh)
    me = process_index()
    return [r for r in range(devs.shape[0]) if procs is None or me in procs[r]]


def _rows(mesh: Mesh) -> tuple[list[tuple[int, Mesh, object]], int]:
    """``(chain row, its objs mesh, its process group)`` for each row this
    process holds a shard of, in row order, and the number of rows. Every
    process makes the group of every row that spans processes, in row
    order, as ``dist.new_group`` asks."""
    devs, procs = _grid(mesh)
    me = process_index()
    out = []
    for r in range(devs.shape[0]):
        owners = None if procs is None else procs[r]
        group = None
        if owners is not None and len(set(owners.tolist())) > 1:
            group = process_group(owners.tolist())
        if owners is None or me in owners:
            out.append((r, Mesh(devs[r], (OBJS_AXIS,), processes=owners), group))
    return out, devs.shape[0]


def cost_terms_sharded(pose: Tensor, scene: Scene, mesh: Mesh,
                       mode: CostMode = CostMode.PARITY) -> CostBreakdown:
    """:func:`~mh_tpu_torch.ops.costs.cost_terms` with the O(N^2) terms
    row-sharded over ``mesh``'s objs axis (the off-limits term evaluated in
    FIXED, as ``cost_terms`` does). Raises where the axis does not divide
    the padded object count. The result lies on this process's first shard's
    device. On a mesh that spans processes every process calls it with the
    same ``pose`` and evaluates each chain row it holds a shard of (their
    collectives are shared with those rows' other processes); every process
    returns the same breakdown where the rows' devices are of one type."""
    rows, _ = _rows(mesh)
    if not mesh.spans_processes:
        rows = rows[:1]
    out = []
    for _, row, group in rows:
        shards = RowShards(scene, mode, row, with_off=True, group=group)
        out.append(shards(pose.to(shards.devices[0])))
    return out[0]


def obj_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh with object rows split along the objs axis.

    Within one process, ``devices`` as
    :func:`~mh_tpu_torch.parallel.mesh.chain_mesh` takes them. After
    :func:`~mh_tpu_torch.parallel.multihost.initialize`, every process's
    devices, process-major (``devices``: this process's, as
    :func:`~mh_tpu_torch.parallel.multihost.global_devices` takes them;
    every process must call it), the first ``n_devices`` of them, as
    ``mh_tpu``'s takes ``jax.devices()[:n_devices]``."""
    if not dist.is_initialized():
        devices = cuda_devices(n_devices) if devices is None else list(devices)[:n_devices]
        return Mesh(np.array(devices, dtype=object), (OBJS_AXIS,))
    devices, ranks = global_devices(devices)
    return Mesh(np.array(devices[:n_devices], dtype=object), (OBJS_AXIS,),
                processes=ranks[:n_devices])


def chain_obj_mesh(n_chain: int, n_obj: int, devices=None) -> Mesh:
    """A 2-D (chains x objs) mesh: chains split on one axis, the O(N^2)
    objective row-sharded on the other. ``devices``: ``n_chain * n_obj``
    devices in row-major order (repeats allowed); default the first CUDA
    devices, raising where there is no card. After
    :func:`~mh_tpu_torch.parallel.multihost.initialize` the devices are
    every process's, process-major (``devices``: this process's, as
    :func:`~mh_tpu_torch.parallel.multihost.global_devices` takes them;
    every process must call it), and either axis may span processes."""
    k = n_chain * n_obj
    if dist.is_initialized():
        devices, ranks = global_devices(devices)
    else:
        devices, ranks = (cuda_devices(k) if devices is None else list(devices)), None
    if len(devices) != k:
        raise ValueError(f"a {n_chain} x {n_obj} mesh needs {k} devices, got {len(devices)}"
                         + ("" if ranks is None else " over every process"))
    return Mesh(np.array(devices, dtype=object).reshape(n_chain, n_obj), (CHAINS_AXIS, OBJS_AXIS),
                processes=None if ranks is None else np.reshape(ranks, (n_chain, n_obj)))


def run_chains_objsharded(key: Tensor, pose0: Tensor, scene: Scene, cfg: SamplerConfig,
                          mesh: Mesh):
    """MH chains on a 2-D (chains x objs) mesh: huge-scene sampling.

    Chains split over the chains axis as in
    :func:`~mh_tpu_torch.parallel.sharded.run_chains_sharded` (chain ``c``
    keyed ``fold_in(key, c)``); within a chain row each step's star pose
    is copied to every objs shard, which scores its row slice of the N x N
    matrices (:class:`RowShards`, the ``cost_fn`` of the step). Proposals
    and accept draws come from the chain's key, so only the order of the
    row sums differs from the unsharded run. Returns the final
    :class:`~mh_tpu_torch.sampler.mh.MHState` (off-limits term filled on
    the final pose, as the unsharded path does) of the chain rows this
    process holds a shard of (:func:`chain_rows`; every row within one
    process), on its first device. On a mesh that spans processes every
    process calls it; a row that spans processes comes back from each of
    them, bitwise equal.
    """
    rows, n_rows = _rows(mesh)
    n_local = local_count(cfg.n_chains, n_rows, "n_chains")
    with_off = not offlimits_unused(scene, cfg.mode)
    cost_fns = [RowShards(scene, cfg.mode, row, with_off, group) for _, row, group in rows]
    steps = shard_steps(scene, cfg, [f.devices[0] for f in cost_fns])
    states = shard_starts(key, pose0, steps, n_local, [r for r, _, _ in rows],
                          cost_fns=cost_fns)
    states = advance(steps, states, cfg.iterations, cost_fns=cost_fns)
    return concat_states([st.finalize(s) for st, s in zip(steps, states)])
