"""Device meshes and the collectives of the sharded runners.

Counterpart of ``mh_tpu.parallel.mesh``. ``mh_tpu`` runs one program per
device under ``shard_map``; the port drives the shards from Python. A
:class:`Mesh` is an array of ``torch.device`` with named axes; one that
spans processes also records the process that owns each shard (a mesh
without ranks is every shard this process's). A runner loops over
this process's own shards step by step (each shard's tensors live on its
device, so its work queues there), and the collectives are explicit
functions over the list of this process's per-shard tensors, in shard
order. Within one process (every shard local):

- :func:`psum` / :func:`pmax` reduce the partials in global shard order on
  the first shard's device and hand every shard the same bits;
- :func:`all_gather` is ``torch.cat`` in shard order (``tiled=True``);
- :func:`ppermute` moves each shard's tensor to its destination's device.

A mesh that spans processes (:func:`~mh_tpu_torch.parallel.multihost.global_chain_mesh`,
after :func:`~mh_tpu_torch.parallel.multihost.initialize`) runs the same
collectives over ``torch.distributed``: :func:`psum` and :func:`pmax`
gather every shard's partial (``dist.all_gather``) and reduce them in the
same global shard order, so they give one process's bits (never
``dist.all_reduce``, whose ring order is not shard order). They reduce
over the chains axis; :func:`psum` also over another axis of a 1-D mesh
(the row-sharded objective's objs axis, one chain row's shards) within the
process group of the processes that own its shards (:func:`process_group`);
:func:`all_gather` joins the gathered parts in shard order; and
:func:`ppermute` copies the pairs whose two shards live in one process
and sends the others with ``dist.batch_isend_irecv``. On the ``gloo``
backend CUDA tensors are staged through host memory explicitly.

A mesh may name one device more than once (``["cpu"] * 8``, ``["cuda:0"] *
4``): the port's counterpart of the 8 virtual CPU devices ``mh_tpu``'s
tests run on. On a host with several cards :func:`chain_mesh` spans them
all and the copies go device to device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

Tensor = torch.Tensor

CHAINS_AXIS = "chains"


def process_index() -> int:
    """This process's rank in the default process group (0 without one)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices on named axes: ``devices`` is an object array of
    ``torch.device`` with one dimension per name in ``axis_names``;
    ``processes`` (same shape) the rank of the process that owns each
    shard, None where every shard is this process's (a mesh within one
    process; only :func:`~mh_tpu_torch.parallel.multihost.global_chain_mesh`
    sets ranks)."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    processes: np.ndarray | None = None

    def __post_init__(self):
        devs = np.array(self.devices, dtype=object)
        flat = [torch.device(d) for d in devs.flat]
        devs = np.empty(devs.shape, dtype=object)
        devs.flat[:] = flat
        names = tuple(self.axis_names)
        if devs.ndim != len(names) or len(set(names)) != len(names) or devs.size == 0:
            raise ValueError(f"a mesh of shape {devs.shape} needs {devs.ndim} distinct axis "
                             f"names, got {names}")
        if self.processes is not None:
            procs = np.asarray(self.processes, dtype=np.int64)
            if procs.shape != devs.shape:
                raise ValueError(f"processes of shape {procs.shape} for devices of shape "
                                 f"{devs.shape}")
            object.__setattr__(self, "processes", procs)
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def spans_processes(self) -> bool:
        """Whether other processes own some of the shards."""
        return self.processes is not None and bool((self.processes != process_index()).any())

    def _along(self, axis: str, arr: np.ndarray) -> np.ndarray:
        """``arr``'s entries along ``axis``, at index 0 of every other axis."""
        lead = np.moveaxis(arr, self.axis_names.index(axis), 0)
        return lead.reshape(lead.shape[0], -1)[:, 0]

    def axis_processes(self, axis: str) -> list[int]:
        """The owning process of each shard along ``axis``, in shard order
        (this process for every shard of a mesh within one process)."""
        if self.processes is None:
            return [process_index()] * self.shape.get(axis, 1)
        if axis not in self.axis_names:
            return [int(self.processes.flat[0])]
        return [int(p) for p in self._along(axis, self.processes)]

    def axis_shards(self, axis: str) -> list[int]:
        """The global indices along ``axis`` of this process's shards."""
        me = process_index()
        return [i for i, p in enumerate(self.axis_processes(axis)) if p == me]

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices of this process's shards along ``axis`` (at index 0
        of every other axis), in shard order; a mesh without the axis is
        one shard on its first device."""
        if axis not in self.axis_names:
            return [self.devices.flat[0]]
        along = self._along(axis, self.devices)
        return [along[i] for i in self.axis_shards(axis)]


def chain_shards(mesh: Mesh | None, device) -> tuple[list[int], list[torch.device], int]:
    """``(global indices, devices)`` of this process's shards along the
    chains axis, and the number of shards on that axis in all processes;
    ``mesh=None`` is one shard on ``device``."""
    if mesh is None:
        return [0], [torch.device(device)], 1
    return (mesh.axis_shards(CHAINS_AXIS), mesh.axis_devices(CHAINS_AXIS),
            mesh.shape.get(CHAINS_AXIS, 1))


def cuda_devices(n: int | None) -> list[torch.device]:
    """The first ``n`` CUDA devices (default: all); raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices=['cpu'] * k for a mesh on the CPU")
    count = torch.cuda.device_count()
    n = count if n is None else n
    if not 1 <= n <= count:
        raise ValueError(f"asked for {n} CUDA devices; {count} are visible")
    return [torch.device("cuda", i) for i in range(n)]


def chain_mesh(n_devices: int | None = None, devices=None, axis: str = CHAINS_AXIS) -> Mesh:
    """A 1-D mesh with the chains split along ``axis``.

    ``devices`` (names or ``torch.device``, repeats allowed) places the
    shards; without it the mesh spans the first ``n_devices`` CUDA devices
    (default: all) and raises where there is no card.
    """
    if devices is None:
        devices = cuda_devices(n_devices)
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    return Mesh(np.array(list(devices), dtype=object), (axis,))


def local_count(total: int, n_shards: int, what: str) -> int:
    """``total / n_shards``; raises where the shards do not divide it."""
    if total % n_shards:
        raise ValueError(f"{what}={total} not divisible by mesh size {n_shards}")
    return total // n_shards


def split_rows(t: Tensor, devices: list[torch.device]) -> list[Tensor]:
    """A leading-dim tensor cut into ``len(devices)`` contiguous shards,
    shard ``d`` on ``devices[d]``."""
    n = local_count(t.shape[0], len(devices), "leading size")
    return [t[d * n:(d + 1) * n].to(dev) for d, dev in enumerate(devices)]


def concat(parts: list[Tensor]) -> Tensor:
    """The shards joined in shard order on the first shard's device."""
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts])


def _staged(t: Tensor) -> Tensor:
    """``t`` as the process group's backend takes it: gloo moves CUDA
    tensors through host memory, NCCL takes them where they are (a CPU
    tensor through this process's current card)."""
    if dist.get_backend() == "gloo":
        return t.cpu()
    return t if t.is_cuda else t.to(torch.device("cuda", torch.cuda.current_device()))


def gather_processes(t: Tensor, sizes: list[int] | None = None, group=None) -> list[Tensor]:
    """Every process's ``t`` in process order, each on ``t``'s device.

    The leading sizes may differ (``sizes``: each process's, exchanged
    where not given): each process pads its ``t`` to the largest, and
    ``dist.all_gather`` hands every process every padded copy. ``group``:
    the processes taking part (:func:`process_group`), default all."""
    world = dist.get_world_size(group)
    if sizes is None:
        sizes = [None] * world
        dist.all_gather_object(sizes, t.shape[0], group=group)
    mine = t.contiguous()
    if t.shape[0] < max(sizes):
        mine = torch.cat([mine, mine.new_zeros((max(sizes) - t.shape[0], *t.shape[1:]))])
    mine = _staged(mine)
    parts = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(parts, mine, group=group)
    return [p[:n].to(t.device) for p, n in zip(parts, sizes)]


_GROUPS: dict = {}  # sorted ranks -> process group, for the default group in "world"


def process_group(ranks):
    """The process group of ``ranks``: None (the default group) where they
    are every process, else a ``dist.new_group`` made at the first call and
    kept. ``dist.new_group`` is collective over every process, members or
    not: every process calls this with the same ranks in the same order."""
    ranks = tuple(sorted(set(int(r) for r in ranks)))
    if ranks == tuple(range(dist.get_world_size())):
        return None
    if _GROUPS.get("world") is not dist.group.WORLD:  # a new default group
        _GROUPS.clear()
        _GROUPS["world"] = dist.group.WORLD
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


def _spanning(mesh: Mesh | None, axis: str = CHAINS_AXIS, group=None) -> list[int] | None:
    """The processes of ``axis``'s shards where the mesh spans processes
    (every process of ``group``, default all, must own a shard), else None."""
    if mesh is None or not mesh.spans_processes:
        return None
    procs = mesh.axis_processes(axis)
    members = (range(dist.get_world_size()) if group is None
               else dist.get_process_group_ranks(group))
    if set(procs) != set(members):
        raise ValueError(f"a mesh whose {axis} shards live in processes {sorted(set(procs))} "
                         f"does not match the {len(members)} processes {sorted(members)} "
                         "of its process group")
    return procs


def _gather_shards(parts: list[Tensor], procs: list[int], group=None) -> list[Tensor]:
    """Every shard's part, in global shard order, on ``parts[0]``'s device:
    each process's parts stacked and gathered within ``group``
    (:func:`gather_processes`); the mesh says which process holds which
    shard, so nothing else travels."""
    members = sorted(set(procs))  # the group's ranks, in its order
    home = parts[0].device
    stacks = gather_processes(torch.stack([p.to(home) for p in parts]),
                              [procs.count(r) for r in members], group)
    stacks = dict(zip(members, stacks))
    seen = dict.fromkeys(members, 0)
    out = []
    for r in procs:
        out.append(stacks[r][seen[r]])
        seen[r] += 1
    return out


def _reduce(parts: list[Tensor], op, mesh: Mesh | None, axis: str, group) -> list[Tensor]:
    procs = _spanning(mesh, axis, group)
    every = parts if procs is None else _gather_shards(parts, procs, group)
    acc = every[0]
    for p in every[1:]:
        acc = op(acc, p.to(acc.device))
    return [acc.to(p.device) for p in parts]


def psum(parts: list[Tensor], mesh: Mesh | None = None, axis: str = CHAINS_AXIS,
         group=None) -> list[Tensor]:
    """The sum over ``mesh``'s shards along ``axis``, added in global shard
    order; every shard of this process gets the same bits (one shard: its
    own tensor). ``parts``: this process's shards' tensors in shard order;
    without a mesh, or on a mesh within this process, every shard's. Where
    the mesh spans processes, ``group`` is the process group of the
    processes that own ``axis``'s shards (:func:`process_group`; default
    every process)."""
    return _reduce(parts, torch.add, mesh, axis, group)


def pmax(parts: list[Tensor], mesh: Mesh | None = None) -> list[Tensor]:
    """The maximum over the chains shards, on every shard (``parts`` as
    :func:`psum`)."""
    return _reduce(parts, torch.maximum, mesh, CHAINS_AXIS, None)


def all_gather(parts: list[Tensor], mesh: Mesh | None = None) -> list[Tensor]:
    """Every shard's tensor joined along dim 0 in global shard order
    (``all_gather(tiled=True)``), on every shard of this process."""
    procs = _spanning(mesh)
    whole = concat(parts if procs is None else _gather_shards(parts, procs))
    return [whole.to(p.device) for p in parts]


def ppermute(parts: list[Tensor], perm, mesh: Mesh | None = None) -> list[Tensor]:
    """``perm``: (source, destination) pairs of global shard indices; each
    destination of this process gets its source's tensor on its own
    device, a shard no pair names zeros. Pairs within this process are
    copies; the others go through ``dist.batch_isend_irecv``, each process
    posting its sends and receives in ``perm``'s order, so the messages
    between two processes match one for one."""
    procs = _spanning(mesh)
    shards = range(len(parts)) if procs is None else mesh.axis_shards(CHAINS_AXIS)
    at = {g: j for j, g in enumerate(shards)}  # global shard -> position in parts
    out = [torch.zeros_like(p) for p in parts]
    ops, received = [], []
    for src, dst in perm:
        if src in at and dst in at:
            out[at[dst]] = parts[at[src]].to(parts[at[dst]].device)
        elif src in at:
            ops.append(dist.P2POp(dist.isend, _staged(parts[at[src]]).contiguous(), procs[dst]))
        elif dst in at:
            buf = _staged(torch.empty_like(parts[at[dst]]))
            ops.append(dist.P2POp(dist.irecv, buf, procs[src]))
            received.append((at[dst], buf))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for j, buf in received:
        out[j] = buf.to(parts[j].device)
    return out


def device_report() -> str:
    """Human-readable report of the CUDA devices and the default chain mesh."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    lines = [
        f"backend: {'cuda' if n else 'cpu'} (torch {torch.__version__}, CUDA {torch.version.cuda})",
        f"{n} CUDA devices",
    ]
    for i in range(n):
        lines.append(f"  device {i}: cuda ({torch.cuda.get_device_name(i)})")
    if n:
        lines.append(f"chain mesh: {n} devices on axis '{CHAINS_AXIS}' (chain_mesh())")
    else:
        lines.append("chain mesh: none without a CUDA device (a mesh on the CPU: "
                     "chain_mesh(devices=['cpu'] * k))")
    return "\n".join(lines)
