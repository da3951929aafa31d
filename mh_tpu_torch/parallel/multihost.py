"""Runs across processes over ``torch.distributed`` (counterpart of ``mh_tpu.parallel.multihost``).

``mh_tpu`` spans hosts with ``jax.distributed``; the port spans processes
the way PyTorch users run several cards, one process per card or several
processes sharing one (``torchrun --nproc-per-node K``, or
:func:`initialize` by hand). Call :func:`initialize` once per process
before any collective, build the mesh over every process's devices with
:func:`global_chain_mesh` (or, for the row-sharded objective,
:func:`~mh_tpu_torch.parallel.objshard.obj_mesh` /
:func:`~mh_tpu_torch.parallel.objshard.chain_obj_mesh`), and call the
sharded runners (:mod:`mh_tpu_torch.parallel.sharded`,
``run_chains_fused_sharded``, ``run_tempered``, ``run_smc``,
``run_chains_objsharded``, ``cost_terms_sharded``) in every process: each
steps its own shards, every chain keyed by its global index, so the result
is bitwise that of one process on the same shards.

The backend: ``nccl`` where no card is named by two processes, ``gloo``
otherwise (NCCL refuses two ranks on one card) and where there is no card.
:func:`initialize` decides before any process has named its devices, so
with ``backend=None`` it counts: ``nccl`` where the host has a card for
each of its processes, each process then taking card ``LOCAL_RANK`` (what
:func:`global_chain_mesh` names by default), ``gloo`` where there are
fewer cards than processes. Processes that share a card on a host with
enough cards (each naming ``cuda:0``) pass ``backend="gloo"``: under
``nccl`` :func:`global_chain_mesh` raises on a card named by two. On
``gloo`` the compute stays on the cards; only the collectives' few bytes
go through host memory, staged there explicitly. Nothing falls back from
one backend to the other, and asking for ``nccl`` with more processes than
cards raises.

Recovery: on a failure restart every process, call :func:`initialize`
again, restore each process's rows with
:func:`~mh_tpu_torch.utils.checkpoint.restore_local_shards`, and continue
with :func:`~mh_tpu_torch.parallel.sharded.continue_chains_sharded`: the
chains resume bitwise.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from mh_tpu_torch.parallel.mesh import CHAINS_AXIS, Mesh, cuda_devices, gather_processes

Tensor = torch.Tensor


def choose_backend(requested: str | None, local_processes: int,
                   cards: int) -> tuple[str, str]:
    """``(backend, reason)`` for ``local_processes`` processes on a host
    with ``cards`` CUDA cards: ``nccl`` where each process can have a card
    of its own (card ``LOCAL_RANK``), ``gloo`` where there is no card or
    two processes must share one. A ``requested`` backend is kept;
    ``nccl`` raises where it cannot run. The rule counts, as no process
    has named its devices yet: processes that will name one card between
    them on a host with enough cards ask for ``gloo``."""
    if requested not in (None, "nccl", "gloo"):
        raise ValueError(f"backend={requested!r} (use 'nccl' or 'gloo')")
    shared = local_processes > cards
    if requested == "gloo":
        return "gloo", "asked for"
    if requested == "nccl":
        if not cards:
            raise ValueError("nccl needs a CUDA card; this host has none")
        if shared:
            raise ValueError(f"nccl cannot put two ranks on one card: {local_processes} "
                             f"processes on this host, {cards} cards")
        return "nccl", "asked for"
    if not cards:
        return "gloo", "no CUDA card on this host"
    if shared:
        return "gloo", (f"{local_processes} processes share this host's {cards} card(s); "
                        "nccl refuses two ranks on one card")
    return "nccl", f"{local_processes} processes, {cards} cards: one card each"


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None):
    """Join the process group of a run across processes.

    ``coordinator_address`` is ``host:port`` of process 0; with no
    arguments the process reads torchrun's variables (``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; ``LOCAL_WORLD_SIZE`` and
    ``LOCAL_RANK`` say which processes share this host, default: all of
    them). A no-op, returning None, where there is nothing to coordinate
    (no address and at most one process). Otherwise it picks the backend
    (:func:`choose_backend`), makes the process's own card current under
    ``nccl``, calls ``init_process_group(init_method="tcp://<address>")``
    and returns ``(backend, reason)``.
    """
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes in (None, 1):
        return None  # one process: nothing to coordinate
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a run across processes needs the coordinator's address, the number "
                         "of processes and this process's id")
    local = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    chosen = choose_backend(backend, local, cards)
    if chosen[0] == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id % local)))
    dist.init_process_group(chosen[0], init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return chosen


def global_devices(devices=None) -> tuple[list[torch.device], list[int] | None]:
    """Every process's shards, process 0's first, and the rank owning each.

    ``devices`` (names or ``torch.device``, repeats allowed) are this
    process's shards. Without it a process on ``nccl`` takes its own card
    and one on ``gloo`` every card it sees, raising where there is none,
    as :func:`~mh_tpu_torch.parallel.mesh.chain_mesh` does. Every process
    must call it (the device lists are exchanged). Under ``nccl`` a card
    named by two processes raises (initialize with ``backend="gloo"`` to
    share cards). Without a process group: this process's devices, and
    None for the ranks."""
    on_nccl = dist.is_initialized() and dist.get_backend() == "nccl"
    if devices is None:
        devices = ([torch.device("cuda", torch.cuda.current_device())] if on_nccl
                   else cuda_devices(None))
    devices = [torch.device(d) for d in devices]
    if not dist.is_initialized():
        return devices, None
    lists = [None] * dist.get_world_size()
    dist.all_gather_object(lists, (socket.gethostname(), [str(d) for d in devices]))
    if on_nccl:
        owners = {}
        for rank, (host, names) in enumerate(lists):
            for name in names:
                dev = torch.device(name)
                card = (host, dev.index if dev.index is not None else 0)
                if dev.type == "cuda" and owners.setdefault(card, rank) != rank:
                    raise ValueError(f"processes {owners[card]} and {rank} both name {name} on "
                                     f"{host}: nccl cannot put two ranks on one card "
                                     "(initialize with backend='gloo' to share it)")
    flat = [(torch.device(n), rank) for rank, (_, names) in enumerate(lists) for n in names]
    return [d for d, _ in flat], [r for _, r in flat]


def global_chain_mesh(devices=None) -> Mesh:
    """A 1-D mesh over every process's devices, chains split along its
    chains axis: process 0's shards, then process 1's, and so on
    (:func:`global_devices`; every process must call it). Without a
    process group it is ``chain_mesh(devices=devices)``."""
    devices, ranks = global_devices(devices)
    devs = np.empty(len(devices), dtype=object)
    devs[:] = devices
    return Mesh(devs, (CHAINS_AXIS,), processes=ranks)


def process_allgather(t: Tensor) -> Tensor:
    """Every process's ``t`` joined along dim 0 in process order, on
    ``t``'s device (``multihost_utils.process_allgather(..., tiled=True)``);
    ``t`` itself without a process group. The leading sizes may differ."""
    if not dist.is_initialized():
        return t
    return torch.cat(gather_processes(t))
