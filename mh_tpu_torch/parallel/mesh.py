"""Device meshes and the collectives of the sharded runners.

Counterpart of ``mh_tpu.parallel.mesh``. ``mh_tpu`` runs one program per
device under ``shard_map`` with one controller; the port keeps that model
in one process: a :class:`Mesh` is an array of ``torch.device`` with named
axes, a sharded runner is a Python loop over the shards (each shard's
tensors live on its device, so its work queues there), and the collectives
are explicit functions over the list of per-shard tensors, in shard order:

- :func:`psum` / :func:`pmax` reduce the partials in global shard order on
  the first shard's device and hand every shard the same bits;
- :func:`all_gather` is ``torch.cat`` in shard order (``tiled=True``);
- :func:`ppermute` moves each shard's tensor to its destination's device.

A mesh may name one device more than once (``["cpu"] * 8``, ``["cuda:0"] *
4``): the port's counterpart of the 8 virtual CPU devices ``mh_tpu``'s
tests run on. On a host with several cards :func:`chain_mesh` spans them
all and the copies go device to device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

Tensor = torch.Tensor

CHAINS_AXIS = "chains"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices on named axes: ``devices`` is an object array of
    ``torch.device`` with one dimension per name in ``axis_names``."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        devs = np.array(self.devices, dtype=object)
        flat = [torch.device(d) for d in devs.flat]
        devs = np.empty(devs.shape, dtype=object)
        devs.flat[:] = flat
        names = tuple(self.axis_names)
        if devs.ndim != len(names) or len(set(names)) != len(names) or devs.size == 0:
            raise ValueError(f"a mesh of shape {devs.shape} needs {devs.ndim} distinct axis "
                             f"names, got {names}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "axis_names", names)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` (at index 0 of every other axis); a
        mesh without the axis is one shard on its first device."""
        if axis not in self.axis_names:
            return [self.devices.flat[0]]
        lead = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        return list(lead.reshape(lead.shape[0], -1)[:, 0])


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


def _reduce(parts: list[Tensor], op) -> list[Tensor]:
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p.to(acc.device))
    return [acc.to(p.device) for p in parts]


def psum(parts: list[Tensor]) -> list[Tensor]:
    """The sum over shards, added in shard order on the first shard's
    device; every shard gets the same bits (one shard: its own tensor)."""
    return _reduce(parts, torch.add)


def pmax(parts: list[Tensor]) -> list[Tensor]:
    """The maximum over shards, on every shard."""
    return _reduce(parts, torch.maximum)


def all_gather(parts: list[Tensor]) -> list[Tensor]:
    """Every shard's tensor joined along dim 0 in shard order
    (``all_gather(tiled=True)``), on every shard."""
    whole = concat(parts)
    return [whole.to(p.device) for p in parts]


def ppermute(parts: list[Tensor], perm) -> list[Tensor]:
    """``perm``: (source, destination) shard pairs; each destination gets
    its source's tensor on its own device, a shard no pair names zeros."""
    out = [torch.zeros_like(p) for p in parts]
    for src, dst in perm:
        out[dst] = parts[src].to(parts[dst].device)
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
