"""Checkpoint / resume of sampler state (counterpart of ``mh_tpu.utils.checkpoint``).

A whole :class:`~mh_tpu_torch.sampler.mh.MHState` (pose, cost breakdown,
threefry key words, step counters, adaptation state), or any dataclass,
dict, tuple or list of tensors, round-trips to disk with ``torch.save`` and
``torch.load(weights_only=True)``, so a run resumes exactly where it
stopped: the chain continues bitwise, because the step key folds from the
chain's key and step counter, both in the state. The key is already raw
integer words in the port, so it needs no marker. A file is written next
to its final name and moved there in one step, so a process killed while
saving leaves the previous checkpoint whole.

Per-process shards (:func:`save_local_shards`, :func:`restore_local_shards`):
in a run across processes every process saves only its own rows and, on
restart, reads only its own file; nothing travels between processes.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from mh_tpu_torch.parallel.mesh import process_index

Tensor = torch.Tensor


def flatten(tree, prefix: str = "") -> dict[str, Tensor]:
    """The tensors of a dataclass / dict / tuple / list tree, by path
    (``"costs/total"``), in the tree's order."""
    if isinstance(tree, Tensor):
        return {prefix: tree}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree) if f.init]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (tuple, list)):
        items = list(enumerate(tree))
    else:
        raise TypeError(f"cannot save a {type(tree).__name__} at {prefix or 'the root'!r}")
    out = {}
    for name, sub in items:
        out.update(flatten(sub, f"{prefix}/{name}" if prefix else str(name)))
    return out


def tree_map(fn, tree):
    """``tree`` with every tensor ``t`` replaced by ``fn(t)``."""
    if isinstance(tree, Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    raise TypeError(f"cannot restore a {type(tree).__name__}")


def _write(path: str, tree) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({k: t.detach().cpu() for k, t in flatten(tree).items()}, tmp)
    os.replace(tmp, path)


def _read(path: str, template):
    """``template``'s tree with the tensors of ``path``, each on its
    template tensor's device; raises where a name, shape or dtype differs."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    want = flatten(template)
    if set(saved) != set(want):
        raise ValueError(f"{path} holds {sorted(saved)}, the template {sorted(want)}")
    for name, t in want.items():
        if saved[name].shape != t.shape or saved[name].dtype != t.dtype:
            raise ValueError(f"{path}: {name} is {saved[name].dtype}{list(saved[name].shape)}, "
                             f"the template's {t.dtype}{list(t.shape)}")
    names = iter(want)
    return tree_map(lambda t: saved[next(names)].to(t.device), template)


def save_state(path: str, state, log=None) -> None:
    """Save a sampler state (an ``MHState`` or any tree of tensors) to
    ``<path>.pt``.

    ``log``: optional :class:`~mh_tpu_torch.utils.runlog.RunLogger`, given
    a ``checkpoint`` event (op=save, with the state's largest step).
    """
    path = os.path.abspath(path)
    _write(f"{path}.pt", state)
    if log is not None:
        step = getattr(state, "step", None)
        log.log_checkpoint("save", path, **({} if step is None else {"step": int(step.max())}))


def restore_state(path: str, template, log=None):
    """Restore a state saved by :func:`save_state`; ``template`` gives the
    structure, shapes and dtypes, and each tensor's device."""
    path = os.path.abspath(path)
    restored = _read(f"{path}.pt", template)
    if log is not None:
        log.log_checkpoint("restore", path)
    return restored


def _shard_path(path: str) -> str:
    """The file of this process's rows."""
    return f"{os.path.abspath(path)}.proc{process_index()}.pt"


def save_local_shards(path: str, state) -> None:
    """Save this process's rows of a chains-sharded state (what the sharded
    runners return in this process) to ``<path>.proc<rank>.pt``."""
    _write(_shard_path(path), state)


def restore_local_shards(path: str, template):
    """This process's rows saved by :func:`save_local_shards`, onto the
    template's devices. ``template`` is a state of this process's rows
    (structure, shapes and dtypes); each process reads only its own file.
    :func:`~mh_tpu_torch.parallel.sharded.continue_chains_sharded` cuts the
    rows into this process's shards of the new mesh."""
    return _read(_shard_path(path), template)
