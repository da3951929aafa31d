"""Chains sharded over a mesh (counterpart of ``mh_tpu.parallel.sharded``).

``mh_tpu`` runs ``vmap(chain)`` on each device under ``shard_map``; here
each shard is a batch of chains on its own device, stepped by the
:class:`~mh_tpu_torch.sampler.mh.ChainStep` of its device (one per distinct
device, the scene copied there once), and each process loops over its own
shards step by step, so shards on different cards run at once. Chain ``c``
is keyed by ``fold_in(key, c)`` from its global index (shard ``d`` runs
chains ``d n_local ..`` with ``d`` its index in the whole mesh), so a run
is bitwise the same on any number of shards and processes. Collective
adaptation sums the rounds' accept counts over every shard with
:func:`~mh_tpu_torch.parallel.mesh.psum` and sets one shared step scale on
every chain. The runners return this process's rows, chains leading, on
its first shard's device (:func:`~mh_tpu_torch.parallel.multihost.process_allgather`
joins every process's).
"""

from __future__ import annotations

import dataclasses

import torch

from mh_tpu_torch.config import SamplerConfig
from mh_tpu_torch.models.scene import Scene
from mh_tpu_torch.ops.costs import CostBreakdown
from mh_tpu_torch.parallel.mesh import Mesh, chain_shards, concat, local_count, psum
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.mh import _COST_FIELDS, ChainStep, MHState, chain_starts

Tensor = torch.Tensor


def shard_steps(scene: Scene, cfg: SamplerConfig, devices) -> list[ChainStep]:
    """The ChainStep of each shard's device, one per distinct device."""
    steps = {}
    for d in devices:
        if d not in steps:
            steps[d] = ChainStep(scene.to(d), cfg)
    return [steps[d] for d in devices]


def shard_starts(key: Tensor, pose0: Tensor, steps: list[ChainStep], n_local: int,
                 shard_ids: list[int], cost_fns=None) -> list[MHState]:
    """The initial states of each shard's chains ``d n_local ..``, keyed by
    their global indices; ``shard_ids[j]`` is ``d`` of ``steps[j]``'s shard."""
    return [st.init(*chain_starts(key, pose0, st.scene, n_local, d * n_local),
                    cost_fn=None if cost_fns is None else cost_fns[j])
            for j, (d, st) in enumerate(zip(shard_ids, steps))]


def advance(steps: list[ChainStep], states: list[MHState], n: int, cost_fns=None,
            betas=None) -> list[MHState]:
    """``n`` steps of every shard, shard after shard within each step."""
    for _ in range(n):
        states = [st(s, beta=None if betas is None else betas[d],
                     cost_fn=None if cost_fns is None else cost_fns[d])
                  for d, (st, s) in enumerate(zip(steps, states))]
    return states


def concat_states(parts: list[MHState]) -> MHState:
    """The shards' states joined, chains in shard order, on the first
    shard's device."""
    costs = CostBreakdown(*(concat([getattr(s.costs, f) for s in parts]) for f in _COST_FIELDS))
    return MHState(
        pose=concat([s.pose for s in parts]), costs=costs, key=concat([s.key for s in parts]),
        step=concat([s.step for s in parts]), n_accept=concat([s.n_accept for s in parts]),
        log_scale=concat([s.log_scale for s in parts]))


def run_chains_sharded(key: Tensor, pose0: Tensor, scene: Scene, cfg: SamplerConfig,
                       mesh: Mesh) -> MHState:
    """``cfg.n_chains`` independent chains split over ``mesh``'s chains axis.

    Shard ``d`` runs chains ``d n_local .. (d + 1) n_local - 1``, keyed
    ``fold_in(key, d n_local + i)``, so the result is bitwise that of
    :func:`~mh_tpu_torch.sampler.mh.run_chains` on one shard. Returns the
    final :class:`MHState` of this process's shards, chains leading, on
    its first shard's device (every chain on a mesh within one process).
    """
    ids, devices, n_shards = chain_shards(mesh, scene.device)
    n_local = local_count(cfg.n_chains, n_shards, "n_chains")
    steps = shard_steps(scene, cfg, devices)
    states = advance(steps, shard_starts(key, pose0, steps, n_local, ids), cfg.iterations)
    return concat_states([st.finalize(s) for st, s in zip(steps, states)])


def continue_chains_sharded(states: MHState, scene: Scene, cfg: SamplerConfig,
                            mesh: Mesh) -> MHState:
    """``cfg.iterations`` more steps of this process's chains, split over
    its shards of ``mesh``; bitwise equal to an uninterrupted sharded run,
    as the step keys fold from each chain's own key and step counter.

    ``states``: this process's rows, chains leading (what the runners or
    :func:`~mh_tpu_torch.utils.checkpoint.restore_local_shards` return; on
    a mesh within one process every chain, e.g. an ``mh_tpu`` checkpoint
    carried in by ``mh_state_from_numpy``).
    """
    devices = chain_shards(mesh, scene.device)[1]
    n = local_count(states.pose.shape[0], len(devices), "n_chains")
    steps = shard_steps(scene, cfg, devices)
    parts = [states.map(lambda t, d=d, dev=dev: t[d * n:(d + 1) * n].to(dev))
             for d, dev in enumerate(devices)]
    parts = advance(steps, parts, cfg.iterations)
    return concat_states([st.finalize(s) for st, s in zip(steps, parts)])


def run_chains_collective(key: Tensor, pose0: Tensor, scene: Scene, cfg: SamplerConfig,
                          mesh: Mesh, rounds: int = 10, steps_per_round: int = 10):
    """Chains with collective step-size adaptation (BASELINE config 4).

    Each round every chain runs ``steps_per_round`` steps; the round's
    accept counts are summed over the shards (:func:`psum`) and drive one
    shared Robbins-Monro update of ``log_scale``, set on every chain at the
    start of the next round. Returns ``(states, rates f32[rounds],
    log_scale f32[])`` on this process's first shard's device, ``states``
    this process's chains.
    """
    ids, devices, n_shards = chain_shards(mesh, scene.device)
    n_local = local_count(cfg.n_chains, n_shards, "n_chains")
    steps = shard_steps(scene, cfg, devices)
    states = shard_starts(key, pose0, steps, n_local, ids)
    scale = prng.reciprocal(cfg.n_chains * steps_per_round)
    log_scales = [torch.zeros((), dtype=torch.float32, device=d) for d in devices]
    rates = []
    for _ in range(rounds):
        states = [dataclasses.replace(s, log_scale=ls.expand(n_local))
                  for s, ls in zip(states, log_scales)]
        before = [s.n_accept for s in states]
        states = advance(steps, states, steps_per_round)
        accepted = psum([torch.sum(s.n_accept - b).to(torch.float32)
                         for s, b in zip(states, before)], mesh)
        rate = [a * scale for a in accepted]
        log_scales = [ls + st.adapt_rate * (r - st.target_accept)
                      for ls, st, r in zip(log_scales, steps, rate)]
        rates.append(rate[0])
    states = concat_states([st.finalize(s) for st, s in zip(steps, states)])
    rate_trace = torch.stack(rates) if rates else torch.zeros(0, device=devices[0])
    return states, rate_trace, log_scales[0]
