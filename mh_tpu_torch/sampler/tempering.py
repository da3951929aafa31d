"""Parallel tempering over a device mesh (counterpart of ``mh_tpu.sampler.tempering``).

K replicas sample the layout objective at an ascending inverse-temperature
ladder ``betas`` (the last entry is the target, e.g. the reference's
BETA=2, ``Kernel.cu:33``); every ``exchange_every`` MH steps neighbouring
replicas attempt a configuration swap with probability ``min(1, exp((b_i -
b_j) * (S_j - S_i)))``, alternating even and odd pairs.

As in ``mh_tpu`` the ladder is split over the mesh's chains axis in
contiguous replica blocks: each shard appends the last replica of its left
neighbour and the first of its right neighbour (moved by
:func:`~mh_tpu_torch.parallel.mesh.ppermute`, cyclically; validity is by
global id) and indexes every partner in that extended block. Pair
decisions use ``mh_tpu``'s keys, folded from the global pair index
(``fold_in(fold_in(key, 0x7E3), round * K + pair)``), so both members of a
pair across a boundary decide alike; each accepted pair is counted once, by
its lower member, and the counts and the ladder's per-pair indicators are
summed over the shards with :func:`~mh_tpu_torch.parallel.mesh.psum`.
On a mesh that spans processes each process steps its own shards, the
boundary replicas cross processes through ``ppermute`` and the sums
through ``psum``, so the run is bitwise that of one process.
``mesh=None`` is one shard on the scene's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mh_tpu_torch.config import SamplerConfig
from mh_tpu_torch.models.scene import Scene
from mh_tpu_torch.ops.costs import CostBreakdown
from mh_tpu_torch.parallel.mesh import Mesh, chain_shards, local_count, ppermute, psum
from mh_tpu_torch.parallel.sharded import advance, concat_states, shard_starts, shard_steps
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.mh import MHState

Tensor = torch.Tensor


def geometric_ladder(n: int, beta_min: float, beta_max: float, device=None) -> Tensor:
    """Geometric inverse-temperature ladder, ascending to the target beta.

    Computed in float32 on the host, as XLA computes ``mh_tpu``'s (the
    division by the constant ``n - 1`` is a multiply by its float32
    reciprocal), then placed on ``device``.
    """
    frac = np.arange(n, dtype=np.float32) * (np.float32(1.0) / np.float32(max(n - 1, 1)))
    ladder = np.float32(beta_min) * np.float32(beta_max / beta_min) ** frac
    return torch.as_tensor(ladder.astype(np.float32), device=device)


def with_rows(states: MHState, rows: tuple[Tensor, Tensor], accept: Tensor) -> MHState:
    """``states`` with replica/particle ``i`` replaced by ``rows[i]`` where
    ``accept[i]``: ``rows`` is ``(pose f32[L, N, 6], cost vectors f32[L,
    8])``; the pose and its cost breakdown move together."""
    pose, cvec = rows
    new_cvec = torch.where(accept[:, None], cvec, states.costs.as_vector())
    costs = CostBreakdown(*new_cvec.unbind(-1))
    return dataclasses.replace(states, pose=torch.where(accept[:, None, None], pose, states.pose),
                               costs=costs)


def run_tempered(
    key: Tensor,
    pose0: Tensor,
    scene: Scene,
    cfg: SamplerConfig,
    mesh: Mesh | None = None,
    n_replicas: int = 16,
    betas: Tensor | None = None,
    exchange_every: int = 5,
    rounds: int = 20,
    adapt_ladder: bool = False,
    target_swap: float = 0.234,
):
    """Run a parallel-tempering ensemble over ``mesh`` (BASELINE config 5).

    Returns ``(states [n_replicas, ...], swap_rate_trace f32[rounds])``;
    with ``adapt_ladder=True``, ``(states, swap_rate_trace, betas f32[K])``,
    on this process's first shard's device, ``states`` this process's
    replicas. The target-temperature sample is the last replica. Bitwise
    the same on any number of shards and processes.

    ``adapt_ladder``: stochastic-approximation ladder adaptation
    (Miasojedow-Moulines-Vihola, arXiv:1205.1076): the top beta stays
    pinned and each log-beta gap drifts by ``gamma_t * (accept_k -
    target_swap)``, ``gamma_t = 0.5 / (1 + t)^0.6``.
    """
    ids, devices, n_dev = chain_shards(mesh, scene.device)
    k_rep = n_replicas
    n_local = local_count(k_rep, n_dev, "n_replicas")
    home = devices[0]
    if betas is None:
        betas = geometric_ladder(k_rep, 0.1, cfg.beta)
    betas = torch.as_tensor(betas, dtype=torch.float32).to(home)
    steps = shard_steps(scene, cfg, devices)
    states = shard_starts(key, pose0, steps, n_local, ids)

    lids = [torch.arange(n_local, device=d) for d in devices]
    gids = [d * n_local + lid for d, lid in zip(ids, lids)]
    pair_keys = [prng.fold_in(key.to(d), 0x7E3) for d in devices]
    right = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    left = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    log_bmax = torch.log(betas[-1])
    rho = torch.log(torch.diff(torch.log(betas)))  # [K-1] log gaps
    gammas = torch.as_tensor(
        np.float32(0.5) / (np.float32(1.0) + np.arange(rounds, dtype=np.float32))
        ** np.float32(0.6), device=home)

    def betas_from_rho(rho):
        # suffix-sum the positive gaps down from the pinned target beta
        suffix = torch.flip(torch.cumsum(torch.flip(torch.exp(rho), (0,)), 0), (0,))
        return torch.exp(torch.cat([log_bmax - suffix, log_bmax[None]]))

    rates = []
    for rnd in range(rounds):
        betas_now = betas_from_rho(rho) if adapt_ladder else betas
        shard_betas = [betas_now.to(d) for d in devices]
        states = advance(steps, states, exchange_every,
                         betas=[b[g] for b, g in zip(shard_betas, gids)])

        # boundary transport: my last replica -> right neighbour, my first
        # replica -> left neighbour (cyclic; validity by global id)
        rows = [(s.pose, s.costs.as_vector()) for s in states]
        from_left = [ppermute([r[i][-1:] for r in rows], right, mesh) for i in (0, 1)]
        from_right = [ppermute([r[i][:1] for r in rows], left, mesh) for i in (0, 1)]
        swaps, attempts, acc_vecs, att_vecs = [], [], [], []
        for d, (s, (pose, cvec), g, lid) in enumerate(zip(states, rows, gids, lids)):
            # extended block: index l + 1 == local replica l
            pose_ext = torch.cat([from_left[0][d], pose, from_right[0][d]])
            cvec_ext = torch.cat([from_left[1][d], cvec, from_right[1][d]])
            is_lower = (g % 2) == (rnd % 2)  # pair (g, g+1), g is the lower half
            partner = torch.where(is_lower, g + 1, g - 1)
            partner_ext = torch.where(is_lower, lid + 2, lid)
            valid = (partner >= 0) & (partner < k_rep)
            b = shard_betas[d]
            u = prng.uniform(prng.fold_in(pair_keys[d], rnd * k_rep + torch.minimum(g, partner)))
            log_ratio = (b[g] - b[torch.clamp(partner, 0, k_rep - 1)]) * (
                cvec_ext[partner_ext, 0] - cvec[:, 0])
            accept = valid & (u < torch.exp(torch.clamp_max(log_ratio, 0.0)))
            states[d] = with_rows(s, (pose_ext[partner_ext], cvec_ext[partner_ext]), accept)

            own = valid & is_lower  # count each pair once, by its lower member
            swapped = (accept & own).to(torch.float32)
            swaps.append(torch.sum(swapped))
            attempts.append(torch.sum(own.to(torch.float32)))
            if adapt_ladder:
                # per-pair indicators, scattered into [K-1] by pair id g
                pair_oh = (g[:, None] == torch.arange(k_rep - 1, device=g.device)).to(torch.float32)
                acc_vecs.append(torch.sum(pair_oh * swapped[:, None], 0))
                att_vecs.append(torch.sum(pair_oh * own.to(torch.float32)[:, None], 0))
        rates.append(psum(swaps, mesh)[0] / torch.clamp_min(psum(attempts, mesh)[0], 1.0))
        if adapt_ladder:
            # Robbins-Monro on the log gaps; pair k is (k, k+1), counted at k
            rho = rho + gammas[rnd] * (psum(acc_vecs, mesh)[0]
                                       - target_swap * psum(att_vecs, mesh)[0])

    states = concat_states([st.finalize(s) for st, s in zip(steps, states)])
    swap_rates = torch.stack(rates) if rates else torch.zeros(0, device=home)
    if adapt_ladder:
        return states, swap_rates, betas_from_rho(rho)
    return states, swap_rates
