"""Parallel tempering on one device (counterpart of ``mh_tpu.sampler.tempering``).

K replicas sample the layout objective at an ascending inverse-temperature
ladder ``betas`` (the last entry is the target, e.g. the reference's
BETA=2, ``Kernel.cu:33``); every ``exchange_every`` MH steps neighbouring
replicas attempt a configuration swap with probability ``min(1, exp((b_i -
b_j) * (S_j - S_i)))``, alternating even and odd pairs.

``mh_tpu`` shards the ladder over a device mesh and moves the boundary
replicas with ``ppermute``; on one device every partner is local, so the
exchange indexes its partner directly and the ``psum`` of swap counts is a
local sum. Pair decisions keep ``mh_tpu``'s keys, folded from the global
pair index (``fold_in(fold_in(key, 0x7E3), round * K + pair)``), and each
accepted pair is counted once, by its lower member. Multi-GPU tempering is
ROADMAP Queue 1.8.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mh_tpu_torch.config import SamplerConfig
from mh_tpu_torch.models.scene import Scene
from mh_tpu_torch.ops.costs import CostBreakdown
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.mh import ChainStep, MHState, chain_starts

Tensor = torch.Tensor


def check_one_device(mesh) -> None:
    """``mesh`` must be None or span one device; anything wider raises."""
    if mesh is None:
        return
    shape = mesh.shape
    sizes = shape.values() if hasattr(shape, "values") else shape
    if int(np.prod(list(sizes))) != 1:
        raise NotImplementedError(
            "multi-GPU tempering and SMC are not ported yet (ROADMAP Queue 1.8); "
            "pass mesh=None or a one-device mesh")


def geometric_ladder(n: int, beta_min: float, beta_max: float, device=None) -> Tensor:
    """Geometric inverse-temperature ladder, ascending to the target beta.

    Computed in float32 on the host, as XLA computes ``mh_tpu``'s (the
    division by the constant ``n - 1`` is a multiply by its float32
    reciprocal), then placed on ``device``.
    """
    frac = np.arange(n, dtype=np.float32) * (np.float32(1.0) / np.float32(max(n - 1, 1)))
    ladder = np.float32(beta_min) * np.float32(beta_max / beta_min) ** frac
    return torch.as_tensor(ladder.astype(np.float32), device=device)


def with_rows(states: MHState, rows: Tensor, accept: Tensor) -> MHState:
    """``states`` with replica/particle ``i`` replaced by ``rows[i]`` where
    ``accept[i]``: the pose and its cost breakdown move together."""
    cvec = states.costs.as_vector()
    new_cvec = torch.where(accept[:, None], cvec[rows], cvec)
    costs = CostBreakdown(*new_cvec.unbind(-1))
    pose = torch.where(accept[:, None, None], states.pose[rows], states.pose)
    return dataclasses.replace(states, pose=pose, costs=costs)


def run_tempered(
    key: Tensor,
    pose0: Tensor,
    scene: Scene,
    cfg: SamplerConfig,
    mesh=None,
    n_replicas: int = 16,
    betas: Tensor | None = None,
    exchange_every: int = 5,
    rounds: int = 20,
    adapt_ladder: bool = False,
    target_swap: float = 0.234,
):
    """Run a parallel-tempering ensemble on the scene's device (BASELINE config 5).

    Returns ``(states [n_replicas, ...], swap_rate_trace f32[rounds])``;
    with ``adapt_ladder=True``, ``(states, swap_rate_trace, betas f32[K])``.
    The target-temperature sample is the last replica.

    ``adapt_ladder``: stochastic-approximation ladder adaptation
    (Miasojedow-Moulines-Vihola, arXiv:1205.1076): the top beta stays
    pinned and each log-beta gap drifts by ``gamma_t * (accept_k -
    target_swap)``, ``gamma_t = 0.5 / (1 + t)^0.6``.
    """
    check_one_device(mesh)
    dev = scene.device
    k_rep = n_replicas
    if betas is None:
        betas = geometric_ladder(k_rep, 0.1, cfg.beta)
    betas = torch.as_tensor(betas, dtype=torch.float32).to(dev)
    key = key.to(dev)
    step = ChainStep(scene, cfg)
    states = step.init(*chain_starts(key, pose0, scene, k_rep))

    g = torch.arange(k_rep, device=dev)
    pair_key = prng.fold_in(key, 0x7E3)
    log_bmax = torch.log(betas[-1])
    rho = torch.log(torch.diff(torch.log(betas)))  # [K-1] log gaps
    gammas = torch.as_tensor(
        np.float32(0.5) / (np.float32(1.0) + np.arange(rounds, dtype=np.float32))
        ** np.float32(0.6), device=dev)

    def betas_from_rho(rho):
        # suffix-sum the positive gaps down from the pinned target beta
        suffix = torch.flip(torch.cumsum(torch.flip(torch.exp(rho), (0,)), 0), (0,))
        return torch.exp(torch.cat([log_bmax - suffix, log_bmax[None]]))

    rates = []
    for rnd in range(rounds):
        betas_now = betas_from_rho(rho) if adapt_ladder else betas
        for _ in range(exchange_every):
            states = step(states, beta=betas_now)

        # alternating even/odd neighbour swaps, partners indexed directly
        is_lower = (g % 2) == (rnd % 2)  # pair (g, g+1), g is the lower half
        partner = torch.where(is_lower, g + 1, g - 1)
        valid = (partner >= 0) & (partner < k_rep)
        pc = torch.clamp(partner, 0, k_rep - 1)
        s = states.costs.total
        u = prng.uniform(prng.fold_in(pair_key, rnd * k_rep + torch.minimum(g, partner)))
        log_ratio = (betas_now - betas_now[pc]) * (s[pc] - s)
        accept = valid & (u < torch.exp(torch.clamp_max(log_ratio, 0.0)))
        states = with_rows(states, pc, accept)

        own = valid & is_lower  # count each pair once, by its lower member
        swapped = accept & own
        n_at = torch.sum(own.to(torch.float32))
        rates.append(torch.sum(swapped.to(torch.float32)) / torch.clamp_min(n_at, 1.0))
        if adapt_ladder:
            # Robbins-Monro on the log gaps; pair k is (k, k+1), counted at k
            acc = swapped[:-1].to(torch.float32)
            att = own[:-1].to(torch.float32)
            rho = rho + gammas[rnd] * (acc - target_swap * att)

    states = step.finalize(states)
    swap_rates = torch.stack(rates) if rates else torch.zeros(0, device=dev)
    if adapt_ladder:
        return states, swap_rates, betas_from_rho(rho)
    return states, swap_rates
