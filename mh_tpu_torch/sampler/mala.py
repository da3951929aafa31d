"""Metropolis-adjusted Langevin (counterpart of ``mh_tpu.sampler.mala``).

MALA proposes ``theta* = theta + eps^2/2 * grad(log pi)(theta) + eps * xi``
and corrects with the asymmetric-proposal MH ratio: one gradient per step
(cached in the state), on the batched log-density interface of
:mod:`mh_tpu_torch.sampler.generic`. The layout objective's piecewise terms
give subgradients, split at ties as JAX splits them.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.generic import (
    LogDensity, SamplerState, chain_starts, select, value_and_grad,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MALAState(SamplerState):
    theta: Tensor  # f32[..., D]
    logprob: Tensor  # f32[...]
    grad: Tensor  # f32[..., D]
    n_accept: Tensor  # i32[...]
    step: Tensor  # i32[...]


def mala_state_from_numpy(fields: Mapping, device=None) -> MALAState:
    return MALAState.from_numpy(fields, device)


def mala_init(logdensity_fn: LogDensity, theta0: Tensor) -> MALAState:
    lp, g = value_and_grad(logdensity_fn, theta0)
    zeros = torch.zeros(theta0.shape[:-1], dtype=torch.int32, device=theta0.device)
    return MALAState(theta=theta0, logprob=lp, grad=g, n_accept=zeros, step=zeros)


def mala_step(key: Tensor, state: MALAState, logdensity_fn: LogDensity,
              step_size) -> MALAState:
    """One MALA iteration per chain (one gradient evaluation)."""
    ks = prng.split(key)
    k_prop, k_acc = ks[..., 0, :], ks[..., 1, :]
    eps = np.float32(step_size)
    eps2 = eps * eps
    drift = float(np.float32(0.5) * eps2)
    mean_fwd = prng.fma(state.grad, drift, state.theta)
    star = prng.fma(prng.normal(k_prop, state.theta.shape[-1:]), float(eps), mean_fwd)
    lp_star, g_star = value_and_grad(logdensity_fn, star)

    # log q(theta | star) - log q(star | theta): Gaussians with the drifted
    # means; the eps^-2/2 normalization cancels
    mean_rev = prng.fma(g_star, drift, star)
    d_fwd = star - mean_fwd
    d_rev = state.theta - mean_rev
    log_q = (torch.sum(d_fwd * d_fwd, -1) - torch.sum(d_rev * d_rev, -1)) / float(
        np.float32(2.0) * eps2)

    acc = torch.log(prng.uniform(k_acc)) < lp_star - state.logprob + log_q
    return MALAState(
        theta=select(acc, star, state.theta),
        logprob=torch.where(acc, lp_star, state.logprob),
        grad=select(acc, g_star, state.grad),
        n_accept=state.n_accept + acc.to(torch.int32),
        step=state.step + 1,
    )


def mala_sample(
    key,
    logdensity_fn: LogDensity,
    theta0,
    n_samples: int,
    n_chains: int = 1,
    step_size: float = 0.1,
    thin: int = 1,
    device=None,
):
    """Vectorized MALA: ``(samples f32[n_chains, n_samples, D], final
    MALAState)``. ``theta0``: ``[D]`` (shared) or ``[n_chains, D]``."""
    keys, theta = chain_starts(key, theta0, n_chains, device)
    state = mala_init(logdensity_fn, theta)
    samples = theta.new_empty((theta.shape[0], n_samples, theta.shape[1]))
    for i in range(n_samples):
        k = prng.fold_in(keys, i)
        for j in range(thin):
            state = mala_step(prng.fold_in(k, j), state, logdensity_fn, step_size)
        samples[:, i] = state.theta
    return samples, state
