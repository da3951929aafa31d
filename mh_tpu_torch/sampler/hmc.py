"""Hamiltonian Monte Carlo (counterpart of ``mh_tpu.sampler.hmc``).

Leapfrog HMC with optional dual-averaging step-size adaptation (Hoffman &
Gelman 2014, Alg. 5) on the batched log-density interface of
:mod:`mh_tpu_torch.sampler.generic`; every chain carries its own step
size. Gradients come from autograd; on the layout objective's piecewise
terms they are subgradients, split at ties as JAX splits them.
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
class HMCState(SamplerState):
    theta: Tensor  # f32[..., D]
    logprob: Tensor  # f32[...]
    grad: Tensor  # f32[..., D]
    n_accept: Tensor  # i32[...]
    # dual-averaging state, f32[...] each
    log_eps: Tensor
    log_eps_avg: Tensor
    h_avg: Tensor


def hmc_state_from_numpy(fields: Mapping, device=None) -> HMCState:
    return HMCState.from_numpy(fields, device)


def hmc_init(logdensity_fn: LogDensity, theta0: Tensor, step_size: float) -> HMCState:
    lp, g = value_and_grad(logdensity_fn, theta0)
    lead = theta0.shape[:-1]
    log_eps = torch.full(lead, float(np.log(np.float32(step_size))), device=theta0.device)
    return HMCState(
        theta=theta0, logprob=lp, grad=g,
        n_accept=torch.zeros(lead, dtype=torch.int32, device=theta0.device),
        log_eps=log_eps, log_eps_avg=log_eps.clone(), h_avg=torch.zeros_like(log_eps),
    )


def _leapfrog(logdensity_fn, theta, p, grad, eps, n_steps):
    """``n_steps`` leapfrog steps; ``eps`` has the chains' dims."""
    half = (0.5 * eps)[..., None]
    eps = eps[..., None]
    lp = None
    for _ in range(n_steps):
        p = prng.fma(half, grad, p)
        theta = prng.fma(eps, p, theta)
        lp, grad = value_and_grad(logdensity_fn, theta)
        p = prng.fma(half, grad, p)
    return theta, p, grad, lp


def dual_averaging(step, accept_prob, log_eps_avg, h_avg, target_accept, t0, gamma, kappa,
                   mu_eps=None):
    """One dual-averaging update (Hoffman & Gelman 2014): ``(log_eps,
    log_eps_avg, h_avg)``. ``step`` is the draw's index (an int, the same
    for every chain). Its scalars are float32 and each multiply-add is
    fused, with the division by ``gamma`` a multiply by its reciprocal, as
    XLA compiles ``mh_tpu``'s update: bitwise equal to it on the CPU. The
    update feeds its output back into the step size, so a difference of an
    ulp here doubles every few steps."""
    f = np.float32
    m = f(step) + f(1.0)
    eta = f(1.0) / (m + f(t0))
    h_avg = prng.fma(h_avg, float(f(1.0) - eta),
                     float(eta) * (prng.f32(target_accept) - accept_prob))
    if mu_eps is None:
        mu = float(np.log(f(10.0))) + log_eps_avg
    else:
        mu = torch.full_like(h_avg, float(np.log(f(mu_eps))))
    log_eps = prng.fma(h_avg, -float(np.sqrt(m) * (f(1.0) / f(gamma))), mu)
    w = m ** f(-kappa)
    log_eps_avg = prng.fma(log_eps, float(w), float(f(1.0) - w) * log_eps_avg)
    return log_eps, log_eps_avg, h_avg


def hmc_step(
    key: Tensor,
    state: HMCState,
    logdensity_fn: LogDensity,
    n_leapfrog: int,
    step: int,
    adapt: bool = True,
    target_accept: float = 0.8,
    t0: float = 10.0,
    gamma: float = 0.05,
    kappa: float = 0.75,
    mu_eps: float | None = None,
) -> HMCState:
    """One HMC transition per chain; ``key`` holds one key per chain."""
    ks = prng.split(key)
    k_mom, k_acc = ks[..., 0, :], ks[..., 1, :]
    eps = torch.exp(state.log_eps)
    p0 = prng.normal(k_mom, state.theta.shape[-1:])
    theta1, p1, grad1, lp1 = _leapfrog(logdensity_fn, state.theta, p0, state.grad, eps,
                                       n_leapfrog)
    h0 = state.logprob - 0.5 * torch.sum(torch.square(p0), -1)
    h1 = lp1 - 0.5 * torch.sum(torch.square(p1), -1)
    log_ratio = h1 - h0
    # guard divergences: reject non-finite trajectories outright
    log_ratio = torch.where(torch.isfinite(log_ratio), log_ratio, -torch.inf)
    accept_prob = torch.exp(torch.clamp_max(log_ratio, 0.0))
    acc = torch.log(prng.uniform(k_acc)) < log_ratio

    log_eps, log_eps_avg, h_avg = state.log_eps, state.log_eps_avg, state.h_avg
    if adapt:
        log_eps, log_eps_avg, h_avg = dual_averaging(
            step, accept_prob, log_eps_avg, h_avg, target_accept, t0, gamma, kappa, mu_eps)
    return HMCState(
        theta=select(acc, theta1, state.theta),
        logprob=torch.where(acc, lp1, state.logprob),
        grad=select(acc, grad1, state.grad),
        n_accept=state.n_accept + acc.to(torch.int32),
        log_eps=log_eps,
        log_eps_avg=log_eps_avg,
        h_avg=h_avg,
    )


def hmc_sample(
    key,
    logdensity_fn: LogDensity,
    theta0,
    n_samples: int,
    n_warmup: int = 100,
    n_leapfrog: int = 10,
    step_size: float = 0.1,
    n_chains: int = 1,
    target_accept: float = 0.8,
    device=None,
):
    """Adaptive HMC: warmup with dual averaging, then fixed-step sampling.

    Returns ``(samples f32[n_chains, n_samples, D], final HMCState)``.
    """
    keys, theta = chain_starts(key, theta0, n_chains, device)
    state = hmc_init(logdensity_fn, theta, step_size)
    for i in range(n_warmup):
        state = hmc_step(prng.fold_in(keys, i), state, logdensity_fn, n_leapfrog, i,
                         adapt=True, target_accept=target_accept)
    # freeze at the averaged step size
    state = dataclasses.replace(state, log_eps=state.log_eps_avg,
                                n_accept=torch.zeros_like(state.n_accept))
    samples = theta.new_empty((theta.shape[0], n_samples, theta.shape[1]))
    for i in range(n_samples):
        state = hmc_step(prng.fold_in(keys, n_warmup + i), state, logdensity_fn, n_leapfrog, i,
                         adapt=False)
        samples[:, i] = state.theta
    return samples, state
