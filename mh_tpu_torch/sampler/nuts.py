"""No-U-Turn Sampler (counterpart of ``mh_tpu.sampler.nuts``).

Multinomial NUTS (Hoffman & Gelman 2014; Betancourt 2017) with
dual-averaging warmup, on the batched log-density interface of
:mod:`mh_tpu_torch.sampler.generic`. The tree is ``mh_tpu``'s
stored-subtree scheme, with the chains as a leading dim:

- doubling ``j`` runs ``2**j`` leapfrog steps from the edge it grows and
  keeps the whole subtree (positions, momenta, gradients, log-probs) as
  ``[C, 2**j, ...]`` tensors;
- the sub-U-turn checks of the recursive build are level-wise reshapes
  over the stored subtree;
- the draw within a subtree is one Gumbel-argmax over its log-weights,
  and across doublings biased progressive sampling keeps one proposal.

Under ``vmap`` the reference's per-chain ``lax.cond`` on the termination
flag is a select: every chain expands and a chain that is done keeps its
carry. So here: every chain expands and keeps the result only where it
was not done. The loop stops early once every chain is done (one host
read per doubling), which leaves the result unchanged.
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
from mh_tpu_torch.sampler.hmc import dual_averaging

Tensor = torch.Tensor

_DIVERGENCE_THRESHOLD = 1000.0  # energy error that flags a divergent transition


@dataclasses.dataclass(frozen=True)
class NUTSState(SamplerState):
    theta: Tensor  # f32[..., D]
    logprob: Tensor  # f32[...]
    grad: Tensor  # f32[..., D]
    n_divergent: Tensor  # i32[...]: divergent transitions seen so far
    sum_depth: Tensor  # i32[...]: accumulated tree depth (mean-depth diagnostics)
    # dual-averaging state (Hoffman & Gelman 2014, Alg. 6), f32[...] each
    log_eps: Tensor
    log_eps_avg: Tensor
    h_avg: Tensor


def nuts_state_from_numpy(fields: Mapping, device=None) -> NUTSState:
    return NUTSState.from_numpy(fields, device)


def nuts_init(logdensity_fn: LogDensity, theta0: Tensor, step_size: float) -> NUTSState:
    lp, g = value_and_grad(logdensity_fn, theta0)
    lead = theta0.shape[:-1]
    zeros = torch.zeros(lead, dtype=torch.int32, device=theta0.device)
    log_eps = torch.full(lead, float(np.log(np.float32(step_size))), device=theta0.device)
    return NUTSState(theta=theta0, logprob=lp, grad=g, n_divergent=zeros, sum_depth=zeros,
                     log_eps=log_eps, log_eps_avg=log_eps.clone(),
                     h_avg=torch.zeros_like(log_eps))


def _leapfrog_trajectory(logdensity_fn, theta, p, grad, eps, n_steps):
    """``n_steps`` leapfrog steps (``eps`` has the chains' dims, signed by
    the direction); every visited state: ``[..., n_steps, D]`` and lps
    ``[..., n_steps]``."""
    half = (0.5 * eps)[..., None]
    eps = eps[..., None]
    thetas, ps, grads, lps = [], [], [], []
    for _ in range(n_steps):
        p_half = prng.fma(half, grad, p)
        theta = prng.fma(eps, p_half, theta)
        lp, grad = value_and_grad(logdensity_fn, theta)
        p = prng.fma(half, grad, p_half)
        thetas.append(theta), ps.append(p), grads.append(grad), lps.append(lp)
    return (torch.stack(thetas, -2), torch.stack(ps, -2), torch.stack(grads, -2),
            torch.stack(lps, -1))


def _subtree_uturn(thetas: Tensor, ps: Tensor, v: Tensor) -> Tensor:
    """Sub-U-turn check over stored subtrees ``[..., m, D]`` (traversal
    order, m = 2**j): every aligned segment of length ``2**l`` for ``l =
    1..j``, the internal merge nodes the recursive build tests. ``v``
    corrects for temporal orientation where a subtree grew backward."""
    *lead, m, dim = thetas.shape
    uturn = torch.zeros(lead, dtype=torch.bool, device=thetas.device)
    level = 2
    while level <= m:
        seg_t = thetas.reshape(*lead, m // level, level, dim)
        seg_p = ps.reshape(*lead, m // level, level, dim)
        d = seg_t[..., -1, :] - seg_t[..., 0, :]  # traversal-order span per segment
        lo = torch.sum(d * seg_p[..., 0, :], -1) * v[..., None]
        hi = torch.sum(d * seg_p[..., -1, :], -1) * v[..., None]
        uturn = uturn | torch.any((lo < 0.0) | (hi < 0.0), -1)
        level *= 2
    return uturn


def gumbel(u: Tensor) -> Tensor:
    """Gumbel noise ``-log(-log(u))`` from uniforms on [0, 1).

    The reference writes ``-log(-log(u + 1e-38) + 1e-38)``. In float32 the
    guard is subnormal, and XLA flushes subnormals to zero, so there it
    adds nothing: a uniform of exactly 0 gives -inf, and that leaf is never
    drawn; a uniform above 0 (at least 2^-23) is unchanged by it. PyTorch
    keeps subnormals, so the guard is left out here to give the
    reference's flushed result."""
    return -torch.log(-torch.log(u))


def _pick(ws: Tensor, u: Tensor) -> Tensor:
    """The leaf drawn from log-weights ``ws [..., m]`` with uniforms ``u``:
    argmax of ``ws + gumbel(u)``, ties to the first index as in JAX."""
    return torch.argmax(ws + gumbel(u), -1)


def _take(rows: Tensor, idx: Tensor) -> Tensor:
    """``rows[..., idx, :]`` per chain (``rows [..., m, D]``, ``idx [...]``)."""
    return torch.take_along_dim(rows, idx[..., None, None], -2).squeeze(-2)


def _expand(j, c, logdensity_fn, k_loop, eps, h0):
    """Doubling ``j`` from carry ``c``, for every chain."""
    m = 1 << j
    ks = prng.split(prng.fold_in(k_loop, j), 3)
    k_dir, k_gum, k_take = ks[..., 0, :], ks[..., 1, :], ks[..., 2, :]
    v = torch.where(prng.uniform(k_dir) < 0.5, -1.0, 1.0)
    fwd = v > 0

    edge_theta = select(fwd, c["theta_plus"], c["theta_minus"])
    edge_p = select(fwd, c["p_plus"], c["p_minus"])
    edge_grad = select(fwd, c["grad_plus"], c["grad_minus"])
    thetas, ps, grads, lps = _leapfrog_trajectory(logdensity_fn, edge_theta, edge_p,
                                                  edge_grad, eps * v, m)
    ws = lps - 0.5 * torch.sum(torch.square(ps), -1) - h0[..., None]  # log-weights [..., m]
    ws = torch.where(torch.isfinite(ws), ws, -torch.inf)
    div = torch.any(ws < -_DIVERGENCE_THRESHOLD, -1)
    alpha_sum = c["alpha_sum"] + torch.sum(torch.exp(torch.clamp_max(ws, 0.0)), -1)
    n_alpha = c["n_alpha"] + float(m)

    internal_ut = _subtree_uturn(thetas, ps, v) if m > 1 else torch.zeros_like(div)
    subtree_ok = ~(div | internal_ut)

    # multinomial draw within the subtree, then biased progressive sampling
    # across doublings (Stan); log(u) of u == 0 is -inf, as in the reference
    idx = _pick(ws, prng.uniform(k_gum, (m,)))
    log_sum_w_new = torch.logsumexp(ws, -1)
    take = subtree_ok & (torch.log(prng.uniform(k_take)) < log_sum_w_new - c["log_sum_w"])

    # extend the temporal edge that grew (only if the subtree is kept)
    grow_plus = subtree_ok & fwd
    grow_minus = subtree_ok & ~fwd
    last_theta, last_p, last_grad = thetas[..., -1, :], ps[..., -1, :], grads[..., -1, :]
    out = {
        "theta_plus": select(grow_plus, last_theta, c["theta_plus"]),
        "p_plus": select(grow_plus, last_p, c["p_plus"]),
        "grad_plus": select(grow_plus, last_grad, c["grad_plus"]),
        "theta_minus": select(grow_minus, last_theta, c["theta_minus"]),
        "p_minus": select(grow_minus, last_p, c["p_minus"]),
        "grad_minus": select(grow_minus, last_grad, c["grad_minus"]),
        "theta": select(take, _take(thetas, idx), c["theta"]),
        "logprob": torch.where(take, torch.gather(lps, -1, idx[..., None])[..., 0],
                               c["logprob"]),
        "grad": select(take, _take(grads, idx), c["grad"]),
        "log_sum_w": torch.where(subtree_ok, torch.logaddexp(c["log_sum_w"], log_sum_w_new),
                                 c["log_sum_w"]),
        "divergent": c["divergent"] | div,
        "depth": torch.where(subtree_ok, j + 1, c["depth"]).to(torch.int32),
        "alpha_sum": alpha_sum,
        "n_alpha": n_alpha,
    }
    d = out["theta_plus"] - out["theta_minus"]
    full_ut = ((torch.sum(d * out["p_minus"], -1) < 0.0)
               | (torch.sum(d * out["p_plus"], -1) < 0.0))
    out["done"] = ~subtree_ok | full_ut
    return out


def nuts_step(
    key: Tensor,
    state: NUTSState,
    logdensity_fn: LogDensity,
    max_depth: int,
    step: int,
    adapt: bool = True,
    target_accept: float = 0.8,
    t0: float = 10.0,
    gamma: float = 0.05,
    kappa: float = 0.75,
) -> NUTSState:
    """One NUTS transition per chain (tree doubling up to ``max_depth``)."""
    ks = prng.split(key)
    k_mom, k_loop = ks[..., 0, :], ks[..., 1, :]
    eps = torch.exp(state.log_eps)
    p0 = prng.normal(k_mom, state.theta.shape[-1:])
    h0 = state.logprob - 0.5 * torch.sum(torch.square(p0), -1)

    zero = torch.zeros_like(state.logprob)
    no = torch.zeros_like(zero, dtype=torch.bool)
    carry = {
        # temporal trajectory edges
        "theta_minus": state.theta, "p_minus": p0, "grad_minus": state.grad,
        "theta_plus": state.theta, "p_plus": p0, "grad_plus": state.grad,
        # current proposal (the initial point has log-weight 0 relative to h0)
        "theta": state.theta, "logprob": state.logprob, "grad": state.grad,
        "log_sum_w": zero, "done": no, "divergent": no,
        "depth": torch.zeros_like(state.n_divergent),
        "alpha_sum": zero, "n_alpha": zero,
    }
    for j in range(max_depth):
        if bool(carry["done"].all()):
            break
        new = _expand(j, carry, logdensity_fn, k_loop, eps, h0)
        carry = {k: select(carry["done"], carry[k], new[k]) for k in carry}

    accept_prob = carry["alpha_sum"] / torch.clamp_min(carry["n_alpha"], 1.0)
    log_eps, log_eps_avg, h_avg = state.log_eps, state.log_eps_avg, state.h_avg
    if adapt:
        log_eps, log_eps_avg, h_avg = dual_averaging(
            step, accept_prob, log_eps_avg, h_avg, target_accept, t0, gamma, kappa)
    return NUTSState(
        theta=carry["theta"],
        logprob=carry["logprob"],
        grad=carry["grad"],
        n_divergent=state.n_divergent + carry["divergent"].to(torch.int32),
        sum_depth=state.sum_depth + carry["depth"],
        log_eps=log_eps,
        log_eps_avg=log_eps_avg,
        h_avg=h_avg,
    )


def nuts_sample(
    key,
    logdensity_fn: LogDensity,
    theta0,
    n_samples: int,
    n_warmup: int = 200,
    max_depth: int = 8,
    step_size: float = 0.1,
    n_chains: int = 1,
    target_accept: float = 0.8,
    device=None,
):
    """Adaptive NUTS: dual-averaging warmup, then fixed-step sampling.

    Returns ``(samples f32[n_chains, n_samples, D], final NUTSState)``.
    Diagnostics on the final state: ``n_divergent`` (sampling phase only)
    and ``sum_depth / n_samples`` (mean tree depth).
    """
    keys, theta = chain_starts(key, theta0, n_chains, device)
    state = nuts_init(logdensity_fn, theta, step_size)
    for i in range(n_warmup):
        state = nuts_step(prng.fold_in(keys, i), state, logdensity_fn, max_depth, i,
                          adapt=True, target_accept=target_accept)
    # freeze at the averaged step size; reset diagnostics for sampling
    zeros = torch.zeros_like(state.n_divergent)
    state = dataclasses.replace(state, log_eps=state.log_eps_avg, n_divergent=zeros,
                                sum_depth=zeros)
    samples = theta.new_empty((theta.shape[0], n_samples, theta.shape[1]))
    for i in range(n_samples):
        state = nuts_step(prng.fold_in(keys, n_warmup + i), state, logdensity_fn, max_depth,
                          i, adapt=False)
        samples[:, i] = state.theta
    return samples, state
