"""Generic-density samplers (counterpart of ``mh_tpu.sampler.generic``).

A vectorized random-walk Metropolis kernel over a batched log-density
``logdensity_fn(theta [..., D]) -> [...]``, the adapter that exposes the
layout objective as such a density (continuous parameters = x, y, rotY of
every unfrozen object; frozen and padded objects are held), and what the
gradient samplers (MALA, HMC, NUTS, VI) share: :func:`value_and_grad`, the
device rule and the chains' start.

Chains are the leading dim of every state tensor, as in the chain engine,
and the draws are ``mh_tpu``'s: chain ``c`` is keyed by ``fold_in(key,
c)``, draw ``i`` by ``fold_in(chain_key, i)``, and ``split``, ``uniform``
and ``normal`` take the batched keys where the reference takes one chain's
key under ``vmap``. Every sampler runs on the card unless ``device`` (or
``theta0``'s device) names another; without a card it raises.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch

from mh_tpu_torch.config import CostMode
from mh_tpu_torch.models.scene import Scene
from mh_tpu_torch.ops.costs import offlimits_unused, weighted_terms
from mh_tpu_torch.sampler import prng

Tensor = torch.Tensor
LogDensity = Callable[[Tensor], Tensor]


def value_and_grad(fn: LogDensity, theta: Tensor) -> tuple[Tensor, Tensor]:
    """``(fn(theta), d sum(fn(theta)) / d theta)``, both detached. Chains are
    independent, so the gradient of the sum is each chain's own gradient."""
    with torch.enable_grad():
        t = theta.detach().requires_grad_(True)
        lp = fn(t)
        (g,) = torch.autograd.grad(lp.sum(), t)
    return lp.detach(), g


def resolve_device(theta0, device=None) -> torch.device:
    """``device``; else ``theta0``'s device when it is a tensor, else the
    card. Raises where that is the card and there is none."""
    if device is None:
        device = theta0.device if isinstance(theta0, Tensor) else "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return device


def start_point(key, theta0, device=None) -> tuple[Tensor, Tensor]:
    """``key`` (a key tensor or an int seed) and ``theta0`` (a tensor,
    array or list) as float32 tensors on the resolved device."""
    dev = resolve_device(theta0, device)
    if isinstance(theta0, Tensor):
        theta0 = theta0.to(dev, torch.float32)
    else:
        theta0 = torch.as_tensor(np.array(theta0, np.float32), device=dev)
    key = prng.key(key) if isinstance(key, int) else key
    return key.to(dev), theta0


def chain_starts(key, theta0, n_chains: int, device=None) -> tuple[Tensor, Tensor]:
    """The chains' keys ``fold_in(key, c)`` and start points ``[C, D]`` on
    the resolved device; ``theta0`` is ``[D]`` (shared) or ``[C, D]``."""
    key, theta0 = start_point(key, theta0, device)
    if theta0.ndim == 1:
        theta0 = theta0.expand(n_chains, -1)
    keys = prng.fold_in(key, torch.arange(theta0.shape[0], device=theta0.device))
    return keys, theta0.contiguous()


@dataclasses.dataclass(frozen=True)
class SamplerState:
    """Fields of a sampler's state, batched over the leading dims (chains).
    Integer fields are int32, the rest float32."""

    def to_numpy(self) -> dict:
        return {f.name: getattr(self, f.name).detach().cpu().numpy()
                for f in dataclasses.fields(self)}

    @classmethod
    def from_numpy(cls, fields: Mapping, device=None):
        """The inverse of :meth:`to_numpy`: carries a state (e.g. one of
        ``mh_tpu``'s, field by field) into the port."""
        out = {}
        for f in dataclasses.fields(cls):
            a = np.asarray(fields[f.name])
            dtype = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
            out[f.name] = torch.as_tensor(np.array(a, dtype), device=device)
        return cls(**out)


def select(acc: Tensor, new: Tensor, old: Tensor) -> Tensor:
    """``new`` where the chain accepted, else ``old`` (``acc`` has the
    chains' dims; trailing dims of the fields broadcast)."""
    return torch.where(acc.reshape(acc.shape + (1,) * (new.ndim - acc.ndim)), new, old)


# --- layout objective as a generic density ---------------------------------


def theta_from_pose(pose: Tensor) -> Tensor:
    """Flatten the continuous layout parameters: ``[..., x | y | rotY]`` (3N)."""
    return torch.cat([pose[..., 0], pose[..., 1], pose[..., 4]], -1)


def pose_from_theta(theta: Tensor, pose0: Tensor, scene: Scene) -> Tensor:
    """Rebuild poses ``[..., N, 6]`` from ``theta [..., 3N]``; frozen and
    padded objects keep ``pose0``'s values."""
    n = pose0.shape[-2]
    free = (scene.obj_mask > 0) & ~scene.frozen
    x = torch.where(free, theta[..., :n], pose0[..., 0])
    y = torch.where(free, theta[..., n:2 * n], pose0[..., 1])
    rot = torch.where(free, theta[..., 2 * n:], pose0[..., 4])
    x, y, rot = torch.broadcast_tensors(x, y, rot)
    rest = pose0.expand(x.shape + (6,))
    return torch.stack([x, y, rest[..., 2], rest[..., 3], rot, rest[..., 5]], -1)


def layout_logdensity(
    scene: Scene,
    pose0: Tensor,
    beta: float,
    mode: CostMode = CostMode.PARITY,
) -> LogDensity:
    """log pi(theta) = beta * total_cost(pose(theta)): the MH stationary
    density implied by the reference accept rule (``Kernel.cu:712``).

    Batched over theta's leading dims and differentiable by autograd. The
    off-limits term is left out where it cannot change the total (decided
    here, once, from the scene); no matmul carries a value.
    """
    beta = prng.f32(beta)
    with_off = not offlimits_unused(scene, mode)
    pose0 = pose0.to(scene.device, torch.float32)

    def logdensity(theta: Tensor) -> Tensor:
        pose = pose_from_theta(theta, pose0, scene)
        return beta * weighted_terms(pose, scene, mode, with_off).total

    return logdensity


# --- vectorized random-walk Metropolis -------------------------------------


@dataclasses.dataclass(frozen=True)
class RWState(SamplerState):
    theta: Tensor  # f32[..., D]
    logprob: Tensor  # f32[...]
    n_accept: Tensor  # i32[...]
    step: Tensor  # i32[...]


def rw_state_from_numpy(fields: Mapping, device=None) -> RWState:
    return RWState.from_numpy(fields, device)


def rw_init(logdensity_fn: LogDensity, theta0: Tensor) -> RWState:
    lead = theta0.shape[:-1]
    zeros = torch.zeros(lead, dtype=torch.int32, device=theta0.device)
    with torch.no_grad():
        lp = logdensity_fn(theta0)
    return RWState(theta=theta0, logprob=lp, n_accept=zeros, step=zeros)


def rw_step(key: Tensor, state: RWState, logdensity_fn: LogDensity, step_size) -> RWState:
    """One RW-MH step per chain; ``key`` holds one key per chain."""
    ks = prng.split(key)
    k_prop, k_acc = ks[..., 0, :], ks[..., 1, :]
    star = prng.fma(prng.normal(k_prop, state.theta.shape[-1:]), prng.f32(step_size),
                    state.theta)
    with torch.no_grad():
        lp_star = logdensity_fn(star)
    acc = torch.log(prng.uniform(k_acc)) < lp_star - state.logprob
    return RWState(
        theta=select(acc, star, state.theta),
        logprob=torch.where(acc, lp_star, state.logprob),
        n_accept=state.n_accept + acc.to(torch.int32),
        step=state.step + 1,
    )


def rw_metropolis(
    key,
    logdensity_fn: LogDensity,
    theta0,
    n_samples: int,
    n_chains: int = 1,
    step_size: float = 0.5,
    thin: int = 1,
    device=None,
):
    """Vectorized RW-Metropolis: ``(samples f32[n_chains, n_samples, D],
    final RWState)``. ``theta0``: ``[D]`` (shared) or ``[n_chains, D]``."""
    keys, theta = chain_starts(key, theta0, n_chains, device)
    state = rw_init(logdensity_fn, theta)
    samples = theta.new_empty((theta.shape[0], n_samples, theta.shape[1]))
    for i in range(n_samples):
        k = prng.fold_in(keys, i)
        for j in range(thin):
            state = rw_step(prng.fold_in(k, j), state, logdensity_fn, step_size)
        samples[:, i] = state.theta
    return samples, state
