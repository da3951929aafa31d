"""The Metropolis-Hastings chain engine (counterpart of ``mh_tpu.sampler.mh``).

``mh_tpu`` runs one chain as a ``lax.scan`` and many chains under ``vmap``;
here the chains are the leading dim of every state tensor and the steps
are a Python loop. The random stream is ``mh_tpu``'s own
(:mod:`mh_tpu_torch.sampler.prng`): chain ``c`` is keyed by
``fold_in(key, c)``, step ``t`` draws ``uniform(fold_in(chain_key, t), (M,
8))`` and, with K > 1 accept draws, ``uniform(fold_in(step_key, 1), (K,))``.
So the engine consumes exactly the uniforms ``mh_tpu`` consumes, and a
resumed chain consumes exactly the stream the uninterrupted one would.

A step reads nothing back to the host and builds no tensor from host data:
every input is a device tensor or a Python constant, so on CUDA
:func:`compile_chains` captures it once as a CUDA graph and replays it.
The off-limits decision (skip the O(N^2) term where it cannot change the
total) is made once per scene by the runners, outside the steps.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from mh_tpu_torch.config import CostMode, SamplerConfig
from mh_tpu_torch.models.scene import Scene
from mh_tpu_torch.ops.costs import (
    CostBreakdown, off_limits_costs, offlimits_unused, weighted_terms,
)
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.proposal import UNIFORMS_PER_MOVE, MoveTables, block_apply

Tensor = torch.Tensor
_COST_FIELDS = tuple(f.name for f in dataclasses.fields(CostBreakdown))


@dataclasses.dataclass(frozen=True)
class MHState:
    """Chain state, batched over the leading dims (chains)."""

    pose: Tensor  # f32[..., N, 6]
    costs: CostBreakdown  # weighted breakdown of the current pose, f32[...] each
    key: Tensor  # i64[..., 2] — the chain's threefry key words
    step: Tensor  # i32[...] — global step counter
    n_accept: Tensor  # i32[...] — accepted proposals so far
    log_scale: Tensor  # f32[...] — log step-size scale (adaptation; 0 == reference)

    @property
    def accept_rate(self) -> Tensor:
        return self.n_accept / torch.clamp_min(self.step, 1)

    def map(self, fn) -> "MHState":
        """Apply ``fn`` to every tensor of the state."""
        costs = CostBreakdown(*(fn(getattr(self.costs, f)) for f in _COST_FIELDS))
        return MHState(fn(self.pose), costs, fn(self.key), fn(self.step), fn(self.n_accept),
                       fn(self.log_scale))

    def to(self, device) -> "MHState":
        return self.map(lambda t: t.to(device))

    def to_numpy(self) -> dict:
        """Field name -> numpy array, ``costs`` as a dict of its fields and
        ``key`` as uint32 words (the layout of ``jax.random.key_data``)."""

        def conv(t):
            return t.detach().cpu().numpy()

        return {
            "pose": conv(self.pose),
            "costs": {f: conv(getattr(self.costs, f)) for f in _COST_FIELDS},
            "key": prng.key_data(self.key),
            "step": conv(self.step),
            "n_accept": conv(self.n_accept),
            "log_scale": conv(self.log_scale),
        }


def mh_state_from_numpy(fields: Mapping, device=None) -> MHState:
    """The inverse of :meth:`MHState.to_numpy`: carries a state (e.g. an
    ``mh_tpu`` checkpoint with its key as ``jax.random.key_data``) into the
    port."""

    def t(a, dtype):
        return torch.as_tensor(np.array(a, dtype), device=device)

    costs = CostBreakdown(*(t(fields["costs"][f], np.float32) for f in _COST_FIELDS))
    return MHState(
        pose=t(fields["pose"], np.float32),
        costs=costs,
        key=prng.wrap_key_data(fields["key"], device),
        step=t(fields["step"], np.int32),
        n_accept=t(fields["n_accept"], np.int32),
        log_scale=t(fields["log_scale"], np.float32),
    )


def boltzmann_accept(key: Tensor, cost_star: Tensor, cost_cur: Tensor, beta) -> Tensor:
    """u < min(1, exp(beta * (cost_star - cost_cur))) (``Kernel.cu:706-713``).

    The positive sign is the reference's: a higher total is better.
    """
    u = prng.uniform(key)
    return u < torch.exp(torch.clamp_max(beta * (cost_star - cost_cur), 0.0))


class ChainStep:
    """One MH iteration for one (scene, config): propose -> cost -> accept
    (``Kernel.cu:785-828``), with the scene-static tables built once.

    ``with_off`` says whether the off-limits term is evaluated in the loop.
    The default decides it from the scene (a host read, once, here):
    skipped where it cannot change the total.
    """

    def __init__(self, scene: Scene, cfg: SamplerConfig, with_off: bool | None = None):
        self.scene, self.cfg = scene, cfg
        self.with_off = (not offlimits_unused(scene, cfg.mode)) if with_off is None else with_off
        self.tables = MoveTables.build(scene, cfg)
        self.beta = prng.f32(cfg.beta)
        self.adapt_rate = prng.f32(cfg.adapt_rate)
        self.target_accept = prng.f32(cfg.target_accept)

    def costs(self, pose: Tensor) -> CostBreakdown:
        return weighted_terms(pose, self.scene, self.cfg.mode, self.with_off)

    def init(self, pose: Tensor, key: Tensor, cost_fn=None) -> MHState:
        lead = pose.shape[:-2]
        dev = pose.device
        costs = self.costs(pose) if cost_fn is None else cost_fn(pose)
        return MHState(pose=pose, costs=costs, key=key,
                       step=torch.zeros(lead, dtype=torch.int32, device=dev),
                       n_accept=torch.zeros(lead, dtype=torch.int32, device=dev),
                       log_scale=torch.zeros(lead, dtype=torch.float32, device=dev))

    def __call__(self, state: MHState, beta=None, cost_fn=None) -> MHState:
        cfg = self.cfg
        key_step = prng.fold_in(state.key, state.step)
        u = prng.uniform(key_step, (cfg.n_moves_per_step, UNIFORMS_PER_MOVE))
        star = block_apply(u, state.pose, self.tables, torch.exp(state.log_scale))
        star_costs = self.costs(star) if cost_fn is None else cost_fn(star)
        b = self.beta if beta is None else beta
        ratio = torch.exp(torch.clamp_max(b * (star_costs.total - state.costs.total), 0.0))
        if cfg.accept_draws == 1:
            u_acc = u[..., 0, 1]  # the move block's reserved accept slot
        else:
            # accept iff ANY of K draws accepts == the minimum of K uniforms
            # (the reference's per-thread divergent Accept, Kernel.cu:819)
            u_acc = torch.amin(prng.uniform(prng.fold_in(key_step, 1), (cfg.accept_draws,)), -1)
        acc = u_acc < ratio

        costs = CostBreakdown(*(torch.where(acc, getattr(star_costs, f), getattr(state.costs, f))
                                for f in _COST_FIELDS))
        log_scale = state.log_scale
        if cfg.adapt:
            # Robbins-Monro drift toward the target acceptance rate
            log_scale = log_scale + self.adapt_rate * (acc.to(torch.float32) - self.target_accept)
        return MHState(
            pose=torch.where(acc[..., None, None], star, state.pose),
            costs=costs,
            key=state.key,
            step=state.step + 1,
            n_accept=state.n_accept + acc.to(torch.int32),
            log_scale=log_scale,
        )

    def finalize(self, state: MHState) -> MHState:
        return finalize_costs(state, self.scene, self.cfg)


def mh_init(pose: Tensor, scene: Scene, key: Tensor, mode: CostMode = CostMode.PARITY) -> MHState:
    """Initial state of the chains of ``pose`` f32[..., N, 6] keyed by
    ``key`` i64[..., 2]. Evaluates the off-limits term in FIXED (as
    ``mh_tpu`` does for a traced scene) and reads nothing to the host."""
    return ChainStep(scene, SamplerConfig(mode=mode), with_off=mode is CostMode.FIXED).init(
        pose, key)


def mh_step(state: MHState, scene: Scene, cfg: SamplerConfig, beta=None,
            cost_fn=None) -> MHState:
    """One MH iteration of every chain in ``state``.

    ``beta`` overrides ``cfg.beta`` (a float or a tensor broadcasting over
    the chains: parallel tempering's per-replica temperatures). ``cost_fn``
    replaces the objective (``pose -> CostBreakdown``). Reads nothing back
    to the host: in FIXED it evaluates the off-limits term, as ``mh_tpu``
    does for a traced scene. Runners build a :class:`ChainStep` once instead.
    """
    return ChainStep(scene, cfg, with_off=cfg.mode is CostMode.FIXED)(state, beta, cost_fn)


def finalize_costs(state: MHState, scene: Scene, cfg: SamplerConfig) -> MHState:
    """Fill in the OffLimits term the loop skips in PARITY (the reference
    leaves it out of the accept total, ``Kernel.cu:547``, but reports it,
    ``:142``): recomputed once on the final pose."""
    if cfg.mode is not CostMode.PARITY:
        return state
    off = scene.w_offlimits * off_limits_costs(state.pose, scene, cfg.mode)
    return dataclasses.replace(state, costs=dataclasses.replace(state.costs, off_limits=off))


def _validate_thin(thin: int, iterations: int) -> None:
    """The thin/iterations contract, enforced on every public path."""
    if thin < 1 or iterations % thin:
        raise ValueError(f"thin={thin} must be >= 1 and divide iterations={iterations}")


def chain_starts(key: Tensor, pose0: Tensor, scene: Scene, n_chains: int, first: int = 0):
    """(poses f32[C, N, 6], per-chain keys i64[C, 2]) of the chains ``first
    .. first + C - 1`` on the scene's device: chain ``c`` is keyed by
    ``fold_in(key, c)``, its global index; a shared ``pose0`` f32[N, 6]
    starts every chain, a per-chain one f32[n, N, 6] chain ``c`` at row c."""
    dev = scene.device
    keys = prng.fold_in(key.to(dev), torch.arange(first, first + n_chains, device=dev))
    pose0 = pose0.to(device=dev, dtype=torch.float32)
    if pose0.ndim == 2:
        pose0 = pose0.expand(n_chains, *pose0.shape)
    else:
        pose0 = pose0[first:first + n_chains]
    return pose0.contiguous(), keys


def _eager(step: ChainStep):
    def advance(state: MHState, n: int) -> MHState:
        for _ in range(n):
            state = step(state)
        return state

    return advance


def _run(advance, state: MHState, iterations: int, trace_costs: bool, trace_poses: bool,
         thin: int):
    """``iterations`` steps; with traces, a sample every ``thin`` steps."""
    if not (trace_costs or trace_poses):
        return advance(state, iterations), None
    costs, poses = [], []
    for _ in range(iterations // thin):
        state = advance(state, thin)
        costs.append(state.costs.total)
        poses.append(state.pose)
    dim = state.pose.ndim - 2  # the time axis follows the chain dims
    ct = torch.stack(costs, dim) if costs else state.costs.total.new_zeros(
        (*state.costs.total.shape, 0))
    pt = torch.stack(poses, dim) if poses else state.pose.new_zeros(
        (*state.pose.shape[:-2], 0, *state.pose.shape[-2:]))
    if trace_costs and trace_poses:
        return state, (ct, pt)
    return state, ct if trace_costs else pt


def run_chain(key: Tensor, pose0: Tensor, scene: Scene, cfg: SamplerConfig,
              trace_costs: bool = False, trace_poses: bool = False, thin: int = 1):
    """One chain keyed by ``key`` itself for ``cfg.iterations`` steps.

    Returns the final :class:`MHState` (no chain dim) and a trace:
    ``trace_costs`` gives f32[iterations//thin] accepted totals,
    ``trace_poses`` f32[iterations//thin, N, 6] poses (both: a tuple).
    """
    _validate_thin(thin, cfg.iterations)
    step = ChainStep(scene, cfg)
    dev = scene.device
    state = step.init(pose0.to(dev, torch.float32)[None], key.to(dev)[None])
    state, trace = _run(_eager(step), state, cfg.iterations, trace_costs, trace_poses, thin)
    state = step.finalize(state).map(lambda t: t[0])
    if trace is not None:
        trace = tuple(t[0] for t in trace) if isinstance(trace, tuple) else trace[0]
    return state, trace


def run_chains(key: Tensor, pose0: Tensor, scene: Scene, cfg: SamplerConfig,
               trace_costs: bool = False, trace_poses: bool = False, thin: int = 1):
    """Run ``cfg.n_chains`` independent chains on the scene's device.

    ``pose0`` is f32[N, 6] (every chain starts there) or f32[n_chains, N, 6].
    Returns the final :class:`MHState` (chains leading) and a trace as
    :func:`run_chain`'s, with the chains leading: f32[n_chains, T] and
    f32[n_chains, T, N, 6].
    """
    _validate_thin(thin, cfg.iterations)
    step = ChainStep(scene, cfg)
    state = step.init(*chain_starts(key, pose0, scene, cfg.n_chains))
    state, trace = _run(_eager(step), state, cfg.iterations, trace_costs, trace_poses, thin)
    return step.finalize(state), trace


def continue_chains(states: MHState, scene: Scene, cfg: SamplerConfig) -> MHState:
    """``cfg.iterations`` more steps from ``states`` — the resume half of
    checkpoint/resume. Bitwise equal to an uninterrupted run on one device:
    the step key is folded from ``(state.key, state.step)``, both carried
    in the state."""
    step = ChainStep(scene, cfg)
    states = states.to(scene.device)
    return step.finalize(_eager(step)(states, cfg.iterations))


@dataclasses.dataclass(frozen=True)
class StreamingMoments:
    """Welford accumulators for posterior moments, per chain: O(N*6) state
    instead of an O(T*N*6) pose trace."""

    n: Tensor  # f32[...] — samples folded in so far
    pose_mean: Tensor  # f32[..., N, 6]
    pose_m2: Tensor  # f32[..., N, 6] — sum of squared deviations
    cost_mean: Tensor  # f32[...]
    cost_m2: Tensor  # f32[...]

    @property
    def pose_var(self) -> Tensor:
        return self.pose_m2 / torch.clamp_min(self.n - 1.0, 1.0)[..., None, None]

    @property
    def cost_var(self) -> Tensor:
        return self.cost_m2 / torch.clamp_min(self.n - 1.0, 1.0)


def _moments_update(m: StreamingMoments, pose: Tensor, cost: Tensor, w: Tensor):
    """Gated Welford update (w = 0 skips, w = 1 folds the sample in)."""
    n = m.n + w
    n_safe = torch.clamp_min(n, 1.0)
    wp, np_ = w[..., None, None], n_safe[..., None, None]
    d_pose = pose - m.pose_mean
    pose_mean = m.pose_mean + wp * d_pose / np_
    pose_m2 = m.pose_m2 + wp * d_pose * (pose - pose_mean)
    d_cost = cost - m.cost_mean
    cost_mean = m.cost_mean + w * d_cost / n_safe
    cost_m2 = m.cost_m2 + w * d_cost * (cost - cost_mean)
    return StreamingMoments(n, pose_mean, pose_m2, cost_mean, cost_m2)


def run_chains_streaming(key: Tensor, pose0: Tensor, scene: Scene, cfg: SamplerConfig,
                         burn: int = 0):
    """Chains with streaming posterior statistics instead of a pose trace.

    Returns ``(states, moments)``: per-chain :class:`StreamingMoments` of
    every pose coordinate and of the accepted total over the steps after
    ``burn``, at constant memory.
    """
    step = ChainStep(scene, cfg)
    state = step.init(*chain_starts(key, pose0, scene, cfg.n_chains))
    zero = torch.zeros_like(state.costs.total)
    mom = StreamingMoments(zero, torch.zeros_like(state.pose), torch.zeros_like(state.pose),
                           zero, zero)
    for _ in range(cfg.iterations):
        state = step(state)
        w = (state.step > burn).to(torch.float32)
        mom = _moments_update(mom, state.pose, state.costs.total, w)
    return step.finalize(state), mom


class _GraphSteps:
    """One MH step captured as a CUDA graph on static state buffers.

    The graph computes a step from the buffers and copies the result back
    into them, so each replay advances every chain by one step; the
    kernels are the eager step's, so the results are bitwise the same.
    Captured at first use; a failed capture raises.
    """

    def __init__(self, step: ChainStep):
        self.step = step
        self.graph = None
        self.static = None

    @staticmethod
    def _copy_into(dst: MHState, src: MHState) -> None:
        dst.pose.copy_(src.pose)
        for f in _COST_FIELDS:
            getattr(dst.costs, f).copy_(getattr(src.costs, f))
        for name in ("key", "step", "n_accept", "log_scale"):
            getattr(dst, name).copy_(getattr(src, name))

    def _capture(self, state: MHState) -> None:
        self.static = state.map(torch.clone)
        side = torch.cuda.Stream(state.pose.device)
        side.wait_stream(torch.cuda.current_stream(state.pose.device))
        with torch.cuda.stream(side):
            for _ in range(2):  # warm-up: lazy initialisation stays out of the graph
                self.step(self.static)
        torch.cuda.current_stream(state.pose.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._copy_into(self.static, self.step(self.static))
        self.graph = graph

    def advance(self, state: MHState, n: int) -> MHState:
        if self.graph is None or self.static.pose.shape != state.pose.shape:
            self._capture(state)
        self._copy_into(self.static, state)
        for _ in range(n):
            self.graph.replay()
        return self.static.map(torch.clone)


def step_advance(step: ChainStep, graph: bool):
    """``advance(state, n) -> state``: ``n`` steps of ``step``, replayed as
    one captured CUDA graph when ``graph`` and the scene is on CUDA, else
    eager. Both give the same bits."""
    if graph and step.scene.device.type == "cuda":
        return _GraphSteps(step).advance
    return _eager(step)


def compile_chains(scene: Scene, cfg: SamplerConfig, trace_costs: bool = False,
                   trace_poses: bool = False, thin: int = 1):
    """A chain runner **specialized to one scene** (``mh_tpu``'s
    ``xla_specialized`` engine).

    Returns ``runner(key, pose0, iterations=None) -> (states, trace)`` with
    the semantics of :func:`run_chains`. On a CUDA scene the step is
    captured once as a CUDA graph (at the first call) and replayed each
    step, which removes the per-kernel launch cost; results are bitwise
    those of :func:`run_chains` on the same device. On the CPU the runner
    takes the same eager step (there is no graph there). Trace-free
    runners take an ``iterations=`` override per call.
    """
    traced = trace_costs or trace_poses
    _validate_thin(thin, cfg.iterations)
    step = ChainStep(scene, cfg)
    advance = step_advance(step, graph=True)

    def runner(key: Tensor, pose0: Tensor, iterations: int | None = None):
        if traced and iterations is not None:
            raise ValueError("iterations override needs a trace-free runner "
                             "(traces fix their length when the runner is built)")
        its = cfg.iterations if iterations is None else iterations
        _validate_thin(thin, its)
        state = step.init(*chain_starts(key, pose0, scene, cfg.n_chains))
        state, trace = _run(advance, state, its, trace_costs, trace_poses,
                            thin if traced else 1)
        return step.finalize(state), trace

    return runner
