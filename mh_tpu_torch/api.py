"""Public API: scene in -> layout suggestions + real cost breakdowns out.

Counterpart of ``mh_tpu.api`` (the reference's ``KernelWrapper`` C ABI,
``Kernel.cu:873-984``): one suggested layout per chain, each with its real
weighted cost breakdown.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mh_tpu_torch.config import SamplerConfig
from mh_tpu_torch.kernels.fused_mh import kernel_takes, run_chains_fused, tracks_off
from mh_tpu_torch.models.scene import Scene, SceneSpec
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.mh import (
    ChainStep, chain_starts, compile_chains, run_chains, step_advance,
)
from mh_tpu_torch.utils.runlog import RunLogger, as_logger

ENGINES = ("auto", "torch", "torch_graph", "fused")
# mh_tpu's names for the same two engines: its XLA scan and the scan
# compiled with the scene baked in
ENGINE_ALIASES = {"xla": "torch", "xla_specialized": "torch_graph"}


@dataclasses.dataclass(frozen=True)
class LayoutResult:
    """One suggestion per chain (replaces ``result``/``point``, Kernel.cu:129-149)."""

    points: np.ndarray  # f32[n_chains, n_objs, 6] — (x,y,z,rotX,rotY,rotZ)
    costs: np.ndarray  # f32[n_chains, 8] — (total, pairwise, visual, focal,
    #                     symmetry, clearance, offlimits, surface), real values
    accept_rate: np.ndarray  # f32[n_chains] (torch engines); f64 (fused)
    step_scale: np.ndarray  # f32[n_chains] — final adapted step-size scale

    COST_FIELDS = (
        "total",
        "pair_wise",
        "visual_balance",
        "focal_point",
        "symmetry",
        "clearance",
        "off_limits",
        "surface_area",
    )


def suggest_layouts(
    scene: Scene | SceneSpec,
    cfg: SamplerConfig,
    key: int = 0,
    pose0: torch.Tensor | None = None,
    engine: str = "auto",
    mesh=None,
    serve: bool = False,
    objs_devices: int | None = None,
    log=None,
    log_every: int = 0,
    device=None,
) -> LayoutResult:
    """Run ``cfg.n_chains`` MH chains and return their final layouts.

    Accepts a :class:`SceneSpec` (initial poses taken from the spec) or a
    built :class:`Scene` with ``pose0`` (f32[N, 6] or f32[n_chains, N, 6]).

    ``key``: the integer seed (the torch engines key ``prng.key(key)`` as
    ``mh_tpu`` keys ``jax.random.key(key)``; the fused kernel seeds its
    counter-based stream with it).
    ``device``: where the chains run. Default: a built scene's own device;
    for a :class:`SceneSpec`, ``"cuda"``, which raises on a host without a
    CUDA device (the CPU is only ever chosen by name, as ``JAX_PLATFORMS``
    chooses it for ``mh_tpu``).

    ``engine``:

    - ``"torch"`` (or ``mh_tpu``'s name ``"xla"``): the chain engine of
      :mod:`mh_tpu_torch.sampler.mh`, on any device, on ``mh_tpu``'s own
      random stream;
    - ``"torch_graph"`` (or ``"xla_specialized"``): the same engine
      specialized to the scene — on CUDA its step is captured once as a
      CUDA graph; bitwise equal to ``"torch"``;
    - ``"fused"``: the fused CUDA kernel (its plain PyTorch version on the
      CPU), on its own counter-based stream;
    - ``"auto"``: chosen from the config before anything runs — on the
      CPU ``"torch"``; on CUDA ``"fused"`` wherever the kernel takes the
      config (``accept_draws`` <= 120 and its shared-memory bound), else
      ``"torch_graph"``.

    ``serve`` is accepted for ``mh_tpu``'s signature and changes nothing:
    on the H100 the fused kernel is faster than the CUDA graph at every
    measured size, and the graph beats the eager engine within about 12
    steps a call (PERF.md).

    ``log``: a file path / file-like / :class:`RunLogger` receiving a JSONL
    event stream (``run_config`` + ``result``); with ``log_every > 0`` the
    torch engines run in ``log_every``-step rounds (bitwise equal to one
    shot) with a ``round`` event after each. ``mesh`` and
    ``objs_devices`` (multi-GPU) are not ported yet and raise
    ``NotImplementedError`` (ROADMAP Queue 1.8).
    """
    if not isinstance(key, int) or isinstance(key, bool):
        raise TypeError(f"key must be an int seed, got {type(key).__name__}")
    engine = ENGINE_ALIASES.get(engine, engine)
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (use one of {ENGINES} or "
                         f"{tuple(ENGINE_ALIASES)})")
    if mesh is not None or (objs_devices or 1) > 1:
        raise NotImplementedError("multi-GPU sampling is not ported yet (ROADMAP Queue 1.8)")

    logger = as_logger(log)
    try:
        res, engine_used = _dispatch_layouts(scene, cfg, key, pose0, engine, logger, log_every,
                                             device)
        if logger is not None:
            logger.log_result(res, engine=engine_used)
        return res
    finally:
        if logger is not None and not isinstance(log, RunLogger):
            logger.close()


def _dispatch_layouts(scene, cfg, key, pose0, engine, logger, log_every, device):
    if isinstance(scene, SceneSpec):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU (the torch engine, "
                "or the fused kernel's plain PyTorch version)"
            )
        spec = scene
        scene = spec.build(device=device)
        if pose0 is None:
            pose0 = spec.initial_pose(device=device)
    if pose0 is None:
        raise ValueError("pose0 is required when passing a built Scene")
    device = scene.device if device is None else torch.device(device)
    scene = scene.to(device)
    n_real = int(torch.sum(scene.obj_mask > 0))

    if engine == "auto":
        n_clr = int(torch.sum(scene.clr_mask > 0))
        engine = auto_engine(device, cfg, scene.n_pad_objs, n_clr, tracks_off(scene, cfg))
    if logger is not None:
        logger.log_config(cfg, engine=engine, n_objs=n_real, n_chains=cfg.n_chains)

    if engine == "fused":
        pose, breakdown, n_acc, scale = run_chains_fused(
            key, pose0, scene, cfg, cfg.n_chains, cfg.iterations, device=device
        )
        return LayoutResult(
            points=pose[:, :n_real, :].cpu().numpy(),
            costs=breakdown.cpu().numpy(),
            accept_rate=n_acc.cpu().numpy().astype(np.float64) / max(cfg.iterations, 1),
            step_scale=scale.cpu().numpy(),
        ), engine

    tkey = prng.key(key, device)
    if logger is not None and log_every > 0:
        states = _run_logged(scene, cfg, tkey, pose0, logger, log_every, engine == "torch_graph")
    elif engine == "torch":
        states, _ = run_chains(tkey, pose0, scene, cfg)
    else:
        states, _ = compile_chains(scene, cfg)(tkey, pose0)
    return LayoutResult(
        points=states.pose[:, :n_real, :].cpu().numpy(),
        costs=states.costs.as_vector().cpu().numpy(),
        accept_rate=states.accept_rate.cpu().numpy(),
        step_scale=np.exp(states.log_scale.cpu().numpy()),
    ), engine


def auto_engine(device, cfg: SamplerConfig, n_pad_objs: int, n_clearances: int,
                track_off: bool) -> str:
    """The ``engine="auto"`` decision, a pure function of the run's config
    (``track_off``: FIXED mode with an off-limits weight, ``tracks_off``,
    whose slab state takes more of the kernel's shared memory).

    On the CPU, ``"torch"`` (as ``mh_tpu`` picks its XLA scan off the TPU).
    On CUDA, ``"fused"`` wherever the kernel takes the config, else
    ``"torch_graph"``: on the H100 the fused kernel is faster than the CUDA
    graph at every measured size, and a call that captures the graph
    breaks even with the eager engine within about 4-12 steps at 100
    objects x 1024 chains (PERF.md), far below a sampling run's length.
    ``mh_tpu``'s crossovers were measured on a TPU and are not carried
    over.
    """
    if torch.device(device).type != "cuda":
        return "torch"
    if kernel_takes(cfg, n_pad_objs, n_clearances, track_off):
        return "fused"
    return "torch_graph"


def _run_logged(scene, cfg, key, pose0, logger, log_every, graph):
    """The torch engine (as a CUDA graph when ``graph``) in
    ``log_every``-step rounds with a ``round`` event after each — the same
    steps as the one-shot run, so bitwise equal to it."""
    step = ChainStep(scene, cfg)
    advance = step_advance(step, graph)
    state = step.init(*chain_starts(key, pose0, scene, cfg.n_chains))
    done, rnd = 0, 0
    while rnd == 0 or done < cfg.iterations:
        n = min(log_every, cfg.iterations - done)
        state = advance(state, n)
        done += n
        logger.log_round(rnd, done, step.finalize(state))
        rnd += 1
    return step.finalize(state)
