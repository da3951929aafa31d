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
from mh_tpu_torch.kernels.fused_mh import (
    kernel_takes, run_chains_fused, run_chains_fused_sharded, tracks_off,
)
from mh_tpu_torch.models.scene import Scene, SceneSpec, build_with_pose, host_twin
from mh_tpu_torch.parallel.mesh import CHAINS_AXIS, Mesh, chain_mesh
from mh_tpu_torch.parallel.objshard import OBJS_AXIS, run_chains_objsharded
from mh_tpu_torch.parallel.sharded import run_chains_sharded
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.mh import (
    ChainStep, chain_starts, compile_chains, run_chains, step_advance,
)
from mh_tpu_torch.utils.profiling import span
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
    A built scene passed call after call is copied to each card, packed
    and counted once while its tensors are unchanged (its memo,
    :meth:`Scene.memo`); a spec is built and packed afresh in every call,
    on the host, and goes to the card in two copies (the scene with the
    start pose, then the packing), with nothing read back before the
    kernel.

    ``key``: the integer seed (the torch engines key ``prng.key(key)`` as
    ``mh_tpu`` keys ``jax.random.key(key)``; the fused kernel seeds its
    counter-based stream with it).
    ``device``: where the chains run. Default: the first device of
    ``mesh``, else a built scene's own device; for a :class:`SceneSpec`,
    ``"cuda"``, which raises on a host without a CUDA device (the CPU is
    only ever chosen by name, as ``JAX_PLATFORMS`` chooses it for
    ``mh_tpu``).

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
      ``"torch_graph"``; with a mesh, ``"fused"`` or ``"torch"``
      (:func:`auto_engine`).

    ``serve`` is accepted for ``mh_tpu``'s signature and changes nothing:
    on the H100 the fused kernel is faster than the CUDA graph at every
    measured size, and the graph beats the eager engine within about 12
    steps a call (PERF.md).

    ``log``: a file path / file-like / :class:`RunLogger` receiving a JSONL
    event stream (``run_config`` + ``result``); with ``log_every > 0`` and
    no ``mesh`` the torch engines run in ``log_every``-step rounds (bitwise
    equal to one shot) with a ``round`` event after each; a sharded run is
    logged as one shot.

    ``mesh`` (a :class:`~mh_tpu_torch.parallel.mesh.Mesh` with a chains
    axis, e.g. ``chain_mesh()``): the chains split over its devices, on the
    fused kernel (one launch per shard, keyed by each shard's first global
    chain) or the ``torch`` engine (``torch_graph`` raises; so does a
    per-chain ``pose0`` there). Both are bitwise equal to one shard. With
    no ``mesh``, a CUDA run on a host with more than one card spans every
    card where the chains divide among them and ``pose0`` is shared. A
    mesh that spans processes raises: each process calls the sharded
    runners itself.

    ``objs_devices``: split the O(N^2) objective within each chain into
    this many row shards (:mod:`mh_tpu_torch.parallel.objshard`, the path
    past the fused kernel's object limit): over every card where their
    count is a multiple of it (the chains split over the groups), else all
    on the run's device; or pass a ``mesh`` that carries the objs axis
    (``chain_obj_mesh``). It takes the ``torch`` engine and one shared
    ``pose0``.
    """
    with span("mh.suggest_layouts"):
        if not isinstance(key, int) or isinstance(key, bool):
            raise TypeError(f"key must be an int seed, got {type(key).__name__}")
        engine = ENGINE_ALIASES.get(engine, engine)
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r} (use one of {ENGINES} or "
                             f"{tuple(ENGINE_ALIASES)})")

        logger = as_logger(log)
        try:
            res, engine_used = _dispatch_layouts(scene, cfg, key, pose0, engine, mesh,
                                                 objs_devices, logger, log_every, device)
            if logger is not None:
                logger.log_result(res, engine=engine_used)
            return res
        finally:
            if logger is not None and not isinstance(log, RunLogger):
                logger.close()


def _dispatch_layouts(scene, cfg, key, pose0, engine, mesh, objs_devices, logger, log_every,
                      device):
    if mesh is not None and mesh.spans_processes:
        raise ValueError("suggest_layouts runs in one process; for a mesh that spans processes "
                         "call run_chains_sharded or run_chains_fused_sharded in each process")
    if device is None and mesh is not None:
        device = mesh.devices.flat[0]
    if isinstance(scene, SceneSpec):
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU (the torch engine, "
                "or the fused kernel's plain PyTorch version)"
            )
        spec = scene
        with span("mh.scene_build"):
            if pose0 is None:
                scene, pose0 = build_with_pose(spec, device)
            else:
                scene = spec.build(device=device)
    if pose0 is None:
        raise ValueError("pose0 is required when passing a built Scene")
    device = scene.device if device is None else torch.device(device)
    scene = scene.to(device)
    n_real, n_clr = scene.memo("mask counts", lambda: _mask_counts(scene))
    shared_pose0 = pose0.ndim == 2

    def log_cfg(eng: str) -> None:
        if logger is not None:
            logger.log_config(cfg, engine=eng, n_objs=n_real, n_chains=cfg.n_chains)

    # the row-sharded objective: asked for by count, or by a mesh with the objs axis
    if objs_devices is not None and objs_devices > 1:
        if mesh is not None:
            raise ValueError("pass either objs_devices or a 2-D mesh, not both")
        mesh = _objs_mesh(device, objs_devices)
    if mesh is not None and mesh.shape.get(OBJS_AXIS, 1) > 1:
        if engine not in ("auto", "torch"):
            raise ValueError(f"objs-sharded sampling uses the torch engine (got {engine!r})")
        if not shared_pose0:
            raise ValueError("objs-sharded sampling needs one shared pose0 f32[N, 6]")
        log_cfg("torch_objsharded")
        states = run_chains_objsharded(prng.key(key, device), pose0, scene, cfg, mesh)
        return _result_from_state(states, n_real), "torch_objsharded"

    every_card = mesh is None and device.type == "cuda" and torch.cuda.device_count() > 1 and (
        cfg.n_chains % torch.cuda.device_count() == 0 and shared_pose0
        and engine in ("auto", "fused", "torch"))
    if every_card:
        mesh = chain_mesh()
    if engine == "auto":
        engine = auto_engine(device, cfg, scene.n_pad_objs, n_clr, tracks_off(scene, cfg),
                             None if mesh is None else len(mesh.axis_devices(CHAINS_AXIS)),
                             shared_pose0)
    log_cfg(engine)

    if engine == "fused":
        if mesh is None:
            out = run_chains_fused(key, pose0, scene, cfg, cfg.n_chains, cfg.iterations,
                                   device=device)
        else:
            out = run_chains_fused_sharded(key, pose0, scene, cfg, cfg.n_chains,
                                           cfg.iterations, mesh)
        pose, breakdown, n_acc, scale = out
        with span("mh.readback"):
            out = (pose[:, :n_real, :], breakdown, n_acc, scale)
            if pose.is_cuda:
                out = _read_pinned(out)
            pose, breakdown, n_acc, scale = out
            return LayoutResult(
                points=pose.numpy(),
                costs=breakdown.numpy(),
                accept_rate=n_acc.numpy().astype(np.float64) / max(cfg.iterations, 1),
                step_scale=scale.numpy(),
            ), engine

    if mesh is not None and engine == "torch_graph":
        raise ValueError("mesh sharding applies to engine='torch' (xla) only")
    if mesh is not None and not shared_pose0:
        raise ValueError("mesh sharding supports one shared pose0 (f32[N, 6]); per-chain "
                         "starts need the unsharded engine='torch'")
    tkey = prng.key(key, device)
    if logger is not None and log_every > 0 and (mesh is None or every_card):
        # rounds of the unsharded engine, as mh_tpu logs where the caller
        # passed no mesh: bitwise the sharded run (chains are keyed by
        # global index)
        states = _run_logged(scene, cfg, tkey, pose0, logger, log_every, engine == "torch_graph")
    elif mesh is not None:
        states = run_chains_sharded(tkey, pose0, scene, cfg, mesh)
    elif engine == "torch":
        states, _ = run_chains(tkey, pose0, scene, cfg)
    else:
        states, _ = compile_chains(scene, cfg)(tkey, pose0)
    return _result_from_state(states, n_real), engine


def _mask_counts(scene: Scene) -> tuple[int, int]:
    """The real objects and clearances, counted once per unchanged scene
    (its memo): on the host twin where the scene has one, else read back."""
    h = host_twin(scene)
    if h is not None:
        return int(np.sum(h["obj_mask"] > 0)), int(np.sum(h["clr_mask"] > 0))
    return int(torch.sum(scene.obj_mask > 0)), int(torch.sum(scene.clr_mask > 0))


def _objs_mesh(device: torch.device, k: int) -> Mesh:
    """``k`` objs shards in this process: over every card where their count
    is a multiple of ``k`` (chains split over the groups), else all on
    ``device``."""
    if device.type == "cuda" and torch.cuda.device_count() % k == 0:
        n = torch.cuda.device_count()
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        n, devices = k, [device] * k
    return Mesh(np.array(devices, dtype=object).reshape(n // k, k), (CHAINS_AXIS, OBJS_AXIS))


def _read_pinned(tensors):
    """``tensors`` (on one card) copied to the host into page-locked tensors
    from PyTorch's caching host allocator: every copy queued on the card's
    current stream, the kernel's, then one wait for all of them. Each block
    goes to the caller with its array and back to the allocator's cache when
    that is dropped, so calls in a loop reuse a few blocks (no allocation,
    mapping or page fault once warm) and a result the caller holds never
    changes. Opens ``mh.readback_pinned``, a range of no work."""
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    with span("mh.readback_pinned"):
        pass
    return host


def _result_from_state(states, n_real: int) -> LayoutResult:
    return LayoutResult(
        points=states.pose[:, :n_real, :].cpu().numpy(),
        costs=states.costs.as_vector().cpu().numpy(),
        accept_rate=states.accept_rate.cpu().numpy(),
        step_scale=np.exp(states.log_scale.cpu().numpy()),
    )


def auto_engine(device, cfg: SamplerConfig, n_pad_objs: int, n_clearances: int,
                track_off: bool, n_shards: int | None = None, shared_pose0: bool = True) -> str:
    """The ``engine="auto"`` decision, a pure function of the run's config
    (``track_off``: FIXED mode with an off-limits weight, ``tracks_off``,
    whose slab state takes more of the kernel's shared memory; ``n_shards``:
    the chains axis of the run's mesh, None without one; ``shared_pose0``:
    one start pose for every chain).

    On the CPU, ``"torch"`` (as ``mh_tpu`` picks its XLA scan off the TPU).
    On CUDA, ``"fused"`` wherever the kernel takes the config, else
    ``"torch_graph"``: on the H100 the fused kernel is faster than the CUDA
    graph at every measured size, and a call that captures the graph
    breaks even with the eager engine within about 4-12 steps at 100
    objects x 1024 chains (PERF.md), far below a sampling run's length.
    ``mh_tpu``'s crossovers were measured on a TPU and are not carried
    over.

    With a mesh, ``"fused"`` where the kernel takes the config, the shards
    divide the chains and ``pose0`` is shared, else the sharded ``"torch"``
    engine (a CUDA graph is not sharded).
    """
    if torch.device(device).type != "cuda":
        return "torch"
    takes = kernel_takes(cfg, n_pad_objs, n_clearances, track_off)
    if n_shards is None:
        return "fused" if takes else "torch_graph"
    return "fused" if takes and cfg.n_chains % n_shards == 0 and shared_pose0 else "torch"


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
