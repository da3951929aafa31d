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
from mh_tpu_torch.kernels.fused_mh import run_chains_fused
from mh_tpu_torch.models.scene import Scene, SceneSpec


@dataclasses.dataclass(frozen=True)
class LayoutResult:
    """One suggestion per chain (replaces ``result``/``point``, Kernel.cu:129-149)."""

    points: np.ndarray  # f32[n_chains, n_objs, 6] — (x,y,z,rotX,rotY,rotZ)
    costs: np.ndarray  # f32[n_chains, 8] — (total, pairwise, visual, focal,
    #                     symmetry, clearance, offlimits, surface), real values
    accept_rate: np.ndarray  # f64[n_chains]
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

    ``key``: the integer seed of the kernel's counter-based stream.
    ``device``: where the chains run — ``"cuda"`` launches the fused CUDA
    kernel, ``"cpu"`` runs its plain PyTorch version. Default: a built
    scene's device, else CUDA when a card is present.
    ``engine``: ``"auto"`` and ``"fused"`` both run the fused kernel, the
    port's one engine. ``serve`` changes nothing for it (it has no
    per-scene compile to amortize). The other engines and ``mesh``,
    ``objs_devices`` and ``log`` are not ported yet and raise
    ``NotImplementedError`` (ROADMAP Queue 1).
    """
    if not isinstance(key, int) or isinstance(key, bool):
        raise TypeError(f"key must be an int seed, got {type(key).__name__}")
    if engine in ("xla", "xla_specialized"):
        raise NotImplementedError(
            f"engine={engine!r}: the torch chain engine is not ported yet (ROADMAP Queue 1.5)"
        )
    if engine == "auto":
        engine = auto_engine()
    if engine != "fused":
        raise ValueError(f"unknown engine {engine!r} (use 'auto' or 'fused')")
    if mesh is not None or (objs_devices or 1) > 1:
        raise NotImplementedError("multi-GPU sampling is not ported yet (ROADMAP Queue 1.8)")
    if log is not None:
        raise NotImplementedError("run logging is not ported yet (ROADMAP Queue 1.11)")

    if isinstance(scene, SceneSpec):
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        spec = scene
        scene = spec.build(device=device)
        if pose0 is None:
            pose0 = spec.initial_pose(device=device)
    if pose0 is None:
        raise ValueError("pose0 is required when passing a built Scene")
    if device is None:
        device = scene.device

    pose, breakdown, n_acc, scale = run_chains_fused(
        key, pose0, scene, cfg, cfg.n_chains, cfg.iterations, device=device
    )
    n_real = int(torch.sum(scene.obj_mask > 0))
    return LayoutResult(
        points=pose[:, :n_real, :].cpu().numpy(),
        costs=breakdown.cpu().numpy(),
        accept_rate=n_acc.cpu().numpy().astype(np.float64) / max(cfg.iterations, 1),
        step_scale=scale.cpu().numpy(),
    )


def auto_engine() -> str:
    """The ``engine="auto"`` decision: the port has one engine, the fused
    kernel, so auto always picks it. (``mh_tpu``'s crossovers against its
    XLA scans were measured on a TPU and do not carry over.)"""
    return "fused"
