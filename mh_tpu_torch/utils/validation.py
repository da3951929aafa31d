"""Scene validation and state health checks (counterpart of ``mh_tpu.utils.validation``).

:func:`validate_spec` checks a :class:`~mh_tpu_torch.models.scene.SceneSpec`
on the host before it is built (index bounds, shapes, finite poses, a
scene with something to move) with ``mh_tpu``'s messages in its order.
:func:`check_state_finite` checks a sampler state between runs. It reads
the state to the host, so it never runs inside a step: ``compile_chains``
captures the step as a CUDA graph, which no host read may enter.
"""

from __future__ import annotations

import numpy as np
import torch

from mh_tpu_torch.models.scene import SceneSpec


def validate_spec(spec: SceneSpec) -> list[str]:
    """Return a list of problems (empty == valid)."""
    errs: list[str] = []
    n = spec.n_objs
    pos = np.asarray(spec.positions)
    if pos.shape != (n, 6):
        errs.append(f"positions shape {pos.shape} != ({n}, 6)")
    if np.asarray(spec.sizes).shape != (n, 2):
        errs.append(f"sizes shape {np.asarray(spec.sizes).shape} != ({n}, 2)")
    if np.asarray(spec.frozen).shape != (n,):
        errs.append("frozen shape mismatch")
    if np.asarray(spec.offlimit_quads).reshape(-1, 4, 2).shape[0] != n:
        errs.append("offlimit_quads count != n_objs")
    if np.asarray(spec.surface_quad).reshape(-1, 2).shape[0] != 4:
        errs.append("surface_quad must have 4 vertices")
    if not np.isfinite(pos).all():
        errs.append("non-finite positions")

    for kind, rels in (
        ("relationship", spec.relationships),
        ("angle_relationship", spec.angle_relationships),
    ):
        for i, r in enumerate(rels):
            s, t = int(r[0]), int(r[1])
            if not (0 <= s < n and 0 <= t < n):
                errs.append(f"{kind}[{i}] index out of range: ({s}, {t})")
    for i, (quad, src) in enumerate(spec.clearances):
        if not 0 <= int(src) < n:
            errs.append(f"clearance[{i}] source index {src} out of range")
        if np.asarray(quad).reshape(-1, 2).shape[0] != 4:
            errs.append(f"clearance[{i}] quad must have 4 vertices")
    if bool(np.all(np.asarray(spec.frozen))) and n > 0:
        errs.append(
            "all objects frozen: proposals are no-ops (the reference would "
            "spin forever here, Kernel.cu:600-602)"
        )
    return errs


def require_valid(spec: SceneSpec) -> None:
    """Raise ``ValueError`` listing every problem :func:`validate_spec` finds."""
    errs = validate_spec(spec)
    if errs:
        raise ValueError("invalid scene: " + "; ".join(errs))


def check_state_finite(state) -> None:
    """Raise ``ValueError`` where a sampler state's pose or total cost holds
    a NaN or an infinity. A host-side check between runs (it reads two
    flags back), never inside a captured step."""
    if not bool(torch.isfinite(state.pose).all()):
        raise ValueError("non-finite pose in state")
    if not bool(torch.isfinite(state.costs.total).all()):
        raise ValueError("non-finite total cost")
