"""The scene as tensors, built from a configuration's ``scene`` object
(frozen from ``mh_tpu_torch/models/scene.py`` ``SceneSpec.build``, commit
97f1de5). The configuration file holds the fields of the port's
``SceneSpec`` by name; the reference reads them itself.

Rectangles never rotate, so each keeps its local AABB; the PARITY
``minValue`` quirk keeps the first vertex's x (``v0x``) apart from the
minimum over the other three (``tail_min_x``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BIG = 1e30  # the reference's DBL_MAX extents; only ever compared
WEIGHTS = ("w_pairwise", "w_visual_balance", "w_focal", "w_symmetry", "w_clearance",
           "w_offlimits", "w_surface_area")


@dataclasses.dataclass(frozen=True)
class Rects:
    v0x: torch.Tensor
    tail_min_x: torch.Tensor
    min_x: torch.Tensor
    min_y: torch.Tensor
    max_x: torch.Tensor
    max_y: torch.Tensor

    def aabb(self, tx, ty, parity: bool):
        """(min_x, min_y, max_x, max_y) translated by (tx, ty)."""
        mnx = torch.minimum(self.v0x, self.tail_min_x + tx) if parity else self.min_x + tx
        return mnx, self.min_y + ty, self.max_x + tx, self.max_y + ty


@dataclasses.dataclass(frozen=True)
class Scene:
    obj_mask: torch.Tensor  # [N]
    frozen: torch.Tensor  # bool [N]
    sizes: torch.Tensor  # [N, 2]
    off_rects: Rects  # [N]
    surface: Rects  # [1]
    centroid: torch.Tensor
    focal: torch.Tensor
    focal_rot: torch.Tensor
    w_pairwise: torch.Tensor
    w_visual_balance: torch.Tensor
    w_focal: torch.Tensor
    w_symmetry: torch.Tensor
    w_clearance: torch.Tensor
    w_offlimits: torch.Tensor
    w_surface_area: torch.Tensor
    rel_src: torch.Tensor  # int32 [R]
    rel_tgt: torch.Tensor
    rel_lo: torch.Tensor
    rel_hi: torch.Tensor
    rel_mask: torch.Tensor
    ang_src: torch.Tensor  # int32 [R]
    ang_tgt: torch.Tensor
    ang_min: torch.Tensor
    ang_max: torch.Tensor
    ang_mask: torch.Tensor
    clr_rects: Rects  # [C]
    clr_src: torch.Tensor  # int32 [C]
    clr_mask: torch.Tensor

    @property
    def n(self) -> int:
        return self.obj_mask.shape[0]

    @property
    def device(self):
        return self.obj_mask.device

    def surface_bounds(self):
        zero = torch.zeros((), dtype=self.obj_mask.dtype, device=self.device)
        mnx, mny, mxx, mxy = self.surface.aabb(zero, zero, parity=False)
        return mnx[0], mny[0], mxx[0], mxy[0]

    def astype(self, dtype) -> "Scene":
        """Every floating tensor in ``dtype``; indices and flags as they are."""
        return _map(self, lambda t: t.to(dtype) if t.is_floating_point() else t)


def _map(obj, fn):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = _map(v, fn) if isinstance(v, Rects) else fn(v)
    return type(obj)(**out)


def _rects(quads, n_pad: int, device) -> Rects:
    quads = np.asarray(quads, np.float64).reshape(-1, 4, 2)
    xs, ys = quads[..., 0], quads[..., 1]
    cols = (xs[:, 0], xs[:, 1:].min(axis=1), xs.min(axis=1), ys.min(axis=1), xs.max(axis=1),
            ys.max(axis=1))
    return Rects(*(torch.as_tensor(np.pad(np.asarray(c, np.float32), (0, n_pad - len(c))),
                                   device=device) for c in cols))


def build(spec: dict, device=None) -> Scene:
    """The scene of a configuration's ``scene`` object, on ``device``."""
    n = len(spec["positions"])
    rel = np.asarray(spec.get("relationships", []), np.float64).reshape(-1, 4)
    ang = np.asarray(spec.get("angle_relationships", []), np.float64).reshape(-1, 4)
    clr = spec.get("clearances", [])
    r, a, c = len(rel), len(ang), len(clr)
    pr, pc = max(r, a, 1), max(c, 1)

    def t(v, dtype=np.float32):
        return torch.as_tensor(np.asarray(v, dtype), device=device)

    def pad(vals, width, dtype=np.float32):
        out = np.zeros(width, dtype)
        out[:len(vals)] = vals
        return t(out, dtype)

    clr_quads = np.stack([np.asarray(q, np.float64) for q, _ in clr]) if c else np.zeros((1, 4, 2))
    return Scene(
        obj_mask=pad(np.ones(n), n),
        frozen=pad(np.asarray(spec["frozen"], bool), n, bool),
        sizes=t(spec["sizes"]),
        off_rects=_rects(spec["offlimit_quads"], n, device),
        surface=_rects([spec["surface_quad"]], 1, device),
        centroid=t(spec["centroid"]),
        focal=t(spec["focal"]),
        focal_rot=t(spec["focal_rot"]),
        **{w: t(spec[w]) for w in WEIGHTS},
        rel_src=pad(rel[:, 0], pr, np.int32),
        rel_tgt=pad(rel[:, 1], pr, np.int32),
        rel_lo=pad(rel[:, 2], pr),
        rel_hi=pad(rel[:, 3], pr),
        rel_mask=pad(np.ones(r), pr),
        ang_src=pad(ang[:, 0], pr, np.int32),
        ang_tgt=pad(ang[:, 1], pr, np.int32),
        ang_min=pad(ang[:, 2], pr),
        ang_max=pad(ang[:, 3], pr),
        ang_mask=pad(np.ones(a), pr),
        clr_rects=_rects(clr_quads, pc, device),
        clr_src=pad([s for _, s in clr], pc, np.int32),
        clr_mask=pad(np.ones(c), pc),
    )


def initial_pose(spec: dict, device=None) -> torch.Tensor:
    """f32[N, 6]: the configuration's start poses."""
    return torch.as_tensor(np.asarray(spec["positions"], np.float32), device=device)
