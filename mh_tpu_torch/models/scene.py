"""Scene data model: static-shaped, masked dataclasses of tensors.

The counterpart of ``mh_tpu.models.scene``: the reference wire structs
(``Kernel.cu:43-149``) as a struct of padded tensors with 0/1 masks.
Rectangles never rotate (``minValue``/``maxValue`` ignore rotation,
``Kernel.cu:366-401``), so each rect's local AABB is precomputed once.

The reference's ``minValue`` quirk — the first x-candidate is taken
*untranslated* (``Kernel.cu:371``) — is kept as two values per rect: the
first vertex's x (``v0x``) and the min over the other three (``tail_min_x``).

``scene_from_numpy`` / ``Scene.to_numpy`` carry a scene between this package
and ``mh_tpu`` as numpy arrays keyed by field name.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from mh_tpu_torch.config import CostMode

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RectSet:
    """Precomputed local AABBs for M axis-aligned rectangles (``f32[M]`` each)."""

    v0x: Tensor
    tail_min_x: Tensor
    min_x: Tensor
    min_y: Tensor
    max_x: Tensor
    max_y: Tensor

    def aabb(self, tx: Tensor, ty: Tensor, mode: CostMode):
        """AABB (min_x, min_y, max_x, max_y) after translating by (tx, ty).

        Parity: min_x = min(v0x, tail_min_x + tx) — the first vertex stays
        untranslated (``Kernel.cu:371-374``).
        """
        if mode is CostMode.PARITY:
            mnx = torch.minimum(self.v0x, self.tail_min_x + tx)
        else:
            mnx = self.min_x + tx
        return mnx, self.min_y + ty, self.max_x + tx, self.max_y + ty


def rects_from_vertices(
    vertices: np.ndarray, start_indices: Sequence[int], device=None
) -> RectSet:
    """Build a :class:`RectSet` from a flat vertex array + per-rect start index.

    Each rectangle is 4 consecutive vertices beginning at ``point1Index``
    (``Kernel.cu:366-401``, callers ``Kernel.cu:414``).
    """
    vertices = np.asarray(vertices, dtype=np.float64)
    idx = np.asarray(start_indices, dtype=np.int64)
    quads = np.stack([vertices[idx + k] for k in range(4)], axis=1)  # [M,4,>=2]
    xs, ys = quads[..., 0], quads[..., 1]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return RectSet(
        v0x=f32(xs[:, 0]),
        tail_min_x=f32(xs[:, 1:].min(axis=1)),
        min_x=f32(xs.min(axis=1)),
        min_y=f32(ys.min(axis=1)),
        max_x=f32(xs.max(axis=1)),
        max_y=f32(ys.max(axis=1)),
    )


def _pad_rects(r: RectSet, n: int) -> RectSet:
    return _map_tensors(r, lambda a: torch.nn.functional.pad(a, (0, n - a.shape[0])))


def _map_tensors(obj, fn):
    """Apply ``fn`` to every tensor leaf of a RectSet/Scene dataclass."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = _map_tensors(v, fn) if isinstance(v, RectSet) else fn(v)
    return type(obj)(**out)


@dataclasses.dataclass(frozen=True)
class Scene:
    """The static scene: everything except the mutable object poses.

    Replaces the reference's ``Surface`` + relationship/clearance/off-limits
    arrays (``Kernel.cu:79-117``); field for field the same as
    ``mh_tpu.models.scene.Scene``.
    """

    # objects
    obj_mask: Tensor  # f32[N] — 1 for real objects, 0 for padding
    frozen: Tensor  # bool[N] — never proposed (Kernel.cu:601)
    sizes: Tensor  # f32[N,2] — (length, width) (Kernel.cu:199)
    off_rects: RectSet  # per-object off-limits local AABBs (len N)
    # surface
    surface: RectSet  # len 1 (Kernel.cu:448-449)
    centroid: Tensor  # f32[2] (Kernel.cu:110-111)
    focal: Tensor  # f32[2] (Kernel.cu:114-115)
    focal_rot: Tensor  # f32[] — symmetry-axis direction (Kernel.cu:116)
    # weights (Surface.Weight*, Kernel.cu:101-107)
    w_pairwise: Tensor
    w_visual_balance: Tensor
    w_focal: Tensor
    w_symmetry: Tensor
    w_clearance: Tensor
    w_offlimits: Tensor
    w_surface_area: Tensor
    # distance relationships (Kernel.cu:79-85)
    rel_src: Tensor  # i32[R]
    rel_tgt: Tensor  # i32[R]
    rel_lo: Tensor  # f32[R]
    rel_hi: Tensor  # f32[R]
    rel_mask: Tensor  # f32[R]
    # angle relationships (Kernel.cu:87-92)
    ang_src: Tensor  # i32[A]
    ang_tgt: Tensor  # i32[A]
    ang_min: Tensor  # f32[A]
    ang_max: Tensor  # f32[A]
    ang_mask: Tensor  # f32[A]
    # clearances (rectangle + SourceIndex, Kernel.cu:50-57)
    clr_rects: RectSet  # len C
    clr_src: Tensor  # i32[C]
    clr_mask: Tensor  # f32[C]

    @property
    def n_pad_objs(self) -> int:
        return self.obj_mask.shape[0]

    @property
    def device(self) -> torch.device:
        return self.obj_mask.device

    def to(self, device) -> "Scene":
        return _map_tensors(self, lambda t: t.to(device))

    def surface_bounds(self):
        """(min_x, min_y, max_x, max_y) of the surface rectangle (untranslated,
        ``Kernel.cu:448-449,585-586``)."""
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        mnx, mny, mxx, mxy = self.surface.aabb(zero, zero, CostMode.FIXED)
        return mnx[0], mny[0], mxx[0], mxy[0]

    def to_numpy(self) -> dict:
        """Field name -> numpy array; RectSet fields become nested dicts."""

        def conv(v):
            if isinstance(v, RectSet):
                return {f.name: conv(getattr(v, f.name)) for f in dataclasses.fields(v)}
            return v.detach().cpu().numpy()

        return {f.name: conv(getattr(self, f.name)) for f in dataclasses.fields(self)}


def scene_from_numpy(fields: Mapping, device=None) -> Scene:
    """Build a :class:`Scene` from numpy arrays keyed by field name.

    The inverse of :meth:`Scene.to_numpy`; RectSet fields are mappings of
    their six arrays. Arrays keep their dtypes (f32 / i32 / bool), so the
    round trip is exact.
    """
    names = {f.name for f in dataclasses.fields(Scene)}
    if set(fields) != names:
        raise ValueError(
            f"scene fields mismatch: missing {sorted(names - set(fields))}, "
            f"unexpected {sorted(set(fields) - names)}"
        )

    def conv(v):
        if isinstance(v, Mapping):
            return RectSet(**{k: conv(a) for k, a in v.items()})
        return torch.as_tensor(np.array(v), device=device)

    return Scene(**{k: conv(v) for k, v in fields.items()})


@dataclasses.dataclass
class SceneSpec:
    """Host-side (NumPy) scene description; :meth:`build` pads it into a :class:`Scene`.

    The ergonomic equivalent of hand-filling the reference wire structs in
    ``main()`` (``Kernel.cu:1007-1194``).
    """

    positions: np.ndarray  # [n,6] (x,y,z,rotX,rotY,rotZ) — initial poses
    sizes: np.ndarray  # [n,2] (length,width)
    frozen: np.ndarray  # [n] bool
    offlimit_quads: np.ndarray  # [n,4,2] local off-limits rect vertices
    surface_quad: np.ndarray  # [4,2]
    centroid: tuple[float, float] = (0.0, 0.0)
    focal: tuple[float, float] = (0.0, 0.0)
    focal_rot: float = 0.0
    w_pairwise: float = 0.0
    w_visual_balance: float = 0.0
    w_focal: float = 0.0
    w_symmetry: float = 0.0
    w_clearance: float = 0.0
    w_offlimits: float = 0.0
    w_surface_area: float = 0.0
    # relationships: (src, tgt, lo, hi)
    relationships: Sequence[tuple[int, int, float, float]] = ()
    # angle relationships: (src, tgt, amin, amax)
    angle_relationships: Sequence[tuple[int, int, float, float]] = ()
    # clearances: (quad [4,2], source_index)
    clearances: Sequence[tuple[np.ndarray, int]] = ()

    @property
    def n_objs(self) -> int:
        return int(np.asarray(self.positions).shape[0])

    def build(
        self,
        pad_objs: int | None = None,
        pad_rels: int | None = None,
        pad_clearances: int | None = None,
        device=None,
    ) -> Scene:
        n = self.n_objs
        pn = pad_objs or max(n, 1)
        r = len(self.relationships)
        a = len(self.angle_relationships)
        pr = pad_rels or max(r, a, 1)
        c = len(self.clearances)
        pc = pad_clearances or max(c, 1)
        if pn < n or pr < max(r, a) or pc < c:
            raise ValueError("padding smaller than actual counts")

        def quad_rects(quads: np.ndarray) -> RectSet:
            quads = np.asarray(quads, dtype=np.float64).reshape(-1, 4, 2)
            starts = np.arange(quads.shape[0]) * 4
            return rects_from_vertices(quads.reshape(-1, 2), starts, device)

        def t(a, dtype=np.float32):
            return torch.as_tensor(np.asarray(a, dtype), device=device)

        def padf(vals, width, dtype=np.float32):
            out = np.zeros(width, dtype=dtype)
            out[: len(vals)] = vals
            return t(out, dtype)

        rel = np.asarray([list(x) for x in self.relationships], np.float64).reshape(r, 4)
        ang = np.asarray(
            [list(x) for x in self.angle_relationships], np.float64
        ).reshape(a, 4)
        clr_quads = (
            np.stack([np.asarray(q, np.float64) for q, _ in self.clearances])
            if c
            else np.zeros((1, 4, 2))
        )
        clr_src = np.asarray([s for _, s in self.clearances], np.int64)

        return Scene(
            obj_mask=padf(np.ones(n), pn),
            frozen=padf(np.asarray(self.frozen, bool), pn, dtype=bool),
            sizes=t(np.pad(np.asarray(self.sizes, np.float32), ((0, pn - n), (0, 0)))),
            off_rects=_pad_rects(quad_rects(self.offlimit_quads), pn),
            surface=quad_rects(np.asarray(self.surface_quad).reshape(1, 4, 2)),
            centroid=t(self.centroid),
            focal=t(self.focal),
            focal_rot=t(self.focal_rot),
            w_pairwise=t(self.w_pairwise),
            w_visual_balance=t(self.w_visual_balance),
            w_focal=t(self.w_focal),
            w_symmetry=t(self.w_symmetry),
            w_clearance=t(self.w_clearance),
            w_offlimits=t(self.w_offlimits),
            w_surface_area=t(self.w_surface_area),
            rel_src=padf(rel[:, 0], pr, np.int32),
            rel_tgt=padf(rel[:, 1], pr, np.int32),
            rel_lo=padf(rel[:, 2], pr),
            rel_hi=padf(rel[:, 3], pr),
            rel_mask=padf(np.ones(r), pr),
            ang_src=padf(ang[:, 0], pr, np.int32),
            ang_tgt=padf(ang[:, 1], pr, np.int32),
            ang_min=padf(ang[:, 2], pr),
            ang_max=padf(ang[:, 3], pr),
            ang_mask=padf(np.ones(a), pr),
            clr_rects=_pad_rects(quad_rects(clr_quads), pc),
            clr_src=padf(clr_src, pc, np.int32),
            clr_mask=padf(np.ones(c), pc),
        )

    def initial_pose(self, pad_objs: int | None = None, device=None) -> Tensor:
        pn = pad_objs or max(self.n_objs, 1)
        pose = np.zeros((pn, 6), np.float32)
        pose[: self.n_objs] = np.asarray(self.positions, np.float32)
        return torch.as_tensor(pose, device=device)


def _unit_quad(w: float, h: float, x0: float = 0.0, y0: float = 0.0) -> np.ndarray:
    """Axis-aligned quad in the reference's clockwise-from-top-right order."""
    return np.array(
        [[x0 + w, y0 + h], [x0 + w, y0], [x0, y0], [x0, y0 + h]], np.float64
    )


def demo_scene(n_objs: int = 32) -> SceneSpec:
    """The reference demo harness scene (``Kernel.cu:1003-1194``).

    N objects on a 10x10 surface placed along the diagonal at (2i, 2i), one
    distance relationship (0->1, [2,4]) and one angle relationship (0->1,
    [pi/4, 5pi/8]); two clearance rects anchored to objects 0 and 1;
    alternating 2x2 / offset-2x2 off-limits rects; the harness weight vector
    (``Kernel.cu:1014-1019``; the uninitialized ``WeightOffLimits`` is 0).
    """
    n = n_objs
    positions = np.zeros((n, 6))
    positions[:, 0] = np.arange(n) * 2.0
    positions[:, 1] = np.arange(n) * 2.0
    offquads = np.stack(
        [_unit_quad(2, 2) if i % 2 == 0 else _unit_quad(2, 2, x0=1.0) for i in range(n)]
    )
    return SceneSpec(
        positions=positions,
        sizes=np.ones((n, 2)),
        frozen=np.zeros(n, bool),
        offlimit_quads=offquads,
        surface_quad=_unit_quad(10, 10),
        centroid=(0.0, 0.0),
        focal=(5.0, 5.0),
        focal_rot=0.0,
        w_pairwise=-2.0,
        w_visual_balance=1.5,
        w_focal=-2.0,
        w_symmetry=-2.0,
        w_clearance=-2.0,
        w_offlimits=0.0,
        w_surface_area=-2.0,
        relationships=[(0, 1, 2.0, 4.0)],
        angle_relationships=[(0, 1, 3.1416 / 4, 5 * 3.1416 / 8)],
        clearances=[(_unit_quad(2, 2), 0), (_unit_quad(2, 2, x0=1.0), 1)],
    )
