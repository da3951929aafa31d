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

A scene remembers what callers derive from it while its tensors stay as
they are (:meth:`Scene.memo`): its copy on each other device and, on
each device, the fused kernel's packed inputs and the counts read back to
the host, so a caller that passes one scene call after call reads and
uploads it once per device.

``SceneSpec.build`` forms every field in numpy and sends them to the device
in one copy (:func:`stage`); the scene keeps those host arrays in its memo
(:func:`host_twin`), so what would read its fields back reads them there
instead while none has been written.
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
    return RectSet(**{k: torch.as_tensor(a, device=device) for k, a in _quad_arrays(quads).items()})


def _quad_arrays(quads: np.ndarray) -> dict:
    """The six f32[M] fields of the rects of f64 ``quads`` [M, 4, >=2]."""
    xs, ys = quads[..., 0], quads[..., 1]

    def f32(a):
        return np.array(a, np.float32)

    return dict(
        v0x=f32(xs[:, 0]),
        tail_min_x=f32(xs[:, 1:].min(axis=1)),
        min_x=f32(xs.min(axis=1)),
        min_y=f32(ys.min(axis=1)),
        max_x=f32(xs.max(axis=1)),
        max_y=f32(ys.max(axis=1)),
    )


STAGE_ALIGN = 256  # bytes: each staged array starts where a card allocation would
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.int32): torch.int32,
                 np.dtype(np.bool_): torch.bool}


def stage(arrays: Sequence[np.ndarray], device=None) -> list:
    """``arrays`` (f32, i32 or bool) as tensors on ``device``, sent in one copy.

    Each array's bytes go to an aligned offset of one host buffer, page-locked
    from PyTorch's caching host allocator where ``device`` is a card, which
    goes to the device in one non-blocking copy on its current stream (the
    allocator keeps the block until the copy is done). Each tensor is a view
    of its own byte range of the one device buffer, with its array's dtype
    and shape; so the tensors share a version counter, and an in-place write
    to one bumps every one's. On the CPU the host buffer is that buffer.
    Nothing waits on the card.
    """
    device = torch.device("cpu" if device is None else device)
    parts, end = [], 0
    for a in arrays:
        c = np.ascontiguousarray(a)  # at least 1-d: a's own shape is kept apart
        parts.append((end, c.reshape(-1).view(np.uint8), a.shape,
                      [st // c.itemsize for st in c.strides[:a.ndim]], _TORCH_DTYPES[c.dtype]))
        end += -(-c.nbytes // STAGE_ALIGN) * STAGE_ALIGN
    host = torch.empty(end, dtype=torch.uint8, pin_memory=device.type == "cuda")
    raw = host.numpy()
    for o, b, _, _, _ in parts:
        raw[o:o + b.size] = b
    buf = host if device.type == "cpu" else host.to(device, non_blocking=True)
    typed, out = {}, []
    for o, b, shape, strides, dtype in parts:
        if dtype not in typed:
            typed[dtype] = buf.view(dtype)
        out.append(typed[dtype].as_strided(shape, strides, o // dtype.itemsize))
    return out


def _tensor_leaves(obj) -> list:
    """Every tensor of ``obj``: itself, or the leaves of a dataclass's fields."""
    if isinstance(obj, Tensor):
        return [obj]
    if isinstance(obj, Scene):
        return list(obj._get_memo().leaves)
    if not dataclasses.is_dataclass(obj):
        return []
    return [t for f in dataclasses.fields(obj) for t in _tensor_leaves(getattr(obj, f.name))]


def _stamp(tensors):
    """Each tensor's storage address and version counter (which torch bumps
    on every in-place write), or None for an inference tensor, which keeps
    no version."""
    try:
        return tuple((t.data_ptr(), t._version) for t in tensors)
    except RuntimeError:
        return None


def _normalise(device) -> torch.device:
    """``device`` as a tensor on it names it: ``"cuda"`` with the current
    card's index, ``"cpu"`` without one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if device.type == "cpu":
        return torch.device("cpu")
    return device


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

    A scene keeps a memo, outside its fields, of values derived from it
    (:meth:`memo`, :meth:`to`): each entry holds the storage address and
    version counter of every tensor of the scene and of the value, and
    counts only while none has changed. An in-place
    write through torch bumps a version, so the next call derives afresh;
    a write made outside torch (through ``.data``, or through a numpy view
    of a CPU tensor) is not seen, as the frozen dataclass promises no such
    write. The memo lives and dies with the scene and is left out of
    copies and pickles.
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
    def n_objs(self) -> Tensor:
        """i32[] — real objects, a device scalar (gates swaps, ``Kernel.cu:657``)."""
        return torch.sum(self.obj_mask).to(torch.int32)

    @property
    def device(self) -> torch.device:
        return self.obj_mask.device

    def to(self, device) -> "Scene":
        """This scene on ``device``: itself where every tensor is there
        already, else its copy there, made once and kept in the memo."""
        device = _normalise(device)
        leaves = self._get_memo().leaves
        if all(t.device == device for t in leaves):
            return self
        return self.memo(("to", device), lambda: _map_tensors(self, lambda t: t.to(device)))

    def memo_get(self, key):
        """The value stored under ``key`` if no tensor of this scene or of
        the value has been written or replaced since, else None."""
        memo = self._get_memo()
        entry = memo.entries.get(key)
        if entry is None:
            return None
        stamp, value, value_stamp = entry
        if stamp != _stamp(memo.leaves) or value_stamp != _stamp(_tensor_leaves(value)):
            return None
        return value

    def memo_put(self, key, value):
        """Store ``value`` under ``key``, stamped with the state of this
        scene's tensors and its own; returns ``value``. Inference tensors
        keep no version, so a value where either holds one is not stored."""
        memo = self._get_memo()
        stamp, value_stamp = _stamp(memo.leaves), _stamp(_tensor_leaves(value))
        if stamp is not None and value_stamp is not None:
            memo.entries[key] = (stamp, value, value_stamp)
        return value

    def memo(self, key, make):
        """The value under ``key`` (:meth:`memo_get`), made by ``make()``
        and stored where there is none."""
        value = self.memo_get(key)
        return self.memo_put(key, make()) if value is None else value

    def _get_memo(self) -> "_Memo":
        memo = self.__dict__.get("_memo")
        if memo is None:
            memo = _Memo(tuple(t for f in dataclasses.fields(self)
                               for t in _tensor_leaves(getattr(self, f.name))))
            object.__setattr__(self, "_memo", memo)
        return memo

    def __getstate__(self):
        return {k: v for k, v in self.__dict__.items() if k != "_memo"}

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


class _Memo:
    """A scene's tensors, in field order, and its memo entries: key ->
    (the tensors' stamp, value, the value's stamp)."""

    __slots__ = ("leaves", "entries")

    def __init__(self, leaves: tuple):
        self.leaves = leaves
        self.entries = {}


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
        """The padded :class:`Scene` on ``device``: every field is made in
        host memory, then all go to the device in one copy (:func:`stage`),
        each a view of its part of one buffer there. The scene keeps the
        host arrays in its memo (:func:`host_twin`), so what reads them
        back finds them on the host while no field has been written."""
        return _staged_scene(self._host_fields(pad_objs, pad_rels, pad_clearances), device)[0]

    def _host_fields(self, pad_objs, pad_rels, pad_clearances) -> dict:
        """Every field of the built scene as a new numpy array, keyed as
        :meth:`Scene.to_numpy` keys them (none is one of the spec's own)."""
        n = self.n_objs
        pn = pad_objs or max(n, 1)
        r = len(self.relationships)
        a = len(self.angle_relationships)
        pr = pad_rels or max(r, a, 1)
        c = len(self.clearances)
        pc = pad_clearances or max(c, 1)
        if pn < n or pr < max(r, a) or pc < c:
            raise ValueError("padding smaller than actual counts")

        def pad(vals, width, dtype=np.float32):
            out = np.zeros(width, dtype=dtype)
            out[: len(vals)] = vals
            return out

        def f64_quads(quads) -> np.ndarray:
            return np.asarray(quads, dtype=np.float64).reshape(-1, 4, 2)

        def f32(v):
            return np.array(v, np.float32)

        rel = np.asarray([list(x) for x in self.relationships], np.float64).reshape(r, 4)
        ang = np.asarray(
            [list(x) for x in self.angle_relationships], np.float64
        ).reshape(a, 4)
        clr_quads = [q for q, _ in self.clearances] if c else np.zeros((1, 4, 2))
        clr_src = np.asarray([s for _, s in self.clearances], np.int64)
        # the off-limits, surface and clearance rects in one pass
        quads = [f64_quads(q) for q in (self.offlimit_quads, self.surface_quad, clr_quads)]
        ends = np.cumsum([len(q) for q in quads])
        rects = [{k: v[lo:hi] for k, v in _quad_arrays(np.concatenate(quads)).items()}
                 for lo, hi in zip([0, *ends[:-1]], ends)]
        sizes = np.zeros((pn, 2), np.float32)
        sizes[:n] = np.asarray(self.sizes, np.float32)

        return dict(
            obj_mask=pad(np.ones(n), pn),
            frozen=pad(np.asarray(self.frozen, bool), pn, dtype=bool),
            sizes=sizes,
            off_rects={k: pad(v, pn) for k, v in rects[0].items()},
            surface=rects[1],
            centroid=f32(self.centroid),
            focal=f32(self.focal),
            focal_rot=f32(self.focal_rot),
            w_pairwise=f32(self.w_pairwise),
            w_visual_balance=f32(self.w_visual_balance),
            w_focal=f32(self.w_focal),
            w_symmetry=f32(self.w_symmetry),
            w_clearance=f32(self.w_clearance),
            w_offlimits=f32(self.w_offlimits),
            w_surface_area=f32(self.w_surface_area),
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
            clr_rects={k: pad(v, pc) for k, v in rects[2].items()},
            clr_src=pad(clr_src, pc, np.int32),
            clr_mask=pad(np.ones(c), pc),
        )

    def initial_pose(self, pad_objs: int | None = None, device=None) -> Tensor:
        return torch.as_tensor(self._pose_array(pad_objs), device=device)

    def _pose_array(self, pad_objs) -> np.ndarray:
        pn = pad_objs or max(self.n_objs, 1)
        pose = np.zeros((pn, 6), np.float32)
        pose[: self.n_objs] = np.asarray(self.positions, np.float32)
        return pose


_HOST_TWIN = "host twin"


def build_with_pose(spec: SceneSpec, device=None) -> tuple[Scene, Tensor]:
    """``(spec.build(device=device), spec.initial_pose(device=device))``,
    both sent to the device in one copy."""
    return _staged_scene(spec._host_fields(None, None, None), device, spec._pose_array(None))


def _staged_scene(fields: dict, device, *extra: np.ndarray) -> tuple:
    """The :class:`Scene` of ``fields`` (:meth:`Scene.to_numpy`'s layout) and
    the tensors of ``extra``, all sent to ``device`` in one copy; the scene
    keeps ``fields`` as its host twin."""
    arrays = [a for v in fields.values() for a in (v.values() if isinstance(v, dict) else (v,))]
    tensors = iter(stage(arrays + list(extra), device))
    scene = Scene(**{k: RectSet(**{f: next(tensors) for f in v}) if isinstance(v, dict)
                     else next(tensors) for k, v in fields.items()})
    scene.memo_put(_HOST_TWIN, fields)
    return (scene, *tensors)


def host_twin(scene: Scene) -> dict | None:
    """The host arrays a scene built from a :class:`SceneSpec` was sent from
    (:meth:`Scene.to_numpy`'s layout), while none of its tensors has been
    written in place since; else None (a scene of a caller's tensors, a copy
    made by :meth:`Scene.to`, a written scene, inference tensors). Read it,
    never write it."""
    return scene.memo_get(_HOST_TWIN)


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
