"""Calls into ``libmh_tpu_torch.so`` from Python through ``ctypes``.

What a C or C# host does, for Python callers and checks: the wire structs
of :mod:`~mh_tpu_torch.native.bridge` into ``MHKernelWrapper``, and the
reference's structs (``ref_compat.h``, declared here as
``ctypes.Structure``) into ``KernelWrapper``. Each call drops the
interpreter lock; the library takes it again around its own calls into
Python, in this same interpreter.
"""

from __future__ import annotations

import ctypes

import numpy as np

from mh_tpu_torch.native import _build

_d, _f, _i = ctypes.c_double, ctypes.c_float, ctypes.c_int


class RefVertex(ctypes.Structure):
    _fields_ = [("x", _d), ("y", _d), ("z", _d)]


class RefRectangle(ctypes.Structure):
    _fields_ = [("point1Index", _i), ("point2Index", _i), ("point3Index", _i),
                ("point4Index", _i), ("SourceIndex", _i)]


class RefPositionAndRotation(ctypes.Structure):
    _fields_ = [("x", _d), ("y", _d), ("z", _d), ("rotX", _d), ("rotY", _d), ("rotZ", _d),
                ("frozen", ctypes.c_ubyte), ("length", _d), ("width", _d)]


class RefTargetRange(ctypes.Structure):
    _fields_ = [("targetRangeStart", _d), ("targetRangeEnd", _d)]


class RefRelationship(ctypes.Structure):
    _fields_ = [("TargetRange", RefTargetRange), ("SourceIndex", _i), ("TargetIndex", _i),
                ("DegreesOfAtrraction", _d)]


class RefRelationshipAngle(ctypes.Structure):
    _fields_ = [("angleMin", _d), ("angleMax", _d), ("SourceIndex", _i), ("TargetIndex", _i)]


class RefSurface(ctypes.Structure):
    _fields_ = [("nObjs", _i), ("nRelationships", _i), ("nClearances", _i),
                ("WeightFocalPoint", _f), ("WeightPairWise", _f), ("WeightVisualBalance", _f),
                ("WeightSymmetry", _f), ("WeightOffLimits", _f), ("WeightClearance", _f),
                ("WeightSurfaceArea", _f), ("centroidX", _d), ("centroidY", _d),
                ("focalX", _d), ("focalY", _d), ("focalRot", _d)]


class RefGpuConfig(ctypes.Structure):
    _fields_ = [("gridxDim", _i), ("gridyDim", _i), ("blockxDim", _i), ("blockyDim", _i),
                ("blockzDim", _i), ("iterations", _i)]


class RefPoint(ctypes.Structure):
    _fields_ = [(f, _f) for f in ("x", "y", "z", "rotX", "rotY", "rotZ")]


class RefResultCosts(ctypes.Structure):
    _fields_ = [(f, _f) for f in (
        "totalCosts", "PairWiseCosts", "VisualBalanceCosts", "FocalPointCosts", "SymmetryCosts",
        "ClearanceCosts", "OffLimitsCosts", "SurfaceAreaCosts")]


class RefResult(ctypes.Structure):
    _fields_ = [("points", ctypes.POINTER(RefPoint)), ("costs", RefResultCosts)]


REF_STRUCTS = {
    "ref_vertex": RefVertex, "ref_rectangle": RefRectangle,
    "ref_positionAndRotation": RefPositionAndRotation, "ref_targetRangeStruct": RefTargetRange,
    "ref_relationshipStruct": RefRelationship,
    "ref_relationshipAngleStruct": RefRelationshipAngle, "ref_Surface": RefSurface,
    "ref_gpuConfig": RefGpuConfig, "ref_point": RefPoint, "ref_resultCosts": RefResultCosts,
    "ref_result": RefResult,
}


def _ptr(buf) -> ctypes.c_void_p:
    return ctypes.cast(buf, ctypes.c_void_p)


def mh_kernel_wrapper(wire: tuple[bytes, ...]):
    """``MHKernelWrapper`` on the seven wire structs (``bridge.encode_wire``'s
    order): ``(rc, points f64[C, N, 6], costs f64[C, 8], accept f64[C])``.
    The arrays start as NaN, and the library writes them only where ``rc``
    is 0."""
    lib = _build.load()
    n = int(np.frombuffer(wire[0], np.int64, count=1)[0])
    chains = int(np.frombuffer(wire[6], np.int64, count=1)[0])
    ins = [ctypes.create_string_buffer(b, max(len(b), 1)) for b in wire]
    points = np.full((chains, n, 6), np.nan)
    costs = np.full((chains, 8), np.nan)
    accept = np.full(chains, np.nan)
    rc = lib.MHKernelWrapper(*map(_ptr, ins), points.ctypes.data, costs.ctypes.data,
                             accept.ctypes.data)
    return rc, points, costs, accept


def mh_device_report() -> tuple[int, str]:
    """``MHDeviceReport``: ``(rc, report)``."""
    buf = ctypes.create_string_buffer(4096)
    rc = _build.load().MHDeviceReport(buf, len(buf))
    return rc, buf.value.decode()


def reference_structs(spec, n_chains: int, block: int, iterations: int) -> dict:
    """A :class:`SceneSpec` in the reference's structs, filled as its
    ``main()`` fills them (``Kernel.cu:1003-1194``): a vertex pool holding
    each clearance's and then each object's off-limits quad, 4 consecutive
    vertices a rectangle; the surface weights travel as float. The
    reference sizes the angle array by ``nRelationships``, so the spec
    must have as many angle relationships as relationships."""
    n, rels, angs = spec.n_objs, list(spec.relationships), list(spec.angle_relationships)
    if len(angs) != len(rels):
        raise ValueError("the reference's structs carry as many angle relationships as "
                         f"relationships (got {len(angs)} and {len(rels)})")
    quads = [np.asarray(q, np.float64).reshape(4, 2) for q, _ in spec.clearances]
    quads += list(np.asarray(spec.offlimit_quads, np.float64).reshape(n, 4, 2))
    vertices = (RefVertex * (4 * len(quads)))(
        *[RefVertex(float(x), float(y), 0.0) for q in quads for x, y in q])
    rect = [RefRectangle(4 * k, 4 * k + 1, 4 * k + 2, 4 * k + 3, 0) for k in range(len(quads))]
    clearances = (RefRectangle * max(len(spec.clearances), 1))()
    for k, (_, src) in enumerate(spec.clearances):
        clearances[k] = rect[k]
        clearances[k].SourceIndex = src
    offlimits = (RefRectangle * n)(*rect[len(spec.clearances):])
    surface_rect = (RefVertex * 4)(
        *[RefVertex(float(x), float(y), 0.0) for x, y in np.asarray(spec.surface_quad)])
    positions, sizes = np.asarray(spec.positions, np.float64), np.asarray(spec.sizes, np.float64)
    cfg = (RefPositionAndRotation * n)(*[
        RefPositionAndRotation(*map(float, positions[i]), int(bool(spec.frozen[i])),
                               float(sizes[i, 0]), float(sizes[i, 1])) for i in range(n)])
    rss = (RefRelationship * max(len(rels), 1))(*[
        RefRelationship(RefTargetRange(lo, hi), src, tgt, 0.0) for src, tgt, lo, hi in rels])
    rsa = (RefRelationshipAngle * max(len(angs), 1))(*[
        RefRelationshipAngle(lo, hi, src, tgt) for src, tgt, lo, hi in angs])
    srf = RefSurface(
        nObjs=n, nRelationships=len(rels), nClearances=len(spec.clearances),
        WeightFocalPoint=spec.w_focal, WeightPairWise=spec.w_pairwise,
        WeightVisualBalance=spec.w_visual_balance, WeightSymmetry=spec.w_symmetry,
        WeightOffLimits=spec.w_offlimits, WeightClearance=spec.w_clearance,
        WeightSurfaceArea=spec.w_surface_area, centroidX=spec.centroid[0],
        centroidY=spec.centroid[1], focalX=spec.focal[0], focalY=spec.focal[1],
        focalRot=spec.focal_rot)
    gpu = RefGpuConfig(gridxDim=n_chains, blockxDim=block, iterations=iterations)
    return dict(rss=rss, rsa=rsa, cfg=cfg, clearances=clearances, offlimits=offlimits,
                vertices=vertices, surfaceRectangle=surface_rect, srf=srf, gpuCfg=gpu)


def kernel_wrapper(spec, n_chains: int, block: int, iterations: int):
    """The reference's ``KernelWrapper`` on ``spec`` (``gridxDim = n_chains``,
    ``blockxDim = block``; the seed is ``$MH_TPU_SEED``, else the wall
    clock): ``(points f32[C, N, 6], costs f32[C, 8])``, or None where the
    library returned NULL. The result is freed with ``KernelWrapperFree``."""
    s = reference_structs(spec, n_chains, block, iterations)
    lib = _build.load()
    res = lib.KernelWrapper(*(_ptr(ctypes.pointer(v) if isinstance(v, ctypes.Structure) else v)
                              for v in s.values()))
    if not res:
        return None
    try:
        results = ctypes.cast(res, ctypes.POINTER(RefResult * n_chains)).contents
        n = spec.n_objs
        points = np.ctypeslib.as_array(ctypes.cast(results[0].points, ctypes.POINTER(_f)),
                                       (n_chains, n, 6)).copy()
        costs = np.array([[getattr(r.costs, f) for f, _ in RefResultCosts._fields_]
                          for r in results], np.float32)
    finally:
        lib.KernelWrapperFree(res)
    return points, costs
