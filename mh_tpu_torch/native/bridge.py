"""Python side of the port's native C ABI (``wire.h``, ``kernel_wrapper.cpp``).

The counterpart of ``mh_tpu.native.bridge``: it decodes the same 8-byte
aligned wire structs with NumPy structured dtypes into a
:class:`~mh_tpu_torch.models.scene.SceneSpec` and a
:class:`~mh_tpu_torch.config.SamplerConfig`, runs
:func:`mh_tpu_torch.suggest_layouts` and returns the same flat f64 byte
buffer: points | cost breakdowns | accept rates.

The device is the ``device`` argument, else ``$MH_TPU_TORCH_DEVICE``, else
``"cuda"``: the C library passes none, so a host picks the CPU only by
setting the variable (as ``JAX_PLATFORMS=cpu`` picks it for ``mh_tpu``'s
library). Without a card the call raises and the C entry point returns
nonzero; nothing falls back to the CPU.
"""

from __future__ import annotations

import os

import numpy as np

DEVICE_ENV = "MH_TPU_TORCH_DEVICE"

POSE_DT = np.dtype(
    [
        ("x", "<f8"), ("y", "<f8"), ("z", "<f8"),
        ("rot_x", "<f8"), ("rot_y", "<f8"), ("rot_z", "<f8"),
        ("length", "<f8"), ("width", "<f8"),
        ("frozen", "<i8"),
    ]
)
REL_DT = np.dtype(
    [
        ("range_start", "<f8"), ("range_end", "<f8"),
        ("degrees_of_attraction", "<f8"),
        ("source_index", "<i8"), ("target_index", "<i8"),
    ]
)
ANG_DT = np.dtype(
    [
        ("angle_min", "<f8"), ("angle_max", "<f8"),
        ("source_index", "<i8"), ("target_index", "<i8"),
    ]
)
RECT_DT = np.dtype([("quad", "<f8", (8,)), ("source_index", "<i8")])
SURFACE_DT = np.dtype(
    [
        ("n_objs", "<i8"), ("n_relationships", "<i8"),
        ("n_angle_relationships", "<i8"), ("n_clearances", "<i8"),
        ("w_focal_point", "<f8"), ("w_pair_wise", "<f8"),
        ("w_visual_balance", "<f8"), ("w_symmetry", "<f8"),
        ("w_off_limits", "<f8"), ("w_clearance", "<f8"),
        ("w_surface_area", "<f8"),
        ("centroid_x", "<f8"), ("centroid_y", "<f8"),
        ("focal_x", "<f8"), ("focal_y", "<f8"), ("focal_rot", "<f8"),
        ("surface_quad", "<f8", (8,)),
    ]
)
CONFIG_DT = np.dtype(
    [
        ("n_chains", "<i8"), ("iterations", "<i8"), ("moves_per_step", "<i8"),
        ("accept_draws", "<i8"),
        ("parity_mode", "<i8"), ("seed", "<i8"), ("beta", "<f8"),
    ]
)
# the order of run_wire's arguments and of encode_wire's result
WIRE_DTYPES = (SURFACE_DT, REL_DT, ANG_DT, POSE_DT, RECT_DT, RECT_DT, CONFIG_DT)


def decode_wire(surface_b, rels_b, angs_b, poses_b, clr_b, off_b, cfg_b):
    """The wire structs as ``(SceneSpec, SamplerConfig, seed)``, by
    ``mh_tpu.native.bridge``'s rules: ``moves_per_step`` and
    ``accept_draws`` clamp to >= 1, ``beta <= 0`` selects ``REF_BETA`` and
    ``parity_mode`` picks PARITY (nonzero) or FIXED."""
    from mh_tpu_torch.config import REF_BETA, CostMode, SamplerConfig
    from mh_tpu_torch.models.scene import SceneSpec

    srf = np.frombuffer(surface_b, SURFACE_DT)[0]
    cfg = np.frombuffer(cfg_b, CONFIG_DT)[0]
    poses = np.frombuffer(poses_b, POSE_DT)
    rels = np.frombuffer(rels_b, REL_DT)
    angs = np.frombuffer(angs_b, ANG_DT)
    clrs = np.frombuffer(clr_b, RECT_DT)
    offs = np.frombuffer(off_b, RECT_DT)

    n = int(srf["n_objs"])
    positions = np.zeros((n, 6))
    for j, f in enumerate(["x", "y", "z", "rot_x", "rot_y", "rot_z"]):
        positions[:, j] = poses[f][:n]

    spec = SceneSpec(
        positions=positions,
        sizes=np.stack([poses["length"][:n], poses["width"][:n]], axis=1),
        frozen=poses["frozen"][:n] != 0,
        offlimit_quads=offs["quad"][:n].reshape(n, 4, 2),
        surface_quad=np.asarray(srf["surface_quad"]).reshape(4, 2),
        centroid=(float(srf["centroid_x"]), float(srf["centroid_y"])),
        focal=(float(srf["focal_x"]), float(srf["focal_y"])),
        focal_rot=float(srf["focal_rot"]),
        w_pairwise=float(srf["w_pair_wise"]),
        w_visual_balance=float(srf["w_visual_balance"]),
        w_focal=float(srf["w_focal_point"]),
        w_symmetry=float(srf["w_symmetry"]),
        w_clearance=float(srf["w_clearance"]),
        w_offlimits=float(srf["w_off_limits"]),
        w_surface_area=float(srf["w_surface_area"]),
        relationships=[
            (int(r["source_index"]), int(r["target_index"]),
             float(r["range_start"]), float(r["range_end"]))
            for r in rels
        ],
        angle_relationships=[
            (int(a["source_index"]), int(a["target_index"]),
             float(a["angle_min"]), float(a["angle_max"]))
            for a in angs
        ],
        clearances=[
            (np.asarray(c["quad"]).reshape(4, 2), int(c["source_index"]))
            for c in clrs
        ],
    )
    sampler_cfg = SamplerConfig(
        iterations=int(cfg["iterations"]),
        n_chains=int(cfg["n_chains"]),
        n_moves_per_step=max(int(cfg["moves_per_step"]), 1),
        accept_draws=max(int(cfg["accept_draws"]), 1),
        beta=float(cfg["beta"]) if float(cfg["beta"]) > 0 else REF_BETA,
        mode=CostMode.PARITY if int(cfg["parity_mode"]) else CostMode.FIXED,
    )
    return spec, sampler_cfg, int(cfg["seed"])


def run_wire(surface_b, rels_b, angs_b, poses_b, clr_b, off_b, cfg_b, device=None) -> bytes:
    """``MHKernelWrapper``'s body: the wire structs in, f64 points | costs |
    accept rates out (``device``: see the module docstring)."""
    from mh_tpu_torch.api import suggest_layouts

    spec, cfg, seed = decode_wire(surface_b, rels_b, angs_b, poses_b, clr_b, off_b, cfg_b)
    if device is None:
        device = os.environ.get(DEVICE_ENV) or "cuda"
    res = suggest_layouts(spec, cfg, key=seed, device=device)

    points = np.asarray(res.points, np.float64).reshape(-1)
    costs = np.asarray(res.costs, np.float64).reshape(-1)
    accept = np.asarray(res.accept_rate, np.float64).reshape(-1)
    return points.tobytes() + costs.tobytes() + accept.tobytes()


def encode_wire(spec, cfg, seed: int) -> tuple[bytes, ...]:
    """The wire structs of a :class:`SceneSpec`, a :class:`SamplerConfig`
    and a seed, in ``run_wire``'s argument order: what a C host fills in.
    ``beta`` and the mode travel as given; the step-size and sigma knobs
    that the wire has no field for must be at their defaults."""
    from mh_tpu_torch.config import CostMode, SamplerConfig

    extra = {f.name for f in SamplerConfig.__dataclass_fields__.values()
             if getattr(cfg, f.name) != f.default} - {
        "iterations", "n_chains", "n_moves_per_step", "accept_draws", "beta", "mode"}
    if extra:
        raise ValueError(f"the wire format has no field for {sorted(extra)}")
    n = spec.n_objs
    srf = np.zeros((), SURFACE_DT)
    srf["n_objs"] = n
    srf["n_relationships"] = len(spec.relationships)
    srf["n_angle_relationships"] = len(spec.angle_relationships)
    srf["n_clearances"] = len(spec.clearances)
    for field, value in (("w_focal_point", spec.w_focal), ("w_pair_wise", spec.w_pairwise),
                         ("w_visual_balance", spec.w_visual_balance),
                         ("w_symmetry", spec.w_symmetry), ("w_off_limits", spec.w_offlimits),
                         ("w_clearance", spec.w_clearance),
                         ("w_surface_area", spec.w_surface_area),
                         ("centroid_x", spec.centroid[0]), ("centroid_y", spec.centroid[1]),
                         ("focal_x", spec.focal[0]), ("focal_y", spec.focal[1]),
                         ("focal_rot", spec.focal_rot)):
        srf[field] = value
    srf["surface_quad"] = np.asarray(spec.surface_quad, np.float64).reshape(8)

    poses = np.zeros(n, POSE_DT)
    positions = np.asarray(spec.positions, np.float64)
    for j, f in enumerate(["x", "y", "z", "rot_x", "rot_y", "rot_z"]):
        poses[f] = positions[:, j]
    poses["length"], poses["width"] = np.asarray(spec.sizes, np.float64).T
    poses["frozen"] = np.asarray(spec.frozen, bool)

    rels = np.zeros(len(spec.relationships), REL_DT)
    for r, (src, tgt, lo, hi) in zip(rels, spec.relationships):
        r["source_index"], r["target_index"], r["range_start"], r["range_end"] = src, tgt, lo, hi
    angs = np.zeros(len(spec.angle_relationships), ANG_DT)
    for a, (src, tgt, lo, hi) in zip(angs, spec.angle_relationships):
        a["source_index"], a["target_index"], a["angle_min"], a["angle_max"] = src, tgt, lo, hi
    clrs = np.zeros(len(spec.clearances), RECT_DT)
    for c, (quad, src) in zip(clrs, spec.clearances):
        c["quad"], c["source_index"] = np.asarray(quad, np.float64).reshape(8), src
    offs = np.zeros(n, RECT_DT)
    offs["quad"] = np.asarray(spec.offlimit_quads, np.float64).reshape(n, 8)

    wire_cfg = np.zeros((), CONFIG_DT)
    wire_cfg["n_chains"], wire_cfg["iterations"] = cfg.n_chains, cfg.iterations
    wire_cfg["moves_per_step"], wire_cfg["accept_draws"] = cfg.n_moves_per_step, cfg.accept_draws
    wire_cfg["parity_mode"] = int(cfg.mode is CostMode.PARITY)
    wire_cfg["seed"], wire_cfg["beta"] = seed, cfg.beta
    return tuple(a.tobytes() for a in (srf, rels, angs, poses, clrs, offs, wire_cfg))


def device_report() -> str:
    """``MHDeviceReport``'s body: the CUDA devices and the default chain mesh."""
    from mh_tpu_torch.parallel.mesh import device_report as rep

    return rep()
