"""Small cells for the CPU tests: configuration and traffic objects shaped
like the files under ``portbench/``, at toy sizes."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def scene_of(spec) -> dict:
    """A configuration's ``scene`` object from a port ``SceneSpec``."""
    def fl(a):
        return np.asarray(a, np.float64).tolist()

    return dict(
        positions=fl(spec.positions), sizes=fl(spec.sizes),
        frozen=np.asarray(spec.frozen, bool).tolist(), offlimit_quads=fl(spec.offlimit_quads),
        surface_quad=fl(spec.surface_quad), centroid=list(spec.centroid),
        focal=list(spec.focal), focal_rot=float(spec.focal_rot),
        **{k: float(getattr(spec, k)) for k in (
            "w_pairwise", "w_visual_balance", "w_focal", "w_symmetry", "w_clearance",
            "w_offlimits", "w_surface_area")},
        relationships=[list(r) for r in spec.relationships],
        angle_relationships=[list(r) for r in spec.angle_relationships],
        clearances=[[fl(q), int(i)] for q, i in spec.clearances])


def config(n: int = 8, mode: str = "parity", **weights) -> dict:
    from mh_tpu_torch.models.scene import demo_scene

    spec = demo_scene(n)
    for k, v in weights.items():
        setattr(spec, k, v)
    return dict(name=f"toy{n}_{mode}", mode=mode, precision="float32", reduced=[],
                scene=scene_of(spec))


def traffic(name: str, **sizes) -> dict:
    """The traffic file ``name`` cut to toy sizes; CPU runs take the fused
    kernel's plain version (``engine="auto"`` takes the torch engine on the
    CPU)."""
    t = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    if "sampler" in t and t["entry"] == "suggest_layouts":
        t["sampler"] = {**t["sampler"], "iterations": 20, "n_chains": 4, **sizes}
        t["engine"] = "fused"
    if "tempering" in t:
        t["tempering"] = {"n_replicas": 8, "exchange_every": 2, "rounds": 3, **sizes}
    t.update(warmup_calls=1, check_calls=2, trace_calls=2)
    return t


def cell(name: str, config_: dict, traffic_: dict, end_to_end=(), per_layer=()) -> dict:
    return dict(name=name, chips=1, config=config_, traffic=traffic_,
                end_to_end=list(end_to_end), per_layer=list(per_layer))
