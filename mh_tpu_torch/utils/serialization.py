"""Scene and sampler-config (de)serialization: JSON on disk, SceneSpec in memory.

The same JSON schema as ``mh_tpu.utils.serialization`` (``SCHEMA_VERSION``
1), so a scene file written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np

from mh_tpu_torch.config import CostMode, SamplerConfig
from mh_tpu_torch.models.scene import SceneSpec

SCHEMA_VERSION = 1


def scene_to_dict(spec: SceneSpec) -> dict[str, Any]:
    return {
        "schema_version": SCHEMA_VERSION,
        "positions": np.asarray(spec.positions, np.float64).tolist(),
        "sizes": np.asarray(spec.sizes, np.float64).tolist(),
        "frozen": np.asarray(spec.frozen, bool).astype(int).tolist(),
        "offlimit_quads": np.asarray(spec.offlimit_quads, np.float64).tolist(),
        "surface_quad": np.asarray(spec.surface_quad, np.float64).tolist(),
        "centroid": list(spec.centroid),
        "focal": list(spec.focal),
        "focal_rot": spec.focal_rot,
        "weights": {
            "pairwise": spec.w_pairwise,
            "visual_balance": spec.w_visual_balance,
            "focal": spec.w_focal,
            "symmetry": spec.w_symmetry,
            "clearance": spec.w_clearance,
            "offlimits": spec.w_offlimits,
            "surface_area": spec.w_surface_area,
        },
        "relationships": [list(r) for r in spec.relationships],
        "angle_relationships": [list(a) for a in spec.angle_relationships],
        "clearances": [
            {"quad": np.asarray(q, np.float64).tolist(), "source": int(s)}
            for q, s in spec.clearances
        ],
    }


def scene_from_dict(d: dict[str, Any]) -> SceneSpec:
    if d.get("schema_version", 1) != SCHEMA_VERSION:
        raise ValueError(f"unsupported scene schema {d.get('schema_version')}")
    w = d.get("weights", {})
    return SceneSpec(
        positions=np.asarray(d["positions"], np.float64),
        sizes=np.asarray(d["sizes"], np.float64),
        frozen=np.asarray(d["frozen"], bool),
        offlimit_quads=np.asarray(d["offlimit_quads"], np.float64),
        surface_quad=np.asarray(d["surface_quad"], np.float64),
        centroid=tuple(d.get("centroid", (0.0, 0.0))),
        focal=tuple(d.get("focal", (0.0, 0.0))),
        focal_rot=float(d.get("focal_rot", 0.0)),
        w_pairwise=float(w.get("pairwise", 0.0)),
        w_visual_balance=float(w.get("visual_balance", 0.0)),
        w_focal=float(w.get("focal", 0.0)),
        w_symmetry=float(w.get("symmetry", 0.0)),
        w_clearance=float(w.get("clearance", 0.0)),
        w_offlimits=float(w.get("offlimits", 0.0)),
        w_surface_area=float(w.get("surface_area", 0.0)),
        relationships=[tuple(r) for r in d.get("relationships", [])],
        angle_relationships=[tuple(a) for a in d.get("angle_relationships", [])],
        clearances=[
            (np.asarray(c["quad"], np.float64), int(c["source"]))
            for c in d.get("clearances", [])
        ],
    )


def save_scene(path: str, spec: SceneSpec) -> None:
    with open(path, "w") as f:
        json.dump(scene_to_dict(spec), f, indent=1)


def load_scene(path: str) -> SceneSpec:
    with open(path) as f:
        return scene_from_dict(json.load(f))


def sampler_config_from_dict(d: dict[str, Any]) -> SamplerConfig:
    mode = CostMode(d.get("mode", "parity"))
    fields = {f.name for f in dataclasses.fields(SamplerConfig)}
    kwargs = {k: v for k, v in d.items() if k in fields and k != "mode"}
    return SamplerConfig(mode=mode, **kwargs)
