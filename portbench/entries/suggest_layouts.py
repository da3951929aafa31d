"""Entry: ``mh_tpu_torch.api.suggest_layouts``, the port's main call.

With ``scene_per_call`` false, set-up builds the ``Scene`` and its start
pose once and each call passes them (a caller generating many suggestions
for one scene); with it true each call passes the ``SceneSpec`` itself, so
the scene is built and packed in every call (an interactive app). A call
ends with the layouts in numpy. Its reference is the fused chain's plain
version (``engine="auto"`` takes the fused kernel on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import fused as rf
from portbench.reference import scene as rs

ROWS_PER_BLOCK = 4096  # reference rows replayed at once


def scene_spec(scene: dict):
    """The program's ``SceneSpec`` of a configuration's scene."""
    from mh_tpu_torch.models.scene import SceneSpec

    floats = {k: float(v) for k, v in scene.items() if k.startswith("w_") or k == "focal_rot"}
    return SceneSpec(
        positions=np.asarray(scene["positions"], np.float64),
        sizes=np.asarray(scene["sizes"], np.float64),
        frozen=np.asarray(scene["frozen"], bool),
        offlimit_quads=np.asarray(scene["offlimit_quads"], np.float64),
        surface_quad=np.asarray(scene["surface_quad"], np.float64),
        centroid=tuple(scene["centroid"]), focal=tuple(scene["focal"]),
        relationships=[tuple(r) for r in scene.get("relationships", [])],
        angle_relationships=[tuple(r) for r in scene.get("angle_relationships", [])],
        clearances=[(np.asarray(q, np.float64), int(s)) for q, s in scene.get("clearances", [])],
        **floats)


def sampler(config: dict, traffic: dict) -> rf.Sampler:
    """The run's sampler settings as the reference reads them."""
    s = traffic["sampler"]
    return rf.Sampler(iterations=s["iterations"], n_moves_per_step=s.get("n_moves_per_step", 1),
                      accept_draws=s.get("accept_draws", 1), parity=config["mode"] == "parity")


@dataclasses.dataclass
class Program:
    call: object
    scene: object
    cfg: object
    pose0: object
    engine: str
    kwargs: dict


def setup(config: dict, traffic: dict, device: str) -> Program:
    from mh_tpu_torch.api import suggest_layouts
    from mh_tpu_torch.config import CostMode, SamplerConfig

    s = traffic["sampler"]
    cfg = SamplerConfig(iterations=s["iterations"], n_chains=s["n_chains"],
                        n_moves_per_step=s.get("n_moves_per_step", 1),
                        accept_draws=s.get("accept_draws", 1), mode=CostMode(config["mode"]))
    spec = scene_spec(config["scene"])
    kwargs = {} if device == "cuda" else {"device": device}
    if traffic["scene_per_call"]:
        return Program(suggest_layouts, spec, cfg, None, traffic["engine"], kwargs)
    return Program(suggest_layouts, spec.build(device=device), cfg,
                   spec.initial_pose(device=device), traffic["engine"], kwargs)


def call(p: Program, key: int):
    return p.call(p.scene, p.cfg, key, p.pose0, engine=p.engine, **p.kwargs)


def proposals(traffic: dict) -> int:
    s = traffic["sampler"]
    return s["n_chains"] * s["iterations"] * s.get("n_moves_per_step", 1)


def steps(traffic: dict) -> int:
    return traffic["sampler"]["iterations"]


def record(traffic: dict, result) -> dict:
    """The layouts of one call as the judge compares them."""
    return dict(pose=np.asarray(result.points, np.float32),
                costs=np.asarray(result.costs, np.float32),
                accepts=np.rint(np.asarray(result.accept_rate, np.float64)
                                * traffic["sampler"]["iterations"]).astype(np.int64))


def expected(config: dict, traffic: dict, keys: list[int], device, dtype) -> list[dict]:
    """The reference's layouts of the calls keyed ``keys``, in ``dtype``:
    every chain of every call, replayed in blocks of rows."""
    cfg = sampler(config, traffic)
    scene = rs.build(config["scene"], device)
    pk = rf.pack(scene, cfg, dtype)
    pose0 = rs.initial_pose(config["scene"], device).to(dtype)
    c = traffic["sampler"]["n_chains"]
    seeds = torch.as_tensor(np.repeat(np.asarray(keys, np.int64), c), device=device)
    chain_ids = torch.arange(c, device=device).repeat(len(keys))
    parts = []
    for lo in range(0, len(seeds), ROWS_PER_BLOCK):
        hi = min(lo + ROWS_PER_BLOCK, len(seeds))
        pose, br, n_acc, _ = rf.chains(pk, pose0.expand(hi - lo, *pose0.shape), seeds[lo:hi],
                                       chain_ids[lo:hi], cfg.iterations)
        parts.append((pose.float().cpu().numpy(), br.float().cpu().numpy(),
                      n_acc.cpu().numpy().astype(np.int64)))
    pose, costs, accepts = (np.concatenate(x) for x in zip(*parts))
    return [dict(pose=pose[i * c:(i + 1) * c], costs=costs[i * c:(i + 1) * c],
                 accepts=accepts[i * c:(i + 1) * c]) for i in range(len(keys))]


def objective(config: dict, traffic: dict, records: list[dict], device) -> list[np.ndarray]:
    """The reference's breakdown [C, 8] of each record's poses."""
    pk = rf.pack(rs.build(config["scene"], device), sampler(config, traffic))
    return [rf.breakdown(pk, torch.as_tensor(r["pose"], device=device)).cpu().numpy()
            for r in records]
