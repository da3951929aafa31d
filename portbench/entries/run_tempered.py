"""Entry: ``mh_tpu_torch.sampler.tempering.run_tempered``, parallel
tempering on the torch chain engine (BASELINE config 5), with no mesh.

Set-up builds the ``Scene`` and its start pose once; each call runs the
ladder's replicas from ``prng.key(key)`` and ends with the states
synchronised on the card. Its reference is the frozen engine's step and
replica exchange.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.entries.suggest_layouts import scene_spec
from portbench.reference import engine as re
from portbench.reference import fused as rf
from portbench.reference import scene as rs
from portbench.reference import threefry as tf


def sampler(config: dict) -> rf.Sampler:
    return rf.Sampler(parity=config["mode"] == "parity")


@dataclasses.dataclass
class Program:
    run: object
    key: object
    scene: object
    pose0: object
    cfg: object
    kwargs: dict


def setup(config: dict, traffic: dict, device: str) -> Program:
    from mh_tpu_torch.config import CostMode, SamplerConfig
    from mh_tpu_torch.sampler import prng
    from mh_tpu_torch.sampler.tempering import run_tempered

    spec = scene_spec(config["scene"])
    return Program(run_tempered, prng.key, spec.build(device=device),
                   spec.initial_pose(device=device), SamplerConfig(mode=CostMode(config["mode"])),
                   dict(traffic["tempering"]))


def call(p: Program, key: int):
    states, rates = p.run(p.key(key, p.scene.device), p.pose0, p.scene, p.cfg, mesh=None,
                          **p.kwargs)
    if states.pose.is_cuda:
        torch.cuda.synchronize(states.pose.device)
    return states, rates


def proposals(traffic: dict) -> int:
    t = traffic["tempering"]
    return t["n_replicas"] * t["exchange_every"] * t["rounds"]


def steps(traffic: dict) -> int:
    t = traffic["tempering"]
    return t["exchange_every"] * t["rounds"]


def record(traffic: dict, result) -> dict:
    states, _ = result
    return dict(pose=states.pose.float().cpu().numpy(),
                costs=states.costs.as_vector().float().cpu().numpy(),
                accepts=states.n_accept.cpu().numpy().astype(np.int64))


def expected(config: dict, traffic: dict, keys: list[int], device, dtype) -> list[dict]:
    """The reference's replicas of the calls keyed ``keys``, in ``dtype``,
    one call at a time (the engine's own shapes)."""
    scene = rs.build(config["scene"], device).astype(dtype)
    pose0 = rs.initial_pose(config["scene"], device).to(dtype)
    out = []
    for k in keys:
        st, _ = re.tempered(tf.key(k, device), pose0, scene, sampler(config),
                            **traffic["tempering"])
        out.append(dict(pose=st.pose.float().cpu().numpy(), costs=st.costs.float().cpu().numpy(),
                        accepts=st.n_accept.cpu().numpy().astype(np.int64)))
    return out


def objective(config: dict, traffic: dict, records: list[dict], device) -> list[np.ndarray]:
    """The reference's breakdown [K, 8] of each record's replicas."""
    scene = rs.build(config["scene"], device)
    parity = config["mode"] == "parity"
    return [re.weighted_terms(torch.as_tensor(r["pose"], device=device), scene, parity, True)
            .cpu().numpy() for r in records]
