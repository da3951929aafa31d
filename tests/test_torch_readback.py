"""The fused result's readback into the ``LayoutResult``.

On a card ``suggest_layouts`` copies the result into page-locked host
memory with one wait for every copy and opens ``mh.readback_pinned``;
tests/test_torch_cuda.py holds that path. On the CPU the result is read as
it always was: these tests hold the arrays to the plain ``.cpu().numpy()``
readback of the same outputs, and show that no call's arrays share memory
with another's and that no ``mh.readback_pinned`` range opens.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import mh_tpu_torch
from mh_tpu_torch.config import CostMode, SamplerConfig
from mh_tpu_torch.kernels import fused_mh as TF
from mh_tpu_torch.parallel.mesh import chain_mesh

import test_torch_threads  # noqa: F401

SPEC = dataclasses.replace(mh_tpu_torch.demo_scene(6), w_offlimits=-1.5)
FIELDS = ("points", "costs", "accept_rate", "step_scale")
CFGS = {"parity": SamplerConfig(iterations=12, n_chains=4),
        "weighted_fixed": SamplerConfig(iterations=12, n_chains=4, mode=CostMode.FIXED)}


def call(scene, pose0, cfg, key, **kw):
    return mh_tpu_torch.suggest_layouts(scene, cfg, key=key, pose0=pose0, engine="fused",
                                        device="cpu", **kw)


@pytest.mark.parametrize("pad", [None, 8], ids=["unpadded", "padded"])
@pytest.mark.parametrize("mode", list(CFGS))
def test_cpu_result_is_the_plain_readback(mode, pad):
    """Each field has the dtype, shape, C-contiguity and bits of the
    ``.cpu().numpy()`` readback of the fused run's own outputs."""
    cfg = CFGS[mode]
    scene, pose0 = SPEC.build(pad_objs=pad), SPEC.initial_pose(pad_objs=pad)
    got = call(scene, pose0, cfg, 7)
    pose, breakdown, n_acc, scale = TF.run_chains_fused(7, pose0, scene, cfg, cfg.n_chains,
                                                        cfg.iterations, device="cpu")
    want = {"points": pose[:, :SPEC.n_objs, :].cpu().numpy(),
            "costs": breakdown.cpu().numpy(),
            "accept_rate": n_acc.cpu().numpy().astype(np.float64) / cfg.iterations,
            "step_scale": scale.cpu().numpy()}
    assert (got.accept_rate > 0).any()
    for field in FIELDS:
        g, w = getattr(got, field), want[field]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), field
        assert g.flags["C_CONTIGUOUS"] == w.flags["C_CONTIGUOUS"], field
        assert g.tobytes() == w.tobytes(), field
    assert got.points.shape == (cfg.n_chains, SPEC.n_objs, 6)
    assert got.points.dtype == got.costs.dtype == got.step_scale.dtype == np.float32


@pytest.mark.parametrize("shards", [None, 2])
def test_successive_results_share_no_memory(shards):
    """A held result's arrays are its own: the next calls (other keys, the
    same scene) share no memory with them and leave their bits as they
    were."""
    mesh = None if shards is None else chain_mesh(devices=["cpu"] * shards)
    scene, pose0, cfg = SPEC.build(), SPEC.initial_pose(), CFGS["parity"]
    first = call(scene, pose0, cfg, 1, mesh=mesh)
    kept = {f: getattr(first, f).copy() for f in FIELDS}
    second = call(scene, pose0, cfg, 2, mesh=mesh)
    third = call(scene, pose0, cfg, 3, mesh=mesh)
    for field in FIELDS:
        for a, b in ((first, second), (second, third), (first, third)):
            assert not np.shares_memory(getattr(a, field), getattr(b, field)), field
        assert getattr(first, field).tobytes() == kept[field].tobytes(), field
    assert first.points.tobytes() != second.points.tobytes()


@pytest.mark.parametrize("shards", [None, 2])
def test_cpu_result_opens_no_pinned_range(shards):
    """``mh.readback`` opens once per call; ``mh.readback_pinned`` never
    does on a CPU result, with or without a mesh."""
    mesh = None if shards is None else chain_mesh(devices=["cpu"] * shards)
    scene, pose0 = SPEC.build(), SPEC.initial_pose()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for key in (4, 5):
            call(scene, pose0, CFGS["weighted_fixed"], key, mesh=mesh)
    names = [e.name for e in prof.events() if e.name.startswith("mh.readback")]
    assert names == ["mh.readback"] * 2
