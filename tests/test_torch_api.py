"""mh_tpu_torch.suggest_layouts against mh_tpu.suggest_layouts, its argument
contract, and the package's independence from JAX."""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import mh_tpu
import mh_tpu_torch
from mh_tpu_torch.api import LayoutResult, auto_engine
from mh_tpu_torch.kernels import fused_mh as TF

# tests/test_torch_fused.py states these and why a few chains may part
RTOL, ATOL, POSE_ATOL, MAX_DIVERGENT = 2e-4, 2e-3, 1e-4, 2


def test_fused_engine_matches_mh_tpu():
    cfg_j = mh_tpu.SamplerConfig(iterations=50, n_chains=8)
    cfg_t = mh_tpu_torch.SamplerConfig(iterations=50, n_chains=8)
    want = mh_tpu.suggest_layouts(mh_tpu.demo_scene(32), cfg_j, key=4, engine="fused")
    got = mh_tpu_torch.suggest_layouts(
        mh_tpu_torch.demo_scene(32), cfg_t, key=4, engine="fused", device="cpu")
    assert LayoutResult.COST_FIELDS == mh_tpu.LayoutResult.COST_FIELDS
    for field in ("points", "costs", "accept_rate", "step_scale"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.shape == w.shape, field
        assert g.dtype == w.dtype, field
    same = (got.accept_rate == want.accept_rate) & (
        np.abs(got.points - want.points).max(axis=(1, 2)) <= POSE_ATOL)
    assert (~same).sum() <= MAX_DIVERGENT
    np.testing.assert_allclose(got.costs[same], want.costs[same], rtol=RTOL, atol=ATOL)
    assert np.isfinite(got.costs).all() and (got.accept_rate > 0.1).all()


def test_auto_is_fused_and_runs_the_plain_version_on_cpu():
    assert auto_engine() == "fused"
    calls = TF.fused_chains_reference.calls
    spec = mh_tpu_torch.demo_scene(10)
    res = mh_tpu_torch.suggest_layouts(
        spec, mh_tpu_torch.SamplerConfig(iterations=20, n_chains=4), key=1, device="cpu")
    assert TF.fused_chains_reference.calls == calls + 1
    assert res.points.shape == (4, 10, 6) and res.costs.shape == (4, 8)
    again = mh_tpu_torch.suggest_layouts(
        spec, mh_tpu_torch.SamplerConfig(iterations=20, n_chains=4), key=1, engine="fused",
        device="cpu", serve=True)
    np.testing.assert_array_equal(res.points, again.points)
    np.testing.assert_array_equal(res.costs, again.costs)


def test_spec_without_device_needs_cuda(monkeypatch):
    """A SceneSpec with no device runs on CUDA; without a card it raises and
    never falls back to the plain version. A built Scene keeps its device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = TF.fused_chains_reference.calls
    spec = mh_tpu_torch.demo_scene(6)
    cfg = mh_tpu_torch.SamplerConfig(iterations=5, n_chains=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        mh_tpu_torch.suggest_layouts(spec, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        mh_tpu_torch.suggest_layouts(spec, cfg, device="cuda:0")
    assert TF.fused_chains_reference.calls == calls
    res = mh_tpu_torch.suggest_layouts(spec.build(), cfg, pose0=spec.initial_pose())
    assert TF.fused_chains_reference.calls == calls + 1
    assert res.costs.shape == (2, 8)


def test_built_scene_with_pose0():
    spec = mh_tpu_torch.demo_scene(10)
    scene = spec.build(pad_objs=16)
    pose0 = spec.initial_pose(pad_objs=16)
    res = mh_tpu_torch.suggest_layouts(
        scene, mh_tpu_torch.SamplerConfig(iterations=10, n_chains=2), key=3, pose0=pose0)
    assert res.points.shape == (2, 10, 6)
    with pytest.raises(ValueError, match="pose0"):
        mh_tpu_torch.suggest_layouts(scene, mh_tpu_torch.SamplerConfig())


@pytest.mark.parametrize(
    "kwargs,error",
    [
        (dict(key=np.int64(3)), TypeError),
        (dict(key=torch.tensor(3)), TypeError),
        (dict(key=True), TypeError),
        (dict(engine="xla"), NotImplementedError),
        (dict(engine="xla_specialized"), NotImplementedError),
        (dict(engine="bogus"), ValueError),
        (dict(mesh=object()), NotImplementedError),
        (dict(objs_devices=2), NotImplementedError),
        (dict(log="run.jsonl"), NotImplementedError),
    ],
)
def test_unsupported_arguments_raise(kwargs, error):
    with pytest.raises(error):
        mh_tpu_torch.suggest_layouts(
            mh_tpu_torch.demo_scene(4), mh_tpu_torch.SamplerConfig(iterations=1),
            device="cpu", **kwargs)


def test_runs_with_jax_unimportable():
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        sys.modules["mh_tpu"] = None
        import mh_tpu_torch
        import mh_tpu_torch.kernels.pi_kernel
        import mh_tpu_torch.utils.serialization
        from mh_tpu_torch import cli
        res = mh_tpu_torch.suggest_layouts(
            mh_tpu_torch.demo_scene(8),
            mh_tpu_torch.SamplerConfig(iterations=5, n_chains=2), key=0, device="cpu")
        assert res.costs.shape == (2, 8)
        assert cli.main(["pi", "--fused", "--samples", "4096", "--device", "cpu"]) == 0
        assert not any(m == "jax" or m.startswith(("jax.", "jaxlib", "mh_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"
