"""mh_tpu_torch.suggest_layouts against mh_tpu.suggest_layouts, its argument
contract, the ``auto`` rule, run logging, and the package's independence
from JAX."""

from __future__ import annotations

import dataclasses
import inspect
import io
import json
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
from mh_tpu_torch.parallel.mesh import chain_mesh
from mh_tpu_torch.utils.runlog import RunLogger

import test_torch_threads  # noqa: F401

# tests/test_torch_fused.py states these and why a few chains may part
RTOL, ATOL, POSE_ATOL, MAX_DIVERGENT = 2e-4, 2e-3, 1e-4, 2


def assert_results_agree(got, want):
    """Accept rates equal and poses within POSE_ATOL in all but
    MAX_DIVERGENT chains; the costs of the rest within RTOL / ATOL."""
    for field in ("points", "costs", "accept_rate", "step_scale"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.shape == w.shape, field
        assert g.dtype == w.dtype, field
    same = (got.accept_rate == want.accept_rate) & (
        np.abs(got.points - want.points).max(axis=(1, 2)) <= POSE_ATOL)
    assert (~same).sum() <= MAX_DIVERGENT
    np.testing.assert_allclose(got.costs[same], want.costs[same], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.step_scale[same], want.step_scale[same], rtol=1e-5)
    return same


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
    """The per-device auto rule: on CUDA the fused kernel wherever it takes
    the config; on the CPU the torch engine (mh_tpu picks its XLA scan off
    the TPU). engine="fused" on the CPU runs the kernel's plain version."""
    cfg = mh_tpu_torch.SamplerConfig()
    assert auto_engine("cuda", cfg, 100, 2, False) == "fused"
    assert auto_engine(torch.device("cuda:0"), dataclasses.replace(
        cfg, n_moves_per_step=64, accept_draws=64), 100, 2, False) == "fused"
    assert auto_engine("cpu", cfg, 100, 2, False) == "torch"
    spec = mh_tpu_torch.demo_scene(10)
    calls = TF.fused_chains_reference.calls
    res = mh_tpu_torch.suggest_layouts(
        spec, mh_tpu_torch.SamplerConfig(iterations=20, n_chains=4), key=1, device="cpu")
    assert TF.fused_chains_reference.calls == calls
    want = mh_tpu_torch.suggest_layouts(
        spec, mh_tpu_torch.SamplerConfig(iterations=20, n_chains=4), key=1, engine="torch",
        device="cpu")
    np.testing.assert_array_equal(res.points, want.points)
    assert res.accept_rate.dtype == np.float32
    fused = mh_tpu_torch.suggest_layouts(
        spec, mh_tpu_torch.SamplerConfig(iterations=20, n_chains=4), key=1, engine="fused",
        device="cpu", serve=True)
    assert TF.fused_chains_reference.calls == calls + 1
    assert fused.points.shape == (4, 10, 6) and fused.accept_rate.dtype == np.float64


def test_auto_on_cuda_leaves_the_fused_kernel_where_it_cannot_run():
    """Past the kernel's limits (K > 120 accept draws, its shared memory)
    auto takes the torch engine as a CUDA graph, whatever serve says; the
    choice is made from the config, before any launch."""
    many_draws = mh_tpu_torch.SamplerConfig(accept_draws=121)
    assert auto_engine("cuda", many_draws, 100, 2, False) == "torch_graph"
    assert not TF.kernel_takes(mh_tpu_torch.SamplerConfig(), 2600, 2, False)
    assert auto_engine("cuda", mh_tpu_torch.SamplerConfig(), 2600, 2, False) == "torch_graph"
    assert TF.kernel_takes(mh_tpu_torch.SamplerConfig(), 2500, 2, False)
    assert "serve" not in inspect.signature(auto_engine).parameters


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
    assert TF.fused_chains_reference.calls == calls  # auto on the CPU: torch engine
    assert res.costs.shape == (2, 8)
    fused = mh_tpu_torch.suggest_layouts(spec.build(), cfg, pose0=spec.initial_pose(),
                                         engine="fused")
    assert TF.fused_chains_reference.calls == calls + 1
    assert fused.costs.shape == (2, 8)


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
        (dict(engine="xla_specialized", mesh=chain_mesh(devices=["cpu"] * 2)), ValueError),
        (dict(engine="xla_specialized", objs_devices=2), ValueError),
        (dict(engine="bogus"), ValueError),
        (dict(mesh=chain_mesh(devices=["cpu"] * 3)), ValueError),
        (dict(objs_devices=3), ValueError),
        (dict(objs_devices=2, mesh=chain_mesh(devices=["cpu"] * 2)), ValueError),
    ],
)
def test_unsupported_arguments_raise(kwargs, error):
    """Non-int keys; engines or meshes mh_tpu refuses too: a CUDA graph
    with a mesh, the row-sharded objective off the torch engine, chains or
    objects the shards do not divide (4 chains over 3 shards; 4 objects
    over 3), objs_devices with a mesh."""
    with pytest.raises(error):
        mh_tpu_torch.suggest_layouts(
            mh_tpu_torch.demo_scene(4), mh_tpu_torch.SamplerConfig(iterations=1),
            device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs,engine", [
    (dict(engine="xla", mesh=chain_mesh(devices=["cpu"] * 2)), "torch"),
    (dict(mesh=chain_mesh(devices=["cpu"] * 4)), "torch"),
    (dict(engine="fused", mesh=chain_mesh(devices=["cpu"] * 2)), "fused"),
    (dict(objs_devices=2), "torch_objsharded"),
    (dict(engine="torch", mesh=chain_mesh(devices=["cpu"] * 2), log_every=1), "torch"),
], ids=["xla_mesh", "auto_mesh", "fused_mesh", "objs_devices", "logged_mesh"])
def test_mesh_arguments_run(kwargs, engine):
    """mesh= and objs_devices= run on a CPU mesh and give the unsharded
    result: bitwise on the chains axis, poses within 1e-4 and equal accepts
    with the objective row-sharded; a sharded run logs one shot."""
    spec = mh_tpu_torch.demo_scene(4)
    cfg = mh_tpu_torch.SamplerConfig(iterations=6, n_chains=4)
    log = io.StringIO()
    got = mh_tpu_torch.suggest_layouts(spec, cfg, key=1, log=log, device="cpu", **kwargs)
    want = mh_tpu_torch.suggest_layouts(spec, cfg, key=1, device="cpu",
                                        engine="fused" if engine == "fused" else "torch")
    events = _events(log.getvalue())
    assert [e["event"] for e in events] == ["run_config", "result"]
    assert events[0]["engine"] == events[1]["engine"] == engine
    np.testing.assert_array_equal(got.accept_rate, want.accept_rate)
    if engine == "torch_objsharded":
        np.testing.assert_allclose(got.points, want.points, atol=1e-4)
    else:
        for field in ("points", "costs", "step_scale"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


@pytest.mark.parametrize("shards", [None, 2])
def test_fused_call_opens_its_spans(shards):
    """A traced call on a SceneSpec opens each span of the call path on
    the caller's thread, inside ``mh.suggest_layouts``: ``mh.launch`` once
    per shard, ``mh.pack_scene`` once per distinct device (a CPU mesh
    names one), the split and gather only on a mesh."""
    mesh = None if shards is None else chain_mesh(devices=["cpu"] * shards)
    cfg = mh_tpu_torch.SamplerConfig(iterations=4, n_chains=4)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mh_tpu_torch.suggest_layouts(mh_tpu_torch.demo_scene(6), cfg, key=2, engine="fused",
                                     mesh=mesh, device="cpu")
    spans = [e for e in prof.events() if e.name.startswith("mh.")]
    counts = {n: sum(e.name == n for e in spans) for n in {e.name for e in spans}}
    want = {"mh.suggest_layouts": 1, "mh.scene_build": 1, "mh.pack_scene": 1,
            "mh.launch": shards or 1, "mh.readback": 1}
    if shards:
        want.update({"mh.split": 1, "mh.gather": 1})
    assert counts == want
    top = next(e for e in spans if e.name == "mh.suggest_layouts")
    for e in spans:
        assert e.thread == top.thread and not e.is_user_annotation
        assert top.time_range.start <= e.time_range.start <= e.time_range.end \
            <= top.time_range.end


def test_auto_engine_with_a_mesh():
    """With a mesh, auto takes the fused kernel where it takes the config,
    the shards divide the chains and pose0 is shared, else the sharded
    torch engine (never the unsharded CUDA graph)."""
    cfg = mh_tpu_torch.SamplerConfig(n_chains=1024)
    assert auto_engine("cuda", cfg, 100, 2, False, 4, True) == "fused"
    assert auto_engine("cuda", cfg, 100, 2, False, 3, True) == "torch"
    assert auto_engine("cuda", cfg, 100, 2, False, 4, False) == "torch"
    assert auto_engine("cuda", cfg, 2600, 2, False, 4, True) == "torch"
    assert auto_engine("cpu", cfg, 100, 2, False, 4, True) == "torch"


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
        from mh_tpu_torch.sampler import prng, run_smc, run_tempered
        cfg = mh_tpu_torch.SamplerConfig(iterations=5, n_chains=2)
        for engine in ("fused", "torch", "torch_graph", "xla"):
            res = mh_tpu_torch.suggest_layouts(
                mh_tpu_torch.demo_scene(8), cfg, key=0, engine=engine, device="cpu")
            assert res.costs.shape == (2, 8)
        spec = mh_tpu_torch.demo_scene(6)
        states, rates = run_tempered(prng.key(0), spec.initial_pose(), spec.build(), cfg,
                                     n_replicas=4, rounds=2)
        assert rates.shape == (2,)
        states, diag = run_smc(prng.key(0), spec.initial_pose(), spec.build(), cfg,
                               n_particles=4, n_stages=2, mutate_steps=1)
        assert diag["ess"].shape == (2,)
        assert cli.main(["pi", "--fused", "--samples", "4096", "--device", "cpu"]) == 0
        assert cli.main(["smc", "--objects", "6", "--particles", "4", "--stages", "2",
                         "--device", "cpu"]) == 0
        from mh_tpu_torch.parallel.mesh import chain_mesh
        for kw in (dict(mesh=chain_mesh(devices=["cpu"] * 2)), dict(objs_devices=2)):
            res = mh_tpu_torch.suggest_layouts(mh_tpu_torch.demo_scene(8), cfg, device="cpu", **kw)
            assert res.costs.shape == (2, 8)
        import torch
        from mh_tpu_torch.models import densities
        from mh_tpu_torch.sampler import generic, hmc, mala, nuts, vi
        from mh_tpu_torch.sampler import (
            hmc_sample, layout_logdensity, mala_sample, meanfield_vi, nuts_sample,
            rw_metropolis)
        spec = mh_tpu_torch.demo_scene(6)
        pose0 = spec.initial_pose()
        target = layout_logdensity(spec.build(), pose0, 2.0, mh_tpu_torch.CostMode.FIXED)
        theta0 = generic.theta_from_pose(pose0)
        keys = prng.fold_in(prng.key(1), torch.arange(2))
        start = theta0.expand(2, 18)
        generic.rw_step(keys, generic.rw_init(target, start), target, 0.05)
        mala.mala_step(keys, mala.mala_init(target, start), target, 0.05)
        hmc.hmc_step(keys, hmc.hmc_init(target, start, 0.01), target, 3, 0)
        nuts.nuts_step(keys, nuts.nuts_init(target, start, 0.01), target, 3, 0)
        vi.elbo(prng.key(2), theta0, torch.zeros(18), target, 4)
        g = densities.gaussian([0.0, 1.0], [1.0, 2.0])
        for run in (lambda: rw_metropolis(0, g, [0.0, 0.0], 3, 2, device="cpu"),
                    lambda: mala_sample(0, g, [0.0, 0.0], 3, 2, device="cpu"),
                    lambda: hmc_sample(0, g, [0.0, 0.0], 2, 2, 3, n_chains=2, device="cpu"),
                    lambda: nuts_sample(0, g, [0.0, 0.0], 2, 2, 3, n_chains=2, device="cpu")):
            samples, final = run()
            assert samples.shape[0] == 2 and bool(torch.isfinite(samples).all())
        assert meanfield_vi(0, g, [0.0, 0.0], n_steps=3, device="cpu")[2].shape == (3,)
        assert not any(m == "jax" or m.startswith(("jax.", "jaxlib", "mh_tpu."))
                       for m in sys.modules if sys.modules[m] is not None)
        print("ok")
        """
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_gradient_samplers_without_a_card_raise():
    """Numpy or list theta0 and no device means the card: without one,
    every sampler raises rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks what happens without a card")
    from mh_tpu_torch.models.densities import gaussian
    from mh_tpu_torch.sampler import (
        hmc_sample, mala_sample, meanfield_vi, nuts_sample, rw_metropolis)

    g = gaussian([0.0, 1.0], [1.0, 2.0])
    theta0 = np.zeros(2, np.float32)
    for run in (lambda: rw_metropolis(0, g, theta0, 3, 2),
                lambda: mala_sample(0, g, theta0, 3, 2),
                lambda: hmc_sample(0, g, [0.0, 0.0], 2, 2, 3),
                lambda: nuts_sample(0, g, theta0, 2, 2, 3),
                lambda: meanfield_vi(0, g, theta0, n_steps=3),
                lambda: rw_metropolis(0, g, torch.zeros(2), 3, 2, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
    # a CPU tensor names its device
    samples, _ = rw_metropolis(0, g, torch.zeros(2), 3, 2)
    assert samples.device.type == "cpu"


def test_sampler_exports_match_mh_tpu():
    """mh_tpu_torch.sampler exports the entry points mh_tpu.sampler does."""
    import mh_tpu.sampler as JS
    import mh_tpu_torch.sampler as TS

    names = ("hmc_sample", "nuts_sample", "mala_sample", "meanfield_vi", "layout_logdensity",
             "rw_metropolis", "run_smc", "run_tempered", "geometric_ladder", "run_chains",
             "run_chain", "compile_chains", "mh_init", "mh_step", "MHState")
    for name in names:
        assert hasattr(JS, name) and callable(getattr(TS, name)), name


@pytest.mark.parametrize("engine", ["torch", "xla", "auto"])
def test_torch_engine_matches_mh_tpu_xla(engine):
    """16 objects x 8 chains x 30 steps on the CPU against mh_tpu's XLA engine
    (the same threefry stream; the tolerance of assert_results_agree)."""
    cfg_j = mh_tpu.SamplerConfig(iterations=30, n_chains=8)
    cfg_t = mh_tpu_torch.SamplerConfig(iterations=30, n_chains=8)
    want = mh_tpu.suggest_layouts(mh_tpu.demo_scene(16), cfg_j, key=7, engine="xla")
    got = mh_tpu_torch.suggest_layouts(mh_tpu_torch.demo_scene(16), cfg_t, key=7,
                                       engine=engine, device="cpu")
    same = assert_results_agree(got, want)
    assert same.sum() >= 6 and np.isfinite(got.costs).all()


def test_graph_engine_equals_torch_engine_and_aliases():
    """torch_graph (xla_specialized) is bitwise torch (xla); on the CPU it
    takes the same eager step."""
    spec = mh_tpu_torch.demo_scene(12)
    cfg = mh_tpu_torch.SamplerConfig(iterations=15, n_chains=4, n_moves_per_step=2, adapt=True)
    runs = {e: mh_tpu_torch.suggest_layouts(spec, cfg, key=2, engine=e, device="cpu")
            for e in ("torch", "torch_graph", "xla", "xla_specialized")}
    for e, res in runs.items():
        for field in ("points", "costs", "accept_rate", "step_scale"):
            np.testing.assert_array_equal(getattr(res, field), getattr(runs["torch"], field),
                                          err_msg=f"{e} {field}")


def _events(text: str) -> list[dict]:
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def test_logged_run_matches_mh_tpu_events_and_one_shot(tmp_path):
    """log/log_every: the same event kinds and fields as mh_tpu's, the same
    round steps, and a result bitwise equal to the unlogged run."""
    logs = {}
    for name, pkg, kw in (("jax", mh_tpu, dict(engine="xla")),
                          ("torch", mh_tpu_torch, dict(engine="torch", device="cpu"))):
        path = tmp_path / f"{name}.jsonl"
        cfg = pkg.SamplerConfig(iterations=30, n_chains=4)
        logged = pkg.suggest_layouts(pkg.demo_scene(8), cfg, key=3, log=str(path), log_every=7,
                                     **kw)
        plain = pkg.suggest_layouts(pkg.demo_scene(8), cfg, key=3, **kw)
        np.testing.assert_array_equal(logged.points, plain.points)
        np.testing.assert_array_equal(logged.costs, plain.costs)
        logs[name] = _events(path.read_text())
    want, got = logs["jax"], logs["torch"]
    assert [e["event"] for e in got] == [e["event"] for e in want]
    assert [e["event"] for e in got] == ["run_config"] + ["round"] * 5 + ["result"]
    for g, w in zip(got, want):
        assert set(g) == set(w), g["event"]
        for k, v in w.items():
            if isinstance(v, dict):
                assert set(g[k]) == set(v), (g["event"], k)
    assert [e["step"] for e in got if e["event"] == "round"] == [7, 14, 21, 28, 30]
    assert got[0]["engine"] == "torch" and got[0]["config"] == want[0]["config"]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g["cost_total"]["best"], w["cost_total"]["best"], rtol=RTOL)


@pytest.mark.parametrize("iterations", [0, 20])
def test_logged_graph_engine_equals_one_shot(iterations):
    """torch_graph (the engine auto takes on CUDA past the kernel's limits)
    logs its rounds too, with the one-shot run's bits; a run of 0 steps
    logs one round at step 0."""
    spec = mh_tpu_torch.demo_scene(8)
    cfg = mh_tpu_torch.SamplerConfig(iterations=iterations, n_chains=4, n_moves_per_step=2)
    buf = io.StringIO()
    logged = mh_tpu_torch.suggest_layouts(spec, cfg, key=5, engine="torch_graph", log=buf,
                                          log_every=8, device="cpu")
    plain = mh_tpu_torch.suggest_layouts(spec, cfg, key=5, engine="torch", device="cpu")
    for field in ("points", "costs", "accept_rate", "step_scale"):
        np.testing.assert_array_equal(getattr(logged, field), getattr(plain, field))
    events = _events(buf.getvalue())
    want_steps = [8, 16, 20] if iterations else [0]
    assert [e["step"] for e in events if e["event"] == "round"] == want_steps
    assert events[0]["engine"] == events[-1]["engine"] == "torch_graph"


def test_logger_object_is_left_open():
    buf = io.StringIO()
    lg = RunLogger(buf)
    mh_tpu_torch.suggest_layouts(mh_tpu_torch.demo_scene(6),
                                 mh_tpu_torch.SamplerConfig(iterations=4, n_chains=2),
                                 log=lg, device="cpu")
    lg.event("after", ok=True)
    kinds = [e["event"] for e in _events(buf.getvalue())]
    assert kinds == ["run_config", "result", "after"]
