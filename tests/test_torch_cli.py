"""The port's scene JSON format and ``python -m mh_tpu_torch`` against mh_tpu's.

Scene files cross between the packages field for field. The CLI runs here
with ``--device cpu`` (the kernels' plain PyTorch versions); its JSON is
held to mh_tpu's fused engine with the tolerance of
tests/test_torch_fused.py: accept counts equal and poses within 1e-4 except
for at most 2 of 8 chains, costs of the rest within rtol 2e-4 / atol 2e-3.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

import mh_tpu
from mh_tpu import cli as jax_cli
from mh_tpu.utils import serialization as JS
import mh_tpu_torch
from mh_tpu_torch import cli
from mh_tpu_torch.utils import serialization as TS
from test_torch_scene import assert_fields_equal, jax_scene_fields

RTOL, ATOL, POSE_ATOL, MAX_DIVERGENT = 2e-4, 2e-3, 1e-4, 2
LIVING_ROOM = Path(__file__).resolve().parents[1] / "examples" / "scenes" / "living_room.json"


def spec_fields(spec) -> dict:
    """A SceneSpec's fields as numpy arrays (clearances as quads + sources)."""
    out = {}
    for f in dataclasses.fields(spec):
        v = getattr(spec, f.name)
        if f.name == "clearances":
            out["clearance_quads"] = np.asarray([np.asarray(q) for q, _ in v])
            out["clearance_sources"] = np.asarray([s for _, s in v])
        else:
            out[f.name] = np.asarray(v)
    return out


def test_living_room_loads_into_equal_fields():
    want, got = JS.load_scene(str(LIVING_ROOM)), TS.load_scene(str(LIVING_ROOM))
    assert isinstance(got, mh_tpu_torch.SceneSpec)
    assert_fields_equal(spec_fields(want), spec_fields(got))
    assert_fields_equal(jax_scene_fields(want.build()), got.build().to_numpy())


def test_port_save_scene_loads_in_mh_tpu(tmp_path):
    spec = TS.load_scene(str(LIVING_ROOM))
    path = str(tmp_path / "scene.json")
    TS.save_scene(path, spec)
    back = JS.load_scene(path)
    assert_fields_equal(spec_fields(spec), spec_fields(back))
    assert TS.scene_to_dict(spec) == JS.scene_to_dict(back)


def test_scene_dict_rejects_bad_schema():
    d = TS.scene_to_dict(mh_tpu_torch.demo_scene(4))
    d["schema_version"] = 99
    with pytest.raises(ValueError, match="schema"):
        TS.scene_from_dict(d)


def test_sampler_config_from_dict():
    d = {"iterations": 7, "n_chains": 3, "mode": "fixed", "n_moves_per_step": 4,
         "accept_draws": 2, "unknown": 1}
    cfg = TS.sampler_config_from_dict(d)
    assert cfg == mh_tpu_torch.SamplerConfig(
        iterations=7, n_chains=3, mode=mh_tpu_torch.CostMode.FIXED, n_moves_per_step=4,
        accept_draws=2)
    assert dataclasses.asdict(JS.sampler_config_from_dict(d)).keys() == \
        dataclasses.asdict(cfg).keys()


@pytest.mark.parametrize("extra", [[], ["--moves-per-step", "4", "--accept-draws", "4"]])
def test_cli_suggest_matches_mh_tpu(extra, capsys):
    args = ["suggest", "--engine", "fused", "--objects", "16", "--chains", "8",
            "--iters", "30", "--seed", "2", *extra]
    assert jax_cli.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main([*args, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got.keys() == want.keys() and got["costs"].keys() == want["costs"].keys()
    gp, wp = np.asarray(got["points"]), np.asarray(want["points"])
    assert gp.shape == wp.shape == (8, 16, 6)
    ga, wa = np.asarray(got["accept_rate"]), np.asarray(want["accept_rate"])
    same = (ga == wa) & (np.abs(gp - wp).max(axis=(1, 2)) <= POSE_ATOL)
    assert (~same).sum() <= MAX_DIVERGENT
    for name in want["costs"]:
        np.testing.assert_allclose(np.asarray(got["costs"][name])[same],
                                   np.asarray(want["costs"][name])[same], rtol=RTOL, atol=ATOL)


def test_cli_suggest_scene_file_and_out(tmp_path):
    scene_path = str(tmp_path / "scene.json")
    TS.save_scene(scene_path, mh_tpu_torch.demo_scene(6))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps({"iterations": 5, "n_chains": 2, "mode": "fixed"}))
    out = str(tmp_path / "res.json")
    assert cli.main(["suggest", "--scene", scene_path, "--config", str(cfg_path),
                     "--out", out, "--device", "cpu"]) == 0
    data = json.loads(open(out).read())
    assert np.asarray(data["points"]).shape == (2, 6, 6)
    assert len(data["costs"]["total"]) == 2


def test_cli_demo_pi_and_devices(capsys):
    assert cli.main(["demo", "--objects", "8", "--chains", "2", "--iters", "10",
                     "--moves-per-step", "2", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("Suggestion") == 2
    assert cli.main(["pi", "--samples", str(1 << 16), "--device", "cpu"]) == 0
    assert "pi ~=" in capsys.readouterr().out
    assert cli.main(["pi", "--fused", "--samples", str(1 << 18), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "pi ~=" in out and f"({1 << 18} samples, fused kernel)" in out
    assert cli.main(["devices"]) == 0
    assert "devices" in capsys.readouterr().out


@pytest.mark.parametrize("seed", [0, 7])
def test_cli_pi_prints_mh_tpu_estimate(seed, capsys):
    args = ["pi", "--seed", str(seed), "--samples", str(1 << 18)]
    assert jax_cli.main(args) == 0
    want = capsys.readouterr().out
    assert cli.main([*args, "--device", "cpu"]) == 0
    assert capsys.readouterr().out == want and "pi ~=" in want


def test_cli_suggest_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(mh_tpu_torch.api.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["suggest", "--objects", "4", "--iters", "1"])


@pytest.mark.parametrize("extra", [
    ["--engine", "torch"], ["--engine", "torch_graph"], ["--engine", "xla"], [], ["--log", "LOG"],
], ids=["torch", "torch_graph", "xla", "auto", "logged"])
def test_cli_objs_devices(extra, capsys, tmp_path):
    """--objs-devices runs the row-sharded objective on the torch engine (2
    shards of the CPU here), with the unsharded engine's accepts and poses
    within 1e-4; torch_graph raises, as mh_tpu's xla_specialized does."""
    argv = ["suggest", "--objects", "4", "--iters", "8", "--device", "cpu", "--seed", "3",
            "--objs-devices", "2", *[str(tmp_path / "run.jsonl") if a == "LOG" else a
                                     for a in extra]]
    if "torch_graph" in extra:
        with pytest.raises(ValueError, match="torch engine"):
            cli.main(argv)
        return
    assert cli.main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert cli.main(["suggest", "--objects", "4", "--iters", "8", "--device", "cpu", "--seed",
                     "3", "--engine", "torch"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert got["accept_rate"] == want["accept_rate"]
    np.testing.assert_allclose(got["points"], want["points"], atol=1e-4)
    if "--log" in extra:
        events = [json.loads(line) for line in (tmp_path / "run.jsonl").read_text().splitlines()]
        assert [e["event"] for e in events] == ["run_config", "result"]
        assert events[0]["engine"] == "torch_objsharded"


@pytest.mark.parametrize("engine", ["xla", "torch"])
def test_cli_suggest_torch_engine_matches_mh_tpu(engine, capsys):
    args = ["suggest", "--objects", "16", "--chains", "8", "--iters", "30", "--seed", "5",
            "--mode", "fixed"]
    assert jax_cli.main([*args, "--engine", "xla"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main([*args, "--engine", engine, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got.keys() == want.keys()
    gp, wp = np.asarray(got["points"]), np.asarray(want["points"])
    ga, wa = np.asarray(got["accept_rate"]), np.asarray(want["accept_rate"])
    same = (ga == wa) & (np.abs(gp - wp).max(axis=(1, 2)) <= POSE_ATOL)
    assert (~same).sum() <= MAX_DIVERGENT
    for name in want["costs"]:
        np.testing.assert_allclose(np.asarray(got["costs"][name])[same],
                                   np.asarray(want["costs"][name])[same], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("extra", [[], ["--adapt-ladder", "--mode", "fixed"]])
def test_cli_temper_matches_mh_tpu(extra, capsys, tmp_path):
    """mh_tpu's temper runs over its 8 test devices (device-count
    invariant); the port's on one shard with --device cpu (on CUDA, over
    every card). The same keys and, to the tolerance of
    tests/test_torch_tempering.py, the same values."""
    args = ["temper", "--objects", "8", "--replicas", "8", "--rounds", "10",
            "--exchange-every", "3", "--iters", "0", "--seed", "4", *extra]
    assert jax_cli.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    log = tmp_path / "t.jsonl"
    assert cli.main([*args, "--device", "cpu", "--log", str(log)]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got.keys() == want.keys()
    assert (np.asarray(got["swap_rates"]) != np.asarray(want["swap_rates"])).sum() <= 2
    assert got["target_total_cost"] == pytest.approx(want["target_total_cost"], rel=RTOL)
    if "betas" in want:
        np.testing.assert_allclose(got["betas"], want["betas"], rtol=1e-5)
    events = [json.loads(line) for line in log.read_text().splitlines()]
    assert [e["event"] for e in events] == ["run_config", "result"]
    assert events[1]["swap_rates"] == got["swap_rates"]


@pytest.mark.parametrize("extra", [[], ["--adaptive", "--init", "prior"]])
def test_cli_smc_matches_mh_tpu(extra, capsys):
    args = ["smc", "--objects", "8", "--particles", "16", "--stages", "5",
            "--mutate-steps", "2", "--iters", "0", "--seed", "2", *extra]
    assert jax_cli.main(args) == 0
    want = json.loads(capsys.readouterr().out)
    assert cli.main([*args, "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got.keys() == want.keys()
    assert got["resampled"] == want["resampled"]
    np.testing.assert_allclose(got["ess"], want["ess"], rtol=1e-4)
    np.testing.assert_allclose(got["betas"], want["betas"], rtol=1e-5)
    assert got["log_evidence"] == pytest.approx(want["log_evidence"], rel=1e-5)
    assert got["best_total_cost"] == pytest.approx(want["best_total_cost"], rel=RTOL)


def test_cli_demo_log_rounds(tmp_path, capsys):
    """--log with no --log-every: ~10 round events, as mh_tpu's CLI."""
    log = tmp_path / "run.jsonl"
    assert cli.main(["demo", "--objects", "8", "--chains", "4", "--iters", "20", "--log",
                     str(log), "--device", "cpu"]) == 0
    events = [json.loads(line) for line in log.read_text().splitlines()]
    rounds = [e for e in events if e["event"] == "round"]
    assert events[0]["event"] == "run_config" and events[-1]["event"] == "result"
    assert [r["step"] for r in rounds] == [2 * (i + 1) for i in range(10)]
    assert events[0]["n_objs"] == 8 and events[0]["config"]["iterations"] == 20


def test_cli_temper_and_smc_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(mh_tpu_torch.api.torch.cuda, "is_available", lambda: False)
    for argv in (["temper", "--objects", "4", "--replicas", "2", "--rounds", "1"],
                 ["smc", "--objects", "4", "--particles", "2", "--stages", "1"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
