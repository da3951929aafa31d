"""The port's utilities (mh_tpu_torch.utils): checkpoint, metrics, profiling.

Mirrors tests/test_utils.py. A checkpoint round-trips a state and the
resumed chain continues bitwise, with the run log's ``checkpoint`` events.
ESS, split R-hat and ``summarize_chains`` agree with ``mh_tpu.utils.metrics``
on the same numpy traces (iid, AR(1), mixed and unmixed chains) within
rtol 1e-4: float32 sums in another order.
"""

from __future__ import annotations

import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mh_tpu_torch
from mh_tpu.utils import metrics as JMET
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.mh import ChainStep, run_chain, run_chains
from mh_tpu_torch.utils import checkpoint as CK
from mh_tpu_torch.utils import metrics as MET
from mh_tpu_torch.utils.profiling import PhaseTimer, force_completion, trace
from mh_tpu_torch.utils.runlog import RunLogger

RTOL = 1e-4


def _advance(step, s, n):
    for _ in range(n):
        s = step(s)
    return s


def test_checkpoint_roundtrip_and_deterministic_resume(tmp_path):
    spec = mh_tpu_torch.demo_scene(8)
    scene = spec.build()
    cfg = mh_tpu_torch.SamplerConfig(iterations=30)
    mid, _ = run_chain(prng.key(0), spec.initial_pose(), scene, cfg)

    path = str(tmp_path / "ckpt")
    sink = io.StringIO()
    CK.save_state(path, mid, log=RunLogger(sink))
    restored = CK.restore_state(path, mid, log=RunLogger(sink))
    assert os.path.exists(path + ".pt")
    for name, t in CK.flatten(mid).items():
        got = CK.flatten(restored)[name]
        assert got.dtype == t.dtype and torch.equal(got, t), name
    assert int(restored.step) == int(mid.step) == 30
    events = [json.loads(ln) for ln in sink.getvalue().splitlines()]
    assert [(e["event"], e["op"]) for e in events] == [("checkpoint", "save"),
                                                        ("checkpoint", "restore")]
    assert events[0]["step"] == 30 and events[0]["path"] == os.path.abspath(path)

    # resuming from the restored state continues bitwise
    step = ChainStep(scene, cfg)
    a = _advance(step, mid.map(lambda t: t[None]), 5)
    b = _advance(step, restored.map(lambda t: t[None]), 5)
    assert torch.equal(a.pose, b.pose) and torch.equal(a.n_accept, b.n_accept)


def test_checkpoint_of_a_tree_and_a_wrong_template(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": (torch.ones(2), [torch.tensor(1.5, dtype=torch.float64)])}
    path = str(tmp_path / "tree")
    CK.save_state(path, tree)
    back = CK.restore_state(path, CK.tree_map(torch.zeros_like, tree))
    assert isinstance(back["b"], tuple) and isinstance(back["b"][1], list)
    assert all(torch.equal(CK.flatten(back)[k], v) for k, v in CK.flatten(tree).items())
    with pytest.raises(ValueError, match="template"):
        CK.restore_state(path, {**tree, "a": torch.zeros(2, 4, dtype=torch.int32)})
    with pytest.raises(ValueError, match="template"):
        CK.restore_state(path, {"a": tree["a"]})
    with pytest.raises(TypeError):
        CK.save_state(path, {"a": "text"})


def test_local_shards_round_trip_onto_a_new_mesh(tmp_path):
    """One process: its rows saved to <path>.proc0.pt come back whole, and
    continue on a mesh with another number of shards as the saved run."""
    from mh_tpu_torch.parallel.mesh import chain_mesh
    from mh_tpu_torch.parallel.sharded import continue_chains_sharded, run_chains_sharded

    spec = mh_tpu_torch.demo_scene(8)
    scene, p0 = spec.build(), spec.initial_pose()
    cfg = mh_tpu_torch.SamplerConfig(iterations=6, n_chains=8)
    first = run_chains_sharded(prng.key(5), p0, scene, cfg, chain_mesh(devices=["cpu"] * 2))
    path = str(tmp_path / "shards")
    CK.save_local_shards(path, first)
    assert os.path.exists(path + ".proc0.pt")
    rows = CK.restore_local_shards(path, first)
    assert torch.equal(rows.pose, first.pose) and torch.equal(rows.key, first.key)
    got = continue_chains_sharded(rows, scene, cfg, chain_mesh(devices=["cpu"] * 4))
    want = continue_chains_sharded(first, scene, cfg, chain_mesh(devices=["cpu"] * 2))
    assert torch.equal(got.pose, want.pose) and torch.equal(got.n_accept, want.n_accept)
    with pytest.raises(ValueError, match="not divisible"):
        continue_chains_sharded(rows, scene, cfg, chain_mesh(devices=["cpu"] * 3))


def _ar1(n: int, phi: float, seed: int) -> np.ndarray:
    noise = np.random.default_rng(seed).standard_normal(n)
    x = np.zeros(n)
    for t in range(1, n):
        x[t] = phi * x[t - 1] + noise[t]
    return x.astype(np.float32)


TRACES = {
    "iid": lambda: np.random.default_rng(0).standard_normal(512).astype(np.float32),
    "ar1": lambda: _ar1(512, 0.95, 1),
    "short": lambda: np.random.default_rng(2).standard_normal(40).astype(np.float32),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_ess_matches_mh_tpu(name):
    x = TRACES[name]()
    got = float(MET.effective_sample_size(torch.as_tensor(x)))
    want = float(JMET.effective_sample_size(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL)
    if name == "iid":
        assert 200 < got <= 512 * 1.5
    if name == "ar1":
        assert got < 150
    # batched: one call over several chains gives each chain's value
    batch = np.stack([x, x[::-1].copy(), 2 * x + 1])
    per = [float(JMET.effective_sample_size(jnp.asarray(b))) for b in batch]
    np.testing.assert_allclose(MET.effective_sample_size(torch.as_tensor(batch)).numpy(), per,
                               rtol=RTOL)


def test_r_hat_mixed_vs_unmixed_matches_mh_tpu():
    mixed = np.random.default_rng(3).standard_normal((4, 256)).astype(np.float32)
    shifted = mixed + np.arange(4, dtype=np.float32)[:, None] * 10.0
    for traces in (mixed, shifted):
        np.testing.assert_allclose(float(MET.split_r_hat(torch.as_tensor(traces))),
                                   float(JMET.split_r_hat(jnp.asarray(traces))), rtol=RTOL)
    assert float(MET.split_r_hat(torch.as_tensor(mixed))) < 1.1
    assert float(MET.split_r_hat(torch.as_tensor(shifted))) > 1.5


def test_summarize_chains_matches_mh_tpu():
    traces = np.stack([_ar1(128, 0.5, s) for s in range(4)]
                      + [np.random.default_rng(9).standard_normal((4, 128)).astype(np.float32)[i]
                         for i in range(4)])
    got = MET.summarize_chains(torch.as_tensor(traces))
    want = JMET.summarize_chains(jnp.asarray(traces))
    assert got.keys() == want.keys() and got["mean"].shape == (8,)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=1e-6,
                                   err_msg=k)
    assert float(got["r_hat"]) < 1.2


def test_summarize_the_engines_cost_traces():
    """The traces a run returns, f32[C, T], summarised in one call."""
    spec = mh_tpu_torch.demo_scene(8)
    cfg = mh_tpu_torch.SamplerConfig(iterations=60, n_chains=4)
    _, costs = run_chains(prng.key(1), spec.initial_pose(), spec.build(), cfg, trace_costs=True)
    got = MET.summarize_chains(costs)
    want = JMET.summarize_chains(jnp.asarray(costs.numpy()))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=RTOL, atol=1e-6,
                                   err_msg=k)


def test_phase_timer_and_force_completion():
    t = PhaseTimer()
    with t.phase("a"):
        x = torch.ones(8, 8) * 2
        force_completion({"x": x, "y": (x, [x])})
    with t.phase("a"):
        force_completion(x)
    assert t.counts["a"] == 2 and "a" in t.report() and "ms/call  x2" in t.report()


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(log_dir, "trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
