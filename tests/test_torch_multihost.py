"""The port's runs across processes (mh_tpu_torch.parallel.multihost) against one process.

Mirrors tests/test_multihost.py. Two OS processes, each owning 2 CPU
shards, join one ``torch.distributed`` group (gloo on 127.0.0.1) and run
the sharded programs on the 4-shard global mesh: sharded chains, the
collective runner, tempering (fixed and adapted ladder), SMC, and
``run_chains_fused_sharded`` (the fused kernel's plain version on the
CPU). Every result must be BITWISE equal to the port in one process on
``chain_mesh(devices=["cpu"] * 4)``, as the chains, replicas and
particles are keyed by global index and the collectives reduce in global
shard order. Against ``mh_tpu``'s single-process runners on 4 of this
process's virtual devices (what tests/test_multihost.py compares with)
the chain engine's tolerance holds (tests/test_torch_parallel.py): at
most 2 of 8 chains apart.

The module is its own worker:
``python tests/test_torch_multihost.py <pid> <nproc> <port> <out>``. The
workers import neither ``jax`` nor ``mh_tpu``, and check that they did not.
Every worker runs under a timeout and a worker that fails ends its peers.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

import mh_tpu_torch
from mh_tpu_torch.kernels.fused_mh import run_chains_fused_sharded
from mh_tpu_torch.parallel import mesh as PM
from mh_tpu_torch.parallel import multihost as MH
from mh_tpu_torch.parallel.sharded import run_chains_collective, run_chains_sharded
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.smc import run_smc
from mh_tpu_torch.sampler.tempering import run_tempered

import test_torch_threads  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 120.0
MAX_DIVERGENT, POSE_ATOL = 2, 1e-4
PROGRAMS = ("collectives", "chains", "collective", "tempering", "tempering_adapted", "smc",
            "smc_adaptive", "fused")
AGAINST_MH_TPU = ("chains", "collective", "tempering", "tempering_adapted", "smc")
# float32 partials whose sum depends on the order: (((1e8 + 1) - 1e8) + 1)
# is 1 in shard order, ((1e8 + 1) + (-1e8 + 1)) is 0
PARTIALS = (1e8, 1.0, -1e8, 1.0)
TEMPER = dict(n_replicas=8, exchange_every=2, rounds=4)
SMC = dict(n_particles=8, n_stages=3, mutate_steps=2)
COLLECTIVE = dict(adapt_rate=0.3, target_accept=0.3)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(argvs, expect_rc: int = 0, timeout: float = WORKER_TIMEOUT):
    """Run ``python <argv>`` for each argv at once, with the repo on the
    path; returns ``([(rc, stdout, stderr)], timed_out)``. As soon as one
    process ends with another code than ``expect_rc``, or the timeout runs
    out, the others are killed: no worker waits on a dead peer."""
    env = {**os.environ, "PYTHONPATH": REPO}
    with tempfile.TemporaryDirectory() as tmp:
        logs = [(open(os.path.join(tmp, f"{i}.out"), "w+"), open(os.path.join(tmp, f"{i}.err"), "w+"))
                for i in range(len(argvs))]
        procs = [subprocess.Popen([sys.executable, *argv], stdout=out, stderr=err, env=env, cwd=REPO)
                 for argv, (out, err) in zip(argvs, logs)]
        deadline = time.monotonic() + timeout
        timed_out = False
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, expect_rc) for p in procs):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        results = []
        for p, (out, err) in zip(procs, logs):
            out.seek(0)
            err.seek(0)
            results.append((p.returncode, out.read(), err.read()))
            out.close()
            err.close()
    return results, timed_out


def programs(mesh, gather) -> dict:
    """Every program on ``mesh``; ``gather`` joins the processes' rows."""
    spec = mh_tpu_torch.demo_scene(8)
    scene = spec.build(device="cpu")
    p0 = spec.initial_pose(device="cpu")
    cfg0 = mh_tpu_torch.SamplerConfig(iterations=0, n_chains=8)

    def state(s):
        return {"pose": gather(s.pose), "costs": gather(s.costs.as_vector()),
                "n_accept": gather(s.n_accept), "step": gather(s.step),
                "log_scale": gather(s.log_scale), "key": gather(s.key)}

    ids = mesh.axis_shards("chains")
    parts = [torch.tensor([PARTIALS[g]]) for g in ids]
    ring = [(i, (i + 1) % len(PARTIALS)) for i in range(len(PARTIALS))]
    out = {"collectives": {
        "psum": PM.psum(parts, mesh)[0], "pmax": PM.pmax(parts, mesh)[0],
        "all_gather": PM.all_gather(parts, mesh)[0],
        "ppermute": gather(torch.cat(PM.ppermute(parts, ring, mesh))),
        "ppermute_some": gather(torch.cat(PM.ppermute(parts, [(3, 0), (1, 2)], mesh)))}}
    out["chains"] = state(run_chains_sharded(
        prng.key(0), p0, scene, mh_tpu_torch.SamplerConfig(iterations=20, n_chains=8), mesh))
    s, rates, log_scale = run_chains_collective(
        prng.key(1), p0, scene, mh_tpu_torch.SamplerConfig(iterations=0, n_chains=8, **COLLECTIVE),
        mesh, rounds=4, steps_per_round=5)
    out["collective"] = {**state(s), "rates": rates, "scale": log_scale}
    for name, adapt in (("tempering", False), ("tempering_adapted", True)):
        got = run_tempered(prng.key(2), p0, scene, cfg0, mesh, adapt_ladder=adapt, **TEMPER)
        out[name] = {**state(got[0]), "swaps": got[1], **({"betas": got[2]} if adapt else {})}
    for name, adaptive in (("smc", False), ("smc_adaptive", True)):
        s, diag = run_smc(prng.key(3), p0, scene, cfg0, mesh, adaptive=adaptive, **SMC)
        out[name] = {**state(s), "log_weights": gather(diag["log_weights"]),
                     **{k: diag[k] for k in ("log_evidence", "ess", "resampled", "betas")}}
    fused = run_chains_fused_sharded(4, p0, scene, cfg0, 8, 20, mesh)
    out["fused"] = dict(zip(("pose", "breakdown", "n_accept", "step_scale"), map(gather, fused)))
    return out


def worker(pid: int, nproc: int, port: int, out: str) -> None:
    MH.initialize(f"127.0.0.1:{port}", nproc, pid)
    mesh = MH.global_chain_mesh(["cpu"] * 2)
    if mesh.shape != {"chains": 2 * nproc} or mesh.axis_shards("chains") != [2 * pid, 2 * pid + 1]:
        raise AssertionError(f"process {pid}: mesh {mesh.shape}, shards {mesh.axis_shards('chains')}")
    res = programs(mesh, MH.process_allgather)
    try:  # 6 chains on 4 shards: every process raises before any collective
        run_chains_sharded(prng.key(0), torch.zeros(8, 6), mh_tpu_torch.demo_scene(8).build(),
                           mh_tpu_torch.SamplerConfig(iterations=1, n_chains=6), mesh)
        res["indivisible_raises"] = False
    except ValueError as e:
        res["indivisible_raises"] = "divisible" in str(e)
    if {"jax", "mh_tpu"} & set(sys.modules):
        raise AssertionError("a worker imported jax or mh_tpu")
    if pid == 0:
        torch.save(res, out)
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("multihost") / "result.pt")
    port = free_port()
    results, timed_out = run_workers([[__file__, str(pid), "2", str(port), out] for pid in (0, 1)])
    assert not timed_out, [r[2][-3000:] for r in results]
    for rc, so, se in results:
        assert rc == 0, f"worker failed ({rc}):\n{so}\n{se[-3000:]}"
    return torch.load(out, weights_only=True)


@pytest.fixture(scope="module")
def one_process():
    return programs(PM.chain_mesh(devices=["cpu"] * 4), lambda t: t)


@pytest.mark.parametrize("program", PROGRAMS)
def test_two_processes_equal_one_process_bitwise(two_processes, one_process, program):
    got, want = two_processes[program], one_process[program]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), (program, k)
    if program in ("chains", "collective", "fused"):
        assert (want["n_accept"] > 0).all(), program
    if program == "collectives":  # the partials' order shows
        assert want["psum"].tolist() == [1.0] and want["pmax"].tolist() == [1e8]
        assert want["all_gather"].tolist() == list(PARTIALS)
        assert want["ppermute"].tolist() == [PARTIALS[-1], *PARTIALS[:-1]]
        assert want["ppermute_some"].tolist() == [PARTIALS[3], 0.0, PARTIALS[1], 0.0]


def test_two_processes_raise_on_indivisible_chains(two_processes):
    assert two_processes["indivisible_raises"]


def _jax_reference(program):
    """``program`` through mh_tpu's runner on 4 of this process's virtual devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import mh_tpu
    from mh_tpu.parallel.mesh import CHAINS_AXIS
    from mh_tpu.parallel.sharded import run_chains_collective as J_collective
    from mh_tpu.parallel.sharded import run_chains_sharded as J_sharded
    from mh_tpu.sampler.smc import run_smc as J_smc
    from mh_tpu.sampler.tempering import run_tempered as J_tempered

    mesh = Mesh(np.array(jax.devices()[:4]), (CHAINS_AXIS,))
    spec = mh_tpu.demo_scene(8)
    scene, pose0 = spec.build(), jnp.asarray(spec.initial_pose())
    cfg0 = mh_tpu.SamplerConfig(iterations=0, n_chains=8)
    if program == "chains":
        s = J_sharded(jax.random.key(0), pose0, scene,
                      mh_tpu.SamplerConfig(iterations=20, n_chains=8), mesh)
        return {"pose": s.pose, "n_accept": s.n_accept, "step": s.step}
    if program == "collective":
        s, rates, scale = J_collective(
            jax.random.key(1), pose0, scene,
            mh_tpu.SamplerConfig(iterations=0, n_chains=8, **COLLECTIVE), mesh,
            rounds=4, steps_per_round=5)
        return {"pose": s.pose, "n_accept": s.n_accept, "rates": rates, "scale": scale}
    if program.startswith("tempering"):
        out = J_tempered(jax.random.key(2), pose0, scene, cfg0, mesh,
                         adapt_ladder=program == "tempering_adapted", **TEMPER)
        return {"pose": out[0].pose, "swaps": out[1],
                **({"betas": out[2]} if program == "tempering_adapted" else {})}
    s, diag = J_smc(jax.random.key(3), pose0, scene, cfg0, mesh, **SMC)
    return {"pose": s.pose, "resampled": diag["resampled"], "ess": diag["ess"],
            "log_evidence": diag["log_evidence"]}


@pytest.mark.parametrize("program", AGAINST_MH_TPU)
def test_two_processes_agree_with_mh_tpu(two_processes, program):
    """The engine's tolerance: at most 2 of 8 chains (replicas, particles)
    apart; the rest with poses within 1e-4 and equal accept counts."""
    got = two_processes[program]
    want = {k: np.asarray(v) for k, v in _jax_reference(program).items()}
    gap = np.abs(got["pose"].numpy() - want["pose"]).max(axis=(1, 2))
    apart = gap > POSE_ATOL
    if "n_accept" in want:
        apart |= got["n_accept"].numpy() != want["n_accept"]
    assert apart.sum() <= MAX_DIVERGENT, (program, gap)
    if "step" in want:
        np.testing.assert_array_equal(got["step"].numpy(), want["step"])
    if "rates" in want:
        # a chain that parts moves the global rate by 1/40 of a step a round
        np.testing.assert_allclose(got["rates"].numpy(), want["rates"], atol=2.0 / 40)
    if "swaps" in want:
        assert (got["swaps"].numpy() != want["swaps"]).sum() <= 2
    if "betas" in want:
        np.testing.assert_allclose(got["betas"].numpy(), want["betas"], rtol=1e-5)
    if "resampled" in want:
        np.testing.assert_array_equal(got["resampled"].numpy(), want["resampled"])
        np.testing.assert_allclose(got["ess"].numpy(), want["ess"], rtol=1e-4)
        np.testing.assert_allclose(float(got["log_evidence"]), float(want["log_evidence"]),
                                   rtol=1e-5)


def test_initialize_without_coordination_is_a_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert MH.initialize() is None
    assert MH.initialize(num_processes=1) is None
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="address"):
        MH.initialize(num_processes=2, process_id=0)


def test_backend_rule():
    assert MH.choose_backend(None, 2, 0)[0] == "gloo"  # no card
    assert MH.choose_backend(None, 2, 1)[0] == "gloo"  # two processes share the card
    assert MH.choose_backend(None, 2, 2)[0] == "nccl"  # a card each
    assert MH.choose_backend("gloo", 2, 2) == ("gloo", "asked for")
    assert MH.choose_backend("nccl", 4, 8) == ("nccl", "asked for")
    with pytest.raises(ValueError, match="two ranks on one card"):
        MH.choose_backend("nccl", 2, 1)
    with pytest.raises(ValueError, match="no"):
        MH.choose_backend("nccl", 1, 0)
    with pytest.raises(ValueError, match="mpi"):
        MH.choose_backend("mpi", 1, 1)


def test_two_processes_naming_one_card_under_nccl_raise_in_the_mesh(monkeypatch):
    """The rule counts: two processes on a host with two cards get nccl
    (each may take a card of its own). Where both then name cuda:0 the
    mesh raises and says to ask for gloo; nothing falls back."""
    assert MH.choose_backend(None, 2, 2)[0] == "nccl"
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "nccl")
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)

    def both_name_mine(lists, mine):  # each process names the same card
        lists[:] = [mine, mine]

    monkeypatch.setattr(dist, "all_gather_object", both_name_mine)
    with pytest.raises(ValueError, match="both name cuda:0.*backend='gloo'"):
        MH.global_chain_mesh(["cuda:0"])


def test_nccl_with_two_ranks_on_one_card_raises_before_connecting(monkeypatch):
    """Two processes on a host with one card, nccl asked for: raises before
    joining any group (nothing falls back to gloo)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def joined(*args, **kwargs):
        raise AssertionError("init_process_group was called")

    monkeypatch.setattr(torch.distributed, "init_process_group", joined)
    with pytest.raises(ValueError, match="two ranks on one card"):
        MH.initialize(f"127.0.0.1:{free_port()}", 2, 0, backend="nccl")


def test_mesh_records_the_process_of_each_shard():
    m = PM.Mesh(np.array(["cpu"] * 4, dtype=object), ("chains",), processes=[1, 1, 0, 0])
    assert m.spans_processes and m.axis_processes("chains") == [1, 1, 0, 0]
    assert m.axis_shards("chains") == [2, 3]  # this process is rank 0
    assert PM.chain_shards(m, "cpu") == ([2, 3], [torch.device("cpu")] * 2, 4)
    local = PM.chain_mesh(devices=["cpu"] * 3)
    assert not local.spans_processes and local.axis_shards("chains") == [0, 1, 2]
    assert PM.chain_shards(None, "cpu") == ([0], [torch.device("cpu")], 1)
    with pytest.raises(ValueError, match="processes of shape"):
        PM.Mesh(np.array(["cpu"] * 2, dtype=object), ("chains",), processes=[0])
    # without a process group: the local mesh, and gathering is the identity
    assert MH.global_chain_mesh(["cpu"] * 2).shape == {"chains": 2}
    t = torch.arange(3)
    assert MH.process_allgather(t) is t


def test_a_local_mesh_stays_local_in_any_rank(monkeypatch):
    """A mesh built without ranks (before initialize, or by chain_mesh) is
    every shard this process's, whatever its rank later is."""
    local = PM.chain_mesh(devices=["cpu"] * 3)
    monkeypatch.setattr(PM, "process_index", lambda: 1)
    assert local.processes is None and not local.spans_processes
    assert local.axis_shards("chains") == [0, 1, 2] and len(local.axis_devices("chains")) == 3
    ranked = PM.Mesh(np.array(["cpu"] * 2, dtype=object), ("chains",), processes=[0, 1])
    assert ranked.spans_processes and ranked.axis_shards("chains") == [1]


def test_paths_that_stay_in_one_process_raise_on_a_spanning_mesh():
    """suggest_layouts reads every chain in the calling process, so it
    refuses a mesh that spans processes (the row-sharded objective runs on
    one: tests/test_torch_objshard_multihost.py)."""
    spec = mh_tpu_torch.demo_scene(8)
    scene, p0 = spec.build(), spec.initial_pose()
    cfg = mh_tpu_torch.SamplerConfig(iterations=1, n_chains=2)
    span = PM.Mesh(np.array(["cpu"] * 2, dtype=object), ("chains",), processes=[0, 1])
    with pytest.raises(ValueError, match="one process"):
        mh_tpu_torch.suggest_layouts(spec, cfg, mesh=span, device="cpu")
    objs = PM.Mesh(np.array(["cpu"] * 2, dtype=object), ("objs",), processes=[0, 1])
    with pytest.raises(ValueError, match="one process"):
        mh_tpu_torch.suggest_layouts(spec, cfg, mesh=objs, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        run_chains_sharded(prng.key(0), p0, scene, mh_tpu_torch.SamplerConfig(n_chains=3),
                           PM.Mesh(np.array(["cpu"] * 2, dtype=object), ("chains",),
                                   processes=[0, 1]))


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
