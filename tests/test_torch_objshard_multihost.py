"""The row-sharded objective across processes against one process and mh_tpu's.

Mirrors tests/test_torch_multihost.py for ``mh_tpu_torch.parallel.objshard``.
OS processes join one ``torch.distributed`` group (gloo on 127.0.0.1) and
build the (chains x objs) meshes over every process's CPU shards: 2
processes x 2 shards, where a 1 x 4 mesh's objs axis spans the processes
and a 2 x 2 mesh's chains axis does; and 4 processes x 1 shard, where the
1 x 4 mesh's row spans all four and each row of the 2 x 2 mesh spans two
(a process group per row). ``run_chains_objsharded`` and
``cost_terms_sharded`` run there in PARITY and weighted FIXED
(``w_offlimits=-1.5``, the off-limits term in the loop). Every process's
copy of a row that spans processes must be bitwise equal to the others',
and the rows bitwise equal to the same mesh shape in one process (the
partials add in global shard order). Against ``mh_tpu``'s runners on its
virtual CPU devices, tests/test_torch_objshard.py's tolerances hold.

The module is its own worker:
``python tests/test_torch_objshard_multihost.py <pid> <nproc> <port> <out>``.
The workers import neither ``jax`` nor ``mh_tpu``, and check that they did
not. Every worker runs under a timeout and a worker that fails ends its
peers.
"""

from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import pytest
import torch

import mh_tpu_torch
from mh_tpu_torch.parallel import mesh as PM
from mh_tpu_torch.parallel import multihost as MH
from mh_tpu_torch.parallel.objshard import (
    chain_obj_mesh, chain_rows, cost_terms_sharded, obj_mesh, run_chains_objsharded,
)
from mh_tpu_torch.sampler import prng
import test_torch_threads  # noqa: F401
from test_torch_multihost import PARTIALS, free_port, run_workers

N_OBJS, CHAINS, STEPS = 16, 4, 30
SHAPES = {"objs_span": (1, 4), "chains_span": (2, 2)}
MODES = {"parity": ("PARITY", 0.0), "fixed_weighted": ("FIXED", -1.5)}
RUNS = tuple(f"{s}/{m}" for s in SHAPES for m in MODES)
COSTS = tuple(f"cost_terms/{m}" for m in MODES)
# each layout's processes, and the owner of each shard of each mesh shape
LAYOUTS = {2: {"objs_span": [[0, 0, 1, 1]], "chains_span": [[0, 0], [1, 1]]},
           4: {"objs_span": [[0, 1, 2, 3]], "chains_span": [[0, 1], [2, 3]]}}


def scene_and_pose(w_off: float):
    spec = dataclasses.replace(mh_tpu_torch.demo_scene(N_OBJS), w_offlimits=w_off)
    return spec.build(device="cpu"), spec.initial_pose(device="cpu")


def batch_of(p0: torch.Tensor) -> torch.Tensor:
    """Three poses, one per chain, for the breakdown."""
    return p0.expand(3, *p0.shape) + torch.arange(3.0)[:, None, None] * 0.25


def programs(devices) -> dict:
    """Every program on meshes over ``devices`` (this process's shards;
    every process's after ``initialize``), with the chain rows each run
    returned and each mesh's owning processes."""
    out = {}
    for mname, (mode, w_off) in MODES.items():
        scene, p0 = scene_and_pose(w_off)
        cfg = mh_tpu_torch.SamplerConfig(iterations=STEPS, n_chains=CHAINS,
                                         mode=mh_tpu_torch.CostMode[mode])
        for name, shape in SHAPES.items():
            mesh = chain_obj_mesh(*shape, devices=devices)
            s = run_chains_objsharded(prng.key(5), p0, scene, cfg, mesh)
            out[f"{name}/{mname}"] = {
                "rows": torch.tensor(chain_rows(mesh)), "pose": s.pose,
                "costs": s.costs.as_vector(), "n_accept": s.n_accept, "step": s.step,
                "key": s.key, "log_scale": s.log_scale,
                "processes": torch.as_tensor(np.zeros(shape, np.int64) if mesh.processes is None
                                             else mesh.processes)}
        got = cost_terms_sharded(batch_of(p0), scene, obj_mesh(devices=devices), cfg.mode)
        out[f"cost_terms/{mname}"] = {"costs": got.as_vector()}
    objs = obj_mesh(devices=devices)
    parts = [torch.tensor([PARTIALS[o]]) for o in objs.axis_shards("objs")]
    out["objs_psum"] = PM.psum(parts, objs, "objs")[0]
    return out


def worker(pid: int, nproc: int, port: int, out: str) -> None:
    MH.initialize(f"127.0.0.1:{port}", nproc, pid)
    res = programs(["cpu"] * (4 // nproc))
    if {"jax", "mh_tpu"} & set(sys.modules):
        raise AssertionError("a worker imported jax or mh_tpu")
    torch.save(res, f"{out}.{pid}")
    torch.distributed.destroy_process_group()


@pytest.fixture(scope="module", params=sorted(LAYOUTS), ids=lambda n: f"{n}_processes")
def spanning(request, tmp_path_factory):
    """``(number of processes, [each process's outputs])``."""
    nproc = request.param
    out = str(tmp_path_factory.mktemp("objshard_multihost") / "result.pt")
    port = free_port()
    results, timed_out = run_workers(
        [[__file__, str(pid), str(nproc), str(port), out] for pid in range(nproc)])
    assert not timed_out, [r[2][-3000:] for r in results]
    for rc, so, se in results:
        assert rc == 0, f"worker failed ({rc}):\n{so}\n{se[-3000:]}"
    return nproc, [torch.load(f"{out}.{pid}", weights_only=True) for pid in range(nproc)]


@pytest.fixture(scope="module")
def one_process():
    return programs(["cpu"] * 4)


def joined(outs: list[dict], program: str) -> dict:
    """Each chain row once, in row order, from the processes that hold it;
    every process's copy of a row must be bitwise equal to the others'."""
    rows = {}
    for pid, res in enumerate(outs):
        got = res[program]
        per_row = CHAINS // got["processes"].shape[0]
        for j, r in enumerate(got["rows"].tolist()):
            mine = {k: v[j * per_row:(j + 1) * per_row] for k, v in got.items()
                    if k not in ("rows", "processes")}
            if r in rows:
                for k, v in mine.items():
                    assert torch.equal(v, rows[r][k]), (program, r, k, pid)
            rows[r] = mine
    assert sorted(rows) == list(range(len(outs[0][program]["processes"])))
    return {k: torch.cat([rows[r][k] for r in sorted(rows)]) for k in rows[0]}


@pytest.mark.parametrize("program", RUNS)
def test_spanning_runs_equal_one_process_bitwise(spanning, one_process, program):
    nproc, outs = spanning
    got, want = joined(outs, program), one_process[program]
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), (program, k)
    assert (want["n_accept"] > 0).all() and (want["step"] == STEPS).all()
    owners = LAYOUTS[nproc][program.split("/")[0]]
    for res in outs:
        assert res[program]["processes"].tolist() == owners


@pytest.mark.parametrize("program", COSTS)
def test_spanning_cost_terms_equal_one_process_bitwise(spanning, one_process, program):
    _, outs = spanning
    want = one_process[program]["costs"]
    for res in outs:  # the same breakdown in every process
        assert torch.equal(res[program]["costs"], want), program


def test_objs_axis_reduces_in_global_shard_order(spanning, one_process):
    """(((1e8 + 1) - 1e8) + 1) is 1 in shard order; any other order of
    these float32 partials gives another sum."""
    _, outs = spanning
    for res in [one_process, *outs]:
        assert res["objs_psum"].tolist() == [1.0]


@functools.lru_cache(maxsize=None)
def _jax_run(program: str) -> dict:
    """``program`` through mh_tpu's runner on its virtual CPU devices."""
    import jax
    import jax.numpy as jnp

    import mh_tpu
    from mh_tpu.parallel.objshard import chain_obj_mesh as J_chain_obj_mesh
    from mh_tpu.parallel.objshard import cost_terms_sharded as J_cost_terms_sharded
    from mh_tpu.parallel.objshard import obj_mesh as J_obj_mesh
    from mh_tpu.parallel.objshard import run_chains_objsharded as J_objsharded

    shape, mname = program.split("/")
    mode, w_off = MODES[mname]
    spec = dataclasses.replace(mh_tpu.demo_scene(N_OBJS), w_offlimits=w_off)
    scene, pose0 = spec.build(), jnp.asarray(spec.initial_pose())
    jm = mh_tpu.CostMode[mode]
    if shape == "cost_terms":
        batch = np.asarray(batch_of(torch.as_tensor(np.array(pose0))))
        return {"costs": np.stack([np.asarray(J_cost_terms_sharded(p, scene, J_obj_mesh(4), jm)
                                              .as_vector()) for p in batch])}
    s = J_objsharded(jax.random.key(5), pose0, scene,
                     mh_tpu.SamplerConfig(iterations=STEPS, n_chains=CHAINS, mode=jm),
                     J_chain_obj_mesh(*SHAPES[shape]))
    return {"pose": np.asarray(s.pose), "n_accept": np.asarray(s.n_accept)}


@pytest.mark.parametrize("program", RUNS + COSTS)
def test_spanning_runs_agree_with_mh_tpu(spanning, program):
    """tests/test_torch_objshard.py's tolerances: breakdowns within rtol
    1e-5 / atol 1e-4; of the 4 chains at least 3 with equal accept counts
    and poses within 1e-4."""
    _, outs = spanning
    want = _jax_run(program)
    if program.startswith("cost_terms"):
        got = outs[0][program]["costs"].numpy()
        fields = list(mh_tpu_torch.LayoutResult.COST_FIELDS)
        keep = [i for i, f in enumerate(fields)
                if not (f == "off_limits" and program.endswith("parity"))]
        np.testing.assert_allclose(got[:, keep], want["costs"][:, keep], rtol=1e-5, atol=1e-4)
        return
    got = joined(outs, program)
    same = (got["n_accept"].numpy() == want["n_accept"]) & (
        np.abs(got["pose"].numpy() - want["pose"]).max(axis=(1, 2)) <= 1e-4)
    assert same.sum() >= 3, (program, same)


def test_a_chain_row_mixing_device_types_raises():
    """A row's shards must round alike: a CPU shard beside a card's raises,
    naming the devices, before anything runs (no card needed)."""
    scene, p0 = scene_and_pose(0.0)
    cfg = mh_tpu_torch.SamplerConfig(iterations=1, n_chains=2)
    mixed = chain_obj_mesh(1, 2, devices=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match=r"mixes device types \['cpu', 'cuda:0'\]"):
        run_chains_objsharded(prng.key(0), p0, scene, cfg, mixed)
    with pytest.raises(ValueError, match="mixes device types"):
        cost_terms_sharded(p0, scene, obj_mesh(devices=["cuda:0", "cpu"]))
    # rows of different types are fine: each row is of one type
    assert chain_rows(chain_obj_mesh(2, 1, devices=["cpu", "cuda:0"])) == [0, 1]


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
