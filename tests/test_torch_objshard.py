"""The row-sharded objective (mh_tpu_torch.parallel.objshard) against the unsharded and mh_tpu's.

Mirrors tests/test_objshard.py. Each objs shard sums its rows of the
symmetry (and, in FIXED, off-limits) matrices; the partials add in shard
order, so totals match ``cost_terms`` to float rounding (rtol 1e-5, as
mh_tpu's test allows), and chains follow the unsharded trajectory:
accept counts equal, poses within 1e-4.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mh_tpu
import mh_tpu_torch
from mh_tpu.ops.costs import cost_terms as J_cost_terms
from mh_tpu.parallel.objshard import chain_obj_mesh as J_chain_obj_mesh
from mh_tpu.parallel.objshard import cost_terms_sharded as J_cost_terms_sharded
from mh_tpu.parallel.objshard import obj_mesh as J_obj_mesh
from mh_tpu.parallel.objshard import run_chains_objsharded as J_objsharded
from mh_tpu_torch.parallel.objshard import (
    chain_obj_mesh, cost_terms_sharded, obj_mesh, run_chains_objsharded,
)
from mh_tpu_torch.sampler import mh as TM
from mh_tpu_torch.sampler import prng
import test_torch_threads  # noqa: F401
from test_costs import random_spec
from test_torch_scene import to_torch_scene

FIELDS = mh_tpu_torch.LayoutResult.COST_FIELDS


def cpu(k: int) -> list[str]:
    return ["cpu"] * k


@pytest.mark.parametrize("mode", ["PARITY", "FIXED"])
def test_sharded_costs_match_unsharded_and_mh_tpu(mode):
    rng = np.random.default_rng(11)
    spec = random_spec(rng, n=13, r=4, c=3)
    js = spec.build(pad_objs=16)  # 16 rows over 8 shards -> 2 rows each
    pose = spec.initial_pose(pad_objs=16)
    ts, tp = to_torch_scene(js), torch.as_tensor(np.array(pose))
    jm, tm = mh_tpu.CostMode[mode], mh_tpu_torch.CostMode[mode]
    got = cost_terms_sharded(tp, ts, obj_mesh(devices=cpu(8)), tm)
    own = mh_tpu_torch.cost_terms(tp, ts, tm)
    jax_sharded = J_cost_terms_sharded(pose, js, J_obj_mesh(8), jm)
    jax_whole = J_cost_terms(pose, js, jm)
    for f in FIELDS:
        if f == "off_limits" and mode == "PARITY":
            continue  # mh_tpu's sharded breakdown reports 0 for it in PARITY
        g = float(getattr(got, f))
        for want in (own, jax_sharded, jax_whole):
            np.testing.assert_allclose(g, float(getattr(want, f)), rtol=1e-5, atol=1e-4,
                                       err_msg=f)
    # batched over chains, and on a (chains x objs) mesh's objs axis
    batch = tp.expand(3, 16, 6) + torch.arange(3.0)[:, None, None] * 0.25
    got_b = cost_terms_sharded(batch, ts, chain_obj_mesh(2, 4, devices=cpu(8)), tm)
    own_b = mh_tpu_torch.cost_terms(batch, ts, tm)
    for f in FIELDS[:6] + FIELDS[7:] + (FIELDS[6:7] if mode == "FIXED" else ()):
        np.testing.assert_allclose(getattr(got_b, f).numpy(), getattr(own_b, f).numpy(),
                                   rtol=1e-5, atol=1e-4, err_msg=f)


def test_sharded_costs_bad_divisibility():
    rng = np.random.default_rng(1)
    spec = random_spec(rng, n=9)
    ts = to_torch_scene(spec.build())
    with pytest.raises(ValueError, match="divisible"):
        cost_terms_sharded(torch.as_tensor(np.array(spec.initial_pose())), ts,
                           obj_mesh(devices=cpu(8)))
    with pytest.raises(ValueError, match="divisible"):
        run_chains_objsharded(prng.key(0), torch.as_tensor(np.array(spec.initial_pose())), ts,
                              mh_tpu_torch.SamplerConfig(iterations=1, n_chains=2),
                              chain_obj_mesh(2, 8, devices=cpu(16)))


@pytest.mark.parametrize("mode,w_off", [("PARITY", 0.0), ("FIXED", -1.5)])
def test_objsharded_chains_match_unsharded_and_mh_tpu(mode, w_off):
    """Chains on a (2 chains x 4 objs) mesh follow the unsharded torch
    engine (accepts equal, poses within 1e-4), on a (4 x 2) mesh too, and
    mh_tpu's objs-sharded runner on its (2 x 4) mesh."""
    import dataclasses

    spec = mh_tpu.demo_scene(16)
    js = dataclasses.replace(spec.build(), w_offlimits=jnp.float32(w_off))
    ts, pose0 = to_torch_scene(js), np.array(spec.initial_pose())
    kw = dict(iterations=30, n_chains=4)
    tc = mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode[mode], **kw)
    p0 = torch.as_tensor(pose0)
    got = run_chains_objsharded(prng.key(5), p0, ts, tc, chain_obj_mesh(2, 4, devices=cpu(8)))
    other = run_chains_objsharded(prng.key(5), p0, ts, tc, chain_obj_mesh(4, 2, devices=cpu(8)))
    want, _ = TM.run_chains(prng.key(5), p0, ts, tc)
    for g in (got, other):
        np.testing.assert_array_equal(g.n_accept.numpy(), want.n_accept.numpy())
        np.testing.assert_allclose(g.pose.numpy(), want.pose.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g.costs.as_vector().numpy(), want.costs.as_vector().numpy(),
                                   rtol=1e-4, atol=1e-3)
    assert (got.n_accept > 0).all()
    jw = J_objsharded(jax.random.key(5), jnp.asarray(pose0), js,
                      mh_tpu.SamplerConfig(mode=mh_tpu.CostMode[mode], **kw),
                      J_chain_obj_mesh(2, 4))
    same = (got.n_accept.numpy() == np.asarray(jw.n_accept)) & (
        np.abs(got.pose.numpy() - np.asarray(jw.pose)).max(axis=(1, 2)) <= 1e-4)
    assert same.sum() >= 3


def test_objsharded_huge_scene_samples():
    """A 2048-object scene on a (1 x 8) mesh runs its steps, and every
    final total matches the unsharded objective on its pose."""
    spec = mh_tpu_torch.demo_scene(2048)
    scene = spec.build(device="cpu")
    cfg = mh_tpu_torch.SamplerConfig(iterations=3, n_chains=2)
    states = run_chains_objsharded(prng.key(1), spec.initial_pose(device="cpu"), scene, cfg,
                                   chain_obj_mesh(1, 8, devices=cpu(8)))
    assert tuple(states.pose.shape) == (2, 2048, 6) and torch.isfinite(states.pose).all()
    assert states.step.tolist() == [3, 3]
    want = mh_tpu_torch.cost_terms(states.pose, scene, cfg.mode)
    np.testing.assert_allclose(states.costs.total.numpy(), want.total.numpy(), rtol=1e-4,
                               atol=1e-2)


def test_suggest_layouts_objs_devices():
    """objs_devices=k and a mesh with the objs axis take the row-sharded
    path (the torch engine, one shared pose0); anything else raises as
    mh_tpu does."""
    spec = mh_tpu_torch.demo_scene(8)
    cfg = mh_tpu_torch.SamplerConfig(iterations=12, n_chains=4)
    want = mh_tpu_torch.suggest_layouts(spec, cfg, key=2, engine="torch", device="cpu")
    for kw in (dict(objs_devices=4, device="cpu"),
               dict(mesh=chain_obj_mesh(2, 2, devices=cpu(4)), engine="xla")):
        got = mh_tpu_torch.suggest_layouts(spec, cfg, key=2, **kw)
        np.testing.assert_array_equal(got.accept_rate, want.accept_rate)
        np.testing.assert_allclose(got.points, want.points, atol=1e-4)
    scene = spec.build(device="cpu")
    per_chain = spec.initial_pose(device="cpu").expand(4, 8, 6)
    for kw, match in ((dict(objs_devices=2, engine="fused"), "torch engine"),
                      (dict(objs_devices=2, mesh=chain_obj_mesh(1, 2, devices=cpu(2))), "either"),
                      (dict(objs_devices=2, pose0=per_chain), "shared pose0")):
        with pytest.raises(ValueError, match=match):
            mh_tpu_torch.suggest_layouts(scene, cfg, **{"pose0": spec.initial_pose(), **kw})
