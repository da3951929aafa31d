"""The scene's memo: ``Scene.to``, ``pack_scene`` and the counts
``suggest_layouts`` reads back are derived once per unchanged scene, device
and config, and every result stays bitwise what a freshly built scene
gives.

On the CPU the fused engine runs the kernel's plain version; the meta
device stands in for a second device where a copy is needed.
tests/test_torch_cuda.py repeats the bitwise checks on the card.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import pickle
import weakref

import numpy as np
import pytest
import torch

import mh_tpu_torch
from mh_tpu_torch.config import CostMode, SamplerConfig
from mh_tpu_torch.kernels import fused_mh as TF
from mh_tpu_torch.parallel.mesh import chain_mesh

import test_torch_threads  # noqa: F401

CFG = SamplerConfig(iterations=12, n_chains=4)
FIXED = SamplerConfig(iterations=12, n_chains=4, mode=CostMode.FIXED)
SPEC = dataclasses.replace(mh_tpu_torch.demo_scene(6), w_offlimits=-1.5)


def call(scene, cfg=CFG, key=5, **kw):
    return mh_tpu_torch.suggest_layouts(scene, cfg, key=key, pose0=SPEC.initial_pose(),
                                        engine="fused", device="cpu", **kw)


def assert_bitwise(got, want):
    for field in ("points", "costs", "accept_rate", "step_scale"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert g.tobytes() == w.tobytes(), field


@pytest.mark.parametrize("cfg", [CFG, FIXED], ids=["parity", "weighted_fixed"])
def test_second_call_packs_nothing_and_equals_a_fresh_scene(cfg):
    scene = SPEC.build()
    first = call(scene, cfg)
    packs = TF.pack_scene.packs
    again = call(scene, cfg)
    assert TF.pack_scene.packs == packs
    assert (again.accept_rate > 0).any()
    assert_bitwise(again, first)
    assert_bitwise(again, call(SPEC.build(), cfg))


@pytest.mark.parametrize("write", ["w_symmetry", "sizes", "off_rects"])
def test_an_in_place_write_repacks(write):
    scene = SPEC.build()
    call(scene)
    packs = TF.pack_scene.packs
    if write == "w_symmetry":
        scene.w_symmetry.fill_(-0.5)
        spec = dataclasses.replace(SPEC, w_symmetry=-0.5)
    elif write == "sizes":
        scene.sizes.mul_(1.5)
        spec = dataclasses.replace(SPEC, sizes=np.asarray(SPEC.sizes) * 1.5)
    else:
        scene.off_rects.max_y.add_(0.25)
        quads = np.array(SPEC.offlimit_quads, np.float64)
        ys = quads[..., 1]
        quads[..., 1] = np.where(ys == ys.max(axis=1, keepdims=True), ys + 0.25, ys)
        spec = dataclasses.replace(SPEC, offlimit_quads=quads)
    got = call(scene)
    assert TF.pack_scene.packs == packs + 1
    assert_bitwise(got, call(spec.build()))


@pytest.mark.parametrize("change", [dict(beta=1.5), dict(sigma_t=0.25), dict(accept_draws=4),
                                    dict(mode=CostMode.FIXED), dict(sigma_xy_override=-0.0),
                                    dict(adapt=True)])
def test_a_config_that_differs_in_a_packed_field_repacks(change):
    scene = SPEC.build()
    call(scene)
    packs = TF.pack_scene.packs
    cfg = dataclasses.replace(CFG, **change)
    got = call(scene, cfg)
    assert TF.pack_scene.packs == packs + 1
    assert_bitwise(got, call(SPEC.build(), cfg))


def test_an_equal_config_in_a_new_object_or_other_run_lengths_hit():
    scene = SPEC.build()
    call(scene)
    packs = TF.pack_scene.packs
    for cfg in (dataclasses.replace(CFG), dataclasses.replace(CFG, iterations=5, n_chains=2)):
        assert cfg is not CFG
        got = call(scene, cfg, key=9)
        assert_bitwise(got, call(SPEC.build(), cfg, key=9))
    assert TF.pack_scene.packs == packs + 2  # the two fresh scenes only


def test_pack_scene_returns_the_stored_packing_until_it_is_written():
    scene = SPEC.build()
    pk = TF.pack_scene(scene, CFG)
    assert TF.pack_scene(scene, CFG) is pk
    want = pk.scalars.clone()
    pk.scalars.mul_(2.0)
    again = TF.pack_scene(scene, CFG)
    assert again is not pk and torch.equal(again.scalars, want)


def test_to_its_own_device_is_itself():
    scene = SPEC.build()
    assert scene.to(scene.device) is scene
    assert scene.to("cpu") is scene and scene.to(torch.device("cpu")) is scene


def test_a_copy_to_another_device_is_made_once_per_state_of_both():
    scene = SPEC.build()
    meta = scene.to("meta")
    assert meta.device.type == "meta" and scene.to("meta") is meta
    scene.sizes.mul_(2.0)  # the source changed: a new copy
    meta2 = scene.to("meta")
    assert meta2 is not meta and scene.to("meta") is meta2
    meta2.sizes.add_(1.0)  # the copy changed: a new copy
    assert scene.to("meta") is not meta2


def test_the_memo_keeps_no_scene_alive():
    scene = SPEC.build()
    call(scene)
    scene.to("meta")
    ref = weakref.ref(scene)
    del scene
    gc.collect()
    assert ref() is None


def test_copies_and_pickles_leave_the_memo_behind():
    scene = SPEC.build()
    call(scene)
    for other in (copy.copy(scene), copy.deepcopy(scene), pickle.loads(pickle.dumps(scene))):
        assert "_memo" not in vars(other)
        assert_bitwise(call(other), call(scene))


def test_inference_tensors_are_packed_every_call():
    with torch.inference_mode():
        scene = SPEC.build()
    packs = TF.pack_scene.packs
    first = call(scene)
    second = call(scene)
    assert TF.pack_scene.packs == packs + 2
    assert_bitwise(second, first)


def test_build_copies_the_spec_arrays():
    """A CPU scene's tensors share no memory with its spec, so a write to
    the spec's arrays after the build, which torch would not see, cannot
    change the scene."""
    spec = dataclasses.replace(SPEC, sizes=np.ones((6, 2), np.float32),
                               positions=np.asarray(SPEC.positions, np.float32))
    scene = spec.build()
    before = scene.to_numpy()
    spec.sizes[:] = 3.0
    spec.offlimit_quads[:] = 0.0
    np.testing.assert_array_equal(scene.sizes.numpy(), before["sizes"])
    np.testing.assert_array_equal(scene.off_rects.max_x.numpy(), before["off_rects"]["max_x"])


def test_sharded_calls_pack_once_per_device():
    mesh = chain_mesh(devices=["cpu"] * 2)
    scene = SPEC.build()
    first = call(scene, mesh=mesh)
    packs = TF.pack_scene.packs
    again = call(scene, mesh=mesh)
    assert TF.pack_scene.packs == packs
    assert_bitwise(again, first)
    assert_bitwise(again, call(SPEC.build()))


def test_a_hit_opens_pack_hit_inside_pack_scene():
    scene = SPEC.build()
    names = []
    for _ in range(2):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            call(scene)
        events = [e for e in prof.events() if e.name in ("mh.pack_scene", "mh.pack_hit")]
        names.append(sorted(e.name for e in events))
        pack = next(e for e in events if e.name == "mh.pack_scene")
        for e in events:
            assert pack.time_range.start <= e.time_range.start <= e.time_range.end \
                <= pack.time_range.end
    assert names == [["mh.pack_scene"], ["mh.pack_hit", "mh.pack_scene"]]
