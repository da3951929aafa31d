"""A scene built from a ``SceneSpec`` is made on the host and sent in one
copy (``models/scene.py`` ``stage``), and keeps the host arrays it was sent
from (its host twin, ``host_twin``), which ``pack_scene``, ``tracks_off``
and ``suggest_layouts``' mask counts read in place of the scene's tensors.

Everything here is held bitwise to the route that reads the tensors back (a
scene without a twin) and to a per-leaf build of ``mh_tpu``'s scene. On the
CPU the staging buffer is the scene's own; tests/test_torch_cuda.py checks
the copies and the absence of syncs on the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import mh_tpu
import mh_tpu_torch
from mh_tpu_torch import api
from mh_tpu_torch.config import CostMode, SamplerConfig
from mh_tpu_torch.kernels import fused_mh as TF
from mh_tpu_torch.models import scene as S
from mh_tpu_torch.models.scene import Scene, build_with_pose, host_twin, scene_from_numpy

import test_torch_threads  # noqa: F401
from test_torch_scene import jax_scene_fields, torch_spec

PARITY = SamplerConfig(iterations=12, n_chains=4)
FIXED = SamplerConfig(iterations=12, n_chains=4, mode=CostMode.FIXED)


def harness(n: int = 32) -> mh_tpu.SceneSpec:
    return mh_tpu.demo_scene(n)


def weighted(n: int = 100) -> mh_tpu.SceneSpec:
    return dataclasses.replace(mh_tpu.demo_scene(n), w_offlimits=-1.5)


def bare(n: int = 10) -> mh_tpu.SceneSpec:
    """No relationships, angle relationships or clearances: each padded
    set is one masked row."""
    return dataclasses.replace(mh_tpu.demo_scene(n), relationships=[],
                               angle_relationships=[], clearances=[])


def frozen(n: int = 12) -> mh_tpu.SceneSpec:
    fr = np.zeros(n, bool)
    fr[[0, 3, 7]] = True
    return dataclasses.replace(weighted(n), frozen=fr)


def signed_zeros(n: int = 10) -> mh_tpu.SceneSpec:
    """-0.0 in the surface, the off-limits and clearance quads and the focal
    angle: the surface bounds come out +0.0 (``Scene.surface_bounds`` adds a
    zero)."""
    spec = mh_tpu.demo_scene(n)
    quads = np.array(spec.offlimit_quads)
    quads[::2, :, 0] *= -1.0
    surface = np.array(spec.surface_quad)
    surface[surface == 0.0] = -0.0
    return dataclasses.replace(spec, surface_quad=surface, offlimit_quads=quads, focal_rot=-0.0,
                               clearances=[(quads[0], 0), (-quads[1], 2)])


SPECS = {"harness32": harness, "scene100_weighted": weighted, "bare": bare, "frozen": frozen,
         "signed_zeros": signed_zeros}
CASES = [("harness32", PARITY), ("scene100_weighted", FIXED), ("bare", PARITY), ("bare", FIXED),
         ("frozen", PARITY), ("frozen", FIXED), ("signed_zeros", PARITY), ("signed_zeros", FIXED)]
IDS = [f"{name}-{cfg.mode.name}" for name, cfg in CASES]


def spec_of(name: str) -> mh_tpu_torch.SceneSpec:
    return torch_spec(SPECS[name]())


def untwinned(scene: Scene) -> Scene:
    """The same scene made of its tensors read back: no host twin."""
    out = scene_from_numpy(scene.to_numpy())
    assert host_twin(out) is None
    return out


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    return (got.dtype == want.dtype and got.shape == want.shape
            and got.cpu().numpy().tobytes() == want.cpu().numpy().tobytes())


def assert_packs_equal(got: TF.PackedScene, want: TF.PackedScene) -> None:
    for f in dataclasses.fields(TF.PackedScene):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, torch.Tensor):
            assert same_bits(g, w), f.name
        else:
            assert g == w, f.name


def assert_bitwise(got, want) -> None:
    for field in ("points", "costs", "accept_rate", "step_scale"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and g.shape == w.shape, field
        assert g.tobytes() == w.tobytes(), field


@pytest.fixture
def no_reads(monkeypatch):
    """Within the test, any read of a scene's tensors back to the host
    raises."""
    def refuse(*args, **kwargs):
        raise AssertionError("read back to the host")

    monkeypatch.setattr(Scene, "to_numpy", refuse)
    for name in ("__float__", "__int__", "__bool__", "item", "tolist", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("name,cfg", CASES, ids=IDS)
def test_packing_through_the_twin_equals_packing_the_tensors(name, cfg, monkeypatch):
    scene = spec_of(name).build()
    want = TF._pack(untwinned(scene), cfg)
    assert host_twin(scene) is not None
    monkeypatch.setattr(Scene, "to_numpy", lambda self: pytest.fail("read the tensors"))
    assert_packs_equal(TF._pack(scene, cfg), want)


def test_the_twin_path_reads_nothing_back(no_reads):
    scene = spec_of("frozen").build()
    TF._pack(scene, FIXED)
    assert TF.tracks_off(scene, FIXED)
    assert api._mask_counts(scene) == (12, 2)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_built_leaves_equal_a_per_leaf_build(name):
    """Value, dtype and shape of every leaf, bitwise ``mh_tpu``'s build
    with each leaf made on its own; the scene and the start pose share one
    buffer (one copy)."""
    spec = SPECS[name]()
    scene, pose0 = build_with_pose(torch_spec(spec))
    want = scene_from_numpy(jax_scene_fields(spec.build()))
    for got_leaf, want_leaf in zip(S._tensor_leaves(scene), S._tensor_leaves(want)):
        assert same_bits(got_leaf, want_leaf)
    assert same_bits(pose0, torch.as_tensor(np.array(spec.initial_pose())))
    assert same_bits(pose0, torch_spec(spec).initial_pose())
    for got_leaf, built_leaf in zip(S._tensor_leaves(scene),
                                    S._tensor_leaves(torch_spec(spec).build())):
        assert same_bits(got_leaf, built_leaf)
    storages = {t.untyped_storage().data_ptr() for t in [*S._tensor_leaves(scene), pose0]}
    assert len(storages) == 1


def test_padded_build_stages_every_leaf():
    spec = torch_spec(mh_tpu.demo_scene(9))
    scene = spec.build(pad_objs=16, pad_rels=4, pad_clearances=8)
    want = scene_from_numpy(jax_scene_fields(
        mh_tpu.demo_scene(9).build(pad_objs=16, pad_rels=4, pad_clearances=8)))
    for got_leaf, want_leaf in zip(S._tensor_leaves(scene), S._tensor_leaves(want)):
        assert same_bits(got_leaf, want_leaf)
    assert_packs_equal(TF._pack(scene, FIXED), TF._pack(untwinned(scene), FIXED))


@pytest.mark.parametrize("shapes", [
    [((), np.float32), ((3,), np.int32), ((4, 2), np.float32), ((5,), np.bool_)],
    [((0, 2), np.int32), ((1,), np.float32), ((), np.int32), ((70,), np.bool_), ((2, 3), np.int32)],
])
def test_stage_keeps_dtype_shape_and_bits(shapes):
    rng = np.random.default_rng(0)
    arrays = [rng.standard_normal(s).astype(d) if d is np.float32
              else rng.integers(-5, 5, s).astype(d) for s, d in shapes]
    tensors = S.stage(arrays)
    for a, t in zip(arrays, tensors):
        assert same_bits(t, torch.from_numpy(np.array(a)))
        assert t.is_contiguous()
        assert t.storage_offset() * t.element_size() % S.STAGE_ALIGN == 0
    assert len({t.untyped_storage().data_ptr() for t in tensors}) == 1


@pytest.mark.parametrize("write", ["w_symmetry", "sizes", "off_rects", "rel_src", "frozen"])
def test_an_in_place_write_makes_the_twin_miss(write):
    spec = torch_spec(weighted(12))
    scene = spec.build()
    assert host_twin(scene) is not None
    if write == "w_symmetry":
        scene.w_symmetry.fill_(-0.5)
        spec = dataclasses.replace(spec, w_symmetry=-0.5)
    elif write == "sizes":
        scene.sizes.mul_(1.5)
        spec = dataclasses.replace(spec, sizes=np.asarray(spec.sizes) * 1.5)
    elif write == "off_rects":
        scene.off_rects.max_y.add_(0.25)
        quads = np.array(spec.offlimit_quads, np.float64)
        ys = quads[..., 1]
        quads[..., 1] = np.where(ys == ys.max(axis=1, keepdims=True), ys + 0.25, ys)
        spec = dataclasses.replace(spec, offlimit_quads=quads)
    elif write == "rel_src":
        scene.rel_src.fill_(2)
        spec = dataclasses.replace(spec, relationships=[(2, 1, 2.0, 4.0)])
    else:
        scene.frozen[3] = True
        fr = np.zeros(12, bool)
        fr[3] = True
        spec = dataclasses.replace(spec, frozen=fr)
    assert host_twin(scene) is None
    fresh = spec.build()
    assert host_twin(fresh) is not None
    for cfg in (PARITY, FIXED):
        assert_packs_equal(TF._pack(scene, cfg), TF._pack(fresh, cfg))


def test_copies_and_other_scenes_carry_no_twin():
    spec = torch_spec(harness(8))
    scene = spec.build()
    assert host_twin(scene.to("meta")) is None
    assert host_twin(scene_from_numpy(scene.to_numpy())) is None
    with torch.inference_mode():
        assert host_twin(spec.build()) is None


def test_writing_the_spec_after_a_build_changes_neither_twin_nor_packing():
    """The twin holds copies: arrays of the spec already in the build's
    dtypes, which ``np.asarray`` would not copy, written after the build."""
    base = torch_spec(frozen(12))
    spec = dataclasses.replace(
        base, sizes=np.asarray(base.sizes, np.float32),
        positions=np.asarray(base.positions, np.float32),
        frozen=np.array(base.frozen), offlimit_quads=np.array(base.offlimit_quads),
        centroid=np.asarray(base.centroid, np.float32),
        clearances=[(np.array(q), s) for q, s in base.clearances])
    scene = spec.build()
    kept = {k: {f: a.copy() for f, a in v.items()} if isinstance(v, dict) else v.copy()
            for k, v in host_twin(scene).items()}
    want = TF._pack(scene, FIXED)
    spec.sizes[:] = 3.0
    spec.positions[:] = 1.0
    spec.frozen[:] = True
    spec.offlimit_quads[:] = 0.0
    spec.centroid[:] = 9.0
    spec.clearances[0][0][:] = 0.0
    twin = host_twin(scene)
    for k, v in kept.items():
        for f, a in (v.items() if isinstance(v, dict) else [("", v)]):
            b = twin[k][f] if f else twin[k]
            assert a.tobytes() == b.tobytes(), (k, f)
    assert_packs_equal(TF._pack(scene, FIXED), want)


def test_a_second_call_with_the_same_spec_packs_again():
    spec = torch_spec(harness(8))
    packs, names = TF.pack_scene.packs, []
    for _ in range(2):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            mh_tpu_torch.suggest_layouts(spec, PARITY, key=3, engine="fused", device="cpu")
        names.append(sorted(e.name for e in prof.events()
                            if e.name in ("mh.pack_scene", "mh.pack_hit", "mh.scene_build")))
    assert TF.pack_scene.packs == packs + 2
    assert names == [["mh.pack_scene", "mh.scene_build"]] * 2


@pytest.mark.parametrize("engine", ["fused", "torch"])
@pytest.mark.parametrize("cfg", [PARITY, FIXED], ids=["parity", "fixed"])
def test_a_spec_call_equals_a_built_scene_call(engine, cfg):
    spec = torch_spec(weighted(16))
    got = mh_tpu_torch.suggest_layouts(spec, cfg, key=7, engine=engine, device="cpu")
    want = mh_tpu_torch.suggest_layouts(spec.build(), cfg, key=7, pose0=spec.initial_pose(),
                                        engine=engine)
    untw = mh_tpu_torch.suggest_layouts(untwinned(spec.build()), cfg, key=7,
                                        pose0=spec.initial_pose(), engine=engine)
    assert (got.accept_rate > 0).any()
    assert_bitwise(got, want)
    assert_bitwise(got, untw)


@pytest.mark.parametrize("n", [0, 1, 31, 128, 129, 300, 4096])
def test_host_block_sum_equals_the_kernel_order(n):
    rng = np.random.default_rng(n)
    for _ in range(10):
        v = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
        want = TF._block_sum(torch.as_tensor(v)[None])[0]
        assert np.float32(TF._block_sum_host(v)).tobytes() == want.numpy().tobytes()
