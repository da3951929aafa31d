"""mh_tpu_torch scene model against mh_tpu's: the same specs build the same
fields, and scenes cross between the packages as numpy arrays exactly."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mh_tpu
import mh_tpu_torch
from mh_tpu_torch.models.scene import scene_from_numpy
from test_costs import random_spec


def jax_scene_fields(scene) -> dict:
    """An mh_tpu Scene's leaves as numpy arrays keyed by field name."""

    def conv(v):
        if dataclasses.is_dataclass(v):
            return {f.name: conv(getattr(v, f.name)) for f in dataclasses.fields(v)}
        return np.asarray(v)

    return {f.name: conv(getattr(scene, f.name)) for f in dataclasses.fields(scene)}


def to_torch_scene(jax_scene, device=None) -> mh_tpu_torch.Scene:
    return scene_from_numpy(jax_scene_fields(jax_scene), device=device)


def torch_spec(spec: mh_tpu.SceneSpec) -> mh_tpu_torch.SceneSpec:
    """The same host-side spec, as the port's SceneSpec."""
    return mh_tpu_torch.SceneSpec(
        **{f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    )


def assert_fields_equal(want: dict, got: dict, path: str = "") -> None:
    assert set(want) == set(got), path
    for k, w in want.items():
        if isinstance(w, dict):
            assert_fields_equal(w, got[k], f"{path}{k}.")
            continue
        g = got[k]
        assert g.dtype == w.dtype, f"{path}{k}: {g.dtype} != {w.dtype}"
        assert g.shape == w.shape, f"{path}{k}: {g.shape} != {w.shape}"
        np.testing.assert_array_equal(g, w, err_msg=f"{path}{k}")


SPECS = {
    "demo32": lambda: mh_tpu.demo_scene(32),
    "demo100": lambda: mh_tpu.demo_scene(100),
    "random0": lambda: random_spec(np.random.default_rng(0)),
    "random5": lambda: random_spec(np.random.default_rng(5)),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_specs_build_equal_fields(name):
    """Exact: both packages round the same float64 vertices to float32."""
    spec = SPECS[name]()
    want = jax_scene_fields(spec.build())
    got = torch_spec(spec).build().to_numpy()
    assert_fields_equal(want, got)
    np.testing.assert_array_equal(
        torch_spec(spec).initial_pose().numpy(), np.asarray(spec.initial_pose())
    )


def test_demo_scene_specs_equal():
    a, b = mh_tpu.demo_scene(48), mh_tpu_torch.demo_scene(48)
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        elif f.name == "clearances":
            for (qa, sa), (qb, sb) in zip(va, vb):
                np.testing.assert_array_equal(qa, qb)
                assert sa == sb
        else:
            assert va == vb, f.name


def test_padded_build_field_equal():
    spec = random_spec(np.random.default_rng(7), n=9, r=4, c=2)
    want = jax_scene_fields(spec.build(pad_objs=32, pad_rels=16, pad_clearances=8))
    got = torch_spec(spec).build(pad_objs=32, pad_rels=16, pad_clearances=8).to_numpy()
    assert_fields_equal(want, got)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_scene_from_numpy_round_trip_exact(name):
    fields = jax_scene_fields(SPECS[name]().build())
    scene = scene_from_numpy(fields)
    assert_fields_equal(fields, scene.to_numpy())
    assert scene.frozen.dtype == torch.bool
    assert scene.rel_src.dtype == torch.int32
    assert_fields_equal(fields, scene.to("cpu").to_numpy())


def test_scene_from_numpy_rejects_wrong_fields():
    fields = jax_scene_fields(mh_tpu.demo_scene(4).build())
    del fields["focal"]
    with pytest.raises(ValueError, match="focal"):
        scene_from_numpy(fields)


def test_surface_bounds_and_aabb_match():
    spec = random_spec(np.random.default_rng(3))
    js, ts = spec.build(), torch_spec(spec).build()
    for a, b in zip(js.surface_bounds(), ts.surface_bounds()):
        assert float(a) == float(b)
    tx = np.linspace(-3, 3, js.n_pad_objs).astype(np.float32)
    for mode in ("PARITY", "FIXED"):
        want = js.off_rects.aabb(jnp.asarray(tx), jnp.asarray(-tx), mh_tpu.CostMode[mode])
        got = ts.off_rects.aabb(torch.as_tensor(tx), torch.as_tensor(-tx),
                                mh_tpu_torch.CostMode[mode])
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_config_mirrors_reference():
    assert mh_tpu_torch.REF_PI == mh_tpu.REF_PI == 3.1416
    assert mh_tpu_torch.REF_BETA == mh_tpu.REF_BETA
    assert mh_tpu_torch.CostMode.PARITY.pi == mh_tpu.CostMode.PARITY.pi
    assert mh_tpu_torch.CostMode.FIXED.pi == mh_tpu.CostMode.FIXED.pi
    a, b = mh_tpu.SamplerConfig(), mh_tpu_torch.SamplerConfig()
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        assert (va.value if f.name == "mode" else va) == (vb.value if f.name == "mode" else vb)
    for bad in (dict(iterations=-1), dict(n_chains=0), dict(n_moves_per_step=0),
                dict(accept_draws=0)):
        with pytest.raises(ValueError):
            mh_tpu_torch.SamplerConfig(**bad)
