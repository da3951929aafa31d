"""mh_tpu_torch objective against mh_tpu's: every term and the aggregate, on
random scenes and random poses, in both modes.

Tolerance: rtol=2e-4, atol=2e-3, as tests/test_costs.py holds mh_tpu to its
float64 oracle — both packages compute in float32 with their own libm
(atan2, cos, sqrt) and reduction orders.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mh_tpu
from mh_tpu.ops import costs as JC
from mh_tpu.ops import geometry as JG
from mh_tpu_torch import CostMode
from mh_tpu_torch.ops import costs as TC
from mh_tpu_torch.ops import geometry as TG
import test_torch_threads  # noqa: F401
from test_costs import random_spec
from test_torch_scene import to_torch_scene

RTOL, ATOL = 2e-4, 2e-3
MODES = ["PARITY", "FIXED"]


def random_pose(rng: np.random.Generator, n: int) -> np.ndarray:
    pose = np.zeros((n, 6), np.float32)
    pose[:, 0:2] = rng.uniform(-1.0, 11.0, size=(n, 2))
    pose[:, 2:4] = rng.uniform(-1.0, 1.0, size=(n, 2))
    pose[:, 4] = rng.uniform(0.0, 2 * np.pi, size=n)
    pose[:, 5] = rng.uniform(-1.0, 1.0, size=n)
    return pose


def scene_pair(seed: int):
    rng = np.random.default_rng(seed)
    spec = random_spec(rng)
    js = spec.build()
    return js, to_torch_scene(js), random_pose(rng, js.n_pad_objs)


TERMS = [
    ("pair_wise_costs", False),
    ("pair_wise_angle_costs", True),
    ("visual_balance_costs", False),
    ("focal_point_costs", True),
    ("symmetry_costs", True),
    ("clearance_costs", True),
    ("off_limits_costs", True),
    ("surface_area_costs", True),
]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("term,takes_mode", TERMS)
def test_term_matches_mh_tpu(term, takes_mode, mode, seed):
    js, ts, pose = scene_pair(seed)
    jargs = (jnp.asarray(pose), js) + ((mh_tpu.CostMode[mode],) if takes_mode else ())
    targs = (torch.as_tensor(pose), ts) + ((CostMode[mode],) if takes_mode else ())
    want = float(getattr(JC, term)(*jargs))
    got = float(getattr(TC, term)(*targs))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=f"{term} {mode}")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("mode", MODES)
def test_cost_terms_match_mh_tpu(mode, seed):
    js, ts, pose = scene_pair(seed)
    want = np.asarray(JC.cost_terms(jnp.asarray(pose), js, mh_tpu.CostMode[mode]).as_vector())
    got = TC.cost_terms(torch.as_tensor(pose), ts, CostMode[mode]).as_vector().numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert float(TC.total_cost(torch.as_tensor(pose), ts, CostMode[mode])) == got[0]


@pytest.mark.parametrize("mode", MODES)
def test_demo_scene_cost_terms_match_mh_tpu(mode):
    spec = mh_tpu.demo_scene(100)
    js = spec.build()
    pose = np.array(spec.initial_pose())
    want = np.asarray(JC.cost_terms(jnp.asarray(pose), js, mh_tpu.CostMode[mode]).as_vector())
    got = TC.cost_terms(torch.as_tensor(pose), to_torch_scene(js), CostMode[mode]).as_vector()
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_cost_terms_batched_equals_per_pose():
    """Leading batch dims evaluate each pose independently (exact)."""
    js, ts, _ = scene_pair(4)
    rng = np.random.default_rng(4)
    poses = torch.as_tensor(np.stack([random_pose(rng, js.n_pad_objs) for _ in range(5)]))
    for mode in CostMode:
        batched = TC.cost_terms(poses, ts, mode).as_vector()
        assert batched.shape == (5, 8)
        for c in range(5):
            single = TC.cost_terms(poses[c], ts, mode).as_vector()
            torch.testing.assert_close(batched[c], single, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize(
    "mode,w_off,skipped",
    [("PARITY", -1.0, True), ("FIXED", 0.0, True), ("FIXED", -1.0, False)],
)
def test_skip_unused_offlimits_gate(mode, w_off, skipped):
    """The O(N^2) off-limits matrix is skipped exactly where it cannot change
    the total: always in PARITY, in FIXED only at a zero weight."""
    import dataclasses

    _, ts, pose = scene_pair(2)
    ts = dataclasses.replace(ts, w_offlimits=torch.tensor(w_off))
    pose = torch.as_tensor(pose)
    full = TC.cost_terms(pose, ts, CostMode[mode])
    gated = TC.cost_terms(pose, ts, CostMode[mode], skip_unused_offlimits=True)
    assert float(gated.total) == float(full.total)
    if skipped:
        assert float(gated.off_limits) == 0.0
    else:
        assert float(gated.off_limits) == float(full.off_limits) != 0.0


def test_geometry_matches_mh_tpu():
    rng = np.random.default_rng(11)
    a = [rng.uniform(-5, 5, size=64).astype(np.float32) for _ in range(8)]
    j = [jnp.asarray(v) for v in a]
    t = [torch.as_tensor(v) for v in a]
    for pi in (3.1416, np.pi):
        pairs = [
            (JG.distance(*j[:4]), TG.distance(*t[:4])),
            (JG.theta(*j[:5], pi), TG.theta(*t[:5], pi)),
            (JG.phi(*j[:5], pi), TG.phi(*t[:5], pi)),
            (JG.wrap_angle_once(j[0] * 2, pi), TG.wrap_angle_once(t[0] * 2, pi)),
        ]
        for want, got in pairs:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    lo = [np.minimum(a[k], a[k + 1]) for k in (0, 2)]
    hi = [np.maximum(a[k], a[k + 1]) for k in (0, 2)]
    box_a = [lo[0], lo[1], hi[0], hi[1]]
    box_b = [v + np.float32(1.0) for v in box_a]
    want = JG.intersection_area(*map(jnp.asarray, box_a + box_b))
    got = TG.intersection_area(*map(torch.as_tensor, box_a + box_b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    surf = [np.float32(0), np.float32(0), np.float32(4), np.float32(4)]
    want = JG.outside_surface_area(*map(jnp.asarray, box_a + surf))
    got = TG.outside_surface_area(*map(torch.as_tensor, box_a + surf))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_floor_mod_matches_jnp_mod():
    x = np.array([-7.5, -6.2832, -1e-3, 0.0, 1e-3, 3.0, 6.2832, 12.9], np.float32)
    want = np.asarray(jnp.mod(jnp.asarray(x), 2 * 3.1416))
    np.testing.assert_array_equal(TC.floor_mod(torch.as_tensor(x), 2 * 3.1416).numpy(), want)
