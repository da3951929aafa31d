"""The port's scene validation and state health check (mh_tpu_torch.utils.validation).

Mirrors tests/test_validation.py: each of its cases goes through
``mh_tpu``'s ``validate_spec`` and the port's on the same spec, carried
across field by field as numpy, and the message lists must be equal.
``check_state_finite`` is a host-side check in the port (between runs;
``mh_tpu`` uses ``checkify`` inside jitted code): it raises ValueError
with the reference's messages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import mh_tpu
import mh_tpu_torch
from mh_tpu.utils.validation import validate_spec as J_validate
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.mh import run_chains
from mh_tpu_torch.utils.validation import check_state_finite, require_valid, validate_spec


def _to_port(spec) -> mh_tpu_torch.SceneSpec:
    def conv(v):
        return np.array(v) if isinstance(v, np.ndarray) else v

    return mh_tpu_torch.SceneSpec(**{f.name: conv(getattr(spec, f.name))
                                     for f in dataclasses.fields(spec)})


def _bad_relationship(spec):
    spec.relationships = [(0, 99, 1.0, 2.0)]


def _bad_angle(spec):
    spec.angle_relationships = [(-1, 2, 0.0, 1.0)]


def _all_frozen(spec):
    spec.frozen = np.ones(4, bool)


def _nonfinite(spec):
    spec.positions[0, 0] = np.nan


def _bad_clearance(spec):
    spec.clearances = [(np.zeros((3, 2)), 7)]


def _bad_shapes(spec):
    spec.sizes = np.zeros((3, 2))
    spec.frozen = np.zeros(5, bool)
    spec.surface_quad = np.zeros((3, 2))


CASES = {
    "valid": (8, lambda spec: None, None),
    "bad_relationship_index": (4, _bad_relationship, "out of range"),
    "bad_angle_index": (4, _bad_angle, "out of range"),
    "all_frozen": (4, _all_frozen, "frozen"),
    "nonfinite_positions": (4, _nonfinite, "non-finite"),
    "bad_clearance": (4, _bad_clearance, "clearance"),
    "bad_shapes": (4, _bad_shapes, "shape"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_validate_spec_gives_mh_tpus_messages(case):
    n, mutate, expect = CASES[case]
    spec = mh_tpu.demo_scene(n)
    mutate(spec)
    want = J_validate(spec)
    got = validate_spec(_to_port(spec))
    assert got == want
    if expect is None:
        assert got == []
        require_valid(_to_port(spec))
    else:
        assert any(expect in e for e in got), got
        with pytest.raises(ValueError, match="invalid scene: "):
            require_valid(_to_port(spec))


def test_check_state_finite():
    spec = mh_tpu_torch.demo_scene(8)
    state, _ = run_chains(prng.key(0), spec.initial_pose(), spec.build(),
                          mh_tpu_torch.SamplerConfig(iterations=10, n_chains=2))
    check_state_finite(state)  # healthy state: no error
    bad = dataclasses.replace(state, pose=state.pose.clone())
    bad.pose[0, 0, 0] = float("nan")
    with pytest.raises(ValueError, match="non-finite pose in state"):
        check_state_finite(bad)
    inf_cost = dataclasses.replace(state, costs=dataclasses.replace(
        state.costs, total=state.costs.total.clone().fill_(float("inf"))))
    with pytest.raises(ValueError, match="non-finite total cost"):
        check_state_finite(inf_cost)
