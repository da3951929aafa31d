"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports neither JAX nor mh_tpu, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The fused kernel sums in the plain version's order and is built without
contracted multiply-adds, so on one card the two agree exactly; the pi
kernel counts exactly the plain version's hits.
"""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

import mh_tpu_torch
from mh_tpu_torch.kernels import fused_mh as TF
from mh_tpu_torch.kernels import pi_kernel as TP

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def test_uniform_block_bits(cuda):
    for seed, counter, first in ((0, 0, 0), (7, 3, 40), (-5, 999, 1 << 20)):
        got = TF.uniform_block_cuda(seed, counter, first, 64, cuda)
        want = TF.uniform_block(seed, counter, first, 64, cuda)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("mode,w_off", [("PARITY", 0.0), ("FIXED", 0.0), ("FIXED", -1.5)])
def test_kernel_matches_reference(cuda, mode, w_off):
    spec = mh_tpu_torch.demo_scene(32)
    scene = dataclasses.replace(
        spec.build(device=cuda), w_offlimits=torch.tensor(w_off, device=cuda))
    cfg = mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode[mode], adapt=mode == "FIXED")
    pk = TF.pack_scene(scene, cfg)
    pose0 = spec.initial_pose(device=cuda).expand(64, 32, 6).contiguous()
    launches = TF.fused_mh_cuda.launches
    got = TF.fused_mh_cuda(pk, pose0, 5, 50)
    assert TF.fused_mh_cuda.launches == launches + 1
    want = TF.fused_chains_reference(pk, pose0, 5, 50)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("moves,draws", [(4, 1), (4, 4), (1, 16), (1, 30)])
@pytest.mark.parametrize("mode,w_off", [("PARITY", 0.0), ("FIXED", -1.5)])
def test_compound_kernel_matches_reference(cuda, moves, draws, mode, w_off):
    spec = mh_tpu_torch.demo_scene(32)
    scene = dataclasses.replace(
        spec.build(device=cuda), w_offlimits=torch.tensor(w_off, device=cuda))
    cfg = mh_tpu_torch.SamplerConfig(mode=mh_tpu_torch.CostMode[mode], adapt=mode == "FIXED",
                                     n_moves_per_step=moves, accept_draws=draws)
    pk = TF.pack_scene(scene, cfg)
    pose0 = spec.initial_pose(device=cuda).expand(64, 32, 6).contiguous()
    got = TF.fused_mh_cuda(pk, pose0, 9, 40)
    want = TF.fused_chains_reference(pk, pose0, 9, 40)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed,total", [(0, 1 << 24), (7, 12345), (-3, (1 << 22) + 1), (1, 0)])
def test_pi_hits_equal_reference(cuda, seed, total):
    launches = TP.pi_hits_cuda.launches
    assert TP.pi_hits_cuda(seed, total, cuda) == TP.pi_hits_reference(seed, total, cuda)
    assert TP.pi_hits_cuda.launches == launches + 1


def test_estimate_pi_fused_on_card(cuda):
    calls = TP.pi_hits_reference.calls
    est, total = TP.estimate_pi_fused(0, 1 << 28, device=cuda)
    assert total == 1 << 28
    sigma = 4 * math.sqrt((math.pi / 4) * (1 - math.pi / 4) / total)
    assert abs(est - math.pi) < 6 * sigma
    assert (est, total) == TP.estimate_pi_fused(0, 1 << 28, device=cuda)
    assert TP.pi_hits_reference.calls == calls


def test_spec_runs_on_cuda_by_default(cuda):
    launches, calls = TF.fused_mh_cuda.launches, TF.fused_chains_reference.calls
    res = mh_tpu_torch.suggest_layouts(
        mh_tpu_torch.demo_scene(10), mh_tpu_torch.SamplerConfig(iterations=20, n_chains=4))
    assert TF.fused_mh_cuda.launches == launches + 1
    assert TF.fused_chains_reference.calls == calls
    assert res.costs.shape == (4, 8)


def test_run_chains_fused_launches_the_kernel(cuda):
    spec = mh_tpu_torch.demo_scene(12)
    launches, calls = TF.fused_mh_cuda.launches, TF.fused_chains_reference.calls
    out = TF.run_chains_fused(1, spec.initial_pose(), spec.build(),
                              mh_tpu_torch.SamplerConfig(), 16, 40, device=cuda)
    assert TF.fused_mh_cuda.launches == launches + 1
    assert TF.fused_chains_reference.calls == calls
    assert all(t.device.type == "cuda" for t in out)
    ref = mh_tpu_torch.cost_terms(out[0], spec.build(device=cuda)).as_vector()
    torch.testing.assert_close(out[1], ref, rtol=2e-4, atol=2e-3)


def test_too_many_objects_for_shared_memory_raise(cuda):
    spec = mh_tpu_torch.demo_scene(6000)
    pk = TF.pack_scene(spec.build(device=cuda), mh_tpu_torch.SamplerConfig())
    with pytest.raises(ValueError, match="shared"):
        TF.fused_mh_cuda(pk, spec.initial_pose(device=cuda)[None].contiguous(), 0, 1)
