"""The port's Monte-Carlo pi estimators against mh_tpu's and analytic pi.

``mh_tpu``'s pi kernel draws from the TPU's hardware generator and runs
only on a TPU, so the port's kernel cannot match it draw for draw. The
port is held to: pi within 6 sigma of the binomial error, agreement with
``mh_tpu.estimate_pi`` within the combined 6 sigma of both estimates, the
same sample count as ``mh_tpu``'s kernel for the same arguments, and exact
hit counts of its plain version against an independent numpy count of the
same counter hash. The plain ``estimate_pi`` draws ``mh_tpu``'s threefry
points, so it equals ``mh_tpu.estimate_pi`` exactly wherever both count
exactly (under 2^24 hits, over a power-of-two total).
tests/test_torch_cuda.py holds the CUDA kernel's counts to the plain
version's exactly, and the card's plain estimate to the CPU's.
"""

from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch

import mh_tpu
from mh_tpu.kernels import pi_kernel as JP
import mh_tpu_torch
from mh_tpu_torch.kernels import counter_rng
from mh_tpu_torch.kernels import pi_kernel as TP


def sigma(n: int) -> float:
    """Standard deviation of 4 * hits / n with hits ~ Binomial(n, pi/4)."""
    return 4 * math.sqrt((math.pi / 4) * (1 - math.pi / 4) / n)


def np_counter_bits(seed: int, counter: np.ndarray, flat: np.ndarray) -> np.ndarray:
    """The counter hash in numpy uint32 arithmetic (wrapping multiplies)."""
    with np.errstate(over="ignore"):
        u = np.uint32
        x = flat.astype(u) ^ (u(seed & 0xFFFFFFFF) * u(0x9E3779B9)
                              ^ counter.astype(u) * u(0x85EBCA6B))
        for _ in range(2):
            x = x ^ (x >> u(17))
            x = x * u(0xED5AD4BB)
            x = x ^ (x >> u(11))
            x = x * u(0xAC4C1B51)
            x = x ^ (x >> u(15))
            x = x * u(0x31848BAB)
            x = x ^ (x >> u(14))
        return (x >> u(9)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1])
def test_estimate_pi_within_mc_error(seed):
    n = 1 << 18
    assert abs(mh_tpu_torch.estimate_pi(seed, n_samples=n, device="cpu") - math.pi) < 6 * sigma(n)


def test_estimate_pi_deterministic_per_seed():
    a = mh_tpu_torch.estimate_pi(3, n_samples=1 << 16, device="cpu")
    assert a == mh_tpu_torch.estimate_pi(3, n_samples=1 << 16, device="cpu")
    assert a != mh_tpu_torch.estimate_pi(4, n_samples=1 << 16, device="cpu")


def test_estimate_pi_without_device_needs_cuda(monkeypatch):
    """The exported estimator runs on the card by default; without one it
    raises and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mh_tpu_torch.estimate_pi(0, n_samples=1 << 10)


@pytest.mark.parametrize("seed", [0, 5])
def test_fused_plain_version_within_mc_error(seed):
    est, total = TP.estimate_pi_fused(seed, 1 << 18, device="cpu")
    assert total == 1 << 18
    assert abs(est - math.pi) < 6 * sigma(total)
    assert (est, total) == TP.estimate_pi_fused(seed, 1 << 18, device="cpu")


@pytest.mark.parametrize("seed", [0, 2])
def test_agrees_with_mh_tpu_estimate_pi(seed):
    n = 1 << 18
    want = float(mh_tpu.estimate_pi(jax.random.key(seed), n_samples=n))
    for got in (mh_tpu_torch.estimate_pi(seed, n_samples=n, device="cpu"),
                TP.estimate_pi_fused(seed, n, device="cpu")[0]):
        assert abs(got - want) < 6 * math.sqrt(2) * sigma(n)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n,batch", [(1 << 16, 1 << 12), (1 << 18, 1 << 16)])
def test_estimate_pi_equals_mh_tpu_exactly(seed, n, batch):
    """Batch i is mh_tpu's ``uniform(fold_in(key, i), (batch, 2))``: the
    same hits, and (under 2^24 hits, a power-of-two total) the same float."""
    want = float(mh_tpu.estimate_pi(jax.random.key(seed), n, batch))
    assert mh_tpu_torch.estimate_pi(seed, n, batch, device="cpu") == want


@pytest.mark.parametrize("n,grid", [(1, 8), (1 << 18, 8), ((1 << 18) + 1, 8),
                                    (1000, 1), (5 * (1 << 15) - 7, 3), (1 << 30, 8)])
def test_total_rounds_like_mh_tpu(n, grid):
    assert TP.TILE_N == JP.TILE_N
    assert TP.pi_total(n, grid) == -(-n // (JP.TILE_N * grid)) * JP.TILE_N * grid


@pytest.mark.parametrize("n,grid", [(0, 8), (10, 0)])
def test_bad_counts_raise(n, grid):
    with pytest.raises(ValueError):
        TP.estimate_pi_fused(0, n, grid, device="cpu")


@pytest.mark.parametrize("seed,total", [(0, 1000), (-7, 4097), (2**31 - 1, 1 << 15)])
def test_plain_hits_equal_numpy_count(seed, total):
    """Exact hits: sample s's x and y are the 23-bit hashes of flat indices
    2s and 2s + 1 under counter s >> 31, scaled by 2^-23, tested in f32."""
    s = np.arange(total, dtype=np.int64)
    x = np_counter_bits(seed, s >> 31, 2 * s).astype(np.float32) * np.float32(2.0**-23)
    y = np_counter_bits(seed, s >> 31, 2 * s + 1).astype(np.float32) * np.float32(2.0**-23)
    want = int(np.count_nonzero(x * x + y * y <= np.float32(1.0)))
    calls = TP.pi_hits_reference.calls
    assert TP.pi_hits_reference(seed, total) == want
    assert TP.pi_hits_reference.calls == calls + 1


def test_counter_bits_past_2_to_31_samples():
    """Counters above 0 (samples past 2^31) and wrapped flat indices hash
    like numpy's uint32 arithmetic."""
    rng = np.random.default_rng(0)
    s = rng.integers(0, 1 << 40, size=4096, dtype=np.int64)
    for coord in (0, 1):
        flat = (2 * s + coord) & 0xFFFFFFFF
        got = counter_rng.counter_bits(9, torch.as_tensor(s >> 31), torch.as_tensor(flat))
        np.testing.assert_array_equal(got.numpy(), np_counter_bits(9, s >> 31, flat))


def test_cuda_wrapper_refuses_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        TP.pi_hits_cuda(0, 1 << 15, device="cpu")
