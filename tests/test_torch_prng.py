"""mh_tpu_torch.sampler.prng against jax.random, bit for bit.

The port's chain engine draws through these functions, so a single
differing bit would send every chain of the port down another path than
mh_tpu's. Every comparison here is exact: keys as their uint32 words,
uniforms as their float32 bit patterns.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mh_tpu_torch.sampler import prng

import test_torch_threads  # noqa: F401

SEEDS = [0, 1, 42, 123456789, 2**31 - 1, 2**31 + 5, 2**32 - 1, -1, -7]
DATA = [0, 1, 2, 7, 0x7E3, 0x9A1, 2**31 - 1, 2**31, 2**31 + 3, 2**32 - 1]


def jax_words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k))


def bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(prng.key_data(tk), jax_words(jk))
    for d in DATA:
        np.testing.assert_array_equal(prng.key_data(prng.fold_in(tk, d)),
                                      jax_words(jax.random.fold_in(jk, d)), err_msg=str(d))
    np.testing.assert_array_equal(prng.key_data(prng.split(tk, 7)),
                                  jax_words(jax.random.split(jk, 7)))


def test_key_of_minus_one_is_all_ones_low_word():
    np.testing.assert_array_equal(prng.key_data(prng.key(-1)), [0, 4294967295])


def test_fold_in_batched_over_keys_and_data():
    """Tensor data (including >= 2^31) fold per element, as jax.vmap does."""
    data = np.array([0, 5, 2**31, 2**32 - 2, 77], np.uint32)
    want = jax.vmap(lambda d: jax.random.fold_in(jax.random.key(9), d))(jnp.asarray(data))
    got = prng.fold_in(prng.key(9), torch.as_tensor(data.astype(np.int64)))
    np.testing.assert_array_equal(prng.key_data(got), jax_words(want))
    # a batch of keys, each folded with its own datum
    keys = prng.split(prng.key(3), 4)
    want = jax.vmap(jax.random.fold_in)(jax.random.split(jax.random.key(3), 4),
                                        jnp.arange(4, dtype=jnp.uint32) + 10)
    got = prng.fold_in(keys, torch.arange(4) + 10)
    np.testing.assert_array_equal(prng.key_data(got), jax_words(want))


@pytest.mark.parametrize("shape", [(), (1,), (3,), (8,), (64,), (4, 8), (64, 8), (2, 3, 5)])
@pytest.mark.parametrize("seed", [0, 11, 2**31 + 1, -3])
def test_uniform_bits(seed, shape):
    want = jax.random.uniform(jax.random.key(seed), shape)
    got = prng.uniform(prng.key(seed), shape)
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float32
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0 / 64), (0.0, 2 * 3.1416), (-3.0, 7.5),
                                   (1.25, 9.75), (-1e3, 1e-3)])
def test_uniform_bounds(lo, hi):
    """Python and tensor bounds, over many draws (XLA fuses the scaling
    into one multiply-add; the port's float64 scaling gives its bits)."""
    for seed in range(8):
        jk, tk = jax.random.key(seed), prng.key(seed)
        want = jax.random.uniform(jk, (257,), minval=lo, maxval=hi)
        np.testing.assert_array_equal(bits(prng.uniform(tk, (257,), lo, hi).numpy()),
                                      bits(want))
        want = jax.random.uniform(jk, (257,), minval=jnp.float32(lo), maxval=jnp.float32(hi))
        got = prng.uniform(tk, (257,), torch.tensor(lo), torch.tensor(hi))
        np.testing.assert_array_equal(bits(got.numpy()), bits(want))


def test_uniform_batched_keys_match_vmap():
    """The engine's draw: per-chain keys folded with per-chain steps, (M, 8)
    and K = 64 accept draws each."""
    chains = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(5), i))(jnp.arange(6))
    steps = jnp.asarray([0, 1, 17, 2**31, 999, 3], jnp.uint32)
    step_keys = jax.vmap(jax.random.fold_in)(chains, steps)
    t_chains = prng.fold_in(prng.key(5), torch.arange(6))
    t_step = prng.fold_in(t_chains, torch.as_tensor(np.asarray(steps).astype(np.int64)))
    np.testing.assert_array_equal(prng.key_data(t_step), jax_words(step_keys))
    want = jax.vmap(lambda k: jax.random.uniform(k, (4, 8)))(step_keys)
    np.testing.assert_array_equal(bits(prng.uniform(t_step, (4, 8)).numpy()), bits(want))
    want = jax.vmap(lambda k: jax.random.uniform(jax.random.fold_in(k, 1), (64,)))(step_keys)
    got = prng.uniform(prng.fold_in(t_step, 1), (64,))
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


def test_wrap_key_data_round_trip():
    words = jax_words(jax.random.split(jax.random.key(8), 3))
    k = prng.wrap_key_data(words)
    assert k.dtype == torch.int64 and tuple(k.shape) == (3, 2)
    np.testing.assert_array_equal(prng.key_data(k), words)


def test_uniform_range_and_mean():
    u = prng.uniform(prng.key(0), (4096,))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.02
