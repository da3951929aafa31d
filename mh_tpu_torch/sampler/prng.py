"""``jax.random``'s threefry-2x32 stream, bit for bit, in plain PyTorch.

The chain engine of ``mh_tpu`` draws every random number through
``jax.random`` with the default threefry implementation and the
partitionable layout (``jax_threefry_partitionable=True``). This module
reproduces that stream, so the port's engine consumes exactly the uniforms
``mh_tpu``'s engine consumes:

- ``key(seed)`` is the word pair ``(0, seed mod 2^32)``;
- ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
- ``split(k, n)[i]`` is ``threefry2x32(k, (hi(i), lo(i)))``, which equals
  ``fold_in(k, i)``;
- ``uniform(k, shape)`` hashes each flat index ``i`` of ``shape`` as the
  counter ``(hi(i), lo(i))``, takes ``out0 ^ out1``, keeps its top 23 bits
  as the mantissa of a float in [1, 2) and subtracts 1.

A key is an int64 tensor ``[..., 2]`` holding two 32-bit words; every
function is batched over the leading dims of its key. The words are int64
with every result masked to 32 bits (PyTorch has no full uint32
arithmetic), so the same code runs on CPU and CUDA tensors, reads nothing
back to the host and can be captured in a CUDA graph.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1) -> tuple[Tensor, Tensor]:
    """The Threefry-2x32 hash (20 rounds), as ``jax._src.prng`` computes it.

    Every argument is an int64 tensor (or int) of 32-bit words; they
    broadcast. Returns the two output words.
    """
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def key(seed: int, device=None) -> Tensor:
    """``jax.random.key(seed)`` as its two words, ``(0, seed mod 2^32)``."""
    return torch.tensor([0, seed & M32], dtype=torch.int64, device=device)


def key_data(k: Tensor) -> np.ndarray:
    """The key words as uint32, the layout of ``jax.random.key_data``."""
    return k.detach().cpu().numpy().astype(np.uint32)


def wrap_key_data(words, device=None) -> Tensor:
    """A key from its uint32 words (e.g. ``jax.random.key_data(k)``)."""
    return torch.as_tensor(np.asarray(words, np.uint32).astype(np.int64), device=device)


def fold_in(k: Tensor, data) -> Tensor:
    """``jax.random.fold_in``: keys ``[..., 2]`` and data (int or int tensor,
    taken mod 2^32) broadcast over the leading dims."""
    if isinstance(data, Tensor):
        data = data.to(torch.int64) & M32
    else:
        data = int(data) & M32
    out0, out1 = threefry2x32(k[..., 0], k[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(out0, out1), -1)


def split(k: Tensor, n: int = 2) -> Tensor:
    """``jax.random.split(k, n)``: ``[..., n, 2]``; entry ``i`` is
    ``fold_in(k, i)`` (counters below 2^32 have a zero high word)."""
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    return fold_in(k[..., None, :], idx)


def random_bits(k: Tensor, shape: tuple[int, ...]) -> Tensor:
    """32 random bits (int64 in [0, 2^32)) per element: ``[..., *shape]``."""
    shape = tuple(shape)
    n = math.prod(shape)
    flat = torch.arange(n, dtype=torch.int64, device=k.device)
    out0, out1 = threefry2x32(k[..., 0, None], k[..., 1, None], flat >> 32, flat & M32)
    return (out0 ^ out1).reshape(tuple(k.shape[:-1]) + shape)


def f32(v: float) -> float:
    """``v`` rounded to float32, as JAX rounds a Python scalar operand. The
    result is exact in float32, so a PyTorch op on a float32 tensor uses
    the same value on either device."""
    return float(np.float32(v))


def reciprocal(n: int) -> float:
    """``1 / n`` in float32. XLA turns a division by a constant into a
    multiply by its float32 reciprocal, and so does PyTorch on CUDA for a
    host scalar; the port multiplies by it explicitly on both devices."""
    return float(np.float32(1.0) / np.float32(n))


def uniform(k: Tensor, shape: tuple[int, ...] = (), minval=0.0, maxval=1.0) -> Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: ``[..., *shape]``.

    Bounds are Python numbers (rounded to float32, as JAX rounds them) or
    float32 tensors that broadcast against the result. XLA contracts the
    scaling ``f * (maxval - minval) + minval`` into one fused multiply-add;
    here the product is exact in float64 and the sum is rounded once more
    to float32, which gives the fused result on both devices (the two can
    part only where the float64 sum lands on a float32 rounding midpoint).
    """
    bits = random_bits(k, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    if not isinstance(minval, Tensor) and not isinstance(maxval, Tensor):
        lo, hi = f32(minval), f32(maxval)
        if (lo, hi) == (0.0, 1.0):
            return f  # f * 1 + 0, floored at 0: f itself
        span = f32(np.float32(hi) - np.float32(lo))
        return torch.clamp_min((f.double() * span + lo).float(), lo)
    lo = torch.as_tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.as_tensor(maxval, dtype=torch.float32, device=f.device)
    scaled = f.double() * (hi - lo).double() + lo.double()
    return torch.maximum(lo, scaled.float())
