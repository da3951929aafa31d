"""``jax.random``'s threefry-2x32 stream, as the torch chain engine draws
it (frozen from ``mh_tpu_torch/sampler/prng.py``, commit 97f1de5): the
key words, ``fold_in`` and ``uniform`` on [0, 1). A key is an int64 tensor
``[..., 2]`` of two 32-bit words.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def f32(v: float) -> float:
    """``v`` rounded to float32, as JAX rounds a Python scalar operand."""
    return float(np.float32(v))


def _rotl(x, r: int):
    return ((x << r) & M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) on int64 words that broadcast."""
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


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)``: the words ``(0, seed mod 2^32)``."""
    return torch.tensor([0, seed & M32], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of keys ``[..., 2]`` and data (int or int
    tensor, mod 2^32), broadcast over the leading dims."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & M32
    else:
        data = int(data) & M32
    out0, out1 = threefry2x32(k[..., 0], k[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(out0, out1), -1)


def uniform(k: torch.Tensor, shape: tuple[int, ...] = ()) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` on [0, 1) in float32: ``[..., *shape]``."""
    shape = tuple(shape)
    flat = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device)
    out0, out1 = threefry2x32(k[..., 0, None], k[..., 1, None], flat >> 32, flat & M32)
    bits = (out0 ^ out1).reshape(tuple(k.shape[:-1]) + shape)
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
