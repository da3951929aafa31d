"""The counter-based random stream, in plain PyTorch.

The host side of ``csrc/counter_rng.cuh`` and of the JAX kernel's
``_uniform_sw`` (``mh_tpu/kernels/fused_mh.py:357-402``) with the
``draw_block`` base (``:1403-1408``). uint32 values are held in int64 with
logical shifts; each 32x32 multiply is split in 16-bit halves so no int64
product overflows.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

M32 = 0xFFFFFFFF
SEED_MUL = 0x9E3779B9
COUNTER_MUL = 0x85EBCA6B


def mul32(x: Tensor, c: int) -> Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def mix32(x: Tensor) -> Tensor:
    """triple32-style mixing on uint32 values held in int64 (logical shifts)."""
    x = x ^ (x >> 17)
    x = mul32(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = mul32(x, 0xAC4C1B51)
    x = x ^ (x >> 15)
    x = mul32(x, 0x31848BAB)
    return x ^ (x >> 14)


def counter_bits(seed: int, counter: int | Tensor, flat: Tensor) -> Tensor:
    """23 random bits (int64) for each ``flat`` index under one or many counters:
    ``mix(mix(flat ^ base)) >> 9`` with ``base = seed * 0x9E3779B9 ^
    counter * 0x85EBCA6B`` (uint32)."""
    if isinstance(counter, Tensor):
        cmix = mul32(counter & M32, COUNTER_MUL)
    else:
        cmix = (counter * COUNTER_MUL) & M32
    base = ((seed * SEED_MUL) & M32) ^ cmix
    return mix32(mix32((flat & M32) ^ base)) >> 9
