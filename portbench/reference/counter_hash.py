"""The fused kernel's counter-based uniforms (frozen from
``mh_tpu_torch/kernels/counter_rng.py`` and ``kernels/fused_mh.py``
``uniform_block``, commit 97f1de5), for rows that each carry their own
seed and global chain index.

uint32 values are held in int64 with logical shifts; each 32 x 32 multiply
is split in 16-bit halves so no int64 product overflows.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
SEED_MUL = 0x9E3779B9
COUNTER_MUL = 0x85EBCA6B
DRAW_LANES = 128  # uniforms per (chain, draw counter)


def mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) (a tensor or an array)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def mix32(x):
    """triple32-style mixing on uint32 values held in int64."""
    x = x ^ (x >> 17)
    x = mul32(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = mul32(x, 0xAC4C1B51)
    x = x ^ (x >> 15)
    x = mul32(x, 0x31848BAB)
    return x ^ (x >> 14)


def bits23(seeds, counter: int, flat):
    """23 random bits for each ``flat`` index (``chain * 128 + lane``) of
    rows keyed by ``seeds``: ``mix(mix(flat ^ base)) >> 9`` with ``base =
    seed * 0x9E3779B9 ^ counter * 0x85EBCA6B`` (uint32). ``seeds`` and
    ``flat`` are int64 tensors or arrays that broadcast."""
    base = mul32(seeds & M32, SEED_MUL) ^ ((counter * COUNTER_MUL) & M32)
    return mix32(mix32((flat & M32) ^ base)) >> 9


def uniform_rows(seeds: torch.Tensor, chains: torch.Tensor, counter: int,
                 dtype=torch.float32) -> torch.Tensor:
    """``[R, 128]`` uniforms in (0, 1) of draw ``counter`` for row ``r``,
    chain ``chains[r]`` of the run seeded ``seeds[r]`` (int64 ``[R]``):
    ``bits * 2^-23 + 1e-7``, computed in ``dtype``."""
    lanes = torch.arange(DRAW_LANES, dtype=torch.int64, device=seeds.device)
    b = bits23(seeds[:, None], counter, chains[:, None] * DRAW_LANES + lanes)
    return b.to(dtype) * (1.0 / (1 << 23)) + 1e-7


def uniform_lanes_np(seed: int, counter: int, chains: np.ndarray, lanes) -> np.ndarray:
    """The same uniforms in float32 numpy for a few ``lanes`` of every
    chain of one run: ``[len(chains), len(lanes)]``."""
    flat = chains.astype(np.int64)[:, None] * DRAW_LANES + np.asarray(lanes, np.int64)
    b = bits23(np.int64(seed), counter, flat)
    return b.astype(np.float32) * np.float32(1.0 / (1 << 23)) + np.float32(1e-7)
