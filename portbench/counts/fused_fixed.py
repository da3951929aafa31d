"""Operations, bytes and least time of one single-move launch of the MH
kernel with the FIXED off-limits term in the loop (weighted FIXED), on one
H100 (``chip_smoke.py`` ``fused_bound`` with the term tracked, commit
97f1de5).

``fused_single``'s count, plus the pairs the off-limits term changes: a
translated box against the N - 1 other objects, and both boxes of a swap
of two objects (2 N - 3 pairs; a rotation moves no box), read from the
launch's own draws through the frozen counter hash; and the N (N - 1) / 2
pairs of the first and of the final evaluation. Each pair is one box
overlap added into its row. This is the algorithm's own work, not what the
kernel's slab scheme recomputes. Bytes are ``fused_single``'s.
"""

from __future__ import annotations

import numpy as np

from portbench.counts import fused_single as single
from portbench.reference.counter_hash import uniform_lanes_np

# operations of one off-limits pair: the later object's box (4 adds), the
# overlap (2 max, 2 min, 2 compares, 2 sub, a multiply), the mask multiply
# and the add into its row
OVERLAP_OPS = 15


def off_pairs(n: int, n_unf: int, n_chains: int, iterations: int, seed: int,
              first_chain: int = 0) -> int:
    """The off-limits pairs that the steps' moves change, summed over
    ``n_chains`` chains from ``first_chain`` and ``iterations`` single-move
    steps of the run seeded ``seed``."""
    if n_unf == 0:
        return 0
    lanes, unroll = single.PROPOSAL_LANES, min(4, single.DRAW_LANES // single.PROPOSAL_LANES)
    chains = np.arange(first_chain, first_chain + n_chains, dtype=np.int64)
    want = [lanes * j + k for j in range(unroll) for k in (0, 6, 7)]
    last = np.float32(max(n_unf - 1.0, 0.0))
    translates = swaps = 0
    for counter in range(-(-iterations // unroll)):
        u = uniform_lanes_np(seed, counter, chains, want).reshape(n_chains, unroll, 3)
        u = u[:, :min(unroll, iterations - counter * unroll)]
        kind = np.minimum((u[..., 0] * np.float32(3.0)).astype(np.int32), 2)
        k1 = np.minimum(np.floor(u[..., 1] * np.float32(n_unf)), last)
        k2 = np.minimum(np.floor(u[..., 2] * np.float32(n_unf)), last)
        translates += int((kind == 0).sum())
        swaps += int(((kind == 2) & (k1 != k2) & (n >= 2)).sum())
    return translates * (n - 1) + swaps * (2 * n - 3)


def count(n: int, n_unf: int, n_clr: int, rel_rows: int, n_chains: int, iterations: int,
          seed: int, first_chain: int = 0) -> dict:
    """Operations, bytes and least time of ``n_chains`` chains from
    ``first_chain`` over ``iterations`` single-move steps of the run
    seeded ``seed`` (one accept draw a step), the off-limits term in the
    loop."""
    base = single.count(n, n_unf, n_clr, rel_rows, n_chains, iterations, seed, first_chain)
    pairs = off_pairs(n, n_unf, n_chains, iterations, seed, first_chain)
    ends = 2 * n_chains * (n * (n - 1) // 2)
    ops = base["operations"] + (pairs + ends) * OVERLAP_OPS
    t_ops, t_bytes = ops / single.F32_PEAK_FLOPS, base["bytes"] / single.HBM_BYTES_PER_S
    return dict(operations=ops, bytes=base["bytes"], bound_s=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                moved_lanes_per_step=base["moved_lanes_per_step"],
                off_pairs_per_step=pairs / max(iterations * n_chains, 1))


def launch(config: dict, traffic: dict, key: int) -> dict | None:
    """The count of one call's single launch of a cell, or None where the
    call is not a single-move, one-draw launch with the off-limits term in
    the loop (PARITY, FIXED with no off-limits weight, more moves or
    accept draws a step)."""
    s = traffic["sampler"]
    track_off = config["mode"] != "parity" and float(config["scene"]["w_offlimits"]) != 0.0
    if s.get("n_moves_per_step", 1) != 1 or s.get("accept_draws", 1) != 1 or not track_off:
        return None
    return count(**single.sizes(config["scene"]), n_chains=s["n_chains"],
                 iterations=s["iterations"], seed=key)
