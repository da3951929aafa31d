"""Operations and bytes of one single-move launch of the MH kernel, and its
least time on one H100 (frozen from ``chip_smoke.py`` ``fused_bound``,
commit 97f1de5, for single-move launches without the FIXED off-limits
term in the loop).

Operations count the algorithm's own work, whatever implements it: each
step's moved lanes, read from the launch's own draws through the frozen
counter hash (a translate or rotate moves one object, a swap of two
objects two), each matched against every reflection and its own
reflection against every candidate (2 N symmetry values) with its
per-object terms rescored; every object's share of each reduced row; and
the full match and terms of the first and the final evaluation. Bytes:
the poses in and out, the stats rows and the packed scene, each once.
"""

from __future__ import annotations

import numpy as np

from portbench.reference.counter_hash import uniform_lanes_np

# NVIDIA's H100 SXM data sheet, at 700 W: float32 outside the tensor cores,
# device memory
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# operations, a square root counted as one: one symmetry value (2 sub, 2
# mul, add, 2 sqrt, sub, compare, select, sub, mul, abs, the mask test);
# one object's per-object terms (focal, balance, outside area, clearances)
SYM_VAL_OPS, OBJECT_OPS = 14, 60
DRAW_LANES, PROPOSAL_LANES, N_STATS, N_PLANES, N_SCALARS = 128, 8, 10, 10, 32


def sizes(scene: dict) -> dict:
    """The sizes the count needs, from a configuration's scene: objects,
    movable objects, clearances, and the rows of the relationship tables
    (padded to the longer of the two, at least one)."""
    n = len(scene["positions"])
    rows = max(len(scene.get("relationships", [])), len(scene.get("angle_relationships", [])), 1)
    return dict(n=n, n_unf=n - int(np.sum(np.asarray(scene["frozen"], bool))),
                n_clr=len(scene.get("clearances", [])), rel_rows=rows)


def count(n: int, n_unf: int, n_clr: int, rel_rows: int, n_chains: int, iterations: int,
          seed: int, first_chain: int = 0) -> dict:
    """Operations, bytes and least time of ``n_chains`` chains from
    ``first_chain`` over ``iterations`` single-move steps of the run
    seeded ``seed`` (one accept draw a step)."""
    lanes, unroll = PROPOSAL_LANES, min(4, DRAW_LANES // PROPOSAL_LANES)
    chains = np.arange(first_chain, first_chain + n_chains, dtype=np.int64)
    moved = 0
    if n_unf > 0:
        want = [lanes * j + k for j in range(unroll) for k in (0, 6, 7)]
        last = np.float32(max(n_unf - 1.0, 0.0))
        for counter in range(-(-iterations // unroll)):
            u = uniform_lanes_np(seed, counter, chains, want).reshape(n_chains, unroll, 3)
            u = u[:, :min(unroll, iterations - counter * unroll)]
            kind = np.minimum((u[..., 0] * np.float32(3.0)).astype(np.int32), 2)
            k1 = np.minimum(np.floor(u[..., 1] * np.float32(n_unf)), last)
            k2 = np.minimum(np.floor(u[..., 2] * np.float32(n_unf)), last)
            swap = (kind == 2) & (k1 != k2) & (n >= 2)
            moved += int((kind < 2).sum()) + 2 * int(swap.sum())
    rows = 6 + n_clr
    ops = (moved * (2 * n * SYM_VAL_OPS + OBJECT_OPS) + iterations * n_chains * n * rows
           + 2 * n_chains * (n * n * SYM_VAL_OPS + n * (OBJECT_OPS + rows)))
    scene_words = (N_PLANES * n + max(n_unf, 1) + N_SCALARS + 2 * (2 + 3) * rel_rows
                   + (2 + 6) * n_clr)
    nbytes = 2 * 4 * n_chains * n * 6 + 4 * n_chains * N_STATS + 4 * scene_words
    t_ops, t_bytes = ops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    return dict(operations=ops, bytes=nbytes, bound_s=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                moved_lanes_per_step=moved / max(iterations * n_chains, 1))


def launch(config: dict, traffic: dict, key: int) -> dict | None:
    """The count of one call's single launch of a cell, or None where the
    call is not a single-move launch without the off-limits term in the
    loop (more moves or accept draws a step, or weighted FIXED)."""
    s = traffic["sampler"]
    track_off = config["mode"] != "parity" and float(config["scene"]["w_offlimits"]) != 0.0
    if s.get("n_moves_per_step", 1) != 1 or s.get("accept_draws", 1) != 1 or track_off:
        return None
    return count(**sizes(config["scene"]), n_chains=s["n_chains"], iterations=s["iterations"],
                 seed=key)
