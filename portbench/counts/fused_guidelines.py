"""Operations, bytes and least time of one single-move launch of the MH
kernel on a scene with many design guidelines (clearances, distance and
angle relationships), on one H100.

``fused_single``'s count, plus the guideline work that the launch's own
moves change, read from its draws through the frozen counter hash (as
``fused_fixed.off_pairs`` reads them):

- clearance c, its rect anchored at its source object, overlaps every
  object's box; a step changes the pairs (c, j) whose object j or whose
  source moved: for a moved set P of boxes, |P| C + A (N - |P|) pairs,
  A the clearances anchored in P;
- clearance c's outside-surface term, at its surface anchor (object c in
  PARITY, its source in FIXED), where that anchor moved;
- the distance rows with an end in P, and the angle rows with an end in P
  or whose target's rotation moved;
- every pair and row of the first and of the final evaluation.

A translate moves one box, a swap of two objects both boxes and both
rotations, a rotation one rotation and no box (a box is placed by the
position alone). This is the algorithm's work, whatever implements it:
the kernel rescans every object against every clearance each step, which
``fused_single`` counts as one add per object per reduced row, and which
is left there. Bytes are ``fused_single``'s, whose scene words hold every
row and clearance.

Operations of one term, from the kernel's expressions
(``csrc/fused_mh.cu`` ``lane_partials`` and ``entity_terms``), a square
root, a division, a select and a compare each counted as one:

- a clearance pair, ``CLEARANCE_OPS``: the anchored rect (the PARITY
  ``aabb_minx`` an add and a min, FIXED's an add; three adds), the
  overlap (2 max, 2 min, 2 compares, 2 sub, a multiply) and the mask
  multiply; its add into the row is ``fused_single``'s row count;
- an outside-surface term, ``SURFACE_OPS``: the anchored rect as above,
  the overlap with the surface (9), the rect's area (2 sub, a multiply),
  the area less the overlap, the max with 0, and the add into the sum;
- a distance row, ``DISTANCE_OPS``: 2 sub, 2 multiplies, an add and a
  square root; each of the two quotients a compare, a select and a divide;
  the penalty's 2 compares, 2 squares, 2 negations and 2 selects; the
  mask multiply and the add;
- an angle row, ``ANGLE_OPS``: ``atan2_poly`` (2 abs, max, min, the max
  with 1e-30, a divide, a square; the polynomial's 5 multiplies and 5
  adds; the multiply by a; three compare-adjust-selects) 27; the two wraps
  into [0, 2 pi) 3 each and the target's rotation subtracted 1; the
  deviation (2 sub, 2 abs, min) 5; the wrap case's compare 1 and its norm
  (sub, divide, select) 3; ``floor_mod(amin + th, 2 pi) > amax`` (the add,
  fmod, 5 compares and logic, the add and select of the adjustment, the
  compare) 10; the plain norm (2 sub, a divide, compare, select) 5; the
  plain condition (2 compares, an or) 3; the penalty (2 negations, 2
  divides, 3 selects) 7; the mask multiply and the add 2.
"""

from __future__ import annotations

import numpy as np

from portbench.counts import fused_single as single
from portbench.reference.counter_hash import uniform_lanes_np

CLEARANCE_OPS = {True: 15, False: 14}  # by PARITY
SURFACE_OPS = {True: 20, False: 19}
DISTANCE_OPS, ANGLE_OPS = 22, 70


def tables(scene: dict, parity: bool) -> dict:
    """Per object lane: the clearances anchored at it (``anc``), the
    outside-surface terms anchored at it (``surf``), the distance and
    angle rows with an end at it (``rel_deg``, ``ang_deg``), the angle rows
    whose target it is (``ang_tgt``), and per pair of lanes the rows that
    join them (``rel_both``, ``ang_both``)."""
    n = len(scene["positions"])
    src = np.asarray([int(s) for _, s in scene.get("clearances", [])], np.int64)
    anchor = np.minimum(np.arange(len(src)), n - 1) if parity else src

    def rows(key):
        r = np.asarray([[int(a), int(b)] for a, b, *_ in scene.get(key, [])], np.int64)
        r = r.reshape(-1, 2)
        deg = np.bincount(r[:, 0], minlength=n) + np.bincount(r[:, 1], minlength=n)
        deg -= np.bincount(r[r[:, 0] == r[:, 1], 0], minlength=n)
        both = np.zeros((n, n), np.int64)
        two = r[r[:, 0] != r[:, 1]]
        np.add.at(both, (two[:, 0], two[:, 1]), 1)
        return r, deg, both + both.T

    rel, rel_deg, rel_both = rows("relationships")
    ang, ang_deg, ang_both = rows("angle_relationships")
    return dict(n=n, n_clr=len(src), n_rel=len(rel), n_ang=len(ang),
                anc=np.bincount(src, minlength=n), surf=np.bincount(anchor, minlength=n),
                rel_deg=rel_deg, rel_both=rel_both, ang_deg=ang_deg, ang_both=ang_both,
                ang_tgt=np.bincount(ang[:, 1], minlength=n),
                unf=np.flatnonzero(~np.asarray(scene["frozen"], bool)))


def changed(tab: dict, n_chains: int, iterations: int, seed: int, first_chain: int = 0) -> dict:
    """The clearance pairs, outside-surface terms, distance rows and angle
    rows that the steps' moves change, summed over ``n_chains`` chains
    from ``first_chain`` and ``iterations`` single-move steps of the run
    seeded ``seed``."""
    n, c, unf = tab["n"], tab["n_clr"], tab["unf"]
    out = dict(pairs=0, surf=0, rel=0, ang=0)
    if unf.size == 0:
        return out
    lanes, unroll = single.PROPOSAL_LANES, min(4, single.DRAW_LANES // single.PROPOSAL_LANES)
    chains = np.arange(first_chain, first_chain + n_chains, dtype=np.int64)
    want = [lanes * j + k for j in range(unroll) for k in (0, 6, 7)]
    last = np.float32(max(unf.size - 1.0, 0.0))
    for counter in range(-(-iterations // unroll)):
        u = uniform_lanes_np(seed, counter, chains, want).reshape(n_chains, unroll, 3)
        u = u[:, :min(unroll, iterations - counter * unroll)]
        kind = np.minimum((u[..., 0] * np.float32(3.0)).astype(np.int32), 2)
        k1 = np.minimum(np.floor(u[..., 1] * np.float32(unf.size)), last).astype(np.int64)
        k2 = np.minimum(np.floor(u[..., 2] * np.float32(unf.size)), last).astype(np.int64)
        a, b = unf[k1], unf[k2]
        tr, rot = kind == 0, kind == 1
        sw = (kind == 2) & (k1 != k2) & (n >= 2)
        a_t, a_r, a_s, b_s = a[tr], a[rot], a[sw], b[sw]
        anc_s = tab["anc"][a_s] + tab["anc"][b_s]
        out["pairs"] += int((c + tab["anc"][a_t] * (n - 1)).sum()
                            + (2 * c + anc_s * (n - 2)).sum())
        out["surf"] += int(tab["surf"][a_t].sum() + (tab["surf"][a_s] + tab["surf"][b_s]).sum())
        out["rel"] += int(tab["rel_deg"][a_t].sum() + (
            tab["rel_deg"][a_s] + tab["rel_deg"][b_s] - tab["rel_both"][a_s, b_s]).sum())
        out["ang"] += int(tab["ang_deg"][a_t].sum() + tab["ang_tgt"][a_r].sum() + (
            tab["ang_deg"][a_s] + tab["ang_deg"][b_s] - tab["ang_both"][a_s, b_s]).sum())
    return out


def count(scene: dict, parity: bool, n_chains: int, iterations: int, seed: int,
          first_chain: int = 0) -> dict:
    """Operations, bytes and least time of ``n_chains`` chains from
    ``first_chain`` over ``iterations`` single-move steps of the run
    seeded ``seed`` (one accept draw a step) on the scene ``scene`` (a
    configuration's ``scene`` object)."""
    base = single.count(**single.sizes(scene), n_chains=n_chains, iterations=iterations,
                        seed=seed, first_chain=first_chain)
    tab = tables(scene, parity)
    moves = changed(tab, n_chains, iterations, seed, first_chain)
    ends = 2 * n_chains
    pairs = moves["pairs"] + ends * tab["n"] * tab["n_clr"]
    surf = moves["surf"] + ends * tab["n_clr"]
    rel = moves["rel"] + ends * tab["n_rel"]
    ang = moves["ang"] + ends * tab["n_ang"]
    extra = (pairs * CLEARANCE_OPS[parity] + surf * SURFACE_OPS[parity] + rel * DISTANCE_OPS
             + ang * ANGLE_OPS)
    ops = base["operations"] + extra
    t_ops, t_bytes = ops / single.F32_PEAK_FLOPS, base["bytes"] / single.HBM_BYTES_PER_S
    per_step = max(iterations * n_chains, 1)
    return dict(operations=ops, bytes=base["bytes"], bound_s=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                moved_lanes_per_step=base["moved_lanes_per_step"], guideline_operations=extra,
                clearance_pairs_per_step=moves["pairs"] / per_step,
                rows_per_step=(moves["rel"] + moves["ang"]) / per_step)


def launch(config: dict, traffic: dict, key: int) -> dict | None:
    """The count of one call's single launch of a cell, or None where the
    call is not a single-move, one-draw launch without the off-limits term
    in the loop (compound steps, more accept draws, weighted FIXED)."""
    s = traffic["sampler"]
    track_off = config["mode"] != "parity" and float(config["scene"]["w_offlimits"]) != 0.0
    if s.get("n_moves_per_step", 1) != 1 or s.get("accept_draws", 1) != 1 or track_off:
        return None
    return count(config["scene"], config["mode"] == "parity", n_chains=s["n_chains"],
                 iterations=s["iterations"], seed=key)
