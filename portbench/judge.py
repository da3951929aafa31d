"""The comparison that decides a run's ``correct``.

The judge holds what the program returned against what the reference
works out for the same keys: every chain (or replica) of every call it
checks must follow the reference's trajectory, and every returned
breakdown must be the reference objective's at the returned pose. Two
numbers, each held to its limit in the traffic file:

- ``chains_apart_pct``: the share of checked chains, in %, whose final
  pose or breakdown leaves the reference's by more than ``ATOL + RTOL *
  |reference|`` anywhere, or whose accept count differs (a chain that
  parts once takes another path from then on);
- ``cost_gap``: the widest gap between a returned breakdown term and the
  reference objective at the returned pose, over ``max(|reference|, 1)``.
"""

from __future__ import annotations

import numpy as np

ATOL = RTOL = 1e-4
NOT_FINITE = 1e30  # a gap that is NaN or infinite reads as this


def _far(got, want) -> np.ndarray:
    """Rows of ``got`` that leave ``want`` anywhere (NaN counts as far)."""
    close = np.abs(got - want) <= ATOL + RTOL * np.abs(want)
    return ~close.reshape(len(want), -1).all(1)


def numbers(program: list[dict], expected: list[dict], objective: list) -> tuple[dict, int]:
    """``({number: value}, rows checked)`` of the program's records against
    the reference's for the same calls."""
    apart, rows, gap = 0, 0, 0.0
    for got, want, obj in zip(program, expected, objective):
        rows += len(want["pose"])
        if got["pose"].shape != want["pose"].shape or got["costs"].shape != want["costs"].shape:
            apart += len(want["pose"])
        else:
            far = (_far(got["pose"], want["pose"]) | _far(got["costs"], want["costs"])
                   | (got["accepts"] != want["accepts"]))
            apart += int(far.sum())
        g = np.abs(got["costs"].astype(np.float64) - obj) / np.maximum(np.abs(obj), 1.0)
        g = np.where(np.isfinite(g), g, NOT_FINITE)
        gap = max(gap, float(g.max()) if g.size else NOT_FINITE)
    pct = 100.0 * apart / rows if rows else 100.0
    return {"chains_apart_pct": pct, "cost_gap": gap}, rows


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(every number within its limit, {number: {value, limit}})``."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
