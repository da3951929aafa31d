"""Elementwise geometry primitives (counterpart of ``mh_tpu.ops.geometry``).

``Distance`` (``Kernel.cu:162``), ``theta`` (``:170``), ``phi`` (``:185``),
``calculateIntersectionArea`` (``:321``), ``createComplementRectangle``
(``:343``). Every function broadcasts over arbitrary batch shapes.
"""

from __future__ import annotations

import torch

from mh_tpu_torch.config import BIG

Tensor = torch.Tensor


def distance(xi, yi, xj, yj) -> Tensor:
    """Euclidean distance (``Kernel.cu:162-167``)."""
    dx = xi - xj
    dy = yi - yj
    return torch.sqrt(dx * dx + dy * dy)


def theta(xi, yi, xj, yj, ti, pi: float) -> Tensor:
    """Bearing of i seen from j, re-oriented by ``ti``, in [0, 2*pi)
    (``Kernel.cu:170-182``); ``pi`` is the mode's PI constant."""
    t = torch.atan2(yi - yj, xi - xj)
    t = torch.where(t < 0, 2 * pi + t, t)
    t = t - ti
    return torch.where(t < 0, 2 * pi + t, t)


def phi(xi, yi, xj, yj, tj, pi: float) -> Tensor:
    """Facing angle of object j toward point i (``Kernel.cu:185-188``)."""
    return torch.atan2(yi - yj, xi - xj) - tj + pi / 2.0


def intersection_area(a_min_x, a_min_y, a_max_x, a_max_y,
                      b_min_x, b_min_y, b_max_x, b_max_y) -> Tensor:
    """Overlap area of two AABBs; 0 when degenerate (``Kernel.cu:321-340``).

    Touching edges count as no intersection, like the reference's strict check.
    """
    x5 = torch.maximum(a_min_x, b_min_x)
    y5 = torch.maximum(a_min_y, b_min_y)
    x6 = torch.minimum(a_max_x, b_max_x)
    y6 = torch.minimum(a_max_y, b_max_y)
    empty = (x5 >= x6) | (y5 >= y6)
    return torch.where(empty, 0.0, (x6 - x5) * (y6 - y5))


def outside_surface_area(r_min_x, r_min_y, r_max_x, r_max_y,
                         s_min_x, s_min_y, s_max_x, s_max_y) -> Tensor:
    """Area of an AABB outside the surface rectangle.

    The reference's decomposition of the surface's complement into four
    half-plane rects with DBL_MAX extents (``Kernel.cu:343-364``), summed
    as four intersection areas (``Kernel.cu:463-466``).
    """
    big = torch.full_like(s_min_x, BIG)
    a1 = intersection_area(r_min_x, r_min_y, r_max_x, r_max_y, -big, -big, big, s_min_y)
    a2 = intersection_area(r_min_x, r_min_y, r_max_x, r_max_y, -big, s_min_y, s_min_x, s_max_y)
    a3 = intersection_area(r_min_x, r_min_y, r_max_x, r_max_y, -big, s_max_y, big, big)
    a4 = intersection_area(r_min_x, r_min_y, r_max_x, r_max_y, s_max_x, s_min_y, big, s_max_y)
    return a1 + a2 + a3 + a4


def wrap_angle_once(a: Tensor, pi: float) -> Tensor:
    """Single conditional wrap into [0, 2*pi] (``Kernel.cu:648-651``)."""
    a = torch.where(a < 0, a + 2 * pi, a)
    return torch.where(a > 2 * pi, a - 2 * pi, a)
