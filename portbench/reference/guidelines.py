"""The fused MH chain's plain version (``portbench/reference/fused.py``)
with the guideline tables evaluated a whole table at once: every distance
row, angle row and clearance of every chain row in one batch of tensor
operations, where ``fused.Objective`` makes a few dozen small operations
per table row. A scene with a clearance on each of its 100 objects and 50
+ 50 relationship rows takes ~7,500 such operations a step there, so a
replay of 1000 steps costs minutes of host dispatch whatever the batch.

Each value is computed with the same expressions on the same inputs, and
the rows are added into their sums one at a time in table order, as
``fused.Objective`` and the kernel add them, so every output has
``fused``'s bits. ``chains`` and ``breakdown`` are ``fused``'s own
functions, run with this module's ``Objective``.
"""

from __future__ import annotations

import types

import torch

from portbench.reference import fused
from portbench.reference.fused import (  # noqa: F401  (pack: for the entry)
    S_CX2, S_CY2, S_DENOM, S_FX, S_FY, S_WCL, S_WFP, S_WOL, S_WPW, S_WSA, S_WSY, S_WVB,
    Packed, block_sum, floor_mod, inter_area, pack)


def _columns_summed(start: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``start`` plus each column of ``cols`` [R, K] in turn, from column 0:
    the table-order sum of the rows."""
    acc = start
    for col in cols.unbind(1):
        acc = acc + col
    return acc


class Objective(fused.Objective):
    """``fused.Objective`` with each guideline table evaluated at once."""

    def __init__(self, pk: Packed):
        super().__init__(pk)
        self.rel_s, self.rel_t = pk.rel_idx[:, 0].long(), pk.rel_idx[:, 1].long()
        self.ang_s, self.ang_t = pk.ang_idx[:, 0].long(), pk.ang_idx[:, 1].long()
        self.clr_s, self.clr_a = pk.clr_idx[:, 0].long(), pk.clr_idx[:, 1].long()

    def __call__(self, x, y, rot, with_off: bool, cells=None):
        """(total [C], the seven weighted terms in the stats-lane order)."""
        sc, pk, pi, mask = self.sc, self.pk, self.pi, self.mask
        zero = torch.zeros_like(x[:, 0])

        s, t = self.rel_s, self.rel_t
        lo, hi, rm = pk.rel_p[:, 0], pk.rel_p[:, 1], pk.rel_p[:, 2]
        d = torch.sqrt(torch.square(x[:, s] - x[:, t]) + torch.square(y[:, s] - y[:, t]))
        lo_safe = torch.where(lo > 0, lo, 1.0)
        d_safe = torch.where(d > 0, d, 1.0)
        pen = torch.where(d < lo, -torch.square(d / lo_safe),
                          torch.where(d > hi, -torch.square(hi / d_safe), 0.0))
        pw = _columns_summed(zero, pen * rm)

        s, t = self.ang_s, self.ang_t
        amin, amax, am = pk.ang_p[:, 0], pk.ang_p[:, 1], pk.ang_p[:, 2]
        th = self.theta(x[:, s], y[:, s], x[:, t], y[:, t], rot[:, t])
        dev = torch.minimum(torch.abs(th - amin), torch.abs(th - amax))
        wrap_case = amin > amax
        norm_wrap = torch.where(wrap_case, (amin - amax) / 2.0, 1.0)
        cond_wrap = floor_mod(amin + th, 2 * pi) > amax
        npl_raw = (2 * pi - (amax - amin)) / 2.0
        npl = torch.where(npl_raw != 0, npl_raw, 1.0)
        if pk.parity:
            cond_plain = (amin < th) | (th < amax)
        else:
            cond_plain = (th < amin) | (th > amax)
        apen = torch.where(wrap_case, torch.where(cond_wrap, -dev / norm_wrap, 0.0),
                           torch.where(cond_plain, -dev / npl, 0.0))
        pwa = _columns_summed(zero, apen * am)
        pair = pw * pwa if pk.parity else pw + pwa

        nx = block_sum(self.area * (x * mask)) / sc[S_DENOM]
        ny = block_sum(self.area * (y * mask)) / sc[S_DENOM]
        vb = -torch.sqrt(torch.square(nx - sc[S_CX2]) + torch.square(ny - sc[S_CY2]))

        dxf = sc[S_FX] - x
        dyf = sc[S_FY] - y
        rf = torch.sqrt(torch.square(dxf) + torch.square(dyf))
        srot = torch.sin(rot)
        cph = (dxf * srot - dyf * torch.cos(rot)) / torch.where(rf > 0, rf, 1.0)
        cph = torch.where(rf > 0, cph, srot)
        fp = block_sum(-cph * mask)

        omnx, omny, omxx, omxy = self.boxes(x, y)
        best = self.sym_best(x, y, rot)
        sym = -block_sum(torch.clamp_min(best, 0.0) * mask)

        off = zero
        if with_off:
            row = torch.zeros_like(x)
            if cells is None:
                contrib = self.off_overlaps(x, y)
                for j in range(x.shape[1]):
                    row = row + contrib[:, :, j]
            else:
                for k in range(cells.shape[1]):
                    row = row + cells[:, k]
            off = -block_sum(row * mask)

        # clearance c's rect at its source against every object [R, C, N],
        # and at its surface anchor against the surface [R, C]
        v0x, tlx, mnx_, mny_, mxx_, mxy_ = pk.clr_p.unbind(1)
        cax, cay = x[:, self.clr_s, None], y[:, self.clr_s, None]
        col = (slice(None), None)
        ar = inter_area(self.aabb_minx(v0x[col], tlx[col], mnx_[col], cax), mny_[col] + cay,
                        mxx_[col] + cax, mxy_[col] + cay, omnx[:, None], omny[:, None],
                        omxx[:, None], omxy[:, None])
        r, c, n = ar.shape
        # a - b is a + (-b) exactly, so subtracting each row is adding its negation
        clr = _columns_summed(zero, -block_sum((ar * mask).reshape(r * c, n)).reshape(r, c))
        pax, pay = x[:, self.clr_a], y[:, self.clr_a]
        sa_acc = _columns_summed(zero, self.outside_area(
            self.aabb_minx(v0x, tlx, mnx_, pax), mny_ + pay, mxx_ + pax, mxy_ + pay))
        sa = -sa_acc + (-block_sum(self.outside_area(omnx, omny, omxx, omxy) * mask))

        pair_w = sc[S_WPW] * pair
        vb_w = sc[S_WVB] * vb
        fp_w = sc[S_WFP] * fp
        sym_w = sc[S_WSY] * sym
        clr_w = sc[S_WCL] * clr
        sa_w = sc[S_WSA] * sa
        total = pair_w + vb_w + fp_w + clr_w + sa_w
        total = total + sym_w
        off_w = sc[S_WOL] * off if with_off else zero
        if with_off and not pk.parity:
            total = total + off_w
        return total, (pair_w, vb_w, fp_w, sym_w, clr_w, off_w, sa_w)


# fused's replay and final report, their global names bound to this module's
# Objective (and chains' final breakdown to this breakdown)
_names = {**vars(fused), "Objective": Objective}
breakdown = types.FunctionType(fused.breakdown.__code__, _names, "breakdown")
_names["breakdown"] = breakdown
chains = types.FunctionType(fused.chains.__code__, _names, "chains")
