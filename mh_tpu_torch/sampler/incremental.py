"""Incremental-cost MH: exact delta evaluation of the O(N^2) symmetry term
(counterpart of ``mh_tpu.sampler.incremental``).

A single-object move touches one row and one column of the symmetry val
matrix (``Kernel.cu:283-318``), so each chain carries the matrix and its
per-row *group maxima* and recomputes only what the move changed:

- state: ``A f32[C, N, N]`` (val matrix of the current pose), ``gmax
  f32[C, N, G]`` (per-row max over G column groups of width N/G);
- per move (<= 2 objects): recompute rows {k1, k2} and columns {k1, k2} of
  A (O(N) each), re-reduce the <= 2 touched column slabs (O(N * N/G)) and
  the <= 2 touched gmax rows, then ``rowbest_i = max_g gmax[i, g]``.

Every stored entry is recomputed from the candidate pose when it is
written, never accumulated, and every element of A goes through one
expression (:func:`_val`) that rounds alike whatever the shape it is
evaluated in, so the carried state equals a fresh evaluation of the pose
bit for bit. The cheap terms (pairwise, visual, focal, clearance, surface;
O(N) or smaller) are recomputed in full each step. PARITY only (OffLimits
never enters its total), one move a step.

The chains are the leading dim of every state tensor and the steps a
Python loop, as in :mod:`mh_tpu_torch.sampler.mh`. The random stream is
``mh_tpu``'s: chain ``c`` is keyed by ``fold_in(key, c)``; step ``t`` splits
``fold_in(chain_key, t)`` into the move's key (8 uniforms) and the accept
key (``boltzmann_accept``).
"""

from __future__ import annotations

import dataclasses

import torch

from mh_tpu_torch.config import CostMode, SamplerConfig
from mh_tpu_torch.models.scene import Scene
from mh_tpu_torch.ops import costs as C
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.mh import boltzmann_accept, chain_starts
from mh_tpu_torch.sampler.proposal import (
    UNIFORMS_PER_MOVE, MoveTables, apply_move, decode_moves, move_weights,
)

Tensor = torch.Tensor

_NEG_HUGE = -1e30


# --- symmetry val-matrix pieces --------------------------------------------


def _refl(pose: Tensor, scene: Scene, pi: float):
    """Per-object reflection across the symmetry axis (``Kernel.cu:290-299``)."""
    x, y, rot = pose[..., 0], pose[..., 1], pose[..., 4]
    ux = torch.cos(scene.focal_rot)
    uy = torch.sin(scene.focal_rot)
    s = 2.0 * (scene.focal[0] * ux + scene.focal[1] * uy - (x * ux + y * uy))
    rx = x + s * ux
    ry = y + s * uy
    rrot = 2.0 * scene.focal_rot - rot
    rrot = torch.where(rrot < -pi, rrot + 2 * pi, rrot)
    return rx, ry, rrot


def _val(rx_i, ry_i, rrot_i, xj, yj, rotj, maskj, pi):
    """val[i,j] = 5 - sqrt(dist(pos_j, refl_i)) - 0.4|wrap(rot_j - rrot_i)|.

    The square roots are ``prng._sqrt``'s, correctly rounded: PyTorch's
    vectorised CPU ``torch.sqrt`` rounds an element by where it falls in
    the tensor, so a row of N values and the N x N matrix would part."""
    dp = prng._sqrt(torch.square(xj - rx_i) + torch.square(yj - ry_i))
    dt = rotj - rrot_i
    dt = torch.where(dt > pi, dt - 2 * pi, dt)
    v = 5.0 - prng._sqrt(dp) - 0.4 * torch.abs(dt)
    return torch.where(maskj > 0, v, _NEG_HUGE)


def full_val_matrix(pose: Tensor, scene: Scene, pi: float) -> Tensor:
    """f32[..., N, N]: row i is object i's reflection against every object j."""
    rx, ry, rrot = _refl(pose, scene, pi)
    return _val(rx[..., :, None], ry[..., :, None], rrot[..., :, None],
                pose[..., None, :, 0], pose[..., None, :, 1], pose[..., None, :, 4],
                scene.obj_mask, pi)


def _group_max(a: Tensor, n_groups: int) -> Tensor:
    n = a.shape[-1]
    return torch.amax(a.reshape(*a.shape[:-1], n_groups, n // n_groups), -1)


def _sym_from_gmax(gmax: Tensor, scene: Scene) -> Tensor:
    best = torch.clamp_min(torch.amax(gmax, -1), 0.0)
    return -torch.sum(best * scene.obj_mask, -1)


# --- incremental chain state -----------------------------------------------


@dataclasses.dataclass(frozen=True)
class IncState:
    """Chain state, batched over the leading dim (chains)."""

    pose: Tensor  # f32[C, N, 6]
    a_mat: Tensor  # f32[C, N, N] symmetry val matrix of the current pose
    gmax: Tensor  # f32[C, N, G]
    total: Tensor  # f32[C] current accept total (parity)
    key: Tensor  # i64[C, 2] — the chain's threefry key words
    step: Tensor  # i32[C]
    n_accept: Tensor  # i32[C]


def _cheap_total(pose: Tensor, scene: Scene, mode: CostMode, sym_raw: Tensor) -> Tensor:
    """Total (parity) from the cheap terms + a given raw symmetry value."""
    pw = C.pair_wise_costs(pose, scene)
    pwa = C.pair_wise_angle_costs(pose, scene, mode)
    pair = scene.w_pairwise * (pw * pwa)
    vb = scene.w_visual_balance * C.visual_balance_costs(pose, scene)
    fp = scene.w_focal * C.focal_point_costs(pose, scene, mode)
    clr = scene.w_clearance * C.clearance_costs(pose, scene, mode)
    sa = scene.w_surface_area * C.surface_area_costs(pose, scene, mode)
    return pair + vb + fp + scene.w_symmetry * sym_raw + clr + sa


def inc_init(pose: Tensor, scene: Scene, key: Tensor, n_groups: int) -> IncState:
    """The state of the chains of ``pose`` f32[C, N, 6] keyed by ``key`` i64[C, 2]."""
    pi = CostMode.PARITY.pi
    a = full_val_matrix(pose, scene, pi)
    gmax = _group_max(a, n_groups)
    total = _cheap_total(pose, scene, CostMode.PARITY, _sym_from_gmax(gmax, scene))
    zero = torch.zeros(pose.shape[:-2], dtype=torch.int32, device=pose.device)
    return IncState(pose=pose, a_mat=a, gmax=gmax, total=total, key=key, step=zero,
                    n_accept=zero)


def _propose_with_info(u: Tensor, pose: Tensor, scene: Scene, cfg: SamplerConfig):
    """One move per chain from ``u`` f32[C, 8], with no step scale, and the
    rows ``(k1, k2)`` it touches (``k2 == k1`` unless the move is a swap)."""
    tables = MoveTables.build(scene, cfg)
    move, dx, dy, drot, i1, i2 = (t[:, 0] for t in decode_moves(u[:, None], tables, 1.0))
    star = apply_move(pose, tables, dx, dy, drot, i1, i2, move_weights(move, i1, i2, tables))
    return star, i1, torch.where(move == 2, i2, i1)


def inc_step(state: IncState, scene: Scene, cfg: SamplerConfig, n_groups: int) -> IncState:
    """One step of every chain: propose, delta-update the symmetry state
    for the candidate, accept on the total."""
    pi = CostMode.PARITY.pi
    c, n = state.pose.shape[:2]
    w = n // n_groups
    keys = prng.split(prng.fold_in(state.key, state.step))
    u = prng.uniform(keys[:, 0], (UNIFORMS_PER_MOVE,))
    star, k1, k2 = _propose_with_info(u, state.pose, scene, cfg)
    ks = torch.stack([k1, k2], 1)  # [C, 2]

    # --- delta-update the symmetry matrix for the candidate ---------------
    rx, ry, rrot = _refl(star, scene, pi)
    xj, yj, rotj = star[..., 0], star[..., 1], star[..., 4]
    mask = scene.obj_mask
    # rows k of A (reflection k against every object) and columns k (every
    # reflection against object k), [C, 2, N] each
    rxk, ryk, rrotk, xk, yk, rotk = (torch.gather(t, 1, ks)[..., None]
                                    for t in (rx, ry, rrot, xj, yj, rotj))
    rows = _val(rxk, ryk, rrotk, xj[:, None], yj[:, None], rotj[:, None], mask, pi)
    cols = _val(rx[:, None], ry[:, None], rrot[:, None], xk, yk, rotk, mask[ks][..., None], pi)
    a = state.a_mat.clone()
    a.scatter_(2, ks[:, None, :].expand(c, n, 2), cols.transpose(1, 2))
    a.scatter_(1, ks[..., None].expand(c, 2, n), rows)  # the corners: row formula wins

    # group maxima: re-reduce the two touched column slabs + two touched rows
    g = torch.div(ks, w, rounding_mode="floor")  # [C, 2]
    slab_cols = (g[..., None] * w + torch.arange(w, device=g.device)).reshape(c, 1, 2 * w)
    slab_max = torch.amax(torch.gather(a, 2, slab_cols.expand(c, n, 2 * w))
                          .reshape(c, n, 2, w), -1)
    gmax = state.gmax.clone()
    gmax.scatter_(2, g[:, None, :].expand(c, n, 2), slab_max)
    gmax.scatter_(1, ks[..., None].expand(c, 2, n_groups), _group_max(rows, n_groups))

    total_star = _cheap_total(star, scene, cfg.mode, _sym_from_gmax(gmax, scene))
    acc = boltzmann_accept(keys[:, 1], total_star, state.total, cfg.beta)

    def commit(new, old):
        return torch.where(acc.reshape(-1, *(1,) * (new.ndim - 1)), new, old)

    return IncState(
        pose=commit(star, state.pose),
        a_mat=commit(a, state.a_mat),
        gmax=commit(gmax, state.gmax),
        total=commit(total_star, state.total),
        key=state.key,
        step=state.step + 1,
        n_accept=state.n_accept + acc.to(torch.int32),
    )


def run_chains_incremental(key: Tensor, pose0: Tensor, scene: Scene, cfg: SamplerConfig,
                           n_groups: int = 8, trace_costs: bool = False):
    """Incremental-symmetry chains (PARITY mode, single-move steps) on the
    scene's device.

    ``pose0`` is f32[N, 6] (every chain starts there) or f32[n_chains, N,
    6]. Returns ``(IncState batch, cost trace f32[n_chains, iterations] |
    None)``. Statistically equivalent to
    :func:`mh_tpu_torch.sampler.mh.run_chains` (same proposal and accept
    distributions; same threefry stream layout).
    """
    if cfg.mode is not CostMode.PARITY:
        raise ValueError("incremental path implements PARITY mode only")
    if cfg.n_moves_per_step != 1:
        raise ValueError("incremental path is single-move per step")
    if scene.n_pad_objs % n_groups:
        raise ValueError("padded object count must be divisible by n_groups")
    pose, keys = chain_starts(key, pose0, scene, cfg.n_chains)
    state = inc_init(pose, scene, keys, n_groups)
    trace = []
    for _ in range(cfg.iterations):
        state = inc_step(state, scene, cfg, n_groups)
        if trace_costs:
            trace.append(state.total)
    if not trace_costs:
        return state, None
    return state, torch.stack(trace, 1) if trace else state.total.new_zeros((cfg.n_chains, 0))
