"""Proposal moves: translate / rotate / swap (counterpart of ``mh_tpu.sampler.proposal``).

One move is driven by 8 uniforms (``Kernel.cu:576-704``): u[0] the move
type, u[1] left for the caller's accept draw, u[2:6] Box-Muller inputs for
(dx, dy, dRot), u[6:8] the two object picks. An object pick is the rank
pick of ``mh_tpu``: ``target = min(floor(u * n_unfrozen), n_unfrozen - 1)
+ 1``, the 1-based rank among the movable objects. ``mh_tpu`` applies the
move as one-hot arithmetic over all N objects; here the picked object is
found with ``searchsorted`` on the cumulative rank and its row is loaded
and stored by index, which is exact, touches two rows instead of N, and
needs no matrix product (a float32 product may run in TF32 on the card).
The touched rows are computed with ``mh_tpu``'s own expressions
(``x + (clip(x + dx) - x)``, ``v1 + (v2 - v1)``, ...), so they round alike.

Every function is batched over the leading dims of the pose and reads
nothing back to the host.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from mh_tpu_torch.config import SamplerConfig
from mh_tpu_torch.models.scene import Scene
from mh_tpu_torch.ops.geometry import wrap_angle_once
from mh_tpu_torch.sampler import prng

Tensor = torch.Tensor

UNIFORMS_PER_MOVE = 8
_EPS = prng.f32(1e-7)
_TWO_PI = prng.f32(2.0 * math.pi)


def uniforms_per_move() -> int:
    """Length of the uniform plane one move consumes."""
    return UNIFORMS_PER_MOVE


def translation_sigmas(scene: Scene, cfg: SamplerConfig) -> tuple[Tensor, Tensor]:
    """Per-axis proposal std = surface extent / 16 (``Kernel.cu:587-591``)."""
    mnx, mny, mxx, mxy = scene.surface_bounds()
    if cfg.sigma_xy_override > 0:
        s = torch.full((), cfg.sigma_xy_override, dtype=torch.float32, device=scene.device)
        return s, s
    return (mxx - mnx) / 16.0, (mxy - mny) / 16.0


@dataclasses.dataclass(frozen=True)
class MoveTables:
    """The scene-static inputs of a move, computed once per (scene, config)."""

    rank: Tensor  # f32[N] — cumulative count of movable objects
    n_unf: Tensor  # f32[] — movable objects
    has_unf: Tensor  # bool[]
    can_swap: Tensor  # bool[] — the scene has >= 2 objects (Kernel.cu:657)
    bounds: tuple[Tensor, Tensor, Tensor, Tensor]  # surface (mnx, mny, mxx, mxy)
    sigmas: tuple[Tensor, Tensor]  # translation std (x, y)
    sigma_t: float  # rotation std, rounded to float32
    pi: float  # the mode's PI

    @classmethod
    def build(cls, scene: Scene, cfg: SamplerConfig) -> "MoveTables":
        ok = scene.obj_mask * (1.0 - scene.frozen.to(torch.float32))
        rank = torch.cumsum(ok, 0)
        n_unf = rank[-1]
        return cls(
            rank=rank,
            n_unf=n_unf,
            has_unf=n_unf > 0,
            can_swap=scene.n_objs >= 2,
            bounds=scene.surface_bounds(),
            sigmas=translation_sigmas(scene, cfg),
            sigma_t=prng.f32(cfg.sigma_t),
            pi=cfg.mode.pi,
        )


def decode_moves(u: Tensor, tables: MoveTables, scale) -> tuple[Tensor, ...]:
    """The random quantities of every move of ``u`` f32[..., M, 8] at once.

    Returns (move i32, dx, dy, drot, i1, i2), each ``[..., M]``; ``i1``/``i2``
    are the picked objects' rows (int64). ``scale`` broadcasts over ``[...]``.
    """
    move = torch.clamp_max((u[..., 0] * 3.0).to(torch.int32), 2)
    r1 = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u[..., 2], _EPS)))
    r2 = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u[..., 4], _EPS)))
    n0 = r1 * torch.cos(_TWO_PI * u[..., 3])
    n1 = r1 * torch.sin(_TWO_PI * u[..., 3])
    n2 = r2 * torch.cos(_TWO_PI * u[..., 5])
    scale = torch.as_tensor(scale, dtype=torch.float32, device=u.device)[..., None]
    sx, sy = tables.sigmas
    dx = n0 * sx * scale
    dy = n1 * sy * scale
    drot = n2 * tables.sigma_t * scale
    n_unf = tables.n_unf

    def pick(v):
        target = torch.minimum(torch.floor(v * n_unf), n_unf - 1.0) + 1.0
        return torch.searchsorted(tables.rank, target.contiguous())

    return move, dx, dy, drot, pick(u[..., 6]), pick(u[..., 7])


def apply_move(pose: Tensor, tables: MoveTables, move, dx, dy, drot, i1, i2) -> Tensor:
    """One decoded move on ``pose`` f32[B, N, 6]; the move fields are ``[B]``.

    Row ``i1`` gets the translate or rotate; a swap exchanges the full
    rows ``i1`` and ``i2`` (a no-op when they coincide or the scene has
    fewer than 2 objects). Without a movable object nothing changes.
    """
    mnx, mny, mxx, mxy = tables.bounds
    idx1 = i1[:, None, None].expand(-1, 1, 6)
    idx2 = i2[:, None, None].expand(-1, 1, 6)
    p1 = torch.gather(pose, 1, idx1)[:, 0]  # [B, 6]
    p2 = torch.gather(pose, 1, idx2)[:, 0]
    is_t = (move == 0).to(torch.float32)
    is_r = (move == 1).to(torch.float32)
    is_s = (move == 2) & tables.can_swap

    x, y, rot = p1[:, 0], p1[:, 1], p1[:, 4]
    new_x = x + is_t * (torch.clamp(x + dx, mnx, mxx) - x)
    new_y = y + is_t * (torch.clamp(y + dy, mny, mxy) - y)
    new_rot = rot + is_r * (wrap_angle_once(rot + drot, tables.pi) - rot)
    moved = torch.stack([new_x, new_y, p1[:, 2], p1[:, 3], new_rot, p1[:, 5]], 1)

    diff = p2 - p1
    keep = ~is_s[:, None]
    row1 = torch.where(keep, moved, p1 + diff)
    row2 = torch.where(keep, p2, p2 - diff)
    row1 = torch.where(tables.has_unf, row1, p1)  # nothing movable: i1 == i2 == 0
    out = pose.scatter(1, idx2, row2[:, None])
    return out.scatter(1, idx1, row1[:, None])  # i1 == i2 keeps row 1


def block_apply(u: Tensor, pose: Tensor, tables: MoveTables, scale) -> Tensor:
    """M sequential moves from ``u`` f32[..., M, 8] on ``pose`` f32[..., N, 6]."""
    lead = pose.shape[:-2]
    decoded = decode_moves(u, tables, scale)
    b = math.prod(lead)
    flat = pose.reshape(b, *pose.shape[-2:])
    fields = [t.expand(*lead, u.shape[-2]).reshape(b, -1) for t in decoded]
    for m in range(u.shape[-2]):
        flat = apply_move(flat, tables, *(t[:, m] for t in fields))
    return flat.reshape(pose.shape)


def propose_from_uniforms(
    u: Tensor, pose: Tensor, scene: Scene, cfg: SamplerConfig, scale
) -> Tensor:
    """One move driven by a pre-drawn uniform plane ``u`` f32[..., 8]."""
    return block_apply(u[..., None, :], pose, MoveTables.build(scene, cfg), scale)


def propose(key: Tensor, pose: Tensor, scene: Scene, cfg: SamplerConfig, scale) -> Tensor:
    """One single-object move, type uniform over {0,1,2} (``Kernel.cu:582``)."""
    return propose_from_uniforms(prng.uniform(key, (UNIFORMS_PER_MOVE,)), pose, scene, cfg,
                                 scale)


def block_propose_from_uniforms(
    u: Tensor, pose: Tensor, scene: Scene, cfg: SamplerConfig, scale
) -> Tensor:
    """M sequential single-object moves from a pre-drawn ``u`` f32[..., M, 8]:
    one compound proposal (``Kernel.cu:798``, without the races)."""
    return block_apply(u, pose, MoveTables.build(scene, cfg), scale)


def block_propose(key: Tensor, pose: Tensor, scene: Scene, cfg: SamplerConfig,
                  scale) -> Tensor:
    """``block_propose_from_uniforms`` drawing its own uniform sweep."""
    u = prng.uniform(key, (cfg.n_moves_per_step, UNIFORMS_PER_MOVE))
    return block_propose_from_uniforms(u, pose, scene, cfg, scale)
