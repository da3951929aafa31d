"""Proposal moves: translate / rotate / swap (counterpart of ``mh_tpu.sampler.proposal``).

One move is driven by 8 uniforms (``Kernel.cu:576-704``): u[0] the move
type, u[1] left for the caller's accept draw, u[2:6] Box-Muller inputs for
(dx, dy, dRot), u[6:8] the two object picks. An object pick is the rank
pick of ``mh_tpu``: ``target = min(floor(u * n_unfrozen), n_unfrozen - 1)
+ 1``, the 1-based rank among the movable objects. ``mh_tpu`` applies the
move as one-hot arithmetic over all N objects; here the picked object is
found with ``searchsorted`` on the cumulative rank and its row is loaded
and stored by index, which is exact and needs no matrix product (a
float32 product may run in TF32 on the card). The touched rows are
computed with ``mh_tpu``'s own expressions (``x + (clip(x + dx) - x)``,
``v1 + (v2 - v1)``, ...), so they round alike; every other row gets the
signed zero those expressions add to it, so zero signs match too.

Every function of the chain engine is batched over the leading dims of the
pose and reads nothing back to the host. The single-move wrappers at the
end (``pick_unfrozen``, ``translate_move``, ``rotate_move``, ``swap_move``)
take one key and one pose f32[N, 6], as ``mh_tpu``'s do, for tests and
diagnostics.
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
    neg_zero_row: Tensor  # f32[1, 1, 6] of -0.0: any row a move does not pick

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
            neg_zero_row=torch.full((1, 1, 6), -0.0, device=scene.device),
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


def move_weights(move: Tensor, i1: Tensor, i2: Tensor, tables: MoveTables) -> Tensor:
    """``mh_tpu``'s one-hot weights of the moves ``move``/``i1``/``i2`` [...]:
    f32[..., 3, 3], the translate, rotate and swap weight (``is_t * sel1``,
    ``is_r * sel1``, ``can_swap * (sel1 - sel2)``) of row ``i1``, row ``i2``
    and any other row. Every weight is +-0 or +-1, as ``mh_tpu``'s are."""
    same = (i1 == i2).to(torch.float32)
    one, zero = torch.ones_like(same), torch.zeros_like(same)
    sel1 = torch.stack([one, same, zero], -1)
    sel2 = torch.stack([same, one, zero], -1)
    is_t = (move == 0).to(torch.float32)[..., None]
    is_r = (move == 1).to(torch.float32)[..., None]
    can_swap = ((move == 2) & tables.can_swap).to(torch.float32)[..., None]
    return torch.stack([is_t * sel1, is_r * sel1, can_swap * (sel1 - sel2)], -2)


def apply_move(pose: Tensor, tables: MoveTables, dx, dy, drot, i1, i2, weights) -> Tensor:
    """One decoded move on ``pose`` f32[B, N, 6]; the move fields are ``[B]``,
    ``weights`` f32[B, 3, 3] from :func:`move_weights`.

    Row ``i1`` gets the translate or rotate; a swap exchanges the full
    rows ``i1`` and ``i2`` (a no-op when they coincide or the scene has
    fewer than 2 objects). Without a movable object nothing changes.

    ``mh_tpu`` writes every row through its plane expressions (``x + w *
    (clip(x + dx) - x)``, ``rot + w * (wrap - rot)``, ``pose + can_swap *
    (sel1 - sel2) * (row2 - row1)``), which add a signed zero to each row
    the move does not touch: a -0.0 there turns +0.0 unless every added
    zero is -0.0. Those expressions are evaluated here on the two picked
    rows and on one row of -0.0; the latter's result (+-0) is then added to
    the whole pose, which changes nothing but those zero signs.
    """
    mnx, mny, mxx, mxy = tables.bounds
    b = pose.shape[0]
    idx = torch.stack([i1, i2], 1)[:, :, None].expand(-1, 2, 6)
    rows = torch.cat([torch.gather(pose, 1, idx), tables.neg_zero_row.expand(b, 1, 6)], 1)
    w_t, w_r, w_s = weights.unbind(-2)  # [B, 3] each: row i1, row i2, another row

    x, y, rot = rows[..., 0], rows[..., 1], rows[..., 4]
    new_x = x + w_t * (torch.clamp(x + dx[:, None], mnx, mxx) - x)
    new_y = y + w_t * (torch.clamp(y + dy[:, None], mny, mxy) - y)
    new_rot = rot + w_r * (wrap_angle_once(rot + drot[:, None], tables.pi) - rot)
    star = torch.stack([new_x, new_y, rows[..., 2], rows[..., 3], new_rot, rows[..., 5]], -1)

    # mh_tpu gathers the rows as a one-hot product, whose sum starts at +0.0
    picked = star[:, :2] + 0.0
    out = star + w_s[..., None] * (picked[:, 1] - picked[:, 0])[:, None]
    out = torch.where(tables.has_unf, out, rows)  # nothing movable: i1 == i2 == 0
    new = pose + out[:, 2:]
    return new.scatter_(1, idx, out[:, :2])  # i1 == i2: both rows are the same values


def block_apply(u: Tensor, pose: Tensor, tables: MoveTables, scale) -> Tensor:
    """M sequential moves from ``u`` f32[..., M, 8] on ``pose`` f32[..., N, 6]."""
    lead = pose.shape[:-2]
    b = math.prod(lead)
    flat = pose.reshape(b, *pose.shape[-2:])
    move, *fields = (t.expand(*lead, u.shape[-2]).reshape(b, -1)
                     for t in decode_moves(u, tables, scale))
    weights = move_weights(move, fields[3], fields[4], tables)
    for m in range(u.shape[-2]):
        flat = apply_move(flat, tables, *(t[:, m] for t in fields), weights[:, m])
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


# --- single-move reference-shaped wrappers (used by tests/diagnostics) ------

_NEG_HUGE = -1e30


def pick_unfrozen(key: Tensor, scene: Scene) -> Tensor:
    """Uniform index over valid & unfrozen objects via Gumbel-argmax (the
    first maximum; object 0 where no object is movable)."""
    ok = scene.obj_mask * (1.0 - scene.frozen.to(torch.float32))
    logits = torch.where(ok > 0, 0.0, _NEG_HUGE)
    return torch.argmax(prng.gumbel(key, (scene.n_pad_objs,)) + logits, -1)


def _single_move(pose: Tensor, scene: Scene, cfg: SamplerConfig, scale, move: int, i1, i2,
                 nrm: Tensor) -> Tensor:
    """One move of type ``move`` on rows ``i1``/``i2`` of ``pose`` f32[N, 6]
    from the normals ``nrm`` f32[3], applied as ``mh_tpu``'s wrappers apply
    it: to the picked rows whether or not they are movable."""
    tables = dataclasses.replace(MoveTables.build(scene, cfg),
                                 has_unf=torch.ones((), dtype=torch.bool, device=pose.device))
    scale = torch.as_tensor(scale, dtype=torch.float32, device=pose.device)
    sx, sy = tables.sigmas
    dx, dy, drot = nrm[0] * sx * scale, nrm[1] * sy * scale, nrm[2] * tables.sigma_t * scale
    one = torch.full((1,), move, dtype=torch.int32, device=pose.device)
    i1, i2 = (torch.as_tensor(i, device=pose.device).reshape(1) for i in (i1, i2))
    return apply_move(pose[None], tables, dx.reshape(1), dy.reshape(1), drot.reshape(1), i1, i2,
                      move_weights(one, i1, i2, tables))[0]


def translate_move(key: Tensor, pose: Tensor, scene: Scene, cfg: SamplerConfig,
                   scale) -> Tensor:
    k_obj, k_nrm = prng.split(key)
    i = pick_unfrozen(k_obj, scene)
    return _single_move(pose, scene, cfg, scale, 0, i, i, prng.normal(k_nrm, (3,)))


def rotate_move(key: Tensor, pose: Tensor, scene: Scene, cfg: SamplerConfig,
                scale) -> Tensor:
    k_obj, k_nrm = prng.split(key)
    i = pick_unfrozen(k_obj, scene)
    return _single_move(pose, scene, cfg, scale, 1, i, i, prng.normal(k_nrm, (3,)))


def swap_move(key: Tensor, pose: Tensor, scene: Scene) -> Tensor:
    k1, k2 = prng.split(key)
    return _single_move(pose, scene, SamplerConfig(), 1.0, 2, pick_unfrozen(k1, scene),
                        pick_unfrozen(k2, scene), torch.zeros(3, device=pose.device))
