"""Annealed Sequential Monte Carlo over a device mesh (counterpart of ``mh_tpu.sampler.smc``).

Particles anneal from beta=0 to the target beta: each stage reweights by
``exp(dbeta * S)``, renormalises (folding the normaliser into the
log-evidence), resamples systematically when the effective sample size
drops below ``ess_threshold * n_particles``, and mutates with MH steps at
the new temperature.

As in ``mh_tpu`` the particles are split over the mesh's chains axis (each
process steps its own shards of a mesh that spans processes): the
weights' maximum and sums go through
:func:`~mh_tpu_torch.parallel.mesh.pmax` / :func:`~mh_tpu_torch.parallel.mesh.psum`,
and a resample gathers every shard's poses, cost vectors and log-weights
(:func:`~mh_tpu_torch.parallel.mesh.all_gather`) and gives each shard its
slice of the global systematic indices. ``mh_tpu``'s ``lax.cond`` on the
resample decision becomes a selection (``torch.where``) between the
resampled and the kept ensemble, so no stage reads a value back to the
host. Every shard draws the global resample indices from the gathered
weights, as in ``mh_tpu``; the scalar state (schedule, evidence) is kept
once, on the first shard's device. Keys follow ``mh_tpu``: particle ``i``
is ``fold_in(key, i)`` by global id, the stage-``t`` resample key
``fold_in(fold_in(key, 0x5C), t)``, the prior draws
``split(fold_in(fold_in(key, 0x9A1), i), 3)``. ``mesh=None`` is one shard
on the scene's device.
"""

from __future__ import annotations

import numpy as np
import torch

from mh_tpu_torch.config import SamplerConfig
from mh_tpu_torch.models.scene import Scene
from mh_tpu_torch.parallel.mesh import Mesh, all_gather, chain_shards, local_count, pmax, psum
from mh_tpu_torch.parallel.sharded import advance, concat, concat_states, shard_steps
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.mh import chain_starts
from mh_tpu_torch.sampler.tempering import with_rows

Tensor = torch.Tensor


def _schedule(beta: float, n_stages: int, device) -> Tensor:
    """``jnp.linspace(0, beta, n_stages + 1)`` as XLA computes it in float32:
    ``start * (1 - s) + stop * s`` with ``s = i * (1 / n_stages)``, the last
    entry exactly ``stop``."""
    stop = np.float32(beta)
    s = np.arange(n_stages, dtype=np.float32) * np.float32(prng.reciprocal(n_stages))
    out = np.float32(0.0) * (np.float32(1.0) - s) + stop * s
    return torch.as_tensor(np.append(out, stop).astype(np.float32), device=device)


def systematic_resample_indices(key: Tensor, log_w: Tensor, n: int) -> Tensor:
    """Systematic resampling: n indices (int64) from normalised log-weights.

    An index past the end (a point above the float32 CDF's last entry) is
    clamped to the last particle, as JAX clamps an out-of-range gather.
    """
    cdf = torch.cumsum(torch.softmax(log_w, 0), 0)
    u0 = prng.uniform(key, (), 0.0, 1.0 / n)
    steps = torch.arange(n, dtype=torch.float32, device=log_w.device) * prng.reciprocal(n)
    idx = torch.searchsorted(cdf, u0 + steps, side="left")
    return torch.clamp_max(idx, n - 1)


def _prior_starts(key, p0, scene, cfg, gids):
    """x, y uniform over the surface and rotY over [0, 2 pi) for the
    movable objects of particles ``gids``, keyed by global id."""
    mnx, mny, mxx, mxy = scene.surface_bounds()
    movable = scene.obj_mask * (1.0 - scene.frozen.to(torch.float32))
    sub = prng.split(prng.fold_in(prng.fold_in(key.to(scene.device), 0x9A1), gids), 3)
    n_objs = p0.shape[1]
    draws = (prng.uniform(sub[:, 0], (n_objs,), mnx, mxx),
             prng.uniform(sub[:, 1], (n_objs,), mny, mxy),
             prng.uniform(sub[:, 2], (n_objs,), 0.0, 2.0 * cfg.mode.pi))
    p0 = p0.clone()
    for col, d in zip((0, 1, 4), draws):
        p0[:, :, col] = p0[:, :, col] + movable * (d - p0[:, :, col])
    return p0


def run_smc(
    key: Tensor,
    pose0: Tensor,
    scene: Scene,
    cfg: SamplerConfig,
    mesh: Mesh | None = None,
    n_particles: int = 64,
    n_stages: int = 10,
    mutate_steps: int = 5,
    ess_threshold: float = 0.5,
    adaptive: bool = False,
    target_ess: float = 0.5,
    init: str = "pose0",
):
    """Annealed SMC from beta=0 to ``cfg.beta`` over ``mesh``.

    Returns ``(states [n_particles, ...], diagnostics)``: a dict of per-stage
    ``ess`` (f32[n_stages]), ``resampled`` (bool[n_stages]) and ``betas``
    (f32[n_stages], the post-stage inverse temperature), the final
    ``log_weights`` and the ``log_evidence`` estimate, on this process's
    first shard's device (``states`` and ``log_weights`` this process's
    particles). Poses are bitwise the same on any number of shards; the
    sums in shard order move ESS and evidence by float rounding only, and
    not at all between processes on the same shards.

    ``adaptive``: each increment is bisected (26 halvings) so the
    post-increment ESS lands at ``target_ess * n_particles``; ``n_stages``
    is then a budget, and every ESS-limited stage resamples.
    ``init="prior"`` draws x, y uniformly over the surface and rotY over
    [0, 2 pi) for the movable objects; ``"pose0"`` starts every particle
    at ``pose0``.
    """
    if init not in ("pose0", "prior"):
        raise ValueError(f"init={init!r} (use 'pose0' or 'prior')")
    ids, devices, n_shards = chain_shards(mesh, scene.device)
    n = n_particles
    n_local = local_count(n, n_shards, "n_particles")
    home = devices[0]
    beta_sched = _schedule(cfg.beta, n_stages, home)
    steps = shard_steps(scene, cfg, devices)
    states = []
    for d, st in zip(ids, steps):
        p0, keys = chain_starts(key, pose0, st.scene, n_local, d * n_local)
        if init == "prior":
            gids = torch.arange(d * n_local, (d + 1) * n_local, device=st.scene.device)
            p0 = _prior_starts(key, p0, st.scene, cfg, gids)
        states.append(st.init(p0, keys))

    zero = torch.zeros((), device=home)
    log_w = [torch.zeros(n_local, device=d) for d in devices]
    log_z = zero
    beta_cur = zero
    k_rs = [prng.fold_in(key.to(d), 0x5C) for d in devices]

    def global_ess(log_w):
        m = pmax([torch.amax(lw) for lw in log_w], mesh)
        shifted = [torch.exp(lw - mm) for lw, mm in zip(log_w, m)]
        z1 = psum([torch.sum(s) for s in shifted], mesh)[0]
        z2 = psum([torch.sum(torch.square(s)) for s in shifted], mesh)[0]
        return torch.square(z1) / torch.clamp_min(z2, 1e-30), m[0], z1

    def on_shards(v):
        return [v.to(d) for d in devices]

    ess_t, need_t, beta_t = [], [], []
    for t in range(n_stages):
        scores = [s.costs.total for s in states]
        if adaptive:
            # bisect the largest increment keeping ESS >= target
            remaining = torch.clamp_min(cfg.beta - beta_cur, 0.0)
            target = target_ess * n

            def ess_of(db):
                return global_ess([lw + b * sc
                                   for lw, b, sc in zip(log_w, on_shards(db), scores)])[0]

            full_ok = ess_of(remaining) >= target
            lo, hi = zero, remaining
            for _ in range(26):
                mid = 0.5 * (lo + hi)
                ok = ess_of(mid) >= target
                lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
            dbeta = torch.where(full_ok, remaining, lo)
            beta_next = beta_cur + dbeta
        else:
            dbeta = beta_sched[t + 1] - beta_sched[t]
            beta_next = beta_sched[t + 1]

        # reweight, normalise, fold the stage normaliser into the evidence
        log_w = [lw + b * sc for lw, b, sc in zip(log_w, on_shards(dbeta), scores)]
        ess, m, z1 = global_ess(log_w)
        stage_log_norm = m + torch.log(z1 * prng.reciprocal(n))
        log_z = log_z + stage_log_norm
        log_w = [lw - s for lw, s in zip(log_w, on_shards(stage_log_norm))]

        # resample when the ESS collapses; adaptive tempering also after
        # every partial (ESS-limited) increment, or the schedule stalls
        need = ess < ess_threshold * n
        if adaptive:
            need = need | ~full_ok
        gathered = zip(ids, all_gather([s.pose for s in states], mesh),
                       all_gather([s.costs.as_vector() for s in states], mesh),
                       all_gather(log_w, mesh))
        for j, (d, pose_all, cvec_all, lw_all) in enumerate(gathered):
            idx = systematic_resample_indices(prng.fold_in(k_rs[j], t), lw_all, n)
            mine = idx[d * n_local:(d + 1) * n_local]
            need_j = need.to(devices[j])
            states[j] = with_rows(states[j], (pose_all[mine], cvec_all[mine]),
                                  need_j.expand(n_local))
            log_w[j] = torch.where(need_j, 0.0, log_w[j])

        # mutate: MH steps at the new inverse temperature
        states = advance(steps, states, mutate_steps, betas=on_shards(beta_next))
        beta_cur = beta_next
        ess_t.append(ess)
        need_t.append(need)
        beta_t.append(beta_next)

    def stack(xs, dtype):
        return torch.stack(xs) if xs else torch.zeros(0, dtype=dtype, device=home)

    diagnostics = {
        "log_weights": concat(log_w),
        "log_evidence": log_z,
        "ess": stack(ess_t, torch.float32),
        "resampled": stack(need_t, torch.bool),
        "betas": stack(beta_t, torch.float32),
    }
    return concat_states([st.finalize(s) for st, s in zip(steps, states)]), diagnostics
