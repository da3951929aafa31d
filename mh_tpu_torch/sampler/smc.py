"""Annealed Sequential Monte Carlo on one device (counterpart of ``mh_tpu.sampler.smc``).

Particles anneal from beta=0 to the target beta: each stage reweights by
``exp(dbeta * S)``, renormalises (folding the normaliser into the
log-evidence), resamples systematically when the effective sample size
drops below ``ess_threshold * n_particles``, and mutates with MH steps at
the new temperature.

``mh_tpu`` shards the particles over a mesh, normalises with ``psum`` and
gathers the ensemble with ``all_gather`` to resample; on one device those
are local sums and plain indexing. Its ``lax.cond`` on the resample
decision becomes a selection (``torch.where``) between the resampled and
the kept ensemble, so no stage reads a value back to the host. Keys follow
``mh_tpu``: particle ``i`` is ``fold_in(key, i)``, the stage-``t``
resample key ``fold_in(fold_in(key, 0x5C), t)``, the prior draws
``split(fold_in(fold_in(key, 0x9A1), i), 3)``. Multi-GPU SMC is ROADMAP
Queue 1.8.
"""

from __future__ import annotations

import numpy as np
import torch

from mh_tpu_torch.config import SamplerConfig
from mh_tpu_torch.models.scene import Scene
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.mh import ChainStep, chain_starts
from mh_tpu_torch.sampler.tempering import check_one_device, with_rows

Tensor = torch.Tensor


def _reciprocal(n: int) -> float:
    """``1 / n`` in float32. XLA turns a division by a constant into a
    multiply by its float32 reciprocal, and so does PyTorch on CUDA for a
    host scalar; the port multiplies by it explicitly on both devices."""
    return float(np.float32(1.0) / np.float32(n))


def _schedule(beta: float, n_stages: int, device) -> Tensor:
    """``jnp.linspace(0, beta, n_stages + 1)`` as XLA computes it in float32:
    ``start * (1 - s) + stop * s`` with ``s = i * (1 / n_stages)``, the last
    entry exactly ``stop``."""
    stop = np.float32(beta)
    s = np.arange(n_stages, dtype=np.float32) * np.float32(_reciprocal(n_stages))
    out = np.float32(0.0) * (np.float32(1.0) - s) + stop * s
    return torch.as_tensor(np.append(out, stop).astype(np.float32), device=device)


def systematic_resample_indices(key: Tensor, log_w: Tensor, n: int) -> Tensor:
    """Systematic resampling: n indices (int64) from normalised log-weights.

    An index past the end (a point above the float32 CDF's last entry) is
    clamped to the last particle, as JAX clamps an out-of-range gather.
    """
    cdf = torch.cumsum(torch.softmax(log_w, 0), 0)
    u0 = prng.uniform(key, (), 0.0, 1.0 / n)
    steps = torch.arange(n, dtype=torch.float32, device=log_w.device) * _reciprocal(n)
    idx = torch.searchsorted(cdf, u0 + steps, side="left")
    return torch.clamp_max(idx, n - 1)


def run_smc(
    key: Tensor,
    pose0: Tensor,
    scene: Scene,
    cfg: SamplerConfig,
    mesh=None,
    n_particles: int = 64,
    n_stages: int = 10,
    mutate_steps: int = 5,
    ess_threshold: float = 0.5,
    adaptive: bool = False,
    target_ess: float = 0.5,
    init: str = "pose0",
):
    """Annealed SMC from beta=0 to ``cfg.beta`` on the scene's device.

    Returns ``(states [n_particles, ...], diagnostics)``: a dict of per-stage
    ``ess`` (f32[n_stages]), ``resampled`` (bool[n_stages]) and ``betas``
    (f32[n_stages], the post-stage inverse temperature), the final
    ``log_weights`` and the ``log_evidence`` estimate.

    ``adaptive``: each increment is bisected (26 halvings) so the
    post-increment ESS lands at ``target_ess * n_particles``; ``n_stages``
    is then a budget, and every ESS-limited stage resamples.
    ``init="prior"`` draws x, y uniformly over the surface and rotY over
    [0, 2 pi) for the movable objects; ``"pose0"`` starts every particle
    at ``pose0``.
    """
    if init not in ("pose0", "prior"):
        raise ValueError(f"init={init!r} (use 'pose0' or 'prior')")
    check_one_device(mesh)
    dev = scene.device
    n = n_particles
    key = key.to(dev)
    beta_sched = _schedule(cfg.beta, n_stages, dev)
    step = ChainStep(scene, cfg)
    p0, keys = chain_starts(key, pose0, scene, n)
    if init == "prior":
        mnx, mny, mxx, mxy = scene.surface_bounds()
        movable = scene.obj_mask * (1.0 - scene.frozen.to(torch.float32))
        sub = prng.split(prng.fold_in(prng.fold_in(key, 0x9A1), torch.arange(n, device=dev)), 3)
        n_objs = p0.shape[1]
        draws = (prng.uniform(sub[:, 0], (n_objs,), mnx, mxx),
                 prng.uniform(sub[:, 1], (n_objs,), mny, mxy),
                 prng.uniform(sub[:, 2], (n_objs,), 0.0, 2.0 * cfg.mode.pi))
        p0 = p0.clone()
        for col, d in zip((0, 1, 4), draws):
            p0[:, :, col] = p0[:, :, col] + movable * (d - p0[:, :, col])
    states = step.init(p0, keys)

    zero = torch.zeros((), device=dev)
    log_w = torch.zeros(n, device=dev)
    log_z = zero
    beta_cur = zero
    k_rs = prng.fold_in(key, 0x5C)

    def global_ess(log_w):
        m = torch.amax(log_w)
        shifted = torch.exp(log_w - m)
        z1 = torch.sum(shifted)
        z2 = torch.sum(torch.square(shifted))
        return torch.square(z1) / torch.clamp_min(z2, 1e-30), m, z1

    ess_t, need_t, beta_t = [], [], []
    for t in range(n_stages):
        scores = states.costs.total
        if adaptive:
            # bisect the largest increment keeping ESS >= target
            remaining = torch.clamp_min(cfg.beta - beta_cur, 0.0)
            target = target_ess * n
            full_ok = global_ess(log_w + remaining * scores)[0] >= target
            lo, hi = zero, remaining
            for _ in range(26):
                mid = 0.5 * (lo + hi)
                ok = global_ess(log_w + mid * scores)[0] >= target
                lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
            dbeta = torch.where(full_ok, remaining, lo)
            beta_next = beta_cur + dbeta
        else:
            dbeta = beta_sched[t + 1] - beta_sched[t]
            beta_next = beta_sched[t + 1]

        # reweight, normalise, fold the stage normaliser into the evidence
        log_w = log_w + dbeta * scores
        ess, m, z1 = global_ess(log_w)
        stage_log_norm = m + torch.log(z1 * _reciprocal(n))
        log_z = log_z + stage_log_norm
        log_w = log_w - stage_log_norm

        # resample when the ESS collapses; adaptive tempering also after
        # every partial (ESS-limited) increment, or the schedule stalls
        need = ess < ess_threshold * n
        if adaptive:
            need = need | ~full_ok
        idx = systematic_resample_indices(prng.fold_in(k_rs, t), log_w, n)
        states = with_rows(states, idx, need.expand(n))
        log_w = torch.where(need, zero, log_w)

        # mutate: MH steps at the new inverse temperature
        for _ in range(mutate_steps):
            states = step(states, beta=beta_next)
        beta_cur = beta_next
        ess_t.append(ess)
        need_t.append(need)
        beta_t.append(beta_next)

    def stack(xs, dtype):
        return torch.stack(xs) if xs else torch.zeros(0, dtype=dtype, device=dev)

    diagnostics = {
        "log_weights": log_w,
        "log_evidence": log_z,
        "ess": stack(ess_t, torch.float32),
        "resampled": stack(need_t, torch.bool),
        "betas": stack(beta_t, torch.float32),
    }
    return step.finalize(states), diagnostics
