"""Advanced sampling demo: collective adaptation, tempering, SMC, HMC, NUTS,
VI (counterpart of ``examples/advanced_sampling.py``).

Runs every sampler family of the port on the reference demo scene: the MH
families over a chain mesh (every card; on the CPU, one shard), the
gradient samplers on the layout log-density.

Usage: python -m mh_tpu_torch.examples.advanced_sampling [--objects 16]
       [--replicas 16] [--draws 100] [--device cuda|cpu]

``--draws`` (not in the JAX example, whose sizes it gives by default) sets
HMC's warmup and draws; NUTS takes half as many, VI three times as many
steps.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from mh_tpu_torch.config import CostMode, SamplerConfig
from mh_tpu_torch.models.scene import demo_scene
from mh_tpu_torch.parallel.mesh import chain_mesh, device_report
from mh_tpu_torch.parallel.sharded import run_chains_collective
from mh_tpu_torch.sampler import prng
from mh_tpu_torch.sampler.generic import layout_logdensity, theta_from_pose
from mh_tpu_torch.sampler.hmc import hmc_sample
from mh_tpu_torch.sampler.nuts import nuts_sample
from mh_tpu_torch.sampler.smc import run_smc
from mh_tpu_torch.sampler.tempering import run_tempered
from mh_tpu_torch.sampler.vi import meanfield_vi


def _np(t) -> np.ndarray:
    return torch.as_tensor(t).detach().cpu().numpy()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--objects", type=int, default=16)
    ap.add_argument("--replicas", type=int, default=16)
    ap.add_argument("--draws", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    print(device_report())
    mesh = chain_mesh() if device.type == "cuda" else chain_mesh(devices=[device])
    n_dev = len(mesh.devices.flat)
    spec = demo_scene(args.objects)
    scene = spec.build(device=device)
    pose0 = spec.initial_pose(device=device)
    key = prng.key(0, device)

    n_chains = max(args.replicas, n_dev) // n_dev * n_dev

    print("\n== collective acceptance-rate adaptation (psum) ==")
    cfg = SamplerConfig(iterations=0, n_chains=n_chains, adapt_rate=0.2, target_accept=0.35)
    states, rates, log_scale = run_chains_collective(
        key, pose0, scene, cfg, mesh, rounds=10, steps_per_round=10)
    print(f"accept-rate trace: {np.round(_np(rates), 3)}")
    print(f"shared step-size scale: {float(np.exp(_np(log_scale))):.3f}")

    print("\n== parallel tempering (replica exchange) ==")
    states, swap_rates = run_tempered(
        key, pose0, scene, SamplerConfig(iterations=0), mesh,
        n_replicas=n_chains, exchange_every=5, rounds=10)
    print(f"swap-rate trace: {np.round(_np(swap_rates), 3)}")
    print(f"target-replica total cost: {_np(states.costs.total)[-1]:.2f}")

    print("\n== parallel tempering with swap-rate-adaptive ladder ==")
    states, swap_rates, betas_adapted = run_tempered(
        key, pose0, scene, SamplerConfig(iterations=0), mesh,
        n_replicas=n_chains, exchange_every=5, rounds=10, adapt_ladder=True)
    print(f"adapted ladder: {np.round(_np(betas_adapted), 4)}")
    print(f"swap-rate trace: {np.round(_np(swap_rates), 3)}")

    print("\n== annealed SMC (all-gather resampling) ==")
    states, diag = run_smc(
        key, pose0, scene, SamplerConfig(iterations=0), mesh,
        n_particles=n_chains, n_stages=8, mutate_steps=3)
    print(f"ESS trace: {np.round(_np(diag['ess']), 1)}")
    print(f"resampled at stages: {np.where(_np(diag['resampled']))[0].tolist()}")
    print(f"log evidence: {float(_np(diag['log_evidence'])):.2f}")

    print("\n== adaptive-tempered SMC from the beta=0 prior ==")
    states, diag = run_smc(
        key, pose0, scene, SamplerConfig(iterations=0), mesh,
        n_particles=n_chains, n_stages=8, mutate_steps=3, adaptive=True, init="prior")
    print(f"beta schedule: {np.round(_np(diag['betas']), 4)}")
    print(f"ESS trace: {np.round(_np(diag['ess']), 1)}")
    print(f"log evidence: {float(_np(diag['log_evidence'])):.2f}")

    # The gradient samplers need a proper target: the reference's parity
    # semantics (negative weights, reward-higher-total accept) make the
    # density improper. FIXED mode with positive penalty weights: total <= 0.
    sane = dataclasses.replace(
        spec, w_pairwise=2.0, w_visual_balance=1.0, w_focal=2.0, w_symmetry=2.0,
        w_clearance=2.0, w_offlimits=1.0, w_surface_area=2.0)
    target = layout_logdensity(sane.build(device=device), pose0, beta=2.0, mode=CostMode.FIXED)
    theta0 = theta_from_pose(pose0)

    print("\n== HMC on the (proper, FIXED-mode) layout log-density ==")
    draws, nuts_draws = args.draws, max(args.draws // 2, 1)
    _, final = hmc_sample(prng.key(1), target, theta0, n_samples=draws, n_warmup=draws,
                          n_leapfrog=8, n_chains=2, device=device)
    print(f"accept: {_np(final.n_accept) / draws}")
    print(f"final log-density: {np.round(_np(final.logprob), 2)}")

    print("\n== NUTS (adaptive trajectory length) on the same target ==")
    _, nfinal = nuts_sample(prng.key(3), target, theta0, n_samples=nuts_draws,
                            n_warmup=nuts_draws, max_depth=6, n_chains=2, device=device)
    print(f"mean tree depth: {_np(nfinal.sum_depth) / nuts_draws}")
    print(f"divergences: {_np(nfinal.n_divergent)}")
    print(f"final log-density: {np.round(_np(nfinal.logprob), 2)}")

    print("\n== mean-field VI ==")
    _, _, trace = meanfield_vi(prng.key(2), target, theta0, n_steps=3 * draws, n_mc=8,
                               device=device)
    t, w = _np(trace), max(3 * draws // 15, 1)
    print(f"ELBO: start {t[:w].mean():.1f} -> end {t[-w:].mean():.1f}")


if __name__ == "__main__":
    main()
