"""Command-line interface: ``python -m mh_tpu_torch <command>``.

The same commands, flags, defaults and JSON output as ``mh_tpu.cli``, plus
``--device`` (default ``cuda``), the port's counterpart of
``JAX_PLATFORMS``: ``cuda`` runs the CUDA kernels, ``cpu`` their plain
PyTorch versions.

Commands:
  suggest   run MH layout suggestions on a scene (file or built-in demo)
  demo      run + pretty-print the reference demo scene
  pi        Monte-Carlo pi estimate (plain PyTorch; --fused for the CUDA kernel)
  devices   report the CUDA devices and the default chain mesh
  temper    parallel tempering over every card (chain_mesh()), or one
            shard with --device cpu (--adapt-ladder for the
            swap-rate-adaptive ladder)
  smc       annealed SMC over every card, or one shard with --device cpu
            (--adaptive --init prior for ESS-targeted tempering from the
            beta=0 prior)
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", default="cuda",
        help="cuda (the CUDA kernels; raises without a card) or cpu (their "
             "plain PyTorch versions)",
    )


def _add_sampler_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--chains", type=int, default=4)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--moves-per-step", type=int, default=1)
    p.add_argument(
        "--accept-draws", type=int, default=1,
        help="K independent accept decisions per proposal (Kernel.cu:819 "
             "emulation; set = --moves-per-step for reference-default "
             "blockxDim semantics)",
    )
    p.add_argument("--beta", type=float, default=2.0)
    p.add_argument("--mode", choices=["parity", "fixed"], default="parity")
    p.add_argument("--adapt", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--config", help="JSON file of SamplerConfig overrides")
    p.add_argument(
        "--log", help="append a structured JSONL event stream here "
                      "(run_config / round / result events; utils/runlog)",
    )
    p.add_argument(
        "--log-every", type=int, default=0,
        help="emit a `round` stats event every N steps (default: "
             "iterations/10 when --log is set; torch engine only)",
    )
    _add_device_flag(p)


def _sampler_config(args):
    from mh_tpu_torch.config import CostMode, SamplerConfig
    from mh_tpu_torch.utils.serialization import sampler_config_from_dict

    if args.config:
        with open(args.config) as f:
            return sampler_config_from_dict(json.load(f))
    return SamplerConfig(
        iterations=args.iters,
        n_chains=args.chains,
        n_moves_per_step=args.moves_per_step,
        accept_draws=args.accept_draws,
        beta=args.beta,
        adapt=args.adapt,
        mode=CostMode(args.mode),
    )


def _log_kwargs(args) -> dict:
    """--log/--log-every -> suggest_layouts logging kwargs.

    With --log but no --log-every, default to ~10 rounds of events.
    """
    if not getattr(args, "log", None):
        return {}
    every = getattr(args, "log_every", 0) or max(args.iters // 10, 1)
    return {"log": args.log, "log_every": every}


def cmd_suggest(args) -> int:
    from mh_tpu_torch.api import suggest_layouts
    from mh_tpu_torch.models.scene import demo_scene
    from mh_tpu_torch.utils.serialization import load_scene

    spec = load_scene(args.scene) if args.scene else demo_scene(args.objects)
    res = suggest_layouts(
        spec, _sampler_config(args), key=args.seed, engine=args.engine,
        serve=args.serve, objs_devices=args.objs_devices, device=args.device,
        **_log_kwargs(args),
    )
    out = {
        "points": np.asarray(res.points, np.float64).tolist(),
        "costs": {
            name: np.asarray(res.costs[:, i], np.float64).tolist()
            for i, name in enumerate(type(res).COST_FIELDS)
        },
        "accept_rate": np.asarray(res.accept_rate, np.float64).tolist(),
    }
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}")
    else:
        print(text)
    return 0


def cmd_demo(args) -> int:
    from mh_tpu_torch.api import suggest_layouts
    from mh_tpu_torch.models.scene import demo_scene

    spec = demo_scene(args.objects)
    res = suggest_layouts(
        spec, _sampler_config(args), key=args.seed, device=args.device, **_log_kwargs(args)
    )
    for c in range(res.points.shape[0]):
        print(f"Suggestion {c}  (accept rate {res.accept_rate[c]:.2f})")
        print(
            "  costs: "
            + "  ".join(
                f"{n}={v:.3f}" for n, v in zip(type(res).COST_FIELDS, res.costs[c])
            )
        )
    return 0


def cmd_pi(args) -> int:
    if args.fused:
        from mh_tpu_torch.kernels.pi_kernel import estimate_pi_fused

        est, total = estimate_pi_fused(args.seed, args.samples, device=args.device)
        print(f"pi ~= {est:.6f}  ({total} samples, fused kernel)")
    else:
        from mh_tpu_torch.models.pi import estimate_pi

        est = estimate_pi(args.seed, n_samples=args.samples, device=args.device)
        print(f"pi ~= {est:.6f}  ({args.samples} samples)")
    return 0


def cmd_devices(_args) -> int:
    from mh_tpu_torch.parallel.mesh import device_report

    print(device_report())
    return 0


def _scene_on_device(args):
    """(initial pose, built scene, mesh) of --scene or the demo scene on
    --device; the mesh spans every card for ``cuda`` and is None (one
    shard on the device) otherwise."""
    import torch

    from mh_tpu_torch.models.scene import demo_scene
    from mh_tpu_torch.parallel.mesh import chain_mesh
    from mh_tpu_torch.utils.serialization import load_scene

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    spec = load_scene(args.scene) if args.scene else demo_scene(args.objects)
    mesh = chain_mesh() if device == torch.device("cuda") else None
    return spec.initial_pose(device=device), spec.build(device=device), mesh


def _write_log(args, engine: str, n_chains: int, result: dict) -> None:
    if args.log:
        from mh_tpu_torch.utils.runlog import RunLogger

        with RunLogger(args.log) as lg:
            lg.log_config(_sampler_config(args), engine=engine, n_objs=args.objects,
                          n_chains=n_chains)
            lg.event("result", engine=engine, **result)


def cmd_temper(args) -> int:
    from mh_tpu_torch.sampler import prng
    from mh_tpu_torch.sampler.tempering import run_tempered

    pose0, scene, mesh = _scene_on_device(args)
    out = run_tempered(
        prng.key(args.seed), pose0, scene, _sampler_config(args), mesh,
        n_replicas=args.replicas, exchange_every=args.exchange_every, rounds=args.rounds,
        adapt_ladder=args.adapt_ladder,
    )
    states, swap_rates = out[0], out[1]
    result = {
        "swap_rates": swap_rates.cpu().numpy().astype(np.float64).tolist(),
        "target_total_cost": float(states.costs.total[-1]),
    }
    if args.adapt_ladder:
        result["betas"] = out[2].cpu().numpy().astype(np.float64).tolist()
    _write_log(args, "tempering", args.replicas, result)
    print(json.dumps(result))
    return 0


def cmd_smc(args) -> int:
    from mh_tpu_torch.sampler import prng
    from mh_tpu_torch.sampler.smc import run_smc

    pose0, scene, mesh = _scene_on_device(args)
    states, diag = run_smc(
        prng.key(args.seed), pose0, scene, _sampler_config(args), mesh,
        n_particles=args.particles, n_stages=args.stages, mutate_steps=args.mutate_steps,
        adaptive=args.adaptive, init=args.init,
    )
    result = {
        "log_evidence": float(diag["log_evidence"]),
        "betas": diag["betas"].cpu().numpy().astype(np.float64).tolist(),
        "ess": diag["ess"].cpu().numpy().astype(np.float64).tolist(),
        "resampled": diag["resampled"].cpu().numpy().astype(int).tolist(),
        "best_total_cost": float(states.costs.total.max()),
    }
    _write_log(args, "smc", args.particles, result)
    print(json.dumps(result))
    return 0


def main(argv=None) -> int:
    from mh_tpu_torch.api import ENGINE_ALIASES, ENGINES

    ap = argparse.ArgumentParser(prog="mh_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("suggest", help="run MH layout suggestions")
    p.add_argument("--scene", help="scene JSON (default: built-in demo scene)")
    p.add_argument("--objects", type=int, default=32)
    p.add_argument("--out", help="write results JSON here")
    p.add_argument(
        "--engine", default="auto",
        choices=[*ENGINES, *ENGINE_ALIASES],
        help="sampling engine (see suggest_layouts; xla and xla_specialized are "
             "mh_tpu's names for torch and torch_graph)",
    )
    p.add_argument(
        "--serve", action="store_true",
        help="accepted for mh_tpu's flags; changes nothing here (auto takes the fused "
             "kernel wherever it runs the config, else the CUDA-graph engine)",
    )
    p.add_argument(
        "--objs-devices", type=int, default=None,
        help="split the O(N^2) objective within each chain into this many row "
             "shards (over the cards where their count is a multiple of it, else "
             "on --device; the torch engine)",
    )
    _add_sampler_flags(p)
    p.set_defaults(fn=cmd_suggest)

    p = sub.add_parser("demo", help="reference demo scene, pretty-printed")
    p.add_argument("--objects", type=int, default=32)
    _add_sampler_flags(p)
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("pi", help="Monte-Carlo pi estimate")
    p.add_argument("--samples", type=int, default=1 << 22)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fused", action="store_true", help="the CUDA pi kernel")
    _add_device_flag(p)
    p.set_defaults(fn=cmd_pi)

    p = sub.add_parser("devices", help="device report")
    p.set_defaults(fn=cmd_devices)

    p = sub.add_parser("temper", help="parallel tempering over the chain mesh")
    p.add_argument("--scene", help="scene JSON (default: built-in demo scene)")
    p.add_argument("--objects", type=int, default=32)
    p.add_argument("--replicas", type=int, default=16)
    p.add_argument("--exchange-every", type=int, default=5)
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--adapt-ladder", action="store_true",
                   help="swap-rate-targeted ladder adaptation")
    _add_sampler_flags(p)
    p.set_defaults(fn=cmd_temper)

    p = sub.add_parser("smc", help="annealed SMC over the chain mesh")
    p.add_argument("--scene", help="scene JSON (default: built-in demo scene)")
    p.add_argument("--objects", type=int, default=32)
    p.add_argument("--particles", type=int, default=64)
    p.add_argument("--stages", type=int, default=10)
    p.add_argument("--mutate-steps", type=int, default=5)
    p.add_argument("--adaptive", action="store_true",
                   help="ESS-targeted adaptive tempering")
    p.add_argument("--init", choices=["pose0", "prior"], default="pose0")
    _add_sampler_flags(p)
    p.set_defaults(fn=cmd_smc)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
