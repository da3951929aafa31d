"""Demo harness: the reference `main()` scene on the card (counterpart of
``examples/demo_layout.py``).

Reproduces the hard-coded 32-object scene of ``Kernel.cu:1003-1218`` —
10x10 surface, one distance + one angle relationship, two clearances,
alternating off-limits rects, harness weights — runs MH suggestions and
prints the resulting poses plus the (real) per-chain cost breakdowns.

Usage: python -m mh_tpu_torch.examples.demo_layout [--chains N] [--iters N]
       [--objects N] [--seed N] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from mh_tpu_torch import SamplerConfig, demo_scene, suggest_layouts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--objects", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and torch.cuda.is_available():
        print(f"device: {device} ({torch.cuda.get_device_name(device)})")
    else:
        print(f"device: {device}")
    spec = demo_scene(args.objects)
    cfg = SamplerConfig(iterations=args.iters, n_chains=args.chains)

    t0 = time.perf_counter()
    res = suggest_layouts(spec, cfg, key=args.seed, device=device)
    dt = time.perf_counter() - t0

    for c in range(args.chains):
        print(f"\nSuggestion {c}  (accept rate {res.accept_rate[c]:.2f})")
        names = type(res).COST_FIELDS
        print("  costs: " + "  ".join(f"{n}={v:.3f}" for n, v in zip(names, res.costs[c])))
        for j in range(min(args.objects, 8)):
            x, y, z, rx, ry, rz = res.points[c, j]
            print(f"  obj[{j}] x,y,z: {x:.3f}, {y:.3f}, {z:.3f}  rot: {rx:.3f}, {ry:.3f}, {rz:.3f}")
        if args.objects > 8:
            print(f"  ... ({args.objects - 8} more objects)")

    total_props = args.chains * args.iters
    print(f"\n{total_props} proposals in {dt:.2f}s on {device} (first call, build included)")


if __name__ == "__main__":
    main()
