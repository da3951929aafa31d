"""Huge-scene layout sampling: split the O(N^2) objective into row shards
(counterpart of ``examples/huge_scene.py``).

The reference's own README flags quadratic cost growth as its scaling
limit (the symmetry and off-limits terms build N x N matrices,
``Kernel.cu:283-318,485-514``). The port splits each chain's N x N cost
rows over ``--objs-devices`` shards (``suggest_layouts(objs_devices=k)``):
over every card where their count is a multiple of k (the chains split
over the groups), else k shards of the one device.

Usage: python -m mh_tpu_torch.examples.huge_scene [--objects 2048]
       [--chains 2] [--iters 10] [--objs-devices 4] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from mh_tpu_torch import SamplerConfig, demo_scene, suggest_layouts


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--objects", type=int, default=2048)
    ap.add_argument("--chains", type=int, default=2)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--objs-devices", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    n_cards = torch.cuda.device_count() if device.type == "cuda" else 0
    where = (f"over {n_cards} cards" if n_cards and n_cards % args.objs_devices == 0
             else f"all on {device}")
    print(f"{args.objects}-object scene, objective rows in {args.objs_devices} shards {where}")

    spec = demo_scene(args.objects)
    cfg = SamplerConfig(iterations=args.iters, n_chains=args.chains)
    t0 = time.time()
    res = suggest_layouts(spec, cfg, key=0, objs_devices=args.objs_devices, device=device)
    dt = time.time() - t0
    for c in range(args.chains):
        print(f"chain {c}: total={res.costs[c, 0]:.2f} accept_rate={res.accept_rate[c]:.2f}")
    print(f"{args.chains * args.iters} proposals over a {args.objects}x{args.objects} "
          f"objective in {dt:.1f}s")


if __name__ == "__main__":
    main()
