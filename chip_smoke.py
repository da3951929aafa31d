"""Run the mh_tpu_torch main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

1. device: the card's name and ``nvidia-smi`` power limit;
2. build: ``nvcc`` compiles ``mh_tpu_torch/kernels/csrc/*.cu`` from this
   checkout;
3. rng: the kernel's counter-based uniforms equal the plain version's bits;
4. kernel vs plain version (``fused_chains_reference`` on CUDA tensors):
   ``demo_scene(32)``, 64 chains, 50 steps in PARITY, FIXED and weighted
   FIXED, then the main path's own shape (100 objects, 1024 chains, 1000
   steps). Both sum in one order and round every operation alike, so they
   are expected to agree exactly; the check allows accept counts or poses
   (beyond 1e-4) to differ in at most 1/32 of the chains, and holds the
   rest to the breakdown tolerance rtol=2e-4, atol=2e-3;
5. main path: ``suggest_layouts(demo_scene(100), SamplerConfig(
   iterations=1000, n_chains=1024), key=0, device="cuda")`` must go through
   the CUDA kernel (launch count >= 1, plain version not called), give
   finite costs, a mean accept rate in (0, 1), breakdowns that match
   ``cost_terms`` on every final pose (rtol=2e-4, atol=2e-3), and the same
   bits when run again;
6. time: per-step time from CUDA events, as the slope of the minimum over
   repeats against the step count, for the kernel and the plain version.

Then one JSON line describing the kernels and, last, the device line.
Without a CUDA device, or without the package beside this script, it
exits non-zero before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
RTOL, ATOL, POSE_ATOL = 2e-4, 2e-3, 1e-4
MAX_DIVERGENT_SHARE = 1 / 32


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def events_ms(fn, repeats: int) -> float:
    """Minimum over ``repeats`` of the CUDA-event time of ``fn()``."""
    import torch

    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def timed(fn):
    """``(fn(), CUDA-event milliseconds)`` for one call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def slope(xs, ys) -> float:
    import numpy as np

    return float(np.polyfit(np.asarray(xs, float), np.asarray(ys, float), 1)[0])


def compare(kernel_out, plain_out) -> float:
    """Check the kernel's result against the plain version's; max abs error."""
    import torch

    kp, kb, ka, ks = kernel_out
    pp, pb, pa, ps = plain_out
    same = (ka == pa) & ((kp - pp).abs().amax((1, 2)) <= POSE_ATOL)
    n_div = int((~same).sum())
    if n_div > MAX_DIVERGENT_SHARE * len(same):
        raise AssertionError(f"{n_div} of {len(same)} chains diverge from the plain version")
    torch.testing.assert_close(kb[same], pb[same], rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(ks, ps, rtol=1e-6, atol=0)
    return max((kp - pp)[same].abs().max().item(), (kb - pb)[same].abs().max().item())


def check_self_consistent(pose, breakdown, scene, mode) -> float:
    """Every chain's reported breakdown against cost_terms on its final pose."""
    import torch

    from mh_tpu_torch import cost_terms

    ref = cost_terms(pose, scene, mode).as_vector()
    torch.testing.assert_close(breakdown, ref, rtol=RTOL, atol=ATOL)
    return (breakdown - ref).abs().max().item()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import mh_tpu_torch
    from mh_tpu_torch import CostMode, SamplerConfig, demo_scene, suggest_layouts
    from mh_tpu_torch.kernels import _build
    from mh_tpu_torch.kernels import fused_mh as F

    if Path(mh_tpu_torch.__file__).resolve().parents[1] != HERE:
        raise SystemExit(f"mh_tpu_torch imported from {mh_tpu_torch.__file__}, not {HERE}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", kind=kind, count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    # 2. build
    lib, build_s, log = _build.build()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    say("build", library=lib.name, seconds=build_s, ptxas=regs)

    # 3. rng
    for seed, counter, first in ((0, 0, 0), (7, 3, 40), (-5, 999, 1 << 20)):
        got = F.uniform_block_cuda(seed, counter, first, 1024, dev)
        want = F.uniform_block(seed, counter, first, 1024, dev)
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"uniform bits differ at seed={seed} counter={counter}")
    say("rng", bits_equal=True)

    # 4. kernel vs plain version
    max_err = 0.0
    spec = demo_scene(32)
    for mode, w_off in ((CostMode.PARITY, 0.0), (CostMode.FIXED, 0.0), (CostMode.FIXED, -1.5)):
        scene = spec.build(device=dev)
        scene = dataclasses.replace(scene, w_offlimits=torch.tensor(w_off, device=dev))
        pk = F.pack_scene(scene, SamplerConfig(mode=mode))
        pose0 = spec.initial_pose(device=dev).expand(64, 32, 6).contiguous()
        k = F.fused_mh_cuda(pk, pose0, 5, 50)
        p = F.fused_chains_reference(pk, pose0, 5, 50)
        err = compare(k, p)
        check_self_consistent(k[0], k[1], scene, mode)
        exact = all(torch.equal(a, b) for a, b in zip(k, p))
        max_err = max(max_err, err)
        say("kernel_vs_plain", objs=32, chains=64, steps=50, mode=mode.name, w_offlimits=w_off,
            max_abs_err=err, bitwise_equal=exact)

    head = demo_scene(100)
    cfg = SamplerConfig(iterations=1000, n_chains=1024)
    scene = head.build(device=dev)
    pk = F.pack_scene(scene, cfg)
    pose0 = head.initial_pose(device=dev).expand(cfg.n_chains, 100, 6).contiguous()
    k = F.fused_mh_cuda(pk, pose0, 0, cfg.iterations)
    p, plain_call_ms = timed(lambda: F.fused_chains_reference(pk, pose0, 0, cfg.iterations))
    err = compare(k, p)
    max_err = max(max_err, err)
    say("kernel_vs_plain", objs=100, chains=cfg.n_chains, steps=cfg.iterations,
        mode="PARITY", max_abs_err=err, bitwise_equal=all(torch.equal(a, b) for a, b in zip(k, p)),
        plain_call_ms=plain_call_ms)

    # 5. main path
    F.fused_mh_cuda.launches = 0
    F.fused_chains_reference.calls = 0
    res = suggest_layouts(head, cfg, key=0, device="cuda")
    launches, plain_calls = F.fused_mh_cuda.launches, F.fused_chains_reference.calls
    if launches < 1 or plain_calls:
        raise AssertionError(f"main path: {launches} kernel launches, {plain_calls} plain calls")
    if not (torch.isfinite(torch.as_tensor(res.costs)).all()
            and torch.isfinite(torch.as_tensor(res.points)).all()):
        raise AssertionError("main path returned non-finite values")
    acc = float(res.accept_rate.mean())
    if not 0.0 < acc < 1.0:
        raise AssertionError(f"mean accept rate {acc}")
    pose = torch.as_tensor(res.points, device=dev)
    bd = torch.as_tensor(res.costs, device=dev)
    self_err = check_self_consistent(pose, bd, scene, cfg.mode)
    again = suggest_layouts(head, cfg, key=0, device="cuda")
    if not ((again.points == res.points).all() and (again.costs == res.costs).all()):
        raise AssertionError("two runs with one seed differ")
    say("main_path", objs=100, chains=cfg.n_chains, steps=cfg.iterations, launches=launches,
        plain_calls=plain_calls, mean_accept=acc, breakdown_vs_cost_terms_max_abs=self_err,
        mean_total=float(res.costs[:, 0].mean()), deterministic=True)

    # 6. time (CUDA events; slope over step counts, minimum of repeats)
    def kernel(steps):
        return lambda: F.fused_mh_cuda(pk, pose0, 0, steps)

    def plain(steps):
        return lambda: F.fused_chains_reference(pk, pose0, 0, steps)

    ks = (10, 505, 1010)
    kt = [events_ms(kernel(s), 5) for s in ks]
    ps_ = (5, 15, 25)
    pt = [events_ms(plain(s), 2) for s in ps_]
    k_step, p_step = slope(ks, kt), slope(ps_, pt)
    call_ms = events_ms(kernel(cfg.iterations), 5)
    say("time", card=smi, objs=100, chains=cfg.n_chains,
        kernel_ms_per_step=k_step, kernel_proposals_per_s=cfg.n_chains / (k_step * 1e-3),
        plain_ms_per_step=p_step, plain_proposals_per_s=cfg.n_chains / (p_step * 1e-3),
        kernel_ms=dict(zip(map(str, ks), kt)), plain_ms=dict(zip(map(str, ps_), pt)),
        kernel_call_ms=call_ms, plain_call_ms=plain_call_ms)

    if "jax" in sys.modules or "mh_tpu" in sys.modules:
        raise AssertionError("the port imported JAX or mh_tpu")
    print(json.dumps({"kernels": [{
        "name": "fused_mh",
        "route": "cuda",
        "source": "mh_tpu_torch/kernels/csrc/fused_mh.cu",
        "replaces": "mh_tpu/kernels/fused_mh.py:405",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": call_ms,
        "plain_ms": plain_call_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
