"""Run the mh_tpu_torch paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises and exits non-zero):

1. device: the card's name and ``nvidia-smi`` power limit;
2. build: one ``nvcc`` call compiles ``mh_tpu_torch/kernels/csrc/*.cu``
   from this checkout into one library;
3. rng: the kernel's counter-based uniforms equal the plain version's bits;
4. kernel_vs_plain, the fused MH kernel against its plain version
   (``fused_chains_reference`` on CUDA tensors): ``demo_scene(32)``, 64
   chains, 50 steps in PARITY, FIXED and weighted FIXED, with one move and
   one accept draw and with the compound / min-of-K layouts (M, K) = (4, 1),
   (4, 4), (1, 16), (1, 30); then the single-move main path's own shape
   (100 objects, 1024 chains, 1000 steps) and the block path's (100
   objects, 1024 chains, 64 moves and 64 accept draws per step, 100
   steps), the latter once at the reference's beta=2 and once at
   beta=1e-3 with step-size adaptation, where most chains accept (the
   reference's acceptance at this shape is ~1e-5, so few chains ever
   move). Both versions sum in one order and round every operation
   alike: the pose, breakdown, accept count and step scale must be
   bitwise equal in every chain;
5. main_path: ``suggest_layouts(demo_scene(100), SamplerConfig(
   iterations=1000, n_chains=1024), key=0, device="cuda")``, and
   main_path_block: the same scene with ``n_moves_per_step=64,
   accept_draws=64`` over 500 steps and no ``device`` (a SceneSpec runs on
   CUDA by default). Each must go through the CUDA kernel (launch count
   >= 1, plain version not called), give finite costs, a mean accept rate
   in (0, 1), breakdowns that match ``cost_terms`` on every final pose
   (rtol=2e-4, atol=2e-3), and the same bits when run again;
6. pi: the pi kernel's hit counts equal the plain version's exactly at
   2^28 samples and at a count that is not a whole number of tiles; then
   main_path_pi: ``python -m mh_tpu_torch pi --fused --samples 2^32`` run
   in this process through ``cli.main`` must launch the kernel, not call
   the plain version, and land within 6 sigma of pi;
7. cli: ``python -m mh_tpu_torch pi --fused`` and ``suggest
   --moves-per-step 4`` in subprocesses;
8. time: CUDA-event times, as the slope of the minimum over repeats
   against the step or sample count, for each kernel and its plain version.

Then one JSON line describing the kernels and, last, the device line.
Without a CUDA device, or without the package beside this script, it
exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
RTOL, ATOL = 2e-4, 2e-3
COMPOUND_CASES = ((4, 1), (4, 4), (1, 16), (1, 30))  # (moves per step, accept draws)
BLOCK = dict(n_moves_per_step=64, accept_draws=64)  # BASELINE config 3, layout_block


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


def sigma_pi(n: int) -> float:
    """Standard deviation of 4 * hits / n with hits ~ Binomial(n, pi/4)."""
    return 4 * math.sqrt((math.pi / 4) * (1 - math.pi / 4) / n)


def compare(kernel_out, plain_out) -> dict:
    """Hold the kernel's result to the plain version's, bit for bit.

    Returns the fields each kernel_vs_plain line prints: the largest
    difference, how many chains differ in any output, and how many chains
    accepted at least one step (a chain that never accepts keeps its start
    pose in both versions, so only those that did test the moves)."""
    import torch

    differs = torch.zeros(kernel_out[0].shape[0], dtype=torch.bool, device=kernel_out[0].device)
    err = 0.0
    for k, p in zip(kernel_out, plain_out):
        diff = (k.float() - p.float()).abs().reshape(len(differs), -1)
        differs |= (k.view(torch.int32) != p.view(torch.int32)).reshape(len(differs), -1).any(1)
        err = max(err, diff.max().item())
    n_div = int(differs.sum())
    if n_div:
        raise AssertionError(f"{n_div} of {len(differs)} chains differ from the plain version "
                             f"(max abs error {err})")
    return dict(max_abs_err=err, divergent_chains=n_div,
                chains_accepting=int((kernel_out[2] > 0).sum()))


def check_self_consistent(pose, breakdown, scene, mode) -> float:
    """Every chain's reported breakdown against cost_terms on its final pose."""
    import torch

    from mh_tpu_torch import cost_terms

    ref = cost_terms(pose, scene, mode).as_vector()
    torch.testing.assert_close(breakdown, ref, rtol=RTOL, atol=ATOL)
    return (breakdown - ref).abs().max().item()


def run_main_path(name, spec, cfg, device, counters):
    """Drive ``suggest_layouts`` once with every launch count at 0, check
    the result, run it again for determinism; returns the launch count."""
    import torch

    from mh_tpu_torch import suggest_layouts

    for fn, attr in counters:
        setattr(fn, attr, 0)
    kw = {} if device is None else {"device": device}
    res = suggest_layouts(spec, cfg, key=0, **kw)
    (kernel, _), (plain, _) = counters
    launches, plain_calls = kernel.launches, plain.calls
    if launches < 1 or plain_calls:
        raise AssertionError(f"{name}: {launches} kernel launches, {plain_calls} plain calls")
    if not (torch.isfinite(torch.as_tensor(res.costs)).all()
            and torch.isfinite(torch.as_tensor(res.points)).all()):
        raise AssertionError(f"{name} returned non-finite values")
    acc = float(res.accept_rate.mean())
    if not 0.0 < acc < 1.0:
        raise AssertionError(f"{name}: mean accept rate {acc}")
    dev = torch.device("cuda")
    scene = spec.build(device=dev)
    self_err = check_self_consistent(torch.as_tensor(res.points, device=dev),
                                     torch.as_tensor(res.costs, device=dev), scene, cfg.mode)
    again = suggest_layouts(spec, cfg, key=0, **kw)
    if not ((again.points == res.points).all() and (again.costs == res.costs).all()):
        raise AssertionError(f"{name}: two runs with one seed differ")
    say(name, objs=spec.n_objs, chains=cfg.n_chains, steps=cfg.iterations,
        moves_per_step=cfg.n_moves_per_step, accept_draws=cfg.accept_draws,
        device="default" if device is None else device, launches=launches,
        plain_calls=plain_calls, mean_accept=acc, breakdown_vs_cost_terms_max_abs=self_err,
        mean_total=float(res.costs[:, 0].mean()), deterministic=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import mh_tpu_torch
    from mh_tpu_torch import CostMode, SamplerConfig, cli, demo_scene
    from mh_tpu_torch.kernels import _build
    from mh_tpu_torch.kernels import fused_mh as F
    from mh_tpu_torch.kernels import pi_kernel as P

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
    lib, seconds, log = _build.build()
    say("build", library=lib.name, seconds=seconds,
        ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln])

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
        pose0 = spec.initial_pose(device=dev).expand(64, 32, 6).contiguous()
        for moves, draws in ((1, 1), *COMPOUND_CASES):
            pk = F.pack_scene(scene, SamplerConfig(mode=mode, n_moves_per_step=moves,
                                                   accept_draws=draws))
            k = F.fused_mh_cuda(pk, pose0, 5, 50)
            p = F.fused_chains_reference(pk, pose0, 5, 50)
            got = compare(k, p)
            check_self_consistent(k[0], k[1], scene, mode)
            max_err = max(max_err, got["max_abs_err"])
            say("kernel_vs_plain", objs=32, chains=64, steps=50, mode=mode.name,
                w_offlimits=w_off, moves_per_step=moves, accept_draws=draws, **got)

    head = demo_scene(100)
    scene = head.build(device=dev)
    cfg = SamplerConfig(iterations=1000, n_chains=1024)
    block_cfg = SamplerConfig(iterations=500, n_chains=1024, **BLOCK)
    pose0 = head.initial_pose(device=dev).expand(cfg.n_chains, 100, 6).contiguous()
    pk = F.pack_scene(scene, cfg)
    block_pk = F.pack_scene(scene, block_cfg)
    # the block path where most chains accept, so the compound moves are tested
    hot_cfg = dataclasses.replace(block_cfg, beta=1e-3, adapt=True)
    plain_call_ms = {}
    for name, kcfg, steps in (("single", cfg, cfg.iterations), ("block", block_cfg, 100),
                              ("block_hot", hot_cfg, 100)):
        kpk = F.pack_scene(scene, kcfg)
        k = F.fused_mh_cuda(kpk, pose0, 0, steps)
        p, plain_call_ms[name] = timed(lambda: F.fused_chains_reference(kpk, pose0, 0, steps))
        got = compare(k, p)
        max_err = max(max_err, got["max_abs_err"])
        say("kernel_vs_plain", objs=100, chains=cfg.n_chains, steps=steps, mode="PARITY",
            beta=kcfg.beta, adapt=kcfg.adapt, moves_per_step=kcfg.n_moves_per_step,
            accept_draws=kcfg.accept_draws, plain_call_ms=plain_call_ms[name], **got)
        if name == "block_hot" and got["chains_accepting"] < cfg.n_chains // 2:
            raise AssertionError(f"block_hot: only {got['chains_accepting']} chains accepted")

    # 5. main paths
    fused_counters = ((F.fused_mh_cuda, "launches"), (F.fused_chains_reference, "calls"))
    fused_launches = run_main_path("main_path", head, cfg, "cuda", fused_counters)
    fused_launches += run_main_path("main_path_block", head, block_cfg, None, fused_counters)

    # 6. pi
    pi_err = 0
    for seed, total in ((0, 1 << 28), (11, (1 << 28) - 12345)):
        got = P.pi_hits_cuda(seed, total, dev)
        want = P.pi_hits_reference(seed, total, dev)
        pi_err = max(pi_err, abs(got - want))
        if got != want:
            raise AssertionError(f"pi hits {got} != plain {want} at seed={seed} total={total}")
        say("pi_kernel_vs_plain", seed=seed, samples=total, hits=got, exact=True)
    P.pi_hits_cuda.launches = 0
    P.pi_hits_reference.calls = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["pi", "--fused", "--samples", str(1 << 32)])
    pi_launches, pi_plain = P.pi_hits_cuda.launches, P.pi_hits_reference.calls
    if rc or pi_launches < 1 or pi_plain:
        raise AssertionError(f"pi path: rc {rc}, {pi_launches} launches, {pi_plain} plain calls")
    line = out.getvalue().strip()
    est = float(line.split()[2])
    if abs(est - math.pi) >= 6 * sigma_pi(1 << 32) or f"({1 << 32} samples" not in line:
        raise AssertionError(f"pi path printed {line!r}")
    say("main_path_pi", command="python -m mh_tpu_torch pi --fused --samples 4294967296",
        printed=line, launches=pi_launches, plain_calls=pi_plain,
        error_in_sigmas=abs(est - math.pi) / sigma_pi(1 << 32))

    # 7. the command line in subprocesses
    env = {**os.environ, "PYTHONPATH": str(HERE)}
    for argv, check in (
        (["pi", "--fused", "--samples", str(1 << 26)], lambda s: "fused kernel" in s),
        (["suggest", "--objects", "32", "--chains", "64", "--iters", "50",
          "--moves-per-step", "4"],
         lambda s: len(json.loads(s)["accept_rate"]) == 64
         and all(math.isfinite(v) for v in json.loads(s)["costs"]["total"])),
    ):
        proc = subprocess.run([sys.executable, "-m", "mh_tpu_torch", *argv], cwd=HERE, env=env,
                              capture_output=True, text=True, timeout=300)
        if proc.returncode or not check(proc.stdout):
            raise AssertionError(f"{argv}: rc {proc.returncode}\n{proc.stdout[-2000:]}"
                                 f"\n{proc.stderr[-4000:]}")
        say("cli", argv=argv, rc=proc.returncode, stdout_bytes=len(proc.stdout))

    # 8. time (CUDA events; slope over step or sample counts, minimum of repeats)
    def fused_time(kpk, ksteps, psteps, repeats):
        kt = [events_ms(lambda s=s: F.fused_mh_cuda(kpk, pose0, 0, s), repeats) for s in ksteps]
        pt = [events_ms(lambda s=s: F.fused_chains_reference(kpk, pose0, 0, s), 2)
              for s in psteps]
        return slope(ksteps, kt), slope(psteps, pt), kt, pt

    ks, ps_ = (10, 505, 1010), (5, 15, 25)
    k_step, p_step, kt, pt = fused_time(pk, ks, ps_, 5)
    call_ms = events_ms(lambda: F.fused_mh_cuda(pk, pose0, 0, cfg.iterations), 5)
    say("time", card=smi, objs=100, chains=cfg.n_chains, moves_per_step=1, accept_draws=1,
        kernel_ms_per_step=k_step, kernel_proposals_per_s=cfg.n_chains / (k_step * 1e-3),
        plain_ms_per_step=p_step, plain_proposals_per_s=cfg.n_chains / (p_step * 1e-3),
        kernel_ms=dict(zip(map(str, ks), kt)), plain_ms=dict(zip(map(str, ps_), pt)),
        kernel_call_ms=call_ms, plain_call_ms=plain_call_ms["single"])

    bks, bps = (10, 255, 505), (2, 4, 6)
    bk_step, bp_step, bkt, bpt = fused_time(block_pk, bks, bps, 3)
    proposals = block_cfg.n_moves_per_step * block_cfg.n_chains  # bench.py:220
    say("time", card=smi, objs=100, chains=block_cfg.n_chains, **BLOCK,
        kernel_ms_per_step=bk_step, kernel_proposals_per_s=proposals / (bk_step * 1e-3),
        plain_ms_per_step=bp_step, plain_proposals_per_s=proposals / (bp_step * 1e-3),
        kernel_ms=dict(zip(map(str, bks), bkt)), plain_ms=dict(zip(map(str, bps), bpt)),
        plain_call_ms_100_steps=plain_call_ms["block"])

    pks, pps = (1 << 32, 1 << 33, 1 << 34), (1 << 26, 1 << 27, 1 << 28)
    pkt = [events_ms(lambda n=n: P.pi_hits_cuda(0, n, dev), 3) for n in pks]
    ppt = [events_ms(lambda n=n: P.pi_hits_reference(0, n, dev), 2) for n in pps]
    pi_ms = events_ms(lambda: P.pi_hits_cuda(0, 1 << 32, dev), 3)
    pi_plain_ms = events_ms(lambda: P.pi_hits_reference(0, 1 << 32, dev), 1)
    say("time", card=smi, kernel="pi_kernel",
        kernel_samples_per_s=1e3 / slope(pks, pkt), plain_samples_per_s=1e3 / slope(pps, ppt),
        kernel_ms=dict(zip(map(str, pks), pkt)), plain_ms=dict(zip(map(str, pps), ppt)),
        kernel_ms_2_32=pi_ms, plain_ms_2_32=pi_plain_ms)

    if "jax" in sys.modules or "mh_tpu" in sys.modules:
        raise AssertionError("the port imported JAX or mh_tpu")
    print(json.dumps({"kernels": [{
        "name": "fused_mh",
        "route": "cuda",
        "source": "mh_tpu_torch/kernels/csrc/fused_mh.cu",
        "replaces": "mh_tpu/kernels/fused_mh.py:405",
        "launches": fused_launches,
        "max_abs_err": max_err,
        "ms": call_ms,
        "plain_ms": plain_call_ms["single"],
    }, {
        "name": "pi_kernel",
        "route": "cuda",
        "source": "mh_tpu_torch/kernels/csrc/pi_kernel.cu",
        "replaces": "mh_tpu/kernels/pi_kernel.py:28",
        "launches": pi_launches,
        "max_abs_err": pi_err,
        "ms": pi_ms,
        "plain_ms": pi_plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
