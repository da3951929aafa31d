"""Run the mh_tpu_torch paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--phases kernel_vs_plain,time,...]

With no argument every phase runs and the last two lines are the kernels
line and the device line. ``--phases`` runs device, build and the named
phases only (for short calls), and prints the device line but not the
kernels line. Phases (each prints JSON lines; any failure raises and exits
non-zero):

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
   move), and the single move at beta=1e-3 with adaptation (100 x 1024 x
   1000), in PARITY and in weighted FIXED (``w_offlimits=-1.5``, the
   off-limits slab state); then the symmetry and off-limits states' edge
   cases at 64 chains x 50 steps: 37 objects (PARITY, weighted FIXED, (4,
   4)), frozen objects, -0.0 in the start pose (one move; (4, 4) in PARITY
   and weighted FIXED), 256 and 512 objects (PARITY and weighted FIXED),
   and weighted FIXED at 100 objects with (4, 4) (the cells updated per
   step of four moves). Both versions sum in one order and round every
   operation alike: the pose, breakdown, accept count and step scale must
   be bitwise equal in every chain;
5. main_path: ``suggest_layouts(demo_scene(100), SamplerConfig(
   iterations=1000, n_chains=1024), key=0, device="cuda")``;
   main_path_fixed: the same with ``w_offlimits=-1.5`` and
   ``mode=FIXED`` (the off-limits slab state); and main_path_block: the
   same scene with ``n_moves_per_step=64, accept_draws=64`` over 500 steps
   and no ``device`` (a SceneSpec runs on CUDA by default). On a host with
   several cards each call spans every card (one shard a card where they
   divide the chains). Each must go through the CUDA kernel (one launch per
   shard, plain version not called; each row prints its card and shard
   counts and launches), give finite costs, a mean accept rate
   in (0, 1), breakdowns that match ``cost_terms`` on every final pose
   (rtol=2e-4, atol=2e-3), and the same bits when run again;
6. pi: the pi kernel's hit counts equal the plain version's exactly at
   2^28 samples and at a count that is not a whole number of tiles; the
   plain ``estimate_pi(0, 2^22)`` (the threefry stream) on the card must
   equal the same call on the CPU exactly; then
   main_path_pi: ``python -m mh_tpu_torch pi --fused --samples 2^32`` run
   in this process through ``cli.main`` must launch the kernel, not call
   the plain version, and land within 6 sigma of pi;
7. cli: ``python -m mh_tpu_torch pi --fused`` and ``suggest
   --moves-per-step 4`` in subprocesses;
8. prng: the torch engine's threefry stream (``sampler/prng.py``) gives the
   same bits on the card as on the CPU: keys, fold_in with data >= 2^31,
   uniforms of the engine's shapes, K = 64 accept draws, bounded draws;
9. torch_engine_vs_cpu: ``run_chains`` at ``demo_scene(32)``, 64 chains, 50
   steps on CUDA against the same call on the CPU, in PARITY, FIXED,
   weighted FIXED and (M, K) = (4, 4). The uniforms are equal (integer
   stream); CUDA's transcendentals differ by ulps, so a chain whose accept
   ratio lands within an ulp of its uniform may part: at most 2 of the 64
   chains (every run so far read 0), the rest with equal accept counts,
   poses within 1e-4 and costs within rtol=2e-4 / atol=2e-3; then a start
   pose whose x and rotation columns are -0.0 through ``run_chains`` (one
   move and (M, K) = (4, 4)) and ``run_chains_incremental`` (8 column
   groups), held the same way, where every coordinate of the agreeing
   chains that is zero on either device must be zero on both with the
   same sign bit;
10. main_path_torch: ``suggest_layouts(demo_scene(100), SamplerConfig(
   iterations=1000, n_chains=1024), key=0, engine="torch", device="cuda")``,
   then ``engine="torch_graph"`` (a CUDA graph, bitwise equal to torch),
   ``log_every=100`` on both engines (bitwise equal to one shot, 10
   ``round`` events), the block layout (M = K = 64) over 50 steps on both
   engines (bitwise equal; also at beta=1e-3 with adaptation, where the
   chains accept), a rerun (same bits), breakdowns against ``cost_terms``
   on every final pose, and ``engine="auto"`` on CUDA, which must launch
   the fused kernel, and past the kernel's limit (121 accept draws) must
   take ``torch_graph`` with no kernel launch;
11. tempering_smc: BASELINE config 5 at ``bench.py:330-378``'s sizes
   (``demo_scene(32)``, 64 replicas, ``exchange_every=5``, 24 rounds, with
   and without ``adapt_ladder``; SMC with 64 particles, 8 stages, 5 mutate
   steps, with and without ``adaptive``) on CUDA against the CPU (at most
   1 of 24 rounds' swap rates may differ), and ``python -m mh_tpu_torch
   temper`` / ``smc`` in subprocesses;
12. sharded: chains over a mesh of 4 shards on card 0 (and, on a host
   with more cards, ``every_card``: one shard per card): ``suggest_layouts(demo_scene(100),
   1024 chains, 1000 steps, engine="fused", mesh=...)`` in PARITY, weighted
   FIXED and (M, K) = (64, 64) must launch the kernel once per shard, call
   no plain version and equal one launch on card 0 (a one-shard mesh) bit
   for bit in every chain; ``run_chains_sharded`` (100 objects x 1024 chains x 20 steps)
   against ``run_chains`` prints the chains that differ in any bit;
   ``run_chains_collective`` (10 rounds of 10 steps), tempering (with and
   without ``adapt_ladder``) and SMC poses (with and without ``adaptive``)
   at phase 11's sizes must equal one shard bit for bit, SMC's ESS and
   log-evidence within rtol 1e-6; and ``suggest_layouts(demo_scene(4096),
   4 chains, 10 steps, objs_devices=4)`` (past the kernel's object limit;
   one objs shard per card where the cards divide by 4, else 4 of card 0)
   in PARITY and in weighted FIXED must accept as the unsharded torch
   engine on card 0, with poses within 1e-4 and totals matching ``cost_terms``; each
   row prints its card count and ms per call (the row-sharded rows also ms
   per step, the difference of 10 and 2 steps);
13. multiprocess: worker processes (``chip_smoke.py --worker
   multiprocess ...``) join one process group and run every program on
   meshes over all their shards. Layout ``cuda0_2x2``: 2 processes with 2
   shards of card 0 each, on ``gloo``, asked for (two processes name one
   card, which NCCL refuses; the phase prints why); on a host with 2 or
   more cards ``card_each_2x2``, 2 processes with 2 shards of a card each,
   and with 4 or more ``card_each_4x1``, 4 processes with one card each,
   both on ``nccl``. The fused kernel at 100 objects x 1024 chains x 1000
   steps in PARITY and weighted FIXED must launch once per shard in each
   process, call no plain version and, gathered, equal one launch bit for
   bit in every chain; the torch engine (20 steps), the collective runner,
   tempering (with and without ``adapt_ladder``) and SMC (with and without
   ``adaptive``) at phase sharded's sizes must equal its in-process
   4-shard mesh bit for bit; and the row-sharded objective,
   ``run_chains_objsharded`` at ``demo_scene(4096)``, 4 chains, 10 steps
   in PARITY and weighted FIXED, on a 1 x 4 (chains x objs) mesh whose objs
   shards live in different processes (``objsharded_objs_span``) and on a
   2 x 2 mesh whose chain rows do (``objsharded_chains_span``; under
   ``card_each_4x1`` both axes cross processes), must return each row
   bitwise alike from every process holding it and equal the same mesh
   shape on card 0 in this process bit for bit. Each row prints the
   backend, the workers' and the in-process CUDA-event ms per call, and
   for the row-sharded programs the ms per step of each process (the
   difference of 10 and 2 steps);
14. recovery: the torch engine at 100 objects x 1024 chains on the card
   runs 2 R rounds uninterrupted, and R rounds, a checkpoint and SIGKILL
   in another process, which a fresh process restores and runs R more: the
   sha256 of the pose and the accept counts must equal; then the same with
   2 processes of 2 shards each and per-process shard files; then the save
   and restore time of the 1024-chain state;
15. metrics: ``summarize_chains`` (ESS, split R-hat, mean, std) of the
   cost traces of 1024 chains x 1000 steps at 100 objects on the card
   against the CPU, within rtol 1e-4, with its CUDA-event time;
16. time: CUDA-event times, as the slope of the minimum over repeats
   against the step or sample count, for each kernel and its plain version,
   for the torch engine eager and as a CUDA graph beside the fused kernel
   (100 objects x 1024 chains, one move and M = 64, with the graph's
   capture cost on the host clock; and the serve comparison at smaller
   sizes), the kernel's objects sweep (32, 100, 256, 512 objects x 1024
   chains, one move, with shared memory and blocks per SM) in PARITY and in
   weighted FIXED, tempering sweeps/s and SMC wall time; and each kernel's
   bound: the fused call's operations over the f32 peak beside its bytes
   over the memory rate (PARITY, and weighted FIXED with the pairs each
   step's moved boxes change, counted from the run's own draws; beside it
   the slab state's own count), and pi's SASS instructions
   per sample (``cuobjdump -sass``) over the SMs' issue rate at their top
   clock;
17. profile: ``torch.profiler`` over 10 steps of the torch engine at 100
   objects x 1024 chains, one move and M = K = 64, eager and as a CUDA
   graph: kernels per step, device-busy share of the wall time, top
   kernels;
18. gradient: the gradient samplers (RW-MH, MALA, HMC, NUTS, mean-field
   VI) on the layout log-density, FIXED with positive weights, beta 2;
   they launch no hand-written kernel (their gradients are autograd's).
   First ``demo_scene(32)`` x 64 chains on CUDA against the CPU (RW and
   MALA 40 draws, HMC 20 and NUTS 10 at max_depth 5, both at the start
   step size with no warmup, whose unstable first steps make the step
   size chaotic; VI 50 steps):
   at most 2 of 64 chains may part (accept count, depth or a sample more
   than 1e-4 away), the VI trace within rtol 1e-3; the dual-averaging
   update from the same inputs must be bitwise on both devices, and one
   adapting HMC and one adapting NUTS transition from the same state
   (draw 4, a nonzero ``h_avg``) must give equal accepts and depths and
   the dual-averaging fields within rtol 1e-4; then ``demo_scene(100)``
   (D = 300) x 1024 chains on the card: RW and MALA 200 draws, HMC 50 + 50
   with 8 leapfrog steps, NUTS max_depth 6 at 10 + 10, VI 500 steps with 8
   draws each. Samples and log-probabilities must be finite, RW, MALA and
   HMC must accept at a mean rate in (0, 1), MALA, HMC and NUTS must end
   with a best log-probability at or above the start's, and VI's ELBO must
   rise. It prints the CUDA-event ms per gradient evaluation, per forward
   and per normal draw of the chains' momenta at 100 x 1024, the ms per
   draw of each sampler and NUTS's mean depth;
19. native: the native C ABI (``mh_tpu_torch/native/``), ``g++`` building
   ``libmh_tpu_torch.so`` and the port's two C hosts from this checkout,
   then the library loaded in this process with ``ctypes.CDLL``:
   ``MHKernelWrapper`` on the wire structs of ``demo_scene(100)``, 1024
   chains, 1000 steps, seed 0, in PARITY with one move and in weighted
   FIXED (``w_offlimits=-1.5``), and the reference's ``KernelWrapper``
   with ``gridxDim=1024``, ``blockxDim=64`` (M = K = 64), ``iterations=
   1000`` under ``MH_TPU_SEED=0``: each call must launch the fused kernel
   once, call no plain version, and give points, costs and (for
   ``MHKernelWrapper``) accept rates bitwise equal, as float32, to
   ``suggest_layouts(..., key=0, device="cuda")`` called directly; it
   prints the warm wall ms of the ABI call and of the direct call (least
   of 3, in turns, beside the bridge's ``run_wire`` called from Python)
   and the kernel's CUDA-event ms. Then the two C hosts
   run as processes on the card (``MH_TPU_TORCH_DEVICE`` unset) and must
   exit 0 with their success lines; it prints each one's wall time;
20. examples: ``python -m mh_tpu_torch.examples.demo_layout``,
   ``huge_scene`` (1024 objects on 4 row shards) and ``advanced_sampling``
   at small sizes, each a process on the card that must exit 0 and print
   its results;
21. incremental (run after item 10): ``run_chains_incremental(key 0,
   demo_scene(100), 1024 chains, PARITY, n_groups=10)`` over 200 steps on
   the card (the exact delta-cost chain; no hand-written kernel, as
   ``mh_tpu``'s is an XLA scan): the carried val matrix, group maxima and
   total must equal a fresh ``full_val_matrix`` / ``_group_max`` /
   ``_cheap_total`` of the final poses bit for bit, the totals match
   ``cost_terms`` (rtol=2e-4, atol=2e-3) and the cost trace ends on them;
   chains 0-7 run again on the CPU must draw the same keys and uniforms
   bit for bit, and at most 2 of them may part (accept count, or a pose
   more than 1e-4 away; the count is printed). It prints ms per step (the
   slope of CUDA-event time over 50 and 250 steps) beside the torch
   engine's eager step timed the same way, kernels per step and the
   device-busy share from ``torch.profiler`` (10 steps), and the peak
   memory the run allocates.

Three phases run only when named: ``slab_width`` (weighted FIXED by slab
width), ``kernel_variants`` (the off-limits update against the rows
from scratch by object count, and the phase-profile build's cycles per
warp and step phase) and ``gradient_warmup`` (the chains HMC and NUTS
part between the card and the CPU after 0, 2, 5 and 20 warmup draws).

Then one JSON line describing the kernels and, last, the device line.
Without a CUDA device, or without the package beside this script, it
exits non-zero before printing any result. ``--worker ...`` runs one
process of phases multiprocess and recovery; the phases start these
themselves, each with a timeout, and a worker that fails ends the others.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
RTOL, ATOL = 2e-4, 2e-3
# CUDA against the CPU on one integer stream: every chip run so far read 0
# of 64 chains parting and 0 of 24 tempering rounds differing (PERF.md), so
# a chain may part only where an ulp of logf/expf/cosf flips an accept
POSE_ATOL, MAX_DIVERGENT_CHAINS, MAX_ROUNDS_DIFFERING = 1e-4, 2, 1
COMPOUND_CASES = ((4, 1), (4, 4), (1, 16), (1, 30))  # (moves per step, accept draws)
BLOCK = dict(n_moves_per_step=64, accept_draws=64)  # BASELINE config 3, layout_block
BLOCK_4X4 = dict(n_moves_per_step=4, accept_draws=4)
SWEEP_OBJECTS = (32, 100, 256, 512)
PHASES = ("rng", "kernel_vs_plain", "main_path", "pi", "cli", "prng", "torch_engine_vs_cpu",
          "main_path_torch", "incremental", "tempering_smc", "sharded", "multiprocess", "recovery", "metrics",
          "time", "profile", "gradient", "native", "examples")
# named only: weighted FIXED ms/step by slab width (the kernel takes the
# width at launch), the measurement behind fused_mh.off_slab_width; the
# MH kernel's variant builds (kernel_variants below); and the chains HMC
# and NUTS part between the card and the CPU by warmup length
OPTIONAL_PHASES = ("slab_width", "kernel_variants", "gradient_warmup")
WIDTHS = {100: (8, 16, 32), 256: (16, 32, 64), 512: (32, 64, 128)}
# the step phases of csrc/fused_mh.cu's MH_PHASE_PROFILE build, in order
STEP_PHASES = ("move", "barrier_1", "lanes", "partials_entities", "off_update", "barrier_2",
               "rescans", "off_rows", "barrier_3", "reduce_draw", "barrier_4", "accept_commit")
# bounds (NVIDIA's H100 SXM data sheet, at 700 W): float32 outside the tensor
# cores, device memory, and the issue rate of four warp-instructions a clock
# on each SM
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
ISSUE_THREAD_INSTR_PER_SM_CLOCK = 4 * 32
# operations the fused kernel's function needs, a square root counted as one:
# one sym_val (2 sub, 2 mul, add, 2 sqrt, sub, compare, select, sub, mul, abs,
# the mask test), one object's per-object terms (focal, balance, outside area,
# clearances), and one object's share of each reduced row (an add); one
# off-limits pair overlap (the later object's box: 4 adds; the overlap: 2
# max, 2 min, 2 compares, 2 sub, a multiply; the mask multiply and the add)
SYM_VAL_OPS, OBJECT_OPS, OVERLAP_OPS = 14, 60, 15
# runs across processes: each worker has its own timeout, and a worker
# that fails ends the others (no worker waits on a dead peer)
WORKER_TIMEOUT_S = 300
RECOVERY_ROUNDS, RECOVERY_ITERS = 3, 10  # R rounds before the kill, R after
# the in-process 4-shard runs of phase sharded that phase multiprocess
# repeats across 2 processes x 2 shards (BASELINE config 4 and 5's sizes)
TORCH_STEPS, COLLECTIVE_ROUNDS = 20, (10, 10)
TEMPER = dict(n_replicas=64, exchange_every=5, rounds=24)
SMC = dict(n_particles=64, n_stages=8, mutate_steps=5)
# the row-sharded objective past the kernel's object limit (phases sharded
# and multiprocess): objects, chains, steps, and the short run whose time
# is taken off to give ms per step
HUGE_OBJS, HUGE_CHAINS, HUGE_STEPS, HUGE_SHORT = 4096, 4, 10, 2
# phase incremental: objects, chains, column groups (100 / 10 = 10 a group;
# the default 8 does not divide 100) and steps
INCREMENTAL = (100, 1024, 10, 200)
# phase multiprocess's row-sharded programs and their (chains x objs) mesh
# over the global shards: the objs axis across processes, the chains axis
# across processes (the other programs take the 1-D chains mesh)
OBJ_MESHES = {"objsharded_objs_span": (1, 4), "objsharded_chains_span": (2, 2)}


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn(jobs, env, timeout: float = WORKER_TIMEOUT_S):
    """Run ``python3 chip_smoke.py --worker <args>`` for each ``(args,
    ends_ok)`` of ``jobs`` at once; ``ends_ok(rc)`` says which exit codes a
    job may end with. As soon as one ends otherwise, or the timeout runs
    out, every other is killed. Returns ``[(rc, stdout, stderr)]``; raises
    on a timeout."""
    with tempfile.TemporaryDirectory() as tmp:
        logs = [(open(os.path.join(tmp, f"{i}.out"), "w+"), open(os.path.join(tmp, f"{i}.err"), "w+"))
                for i in range(len(jobs))]
        procs = [subprocess.Popen([sys.executable, str(HERE / "chip_smoke.py"), "--worker", *args],
                                  stdout=out, stderr=err, env=env, cwd=HERE)
                 for (args, _), (out, err) in zip(jobs, logs)]
        deadline = time.monotonic() + timeout
        timed_out = False
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode is not None and not ok(p.returncode)
                       for p, (_, ok) in zip(procs, jobs)):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        results = []
        for p, (out, err) in zip(procs, logs):
            out.seek(0)
            err.seek(0)
            results.append((p.returncode, out.read(), err.read()))
            out.close()
            err.close()
    for (args, ok), (rc, so, se) in zip(jobs, results):
        if timed_out or not ok(rc):
            raise AssertionError(f"worker {args} ended with {rc}"
                                 f"{' at the timeout' if timed_out else ''}:\n{so[-2000:]}\n"
                                 f"{se[-4000:]}")
    return results


def worker_result(out: str) -> dict:
    """The ``RESULT`` line a worker printed."""
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def state_fields(s) -> dict:
    """An MHState's tensors by name (costs as one [C, 8] vector)."""
    return {"pose": s.pose, "costs": s.costs.as_vector(), "key": s.key, "step": s.step,
            "n_accept": s.n_accept, "log_scale": s.log_scale}


def runs_across_processes(dev) -> dict:
    """The programs phase multiprocess compares, by name, as zero-argument
    callables of a mesh, each returning its tensors by name in this
    process (chains leading); ``dev`` the device of the scenes."""
    import dataclasses as dc

    from mh_tpu_torch import CostMode, SamplerConfig, demo_scene
    import torch

    from mh_tpu_torch.kernels import fused_mh as F
    from mh_tpu_torch.parallel.objshard import chain_rows, run_chains_objsharded
    from mh_tpu_torch.parallel.sharded import run_chains_collective, run_chains_sharded
    from mh_tpu_torch.sampler import prng
    from mh_tpu_torch.sampler.smc import run_smc
    from mh_tpu_torch.sampler.tempering import run_tempered

    head = demo_scene(100)
    fixed_head = dc.replace(head, w_offlimits=-1.5)
    cfg = SamplerConfig(iterations=1000, n_chains=1024)
    fixed_cfg = dc.replace(cfg, mode=CostMode.FIXED)
    scene, fixed_scene = head.build(device=dev), fixed_head.build(device=dev)
    pose100 = head.initial_pose(device=dev)
    spec32 = demo_scene(32)
    pose32, scene32 = spec32.initial_pose(device=dev), spec32.build(device=dev)
    key = prng.key(0, dev)
    tcfg = SamplerConfig()

    def fused(kscene, kcfg):
        def run(mesh):
            out = F.run_chains_fused_sharded(0, pose100, kscene, kcfg, kcfg.n_chains,
                                             kcfg.iterations, mesh)
            return dict(zip(("pose", "breakdown", "n_accept", "step_scale"), out))
        return run

    def torch_engine(mesh):
        return state_fields(run_chains_sharded(
            key, pose100, scene, SamplerConfig(iterations=TORCH_STEPS, n_chains=1024), mesh))

    def collective(mesh):
        s, rates, log_scale = run_chains_collective(
            key, pose100, scene,
            SamplerConfig(iterations=0, n_chains=1024, adapt_rate=0.3, target_accept=0.3), mesh,
            *COLLECTIVE_ROUNDS)
        return {**state_fields(s), "rates": rates, "shared_log_scale": log_scale}

    def tempering(adapt):
        def run(mesh):
            out = run_tempered(key, pose32, scene32, tcfg, mesh, adapt_ladder=adapt, **TEMPER)
            return {**state_fields(out[0]), "swap_rates": out[1],
                    **({"betas": out[2]} if adapt else {})}
        return run

    def smc(adaptive):
        def run(mesh):
            s, diag = run_smc(key, pose32, scene32, tcfg, mesh, adaptive=adaptive, **SMC)
            return {**state_fields(s), **diag}
        return run

    huge = demo_scene(HUGE_OBJS)
    huge_pose = huge.initial_pose(device=dev)
    huge_scenes = {"parity": (huge.build(device=dev), CostMode.PARITY),
                   "fixed_weighted": (dc.replace(huge, w_offlimits=-1.5).build(device=dev),
                                      CostMode.FIXED)}

    def objsharded(variant):
        hscene, mode = huge_scenes[variant]

        def run(mesh, steps=HUGE_STEPS):
            s = run_chains_objsharded(key, huge_pose, hscene, SamplerConfig(
                iterations=steps, n_chains=HUGE_CHAINS, mode=mode), mesh)
            return {**state_fields(s), "rows": torch.tensor(chain_rows(mesh))}
        return run

    return {"fused_parity": fused(scene, cfg), "fused_fixed_weighted": fused(fixed_scene, fixed_cfg),
            "torch": torch_engine, "collective": collective,
            "tempering": tempering(False), "tempering_adapted": tempering(True),
            "smc": smc(False), "smc_adaptive": smc(True),
            **{f"{m}_{v}": objsharded(v) for m in OBJ_MESHES for v in huge_scenes}}


def obj_mesh_of(name: str):
    """The ``OBJ_MESHES`` entry of a row-sharded program, else None."""
    return next((m for m in OBJ_MESHES if name.startswith(m)), None)


def rows_once(got: dict) -> tuple[dict, int]:
    """A row-sharded program's gathered outputs with each chain row once, in
    row order, and the number of rows more than one process returned: every
    copy of a row must be bitwise equal to the first."""
    import torch

    rows = got["rows"].tolist()
    per_row = len(got["pose"]) // len(rows)
    seen, shared = {}, set()
    for j, r in enumerate(rows):
        block = {k: v[j * per_row:(j + 1) * per_row] for k, v in got.items() if k != "rows"}
        if r in seen:
            shared.add(r)
            if not all(same_bits(v, seen[r][k]) for k, v in block.items()):
                raise AssertionError(f"two processes' copies of chain row {r} differ")
        else:
            seen[r] = block
    order = sorted(seen)
    if order != list(range(len(order))):
        raise AssertionError(f"gathered chain rows {rows}")
    return ({k: torch.cat([seen[r][k] for r in order]) for k in seen[order[0]]}
            | {"rows": torch.tensor(order)}, len(shared))


# what of each program's output is this process's rows (gathered across
# processes) rather than a value every process holds
SCALAR_OUTPUTS = {"rates", "shared_log_scale", "swap_rates", "betas", "log_evidence", "ess", "resampled"}


def multiprocess_worker(pid: int, nproc: int, port: int, out: str, backend: str,
                        devices: str) -> None:
    """One process of phase multiprocess: joins the group, runs every
    program on the global mesh of ``devices`` (this process's shards),
    gathers each program's rows and prints what it counted and timed;
    process 0 saves the gathered tensors to ``out``."""
    import torch

    from mh_tpu_torch import SamplerConfig, demo_scene
    from mh_tpu_torch.kernels import fused_mh as F
    from mh_tpu_torch.parallel.multihost import global_chain_mesh, initialize, process_allgather
    from mh_tpu_torch.parallel.objshard import chain_obj_mesh
    from mh_tpu_torch.sampler import prng
    from mh_tpu_torch.sampler.mh import run_chains

    chosen = initialize(f"127.0.0.1:{port}", nproc, pid, backend=backend)
    mesh = global_chain_mesh(devices.split(","))
    # every process builds the meshes in one order (the device lists are exchanged)
    obj_meshes = {m: chain_obj_mesh(*shape, devices=devices.split(","))
                  for m, shape in OBJ_MESHES.items()}
    dev = mesh.axis_devices("chains")[0]
    res = {"backend": chosen[0], "reason": chosen[1], "shards": mesh.axis_shards("chains"),
           "devices": [str(d) for d in mesh.axis_devices("chains")], "programs": {},
           "obj_mesh_processes": {m: om.processes.tolist() for m, om in obj_meshes.items()}}
    # untimed and uncounted: load the kernel library and the engine's CUDA
    # modules, so that no program's time holds the process's first launch
    warm = demo_scene(100)
    run_chains(prng.key(0, dev), warm.initial_pose(device=dev), warm.build(device=dev),
               SamplerConfig(iterations=2, n_chains=2))
    F.run_chains_fused(0, warm.initial_pose(device=dev), warm.build(device=dev),
                       SamplerConfig(), 2, 2)
    torch.cuda.synchronize()
    gathered = {}
    for name, run in runs_across_processes(dev).items():
        huge = obj_mesh_of(name) is not None
        pmesh = obj_meshes[obj_mesh_of(name)] if huge else mesh
        if huge:  # a short run first too: it takes the warm-up
            short_ms = timed(lambda: run(pmesh, HUGE_SHORT))[1]
        F.fused_mh_cuda.launches = F.fused_chains_reference.calls = 0
        got, ms = timed(lambda: run(pmesh))
        res["programs"][name] = dict(call_ms=ms, launches=F.fused_mh_cuda.launches,
                                     plain_calls=F.fused_chains_reference.calls)
        if huge:
            short_ms = min(short_ms, timed(lambda: run(pmesh, HUGE_SHORT))[1])
            res["programs"][name].update(
                short_call_ms=short_ms, rows=got["rows"].tolist(),
                ms_per_step=(ms - short_ms) / (HUGE_STEPS - HUGE_SHORT))
        gathered[name] = {k: (v if k in SCALAR_OUTPUTS else process_allgather(v)).cpu()
                          for k, v in got.items()}
    if "jax" in sys.modules or "mh_tpu" in sys.modules:
        raise AssertionError("a worker imported JAX or mh_tpu")
    if pid == 0:
        torch.save(gathered, out)
    print("RESULT " + json.dumps(res), flush=True)
    torch.distributed.destroy_process_group()


def recovery_worker(mode: str, path: str, dist_args: list[str]) -> None:
    """One process of phase recovery, the torch engine on the card at 100
    objects x 1024 chains: ``full`` runs 2 R rounds, ``crash`` R rounds,
    checkpoints and SIGKILLs itself, ``resume`` restores and runs R more;
    with ``<pid> <nproc> <port>`` over 2 shards of card 0 per process,
    each process saving and restoring only its own rows."""
    import hashlib
    import signal

    import numpy as np
    import torch

    from mh_tpu_torch import SamplerConfig, demo_scene
    from mh_tpu_torch.parallel.multihost import global_chain_mesh, initialize, process_allgather
    from mh_tpu_torch.parallel.sharded import continue_chains_sharded, run_chains_sharded
    from mh_tpu_torch.sampler import prng
    from mh_tpu_torch.sampler.mh import continue_chains, run_chains
    from mh_tpu_torch.utils import checkpoint as ckpt

    dev = torch.device("cuda", 0)
    distributed = bool(dist_args)
    pid = int(dist_args[0]) if distributed else 0
    if distributed:
        initialize(f"127.0.0.1:{dist_args[2]}", int(dist_args[1]), pid)
        mesh = global_chain_mesh([dev] * 2)
    spec = demo_scene(100)
    scene, pose0 = spec.build(device=dev), spec.initial_pose(device=dev)
    key = prng.key(42, dev)
    cfg = SamplerConfig(iterations=RECOVERY_ITERS, n_chains=1024)

    def first_round():
        if distributed:
            return run_chains_sharded(key, pose0, scene, cfg, mesh)
        return run_chains(key, pose0, scene, cfg)[0]

    def next_round(states):
        if distributed:
            return continue_chains_sharded(states, scene, cfg, mesh)
        return continue_chains(states, scene, cfg)

    def report(states):
        if distributed:
            states = states.map(process_allgather)
        if pid == 0:
            print("RESULT " + json.dumps({
                "pose_sha": hashlib.sha256(states.pose.cpu().numpy().tobytes()).hexdigest(),
                "n_accept_sha": hashlib.sha256(
                    np.ascontiguousarray(states.n_accept.cpu().numpy()).tobytes()).hexdigest(),
                "steps": sorted(set(states.step.cpu().tolist())),
                "chains_accepting": int((states.n_accept > 0).sum())}), flush=True)

    if mode == "full":
        states = first_round()
        for _ in range(2 * RECOVERY_ROUNDS - 1):
            states = next_round(states)
        report(states)
    elif mode == "crash":
        states = first_round()
        for _ in range(RECOVERY_ROUNDS - 1):
            states = next_round(states)
        if distributed:
            ckpt.save_local_shards(path, states)
            torch.distributed.barrier()  # every file written before any process dies
        else:
            ckpt.save_state(path, states)
        print("CHECKPOINTED", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)
    else:
        template = first_round()  # structure, shapes and dtypes; values replaced
        states = (ckpt.restore_local_shards(path, template) if distributed
                  else ckpt.restore_state(path, template))
        for _ in range(RECOVERY_ROUNDS):
            states = next_round(states)
        report(states)
    if "jax" in sys.modules or "mh_tpu" in sys.modules:
        raise AssertionError("a worker imported JAX or mh_tpu")
    if distributed:
        torch.distributed.destroy_process_group()


def worker_main(args: list[str]) -> int:
    """``--worker multiprocess <pid> <nproc> <port> <out> <backend> <devices>``
    or ``--worker recovery <mode> <path> [<pid> <nproc> <port>]``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke worker: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    if args[0] == "multiprocess":
        pid, nproc, port = map(int, args[1:4])
        multiprocess_worker(pid, nproc, port, *args[4:7])
    elif args[0] == "recovery" and args[1] in ("full", "crash", "resume"):
        recovery_worker(args[1], args[2], args[3:])
    else:
        raise SystemExit(f"unknown worker {args}")
    return 0


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


def states_agree(name: str, got, want, costs=lambda s: s.costs.as_vector(),
                 zero_signs: bool = False) -> dict:
    """A CUDA run of the torch engine (or of the incremental chains, with
    ``costs=lambda s: s.total[:, None]``) against the same run on the CPU.

    At most MAX_DIVERGENT_CHAINS chains may part; the rest have equal
    accept counts, poses within POSE_ATOL and costs within RTOL / ATOL.
    With ``zero_signs``, every pose coordinate of those chains that is zero
    on either device is zero on both, with the same sign bit. Returns the
    fields a comparison line prints."""
    import torch

    gp, wp = got.pose.cpu(), want.pose.cpu()
    gap = (gp - wp).abs().flatten(1).amax(1)
    acc_differs = got.n_accept.cpu() != want.n_accept.cpu()
    same = ~acc_differs & (gap <= POSE_ATOL)
    n_div = int((~same).sum())
    if n_div > MAX_DIVERGENT_CHAINS:
        raise AssertionError(f"{name}: {n_div} of {len(same)} chains part from the CPU run")
    gc, wc = costs(got).cpu(), costs(want).cpu()
    torch.testing.assert_close(gc[same], wc[same], rtol=RTOL, atol=ATOL)
    out = dict(chains=len(same), accept_counts_differ=int(acc_differs.sum()),
               divergent_chains=n_div, max_pose_gap=gap.max().item(),
               max_pose_gap_agreeing=gap[same].max().item() if bool(same.any()) else 0.0,
               max_cost_gap_agreeing=(gc[same] - wc[same]).abs().max().item()
               if bool(same.any()) else 0.0,
               chains_accepting=int((got.n_accept > 0).sum()))
    if zero_signs:
        g, w = gp[same], wp[same]
        zero = (g == 0) | (w == 0)
        if not (bool((g[zero] == 0).all()) and bool((w[zero] == 0).all()) and
                torch.equal(torch.signbit(g[zero]), torch.signbit(w[zero]))):
            raise AssertionError(f"{name}: zero coordinates or their signs differ from the CPU's")
        out.update(zeros=int(zero.sum()), negative_zeros=int(torch.signbit(w[zero]).sum()),
                   zero_signs_equal=True)
    return out


def same_bits(a, b) -> bool:
    """Two LayoutResults (or numpy arrays) equal bit for bit."""
    import numpy as np

    if hasattr(a, "points"):
        return all(same_bits(getattr(a, f), getattr(b, f))
                   for f in ("points", "costs", "accept_rate", "step_scale"))
    return np.asarray(a).tobytes() == np.asarray(b).tobytes()


def _chains_differing(pairs, n: int) -> int:
    """Chains whose rows differ in any bit across ``pairs`` of arrays or
    tensors with the chains leading."""
    import numpy as np

    differ = np.zeros(n, bool)
    for a, b in pairs:
        a, b = (np.ascontiguousarray(t.cpu().numpy() if hasattr(t, "cpu") else t) for t in (a, b))
        differ |= (a.view(np.uint8).reshape(n, -1) != b.view(np.uint8).reshape(n, -1)).any(1)
    return int(differ.sum())


def layout_chains_differing(a, b) -> int:
    """Chains of two LayoutResults that differ in any bit."""
    return _chains_differing([(getattr(a, f), getattr(b, f))
                              for f in ("points", "costs", "accept_rate", "step_scale")],
                             len(a.points))


def state_chains_differing(a, b) -> int:
    """Chains of two MHStates that differ in any bit."""
    return _chains_differing([(a.pose, b.pose), (a.costs.as_vector(), b.costs.as_vector()),
                              (a.n_accept, b.n_accept), (a.log_scale, b.log_scale)],
                             a.pose.shape[0])


def profile_run(run, steps: int) -> dict:
    """``torch.profiler`` over ``run()``, which takes ``steps`` steps: kernels
    per step, device-busy share of the wall time, and the top kernels by
    device time (per step, milliseconds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name[:70], (0, 0.0))
        by_name[e.name[:70]] = (n + 1, t + e.device_time_total / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    return dict(steps=steps, wall_ms=wall_ms, kernels_per_step=len(kernels) / steps,
                device_busy_ms=busy_ms, device_busy_share=busy_ms / wall_ms,
                top=[(k, n / steps, t / steps) for k, (n, t) in top])


def profile_steps(scene, pose0, cfg, graph: bool, steps: int) -> dict:
    """:func:`profile_run` over ``steps`` steps of the torch engine (eager,
    or replayed as a CUDA graph), after two unprofiled steps."""
    from mh_tpu_torch.sampler import mh as M
    from mh_tpu_torch.sampler import prng

    step = M.ChainStep(scene, cfg)
    advance = M.step_advance(step, graph)
    state = advance(step.init(*M.chain_starts(prng.key(0, scene.device), pose0, scene,
                                              cfg.n_chains)), 2)
    return profile_run(lambda: advance(state, steps), steps)


def incremental_phase(smi: str) -> None:
    """Phase incremental (docstring item 21): the incremental-symmetry
    chains at full width on the card."""
    import torch

    from mh_tpu_torch import CostMode, SamplerConfig, cost_terms, demo_scene
    from mh_tpu_torch.sampler import incremental as I
    from mh_tpu_torch.sampler import mh as M
    from mh_tpu_torch.sampler import prng

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    n, chains, groups, steps = INCREMENTAL
    spec = demo_scene(n)
    scene, pose0, key = spec.build(device=dev), spec.initial_pose(device=dev), prng.key(0, dev)
    cfg = SamplerConfig(iterations=steps, n_chains=chains)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    state, trace = I.run_chains_incremental(key, pose0, scene, cfg, n_groups=groups,
                                            trace_costs=True)
    peak = torch.cuda.max_memory_allocated(dev) - base

    # the carried state equals a fresh evaluation of the final poses, bit for bit
    fresh = I.full_val_matrix(state.pose, scene, CostMode.PARITY.pi)
    gmax = I._group_max(fresh, groups)
    total = I._cheap_total(state.pose, scene, CostMode.PARITY, I._sym_from_gmax(gmax, scene))
    for name, carried, want in (("a_mat", state.a_mat, fresh), ("gmax", state.gmax, gmax),
                                ("total", state.total, total)):
        if not torch.equal(carried.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"incremental: the carried {name} differs from a fresh "
                                 "evaluation")
    if not (torch.isfinite(trace).all() and torch.equal(trace[:, -1], state.total)):
        raise AssertionError("incremental: the cost trace is not finite or ends elsewhere")
    acc = float((state.n_accept.float() / steps).mean())
    accepting = int((state.n_accept > 0).sum())
    if not 0.0 < acc < 1.0 or accepting < chains // 2:
        raise AssertionError(f"incremental: mean accept rate {acc}, {accepting} chains accepting")
    ref = cost_terms(state.pose, scene, CostMode.PARITY).total
    torch.testing.assert_close(state.total, ref, rtol=RTOL, atol=ATOL)

    # chains 0-7 again on the CPU: the same keys and uniforms, poses within POSE_ATOL
    few = 8
    cstate, _ = I.run_chains_incremental(prng.key(0), spec.initial_pose(), spec.build(),
                                         dataclasses.replace(cfg, n_chains=few), n_groups=groups)
    at = torch.arange(steps)

    def draws(keys):
        step_keys = prng.fold_in(keys[:, None], at.to(keys.device))
        return prng.uniform(prng.split(step_keys)[..., 0, :], (8,)).cpu()

    if not (torch.equal(state.key[:few].cpu(), cstate.key) and
            torch.equal(draws(state.key[:few]).view(torch.int32),
                        draws(cstate.key).view(torch.int32))):
        raise AssertionError("incremental: keys or uniforms differ between the card and the CPU")
    gap = (state.pose[:few].cpu() - cstate.pose).abs().flatten(1).amax(1)
    parted = (state.n_accept[:few].cpu() != cstate.n_accept) | (gap > POSE_ATOL)
    if int(parted.sum()) > MAX_DIVERGENT_CHAINS:
        raise AssertionError(f"incremental: {int(parted.sum())} of {few} chains part from the CPU")

    # ms per step: the slope over step counts, beside the torch engine's eager step
    counts = (50, 250)

    def inc(k):
        return I.run_chains_incremental(key, pose0, scene, dataclasses.replace(cfg, iterations=k),
                                        n_groups=groups)

    def eager(k):
        return M.run_chains(key, pose0, scene, dataclasses.replace(cfg, iterations=k))

    it = [events_ms(lambda k=k: inc(k), 2) for k in counts]
    et = [events_ms(lambda k=k: eager(k), 2) for k in counts]
    def ten_steps():
        s = state
        for _ in range(10):
            s = I.inc_step(s, scene, cfg, groups)

    I.inc_step(state, scene, cfg, groups)  # warm-up
    prof = profile_run(ten_steps, 10)
    inc_ms, torch_ms = slope(counts, it), slope(counts, et)
    say("incremental", card=smi, objs=n, chains=chains, n_groups=groups, steps=steps,
        state_equals_fresh_bitwise=True, mean_accept=acc, chains_accepting=accepting,
        total_vs_cost_terms_max_abs=(state.total - ref).abs().max().item(),
        cpu_chains=few, cpu_keys_and_uniforms_bitwise=True, cpu_chains_parted=int(parted.sum()),
        cpu_max_pose_gap=gap.max().item(), ms_per_step=inc_ms,
        proposals_per_s=chains / (inc_ms * 1e-3), torch_eager_ms_per_step=torch_ms,
        ratio_to_torch_eager=inc_ms / torch_ms, inc_ms=dict(zip(map(str, counts), it)),
        torch_ms=dict(zip(map(str, counts), et)), peak_memory_bytes=peak,
        state_bytes=sum(t.numel() * t.element_size() for t in (state.a_mat, state.gmax)),
        kernels_per_step=prof["kernels_per_step"], device_busy_share=prof["device_busy_share"],
        profile_wall_ms_per_step=prof["wall_ms"] / 10, top_kernels=prof["top"])


def ptxas_registers(log: str, kernel: str):
    """Registers of ``kernel`` from nvcc's ``-Xptxas -v`` output (None if the
    library was not built in this process)."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and kernel in ln:
            for nxt in lines[i + 1:i + 4]:
                if "registers" in nxt:
                    return int(nxt.split("Used ")[1].split(" registers")[0])
    return None


def blocks_per_sm(registers, smem: int, threads: int = 128) -> int:
    """Resident blocks of the fused kernel on one H100 SM: the least of the
    register file (65,536), shared memory (228 KB, 1 KB of it reserved per
    block), 2,048 threads and 32 blocks."""
    by_regs = 65536 // (threads * registers) if registers else 32
    return min(by_regs, 233472 // (smem + 1024), 2048 // threads, 32)


def fused_bound(F, pk, seed: int, steps: int, n_chains: int, dev) -> dict:
    """The least time of one single-move fused call: the larger of its
    operations over the float32 peak and its bytes over the memory rate.

    Operations: each step's moved lanes, counted from this run's own draws
    (a translate or rotate moves one object, a swap of two objects two),
    each matched against every reflection and its own reflection against
    every candidate (2 N sym_val) and its per-object terms rescored; every
    object's share of the reduced rows; and the full match and terms of the
    first and the final evaluation. With the off-limits term in the loop
    (weighted FIXED) also the pairs it changes: each moved box (a
    translate's, both of a swap of two; a rotation moves none) against
    every other object, each pair's overlap added into its row, and the
    N (N - 1) / 2 pairs of the first and the final evaluation. Bytes: the
    poses in and out, the stats and the packed scene, each once.

    Beside it, ``scheme_*``: what the kernel's slab state computes for the
    same steps (where it keeps the state) -- the pair overlaps of every cell
    a moved box invalidates (the rows of its slab, its column in the later
    slabs) and each object's row over its slabs."""
    import torch

    lanes, unroll = F.step_layout(pk.accept_draws)
    n, rows = pk.n, 6 + pk.n_clr
    n_unf, n_objs = float(pk.scalars[F.S_NUNF]), float(pk.scalars[F.S_NOBJ])
    moved = torch.zeros((), dtype=torch.int64, device=dev)
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    scheme_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    if pk.track_off:
        # per slab: the pairs of its row (cell (s, i) pairs i with the j > i
        # of slab s: sum of j over the slab), its size, the objects after it
        slab = torch.arange(n, device=dev) // F.off_slab_width(n)
        s_count = F.off_slabs(n)
        row_pairs = torch.zeros(s_count, dtype=torch.int64, device=dev).index_add_(
            0, slab, torch.arange(n, device=dev))
        size = torch.bincount(slab, minlength=s_count)
        later = size.flip(0).cumsum(0).flip(0) - size
        unf = pk.unf_idx.long()
    for t in range(steps):
        if t % unroll == 0:
            blk = F.uniform_block(seed, t // unroll, 0, n_chains, dev)
        u = blk[:, lanes * (t % unroll):]
        kind = torch.clamp_max((u[:, 0] * 3.0).to(torch.int32), 2)
        k1 = torch.clamp_max(torch.floor(u[:, 6] * n_unf), max(n_unf - 1.0, 0.0))
        k2 = torch.clamp_max(torch.floor(u[:, 7] * n_unf), max(n_unf - 1.0, 0.0))
        if n_unf > 0:
            swap = (kind == 2) & (k1 != k2) & (n_objs >= 2)
            moved += (kind < 2).sum() + 2 * swap.sum()
            if pk.track_off:
                pairs += (kind == 0).sum() * (n - 1) + swap.sum() * (2 * n - 3)
                sa, sb = slab[unf[k1.long()]], slab[unf[k2.long()]]
                one = (kind == 0) * (row_pairs[sa] + later[sa])
                two = swap * (row_pairs[sa] + (sb != sa) * row_pairs[sb]
                              + later[sa] - (sb > sa) * size[sb]
                              + later[sb] - (sa > sb) * size[sa])
                scheme_pairs += (one + two).sum()
    moved, pairs, scheme_pairs = int(moved), int(pairs), int(scheme_pairs)
    ops = (moved * (2 * n * SYM_VAL_OPS + OBJECT_OPS) + steps * n_chains * n * rows
           + 2 * n_chains * (n * n * SYM_VAL_OPS + n * (OBJECT_OPS + rows)))
    extra = {}
    if pk.track_off:
        ends = 2 * n_chains * (n * (n - 1) // 2) * OVERLAP_OPS
        row_adds = int((F.off_slabs(n) - slab).sum()) + 2 * n
        extra = dict(off_pairs_per_step=pairs / (steps * n_chains),
                     scheme_operations=ops + scheme_pairs * OVERLAP_OPS
                     + steps * n_chains * row_adds + ends,
                     scheme_off_pairs_per_step=scheme_pairs / (steps * n_chains))
        ops += pairs * OVERLAP_OPS + ends
    scene_bytes = sum(4 * t.numel() for t in (pk.planes, pk.unf_idx, pk.scalars, pk.rel_idx,
                                              pk.rel_p, pk.ang_idx, pk.ang_p, pk.clr_idx,
                                              pk.clr_p))
    nbytes = 2 * 4 * n_chains * n * 6 + 4 * n_chains * 10 + scene_bytes
    t_ops, t_bytes = ops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S
    if extra:
        extra["scheme_bound_ms"] = max(extra["scheme_operations"] / F32_PEAK_FLOPS, t_bytes) * 1e3
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                operations=ops, bytes=nbytes, moved_lanes_per_step=moved / (steps * n_chains),
                **extra)


def sass_per_sample(lib: Path, kernel: str) -> dict:
    """SASS instructions per sample of ``kernel``'s hot loop, read with
    ``cuobjdump -sass`` from the built library: the backward branch whose
    body holds the most float compares (one per sample), its instruction
    count over that number."""
    import re

    from mh_tpu_torch.kernels import _build

    tool = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    section = next(s for s in sass.split("Function : ")[1:] if kernel in s.splitlines()[0])
    addrs, ops, labels, pending = [], [], {}, []
    for ln in section.splitlines():
        lab = re.match(r"\s*(\.L_x_\d+):", ln)
        if lab:
            pending.append(lab.group(1))
            continue
        ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if ins:
            addrs.append(int(ins.group(1), 16))
            ops.append(ins.group(2))
            for name in pending:
                labels[name] = addrs[-1]
            pending = []
    best = None
    for a, op in zip(addrs, ops):
        br = re.search(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", op)
        if not br:
            continue
        target = labels.get(br.group(1)) if br.group(1) else int(br.group(2), 16)
        if target is None or target > a:
            continue
        body = [o for b, o in zip(addrs, ops) if target <= b <= a]
        samples = sum(1 for o in body if re.search(r"\bFSETP", o))
        if samples and (best is None or (samples, len(body)) > (best[0], best[1])):
            best = (samples, len(body))
    if best is None:
        raise AssertionError(f"no sample loop found in the SASS of {kernel}")
    return dict(loop_instructions=best[1], samples_per_iteration=best[0],
                instructions_per_sample=best[1] / best[0])


# the example's proper layout target: FIXED mode, positive weights
# (examples/advanced_sampling.py:104-110), at beta 2
SANE_WEIGHTS = dict(w_pairwise=2.0, w_visual_balance=1.0, w_focal=2.0, w_symmetry=2.0,
                    w_clearance=2.0, w_offlimits=1.0, w_surface_area=2.0)


def gradient_target(n: int, d):
    """The layout log-density of ``demo_scene(n)`` on device ``d`` (FIXED,
    positive weights, beta 2) and its start ``theta``."""
    from mh_tpu_torch import CostMode, demo_scene
    from mh_tpu_torch.sampler import generic as G

    spec = dataclasses.replace(demo_scene(n), **SANE_WEIGHTS)
    pose0 = spec.initial_pose(device=d)
    fn = G.layout_logdensity(spec.build(device=d), pose0, 2.0, CostMode.FIXED)
    return fn, G.theta_from_pose(pose0)


def gradient_runs(chains: int, cuts: dict) -> dict:
    """Sampler name -> (call on a log-density, start and device; number of
    draws). ``cuts``: RW and MALA draws, HMC (warmup, draws), NUTS
    (max_depth, warmup, draws)."""
    from mh_tpu_torch.sampler import hmc_sample, mala_sample, nuts_sample, prng, rw_metropolis

    return {
        "rw": (lambda fn, t, d: rw_metropolis(prng.key(1), fn, t, cuts["rw"], chains,
                                              step_size=0.02, device=d), cuts["rw"]),
        "mala": (lambda fn, t, d: mala_sample(prng.key(2), fn, t, cuts["mala"], chains,
                                              step_size=0.02, device=d), cuts["mala"]),
        "hmc": (lambda fn, t, d: hmc_sample(prng.key(3), fn, t, cuts["hmc"][1], cuts["hmc"][0],
                                            n_leapfrog=8, step_size=0.01, n_chains=chains,
                                            device=d), sum(cuts["hmc"])),
        "nuts": (lambda fn, t, d: nuts_sample(prng.key(4), fn, t, cuts["nuts"][2],
                                              cuts["nuts"][1], max_depth=cuts["nuts"][0],
                                              step_size=0.01, n_chains=chains, device=d),
                 sum(cuts["nuts"][1:])),
    }


def chains_parted_vs_cpu(call, fns, dev):
    """Run ``call`` on the card and on the CPU (``fns``: the target on
    each): the chains whose accept count (NUTS: summed depth) or any sample
    differs by more than POSE_ATOL, and each chain's largest gap."""
    import numpy as np
    import torch

    out = []
    for d, (fn, theta0) in zip((dev, torch.device("cpu")), fns):
        samples, final = call(fn, theta0, d)
        count = final.sum_depth if hasattr(final, "sum_depth") else final.n_accept
        out.append((samples.cpu().numpy(), count.cpu().numpy()))
    gap = np.abs(out[0][0] - out[1][0]).max(axis=(1, 2))
    return (gap > POSE_ATOL) | (out[0][1] != out[1][1]), gap


def gradient_warmup_phase(dev, smi: str) -> None:
    """Phase gradient_warmup (named only; checks nothing): the chains HMC
    and NUTS part between the card and the CPU at 32 objects x 64 chains
    after 0, 2, 5 and 20 warmup draws, the measurement behind phase
    gradient comparing whole runs without warmup."""
    import torch

    fns = [gradient_target(32, d) for d in (dev, torch.device("cpu"))]
    for w in (0, 2, 5, 20):
        cut = dict(rw=0, mala=0, hmc=(w, 20), nuts=(5, w, 10))
        for name in ("hmc", "nuts"):
            call, draws = gradient_runs(64, cut)[name]
            parted, _ = chains_parted_vs_cpu(call, fns, dev)
            say("gradient_warmup", sampler=name, objs=32, chains=64, warmup=w, draws=draws,
                chains_parted=int(parted.sum()), card=smi)


def gradient_phase(dev, smi: str) -> None:
    """Phase gradient (docstring item 18): the gradient samplers on the
    card against the CPU at 32 objects x 64 chains, then at full width on
    the card."""
    import numpy as np
    import torch

    from mh_tpu_torch.sampler import generic as G
    from mh_tpu_torch.sampler import meanfield_vi, prng
    from mh_tpu_torch.sampler.hmc import dual_averaging, hmc_state_from_numpy, hmc_step
    from mh_tpu_torch.sampler.nuts import nuts_state_from_numpy, nuts_step

    cpu = torch.device("cpu")
    # card against the CPU: the same draws, the CPU's transcendentals and
    # sums round apart by ulps, so a chain may part where an ulp flips an
    # accept or a U-turn. HMC and NUTS run at the start step size with no
    # warmup: the warmup's first steps try step sizes up to 10x the start,
    # where the leapfrog is unstable, and feed the chaotic energy error
    # back into the step size (PERF.md, PR 9). One adapting transition
    # from a shared state below holds the step-size update itself.
    fns = [gradient_target(32, d) for d in (dev, cpu)]
    small = dict(rw=40, mala=40, hmc=(0, 20), nuts=(5, 0, 10))
    for name, (call, draws) in gradient_runs(64, small).items():
        parted, gap = chains_parted_vs_cpu(call, fns, dev)
        say("gradient", case=f"{name}_vs_cpu", objs=32, chains=64, draws=draws,
            chains_parted=int(parted.sum()), max_gap_kept=float(gap[~parted].max(initial=0.0)))
        if parted.sum() > MAX_DIVERGENT_CHAINS:
            raise AssertionError(f"gradient {name}: {int(parted.sum())} of 64 chains part "
                                 "between CUDA and the CPU")

    # dual averaging on the card against the CPU: the update alone, from
    # the same inputs, is bitwise (each multiply-add rounded once through
    # float64); then one adapting HMC and NUTS transition (draw 4, h_avg in
    # [0.3, 0.6]) from the same bits on both devices. There the energies
    # are float32 sums near -720, whose ulp is 6e-5, and the devices sum in
    # other orders, so an accept probability may differ by ~1e-4 and the
    # update carries it into log_eps times sqrt(5) eta / gamma = 3: the
    # dual-averaging fields are held within rtol 1e-4 (a wrong update
    # moves log_eps by O(1)), accepts and depths equal
    rng = np.random.default_rng(9)
    probs = np.concatenate([rng.uniform(0.0, 1.0, 62), [0.0, 1.0]]).astype(np.float32)
    avg, h = rng.normal(-4.0, 1.0, 64), rng.uniform(-0.6, 0.6, 64)
    upd = [[t.cpu() for t in dual_averaging(
        4, *(torch.as_tensor(a, dtype=torch.float32, device=d) for a in (probs, avg, h)),
        0.8, 10.0, 0.05, 0.75)] for d in (dev, cpu)]
    if not all(torch.equal(a, b) for a, b in zip(*upd)):
        raise AssertionError("gradient: dual_averaging differs between CUDA and the CPU")
    fn_cpu, theta_cpu = fns[1]
    theta = theta_cpu.numpy() + rng.normal(0.0, 0.02, (64, theta_cpu.numel()))
    theta = theta.astype(np.float32)
    lp, grad = G.value_and_grad(fn_cpu, torch.from_numpy(theta))
    zeros = np.zeros(64, np.int32)
    fields = dict(theta=theta, logprob=lp.numpy(), grad=grad.numpy(),
                  log_eps=np.full(64, np.log(np.float32(0.01)), np.float32),
                  log_eps_avg=np.full(64, np.log(np.float32(0.012)), np.float32),
                  h_avg=rng.uniform(0.3, 0.6, 64).astype(np.float32))
    dual = ("log_eps", "log_eps_avg", "h_avg")
    for name, count in (("hmc", "n_accept"), ("nuts", "sum_depth")):
        outs = []
        for d, (fn, _) in zip((dev, cpu), fns):
            keys = prng.fold_in(prng.key(8, d), torch.arange(64, device=d))
            if name == "hmc":
                st = hmc_state_from_numpy(dict(fields, n_accept=zeros), device=d)
                st = hmc_step(keys, st, fn, 8, 4, adapt=True)
            else:
                st = nuts_state_from_numpy(dict(fields, n_divergent=zeros, sum_depth=zeros),
                                           device=d)
                st = nuts_step(keys, st, fn, 5, 4, adapt=True)
            outs.append({k: getattr(st, k).cpu() for k in dual + (count,)})
        say("gradient", case=f"{name}_adapt_step_vs_cpu", objs=32, chains=64, step=4,
            **{f"max_rel_gap_{k}": float(((outs[0][k] - outs[1][k]).abs()
                                          / outs[1][k].abs()).max()) for k in dual},
            **{f"mean_{count}": float(outs[0][count].float().mean())})
        for k in dual:
            torch.testing.assert_close(outs[0][k], outs[1][k], rtol=1e-4, atol=0.0)
        if not torch.equal(outs[0][count], outs[1][count]):
            raise AssertionError(f"gradient {name}: the adapting transition's {count} "
                                 "differs between CUDA and the CPU")

    vi = [[t.cpu() for t in meanfield_vi(prng.key(5), fn, theta0, n_steps=50, device=d)]
          for d, (fn, theta0) in zip((dev, cpu), fns)]
    for a, b in zip(*vi):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)
    say("gradient", case="vi_vs_cpu", objs=32, steps=50,
        max_rel_gap_trace=float(((vi[0][2] - vi[1][2]).abs() / vi[1][2].abs()).max()))

    # full width on the card: 100 objects (D = 300) x 1024 chains
    fn, theta0 = gradient_target(100, dev)
    chains = 1024
    start = theta0.expand(chains, -1).contiguous()
    lp0 = float(fn(theta0))
    grad_ms = events_ms(lambda: G.value_and_grad(fn, start), 5)
    fwd_ms = events_ms(lambda: fn(start), 5)
    keys = prng.fold_in(prng.key(7, dev), torch.arange(chains, device=dev))
    normal_ms = events_ms(lambda: prng.normal(keys, (int(theta0.numel()),)), 5)
    say("gradient", case="value_and_grad", objs=100, chains=chains, dim=int(theta0.numel()),
        grad_ms=grad_ms, forward_ms=fwd_ms, normal_ms=normal_ms, card=smi)
    full = dict(rw=200, mala=200, hmc=(50, 50), nuts=(6, 10, 10))
    for name, (call, draws) in gradient_runs(chains, full).items():
        (samples, final), ms = timed(lambda: call(fn, theta0, dev))
        if not (torch.isfinite(samples).all() and torch.isfinite(final.logprob).all()):
            raise AssertionError(f"gradient {name}: non-finite samples or log-probabilities")
        row = dict(case=name, objs=100, chains=chains, draws=draws, ms=ms, ms_per_draw=ms / draws,
                   start_logprob=lp0, best_logprob=float(final.logprob.max()),
                   mean_logprob=float(final.logprob.mean()))
        if name in ("rw", "mala", "hmc"):
            kept = full["hmc"][1] if name == "hmc" else draws
            rate = float(final.n_accept.float().mean()) / kept
            row["mean_accept"] = rate
            if not 0.0 < rate < 1.0:
                raise AssertionError(f"gradient {name}: mean accept rate {rate}")
        if name == "nuts":
            row["mean_depth"] = float(final.sum_depth.float().mean()) / full["nuts"][2]
            row["divergent"] = int(final.n_divergent.sum())
        if name != "rw" and row["best_logprob"] < lp0:
            raise AssertionError(f"gradient {name}: best log-probability {row['best_logprob']} "
                                 f"below the start's {lp0}")
        say("gradient", **row, card=smi)
    (mu, sigma, trace), ms = timed(lambda: meanfield_vi(prng.key(6), fn, theta0, n_steps=500,
                                                        n_mc=8, device=dev))
    trace = trace.cpu()
    first, last = float(trace[:50].mean()), float(trace[-50:].mean())
    if not (torch.isfinite(trace).all() and torch.isfinite(mu).all() and last > first):
        raise AssertionError(f"gradient vi: the ELBO went from {first} to {last}")
    say("gradient", case="vi", objs=100, steps=500, n_mc=8, ms=ms, ms_per_step=ms / 500,
        elbo_first_50=first, elbo_last_50=last, sigma_mean=float(sigma.mean()), card=smi)


# the port's C hosts and the line each prints on success
NATIVE_HOSTS = (("test_wrapper", "native ABI smoke test OK"),
                ("test_ref_compat", "reference-ABI drop-in test OK"))
# phase examples: (module, arguments, a line the run must print)
EXAMPLES = (
    ("demo_layout", ["--chains", "64", "--iters", "100", "--objects", "32"], "proposals in"),
    ("huge_scene", ["--objects", "1024", "--chains", "2", "--iters", "5", "--objs-devices", "4"],
     "proposals over a 1024x1024 objective"),
    ("advanced_sampling", ["--objects", "16", "--replicas", "16", "--draws", "4"],
     "ELBO: start"),
)


def wall(fn):
    """``(fn(), seconds)`` on the host clock, the card synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def native_phase(smi: str, counters, env: dict) -> int:
    """Phase native (item 19); returns the fused kernel's launches in the
    three ABI calls."""
    import numpy as np
    import torch

    from mh_tpu_torch import CostMode, SamplerConfig, demo_scene, suggest_layouts
    from mh_tpu_torch.kernels import fused_mh as F
    from mh_tpu_torch.native import _build as NB
    from mh_tpu_torch.native import abi, bridge

    built = NB.build()
    say("native", step="build", library=str(built.library.relative_to(HERE)),
        seconds=built.seconds)
    dev = torch.device("cuda")
    head = demo_scene(100)
    single = SamplerConfig(iterations=1000, n_chains=1024)
    fixed_head = dataclasses.replace(head, w_offlimits=-1.5)
    fixed = dataclasses.replace(single, mode=CostMode.FIXED)
    block = dataclasses.replace(single, **BLOCK)

    def mh_call(spec, cfg):
        wire = bridge.encode_wire(spec, cfg, 0)

        def call():
            rc, points, costs, accept = abi.mh_kernel_wrapper(wire)
            if rc:
                raise AssertionError(f"MHKernelWrapper returned {rc}")
            return points, costs, accept
        return call, wire

    def ref_call(spec, cfg):
        def call():
            out = abi.kernel_wrapper(spec, cfg.n_chains, cfg.n_moves_per_step, cfg.iterations)
            if out is None:
                raise AssertionError("KernelWrapper returned NULL")
            return out
        # what the shim hands MHKernelWrapper: the reference's block layout in PARITY
        return call, bridge.encode_wire(spec, cfg, 0)

    seed_was = os.environ.get("MH_TPU_SEED")
    os.environ["MH_TPU_SEED"] = "0"
    launches = 0
    try:
        for name, spec, cfg, (call, wire) in (
                ("MHKernelWrapper", head, single, mh_call(head, single)),
                ("MHKernelWrapper", fixed_head, fixed, mh_call(fixed_head, fixed)),
                ("KernelWrapper", head, block, ref_call(head, block))):
            for fn, attr in counters:
                setattr(fn, attr, 0)
            out = call()
            (kernel, _), (plain, _) = counters
            n_launch, n_plain = kernel.launches, plain.calls
            if n_launch != 1 or n_plain:
                raise AssertionError(f"{name}: {n_launch} kernel launches, {n_plain} plain calls")
            launches += n_launch

            def direct():
                return suggest_layouts(spec, cfg, key=0, device="cuda")

            want = direct()
            for field, got in zip(("points", "costs", "accept_rate"), out):
                g = np.asarray(got, np.float32)
                w = np.asarray(getattr(want, field), np.float32)
                if g.shape != w.shape or g.tobytes() != w.tobytes():
                    raise AssertionError(f"{name} ({cfg.mode.name}): {field} differ from "
                                         "the direct suggest_layouts call")
            # in turns: the C ABI, the direct call, and the bridge's run_wire
            # called from Python (the ABI call less its C side)
            abi_s, direct_s, bridge_s = [], [], []
            for _ in range(3):
                abi_s.append(wall(call)[1])
                direct_s.append(wall(direct)[1])
                bridge_s.append(wall(lambda: bridge.run_wire(*wire))[1])
            scene = spec.build(device=dev)
            pose0 = spec.initial_pose(device=dev).expand(cfg.n_chains, 100, 6).contiguous()
            pk = F.pack_scene(scene, cfg)
            kernel_ms = events_ms(lambda: F.fused_mh_cuda(pk, pose0, 0, cfg.iterations), 3)
            say("native", call=name, card=smi, objs=100, chains=cfg.n_chains,
                steps=cfg.iterations, mode=cfg.mode.name, w_offlimits=spec.w_offlimits,
                moves_per_step=cfg.n_moves_per_step, accept_draws=cfg.accept_draws,
                launches=n_launch, plain_calls=n_plain, bitwise_equal_direct=True,
                fields_compared=len(out), mean_accept=float(want.accept_rate.mean()),
                abi_wall_ms=min(abi_s) * 1e3, direct_wall_ms=min(direct_s) * 1e3,
                bridge_wall_ms=min(bridge_s) * 1e3,
                abi_minus_direct_ms=(min(abi_s) - min(direct_s)) * 1e3,
                kernel_event_ms=kernel_ms)
    finally:
        if seed_was is None:
            os.environ.pop("MH_TPU_SEED", None)
        else:
            os.environ["MH_TPU_SEED"] = seed_was

    host_env = {k: v for k, v in env.items() if k != bridge.DEVICE_ENV}
    for host, line in NATIVE_HOSTS:
        t0 = time.perf_counter()
        proc = subprocess.run([str(built.host(host))], cwd=HERE, env=host_env,
                              capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
        if proc.returncode or line not in proc.stdout:
            raise AssertionError(f"{host}: rc {proc.returncode}\n{proc.stdout[-2000:]}"
                                 f"\n{proc.stderr[-4000:]}")
        say("native", host=host, card=smi, rc=proc.returncode, wall_s=seconds,
            backend=proc.stdout.splitlines()[0] if host == "test_wrapper" else None,
            printed=line)
    return launches


def examples_phase(smi: str, env: dict) -> None:
    """Phase examples (item 20)."""
    for name, args, line in EXAMPLES:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"mh_tpu_torch.examples.{name}", *args],
                              cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
        seconds = time.perf_counter() - t0
        if proc.returncode or line not in proc.stdout:
            raise AssertionError(f"example {name}: rc {proc.returncode}\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        say("examples", example=name, argv=args, card=smi, rc=proc.returncode, wall_s=seconds,
            last_line=proc.stdout.strip().splitlines()[-1])


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
    # on a host with several cards the call spans them all where they divide
    # the chains, one launch per card
    cards = torch.cuda.device_count()
    shards = cards if cards > 1 and cfg.n_chains % cards == 0 else 1
    if launches != shards or plain_calls:
        raise AssertionError(f"{name}: {launches} kernel launches on {shards} shards, "
                             f"{plain_calls} plain calls")
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
        device="default" if device is None else device, cards=cards, shards=shards,
        launches=launches,
        plain_calls=plain_calls, mean_accept=acc, breakdown_vs_cost_terms_max_abs=self_err,
        mean_total=float(res.costs[:, 0].mean()), deterministic=True)
    return launches


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", help="comma-separated subset of: "
                    + ", ".join(PHASES + OPTIONAL_PHASES)
                    + " (device and build always run; default: all but "
                    + ", ".join(OPTIONAL_PHASES) + ", with the kernels line)")
    args = ap.parse_args(argv)
    phases = PHASES if args.phases is None else tuple(args.phases.split(","))
    if set(phases) - set(PHASES + OPTIONAL_PHASES):
        ap.error(f"unknown phases {sorted(set(phases) - set(PHASES + OPTIONAL_PHASES))}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import numpy as np

    import mh_tpu_torch
    from mh_tpu_torch import CostMode, SamplerConfig, cli, cost_terms, demo_scene, suggest_layouts
    from mh_tpu_torch.api import auto_engine
    from mh_tpu_torch.kernels import _build
    from mh_tpu_torch.kernels import fused_mh as F
    from mh_tpu_torch.kernels import pi_kernel as P
    from mh_tpu_torch.parallel.mesh import chain_mesh
    from mh_tpu_torch.parallel.sharded import run_chains_collective, run_chains_sharded
    from mh_tpu_torch.sampler import mh as M
    from mh_tpu_torch.sampler import prng
    from mh_tpu_torch.sampler.smc import run_smc
    from mh_tpu_torch.sampler.tempering import run_tempered

    if Path(mh_tpu_torch.__file__).resolve().parents[1] != HERE:
        raise SystemExit(f"mh_tpu_torch imported from {mh_tpu_torch.__file__}, not {HERE}")
    dev = torch.device("cuda")
    cpu = torch.device("cpu")
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
    fused_regs = ptxas_registers(log, "fused_mh_kernel")
    say("build", library=lib.name, seconds=seconds, fused_mh_registers=fused_regs,
        ptxas=[ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln])

    # what the phases share
    env = {**os.environ, "PYTHONPATH": str(HERE)}
    head = demo_scene(100)
    scene = head.build(device=dev)
    cfg = SamplerConfig(iterations=1000, n_chains=1024)
    block_cfg = SamplerConfig(iterations=500, n_chains=1024, **BLOCK)
    pose0 = head.initial_pose(device=dev).expand(cfg.n_chains, 100, 6).contiguous()
    pk = F.pack_scene(scene, cfg)
    block_pk = F.pack_scene(scene, block_cfg)
    # weighted FIXED: the off-limits term in the loop, through the slab state
    fixed_head = dataclasses.replace(head, w_offlimits=-1.5)
    fixed_scene = fixed_head.build(device=dev)
    fixed_cfg = dataclasses.replace(cfg, mode=CostMode.FIXED)
    fixed_pk = F.pack_scene(fixed_scene, fixed_cfg)
    spec32 = demo_scene(32)
    tcfg = SamplerConfig()
    key0 = prng.key(0, dev)
    pose100 = head.initial_pose(device=dev)
    fused_counters = ((F.fused_mh_cuda, "launches"), (F.fused_chains_reference, "calls"))
    all_counters = (*fused_counters, (P.pi_hits_cuda, "launches"), (P.pi_hits_reference, "calls"))

    def zero_counts():
        for fn, attr in all_counters:
            setattr(fn, attr, 0)

    def read_counts():
        return {f"{fn.__name__}.{attr}": getattr(fn, attr) for fn, attr in all_counters}

    def check_result(name, res, rcfg):
        if not (np.isfinite(res.costs).all() and np.isfinite(res.points).all()):
            raise AssertionError(f"{name} returned non-finite values")
        acc = float(res.accept_rate.mean())
        accepting = int((res.accept_rate > 0).sum())
        # the block layout at beta = 2 accepts ~3e-5 of its steps (PERF.md),
        # so only the other paths must show accepting chains
        if not 0.0 <= acc < 1.0 or (name.split("/")[0] != "block" and
                                     accepting < rcfg.n_chains // 2):
            raise AssertionError(f"{name}: mean accept rate {acc}, {accepting} chains accepting")
        err = check_self_consistent(torch.as_tensor(res.points, device=dev),
                                    torch.as_tensor(res.costs, device=dev), scene, rcfg.mode)
        return dict(mean_accept=acc, chains_accepting=accepting,
                    breakdown_vs_cost_terms_max_abs=err, mean_total=float(res.costs[:, 0].mean()))

    max_err, pi_err, plain_call_ms = 0.0, 0, {}
    fused_launches, fused_calls, pi_launches = 0, 0, 0
    # phase sharded's in-process 4-shard runs, which phase multiprocess
    # repeats across processes: name -> (outputs by name, CUDA-event ms)
    mesh4_runs = {}

    if "rng" in phases:
        # 3. rng
        for seed, counter, first in ((0, 0, 0), (7, 3, 40), (-5, 999, 1 << 20)):
            got = F.uniform_block_cuda(seed, counter, first, 1024, dev)
            want = F.uniform_block(seed, counter, first, 1024, dev)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise AssertionError(f"uniform bits differ at seed={seed} counter={counter}")
        say("rng", bits_equal=True)

    if "kernel_vs_plain" in phases:
        # 4. kernel vs plain version
        for mode, w_off in ((CostMode.PARITY, 0.0), (CostMode.FIXED, 0.0), (CostMode.FIXED, -1.5)):
            s32 = dataclasses.replace(spec32.build(device=dev),
                                      w_offlimits=torch.tensor(w_off, device=dev))
            p32 = spec32.initial_pose(device=dev).expand(64, 32, 6).contiguous()
            for moves, draws in ((1, 1), *COMPOUND_CASES):
                pk32 = F.pack_scene(s32, SamplerConfig(mode=mode, n_moves_per_step=moves,
                                                       accept_draws=draws))
                k = F.fused_mh_cuda(pk32, p32, 5, 50)
                p = F.fused_chains_reference(pk32, p32, 5, 50)
                got = compare(k, p)
                check_self_consistent(k[0], k[1], s32, mode)
                max_err = max(max_err, got["max_abs_err"])
                say("kernel_vs_plain", objs=32, chains=64, steps=50, mode=mode.name,
                    w_offlimits=w_off, moves_per_step=moves, accept_draws=draws, **got)

        # the paths where most chains accept, so the moves and commits are tested
        hot_cfg = dataclasses.replace(block_cfg, beta=1e-3, adapt=True)
        single_hot_cfg = dataclasses.replace(cfg, beta=1e-3, adapt=True)
        fixed_hot_cfg = dataclasses.replace(single_hot_cfg, mode=CostMode.FIXED)
        for name, kcfg, kscene, steps in (
                ("single", cfg, scene, cfg.iterations),
                ("single_hot", single_hot_cfg, scene, cfg.iterations),
                ("single_hot_fixed", fixed_hot_cfg, fixed_scene, cfg.iterations),
                ("block", block_cfg, scene, 100), ("block_hot", hot_cfg, scene, 100)):
            kpk = F.pack_scene(kscene, kcfg)
            k = F.fused_mh_cuda(kpk, pose0, 0, steps)
            p, plain_call_ms[name] = timed(lambda: F.fused_chains_reference(kpk, pose0, 0, steps))
            got = compare(k, p)
            max_err = max(max_err, got["max_abs_err"])
            say("kernel_vs_plain", objs=100, chains=cfg.n_chains, steps=steps, mode=kcfg.mode.name,
                w_offlimits=float(kscene.w_offlimits), beta=kcfg.beta, adapt=kcfg.adapt,
                moves_per_step=kcfg.n_moves_per_step, accept_draws=kcfg.accept_draws,
                plain_call_ms=plain_call_ms[name], **got)
            if "_hot" in name and got["chains_accepting"] < cfg.n_chains // 2:
                raise AssertionError(f"{name}: only {got['chains_accepting']} chains accepted")

        # the symmetry and off-limits states' edge cases: a ragged object
        # count, frozen objects, -0.0 in the start pose (a single move commits
        # it through every lane; a compound step applies its moves to every
        # lane), widths where the O(N) state pays most, and the off-limits
        # cells updated per step of four moves; the plain version's [C, N, N]
        # match stays small at 64 chains
        for case, n_objs, mode, w_off, moves, draws in (
                ("ragged", 37, CostMode.PARITY, 0.0, 1, 1),
                ("ragged", 37, CostMode.FIXED, -1.5, 1, 1),
                ("ragged", 37, CostMode.PARITY, 0.0, 4, 4),
                ("frozen", 32, CostMode.PARITY, 0.0, 1, 1),
                ("frozen", 32, CostMode.FIXED, -1.5, 4, 1),
                ("neg_zero", 32, CostMode.PARITY, 0.0, 1, 1),
                ("neg_zero", 32, CostMode.PARITY, 0.0, 4, 4),
                ("neg_zero", 32, CostMode.FIXED, -1.5, 4, 4),
                ("wide", 256, CostMode.PARITY, 0.0, 1, 1),
                ("wide", 512, CostMode.PARITY, 0.0, 1, 1),
                ("wide", 256, CostMode.FIXED, -1.5, 1, 1),
                ("wide", 512, CostMode.FIXED, -1.5, 1, 1),
                ("off_cells", 100, CostMode.FIXED, -1.5, 4, 4)):
            wspec = demo_scene(n_objs)
            if case == "frozen":
                wspec.frozen = np.arange(n_objs) % 3 == 0
            wscene = dataclasses.replace(wspec.build(device=dev),
                                         w_offlimits=torch.tensor(w_off, device=dev))
            wpose = wspec.initial_pose(device=dev).expand(64, n_objs, 6).clone()
            if case == "neg_zero":
                wpose[:, ::2, 2:] = -0.0
                wpose[:, 0, :2] = -0.0
            hot = case in ("neg_zero", "off_cells") or (case == "wide" and w_off != 0.0)
            wcfg = SamplerConfig(mode=mode, n_moves_per_step=moves, accept_draws=draws,
                                 beta=1e-3 if hot else 2.0)
            wpk = F.pack_scene(wscene, wcfg)
            got = compare(F.fused_mh_cuda(wpk, wpose, 5, 50),
                          F.fused_chains_reference(wpk, wpose, 5, 50))
            if not got["chains_accepting"]:
                raise AssertionError(f"{case}: no chain accepted")
            max_err = max(max_err, got["max_abs_err"])
            say("kernel_vs_plain", case=case, objs=n_objs, chains=64, steps=50, mode=mode.name,
                w_offlimits=w_off, beta=wcfg.beta, moves_per_step=moves, accept_draws=draws,
                sym_incremental=F.sym_incremental(moves, n_objs),
                off_incremental=wpk.track_off and F.off_incremental(moves, n_objs, wpk.n_clr),
                **got)

    if "main_path" in phases:
        # 5. main paths
        fused_launches += run_main_path("main_path", head, cfg, "cuda", fused_counters)
        fused_launches += run_main_path("main_path_fixed", fixed_head, fixed_cfg, "cuda",
                                        fused_counters)
        fused_launches += run_main_path("main_path_block", head, block_cfg, None, fused_counters)
        fused_calls += 3

    if "pi" in phases:
        # 6. pi
        for seed, total in ((0, 1 << 28), (11, (1 << 28) - 12345)):
            got = P.pi_hits_cuda(seed, total, dev)
            want = P.pi_hits_reference(seed, total, dev)
            pi_err = max(pi_err, abs(got - want))
            if got != want:
                raise AssertionError(f"pi hits {got} != plain {want} at seed={seed} total={total}")
            say("pi_kernel_vs_plain", seed=seed, samples=total, hits=got, exact=True)
        # the plain estimator draws the threefry stream: the card's estimate
        # is the CPU's
        plain_card, plain_card_ms = timed(lambda: mh_tpu_torch.estimate_pi(0, 1 << 22))
        plain_cpu = mh_tpu_torch.estimate_pi(0, 1 << 22, device="cpu")
        if plain_card != plain_cpu:
            raise AssertionError(f"estimate_pi on the card {plain_card} != the CPU's {plain_cpu}")
        say("pi_plain_card_vs_cpu", seed=0, samples=1 << 22, card=plain_card, cpu=plain_cpu,
            equal=True, card_call_ms=plain_card_ms)
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

    if "cli" in phases:
        # 7. the command line in subprocesses
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

    if "prng" in phases:
        # 8. prng: the torch engine's threefry stream on the card against the CPU
        def prng_draws(d):
            out = []
            for seed in (0, 7, -1, 2**31 + 5):
                k = prng.key(seed, d)
                chains = prng.fold_in(k, torch.arange(1024, device=d))
                steps = prng.fold_in(chains, torch.arange(1024, device=d) * 4099 + 2**31)
                lo, hi = torch.tensor(-3.0, device=d), torch.tensor(7.5, device=d)
                out += [prng.split(k, 5), chains, steps, prng.uniform(steps, (1, 8)),
                        prng.uniform(steps, (64, 8)), prng.uniform(prng.fold_in(steps, 1), (64,)),
                        prng.uniform(chains, (100,), lo, hi), prng.uniform(chains, (100,), 0.0, 6.2832)]
            return out

        n_draws = 0
        for g, w in zip(prng_draws(dev), prng_draws(cpu)):
            g = g.cpu()
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            if not torch.equal(g, w):
                raise AssertionError("threefry bits differ between CUDA and the CPU")
            n_draws += g.numel()
        say("prng", values_compared=n_draws, bits_equal=True)

    if "torch_engine_vs_cpu" in phases:
        # 9. the torch chain engine on CUDA against the same call on the CPU
        for case, mode, w_off, kw in (("parity", CostMode.PARITY, 0.0, {}),
                                      ("fixed", CostMode.FIXED, 0.0, {}),
                                      ("fixed_weighted", CostMode.FIXED, -1.5, {}),
                                      ("block_4x4", CostMode.PARITY, 0.0, BLOCK_4X4)):
            ecfg = SamplerConfig(iterations=50, n_chains=64, mode=mode, **kw)
            runs = {}
            for d in (dev, cpu):
                sc = dataclasses.replace(spec32.build(device=d), w_offlimits=torch.tensor(w_off, device=d))
                runs[d.type], _ = M.run_chains(prng.key(5, d), spec32.initial_pose(device=d), sc, ecfg)
            say("torch_engine_vs_cpu", case=case, objs=32, steps=50,
                **states_agree(case, runs["cuda"], runs["cpu"]))
        # a start pose holding -0.0: every zero keeps the CPU's sign bit
        from mh_tpu_torch.sampler.incremental import run_chains_incremental
        ecfg = SamplerConfig(iterations=50, n_chains=64)
        for case, run, kw in (
                ("neg_zero", M.run_chains, {}),
                ("neg_zero_block_4x4", M.run_chains, {}),
                ("neg_zero_incremental", run_chains_incremental, dict(n_groups=8))):
            rcfg = dataclasses.replace(ecfg, **BLOCK_4X4) if "block" in case else ecfg
            runs = {}
            for d in (dev, cpu):
                start = spec32.initial_pose(device=d).clone()
                start[:, [0, 4]] = -0.0
                runs[d.type], _ = run(prng.key(5, d), start, spec32.build(device=d), rcfg, **kw)
            costs = (lambda s: s.total[:, None]) if "incremental" in case else \
                (lambda s: s.costs.as_vector())
            say("torch_engine_vs_cpu", case=case, objs=32, steps=50,
                **states_agree(case, runs["cuda"], runs["cpu"], costs, zero_signs=True))

    if "main_path_torch" in phases:
        # 10. the torch engine's main path at full width, and auto on CUDA
        block50 = SamplerConfig(iterations=50, n_chains=1024, **BLOCK)
        torch_runs = {}
        for name, rcfg in (("single", cfg), ("block", block50),
                           ("block_hot", dataclasses.replace(block50, beta=1e-3, adapt=True))):
            for engine in ("torch", "torch_graph"):
                zero_counts()
                res, secs = wall(lambda: suggest_layouts(head, rcfg, key=0, engine=engine,
                                                         device="cuda"))
                counts = read_counts()
                if any(counts.values()):
                    raise AssertionError(f"the {engine} engine launched a kernel: {counts}")
                torch_runs[name, engine] = res
                say("main_path_torch", path=name, engine=engine, objs=100, chains=rcfg.n_chains,
                    steps=rcfg.iterations, moves_per_step=rcfg.n_moves_per_step,
                    accept_draws=rcfg.accept_draws, wall_s=secs, **counts,
                    **check_result(f"{name}/{engine}", res, rcfg))
            if not same_bits(torch_runs[name, "torch"], torch_runs[name, "torch_graph"]):
                raise AssertionError(f"{name}: torch_graph differs from torch")
        again = suggest_layouts(head, cfg, key=0, engine="torch", device="cuda")
        if not same_bits(again, torch_runs["single", "torch"]):
            raise AssertionError("a rerun differs from the one-shot torch run")
        for engine in ("torch", "torch_graph"):
            log = io.StringIO()
            logged = suggest_layouts(head, cfg, key=0, engine=engine, device="cuda", log=log,
                                     log_every=100)
            events = [json.loads(line)["event"] for line in log.getvalue().splitlines()]
            if not same_bits(logged, torch_runs["single", "torch"]):
                raise AssertionError(f"a logged {engine} run differs from the one-shot torch run")
            if events.count("round") != 10 or events[0] != "run_config" or events[-1] != "result":
                raise AssertionError(f"logged {engine} run events {events}")
        n_clr = int((scene.clr_mask > 0).sum())
        chosen = auto_engine(dev, cfg, scene.n_pad_objs, n_clr, F.tracks_off(scene, cfg))
        zero_counts()
        auto_res = suggest_layouts(head, cfg, key=0, device="cuda")
        auto_counts = read_counts()
        if chosen != "fused" or auto_counts["fused_mh_cuda.launches"] < 1 or \
                auto_counts["fused_chains_reference.calls"]:
            raise AssertionError(f"auto chose {chosen}: {auto_counts}")
        fused_launches += auto_counts["fused_mh_cuda.launches"]
        fused_calls += 1
        # past the kernel's limit of 120 accept draws auto takes the CUDA graph
        wide = SamplerConfig(iterations=20, n_chains=1024, accept_draws=121)
        wide_chosen = auto_engine(dev, wide, scene.n_pad_objs, n_clr, F.tracks_off(scene, wide))
        zero_counts()
        wide_res = suggest_layouts(head, wide, key=0, device="cuda")
        wide_counts = read_counts()
        if wide_chosen != "torch_graph" or any(wide_counts.values()) or not same_bits(
                wide_res, suggest_layouts(head, wide, key=0, engine="torch", device="cuda")):
            raise AssertionError(f"auto past the kernel's limit chose {wide_chosen}: {wide_counts}")
        say("main_path_torch", graph_equals_eager_bitwise=True, rerun_bitwise=True,
            logged_equals_one_shot_bitwise=True, round_events=events.count("round"),
            auto_engine=chosen, auto_counts=auto_counts,
            auto_mean_accept=float(auto_res.accept_rate.mean()),
            auto_engine_121_draws=wide_chosen, auto_121_draws_equals_torch_bitwise=True,
            auto_121_draws_mean_accept=float(wide_res.accept_rate.mean()))

    if "incremental" in phases:
        # 21. the incremental-symmetry chains at 100 x 1024
        incremental_phase(smi)

    if "tempering_smc" in phases:
        # 11. tempering and SMC (BASELINE config 5, bench.py:330-378) on CUDA vs the CPU
        for adapt in (False, True):
            outs = {d.type: run_tempered(prng.key(0, d), spec32.initial_pose(device=d),
                                         spec32.build(device=d), tcfg, None, 64, exchange_every=5,
                                         rounds=24, adapt_ladder=adapt) for d in (dev, cpu)}
            rates, rates_cpu = outs["cuda"][1].cpu().numpy(), outs["cpu"][1].numpy()
            rounds_differing = int((rates != rates_cpu).sum())
            if rounds_differing > MAX_ROUNDS_DIFFERING:
                raise AssertionError(f"tempering: {rounds_differing} rounds differ from the CPU")
            extra = {}
            if adapt:
                b, bc = outs["cuda"][2].cpu().numpy(), outs["cpu"][2].numpy()
                extra = dict(betas=b.tolist(), betas_max_rel_gap=float(np.abs(b / bc - 1).max()))
            say("tempering", replicas=64, objs=32, exchange_every=5, rounds=24, adapt_ladder=adapt,
                swap_rates=rates.tolist(), rounds_differing=rounds_differing, **extra,
                **states_agree("tempering", outs["cuda"][0], outs["cpu"][0]))
        for adaptive in (False, True):
            outs = {d.type: run_smc(prng.key(0, d), spec32.initial_pose(device=d),
                                    spec32.build(device=d), tcfg, None, 64, n_stages=8,
                                    mutate_steps=5, adaptive=adaptive) for d in (dev, cpu)}
            gd, wd = ({k: v.cpu().numpy() for k, v in outs[t][1].items()} for t in ("cuda", "cpu"))
            np.testing.assert_array_equal(gd["resampled"], wd["resampled"])
            np.testing.assert_allclose(gd["ess"], wd["ess"], rtol=1e-4)
            np.testing.assert_allclose(gd["betas"], wd["betas"], rtol=1e-5)
            np.testing.assert_allclose(gd["log_evidence"], wd["log_evidence"], rtol=1e-5)
            say("smc", particles=64, objs=32, stages=8, mutate_steps=5, adaptive=adaptive,
                log_evidence=float(gd["log_evidence"]), ess=gd["ess"].tolist(),
                resampled=gd["resampled"].astype(int).tolist(), betas=gd["betas"].tolist(),
                **states_agree("smc", outs["cuda"][0], outs["cpu"][0]))
        for argv, keys in ((["temper", "--objects", "32", "--replicas", "64", "--rounds", "24"],
                            {"swap_rates", "target_total_cost"}),
                           (["smc", "--objects", "32", "--particles", "64", "--stages", "8",
                             "--adaptive"],
                            {"log_evidence", "betas", "ess", "resampled", "best_total_cost"})):
            proc = subprocess.run([sys.executable, "-m", "mh_tpu_torch", *argv], cwd=HERE, env=env,
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode or set(json.loads(proc.stdout)) != keys:
                raise AssertionError(f"{argv}: rc {proc.returncode}\n{proc.stdout[-2000:]}"
                                     f"\n{proc.stderr[-4000:]}")
            say("cli", argv=argv, rc=proc.returncode, output=json.loads(proc.stdout))

    if "sharded" in phases:
        # 12. chains over a device mesh: 4 shards of card 0 (and, on a host
        # with more cards, one shard per card) against one shard
        dev0 = torch.device("cuda", 0)
        meshes = {"cuda0_x4": chain_mesh(devices=[dev0] * 4)}
        if torch.cuda.device_count() > 1:
            meshes["every_card"] = chain_mesh()
        mesh4, mesh1 = meshes["cuda0_x4"], chain_mesh(devices=[dev0])
        # the fused kernel, once per shard keyed by its first global chain
        for name, rspec, rcfg in (("parity", head, cfg), ("fixed_weighted", fixed_head, fixed_cfg),
                                  ("block", head, dataclasses.replace(cfg, **BLOCK))):
            def one_call():  # one launch on card 0, on a host with any number of cards
                return suggest_layouts(rspec, rcfg, key=0, engine="fused", mesh=mesh1)

            zero_counts()
            want = one_call()
            want_launches = F.fused_mh_cuda.launches
            want_ms = events_ms(one_call, 3)
            for mname, mesh in meshes.items():
                def sharded_call():
                    return suggest_layouts(rspec, rcfg, key=0, engine="fused", mesh=mesh)

                zero_counts()
                got = sharded_call()
                counts = read_counts()
                got_ms = events_ms(sharded_call, 3)
                shards = mesh.shape["chains"]
                launches, plain = (counts["fused_mh_cuda.launches"],
                                   counts["fused_chains_reference.calls"])
                differ = layout_chains_differing(got, want)
                if launches != shards or plain or differ:
                    raise AssertionError(f"sharded fused {name} on {mname}: {launches} launches, "
                                         f"{plain} plain calls, {differ} chains differ")
                say("sharded_fused", path=name, mesh=mname, shards=shards,
                    cards=torch.cuda.device_count(), devices=[str(d) for d in mesh.devices.flat],
                    objs=100,
                    chains=rcfg.n_chains, steps=rcfg.iterations, mode=rcfg.mode.name,
                    moves_per_step=rcfg.n_moves_per_step, accept_draws=rcfg.accept_draws,
                    launches=launches, plain_calls=plain, chains_differing=differ,
                    chains_accepting=int((got.accept_rate > 0).sum()), call_ms=got_ms,
                    one_launch_call_ms=want_ms, one_launch_launches=want_launches,
                    card=smi)

        # the torch engine and collective adaptation, 4 shards against 1
        ecfg = SamplerConfig(iterations=TORCH_STEPS, n_chains=1024)
        one, one_ms = timed(lambda: M.run_chains(key0, pose100, scene, ecfg)[0])
        four, four_ms = timed(lambda: run_chains_sharded(key0, pose100, scene, ecfg, mesh4))
        mesh4_runs["torch"] = (state_fields(four), four_ms)
        say("sharded_torch", objs=100, chains=ecfg.n_chains, steps=ecfg.iterations, shards=4,
            chains_differing=state_chains_differing(four, one), call_ms=four_ms,
            one_shard_call_ms=one_ms, card=smi)
        ccfg = SamplerConfig(iterations=0, n_chains=1024, adapt_rate=0.3, target_accept=0.3)
        outs = {}
        for mname, mesh in (("one", mesh1), ("four", mesh4)):
            outs[mname] = timed(lambda: run_chains_collective(key0, pose100, scene, ccfg, mesh,
                                                              *COLLECTIVE_ROUNDS))
        (c1, c1_ms), (c4, c4_ms) = outs["one"], outs["four"]
        mesh4_runs["collective"] = ({**state_fields(c4[0]), "rates": c4[1],
                                     "shared_log_scale": c4[2]}, c4_ms)
        if not (torch.equal(c1[1], c4[1]) and torch.equal(c1[2], c4[2])):
            raise AssertionError(f"collective: 4 shards {c4[1].tolist()} {float(c4[2])} against "
                                 f"1 shard {c1[1].tolist()} {float(c1[2])}")
        say("sharded_collective", objs=100, chains=ccfg.n_chains, rounds=COLLECTIVE_ROUNDS[0],
            steps_per_round=COLLECTIVE_ROUNDS[1],
            shards=4, rates=c4[1].tolist(), log_scale=float(c4[2]), rates_bitwise=True,
            chains_differing=state_chains_differing(c4[0], c1[0]), call_ms=c4_ms,
            one_shard_call_ms=c1_ms, card=smi)

        # tempering and SMC (BASELINE config 5's sizes), 4 shards against 1
        pose32, scene32 = spec32.initial_pose(device=dev), spec32.build(device=dev)
        for adapt in (False, True):
            (a, a_ms), (b, b_ms) = (timed(lambda m=m: run_tempered(
                prng.key(0, dev), pose32, scene32, tcfg, m, adapt_ladder=adapt, **TEMPER))
                for m in (None, mesh4))
            if not all(torch.equal(x, y) for x, y in zip((a[0].pose, *a[1:]), (b[0].pose, *b[1:]))):
                raise AssertionError(f"tempering (adapt_ladder={adapt}): 4 shards differ from 1")
            mesh4_runs["tempering_adapted" if adapt else "tempering"] = (
                {**state_fields(b[0]), "swap_rates": b[1], **({"betas": b[2]} if adapt else {})},
                b_ms)
            say("sharded_tempering", replicas=TEMPER["n_replicas"], objs=32,
                exchange_every=TEMPER["exchange_every"], rounds=TEMPER["rounds"],
                adapt_ladder=adapt, shards=4, bitwise=True, call_ms=b_ms, one_shard_call_ms=a_ms,
                card=smi)
        for adaptive in (False, True):
            (a, a_ms), (b, b_ms) = (timed(lambda m=m: run_smc(
                prng.key(0, dev), pose32, scene32, tcfg, m, adaptive=adaptive, **SMC))
                for m in (None, mesh4))
            if not torch.equal(a[0].pose, b[0].pose):
                raise AssertionError(f"smc (adaptive={adaptive}): 4 shards' poses differ from 1")
            for k in ("ess", "log_evidence"):
                np.testing.assert_allclose(b[1][k].cpu().numpy(), a[1][k].cpu().numpy(), rtol=1e-6)
            mesh4_runs["smc_adaptive" if adaptive else "smc"] = ({**state_fields(b[0]), **b[1]},
                                                                 b_ms)
            say("sharded_smc", particles=SMC["n_particles"], objs=32, stages=SMC["n_stages"],
                mutate_steps=SMC["mutate_steps"], adaptive=adaptive,
                shards=4, poses_bitwise=True,
                log_evidence_rel_gap=abs(float(b[1]["log_evidence"] / a[1]["log_evidence"]) - 1),
                call_ms=b_ms, one_shard_call_ms=a_ms, card=smi)

        # a scene past the kernel's object limit: the objective row-sharded
        # over 4 objs shards (one per card where the cards divide by 4, else
        # all on card 0), against the unsharded torch engine, in PARITY and
        # in weighted FIXED (both O(N^2) terms cross the reduction)
        from mh_tpu_torch.api import _objs_mesh

        huge = demo_scene(HUGE_OBJS)
        objs_mesh = _objs_mesh(dev, 4)
        for variant, hspec, mode in (
                ("parity", huge, CostMode.PARITY),
                ("fixed_weighted", dataclasses.replace(huge, w_offlimits=-1.5), CostMode.FIXED)):
            huge_scene = hspec.build(device=dev)
            hcfg = SamplerConfig(iterations=HUGE_STEPS, n_chains=HUGE_CHAINS, mode=mode)
            if F.kernel_takes(hcfg, HUGE_OBJS, int((huge_scene.clr_mask > 0).sum()),
                              mode is CostMode.FIXED):
                raise AssertionError("the fused kernel takes 4,096 objects; pick a larger scene")
            short = dataclasses.replace(hcfg, iterations=HUGE_SHORT)

            def short_call():
                return timed(lambda: suggest_layouts(hspec, short, key=0, objs_devices=4,
                                                     device="cuda"))[1]

            short_ms = short_call()  # first: it takes the cards' warm-up
            zero_counts()
            got, got_ms = timed(lambda: suggest_layouts(hspec, hcfg, key=0, objs_devices=4,
                                                        device="cuda"))
            if any(read_counts().values()):
                raise AssertionError(f"the objs-sharded run launched a kernel: {read_counts()}")
            want, want_ms = timed(lambda: suggest_layouts(hspec, hcfg, key=0, engine="torch",
                                                          mesh=mesh1))
            if not np.array_equal(got.accept_rate, want.accept_rate):
                raise AssertionError(f"objs-sharded accepts {got.accept_rate} != {want.accept_rate}")
            np.testing.assert_allclose(got.points, want.points, rtol=1e-4, atol=1e-4)
            ref = cost_terms(torch.as_tensor(got.points, device=dev), huge_scene,
                             hcfg.mode).total.cpu().numpy()
            np.testing.assert_allclose(got.costs[:, 0], ref, rtol=1e-4, atol=1e-2)
            short_ms = min(short_ms, short_call())
            say("sharded_objs", variant=variant, objs=HUGE_OBJS, chains=hcfg.n_chains,
                steps=hcfg.iterations, mode=mode.name, objs_shards=4,
                cards=torch.cuda.device_count(), mesh_shape=objs_mesh.shape,
                mesh_devices=[str(d) for d in objs_mesh.devices.flat],
                accept_rate=got.accept_rate.tolist(),
                max_pose_gap=float(np.abs(got.points - want.points).max()),
                total_vs_cost_terms_max_abs=float(np.abs(got.costs[:, 0] - ref).max()),
                ms_per_step=(got_ms - short_ms) / (hcfg.iterations - short.iterations),
                call_ms=got_ms, unsharded_call_ms=want_ms, card=smi)

    if "multiprocess" in phases:
        # 13. runs across processes: 2 processes x 2 shards of card 0 on gloo
        # (and, on a host with more cards, 2 processes x 2 shards of a card
        # each and 4 processes x 1 card on nccl) against one launch (the
        # fused kernel) or the same mesh shape in this process on card 0
        # (the rest), bit for bit in every chain
        from mh_tpu_torch.parallel.objshard import chain_obj_mesh

        dev0 = torch.device("cuda", 0)
        mesh4, mesh1 = chain_mesh(devices=[dev0] * 4), chain_mesh(devices=[dev0])
        progs = runs_across_processes(dev)
        layouts = {"cuda0_2x2": ("gloo", ["cuda:0,cuda:0"] * 2,
                                 "both processes name card 0; nccl refuses two ranks on one card")}
        if torch.cuda.device_count() > 1:
            layouts["card_each_2x2"] = ("nccl", [f"cuda:{i},cuda:{i}" for i in range(2)],
                                        "each process names a card of its own")
        if torch.cuda.device_count() > 3:
            layouts["card_each_4x1"] = ("nccl", [f"cuda:{i}" for i in range(4)],
                                        "each process names a card of its own")
        huge_short = {}  # row-sharded program -> in-process ms of the short run
        for lname, (backend, devs, why) in layouts.items():
            nproc = len(devs)
            with tempfile.TemporaryDirectory() as tmp:
                out, port = os.path.join(tmp, "gathered.pt"), free_port()
                done = spawn(
                    [(["multiprocess", str(pid), str(nproc), str(port), out, backend, devs[pid]],
                      lambda rc: rc == 0) for pid in range(nproc)], env)
                gathered = torch.load(out, weights_only=True)
            res = [worker_result(so) for _, so, _ in done]
            if any(r["backend"] != backend for r in res):
                raise AssertionError(f"{lname}: asked for {backend}, got "
                                     f"{[r['backend'] for r in res]}")
            say("multiprocess_backend", layout=lname, processes=nproc, backend=res[0]["backend"],
                reason=f"{res[0]['reason']}: {why}", shards=[r["shards"] for r in res],
                devices=[r["devices"] for r in res],
                obj_mesh_processes=res[0]["obj_mesh_processes"])
            for name, run in progs.items():
                counts = [r["programs"][name] for r in res]
                extra = {}
                omesh = obj_mesh_of(name)
                if name.startswith("fused"):
                    if name not in mesh4_runs:
                        mesh4_runs[name] = timed(lambda: run(mesh4))
                        zero_counts()
                        want, one_ms = timed(lambda: run(mesh1))
                        if read_counts()["fused_mh_cuda.launches"] != 1:
                            raise AssertionError(f"{name}: one launch launched {read_counts()}")
                        mesh4_runs[name + "_one_launch"] = (want, one_ms)
                    want, one_ms = mesh4_runs[name + "_one_launch"]
                    extra = dict(one_launch_call_ms=one_ms,
                                 chains_accepting=int((want["n_accept"] > 0).sum()))
                    if any(c["launches"] != len(r["shards"]) or c["plain_calls"]
                           for c, r in zip(counts, res)):
                        raise AssertionError(f"{name} on {lname}: {counts}")
                elif name not in mesh4_runs:
                    local = (mesh4 if omesh is None else
                             chain_obj_mesh(*OBJ_MESHES[omesh], devices=[dev0] * 4))
                    if omesh is not None:
                        huge_short[name] = timed(lambda: run(local, HUGE_SHORT))[1]
                    mesh4_runs[name] = timed(lambda: run(local))
                    if omesh is not None:
                        huge_short[name] = min(huge_short[name],
                                               timed(lambda: run(local, HUGE_SHORT))[1])
                if not name.startswith("fused"):
                    want = mesh4_runs[name][0]
                got = gathered[name]
                if omesh is not None:
                    got, shared_rows = rows_once(got)
                    extra = dict(
                        mesh=OBJ_MESHES[omesh], objs=HUGE_OBJS, steps=HUGE_STEPS,
                        rows_per_process=[c["rows"] for c in counts],
                        rows_returned_by_several_processes=shared_rows,
                        ms_per_step_per_process=[c["ms_per_step"] for c in counts],
                        in_process_ms_per_step=(mesh4_runs[name][1] - huge_short[name])
                        / (HUGE_STEPS - HUGE_SHORT),
                        chains_accepting=int((want["n_accept"] > 0).sum()))
                if set(got) != set(want):
                    raise AssertionError(f"{name}: outputs {sorted(got)} against {sorted(want)}")
                rows = [k for k in want if k not in SCALAR_OUTPUTS]
                differ = _chains_differing([(got[k], want[k]) for k in rows if k != "rows"],
                                           len(want["pose"]))
                scalars_equal = all(torch.equal(got[k], want[k].cpu())
                                    for k in want if k in SCALAR_OUTPUTS or k == "rows")
                if differ or not scalars_equal:
                    raise AssertionError(f"{name} on {lname}: {differ} chains differ, scalar "
                                         f"outputs equal: {scalars_equal}")
                say("multiprocess", layout=lname, backend=backend, processes=nproc,
                    program=name, chains=len(want["pose"]), chains_differing=differ,
                    bitwise=True, launches_per_process=[c["launches"] for c in counts],
                    plain_calls=[c["plain_calls"] for c in counts],
                    call_ms_per_process=[c["call_ms"] for c in counts],
                    in_process_call_ms=mesh4_runs[name][1], **extra, card=smi)

    if "recovery" in phases:
        # 14. kill and resume: the torch engine on the card at 100 objects x
        # 1024 chains, R rounds, a checkpoint, SIGKILL, a fresh process
        # restores and runs R more; in one process, then in 2 processes
        # with per-process shard files. The uninterrupted runs and the
        # crashes run at once, then the resumes.
        with tempfile.TemporaryDirectory() as tmp:
            one, two = os.path.join(tmp, "one"), os.path.join(tmp, "two")
            ok, killed = (lambda rc: rc == 0), (lambda rc: rc == -signal.SIGKILL)
            p_full, p_crash, p_resume = free_port(), free_port(), free_port()

            def pair(mode, path, port, ends):
                return [(["recovery", mode, path, str(pid), "2", str(port)], ends) for pid in (0, 1)]

            t0 = time.perf_counter()
            # a process whose peer's connection drops a moment before its own
            # kill may exit non-zero instead; either way it died after saving
            first = spawn([(["recovery", "full", one], ok), (["recovery", "crash", one], killed),
                           *pair("full", two, p_full, ok),
                           *pair("crash", two, p_crash, lambda rc: rc != 0)], env)
            first_s = time.perf_counter() - t0
            if not all("CHECKPOINTED" in first[i][1] for i in (1, 4, 5)):
                raise AssertionError("a crash worker died before its checkpoint")
            files = [one + ".pt", two + ".proc0.pt", two + ".proc1.pt"]
            if not all(os.path.exists(f) for f in files):
                raise AssertionError(f"checkpoint files missing: {os.listdir(tmp)}")
            t0 = time.perf_counter()
            second = spawn([(["recovery", "resume", one], ok), *pair("resume", two, p_resume, ok)],
                           env)
            second_s = time.perf_counter() - t0
        single_full, pair_full = worker_result(first[0][1]), worker_result(first[2][1])
        single_resume, pair_resume = worker_result(second[0][1]), worker_result(second[1][1])
        if single_resume != single_full or pair_resume != pair_full:
            raise AssertionError(f"resumed runs differ: {single_resume} / {single_full}, "
                                 f"{pair_resume} / {pair_full}")
        # save and restore of the state in this process (host clock, the
        # card synchronised before and after)
        from mh_tpu_torch.utils.checkpoint import restore_state, save_state

        rstate, _ = M.run_chains(prng.key(42, dev), pose100, scene,
                                 SamplerConfig(iterations=RECOVERY_ITERS, n_chains=1024))
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "state")
            (_, save_s) = wall(lambda: save_state(path, rstate))
            nbytes = os.path.getsize(path + ".pt")
            back, restore_s = wall(lambda: restore_state(path, rstate.map(torch.empty_like)))
        if state_chains_differing(back, rstate) or not torch.equal(back.key, rstate.key):
            raise AssertionError("a restored state differs from the saved one")
        say("recovery", objs=100, chains=1024, rounds_before_kill=RECOVERY_ROUNDS,
            steps_per_round=RECOVERY_ITERS, single_process_equal=True,
            two_processes_equal=True, single=single_full, two_processes=pair_full,
            two_processes_equal_single=pair_full == single_full,
            checkpoint_save_ms=save_s * 1e3, checkpoint_restore_ms=restore_s * 1e3,
            checkpoint_bytes=nbytes, full_and_crash_wall_s=first_s, resume_wall_s=second_s,
            card=smi)

    if "metrics" in phases:
        # 15. ESS, split R-hat, mean and std of the cost traces of 1024 chains
        # x 1000 steps (100 objects) on the card against the CPU
        from mh_tpu_torch.utils.metrics import summarize_chains

        mcfg = SamplerConfig(iterations=1000, n_chains=1024)
        (_, traces), trace_ms = timed(
            lambda: M.compile_chains(scene, mcfg, trace_costs=True)(key0, pose100))
        got, got_ms = timed(lambda: summarize_chains(traces))
        best_ms = events_ms(lambda: summarize_chains(traces), 3)
        want = summarize_chains(traces.cpu())
        for k, v in want.items():
            torch.testing.assert_close(got[k].cpu(), v, rtol=1e-4, atol=1e-6)
        if not all(torch.isfinite(v).all() for v in got.values()):
            raise AssertionError("summarize_chains returned non-finite values")
        ess = got["ess"].cpu()
        say("metrics", objs=100, chains=1024, steps=1000, trace_shape=list(traces.shape),
            summarize_ms=best_ms, first_call_ms=got_ms, trace_run_ms=trace_ms,
            max_rel_gap_vs_cpu={k: float(((got[k].cpu() - v).abs()
                                          / v.abs().clamp_min(1e-30)).max())
                                for k, v in want.items()},
            ess_min=float(ess.min()), ess_median=float(ess.median()), ess_max=float(ess.max()),
            r_hat=float(got["r_hat"]), card=smi)

    if "time" in phases:
        # 16. time (CUDA events; slope over step or sample counts, minimum of repeats)
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
            kernel_call_ms=call_ms, plain_call_ms=plain_call_ms.get("single"))
        fused_b = fused_bound(F, pk, 0, cfg.iterations, cfg.n_chains, dev)
        say("bound", card=smi, kernel="fused_mh", objs=100, chains=cfg.n_chains,
            steps=cfg.iterations, kernel_call_ms=call_ms, **fused_b,
            share_of_bound=fused_b["bound_ms"] / call_ms)

        bks, bps = (10, 255, 505), (2, 4, 6)
        bk_step, bp_step, bkt, bpt = fused_time(block_pk, bks, bps, 3)
        proposals = block_cfg.n_moves_per_step * block_cfg.n_chains  # bench.py:220
        say("time", card=smi, objs=100, chains=block_cfg.n_chains, **BLOCK,
            kernel_ms_per_step=bk_step, kernel_proposals_per_s=proposals / (bk_step * 1e-3),
            plain_ms_per_step=bp_step, plain_proposals_per_s=proposals / (bp_step * 1e-3),
            kernel_ms=dict(zip(map(str, bks), bkt)), plain_ms=dict(zip(map(str, bps), bpt)),
            plain_call_ms_100_steps=plain_call_ms.get("block"))

        # the kernel's objects sweep (one move), and weighted FIXED at 100 objects
        sweep = {}
        for n_objs in SWEEP_OBJECTS:
            sspec = demo_scene(n_objs)
            spk = F.pack_scene(sspec.build(device=dev), cfg)
            spose = sspec.initial_pose(device=dev).expand(cfg.n_chains, n_objs, 6).contiguous()
            st = [events_ms(lambda s=s: F.fused_mh_cuda(spk, spose, 0, s), 3) for s in ks]
            sweep[n_objs] = dict(ms_per_step=slope(ks, st), ms=dict(zip(map(str, ks), st)),
                                 smem_bytes=F.smem_bytes(n_objs, spk.n_clr, 1, False),
                                 blocks_per_sm=blocks_per_sm(
                                     fused_regs, F.smem_bytes(n_objs, spk.n_clr, 1, False)))
        say("time_objects_sweep", card=smi, chains=cfg.n_chains, moves_per_step=1, mode="PARITY",
            registers=fused_regs, objects={str(k): v for k, v in sweep.items()},
            ratio_512_to_100=sweep[512]["ms_per_step"] / sweep[100]["ms_per_step"])
        # one chain to an SM: the step's latency, beside the 1024-chain step
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        lpose = head.initial_pose(device=dev).expand(n_sms, 100, 6).contiguous()
        lt = [events_ms(lambda s=s: F.fused_mh_cuda(pk, lpose, 0, s), 3) for s in ks]
        say("time", card=smi, objs=100, chains=n_sms, moves_per_step=1, one_chain_per_sm=True,
            kernel_ms_per_step=slope(ks, lt), kernel_ms=dict(zip(map(str, ks), lt)),
            ratio_to_1024_chains=slope(ks, lt) / sweep[100]["ms_per_step"])
        # weighted FIXED: the off-limits slab state, by object count
        wsweep = {}
        for n_objs in SWEEP_OBJECTS:
            sspec = dataclasses.replace(demo_scene(n_objs), w_offlimits=-1.5)
            spk = F.pack_scene(sspec.build(device=dev), fixed_cfg)
            spose = sspec.initial_pose(device=dev).expand(cfg.n_chains, n_objs, 6).contiguous()
            st = [events_ms(lambda s=s: F.fused_mh_cuda(spk, spose, 0, s), 3) for s in ks]
            smem = F.smem_bytes(n_objs, spk.n_clr, 1, True)
            wsweep[n_objs] = dict(ms_per_step=slope(ks, st), ms=dict(zip(map(str, ks), st)),
                                  smem_bytes=smem, blocks_per_sm=blocks_per_sm(fused_regs, smem),
                                  slab_width=F.off_slab_width(n_objs), slabs=F.off_slabs(n_objs),
                                  ratio_to_parity=slope(ks, st) / sweep[n_objs]["ms_per_step"])
        say("time_objects_sweep", card=smi, chains=cfg.n_chains, moves_per_step=1, mode="FIXED",
            w_offlimits=-1.5, registers=fused_regs, objects={str(k): v for k, v in wsweep.items()},
            ratio_512_to_100=wsweep[512]["ms_per_step"] / wsweep[100]["ms_per_step"])
        fixed_call_ms = events_ms(lambda: F.fused_mh_cuda(fixed_pk, pose0, 0, cfg.iterations), 5)
        fixed_b = fused_bound(F, fixed_pk, 0, cfg.iterations, cfg.n_chains, dev)
        say("bound", card=smi, kernel="fused_mh", mode="FIXED", w_offlimits=-1.5, objs=100,
            chains=cfg.n_chains, steps=cfg.iterations, kernel_call_ms=fixed_call_ms, **fixed_b,
            share_of_bound=fixed_b["bound_ms"] / fixed_call_ms)

        pks, pps = (1 << 32, 1 << 33, 1 << 34), (1 << 26, 1 << 27, 1 << 28)
        pkt = [events_ms(lambda n=n: P.pi_hits_cuda(0, n, dev), 3) for n in pks]
        ppt = [events_ms(lambda n=n: P.pi_hits_reference(0, n, dev), 2) for n in pps]
        pi_ms = events_ms(lambda: P.pi_hits_cuda(0, 1 << 32, dev), 3)
        pi_plain_ms = events_ms(lambda: P.pi_hits_reference(0, 1 << 32, dev), 1)
        say("time", card=smi, kernel="pi_kernel",
            kernel_samples_per_s=1e3 / slope(pks, pkt), plain_samples_per_s=1e3 / slope(pps, ppt),
            kernel_ms=dict(zip(map(str, pks), pkt)), plain_ms=dict(zip(map(str, pps), ppt)),
            kernel_ms_2_32=pi_ms, plain_ms_2_32=pi_plain_ms)
        # pi is bound by instruction issue: SASS instructions per sample over
        # four warp-instructions a clock on every SM at the card's top SM clock
        pi_sass = sass_per_sample(lib, "pi_hits_kernel")
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60).stdout.split("\n")[0]
        max_mhz, now_mhz = (float(v) for v in clocks.split(","))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        pi_b = dict(bound_ms=(1 << 32) * pi_sass["instructions_per_sample"]
                    / (sms * ISSUE_THREAD_INSTR_PER_SM_CLOCK * max_mhz * 1e6) * 1e3,
                    bound_by="operations")
        say("bound", card=smi, kernel="pi_kernel", samples=1 << 32, kernel_ms=pi_ms, **pi_sass,
            sms=sms, sm_clock_max_mhz=max_mhz, sm_clock_now_mhz=now_mhz, **pi_b,
            share_of_bound=pi_b["bound_ms"] / pi_ms)

        # the torch engine, eager and as a CUDA graph, beside the fused kernel

        def wall_ms(fn, repeats):
            """Minimum over ``repeats`` of ``fn()``'s host wall time, synchronized."""
            return min(wall(fn)[1] for _ in range(repeats)) * 1e3

        def engine_time(kcfg, eager_steps, graph_steps):
            def eager(n):
                return M.run_chains(key0, pose100, scene, dataclasses.replace(kcfg, iterations=n))

            runner = M.compile_chains(scene, kcfg)
            # the capture: the first call of a runner captures the step; the
            # host clock, since capture is host work
            first_ms = wall_ms(lambda: runner(key0, pose100, iterations=1), 1)
            calls = dict(first_graph_call_1_step_ms=first_ms,
                         graph_call_1_step_ms=wall_ms(lambda: runner(key0, pose100, iterations=1), 3),
                         eager_call_1_step_ms=wall_ms(lambda: eager(1), 3))
            et = [events_ms(lambda n=n: eager(n), 2) for n in eager_steps]
            gt = [events_ms(lambda n=n: runner(key0, pose100, iterations=n), 3) for n in graph_steps]
            return slope(eager_steps, et), slope(graph_steps, gt), et, gt, calls

        torch_ms = {}
        for name, kcfg, es, gs, fused_step in (
                ("single", cfg, (5, 15, 25), (50, 150, 250), k_step),
                ("block", block_cfg, (1, 2, 3), (5, 10, 20), bk_step)):
            e_step, g_step, et, gt, calls = engine_time(kcfg, es, gs)
            torch_ms[name] = (e_step, g_step)
            proposals = kcfg.n_chains * kcfg.n_moves_per_step
            capture_ms = calls["first_graph_call_1_step_ms"] - calls["graph_call_1_step_ms"]
            # steps at which a capturing graph call costs what an eager call does
            break_even = 1 + max(0.0, calls["first_graph_call_1_step_ms"]
                                 - calls["eager_call_1_step_ms"]) / (e_step - g_step)
            say("time", card=smi, objs=100, chains=kcfg.n_chains,
                moves_per_step=kcfg.n_moves_per_step, accept_draws=kcfg.accept_draws,
                torch_ms_per_step=e_step, torch_proposals_per_s=proposals / (e_step * 1e-3),
                torch_graph_ms_per_step=g_step,
                torch_graph_proposals_per_s=proposals / (g_step * 1e-3),
                fused_ms_per_step=fused_step, fused_proposals_per_s=proposals / (fused_step * 1e-3),
                graph_capture_ms=capture_ms, graph_break_even_steps=break_even, **calls,
                torch_ms=dict(zip(map(str, es), et)), torch_graph_ms=dict(zip(map(str, gs), gt)))

        # serve: is the CUDA graph faster than the fused kernel at any size?
        for n_objs, n_chains in ((10, 1), (10, 64), (32, 64), (32, 1024)):
            sspec = demo_scene(n_objs)
            sscene = sspec.build(device=dev)
            scfg = SamplerConfig(iterations=1, n_chains=n_chains)
            spk = F.pack_scene(sscene, scfg)
            spose = sspec.initial_pose(device=dev).expand(n_chains, n_objs, 6).contiguous()
            fs = (100, 400, 700)
            ft = [events_ms(lambda n=n: F.fused_mh_cuda(spk, spose, 0, n), 3) for n in fs]
            runner = M.compile_chains(sscene, scfg)
            runner(key0, spose, iterations=1)
            gs = (50, 150, 250)
            gt = [events_ms(lambda n=n: runner(key0, spose, iterations=n), 3) for n in gs]
            f_step, g_step = slope(fs, ft), slope(gs, gt)
            say("time_serve", card=smi, objs=n_objs, chains=n_chains, fused_ms_per_step=f_step,
                torch_graph_ms_per_step=g_step, graph_faster=g_step < f_step,
                fused_ms=dict(zip(map(str, fs), ft)), torch_graph_ms=dict(zip(map(str, gs), gt)))

        # tempering sweeps/s as bench.py:374 counts them; SMC wall time
        pose32, scene32 = spec32.initial_pose(device=dev), spec32.build(device=dev)
        rounds = (4, 14, 24)
        rt = [events_ms(lambda r=r: run_tempered(prng.key(0, dev), pose32, scene32, tcfg, None, 64,
                                                 exchange_every=5, rounds=r), 3) for r in rounds]
        per_step = slope(rounds, rt) / 5.0
        smc_ms = events_ms(lambda: run_smc(prng.key(0, dev), pose32, scene32, tcfg, None, 64,
                                           n_stages=8, mutate_steps=5), 2)
        say("time_tempering_smc", card=smi, objs=32, replicas=64,
            tempering_sweeps_per_s=64 / (per_step * 1e-3), tempering_ms_per_step=per_step,
            tempering_ms=dict(zip(map(str, rounds), rt)), smc_wall_ms=smc_ms)

    if "slab_width" in phases:
        # weighted FIXED by slab width beside PARITY, one move: the width
        # trades the row update's pairs (~W N / 2) against the cells' shared
        # memory (2 N^2 / W words) and so the blocks an SM holds
        chosen = F.off_slab_width
        ks = (10, 505, 1010)
        for n_objs, widths in WIDTHS.items():
            sspec = dataclasses.replace(demo_scene(n_objs), w_offlimits=-1.5)
            spose = sspec.initial_pose(device=dev).expand(cfg.n_chains, n_objs, 6).contiguous()
            rows = {}
            for w in (None, *widths):
                F.off_slab_width = chosen if w is None else (lambda n, w=w: w)
                spk = (F.pack_scene(demo_scene(n_objs).build(device=dev), cfg) if w is None
                       else F.pack_scene(sspec.build(device=dev), fixed_cfg))
                st = [events_ms(lambda s=s: F.fused_mh_cuda(spk, spose, 0, s), 3) for s in ks]
                smem = F.smem_bytes(n_objs, spk.n_clr, 1, spk.track_off)
                rows["parity" if w is None else str(w)] = dict(
                    ms_per_step=slope(ks, st), smem_bytes=smem,
                    blocks_per_sm=blocks_per_sm(fused_regs, smem))
            F.off_slab_width = chosen
            say("slab_width", card=smi, objs=n_objs, chains=cfg.n_chains, moves_per_step=1,
                chosen_width=chosen(n_objs), rows=rows)

    if "kernel_variants" in phases:
        # the MH kernel's design choices, each against the default in this
        # run: the off-limits update against the rows from scratch by object
        # count, in turns (A B B A; fused_mh.off_incremental rebound), then
        # the phase profile build (-DMH_PHASE_PROFILE): clock cycles per step
        # of each warp's lane 0 in each phase of a single-move step, 1024
        # chains and one per SM
        ks = (10, 505, 1010)
        default_load = _build.load
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

        def step_ms(spk, spose):
            return slope(ks, [events_ms(lambda s=s: F.fused_mh_cuda(spk, spose, 0, s), 3)
                              for s in ks])

        def case(n_objs, mode, w_off, chains=cfg.n_chains):
            sspec = dataclasses.replace(demo_scene(n_objs), w_offlimits=w_off)
            return (F.pack_scene(sspec.build(device=dev), SamplerConfig(mode=mode)),
                    sspec.initial_pose(device=dev).expand(chains, n_objs, 6).contiguous())

        chosen = F.off_incremental
        schemes = {}
        for n_objs in (32, 37, 48, 64, 100, 256, 1024):
            spk, spose = case(n_objs, CostMode.FIXED, -1.5)
            row = schemes.setdefault(str(n_objs), dict(chosen=chosen(1, n_objs, spk.n_clr)))
            for inc in (True, False, False, True):
                F.off_incremental = lambda m, n, c, inc=inc: inc
                row.setdefault("update" if inc else "recompute", []).append(step_ms(spk, spose))
            F.off_incremental = chosen
        say("kernel_variants", card=smi, chains=cfg.n_chains, moves_per_step=1,
            w_offlimits=-1.5, off_scheme_ms_per_step=schemes)

        plib = default_load(("MH_PHASE_PROFILE",))
        for fn in ("mh_phase_cycles_read", "mh_phase_cycles_reset"):
            getattr(plib, fn).argtypes = [ctypes.c_void_p] if fn.endswith("read") else []
            getattr(plib, fn).restype = ctypes.c_int
        _build.load = lambda: plib
        buf = (ctypes.c_ulonglong * (4 * len(STEP_PHASES) + 1))()
        for key in ("PARITY_32", "FIXED_weighted_32", "PARITY_100", "FIXED_weighted_100"):
            n_objs = int(key.rsplit("_", 1)[1])
            for chains in (cfg.n_chains, n_sms):
                spk, spose = case(n_objs, CostMode[key.split("_")[0]],
                                  -1.5 if "weighted" in key else 0.0, chains)
                if plib.mh_phase_cycles_reset():
                    raise AssertionError("phase profile reset failed")
                F.fused_mh_cuda(spk, spose, 0, 1000)
                torch.cuda.synchronize()
                if plib.mh_phase_cycles_read(ctypes.addressof(buf)):
                    raise AssertionError("phase profile read failed")
                per = [[buf[w * len(STEP_PHASES) + k] / (buf[-1] * 1000)
                        for k in range(len(STEP_PHASES))] for w in range(4)]
                say("kernel_phases", card=smi, case=key, chains=chains, steps=1000,
                    cycles_per_step={ph: [round(per[w][k], 1) for w in range(4)]
                                     for k, ph in enumerate(STEP_PHASES)},
                    warp0_cycles_per_step=round(sum(per[0]), 1))
        _build.load = default_load

    if "profile" in phases:
        # 17. profile: what the torch engine's step is made of on the card
        for name, kcfg in (("single", cfg), ("block", block_cfg)):
            for graph in (False, True):
                say("profile", card=smi, objs=100, chains=kcfg.n_chains, path=name,
                    mode="graph" if graph else "eager",
                    **profile_steps(scene, pose100, kcfg, graph, steps=10))

    if "gradient" in phases:
        gradient_phase(dev, smi)
    if "gradient_warmup" in phases:
        gradient_warmup_phase(dev, smi)
    if "native" in phases:
        # 19. the native C ABI, in this process and as C host processes
        fused_launches += native_phase(smi, fused_counters, env)
        fused_calls += 3
    if "examples" in phases:
        # 20. the examples as processes on the card
        examples_phase(smi, env)

    if "jax" in sys.modules or "mh_tpu" in sys.modules:
        raise AssertionError("the port imported JAX or mh_tpu")
    if phases == PHASES:
        # no PyTorch call computes either kernel's function: library_ms is null
        print(json.dumps({"kernels": [{
            "name": "fused_mh",
            "route": "cuda",
            "source": "mh_tpu_torch/kernels/csrc/fused_mh.cu",
            "replaces": "mh_tpu/kernels/fused_mh.py:405",
            "launches": fused_launches,
            "launches_per_call": fused_launches / fused_calls,
            "max_abs_err": max_err,
            "ms": call_ms,
            "plain_ms": plain_call_ms["single"],
            "bound_ms": fused_b["bound_ms"],
            "bound_by": fused_b["bound_by"],
            "library_ms": None,
        }, {
            "name": "pi_kernel",
            "route": "cuda",
            "source": "mh_tpu_torch/kernels/csrc/pi_kernel.cu",
            "replaces": "mh_tpu/kernels/pi_kernel.py:28",
            "launches": pi_launches,
            "launches_per_call": pi_launches,
            "max_abs_err": pi_err,
            "ms": pi_ms,
            "plain_ms": pi_plain_ms,
            "bound_ms": pi_b["bound_ms"],
            "bound_by": pi_b["bound_by"],
            "library_ms": None,
        }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(worker_main(sys.argv[2:]) if sys.argv[1:2] == ["--worker"] else main())
