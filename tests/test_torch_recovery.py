"""Kill-and-resume with the port: SIGKILL a run mid-flight, restore, continue.

Mirrors tests/test_recovery.py. A worker process checkpoints, dies by an
uncatchable SIGKILL, and a fresh process restores and continues; the
resumed run's final state must be BITWISE that of an uninterrupted run
(sha256 of the pose, the accept counts and the steps), because the step
key folds from the checkpointed (chain key, step counter). Covered in one
process (``mh_tpu_torch.utils.checkpoint.save_state``) and in two
processes of 2 CPU shards each over ``torch.distributed`` (gloo), where
every process saves and restores only its own rows
(``save_local_shards`` / ``restore_local_shards``).

The module is its own worker:
``python tests/test_torch_recovery.py <mode> <ckpt> [<pid> <nproc> <port>]``
with mode ``full`` (2 R rounds), ``crash`` (R rounds, checkpoint, SIGKILL)
or ``resume`` (restore, R rounds).
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import sys

import numpy as np
import torch

ROUNDS = 3  # R rounds before the crash, R after
ROUND_ITERS = 10
N_CHAINS = 8


def digest(pose: torch.Tensor, n_accept: torch.Tensor, step: torch.Tensor) -> dict:
    return {
        "pose_sha": hashlib.sha256(np.ascontiguousarray(pose.cpu().numpy()).tobytes()).hexdigest(),
        "n_accept": n_accept.tolist(),
        "step": step.tolist(),
    }


def worker(mode: str, path: str, dist_args: list[str]) -> None:
    import mh_tpu_torch
    from mh_tpu_torch.parallel.multihost import global_chain_mesh, initialize, process_allgather
    from mh_tpu_torch.parallel.sharded import continue_chains_sharded, run_chains_sharded
    from mh_tpu_torch.sampler import prng
    from mh_tpu_torch.sampler.mh import continue_chains, run_chains
    from mh_tpu_torch.utils import checkpoint as ckpt

    distributed = bool(dist_args)
    if distributed:
        pid, nproc, port = map(int, dist_args)
        initialize(f"127.0.0.1:{port}", nproc, pid)
        mesh = global_chain_mesh(["cpu"] * 2)
    else:
        pid = 0
    spec = mh_tpu_torch.demo_scene(8)
    scene, pose0 = spec.build(), spec.initial_pose()
    key = prng.key(42)
    cfg = mh_tpu_torch.SamplerConfig(iterations=ROUND_ITERS, n_chains=N_CHAINS)

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
            print("RESULT " + json.dumps(digest(states.pose, states.n_accept, states.step)),
                  flush=True)

    if mode == "full":
        states = first_round()
        for _ in range(2 * ROUNDS - 1):
            states = next_round(states)
        report(states)
    elif mode == "crash":
        states = first_round()
        for _ in range(ROUNDS - 1):
            states = next_round(states)
        if distributed:
            ckpt.save_local_shards(path, states)
            # every process has its file before any of them dies
            torch.distributed.barrier()
        else:
            ckpt.save_state(path, states)
        print("CHECKPOINTED", flush=True)
        os.kill(os.getpid(), signal.SIGKILL)  # no Python cleanup runs after this
    elif mode == "resume":
        template = first_round()  # structure, shapes and dtypes; values replaced
        if distributed:
            states = ckpt.restore_local_shards(path, template)
        else:
            states = ckpt.restore_state(path, template)
        for _ in range(ROUNDS):
            states = next_round(states)
        report(states)
    else:
        raise SystemExit(f"unknown mode {mode}")
    if {"jax", "mh_tpu"} & set(sys.modules):
        raise AssertionError("a worker imported jax or mh_tpu")
    if distributed:
        torch.distributed.destroy_process_group()


def _result(out: str) -> dict:
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _run(mode, ckpt, nproc=1):
    """The workers' ``(rc, stdout, stderr)``; every one must end with 0,
    or in ``crash`` by its own SIGKILL after checkpointing."""
    from test_torch_multihost import free_port, run_workers

    port = free_port()
    argvs = [[__file__, mode, ckpt] + ([str(pid), str(nproc), str(port)] if nproc > 1 else [])
             for pid in range(nproc)]
    expect = -signal.SIGKILL if mode == "crash" else 0
    results, timed_out = run_workers(argvs, expect_rc=expect)
    assert not timed_out, [r[2][-3000:] for r in results]
    for rc, so, se in results:
        if mode == "crash" and nproc > 1:
            # as in tests/test_recovery.py: a process that sees its peer's
            # connection drop a moment before its own kill may exit non-zero
            # instead; either way it died after checkpointing
            assert rc != 0 and "CHECKPOINTED" in so, (rc, se[-3000:])
        else:
            assert rc == expect, f"{mode} worker ended with {rc}:\n{so}\n{se[-3000:]}"
    return results


def test_kill_and_resume_single_process(tmp_path):
    ckpt = str(tmp_path / "ck")
    full = _run("full", ckpt)
    crash = _run("crash", ckpt)
    assert "CHECKPOINTED" in crash[0][1] and os.path.exists(ckpt + ".pt")
    resume = _run("resume", ckpt)
    want = _result(full[0][1])
    assert _result(resume[0][1]) == want
    assert want["step"] == [2 * ROUNDS * ROUND_ITERS] * N_CHAINS and sum(want["n_accept"]) > 0


def test_kill_and_resume_two_processes(tmp_path):
    """Both processes checkpoint their own rows, die by SIGKILL, and a fresh
    pair restores and continues bitwise."""
    ckpt = str(tmp_path / "dck")
    full = _run("full", ckpt, nproc=2)
    _run("crash", ckpt, nproc=2)
    assert os.path.exists(ckpt + ".proc0.pt") and os.path.exists(ckpt + ".proc1.pt")
    resume = _run("resume", ckpt, nproc=2)
    assert _result(resume[0][1]) == _result(full[0][1])
    # and equal to the single-process run of the same chains
    single = str(tmp_path / "one")
    assert _result(_run("full", single)[0][1]) == _result(full[0][1])


if __name__ == "__main__":
    worker(sys.argv[1], sys.argv[2], sys.argv[3:])
