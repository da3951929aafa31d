"""The port's examples (``python -m mh_tpu_torch.examples.<name>``) run to
the end on the CPU at a toy size, and without ``--device`` need a card:
they fail without one and never run on the CPU. tests/test_torch_cuda.py
runs them on the card."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
# (module, toy arguments, a line the run must print)
EXAMPLES = [
    ("demo_layout", ["--chains", "2", "--iters", "20", "--objects", "8"], "proposals in"),
    ("huge_scene", ["--objects", "64", "--chains", "2", "--iters", "3", "--objs-devices", "2"],
     "proposals over a 64x64 objective"),
    ("advanced_sampling", ["--objects", "4", "--replicas", "4", "--draws", "10"], "ELBO: start"),
]


def run_example(name, args, **env):
    return subprocess.run(
        [sys.executable, "-m", f"mh_tpu_torch.examples.{name}", *args], cwd=REPO,
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(REPO), **env})


@pytest.mark.parametrize("name,args,line", EXAMPLES, ids=[e[0] for e in EXAMPLES])
def test_example_runs_on_cpu(name, args, line):
    run = run_example(name, [*args, "--device", "cpu"])
    assert run.returncode == 0, run.stderr[-2000:]
    assert line in run.stdout


@pytest.mark.parametrize("name,args,line", EXAMPLES, ids=[e[0] for e in EXAMPLES])
def test_example_needs_a_card_by_default(name, args, line):
    run = run_example(name, args, CUDA_VISIBLE_DEVICES="")
    assert run.returncode != 0
    assert "CUDA" in run.stderr or "cuda" in run.stderr
    assert line not in run.stdout
