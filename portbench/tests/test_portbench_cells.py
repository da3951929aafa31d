"""Each one-card cell run briefly on the card through the benchmark's own
command, with its result line checked. Needs an NVIDIA card; skips without
one."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def one_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"] if w["chips"] == 1])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(one_card, cell, trace):
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
                        "2147483711", "--seconds", "2", "--trace", str(trace)],
                       cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0, out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert list(out)[-1] == "checks"
    if trace:
        assert out["device"]["busy_s"] > 0 and out["breakdown"]["device_ops"]
