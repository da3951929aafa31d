"""One torch intra-op thread in every process that runs the port's CPU tests.

The suite runs in several pytest-xdist workers at once on one machine. The
plain versions' ops are small, so torch's default pool (one thread per
core) in each worker only adds synchronisation: the workers' threads wait
on each other, and a test that takes seconds alone takes minutes in the
suite. Every ``tests/test_torch_*.py`` that runs on the CPU imports this
module, so one rule holds in the xdist run and in a single file run alike.
``OMP_NUM_THREADS`` and ``MKL_NUM_THREADS`` go into ``os.environ`` too, so
the processes the tests start (workers, examples, the CLI, the native C
hosts) build their env from it and start with one thread as well.

The program itself sets nothing: its CPU callers keep torch's defaults.
"""

from __future__ import annotations

import os
import subprocess
import sys

THREADS = 1

os.environ["OMP_NUM_THREADS"] = str(THREADS)
os.environ["MKL_NUM_THREADS"] = str(THREADS)

import torch  # noqa: E402

torch.set_num_threads(THREADS)


def test_one_thread_here_and_in_children():
    """The test process and a child started with ``os.environ`` each run
    torch on one intra-op thread."""
    assert torch.get_num_threads() == THREADS
    child = subprocess.run(
        [sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
        env=os.environ, capture_output=True, text=True, timeout=120, check=True)
    assert child.stdout.split() == [str(THREADS)], child.stdout + child.stderr
