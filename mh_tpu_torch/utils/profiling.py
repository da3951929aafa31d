"""Profiling and timing instrumentation (counterpart of ``mh_tpu.utils.profiling``).

A phase timer on the host clock that must see the device finish before it
reads the clock (CUDA work returns before it is done, so a phase ends with
:func:`force_completion` of what it made), and a thin wrapper over
``torch.profiler`` that writes a Chrome trace. Kernel times on the card
come from CUDA events (``chip_smoke.py``), not from these.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict

import torch

from mh_tpu_torch.utils.checkpoint import flatten


def force_completion(tree) -> None:
    """Wait until every CUDA device that holds a tensor of ``tree`` (a
    state, tuple, dict or tensor) has finished its queued work."""
    for dev in {t.device for t in flatten(tree).values() if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulating wall-clock timer per named phase.

    >>> timer = PhaseTimer()
    >>> with timer.phase("propose+cost"):
    ...     out = step(x)
    ...     force_completion(out)
    >>> timer.report()
    """

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:24s} {t * 1e3:10.2f} ms total  {t / c * 1e3:8.3f} ms/call  x{c}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` over the block, CPU activity and, where there is
    a card, CUDA activity; on exit it writes ``trace.json`` (Chrome trace
    format) into ``log_dir`` (default ``mh_tpu_torch_trace`` in the
    temporary directory) and yields the directory."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "mh_tpu_torch_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
