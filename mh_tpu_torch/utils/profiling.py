"""Profiling and timing instrumentation (counterpart of ``mh_tpu.utils.profiling``).

A phase timer on the host clock that must see the device finish before it
reads the clock (CUDA work returns before it is done, so a phase ends with
:func:`force_completion` of what it made), a thin wrapper over
``torch.profiler`` that writes a Chrome trace, and :func:`span`, the named
ranges the package opens on its own call path. Kernel times on the card
come from CUDA events (``chip_smoke.py``), not from these.

``suggest_layouts`` opens these spans on the caller's thread, nested by
time, which a trace shows on the clock of the card's kernels and copies
(the Chrome trace :func:`trace` writes, or any ``torch.profiler`` run):

- ``mh.suggest_layouts``: the whole call; its self time is the dispatch
  (argument checks, ``Scene.to``, the mask counts read back once per
  scene, the engine choice, ``chain_mesh()``, logging);
- ``mh.scene_build``: ``SceneSpec.build`` and ``initial_pose`` when a
  ``SceneSpec`` is passed;
- ``mh.pack_scene``: ``pack_scene``, once per distinct device: the lookup
  in the scene's memo and, where it holds no valid packing, the scene's
  host reads, packing and uploads;
- ``mh.pack_hit``: inside ``mh.pack_scene``, opened only where the memo
  held the packing (none opens on a packing made afresh);
- ``mh.launch``: the fused kernel's launch wrapper, once per shard (on the
  CPU, the plain version's run);
- ``mh.off_state`` / ``mh.off_rows``: inside ``mh.launch``, a range of no
  work opened only in a weighted FIXED launch (the off-limits term in the
  loop): ``mh.off_state`` where the kernel keeps the off-limits slab state,
  ``mh.off_rows`` where it sums the slab rows from scratch;
- ``mh.blocks_per_sm.<k>``: inside ``mh.launch``, a range of no work
  opened once a launch of the CUDA kernel (none on the CPU): ``k`` blocks
  of the launch fit one SM at its shared memory, as CUDA's occupancy
  calculator gives it (asked once per card and shared-memory size);
- ``mh.split``: the shared start expanded and each shard's slice moved to
  its card (a mesh, or every card);
- ``mh.gather``: the shards' outputs joined on the first shard's card;
- ``mh.readback``: the fused result copied into the ``LayoutResult``;
- ``mh.readback_pinned``: inside ``mh.readback``, a range of no work
  opened only where the result, on a card, went into page-locked host
  memory with one wait for every copy (none opens on a CPU result).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

from mh_tpu_torch.utils.checkpoint import flatten

_NO_SPAN = contextlib.nullcontext()


def force_completion(tree) -> None:
    """Wait until every CUDA device that holds a tensor of ``tree`` (a
    state, tuple, dict or tensor) has finished its queued work."""
    for dev in {t.device for t in flatten(tree).values() if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


def span(name: str):
    """A context manager that records the block as ``name`` while
    ``torch.profiler`` runs, and does nothing otherwise (one shared no-op
    context; a check of the profiler's flag is all it costs).

    The range is function-scoped (``_RecordFunctionFast``), a host op like
    an aten op. A user-scope ``torch.profiler.record_function`` is not
    used: the profiler gives each such range a copy on the card's
    timeline spanning the device work launched inside it, so a trace
    would count the whole call as card activity. The range belongs to the
    calling thread.
    """
    if _autograd_profiler._is_profiler_enabled:
        return _RecordFunctionFast(name)
    return _NO_SPAN


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
