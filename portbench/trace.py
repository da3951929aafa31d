"""What a ``--trace 1`` run reads from ``torch.profiler``: the benchmark's
own call spans, the card's kernels and copies, and the host's ops.

Times are microseconds on the profiler's clock, which puts the card's
activity and the host's ops on one timeline. The traced window runs from
the first traced call's start to the last one's end.
"""

from __future__ import annotations

import heapq
from collections import defaultdict

CALL_SPAN = "portbench.call"


def merge(intervals):
    """Sorted, non-overlapping union of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def covered(intervals, lo, hi) -> float:
    """Length of ``[lo, hi]`` that the merged ``intervals`` cover."""
    return sum(e - s for s, e in clip(intervals, lo, hi))


class Trace:
    """The events of one profiled stretch of calls.

    ``calls``: the benchmark's call spans; ``device``: ``(name, card,
    start, end)`` of every kernel, copy and set on the cards; ``host``:
    ``(name, start, end)`` of every other host op."""

    def __init__(self, calls, device, host, cards: int):
        self.calls = sorted(calls)
        self.device = device
        self.host = host
        self.cards = cards
        self.window = (self.calls[0][0], self.calls[-1][1]) if self.calls else (0.0, 0.0)

    @classmethod
    def from_profiler(cls, prof, cards: int) -> "Trace":
        from torch.autograd import DeviceType

        calls, device, host = [], [], []
        for e in prof.events():
            tr = e.time_range
            if e.name == CALL_SPAN:
                # the span's copy on the card's timeline is no device work
                if e.device_type != DeviceType.CUDA:
                    calls.append((tr.start, tr.end))
            elif e.device_type == DeviceType.CUDA:
                device.append((e.name, e.device_index, tr.start, tr.end))
            else:
                host.append((e.name, tr.start, tr.end))
        return cls(calls, device, host, cards)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self, card=None):
        """Merged intervals in which ``card`` (default: any card) runs a
        kernel or a copy, clipped to the window."""
        return clip(merge((s, e) for _, c, s, e in self.device if card is None or c == card),
                    *self.window)

    def busy_us_per_card(self) -> list[float]:
        """Busy time of each card the run uses, cards with no activity as 0."""
        by_card = defaultdict(list)
        for _, c, s, e in self.device:
            by_card[c].append((s, e))
        cards = sorted(by_card)[:self.cards]
        times = [covered(merge(by_card[c]), *self.window) for c in cards]
        return times + [0.0] * (self.cards - len(times))

    def kernels(self, name: str = ""):
        """Durations of the kernels (not copies or sets) whose name holds
        ``name``, inside the window."""
        lo, hi = self.window
        return [e - s for n, _, s, e in self.device
                if name in n and not n.startswith(("Memcpy", "Memset")) and s >= lo and e <= hi]

    def device_ops(self, top: int = 10):
        """``[name, seconds]`` of the device ops that took the most time."""
        total = defaultdict(float)
        for n, _, s, e in self.device:
            total[n[:120]] += (e - s) * 1e-6
        return sorted(([n, t] for n, t in total.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        """``[host op, seconds]``: the card's idle time inside the window,
        each gap named by the innermost host op running at its middle
        (``python`` where only the call span was), summed by name and
        averaged over the cards."""
        gaps = []
        cards = sorted({c for _, c, _, _ in self.device})[:self.cards] or [None]
        for c in cards:
            edge = self.window[0]
            for s, e in self.busy(c) + [(self.window[1], self.window[1])]:
                if s > edge:
                    gaps.append((edge, s))
                edge = max(edge, e)
        spans = sorted([(s, e, n) for n, s, e in self.host]
                       + [(s, e, "python") for s, e in self.calls])
        total = defaultdict(float)
        active, i = [], 0
        for mid, length in sorted(((s + e) / 2, e - s) for s, e in gaps):
            while i < len(spans) and spans[i][0] <= mid:
                heapq.heappush(active, (-spans[i][0], spans[i][1], spans[i][2]))
                i += 1
            while active and active[0][1] < mid:
                heapq.heappop(active)
            total[active[0][2] if active else "outside calls"] += length * 1e-6 / len(cards)
        return sorted(([n, t] for n, t in total.items()), key=lambda kv: -kv[1])[:top]
