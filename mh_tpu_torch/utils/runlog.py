"""Structured run logging: a JSONL event stream (counterpart of ``mh_tpu.utils.runlog``).

One JSON object per line, each with a wall-clock ``ts``, an ``event`` kind
and the kind's fields, the same as ``mh_tpu``'s:

- ``run_config``  — engine, sampler config, scene summary (run start)
- ``round``       — periodic chain statistics: accept-rate mean/min/max,
                    step-scale stats, total-cost quantiles (p10/p50/p90)
- ``checkpoint``  — a state save/restore (path, step)
- ``result``      — final layouts summary (run end)

Wire-in points: ``suggest_layouts(..., log=..., log_every=N)`` and the CLI
``--log FILE`` flags. Tensors are read to the host only when an event is
written.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import IO

import numpy as np
import torch


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _jsonable(v):
    if isinstance(v, torch.Tensor):
        v = _host(v)
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _jsonable(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "name") and hasattr(v, "value"):  # Enum
        return v.name
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)


class RunLogger:
    """Append-only JSONL event emitter.

    ``sink`` is a file path (opened in append mode) or any file-like with
    ``write``. One logger per run (not thread-safe).
    """

    def __init__(self, sink: str | IO[str]):
        if isinstance(sink, str):
            self._fh: IO[str] = open(sink, "a")  # noqa: SIM115 — closed in close()
            self._owns = True
        else:
            self._fh = sink
            self._owns = False

    def event(self, kind: str, **fields) -> None:
        rec = {"ts": round(time.time(), 3), "event": kind}
        rec.update({k: _jsonable(v) for k, v in fields.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._owns:
            self._fh.close()

    def __enter__(self) -> "RunLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def log_config(self, cfg, *, engine: str, n_objs: int, n_chains: int, **extra) -> None:
        self.event("run_config", engine=engine, n_objs=n_objs, n_chains=n_chains, config=cfg,
                   **extra)

    def log_round(self, round_idx: int, step: int, states) -> None:
        """Chain statistics from a batched ``MHState``."""
        acc = _host(states.accept_rate).astype(np.float64)
        scale = np.exp(_host(states.log_scale).astype(np.float64))
        total = _host(states.costs.total).astype(np.float64)
        q10, q50, q90 = np.quantile(total, (0.1, 0.5, 0.9))
        self.event(
            "round",
            round=round_idx,
            step=step,
            accept_rate={"mean": acc.mean(), "min": acc.min(), "max": acc.max()},
            step_scale={"mean": scale.mean(), "min": scale.min(), "max": scale.max()},
            cost_total={"p10": q10, "p50": q50, "p90": q90, "best": total.max()},
        )

    def log_checkpoint(self, kind: str, path: str, **extra) -> None:
        self.event("checkpoint", op=kind, path=path, **extra)

    def log_result(self, result, *, engine: str) -> None:
        acc = np.asarray(result.accept_rate, np.float64)
        total = np.asarray(result.costs[:, 0], np.float64)
        self.event(
            "result",
            engine=engine,
            n_suggestions=int(result.points.shape[0]),
            accept_rate={"mean": acc.mean(), "min": acc.min(), "max": acc.max()},
            cost_total={"best": total.max(), "p50": float(np.median(total))},
        )


def as_logger(log) -> RunLogger | None:
    """Coerce a path / file-like / RunLogger / None into a logger."""
    if log is None or isinstance(log, RunLogger):
        return log
    return RunLogger(log)
