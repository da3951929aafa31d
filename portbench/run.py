"""Run one benchmark cell once and print its result as one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. ``BENCHMARK.json`` names the cell's configuration and traffic mix;
each is a file of its own (``portbench/configs/<config>.json``,
``portbench/traffic/<mix>.json``), the traffic names its entry
(``portbench/entries/<entry>.py``), and each metric is read by
``portbench/metrics/<metric>.py``.

Set-up (timed as ``setup_s``, from process start): imports, the program's
objects for the cell (which build or load the CUDA library at the first
call) and warm-up calls of the cell's own shapes. With ``--trace 0`` one
caller then makes calls back to back for ``--seconds``, each with a fresh
key drawn from ``--seed`` and the call's index, and the run reports the
cell's end-to-end metrics. With ``--trace 1`` the same window runs, then
``torch.profiler`` records the calls the traffic file names, and the run
reports the cell's per-layer metrics, read from the trace or the window.
Either way a sample of the calls, drawn from the seed, is then
replayed by the plain reference (``portbench/reference``) and judged
(``portbench/judge.py``); each number compared is printed beside its limit
as the last lines of standard error and under ``checks``, the result's
last key.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".portbench_cache"
# top-level module names no run may hold once its window has closed
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "mh_tpu"})
KEY_STREAM, WARMUP_STREAM, SAMPLE_STREAM = 0, 1, 2
M_TRIM_THRESHOLD = -1  # glibc's mallopt parameter


def cell_spec(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``: its chips, configuration,
    traffic and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise ValueError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def applies(m):
        return name in m.get("workloads", [name])

    return dict(name=name, chips=cell["chips"],
                config=json.loads((root / cfg["file"]).read_text()),
                traffic=json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
                end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                per_layer=[m for m in bench["per_layer"] if applies(m)])


def load_reader(metric: str):
    """``portbench/metrics/<metric>.py``: its ``read(ctx)`` returns the
    metric's value, or None where it finds nothing to read."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def key_stream(seed: int, stream: int):
    """Fresh int keys below 2^31, the i-th from ``seed``, ``stream`` and i."""
    rng = np.random.default_rng([seed % 2**64, stream])
    while True:
        yield int(rng.integers(0, 2**31))


class Reservoir:
    """A uniform sample of ``k`` of the calls offered, drawn from the seed,
    kept as host records. Each kept record is copied into buffers made in
    set-up from a warm-up call's record, so keeping a sample allocates
    nothing in the window and holds none of the program's results."""

    def __init__(self, k: int, seed: int, template: dict):
        self.k, self.seen = k, 0
        self.slots = [{n: np.empty_like(a) for n, a in template.items()} for _ in range(k)]
        self.keys = []
        self.rng = np.random.default_rng([seed % 2**64, SAMPLE_STREAM])

    def offer(self, key: int, record) -> None:
        """``record()`` gives the call's record; it runs only for a call kept."""
        j = len(self.keys) if len(self.keys) < self.k else int(self.rng.integers(0, self.seen + 1))
        self.seen += 1
        if j >= self.k:
            return
        rec = record()
        slot = self.slots[j]
        if all(rec[n].shape == slot[n].shape and rec[n].dtype == slot[n].dtype for n in slot):
            for n in slot:
                np.copyto(slot[n], rec[n])
        else:  # a result of another shape is kept as it is, for the judge to see
            self.slots[j] = rec
        if j == len(self.keys):
            self.keys.append(key)
        else:
            self.keys[j] = key

    @property
    def kept(self) -> list:
        return list(zip(self.keys, self.slots))


@dataclasses.dataclass
class WindowContext:
    latencies_s: list
    proposals: int
    span_s: float
    setup_s: float


@dataclasses.dataclass
class TraceContext:
    trace: object
    config: dict
    traffic: dict
    keys: list
    steps_per_call: int
    window: WindowContext

    def count(self, kernel: str):
        return importlib.import_module(f"portbench.counts.{kernel}")


def synchronize(device: str) -> None:
    import torch

    if device == "cuda":
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda") -> dict:
    """One run of the cell ``spec`` (see :func:`cell_spec`); returns the
    result object. ``device`` is where the program and the reference run:
    ``"cuda"`` in a benchmark run, ``"cpu"`` in the tests."""
    import torch

    config, traffic = spec["config"], spec["traffic"]
    if traffic.get("loop", {}).get("kind", "closed") != "closed" or \
            traffic.get("loop", {}).get("clients", 1) != 1:
        raise ValueError("the harness drives a closed loop with one caller")
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    t_imports = time.perf_counter()
    program = entry.setup(config, traffic, device)
    t_program = time.perf_counter()
    warm = key_stream(seed, WARMUP_STREAM)
    if traffic["warmup_calls"] < 1:
        raise ValueError("a traffic mix warms up with one call or more")
    for _ in range(traffic["warmup_calls"]):
        result = entry.call(program, next(warm))
    template = entry.record(traffic, result)
    synchronize(device)
    setup_s = time.perf_counter() - T0
    say(f"set-up {setup_s:.3f} s: imports {t_imports - T0:.3f}, program "
        f"{t_program - t_imports:.3f}, {traffic['warmup_calls']} warm-up calls "
        f"{T0 + setup_s - t_program:.3f}")
    if device == "cuda":
        for d in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(d)

    keys = key_stream(seed, KEY_STREAM)
    sample = Reservoir(traffic["check_calls"], seed, template)
    result = template = None
    latencies, failed = [], 0
    per_call = entry.proposals(traffic)
    t_start = t_last = time.perf_counter()
    while t_last - t_start < seconds or not latencies and not failed:
        key = next(keys)
        t0 = time.perf_counter()
        try:
            result = entry.call(program, key)
        except Exception:  # a failed call is counted and the loop goes on
            failed += 1
            if failed == 1:
                traceback.print_exc()
            t_last = time.perf_counter()
            continue
        t_last = time.perf_counter()
        latencies.append(t_last - t0)
        sample.offer(key, lambda: entry.record(traffic, result))
    attempted = len(latencies) + failed
    window = WindowContext(latencies, per_call * len(latencies), t_last - t_start, setup_s)
    lat_ms = [round(v * 1e3, 3) for v in latencies]
    say(f"window: {len(latencies)} calls completed, {failed} failed, over "
        f"{t_last - t_start:.3f} s; call ms min {min(lat_ms, default=0)} median "
        f"{float(np.median(lat_ms)) if lat_ms else 0} max {max(lat_ms, default=0)}, first "
        f"{lat_ms[:3]}, last {lat_ms[-3:]}")
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench.trace import CALL_SPAN, Trace

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        traced = []
        with profile(activities=acts) as prof:
            for _ in range(traffic["trace_calls"]):
                key = next(keys)
                with record_function(CALL_SPAN):
                    result = entry.call(program, key)
                traced.append(key)
                sample.offer(key, lambda: entry.record(traffic, result))
        t_read = time.perf_counter()
        tr = Trace.from_profiler(prof, spec["chips"])
        del prof
        ctx = TraceContext(tr, config, traffic, traced, entry.steps(traffic), window)
        metrics = read_metrics(spec["per_layer"], ctx)
        say(f"trace: {len(tr.device)} device ops, {len(tr.host)} host ops over "
            f"{len(traced)} calls, read in {time.perf_counter() - t_read:.3f} s")
        attempted += len(traced)
    else:
        metrics = read_metrics(spec["end_to_end"], window)

    dev = device_fields(device, spec["chips"])
    if trace:
        busy = tr.busy_us_per_card()
        dev.update(busy_s=sum(busy) / len(busy) * 1e-6, window_s=tr.window_us * 1e-6)

    # the program's state goes before the reference runs on the same card
    kept = sample.kept
    result = program = sample = None
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    from portbench import judge

    want = entry.expected(config, traffic, [k for k, _ in kept], device, torch.float32)
    got = [r for _, r in kept]
    values, rows = judge.numbers(got, want, entry.objective(config, traffic, got, device))
    ok, checks = judge.verdict(values, traffic["limits"])
    say(f"reference: {len(kept)} calls, {rows} chains checked in "
        f"{time.perf_counter() - t_ref:.3f} s")
    out = dict(correct=bool(ok and rows > 0 and failed == 0), attempted=attempted, failed=failed,
               metrics=metrics, device=dev)
    if trace:
        out["breakdown"] = dict(device_ops=tr.device_ops(), idle_gaps=tr.idle_gaps())
    out["checks"] = checks
    return out


def read_metrics(specs: list[dict], ctx) -> dict:
    out = {}
    for m in specs:
        value = load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def device_fields(device: str, chips: int) -> dict:
    import torch

    if device != "cuda":
        return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    peak = max(torch.cuda.max_memory_allocated(d) for d in range(torch.cuda.device_count()))
    out = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips,
               memory_peak_bytes=int(peak))
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30, check=True)
        out["power_limit_w"] = [float(v) for v in smi.stdout.split()][:chips]
    except (OSError, subprocess.SubprocessError, ValueError):
        pass
    return out


def say(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def prepare_environment(chips: int) -> None:
    """Before torch is imported: the cards the cell asks for, every kernel
    and build cache at a fixed place inside the checkout, and one malloc
    policy for every process. glibc's dynamic thresholds decide per
    process whether a freed multi-megabyte result goes back to the OS, so
    one process page-faults its readback each call and the next does not;
    a fixed trim threshold makes each map its large results afresh."""
    try:
        ctypes.CDLL(None).mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except (OSError, AttributeError):  # not glibc: its own policy stands
        pass
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", ",".join(str(i) for i in range(chips)))
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(args.workload)
    prepare_environment(spec["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        say(f"{args.workload} needs {spec['chips']} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 2
    torch.set_num_threads(1)
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        say(f"the run loaded modules of JAX or the JAX package: {', '.join(bad)}")
        return 3
    for name, c in out["checks"].items():
        say(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
