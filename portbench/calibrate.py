"""The readings a cell's limits are set from, in one process on the card:

    python3 -m portbench.calibrate --workload <cell> --program-seeds 1,2,... --control-seeds 3,4,...

For each program seed the program makes the calls a run of that seed
starts with (as many as the run checks) and the judge's numbers are
printed: the largest over sound runs is a limit's lower reading. For each
control seed the reference computed in bfloat16, one precision below the
configuration's float32, stands in the program's place for the same calls:
the smallest of its numbers is the upper reading. One JSON line per seed,
then one with the largest program and the smallest control readings.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from portbench import judge, run


def readings(entry, spec: dict, keys: list[int], results: list) -> dict:
    config, traffic = spec["config"], spec["traffic"]
    want = entry.expected(config, traffic, keys, "cuda", torch.float32)
    values, rows = judge.numbers(results, want, entry.objective(config, traffic, results, "cuda"))
    return dict(rows=rows, **values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    spec = run.cell_spec(args.workload)
    run.prepare_environment(spec["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} CUDA card(s)", file=sys.stderr)
        return 2
    config, traffic = spec["config"], spec["traffic"]
    entry = importlib.import_module(f"portbench.entries.{traffic['entry']}")
    program = entry.setup(config, traffic, "cuda")
    entry.call(program, 0)
    worst, least = {}, {}
    for kind, seeds in (("program", args.program_seeds), ("control", args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            stream = run.key_stream(seed, run.KEY_STREAM)
            keys = [next(stream) for _ in range(traffic["check_calls"])]
            if kind == "program":
                results = [entry.record(traffic, entry.call(program, k)) for k in keys]
            else:
                results = entry.expected(config, traffic, keys, "cuda", torch.bfloat16)
            r = readings(entry, spec, keys, results)
            print(json.dumps(dict(kind=kind, seed=seed, **r)), flush=True)
            pick = worst if kind == "program" else least
            for k in traffic["limits"]:
                pick[k] = (max if kind == "program" else min)(pick.get(k, r[k]), r[k])
    print(json.dumps(dict(workload=args.workload, program_largest=worst, control_smallest=least,
                          limits=traffic["limits"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
