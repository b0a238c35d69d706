#!/usr/bin/env python3
"""Readings for a cell's correctness limits, in one process (the kernels
built once): the compared numbers of sound runs of the program over
`--seeds`, and of the control (the cell generator's `control`: the
reference in a lower precision in the program's place) over
`--control-seeds`.  One JSON line per reading, and a summary line.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 101,102,103 [--seconds 3] [--out chiprun_out/x.jsonl]
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import faults, harness, run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--fault", default="", help="a fault of benchmark/faults.py planted "
                    "in the program for the --seeds runs")
    args = ap.parse_args()
    harness.env_setup()
    import torch

    cell = harness.load_cell(args.workload)
    gen = harness.generator(cell)
    out = open(args.out, "a") if args.out else None
    summary = {"control": {}}

    def record(kind, seed, numbers, extra=None):
        line = {"kind": kind, "workload": cell.name, "seed": seed,
                "numbers": {n: v for n, v, _ in numbers}, **(extra or {})}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        for n, v, _ in numbers:
            summary[kind].setdefault(n, []).append(v)

    kind = "fault:" + args.fault if args.fault else "program"
    summary[kind] = {}
    for s in [int(x) for x in args.seeds.split(",") if x]:
        t = time.perf_counter()
        with faults.FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
            res, numbers = run.run_cell(cell.name, s, args.seconds, False, cell=cell, t_start=t)
        record(kind, s, numbers, {"metrics": res["metrics"], "correct": res["correct"]})
        gc.collect()
        torch.cuda.empty_cache()
    for s in [int(x) for x in args.control_seeds.split(",") if x]:
        ctx = run.Ctx(cell, s, "cuda", False)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        record("control", s, gen.control(ctx))
        del ctx
        gc.collect()
        torch.cuda.empty_cache()
    for kind in summary:
        for n, vs in summary[kind].items():
            print(f"{kind} {n}: max {max(vs)!r} min {min(vs)!r} over {len(vs)}", flush=True)
    print(f"calibrate: {time.perf_counter() - T0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
