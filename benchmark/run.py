#!/usr/bin/env python3
"""Run one benchmark cell of rvc_maker_tpu_torch once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json` "workloads") names a configuration and a
traffic file, `benchmark/workloads/<cell>.json`, whose "generator" names
the module under `benchmark/traffic/` that drives it:

    setup(ctx)            builds the weights from the seed on the card,
                          the program's object and the inputs, and warms
                          every shape the window uses (counted in setup_s)
    window(ctx, seconds)  runs the traffic for `seconds` and returns the
                          end-to-end metrics and what the window did
    check(ctx)            after the window (the program's state freed):
                          the plain reference under `benchmark/reference/`
                          judges a sample of what the window produced;
                          returns [(name, value, limit)]

With --trace 1 the window runs under torch.profiler and the line holds
the cell's per-layer metrics (`benchmark/metrics/<metric>.py`), the
device's busy and window seconds and a breakdown.  The last line of
stdout is one JSON object: correct, attempted, failed, metrics, device
[, breakdown], then the compared numbers with their limits.  Without a
card, or with fewer cards than the cell asks for, the run exits 2 and
prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402


class Ctx:
    """One run's state: the cell, the arguments, the device, and whatever
    the generator keeps between its three calls (`ctx.state`)."""

    def __init__(self, cell, seed: int, device: str, trace: bool):
        self.cell = cell
        self.config = cell.config
        self.params = cell.params
        self.seed = seed
        self.device = device
        self.trace = trace
        self.state: dict = {}


def traced_windows(gen, ctx, seconds: float):
    """The traced run's two windows (`harness.Trace`): the first under
    the profiler with device activity alone, the second, at most
    `harness.RANGE_WINDOW_S` long, with the host's ops as well, for the
    ranges.  Returns the first window's result and the Trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = ctx.device == "cuda"
    kw = {}
    if cuda:
        # no host-op correlation in the first window: less host overhead
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(disable_external_correlation=True)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU],
                 **kw) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen.window(ctx, seconds)
        window_s = time.perf_counter() - t0
    busy_s, kernels = harness.read_device_trace(prof)
    del prof
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(harness.WINDOW_RANGE):
            out_b = gen.window(ctx, min(seconds, harness.RANGE_WINDOW_S))
    range_ms, gaps = harness.read_range_trace(prof, set(out_b.get("ranges", ())))
    del prof
    return out, harness.Trace(busy_s=busy_s, window_s=window_s, kernels=kernels,
                              work=out.get("work", {}), range_ms=range_ms,
                              range_work=out_b.get("work", {}), idle_gaps=gaps)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", cell=None, t_start: float | None = None) -> tuple:
    """One run of a cell: (result dict, compared numbers).  `cell` may
    stand in for the manifest's (tests); `device` "cpu" is for tests."""
    import torch

    t_start = T_START if t_start is None else t_start
    cell = cell or harness.load_cell(cell_name)
    gen = harness.generator(cell)
    ctx = Ctx(cell, seed, device, trace)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    gen.setup(ctx)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # set-up's objects out of the collector's later passes, so that a full
    # collection in the window walks only what the window made
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    if trace:
        out, tr = traced_windows(gen, ctx, seconds)
    else:
        out = gen.window(ctx, seconds)

    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    metrics: dict = {}
    breakdown = None
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": int(cell.entry.get("chips", 1)), "memory_peak_bytes": int(peak)}
    if trace:
        if hasattr(gen, "trace_work"):
            gen.trace_work(ctx, tr.work)
        for m in cell.per_layer:
            v = harness.metric_reader(m["name"]).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": harness.device_ops_top(tr), "idle_gaps": tr.idle_gaps}
        for line in tr.work.get("notes", ()):
            print(line, file=sys.stderr)
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
            elif m["name"] in out["metrics"]:
                metrics[m["name"]] = {"value": float(out["metrics"][m["name"]]),
                                      "unit": m["unit"]}
    # the window is closed and its peak read: free the program's state,
    # then judge a sample of what it produced against the reference
    gen_free = getattr(gen, "free", None)
    if gen_free is not None:
        gen_free(ctx)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    gc.unfreeze()
    numbers = gen.check(ctx)
    correct = all(harness.finite(v) and v <= lim for _, v, lim in numbers) and bool(numbers)
    result = {"correct": correct, "attempted": int(out["attempted"]),
              "failed": int(out.get("failed", 0)), "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, numbers


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    harness.env_setup()
    cell = harness.load_cell(args.workload)

    import torch

    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result, numbers = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               cell=cell)
    bad = harness.forbidden_loaded()
    if bad:
        print("no result: the run loaded " + ", ".join(bad), file=sys.stderr)
        return 3
    harness.emit(result, numbers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
