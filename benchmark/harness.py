"""The benchmark's shared machinery: the manifest, the cells' files, the
device, the profiler's trace and the result line.

Everything that belongs to one cell, traffic kind or per-layer metric
lives in a file of its own, found by name:

    BENCHMARK.json                          the manifest (repo root)
    benchmark/configs/<config>.json         one model configuration
    benchmark/workloads/<cell>.json         one cell's traffic parameters
    benchmark/traffic/<generator>.py        the generator a cell names
    benchmark/metrics/<metric>.py           one per-layer metric's reader

A generator module has `setup(ctx)`, `window(ctx, seconds)` and
`check(ctx)` (module docstring of `run.py`).  A metric reader has
`read(trace) -> float | None`; None leaves the metric out of the line.
"""

from __future__ import annotations

import bisect
import importlib.util
import json
import math
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "rvc_maker_tpu")


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path, name: str | None = None):
    """A module from a file of the benchmark (names may hold dots)."""
    name = name or "bench_" + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    entry: dict                 # the manifest's workload entry
    config: dict                # benchmark/configs/<config>.json
    params: dict                # benchmark/workloads/<cell>.json
    end_to_end: list            # the manifest's end_to_end entries this cell reports
    per_layer: list             # the manifest's per_layer entries this cell reports


def _reports(metric: dict, cell: str, e2e_names: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric.get("moves") in e2e_names


def load_cell(name: str, man: dict | None = None) -> Cell:
    man = man or manifest()
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}: BENCHMARK.json has "
                         + ", ".join(w["name"] for w in man["workloads"]))
    cfg_entry = next(c for c in man["configs"] if c["name"] == entry["config"])
    config = load_json(ROOT / cfg_entry["file"])
    params = load_json(BENCH_DIR / "workloads" / f"{name}.json")
    e2e = [m for m in man["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _reports(m, name, names)]
    return Cell(name, entry, config, params, e2e, per_layer)


def generator(cell: Cell):
    return load_module(BENCH_DIR / "traffic" / f"{cell.params['generator']}.py")


def metric_reader(name: str):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py")


def forbidden_loaded() -> list[str]:
    """Modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN_MODULES})


# ---------------------------------------------------------------------------
# the profiler's trace
# ---------------------------------------------------------------------------

WINDOW_RANGE = "bench.window"
# the traced run's second window, whose host ops make the trace long to read
RANGE_WINDOW_S = 10.0


@dataclass
class Trace:
    """What a traced run gives the per-layer readers.

    The traced run has two windows.  The first runs under the profiler
    with device activity only (its host overhead is small): busy_s, the
    union of the device's operation intervals, over window_s, the
    window's length on the host clock (synchronised at both ends);
    kernels, (name, ms) of every device operation; work, what the cell's
    generator says that window did (audio seconds, steps, the resblock
    launches' shapes, the model's operations).  The second, at most
    RANGE_WINDOW_S long, records the host's ops too, which slows the host: range_ms, device ms of the
    kernels launched while each named host range was open, on any thread
    (so a backward that autograd launches from its own thread counts in
    the range that waits for it), over range_work, what that window did;
    idle_gaps, its longest idle gaps, named by the host op open at their
    middle."""

    busy_s: float
    window_s: float
    kernels: list
    work: dict = field(default_factory=dict)
    range_ms: dict = field(default_factory=dict)
    range_work: dict = field(default_factory=dict)
    idle_gaps: list = field(default_factory=list)

    def kernel_ms(self, pattern: str) -> list[float]:
        return [ms for name, ms in self.kernels if pattern in name]


def _union_ns(intervals: list[tuple[int, int]], lo: int, hi: int) -> int:
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def read_device_trace(prof) -> tuple[float, list]:
    """(busy seconds, [(name, ms)]) of every device operation a finished
    profile recorded."""
    from torch.autograd import DeviceType

    ops = [(e.start_ns(), e.end_ns(), e.name()) for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    if not ops:
        return 0.0, []
    busy = _union_ns([(s, e) for s, e, _ in ops], min(o[0] for o in ops), max(o[1] for o in ops))
    return busy / 1e9, [(n, (e - s) / 1e6) for s, e, n in ops]


def read_range_trace(prof, range_names, n_gaps: int = 10) -> tuple[dict, list]:
    """(range_ms, idle_gaps) from a finished torch.profiler.profile over
    one window held in a `WINDOW_RANGE` record_function range."""
    from torch.autograd import DeviceType

    device, launches, ranges, cpu_main, window = [], {}, [], [], None
    thread_counts: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.start_ns(), e.end_ns(), e.name(), e.linked_correlation_id()))
            continue
        if e.device_type() != DeviceType.CPU:
            continue
        name = e.name()
        if name == WINDOW_RANGE:
            window = (e.start_ns(), e.end_ns())
        elif name in range_names:
            ranges.append((e.start_ns(), e.end_ns(), name))
        if e.linked_correlation_id() == 0:
            # the host op a kernel links to (its external correlation)
            launches[e.correlation_id()] = e.start_ns()
        tid = e.start_thread_id()
        thread_counts[tid] = thread_counts.get(tid, 0) + 1
        cpu_main.append((e.start_ns(), e.end_ns(), name, tid))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE!r} range")
    lo, hi = window
    inside = [d for d in device if d[1] > lo and d[0] < hi]
    range_ms = {}
    if ranges:
        ranges.sort()
        starts = [r[0] for r in ranges]
        for s, e, _, corr in inside:
            t = launches.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            # ranges of one name do not nest; look back over the few
            # ranges that may still be open at t
            for j in range(i, max(i - 8, -1), -1):
                rs, re_, rn = ranges[j]
                if rs <= t <= re_:
                    range_ms[rn] = range_ms.get(rn, 0.0) + (e - s) / 1e6
    # the longest idle gaps, named by the innermost host op open at their
    # middle on the thread that ran the most ops
    main = max(thread_counts, key=thread_counts.get) if thread_counts else None
    ops = sorted((s, e, n) for s, e, n, tid in cpu_main if tid == main and n != WINDOW_RANGE)
    gaps, cur = [], lo
    for s, e, _, _ in sorted(inside):
        if s > cur:
            gaps.append((s - cur, cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((hi - cur, cur, hi))
    gaps.sort(reverse=True)
    op_starts = [o[0] for o in ops]
    idle = []
    for length, a, b in gaps[:n_gaps]:
        mid = (a + b) // 2
        what = "host"
        best = None
        for j in range(bisect.bisect_right(op_starts, mid) - 1, -1, -1):
            s, e, n = ops[j]
            if e >= mid and (best is None or s >= best[0]):
                best = (s, n)
            if mid - s > 60e9:
                break
        if best is not None:
            what = best[1]
        idle.append([what, length / 1e9])
    return range_ms, idle


def device_ops_top(trace: Trace, n: int = 10) -> list:
    by: dict = {}
    for name, ms in trace.kernels:
        by[name] = by.get(name, 0.0) + ms / 1e3
    return [[k[:200], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------

def compared_text(numbers: list) -> str:
    return "; ".join(f"{n} {v!r} (limit {lim!r})" for n, v, lim in numbers)


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def emit(result: dict, numbers: list) -> None:
    """The compared numbers as the last lines of stderr, then the result
    as the last line of stdout, its `compared` key last."""
    for n, v, lim in numbers:
        print(f"compared {n} {v!r} limit {lim!r}", file=sys.stderr)
    result = dict(result)
    result["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in numbers}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


HOST_THREADS = "2"


def env_setup() -> None:
    """Keep libraries from loading JAX on their own, and keep the host's
    thread pools small (the load is one process; the card does the
    work).  Call before importing numpy or torch.  The program's only
    build cache is its checkout's `rvc_maker_tpu_torch/_build/`."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, HOST_THREADS)
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
