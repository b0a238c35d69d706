"""The result line: its keys, the compared numbers last on stderr and in
the line, and no result without a card (tiny configuration, CPU)."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness, run
from benchmark.tests import tiny

ROOT = str(harness.ROOT)


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace, capsys):
    cell = tiny.cell("v2-48k.convert-batch")
    result, numbers = run.run_cell(cell.name, 3, 0.5, trace, device="cpu", cell=cell)
    harness.emit(result, numbers)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown", "compared"] if trace else ["compared"]
    assert list(line) == want
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert line["correct"] is True
    assert err.strip().splitlines()[-len(numbers):] == [
        f"compared {n} {v!r} limit {lim!r}" for n, v, lim in numbers]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "v2-48k.convert-batch",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
