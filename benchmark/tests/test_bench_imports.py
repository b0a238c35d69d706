"""A dry run of each cell's set-up (tiny, CPU) loads nothing whose whole
top-level name is jax, jaxlib, flax or rvc_maker_tpu; the reference
imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import harness

SCRIPT = """
import sys
from benchmark import harness, run
from benchmark.tests import tiny
cell = tiny.cell(sys.argv[1])
ctx = run.Ctx(cell, 7, "cpu", False)
harness.generator(cell).setup(ctx)
bad = harness.forbidden_loaded()
print("LOADED", ",".join(bad))
sys.exit(1 if bad else 0)
"""


@pytest.mark.parametrize("name", [w["name"] for w in harness.manifest()["workloads"]])
def test_setup_loads_no_jax(name):
    p = subprocess.run([sys.executable, "-c", SCRIPT, name], cwd=str(harness.ROOT),
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-4000:]
    assert "LOADED \n" in p.stdout


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_no_program():
    for path in (harness.BENCH_DIR / "reference").glob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "rvc_maker_tpu",
                                     "rvc_maker_tpu_torch", "benchmark"}, path


def test_no_benchmark_file_imports_jax():
    for path in harness.BENCH_DIR.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "rvc_maker_tpu"}, path
