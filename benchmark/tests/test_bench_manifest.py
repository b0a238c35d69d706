"""The manifest and the files it names: every cell loads from its files,
and the manifest keeps to the benchmark contract's shapes."""

import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_loads_from_its_files():
    man = harness.manifest()
    for w in man["workloads"]:
        cell = harness.load_cell(w["name"], man)
        gen = harness.generator(cell)
        for fn in ("setup", "window", "check", "control"):
            assert callable(getattr(gen, fn)), (w["name"], fn)
        assert cell.config["name"] == w["config"]
        assert cell.per_layer and any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert any(m["name"] != "setup_s" for m in cell.end_to_end)
        for m in cell.per_layer:
            assert callable(harness.metric_reader(m["name"]).read)
            assert m["moves"] in {e["name"] for e in cell.end_to_end}, (w["name"], m["name"])


def test_manifest_shapes():
    man = harness.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in man[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/")
        assert any(w["config"] == c["name"] for w in man["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("name", [w["name"] for w in harness.manifest()["workloads"]])
def test_cell_limits_are_set(name):
    cell = harness.load_cell(name)
    assert cell.params["limits"] and all(v > 0 for v in cell.params["limits"].values())
