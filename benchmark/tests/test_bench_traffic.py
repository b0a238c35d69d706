"""Each traffic generator makes the same inputs from the same seed, and
other inputs from another seed (tiny configurations, on the CPU)."""

import numpy as np
import pytest
import torch

from benchmark import harness, run
from benchmark.tests import tiny


def _inputs(name: str, seed: int):
    cell = tiny.cell(name)
    gen = harness.generator(cell)
    ctx = run.Ctx(cell, seed, "cpu", False)
    if name.endswith("train"):
        batches, noises = gen._batches(ctx)
        return [torch.cat([b["wave"].flatten(), b["phone"].flatten(), n["post_noise"].flatten(),
                           n["dec_noise"]["sine"].flatten()]).numpy()
                for b, n in zip(batches, noises)]
    gen.setup_inputs(ctx)
    st = ctx.state
    out = list(st.get("pool", st.get("songs", [])))
    if "noise" in st:
        out += [t.numpy() for pair in st["noise"] for t in pair]
    else:
        out += [st["z"].numpy(), st["sine"].numpy()]
    return out


@pytest.mark.parametrize("name", [w["name"] for w in harness.manifest()["workloads"]])
def test_generator_is_deterministic_per_seed(name):
    a, b, c = _inputs(name, 2 ** 31 + 7), _inputs(name, 2 ** 31 + 7), _inputs(name, 5)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(x.shape != y.shape or not np.array_equal(x, y) for x, y in zip(a, c))


def test_song_lengths_are_one_ladder():
    cell = tiny.cell("v2-40k.convert-song", song_seconds=[2.0, 3.0, 4.0])
    gen = harness.generator(cell)
    lens = []
    for seed in (1, 2, 3, 4):
        ctx = run.Ctx(cell, seed, "cpu", False)
        gen.setup_inputs(ctx)
        lens.append([len(s) for s in ctx.state["songs"]])
    assert all(x == lens[0] for x in lens)
