"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have (`benchmark/faults.py`), planted in the
program (tiny configurations, on the CPU, the harness's look for a card
skipped)."""

import pytest

from benchmark import faults, run
from benchmark.tests import tiny


def _run(name, **params):
    cell = tiny.cell(name, **params)
    result, numbers = run.run_cell(cell.name, 11, 0.5, False, device="cpu", cell=cell)
    return result["correct"], dict((n, v) for n, v, _ in numbers)


@pytest.mark.parametrize("name", ["v2-48k.convert-batch", "v2-40k.convert-song",
                                  "v2-40k.train"])
def test_sound_run_is_correct(name):
    assert _run(name)[0]


@pytest.mark.parametrize("name,fault", [
    ("v2-48k.convert-batch", "convert_half_batch"),
    ("v2-48k.convert-batch", "convert_wave_altered"),
    ("v2-48k.convert-batch", "convert_pitch_altered"),
    ("v2-40k.convert-song", "convert_wave_altered"),
    ("v2-40k.convert-song", "convert_pitch_altered"),
    ("v2-40k.train", "train_half_batch"),
    ("v2-40k.train", "train_state_unchanged"),
])
def test_fault_is_not_correct(name, fault):
    with faults.FAULTS[fault]():
        correct, numbers = _run(name)
    assert not correct, numbers
    if fault == "train_state_unchanged":
        assert numbers["update_gap"] >= 0.99
