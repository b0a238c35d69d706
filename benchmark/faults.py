"""Faults planted in the program, to read what a broken timed path
gives: the fault test (`tests/test_bench_faults.py`, tiny, CPU) and
`calibrate.py --fault` (the card, the cell's own size) apply them the
same way.  Each is a context manager that patches the port for the
block's duration."""

from __future__ import annotations

import contextlib
import dataclasses


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def train_half_batch():
    """Each step sees the first half of its batch's rows; the means are
    taken over them."""
    from rvc_maker_tpu_torch.pipelines import train as ptrain

    make = ptrain.make_train_step

    def halved(cfg, *a, **kw):
        step = make(cfg, *a, **kw)

        def run_half(state, batch, *, noise=None, **k):
            h = batch.spec.shape[0] // 2
            batch = dataclasses.replace(batch, **{f.name: getattr(batch, f.name)[:h]
                                                  for f in dataclasses.fields(batch)})
            noise = {"post_noise": noise["post_noise"][:h], "ids_slice": noise["ids_slice"][:h],
                     "dec_noise": {"sine": noise["dec_noise"]["sine"][:h]}}
            return step(state, batch, noise=noise, **k)
        return run_half
    return _patched(ptrain, "make_train_step", halved)


def train_state_unchanged():
    """Every optimizer update is dropped: the step leaves its state as it
    was."""
    from rvc_maker_tpu_torch.pipelines import train as ptrain

    return _patched(ptrain, "_apply", lambda *a, **kw: None)


def convert_half_batch():
    """The second half of each batch's rows come back silent."""
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline

    inner = ConvertPipeline._convert_rows

    def half(self, *a, **kw):
        wav, pitchf = inner(self, *a, **kw)
        wav[wav.shape[0] // 2:] = 0.0
        return wav, pitchf
    return _patched(ConvertPipeline, "_convert_rows", half)


def convert_wave_altered():
    """One sample of one row's waveform moved by 0.05 where the
    synthesizer produces it."""
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline

    inner = ConvertPipeline._synth

    def altered(self, *a, **kw):
        wav, pitchf = inner(self, *a, **kw)
        wav[0, wav.shape[1] // 2] += 0.05
        return wav, pitchf
    return _patched(ConvertPipeline, "_synth", altered)


def convert_pitch_altered():
    """One row's pitch a semitone up where the F0 stage produces it."""
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline

    inner = ConvertPipeline._f0

    def altered(self, *a, **kw):
        f0 = inner(self, *a, **kw)
        f0[0] = f0[0] * 2 ** (1 / 12)
        return f0
    return _patched(ConvertPipeline, "_f0", altered)


FAULTS = {"train_half_batch": train_half_batch, "train_state_unchanged": train_state_unchanged,
          "convert_half_batch": convert_half_batch, "convert_wave_altered": convert_wave_altered,
          "convert_pitch_altered": convert_pitch_altered}
