"""The port's host audio tools against the JAX package's: each effect of
`rvc_maker_tpu_torch/utils/effects.py`, `apply_effects` with every
effect on, `cli effects`, and the phase-vocoder `utils/pitchshift.py`
(`shift_pitch`, `formant_shift`), each within 1e-6 on the same numpy
input."""

import dataclasses

import numpy as np
import pytest

from rvc_maker_tpu.cli import main as jax_main
from rvc_maker_tpu.utils import effects as jfx
from rvc_maker_tpu.utils import pitchshift as jps
from rvc_maker_tpu_torch import cli
from rvc_maker_tpu_torch.utils import effects as fx
from rvc_maker_tpu_torch.utils import pitchshift as ps
from rvc_maker_tpu_torch.utils.audio import read_wav, save_wav

ATOL = 1e-6
SR = 16000


def _tone(seconds=0.6, sr=SR, seed=0):
    rs = np.random.RandomState(seed)
    tt = np.arange(int(sr * seconds)) / sr
    x = 0.4 * np.sin(2 * np.pi * 220 * tt) + 0.2 * np.sin(2 * np.pi * 1500 * tt)
    return (x * np.minimum(1.0, 4 * tt) + 0.02 * rs.randn(len(tt))).astype(np.float32)


EFFECTS = {
    "highpass": (SR, 80.0),
    "gain": (-4.0,),
    "distortion": (18.0,),
    "clipping": (-8.0,),
    "bitcrush": (6,),
    "delay": (SR, 0.1, 0.4, 0.5),
    "chorus": (SR, 1.5, 0.5, 10.0, 0.2, 0.5),
    "phaser": (SR, 1.0, 0.5, 1300.0, 0.3, 0.5),
    "compressor": (SR, -24.0, 4.0, 1.0, 100.0),
    "limiter": (SR, -6.0, 100.0),
    "bass_boost": (SR, 6.0, 200.0),
    "treble_boost": (SR, 4.0, 3000.0),
    "fade_in": (SR, 0.2),
    "fade_out": (SR, 0.2),
    "reverb": (SR, 0.6, 0.4, 0.3, 0.5, 1.0, 0.0),
}


@pytest.mark.parametrize("name", list(EFFECTS))
def test_effect_matches_jax(name):
    x = _tone()
    got = getattr(fx, name)(x.copy(), *EFFECTS[name])
    ref = getattr(jfx, name)(x.copy(), *EFFECTS[name])
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert name in ("fade_in", "fade_out") or np.abs(got - x).max() > 1e-4


def _all_on(settings_cls, **extra):
    on = {f.name: True for f in dataclasses.fields(settings_cls) if f.type in (bool, "bool")}
    return settings_cls(**on, pitch_shift=3.0, gain_db=-2.0, bass_boost_db=3.0,
                        treble_boost_db=2.0, fade_in_duration=0.1, fade_out_duration=0.1,
                        **extra)


@pytest.mark.parametrize("resample_sr", [0, 22050])
def test_apply_effects_every_effect_matches_jax(resample_sr):
    x = _tone(0.8, seed=1)
    got, sr = fx.apply_effects(x, SR, _all_on(fx.EffectsSettings, resample_sr=resample_sr))
    ref, jsr = jfx.apply_effects(x, SR, _all_on(jfx.EffectsSettings, resample_sr=resample_sr))
    assert sr == jsr == (resample_sr or SR)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert [f.name for f in dataclasses.fields(fx.EffectsSettings)] == \
        [f.name for f in dataclasses.fields(jfx.EffectsSettings)]


def test_cli_effects_matches_jax(tmp_path):
    """`cli effects` with flags of every kind writes JAX's file."""
    save_wav(str(tmp_path / "in.wav"), np.stack([_tone(seed=2), _tone(seed=3)], 1), SR)
    flags = ["--reverb", "--reverb-room-size", "0.7", "--gain", "--gain-db", "-3",
             "--bitcrush", "--bitcrush-bit-depth", "7", "--pitchshift", "--pitch-shift", "2",
             "--resample-sr", "24000"]
    assert cli.main(["effects", "--input", str(tmp_path / "in.wav"),
                     "--output", str(tmp_path / "p.wav"), *flags]) == 0
    jax_main(["effects", "--input", str(tmp_path / "in.wav"),
              "--output", str(tmp_path / "j.wav"), *flags])
    got, sr = read_wav(str(tmp_path / "p.wav"))
    assert sr == 24000 and got.ndim == 1 and np.abs(got).max() > 0.05
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


@pytest.mark.parametrize("factors", [2.0, 0.75, (1.0, 1.5)], ids=["octave", "down", "chord"])
def test_shift_pitch_matches_jax(factors):
    x = _tone(0.5, seed=4)
    got = ps.shift_pitch(x, SR, factors=factors)
    ref = jps.shift_pitch(x, SR, factors=factors)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("quefrency,timbre", [(0.8, 0.8), (1.0, 1.2), (0.5, 1.0)])
def test_formant_shift_matches_jax(quefrency, timbre):
    x = _tone(0.5, seed=5)
    got = ps.formant_shift(x, SR, quefrency=quefrency, timbre=timbre)
    ref = jps.formant_shift(x, SR, quefrency=quefrency, timbre=timbre)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
