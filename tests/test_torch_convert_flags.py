"""The rest of the port's `cli convert` against the JAX package's
`cmd_convert`, both on the CPU on the same files: a preset JSON with
every key (formant shifting, the noise gate, autotune, resampling,
split audio, ...) on a stereo FLAC input, exported as FLAC.  The port is
fed the noise the JAX pipeline draws; the decoded outputs agree within
1e-3 plus one int16 step.  Also: every preset key reaches its flag in
both command lines, the `--resample-sr` < 16000 divergence, and no card
without `--device cpu`.  The model is test_torch_app.py's narrow one."""

import json

import numpy as np
import pytest
import torch

from rvc_maker_tpu import cli as jcli
from rvc_maker_tpu.config import ModelConfig as JaxModelConfig
from rvc_maker_tpu.models import hubert as jhubert
from rvc_maker_tpu.utils import presets as jpresets
from rvc_maker_tpu_torch import cli
from rvc_maker_tpu_torch.utils import presets
from rvc_maker_tpu_torch.utils.audio import read_wav, save_wav
from torch_port_util import patch_jax_noise, torch_threads, voice, write_voice_files  # noqa: F401

JCFG = JaxModelConfig(
    spec_channels=129, segment_size=8, inter_channels=32, hidden_channels=32,
    filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
    resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
    upsample_rates=(4, 4, 2, 2), upsample_initial_channel=64,
    upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16,
    sr=6400, use_f0=True, text_enc_hidden_dim=768)
ATOL = 1e-3 + 1.0 / 32768
PRESET = dict(cleaner=True, autotune=True, pitch=3, clean_strength=0.6, index_strength=0.6,
              resample_sr=16000, filter_radius=2, volume_envelope=0.8, protect=0.4,
              split_audio=True, f0_autotune_strength=0.5, formant_shifting=True,
              formant_qfrency=1.0, formant_timbre=1.2)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("convert_flags")
    f = write_voice_files(d, JCFG)
    f["index"] = str(d / "total_fea.npy")
    np.save(f["index"], np.random.RandomState(5).randn(300, 768).astype(np.float32))
    # a stereo 22.05 kHz FLAC input, written by the port
    from rvc_maker_tpu_torch.utils.audio import resample

    left = resample(voice(1.2, 190.0, 3), 16000, 22050)
    f["input"] = str(d / "in.flac")
    save_wav(f["input"], np.stack([left, 0.8 * left], 1), 22050)
    return f


def _argv(files, out, *flags):
    return ["convert", "--input", files["input"], "--output", out, "--model", files["model"],
            "--rmvpe-path", files["rmvpe"], "--embedder-path", files["embedder"],
            "--index", files["index"], *flags]


def _both(files, tmp_path, monkeypatch, *flags):
    """Run both command lines with `flags`; (port's argv result dir)."""
    monkeypatch.setattr(jhubert, "N_LAYERS", 2)
    patch_jax_noise(monkeypatch)
    assert cli.main(_argv(files, str(tmp_path / "p.wav"), *flags, "--device", "cpu")) == 0
    jcli.main(_argv(files, str(tmp_path / "j.wav"), *flags))


def test_cli_convert_preset_formants_clean_flac_matches_jax(files, tmp_path, monkeypatch):
    """Every preset key, on a FLAC input, exported as FLAC: the formant
    shift on the 16 kHz input, the noise gate on the 16 kHz output."""
    preset = tmp_path / "preset.json"
    presets.save_preset(str(preset), **PRESET)
    assert json.loads(preset.read_text()) == PRESET
    _both(files, tmp_path, monkeypatch, "--preset", str(preset), "--export-format", "flac")
    assert not (tmp_path / "p.wav").exists()
    assert (tmp_path / "p.flac").read_bytes()[:4] == b"fLaC"
    got, sr = read_wav(str(tmp_path / "p.flac"))
    ref, jsr = read_wav(str(tmp_path / "j.flac"))
    assert sr == jsr == 16000 and got.shape == ref.shape
    assert abs(len(got) / sr - 1.2) < 0.05 and np.abs(ref).max() > 0.1
    err = float(np.abs(got - ref).max())
    print(f"\ncli convert --preset (every key) FLAC, port vs JAX: max abs {err:.3e} "
          f"(tol {ATOL:.3e})")
    assert err <= ATOL, err


def test_cli_convert_resample_below_16k_keeps_the_model_rate(files, tmp_path, monkeypatch):
    """--resample-sr 8000: convert_utterance resamples only from 16 kHz
    up, so both packages write the model's 6400 Hz samples; the port's
    header says 6400, JAX's says 8000 (a recorded divergence)."""
    _both(files, tmp_path, monkeypatch, "--resample-sr", "8000", "--f0-method", "yin")
    got, sr = read_wav(str(tmp_path / "p.wav"))
    ref, jsr = read_wav(str(tmp_path / "j.wav"))
    assert (sr, jsr) == (JCFG.sr, 8000)
    assert got.shape == ref.shape and abs(len(got) / JCFG.sr - 1.2) < 0.05
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def _convert_args(parser):
    return parser.parse_args(["convert", "--input", "in.flac", "--output", "out.wav",
                              "--model", "voice.pth"])


@pytest.mark.parametrize("key", presets.PRESET_KEYS)
def test_every_preset_key_reaches_its_flag(key):
    """Each key sets one attribute of the port's parsed `convert` flags,
    the one it sets in the JAX package's, to the preset's value."""
    value = {"pitch": 5, "resample_sr": 44100, "filter_radius": 5, "clean_strength": 0.3,
             "index_strength": 0.9, "volume_envelope": 0.25, "protect": 0.1,
             "f0_autotune_strength": 0.4, "formant_qfrency": 1.5,
             "formant_timbre": 1.3}.get(key, True)
    changed = []
    for parser, apply in ((cli.build_parser(), presets.apply_preset_to_args),
                          (jcli.build_parser(), jpresets.apply_preset_to_args)):
        args = _convert_args(parser)
        before = dict(vars(args))
        apply(args, {key: value})
        changed.append({k: v for k, v in vars(args).items() if before[k] != v})
    assert len(changed[0]) == 1 and changed[0] == changed[1], changed
    assert list(changed[0].values()) == [value]
    assert presets.PRESET_KEYS == jpresets.PRESET_KEYS


def test_preset_files_match_jax(tmp_path):
    """save_preset keeps only the preset keys and writes JAX's bytes;
    load_preset drops unknown keys; no key at all raises."""
    settings = dict(PRESET, unknown=1)
    presets.save_preset(str(tmp_path / "p.json"), **settings)
    jpresets.save_preset(str(tmp_path / "j.json"), **settings)
    assert (tmp_path / "p.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    (tmp_path / "x.json").write_text(json.dumps(dict(PRESET, other="y")))
    assert presets.load_preset(str(tmp_path / "x.json")) == PRESET
    with pytest.raises(ValueError, match="no preset keys"):
        presets.save_preset(str(tmp_path / "none.json"), other=1)


def test_cli_convert_on_a_missing_card_raises(files, tmp_path, monkeypatch):
    """Without --device cpu the conversion (and its noise gate) asks for
    the card, and no card raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(_argv(files, str(tmp_path / "p.wav"), "--clean-audio", "--f0-method", "yin"))
    assert not (tmp_path / "p.wav").exists()
