"""The port's audio I/O (`rvc_maker_tpu_torch/utils/audio.py`,
`utils/flac_enc.py`, `utils/flac_dec.py`) against the JAX package's:
FLAC written by one package and read by the other with int16 samples
equal, mono and stereo; the encoder's bytes equal to JAX's; `save_audio`
in wav and flac, and an ffmpeg format raising without ffmpeg; the `fLaC`
routing of `read_wav`; the g++ build of native/src/flacdec.cpp."""

import numpy as np
import pytest
from scipy.io import wavfile

from rvc_maker_tpu.utils import audio as jaudio
from rvc_maker_tpu.utils import flac_enc as jflac_enc
from rvc_maker_tpu_torch.ops import build
from rvc_maker_tpu_torch.utils import audio, flac_dec, flac_enc


def _signal(channels, seconds=0.7, sr=16000, seed=0):
    """A tone with noise, past full scale in places (the writers clip),
    (T,) or (T, 2)."""
    rs = np.random.RandomState(seed)
    tt = np.arange(int(sr * seconds)) / sr
    x = 0.6 * np.sin(2 * np.pi * 220 * tt) + 0.05 * rs.randn(len(tt))
    x[100:140] = 1.3
    if channels == 2:
        x = np.stack([x, 0.5 * np.cos(2 * np.pi * 330 * tt) + 0.02 * rs.randn(len(tt))], 1)
    return x.astype(np.float32)


def _int16(x):
    """Decoded float samples (int / 2^15) back to their int16 values."""
    q = np.asarray(x, np.float64) * 32768.0
    assert np.array_equal(q, np.round(q))
    return q.astype(np.int16)


@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
def test_flac_written_by_jax_read_by_port(tmp_path, channels):
    x = _signal(channels)
    path = str(tmp_path / "j.flac")
    jaudio.save_wav(path, x, 16000)
    got, sr = audio.read_wav(path)
    ref, jsr = jaudio.read_wav(path)
    assert sr == jsr == 16000 and got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_array_equal(_int16(got), _int16(ref))
    # the encoder rounds clip(x) * 2^15, clipped to int16's range
    expect = np.clip(np.round(np.clip(x, -1, 1).astype(np.float64) * 32768), -32768, 32767)
    np.testing.assert_array_equal(_int16(got), expect.astype(np.int16))


@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
def test_flac_written_by_port_read_by_jax(tmp_path, channels):
    x = _signal(channels, seed=3)
    path = str(tmp_path / "p.flac")
    audio.save_wav(path, x, 44100)
    ref, sr = jaudio.read_wav(path)
    got, psr = audio.read_wav(path)
    assert sr == psr == 44100 and ref.shape == x.shape
    np.testing.assert_array_equal(_int16(ref), _int16(got))


@pytest.mark.parametrize("channels,seconds", [(1, 0.7), (2, 0.7), (2, 2.0), (1, 1.024)],
                         ids=["mono", "stereo", "long-stereo", "whole-blocks"])
def test_encoder_bytes_equal_jax(channels, seconds):
    """The port's encoder writes JAX's bytes (1.024 s at 16 kHz is four
    whole 4096-sample blocks)."""
    x = _signal(channels, seconds=seconds, seed=1)
    assert flac_enc.encode_flac(x, 16000) == jflac_enc.encode_flac(x, 16000)


def test_save_wav_flac_bytes_equal_jax(tmp_path):
    x = _signal(1, seed=4)
    audio.save_wav(str(tmp_path / "p.flac"), x, 48000)
    jaudio.save_wav(str(tmp_path / "j.flac"), x, 48000)
    data = (tmp_path / "p.flac").read_bytes()
    assert data[:4] == b"fLaC" and data == (tmp_path / "j.flac").read_bytes()


@pytest.mark.parametrize("fmt", ["wav", "flac"])
def test_save_audio_native_formats(tmp_path, fmt):
    """save_audio swaps the extension for the format's and writes the
    bytes JAX's save_audio writes."""
    x = _signal(1, seed=5)
    got = audio.save_audio(str(tmp_path / "out_p.mp3"), x, 32000, fmt)
    ref = jaudio.save_audio(str(tmp_path / "out_j.mp3"), x, 32000, fmt)
    assert got == str(tmp_path / f"out_p.{fmt}") and ref == str(tmp_path / f"out_j.{fmt}")
    with open(got, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()
    back, sr = audio.read_wav(got)
    assert sr == 32000 and back.shape == x.shape


@pytest.mark.parametrize("fmt", ["mp3", "ogg", "m4a"])
def test_save_audio_needs_ffmpeg_for_other_formats(tmp_path, monkeypatch, fmt):
    monkeypatch.setattr(audio.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="needs ffmpeg"):
        audio.save_audio(str(tmp_path / "out.wav"), _signal(1), 16000, fmt)
    assert not list(tmp_path.iterdir())


def test_read_wav_routes_by_magic_not_name(tmp_path):
    """A FLAC stream under a .wav name is decoded as FLAC, and RIFF bytes
    under a .flac name are read as WAV."""
    x = _signal(2, seed=6)
    (tmp_path / "flac.wav").write_bytes(flac_enc.encode_flac(x, 22050))
    got, sr = audio.read_wav(str(tmp_path / "flac.wav"))
    assert sr == 22050 and got.shape == x.shape
    wavfile.write(str(tmp_path / "riff.flac"), 16000, (x[:, 0] * 16000).astype(np.int16))
    got, sr = audio.read_wav(str(tmp_path / "riff.flac"))
    ref, _ = jaudio.read_wav(str(tmp_path / "riff.flac"))
    assert sr == 16000
    np.testing.assert_array_equal(got, ref)


def test_load_audio_flac_matches_jax(tmp_path):
    """A stereo 44.1 kHz FLAC mixed to mono and resampled to 16 kHz."""
    path = str(tmp_path / "in.flac")
    jaudio.save_wav(path, _signal(2, sr=44100, seed=7), 44100)
    np.testing.assert_array_equal(audio.load_audio(path, 16000), jaudio.load_audio(path, 16000))


def test_flac_probe_reads_streaminfo_and_rejects_garbage():
    x = _signal(2, seed=8)
    info = flac_dec.flac_probe(flac_enc.encode_flac(x, 48000))
    assert info == dict(sample_rate=48000, channels=2, bps=16, total=len(x))
    with pytest.raises(ValueError, match="not a decodable FLAC stream"):
        flac_dec.flac_decode(b"RIFF" + bytes(100))


def test_flacdec_built_by_gpp_into_the_package(tmp_path):
    """The decoder is native/src/flacdec.cpp built alone with g++ into
    rvc_maker_tpu_torch/_build/, never native/build/librvcnative.so."""
    flac_dec.flac_decode(flac_enc.encode_flac(_signal(1), 16000))
    assert build.HOST_SOURCES["flacdec"] == build.PACKAGE_DIR.parent / "native" / "src" / \
        "flacdec.cpp"
    path = build.host_library_path("flacdec")
    assert path.parent == build.BUILD_DIR and path.exists()
    assert flac_dec._lib is build._loaded["flacdec"]
    assert "librvcnative" not in flac_dec._lib._name


def test_flacdec_build_failure_raises(tmp_path, monkeypatch):
    """A decoder source that g++ refuses raises with the compiler's
    output, and read_wav of a FLAC file raises with it: nothing falls back."""
    bad = tmp_path / "flacdec.cpp"
    bad.write_text("not C++ at all\n")
    monkeypatch.setattr(build, "HOST_SOURCES", dict(build.HOST_SOURCES, flacdec=bad))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(flac_dec, "_lib", None)
    path = tmp_path / "x.flac"
    path.write_bytes(flac_enc.encode_flac(_signal(1), 16000))
    with pytest.raises(RuntimeError, match="flacdec: g\\+\\+ exited"):
        audio.read_wav(str(path))
    assert not list((tmp_path / "_build").glob("*.so"))
