"""The dataset builder (`pipelines/create_dataset.py`, `cli create-dataset`)
against the JAX package's on the CPU.

Inputs: a 48 kHz stereo song (resampled to 44.1 kHz) and a 44.1 kHz mono
one, one of them fetched from a 127.0.0.1 file server; the separator is a
small HTDemucs `.th` from a seed (test_torch_separate.py's), the clean
step the noise gate.  Bound: the dataset WAVs within 1e-3 of JAX's (the
Demucs stems' bound), and the sample rates and lengths equal.
"""

import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from rvc_maker_tpu import cli as jax_cli
from rvc_maker_tpu.pipelines import create_dataset as jcd
from rvc_maker_tpu_torch import cli
from rvc_maker_tpu_torch.interop.from_jax import random_demucs_state_dict
from rvc_maker_tpu_torch.models import demucs as pd
from rvc_maker_tpu_torch.pipelines import create_dataset as pcd
from test_torch_separate import CFG, write_th
from torch_port_util import torch_threads  # noqa: F401

TOL = 1e-3


def _song(seconds, sr, seed, stereo=True):
    t = np.arange(int(seconds * sr)) / sr
    rs = np.random.RandomState(seed)
    x = (0.3 * np.sin(2 * np.pi * 220 * t * (1 + 0.02 * np.sin(2 * np.pi * 4 * t)))
         + 0.15 * np.sin(2 * np.pi * 55 * t) + 0.05 * rs.randn(len(t)))
    if stereo:
        x = np.stack([x, 0.6 * x + 0.05 * rs.randn(len(t))], axis=1)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("create_dataset")
    sd = random_demucs_state_dict(CFG, channels=8, t_layers=3, seed=21)
    out = dict(th=write_th(d / "htdemucs.th", sd), a=str(d / "a.wav"), b=str(d / "b.wav"))
    wavfile.write(out["a"], 48000, _song(1.6, 48000, 1))
    wavfile.write(out["b"], 44100, _song(1.2, 44100, 2, stereo=False))
    return out


class _Files(BaseHTTPRequestHandler):
    CONTENT: dict = {}

    def do_GET(self):
        data = self.CONTENT[self.path.lstrip("/")]
        self.send_response(200)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


@pytest.fixture()
def file_server(files):
    with open(files["b"], "rb") as f:
        _Files.CONTENT = {"b.wav": f.read()}
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Files)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    t.join(10)


def _read_all(paths):
    out = []
    for p in paths:
        sr, x = wavfile.read(p)
        out.append((os.path.basename(p), sr, x))
    return out


def _assert_datasets_close(got, ref):
    assert [(n, sr, x.shape, x.dtype) for n, sr, x in got] == \
        [(n, sr, x.shape, x.dtype) for n, sr, x in ref]
    for (_, _, x), (_, _, y) in zip(got, ref):
        err = float(np.abs(x.astype(np.float64) - y).max())
        print(f"create_dataset port vs JAX: {err:.3e}")
        assert err <= TOL, err
        assert np.isfinite(x).all() and x.std() > 1e-4


def test_parse_time():
    for v in ("90", "1:30", "0:01:30", 2.5, 3, "0.25"):
        assert pcd._parse_time(v) == jcd._parse_time(v)


def test_create_dataset_matches_jax(files, file_server, tmp_path):
    """Separator and clean step, a skipped head and tail, one input from
    the local file server: the written files within 1e-3 of JAX's."""
    from rvc_maker_tpu.interop.demucs_load import load_demucs_th as jload
    from rvc_maker_tpu_torch.interop.demucs_load import load_demucs_th as pload

    inputs = [files["a"], f"{file_server}/b.wav"]
    kw = dict(sample_rate=44100, skip_start=["0.2", "0:00.1"], skip_end=["0.3"],
              clean_dataset=True, clean_strength=0.6)
    got = pcd.create_dataset(inputs, str(tmp_path / "port"), separator=pload(files["th"],
                                                                             device="cpu"),
                             device="cpu", **kw)
    ref = jcd.create_dataset(inputs, str(tmp_path / "jax"), separator=jload(files["th"]),
                             workdir=str(tmp_path / "jax_work"), **kw)
    assert [os.path.basename(p) for p in got] == ["dataset_0.wav", "dataset_1.wav"]
    _assert_datasets_close(_read_all(got), _read_all(ref))
    assert sorted(os.listdir(tmp_path / "port")) == ["dataset_0.wav", "dataset_1.wav"]


def test_create_dataset_without_separator_matches_jax(files, tmp_path):
    """No separator and no clean step: resample, mono mix and the skips
    alone, at 40 kHz."""
    kw = dict(sample_rate=40000, skip_start=["0.1"], skip_end=["0", "0.5"])
    got = pcd.create_dataset([files["b"], files["a"]], str(tmp_path / "port"), device="cpu", **kw)
    ref = jcd.create_dataset([files["b"], files["a"]], str(tmp_path / "jax"),
                             workdir=str(tmp_path / "jw"), **kw)
    _assert_datasets_close(_read_all(got), _read_all(ref))


def test_create_dataset_leaves_no_workdir(files, tmp_path, monkeypatch):
    """The default workdir is a fresh temporary directory, removed at the
    end, also when a step fails; a given one is removed too."""
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    os.makedirs(tmp_path / "tmp")
    pcd.create_dataset([files["b"]], str(tmp_path / "out"), device="cpu")
    assert os.listdir(tmp_path / "tmp") == []
    with pytest.raises(FileNotFoundError):
        pcd.create_dataset([files["b"], str(tmp_path / "missing.wav")], str(tmp_path / "o2"),
                           device="cpu")
    assert os.listdir(tmp_path / "tmp") == []
    work = tmp_path / "given"
    pcd.create_dataset([files["b"]], str(tmp_path / "o3"), workdir=str(work), device="cpu")
    assert not work.exists()


def test_youtube_inputs_go_through_the_youtube_downloader(files, tmp_path, monkeypatch):
    """A YouTube URL is fetched as bestaudio and decoded to WAV at the
    dataset rate (here the decode mocked: no network, no ffmpeg)."""
    import shutil

    from rvc_maker_tpu_torch.utils import youtube

    calls = []

    def fake(url, out, *, sample_rate=44100, timeout=30.0):
        calls.append((url, os.path.basename(out), sample_rate))
        shutil.copy(files["b"], out)
        return out

    monkeypatch.setattr(youtube, "download_audio_wav", fake)
    got = pcd.create_dataset(["https://youtu.be/dQw4w9WgXcQ"], str(tmp_path / "out"),
                             sample_rate=44100, device="cpu")
    assert calls == [("https://youtu.be/dQw4w9WgXcQ", "audio_0.wav", 44100)]
    assert wavfile.read(got[0])[1].shape == (int(1.2 * 44100),)


def test_cli_create_dataset_matches_jax(files, tmp_path, monkeypatch):
    """`cli create-dataset` with --separator-model, --clean-dataset and
    the skips on both packages (the port with --device cpu; JAX's fixed
    default workdir pointed into tmp_path)."""
    flags = [files["a"], files["b"], "--sample-rate", "44100", "--separator-model", files["th"],
             "--clean-dataset", "--skip-start", "0.25", "0.1", "--skip-end", "0.2"]
    assert cli.main(["create-dataset", *flags, "--output", str(tmp_path / "port"),
                     "--device", "cpu"]) == 0
    monkeypatch.setitem(jcd.create_dataset.__kwdefaults__, "workdir", str(tmp_path / "jw"))
    jax_cli.main(["create-dataset", *flags, "--output", str(tmp_path / "jax")])
    names = ["dataset_0.wav", "dataset_1.wav"]
    _assert_datasets_close(_read_all([str(tmp_path / "port" / n) for n in names]),
                           _read_all([str(tmp_path / "jax" / n) for n in names]))


def test_cli_create_dataset_needs_the_card_unless_told(files, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["create-dataset", files["b"], "--output", str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="cuda"):
        pcd.create_dataset([files["b"]], str(tmp_path / "out2"))
    assert not (tmp_path / "out").exists() and not (tmp_path / "out2").exists()


def test_separator_vocals_are_demucs_vocals(files, tmp_path):
    """The dataset file is the mono mean of separate_vocals' stem at the
    Demucs rate (no clean step)."""
    from rvc_maker_tpu_torch.interop.demucs_load import load_demucs_th
    from rvc_maker_tpu_torch.pipelines.separate import separate_vocals
    from rvc_maker_tpu_torch.utils.audio import read_wav

    params, dcfg = load_demucs_th(files["th"], device="cpu")
    assert isinstance(dcfg, pd.DemucsConfig)
    got = pcd.create_dataset([files["b"]], str(tmp_path / "out"), separator=(params, dcfg),
                             device="cpu")
    audio, sr = read_wav(files["b"])
    vocals, _ = separate_vocals(params, dcfg, audio, sr, shifts=0)
    sr_out, x = wavfile.read(got[0])
    assert sr_out == dcfg.samplerate
    np.testing.assert_array_equal(x, vocals.mean(axis=1).astype(np.float32))
