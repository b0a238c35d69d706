"""MDX-Net separation in the port (`pipelines/mdx.py`,
`pipelines/separate_music.py`, `cli separate` with a `.onnx`, `cli
separate-music`, `/api/separate` with a `.onnx`) against the JAX package
on the CPU.

The model is JAX `tests/test_mdx.py`'s toy spectrogram U-Net (conv 3x3,
tanh, conv 1x1 over (B, 4, 24, 32)), exported once by the JAX exporter
with a fixed batch of 1, and once with a dynamic batch; both executors
read the same files.  Bounds: `mdx_demix` and `mdx_separate` 1e-4 max
abs, the written stems of `separate_music` 1e-3 (plus one int16 step,
since they went through WAV files).
"""

import base64
import http.client
import io
import json
import shutil
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from rvc_maker_tpu import cli as jax_cli
from rvc_maker_tpu.app import server as jax_srv
from rvc_maker_tpu.interop import onnx_proto as jproto
from rvc_maker_tpu.interop.onnx_export import export_onnx as jax_export_onnx
from rvc_maker_tpu.interop.onnx_run import OnnxGraph as JaxGraph
from rvc_maker_tpu.pipelines import mdx as jmdx
from rvc_maker_tpu.pipelines import separate_music as jsm
from rvc_maker_tpu_torch import cli
from rvc_maker_tpu_torch.app import server as srv
from rvc_maker_tpu_torch.errors import BadRequest
from rvc_maker_tpu_torch.interop.onnx_run import OnnxGraph
from rvc_maker_tpu_torch.pipelines import mdx
from rvc_maker_tpu_torch.pipelines import separate_music as psm
from rvc_maker_tpu_torch.utils import bootstrap as pboot
from torch_port_util import n, torch_threads  # noqa: F401

MDX_TOL = 1e-4
STEM_TOL = 1e-3
INT16_STEP = 1.0 / 32768
P = mdx.MDXParams(n_fft=64, dim_f=24, dim_t=32, compensate=1.035, overlap=0.25, hop_length=16)


def _jp(p):
    return jmdx.MDXParams(**p.__dict__)


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """{"static": path, "dynamic": path}: the toy net with a batch of 1
    and with a symbolic batch."""
    rs = np.random.RandomState(0)
    w1 = jnp.asarray(rs.randn(4, 8, 3, 3).astype(np.float32) * 0.2)
    b1 = jnp.asarray(rs.randn(8).astype(np.float32) * 0.1)
    w2 = jnp.asarray(rs.randn(8, 4, 1, 1).astype(np.float32) * 0.3)

    def net(spek):                    # (B, 4, dim_f, dim_t)
        h = jax.lax.conv_general_dilated(spek, jnp.transpose(w1, (1, 0, 2, 3)), (1, 1),
                                         [(1, 1), (1, 1)],
                                         dimension_numbers=("NCHW", "OIHW", "NCHW"))
        h = jnp.tanh(h + b1[None, :, None, None])
        return jax.lax.conv_general_dilated(h, jnp.transpose(w2, (1, 0, 2, 3)), (1, 1),
                                            [(0, 0), (0, 0)],
                                            dimension_numbers=("NCHW", "OIHW", "NCHW"))

    d = tmp_path_factory.mktemp("mdx")
    out = {}
    for name, batch, axes in (("static", 1, None), ("dynamic", 2, {"input": {0: "b"}})):
        x = jnp.zeros((batch, 4, P.dim_f, P.dim_t), jnp.float32)
        model = jax_export_onnx(net, (x,), input_names=["input"], output_names=["output"],
                                dynamic_axes=axes)
        out[name] = str(d / f"toy_{name}.onnx")
        jproto.save_model(model, out[name])
    return out


def _pair(path):
    return OnnxGraph(path, device="cpu"), JaxGraph(path)


@pytest.mark.parametrize("hop", [64, 96], ids=["hop-divides", "hop-does-not"])
def test_stft_and_istft_match_jax(hop):
    x = (np.random.RandomState(1).randn(2, 2, 5000) * 0.3).astype(np.float32)
    ref = np.asarray(jmdx.mdx_stft(jnp.asarray(x), n_fft=256, hop=hop, dim_f=100))
    got = n(mdx.mdx_stft(torch.as_tensor(x), n_fft=256, hop=hop, dim_f=100))
    assert got.shape == ref.shape and np.abs(got - ref).max() <= MDX_TOL
    spec = np.random.RandomState(2).randn(*ref.shape).astype(np.float32)
    ref = np.asarray(jmdx.mdx_istft(jnp.asarray(spec), n_fft=256, hop=hop, length=5000))
    got = n(mdx.mdx_istft(torch.as_tensor(spec), n_fft=256, hop=hop, length=5000))
    assert got.shape == ref.shape == (2, 2, 5000) and np.abs(got - ref).max() <= MDX_TOL


@pytest.mark.parametrize("denoise", [False, True], ids=["plain", "denoise"])
@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_demix_matches_jax(graphs, kind, denoise):
    g, jg = _pair(graphs[kind])
    assert mdx._graph_batch_static_one(g) == (kind == "static")
    p = mdx.MDXParams(**{**P.__dict__, "enable_denoise": denoise})
    mix = (np.random.RandomState(3).randn(2, 1500) * 0.3).astype(np.float32)
    ref = jmdx.mdx_demix(jg, mix.copy(), _jp(p))
    got = mdx.mdx_demix(g, mix.copy(), p)
    assert got.shape == ref.shape == mix.shape
    assert np.abs(got - ref).max() <= MDX_TOL


@pytest.mark.parametrize("denoise", [False, True], ids=["plain", "denoise"])
@pytest.mark.parametrize("kind", ["static", "dynamic"])
def test_graph_calls_per_demix(graphs, kind, denoise, monkeypatch):
    """A fixed batch of 1 takes one call per chunk (two with denoise); a
    dynamic batch takes every chunk in one call, the denoise pair folded
    into it."""
    g = OnnxGraph(graphs[kind], device="cpu")
    batches = []
    real = g.run

    def spy(feeds):
        batches.append(next(iter(feeds.values())).shape[0])
        return real(feeds)

    monkeypatch.setattr(g, "run", spy)
    mix = (np.random.RandomState(4).randn(2, 1500) * 0.3).astype(np.float32)
    mdx.mdx_demix(g, mix, mdx.MDXParams(**{**P.__dict__, "enable_denoise": denoise}))
    trim, chunk = P.n_fft // 2, P.hop_length * (P.dim_t - 1)
    gen = chunk - 2 * trim
    total = trim + 1500 + gen + trim - 1500 % gen           # the padded mixture
    chunks = len(range(0, total, int((1 - P.overlap) * chunk)))
    assert chunks > 1
    if kind == "static":
        assert batches == [1] * (chunks * (2 if denoise else 1))
    else:
        assert batches == [chunks * (2 if denoise else 1)]


def test_demix_fetch_f16_matches_jax(graphs, monkeypatch):
    """RVC_TPU_FETCH_F16=1: the stem comes back through float16 in both
    packages (within one float16 step at the stem's scale)."""
    monkeypatch.setenv("RVC_TPU_FETCH_F16", "1")
    g, jg = _pair(graphs["dynamic"])
    mix = (np.random.RandomState(7).randn(2, 1500) * 0.3).astype(np.float32)
    ref = jmdx.mdx_demix(jg, mix.copy(), _jp(P))
    got = mdx.mdx_demix(g, mix.copy(), P)
    assert got.dtype == np.float32 and np.array_equal(got, got.astype(np.float16))
    assert np.abs(got - ref).max() <= 2.0 ** -10 * max(1.0, float(np.abs(ref).max()))


def test_demix_match_mix_matches_jax(graphs):
    g, jg = _pair(graphs["static"])
    mix = (np.random.RandomState(5).randn(2, 1200) * 0.3).astype(np.float32)
    ref = jmdx.mdx_demix(jg, mix.copy(), _jp(P), is_match_mix=True)
    got = mdx.mdx_demix(g, mix.copy(), P, is_match_mix=True)
    assert np.abs(got - ref).max() <= MDX_TOL


def test_params_from_graph(graphs):
    g, jg = _pair(graphs["static"])
    got = mdx.params_from_graph(g, n_fft=64, compensate=1.035)
    ref = jmdx.params_from_graph(jg, n_fft=64, compensate=1.035)
    assert got.__dict__ == ref.__dict__ and (got.dim_f, got.dim_t) == (P.dim_f, P.dim_t)
    with pytest.raises(BadRequest, match="n_fft"):
        mdx.params_from_graph(g)
    with pytest.raises(ValueError, match="n_fft"):
        jmdx.params_from_graph(jg)


@pytest.mark.parametrize("invert", [False, True], ids=["difference", "invert-using-spec"])
def test_mdx_separate_matches_jax(graphs, invert):
    g, jg = _pair(graphs["static"])
    mix = (np.random.RandomState(6).randn(2, 2000) * 0.6).astype(np.float32)
    rp, rs_ = jmdx.mdx_separate(jg, mix, _jp(P), invert_using_spec=invert)
    gp, gs = mdx.mdx_separate(g, mix, P, invert_using_spec=invert)
    assert gp.shape == rp.shape and gs.shape == rs_.shape
    assert np.abs(gp - rp).max() <= MDX_TOL and np.abs(gs - rs_).max() <= MDX_TOL


def test_demix_without_a_card_raises(graphs):
    with pytest.raises(RuntimeError, match="cuda"):
        OnnxGraph(graphs["static"])


# ---------------------------------------------------------------------------
# the command lines and the music separator
# ---------------------------------------------------------------------------

def _song_file(path, seconds=0.6, sr=44100, stereo=False):
    t = np.arange(int(seconds * sr)) / sr
    mix = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 275 * t)
    if stereo:
        mix = np.stack([mix, 0.8 * mix + 0.05 * np.sin(2 * np.pi * 440 * t)], axis=1)
    wavfile.write(path, sr, (mix * 32767).astype(np.int16))
    return str(path)


def _read(path):
    sr, x = wavfile.read(path)
    return sr, x.astype(np.float64) / 32768.0


def test_cli_separate_onnx_matches_jax(graphs, tmp_path):
    song = _song_file(tmp_path / "song.wav", stereo=True)
    flags = ["--model", graphs["static"], "--input", song, "--mdx-n-fft", "64", "--mdx-hop",
             "16", "--mdx-denoise", "--invert-using-spec"]
    outs = {}
    for who, main in (("port", cli.main), ("jax", jax_cli.main)):
        v, i = str(tmp_path / f"{who}_v.wav"), str(tmp_path / f"{who}_i.wav")
        main(["separate", *flags, "--output-vocals", v, "--output-instrumental", i]
             + (["--device", "cpu"] if who == "port" else []))
        outs[who] = [_read(v), _read(i)]
    for (gsr, g), (rsr, r) in zip(outs["port"], outs["jax"]):
        assert gsr == rsr == 44100 and g.shape == r.shape
        assert np.abs(g - r).max() <= MDX_TOL + INT16_STEP


ALL_STEMS = {"Original_Vocals", "Instruments", "Main_Vocals", "Backing_Vocals",
             "Original_Vocals_No_Reverb", "Main_Vocals_No_Reverb", "Backing_Vocals_No_Reverb"}


def test_cli_separate_music_matches_jax(graphs, tmp_path):
    """`cli separate-music` with the karaoke split, dereverb and the
    backing dereverb, every model the toy graph: the same 7 stems."""
    song = _song_file(tmp_path / "song.wav")
    g = graphs["static"]
    flags = ["--input", song, "--model-name", g, "--kara-model", g, "--reverb-model", g,
             "--backing", "--reverb", "--backing-reverb", "--mdx-hop", "16", "--mdx-n-fft", "64"]
    cli.main(["separate-music", *flags, "--output", str(tmp_path / "port"), "--device", "cpu"])
    jax_cli.main(["separate-music", *flags, "--output", str(tmp_path / "jax")])
    for stem in ALL_STEMS:
        (gsr, got), (rsr, ref) = (_read(str(tmp_path / who / "song" / f"{stem}.wav"))
                                  for who in ("port", "jax"))
        assert gsr == rsr == 44100 and got.shape == ref.shape, stem
        assert np.abs(got - ref).max() <= STEM_TOL + INT16_STEP, stem


def test_separate_music_with_the_gate_matches_jax(graphs, tmp_path):
    """Every stem spectral-gated (`utils/noisereduce.py`) before it is
    written."""
    song = _song_file(tmp_path / "song.wav", seconds=0.8)
    kw = dict(model_name=graphs["dynamic"], clean_audio=True, mdx_hop=16, mdx_n_fft=64)
    got = psm.separate_music(song, str(tmp_path / "port"),
                             psm.SeparationSettings(device="cpu", **kw))
    ref = jsm.separate_music(song, str(tmp_path / "jax"), jsm.SeparationSettings(**kw))
    assert set(got) == set(ref) == {"Original_Vocals", "Instruments"}
    for stem in got:
        (gsr, g), (rsr, r) = _read(got[stem]), _read(ref[stem])
        assert gsr == rsr and g.shape == r.shape
        assert np.abs(g - r).max() <= STEM_TOL + INT16_STEP, stem


def test_separate_music_finds_registry_names_only_on_disk(graphs, tmp_path, monkeypatch):
    """A registry name resolves to its file in model_dir; one whose file is
    absent is downloaded there, from the URL to the path that JAX's
    `_resolve_model` asks for (the download mocked: a copy of the graph);
    an unknown name is a BadRequest and nothing is written."""
    asked = {"port": [], "jax": []}

    def fake(calls):
        def download(url, path):
            calls.append((url, path))
            shutil.copy(graphs["static"], path)
            return path
        return download

    monkeypatch.setattr("rvc_maker_tpu_torch.utils.downloads.download_url", fake(asked["port"]))
    monkeypatch.setattr("rvc_maker_tpu.utils.downloads.download_url", fake(asked["jax"]))
    models = tmp_path / "uvr5"
    models.mkdir()
    shutil.copy(graphs["static"], models / "Kim_Vocal_1.onnx")
    song = _song_file(tmp_path / "song.wav", seconds=0.3)
    for name in ("Kim_Vocal_1", "Kim_Vocal_2"):
        s = psm.SeparationSettings(model_name=name, model_dir=str(models), mdx_hop=16,
                                   mdx_n_fft=64, device="cpu")
        written = psm.separate_music(song, str(tmp_path / name), s)
        assert set(written) == {"Original_Vocals", "Instruments"}
    assert [u for u, _ in asked["port"]] == [f"{pboot.HF_BASE}uvr5/Kim_Vocal_2.onnx"]
    assert asked["port"][0][1] == str(models / "Kim_Vocal_2.onnx")
    jax_models = tmp_path / "jax_uvr5"
    jax_models.mkdir()
    jsm._resolve_model("Kim_Vocal_2", jsm.SeparationSettings(model_dir=str(jax_models)))
    assert [u for u, _ in asked["jax"]] == [u for u, _ in asked["port"]]
    s2 = psm.SeparationSettings(model_name="NotAModel", model_dir=str(models), device="cpu")
    with pytest.raises(BadRequest, match="unknown"):
        psm.separate_music(song, str(tmp_path / "out2"), s2)
    assert not (tmp_path / "out2").exists()
    assert psm.MDX_MODELS == jsm.MDX_MODELS and psm.KARA_MODELS == jsm.KARA_MODELS
    assert psm.DEMUCS_MODELS == jsm.DEMUCS_MODELS and psm.REVERB_MODEL == jsm.REVERB_MODEL


def test_cli_separate_music_needs_the_card_unless_told(graphs, tmp_path):
    song = _song_file(tmp_path / "song.wav", seconds=0.2)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["separate-music", "--input", song, "--model-name", graphs["static"],
                  "--output", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


# ---------------------------------------------------------------------------
# /api/separate with a .onnx
# ---------------------------------------------------------------------------

def _start(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def _call(port, path, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(obj),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_api_separate_onnx_matches_jax_server(graphs, tmp_path):
    """A mono request with the toy graph: both servers answer 200 with mono
    stems at the input's rate, within 1e-4 plus one int16 step."""
    saved = srv._STATE["device"]
    srv.set_device("cpu")
    servers = _start(srv.Handler), _start(jax_srv.Handler)
    try:
        buf = io.BytesIO()
        song = _read(_song_file(tmp_path / "song.wav", seconds=0.5, sr=22050))[1]
        wavfile.write(buf, 22050, (song * 32767).astype(np.int16))
        req = {"audio_b64": base64.b64encode(buf.getvalue()).decode(),
               "model": graphs["static"], "mdx_n_fft": 64, "mdx_hop": 16}
        (gc, got), (rc, ref) = (_call(s.server_address[1], "/api/separate", req)
                                for s in servers)
    finally:
        for httpd in servers:
            httpd.shutdown()
            httpd.server_close()
        srv._STATE["device"] = saved
    assert gc == rc == 200, (got, ref)
    assert got["sr"] == ref["sr"] == 22050
    for key in ("vocals_b64", "instrumental_b64"):
        g = wavfile.read(io.BytesIO(base64.b64decode(got[key])))[1] / 32768.0
        r = wavfile.read(io.BytesIO(base64.b64decode(ref[key])))[1] / 32768.0
        assert g.shape == r.shape == (11025,)
        assert np.abs(g - r).max() <= MDX_TOL + INT16_STEP
