"""Demucs separation in the port (`pipelines/separate.py`,
`interop/demucs_load.py`, `cli separate`, `/api/separate`) against the
JAX package on the CPU.

The model is a small HTDemucs (channels 8, nfft 2048, depth 4, 3
transformer layers, 0.3 s segment) from `random_demucs_state_dict`,
written as the reference's `.th` packages and `.yaml` bags.  Bounds:
stems 1e-3 max abs (plus one int16 step where they went through a WAV
file).  Each JAX `apply_model` call jits its window function anew, so
the JAX side is called as few times as the comparisons need.
"""

import base64
import http.client
import io
import json
import os
import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
import yaml
from scipy.io import wavfile

from rvc_maker_tpu import cli as jax_cli
from rvc_maker_tpu.app import server as jax_srv
from rvc_maker_tpu.interop import demucs_load as jax_load
from rvc_maker_tpu.models import demucs as jd
from rvc_maker_tpu.pipelines import separate as jsep
from rvc_maker_tpu_torch import cli
from rvc_maker_tpu_torch.app import server as srv
from rvc_maker_tpu_torch.errors import BadRequest
from rvc_maker_tpu_torch.interop import demucs_load as pload
from rvc_maker_tpu_torch.interop.from_jax import demucs_from_jax, random_demucs_state_dict
from rvc_maker_tpu_torch.models import demucs as pd
from rvc_maker_tpu_torch.pipelines import separate as psep
from torch_port_util import torch_threads  # noqa: F401

TOL = 1e-3
INT16_STEP = 1.0 / 32768
CFG = pd.DemucsConfig(nfft=2048, depth=4, segment=0.3, use_train_segment=True)
KWARGS = dict(sources=list(CFG.sources), audio_channels=2, channels=8, nfft=2048, depth=4,
              t_layers=3, segment=0.3, samplerate=44100)


def _jcfg(cfg):
    return jd.DemucsConfig(**cfg.__dict__)


def write_th(path, sd, arch="HTDemucs", kwargs=None):
    """A demucs package ({klass, args, kwargs, state}) whose klass is the
    port's marker, pickled under demucs.<module>.<arch>."""
    pload.install_demucs_shims()
    klass = pload.marker_class("demucs", arch.lower(), arch)
    torch.save({"klass": klass, "args": (), "kwargs": dict(KWARGS if kwargs is None else kwargs),
                "state": sd}, path)
    return str(path)


@pytest.fixture(scope="module")
def model():
    sd = random_demucs_state_dict(CFG, channels=8, t_layers=3, seed=11)
    jtree = jd.htdemucs_params_from_state_dict({k: v.numpy() for k, v in sd.items()}, _jcfg(CFG))
    return sd, jtree, pd.params_from_state_dict(sd, CFG)


def _song(seconds, sr=44100, seed=0):
    t = np.arange(int(seconds * sr)) / sr
    rs = np.random.RandomState(seed)
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.2 * np.sin(2 * np.pi * 331 * t) + 0.05 * rs.randn(len(t))
    return x.astype(np.float32)


def test_apply_model_with_overlap_and_two_shifts_matches_jax(model):
    """Two random shifts (JAX's draws, RandomState(0)) of 3 overlapping
    windows each."""
    _, jtree, ptree = model
    mix = (np.random.RandomState(2).randn(1, 2, 26000) * 0.1).astype(np.float32)
    ref = jsep.apply_model(jtree, _jcfg(CFG), mix, shifts=2, overlap=0.25)
    got = psep.apply_model(ptree, CFG, mix, shifts=2, overlap=0.25)
    assert got.shape == ref.shape == (1, 4, 2, 26000)
    assert np.abs(got - ref).max() <= TOL


def test_apply_bag_matches_jax(model):
    """Two models with per-source weights."""
    sd, jtree, ptree = model
    sd2 = random_demucs_state_dict(CFG, channels=8, t_layers=3, seed=12)
    jtree2 = jd.htdemucs_params_from_state_dict({k: v.numpy() for k, v in sd2.items()},
                                                _jcfg(CFG))
    weights = ([1.0, 0.5, 0.0, 1.0], [0.0, 0.5, 1.0, 1.0])
    mix = (np.random.RandomState(3).randn(1, 2, 15000) * 0.1).astype(np.float32)
    ref = jsep.apply_bag([(jtree, _jcfg(CFG), weights[0]), (jtree2, _jcfg(CFG), weights[1])],
                         mix, shifts=0)
    got = psep.apply_bag([(ptree, CFG, weights[0]),
                          (pd.params_from_state_dict(sd2, CFG), CFG, weights[1])],
                         mix, shifts=0)
    assert np.abs(got - ref).max() <= TOL


@pytest.mark.parametrize("invert", [False, True], ids=["stems", "invert-using-spec"])
def test_separate_vocals_matches_jax(model, invert):
    """Mono at 22,050 Hz in (resampled, made stereo), one shift; the
    instrumental summed from the stems or inverted from the mixture (the
    inversion's istft drops the last partial hop, in both packages)."""
    _, jtree, ptree = model
    audio = _song(0.5, 22050)
    rv, ri = jsep.separate_vocals(jtree, _jcfg(CFG), audio, 22050, invert_using_spec=invert)
    gv, gi = psep.separate_vocals(ptree, CFG, audio, 22050, invert_using_spec=invert)
    assert gv.shape == rv.shape == (22050, 2)
    assert gi.shape == ri.shape == ((21504, 2) if invert else (22050, 2))
    assert np.abs(gv - rv).max() <= TOL and np.abs(gi - ri).max() <= TOL


def test_load_demucs_th_in_both_packages(model, tmp_path):
    """A package pickled with the port's marker loads through JAX's shims
    and the port's: the same config, and JAX's tree carried over is the
    port's."""
    sd, *_ = model
    path = write_th(tmp_path / "955717e8-abc.th", sd)
    jparams, jcfg = jax_load.load_demucs_th(path)
    params, cfg = pload.load_demucs_th(path, device="cpu")
    assert jcfg.__dict__ == cfg.__dict__ and cfg.has_transformer and cfg.segment == 0.3
    ref = demucs_from_jax(jparams, cfg)
    assert all(torch.equal(a["conv"]["w"], b["conv"]["w"])
               for a, b in zip(params["encoder"], ref["encoder"]))
    assert torch.equal(params["transformer"]["layers"][1]["z"]["attn"]["in_w"],
                       ref["transformer"]["layers"][1]["z"]["attn"]["in_w"])
    # JAX's shims were installed last; the port's load works as well
    params2, _ = pload.load_demucs_th(path, device="cpu")
    assert torch.equal(params2["freq_emb"], params["freq_emb"])


def test_load_demucs_th_without_a_card_raises(model, tmp_path):
    path = write_th(tmp_path / "m.th", model[0])
    with pytest.raises(RuntimeError, match="cuda"):
        pload.load_demucs_th(path)


def test_quantized_checkpoint_is_a_bad_request(model, tmp_path):
    sd = dict(model[0], __quantized=True)
    path = write_th(tmp_path / "q.th", sd)
    with pytest.raises(BadRequest, match="quantized"):
        pload.load_demucs_th(path, device="cpu")
    with pytest.raises(NotImplementedError):
        jax_load.load_demucs_th(path)


BAGS = {
    "flow": "models: ['955717e8', \"d12395a8\"]\n"
            "weights: [\n  [1., 0., 0., 0.],  # drums from the first\n  [0., 1., 1., 1.],\n]\n"
            "segment: 7.8\n",
    "block": "# a bag\nmodels:\n  - 955717e8\n  - 'd12395a8'\nweights:\n  - [1., 0.5, 0, 1]\n"
             "  - [0., 0.5, 1.0, 1]\nsegment: 44\n",
    "one": "models: ['955717e8']\n",
    "numbers": "models: [12345678, 1e5, 0x1f, 0755, 0b11, -7, 04573f0d, abc]\nsegment: .5\n"
               "flag: true\nnone: ~\n",
}


@pytest.mark.parametrize("name", sorted(BAGS))
def test_bag_parser_matches_yaml(name):
    assert pload.parse_bag(BAGS[name]) == yaml.safe_load(BAGS[name])


def test_load_demucs_bag_in_both_packages(model, tmp_path):
    sd, *_ = model
    sd2 = random_demucs_state_dict(CFG, channels=8, t_layers=3, seed=13)
    write_th(tmp_path / "955717e8.th", sd)
    write_th(tmp_path / "d12395a8.th", sd2)
    (tmp_path / "bag.yaml").write_text(BAGS["flow"])
    jbag = jax_load.load_demucs_bag(str(tmp_path / "bag.yaml"))
    bag = pload.load_demucs_bag(str(tmp_path / "bag.yaml"), device="cpu")
    assert len(bag) == len(jbag) == 2
    for (p, c, w), (jp, jc, jw) in zip(bag, jbag):
        assert c.__dict__ == jc.__dict__ and c.segment == 7.8 and list(w) == list(jw)
        assert torch.equal(p["decoder"][0]["conv_tr"]["w"],
                           demucs_from_jax(jp, c)["decoder"][0]["conv_tr"]["w"])


def test_bag_member_not_found_is_a_bad_request(tmp_path):
    (tmp_path / "bag.yaml").write_text(BAGS["one"])
    with pytest.raises(BadRequest, match="955717e8"):
        pload.load_demucs_bag(str(tmp_path / "bag.yaml"), device="cpu")


def _write_wav(path, audio, sr):
    wavfile.write(path, sr, (np.clip(audio, -1, 1) * 32767).astype(np.int16))
    return str(path)


def _read(path):
    sr, x = wavfile.read(path)
    return sr, x.astype(np.float64) / 32768.0


@pytest.mark.parametrize("kind", ["th", "yaml"])
def test_cli_separate_matches_jax(model, tmp_path, kind):
    """`cli separate` with a .th (one shift, spectral inversion) and a
    one-model .yaml bag (no shift), against the JAX command line."""
    sd, *_ = model
    th = write_th(tmp_path / "955717e8.th", sd)
    if kind == "yaml":
        (tmp_path / "bag.yaml").write_text(BAGS["one"] + "segment: 0.3\n")
        args = ["--model", str(tmp_path / "bag.yaml")]
    else:
        args = ["--model", th, "--shifts", "1", "--invert-using-spec"]
    song = _write_wav(tmp_path / "song.wav", np.stack([_song(0.4, seed=1), _song(0.4, seed=2)], 1),
                      44100)
    outs = {}
    for who, main in (("port", cli.main), ("jax", jax_cli.main)):
        v, i = str(tmp_path / f"{who}_v.wav"), str(tmp_path / f"{who}_i.wav")
        main(["separate", *args, "--input", song, "--output-vocals", v,
              "--output-instrumental", i] + (["--device", "cpu"] if who == "port" else []))
        outs[who] = [_read(v), _read(i)]
    for (gsr, g), (rsr, r) in zip(outs["port"], outs["jax"]):
        assert gsr == rsr == 44100 and g.shape == r.shape
        assert np.abs(g - r).max() <= TOL + INT16_STEP


def test_cli_separate_needs_the_card_unless_told(model, tmp_path):
    th = write_th(tmp_path / "m.th", model[0])
    song = _write_wav(tmp_path / "song.wav", _song(0.2), 44100)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["separate", "--model", th, "--input", song,
                  "--output-vocals", str(tmp_path / "v.wav")])
    assert not (tmp_path / "v.wav").exists()


# ---------------------------------------------------------------------------
# the served route, and the 400 answers of library validation
# ---------------------------------------------------------------------------

def _start(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


@pytest.fixture(scope="module")
def servers():
    saved = srv._STATE["device"]
    srv.set_device("cpu")
    port, ref = _start(srv.Handler), _start(jax_srv.Handler)
    yield port.server_address[1], ref.server_address[1]
    for httpd in (port, ref):
        httpd.shutdown()
        httpd.server_close()
    srv._STATE["device"] = saved


def _call(port, path, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(obj),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _b64_wav(audio, sr):
    buf = io.BytesIO()
    wavfile.write(buf, sr, (np.clip(audio, -1, 1) * 32767).astype(np.int16))
    return base64.b64encode(buf.getvalue()).decode()


def _decode(b64):
    sr, x = wavfile.read(io.BytesIO(base64.b64decode(b64)))
    return sr, x.astype(np.float64) / 32768.0


def test_api_separate_th_matches_jax_server(servers, model, tmp_path):
    """A mono 22,050 Hz request with a .th: both servers answer 200 with
    mono stems at the model's 44,100 Hz, within 1e-3 plus one int16 step;
    the port's ran on its device thread."""
    th = write_th(tmp_path / "m.th", model[0])
    req = {"audio_b64": _b64_wav(_song(0.4, 22050, seed=3), 22050), "model": th}
    threads = []
    real = psep.separate_vocals

    def spy(*a, **kw):
        threads.append(threading.current_thread().name)
        return real(*a, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(psep, "separate_vocals", spy)
    try:
        (gc, got), (rc, ref) = _call(servers[0], "/api/separate", req), _call(
            servers[1], "/api/separate", req)
    finally:
        mp.undo()
    assert gc == rc == 200, (got, ref)
    assert got["sr"] == ref["sr"] == 44100
    assert threads and all(t.startswith("rvc-device") for t in threads)
    for key in ("vocals_b64", "instrumental_b64"):
        (gsr, g), (rsr, r) = _decode(got[key]), _decode(ref[key])
        assert gsr == rsr == 44100 and g.shape == r.shape == (17640,)
        assert np.abs(g - r).max() <= TOL + INT16_STEP


def test_api_separate_quantized_th_answers_400(servers, model, tmp_path):
    """A quantized checkpoint is the caller's mistake: 400 (JAX's server
    answers 500, its NotImplementedError raised in the library)."""
    th = write_th(tmp_path / "q.th", dict(model[0], __quantized=True))
    req = {"audio_b64": _b64_wav(_song(0.2, 22050), 22050), "model": th}
    code, body = _call(servers[0], "/api/separate", req)
    assert code == 400 and "quantized" in body["error"]
    assert _call(servers[1], "/api/separate", req)[0] == 500


@pytest.mark.parametrize("mismatch", ["rate", "architecture"])
def test_api_fuse_of_mismatched_models_answers_400(servers, tmp_path, mismatch):
    """Fusing models of different rates or architectures: 400 with the
    library's message (JAX's server answers 500)."""
    w = torch.zeros(3)
    torch.save({"weight": {"a": w}, "sr": 48000}, tmp_path / "a.pth")
    other = {"weight": {"a": w}, "sr": 40000} if mismatch == "rate" else {
        "weight": {"b": w}, "sr": 48000}
    torch.save(other, tmp_path / "b.pth")
    req = {"a": str(tmp_path / "a.pth"), "b": str(tmp_path / "b.pth"),
           "out": str(tmp_path / "out.pth")}
    code, body = _call(servers[0], "/api/fuse", req)
    assert code == 400 and ("rates" if mismatch == "rate" else "architectures") in body["error"]
    assert _call(servers[1], "/api/fuse", dict(req, out=str(tmp_path / "j.pth")))[0] == 500
    assert not os.path.exists(req["out"])

