"""The port's HTTP server (`rvc_maker_tpu_torch/app/server.py`) on the
CPU, in process, against the JAX package's server.

Both servers get the same `/api/convert` request on the same files: a
voice `.pth`, a reference-layout `rmvpe.pt`, a fairseq HuBERT `.pt` and a
`.npy` index.  The port's noise is the JAX server's draws, fed through
`convert_utterance`'s `noise_fn`.  In fp32 the decoded waveforms agree
within 1e-3 plus one int16 step.  In bf16, correlation > 0.98 and max
abs < 0.1, the thresholds of JAX `tests/test_bf16_mode.py`.  Then the
counterparts of JAX `tests/test_app.py` and the 501 answer of every route
the port has not ported.  The distances are printed (-s).  Sizes are
small: a 2-layer HuBERT and a narrow RMVPE and synthesizer.
"""

import base64
import functools
import http.client
import io
import json
import os
import re
import shutil
import threading
import time
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from rvc_maker_tpu.app import server as jax_srv
from rvc_maker_tpu.config import ModelConfig as JaxModelConfig
from rvc_maker_tpu.config import RVCConfig as JaxRVCConfig
from rvc_maker_tpu.interop.torch_export import export_synthesizer_pth
from rvc_maker_tpu_torch.app import server as srv
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.ops import resblock as rb
from rvc_maker_tpu_torch.pipelines.convert import ConvertSettings
from rvc_maker_tpu_torch.utils.i18n import tr
from torch_port_util import (hubert_state_dict, jax_noise, rmvpe_state_dict,  # noqa: F401
                             torch_threads)

JCFG = JaxModelConfig(
    spec_channels=129, segment_size=8, inter_channels=32, hidden_channels=32,
    filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
    resblock_kernel_sizes=(3, 7), resblock_dilation_sizes=((1, 3, 5), (1, 3, 5)),
    upsample_rates=(4, 4, 2, 2), upsample_initial_channel=64,
    upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4, gin_channels=16,
    sr=6400, use_f0=True, text_enc_hidden_dim=768)
INT16_STEP = 1.0 / 32768
FP32_ATOL = 1e-3 + INT16_STEP
CORR_MIN, MAX_ABS = 0.98, 0.1          # JAX test_bf16_close_to_fp32


def _voice(seconds=1.0, f0=200.0, seed=0):
    tt = np.arange(int(16000 * seconds)) / 16000
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.05 * np.sin(2 * np.pi * 3 * tt))) / 16000
    x = sum(0.3 / h * np.sin(h * phase) for h in (1, 2, 3))
    return (x + 0.01 * np.random.RandomState(seed).randn(len(tt))).astype(np.float32)


def _wav_b64(audio, sr=16000):
    buf = io.BytesIO()
    wavfile.write(buf, sr, (np.clip(audio, -1, 1) * 32767).astype(np.int16))
    return base64.b64encode(buf.getvalue()).decode()


def _decode(b64):
    sr, x = wavfile.read(io.BytesIO(base64.b64decode(b64)))
    return sr, x.astype(np.float64) / 32768.0


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The served files, from seeded trees: the synthesizer's decode
    scaled up so that 1e-3 is a tight bound on the waveform."""
    d = tmp_path_factory.mktemp("serve")
    tree = from_jax.random_synthesizer_tree(JCFG, seed=0)
    for u in tree["dec"]["ups"]:
        u["w"] *= 20.0
    tree["dec"]["conv_post"]["w"] *= 20.0
    out = dict(model=str(d / "voice.pth"), rmvpe=str(d / "rmvpe.pt"),
               embedder=str(d / "hubert.pt"), index=str(d / "total_fea.npy"))
    export_synthesizer_pth(jax.tree_util.tree_map(jnp.asarray, tree),
                           JaxRVCConfig(version="v2", model=JCFG), out["model"])
    torch.save(rmvpe_state_dict(from_jax.random_rmvpe_tree(
        seed=2, widths=(4, 8, 16, 32, 64), inter_width=128), np.random.RandomState(0)),
        out["rmvpe"])
    torch.save({"model": hubert_state_dict(from_jax.random_hubert_tree(seed=1, n_layers=2))},
               out["embedder"])
    np.save(out["index"], np.random.RandomState(5).randn(300, 768).astype(np.float32))
    return out


def _start(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The port's server on the CPU and the JAX package's, each with its
    settings file in a temporary directory.  The JAX fairseq loader reads
    a fixed 12 layers; it is told the test HuBERT's 2 (the port's loader
    counts them)."""
    from rvc_maker_tpu.models import hubert as jax_hubert

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_hubert, "N_LAYERS", 2)
    d = tmp_path_factory.mktemp("settings")
    saved = (srv.SETTINGS_PATH, dict(srv._SETTINGS), srv._STATE["device"],
             jax_srv._SETTINGS_PATH, dict(jax_srv._SETTINGS))
    srv.SETTINGS_PATH = str(d / "port.json")
    jax_srv._SETTINGS_PATH = str(d / "jax.json")
    srv.set_device("cpu")
    port, ref = _start(srv.Handler), _start(jax_srv.Handler)
    yield port.server_address[1], ref.server_address[1]
    for httpd in (port, ref):
        httpd.shutdown()
        httpd.server_close()
    if srv._STATE.get("batcher") is not None:
        srv._STATE["batcher"].close()
    srv._STATE.update(pipeline=None, pipeline_key=None, batcher=None, batcher_pipe=None)
    srv.SETTINGS_PATH, jax_srv._SETTINGS_PATH = saved[0], saved[3]
    srv._SETTINGS.clear()
    srv._SETTINGS.update(saved[1])
    srv._STATE["device"] = saved[2]
    jax_srv._SETTINGS.clear()
    jax_srv._SETTINGS.update(saved[4])
    mp.undo()


def _call(port, path, obj=None, method="POST", raw=None):
    """(status, JSON body or text) of one request to 127.0.0.1:port."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        body = raw if raw is not None else (None if obj is None else json.dumps(obj))
        conn.request(method, path, body=body, headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read().decode()
        ctype = resp.getheader("Content-Type", "")
        return resp.status, json.loads(data) if "json" in ctype else data
    finally:
        conn.close()


def _ok(port, path, obj):
    code, body = _call(port, path, obj)
    assert code == 200, (code, body)
    return body


def _set_precision(servers, precision):
    for p in servers:
        assert _ok(p, "/api/settings", {"precision": precision})["precision"] == precision


def _convert_req(files, audio, **kw):
    return dict(dict(files, audio_b64=_wav_b64(audio), f0_method="rmvpe", index_rate=0.5,
                     protect=0.33), **kw)


def _with_jax_noise(pipe, monkeypatch, dtype=None):
    """Feed the port's pipeline the noise the JAX pipeline draws for each
    chunk (PRNGKey(0), in the compute dtype)."""
    cfg = pipe.cfg

    def noise_fn(b, p_len):
        z, s = jax_noise(b, p_len, cfg.inter_channels, cfg.upp, dtype=dtype)
        return torch.as_tensor(z), {"sine": torch.as_tensor(s)}

    monkeypatch.setattr(pipe, "convert_utterance", functools.partial(
        type(pipe).convert_utterance, pipe, noise_fn=noise_fn))


def _both(servers, files, req, precision, monkeypatch, noise_dtype=None):
    _set_precision(servers, precision)
    pipe = srv._get_pipeline(files["model"], files["index"], files["rmvpe"], files["embedder"])
    _with_jax_noise(pipe, monkeypatch, noise_dtype)
    out = [_ok(p, "/api/convert", req) for p in servers]
    (sr_p, wav_p), (sr_j, wav_j) = (_decode(o["audio_b64"]) for o in out)
    assert sr_p == sr_j == out[0]["sr"] == out[1]["sr"] == JCFG.sr
    assert wav_p.shape == wav_j.shape
    return wav_p, wav_j


def test_convert_matches_jax_server_fp32(servers, files, monkeypatch):
    """The same fp32 request to both servers: the port's response within
    1e-3 plus one int16 step of the JAX server's."""
    req = _convert_req(files, _voice(1.0, 190.0, 1))
    wav_p, wav_j = _both(servers, files, req, "fp32", monkeypatch)
    err = float(np.abs(wav_p - wav_j).max())
    print(f"\nfp32 /api/convert, port vs JAX server: max abs {err:.3e} (tol {FP32_ATOL:.3e}); "
          f"|wav|max {np.abs(wav_j).max():.3f}")
    assert np.abs(wav_j).max() > 0.1 and abs(len(wav_j) / JCFG.sr - 1.0) < 0.05
    assert err <= FP32_ATOL, err


def test_convert_close_to_jax_server_bf16(servers, files, monkeypatch):
    """The same request in bf16 on both servers, the port fed JAX's bf16
    noise: correlation > 0.98 and max abs < 0.1.  F0 by yin, which runs
    fp32 in both modes: RMVPE's salience net runs bf16, and where the
    random net's salience is flat each framework's rounding moves the
    argmax by up to an octave on some frames, so the waveforms would
    follow different f0 (test_torch_bf16.py holds RMVPE's bf16 drift
    against JAX's)."""
    req = _convert_req(files, _voice(1.0, 190.0, 1), f0_method="yin")
    wav_p, wav_j = _both(servers, files, req, "bf16", monkeypatch, noise_dtype=jnp.bfloat16)
    corr = float(np.dot(wav_p, wav_j) / (np.linalg.norm(wav_p) * np.linalg.norm(wav_j)))
    err = float(np.abs(wav_p - wav_j).max())
    print(f"\nbf16 /api/convert, port vs JAX server: corr {corr:.6f}, max abs {err:.3e}")
    assert corr > CORR_MIN and err < MAX_ABS, (corr, err)


def test_index_page(servers):
    """The page is the JAX server's, rendered in the active locale."""
    code, page = _call(servers[0], "/", method="GET")
    assert code == 200 and "Convert Audio" in page and "Model Fusion" in page
    assert "{{" not in page
    assert srv.INDEX_HTML == jax_srv.INDEX_HTML
    assert srv.render_index() == jax_srv.render_index()


def test_i18n_endpoint(servers):
    code, body = _call(servers[0], "/api/i18n", method="GET")
    assert code == 200 and body["language"] == "en-US"
    assert body["strings"]["convert_audio"] == "Convert Audio"
    assert body["strings"]["not_ported"] == tr("not_ported", what="{what}")
    assert _call(servers[0], "/no/such/page", method="GET")[0] == 404


def test_settings_endpoint(servers):
    port = servers[0]
    r = _ok(port, "/api/settings", {})
    assert "en-US" in r["languages"] and "vi-VN" in r["languages"]
    r = _ok(port, "/api/settings", {"language": "ja-JP", "precision": "fp32"})
    assert r["language"] == "ja-JP" and r["precision"] == "fp32"
    try:
        assert tr("srt_invalid") == "SRTファイルが空か不正です"
        with open(srv.SETTINGS_PATH, encoding="utf-8") as f:
            assert json.load(f) == {"language": "ja-JP", "precision": "fp32"}
        assert _call(port, "/api/settings", {"precision": "fp16"})[0] == 400
        assert _call(port, "/api/settings", {"language": "xx-XX"})[0] == 400
    finally:
        _ok(port, "/api/settings", {"language": "en-US", "precision": "bf16"})
    assert tr("srt_invalid") == "The SRT file is empty or malformed"


def test_settings_file_is_the_ports_own(tmp_path):
    """The port's settings persist to ~/.rvc_maker_tpu_torch.json, never
    to the JAX server's ~/.rvc_maker_tpu.json."""
    import subprocess
    import sys

    code = ("from rvc_maker_tpu_torch.app import server as s; "
            "s._SETTINGS['precision'] = 'fp32'; s._save_settings()")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, HOME=str(tmp_path)), cwd=os.path.dirname(
                       os.path.dirname(os.path.abspath(__file__))))
    with open(tmp_path / ".rvc_maker_tpu_torch.json", encoding="utf-8") as f:
        assert json.load(f) == {"precision": "fp32"}
    assert not (tmp_path / ".rvc_maker_tpu.json").exists()


def test_persisted_settings_load(tmp_path, monkeypatch):
    """What /api/settings saved is applied when a server starts."""
    from rvc_maker_tpu_torch.utils import i18n

    path = tmp_path / "settings.json"
    path.write_text(json.dumps({"language": "vi-VN", "precision": "fp32"}))
    monkeypatch.setattr(srv, "SETTINGS_PATH", str(path))
    monkeypatch.setattr(srv, "_SETTINGS", {})
    try:
        srv._load_settings()
        assert srv._SETTINGS == {"language": "vi-VN", "precision": "fp32"}
        assert i18n.current_language() == "vi-VN"
    finally:
        i18n.set_language("en-US")
    path.write_text("{not json")
    monkeypatch.setattr(srv, "_SETTINGS", {})
    srv._load_settings()
    assert srv._SETTINGS == {}


def test_precision_setting_reaches_pipeline(servers, files):
    """The settings' precision selects the pipeline's compute dtype and
    is part of the pipeline cache key."""
    _set_precision(servers[:1], "bf16")
    pipe = srv._get_pipeline(files["model"], "", "", files["embedder"])
    assert pipe.compute_dtype is torch.bfloat16 and pipe.device.type == "cpu"
    assert pipe.synth_params["dec"]["conv_pre"]["w"].dtype == torch.bfloat16
    assert "bf16" in srv._STATE["pipeline_key"]
    _set_precision(servers[:1], "fp32")
    pipe32 = srv._get_pipeline(files["model"], "", "", files["embedder"])
    assert pipe32.compute_dtype is None and pipe32 is not pipe
    assert srv._get_pipeline(files["model"], "", "", files["embedder"]) is pipe32
    _set_precision(servers[:1], "bf16")


def test_served_requests_run_under_inference_mode(servers, files, monkeypatch):
    """Grad mode is thread-local: the handler thread's conversion runs
    under inference mode, and its output carries no autograd graph."""
    _set_precision(servers[:1], "fp32")
    pipe = srv._get_pipeline(files["model"], files["index"], files["rmvpe"], files["embedder"])
    seen = []
    orig = pipe.convert_batch

    def spy(*a, **kw):
        seen.append(torch.is_inference_mode_enabled())
        wav, pitchf = orig(*a, **kw)
        seen.append(wav.requires_grad)
        return wav, pitchf

    monkeypatch.setattr(pipe, "convert_batch", spy)
    _ok(servers[0], "/api/convert", _convert_req(files, _voice(0.5)))
    assert seen == [True, False]


def test_conversion_and_warm_up_run_on_one_device_thread(servers, files, monkeypatch):
    """PyTorch keeps cuDNN's execution plans per thread: the warm-up, the
    single path and the batcher all call the pipeline on the server's one
    device thread, so the plans the warm-up builds serve every request."""
    _set_precision(servers[:1], "fp32")
    paths = (files["model"], files["index"], files["rmvpe"], files["embedder"])
    pipe = srv._get_pipeline(*paths)
    threads = []
    orig = pipe.convert_batch

    def spy(*a, **kw):
        threads.append(threading.current_thread().name)
        return orig(*a, **kw)

    monkeypatch.setattr(pipe, "convert_batch", spy)
    srv.warm(*paths, buckets="1,2x1")
    _ok(servers[0], "/api/convert", _convert_req(files, _voice(0.5)))
    monkeypatch.setenv("RVC_TPU_BATCH_SERVE", "1")
    _ok(servers[0], "/api/convert", _convert_req(files, _voice(0.5)))
    assert len(threads) >= 4 and set(threads) == {"rvc-device_0"}, threads


@pytest.mark.parametrize("case", [
    "bad_base64", "missing_audio", "not_a_wav", "empty_audio", "unknown_f0_method",
    "rmvpe_without_path", "sid_not_integer", "sid_out_of_range", "not_json", "not_an_object",
    "missing_model"])
def test_malformed_convert_requests_are_client_errors(servers, files, case):
    """Malformed requests answer 400, never 500, and the server keeps
    serving; faults of the request are caught in app/."""
    good = _convert_req(files, _voice(0.3))
    reqs = {
        "bad_base64": dict(good, audio_b64="!!!notbase64!!!"),
        "missing_audio": {k: v for k, v in good.items() if k != "audio_b64"},
        "not_a_wav": dict(good, audio_b64=base64.b64encode(b"junkjunk").decode()),
        "empty_audio": dict(good, audio_b64=_wav_b64(np.zeros(0, np.float32))),
        "unknown_f0_method": dict(good, f0_method="no-such-method"),
        "rmvpe_without_path": dict(good, f0_method="hybrid[rmvpe+yin]", rmvpe=""),
        "sid_not_integer": dict(good, sid="zero"),
        "sid_out_of_range": dict(good, sid=JCFG.spk_embed_dim),
        "missing_model": {k: v for k, v in good.items() if k != "model"},
    }
    raw = {"not_json": "{", "not_an_object": "[1, 2]"}.get(case)
    code, body = _call(servers[0], "/api/convert", reqs.get(case), raw=raw)
    assert code == 400, (case, code, body)
    assert "error" in body
    assert "Convert Audio" in _call(servers[0], "/", method="GET")[1]


def test_raised_in_library_classifier():
    """A ValueError from a library module of the port is a server fault
    (500) even though its type is one the 400 classifier matches; one
    raised while app/ parses the request is a client error.  Frames are
    told apart by module name, so `rvc_maker_tpu_torch/` is not mistaken
    for the JAX package or the other way round."""
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline

    try:
        json.loads("{")
    except json.JSONDecodeError as e:
        assert not srv._raised_in_library(e)
    try:
        srv._int_field({"sid": "x"}, "sid", 0)
    except ValueError as e:
        assert not srv._raised_in_library(e)
    try:
        ConvertPipeline(None, None, None, device="cpu", compute_dtype=torch.float16)
    except ValueError as e:
        assert srv._raised_in_library(e)
    try:
        from rvc_maker_tpu.ops.int8_conv import Int8Ctx

        Int8Ctx("bogus-mode")               # the JAX package's library, not ours
    except ValueError as e:
        assert not srv._raised_in_library(e)


def test_library_fault_is_a_server_error(servers, files, tmp_path):
    """A corrupt voice model raises inside the port's loader: 500."""
    bad = tmp_path / "bad.pth"
    torch.save({"weight": {}, "config": [1, 2, 3]}, bad)
    code, body = _call(servers[0], "/api/convert",
                       _convert_req(dict(files, model=str(bad)), _voice(0.3)))
    assert code == 500 and "error" in body


def test_kernel_failure_answers_500_without_the_plain_chain(servers, files, monkeypatch):
    """A request whose resblock route is a kernel that cannot be built
    answers 500, and the plain F.conv1d chain never runs in its place.
    (On the CPU the route is the plain chain; it is pointed at the bf16
    tensor-core kernel here, whose build has no nvcc on this machine.)"""
    _set_precision(servers[:1], "bf16")
    branches = []
    monkeypatch.setattr(rb, "_route", lambda device_type, dtype, channels: "tc_bf16")
    monkeypatch.setattr(rb, "_library", lambda route: (_ for _ in ()).throw(
        RuntimeError("nvcc not found: the CUDA toolkit is needed")))
    orig = rb._branch
    monkeypatch.setattr(rb, "_branch", lambda *a, **k: branches.append(1) or orig(*a, **k))
    code, body = _call(servers[0], "/api/convert", _convert_req(files, _voice(0.3)))
    assert code == 500 and "nvcc" in body["error"], (code, body)
    assert branches == []


def test_convert_refused_while_training_job_active(servers, monkeypatch):
    """503 and a retry while a train job runs; RVC_TPU_SERVE_DURING_TRAIN=1
    opts out (the request then fails later, on the missing model)."""
    monkeypatch.delenv("RVC_TPU_SERVE_DURING_TRAIN", raising=False)
    req = {"audio_b64": _wav_b64(_voice(0.3)), "model": "/nope.pth", "f0_method": "yin"}
    with srv._JOBS_LOCK:
        srv._JOBS["train-999"] = {"log": [], "done": False, "error": None}
    try:
        code, body = _call(servers[0], "/api/convert", req)
        assert code == 503 and body.get("retry") is True
        monkeypatch.setenv("RVC_TPU_SERVE_DURING_TRAIN", "1")
        assert _call(servers[0], "/api/convert", req)[0] not in (200, 503)
    finally:
        with srv._JOBS_LOCK:
            del srv._JOBS["train-999"]


def test_batch_serve_matches_direct(servers, files, monkeypatch):
    """RVC_TPU_BATCH_SERVE=1: concurrent requests ride the batcher; each
    response is its row of the same device batch run directly, within
    the batcher tolerance of JAX tests/test_batcher.py (2e-3, the last
    upp samples excluded), cut to the samples its own audio decodes."""
    from rvc_maker_tpu_torch.app.batcher import _valid_out_samples

    _set_precision(servers[:1], "fp32")
    pipe = srv._get_pipeline(files["model"], files["index"], files["rmvpe"], files["embedder"])
    calls, orig = [], pipe.convert_batch

    def spy(audio_b, lengths, sid, s, **kw):
        calls.append((np.array(audio_b), np.array(lengths), sid, s))
        return orig(audio_b, lengths, sid, s, **kw)

    monkeypatch.setattr(pipe, "convert_batch", spy)
    monkeypatch.setenv("RVC_TPU_BATCH_SERVE", "1")
    reqs = [_convert_req(files, _voice(0.6, f, i)) for i, f in enumerate((170.0, 230.0, 290.0))]
    out = [None] * len(reqs)

    def call(i):
        out[i] = _ok(servers[0], "/api/convert", reqs[i])

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    assert srv._STATE["batcher_pipe"] is pipe and calls
    worst = 0.0
    for r, o in zip(reqs, out):
        a16 = srv._request_audio(r)
        audio_b, lengths, sid, s, row = next(
            (c[0], c[1], c[2], c[3], j) for c in calls for j in range(len(c[0]))
            if np.array_equal(c[0][j, :len(a16)], a16))
        ref = np.clip(orig(audio_b, lengths, sid, s)[0][row].numpy(), -1, 1)
        got = _decode(o["audio_b64"])[1]
        assert len(got) == min(len(a16) * JCFG.upp // 160,
                               _valid_out_samples(len(a16), JCFG.upp))
        k = len(got) - JCFG.upp
        np.testing.assert_allclose(got[:k], ref[:k], atol=2e-3, rtol=2e-3)
        worst = max(worst, float(np.abs(got[:k] - ref[:k]).max()))
    print(f"\nbatched /api/convert vs its direct row: max abs {worst:.3e}, device batches "
          f"{[c[0].shape for c in calls]}")


@pytest.mark.parametrize("method", ["yin", "pyin", "swipe", "pm", "dio", "harvest"])
def test_f0_extract_matches_jax_server(servers, method):
    """/api/f0_extract on both servers: the same frames, the same f0
    (host methods exactly; yin within 1e-2 Hz)."""
    req = {"audio_b64": _wav_b64(_voice(0.8, 220.0, 3)), "method": method}
    got, ref = (_ok(p, "/api/f0_extract", req) for p in servers)
    f0, f0_ref = np.asarray(got["f0"]), np.asarray(ref["f0"])
    assert got["hop_ms"] == ref["hop_ms"] == 10.0 and f0.shape == f0_ref.shape
    voiced = f0_ref > 0
    assert voiced.mean() > 0.5, method
    np.testing.assert_array_equal(f0 > 0, voiced)
    np.testing.assert_allclose(f0, f0_ref, atol=1e-2 if method == "yin" else 1e-4,
                               rtol=0 if method == "yin" else 1e-5)
    assert np.abs(np.median(f0[voiced]) - 220.0) < 15.0, method


def test_f0_extract_unknown_method_is_a_client_error(servers):
    code, body = _call(servers[0], "/api/f0_extract",
                       {"audio_b64": _wav_b64(_voice(0.3)), "method": "rmvpe"})
    assert code == 400 and "rmvpe" in body["error"]


def _wait_job(port, job_id, timeout=120):
    for _ in range(int(timeout * 10)):
        st = _ok(port, "/api/job_status", {"job_id": job_id})
        if st["done"]:
            return st
        time.sleep(0.1)
    raise AssertionError(f"job {job_id} did not finish")


def test_preprocess_job_endpoint(servers, tmp_path):
    from rvc_maker_tpu_torch.utils.audio import save_wav

    data = tmp_path / "data"
    data.mkdir()
    sr = 32000
    tt = np.arange(4 * sr) / sr
    save_wav(str(data / "a.wav"), (0.3 * np.sin(2 * np.pi * 220 * tt)).astype(np.float32), sr)
    exp = str(tmp_path / "exp")
    r = _ok(servers[0], "/api/job_start", {"kind": "preprocess", "exp_dir": exp,
                                            "dataset": str(data), "sr": sr,
                                            "num_workers": 1})
    assert r["job_id"].startswith("preprocess-")
    st = _wait_job(servers[0], r["job_id"])
    assert st["done"] and not st["error"], st
    assert "segments" in st["log"]
    assert os.listdir(os.path.join(exp, "sliced_audios_16k"))


def test_train_job_endpoint(servers, tmp_path, monkeypatch):
    """A train job runs `train_loop.train` on the server's device with the
    request's preset, epochs and batch size; while it runs, conversion is
    refused with 503; its failure is reported through /api/job_status."""
    from rvc_maker_tpu_torch.config import preset
    from rvc_maker_tpu_torch.pipelines import train_loop

    monkeypatch.delenv("RVC_TPU_SERVE_DURING_TRAIN", raising=False)
    release, calls = threading.Event(), []

    def fake_train(exp_dir, cfg, **kw):
        calls.append((exp_dir, cfg, kw))
        release.wait(60)
        if kw["total_epochs"] == 3:
            raise RuntimeError("no filelist.txt")

    monkeypatch.setattr(train_loop, "train", fake_train)
    req = {"kind": "train", "exp_dir": str(tmp_path), "sr": 40000, "version": "v1",
           "epochs": 2, "batch_size": 4}
    job = _ok(servers[0], "/api/job_start", req)["job_id"]
    try:
        code, body = _call(servers[0], "/api/convert",
                           {"audio_b64": _wav_b64(_voice(0.3)), "model": "/nope.pth"})
        assert code == 503 and body["retry"] is True
    finally:
        release.set()
    st = _wait_job(servers[0], job)
    assert not st["error"] and "train: done" in st["log"], st
    exp_dir, cfg, kw = calls[0]
    assert exp_dir == str(tmp_path) and cfg == preset("v1", 40000)
    assert kw["total_epochs"] == 2 and kw["batch_size"] == 4
    assert kw["device"] == torch.device("cpu")
    failed = _ok(servers[0], "/api/job_start", dict(req, epochs=3))["job_id"]
    st = _wait_job(servers[0], failed)
    assert st["error"] == "no filelist.txt"


@pytest.mark.parametrize("req,code", [
    ({"kind": "nope"}, 400),
    ({"kind": "train", "exp_dir": "/x", "epochs": "many"}, 400),
    ({"kind": "preprocess"}, 400),
    ({"kind": "create_dataset", "inputs": ["https://example.invalid/a"]}, 501),
    ({"kind": "extract", "exp_dir": "/x"}, 200),
    ({"kind": "extract", "exp_dir": "/x", "embedder": "e.onnx"}, 200),
    ({"kind": "train", "exp_dir": "/x", "vocoder": "RefineGAN"}, 200),
    ({"kind": "train", "exp_dir": "/x", "pitch_guidance": False}, 200),
], ids=["unknown-kind", "bad-epochs", "no-dataset", "create-dataset", "extract-yin",
        "extract-onnx", "train-refinegan", "train-no-pitch"])
def test_job_start_refusals(servers, req, code, tmp_path):
    """Malformed jobs answer 400, unported ones 501.  The extract job
    without an rmvpe path (yin), with a `.onnx` embedder, and the train
    jobs of another vocoder or without pitch are ported: they start, and
    on an experiment dir with nothing in it (or a missing embedder file)
    they finish with an error."""
    if code == 200:
        req = dict(req, exp_dir=str(tmp_path / "empty"))
    status, body = _call(servers[0], "/api/job_start", req)
    assert status == code, (status, body)
    if code == 501:
        assert body["not_ported"] is True and "not ported" in body["error"]
    if code == 200:
        st = _wait_job(servers[0], body["job_id"])
        assert st["error"] and "No such file" in st["error"], st


def test_extract_job_without_rmvpe_runs_yin(servers, tmp_path):
    """An extract job with neither an rmvpe nor an embedder path: yin F0
    and a random HuBERT, as the JAX server runs it; it writes the f0
    files, the features and the filelist."""
    from rvc_maker_tpu_torch.pipelines import extract as ex
    from rvc_maker_tpu_torch.pipelines.preprocess import preprocess_dataset
    from rvc_maker_tpu_torch.utils.audio import save_wav

    data = tmp_path / "data"
    data.mkdir()
    sr = 32000
    tt = np.arange(3 * sr) / sr
    save_wav(str(data / "a.wav"), (0.3 * np.sin(2 * np.pi * 180 * tt)).astype(np.float32), sr)
    exp = tmp_path / "exp"
    assert preprocess_dataset(str(data), str(exp), sr, per=1.5, num_workers=1) > 0
    job = _ok(servers[0], "/api/job_start", {"kind": "extract", "exp_dir": str(exp),
                                              "sr": sr})["job_id"]
    st = _wait_job(servers[0], job)
    assert not st["error"] and "extract: done" in st["log"], st
    names = sorted(os.listdir(exp / "f0_voiced"))
    assert names and os.path.isfile(exp / "filelist.txt")
    assert sorted(os.listdir(exp / "v2_extracted")) == [n[:-len(".wav.npy")] + ".npy"
                                                         for n in names]
    # the f0 is yin's: the same files as extract_f0(method="yin")
    ref = tmp_path / "ref"
    shutil.copytree(exp / "sliced_audios_16k", ref / "sliced_audios_16k")
    ex.extract_f0(str(ref), method="yin", device="cpu")
    for n in names:
        np.testing.assert_array_equal(np.load(exp / "f0_voiced" / n),
                                      np.load(ref / "f0_voiced" / n))


def test_extract_job_with_onnx_embedder(servers, files, onnx_files, tmp_path):
    """An extract job with a `.onnx` embedder writes the features that
    the `.pt` it was exported from gives, within 1e-4, and the mute row."""
    from rvc_maker_tpu_torch.models.hubert import load_hubert_pt
    from rvc_maker_tpu_torch.pipelines import extract as ex
    from rvc_maker_tpu_torch.pipelines.preprocess import preprocess_dataset
    from rvc_maker_tpu_torch.utils.audio import save_wav

    data = tmp_path / "data"
    data.mkdir()
    sr = 32000
    save_wav(str(data / "a.wav"), _voice(2.0, 180.0, 2), 16000)
    exp = tmp_path / "exp"
    assert preprocess_dataset(str(data), str(exp), sr, per=1.5, num_workers=1) > 0
    job = _ok(servers[0], "/api/job_start", {"kind": "extract", "exp_dir": str(exp), "sr": sr,
                                              "embedder": onnx_files["embedder"]})["job_id"]
    st = _wait_job(servers[0], job)
    assert not st["error"] and "extract: done" in st["log"], st
    ref = tmp_path / "ref"
    shutil.copytree(exp / "sliced_audios_16k", ref / "sliced_audios_16k")
    ex.extract_embeddings(str(ref), load_hubert_pt(files["embedder"]), device="cpu")
    names = sorted(os.listdir(ref / "v2_extracted"))
    assert names and sorted(os.listdir(exp / "v2_extracted")) == names
    for name in names:
        got, want = np.load(exp / "v2_extracted" / name), np.load(ref / "v2_extracted" / name)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert os.path.isfile(exp / "mute" / "v2_extracted" / "mute.npy")


@pytest.mark.parametrize("vocoder,pitch", [("MRF HiFi-GAN", True), ("RefineGAN", True),
                                           ("Default", False)])
def test_train_job_takes_vocoder_and_pitch_guidance(servers, tmp_path, monkeypatch,
                                                    vocoder, pitch):
    """A train job of another vocoder or an f0-less model runs
    `train_loop.train` with that preset on the server's device."""
    from rvc_maker_tpu_torch.config import preset
    from rvc_maker_tpu_torch.pipelines import train_loop

    calls = []
    monkeypatch.setattr(train_loop, "train", lambda exp_dir, cfg, **kw: calls.append(
        (exp_dir, cfg, kw)))
    job = _ok(servers[0], "/api/job_start", {
        "kind": "train", "exp_dir": str(tmp_path), "sr": 48000, "epochs": 1,
        "vocoder": vocoder, "pitch_guidance": pitch})["job_id"]
    st = _wait_job(servers[0], job)
    assert not st["error"] and "train: done" in st["log"], st
    (exp_dir, cfg, kw), = calls
    assert cfg == preset("v2", 48000, vocoder=vocoder, pitch_guidance=pitch)
    assert kw["total_epochs"] == 1 and kw["device"] == torch.device("cpu")


def test_job_status_unknown_id(servers):
    assert _call(servers[0], "/api/job_status", {"job_id": "train-12345"})[0] == 404


def _jax_post_routes():
    with open(jax_srv.__file__, encoding="utf-8") as f:
        return set(re.findall(r'self\.path == "(/api/[a-z0-9_]+)"', f.read()))


def test_every_jax_route_is_served_or_answers_501():
    served = {"/api/convert", "/api/f0_extract", "/api/job_start", "/api/job_status",
              "/api/settings", "/api/i18n", "/api/effects", "/api/model_info", "/api/fuse",
              "/api/tts", "/api/export_onnx", "/api/separate", "/api/convert_whisper",
              "/api/audio_edit"}
    assert served | set(srv.UNPORTED_ROUTES) == _jax_post_routes()
    assert not served & set(srv.UNPORTED_ROUTES)


@pytest.mark.parametrize("path", sorted(srv.UNPORTED_ROUTES))
def test_unported_route_answers_501(servers, path):
    """Each route whose module is not ported answers 501, its message
    through `tr`, naming the module it needs."""
    code, body = _call(servers[0], path, {"model": "m.pth"})
    assert code == 501 and body["not_ported"] is True
    assert body["error"] == tr("not_ported", what=srv.UNPORTED_ROUTES[path])


def test_audio_edit_matches_jax_server(servers, tmp_path, monkeypatch):
    """/api/audio_edit with the toy stack on both servers (the port given
    JAX's noise): 200, and the written stereo WAVs within 1e-3."""
    from torch_port_util import patch_jax_edit_noise

    src = str(tmp_path / "in.wav")
    wavfile.write(src, 16000, _voice(0.5, 200.0, 4))
    req = dict(input=src, toy_stack=True, steps=8, t_start=50, source_prompt="a",
               target_prompt="b", sample_rate=22050)
    patch_jax_edit_noise(monkeypatch)
    got = _ok(servers[0], "/api/audio_edit", dict(req, output=str(tmp_path / "port.wav")))
    ref = _ok(servers[1], "/api/audio_edit", dict(req, output=str(tmp_path / "jax.wav")))
    (sr_p, x), (sr_j, y) = wavfile.read(got["output"]), wavfile.read(ref["output"])
    assert sr_p == sr_j == 22050 and x.shape == y.shape and x.shape[1] == 2
    err = np.abs(x.astype(np.float64) - y).max() / 32768.0
    print(f"/api/audio_edit port vs JAX: {err:.3e}")
    assert err <= 1e-3, err
    assert _call(servers[0], "/api/audio_edit", dict(req, input=str(tmp_path / "no.wav")))[0] == 400


def _both_ok(servers, path, req, jreq=None):
    return _ok(servers[0], path, req), _ok(servers[1], path, req if jreq is None else jreq)


def test_effects_matches_jax_server(servers):
    """The same effects request to both servers: the same WAV back."""
    req = dict(audio_b64=_wav_b64(_voice(0.6, 210.0, 3)), reverb=True, reverb_room_size=0.7,
               pitchshift=True, pitch_shift=3.0, chorus=True, compressor=True, gain=True,
               gain_db=-2.0, resample_sr=22050)
    got, ref = _both_ok(servers, "/api/effects", req)
    assert got == ref and got["sr"] == 22050
    assert abs(len(_decode(got["audio_b64"])[1]) / 22050 - 0.6) < 0.01


def test_model_info_matches_jax_server(servers, files):
    got, ref = _both_ok(servers, "/api/model_info", {"model": files["model"]})
    assert got == ref and got["sr"] == JCFG.sr and got["n_speakers"] == JCFG.spk_embed_dim
    assert _call(servers[0], "/api/model_info", {})[0] == 400


def test_fuse_matches_jax_server(servers, files, tmp_path):
    """Both servers fuse the voice with itself at 0.3: the same weights,
    each written where the request says."""
    req = {"a": files["model"], "b": files["model"], "ratio": 0.3}
    got, ref = _both_ok(servers, "/api/fuse", dict(req, out=str(tmp_path / "p.pth")),
                        dict(req, out=str(tmp_path / "j.pth")))
    assert got == {"output": str(tmp_path / "p.pth")} and ref == {"output": str(tmp_path / "j.pth")}
    wp, wj = (torch.load(tmp_path / f, weights_only=False)["weight"] for f in ("p.pth", "j.pth"))
    assert list(wp) == list(wj) and all(torch.equal(wp[k], wj[k]) for k in wj)


def test_tts_matches_jax_server(servers, files, monkeypatch):
    """The same /api/tts request, with a voice to convert into, to both
    servers against one loopback read-aloud server: the synthesized audio
    equal, the fp32 conversion within 1e-3 plus one int16 step, and the
    port's conversion on its device thread."""
    from read_aloud_fake import FakeReadAloudServer, pcm_wav_bytes
    from rvc_maker_tpu_torch.utils.audio import resample

    tts = FakeReadAloudServer(pcm_wav_bytes(resample(_voice(1.0, 200.0, 4), 16000, 24000)))
    try:
        _set_precision(servers, "fp32")
        pipe = srv._get_pipeline(files["model"], files["index"], files["rmvpe"],
                                 files["embedder"])
        _with_jax_noise(pipe, monkeypatch)
        threads = []
        noisy = pipe.convert_utterance

        def spy(*a, **kw):
            threads.append(threading.current_thread().name)
            return noisy(*a, **kw)

        monkeypatch.setattr(pipe, "convert_utterance", spy)
        req = dict(files, text="hello", voice="en-US-AriaNeural", endpoint=tts.url,
                   f0_method="rmvpe", index_rate=0.5, protect=0.33, pitch=1)
        got, ref = _both_ok(servers, "/api/tts", req)
    finally:
        tts.close()
    assert got["audio_b64"] == ref["audio_b64"] and got["sr"] == ref["sr"] == 24000
    assert got["converted_sr"] == ref["converted_sr"] == JCFG.sr
    (_, wav_p), (_, wav_j) = (_decode(o["converted_b64"]) for o in (got, ref))
    err = float(np.abs(wav_p - wav_j).max())
    print(f"\nfp32 /api/tts, port vs JAX server: max abs {err:.3e} (tol {FP32_ATOL:.3e})")
    assert wav_p.shape == wav_j.shape and np.abs(wav_j).max() > 0.1
    assert err <= FP32_ATOL, err
    assert threads == ["rvc-device_0"]


@pytest.fixture(scope="module")
def onnx_files(servers, files, tmp_path_factory):
    """The voice exported by the port's /api/export_onnx, and the HuBERT
    of `files` exported by the port's `export_embedder`."""
    from rvc_maker_tpu_torch.interop.onnx_embedder import export_embedder
    from rvc_maker_tpu_torch.models.hubert import load_hubert_pt

    d = tmp_path_factory.mktemp("onnx")
    out = {"model": str(d / "voice.onnx"), "embedder": str(d / "hubert.onnx")}
    assert _ok(servers[0], "/api/export_onnx", {"model": files["model"],
                                                "output": out["model"]}) == {
        "output": out["model"]}
    export_embedder(load_hubert_pt(files["embedder"]), out["embedder"])
    return out


def test_export_onnx_route_matches_jax_server(servers, files, onnx_files, tmp_path):
    """/api/export_onnx on both servers from one .pth: the port's file
    loads in the JAX package's OnnxVoiceModel with the config and
    metadata of the JAX server's file (its creation date aside); a
    missing model answers 400."""
    from rvc_maker_tpu.interop import onnx_proto as jproto
    from rvc_maker_tpu.interop.onnx_voice import OnnxVoiceModel as JaxVoiceModel

    ref_path = str(tmp_path / "jax.onnx")
    assert _ok(servers[1], "/api/export_onnx", {"model": files["model"],
                                                "output": ref_path}) == {"output": ref_path}
    got, ref = JaxVoiceModel(onnx_files["model"]), JaxVoiceModel(ref_path)
    assert got.cfg == ref.cfg and got.dynamic and got.min_frames == ref.min_frames == 21
    md = [{e.key: e.value for e in jproto.load_model(p).metadata_props}
          for p in (onnx_files["model"], ref_path)]
    infos = [json.loads(m.pop("model_info")) for m in md]
    for i in infos:
        i.pop("creation_date")
    assert md[0] == md[1] and infos[0] == infos[1]
    assert _call(servers[0], "/api/export_onnx", {"model": "/no/such.pth",
                                                  "output": str(tmp_path / "x.onnx")})[0] == 400


@pytest.mark.parametrize("field", ["model", "embedder"])
def test_onnx_files_convert_like_jax_server(servers, files, onnx_files, field, monkeypatch):
    """/api/convert with the `.onnx` voice model or embedder on the port's
    server against the JAX server with the `.pth` / `.pt` they came from,
    fp32: within 1e-3 plus one int16 step, and on the device thread."""
    _set_precision(servers, "fp32")
    port_files = dict(files, **{field: onnx_files[field]})
    pipe = srv._get_pipeline(port_files["model"], port_files["index"], port_files["rmvpe"],
                             port_files["embedder"])
    kind = {"model": "synth_params", "embedder": "hubert_params"}[field]
    assert type(getattr(pipe, kind)).__name__ == {"model": "OnnxVoiceModel",
                                                  "embedder": "OnnxEmbedder"}[field]
    _with_jax_noise(pipe, monkeypatch)
    audio = _voice(1.0, 190.0, 1)
    got = _ok(servers[0], "/api/convert", _convert_req(port_files, audio))
    ref = _ok(servers[1], "/api/convert", _convert_req(files, audio))
    (sr_p, wav_p), (sr_j, wav_j) = (_decode(o["audio_b64"]) for o in (got, ref))
    err = float(np.abs(wav_p - wav_j).max())
    print(f"\n.onnx {field} /api/convert vs the JAX server's .pth: max abs {err:.3e}")
    assert sr_p == sr_j == JCFG.sr and wav_p.shape == wav_j.shape
    assert np.abs(wav_j).max() > 0.1 and err <= FP32_ATOL, err


def test_warm_runs_the_serving_shapes(servers, files):
    _set_precision(servers[:1], "bf16")
    assert srv.warm(files["model"], "", "", files["embedder"], buckets="1,2x1") > 0
    pipe = srv._get_pipeline(files["model"], "", "", files["embedder"])
    assert pipe.compute_dtype is torch.bfloat16


def test_serve_on_a_missing_card_raises(monkeypatch):
    """serve(device="cuda") without a card raises before it binds."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    saved = srv._STATE["device"]
    try:
        with pytest.raises(RuntimeError, match="is_available"):
            srv.serve("127.0.0.1", 0, device="cuda")
    finally:
        srv._STATE["device"] = saved


def test_entry_points_turn_tf32_off_for_the_card(monkeypatch, tmp_path):
    """The process's TF32 policy is set where it picks its device: the
    server's set_device and the CLI turn cuDNN's and cuBLAS's TF32 off for
    the card (device.use_full_fp32) and leave the flags alone for the CPU."""
    from rvc_maker_tpu_torch import cli

    def flags_on():
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)

    def flags():
        return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32

    saved = srv._STATE["device"]
    try:
        flags_on()
        srv.set_device("cpu")
        assert flags() == (True, True)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        srv.set_device("cuda")
        assert flags() == (False, False)
    finally:
        srv._STATE["device"] = saved
    missing = str(tmp_path / "missing.pt")
    for device, want in (("cpu", (True, True)), ("cuda", (False, False))):
        flags_on()
        with pytest.raises(FileNotFoundError):
            cli.main(["extract", "--exp-dir", str(tmp_path), "--rmvpe-path", missing,
                      "--embedder-path", missing, "--device", device])
        assert flags() == want, device


def test_server_main_without_a_card_exits_nonzero(tmp_path):
    """`python -m rvc_maker_tpu_torch.app.server` defaults to --device cuda,
    which raises on a machine without a card instead of serving on the
    CPU."""
    import subprocess
    import sys

    proc = subprocess.run([sys.executable, "-m", "rvc_maker_tpu_torch.app.server",
                           "--host", "127.0.0.1", "--port", "0"], capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, HOME=str(tmp_path),
                                                           CUDA_VISIBLE_DEVICES=""),
                          cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode != 0 and "is_available() is False" in proc.stderr, proc.stderr
