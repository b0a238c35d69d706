"""The port's diarization (`rvc_maker_tpu_torch/speaker/diarize.py`),
`cli diarize-convert` and `/api/convert_whisper` against the JAX
package's, on the same small voice models, ECAPA weights, segments and
noise (the JAX pipeline's PRNGKey(0) draws fed to the port).

Cluster labels equal scikit-learn's `AgglomerativeClustering` and JAX's
label for label; the energy VAD's segments are equal, the fbank within
1e-5 x max(1, |ref|max); the diarized waveform within 1e-3 of JAX's (the
CLI's and the server's WAVs within 1e-3 plus one int16 step).
"""

import base64
import dataclasses
import http.client
import io
import json
import threading
from http.server import ThreadingHTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile
from sklearn.cluster import AgglomerativeClustering

from rvc_maker_tpu import cli as jcli
from rvc_maker_tpu.app import server as jax_srv
from rvc_maker_tpu.config import ModelConfig as JaxModelConfig
from rvc_maker_tpu.config import RVCConfig as JaxRVCConfig
from rvc_maker_tpu.interop.torch_export import export_synthesizer_pth
from rvc_maker_tpu.models import ecapa_tdnn as jec
from rvc_maker_tpu.models import whisper as jw
from rvc_maker_tpu.pipelines.convert import ConvertPipeline as JaxPipeline
from rvc_maker_tpu.pipelines.convert import ConvertSettings as JaxSettings
from rvc_maker_tpu.speaker import diarize as jdi
from rvc_maker_tpu.speaker.whisper_tokenizer import WhisperTokenizer as JaxTokenizer
from rvc_maker_tpu_torch import cli
from rvc_maker_tpu_torch.app import server as srv
from rvc_maker_tpu_torch.config import ModelConfig
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.models import ecapa_tdnn as pec
from rvc_maker_tpu_torch.models import whisper as pw
from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings
from rvc_maker_tpu_torch.speaker import diarize as pdi
from rvc_maker_tpu_torch.speaker.whisper_tokenizer import WhisperTokenizer
from rvc_maker_tpu_torch.utils.audio import read_wav, save_wav
from torch_port_util import (hubert_state_dict, n, patch_jax_noise, rel_close,  # noqa: F401
                             torch_threads, voice)

SR = 16000
WAVE_ATOL = 1e-3
INT16_STEP = 1.0 / 32768
JCFG = JaxModelConfig(
    spec_channels=129, segment_size=8, inter_channels=32, hidden_channels=32,
    filter_channels=64, n_heads=2, n_layers=1, kernel_size=3,
    resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),), upsample_rates=(4, 4, 2, 2),
    upsample_initial_channel=32, upsample_kernel_sizes=(8, 8, 4, 4), spk_embed_dim=4,
    gin_channels=16, sr=6400, use_f0=True, text_enc_hidden_dim=768)
CFG = ModelConfig(**dataclasses.asdict(JCFG))
WINDOW = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
              n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=4, n_text_layer=2)


def two_speakers(pattern=(130.0, 260.0, 130.0, 260.0), seconds=1.5, gap=0.6, seed=0):
    """Voiced stretches of alternating f0 ranges with silent gaps."""
    parts = []
    for i, f0 in enumerate(pattern):
        parts += [voice(seconds, f0, seed + i), np.zeros(int(gap * SR), np.float32)]
    return np.concatenate(parts)


def _synth_tree(seed):
    tree = from_jax.random_synthesizer_tree(CFG, seed=seed)
    for u in tree["dec"]["ups"]:
        u["w"] *= 20.0
    tree["dec"]["conv_post"]["w"] *= 20.0
    return tree


@pytest.fixture(scope="module")
def ecapa_sd():
    return from_jax.ecapa_state_dict(from_jax.random_ecapa_tree(seed=3),
                                     np.random.RandomState(4))


@pytest.fixture(scope="module")
def models(ecapa_sd):
    """Two voices and a 2-layer HuBERT in both packages, and ECAPA."""
    trees = [_synth_tree(s) for s in (1, 2)]
    hub = from_jax.random_hubert_tree(seed=5, n_layers=2)
    jhub = jax.tree_util.tree_map(jnp.asarray, hub)
    jax_pipes = [JaxPipeline(jax.tree_util.tree_map(jnp.asarray, t), JCFG, jhub, version="v2",
                             compute_dtype=None) for t in trees]
    pipes = [ConvertPipeline(from_jax.synthesizer_from_jax(t, CFG), CFG,
                             from_jax.hubert_from_jax(hub), version="v2", device="cpu")
             for t in trees]
    return dict(trees=trees, hub=hub, jax_pipes=jax_pipes, pipes=pipes,
                jecapa=jec.params_from_state_dict(ecapa_sd),
                ecapa=pec.params_from_state_dict(ecapa_sd))


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("k", [2, 3])
def test_cluster_labels_equal_sklearn(seed, k):
    """scipy's ward tree cut as scikit-learn cuts it, label for label, on
    unit-norm 192-d embeddings: half of them grouped, half scattered."""
    rs = np.random.RandomState(seed)
    m = rs.randint(k + 1, 25)
    x = rs.randn(m, 192).astype(np.float32)
    if seed % 2:
        x += 3.0 * rs.randn(k, 192).astype(np.float32)[rs.randint(0, k, m)]
    x /= np.linalg.norm(x, axis=1, keepdims=True) + 1e-9
    ref = AgglomerativeClustering(n_clusters=k).fit_predict(x)
    np.testing.assert_array_equal(pdi.cluster_labels(x, k), ref)


@pytest.mark.parametrize("k,n_segments", [(2, 6), (3, 6), (2, 2), (3, 2)])
def test_cluster_speakers_matches_jax_and_sklearn(models, k, n_segments):
    """On ECAPA embeddings of the same segments: the JAX package's labels
    (scikit-learn's), also where the segments are no more than k (each
    its own label)."""
    audio = two_speakers((130.0, 260.0, 170.0) * 2, seconds=1.0, gap=0.0)[: n_segments * SR]
    segs = [(i * SR, (i + 1) * SR) for i in range(n_segments)]
    ref = jdi.cluster_speakers(audio, segs, models["jecapa"], num_speakers=k)
    got = pdi.cluster_speakers(audio, segs, models["ecapa"], num_speakers=k)
    np.testing.assert_array_equal(got, ref)
    if n_segments > k:
        embs = pdi.segment_embeddings(audio, segs, models["ecapa"])
        np.testing.assert_array_equal(
            got, AgglomerativeClustering(n_clusters=k).fit_predict(embs))
        assert len(set(got.tolist())) == k


def test_vad_and_fbank_match_jax():
    audio = two_speakers()
    audio[5000:5200] = 0.0
    assert pdi.energy_vad_segments(audio) == jdi.energy_vad_segments(audio)
    assert pdi.energy_vad_segments(audio, min_seg_s=0.5, max_seg_s=1.0) == \
        jdi.energy_vad_segments(audio, min_seg_s=0.5, max_seg_s=1.0)
    for piece in (audio[:SR], audio[2 * SR: 3 * SR + 123]):
        ref = jdi.fbank(piece)
        got = n(pdi.fbank(piece))
        assert got.shape == ref.shape
        rel_close(got, ref, 1e-5, "fbank")


def test_convert_with_diarization_matches_jax(models, monkeypatch):
    patch_jax_noise(monkeypatch)
    labels = []

    def cluster(*a, **kw):
        labels.extend(orig_cluster(*a, **kw).tolist())
        return np.asarray(labels)

    orig_cluster = pdi.cluster_speakers
    monkeypatch.setattr(pdi, "cluster_speakers", cluster)
    audio = two_speakers()
    s_j = [JaxSettings(f0_method="yin", index_rate=0.0)] * 2
    s_p = [ConvertSettings(f0_method="yin", index_rate=0.0)] * 2
    ref = jdi.convert_with_diarization(audio, models["jax_pipes"], s_j, models["jecapa"])
    got = pdi.convert_with_diarization(audio, models["pipes"], s_p, models["ecapa"])
    assert got.shape == ref.shape and labels == [0, 1, 0, 1]
    assert np.abs(ref).max() > 0.1
    err = float(np.abs(got - ref).max())
    print(f"\ndiarized conversion, port vs JAX: max abs {err:.3e}; labels {labels}")
    assert err <= WAVE_ATOL, err
    # the gaps stay silent
    gap = got[int(1.6 * JCFG.sr): int(2.0 * JCFG.sr)]
    assert np.abs(gap).max() == 0.0


@pytest.fixture(scope="module")
def whisper_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("whisper")
    vocab = from_jax.write_tiktoken_vocab(str(d / "v.tiktoken"))
    dims = pw.WhisperDims(**WINDOW)
    path = from_jax.write_whisper_pt(str(d / "whisper.pt"),
                                     from_jax.random_whisper_tree(dims, 0, transcript=True), dims)
    return dict(whisper=path, vocab=vocab)


def test_whisper_segments_match_jax(whisper_files):
    """Whisper's segment boundaries (the transcript-shaped model writes a
    segment about every 2 s up to about 20 s)."""
    audio = two_speakers((130.0, 260.0) * 5, seconds=1.4, gap=0.55)
    jp, jdims = jw.load_whisper_pt(whisper_files["whisper"])
    ref = jdi.whisper_segments(audio, jp, jdims, JaxTokenizer(whisper_files["vocab"]))
    got = pdi.whisper_segments(audio, pw.load_whisper_pt(whisper_files["whisper"], "cpu"),
                               WhisperTokenizer(whisper_files["vocab"]))
    assert got == ref and len(got) >= 8


@pytest.fixture(scope="module")
def files(tmp_path_factory, models, ecapa_sd):
    """The voices as .pth files as the JAX exporter writes them, a
    fairseq HuBERT .pt, an ECAPA checkpoint and the input WAV."""
    d = tmp_path_factory.mktemp("diarize")
    out = dict(model=str(d / "a.pth"), model_b=str(d / "b.pth"), embedder=str(d / "hubert.pt"),
               ecapa=str(d / "ecapa.ckpt"), input=str(d / "in.wav"))
    for key, tree in zip(("model", "model_b"), models["trees"]):
        export_synthesizer_pth(jax.tree_util.tree_map(jnp.asarray, tree),
                               JaxRVCConfig(version="v2", model=JCFG), out[key])
    torch.save({"model": hubert_state_dict(models["hub"])}, out["embedder"])
    torch.save(ecapa_sd, out["ecapa"])
    save_wav(out["input"], two_speakers(), SR)
    return out


@pytest.fixture
def jax_hubert_2_layers(monkeypatch):
    """The JAX fairseq loader reads a fixed 12 layers; the test HuBERT has 2."""
    from rvc_maker_tpu.models import hubert as jax_hubert

    monkeypatch.setattr(jax_hubert, "N_LAYERS", 2)


def test_cli_diarize_convert_matches_jax_cli(files, tmp_path, monkeypatch, jax_hubert_2_layers):
    patch_jax_noise(monkeypatch)
    argv = ["diarize-convert", "--input", files["input"], "--model", files["model"],
            "--model-b", files["model_b"], "--ecapa", files["ecapa"],
            "--embedder-path", files["embedder"], "--f0-method", "yin"]
    cli.main(argv + ["--output", str(tmp_path / "port.wav"), "--device", "cpu"])
    jcli.main(argv + ["--output", str(tmp_path / "jax.wav")])
    got, sr = read_wav(str(tmp_path / "port.wav"))
    ref, jsr = read_wav(str(tmp_path / "jax.wav"))
    assert sr == jsr == JCFG.sr and got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert np.abs(ref).max() > 0.1 and err <= WAVE_ATOL + INT16_STEP, err


def test_cli_diarize_convert_with_whisper_and_a_speechbrain_dir(files, whisper_files, tmp_path,
                                                                ecapa_sd):
    """--whisper cuts the segments (the port's CLI on the CPU; a
    speechbrain directory as --ecapa), against the port's function on
    Whisper's segments."""
    d = tmp_path / "spkrec"
    d.mkdir()
    (d / "hyperparams.yaml").write_text(
        "n_mels: 80\nembedding_model: !new:speechbrain.lobes.models.ECAPA_TDNN.ECAPA_TDNN\n"
        "    input_size: !ref <n_mels>\n    lin_neurons: 192\n")
    torch.save(ecapa_sd, str(d / "embedding_model.ckpt"))
    audio = two_speakers((130.0, 260.0) * 5, seconds=1.4, gap=0.55)
    save_wav(str(tmp_path / "in.wav"), audio, SR)
    rc = cli.main(["diarize-convert", "--input", str(tmp_path / "in.wav"),
                   "--output", str(tmp_path / "out.wav"), "--model", files["model"],
                   "--model-b", files["model_b"], "--ecapa", str(d),
                   "--whisper", whisper_files["whisper"], "--vocab", whisper_files["vocab"],
                   "--embedder-path", files["embedder"], "--f0-method", "yin", "--device", "cpu"])
    out, sr = read_wav(str(tmp_path / "out.wav"))
    assert rc == 0 and sr == JCFG.sr and abs(len(out) / sr - len(audio) / SR) < 0.01
    assert np.isfinite(out).all() and np.abs(out).max() > 0.05


def _call(port, path, obj):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=json.dumps(obj),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The port's server on the CPU and the JAX package's."""
    d = tmp_path_factory.mktemp("settings")
    saved = (srv.SETTINGS_PATH, srv._STATE["device"], jax_srv._SETTINGS_PATH)
    srv.SETTINGS_PATH, jax_srv._SETTINGS_PATH = str(d / "port.json"), str(d / "jax.json")
    srv.set_device("cpu")
    httpds = [ThreadingHTTPServer(("127.0.0.1", 0), h) for h in (srv.Handler, jax_srv.Handler)]
    for h in httpds:
        threading.Thread(target=h.serve_forever, daemon=True).start()
    yield [h.server_address[1] for h in httpds]
    for h in httpds:
        h.shutdown()
        h.server_close()
    srv.SETTINGS_PATH, srv._STATE["device"], jax_srv._SETTINGS_PATH = saved


def _wav_b64(audio, sr=SR):
    buf = io.BytesIO()
    wavfile.write(buf, sr, (np.clip(audio, -1, 1) * 32767).astype(np.int16))
    return base64.b64encode(buf.getvalue()).decode()


def _request(files, audio):
    return dict(audio_b64=_wav_b64(audio), model_a=files["model"], model_b=files["model_b"],
                ecapa=files["ecapa"], embedder=files["embedder"], f0_method="yin",
                index_rate=0.0)


def test_convert_whisper_route_matches_jax_server(servers, files, monkeypatch,
                                                  jax_hubert_2_layers):
    patch_jax_noise(monkeypatch)
    req = _request(files, two_speakers())
    (code_p, body_p), (code_j, body_j) = (_call(p, "/api/convert_whisper", req) for p in servers)
    assert code_p == code_j == 200, (body_p, body_j)
    assert body_p["sr"] == body_j["sr"] == JCFG.sr
    got, ref = (wavfile.read(io.BytesIO(base64.b64decode(b["audio_b64"])))[1] / 32768.0
                for b in (body_p, body_j))
    assert got.shape == ref.shape and np.abs(ref).max() > 0.1
    assert float(np.abs(got - ref).max()) <= WAVE_ATOL + INT16_STEP


@pytest.mark.parametrize("change", ["missing_ecapa", "junk_ecapa", "no_model", "bad_whisper"])
def test_convert_whisper_route_bad_requests(servers, files, tmp_path, change):
    """A caller's missing or unreadable file answers 400."""
    req = _request(files, two_speakers((130.0,), seconds=1.2))
    if change == "missing_ecapa":
        req["ecapa"] = str(tmp_path / "none.ckpt")
    elif change == "junk_ecapa":
        (tmp_path / "junk.ckpt").write_bytes(b"junk")
        req["ecapa"] = str(tmp_path / "junk.ckpt")
    elif change == "no_model":
        del req["model_a"], req["model_b"]
    else:
        (tmp_path / "w.pt").write_bytes(b"junk")
        (tmp_path / "v.tiktoken").write_bytes(b"")
        req.update(whisper=str(tmp_path / "w.pt"), vocab=str(tmp_path / "v.tiktoken"))
    code, body = _call(servers[0], "/api/convert_whisper", req)
    assert code == 400, body
