"""The port's Whisper (`rvc_maker_tpu_torch/models/whisper.py`,
`speaker/transcribe.py`) against the JAX package's on the same weights,
carried across as a reference-layout state dict, at small sizes.

Tolerances: log_mel 1e-5 against JAX and the committed slaney filterbank
at JAX tests/test_mel_golden.py's 2e-7; the encoder, decoder logits and
cross-attention scores rtol 1e-4 / atol 1e-4; the cached step against
the full pass 1e-4 x max |ref|.  Decoding (greedy, sampled at t = 0.4
with the same default_rng seed, beam 2 and 5 at patience 1 and 2, the
temperature fallback with best_of): tokens equal, avg_logprob and
no_speech_prob within 1e-4.  Transcription and `cli transcribe` (word
timestamps, beam search) on a model whose draws are shaped to write
timestamped text (`from_jax.random_whisper_tree(transcript=True)`):
segments equal, times within 1e-6 s.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rvc_maker_tpu import cli as jcli
from rvc_maker_tpu.models import whisper as jw
from rvc_maker_tpu.speaker import transcribe as jtr
from rvc_maker_tpu.speaker.whisper_tokenizer import WhisperTokenizer as JaxTokenizer
from rvc_maker_tpu_torch import cli
from rvc_maker_tpu_torch.interop import from_jax
from rvc_maker_tpu_torch.models import whisper as pw
from rvc_maker_tpu_torch.speaker import transcribe as ptr
from rvc_maker_tpu_torch.speaker.whisper_tokenizer import WhisperTokenizer
from rvc_maker_tpu_torch.utils.audio import save_wav
from torch_port_util import n, torch_threads  # noqa: F401

# the JAX tests' Whisper (tests/test_whisper_parity.py DIMS)
SMALL = dict(n_mels=80, n_audio_ctx=100, n_audio_state=64, n_audio_head=4, n_audio_layer=2,
             n_vocab=51865, n_text_ctx=48, n_text_state=64, n_text_head=4, n_text_layer=2)
# the same widths over a whole 30 s window, for transcription
WINDOW = dict(SMALL, n_audio_ctx=1500, n_text_ctx=448)
FLAT = dict(SMALL, n_text_ctx=448)
PROMPT = [50258, 50259, 50359]          # sot, en, transcribe
EOT, TS0, NO_SPEECH = 50257, 50364, 50362
TOL = 1e-4


def _dims(d):
    return jw.WhisperDims(**d), pw.WhisperDims(**d)


def _models(d, seed=0, emb_scale=1.0, transcript=False):
    """(JAX params, the port's model) of one seeded tree."""
    jd, pd = _dims(d)
    tree = from_jax.random_whisper_tree(pd, seed, transcript=transcript)
    tree["decoder"]["tok_emb"] *= emb_scale
    sd = from_jax.whisper_state_dict(tree)
    return jw.params_from_state_dict(sd, jd), pw.params_from_state_dict(sd, pd)


@pytest.fixture(scope="module")
def small():
    return _models(SMALL)


@pytest.fixture(scope="module")
def flat():
    """Flatter logits (token embedding x 0.05), so that sampling at
    t = 0.4 and beam search part from greedy decoding; Whisper's text
    context, since the fallback decodes its 224 tokens."""
    return _models(FLAT, seed=1, emb_scale=0.05)


@pytest.fixture(scope="module")
def feats(small):
    jp, _ = small
    mel = np.random.RandomState(1).randn(1, 80, 2 * SMALL["n_audio_ctx"]).astype(np.float32)
    return np.array(jw.encode_audio(jp["encoder"], _dims(SMALL)[0], jnp.asarray(mel)))


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    return from_jax.write_tiktoken_vocab(str(tmp_path_factory.mktemp("vocab") / "v.tiktoken"))


def close(got, ref, what):
    np.testing.assert_allclose(n(got), n(ref), rtol=TOL, atol=TOL, err_msg=what)


def test_dims_default_is_whisper_base():
    assert dataclasses.asdict(pw.WhisperDims()) == dataclasses.asdict(jw.WhisperDims())


@pytest.mark.parametrize("seconds", [1.0, 3.0])
def test_log_mel_matches_jax(seconds):
    audio = (np.random.RandomState(0).randn(2, int(16000 * seconds)) * 0.2).astype(np.float32)
    ref = np.asarray(jw.log_mel(jnp.asarray(audio)))
    got = n(pw.log_mel(torch.from_numpy(audio)))
    assert got.shape == ref.shape == (2, 80, int(100 * seconds))
    assert np.abs(got - ref).max() <= 1e-5


def test_log_mel_filterbank_matches_golden():
    """The slaney filterbank log_mel is built on, against the committed
    fixture, at JAX tests/test_mel_golden.py's tolerance."""
    from rvc_maker_tpu_torch.ops.stft import mel_filterbank

    golden = np.load(os.path.join(os.path.dirname(__file__), "data", "mel_golden_whisper.npy"))
    np.testing.assert_allclose(mel_filterbank(16000, 400, 80, 0.0, 8000.0, htk=False), golden,
                               atol=2e-7)


def test_encoder_matches_jax(small):
    jp, m = small
    mel = np.random.RandomState(2).randn(2, 80, 2 * SMALL["n_audio_ctx"]).astype(np.float32)
    ref = jw.encode_audio(jp["encoder"], _dims(SMALL)[0], jnp.asarray(mel))
    close(m.encoder(torch.from_numpy(mel)).detach(), ref, "encoder")


def test_decoder_logits_and_cross_qk_match_jax(small, feats):
    jp, m = small
    jd = _dims(SMALL)[0]
    tokens = np.random.RandomState(3).randint(0, 50000, (1, 9))
    ref = jw.decode_logits(jp["decoder"], jd, jnp.asarray(tokens), jnp.asarray(feats))
    with torch.no_grad():
        got = m.decoder(torch.from_numpy(tokens), torch.from_numpy(feats))
        got_l, got_qk = m.decoder.with_cross_qk(torch.from_numpy(tokens),
                                                torch.from_numpy(feats))
    ref_l, ref_qk = jw.decode_logits_with_cross_qk(jp["decoder"], jd, jnp.asarray(tokens),
                                                   jnp.asarray(feats))
    close(got, ref, "logits")
    close(got_l, ref_l, "logits with qk")
    assert got_qk.shape == (2, 1, 4, 9, SMALL["n_audio_ctx"])
    close(got_qk, ref_qk, "cross qk")


def test_cached_step_matches_full_pass(small, feats):
    """Each cached step's logits against the full pass's at its position,
    batch 2, and the cache written in place at its index."""
    _, m = small
    rs = np.random.RandomState(4)
    tokens = torch.from_numpy(rs.randint(0, 50000, (2, 12)))
    xa = torch.from_numpy(np.concatenate([feats, feats[:, ::-1]]))
    with torch.no_grad():
        full = m.decoder(tokens, xa)
    cache = pw.init_cache(m.decoder, xa)
    assert cache.self_k.shape == (2, 2, SMALL["n_text_ctx"], 64)
    for i in range(tokens.shape[1]):
        step = pw.decode_step(m.decoder, tokens[:, i], cache)
        assert cache.index == i + 1
        assert np.abs(n(step) - n(full[:, i])).max() <= TOL * np.abs(n(full[:, i])).max()
    assert float(cache.self_k[:, :, tokens.shape[1]:].abs().max()) == 0.0


def _jax_kw(**kw):
    return dict(eot=EOT, timestamp_begin=TS0, **kw)


def test_greedy_decode_matches_jax(small, feats):
    """(JAX's greedy_decode writes into a read-only view of its logits
    when given `suppress`, so both run without it.)"""
    jp, m = small
    ref = jw.greedy_decode(jp["decoder"], _dims(SMALL)[0], jnp.asarray(feats), PROMPT,
                           max_tokens=12, **_jax_kw())
    got = pw.greedy_decode(m.decoder, torch.from_numpy(feats), PROMPT, max_tokens=12,
                           **_jax_kw())
    assert got == ref and len(got) == 12


@pytest.mark.parametrize("temperature", [0.0, 0.4])
def test_decode_window_matches_jax(flat, temperature):
    jp, m = flat
    jd = _dims(FLAT)[0]
    mel = np.random.RandomState(5).randn(1, 80, 2 * SMALL["n_audio_ctx"]).astype(np.float32)
    f = np.array(jw.encode_audio(jp["encoder"], jd, jnp.asarray(mel)))
    kw = _jax_kw(max_tokens=16, temperature=temperature, no_speech_token=NO_SPEECH)
    ref = jw.decode_window(jp["decoder"], jd, jnp.asarray(f), PROMPT,
                           rng=np.random.default_rng(7), **kw)
    got = pw.decode_window(m.decoder, torch.from_numpy(f), PROMPT,
                           rng=np.random.default_rng(7), **kw)
    greedy = pw.decode_window(m.decoder, torch.from_numpy(f), PROMPT,
                              **dict(kw, temperature=0.0))
    assert got["tokens"] == ref["tokens"]
    assert abs(got["avg_logprob"] - ref["avg_logprob"]) <= TOL
    assert abs(got["no_speech_prob"] - ref["no_speech_prob"]) <= TOL
    if temperature > 0:
        assert got["tokens"] != greedy["tokens"], "the draw never left the greedy path"


@pytest.mark.parametrize("beam_size,patience", [(2, 1.0), (2, 2.0), (5, 1.0), (5, 2.0)])
def test_beam_decode_matches_jax(flat, beam_size, patience):
    jp, m = flat
    jd = _dims(FLAT)[0]
    mel = np.random.RandomState(6).randn(1, 80, 2 * SMALL["n_audio_ctx"]).astype(np.float32)
    f = np.array(jw.encode_audio(jp["encoder"], jd, jnp.asarray(mel)))
    kw = _jax_kw(beam_size=beam_size, patience=patience, max_tokens=10,
                 no_speech_token=NO_SPEECH)
    ref = jw.beam_decode(jp["decoder"], jd, jnp.asarray(f), PROMPT, **kw)
    got = pw.beam_decode(m.decoder, torch.from_numpy(f), PROMPT, **kw)
    assert got["tokens"] == ref["tokens"]
    assert abs(got["avg_logprob"] - ref["avg_logprob"]) <= TOL
    assert abs(got["no_speech_prob"] - ref["no_speech_prob"]) <= TOL


@pytest.mark.parametrize("beam_size,best_of", [(None, 3), (2, 2)])
def test_decode_with_fallback_matches_jax(flat, vocab, beam_size, best_of):
    """Every temperature's gate fails on the flat model (avg logprob far
    below -1), so each runs: beam or greedy at 0, best_of samples above."""
    jp, m = flat
    jd = _dims(FLAT)[0]
    mel = np.random.RandomState(8).randn(1, 80, 2 * SMALL["n_audio_ctx"]).astype(np.float32)
    f = np.array(jw.encode_audio(jp["encoder"], jd, jnp.asarray(mel)))
    jtok, ptok = JaxTokenizer(vocab), WhisperTokenizer(vocab)
    suppress = np.asarray(list(ptok.non_speech_tokens()) + [ptok.sot], np.int64)
    temps = (0.0, 0.5, 1.0)
    ref = jtr.decode_with_fallback({"decoder": jp["decoder"]}, jd, jtok, jnp.asarray(f),
                                   suppress=suppress, temperatures=temps,
                                   rng=np.random.default_rng(3), beam_size=beam_size,
                                   best_of=best_of)
    got = ptr.decode_with_fallback(m, ptok, torch.from_numpy(f), suppress=suppress,
                                   temperatures=temps, rng=np.random.default_rng(3),
                                   beam_size=beam_size, best_of=best_of)
    assert got["temperature"] == ref["temperature"] == 1.0
    assert got["tokens"] == ref["tokens"] and got["text"] == ref["text"]
    assert abs(got["avg_logprob"] - ref["avg_logprob"]) <= TOL
    assert got["compression_ratio"] == ref["compression_ratio"]


def test_checkpoint_loads_in_both(tmp_path):
    """A reference-layout .pt (dims + fp16 state dict) in both loaders."""
    jd, pd = _dims(SMALL)
    tree = from_jax.random_whisper_tree(pd, 3)
    path = str(tmp_path / "w.pt")
    from_jax.write_whisper_pt(path, tree, pd)
    ckpt = torch.load(path, weights_only=True)
    ckpt["model_state_dict"] = {k: v.half() for k, v in ckpt["model_state_dict"].items()}
    torch.save(ckpt, path)
    jp, jdims = jw.load_whisper_pt(path)
    m = pw.load_whisper_pt(path, device="cpu")
    assert dataclasses.asdict(m.dims) == dataclasses.asdict(jdims)
    sd = m.state_dict()
    np.testing.assert_array_equal(n(sd["decoder.token_embedding.weight"]), jp["decoder"]["tok_emb"])
    np.testing.assert_array_equal(n(sd["encoder.blocks.1.mlp.0.weight"]).T,
                                  jp["encoder"]["blocks"][1]["fc1"]["w"])
    np.testing.assert_array_equal(n(m.encoder.positional_embedding), jp["encoder"]["pos"])


def test_checkpoint_errors_are_bad_requests(tmp_path):
    from rvc_maker_tpu_torch.errors import BadRequest

    bad = tmp_path / "bad.pt"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(BadRequest):
        pw.load_whisper_pt(str(bad), device="cpu")
    pd = _dims(SMALL)[1]
    sd = from_jax.whisper_state_dict(from_jax.random_whisper_tree(pd, 0))
    del sd["decoder.ln.weight"]
    with pytest.raises(BadRequest):
        pw.params_from_state_dict(sd, pd)


def test_alignment_heads():
    import base64
    import gzip

    jd, pd = _dims(SMALL)
    np.testing.assert_array_equal(pw.default_alignment_heads(pd), jw.default_alignment_heads(jd))
    mask = np.random.RandomState(0).rand(2, 4) > 0.5
    dump = base64.b85encode(gzip.compress(mask.tobytes()))
    np.testing.assert_array_equal(pw.alignment_heads_from_dump(dump, pd), mask)
    np.testing.assert_array_equal(jw.alignment_heads_from_dump(dump, jd), mask)


@pytest.fixture(scope="module")
def transcriber():
    """The window-wide small model with draws shaped to write timestamped
    text, in both packages."""
    return _models(WINDOW, seed=2, transcript=True)


def _speech(seconds=3.0):
    return (np.random.RandomState(9).randn(int(16000 * seconds)) * 0.2).astype(np.float32)


def _same_segments(got, ref):
    assert len(got) == len(ref) > 2
    for g, r in zip(got, ref):
        assert g["text"] == r["text"] and g.get("tokens") == r.get("tokens")
        assert abs(g["start"] - r["start"]) <= 1e-6 and abs(g["end"] - r["end"]) <= 1e-6
        assert len(g.get("words", [])) == len(r.get("words", []))
        for gw, rw in zip(g.get("words", []), r.get("words", [])):
            assert gw["word"] == rw["word"]
            assert abs(gw["start"] - rw["start"]) <= 1e-6 and abs(gw["end"] - rw["end"]) <= 1e-6
            assert abs(gw["probability"] - rw["probability"]) <= TOL


@pytest.mark.parametrize("kw", [dict(word_timestamps=True), dict(beam_size=2)],
                         ids=["words", "beam"])
def test_transcribe_matches_jax(transcriber, vocab, kw):
    jp, m = transcriber
    audio = _speech()
    ref = jtr.transcribe(jp, _dims(WINDOW)[0], JaxTokenizer(vocab), audio, **kw)
    got = ptr.transcribe(m, WhisperTokenizer(vocab), audio, **kw)
    _same_segments(got, ref)
    if kw.get("word_timestamps"):
        assert any(s["words"] for s in got)


def test_cli_transcribe_matches_jax_cli(transcriber, vocab, tmp_path):
    _, m = transcriber
    model = str(tmp_path / "whisper.pt")
    torch.save({"dims": dataclasses.asdict(m.dims), "model_state_dict": m.state_dict()}, model)
    wav = str(tmp_path / "speech.wav")
    save_wav(wav, _speech(2.0), 16000)
    outs = []
    for main, name in ((cli.main, "port.json"), (jcli.main, "jax.json")):
        argv = ["transcribe", "--model", model, "--vocab", vocab, "--input", wav,
                "--output", str(tmp_path / name), "--word-timestamps"]
        main(argv + (["--device", "cpu"] if main is cli.main else []))
        with open(tmp_path / name, encoding="utf-8") as f:
            outs.append(json.load(f))
    _same_segments(*outs)
    assert all("tokens" not in s for s in outs[0])


def test_cli_transcribe_without_a_card_raises(tmp_path, vocab, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = str(tmp_path / "whisper.pt")
    from_jax.write_whisper_pt(model, from_jax.random_whisper_tree(_dims(SMALL)[1], 0),
                              _dims(SMALL)[1])
    wav = str(tmp_path / "speech.wav")
    save_wav(wav, _speech(1.0), 16000)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["transcribe", "--model", model, "--vocab", vocab, "--input", wav,
                  "--output", str(tmp_path / "o.json")])
