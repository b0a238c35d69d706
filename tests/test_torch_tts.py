"""The port's TTS stack (`rvc_maker_tpu_torch/utils/ws.py`,
`utils/edge_tts_client.py`, `utils/tts.py`, `cli tts`) against the JAX
package's, offline: a loopback read-aloud server (tests/read_aloud_fake.py,
framed by the port's ws.py) serves both clients.  Frames and protocol messages
equal JAX's, the synthesized bytes, `srt_tts`'s timeline and
`time_stretch` equal, Google's request built as JAX builds it (no
network), and `cli tts --model --device cpu` within 1e-3 plus one int16
step of JAX's `cli tts --model`."""

import socket
import struct
import urllib.request

import numpy as np
import pytest
import torch

from read_aloud_fake import FakeReadAloudServer, pcm_wav_bytes
from rvc_maker_tpu import cli as jcli
from rvc_maker_tpu.models import hubert as jhubert
from rvc_maker_tpu.utils import edge_tts_client as jetc
from rvc_maker_tpu.utils import tts as jtts
from rvc_maker_tpu.utils import ws as jws
from rvc_maker_tpu_torch import cli
from rvc_maker_tpu_torch.utils import edge_tts_client as etc
from rvc_maker_tpu_torch.utils import tts
from rvc_maker_tpu_torch.utils import ws
from rvc_maker_tpu_torch.utils.audio import read_wav, resample
from test_torch_convert_flags import JCFG
from torch_port_util import patch_jax_noise, torch_threads, voice, write_voice_files  # noqa: F401

ATOL = 1e-3 + 1.0 / 32768
SRT = """\
1
00:00:00,500 --> 00:00:01,400
hello there

2
00:00:02,000 --> 00:00:02,600
second line
continued
"""


@pytest.fixture(scope="module")
def server():
    """Serves 1 s of a voiced tone at 24 kHz as RIFF PCM."""
    srv = FakeReadAloudServer(pcm_wav_bytes(resample(voice(1.0, 180.0, 4), 16000, 24000)))
    yield srv
    srv.close()


@pytest.mark.parametrize("n", [0, 125, 126, 65535, 65536])
@pytest.mark.parametrize("mask", [True, False])
def test_frames_equal_jax(n, mask):
    payload = bytes(range(256)) * (n // 256) + bytes(n % 256)
    frame = ws.encode_frame(ws.OP_BINARY, payload, mask=mask, mask_key=b"\x01\x02\x03\x04")
    assert frame == jws.encode_frame(jws.OP_BINARY, payload, mask=mask,
                                     mask_key=b"\x01\x02\x03\x04")
    a, b = socket.socketpair()
    try:
        a.sendall(frame)
        assert ws.decode_frame(b) == (ws.OP_BINARY, True, payload)
    finally:
        a.close()
        b.close()


def test_protocol_messages_equal_jax():
    t = 1_700_000_000
    assert etc.sec_ms_gec(t) == jetc.sec_ms_gec(t)
    assert etc.js_timestamp(t) == jetc.js_timestamp(t)
    for kw in (dict(rate=-10, pitch=3), dict(rate="+5%", pitch="-2Hz", volume=4)):
        assert etc.build_ssml("a < b & c", "en-US-AriaNeural", **kw) == \
            jetc.build_ssml("a < b & c", "en-US-AriaNeural", **kw)
    assert etc.speech_config_message(etc.PCM_FORMAT, "T") == \
        jetc.speech_config_message(jetc.PCM_FORMAT, "T")
    assert etc.ssml_message("id", "<speak/>", "T") == jetc.ssml_message("id", "<speak/>", "T")
    assert etc.request_headers() == jetc.request_headers()
    url = etc.connection_url("wss://example.test/tts/v1", t)
    jurl = jetc.connection_url("wss://example.test/tts/v1", t)
    assert url.rsplit("&ConnectionId=", 1)[0] == jurl.rsplit("&ConnectionId=", 1)[0]
    head = "X-RequestId:abc\r\nPath:audio\r\n"
    msg = struct.pack("!H", len(head)) + head.encode() + b"\xffaudio"
    assert etc.parse_binary_message(msg) == jetc.parse_binary_message(msg)
    assert (etc.PCM_FORMAT, etc.DEFAULT_VOICE, etc.WSS_URL) == \
        (jetc.PCM_FORMAT, jetc.DEFAULT_VOICE, jetc.WSS_URL)


def test_synthesizer_full_exchange(server):
    synth = etc.Synthesizer("en-US-AriaNeural", rate=5, pitch=-2,
                            output_format=etc.PCM_FORMAT, endpoint=server.url)
    audio, words = synth.synthesize("hello world & <tags>")
    assert audio == server.audio
    assert words == [etc.WordBoundary(500000, 1000000, "hello")]
    (h1, b1), (h2, b2) = server.requests[-2:]
    assert h1["Path"] == "speech.config" and etc.PCM_FORMAT in b1
    assert h2["Path"] == "ssml" and "hello world &amp; &lt;tags&gt;" in b2
    assert "rate='+5%'" in b2 and "pitch='-2Hz'" in b2


def test_synthesize_tts_bytes_equal_jax(server, tmp_path):
    for fn, name in ((tts.synthesize_tts, "p.wav"), (jtts.synthesize_tts, "j.wav")):
        fn("hi", "en-US-AriaNeural", str(tmp_path / name), endpoint=server.url,
           output_format=etc.PCM_FORMAT)
    data = (tmp_path / "p.wav").read_bytes()
    assert data[:4] == b"RIFF" and data == server.audio == (tmp_path / "j.wav").read_bytes()


def test_synthesize_tts_refused_connection_raises(tmp_path):
    """A closed port (the card's machine has no network): the OSError
    surfaces as the JAX package's RuntimeError, with no retry."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    with pytest.raises(RuntimeError, match="network access"):
        tts.synthesize_tts("hi", "en-US-AriaNeural", str(tmp_path / "x.wav"),
                           endpoint=f"ws://127.0.0.1:{port}/tts",
                           output_format=etc.PCM_FORMAT)


def test_srt_tts_matches_jax(server, tmp_path):
    """Each cue synthesized, stretched to its duration and placed on a
    silent timeline: the port's file is JAX's."""
    (tmp_path / "cues.srt").write_text(SRT)
    for fn, name in ((tts.srt_tts, "p.wav"), (jtts.srt_tts, "j.wav")):
        fn(str(tmp_path / "cues.srt"), str(tmp_path / name), "en-US-AriaNeural",
           endpoint=server.url)
    got, sr = read_wav(str(tmp_path / "p.wav"))
    assert sr == 24000 and len(got) == int(2.6 * sr)
    assert np.abs(got[: int(0.4 * sr)]).max() == 0 and np.abs(got[int(0.6 * sr):]).max() > 0.05
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    assert tts.parse_srt(SRT) == [tts.SrtCue(**vars(c)) for c in jtts.parse_srt(SRT)]


@pytest.mark.parametrize("target", [1.7, 0.5, 0.01], ids=["stretch", "shrink", "short"])
def test_time_stretch_matches_jax(target):
    x = resample(voice(1.0, 220.0, 5), 16000, 24000)
    if target == 0.01:
        x = x[:100]
    got = tts.time_stretch(x, 24000, target)
    np.testing.assert_allclose(got, jtts.time_stretch(x, 24000, target), rtol=0, atol=1e-6)
    assert len(got) == int(round(target * 24000))


def test_read_tts_output_refuses_mp3(tmp_path):
    path = tmp_path / "tts.mp3"
    path.write_bytes(b"ID3\x04" + bytes(64))
    with pytest.raises(RuntimeError, match="not a RIFF/WAV file"):
        tts._read_tts_output(str(path), 16000)


def test_google_request_is_jax_request(tmp_path, monkeypatch):
    """Google's translate_tts needs the network: the request each package
    builds is captured at urlopen, and they are equal."""
    seen = []

    class Resp:
        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def read(self):
            return b"ID3mp3"

    def urlopen(req, timeout):
        seen.append((req.full_url, dict(req.header_items()), timeout))
        return Resp()

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    for fn, name in ((tts.synthesize_tts, "p.mp3"), (jtts.synthesize_tts, "j.mp3")):
        fn("hola & adiós", "es", str(tmp_path / name), rate=1, google=True)
    assert seen[0] == seen[1] and seen[0][0].startswith(tts.GOOGLE_TTS_URL + "?")
    assert (tmp_path / "p.mp3").read_bytes() == b"ID3mp3"


def test_cli_tts_writes_the_served_bytes(server, tmp_path, monkeypatch):
    monkeypatch.setenv("RVC_TPU_EDGE_TTS_URL", server.url)
    assert cli.main(["tts", "--text", "hello", "--voice", "en-US-AriaNeural",
                     "--output", str(tmp_path / "tts.wav")]) == 0
    assert (tmp_path / "tts.wav").read_bytes() == server.audio


def test_cli_tts_model_matches_jax(server, tmp_path, monkeypatch):
    """`cli tts --model --device cpu` converts the synthesized speech as
    JAX's `cli tts --model` does, fed the JAX pipeline's noise."""
    files = write_voice_files(tmp_path, JCFG)
    monkeypatch.setenv("RVC_TPU_EDGE_TTS_URL", server.url)
    monkeypatch.setattr(jhubert, "N_LAYERS", 2)
    patch_jax_noise(monkeypatch)
    argv = ["tts", "--text", "hello", "--model", files["model"], "--rmvpe-path",
            files["rmvpe"], "--embedder-path", files["embedder"], "--pitch", "2"]
    assert cli.main([*argv, "--output", str(tmp_path / "p_tts.wav"), "--convert-output",
                     str(tmp_path / "p.wav"), "--device", "cpu"]) == 0
    jcli.main([*argv, "--output", str(tmp_path / "j_tts.wav"), "--convert-output",
               str(tmp_path / "j.wav")])
    got, sr = read_wav(str(tmp_path / "p.wav"))
    ref, jsr = read_wav(str(tmp_path / "j.wav"))
    assert sr == jsr == JCFG.sr and got.shape == ref.shape and np.abs(ref).max() > 0.1
    err = float(np.abs(got - ref).max())
    print(f"\ncli tts --model, port vs JAX: max abs {err:.3e} (tol {ATOL:.3e})")
    assert err <= ATOL, err


def test_cli_tts_model_on_a_missing_card_raises(server, tmp_path, monkeypatch):
    """tts --model without --device cpu and no card raises before it
    synthesizes anything."""
    monkeypatch.setenv("RVC_TPU_EDGE_TTS_URL", server.url)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = len(server.requests)
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["tts", "--text", "hello", "--model", "voice.pth",
                  "--output", str(tmp_path / "tts.wav")])
    assert len(server.requests) == before and not (tmp_path / "tts.wav").exists()
