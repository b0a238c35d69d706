"""Native Microsoft Edge read-aloud TTS client (no edge-tts package).

A copy of `rvc_maker_tpu/utils/edge_tts_client.py`; RVC_TPU_EDGE_TTS_URL
still points it at another endpoint (the tests' loopback server).

The reference synthesizes TTS through the ``edge_tts`` pypi package
(app.py synthesize_tts:729-738).  That package is a thin client for the
Edge browser's read-aloud WebSocket service; this module implements the
same wire protocol directly on the stdlib (utils/ws.py):

  * DRM clock token:  ``Sec-MS-GEC`` = SHA256(windows_file_time_rounded
    _to_5min + trusted client token), uppercase hex.
  * speech.config + SSML messages with JS-style X-Timestamp headers.
  * binary audio frames: 2-byte big-endian header-block length, then
    ``Path:audio`` headers, then an audio payload chunk.
  * ``turn.start`` / ``audio.metadata`` / ``turn.end`` text messages.

Synthesis needs network access (zero-egress deployments raise a clear
error at connect time); every protocol piece — token, SSML build,
message framing/parsing, the full exchange — is offline-tested against
a loopback fake server in tests/test_tts.py.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import uuid
from dataclasses import dataclass

TRUSTED_CLIENT_TOKEN = "6A5AA1D4EAFF4E9FB37E23D68491D6F4"
BASE_HOST = "speech.platform.bing.com"
WSS_URL = (f"wss://{BASE_HOST}/consumer/speech/synthesize/"
           "readaloud/edge/v1")
VOICE_LIST_URL = (f"https://{BASE_HOST}/consumer/speech/synthesize/"
                  "readaloud/voices/list"
                  f"?trustedclienttoken={TRUSTED_CLIENT_TOKEN}")
CHROMIUM_FULL_VERSION = "130.0.2849.68"
CHROMIUM_MAJOR = CHROMIUM_FULL_VERSION.split(".", 1)[0]

DEFAULT_VOICE = "en-US-EmmaMultilingualNeural"
DEFAULT_FORMAT = "audio-24khz-48kbitrate-mono-mp3"
PCM_FORMAT = "riff-24khz-16bit-mono-pcm"

_WIN_EPOCH_OFFSET = 11644473600  # seconds between 1601-01-01 and 1970-01-01
_S_TO_100NS = 10_000_000


def sec_ms_gec(unix_time: float | None = None) -> str:
    """The Sec-MS-GEC DRM token: SHA256 of the Windows file time (100 ns
    ticks since 1601) rounded DOWN to the nearest 5 minutes, concatenated
    with the trusted client token; uppercase hex digest."""
    t = time.time() if unix_time is None else unix_time
    ticks = int(t) + _WIN_EPOCH_OFFSET
    ticks -= ticks % 300  # 5-minute windows
    ticks *= _S_TO_100NS
    return hashlib.sha256(
        f"{ticks}{TRUSTED_CLIENT_TOKEN}".encode()).hexdigest().upper()


def js_timestamp(unix_time: float | None = None) -> str:
    """JS Date().toString()-style timestamp the service expects in
    X-Timestamp headers."""
    t = time.gmtime(time.time() if unix_time is None else unix_time)
    days = ("Sun", "Mon", "Tue", "Wed", "Thu", "Fri", "Sat")
    months = ("Jan", "Feb", "Mar", "Apr", "May", "Jun",
              "Jul", "Aug", "Sep", "Oct", "Nov", "Dec")
    return (f"{days[(t.tm_wday + 1) % 7]} "
            f"{months[t.tm_mon - 1]} {t.tm_mday:02d} {t.tm_year} "
            f"{t.tm_hour:02d}:{t.tm_min:02d}:{t.tm_sec:02d} "
            "GMT+0000 (Coordinated Universal Time)")


def connect_id() -> str:
    return uuid.uuid4().hex


def escape_xml(text: str) -> str:
    return (text.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


def _signed(value: int | str, unit: str) -> str:
    if isinstance(value, str):  # already formatted ("+3%", "-20Hz")
        return value
    return f"+{value}{unit}" if value >= 0 else f"{value}{unit}"


def build_ssml(text: str, voice: str, *, rate: int | str = 0,
               pitch: int | str = 0, volume: int | str = 0) -> str:
    """SSML body for one utterance (reference passes rate as +N% and
    pitch as +NHz, app.py:733)."""
    return (
        "<speak version='1.0' xmlns='http://www.w3.org/2001/10/synthesis'"
        " xml:lang='en-US'>"
        f"<voice name='{voice}'>"
        f"<prosody pitch='{_signed(pitch, 'Hz')}' rate='{_signed(rate, '%')}'"
        f" volume='{_signed(volume, '%')}'>"
        f"{escape_xml(text)}"
        "</prosody></voice></speak>"
    )


def speech_config_message(output_format: str = DEFAULT_FORMAT,
                          timestamp: str | None = None) -> str:
    config = {"context": {"synthesis": {"audio": {
        "metadataoptions": {"sentenceBoundaryEnabled": "false",
                            "wordBoundaryEnabled": "true"},
        "outputFormat": output_format}}}}
    return (f"X-Timestamp:{timestamp or js_timestamp()}\r\n"
            "Content-Type:application/json; charset=utf-8\r\n"
            "Path:speech.config\r\n\r\n"
            + json.dumps(config, separators=(",", ":")))


def ssml_message(request_id: str, ssml: str,
                 timestamp: str | None = None) -> str:
    return (f"X-RequestId:{request_id}\r\n"
            "Content-Type:application/ssml+xml\r\n"
            f"X-Timestamp:{timestamp or js_timestamp()}Z\r\n"
            "Path:ssml\r\n\r\n" + ssml)


def parse_text_message(message: str) -> tuple[dict, str]:
    """Split a text message into (headers dict, body)."""
    head, _, body = message.partition("\r\n\r\n")
    headers = {}
    for line in head.split("\r\n"):
        k, _, v = line.partition(":")
        if k:
            headers[k] = v
    return headers, body


def parse_binary_message(message: bytes) -> tuple[dict, bytes]:
    """Split a binary message into (headers dict, audio payload).
    Layout: 2-byte big-endian header-block length + headers + payload."""
    if len(message) < 2:
        raise ValueError("binary message too short")
    hlen = int.from_bytes(message[:2], "big")
    if 2 + hlen > len(message):
        raise ValueError("binary message header length out of range")
    headers, _ = parse_text_message(message[2:2 + hlen].decode(
        "utf-8", errors="replace"))
    return headers, message[2 + hlen:]


def connection_url(base: str | None = None,
                   unix_time: float | None = None) -> str:
    base = base or os.environ.get("RVC_TPU_EDGE_TTS_URL", WSS_URL)
    sep = "&" if "?" in base else "?"
    return (f"{base}{sep}TrustedClientToken={TRUSTED_CLIENT_TOKEN}"
            f"&Sec-MS-GEC={sec_ms_gec(unix_time)}"
            f"&Sec-MS-GEC-Version=1-{CHROMIUM_FULL_VERSION}"
            f"&ConnectionId={connect_id()}")


def request_headers() -> dict[str, str]:
    return {
        "Pragma": "no-cache",
        "Cache-Control": "no-cache",
        "Origin": "chrome-extension://jdiccldimpdaibmpdkjnbmckianbfold",
        "Accept-Language": "en-US,en;q=0.9",
        "User-Agent": ("Mozilla/5.0 (Windows NT 10.0; Win64; x64) "
                       "AppleWebKit/537.36 (KHTML, like Gecko) "
                       f"Chrome/{CHROMIUM_MAJOR}.0.0.0 Safari/537.36 "
                       f"Edg/{CHROMIUM_MAJOR}.0.0.0"),
    }


@dataclass
class WordBoundary:
    offset_100ns: int
    duration_100ns: int
    text: str


class Synthesizer:
    """One synthesis exchange.  ``synthesize`` returns (audio bytes,
    [WordBoundary...]); audio encoding is ``output_format`` (mp3 by
    default, same as the reference's edge-tts usage)."""

    def __init__(self, voice: str = DEFAULT_VOICE, *, rate: int | str = 0,
                 pitch: int | str = 0, volume: int | str = 0,
                 output_format: str = DEFAULT_FORMAT,
                 endpoint: str | None = None, timeout: float = 30.0):
        self.voice = voice
        self.rate = rate
        self.pitch = pitch
        self.volume = volume
        self.output_format = output_format
        self.endpoint = endpoint
        self.timeout = timeout

    def synthesize(self, text: str) -> tuple[bytes, list[WordBoundary]]:
        from .ws import WebSocket

        url = connection_url(self.endpoint)
        audio = bytearray()
        words: list[WordBoundary] = []
        with WebSocket(url, headers=request_headers(),
                       timeout=self.timeout) as ws:
            ws.send_text(speech_config_message(self.output_format))
            ws.send_text(ssml_message(
                connect_id(),
                build_ssml(text, self.voice, rate=self.rate,
                           pitch=self.pitch, volume=self.volume)))
            got_audio = False
            while True:
                msg = ws.receive()
                if msg is None:
                    break
                if isinstance(msg, bytes):
                    headers, payload = parse_binary_message(msg)
                    if headers.get("Path") == "audio":
                        audio.extend(payload)
                        got_audio = True
                    continue
                headers, body = parse_text_message(msg)
                path = headers.get("Path")
                if path == "audio.metadata":
                    for item in json.loads(body).get("Metadata", []):
                        if item.get("Type") == "WordBoundary":
                            d = item["Data"]
                            words.append(WordBoundary(
                                offset_100ns=int(d["Offset"]),
                                duration_100ns=int(d["Duration"]),
                                text=d["text"]["Text"]))
                elif path == "turn.end":
                    break
        if not got_audio:
            raise RuntimeError("edge-tts: no audio received "
                               "(service rejected the request?)")
        return bytes(audio), words


def list_voices(timeout: float = 15.0) -> list[dict]:
    """GET the service's voice catalogue (network)."""
    import urllib.request

    req = urllib.request.Request(
        VOICE_LIST_URL + f"&Sec-MS-GEC={sec_ms_gec()}"
        f"&Sec-MS-GEC-Version=1-{CHROMIUM_FULL_VERSION}",
        headers=request_headers())
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())
