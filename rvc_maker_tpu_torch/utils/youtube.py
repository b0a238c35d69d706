"""YouTube audio downloader over the InnerTube API, no yt-dlp (a copy of
JAX `utils/youtube.py`).

The reference builds datasets from YouTube via the yt-dlp package
(create_dataset.py:135-146, format "bestaudio/best").  This module
implements the same capability natively: the InnerTube ``/player``
endpoint queried as the ANDROID client returns direct (unciphered)
``url`` fields in ``streamingData.adaptiveFormats``, so no JS signature
deciphering is needed; "bestaudio" selection picks the highest-bitrate
audio-only format; downloads go in ranged chunks (large single GETs get
throttled).

Network-gated like every downloader here; the ID parsing, request
construction, format selection and ranged download are tested offline
against fixtures and a local HTTP server.

Decoded output is webm/opus or m4a/aac — converting to WAV needs an
external ffmpeg (the reference needs one too: yt-dlp's
FFmpegExtractAudio postprocessor).  ``to_wav`` gates on its presence.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
import subprocess
import urllib.error
import urllib.parse
import urllib.request

logger = logging.getLogger(__name__)

INNERTUBE_URL = "https://www.youtube.com/youtubei/v1/player"

# ANDROID client: returns direct stream URLs without signatureCipher
ANDROID_CLIENT = {
    "clientName": "ANDROID",
    "clientVersion": "19.09.37",
    "androidSdkVersion": 30,
    "userAgent": "com.google.android.youtube/19.09.37 (Linux; U; Android 11)",
    "hl": "en", "timeZone": "UTC", "utcOffsetMinutes": 0,
}

_ID_RE = re.compile(r"^[A-Za-z0-9_-]{11}$")
_URL_PATTERNS = (
    re.compile(r"(?:v=|/v/|/embed/|/shorts/|/live/)([A-Za-z0-9_-]{11})"),
    re.compile(r"youtu\.be/([A-Za-z0-9_-]{11})"),
)


def extract_video_id(url_or_id: str) -> str:
    """Accepts watch/shorts/embed/youtu.be URLs or a bare 11-char id."""
    s = url_or_id.strip()
    if _ID_RE.match(s):
        return s
    for pat in _URL_PATTERNS:
        m = pat.search(s)
        if m:
            return m.group(1)
    raise ValueError(f"not a YouTube video URL or id: {url_or_id!r}")


def is_youtube_url(url: str) -> bool:
    host = urllib.parse.urlparse(url).netloc.lower().rsplit(":", 1)[0]
    return any(host == d or host.endswith("." + d)
               for d in ("youtube.com", "youtu.be", "youtube-nocookie.com"))


def build_player_request(video_id: str) -> tuple[str, bytes, dict]:
    """(url, body, headers) for the InnerTube /player call."""
    body = json.dumps({
        "context": {"client": dict(ANDROID_CLIENT)},
        "videoId": video_id,
        "contentCheckOk": True,
        "racyCheckOk": True,
        "params": "CgIIAQ==",   # web-safe b64: internal "8AEB" bypass hint
    }).encode()
    headers = {
        "Content-Type": "application/json",
        "User-Agent": ANDROID_CLIENT["userAgent"],
        "X-Youtube-Client-Name": "3",
        "X-Youtube-Client-Version": ANDROID_CLIENT["clientVersion"],
    }
    return f"{INNERTUBE_URL}?prettyPrint=false", body, headers


def fetch_player_response(video_id: str, timeout: float = 20.0) -> dict:
    url, body, headers = build_player_request(video_id)
    req = urllib.request.Request(url, data=body, headers=headers)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode())


def select_best_audio(player_response: dict) -> dict:
    """yt-dlp "bestaudio" semantics: audio-only adaptive format with the
    highest bitrate; must carry a direct url (ANDROID client does)."""
    status = player_response.get("playabilityStatus", {})
    if status.get("status") not in (None, "OK"):
        raise RuntimeError(
            f"video not playable: {status.get('status')} "
            f"{status.get('reason', '')}".strip())
    formats = (player_response.get("streamingData", {})
               .get("adaptiveFormats", []))
    audio = [f for f in formats
             if f.get("mimeType", "").startswith("audio/") and f.get("url")]
    if not audio:
        raise RuntimeError("no direct audio formats in player response "
                           "(cipher-protected or empty streamingData)")
    return max(audio, key=lambda f: f.get("bitrate", 0))


def format_extension(fmt: dict) -> str:
    mime = fmt.get("mimeType", "")
    if mime.startswith("audio/webm"):
        return "webm"
    if mime.startswith("audio/mp4"):
        return "m4a"
    return mime.split("/", 1)[-1].split(";", 1)[0] or "bin"


def download_ranged(url: str, output_path: str, *,
                    total_bytes: int | None = None,
                    chunk_bytes: int = 9 * 1024 * 1024,
                    timeout: float = 30.0) -> str:
    """Download in Range chunks (YouTube throttles monolithic GETs on
    googlevideo hosts; yt-dlp chunks the same way)."""
    pos = 0
    with open(output_path, "wb") as f:
        while True:
            end = pos + chunk_bytes - 1
            if total_bytes is not None:
                if pos >= total_bytes:
                    break
                end = min(end, total_bytes - 1)
            req = urllib.request.Request(
                url, headers={"Range": f"bytes={pos}-{end}"})
            try:
                with urllib.request.urlopen(req, timeout=timeout) as resp:
                    data = resp.read()
            except urllib.error.HTTPError as e:
                if e.code == 416 and pos > 0:  # ran past end of stream
                    break
                raise
            if not data:
                break
            f.write(data)
            pos += len(data)
            if len(data) < end - (pos - len(data)) + 1:
                break  # short read = end of stream
    return output_path


def download_audio(url_or_id: str, output_base: str, *,
                   timeout: float = 30.0) -> str:
    """Download the best audio stream of a video; returns the written
    path (``output_base`` + container extension)."""
    video_id = extract_video_id(url_or_id)
    logger.info("youtube: fetching player response for %s", video_id)
    pr = fetch_player_response(video_id, timeout=timeout)
    fmt = select_best_audio(pr)
    ext = format_extension(fmt)
    out = f"{output_base}.{ext}"
    total = int(fmt["contentLength"]) if fmt.get("contentLength") else None
    logger.info("youtube: downloading itag %s (%s, %s bytes)",
                fmt.get("itag"), fmt.get("mimeType"), total)
    return download_ranged(fmt["url"], out, total_bytes=total,
                           timeout=timeout)


def to_wav(input_path: str, output_path: str, sample_rate: int = 44100) -> str:
    """Decode a downloaded container to WAV via ffmpeg (the only aac/opus
    decoder route; absent in this image -> clear error, same gating as
    yt-dlp's FFmpegExtractAudio)."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(
            "ffmpeg is required to decode YouTube audio (webm/opus or "
            "m4a/aac) to WAV and was not found on PATH")
    subprocess.run(
        [ffmpeg, "-y", "-i", input_path, "-ac", "1",
         "-ar", str(sample_rate), output_path],
        check=True, capture_output=True)
    return output_path


def download_audio_wav(url_or_id: str, output_wav: str, *,
                       sample_rate: int = 44100,
                       timeout: float = 30.0) -> str:
    """Full reference `downloader` equivalent (create_dataset.py:135-146):
    bestaudio download + WAV extraction."""
    base = os.path.splitext(output_wav)[0]
    raw = download_audio(url_or_id, base + ".dl", timeout=timeout)
    try:
        return to_wav(raw, output_wav, sample_rate=sample_rate)
    finally:
        if os.path.exists(raw):
            os.remove(raw)
