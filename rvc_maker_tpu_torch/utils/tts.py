"""Text-to-speech synthesis + TTS->RVC conversion flow.

A copy of `rvc_maker_tpu/utils/tts.py`; the conversion half takes the
port's `ConvertPipeline`, which runs on its own device.

Reference: app.py synthesize_tts:729-749 (edge-tts or Google Translate
TTS), srt_tts:760-788 (SRT-timed synthesis), time_stretch:751-756,
convert_tts:1166-1207 (synthesize then run the RVC pipeline).

Both TTS backends are network services; the protocol clients are native
(utils/edge_tts_client.py over utils/ws.py — no edge_tts package) and a
zero-egress deployment fails at connect time with a clear error.  The
SRT parsing, time stretching, timeline placement, and the conversion
half are fully local and offline-tested.
"""

from __future__ import annotations

import logging
import os
import re
import urllib.parse
import urllib.request
from dataclasses import dataclass

import numpy as np

from .audio import load_audio, read_wav, resample, save_wav
from .i18n import tr

logger = logging.getLogger(__name__)

GOOGLE_TTS_URL = "https://translate.google.com/translate_tts"


def synthesize_tts(text: str, voice: str, output_path: str, *,
                   rate: int = 0, pitch: int = 0, google: bool = False,
                   endpoint: str | None = None,
                   output_format: str | None = None) -> str:
    """Synthesize speech to ``output_path``.

    Edge backend (default): native read-aloud protocol client; ``rate``
    is a speaking-rate delta in percent, ``pitch`` in Hz (the reference's
    +N%/+NHz strings, app.py:733).  ``output_format`` defaults to the
    reference's mp3; pass edge_tts_client.PCM_FORMAT to get a RIFF/WAV
    stream (what convert_tts uses so the local pipeline can read it).

    Google backend: translate_tts GET (reference app.py:735-738; URL
    there is rot13-obfuscated), voice = language code; returns MP3.
    """
    if google:
        params = urllib.parse.urlencode({
            "ie": "UTF-8", "q": text, "tl": voice,
            "ttsspeed": rate, "client": "tw-ob"})
        req = urllib.request.Request(
            f"{GOOGLE_TTS_URL}?{params}",
            headers={"User-Agent": (
                "Mozilla/5.0 (Windows NT 10.0; Win64; x64) "
                "AppleWebKit/537.36 (KHTML, like Gecko) "
                "Chrome/111.0.0.0 Safari/537.36")})
        with urllib.request.urlopen(req, timeout=30) as resp:
            data = resp.read()
        with open(output_path, "wb") as f:
            f.write(data)
        return output_path

    from . import edge_tts_client as etc

    synth = etc.Synthesizer(
        voice or etc.DEFAULT_VOICE, rate=rate, pitch=pitch,
        output_format=output_format or etc.DEFAULT_FORMAT,
        endpoint=endpoint)
    try:
        audio, _ = synth.synthesize(text)
    except OSError as e:
        raise RuntimeError(
            "TTS needs network access to the Edge read-aloud service. "
            + tr("download_disabled")) from e
    with open(output_path, "wb") as f:
        f.write(audio)
    return output_path


# ---------------------------------------------------------------- SRT


@dataclass
class SrtCue:
    index: int
    start: float       # seconds
    end: float
    text: str

    @property
    def duration(self) -> float:
        return self.end - self.start


_SRT_TIME = re.compile(
    r"(\d+):(\d\d):(\d\d)[,.](\d{1,3})\s*-->\s*(\d+):(\d\d):(\d\d)[,.](\d{1,3})")


def parse_srt(content: str) -> list[SrtCue]:
    """Parse SubRip content (replaces the reference's pysrt dependency,
    app.py:758-788)."""
    cues: list[SrtCue] = []
    blocks = re.split(r"\n\s*\n", content.replace("\r\n", "\n").strip())
    for block in blocks:
        lines = [ln for ln in block.split("\n") if ln.strip()]
        if not lines:
            continue
        ti = 0
        idx = len(cues) + 1
        if lines[0].strip().isdigit():
            idx = int(lines[0])
            ti = 1
        if ti >= len(lines):
            continue
        m = _SRT_TIME.search(lines[ti])
        if not m:
            continue
        h1, m1, s1, ms1, h2, m2, s2, ms2 = m.groups()

        def secs(h, m_, s, ms):
            return int(h) * 3600 + int(m_) * 60 + int(s) + int(ms.ljust(3, "0")) / 1000

        cues.append(SrtCue(
            index=idx,
            start=secs(h1, m1, s1, ms1),
            end=secs(h2, m2, s2, ms2),
            text=" ".join(ln.strip() for ln in lines[ti + 1:])))
    return cues


def time_stretch(y: np.ndarray, sr: int, target_duration: float) -> np.ndarray:
    """Stretch/compress ``y`` to ``target_duration`` seconds without
    changing pitch (phase vocoder), then pad/trim to the exact sample
    count (reference time_stretch app.py:751-756)."""
    from .pitchshift import _istft, _stft, _wrap

    n_target = int(round(target_duration * sr))
    y = np.asarray(y, np.float64)
    rate = (len(y) / sr) / max(target_duration, 1e-9)
    if abs(rate - 1.0) > 1e-6 and len(y) > 2048:
        framesize, hopsize = 1024, 256
        frames = _stft(y, framesize, hopsize)        # complex (m, bins)
        m, n = frames.shape
        pos = np.arange(0, m - 1, rate)
        lo = np.floor(pos).astype(int)
        frac = (pos - lo)[:, None]
        mag = np.abs(frames[lo]) * (1 - frac) + np.abs(frames[lo + 1]) * frac
        # phase accumulation: start at the true phases of the first
        # analysis frame, then advance each output hop by the measured
        # per-hop phase increment of the analysis frame it samples —
        # this keeps relative bin phases coherent (repeating _decode's
        # delta for duplicated frames scrambles them and the tone's
        # window lobes cancel in the overlap-add).
        expected = 2 * np.pi * hopsize / framesize * np.arange(n)[None, :]
        arg = np.angle(frames)
        dphase = expected + _wrap(arg[lo + 1] - arg[lo] - expected)
        phase = arg[0] + np.concatenate(
            [np.zeros((1, n)), np.cumsum(dphase, axis=0)[:-1]], axis=0)
        y = _istft(mag * np.exp(1j * phase), framesize, hopsize)
    y = y.astype(np.float32)
    if len(y) < n_target:
        return np.pad(y, (0, n_target - len(y)))
    return y[:n_target]


def _read_tts_output(path: str, target_sr: int) -> np.ndarray:
    """Read a synthesized file (RIFF/WAV only — callers request the PCM
    output format; MP3 needs an external decoder)."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic != b"RIFF":
        raise RuntimeError(
            f"{path}: not a RIFF/WAV file — request PCM_FORMAT from the "
            "edge backend, or decode mp3 externally (no mp3 decoder in "
            "the port)")
    audio, sr = read_wav(path)
    if audio.ndim == 2:
        audio = audio.mean(axis=1)
    return resample(audio, sr, target_sr)


def srt_tts(srt_path: str, out_path: str, voice: str, *, rate: int = 0,
            sr: int = 24000, google: bool = False,
            endpoint: str | None = None) -> str:
    """Synthesize every SRT cue and place it on a silent timeline at its
    cue time, time-stretched to the cue duration (reference srt_tts
    app.py:760-788)."""
    from . import edge_tts_client as etc

    with open(srt_path, encoding="utf-8") as f:
        cues = parse_srt(f.read())
    if not cues:
        raise ValueError(tr("srt_invalid"))

    final = np.zeros(int(round(cues[-1].end * sr)), np.float32)
    import tempfile
    with tempfile.TemporaryDirectory() as tempdir:
        for i, cue in enumerate(cues):
            seg_path = os.path.join(tempdir, f"seg_{i}.wav")
            synthesize_tts(cue.text, voice, seg_path, rate=rate,
                           pitch=0, google=google, endpoint=endpoint,
                           output_format=None if google else etc.PCM_FORMAT)
            audio = _read_tts_output(seg_path, sr)
            adjusted = time_stretch(audio, sr, cue.duration)
            start = int(round(cue.start * sr))
            end = min(start + len(adjusted), len(final))
            final[start:end] += adjusted[:end - start]
    save_wav(out_path, final, sr)
    return out_path


def convert_tts(text: str, voice: str, pipeline, settings, sid: int,
                output_path: str, *, rate: int = 0, google: bool = False,
                endpoint: str | None = None, workdir: str = "/tmp",
                srt_path: str | None = None) -> str:
    """TTS -> voice conversion (reference convert_tts app.py:1166-1207)."""
    from . import edge_tts_client as etc

    tts_path = os.path.join(workdir, "tts_raw.wav")
    if srt_path:
        srt_tts(srt_path, tts_path, voice, rate=rate, google=google,
                endpoint=endpoint)
    else:
        synthesize_tts(text, voice, tts_path, rate=rate, google=google,
                       endpoint=endpoint,
                       output_format=None if google else etc.PCM_FORMAT)
    audio16 = _read_tts_output(tts_path, 16000)
    peak = np.abs(audio16).max() / 0.95
    if peak > 1:
        audio16 = audio16 / peak
    out = pipeline.convert_utterance(audio16, sid, settings)
    save_wav(output_path, out, pipeline.cfg.sr)
    return output_path
