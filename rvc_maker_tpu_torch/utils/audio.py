"""Host-side audio I/O and resampling (numpy/scipy only).

A copy of `rvc_maker_tpu/utils/audio.py`: WAV through scipy.io.wavfile,
FLAC read through the repo's C++ decoder (`utils/flac_dec.py`) and
written by `utils/flac_enc.py`, other containers through ffmpeg,
resampling by scipy's polyphase filter with a Kaiser window.  These run
on the host, never on the card.
"""

from __future__ import annotations

import math
import os
import shutil
import subprocess

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample, float32 in/out."""
    if orig_sr == target_sr:
        return audio.astype(np.float32)
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    out = resample_poly(audio.astype(np.float64), up, down, window=("kaiser", 12.0))
    return out.astype(np.float32)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV or FLAC file -> (float32 in [-1, 1], shape (T,) or
    (T, C), sr).  A file that starts with `fLaC` goes to the decoder."""
    with open(path, "rb") as f:
        if f.read(4) == b"fLaC":
            from .flac_dec import flac_decode

            return flac_decode(b"fLaC" + f.read())
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        audio = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        audio = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        audio = (data.astype(np.float32) - 128.0) / 128.0
    else:
        audio = data.astype(np.float32)
    return audio, sr


def load_audio(path: str, target_sr: int = 16000) -> np.ndarray:
    """Read, mix to mono, resample."""
    audio, sr = read_wav(path)
    if audio.ndim == 2:
        audio = audio.mean(axis=1)
    return resample(audio, sr, target_sr)


def peak_normalize(audio: np.ndarray) -> np.ndarray:
    """Scale `audio` down so that its peak is 0.95 when it is above it
    (the conversion entry points' input normalisation)."""
    peak = np.abs(audio).max() / 0.95
    return audio / peak if peak > 1 else audio


def save_wav(path: str, audio: np.ndarray, sr: int, subtype: str = "pcm16") -> None:
    """Write 16-bit PCM clipped to [-1, 1] (subtype "pcm16"), or float32
    as it is (subtype "float32", the training data's format).  A `.flac`
    path gets 16-bit FLAC of the clipped audio, whatever the subtype."""
    audio = np.asarray(audio)
    if path.lower().endswith(".flac"):
        from .flac_enc import write_flac

        write_flac(path, np.clip(audio, -1.0, 1.0), sr)
        return
    if subtype == "pcm16":
        clipped = np.clip(audio, -1.0, 1.0)
        wavfile.write(path, sr, (clipped * 32767.0).astype(np.int16))
    elif subtype == "float32":
        wavfile.write(path, sr, audio.astype(np.float32))
    else:
        raise ValueError(f"unknown subtype {subtype!r}")


def save_audio(path: str, audio: np.ndarray, sr: int, export_format: str = "wav") -> str:
    """Write `audio` in the container `export_format` under `path` with
    its extension replaced; returns the path written.  wav and flac are
    written here; any other format goes through ffmpeg and raises
    without it."""
    fmt = export_format.lower()
    base = path
    for ext in (".wav", ".flac", ".mp3", ".ogg", ".m4a"):
        if base.lower().endswith(ext):
            base = base[: -len(ext)]
            break
    if fmt in ("wav", "flac"):
        save_wav(f"{base}.{fmt}", audio, sr)
        return f"{base}.{fmt}"
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise RuntimeError(f"export format {fmt!r} needs ffmpeg (wav/flac are native)")
    tmp = base + ".tmp.wav"
    save_wav(tmp, audio, sr)
    out = f"{base}.{fmt}"
    subprocess.run([ffmpeg, "-y", "-i", tmp, out], check=True, capture_output=True)
    os.remove(tmp)
    return out
