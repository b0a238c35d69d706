"""Host-side audio I/O and resampling (numpy/scipy only).

A copy of the WAV parts of `rvc_maker_tpu/utils/audio.py`: WAV through
scipy.io.wavfile, resampling by scipy's polyphase filter with a Kaiser
window.  These run on the host, never on the card.
"""

from __future__ import annotations

import math

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
    """Read a WAV file -> (float32 in [-1, 1], shape (T,) or (T, C), sr)."""
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


def save_wav(path: str, audio: np.ndarray, sr: int, subtype: str = "pcm16") -> None:
    """Write 16-bit PCM clipped to [-1, 1] (subtype "pcm16"), or float32
    as it is (subtype "float32", the training data's format)."""
    audio = np.asarray(audio)
    if subtype == "pcm16":
        clipped = np.clip(audio, -1.0, 1.0)
        wavfile.write(path, sr, (clipped * 32767.0).astype(np.int16))
    elif subtype == "float32":
        wavfile.write(path, sr, audio.astype(np.float32))
    else:
        raise ValueError(f"unknown subtype {subtype!r}")
