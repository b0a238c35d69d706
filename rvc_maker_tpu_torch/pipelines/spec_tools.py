"""Host spectral tools of the separation flow (a part of JAX
`pipelines/spec_tools.py`, itself the reference uvr5_separator/
spec_utils.py): the peak limit and the spectral inversion of a stem
against its mixture, with the numpy STFT they run on.  Host numpy only;
the rest of spec_tools.py (ensembling, alignment, the multi-band tools)
is not ported.
"""

from __future__ import annotations

import numpy as np

N_FFT = 2048
HOP = 1024


def _hann(n: int) -> np.ndarray:
    # periodic hann, librosa's get_window("hann", n, fftbins=True)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def _stft_np(wave: np.ndarray, n_fft: int = N_FFT, hop: int = HOP) -> np.ndarray:
    """librosa.stft (center=True, constant pad).  (L,) -> (F, T) or
    (C, L) -> (C, F, T), complex64."""
    x = np.asarray(wave, np.float32)
    mono = x.ndim == 1
    if mono:
        x = x[None]
    pad = n_fft // 2
    x = np.pad(x, ((0, 0), (pad, pad)))
    n_frames = 1 + (x.shape[-1] - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = x[:, idx] * _hann(n_fft).astype(np.float32)
    z = np.fft.rfft(frames, axis=-1).astype(np.complex64).transpose(0, 2, 1)
    return z[0] if mono else z


def _istft_np(spec: np.ndarray, hop: int = HOP, length: int | None = None) -> np.ndarray:
    """librosa.istft (centered, squared-window normalization).  (F, T) ->
    (L,) or (C, F, T) -> (C, L), float32."""
    z = np.asarray(spec)
    mono = z.ndim == 2
    if mono:
        z = z[None]
    n_fft = 2 * (z.shape[1] - 1)
    win = _hann(n_fft)
    t = np.fft.irfft(z.transpose(0, 2, 1), n=n_fft, axis=-1) * win
    frames = t.shape[1]
    total = (frames - 1) * hop + n_fft
    idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
    y = np.zeros((t.shape[0], total), np.float64)
    np.add.at(y, (slice(None), idx), t)
    norm = np.zeros((total,), np.float64)
    np.add.at(norm, idx.reshape(-1), np.tile(win ** 2, (frames, 1)).reshape(-1))
    y = y / np.maximum(norm, 1e-11)
    pad = n_fft // 2
    y = y[:, pad:-pad]
    if length is not None:
        y = y[:, :length]
    y = y.astype(np.float32)
    return y[0] if mono else y


def normalize(wave: np.ndarray, max_peak: float = 1.0) -> np.ndarray:
    """Peak limit (spec_utils.py:66-70)."""
    maxv = np.abs(wave).max()
    if maxv > max_peak:
        wave = wave * (max_peak / maxv)
    return wave


def spectrogram_to_wave_no_mp(spec: np.ndarray, n_fft: int = N_FFT, hop_length: int = HOP,
                              length: int | None = None) -> np.ndarray:
    """(spec_utils.py:375-379)."""
    wave = _istft_np(spec, hop_length, length)
    if wave.ndim == 1:
        wave = np.asfortranarray([wave, wave])
    return wave


def wave_to_spectrogram_no_mp(wave: np.ndarray) -> np.ndarray:
    """(spec_utils.py:381-385)."""
    spec = _stft_np(wave, N_FFT, HOP)
    if spec.ndim == 1:
        spec = np.asfortranarray([spec, spec])
    return spec


def invert_audio(specs: list) -> np.ndarray:
    """Spectral inversion of a stem against the mixture, with the larger
    magnitude and the mixture's phase (spec_utils.py:387-399, invert_p)."""
    ln = min(specs[0].shape[2], specs[1].shape[2])
    mix, stem = specs[0][:, :, :ln], specs[1][:, :, :ln]
    x_mag, y_mag = np.abs(mix), np.abs(stem)
    return stem - np.where(x_mag >= y_mag, x_mag, y_mag) * np.exp(1.0j * np.angle(mix))


def invert_stem(mixture: np.ndarray, stem: np.ndarray) -> np.ndarray:
    """The secondary stem by spectral subtraction (spec_utils.py:401-402).
    mixture / stem: (C, L) waves -> (L, C) inverted wave."""
    v_spec = invert_audio([wave_to_spectrogram_no_mp(mixture), wave_to_spectrogram_no_mp(stem)])
    return -spectrogram_to_wave_no_mp(v_spec).T
