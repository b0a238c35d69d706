"""STFT phase-vocoder pitch/formant shifting (host-side, vectorized numpy).

A copy of `rvc_maker_tpu/utils/pitchshift.py`.

Behavioral equivalent of the reference's stftpitchshift
(main/library/algorithm/stftpitchshift.py): phase-vocoder
encode (instantaneous frequency) -> optional cepstral-envelope lifter for
formant preservation (quefrency in seconds) -> spectral resample pitch
shift -> phase re-accumulation decode -> weighted OLA.

Used by audio loading with formant_shifting=True (reference
library/utils.py:104-108) and by the audio-effects pipeline.  All
per-frame python loops of the reference are vectorized over the frame
axis (diff/cumsum for the phase chains).
"""

from __future__ import annotations

import numpy as np


def _hann_periodic(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


def _stft(x: np.ndarray, framesize: int, hopsize: int) -> np.ndarray:
    w = _hann_periodic(framesize)
    n_frames = 1 + (len(x) - framesize) // hopsize
    idx = np.arange(n_frames)[:, None] * hopsize + np.arange(framesize)[None, :]
    return np.fft.rfft(x[idx] * w, axis=-1, norm="forward")


def _istft(frames: np.ndarray, framesize: int, hopsize: int) -> np.ndarray:
    w = _hann_periodic(framesize)
    scale = w * hopsize / np.sum(w * w)
    frames = frames.copy()
    frames[:, 0] = 0
    frames[:, -1] = 0
    t = np.fft.irfft(frames, axis=-1, norm="forward") * scale
    n = frames.shape[0] * hopsize + framesize
    y = np.zeros(n)
    for i in range(t.shape[0]):          # overlap-add (small host loop)
        y[i * hopsize : i * hopsize + framesize] += t[i]
    return y


def _wrap(x):
    return (x + np.pi) % (2 * np.pi) - np.pi


def _encode(frames: np.ndarray, framesize: int, hopsize: int,
            samplerate: int) -> np.ndarray:
    """Complex STFT -> (magnitude + 1j * instantaneous frequency)."""
    m, n = frames.shape
    freqinc = samplerate / framesize
    phaseinc = 2 * np.pi * hopsize / framesize
    arg = np.angle(frames)
    delta = np.diff(np.vstack([np.zeros((1, n)), arg]), axis=0)
    i = np.arange(n)[None, :]
    freq = (i + _wrap(delta - i * phaseinc) / phaseinc) * freqinc
    return np.abs(frames) + 1j * freq


def _decode(frames: np.ndarray, framesize: int, hopsize: int,
            samplerate: int) -> np.ndarray:
    """(magnitude + 1j*frequency) -> complex STFT with re-accumulated phase."""
    m, n = frames.shape
    freqinc = samplerate / framesize
    phaseinc = 2 * np.pi * hopsize / framesize
    i = np.arange(n)[None, :]
    delta = (i + (frames.imag - i * freqinc) / freqinc) * phaseinc
    phase = np.cumsum(delta, axis=0)
    return frames.real * np.exp(1j * phase)


def _resample_rows(x: np.ndarray, factor: float) -> np.ndarray:
    """Linear spectral resample of each row by `factor`, zero-padded
    (reference `resample`, stftpitchshift.py:105-121)."""
    if factor == 1:
        return x.copy()
    n = x.shape[-1]
    m = int(n * factor)
    y = np.zeros_like(x)
    i = np.arange(min(n, m))
    k = i * (n / m)
    j = np.trunc(k).astype(int)
    k = k - j
    ok = (0 <= j) & (j < n - 1)
    y[..., i[ok]] = k[ok] * x[..., j[ok] + 1] + (1 - k[ok]) * x[..., j[ok]]
    return y


def _shiftpitch(frames: np.ndarray, factors, samplerate: int) -> np.ndarray:
    mags = np.stack([_resample_rows(frames.real, f) for f in factors])
    freqs = np.stack([_resample_rows(frames.imag, f) * f for f in factors])
    mags[(freqs <= 0) | (freqs >= samplerate / 2)] = 0
    best = np.argmax(mags, axis=0)
    mag = np.take_along_axis(mags, best[None], axis=0)[0]
    freq = np.take_along_axis(freqs, best[None], axis=0)[0]
    return mag + 1j * freq


def _lifter(frames: np.ndarray, quefrency: int) -> np.ndarray:
    """Cepstral low-pass spectral envelopes (stftpitchshift.py:88-103)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        logspec = np.log10(frames.real)
    ceps = np.fft.irfft(logspec, axis=-1, norm="forward")
    ceps[:, 1:quefrency] *= 2
    ceps[:, quefrency + 1:] = 0
    return np.power(10.0, np.real(np.fft.rfft(ceps, axis=-1, norm="forward")))


def shift_pitch(audio: np.ndarray, samplerate: int, *,
                factors=1.0, quefrency: float = 0.0,
                distortion: float = 1.0, framesize: int = 1024,
                hopsize: int = 256, normalization: bool = False) -> np.ndarray:
    """Pitch-shift `audio` by `factors` (scalar or list — max-magnitude
    wins per bin); quefrency>0 (seconds) preserves formants, and
    `distortion` scales the formant envelope (timbre shift)."""
    x = np.asarray(audio, np.float64)
    shape = x.shape
    x = np.squeeze(x)
    factors = np.atleast_1d(np.asarray(factors, float))
    q = int(quefrency * samplerate)

    frames = _encode(_stft(x, framesize, hopsize), framesize, hopsize,
                     samplerate)
    if normalization:
        frames0 = frames.copy()

    def notnormal(v):
        return np.isinf(v) | np.isnan(v) | (np.abs(v) < np.finfo(v.dtype).tiny)

    if q:
        env = _lifter(frames, q)
        bad = notnormal(env)
        real = frames.real / env
        real[bad] = 0
        frames = real + 1j * frames.imag
        if distortion != 1:
            env[bad] = 0
            env = _resample_rows(env, distortion)
            bad = notnormal(env)
        frames = _shiftpitch(frames, factors, samplerate)
        real = frames.real * env
        real[bad] = 0
        frames = real + 1j * frames.imag
    else:
        frames = _shiftpitch(frames, factors, samplerate)

    if normalization:
        a = np.sum(frames0.real ** 2, axis=-1)
        b = np.sum(frames.real ** 2, axis=-1)
        s = np.where(b > 0, np.sqrt(a / np.maximum(b, 1e-300)), 1.0)
        frames = frames.real * s[:, None] + 1j * frames.imag

    out = _istft(_decode(frames, framesize, hopsize, samplerate),
                 framesize, hopsize)
    out = np.resize(out, shape)
    return out.astype(np.float32)


def formant_shift(audio: np.ndarray, samplerate: int,
                  quefrency: float = 0.8, timbre: float = 0.8) -> np.ndarray:
    """The reference's load_audio(formant_shifting=True) call shape
    (library/utils.py:104-108): pitch factor 1, quefrency in ms-scale,
    distortion = timbre."""
    return shift_pitch(audio, samplerate, factors=1.0,
                       quefrency=quefrency * 1e-3, distortion=timbre)
