"""STFT and its inverse, the RMVPE mel front end and the training spectrograms
(counterpart of `rvc_maker_tpu/ops/stft.py`; reference RMVPE.py:146-181,
train.py:700-716).

The mel filterbank reproduces librosa.filters.mel numerics (triangular
filters, slaney area norm) from the published formulas.  The STFT runs
in fp32 (float64 input stays float64) on explicit frames through
torch.fft.rfft.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window, as torch.hann_window(periodic=True)."""
    n = np.arange(win_length)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))).astype(np.float32)


def _hz_to_mel(f, htk: bool):
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def _mel_to_hz(m, htk: bool):
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_sp = 200.0 / 3
    freqs = f_sp * m
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=32)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, htk: bool = False) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) float32, librosa.filters.mel(norm='slaney')."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_min = _hz_to_mel(fmin, htk)
    mel_max = _hz_to_mel(fmax, htk)
    mel_f = _mel_to_hz(np.linspace(mel_min, mel_max, n_mels + 2), htk)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels])
    weights = weights * enorm[:, None]
    return weights.astype(np.float32)


def frame_signal(y, n_fft: int, hop_length: int):
    """(B, L) -> (B, n_frames, n_fft), frame t starting at t * hop_length,
    n_frames = 1 + (L - n_fft) // hop_length (a view, no copy)."""
    return y.unfold(-1, n_fft, hop_length)


def _padded_window(window, win_length: int, n_fft: int, like: torch.Tensor) -> torch.Tensor:
    """The (win_length,) window zero-padded to n_fft centered, as torch
    does, on `like`'s device in its real dtype."""
    win = np.asarray(window, np.float32)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = np.pad(win, (lpad, n_fft - win_length - lpad))
    real = like.real.dtype if like.is_complex() else like.dtype
    return torch.as_tensor(win, device=like.device, dtype=real)


def stft_complex(y, *, n_fft: int, hop_length: int, win_length: int, window,
                 center: bool = True, pad_mode: str = "reflect"):
    """Complex STFT as torch.stft(..., return_complex=True), on explicit
    frames (JAX `ops/stft.py` `stft_complex`).  y: (B, L) real ->
    (B, n_frames, n_fft//2 + 1) complex of y's precision; center pads
    n_fft//2 on both sides with `pad_mode` ("reflect" or "constant")."""
    if center:
        p = n_fft // 2
        y = F.pad(y[:, None], (p, p), mode=pad_mode)[:, 0]
    frames = frame_signal(y, n_fft, hop_length) * _padded_window(window, win_length, n_fft, y)
    return torch.fft.rfft(frames, n=n_fft, dim=-1)


def stft_magnitude(y, *, n_fft: int, hop_length: int, win_length: int,
                   window, center: bool = False, eps: float = 0.0):
    """|STFT| as torch.stft(onesided, return_complex).abs(), computed as
    sqrt(re^2 + im^2 + eps).

    y: (B, L); window: (win_length,) numpy, zero-padded to n_fft
    centered.  center=True reflect-pads n_fft//2 on both sides.
    Returns (B, n_frames, n_fft//2 + 1) fp32, float64 for float64 y."""
    y = y.to(torch.promote_types(y.dtype, torch.float32))
    spec = stft_complex(y, n_fft=n_fft, hop_length=hop_length, win_length=win_length,
                        window=window, center=center)
    return torch.sqrt(spec.real.square() + spec.imag.square() + eps)


def istft(spec, *, n_fft: int, hop_length: int, win_length: int, window,
          length: int):
    """Inverse STFT (JAX `ops/stft.py` `istft`): irfft, window, overlap-add,
    then division by the overlap-added squared window wherever it is
    above 1e-11 (by 1e-11 elsewhere, where torch.istft would raise).
    spec: (B, T, n_fft//2 + 1) complex of a centered STFT -> (B, length):
    n_fft//2 trimmed at the start, then zero-padded or cut to `length`.
    The overlap-add is F.fold, which sums each output sample's frames in
    one thread on the card (no atomics), so a run repeats bit for bit.
    The spectrum is read as Hermitian: the imaginary parts of its DC and
    Nyquist bins are dropped, as the CPU's irfft drops them (cuFFT's
    inverse would read them, and a model's output spectrum has them)."""
    win = _padded_window(window, win_length, n_fft, spec)
    ri = torch.view_as_real(spec).clone()
    ri[..., 0, 1] = 0.0
    if n_fft % 2 == 0 and spec.shape[-1] > n_fft // 2:
        ri[..., n_fft // 2, 1] = 0.0
    frames = torch.fft.irfft(torch.view_as_complex(ri), n=n_fft, dim=-1) * win   # (B, T, n_fft)
    t = frames.shape[1]
    total = (t - 1) * hop_length + n_fft

    def overlap_add(cols):                                          # (N, n_fft, T)
        return F.fold(cols, (1, total), (1, n_fft), stride=(1, hop_length))[:, 0, 0]

    y = overlap_add(frames.transpose(1, 2))
    norm = overlap_add(win.square()[None, :, None].expand(1, n_fft, t))
    y = y / torch.clamp(norm, min=1e-11)
    y = y[:, n_fft // 2:]
    if y.shape[1] < length:
        return F.pad(y, (0, length - y.shape[1]))
    return y[:, :length]


def spectrogram(y, *, n_fft: int, hop_length: int, win_length: int):
    """Training linear spectrogram (reference train.py:700-706).

    y: (B, L).  Reflect-pads (n_fft - hop) / 2 on both sides, center=False,
    eps 1e-6.  Returns (B, L // hop, n_fft//2 + 1) when hop divides L."""
    p = int((n_fft - hop_length) / 2)
    y = y.to(torch.promote_types(y.dtype, torch.float32))
    y = F.pad(y[:, None], (p, p), mode="reflect")[:, 0]
    return stft_magnitude(y, n_fft=n_fft, hop_length=hop_length,
                          win_length=win_length, window=hann_window(win_length),
                          center=False, eps=1e-6)


def spec_to_mel(spec, *, n_fft: int, n_mels: int, sample_rate: int,
                fmin: float, fmax: float | None):
    """(B, T, n_fft//2 + 1) -> (B, T, n_mels) log-mel (slaney filters;
    reference train.py:708-713)."""
    basis = torch.as_tensor(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax,
                                           htk=False), device=spec.device, dtype=spec.dtype)
    mel = torch.matmul(spec, basis.T)
    return torch.log(torch.clamp(mel, min=1e-5))


def mel_spectrogram(y, *, n_fft: int, num_mels: int, sample_rate: int,
                    hop_length: int, win_length: int, fmin: float,
                    fmax: float | None):
    """Log-mel of a waveform (reference mel_spectrogram_torch, train.py:715)."""
    spec = spectrogram(y, n_fft=n_fft, hop_length=hop_length,
                       win_length=win_length)
    return spec_to_mel(spec, n_fft=n_fft, n_mels=num_mels,
                       sample_rate=sample_rate, fmin=fmin, fmax=fmax)


def rmvpe_mel(audio_16k, *, n_mels: int = 128, n_fft: int = 1024,
              hop_length: int = 160, win_length: int = 1024,
              fmin: float = 30.0, fmax: float = 8000.0):
    """RMVPE log-mel (htk, center=True).  audio_16k: (B, L) at 16 kHz.
    Returns (B, n_mels, T), the reference's (mel, time) orientation."""
    mag = stft_magnitude(audio_16k, n_fft=n_fft, hop_length=hop_length,
                         win_length=win_length, window=hann_window(win_length),
                         center=True)
    basis = torch.as_tensor(mel_filterbank(16000, n_fft, n_mels, fmin, fmax,
                                           htk=True), device=mag.device, dtype=mag.dtype)
    mel = torch.matmul(mag, basis.T)                    # (B, T, n_mels)
    mel = torch.log(torch.clamp(mel, min=1e-5))
    return mel.transpose(1, 2)
