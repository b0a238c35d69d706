"""YIN pitch estimator on tensors, batched over frames (librosa.yin
numerics).

Counterpart of `rvc_maker_tpu/f0/yin.py` (reference convert.py:278-281
get_f0_yin): FFT autocorrelation -> difference function -> cumulative
mean normalization -> first trough below the threshold (else the global
minimum) with parabolic interpolation.  Every frame of every row runs at
once on the tensor's device.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.stft import frame_signal


def _parabolic_shifts(y):
    """Parabolic interpolation offsets of every interior lag, (..., tau);
    0 at both ends and wherever the fit is flat or the offset is not in
    (-1, 1)."""
    a = (y[..., 2:] + y[..., :-2] - 2 * y[..., 1:-1]) / 2.0
    b = (y[..., 2:] - y[..., :-2]) / 2.0
    shift = torch.where(a.abs() > 1e-12, -b / (2.0 * a), 0.0)
    shift = torch.where(shift.abs() < 1.0, shift, 0.0)
    return F.pad(shift, (1, 1))


def yin(audio, *, sr: int = 16000, fmin: float = 50.0, fmax: float = 1100.0,
        frame_length: int = 2048, hop_length: int = 160,
        trough_threshold: float = 0.1):
    """audio: (B, L), L > frame_length // 2 -> f0 (B, L // hop + 1) in Hz
    (always voiced, as librosa.yin; callers gate as the reference does)."""
    win_length = frame_length // 2
    min_period = max(int(sr / fmax), 1)
    max_period = min(math.ceil(sr / fmin), win_length - 1)

    pad = frame_length // 2
    y = F.pad(audio.to(torch.float32)[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = frame_signal(y, frame_length, hop_length)          # (B, T, W)

    # autocorrelation over lags 0..win_length through the FFT: the frame
    # against its first half reversed
    a = torch.fft.rfft(frames, frame_length, dim=-1)
    b = torch.fft.rfft(torch.flip(frames[..., 1 : win_length + 1], dims=(-1,)),
                       frame_length, dim=-1)
    acf = torch.fft.irfft(a * b, frame_length, dim=-1)[..., win_length:]
    acf = torch.where(acf.abs() < 1e-6, 0.0, acf)

    e = torch.cumsum(frames.square(), dim=-1)
    energy = e[..., win_length:] - F.pad(e[..., : -win_length - 1], (1, 0))
    energy = torch.where(energy.abs() < 1e-6, 0.0, energy)

    d = energy[..., :1] + energy - 2.0 * acf                     # d(tau)
    tau_range = torch.arange(1, d.shape[-1], device=d.device, dtype=d.dtype)
    cmean = torch.cumsum(d[..., 1:], dim=-1) / tau_range
    cmndf = d[..., min_period : max_period + 1] / (
        cmean[..., min_period - 1 : max_period] + 1e-20)

    shifts = _parabolic_shifts(cmndf)
    is_trough = F.pad((cmndf[..., 1:-1] < cmndf[..., :-2])
                      & (cmndf[..., 1:-1] <= cmndf[..., 2:]), (1, 1))
    is_trough[..., 0] = cmndf[..., 0] < cmndf[..., 1]
    below = is_trough & (cmndf < trough_threshold)
    first_below = torch.argmax(below.to(torch.int32), dim=-1)    # first True
    global_min = torch.argmin(cmndf, dim=-1)
    tau_idx = torch.where(below.any(dim=-1), first_below, global_min)

    shift = torch.gather(shifts, -1, tau_idx[..., None])[..., 0]
    return sr / (min_period + tau_idx + shift)
