"""Spectral-gating noise reduction on the card (counterpart of
`rvc_maker_tpu/utils/noisereduce.py`, which runs it jitted in JAX; the
behaviour of the reference's vendored noisereduce,
main/tools/noisereduce.py).

Stationary mode: a per-frequency dB threshold, mean + 1.5 std (ddof 1)
of the noise clip's (or the signal's own) dB spectrum; non-stationary
mode: a temperature sigmoid of the magnitude's relative excess over its
moving average along time.  The mask is scaled by prop_decrease,
smoothed with a triangular (frequency x time) filter, applied to the
STFT and inverted.  The STFT is `torch.fft` on explicit frames, the
moving average and the smoothing are `F.conv1d` / `F.conv2d`, all on
the device the caller names.  Long audio goes in 600,000-sample chunks
zero-padded by 30,000 samples on each side on the host, as the
reference's streaming wrapper does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import full_fp32, resolve_device
from ..ops.stft import hann_window, istft, stft_complex


def _amp_to_db(x, top_db: float = 40.0):
    """20 log10(|x| + eps), floored at top_db under its max along the
    last axis."""
    x_db = 20.0 * torch.log10(x.abs() + torch.finfo(torch.float32).eps)
    return torch.maximum(x_db, x_db.amax(dim=-1, keepdim=True) - top_db)


def _smoothing_filter(n_grad_freq: int, n_grad_time: int) -> np.ndarray:
    """The (2 n_grad_freq + 1, 2 n_grad_time + 1) triangular filter,
    normalized to sum 1."""
    def tri(n):
        up = np.linspace(0, 1, n + 1, endpoint=False)
        down = np.linspace(1, 0, n + 2)
        return np.concatenate([up, down])[1:-1]

    f = np.outer(tri(n_grad_freq), tri(n_grad_time))
    return (f / f.sum()).astype(np.float32)


def _moving_mean(mag, m: int):
    """Mean over m frames along time of each (batch, bin) row of mag
    (B, T, F), aligned as numpy's convolve(mode="same"): output t averages
    frames t - m//2 .. t + (m-1)//2, zeros beyond the edges.  For an even
    m that is not F.conv1d's padding="same", which puts the extra frame
    on the other side."""
    b, t, f = mag.shape
    rows = F.pad(mag.transpose(1, 2).reshape(b * f, 1, t), (m // 2, (m - 1) // 2))
    kernel = torch.full((1, 1, m), 1.0 / m, device=mag.device, dtype=mag.dtype)
    return F.conv1d(rows, kernel).reshape(b, f, t).transpose(1, 2)


def _gate(x, xn, *, sr: int, stationary: bool, prop_decrease: float,
          n_std_thresh: float = 1.5, n_thresh_nonstat: float = 2.0,
          temp_coeff: float = 0.1, n_movemean: int = 20, n_fft: int = 1024,
          win_length: int = 1024, hop_length: int = 256,
          freq_mask_smooth_hz: int = 500, time_mask_smooth_ms: int = 50):
    """x: (B, L) fp32 tensor; xn: a noise clip (B, Ln) or None.  Returns
    the gated (B, L) on x's device."""
    win = hann_window(win_length)
    spec = dict(n_fft=n_fft, hop_length=hop_length, win_length=win_length, window=win)
    X = stft_complex(x, center=True, pad_mode="constant", **spec)          # (B, T, F)
    mag = X.abs()

    if stationary:
        ref = X if xn is None else stft_complex(xn, center=True, pad_mode="constant",
                                                **spec)
        ref_db = _amp_to_db(ref.transpose(1, 2))                            # (B, F, T)
        thresh = ref_db.mean(dim=-1) + ref_db.std(dim=-1, correction=1) * n_std_thresh
        sig_mask = (_amp_to_db(X.transpose(1, 2)).transpose(1, 2)
                    > thresh[:, None, :]).to(torch.float32)
    else:
        sm = _moving_mean(mag, n_movemean)
        ratio = (mag - sm) / torch.clamp(sm, min=1e-12)
        sig_mask = torch.sigmoid((ratio - n_thresh_nonstat) / temp_coeff)

    sig_mask = prop_decrease * (sig_mask - 1.0) + 1.0

    n_grad_freq = max(int(freq_mask_smooth_hz / (sr / (n_fft / 2))), 1)
    n_grad_time = max(int(time_mask_smooth_ms / (hop_length / sr * 1000)), 1)
    if n_grad_freq > 1 or n_grad_time > 1:
        filt = torch.as_tensor(_smoothing_filter(n_grad_freq, n_grad_time), device=x.device)
        kh, kw = filt.shape
        m = F.pad(sig_mask.transpose(1, 2)[:, None],                       # (B, 1, F, T)
                  ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
        sig_mask = F.conv2d(m, filt[None, None])[:, 0].transpose(1, 2)

    return istft(X * sig_mask, length=x.shape[1], **spec)


def reduce_noise(y: np.ndarray, sr: int, *, stationary: bool = False,
                 y_noise: np.ndarray | None = None, prop_decrease: float = 1.0,
                 time_constant_s: float = 2.0, chunk_size: int = 600000,
                 padding: int = 30000, n_fft: int = 1024,
                 device: str | torch.device = "cuda") -> np.ndarray:
    """Spectral-gate `y` ((L,) or (B, L), at `sr`) and return it as
    float32 numpy of the same shape (reference reduce_noise,
    noisereduce.py:199).  Runs on `device`, the card unless the caller
    passes "cpu"; a card that is not there raises.  On the card, fp32
    convolutions run without TF32 (`device.full_fp32`), and the caller's
    TF32 flags are as they were on return."""
    dev = resolve_device(device)
    flat = y.ndim == 1
    x = np.atleast_2d(np.asarray(y, np.float32))
    hop = n_fft // 4
    n_movemean = max(int(time_constant_s / hop * sr), 2)
    xn = None
    if y_noise is not None:
        xn = torch.as_tensor(np.atleast_2d(np.asarray(y_noise, np.float32)), device=dev)

    n = x.shape[1]
    out = np.zeros_like(x)
    with full_fp32(dev), torch.inference_mode():
        for start in range(0, n, chunk_size):
            end = min(start + chunk_size, n)
            # each chunk zero-padded by `padding` on both sides (the
            # reference's SpectralGate._read_chunk): the pad frames count
            # in the dB statistics
            buf = np.zeros((x.shape[0], end - start + 2 * padding), np.float32)
            lo, hi = max(start - padding, 0), min(end + padding, n)
            at = lo - (start - padding)
            buf[:, at:at + (hi - lo)] = x[:, lo:hi]
            # the moving mean never spans more frames than the chunk has
            # (JAX's convolve(mode="same") would return the kernel's length)
            n_frames = buf.shape[1] // hop + 1
            seg = _gate(torch.as_tensor(buf, device=dev), xn, sr=sr, stationary=stationary,
                        prop_decrease=float(prop_decrease),
                        n_movemean=min(n_movemean, n_frames), n_fft=n_fft,
                        win_length=n_fft, hop_length=hop)
            out[:, start:end] = seg[:, padding:padding + (end - start)].cpu().numpy()
    return out[0] if flat else out
