"""CREPE pitch estimator in PyTorch (five capacities) with its Viterbi
decode on the host.

Counterpart of `rvc_maker_tpu/models/crepe.py` (reference
main/library/predictors/CREPE.py): 1024-sample frames at 16 kHz, each
normalized by its mean and (Bessel-corrected) std; 6 conv layers (conv ->
ReLU -> BatchNorm -> maxpool 2), a linear classifier and a sigmoid over
360 pitch bins.  The conv stack runs on the device over every frame of a
row at once; the Viterbi decode is sequential and runs on the host in
numpy, as in the JAX package.  BatchNorm is folded at import (eps 1e-3,
the reference's).

The reference adds triangular dither in bins_to_frequency (CREPE.py:
117-119); here dither is an explicit argument (None = off).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

Params = Any

CENTS_PER_BIN = 20.0
PITCH_BINS = 360
SAMPLE_RATE = 16000
WINDOW_SIZE = 1024

# capacity -> (in channels, out channels, classifier in-features)
CAPACITIES = {
    "full": ([1, 1024, 128, 128, 128, 256], [1024, 128, 128, 128, 256, 512], 2048),
    "large": ([1, 768, 96, 96, 96, 192], [768, 96, 96, 96, 192, 384], 1536),
    "medium": ([1, 512, 64, 64, 64, 128], [512, 64, 64, 64, 128, 256], 1024),
    "small": ([1, 256, 32, 32, 32, 64], [256, 32, 32, 32, 64, 128], 512),
    "tiny": ([1, 128, 16, 16, 16, 32], [128, 16, 16, 16, 32, 64], 256),
}
KERNELS = [512] + [64] * 5
STRIDES = [4] + [1] * 5
PADS = [(254, 254)] + [(31, 32)] * 5


def frame_audio(audio, hop_length: int):
    """(B, L) 16 kHz -> normalized frames (B, 1 + L // hop, 1024): center
    zero pad 512, each frame minus its mean over its std (ddof = 1,
    floored at 1e-10), as the reference's preprocess (CREPE.py:148-168)."""
    x = F.pad(audio.to(torch.float32), (WINDOW_SIZE // 2, WINDOW_SIZE // 2))
    frames = x.unfold(-1, WINDOW_SIZE, hop_length)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    std = frames.std(dim=-1, keepdim=True, correction=1)
    return frames / torch.clamp(std, min=1e-10)


def crepe_apply(p: Params, frames):
    """frames: (N, 1024) normalized -> sigmoid probabilities (N, 360)."""
    x = frames[:, None, :]
    for i in range(6):
        x = F.conv1d(F.pad(x, PADS[i]), p["convs"][i]["w"], p["convs"][i]["b"],
                     stride=STRIDES[i])
        x = torch.relu(x) * p["bns"][i]["scale"][:, None] + p["bns"][i]["shift"][:, None]
        x = F.max_pool1d(x, 2, 2)
    # the classifier reads the features time-major, (T, C) flattened
    x = x.transpose(1, 2).reshape(x.shape[0], -1)
    return torch.sigmoid(F.linear(x, p["classifier"]["w"], p["classifier"]["b"]))


def predict_probs(p: Params, audio, hop_length: int = 160):
    """(B, L) -> (B, 1 + L // hop, 360) pitch-bin probabilities."""
    frames = frame_audio(audio, hop_length)
    b, t, _ = frames.shape
    return crepe_apply(p, frames.reshape(b * t, WINDOW_SIZE)).reshape(b, t, PITCH_BINS)


# ---------------------------------------------------------------------------
# decode (host numpy; Viterbi is sequential)
# ---------------------------------------------------------------------------

def _transition_matrix() -> np.ndarray:
    xx, yy = np.meshgrid(np.arange(PITCH_BINS), np.arange(PITCH_BINS))
    tr = np.maximum(12 - np.abs(xx - yy), 0).astype(np.float64)
    return tr / tr.sum(axis=1, keepdims=True)


_LOG_TRANSITION = None


def viterbi_decode(probs: np.ndarray) -> np.ndarray:
    """probs: (T, 360) observation probabilities -> bin path (T,) int64,
    a log-space Viterbi with the triangular transition prior (reference
    CREPE.py:71-81 through librosa.sequence.viterbi)."""
    global _LOG_TRANSITION
    if _LOG_TRANSITION is None:
        _LOG_TRANSITION = np.log(_transition_matrix() + 1e-300)
    log_obs = np.log(np.maximum(probs.astype(np.float64), 1e-300))
    t_len = probs.shape[0]
    score = np.full((PITCH_BINS,), -np.log(PITCH_BINS)) + log_obs[0]
    back = np.zeros((t_len, PITCH_BINS), np.int64)
    for t in range(1, t_len):
        cand = score[:, None] + _LOG_TRANSITION           # (from, to)
        back[t] = np.argmax(cand, axis=0)
        score = cand[back[t], np.arange(PITCH_BINS)] + log_obs[t]
    path = np.zeros((t_len,), np.int64)
    path[-1] = int(np.argmax(score))
    for t in range(t_len - 2, -1, -1):
        path[t] = back[t + 1, path[t + 1]]
    return path


def bins_to_frequency(bins, dither: np.ndarray | None = None):
    """cents = 20 * bin + 1997.379...; f0 = 10 * 2^(cents / 1200)."""
    cents = CENTS_PER_BIN * np.asarray(bins, np.float64) + 1997.3794084376191
    if dither is not None:
        cents = cents + dither
    return 10.0 * 2.0 ** (cents / 1200.0)


def frequency_to_bins(freq, quantize=np.floor):
    return quantize(((1200 * np.log2(np.asarray(freq) / 10.0))
                     - 1997.3794084376191) / CENTS_PER_BIN).astype(np.int64)


def decode(probs: np.ndarray, fmin: float = 50.0, fmax: float = 2006.0,
           return_periodicity: bool = False, dither_rng=None):
    """probs: (B, T, 360) from predict_probs, as numpy.  Masks the bins
    outside [fmin, fmax], re-softmaxes over bins, then Viterbi (reference
    postprocess, CREPE.py:137-146)."""
    probs = np.array(probs, np.float32)
    lo = int(frequency_to_bins(fmin))
    hi = int(frequency_to_bins(fmax, np.ceil))
    masked = probs.copy()
    masked[..., :lo] = -np.inf
    masked[..., hi:] = -np.inf
    e = np.exp(masked - masked.max(axis=-1, keepdims=True))
    obs = e / e.sum(axis=-1, keepdims=True)
    bins = np.stack([viterbi_decode(obs[i]) for i in range(obs.shape[0])])
    dither = (None if dither_rng is None else
              dither_rng.triangular(-CENTS_PER_BIN, 0, CENTS_PER_BIN, size=bins.shape))
    pitch = bins_to_frequency(bins, dither).astype(np.float32)
    if not return_periodicity:
        return pitch
    return pitch, np.take_along_axis(probs, bins[..., None], axis=-1)[..., 0]


def mean_filter(signal: np.ndarray, win: int = 3) -> np.ndarray:
    """NaN-aware moving average (reference CREPE.py:176-187)."""
    out = np.empty_like(signal)
    half = win // 2
    for b in range(signal.shape[0]):
        s = signal[b]
        for i in range(len(s)):
            w = s[max(0, i - half) : i + half + 1]
            valid = w[~np.isnan(w)]
            out[b, i] = valid.mean() if len(valid) else np.nan
    return out


def median_filter(signal: np.ndarray, win: int) -> np.ndarray:
    """NaN-aware moving median with reflect padding (CREPE.py:189-209)."""
    half = win // 2
    out = np.empty_like(signal)
    for b in range(signal.shape[0]):
        s = np.pad(signal[b], (half, half), mode="reflect")
        m = np.pad(~np.isnan(signal[b]), (half, half), constant_values=False)
        for i in range(signal.shape[1]):
            w = s[i : i + win][m[i : i + win]]
            out[b, i] = np.median(w) if len(w) else np.nan
    return out


# ---------------------------------------------------------------------------
# reference checkpoint import (crepe_{capacity}.pth)
# ---------------------------------------------------------------------------

def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).contiguous()


def params_from_state_dict(sd, capacity: str = "full") -> Params:
    """A reference Crepe state dict -> the port's tree: conv weights
    (Cout, Cin, K, 1) -> (Cout, Cin, K), each BatchNorm folded into a
    per-channel scale and shift.  A state dict whose widths are not
    `capacity`'s raises."""
    widths = [int(sd[f"conv{i}.weight"].shape[0]) for i in range(1, 7)]
    if widths != CAPACITIES[capacity][1]:
        raise ValueError(f"CREPE weights of widths {widths} are not capacity {capacity!r}'s "
                         f"{CAPACITIES[capacity][1]}")
    eps = 0.0010000000474974513                # reference CREPE.py:38
    p: dict = {"convs": [], "bns": []}
    for i in range(1, 7):
        p["convs"].append({"w": _f32(sd[f"conv{i}.weight"])[:, :, :, 0].contiguous(),
                           "b": _f32(sd[f"conv{i}.bias"])})
        gamma, beta = _f32(sd[f"conv{i}_BN.weight"]), _f32(sd[f"conv{i}_BN.bias"])
        mean, var = _f32(sd[f"conv{i}_BN.running_mean"]), _f32(sd[f"conv{i}_BN.running_var"])
        scale = gamma / torch.sqrt(var + eps)
        p["bns"].append({"scale": scale, "shift": beta - mean * scale})
    p["classifier"] = {"w": _f32(sd["classifier.weight"]), "b": _f32(sd["classifier.bias"])}
    return p


def load_crepe_pth(path: str, capacity: str = "full") -> Params:
    sd = torch.load(path, map_location="cpu", weights_only=False)
    return params_from_state_dict(sd, capacity)
