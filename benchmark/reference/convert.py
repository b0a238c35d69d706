"""Voice conversion of the reference, step by step in plain PyTorch: the
port's `pipelines/convert.py` `convert_batch` (RMVPE f0, HuBERT layer 12,
the retrieval blend, the x2 frame repeat, protect, the synthesizer) and
`convert_utterance`'s chunking (the 48 Hz high-pass, the low-energy split
points, the reflect pads, the trims and the peak limit), written anew
from the reference toolkit's pipeline (convert.py:388-458).
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch
from scipy import signal as sp_signal

from . import hubert, rmvpe, synthesizer

SAMPLE_RATE = 16000
WINDOW = 160
F0_MIN, F0_MAX = 50.0, 1100.0
F0_MEL_MIN = 1127.0 * math.log(1.0 + F0_MIN / 700.0)
F0_MEL_MAX = 1127.0 * math.log(1.0 + F0_MAX / 700.0)
_BH, _AH = sp_signal.butter(N=5, Wn=48, btype="high", fs=SAMPLE_RATE)


def model_cfg(model: dict) -> SimpleNamespace:
    """A configuration file's "model" group as the attribute object the
    reference's synthesizer reads."""
    cfg = SimpleNamespace(**{k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
                             if isinstance(v, list) else v for k, v in model.items()})
    cfg.upp = math.prod(cfg.upsample_rates)
    return cfg


def coarse_f0(f0):
    """Hz -> 1..255 mel-bin codes (reference convert.py:168-179)."""
    f0_mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    scaled = (f0_mel - F0_MEL_MIN) * 254.0 / (F0_MEL_MAX - F0_MEL_MIN) + 1.0
    f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
    return torch.round(torch.clamp(f0_mel, 1.0, 255.0)).to(torch.int64)


def retrieval_blend(feats, vectors, rate: float, k: int = 8):
    """The 8 nearest index rows by squared L2, weighted by 1 / d^4 and
    normalised, blended into the features at `rate`."""
    q2 = feats.square().sum(dim=-1, keepdim=True)
    d2 = q2 - 2.0 * torch.matmul(feats, vectors.T) + vectors.square().sum(dim=-1)
    neg, idx = torch.topk(-d2, k, dim=-1)
    w = 1.0 / torch.clamp(-neg, min=1e-12).square()
    w = w / w.sum(dim=-1, keepdim=True)
    blended = (vectors[idx] * w[..., None]).sum(dim=-2)
    return blended * rate + feats * (1.0 - rate)


def hubert_frames(n_samples: int) -> int:
    fl = n_samples
    for _, k, s in hubert.CONV_LAYERS:
        fl = (fl - k) // s + 1
    return fl


def frames(n_samples: int) -> int:
    """Synthesizer frames of a bucket of n_samples."""
    return min(n_samples // WINDOW, 2 * hubert_frames(n_samples))


def f0(models: dict, audio):
    """RMVPE f0 (B, L // 160 + 1) Hz of (B, L) 16 kHz audio."""
    return rmvpe.infer(models["rmvpe"], audio)


def features(models: dict, audio, lengths, index_rate: float):
    """(blended, plain) HuBERT layer-12 features, each repeated x2 in time."""
    feats, _ = hubert.extract_features(models["hubert"], audio, lengths, output_layer=12)
    feats0 = feats
    if index_rate > 0:
        feats = retrieval_blend(feats, models["index"], index_rate)
    return torch.repeat_interleave(feats, 2, dim=1), torch.repeat_interleave(feats0, 2, dim=1)


def synth(models: dict, cfg, feats, feats0, pitchf, lengths, sid: int, protect: float,
          z_noise, sine):
    """The waveform (B, p_len * upp) on the features and the given pitch."""
    p_len = pitchf.shape[1]
    feats, feats0 = feats[:, :p_len], feats0[:, :p_len]
    if protect < 0.5:
        w = torch.where(pitchf > 0, 1.0, protect)[:, :, None]
        feats = feats * w + feats0 * (1.0 - w)
    frame_lengths = torch.clamp(torch.div(lengths, WINDOW, rounding_mode="floor"), max=p_len)
    sid_t = torch.full((feats.shape[0],), sid, dtype=torch.int64, device=feats.device)
    wav = synthesizer.infer(models["synth"], cfg, feats, frame_lengths, coarse_f0(pitchf),
                            pitchf, sid_t, z_noise, {"sine": sine})
    return wav[:, :, 0]


def convert_rows(models: dict, cfg, audio, lengths, *, sid: int, index_rate: float,
                 protect: float, z_noise, sine, pitchf=None):
    """(waveform, pitchf, the reference's own f0) of one batch.  The
    synthesizer runs on `pitchf` when given (the program's, to judge its
    waveform apart from RMVPE's run-to-run wobble), else on the
    reference's own f0."""
    ref_f0 = f0(models, audio)
    feats, feats0 = features(models, audio, lengths, index_rate)
    p_len = min(audio.shape[1] // WINDOW, feats.shape[1])
    own = ref_f0[:, :p_len]
    use = own if pitchf is None else pitchf[:, :p_len]
    wav = synth(models, cfg, feats, feats0, use, lengths, sid, protect, z_noise, sine)
    return wav, use, own


# ---------------------------------------------------------------------------
# one utterance: the chunking of `convert_utterance`
# ---------------------------------------------------------------------------

def bucket_length(n: int, bucket: int = SAMPLE_RATE) -> int:
    return int(math.ceil(max(n, bucket) / bucket)) * bucket


def chunks(audio16k: np.ndarray, *, x_pad: int, x_query: int, x_center: int, x_max: int):
    """(the high-passed audio, [(padded chunk (1, L), valid length)]): the
    split at the quietest sample near every x_center seconds, each chunk
    with x_pad seconds of reflected context on both sides."""
    t_pad = SAMPLE_RATE * x_pad
    t_query, t_center, t_max = (SAMPLE_RATE * x for x in (x_query, x_center, x_max))
    audio = sp_signal.filtfilt(_BH, _AH, audio16k).astype(np.float32)
    opt_ts = []
    audio_pad = np.pad(audio, (WINDOW // 2, WINDOW // 2), mode="reflect")
    if audio_pad.shape[0] > t_max:
        audio_sum = np.zeros_like(audio)
        for i in range(WINDOW):
            audio_sum += audio_pad[i: i - WINDOW]
        for t in range(t_center, audio.shape[0], t_center):
            w = np.abs(audio_sum[t - t_query: t + t_query])
            opt_ts.append(t - t_query + int(np.where(w == w.min())[0][0]))
    audio_pad = np.pad(audio, (t_pad, t_pad), mode="reflect")
    bounds, start, cur = [], 0, None
    for t in opt_ts:
        cur = t // WINDOW * WINDOW
        bounds.append((start, cur + 2 * t_pad + WINDOW))
        start = cur
    bounds.append((start if cur is not None else 0, audio_pad.shape[0]))
    out = []
    for lo, hi in bounds:
        chunk = audio_pad[lo:hi]
        padded = np.zeros((1, bucket_length(len(chunk))), np.float32)
        padded[0, :len(chunk)] = chunk
        out.append((padded, len(chunk)))
    return audio, out


def assemble(pieces: list, upp: int, sr: int, x_pad: int) -> np.ndarray:
    """[(chunk waveform, chunk's valid input length)] -> the utterance:
    each chunk cut to its valid output, its x_pad context trimmed, then
    scaled down if its peak passes 0.99."""
    t_pad_tgt = sr * x_pad
    parts = []
    for wav, n_in in pieces:
        n_out = min((n_in // WINDOW) * upp, wav.shape[0])
        parts.append(wav[:n_out][t_pad_tgt:-t_pad_tgt] if n_out > 2 * t_pad_tgt
                     else wav[:n_out])
    out = np.concatenate(parts) if len(parts) > 1 else parts[0]
    peak = np.abs(out).max() / 0.99
    if peak > 1:
        out = out / peak
    return out.astype(np.float32)
