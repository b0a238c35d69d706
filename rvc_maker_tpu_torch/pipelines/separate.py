"""Source separation with Demucs: the chunked apply and the vocal /
instrumental split (counterpart of JAX `pipelines/separate.py`).

Reference: demucs/apply.py:112-219 (shift averaging, the triangular
overlap-add over segment windows, a bag of models' per-source weights).
Each window runs `models/demucs.py` `apply_model_single` on the device
the parameters live on (fp32, TF32 off on the card); the overlap-add
runs in float64 on the host, as JAX's does, and the shifts are drawn
from `np.random.RandomState(0)` in JAX's order.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..device import full_fp32
from ..models import demucs as demucs_mod


def _triangle_weight(segment: int, transition_power: float = 1.0) -> np.ndarray:
    w = np.concatenate([np.arange(1, segment // 2 + 1),
                        np.arange(segment - segment // 2, 0, -1)]).astype(np.float64)
    return (w / w.max()) ** transition_power


def apply_model(params: Any, cfg: demucs_mod.DemucsConfig, mix: np.ndarray, *,
                shifts: int = 1, overlap: float = 0.25, transition_power: float = 1.0,
                rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """mix: (B, C, L) float32 -> (B, S, C, L) float32: the mean over
    `shifts` random shifts of the mix (up to half a second), each the
    triangular overlap-add of `segment`-long windows (reference
    apply_model)."""
    if rng is None:
        rng = np.random.RandomState(0)
    b, c, length = mix.shape

    if shifts and shifts > 0:
        max_shift = int(0.5 * cfg.samplerate)
        padded = np.pad(mix, ((0, 0), (0, 0), (max_shift, max_shift)))
        out = None
        for _ in range(shifts):
            offset = rng.randint(0, max_shift + 1)
            shifted = padded[..., offset:offset + length + max_shift]
            so = apply_model(params, cfg, shifted, shifts=0, overlap=overlap,
                             transition_power=transition_power)
            so = so[..., max_shift - offset:max_shift - offset + length]
            out = so if out is None else out + so
        return out / shifts

    segment = int(cfg.samplerate * cfg.segment)
    stride = int((1 - overlap) * segment)
    weight = _triangle_weight(segment, transition_power)
    out = np.zeros((b, len(cfg.sources), c, length), np.float64)
    sum_weight = np.zeros(length, np.float64)
    dev = demucs_mod.params_device(params)
    with full_fp32(dev), torch.inference_mode():
        for offset in range(0, length, stride):
            chunk = mix[..., offset:offset + segment]
            pad_right = segment - chunk.shape[-1]
            if pad_right:
                chunk = np.pad(chunk, ((0, 0), (0, 0), (0, pad_right)))
            x = torch.as_tensor(np.ascontiguousarray(chunk, np.float32), device=dev)
            res = demucs_mod.apply_model_single(params, cfg, x).cpu().numpy()
            res = res[..., :min(segment, length - offset)]
            n = res.shape[-1]
            out[..., offset:offset + n] += weight[:n] * res
            sum_weight[offset:offset + n] += weight[:n]
    return (out / sum_weight).astype(np.float32)


def apply_bag(bag: Sequence[tuple[Any, demucs_mod.DemucsConfig, Sequence[float]]],
              mix: np.ndarray, **kw) -> np.ndarray:
    """A bag of models with per-source weights (reference BagOfModels)."""
    n_src = len(bag[0][1].sources)
    totals = np.zeros(n_src)
    estimate = None
    for params, cfg, weights in bag:
        o = apply_model(params, cfg, mix, **kw)
        for k, w in enumerate(weights):
            o[:, k] *= w
            totals[k] += w
        estimate = o if estimate is None else estimate + o
    for k in range(n_src):
        estimate[:, k] /= totals[k]
    return estimate


def separate_vocals(params: Any, cfg: demucs_mod.DemucsConfig, audio: np.ndarray, sr: int, *,
                    invert_using_spec: bool = False, **kw):
    """audio: (L,) or (L, 2) at any rate -> (vocals, instrumental), each
    (L', 2) float32 at cfg.samplerate.  The instrumental is the sum of
    the other stems, or with invert_using_spec the mixture's spectral
    subtraction of the vocals (reference common_separator.py
    spec_utils.invert_stem)."""
    from ..utils.audio import resample

    if audio.ndim == 1:
        audio = np.stack([audio, audio], axis=1)
    if sr != cfg.samplerate:
        audio = np.stack([resample(audio[:, 0], sr, cfg.samplerate),
                          resample(audio[:, 1], sr, cfg.samplerate)], axis=1)
    mix = audio.T[None]                                     # (1, 2, L)
    ref_std = mix.std() + 1e-8
    ref_mean = mix.mean()
    stems = apply_model(params, cfg, ((mix - ref_mean) / ref_std).astype(np.float32), **kw)
    stems = stems * ref_std + ref_mean
    v_idx = cfg.sources.index("vocals")
    vocals = stems[0, v_idx].T
    if invert_using_spec:
        from .spec_tools import invert_stem

        inst = invert_stem(audio.T.astype(np.float64), stems[0, v_idx].astype(np.float64),
                           device=demucs_mod.params_device(params))
        inst = inst[:len(audio)]
    else:
        inst = sum(stems[0, k] for k in range(len(cfg.sources)) if k != v_idx).T
    return vocals.astype(np.float32), inst.astype(np.float32)
