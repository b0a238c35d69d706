"""Praat-style autocorrelation pitch estimation ("pm" method).

The reference's `pm` F0 method calls parselmouth (Praat bindings)
`Sound.to_pitch_ac(time_step=0.01, voicing_threshold=0.6,
pitch_floor=50, pitch_ceiling=1100)` (reference convert.py:206-213).
parselmouth is not in this image; this is a from-scratch numpy
implementation of Boersma's (1993) AC method: per-frame normalized
autocorrelation (divided by the window's autocorrelation), candidate
peaks with parabolic interpolation, octave-cost weighting, and a
Viterbi path over voiced/unvoiced candidate sequences with
octave-jump / voicing-transition costs (Praat default cost constants).

A copy of `rvc_maker_tpu/f0/praat_ac.py` (the port imports nothing of
the JAX package); the port's tests hold the two equal on the same input.
"""

from __future__ import annotations

import numpy as np

# Praat defaults (Boersma 1993 / praat manual "Sound: To Pitch (ac)...")
SILENCE_THRESHOLD = 0.03
OCTAVE_COST = 0.01
OCTAVE_JUMP_COST = 0.35
VOICED_UNVOICED_COST = 0.14
MAX_CANDIDATES = 15


def praat_ac(x: np.ndarray, fs: int, *, time_step: float = 0.01,
             f0_floor: float = 50.0, f0_ceil: float = 1100.0,
             voicing_threshold: float = 0.6) -> np.ndarray:
    """x: (L,) mono audio -> f0 per frame (Hz, 0 = unvoiced).

    Frame centers every time_step seconds; window = 3 periods of
    f0_floor (Praat's AC window length)."""
    x = np.asarray(x, np.float64)
    global_peak = np.max(np.abs(x)) + 1e-12

    win_sec = 3.0 / f0_floor
    win_len = int(round(win_sec * fs))
    if win_len % 2 == 1:
        win_len += 1
    half = win_len // 2
    hop = int(round(time_step * fs))
    n_frames = max(int(np.floor((len(x)) / hop)) + 1, 1)

    window = np.hanning(win_len)
    # window autocorrelation for normalization (Boersma's key trick)
    w_fft = np.fft.rfft(window, 2 * win_len)
    r_w = np.fft.irfft(w_fft * np.conj(w_fft))[:win_len]
    r_w /= r_w[0]

    min_lag = max(int(fs / f0_ceil), 2)
    max_lag = min(int(np.ceil(fs / f0_floor)), win_len - 2)

    # per-frame candidates: (frequency, strength); index 0 = unvoiced
    cand_freq = np.zeros((n_frames, MAX_CANDIDATES + 1))
    cand_str = np.full((n_frames, MAX_CANDIDATES + 1), -1e9)

    xp = np.pad(x, (half, half + hop))
    for fi in range(n_frames):
        center = fi * hop + half
        seg = xp[center - half : center + half].copy()
        local_peak = np.max(np.abs(seg)) + 1e-12
        seg -= seg.mean()
        segw = seg * window

        f = np.fft.rfft(segw, 2 * win_len)
        r = np.fft.irfft(f * np.conj(f))[:win_len]
        if r[0] <= 0:
            cand_str[fi, 0] = 1e9  # silent -> unvoiced
            continue
        r = r / r[0] / np.maximum(r_w, 1e-12)  # normalized AC

        # unvoiced candidate strength (Boersma eq. 23)
        cand_str[fi, 0] = (voicing_threshold
                           + max(0.0, 2.0 - (local_peak / global_peak)
                                 / (SILENCE_THRESHOLD / (1.0 + voicing_threshold))))

        # voiced candidates: local maxima of r in the lag band
        n_found = 0
        for lag in range(min_lag + 1, max_lag):
            if r[lag] > r[lag - 1] and r[lag] >= r[lag + 1] and r[lag] > 0.3:
                # parabolic interpolation
                denom = r[lag - 1] - 2 * r[lag] + r[lag + 1]
                shift = 0.0 if abs(denom) < 1e-12 else \
                    0.5 * (r[lag - 1] - r[lag + 1]) / denom
                lag_i = lag + shift
                r_i = r[lag] - 0.25 * (r[lag - 1] - r[lag + 1]) * shift
                freq = fs / lag_i
                if freq < f0_floor or freq > f0_ceil:
                    continue
                strength = min(r_i, 1.0) - OCTAVE_COST * np.log2(
                    f0_ceil / freq)
                if n_found < MAX_CANDIDATES:
                    n_found += 1
                    cand_freq[fi, n_found] = freq
                    cand_str[fi, n_found] = strength
                else:
                    weakest = int(np.argmin(cand_str[fi, 1:])) + 1
                    if strength > cand_str[fi, weakest]:
                        cand_freq[fi, weakest] = freq
                        cand_str[fi, weakest] = strength

    # Viterbi over candidates with transition costs
    n_c = MAX_CANDIDATES + 1
    score = cand_str[0].copy()
    back = np.zeros((n_frames, n_c), np.int64)
    for fi in range(1, n_frames):
        prev_v = cand_freq[fi - 1] > 0
        cur_v = cand_freq[fi] > 0
        trans = np.zeros((n_c, n_c))
        # voicing transitions
        trans += VOICED_UNVOICED_COST * (prev_v[:, None] != cur_v[None, :])
        # octave jumps between voiced candidates
        both = prev_v[:, None] & cur_v[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            jump = np.abs(np.log2(np.maximum(cand_freq[fi - 1][:, None], 1e-9)
                                  / np.maximum(cand_freq[fi][None, :], 1e-9)))
        trans += OCTAVE_JUMP_COST * np.where(both, jump, 0.0)
        total = score[:, None] - trans
        back[fi] = np.argmax(total, axis=0)
        score = total[back[fi], np.arange(n_c)] + cand_str[fi]

    path = np.zeros(n_frames, np.int64)
    path[-1] = int(np.argmax(score))
    for fi in range(n_frames - 2, -1, -1):
        path[fi] = back[fi + 1, path[fi + 1]]
    return cand_freq[np.arange(n_frames), path].astype(np.float32)
