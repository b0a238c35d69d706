"""Probabilistic YIN (pYIN) pitch tracker, from-scratch numpy/scipy.

A copy of `rvc_maker_tpu/f0/pyin.py` (the port imports nothing of the
JAX package); the port's tests hold the two equal on the same input.

The reference exposes ``pyin`` as a user-facing F0 method via
librosa.pyin (reference convert.py:278-281 get_f0_yin(mode="pyin"),
app.py:72 method list).  librosa is absent from this image, so this
implements the published pYIN algorithm (Mauch & Dixon 2014) following
librosa's formulation so downstream numerics line up:

  CMND difference function -> all candidate troughs weighted by a
  Beta(2, 18) prior over 100 absolute thresholds and a Boltzmann prior
  over trough rank -> observation probabilities over log-spaced pitch
  bins plus an unvoiced mirror state -> Viterbi over a
  locally-banded triangular transition matrix kron'd with a 2-state
  voicing switch.

Host-side method (like dio/harvest): the HMM is sequential; the
batched device path is ``f0.yin.yin``.
"""

from __future__ import annotations

import math

import numpy as np


def _frame(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    n = 1 + (len(y) - frame_length) // hop_length
    idx = np.arange(frame_length)[None, :] + hop_length * np.arange(n)[:, None]
    return y[idx]  # (T, W)


def _cmnd(frames: np.ndarray, frame_length: int, win_length: int,
          min_period: int, max_period: int) -> np.ndarray:
    """Cumulative mean-normalized difference, lags min..max. (T, P)."""
    a = np.fft.rfft(frames, frame_length, axis=-1)
    b = np.fft.rfft(frames[:, win_length::-1], frame_length, axis=-1)
    acf = np.fft.irfft(a * b, frame_length, axis=-1)[:, win_length:]
    acf[np.abs(acf) < 1e-6] = 0.0

    e = np.cumsum(frames ** 2, axis=-1)
    energy = e[:, win_length:] - np.concatenate(
        [np.zeros((len(e), 1)), e[:, : -win_length - 1]], axis=-1)
    energy[np.abs(energy) < 1e-6] = 0.0

    d = energy[:, :1] + energy - 2.0 * acf          # d(tau), tau=0..W-w
    tau = np.arange(1, d.shape[-1])
    cmean = np.cumsum(d[:, 1:], axis=-1) / tau
    tiny = np.finfo(d.dtype).tiny
    return d[:, min_period: max_period + 1] / (
        cmean[:, min_period - 1: max_period] + tiny)


def _parabolic_shifts(y: np.ndarray) -> np.ndarray:
    shifts = np.zeros_like(y)
    a = (y[:, 2:] + y[:, :-2] - 2.0 * y[:, 1:-1]) / 2.0
    b = (y[:, 2:] - y[:, :-2]) / 2.0
    tiny = np.finfo(y.dtype).tiny
    shifts[:, 1:-1] = -b / (2.0 * a + tiny)
    shifts[np.abs(shifts) > 1.0] = 0.0
    return shifts


def _beta_probs(n_thresholds: int, a: float, b: float) -> np.ndarray:
    """P(threshold bin) under Beta(a, b) — regularized incomplete beta
    differences.  a=2, b=18 have integer parameters, so the CDF is the
    closed-form binomial tail sum (no scipy.special needed)."""
    x = np.linspace(0.0, 1.0, n_thresholds + 1)
    n = int(a + b - 1)
    ks = np.arange(int(a), n + 1)
    from math import comb
    coef = np.array([comb(n, int(k)) for k in ks], dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        cdf = np.sum(coef * x[:, None] ** ks * (1 - x[:, None]) ** (n - ks),
                     axis=-1)
    cdf[0], cdf[-1] = 0.0, 1.0
    return np.diff(cdf)


def _boltzmann_pmf(k: np.ndarray, lam: float, n: np.ndarray) -> np.ndarray:
    """Truncated discrete exponential: pmf(k; lam, N) over k=0..N-1."""
    with np.errstate(divide="ignore", invalid="ignore"):
        p = ((1 - np.exp(-lam)) * np.exp(-lam * k)
             / (1 - np.exp(-lam * n)))
    return np.where((n > 0) & (k >= 0) & (k < n), p, 0.0)


def _local_transition(n_states: int, width: int) -> np.ndarray:
    """Row-stochastic banded transition with a triangular window
    (librosa.sequence.transition_local semantics, wrap=False)."""
    w = 1.0 - np.abs(np.arange(width) - (width - 1) / 2.0) / ((width + 1) / 2.0)
    trans = np.zeros((n_states, n_states))
    half = width // 2
    for i in range(n_states):
        lo = max(0, i - half)
        hi = min(n_states, i - half + width)
        seg = w[lo - (i - half): hi - (i - half)]
        trans[i, lo:hi] = seg / seg.sum()
    return trans


def _viterbi(log_obs: np.ndarray, log_trans: np.ndarray,
             log_init: np.ndarray) -> np.ndarray:
    """Dense max-product decoding. log_obs: (T, S). Returns (T,) states."""
    t_steps, n_states = log_obs.shape
    back = np.zeros((t_steps, n_states), dtype=np.int32)
    value = log_init + log_obs[0]
    for t in range(1, t_steps):
        scores = value[:, None] + log_trans          # (S_prev, S_next)
        back[t] = np.argmax(scores, axis=0)
        value = scores[back[t], np.arange(n_states)] + log_obs[t]
    states = np.zeros(t_steps, dtype=np.int32)
    states[-1] = int(np.argmax(value))
    for t in range(t_steps - 2, -1, -1):
        states[t] = back[t + 1, states[t + 1]]
    return states


def pyin(y: np.ndarray, sr: int, *, fmin: float = 50.0, fmax: float = 1100.0,
         frame_length: int = 2048, hop_length: int = 160,
         n_thresholds: int = 100, beta_parameters=(2.0, 18.0),
         boltzmann_parameter: float = 2.0, resolution: float = 0.1,
         max_transition_rate: float = 35.92, switch_prob: float = 0.01,
         no_trough_prob: float = 0.01, center: bool = True):
    """Returns (f0, voiced_flag, voiced_prob), each (n_frames,).
    f0 is NaN on unvoiced frames (librosa fill_na semantics)."""
    y = np.asarray(y, dtype=np.float64)
    win_length = frame_length // 2
    min_period = max(int(np.floor(sr / fmax)), 1)
    max_period = min(int(np.ceil(sr / fmin)), frame_length - win_length - 1)
    if center:
        y = np.pad(y, frame_length // 2, mode="constant")

    frames = _frame(y, frame_length, hop_length)         # (T, W)
    yin_frames = _cmnd(frames, frame_length, win_length,
                       min_period, max_period)           # (T, P)
    shifts = _parabolic_shifts(yin_frames)
    t_steps, n_periods = yin_frames.shape

    thresholds = np.linspace(0.0, 1.0, n_thresholds + 1)
    beta_probs = _beta_probs(n_thresholds, *beta_parameters)

    # candidate troughs per frame, weighted by threshold prior x rank prior
    is_trough = np.empty_like(yin_frames, dtype=bool)
    is_trough[:, 0] = yin_frames[:, 0] < yin_frames[:, 1]
    is_trough[:, -1] = False
    is_trough[:, 1:-1] = ((yin_frames[:, 1:-1] < yin_frames[:, :-2])
                          & (yin_frames[:, 1:-1] <= yin_frames[:, 2:]))

    # (T, P, n_thresholds): trough below each absolute threshold
    below = (is_trough[:, :, None]
             & (yin_frames[:, :, None] < thresholds[None, None, 1:]))
    positions = np.cumsum(below, axis=1) - 1             # rank among troughs
    n_troughs = np.count_nonzero(below, axis=1)          # (T, n_thresholds)
    prior = _boltzmann_pmf(positions, boltzmann_parameter,
                           n_troughs[:, None, :])
    prior[~below] = 0.0
    yin_probs = prior @ beta_probs                       # (T, P)

    # leftover prior mass when the global min never dips below a threshold
    heights = np.where(is_trough, yin_frames, np.inf)
    has_trough = is_trough.any(axis=1)
    global_min = np.argmin(heights, axis=1)
    rows = np.arange(t_steps)
    n_thr_below_min = np.count_nonzero(~below[rows, global_min], axis=1)
    beta_cum = np.concatenate([[0.0], np.cumsum(beta_probs)])
    yin_probs[rows, global_min] += np.where(
        has_trough, no_trough_prob * beta_cum[n_thr_below_min], 0.0)
    yin_probs[~has_trough] = 0.0

    # observation matrix over pitch bins + unvoiced mirror states
    n_bins_per_semitone = int(np.ceil(1.0 / resolution))
    n_pitch_bins = int(np.floor(12 * n_bins_per_semitone
                                * np.log2(fmax / fmin))) + 1

    frame_index, yin_period = np.nonzero(yin_probs > 0)
    period_candidates = (min_period + yin_period
                         + shifts[frame_index, yin_period])
    f0_candidates = sr / period_candidates
    bin_index = np.clip(np.round(12 * n_bins_per_semitone
                                 * np.log2(f0_candidates / fmin)),
                        0, n_pitch_bins - 1).astype(np.int64)

    observation_probs = np.zeros((t_steps, 2 * n_pitch_bins))
    observation_probs[frame_index, bin_index] = yin_probs[frame_index,
                                                          yin_period]
    voiced_prob = np.clip(
        observation_probs[:, :n_pitch_bins].sum(axis=1), 0.0, 1.0)
    observation_probs[:, n_pitch_bins:] = ((1.0 - voiced_prob[:, None])
                                           / n_pitch_bins)

    # transition: banded pitch movement x voiced/unvoiced switch
    max_semitones_per_frame = round(max_transition_rate * 12
                                    * hop_length / sr)
    transition_width = max_semitones_per_frame * n_bins_per_semitone + 1
    local = _local_transition(n_pitch_bins, transition_width)
    t_switch = np.array([[1.0 - switch_prob, switch_prob],
                         [switch_prob, 1.0 - switch_prob]])
    transition = np.kron(t_switch, local)

    p_init = np.zeros(2 * n_pitch_bins)
    p_init[n_pitch_bins:] = 1.0 / n_pitch_bins

    tiny = np.finfo(np.float64).tiny
    states = _viterbi(np.log(observation_probs + tiny),
                      np.log(transition + tiny), np.log(p_init + tiny))

    freqs = fmin * 2.0 ** (np.arange(n_pitch_bins)
                           / (12.0 * n_bins_per_semitone))
    f0 = freqs[states % n_pitch_bins]
    voiced_flag = states < n_pitch_bins
    f0 = np.where(voiced_flag, f0, np.nan)
    return f0, voiced_flag, voiced_prob
