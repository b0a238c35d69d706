"""SWIPE' pitch estimator (sawtooth-waveform inspired, prime harmonics).

Behavioral equivalent of reference main/library/predictors/SWIPE.py
(itself the classic Camacho SWIPE' algorithm): multi-resolution
spectrogram -> ERB-spaced loudness -> normalized prime-harmonic cosine
kernels per log-spaced pitch candidate -> resolution blending ->
parabolic refinement in log-pitch. Vectorized: the per-candidate kernel
loop becomes one (candidates x freqs) matrix multiply.

A copy of `rvc_maker_tpu/f0/swipe.py` (the port imports nothing of the
JAX package); the port's tests hold the two equal on the same input.
"""

from __future__ import annotations

import numpy as np
from scipy import interpolate


def _hz2erbs(hz):
    return 21.4 * np.log10(1.0 + np.asarray(hz) / 229.0)


def _erbs2hz(erbs):
    return (10.0 ** (np.asarray(erbs) / 21.4) - 1.0) * 229.0


def _primes_upto(n: int) -> list[int]:
    if n < 2:
        return []
    sieve = np.ones(n + 1, bool)
    sieve[:2] = False
    for p in range(2, int(np.sqrt(n)) + 1):
        if sieve[p]:
            sieve[p * p :: p] = False
    return list(np.flatnonzero(sieve))


def _kernel_matrix(f: np.ndarray, pcs: np.ndarray) -> np.ndarray:
    """(n_candidates, n_freqs) normalized SWIPE' kernels."""
    K = np.zeros((len(pcs), len(f)))
    for ci, pc in enumerate(pcs):
        q = f / pc
        k = np.zeros(len(f))
        max_harm = int(np.fix(f[-1] / pc - 0.75))
        for h in [1] + _primes_upto(max_harm):
            a = np.abs(q - h)
            prim = a < 0.25
            k[prim] = np.cos(2 * np.pi * q[prim])
            neigh = (0.25 < a) & (a < 0.75)
            k[neigh] += np.cos(2 * np.pi * q[neigh]) / 2.0
        k *= np.sqrt(1.0 / f)
        norm = np.linalg.norm(k[k > 0])
        if norm > 0:
            k /= norm
        K[ci] = k
    return K


def _specgram(x: np.ndarray, fs: float, nfft: int, hop: int):
    """Complex spectrogram with hanning window (interior points), matching
    the mlab.specgram framing the reference relies on."""
    win = np.hanning(nfft + 2)[1:-1]
    n_frames = 1 + max(0, (len(x) - nfft)) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(nfft)[None, :]
    frames = x[idx] * win
    X = np.fft.rfft(frames, axis=-1)            # (T, F)
    f = np.fft.rfftfreq(nfft, 1.0 / fs)
    ti = np.arange(n_frames) * hop / fs
    return X.T, f, ti                            # (F, T)


def swipe(x: np.ndarray, fs: int, *, f0_floor: float = 50.0,
          f0_ceil: float = 1100.0, frame_period: float = 10.0,
          strength_threshold: float = 0.3):
    """Returns (f0 (T,), times (T,)); f0=0 where pitch strength is below
    threshold (reference swipe, SWIPE.py:9-83)."""
    x = np.asarray(x, np.float64)
    t = np.arange(int(1000 * len(x) / fs / frame_period + 1)) * (frame_period / 1000.0)

    # log-spaced candidates, 96 per octave
    log2pc = np.arange(np.log2(f0_floor) * 96, np.log2(f0_ceil) * 96) / 96.0
    pc = 2.0 ** log2pc
    S = np.zeros((len(pc), len(t)))

    # window sizes: power-of-two, optimal at p0 = 8*fs/ws
    log_ws_max = int(round(np.log2(8.0 * fs / f0_floor)))
    log_ws_min = int(round(np.log2(8.0 * fs / f0_ceil)))
    ws = 2 ** np.arange(log_ws_max, log_ws_min - 1, -1)
    p0 = 8.0 * fs / ws
    d = 1.0 + log2pc - np.log2(8.0 * fs / ws[0])

    fERBs = _erbs2hz(np.arange(_hz2erbs(pc[0] / 4.0), _hz2erbs(fs / 2.0), 0.1))

    for i, w in enumerate(ws):
        dn = int(round(4.0 * fs / p0[i]))        # hop
        xp = np.concatenate([np.zeros(w // 2), x, np.zeros(dn + w // 2)])
        X, f, ti = _specgram(xp, fs, int(w), dn)
        ti = np.concatenate([[0.0], ti[:-1]])
        # loudness on ERB grid
        M = np.maximum(0.0, interpolate.interp1d(f, np.abs(X.T), kind="cubic")(fERBs)).T
        L = np.sqrt(M)

        # which candidates this resolution covers
        if i == len(ws) - 1:
            j = np.flatnonzero(d - (i + 1) > -1)
            k = np.flatnonzero(d[j] - (i + 1) < 0)
        elif i == 0:
            j = np.flatnonzero(d - (i + 1) < 1)
            k = np.flatnonzero(d[j] - (i + 1) > 0)
        else:
            j = np.flatnonzero(np.abs(d - (i + 1)) < 1)
            k = np.arange(len(j))

        den = np.sqrt(np.sum(L * L, axis=0))
        den = np.where(den == 0, np.finfo(float).eps, den)
        Si = _kernel_matrix(fERBs, pc[j]) @ (L / den)

        if Si.shape[1] > 1:
            Si = interpolate.interp1d(ti, Si, bounds_error=False,
                                      fill_value=np.nan)(t)
        else:
            Si = np.full((len(j), len(t)), np.nan)

        mu = np.ones(len(j))
        mu[k] = 1.0 - np.abs(d[j[k]] - i - 1)
        S[j, :] += mu[:, None] * np.nan_to_num(Si)

    # peak picking + parabolic refinement in log-pitch
    f0 = np.zeros(len(t), np.float32)
    for ti_ in range(S.shape[1]):
        col = S[:, ti_]
        best = int(np.argmax(col))
        if col[best] < strength_threshold:
            continue
        if best == 0 or best == len(pc) - 1:
            f0[ti_] = pc[0]
            continue
        # quadratic fit over the three neighbors in normalized period
        I = np.array([best - 1, best, best + 1])
        tc = 1.0 / pc[I]
        ntc = (tc / tc[1] - 1.0) * 2.0 * np.pi
        c = np.polyfit(ntc, col[I], 2)
        fine = 2.0 ** np.arange(np.log2(pc[I[0]]), np.log2(pc[I[2]]) + 1e-12,
                                1.0 / 12 / 64)
        pval = np.polyval(c, (1.0 / fine / tc[1] - 1.0) * 2.0 * np.pi)
        f0[ti_] = 2.0 ** (np.log2(pc[I[0]]) + np.argmax(pval) / 12.0 / 64.0)
    return f0, t.astype(np.float32)
