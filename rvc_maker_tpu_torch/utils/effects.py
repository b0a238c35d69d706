"""Audio effects chain — native DSP replacements for pedalboard (JUCE).

The reference builds a pedalboard chain (audio_effects.py:139-174):
HighpassFilter always, then optional Chorus / Distortion / Reverb /
PitchShift / Delay / Compressor / Limiter / Gain / Bitcrush / Clipping /
Phaser, plus scipy bass/treble shelves, fades and combination overlay.
A copy of `rvc_maker_tpu/utils/effects.py` (numpy/scipy, on the host).
pedalboard is not a dependency; each effect is implemented here in
numpy/scipy with standard DSP formulations and pedalboard-compatible
parameter names/units.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
from scipy.signal import butter, filtfilt, lfilter

from .audio import resample
from .pitchshift import shift_pitch


def highpass(audio: np.ndarray, sr: int, cutoff: float = 50.0) -> np.ndarray:
    b, a = butter(2, cutoff / (0.5 * sr), btype="high")
    return lfilter(b, a, audio).astype(np.float32)


def gain(audio: np.ndarray, gain_db: float) -> np.ndarray:
    return (audio * 10 ** (gain_db / 20.0)).astype(np.float32)


def distortion(audio: np.ndarray, drive_db: float = 25.0) -> np.ndarray:
    """tanh waveshaper with input drive (pedalboard Distortion)."""
    return np.tanh(audio * 10 ** (drive_db / 20.0)).astype(np.float32)


def clipping(audio: np.ndarray, threshold_db: float = -6.0) -> np.ndarray:
    t = 10 ** (threshold_db / 20.0)
    return np.clip(audio, -t, t).astype(np.float32)


def bitcrush(audio: np.ndarray, bit_depth: int = 8) -> np.ndarray:
    levels = 2 ** int(bit_depth)
    return (np.round(audio * (levels / 2)) / (levels / 2)).astype(np.float32)


def delay(audio: np.ndarray, sr: int, seconds: float = 0.5,
          feedback: float = 0.5, mix: float = 0.5) -> np.ndarray:
    """Feedback delay line."""
    d = max(int(seconds * sr), 1)
    out = audio.astype(np.float64).copy()
    buf = np.zeros_like(out)
    # iterative feedback as a geometric sum of shifted copies
    wet = np.zeros_like(out)
    g = 1.0
    shift = d
    while g > 1e-4 and shift < len(audio):
        wet[shift:] += g * audio[: len(audio) - shift]
        g *= feedback
        shift += d
    out = (1 - mix) * out + mix * wet
    return out.astype(np.float32)


def chorus(audio: np.ndarray, sr: int, rate_hz: float = 1.0,
           depth: float = 0.25, centre_delay_ms: float = 7.0,
           feedback: float = 0.0, mix: float = 0.5) -> np.ndarray:
    """LFO-modulated delay (pedalboard Chorus parameterization)."""
    n = len(audio)
    t = np.arange(n)
    centre = centre_delay_ms * 1e-3 * sr
    lfo = centre * (1.0 + depth * np.sin(2 * np.pi * rate_hz * t / sr))
    pos = t - lfo
    base = np.floor(pos).astype(int)
    frac = pos - base
    base = np.clip(base, 0, n - 2)
    wet = (1 - frac) * audio[base] + frac * audio[base + 1]
    if feedback != 0.0:
        wet = wet + feedback * np.roll(wet, int(centre))
    return ((1 - mix) * audio + mix * wet).astype(np.float32)


def phaser(audio: np.ndarray, sr: int, rate_hz: float = 1.0,
           depth: float = 0.5, centre_frequency_hz: float = 1300.0,
           feedback: float = 0.0, mix: float = 0.5) -> np.ndarray:
    """4-stage all-pass phaser with sinusoidal LFO."""
    n = len(audio)
    lfo = centre_frequency_hz * (1.0 + depth * 0.5 * np.sin(
        2 * np.pi * rate_hz * np.arange(n) / sr))
    lfo = np.clip(lfo, 20.0, sr * 0.45)
    # block-wise coefficient update (per 64 samples) for speed
    block = 64
    x = audio.astype(np.float64)
    y = np.zeros(n)
    zs = np.zeros(4)
    fb = 0.0
    for s in range(0, n, block):
        e = min(s + block, n)
        w = np.tan(np.pi * lfo[s] / sr)
        a1 = (w - 1.0) / (w + 1.0)
        for i in range(s, e):
            v = x[i] + fb * feedback
            for k in range(4):
                out = a1 * v + zs[k]
                zs[k] = v - a1 * out
                v = out
            fb = v
            y[i] = v
    return ((1 - mix) * audio + mix * y).astype(np.float32)


def compressor(audio: np.ndarray, sr: int, threshold_db: float = -20.0,
               ratio: float = 4.0, attack_ms: float = 1.0,
               release_ms: float = 100.0) -> np.ndarray:
    """Feed-forward RMS-less peak compressor with attack/release ballistics."""
    eps = 1e-10
    level_db = 20 * np.log10(np.abs(audio) + eps)
    over = np.maximum(level_db - threshold_db, 0.0)
    target_gain_db = -over * (1.0 - 1.0 / ratio)
    a_att = math.exp(-1.0 / (attack_ms * 1e-3 * sr + eps))
    a_rel = math.exp(-1.0 / (release_ms * 1e-3 * sr + eps))
    g = np.empty_like(target_gain_db)
    state = 0.0
    for i in range(len(audio)):
        coef = a_att if target_gain_db[i] < state else a_rel
        state = coef * state + (1 - coef) * target_gain_db[i]
        g[i] = state
    return (audio * 10 ** (g / 20.0)).astype(np.float32)


def limiter(audio: np.ndarray, sr: int, threshold_db: float = -1.0,
            release_ms: float = 100.0) -> np.ndarray:
    return compressor(audio, sr, threshold_db=threshold_db, ratio=1000.0,
                      attack_ms=0.05, release_ms=release_ms)


def bass_boost(audio: np.ndarray, sr: int, gain_db: float,
               frequency: float) -> np.ndarray:
    """Reference semantics (audio_effects.py:82-87): 4th-order low-pass
    then broadband gain when gain_db >= 1."""
    if gain_db >= 1:
        b, a = butter(4, frequency / (0.5 * sr), btype="low")
        return (filtfilt(b, a, audio) * 10 ** (gain_db / 20)).astype(np.float32)
    return audio


def treble_boost(audio: np.ndarray, sr: int, gain_db: float,
                 frequency: float) -> np.ndarray:
    if gain_db >= 1:
        b, a = butter(4, frequency / (0.5 * sr), btype="high")
        return (filtfilt(b, a, audio) * 10 ** (gain_db / 20)).astype(np.float32)
    return audio


def fade_in(audio: np.ndarray, sr: int, duration: float = 3.0) -> np.ndarray:
    n = min(int(duration * sr), len(audio))
    out = audio.copy()
    out[:n] = out[:n] * np.linspace(0.0, 1.0, n)
    return out


def fade_out(audio: np.ndarray, sr: int, duration: float = 3.0) -> np.ndarray:
    n = min(int(duration * sr), len(audio))
    out = audio.copy()
    out[len(audio) - n:] = out[len(audio) - n:] * np.linspace(1.0, 0.0, n)
    return out


def reverb(audio: np.ndarray, sr: int, room_size: float = 0.5,
           damping: float = 0.5, wet_level: float = 0.33,
           dry_level: float = 0.4, width: float = 1.0,
           freeze_mode: float = 0.0) -> np.ndarray:
    """Freeverb topology (Schroeder: 8 combs + 4 allpasses) — the same
    algorithm family pedalboard's Reverb wraps."""
    comb_tunings = [1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617]
    allpass_tunings = [556, 441, 341, 225]
    scale = sr / 44100.0
    x = audio.astype(np.float64)
    n = len(x)

    room = 0.28 * room_size + 0.7
    damp = 0.4 * damping
    if freeze_mode >= 0.5:
        room, damp = 1.0, 0.0

    wet = np.zeros(n)
    for tuning in comb_tunings:
        d = max(int(tuning * scale), 1)
        buf = np.zeros(d)
        filt = 0.0
        out = np.zeros(n)
        idx = 0
        for i in range(n):
            y = buf[idx]
            filt = y * (1 - damp) + filt * damp
            buf[idx] = x[i] + filt * room
            out[i] = y
            idx = (idx + 1) % d
        wet += out
    wet /= len(comb_tunings)
    for tuning in allpass_tunings:
        d = max(int(tuning * scale), 1)
        buf = np.zeros(d)
        idx = 0
        for i in range(n):
            bufout = buf[idx]
            buf[idx] = wet[i] + bufout * 0.5
            wet[i] = bufout - wet[i]
            idx = (idx + 1) % d
    return (dry_level * audio + wet_level * wet).astype(np.float32)


@dataclasses.dataclass
class EffectsSettings:
    """Mirrors the reference CLI flag set (audio_effects.py)."""
    chorus: bool = False
    chorus_depth: float = 0.5
    chorus_rate: float = 1.5
    chorus_mix: float = 0.5
    chorus_delay: float = 10.0
    chorus_feedback: float = 0.0
    distortion: bool = False
    distortion_drive: float = 20.0
    reverb: bool = False
    reverb_room_size: float = 0.5
    reverb_damping: float = 0.5
    reverb_wet_level: float = 0.33
    reverb_dry_level: float = 0.4
    reverb_width: float = 1.0
    reverb_freeze_mode: bool = False
    pitchshift: bool = False
    pitch_shift: float = 0.0
    delay: bool = False
    delay_seconds: float = 0.5
    delay_feedback: float = 0.5
    delay_mix: float = 0.5
    compressor: bool = False
    compressor_threshold: float = -20.0
    compressor_ratio: float = 4.0
    compressor_attack_ms: float = 1.0
    compressor_release_ms: float = 100.0
    limiter: bool = False
    limiter_threshold: float = -1.0
    limiter_release: float = 100.0
    gain: bool = False
    gain_db: float = 0.0
    bitcrush: bool = False
    bitcrush_bit_depth: int = 8
    clipping: bool = False
    clipping_threshold: float = -6.0
    phaser: bool = False
    phaser_rate_hz: float = 1.0
    phaser_depth: float = 0.5
    phaser_centre_frequency_hz: float = 1300.0
    phaser_feedback: float = 0.0
    phaser_mix: float = 0.5
    treble_bass_boost: bool = False
    bass_boost_db: float = 0.0
    bass_boost_frequency: float = 200.0
    treble_boost_db: float = 0.0
    treble_boost_frequency: float = 3000.0
    fade_in_out: bool = False
    fade_in_duration: float = 3.0
    fade_out_duration: float = 3.0
    resample_sr: int = 0


def apply_effects(audio: np.ndarray, sr: int,
                  s: EffectsSettings) -> tuple[np.ndarray, int]:
    """Apply the chain in the reference's order (highpass always first,
    audio_effects.py:139-167). Returns (audio, sr)."""
    out = highpass(audio.astype(np.float32), sr)
    if s.chorus:
        out = chorus(out, sr, s.chorus_rate, s.chorus_depth, s.chorus_delay,
                     s.chorus_feedback, s.chorus_mix)
    if s.distortion:
        out = distortion(out, s.distortion_drive)
    if s.reverb:
        out = reverb(out, sr, s.reverb_room_size, s.reverb_damping,
                     s.reverb_wet_level, s.reverb_dry_level, s.reverb_width,
                     1.0 if s.reverb_freeze_mode else 0.0)
    if s.pitchshift:
        out = shift_pitch(out, sr, factors=2 ** (s.pitch_shift / 12.0))
    if s.delay:
        out = delay(out, sr, s.delay_seconds, s.delay_feedback, s.delay_mix)
    if s.compressor:
        out = compressor(out, sr, s.compressor_threshold, s.compressor_ratio,
                         s.compressor_attack_ms, s.compressor_release_ms)
    if s.limiter:
        out = limiter(out, sr, s.limiter_threshold, s.limiter_release)
    if s.gain:
        out = gain(out, s.gain_db)
    if s.bitcrush:
        out = bitcrush(out, s.bitcrush_bit_depth)
    if s.clipping:
        out = clipping(out, s.clipping_threshold)
    if s.phaser:
        out = phaser(out, sr, s.phaser_rate_hz, s.phaser_depth,
                     s.phaser_centre_frequency_hz, s.phaser_feedback,
                     s.phaser_mix)
    if s.treble_bass_boost:
        out = bass_boost(out, sr, s.bass_boost_db, s.bass_boost_frequency)
        out = treble_boost(out, sr, s.treble_boost_db, s.treble_boost_frequency)
    if s.fade_in_out:
        out = fade_in(out, sr, s.fade_in_duration)
        out = fade_out(out, sr, s.fade_out_duration)
    if s.resample_sr and s.resample_sr != sr:
        out = resample(out, sr, s.resample_sr)
        sr = s.resample_sr
    return out, sr
