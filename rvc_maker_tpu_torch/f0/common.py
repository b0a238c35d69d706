"""F0 post-processing shared by the estimators (counterpart of
`rvc_maker_tpu/f0/common.py`; reference convert.py:168-179, 304-323)."""

from __future__ import annotations

import numpy as np
import torch

F0_MIN = 50.0
F0_MAX = 1100.0
F0_MEL_MIN = 1127.0 * np.log(1.0 + F0_MIN / 700.0)
F0_MEL_MAX = 1127.0 * np.log(1.0 + F0_MAX / 700.0)

# reference convert.py:202 note table
NOTE_FREQS = np.array([
    49.00, 51.91, 55.00, 58.27, 61.74, 65.41, 69.30, 73.42, 77.78, 82.41,
    87.31, 92.50, 98.00, 103.83, 110.00, 116.54, 123.47, 130.81, 138.59,
    146.83, 155.56, 164.81, 174.61, 185.00, 196.00, 207.65, 220.00, 233.08,
    246.94, 261.63, 277.18, 293.66, 311.13, 329.63, 349.23, 369.99, 392.00,
    415.30, 440.00, 466.16, 493.88, 523.25, 554.37, 587.33, 622.25, 659.25,
    698.46, 739.99, 783.99, 830.61, 880.00, 932.33, 987.77, 1046.50,
], dtype=np.float32)


def shift_f0(f0, semitones: float):
    """Transpose by semitones (reference convert.py:311)."""
    return f0 * (2.0 ** (semitones / 12.0))


def autotune_f0(f0, strength: float = 1.0):
    """Snap every frame toward the nearest note frequency."""
    notes = torch.as_tensor(NOTE_FREQS, device=f0.device)
    nearest = notes[torch.argmin(torch.abs(f0[..., None] - notes), dim=-1)]
    return f0 + (nearest - f0) * strength


def coarse_f0(f0):
    """Hz -> 1..255 mel-bin int64 codes.  torch.round rounds half to
    even, as jnp.rint does."""
    f0_mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    scaled = (f0_mel - F0_MEL_MIN) * 254.0 / (F0_MEL_MAX - F0_MEL_MIN) + 1.0
    f0_mel = torch.where(f0_mel > 0, scaled, f0_mel)
    f0_mel = torch.clamp(f0_mel, 1.0, 255.0)
    return torch.round(f0_mel).to(torch.int64)
