"""A copy of `rvc_maker_tpu/utils/presets.py`.

Conversion-settings presets, interchange-compatible with the
reference's JSON preset files (reference app.py:1376-1399
load_presets/save_presets — keys: cleaner, autotune, pitch,
clean_strength, index_strength, resample_sr, filter_radius,
volume_envelope, protect, split_audio, f0_autotune_strength,
formant_shifting, formant_qfrency, formant_timbre)."""

from __future__ import annotations

import json
import os

PRESET_KEYS = (
    "cleaner", "autotune", "pitch", "clean_strength", "index_strength",
    "resample_sr", "filter_radius", "volume_envelope", "protect",
    "split_audio", "f0_autotune_strength", "formant_shifting",
    "formant_qfrency", "formant_timbre",
)


def save_preset(path: str, **settings) -> str:
    """Write a preset JSON with only the recognised keys."""
    data = {k: v for k, v in settings.items() if k in PRESET_KEYS}
    if not data:
        raise ValueError("no preset keys given; choose at least one of "
                         + ", ".join(PRESET_KEYS))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=4)
    return path


def load_preset(path: str) -> dict:
    with open(path) as f:
        data = json.load(f)
    return {k: v for k, v in data.items() if k in PRESET_KEYS}


def apply_preset_to_args(args, preset: dict):
    """Overlay preset values onto an argparse namespace using our CLI
    flag names (reference gradio fields -> our flags)."""
    mapping = {
        "pitch": "pitch", "index_strength": "index_rate",
        "protect": "protect", "volume_envelope": "volume_envelope",
        "resample_sr": "resample_sr", "filter_radius": "filter_radius",
        "autotune": "f0_autotune",
        "f0_autotune_strength": "f0_autotune_strength",
        "cleaner": "clean_audio", "clean_strength": "clean_strength",
        "split_audio": "split_audio",
        "formant_shifting": "formant_shifting",
        "formant_qfrency": "formant_qfrency",
        "formant_timbre": "formant_timbre",
    }
    for key, attr in mapping.items():
        if key in preset and hasattr(args, attr):
            setattr(args, attr, preset[key])
    return args
