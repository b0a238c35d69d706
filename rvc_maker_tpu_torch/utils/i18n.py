"""Internationalization: user-facing strings routed through a registry.

A copy of JAX `utils/i18n.py`: `tr(key)` with English defaults baked in,
and the four locale files of `languages/` (the JAX package's, copied;
the same key space) selected through RVC_LANG or `set_language()`.
"""

from __future__ import annotations

import json
import logging
import os

logger = logging.getLogger(__name__)

_EN = {
    "convert_audio": "Converting audio",
    "convert_audio_success": "Converted {input_path} in {elapsed_time}s -> {output_path}",
    "not_found_audio": "No input audio found",
    "provide_file": "Please provide a valid {filename} file",
    "model": "model",
    "start_preprocess": "Preprocessing with {num_processes} processes",
    "preprocess_success": "Preprocessing finished in {elapsed_time}s",
    "start_extract": "Extracting features",
    "extract_success": "Feature extraction finished",
    "start_training": "Starting training",
    "training_warning": "Possible overtraining detected",
    "save_checkpoint": "Saved checkpoint at epoch {epoch}",
    "sr_not_same": "The two models have different sample rates",
    "architectures_not_same": "The two models have different architectures",
    "fusion_success": "Model fusion complete",
    "error_occurred": "An error occurred: {e}",
    "method_not_valid": "Unknown F0 method",
    "option_not_valid": "Invalid option",
    "download_disabled": "Remote downloads are disabled in this build "
                         "(no network egress); place model files locally "
                         "and pass their paths instead.",
    "srt_invalid": "The SRT file is empty or malformed",
    "enter_the_text": "Please enter text to synthesize",
    "choose_voice": "Please choose a voice",
    "start_tts": "Synthesizing speech",
    "tts_success": "Speech synthesis complete",
}

LANG_DIR = os.path.join(os.path.dirname(__file__), "languages")
_current: dict = dict(_EN)
_lang = "en-US"


def available_languages() -> list[str]:
    langs = ["en-US"]
    if os.path.isdir(LANG_DIR):
        langs += [f[:-5] for f in sorted(os.listdir(LANG_DIR))
                  if f.endswith(".json") and f[:-5] not in langs]
    return langs


def set_language(lang: str) -> None:
    """Load a locale over the baked-in defaults; an unknown locale keeps
    English."""
    global _current, _lang
    _lang = lang
    _current = dict(_EN)
    try:
        with open(os.path.join(LANG_DIR, f"{lang}.json"), encoding="utf-8") as f:
            _current.update(json.load(f))
    except FileNotFoundError:
        if lang != "en-US":
            logger.warning("no locale file for %s; using English", lang)


def current_language() -> str:
    return _lang


def catalog() -> dict:
    """The full active key -> string table (served to UI clients)."""
    return dict(_current)


def tr(key: str, **kwargs) -> str:
    s = _current.get(key, key)
    return s.format(**kwargs) if kwargs else s


set_language(os.environ.get("RVC_LANG", "en-US"))
