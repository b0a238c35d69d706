"""Dataset creation: gather audio, isolate the vocals, clean, write the
dataset (counterpart of JAX `pipelines/create_dataset.py`; reference
main/inference/create_dataset.py).

Each input is a local audio path or a URL (YouTube through
`utils/youtube.py`, any other through `utils/downloads.py`, which need a
network).  It is mixed to mono and resampled on the host, its head and
tail skipped, its vocals isolated by Demucs (`pipelines/separate.py`
`separate_vocals`, on the device its weights were loaded to) and gated
by the noise gate (`utils/noisereduce.py` `reduce_noise`, on `device`),
then written as float32 WAV into the dataset directory.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from typing import Any, Optional, Sequence

import numpy as np

from ..device import resolve_device
from ..utils.audio import read_wav, resample, save_wav
from ..utils.i18n import tr

logger = logging.getLogger(__name__)


def _parse_time(value: str | float) -> float:
    """'90', '1:30' or '0:01:30' -> seconds."""
    if isinstance(value, (int, float)):
        return float(value)
    out = 0.0
    for p in (float(p) for p in str(value).split(":")):
        out = out * 60 + p
    return out


def _fetch(src: str, local: str, sample_rate: int) -> str:
    from ..utils.youtube import download_audio_wav, is_youtube_url

    if is_youtube_url(src):
        # the reference's yt-dlp bestaudio (create_dataset.py:135-146)
        return download_audio_wav(src, local, sample_rate=sample_rate)
    from ..utils.downloads import download_url

    return download_url(src, local)


def create_dataset(inputs: Sequence[str], output_dataset: str, *,
                   sample_rate: int = 44100,
                   skip_start: Optional[Sequence[str]] = None,
                   skip_end: Optional[Sequence[str]] = None,
                   separator: Optional[tuple[Any, Any]] = None,
                   clean_dataset: bool = False,
                   clean_strength: float = 0.7,
                   workdir: Optional[str] = None,
                   device="cuda") -> list[str]:
    """inputs: local audio paths or URLs.  separator: (demucs params,
    DemucsConfig) from `interop/demucs_load.py`, whose vocals replace
    each input.  The noise gate runs on `device`, the card unless the
    caller passes "cpu".  workdir: where downloads and the files in
    progress go, removed at the end; a new temporary directory when None
    (JAX's default is one fixed path under /tmp).  Returns the dataset
    files written."""
    dev = resolve_device(device)
    workdir = tempfile.mkdtemp(prefix="rvc_dataset_") if workdir is None else workdir
    os.makedirs(workdir, exist_ok=True)
    os.makedirs(output_dataset, exist_ok=True)
    try:
        paths: list[str] = []
        for i, src in enumerate(inputs):
            local = src
            if src.startswith(("http://", "https://")):
                local = _fetch(src, os.path.join(workdir, f"audio_{i}.wav"), sample_rate)
            audio, sr = read_wav(local)
            if audio.ndim == 2:
                audio = audio.mean(axis=1)
            audio = resample(audio, sr, sample_rate)
            sr = sample_rate

            if skip_start is not None and i < len(skip_start):
                audio = audio[int(_parse_time(skip_start[i]) * sr):]
            if skip_end is not None and i < len(skip_end):
                n = int(_parse_time(skip_end[i]) * sr)
                if n > 0:
                    audio = audio[:-n]

            if separator is not None:
                from .separate import separate_vocals

                params, dcfg = separator
                vocals, _ = separate_vocals(params, dcfg, audio, sr, shifts=0)
                audio = vocals.mean(axis=1)
                sr = dcfg.samplerate

            if clean_dataset:
                from ..utils.noisereduce import reduce_noise

                audio = reduce_noise(audio.astype(np.float32), sr, prop_decrease=clean_strength,
                                     device=dev)

            out_path = os.path.join(workdir, f"dataset_{i}.wav")
            save_wav(out_path, audio.astype(np.float32), sr, subtype="float32")
            paths.append(out_path)

        final_paths = []
        for p in paths:
            dst = os.path.join(output_dataset, os.path.basename(p))
            shutil.move(p, dst)
            final_paths.append(dst)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    logger.info("%s: %d files in %s", tr("createdataset"), len(final_paths), output_dataset)
    return final_paths
