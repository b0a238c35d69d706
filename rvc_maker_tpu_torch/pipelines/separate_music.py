"""The whole stem-separation chain (counterpart of JAX
`pipelines/separate_music.py`; reference separator_music.py).

Main separation (a Demucs `.th` or `.yaml` bag, or an MDX `.onnx`) ->
optional karaoke main / backing split (MDX KARA models) -> optional
dereverb (the Reverb_HQ MDX model) of the vocals, the main and the
backing vocals -> optional spectral-gate cleanup of every stem
(`utils/noisereduce.py`); each stage writes named stems
(separator_music.py:115-146).  Everything runs on `settings.device`,
the card unless the caller asks for the CPU.

The registries name the reference's files (separator_music.py:36-38).
A model is a path, or a registry name whose file is in `model_dir` or
is downloaded there (`utils/bootstrap.py`); an unknown name raises.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..device import resolve_device
from ..errors import BadRequest
from ..utils.audio import read_wav, resample, save_audio
from ..utils.i18n import tr

logger = logging.getLogger(__name__)

DEMUCS_MODELS = {"HT-Tuned": "htdemucs_ft.yaml", "HT-Normal": "htdemucs.yaml",
                 "HD_MMI": "hdemucs_mmi.yaml", "HT_6S": "htdemucs_6s.yaml"}
KARA_MODELS = {"Version-1": "UVR_MDXNET_KARA.onnx",
               "Version-2": "UVR_MDXNET_KARA_2.onnx"}
REVERB_MODEL = "Reverb_HQ_By_FoxJoy.onnx"
MDX_MODELS = {
    name: f"{file}.onnx" for name, file in {
        "Main_340": "UVR-MDX-NET_Main_340", "Main_390": "UVR-MDX-NET_Main_390",
        "Main_406": "UVR-MDX-NET_Main_406", "Main_427": "UVR-MDX-NET_Main_427",
        "Main_438": "UVR-MDX-NET_Main_438",
        "Inst_full_292": "UVR-MDX-NET-Inst_full_292",
        "Inst_HQ_1": "UVR-MDX-NET-Inst_HQ_1", "Inst_HQ_2": "UVR-MDX-NET-Inst_HQ_2",
        "Inst_HQ_3": "UVR-MDX-NET-Inst_HQ_3", "Inst_HQ_4": "UVR-MDX-NET-Inst_HQ_4",
        "Inst_HQ_5": "UVR-MDX-NET-Inst_HQ_5",
        "Kim_Vocal_1": "Kim_Vocal_1", "Kim_Vocal_2": "Kim_Vocal_2",
        "Kim_Inst": "Kim_Inst",
        "Voc_FT": "UVR-MDX-NET-Voc_FT", "Crowd_HQ": "UVR-MDX-NET_Crowd_HQ_1",
        "Inst_1": "UVR-MDX-NET-Inst_1", "Inst_2": "UVR-MDX-NET-Inst_2",
        "Inst_3": "UVR-MDX-NET-Inst_3", "Inst_Main": "UVR-MDX-NET-Inst_Main",
        "MDXNET_Main": "UVR_MDXNET_Main", "MDXNET_9482": "UVR_MDXNET_9482",
    }.items()
}


@dataclass
class SeparationSettings:
    model_name: str = "HT-Normal"        # a Demucs or MDX registry name, or a path
    kara_model: str = "Version-1"
    reverb_model: str = "Reverb_HQ"
    backing: bool = False                # split main / backing vocals
    reverb: bool = False                 # dereverb pass (Reverb_HQ)
    backing_reverb: bool = False
    clean_audio: bool = False
    clean_strength: float = 0.7
    shifts: int = 2
    sample_rate: int = 44100
    export_format: str = "wav"
    mdx_denoise: bool = False
    mdx_overlap: float = 0.25
    mdx_hop: int = 1024
    mdx_n_fft: int = 6144                # the reference registry's value for most models
    model_dir: str = field(
        default_factory=lambda: os.path.join(
            os.environ.get("RVC_TPU_ASSETS", "assets"), "models", "uvr5"))
    device: str = "cuda"


def _resolve_model(name_or_path: str, settings: SeparationSettings) -> str:
    """An existing path as it is; a registry name -> its file in
    settings.model_dir, downloaded there when it is missing, as the
    reference's Separator.load_model does (JAX separate_music.py:76-91)."""
    if os.path.exists(name_or_path):
        return name_or_path
    fname = (DEMUCS_MODELS.get(name_or_path) or MDX_MODELS.get(name_or_path)
             or KARA_MODELS.get(name_or_path)
             or (REVERB_MODEL if name_or_path == "Reverb_HQ" else None))
    if fname is None:
        raise BadRequest(f"unknown separation model {name_or_path!r}: give a path or a "
                         "registry name")
    path = os.path.join(settings.model_dir, fname)
    if not os.path.exists(path):
        from ..utils.bootstrap import HF_BASE, _download

        _download(f"{HF_BASE}uvr5/{fname}", path)
    return path


def _separate_once(stereo: np.ndarray, sr: int, model_path: str, settings: SeparationSettings):
    """One separation pass -> (target stem, other stem), each (2, L) at
    `sr`.  stereo: (2, L)."""
    if model_path.endswith(".onnx"):
        from ..interop.onnx_run import OnnxGraph
        from . import mdx as mdx_mod

        graph = OnnxGraph(model_path, device=settings.device)
        p = mdx_mod.params_from_graph(graph, n_fft=settings.mdx_n_fft,
                                      hop_length=settings.mdx_hop, overlap=settings.mdx_overlap,
                                      enable_denoise=settings.mdx_denoise)
        return mdx_mod.mdx_separate(graph, stereo, p)
    from ..interop.demucs_load import load_demucs_bag, load_demucs_th
    from .separate import apply_bag, separate_vocals

    if model_path.endswith((".yaml", ".yml")):
        bag = load_demucs_bag(model_path, device=settings.device)
        # (1, 2, L); JAX passes stereo.T[None], (1, L, 2), to apply_bag here
        out = apply_bag(bag, stereo[None].astype(np.float32), shifts=settings.shifts)
        sources = bag[0][1].sources
        v_idx = sources.index("vocals")
        return out[0, v_idx], sum(out[0, k] for k in range(len(sources)) if k != v_idx)
    params, dcfg = load_demucs_th(model_path, device=settings.device)
    vocals, inst = separate_vocals(params, dcfg, stereo.T.astype(np.float32), sr,
                                   shifts=settings.shifts)
    return vocals.T, inst.T


def separate_music(input_path: str, output_dir: str,
                   settings: Optional[SeparationSettings] = None) -> dict[str, str]:
    """The reference `separation` flow (separator_music.py:115-146): the
    stems written under output_dir/<input name>/; returns {stem name:
    path}."""
    s = settings or SeparationSettings()
    dev = resolve_device(s.device)
    name = os.path.splitext(os.path.basename(input_path))[0]
    out_dir = os.path.join(output_dir, name)

    main_model = _resolve_model(s.model_name, s)
    kara = _resolve_model(s.kara_model, s) if s.backing else None
    reverb_model = _resolve_model(s.reverb_model, s) if s.reverb else None
    os.makedirs(out_dir, exist_ok=True)

    audio, sr = read_wav(input_path)
    if audio.ndim == 1:
        audio = np.stack([audio, audio], axis=1)
    if sr != s.sample_rate:
        audio = resample(audio, sr, s.sample_rate)
        sr = s.sample_rate
    stereo = audio.T.astype(np.float32)                     # (2, L)

    written: dict[str, str] = {}

    def _write(stem: str, wav_2xl: np.ndarray) -> None:
        data = np.asarray(wav_2xl, np.float32).T
        if s.clean_audio:
            from ..utils.noisereduce import reduce_noise

            data = np.stack([reduce_noise(data[:, c], sr, prop_decrease=s.clean_strength,
                                          device=dev)
                             for c in range(data.shape[1])], axis=1)
        written[stem] = save_audio(os.path.join(out_dir, f"{stem}.{s.export_format}"),
                                   data, sr, s.export_format)

    logger.info("%s [%s]", tr("separator_process_2"), os.path.basename(main_model))
    vocals, instruments = _separate_once(stereo, sr, main_model, s)
    _write("Original_Vocals", vocals)
    _write("Instruments", instruments)

    main_vocals = vocals
    if s.backing:
        logger.info("%s", tr("karaoke_split", model=os.path.basename(kara)))
        main_vocals, backing_vocals = _separate_once(vocals, sr, kara, s)
        _write("Main_Vocals", main_vocals)
        _write("Backing_Vocals", backing_vocals)

    if s.reverb:
        logger.info("%s [%s]", tr("dereverb"), os.path.basename(reverb_model))
        _, dry = _separate_once(vocals, sr, reverb_model, s)
        _write("Original_Vocals_No_Reverb", dry)
        if s.backing:
            _, main_dry = _separate_once(main_vocals, sr, reverb_model, s)
            _write("Main_Vocals_No_Reverb", main_dry)
            if s.backing_reverb:
                _, back_dry = _separate_once(backing_vocals, sr, reverb_model, s)
                _write("Backing_Vocals_No_Reverb", back_dry)
    return written
