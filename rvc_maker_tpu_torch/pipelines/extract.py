"""Feature extraction for training: F0 and HuBERT features per segment.

Counterpart of `rvc_maker_tpu/pipelines/extract.py` (reference
main/inference/extract.py), with every F0 method of the JAX package's
extract:
  * stage A: F0 per 16 kHz segment -> `f0/` (coarse 1..255 int) and
    `f0_voiced/` (Hz).  The device methods (rmvpe, rmvpe-legacy, yin,
    fcpe, fcpe-legacy) run batched on the device; the host ones (pyin,
    swipe, pm, dio, harvest, crepe-*, mangio-crepe-*) and hybrid[a+b+...]
    one segment at a time, through the dispatch of `pipelines/convert.py`
    (`device_f0`, `host_f0_row` with JAX extract's NaN rule).
  * stage B: HuBERT features -> `{v1,v2}_extracted/*.npy` (T x 768 from
    layer 12 for v2; T x 256 through final_proj for v1), NaN-checked
  * a silent MUTE fixture row set, and `filelist.txt`
    (`wav|feature.npy|f0|f0nsf|sid` rows over the stems every stage
    produced, plus 2 mute rows, shuffled) with `config.json`.
Segments are bucketed by length (whole seconds) and run through the
models in batches on `device` (the card unless the caller asks for the
CPU).  Params are the port's trees (`models.rmvpe`, `models.hubert`
loaders or `interop.from_jax`); the features may also come from an
`.onnx` embedder (`interop.onnx_embedder.OnnxEmbedder`).
"""

from __future__ import annotations

import logging
import os
import random

import numpy as np
import torch

from ..config import RVCConfig
from ..device import resolve_device, tree_to
from ..f0.common import coarse_f0
from ..interop.onnx_embedder import OnnxEmbedder
from ..models import hubert as hubert_mod
from ..utils.audio import load_audio, save_wav
from .convert import DEVICE_F0, device_f0, host_f0_row

logger = logging.getLogger(__name__)

SR16K = 16000
WINDOW = 160


def _bucket(n: int, step: int = SR16K) -> int:
    return int(np.ceil(max(n, step) / step)) * step


def _batches(audios: dict, batch_size: int):
    """(names, (B, L) zero-padded batch, lengths) per bucket and chunk."""
    by_bucket: dict[int, list[str]] = {}
    for n, a in audios.items():
        by_bucket.setdefault(_bucket(len(a)), []).append(n)
    for L, group in sorted(by_bucket.items()):
        for i in range(0, len(group), batch_size):
            chunk = group[i : i + batch_size]
            batch = np.zeros((len(chunk), L), np.float32)
            for j, n in enumerate(chunk):
                batch[j, : len(audios[n])] = audios[n]
            yield chunk, batch, np.array([len(audios[n]) for n in chunk])


def _pending(wav_dir: str, out_dir: str, out_name) -> dict:
    names = [n for n in sorted(os.listdir(wav_dir)) if n.endswith(".wav")
             if not os.path.exists(os.path.join(out_dir, out_name(n)))]
    return {n: load_audio(os.path.join(wav_dir, n), SR16K) for n in names}


@torch.inference_mode()
def extract_f0(exp_dir: str, rmvpe_params=None, *, method: str = "rmvpe",
               crepe_params=None, fcpe_params=None, hop_length: int = 160,
               batch_size: int = 8, device: str | torch.device = "cuda") -> int:
    """Stage A with any F0 method (module docstring).  Each method needs
    the params of its network (rmvpe_params for rmvpe*, fcpe_params for
    fcpe*, crepe_params for *crepe*; the port's trees) and raises without
    them.  hop_length is the frame hop of pyin and mangio-crepe.  Returns
    the number of segments processed."""
    dev = resolve_device(device)
    nets = {"rmvpe": rmvpe_params, "fcpe": fcpe_params, "crepe": crepe_params}
    nets = {k: None if v is None else tree_to(v, dev, torch.float32) for k, v in nets.items()}

    def params(name, m):
        if nets[name] is None:
            raise ValueError(f"{name}_params not loaded: f0 method {m!r} needs them")
        return nets[name]

    wav_dir = os.path.join(exp_dir, "sliced_audios_16k")
    f0_dir = os.path.join(exp_dir, "f0")
    f0v_dir = os.path.join(exp_dir, "f0_voiced")
    os.makedirs(f0_dir, exist_ok=True)
    os.makedirs(f0v_dir, exist_ok=True)
    audios = _pending(wav_dir, f0v_dir, lambda n: n + ".npy")
    done = 0
    for chunk, batch, _ in _batches(audios, batch_size):
        if method in DEVICE_F0:
            f0 = device_f0(method, torch.as_tensor(batch, device=dev), params).cpu()
            coarse = coarse_f0(f0).numpy()
        else:
            # float64 Hz, one segment at a time (JAX extract.py:172-179); the
            # coarse codes from its fp32 values, as JAX computes them
            f0 = np.stack([host_f0_row(method, row, hop_length=hop_length, params=params,
                                       device=dev, extract_rule=True) for row in batch])
            coarse = coarse_f0(torch.as_tensor(f0, dtype=torch.float32)).numpy()
        f0 = np.asarray(f0)
        for i, n in enumerate(chunk):
            p_len = len(audios[n]) // WINDOW
            np.save(os.path.join(f0_dir, n + ".npy"), coarse[i, :p_len],
                    allow_pickle=False)
            np.save(os.path.join(f0v_dir, n + ".npy"), f0[i, :p_len],
                    allow_pickle=False)
            done += 1
    logger.info("f0 (%s) extracted for %d segments", method, done)
    return done


def _features(params, audio, lengths, version: str):
    """HuBERT's features and frame lengths; an `.onnx` embedder
    (`interop.onnx_embedder.OnnxEmbedder`, its v1 projection inside the
    graph) runs on its own device."""
    if isinstance(params, OnnxEmbedder):
        if lengths is None:
            lengths = torch.full((audio.shape[0],), audio.shape[1], device=audio.device)
        return params.features(audio, lengths), hubert_mod.frame_lengths(lengths)
    feats, fl = hubert_mod.extract_features(params, audio, lengths,
                                            output_layer=12 if version == "v2" else 9)
    if version == "v1":
        feats = hubert_mod.final_proj(params, feats)
    return feats, fl


@torch.inference_mode()
def extract_embeddings(exp_dir: str, hubert_params, *, version: str = "v2",
                       batch_size: int = 8, device: str | torch.device = "cuda") -> int:
    """Stage B.  Returns the number of segments processed."""
    dev = resolve_device(device)
    params = tree_to(hubert_params, dev, torch.float32)
    wav_dir = os.path.join(exp_dir, "sliced_audios_16k")
    out_dir = os.path.join(exp_dir, f"{version}_extracted")
    os.makedirs(out_dir, exist_ok=True)
    audios = _pending(wav_dir, out_dir, lambda n: n.replace(".wav", ".npy"))
    done = 0
    for chunk, batch, lengths in _batches(audios, batch_size):
        feats, fl = _features(params, torch.as_tensor(batch, device=dev),
                              torch.as_tensor(lengths, device=dev), version)
        feats, fl = feats.cpu().numpy(), fl.cpu().numpy()
        for i, n in enumerate(chunk):
            out = feats[i, : fl[i]]
            if np.isnan(out).any():
                logger.warning("%s: NaN in the features, skipped", n)
                continue
            np.save(os.path.join(out_dir, n.replace(".wav", ".npy")), out,
                    allow_pickle=False)
            done += 1
    logger.info("features extracted for %d segments", done)
    return done


@torch.inference_mode()
def write_mute_fixture(exp_dir: str, cfg: RVCConfig, hubert_params,
                       version: str = "v2", device: str | torch.device = "cuda") -> None:
    """The silent fixture rows (the reference ships them as assets/logs/
    mute*; they are made here): 3 s of silence at both rates, its f0 at
    L // 160 + 1 frames, its features."""
    dev = resolve_device(device)
    sr = cfg.data.sample_rate
    mute_dir = os.path.join(exp_dir, "mute")
    for sub in ("sliced_audios", "sliced_audios_16k", f"{version}_extracted",
                "f0", "f0_voiced"):
        os.makedirs(os.path.join(mute_dir, sub), exist_ok=True)
    n16 = SR16K * 3
    save_wav(os.path.join(mute_dir, "sliced_audios", f"mute{sr}.wav"),
             np.zeros(sr * 3, np.float32), sr, subtype="float32")
    save_wav(os.path.join(mute_dir, "sliced_audios_16k", "mute.wav"),
             np.zeros(n16, np.float32), SR16K, subtype="float32")
    p_len = n16 // WINDOW + 1
    np.save(os.path.join(mute_dir, "f0", "mute.wav.npy"),
            np.ones(p_len, np.int32), allow_pickle=False)
    np.save(os.path.join(mute_dir, "f0_voiced", "mute.wav.npy"),
            np.zeros(p_len, np.float64), allow_pickle=False)
    feats, _ = _features(tree_to(hubert_params, dev, torch.float32),
                         torch.zeros((1, n16), device=dev), None, version)
    np.save(os.path.join(mute_dir, f"{version}_extracted", "mute.npy"),
            feats[0].cpu().numpy(), allow_pickle=False)


def generate_filelist(exp_dir: str, cfg: RVCConfig, version: str = "v2",
                      seed: int | None = None) -> str:
    """Rows over the stems present in every artifact dir, plus 2 mute
    rows, shuffled (by `seed` when given); writes filelist.txt and
    config.json (reference extract.py:52-77)."""
    gt_dir = os.path.join(exp_dir, "sliced_audios")
    feat_dir = os.path.join(exp_dir, f"{version}_extracted")
    f0_dir = os.path.join(exp_dir, "f0")
    f0v_dir = os.path.join(exp_dir, "f0_voiced")
    gt = {n[:-4] for n in os.listdir(gt_dir) if n.endswith(".wav")}
    feat = {n[:-4] for n in os.listdir(feat_dir) if n.endswith(".npy")}
    f0s = {n[: -len(".wav.npy")] for n in os.listdir(f0_dir)}
    f0vs = {n[: -len(".wav.npy")] for n in os.listdir(f0v_dir)}
    rows = ["|".join([os.path.join(gt_dir, n + ".wav"),
                      os.path.join(feat_dir, n + ".npy"),
                      os.path.join(f0_dir, n + ".wav.npy"),
                      os.path.join(f0v_dir, n + ".wav.npy"),
                      n.split("_")[0]])
            for n in sorted(gt & feat & f0s & f0vs)]
    mute_dir = os.path.join(exp_dir, "mute")
    if os.path.isdir(mute_dir):
        mute_row = "|".join([
            os.path.join(mute_dir, "sliced_audios", f"mute{cfg.data.sample_rate}.wav"),
            os.path.join(mute_dir, f"{version}_extracted", "mute.npy"),
            os.path.join(mute_dir, "f0", "mute.wav.npy"),
            os.path.join(mute_dir, "f0_voiced", "mute.wav.npy"),
            "0",
        ])
        rows += [mute_row, mute_row]
    random.Random(seed).shuffle(rows)
    path = os.path.join(exp_dir, "filelist.txt")
    with open(path, "w") as f:
        f.write("\n".join(rows))
    with open(os.path.join(exp_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    logger.info("wrote %s (%d rows)", path, len(rows))
    return path
