"""Prompt-based audio editing in PyTorch (counterpart of JAX
`edit/pipeline.py`): the reference's audioldm2 stage
(main/inference/audioldm2.py: parse_arguments:46-62, edit:122-128,
invert:88-94, sample:100-120) on the edit-friendly DDPM inversion of
`edit/ddpm_inversion.py`.

audio -> mel -> latent -> inversion under the source prompt -> reverse
chain under the target prompt -> mel -> audio, low-passed at 7.5 kHz,
resampled and written as a stereo tile.  The released AudioLDM2
checkpoints are not in the repository and nothing is fetched:
`load_audioldm2_stack` reads a local diffusers directory and raises as
JAX does; `ToyMelStack` (an identity VAE, a zero eps-predictor,
Griffin-Lim) and `edit/stack.py` `AudioLDM2Stack` built from a seed run
the whole pipeline offline.

A model stack is any object with a `device` and:
    get_mel(audio_16k)   -> (latent-domain x0 tensor, duration_s)
    vae_encode(mel)      -> latent w0
    make_eps_fn(prompt, cfg_ignored) -> eps_fn(x, t) -> (uncond, cond)
    vae_decode(w)        -> mel
    decode_to_mel(mel)   -> audio @ 16 kHz (numpy)
"""

from __future__ import annotations

import logging
import os
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from ..device import resolve_device
from ..errors import BadRequest
from .ddpm_inversion import (DDIMSchedule, inversion_forward, inversion_reverse,
                             low_pass_filter, make_schedule)

logger = logging.getLogger(__name__)

AUDIOLDM2_MODELS = ("audioldm2", "audioldm2-large", "audioldm2-music")


def load_audioldm2_stack(model_id: str = "audioldm2-music", device="cuda"):
    """The AudioLDM2 checkpoint stack from the local diffusers directory
    assets/models/audioldm2/<model_id> (the reference's load_model path,
    library/audioldm2/models.py:321-329).  Raises as JAX does: ValueError
    for an unknown id, RuntimeError for a missing directory,
    NotImplementedError once the weights are imported
    (`AudioLDM2Stack.load_from_dir`)."""
    if model_id not in AUDIOLDM2_MODELS:
        raise ValueError(f"unknown audioldm2 model {model_id!r}; "
                         f"expected one of {AUDIOLDM2_MODELS}")
    from .stack import AudioLDM2Stack

    return AudioLDM2Stack.load_from_dir(os.path.join("assets", "models", "audioldm2", model_id),
                                        device=device)


# --------------------------------------------------------------- mel tools


MEL_BINS = 64
MEL_NFFT = 1024
MEL_HOP = 160
MEL_SR = 16000


def _mel_filterbank(sr=MEL_SR, n_fft=MEL_NFFT, n_mels=MEL_BINS,
                    fmin=0.0, fmax=8000.0) -> np.ndarray:
    """Slaney-style triangular mel filterbank (F, n_mels), JAX's copy."""

    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        mel = f / (200.0 / 3)
        log_region = f >= 1000.0
        return np.where(log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                        / (np.log(6.4) / 27.0), mel)

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        f = m * (200.0 / 3)
        log_region = m >= 15.0
        return np.where(log_region, 1000.0 * np.exp((m - 15.0) * (np.log(6.4) / 27.0)), f)

    n_freqs = n_fft // 2 + 1
    freqs = np.linspace(0, sr / 2, n_freqs)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_freqs, n_mels))
    for i in range(n_mels):
        lo, ctr, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[:, i] = np.maximum(0.0, np.minimum(up, down))
        fb[:, i] *= 2.0 / (hi - lo)
    return fb.astype(np.float32)


def _hann(n_fft: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / n_fft)


def _stft_mag(audio: np.ndarray, n_fft=MEL_NFFT, hop=MEL_HOP) -> np.ndarray:
    x = np.pad(np.asarray(audio, np.float32), (n_fft // 2, n_fft // 2), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    return np.abs(np.fft.rfft(x[idx] * _hann(n_fft).astype(np.float32), axis=-1)).T  # (F, T)


def griffin_lim(mag: np.ndarray, n_fft=MEL_NFFT, hop=MEL_HOP, iters: int = 32,
                seed: int = 0) -> np.ndarray:
    """Phase reconstruction from a magnitude spectrogram (F, T), on the
    host, JAX's numpy with its RandomState(seed) phases."""
    rs = np.random.RandomState(seed)
    angles = np.exp(2j * np.pi * rs.rand(*mag.shape))
    win = _hann(n_fft)

    def istft(spec):
        t = np.fft.irfft(spec.T, n=n_fft, axis=-1) * win
        frames = t.shape[0]
        total = (frames - 1) * hop + n_fft
        idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
        y = np.zeros(total)
        np.add.at(y, idx.reshape(-1), t.reshape(-1))
        norm = np.zeros(total)
        np.add.at(norm, idx.reshape(-1), np.tile(win ** 2, (frames, 1)).reshape(-1))
        y = y / np.maximum(norm, 1e-11)
        return y[n_fft // 2:-(n_fft // 2)]

    def stft(y):
        ypad = np.pad(y, (n_fft // 2, n_fft // 2), mode="reflect")
        frames = 1 + (len(ypad) - n_fft) // hop
        idx = np.arange(frames)[:, None] * hop + np.arange(n_fft)[None, :]
        return np.fft.rfft(ypad[idx] * win, axis=-1).T

    spec = mag * angles
    for _ in range(iters):
        rebuilt = stft(istft(spec))[:, :mag.shape[1]]
        if rebuilt.shape[1] < mag.shape[1]:
            rebuilt = np.pad(rebuilt, ((0, 0), (0, mag.shape[1] - rebuilt.shape[1])))
        spec = mag * np.exp(1j * np.angle(rebuilt))
    return istft(spec).astype(np.float32)


class ToyMelStack:
    """A self-contained latent stack: log-mel "latents" on `device` with
    an identity VAE, a zero eps-predictor and Griffin-Lim on the host.
    It runs the whole edit pipeline (scheduler math, noise maps, reverse
    chain, mel inversion) without pretrained weights."""

    def __init__(self, n_mels: int = MEL_BINS, device="cuda"):
        self.device = resolve_device(device)
        self.n_mels = n_mels
        self._fb = _mel_filterbank(n_mels=n_mels)
        self._pinv = np.linalg.pinv(self._fb)    # (n_mels, F)

    def get_mel(self, audio_16k: np.ndarray):
        mel = np.log(np.maximum(self._fb.T @ _stft_mag(audio_16k), 1e-5))   # (M, T)
        return (torch.as_tensor(mel, dtype=torch.float32, device=self.device),
                len(audio_16k) / MEL_SR)

    def vae_encode(self, mel):
        return mel

    def make_eps_fn(self, prompt: str, cfg_scale: float) -> Callable:
        del prompt, cfg_scale

        def eps_fn(x, t):
            return torch.zeros_like(x), None

        return eps_fn

    def vae_decode(self, w):
        return w

    def decode_to_mel(self, mel) -> np.ndarray:
        mel = mel.detach().cpu().numpy().astype(np.float64)
        return griffin_lim(np.maximum(self._pinv.T @ np.exp(mel), 0.0))


# ------------------------------------------------------------------- edit


def edit(input_path: str, output_path: str, *, model_id: str = "audioldm2-music",
         source_prompt: str = "", target_prompt: str = "", steps: int = 50,
         cfg_scale_src: float = 3.5, cfg_scale_tar: float = 12.0, t_start: int = 45,
         save_compute: bool = True, sr: int = 44100, export_format: str = "wav",
         stack=None, seed: int = 0, schedule: DDIMSchedule | None = None,
         device="cuda", noise: torch.Tensor | None = None) -> str:
    """Invert the input under the source prompt, re-run the reverse chain
    under the target prompt, decode, polish and write (reference
    audioldm2.py edit:122-128 / invert:88-94 / sample:100-120).

    t_start is a percentage (tstart = t_start / 100 * steps).  The
    marginals' noise is drawn from a torch.Generator on `device` seeded
    `seed`, or given as `noise` (steps, *latent shape), for example JAX's
    draw.  `stack` must live on `device`; without one the checkpoint
    stack is loaded there (and raises offline, as in JAX).  Each stage
    runs in a profiler range: edit.vae (the mel, the encode, the decode),
    edit.text (both prompts' streams), edit.inversion, edit.reverse and
    edit.vocoder.  Returns the path written."""
    from ..utils.audio import load_audio, resample, save_audio

    dev = resolve_device(device)
    if stack is None:
        stack = load_audioldm2_stack(model_id, device=dev)
    if torch.device(stack.device).type != dev.type:
        raise BadRequest(f"the model stack is on {stack.device}, the edit on {dev}")
    del save_compute  # shared-forward optimisation: N/A, as in JAX

    audio = load_audio(input_path, target_sr=MEL_SR)
    sched = schedule or make_schedule(steps)
    with torch.inference_mode():
        with record_function("edit.vae"):
            x0, duration = stack.get_mel(np.asarray(audio))
            w0 = stack.vae_encode(x0)
        rng = noise if noise is not None else torch.Generator(device=dev).manual_seed(seed)
        with record_function("edit.text"):
            eps_src = stack.make_eps_fn(source_prompt, cfg_scale_src)
        with record_function("edit.inversion"):
            _, zs, wts = inversion_forward(eps_src, w0, sched, cfg_scale=cfg_scale_src,
                                           etas=1.0, rng=rng, numerical_fix=True)
        with record_function("edit.text"):
            eps_tar = stack.make_eps_fn(target_prompt, cfg_scale_tar)
        with record_function("edit.reverse"):
            w_edit = inversion_reverse(eps_tar, wts, zs, sched,
                                       tstart=int(t_start / 100 * steps),
                                       cfg_scale=cfg_scale_tar, etas=1.0)
        with record_function("edit.vae"):
            mel = stack.vae_decode(w_edit)
        with record_function("edit.vocoder"):
            out = np.asarray(stack.decode_to_mel(mel), np.float32)

    orig_sr = MEL_SR
    if sr != MEL_SR and sr > 0:
        out, orig_sr = resample(out, orig_sr, sr), sr
    out = low_pass_filter(out, 7500.0, orig_sr)
    # the reference writes a stereo tile (audioldm2.py:119)
    written = save_audio(output_path, np.tile(out, (2, 1)).T, orig_sr,
                         export_format=export_format)
    logger.info("edited %s -> %s (%.2fs source)", input_path, written, duration)
    return written
