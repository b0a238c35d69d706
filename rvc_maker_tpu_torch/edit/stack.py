"""The AudioLDM2 model stack of the editing pipeline in PyTorch
(counterpart of JAX `edit/stack.py`).

The model-stack protocol of `edit/pipeline.py` (get_mel / vae_encode /
make_eps_fn / vae_decode / decode_to_mel; reference
main/library/audioldm2/models.py:169-320) on `models/audioldm2*.py`:

  audio -> log-mel (64 bins, the reference's MelSpectrogramProcessor)
  -> VAE latent (.mode * scaling) -> UNet eps on the two text streams
  (CLAP pooled + T5 tokens -> projection -> GPT2 generation; T5 tokens)
  -> VAE decode -> SpeechT5 HiFi-GAN.

Latents are (Z, t, f) on the stack's device.  `published_dims` holds the
component sizes of the released cvssp/audioldm2 stack as the JAX package
records them; `tiny_dims` those of JAX `AudioLDM2Stack.init_tiny`.
`interop/from_jax.py` `random_audioldm2_stack` builds either from a
seed on the device (`init_tiny` is the tiny one);
`load_components_from_dir` imports a local diffusers checkpoint
directory through the port's safetensors reader, and `load_from_dir`
then raises NotImplementedError, as JAX does (the tokenizer files and the
per-component configs are not wired in).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models import audioldm2 as am
from ..models import audioldm2_text as at
from ..ops.stft import hann_window, stft_magnitude
from .pipeline import MEL_BINS, MEL_HOP, MEL_NFFT, MEL_SR, _mel_filterbank


def audioldm2_mel(audio_16k, n_mels: int = MEL_BINS, device="cpu"):
    """The reference's MelSpectrogramProcessor.compute_mel_spectrogram
    (models.py:160-167): |STFT| (1024 / 160 / 1024, hann, centered) ->
    slaney mel -> log clamped at 1e-5.  Returns (T, n_mels) fp32 on
    `device`."""
    audio = torch.as_tensor(np.asarray(audio_16k, np.float32), device=device)
    mag = stft_magnitude(audio[None], n_fft=MEL_NFFT, hop_length=MEL_HOP, win_length=MEL_NFFT,
                         window=hann_window(MEL_NFFT), center=True)[0]
    fb = torch.as_tensor(_mel_filterbank(n_mels=n_mels), device=device)   # (F, n_mels)
    return torch.log(torch.clamp(mag @ fb, min=1e-5))


def published_dims() -> dict:
    """The published cvssp/audioldm2 component sizes, as far as the JAX
    package and the reference record them: CLAP text (RoBERTa-base,
    projection 512), the flan-T5-large encoder, GPT2 (768 wide, 12
    layers, 8 new tokens), the projection 512 / 1024 -> 768; the UNet
    (128, 256, 384, 640), 2 layers per block, slots (None, 768, 1024),
    no attention in the first down and the last up block (the original
    config's attention resolutions 8 / 4 / 2), head_dim 8 (JAX's importer
    default); the VAE (128, 256, 512) with an 8-channel latent; the
    vocoder at 64 mels, 1024 initial channels, rates (5, 4, 2, 2, 2)."""
    return dict(
        vae=am.VAEConfig(block_out_channels=(128, 256, 512), latent_channels=8),
        unet=am.UNetConfig(in_channels=8, block_out_channels=(128, 256, 384, 640),
                           layers_per_block=2, cross_dims=(None, 768, 1024), head_dim=8),
        unet_attn=(False, True, True, True),
        voc=am.VocoderConfig(model_in_dim=MEL_BINS, upsample_initial_channel=1024),
        clap=at.ClapTextConfig(), t5=at.T5Config(), gpt2=at.GPT2Config(),
        gpt2_positions=1024, max_new_tokens=8, n_mels=MEL_BINS)


def tiny_dims(n_mels: int = 16) -> dict:
    """JAX `AudioLDM2Stack.init_tiny`'s sizes (every block with attention)."""
    return dict(
        vae=am.VAEConfig(block_out_channels=(8, 16), latent_channels=4, layers_per_block=1,
                         norm_groups=4),
        unet=am.UNetConfig(in_channels=4, block_out_channels=(8, 16), layers_per_block=1,
                           n_heads=2, cross_dim=12, cross_dim_1=20, norm_groups=4),
        unet_attn=(True, True),
        voc=am.VocoderConfig(model_in_dim=n_mels, upsample_initial_channel=16,
                             upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
                             resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),)),
        clap=at.ClapTextConfig(vocab_size=97, hidden_size=16, n_layers=1, n_heads=2,
                               intermediate_size=32, max_position_embeddings=64,
                               projection_dim=8),
        t5=at.T5Config(vocab_size=97, d_model=20, d_kv=5, d_ff=32, n_layers=1, n_heads=4,
                       rel_buckets=8, rel_max_distance=16),
        gpt2=at.GPT2Config(n_embd=12, n_layers=1, n_heads=2),
        gpt2_positions=128, max_new_tokens=3, n_mels=n_mels)


def byte_tokenizer(vocab_size: int) -> Callable:
    """JAX init_tiny's offline tokenizer (the real tokenizer files are not
    in the repository): a prompt's UTF-8 bytes -> ids mod (vocab - 2) + 2,
    the same ids for CLAP and T5."""
    def tokenize(prompt: str):
        data = prompt.encode() or b"\x00"
        ids = (np.frombuffer(data, np.uint8).astype(np.int32) % (vocab_size - 2) + 2)[None, :]
        mask = np.ones_like(ids)
        return ids, mask, ids, mask

    return tokenize


@dataclass
class AudioLDM2Stack:
    vae_cfg: am.VAEConfig
    unet_cfg: am.UNetConfig
    voc_cfg: am.VocoderConfig
    clap_cfg: at.ClapTextConfig
    t5_cfg: at.T5Config
    gpt2_cfg: at.GPT2Config
    params: dict
    tokenize: Callable          # prompt -> (clap_ids, clap_mask, t5_ids, t5_mask)
    max_new_tokens: int = 8
    n_mels: int = MEL_BINS
    device: torch.device | str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ---------------------------------------------------------- protocol

    def get_mel(self, audio_16k: np.ndarray):
        return audioldm2_mel(audio_16k, self.n_mels, self.device), len(audio_16k) / MEL_SR

    def vae_encode(self, mel):
        """(T, M) log-mel -> latent (Z, t, f); T padded at the front to a
        multiple of 4, as the reference pads it (models.py:183-184)."""
        x = mel[None, None]                                 # (1, 1, T, M)
        t = x.shape[2]
        if t % 4:
            x = F.pad(x, (0, 0, 4 - t % 4, 0))
        return am.vae_encode_mode(self.params["vae"], self.vae_cfg, x)[0]

    def _ids(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _encode_prompt(self, prompt: str):
        """(stream 0: the GPT2-generated embeddings, stream 1: the T5
        tokens), as the reference's encode_text returns them."""
        clap_ids, clap_mask, t5_ids, t5_mask = self.tokenize(prompt)
        p = self.params
        clap = at.clap_get_text_features(p["clap"], self.clap_cfg, self._ids(clap_ids),
                                         self._ids(clap_mask))[:, None, :]
        t5_mask = self._ids(t5_mask)
        t5 = at.t5_encode(p["t5"], self.t5_cfg, self._ids(t5_ids), t5_mask)
        proj, proj_mask = at.projection_forward(
            p["proj"], clap, t5,
            torch.ones(clap.shape[:2], dtype=torch.int32, device=self.device), t5_mask)
        generated = at.generate_language_model(p["gpt2"], self.gpt2_cfg, proj, proj_mask,
                                               max_new_tokens=self.max_new_tokens)
        return generated, t5

    def make_eps_fn(self, prompt: str, cfg_scale: float) -> Callable:
        """eps_fn(w, t) -> (uncond, cond): two UNet calls, on the empty
        prompt's streams and on the prompt's, as JAX makes them."""
        del cfg_scale  # inversion_forward / inversion_reverse apply it
        eh0_c, eh1_c = self._encode_prompt(prompt)
        eh0_u, eh1_u = self._encode_prompt("")
        p, cfg = self.params["unet"], self.unet_cfg

        def eps_fn(w, t):
            x = w[None]
            tt = torch.tensor([t], dtype=torch.int32, device=self.device)
            return (am.unet_forward(p, cfg, x, tt, eh0_u, eh1_u)[0],
                    am.unet_forward(p, cfg, x, tt, eh0_c, eh1_c)[0])

        return eps_fn

    def vae_decode(self, w):
        return am.vae_decode(self.params["vae"], self.vae_cfg, w[None])[0, 0]   # (T, M)

    def decode_to_mel(self, mel) -> np.ndarray:
        wav = am.vocoder_apply(self.params["vocoder"], self.voc_cfg, mel[None])
        return wav[0].float().cpu().numpy()

    # ------------------------------------------------------ constructors

    @classmethod
    def init_tiny(cls, seed: int = 0, n_mels: int = 16, device="cuda") -> "AudioLDM2Stack":
        """A structurally complete random stack at JAX init_tiny's sizes
        (every component real), weights from `seed` on `device`."""
        from ..interop.from_jax import random_audioldm2_stack

        return random_audioldm2_stack(seed, device, dims=tiny_dims(n_mels))

    @classmethod
    def load_from_dir(cls, model_dir: str, device="cuda") -> "AudioLDM2Stack":
        """A local diffusers AudioLDM2 checkpoint directory (vae/,
        text_encoder/, text_encoder_2/, language_model/,
        projection_model/, unet/, vocoder/ with safetensors weights and
        tokenizer files).  As in JAX, every weight tree is imported and
        then NotImplementedError is raised: the tokenizers and the
        per-component configs are not wired into the stack."""
        resolve_device(device)
        params = load_components_from_dir(model_dir)
        del params
        raise NotImplementedError(
            "assembling a full AudioLDM2Stack from a checkpoint dir also "
            "needs the tokenizer files + per-component configs wired into "
            "the stack's *Config dataclasses; every weight tree (VAE, "
            "vocoder, CLAP, T5, GPT2, projection, UNet) already imports "
            "via load_components_from_dir(model_dir).")


def load_components_from_dir(model_dir: str) -> dict:
    """Every AudioLDM2 component of a diffusers checkpoint directory,
    read through `interop/safetensors_io.py`: {vae, vocoder, clap, t5,
    gpt2, proj, unet, unet_cfg} trees on the CPU.  The UNet importer is
    strict (every key consumed; the structure and cross dims follow the
    weights)."""
    if not os.path.isdir(model_dir):
        raise RuntimeError(
            f"AudioLDM2 checkpoint directory {model_dir!r} not found. "
            "The diffusion stack is download-gated: place a diffusers "
            "checkpoint tree locally and pass its path.")
    from ..interop.safetensors_io import load_file

    def read_sf(sub):
        for cand in ("diffusion_pytorch_model.safetensors", "model.safetensors"):
            path = os.path.join(model_dir, sub, cand)
            if os.path.isfile(path):
                return load_file(path)
        raise FileNotFoundError(f"no safetensors under {sub}/")

    unet, unet_cfg = am.unet_params_from_state_dict(read_sf("unet"))
    return {"vae": am.vae_params_from_state_dict(read_sf("vae")),
            "vocoder": am.vocoder_params_from_state_dict(read_sf("vocoder")),
            "clap": at.clap_params_from_state_dict(read_sf("text_encoder")),
            "t5": at.t5_params_from_state_dict(read_sf("text_encoder_2")),
            "gpt2": at.gpt2_params_from_state_dict(read_sf("language_model")),
            "proj": at.projection_params_from_state_dict(read_sf("projection_model")),
            "unet": unet, "unet_cfg": unet_cfg}
