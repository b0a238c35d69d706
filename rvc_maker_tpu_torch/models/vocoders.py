"""The other vocoders of f0 models: MRF-HiFi-GAN and RefineGAN.

Counterpart of `rvc_maker_tpu/models/vocoders.py` (reference
mrf_hifigan.py: a harmonic source with cumsum-wrap phase accumulation,
harmonic_num = 8, MRF residual stacks; refinegan.py: a source-waveform
branch beside the mel branch, parallel resblocks with AdaIN noise,
linear-interpolation upsampling).  Selected by `ModelConfig.vocoder`
through `synthesizer.infer_any`.  Noise comes in explicitly (the source
noise, `rand_ini`, the AdaIN noise), as `synthesizer.decoder_noise`
draws it.

Layouts: the decoders take and return (B, T, C), as the JAX package's
do, and run in (B, C, T) inside.  They run in the params' dtype (fp32 or
bf16); the harmonic sources stay fp32, their phase sums float64.

Kernels: an MRF block is the resblock function of `ops/resblock.py`
(leaky-ReLU 0.1, the dilated conv, leaky-ReLU 0.1, a conv padded by
k // 2, which is (k - 1) // 2 for odd k, and the residual add), so
`mrf_hifigan` runs the NSF decoder's stack on packed weights and every
MRF block through `fused_resblock`.  RefineGAN's resblock takes its
leaky-ReLU at slope 0.2; the kernel's slope is the compile-time 0.1, so
`_refine_resblock` is the F.conv1d chain, as the JAX package runs it in
XLA convolutions.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..ops.nn import conv1d, leaky_relu, linear, linear_as_input
from .synthesizer import _hifigan_stack, _stage_paddings

Params = Any
MRF_HARMONICS = 8          # overtones of the MRF source, beside the fundamental
SINE_AMP = 0.1
NOISE_STD = 0.003
REFINE_KERNELS = (3, 7, 11)
REFINE_DILATIONS = (1, 3, 5)
REFINE_SLOPE = 0.2         # RefineGAN's leaky-ReLU slope everywhere


def interp_linear(x, size: int):
    """torch F.interpolate(mode="linear", align_corners=False) on the
    time axis: (B, C, T) -> (B, C, size).  The JAX package writes the
    formula out; F.interpolate gives the jitted JAX result bit for bit,
    and the same formula as separate torch ops does not (the position
    (i + 0.5) * t_in / size - 0.5 near 240,000 has an ulp of 1/64)."""
    return F.interpolate(x, size=size, mode="linear", align_corners=False)


def _upsample_nearest(x, factor: int):
    """Repeat each step of the last (time) axis `factor` times."""
    return torch.repeat_interleave(x, factor, dim=-1)


def cumsum_sine(f0_buf, rand_ini, *, sample_rate: int):
    """Phase accumulation of both vocoders (mrf_hifigan.py:58-68): rad =
    (f0 / sr) mod 1 with a random initial phase per harmonic, a
    cumulative sum with its wraps taken out as integer shifts.

    f0_buf: (B, T, H) Hz per harmonic; rand_ini: (B, H) phases or None.

    The phase runs in float64, from the division on, along a contiguous
    time axis.  In fp32 a sum over 10^5 samples keeps each sample's
    rounding: the card divides by a scalar through its reciprocal and
    scans in another order than the CPU, which put the 9-harmonic source
    1.6e-4 apart over 96,000 samples.  A scan along an axis with 9
    columns behind it is also slow on the card (250 ms for 2 x 10 s at
    48 kHz)."""
    rad = torch.remainder(f0_buf.to(torch.float64).transpose(1, 2).contiguous()
                          / sample_rate, 1.0)                     # (B, H, T)
    if rand_ini is not None:
        rad[..., 0] += rand_ini
    tmp = torch.remainder(torch.cumsum(rad, dim=-1), 1.0)
    wrap = (tmp[..., 1:] - tmp[..., :-1]) < 0
    shift = F.pad(torch.where(wrap, -1.0, 0.0).to(rad.dtype), (1, 0))
    phase = torch.cumsum(rad + shift, dim=-1)
    return torch.sin(phase * 2.0 * math.pi).to(f0_buf.dtype).transpose(1, 2)


def _harmonic_source(f0, n_harmonics: int, noise, rand_ini, *, sample_rate: int):
    """f0: (B, T) Hz -> sine bank (B, T, n_harmonics + 1); noise likewise."""
    h = torch.arange(1, n_harmonics + 2, dtype=f0.dtype, device=f0.device)
    sines = cumsum_sine(f0[:, :, None] * h, rand_ini, sample_rate=sample_rate) * SINE_AMP
    uv = (f0 > 0).to(f0.dtype)[:, :, None]
    amp = uv * NOISE_STD + (1.0 - uv) * SINE_AMP / 3.0
    return sines * uv + amp * noise


# ---------------------------------------------------------------------------
# MRF-HiFi-GAN
# ---------------------------------------------------------------------------

def mrf_hifigan(p: Params, cfg: ModelConfig, x, f0, g, source_noise, rand_ini=None):
    """x: (B, T, inter); f0: (B, T) Hz; g: (B, 1, gin) or None;
    source_noise: (B, T*upp, MRF_HARMONICS + 1).  The MRF blocks are
    `p["resblocks"]`, packed, stage by stage.  Returns (B, T*upp, 1)."""
    f0_up = _upsample_nearest(f0, cfg.upp)
    sines = _harmonic_source(f0_up, MRF_HARMONICS, source_noise, rand_ini,
                             sample_rate=cfg.sr)
    src = p["source"]["l_linear"]
    har = torch.tanh(linear_as_input(sines, src["w"], src.get("b")))
    return _hifigan_stack(p, cfg, x, g, har.to(x.dtype).transpose(1, 2))


# ---------------------------------------------------------------------------
# RefineGAN
# ---------------------------------------------------------------------------

def _refine_resblock(p: Params, x, *, kernel: int):
    """x: (B, C, T); convs in torch layout (Cout, Cin, k)."""
    for c1, c2, d in zip(p["convs1"], p["convs2"], REFINE_DILATIONS):
        y = leaky_relu(x, REFINE_SLOPE)
        y = conv1d(y, c1["w"], c1["b"], dilation=d, padding=(kernel * d - d) // 2)
        y = leaky_relu(y, REFINE_SLOPE)
        y = conv1d(y, c2["w"], c2["b"], padding=(kernel - 1) // 2)
        x = y + x
    return x


def _adain(p: Params, x, noise):
    """x: (B, C, T); noise: (B, T, C), the layout it is drawn in."""
    return leaky_relu(x + noise.transpose(1, 2) * p["weight"][:, None], REFINE_SLOPE)


def _parallel_resblock(p: Params, x, noises):
    x = conv1d(x, p["input_conv"]["w"], p["input_conv"]["b"], padding=3)
    acc = None
    for bp, ks, (n1, n2) in zip(p["blocks"], REFINE_KERNELS, noises):
        y = _adain(bp["adain1"], x, n1)
        y = _refine_resblock(bp["res"], y, kernel=ks)
        y = _adain(bp["adain2"], y, n2)
        acc = y if acc is None else acc + y
    return acc / len(p["blocks"])


def refinegan(p: Params, cfg: ModelConfig, mel, f0, g, source_noise, adain_noises,
              rand_ini=None):
    """mel: (B, T, inter) (the flow's output); f0: (B, T) Hz; g: (B, 1,
    gin) or None; source_noise: (B, T*upp, 1); adain_noises: per stage
    three (n1, n2) pairs shaped like the stage's activations, (B, t, C).
    Returns (B, T*upp, 1)."""
    t_mel = mel.shape[1]
    f0_up = interp_linear(f0[:, None, :], t_mel * cfg.upp)[:, 0]
    sines = _harmonic_source(f0_up, 0, source_noise, rand_ini, sample_rate=cfg.sr)
    har = torch.tanh(linear_as_input(sines, p["source"]["merge"]["w"]))
    har = har.to(mel.dtype).transpose(1, 2)                       # (B, 1, T*upp)

    x = conv1d(har, p["pre_conv"]["w"], p["pre_conv"]["b"], padding=3)
    x = interp_linear(x, t_mel)
    m = conv1d(mel.transpose(1, 2), p["mel_conv"]["w"], p["mel_conv"]["b"], padding=3)
    if g is not None and "cond" in p:
        m = m + linear(g, p["cond"]["w"], p["cond"]["b"]).transpose(1, 2)
    x = torch.cat([m, x], dim=1)

    for i, (rate, st) in enumerate(zip(cfg.upsample_rates, _stage_paddings(cfg))):
        x = leaky_relu(x, REFINE_SLOPE)
        x = interp_linear(x, x.shape[-1] * rate)
        ds = p["downsample_blocks"][i]
        down = conv1d(har, ds["w"], ds["b"], stride=st["noise_stride"],
                      padding=st["noise_pad"])
        x = torch.cat([x, down], dim=1)
        x = _parallel_resblock(p["upsample_conv_blocks"][i], x, adain_noises[i])
    x = leaky_relu(x, REFINE_SLOPE)
    return torch.tanh(conv1d(x, p["conv_post"]["w"], None, padding=3)).transpose(1, 2)
