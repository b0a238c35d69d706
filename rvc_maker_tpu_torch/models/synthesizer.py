"""VITS-RVC synthesizer in PyTorch: inference and the training forward.

Counterpart of `rvc_maker_tpu/models/synthesizer.py` (reference
synthesizers.py:396-489, residuals.py, modules.py): text encoder with
windowed relative-position attention, the posterior encoder, the flow
in both directions, and the decoders.  Inference runs every decoder the
JAX package has: the NSF-HiFiGAN decoder with its sine source, the plain
HiFi-GAN `generator` of f0-less models, and (in `models/vocoders.py`)
MRF-HiFi-GAN and RefineGAN, dispatched by `infer_any`.  The training
forward (`train_forward`) runs every decoder as well.  Functions
over explicit parameter dicts of torch tensors (layouts in `ops/nn.py`;
weight-norm folded at load, and the generator trains on the folded
weights, as the JAX package's does).  Noise comes in as tensors
(`z_noise`, `sine_noise`, `post_noise`, the `decoder_noise` dict, the
training forward's `train_noise`), or
is drawn from an explicit torch.Generator, so a caller can hold the
random draws.

Precision: the functions run in the dtype of the params and activations
they are given, fp32 or bf16 (the pipeline's compute_dtype, the
JAX package's bf16 mode).  The sine sources stay fp32 and their output
is cast to the activations' dtype, as JAX `generator_nsf` does.

int8: with RVC_TPU_INT8=1 in bf16, an inference call given `use_int8`
(a bool or an `ops.int8_conv.Int8Ctx`; `ConvertPipeline` threads it)
runs every resblock conv of the NSF and plain decoders at C >= 64 as a
W8A8 conv (`Int8Ctx.conv`, csrc/conv1d_w8a8_ws.cu on the card), from the
`w1_q` / `w2_q` that `prequantize_decode` attached; narrower stages keep
`fused_resblock`.  MRF-HiFi-GAN and RefineGAN take no int8, and the
training forward has no `use_int8`, as in the JAX package.

Layouts: the public functions take and return (B, T, C), as the JAX
package does.  The decoders run in (B, C, T) inside: that is the layout
of cuDNN's convolutions, of F.conv_transpose1d and of the resblock
kernel, so a decode needs no transposes between stages.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..config import ModelConfig
from ..device import tree_rows
from ..ops.int8_conv import DECODE_MIN_C, Int8Ctx, as_ctx, int8_enabled
from ..ops.nn import (LRELU_SLOPE, conv1d, conv_transpose1d, embedding,
                      fused_gate, layer_norm, leaky_relu, linear, linear_as_input,
                      sequence_mask, slice_segments)
from ..ops.resblock import fused_resblock

Params = Any


# ---------------------------------------------------------------------------
# Relative-position multi-head attention (reference synthesizers.py:183-284)
# ---------------------------------------------------------------------------

def _get_relative_embeddings(emb, t: int, window_size: int):
    """emb: (1, 2*window+1, k) -> (1, 2t-1, k), zero-padded or sliced."""
    pad_length = max(t - (window_size + 1), 0)
    start = max((window_size + 1) - t, 0)
    if pad_length > 0:
        emb = torch.nn.functional.pad(emb, (0, 0, pad_length, pad_length))
    return emb[:, start : start + 2 * t - 1]


def _relative_to_absolute(x):
    """(B, H, T, 2T-1) -> (B, H, T, T). Reference synthesizers.py:271-274."""
    b, h, t, _ = x.shape
    # pad a zero column and a zero row, flatten, keep (t+1)(2t-1) values:
    # the reference's flat pad of t-1 zeros, in a form whose length a
    # symbolic t factors (torch.export of a dynamic frame axis)
    x = torch.nn.functional.pad(x, (0, 1, 0, 1))
    x = x.reshape(b, h, (t + 1) * 2 * t)[:, :, : (t + 1) * (2 * t - 1)]
    x = x.reshape(b, h, t + 1, 2 * t - 1)
    return x[:, :, :t, t - 1 :]


def _absolute_to_relative(x):
    """(B, H, T, T) -> (B, H, T, 2T-1). Reference synthesizers.py:276-279."""
    b, h, t, _ = x.shape
    x = torch.nn.functional.pad(x, (0, t - 1))
    x = x.reshape(b, h, t * t + t * (t - 1))
    x = torch.nn.functional.pad(x, (t, 0))
    x = x.reshape(b, h, t, 2 * t)
    return x[:, :, :, 1:]


def multi_head_attention(p: Params, x, attn_mask, *, n_heads: int,
                         window_size: int):
    """Self-attention with windowed relative position terms, in the
    reference's dense (2T-1)-wide form for every T.

    x: (B, T, C); attn_mask: (B, 1, T, T), 1 = attend."""
    b, t, c = x.shape
    k_ch = c // n_heads
    scale = 1.0 / math.sqrt(k_ch)

    def heads(y):
        return y.reshape(b, t, n_heads, k_ch).transpose(1, 2)

    q = heads(linear(x, p["q"]["w"], p["q"]["b"])) * scale
    k = heads(linear(x, p["k"]["w"], p["k"]["b"]))
    v = heads(linear(x, p["v"]["w"], p["v"]["b"]))

    scores = torch.matmul(q, k.transpose(-1, -2))
    rel_k = _get_relative_embeddings(p["emb_rel_k"].to(q.dtype), t, window_size)
    scores = scores + _relative_to_absolute(torch.matmul(q, rel_k[0].T))
    # masked logits are -1e4, not -inf (reference synthesizers.py:233)
    scores = scores.masked_fill(attn_mask == 0, -1e4)
    p_attn = torch.softmax(scores, dim=-1)

    out = torch.matmul(p_attn, v)
    rel_v = _get_relative_embeddings(p["emb_rel_v"].to(p_attn.dtype), t, window_size)
    out = out + torch.matmul(_absolute_to_relative(p_attn), rel_v[0])
    out = out.transpose(1, 2).reshape(b, t, c)
    return linear(out, p["o"]["w"], p["o"]["b"])


def _conv_btc(x, w, b, **kw):
    """conv1d on a (B, T, C) tensor."""
    return conv1d(x.transpose(1, 2), w, b, **kw).transpose(1, 2)


def ffn(p: Params, x, x_mask, *, kernel_size: int):
    """Conv feed-forward with ReLU.  x: (B, T, C); x_mask: (B, T, 1)."""
    pad = ((kernel_size - 1) // 2, kernel_size // 2)
    h = _conv_btc(x * x_mask, p["conv1"]["w"], p["conv1"]["b"], padding=pad)
    h = torch.relu(h)
    h = _conv_btc(h * x_mask, p["conv2"]["w"], p["conv2"]["b"], padding=pad)
    return h * x_mask


def rel_transformer_encoder(p: Params, x, x_mask, *, n_heads: int,
                            kernel_size: int, window_size: int):
    """Stack of attention + FFN blocks, post-LN."""
    attn_mask = x_mask[:, None, :, :] * x_mask[:, None, None, :, 0]
    x = x * x_mask
    for lp in p["layers"]:
        y = multi_head_attention(lp["attn"], x, attn_mask, n_heads=n_heads,
                                 window_size=window_size)
        x = layer_norm(x + y, lp["norm1"]["gamma"], lp["norm1"]["beta"])
        y = ffn(lp["ffn"], x, x_mask, kernel_size=kernel_size)
        x = layer_norm(x + y, lp["norm2"]["gamma"], lp["norm2"]["beta"])
    return x * x_mask


def text_encoder(p: Params, cfg: ModelConfig, phone, pitch, lengths):
    """phone: (B, T, emb_dim); pitch: (B, T) int or None; lengths: (B,).
    Returns (m, logs, x_mask (B, T, 1))."""
    x = linear(phone, p["emb_phone"]["w"], p["emb_phone"]["b"])
    if pitch is not None:
        x = x + embedding(p["emb_pitch"]["w"], pitch)
    x = leaky_relu(x * math.sqrt(cfg.hidden_channels), 0.1)
    x_mask = sequence_mask(lengths, x.shape[1]).to(x.dtype)[:, :, None]
    x = rel_transformer_encoder(
        p["encoder"], x, x_mask, n_heads=cfg.n_heads,
        kernel_size=cfg.kernel_size, window_size=cfg.rel_attn_window_size)
    stats = linear(x, p["proj"]["w"], p["proj"]["b"]) * x_mask
    m, logs = torch.chunk(stats, 2, dim=-1)
    return m, logs, x_mask


# ---------------------------------------------------------------------------
# WaveNet and the flow (reference modules.py:9-60, residuals.py:71-140)
# ---------------------------------------------------------------------------

def wavenet(p: Params, x, x_mask, g, *, kernel_size: int, dilation_rate: int,
            n_layers: int):
    """Dilated gated conv stack.  x: (B, T, H); g: (B, 1, gin) or None."""
    hidden = x.shape[-1]
    cond = linear(g, p["cond"]["w"], p["cond"]["b"]) if g is not None else None
    output = torch.zeros_like(x)
    for i in range(n_layers):
        dilation = dilation_rate ** i
        pad = (kernel_size * dilation - dilation) // 2
        x_in = _conv_btc(x, p["in_layers"][i]["w"], p["in_layers"][i]["b"],
                         dilation=dilation, padding=pad)
        g_l = (cond[..., i * 2 * hidden : (i + 1) * 2 * hidden]
               if cond is not None else 0.0)
        acts = fused_gate(x_in, g_l)
        res_skip = linear(acts, p["res_skip"][i]["w"], p["res_skip"][i]["b"])
        if i < n_layers - 1:
            x = (x + res_skip[..., :hidden]) * x_mask
            output = output + res_skip[..., hidden:]
        else:
            output = output + res_skip
    return output * x_mask


def _coupling(p: Params, x, x_mask, g, *, reverse: bool):
    """Mean-only affine coupling layer (ResidualCouplingLayer)."""
    half = x.shape[-1] // 2
    x0, x1 = x[..., :half], x[..., half:]
    h = linear(x0, p["pre"]["w"], p["pre"]["b"]) * x_mask
    h = wavenet(p["enc"], h, x_mask, g, kernel_size=5, dilation_rate=1,
                n_layers=3)
    m = linear(h, p["post"]["w"], p["post"]["b"]) * x_mask
    x1 = (x1 - m) * x_mask if reverse else m + x1 * x_mask
    return torch.cat([x0, x1], dim=-1)


def flow(p: Params, x, x_mask, g, *, reverse: bool = True):
    """4 couplings interleaved with channel flips (ResidualCouplingBlock):
    inference runs it in reverse, training forward."""
    if not reverse:
        for lp in p["layers"]:
            x = torch.flip(_coupling(lp, x, x_mask, g, reverse=False), dims=[-1])
        return x
    for lp in reversed(p["layers"]):
        x = _coupling(lp, torch.flip(x, dims=[-1]), x_mask, g, reverse=True)
    return x


def posterior_encoder(p: Params, y, y_lengths, g, noise):
    """Reference synthesizers.py:373-394.  y: (B, T, spec_channels);
    noise: (B, T, inter) standard normal.  Returns (z, m, logs, y_mask)."""
    y_mask = sequence_mask(y_lengths, y.shape[1]).to(y.dtype)[:, :, None]
    h = linear(y, p["pre"]["w"], p["pre"]["b"]) * y_mask
    h = wavenet(p["enc"], h, y_mask, g, kernel_size=5, dilation_rate=1,
                n_layers=16)
    stats = linear(h, p["proj"]["w"], p["proj"]["b"]) * y_mask
    m, logs = torch.chunk(stats, 2, dim=-1)
    z = (m + noise * torch.exp(logs)) * y_mask
    return z, m, logs, y_mask


# ---------------------------------------------------------------------------
# NSF source and decoder (reference synthesizers.py:69-168)
# ---------------------------------------------------------------------------

def sine_gen(f0, noise, *, upp: int, sample_rate: int, sine_amp: float = 0.1,
             noise_std: float = 0.003, voiced_threshold: float = 0.0):
    """Phase-accumulating sine source (fundamental only), all fp32.

    f0: (B, T) Hz; noise: (B, T*upp, 1).  The phase wrap is a floor-mod
    (torch.remainder) on values that can be negative, as jnp.mod."""
    b, t = f0.shape
    f0 = f0.to(torch.float32)[:, :, None]
    steps = torch.arange(1, upp + 1, dtype=torch.float32, device=f0.device)
    rad = f0 / sample_rate * steps                               # (B, T, upp)
    tmp = torch.remainder(rad[:, :-1, -1] + 0.5, 1.0) - 0.5       # (B, T-1)
    cum = torch.remainder(torch.cumsum(tmp, dim=1), 1.0)
    offset = torch.nn.functional.pad(cum, (1, 0))[:, :, None]
    rad = (rad + offset).reshape(b, t * upp, 1)
    sine = torch.sin(2.0 * math.pi * rad)
    uv = (f0 > voiced_threshold).to(torch.float32)
    uv = torch.repeat_interleave(uv, upp, dim=1)
    noise_amp = uv * noise_std + (1.0 - uv) * (sine_amp / 3.0)
    return sine * sine_amp * uv + noise_amp * noise.to(torch.float32)


def source_module(p: Params, f0, noise, *, upp: int, sample_rate: int):
    """SourceModuleHnNSF: sine source -> 1x1 linear -> tanh, in fp32
    whatever the weights' dtype."""
    s = sine_gen(f0, noise, upp=upp, sample_rate=sample_rate)
    return torch.tanh(linear_as_input(s, p["l_linear"]["w"], p["l_linear"]["b"]))


def _stage_paddings(cfg: ModelConfig):
    """Per-stage (convT padding, output_padding) of `decoder_kind(cfg)`'s
    stack and the noise-conv geometry.  The plain Generator pads its
    transposed convs by (k - u) // 2 with no output_padding (reference
    synthesizers.py:30); the NSF and MRF decoders by the stride's parity."""
    rates = cfg.upsample_rates
    n = len(rates)
    plain = decoder_kind(cfg) == "plain"
    stride_f0s = [math.prod(rates[i + 1:]) if i + 1 < n else 1 for i in range(n)]
    out = []
    for i, (u, k) in enumerate(zip(rates, cfg.upsample_kernel_sizes)):
        if plain or u % 2 == 0:
            convt_pad = (k - u) // 2
        else:
            convt_pad = u // 2 + u % 2
        stride = stride_f0s[i]
        nk = 1 if stride == 1 else stride * 2 - stride % 2
        npad = 0 if stride == 1 else (nk - stride) // 2
        out.append(dict(u=u, k=k, convt_pad=convt_pad, out_pad=0 if plain else u % 2,
                        noise_stride=stride, noise_kernel=nk, noise_pad=npad))
    return out


def _int8_resblock(rb: Params, x, ctx: Int8Ctx, *, dilations):
    """One resblock through `ctx.conv`, two W8A8 convs per dilation step
    (JAX `_resblock`'s int8 route): x = conv2(lrelu(conv1(lrelu(x)))) +
    x, each leaky ReLU in the conv's prologue, the add in conv2's
    epilogue."""
    for i, d in enumerate(dilations):
        y = ctx.conv(x, rb["w1_q"][i], rb["w1_scale"][i], rb["b1"][i], dilation=d,
                     apply_lrelu=True)
        x = ctx.conv(y, rb["w2_q"][i], rb["w2_scale"][i], rb["b2"][i], dilation=1,
                     apply_lrelu=True, residual=x)
    return x


def _resblock_group(p: Params, x, indices, cfg: ModelConfig, ctx: Int8Ctx | None = None):
    """Average of the stage's resblocks (reference synthesizers.py:141-149):
    `fused_resblock`, or `_int8_resblock` when an int8 context is given,
    the mode is on for x's dtype and the stage is at least DECODE_MIN_C
    wide (JAX `_resblock`'s gate)."""
    int8 = (ctx is not None and int8_enabled(x.dtype) and x.shape[1] >= DECODE_MIN_C)
    xs = None
    for idx, ks, ds in zip(indices, cfg.resblock_kernel_sizes,
                           cfg.resblock_dilation_sizes):
        rb = p["resblocks"][idx]
        if int8:
            r = _int8_resblock(rb, x, ctx, dilations=tuple(ds))
        else:
            r = fused_resblock(x, rb["w1"], rb["b1"], rb["w2"], rb["b2"],
                               kernel_size=ks, dilations=tuple(ds))
        xs = r if xs is None else xs + r
    return xs / len(indices)


def _hifigan_stack(p: Params, cfg: ModelConfig, x, g, har=None, use_int8=False):
    """The HiFi-GAN upsampling stack that the NSF, MRF and plain decoders
    share.  x: (B, T, inter); har: the harmonic source (B, 1, T*upp) or
    None.  Per stage: leaky-ReLU, the transposed conv, the source's noise
    conv when there is a source, the average of the stage's resblocks
    (`_resblock_group`, int8 by `use_int8`); then leaky-ReLU 0.01 (torch
    F.leaky_relu's default, reference :161), conv_post and tanh.  Returns
    (B, T*upp, 1)."""
    ctx = as_ctx(use_int8)
    x = conv1d(x.transpose(1, 2), p["conv_pre"]["w"], p["conv_pre"]["b"],
               padding=3)                                      # (B, C, T)
    if g is not None and "cond" in p:
        x = x + linear(g, p["cond"]["w"], p["cond"]["b"]).transpose(1, 2)
    nk = len(cfg.resblock_kernel_sizes)
    for i, st in enumerate(_stage_paddings(cfg)):
        x = leaky_relu(x, LRELU_SLOPE)
        x = conv_transpose1d(x, p["ups"][i]["w"], p["ups"][i]["b"],
                             stride=st["u"], padding=st["convt_pad"],
                             output_padding=st["out_pad"])
        if har is not None:
            x = x + conv1d(har, p["noise_convs"][i]["w"], p["noise_convs"][i]["b"],
                           stride=st["noise_stride"], padding=st["noise_pad"])
        x = _resblock_group(p, x.contiguous(), [i * nk + j for j in range(nk)],
                            cfg, ctx)
    x = leaky_relu(x, 0.01)
    x = conv1d(x, p["conv_post"]["w"], p["conv_post"].get("b"), padding=3)
    return torch.tanh(x).transpose(1, 2)


def generator_nsf(p: Params, cfg: ModelConfig, x, f0, g, sine_noise, *, use_int8=False):
    """NSF-HiFiGAN decode.  x: (B, T, inter); f0: (B, T) Hz; g: (B, 1,
    gin) or None; sine_noise: (B, T*upp, 1).  use_int8: False, True
    (dynamic scales) or an Int8Ctx, whose sites restart here.  Returns
    (B, T*upp, 1)."""
    if isinstance(use_int8, Int8Ctx):
        use_int8.reset_sites()
    har = source_module(p["source"], f0, sine_noise, upp=cfg.upp,
                        sample_rate=cfg.sr).to(x.dtype).transpose(1, 2)
    return _hifigan_stack(p, cfg, x, g, har, use_int8)


def generator(p: Params, cfg: ModelConfig, x, g, *, use_int8=False):
    """Plain HiFi-GAN decode of f0-less models (reference
    synthesizers.py:21-67 Generator): no source, no noise convs, no bias
    on conv_post.  x: (B, T, inter); g: (B, 1, gin) or None; use_int8 as
    `generator_nsf` takes it.  Returns (B, T*upp, 1)."""
    if isinstance(use_int8, Int8Ctx):
        use_int8.reset_sites()
    return _hifigan_stack(p, cfg, x, g, use_int8=use_int8)


MRF_NAMES = ("MRF HiFi-GAN", "MRF-HiFi-GAN")


def decoder_kind(cfg: ModelConfig) -> str:
    """The decoder a model runs (reference synthesizers.py:419-424):
    "plain" for f0-less models whatever their vocoder, else "mrf",
    "refinegan" or "nsf" by `cfg.vocoder`."""
    if not cfg.use_f0:
        return "plain"
    if cfg.vocoder in MRF_NAMES:
        return "mrf"
    return "refinegan" if cfg.vocoder == "RefineGAN" else "nsf"


def decoder_noise(cfg: ModelConfig, b: int, p_len: int,
                  generator: torch.Generator | None, device,
                  dtype: torch.dtype = torch.float32) -> dict:
    """Each decoder's noise for b rows of p_len frames, drawn from
    `generator` in one fixed order, the normals in `dtype` and the
    uniform `rand_ini` in fp32 (the JAX package draws the same shapes
    from a PRNG key, `infer_any`):
      nsf        {"sine": (b, p_len*upp, 1)}
      plain      {}
      mrf        {"source": (b, p_len*upp, H), "rand_ini": (b, H) uniform
                  with column 0 set to 0}, H = MRF_HARMONICS + 1
      refinegan  {"source": (b, p_len*upp, 1), "rand_ini": zeros (b, 1),
                  "adain": per stage three (n1, n2) pairs (b, t_stage,
                  C_stage)}"""
    from .vocoders import MRF_HARMONICS

    kind = decoder_kind(cfg)
    n = p_len * cfg.upp

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)

    if kind == "nsf":
        return {"sine": randn(b, n, 1)}
    if kind == "plain":
        return {}
    if kind == "mrf":
        source = randn(b, n, MRF_HARMONICS + 1)
        rand_ini = torch.rand((b, MRF_HARMONICS + 1), generator=generator, device=device)
        rand_ini[:, 0] = 0.0
        return {"source": source, "rand_ini": rand_ini}
    out = {"source": randn(b, n, 1), "rand_ini": torch.zeros((b, 1), device=device),
           "adain": []}
    ch, t = cfg.upsample_initial_channel, p_len
    for rate in cfg.upsample_rates:
        ch, t = ch // 2, t * rate
        out["adain"].append([(randn(b, t, ch), randn(b, t, ch)) for _ in range(3)])
    return out


def _prior(params: Params, cfg: ModelConfig, phone, phone_lengths, pitch, sid,
           z_noise):
    """Text encoder and the reverse flow: (g, z, x_mask, z_p, m_p, logs_p)."""
    g = embedding(params["emb_g"]["w"], sid)[:, None, :]
    m_p, logs_p, x_mask = text_encoder(params["enc_p"], cfg, phone, pitch,
                                       phone_lengths)
    z_p = (m_p + torch.exp(logs_p) * z_noise * 0.66666) * x_mask
    z = flow(params["flow"], z_p, x_mask, g, reverse=True)
    return g, z, x_mask, z_p, m_p, logs_p


def infer(params: Params, cfg: ModelConfig, phone, phone_lengths, pitch,
          nsff0, sid, z_noise, sine_noise, *, use_int8=False):
    """Inference with the NSF decoder, or the plain one for an f0-less
    model (reference synthesizers.py:446-465).

    phone: (B, T, emb_dim); pitch: (B, T) int, None for an f0-less
    model; nsff0: (B, T) Hz; sid: (B,) int; z_noise: (B, T, inter)
    N(0,1); sine_noise: (B, T*upp, 1), unused by an f0-less model;
    use_int8 as `generator_nsf` takes it.
    Returns (waveform (B, T*upp, 1), x_mask, (z, z_p, m_p, logs_p))."""
    kind = decoder_kind(cfg)
    if kind not in ("nsf", "plain"):
        raise ValueError(f"a {cfg.vocoder} model decodes through infer_any")
    g, z, x_mask, z_p, m_p, logs_p = _prior(params, cfg, phone, phone_lengths,
                                            pitch, sid, z_noise)
    if kind == "plain":
        o = generator(params["dec"], cfg, z * x_mask, g, use_int8=use_int8)
    else:
        o = generator_nsf(params["dec"], cfg, z * x_mask, nsff0, g, sine_noise,
                          use_int8=use_int8)
    return o, x_mask, (z, z_p, m_p, logs_p)


def decode(dec: Params, cfg: ModelConfig, z, f0, g, noise: dict, *, use_int8=False):
    """The decoder `decoder_kind(cfg)` names on z (B, T, inter), f0 (B, T)
    Hz (unused by the plain decoder) and its noise as `decoder_noise`
    lays it out (JAX `infer_any`'s and `_decode_train`'s dispatch).
    use_int8 reaches the NSF and plain decoders only.  Returns the
    waveform (B, T*upp, 1)."""
    from . import vocoders

    kind = decoder_kind(cfg)
    if kind == "plain":
        return generator(dec, cfg, z, g, use_int8=use_int8)
    if kind == "mrf":
        return vocoders.mrf_hifigan(dec, cfg, z, f0, g, noise["source"],
                                    noise["rand_ini"])
    if kind == "refinegan":
        return vocoders.refinegan(dec, cfg, z, f0, g, noise["source"],
                                  noise["adain"], noise["rand_ini"])
    return generator_nsf(dec, cfg, z, f0, g, noise["sine"], use_int8=use_int8)


def infer_any(params: Params, cfg: ModelConfig, phone, phone_lengths, pitch,
              nsff0, sid, z_noise, noise: dict, *, use_int8=False):
    """Inference with the decoder dispatch of the JAX package's
    `infer_any` (`decoder_kind`), on explicit noise: z_noise (B, T,
    inter) and `noise` as `decoder_noise` lays it out; use_int8 as
    `decode` takes it.  Returns the waveform (B, T*upp, 1)."""
    g, z, x_mask, *_ = _prior(params, cfg, phone, phone_lengths, pitch, sid,
                              z_noise)
    return decode(params["dec"], cfg, z * x_mask, nsff0, g, noise, use_int8=use_int8)


def train_noise(cfg: ModelConfig, y, y_lengths, generator: torch.Generator | None,
                *, dtype: torch.dtype | None = None, post_noise=None, ids_slice=None,
                dec_noise=None, rows: slice | None = None, n_rows: int | None = None) -> dict:
    """The training forward's random inputs: the posterior noise (B,
    T_spec, inter) in `dtype` (default y's), the slice starts (B,)
    int(u * (length - segment_size + 1)) with u ~ U[0, 1) (reference
    commons.py:27-33), and the decoder's noise for one segment (a dict as
    `decoder_noise` lays it out, its normals in `dtype`).  Those given
    are kept; the rest are drawn from `generator` in that order.

    rows / n_rows: y holds rows `rows` of a global batch of n_rows (one
    rank of a sharded step).  The draws are then the global batch's, as
    one process would draw them, given noise covers the global batch too,
    and both are cut to `rows`."""
    b, t = y.shape[:2]
    n = b if rows is None else n_rows
    seg = cfg.segment_size
    dtype = dtype or y.dtype

    def mine(tree):
        return tree if rows is None else tree_rows(tree, rows)

    if post_noise is None:
        post_noise = torch.randn((n, t, cfg.inter_channels), generator=generator,
                                 device=y.device, dtype=dtype)
    post_noise = mine(post_noise)
    if ids_slice is None:
        u = mine(torch.rand(n, generator=generator, device=y.device))
        ids_slice = (u * (y_lengths - seg + 1)).to(torch.int32)
    else:
        ids_slice = mine(ids_slice)
    if dec_noise is None:
        dec_noise = decoder_noise(cfg, n, seg, generator, y.device, dtype)
    return {"post_noise": post_noise, "ids_slice": torch.as_tensor(ids_slice, device=y.device),
            "dec_noise": mine(dec_noise)}


def train_forward(params: Params, cfg: ModelConfig, phone, phone_lengths,
                  pitch, pitchf, y, y_lengths, ds, *, post_noise=None,
                  ids_slice=None, dec_noise=None,
                  generator: torch.Generator | None = None):
    """Training path (reference synthesizers.py:434-443) of every decoder:
    the NSF, MRF-HiFi-GAN and RefineGAN decoders of f0 models on the
    sliced pitch, the plain decoder of f0-less ones (pitch None; JAX
    `train_forward` / `_decode_train`).

    y: (B, T_spec, spec_channels) linear spectrogram; pitchf: (B, T_spec)
    Hz.  The noise (`train_noise`: post_noise, ids_slice, dec_noise) is
    used where given, else drawn from `generator`.  Returns (y_hat (B,
    segment_size * upp, 1), ids_slice, x_mask, y_mask, (z, z_flowed, m_p,
    logs_p, m_q, logs_q))."""
    noise = train_noise(cfg, y, y_lengths, generator, post_noise=post_noise,
                        ids_slice=ids_slice, dec_noise=dec_noise)
    g = embedding(params["emb_g"]["w"], ds)[:, None, :]
    m_p, logs_p, x_mask = text_encoder(params["enc_p"], cfg, phone, pitch,
                                       phone_lengths)
    z, m_q, logs_q, y_mask = posterior_encoder(params["enc_q"], y, y_lengths, g,
                                               noise["post_noise"])
    seg = cfg.segment_size
    ids_slice = noise["ids_slice"]
    z_slice = slice_segments(z, ids_slice, seg)
    pitchf_slice = slice_segments(pitchf, ids_slice, seg) if cfg.use_f0 else None
    y_hat = decode(params["dec"], cfg, z_slice, pitchf_slice, g, noise["dec_noise"])
    z_flowed = flow(params["flow"], z, y_mask, g, reverse=False)
    return y_hat, ids_slice, x_mask, y_mask, (z, z_flowed, m_p, logs_p, m_q, logs_q)
