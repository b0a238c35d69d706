"""VITS-RVC synthesizer of the reference (NSF-HiFiGAN decoder): a frozen
copy of the port's `models/synthesizer.py` in fp32, its resblocks the
plain F.conv1d chain in place of the hand-written kernels, without the
int8 route and the other decoders.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from .nn import (LRELU_SLOPE, conv1d, conv_transpose1d, embedding,
                 fused_gate, layer_norm, leaky_relu, linear, linear_as_input,
                 sequence_mask, slice_segments)

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


def text_encoder(p: Params, cfg: Any, phone, pitch, lengths):
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


def _stage_paddings(cfg: Any):
    """Per-stage (convT padding, output_padding) of the NSF stack and the
    noise-conv geometry: transposed convs padded by the stride's parity."""
    rates = cfg.upsample_rates
    n = len(rates)
    stride_f0s = [math.prod(rates[i + 1:]) if i + 1 < n else 1 for i in range(n)]
    out = []
    for i, (u, k) in enumerate(zip(rates, cfg.upsample_kernel_sizes)):
        convt_pad = (k - u) // 2 if u % 2 == 0 else u // 2 + u % 2
        stride = stride_f0s[i]
        nk = 1 if stride == 1 else stride * 2 - stride % 2
        npad = 0 if stride == 1 else (nk - stride) // 2
        out.append(dict(u=u, k=k, convt_pad=convt_pad, out_pad=u % 2,
                        noise_stride=stride, noise_kernel=nk, noise_pad=npad))
    return out


def resblock(x, w1, b1, w2, b2, *, kernel_size: int, dilations):
    """One HiFi-GAN resblock as the plain F.conv1d chain (the port's
    `ops/resblock.py` `_resblock`): for each dilation d,
    x = x + conv_{k,1}(lrelu(conv_{k,d}(lrelu(x)))), zero-padded.  w1 /
    w2: (D, k, C_in, C_out); b1 / b2: (D, C)."""
    k = kernel_size
    for i, d in enumerate(dilations):
        y = F.conv1d(leaky_relu(x), w1[i].permute(2, 1, 0), b1[i], dilation=d,
                     padding=d * (k - 1) // 2)
        y = F.conv1d(leaky_relu(y), w2[i].permute(2, 1, 0), b2[i], padding=(k - 1) // 2)
        x = x + y
    return x


def _resblock_group(p: Params, x, indices, cfg: Any):
    """Average of the stage's resblocks (reference synthesizers.py:141-149)."""
    xs = None
    for idx, ks, ds in zip(indices, cfg.resblock_kernel_sizes,
                           cfg.resblock_dilation_sizes):
        rb = p["resblocks"][idx]
        r = resblock(x, rb["w1"], rb["b1"], rb["w2"], rb["b2"], kernel_size=ks,
                     dilations=tuple(ds))
        xs = r if xs is None else xs + r
    return xs / len(indices)


def _hifigan_stack(p: Params, cfg: Any, x, g, har=None):
    """The HiFi-GAN upsampling stack of the NSF decoder.  x: (B, T, inter); har: the harmonic source (B, 1, T*upp) or
    None.  Per stage: leaky-ReLU, the transposed conv, the source's noise
    conv when there is a source, the average of the stage's resblocks
    (`_resblock_group`); then leaky-ReLU 0.01 (torch
    F.leaky_relu's default, reference :161), conv_post and tanh.  Returns
    (B, T*upp, 1)."""
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
        x = _resblock_group(p, x.contiguous(), [i * nk + j for j in range(nk)], cfg)
    x = leaky_relu(x, 0.01)
    x = conv1d(x, p["conv_post"]["w"], p["conv_post"].get("b"), padding=3)
    return torch.tanh(x).transpose(1, 2)


def generator_nsf(p: Params, cfg: Any, x, f0, g, sine_noise):
    """NSF-HiFiGAN decode.  x: (B, T, inter); f0: (B, T) Hz; g: (B, 1,
    gin) or None; sine_noise: (B, T*upp, 1).  Returns (B, T*upp, 1)."""
    har = source_module(p["source"], f0, sine_noise, upp=cfg.upp,
                        sample_rate=cfg.sr).to(x.dtype).transpose(1, 2)
    return _hifigan_stack(p, cfg, x, g, har)


def _prior(params: Params, cfg: Any, phone, phone_lengths, pitch, sid,
           z_noise):
    """Text encoder and the reverse flow: (g, z, x_mask, z_p, m_p, logs_p)."""
    g = embedding(params["emb_g"]["w"], sid)[:, None, :]
    m_p, logs_p, x_mask = text_encoder(params["enc_p"], cfg, phone, pitch,
                                       phone_lengths)
    z_p = (m_p + torch.exp(logs_p) * z_noise * 0.66666) * x_mask
    z = flow(params["flow"], z_p, x_mask, g, reverse=True)
    return g, z, x_mask, z_p, m_p, logs_p


def infer(params: Params, cfg: Any, phone, phone_lengths, pitch,
          nsff0, sid, z_noise, noise: dict):
    """Inference (reference synthesizers.py:446-465) on explicit noise:
    z_noise (B, T, inter) and noise {"sine": (B, T*upp, 1)}.  Returns the
    waveform (B, T*upp, 1)."""
    g, z, x_mask, *_ = _prior(params, cfg, phone, phone_lengths, pitch, sid,
                              z_noise)
    return generator_nsf(params["dec"], cfg, z * x_mask, nsff0, g, noise["sine"])


def train_forward(params: Params, cfg: Any, phone, phone_lengths,
                  pitch, pitchf, y, y_lengths, ds, *, post_noise, ids_slice,
                  dec_noise):
    """Training path (reference synthesizers.py:434-443), the NSF decoder
    on the sliced pitch.

    y: (B, T_spec, spec_channels) linear spectrogram; pitchf: (B, T_spec)
    Hz; the noise as the port's `synthesizer.train_noise` lays it out:
    post_noise (B, T_spec, inter), ids_slice (B,), dec_noise {"sine":
    (B, segment_size * upp, 1)}.  Returns (y_hat (B,
    segment_size * upp, 1), ids_slice, x_mask, y_mask, (z, z_flowed, m_p,
    logs_p, m_q, logs_q))."""
    g = embedding(params["emb_g"]["w"], ds)[:, None, :]
    m_p, logs_p, x_mask = text_encoder(params["enc_p"], cfg, phone, pitch,
                                       phone_lengths)
    z, m_q, logs_q, y_mask = posterior_encoder(params["enc_q"], y, y_lengths, g,
                                               post_noise)
    seg = cfg.segment_size
    z_slice = slice_segments(z, ids_slice, seg)
    pitchf_slice = slice_segments(pitchf, ids_slice, seg)
    y_hat = generator_nsf(params["dec"], cfg, z_slice, pitchf_slice, g, dec_noise["sine"])
    z_flowed = flow(params["flow"], z, y_mask, g, reverse=False)
    return y_hat, ids_slice, x_mask, y_mask, (z, z_flowed, m_p, logs_p, m_q, logs_q)
