"""HuBERT / ContentVec feature extraction of the reference: a frozen copy
of the port's `models/hubert.py` in fp32, without its int8 and
tensor-parallel routes.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from .nn import conv1d, layer_norm, linear

Params = Any

CONV_LAYERS = ((512, 10, 5), (512, 3, 2), (512, 3, 2), (512, 3, 2),
               (512, 3, 2), (512, 2, 2), (512, 2, 2))
EMBED_DIM = 768
FFN_DIM = 3072
N_HEADS = 12
N_LAYERS = 12
POS_CONV_K = 128
POS_CONV_GROUPS = 16


def _gelu(x):
    return F.gelu(x)  # exact erf GELU, as fairseq


def frame_lengths(lengths):
    """Valid frame count after the VALID conv stack, from sample counts."""
    fl = lengths
    for (_, k, s) in CONV_LAYERS:
        fl = torch.div(fl - k, s, rounding_mode="floor") + 1
    return fl


def conv_frontend(p: Params, source, lengths=None):
    """source: (B, L) -> (B, T, 512).

    The first layer's GroupNorm(512, 512) normalizes each channel over
    time, over the valid frames only when `lengths` is given, so a
    padded batch row equals the same audio run alone."""
    x = source[:, None, :]
    fl = lengths
    for i, (_, k, stride) in enumerate(CONV_LAYERS):
        x = conv1d(x, p["convs"][i]["w"], stride=stride)
        if fl is not None:
            fl = torch.div(fl - k, stride, rounding_mode="floor") + 1
        if i == 0:
            xf = x.to(torch.float32)
            if fl is None:
                mean = xf.mean(dim=2, keepdim=True)
                var = (xf - mean).square().mean(dim=2, keepdim=True)
            else:
                m = (torch.arange(x.shape[2], device=x.device)[None, :]
                     < fl[:, None])[:, None, :]
                cnt = torch.clamp(m.sum(dim=2, keepdim=True), min=1)
                mean = torch.where(m, xf, 0.0).sum(dim=2, keepdim=True) / cnt
                var = torch.where(m, (xf - mean).square(), 0.0).sum(
                    dim=2, keepdim=True) / cnt
            x = ((xf - mean) * torch.rsqrt(var + 1e-5)
                 * p["gn"]["gamma"][:, None] + p["gn"]["beta"][:, None]).to(x.dtype)
        x = _gelu(x)
    return x.transpose(1, 2)


def _self_attention(lp: Params, x, attn_bias):
    """fairseq self-attention, eval mode.  x: (B, T, C); attn_bias:
    (B, 1, 1, T) additive or None.  Softmax in fp32."""
    b, t, c = x.shape
    d = c // N_HEADS
    h = lp["q"]["w"].shape[0] // d

    def heads(y):
        return y.reshape(b, t, h, d).transpose(1, 2)

    q = heads(linear(x, lp["q"]["w"], lp["q"]["b"]) * (d ** -0.5))
    k = heads(linear(x, lp["k"]["w"], lp["k"]["b"]))
    v = heads(linear(x, lp["v"]["w"], lp["v"]["b"]))
    scores = torch.matmul(q, k.transpose(-1, -2))
    if attn_bias is not None:
        scores = scores + attn_bias
    p_attn = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
    out = torch.matmul(p_attn, v).transpose(1, 2).reshape(b, t, h * d)
    return linear(out, lp["o"]["w"], lp["o"]["b"])


def _encoder_layer(lp: Params, x, attn_bias):
    """Post-LN transformer layer (fairseq layer_norm_first=False)."""
    y = _self_attention(lp["attn"], x, attn_bias)
    x = layer_norm(x + y, lp["ln1"]["gamma"], lp["ln1"]["beta"])
    hidden = _gelu(linear(x, lp["fc1"]["w"], lp["fc1"]["b"]))
    y = linear(hidden, lp["fc2"]["w"], lp["fc2"]["b"])
    return layer_norm(x + y, lp["ln2"]["gamma"], lp["ln2"]["beta"])


def extract_features(params: Params, source, lengths=None, *,
                     output_layer: int = 12):
    """source: (B, L) 16 kHz; lengths: (B,) valid samples or None;
    Returns (features (B, T, 768), frame_lengths
    (B,))."""
    feats = conv_frontend(params["frontend"], source, lengths)
    b, t, _ = feats.shape
    if lengths is not None:
        fl = frame_lengths(lengths)
        frame_mask = torch.arange(t, device=feats.device)[None, :] < fl[:, None]
    else:
        fl = torch.full((b,), t, dtype=torch.int64, device=feats.device)
        frame_mask = None

    feats = layer_norm(feats, params["ln_feats"]["gamma"], params["ln_feats"]["beta"])
    x = linear(feats, params["post_proj"]["w"], params["post_proj"]["b"])
    if frame_mask is not None:
        x = x * frame_mask[:, :, None]

    # positional conv; SamePad trims the trailing column
    pos = conv1d(x.transpose(1, 2), params["pos_conv"]["w"],
                 params["pos_conv"]["b"], padding=POS_CONV_K // 2,
                 groups=POS_CONV_GROUPS)[:, :, :-1]
    x = x + _gelu(pos.transpose(1, 2))
    x = layer_norm(x, params["ln_pre"]["gamma"], params["ln_pre"]["beta"])

    # pad T to a multiple of 2 (fairseq required_seq_len_multiple); the
    # pads are unconditional (a pad of 0 is a copy), so that a symbolic t
    # (torch.export of a dynamic length) takes no branch on its parity
    pad_t = t % 2
    x = F.pad(x, (0, 0, 0, pad_t))
    attn_bias = None
    if frame_mask is not None or pad_t:
        key_mask = (~frame_mask if frame_mask is not None
                    else torch.zeros((b, t), dtype=torch.bool, device=x.device))
        key_mask = F.pad(key_mask, (0, pad_t), value=True)
        attn_bias = torch.zeros(key_mask.shape, dtype=x.dtype, device=x.device)
        attn_bias = attn_bias.masked_fill(key_mask, float("-inf"))[:, None, None, :]

    for lp in params["layers"][:output_layer]:
        x = _encoder_layer(lp, x, attn_bias)
    return x[:, :t], fl
