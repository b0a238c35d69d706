"""RMVPE pitch estimation of the reference: a frozen copy of the port's
`models/rmvpe.py` in fp32, without its int8 route.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .stft import rmvpe_mel

Params = Any

N_MELS = 128
N_CLASS = 360
CENTS_MAPPING = 20 * np.arange(N_CLASS) + 1997.3794084376191  # RMVPE.py:207


def _bn(x, p):
    return x * p["scale"][None, :, None, None] + p["shift"][None, :, None, None]


def _conv_block_res(p: Params, x):
    """ConvBlockRes: (conv3x3-BN-ReLU) x 2 + shortcut. RMVPE.py:11-22."""
    y = torch.relu(_bn(F.conv2d(x, p["conv1"]["w"], padding=1), p["bn1"]))
    y = torch.relu(_bn(F.conv2d(y, p["conv2"]["w"], padding=1), p["bn2"]))
    if "shortcut" in p:
        x = F.conv2d(x, p["shortcut"]["w"], p["shortcut"]["b"])
    return y + x


def _block_chain(p: Params, x):
    for bp in p["blocks"]:
        x = _conv_block_res(bp, x)
    return x


def _decoder_block(p: Params, x, skip):
    """ConvT(3x3, stride 2, pad 1, outpad 1, no bias) + BN + ReLU, concat
    the skip, then the residual blocks. RMVPE.py:88-106."""
    y = F.conv_transpose2d(x, p["convt"]["w"], stride=2, padding=1,
                           output_padding=1)
    y = torch.relu(_bn(y, p["bn"]))
    return _block_chain(p, torch.cat([y, skip], dim=1))


def make_bigru(w: dict) -> torch.nn.GRU:
    """A bidirectional torch.nn.GRU holding the given torch-layout weights
    (w_ih (3H, I), w_hh (3H, H), b_ih, b_hh and their *_r reverses)."""
    hidden = w["w_hh"].shape[1]
    gru = torch.nn.GRU(w["w_ih"].shape[1], hidden, num_layers=1,
                       batch_first=True, bidirectional=True)
    names = {"weight_ih_l0": "w_ih", "weight_hh_l0": "w_hh",
             "bias_ih_l0": "b_ih", "bias_hh_l0": "b_hh",
             "weight_ih_l0_reverse": "w_ih_r", "weight_hh_l0_reverse": "w_hh_r",
             "bias_ih_l0_reverse": "b_ih_r", "bias_hh_l0_reverse": "b_hh_r"}
    with torch.no_grad():
        for attr, key in names.items():
            getattr(gru, attr).copy_(torch.as_tensor(w[key]))
    return gru.eval().requires_grad_(False)


def e2e_apply(p: Params, mel):
    """Salience network.  mel: (B, n_mels, T), T a multiple of 32.
    Returns (B, T,
    360) sigmoid salience."""
    x = _bn(mel.transpose(1, 2)[:, None], p["in_bn"])      # (B, 1, T, 128)
    skips = []
    for i, lp in enumerate(p["encoder"]):
        x = _block_chain(lp, x)
        skips.append(x)
        x = F.avg_pool2d(x, 2)
    for lp in p["intermediate"]:
        x = _block_chain(lp, x)
    for i, lp in enumerate(p["decoder"]):
        x = _decoder_block(lp, x, skips[-1 - i])
    x = F.conv2d(x, p["cnn"]["w"], p["cnn"]["b"], padding=1)  # (B, 3, T, 128)
    b, c, t, f = x.shape
    x = x.transpose(1, 2).reshape(b, t, c * f)              # (B, T, 3*128)
    x = p["gru"](x)[0]
    return torch.sigmoid(F.linear(x, p["fc"]["w"], p["fc"]["b"]))


def decode_cents(salience, thred: float = 0.03):
    """Local-average cents decode (reference RMVPE.py:236-252).
    salience: (B, T, 360).  Returns f0 (B, T) Hz, 0 = unvoiced.  The
    argmax takes the first of equal maxima, as jnp.argmax."""
    center = torch.argmax(salience, dim=-1)                 # (B, T)
    pad = F.pad(salience, (4, 4))
    cmap = torch.as_tensor(np.pad(CENTS_MAPPING, (4, 4)).astype(np.float32),
                           device=salience.device)
    idx = center[..., None] + torch.arange(9, device=salience.device)
    win = torch.gather(pad, -1, idx)                         # (B, T, 9)
    cents = (win * cmap[idx]).sum(-1) / win.sum(-1)
    cents = torch.where(salience.amax(dim=-1) > thred, cents, 0.0)
    f0 = 10.0 * torch.pow(2.0, cents / 1200.0)
    return torch.where(f0 == 10.0, 0.0, f0)


def infer(params: Params, audio_16k, *, thred: float = 0.03,
          f0_min: float | None = None, f0_max: float | None = None,
          return_salience: bool = False):
    """audio_16k: (B, L) -> f0 (B, L//160 + 1) Hz.  The mel is
    reflect-padded to a multiple of 32 frames and the salience cropped
    back.  With return_salience, also returns the (B, T, 360) salience.
    The salience net runs in the params' dtype; the mel and the cents
    decode stay fp32."""
    mel = rmvpe_mel(audio_16k)
    n_frames = mel.shape[-1]
    pad_to = 32 * ((n_frames - 1) // 32 + 1)
    mel = F.pad(mel, (0, pad_to - n_frames), mode="reflect")
    net_dtype = params["in_bn"]["scale"].dtype
    hidden = e2e_apply(params, mel.to(net_dtype))[:, :n_frames].to(torch.float32)
    f0 = decode_cents(hidden, thred=thred)
    if f0_min is not None:
        f0 = torch.where((f0 < f0_min) | (f0 > f0_max), 0.0, f0)
    return (f0, hidden) if return_salience else f0


