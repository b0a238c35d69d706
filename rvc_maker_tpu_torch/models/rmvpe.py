"""RMVPE pitch estimator in PyTorch: mel U-Net + BiGRU + cents decode.

Counterpart of `rvc_maker_tpu/models/rmvpe.py` (reference
main/library/predictors/RMVPE.py): log-mel (128 bins, htk) -> U-Net
(5 encoder/decoder levels, 4 intermediate levels, 4 residual blocks
each, BatchNorm folded to scale/shift) -> 3-channel conv -> BiGRU(256)
-> 360-bin sigmoid salience -> local-average cents decode.

Layout NCHW = (batch, channels, time, mel), torch's conv2d layout.  The
decoder's transposed convs hold torch's (Cin, Cout, 3, 3) weight and run
as F.conv_transpose2d (the JAX package stores them pre-flipped for its
input-dilated form; `interop/from_jax.py` un-flips them).  The BiGRU is
torch.nn.GRU (gate order r, z, n, as the reference).

int8: `infer(..., use_int8=True)` runs each residual-block conv that
carries w_q (C_in >= 128, `ops.int8_conv.prequantize_rmvpe`) as a W8A8
conv with a dynamic per-tensor scale (`conv2d_w8a8`), as JAX `_qconv2d`
does.  In bf16 the JAX package W-folds encoder levels 0 and 2 and
decoder levels 2-4 (its `_ENC_FOLDS`, `_DEC_FOLDS`) into a chain that
has no int8 route, so in bf16 those levels keep their bf16 convs here
too.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.int8_conv import conv2d_w8a8
from ..ops.stft import rmvpe_mel

Params = Any

N_MELS = 128
N_CLASS = 360
CENTS_MAPPING = 20 * np.arange(N_CLASS) + 1997.3794084376191  # RMVPE.py:207


def _bn(x, p):
    return x * p["scale"][None, :, None, None] + p["shift"][None, :, None, None]


# the levels JAX folds in bf16, whose chain takes no int8 (module docstring)
_FOLDED_ENC = (True, False, True, False, False)
_FOLDED_DEC = (False, False, True, True, True)


def _qconv2d(x, c, use_int8: bool):
    """The 3x3 conv, or its W8A8 twin where w_q is attached (JAX `_qconv2d`)."""
    if use_int8 and "w_q" in c:
        return conv2d_w8a8(x, c["w"], w_q=c["w_q"], w_scale=c["w_scale"])
    return F.conv2d(x, c["w"], padding=1)


def _conv_block_res(p: Params, x, use_int8: bool = False):
    """ConvBlockRes: (conv3x3-BN-ReLU) x 2 + shortcut. RMVPE.py:11-22."""
    y = torch.relu(_bn(_qconv2d(x, p["conv1"], use_int8), p["bn1"]))
    y = torch.relu(_bn(_qconv2d(y, p["conv2"], use_int8), p["bn2"]))
    if "shortcut" in p:
        x = F.conv2d(x, p["shortcut"]["w"], p["shortcut"]["b"])
    return y + x


def _block_chain(p: Params, x, use_int8: bool = False):
    for bp in p["blocks"]:
        x = _conv_block_res(bp, x, use_int8)
    return x


def _decoder_block(p: Params, x, skip, use_int8: bool = False):
    """ConvT(3x3, stride 2, pad 1, outpad 1, no bias) + BN + ReLU, concat
    the skip, then the residual blocks. RMVPE.py:88-106."""
    y = F.conv_transpose2d(x, p["convt"]["w"], stride=2, padding=1,
                           output_padding=1)
    y = torch.relu(_bn(y, p["bn"]))
    return _block_chain(p, torch.cat([y, skip], dim=1), use_int8)


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


def e2e_apply(p: Params, mel, use_int8: bool = False):
    """Salience network.  mel: (B, n_mels, T), T a multiple of 32.
    use_int8: the W8A8 convs of the module docstring.  Returns (B, T,
    360) sigmoid salience."""
    x = _bn(mel.transpose(1, 2)[:, None], p["in_bn"])      # (B, 1, T, 128)
    folds = mel.dtype == torch.bfloat16
    skips = []
    for i, lp in enumerate(p["encoder"]):
        x = _block_chain(lp, x, use_int8 and not (folds and _FOLDED_ENC[i]))
        skips.append(x)
        x = F.avg_pool2d(x, 2)
    for lp in p["intermediate"]:
        x = _block_chain(lp, x, use_int8)
    for i, lp in enumerate(p["decoder"]):
        x = _decoder_block(lp, x, skips[-1 - i], use_int8 and not (folds and _FOLDED_DEC[i]))
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
          return_salience: bool = False, use_int8: bool = False):
    """audio_16k: (B, L) -> f0 (B, L//160 + 1) Hz.  The mel is
    reflect-padded to a multiple of 32 frames and the salience cropped
    back.  With return_salience, also returns the (B, T, 360) salience.
    The salience net runs in the params' dtype (fp32 or bf16), its deep
    convs in int8 with use_int8; the mel and the cents decode stay fp32,
    as JAX `infer`."""
    mel = rmvpe_mel(audio_16k)
    n_frames = mel.shape[-1]
    pad_to = 32 * ((n_frames - 1) // 32 + 1)
    mel = F.pad(mel, (0, pad_to - n_frames), mode="reflect")
    net_dtype = params["in_bn"]["scale"].dtype
    hidden = e2e_apply(params, mel.to(net_dtype), use_int8)[:, :n_frames].to(torch.float32)
    f0 = decode_cents(hidden, thred=thred)
    if f0_min is not None:
        f0 = torch.where((f0 < f0_min) | (f0 > f0_max), 0.0, f0)
    return (f0, hidden) if return_salience else f0


# ---------------------------------------------------------------------------
# reference rmvpe.pt import (BN folding)
# ---------------------------------------------------------------------------

def _np(t):
    a = t.detach().cpu().numpy() if not isinstance(t, np.ndarray) else t
    return a.astype(np.float32)


def _fold_bn(sd, prefix, eps=1e-5):
    gamma = _np(sd[f"{prefix}.weight"])
    beta = _np(sd[f"{prefix}.bias"])
    mean = _np(sd[f"{prefix}.running_mean"])
    var = _np(sd[f"{prefix}.running_var"])
    scale = gamma / np.sqrt(var + eps)
    return {"scale": torch.from_numpy(scale.astype(np.float32)),
            "shift": torch.from_numpy((beta - mean * scale).astype(np.float32))}


def _conv(sd, prefix):
    out = {"w": torch.from_numpy(_np(sd[f"{prefix}.weight"]))}
    if f"{prefix}.bias" in sd:
        out["b"] = torch.from_numpy(_np(sd[f"{prefix}.bias"]))
    return out


def _block_from(sd, prefix):
    p = {"conv1": _conv(sd, f"{prefix}.conv.0"),
         "bn1": _fold_bn(sd, f"{prefix}.conv.1"),
         "conv2": _conv(sd, f"{prefix}.conv.3"),
         "bn2": _fold_bn(sd, f"{prefix}.conv.4")}
    if f"{prefix}.shortcut.weight" in sd:
        p["shortcut"] = _conv(sd, f"{prefix}.shortcut")
    return p


def params_from_state_dict(sd, *, en_de_layers: int = 5, inter_layers: int = 4,
                           n_blocks: int = 4) -> Params:
    """Map the reference E2E state_dict (rmvpe.pt) onto the port's tree."""
    p: dict = {"in_bn": _fold_bn(sd, "unet.encoder.bn")}
    p["encoder"] = [{"blocks": [_block_from(sd, f"unet.encoder.layers.{i}.conv.{j}")
                                for j in range(n_blocks)]}
                    for i in range(en_de_layers)]
    p["intermediate"] = [{"blocks": [_block_from(sd, f"unet.intermediate.layers.{i}.conv.{j}")
                                     for j in range(n_blocks)]}
                         for i in range(inter_layers)]
    p["decoder"] = [{"convt": _conv(sd, f"unet.decoder.layers.{i}.conv1.0"),
                     "bn": _fold_bn(sd, f"unet.decoder.layers.{i}.conv1.1"),
                     "blocks": [_block_from(sd, f"unet.decoder.layers.{i}.conv2.{j}")
                                for j in range(n_blocks)]}
                    for i in range(en_de_layers)]
    p["cnn"] = _conv(sd, "cnn")
    g = "fc.0.gru"
    p["gru"] = make_bigru({
        "w_ih": _np(sd[f"{g}.weight_ih_l0"]), "w_hh": _np(sd[f"{g}.weight_hh_l0"]),
        "b_ih": _np(sd[f"{g}.bias_ih_l0"]), "b_hh": _np(sd[f"{g}.bias_hh_l0"]),
        "w_ih_r": _np(sd[f"{g}.weight_ih_l0_reverse"]),
        "w_hh_r": _np(sd[f"{g}.weight_hh_l0_reverse"]),
        "b_ih_r": _np(sd[f"{g}.bias_ih_l0_reverse"]),
        "b_hh_r": _np(sd[f"{g}.bias_hh_l0_reverse"]),
    })
    p["fc"] = {"w": torch.from_numpy(_np(sd["fc.1.weight"])),
               "b": torch.from_numpy(_np(sd["fc.1.bias"]))}
    return p


def load_rmvpe_pt(path: str) -> Params:
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return params_from_state_dict(sd)
