"""ECAPA-TDNN speaker embeddings in PyTorch (counterpart of JAX
`models/ecapa_tdnn.py`; reference main/library/speaker_diarization/
ECAPA_TDNN.py, speechbrain's ECAPA).

A TDNN stem, three SE-Res2Net blocks (scale 8), multi-layer feature
aggregation, attentive statistics pooling with global context, BN and a
linear layer to 192 dimensions.  Inference only: every BatchNorm is
folded into a scale and shift at import.  Fixed widths 512 / 512 / 512 /
512 / 1536, kernels 5 / 3 / 3 / 3 / 1, dilations 1 / 2 / 3 / 4 / 1.

Layout: (B, C, T).  The "same" convs reflect-pad dilation * (k - 1) / 2 on
each side (the reference's get_padding_elem for stride 1).  The
parameters are a tree of tensors in the JAX tree's structure, conv
weights (Cout, Cin, K) as the state dict holds them.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..device import resolve_device, tree_to
from ..errors import BadRequest

Params = Any

CHANNELS = (512, 512, 512, 512, 1536)
KERNELS = (5, 3, 3, 3, 1)
DILATIONS = (1, 2, 3, 4, 1)
RES2NET_SCALE = 8


def _same_conv(x, p, *, kernel: int, dilation: int = 1):
    pad = dilation * (kernel - 1) // 2
    if pad:
        x = F.pad(x, (pad, pad), mode="reflect")
    return F.conv1d(x, p["w"], p.get("b"), dilation=dilation)


def _affine(x, bn):
    return x * bn["scale"][:, None] + bn["shift"][:, None]


def _tdnn(x, p, *, kernel: int, dilation: int = 1):
    """Conv -> ReLU -> folded BN (the reference's TDNNBlock)."""
    return _affine(F.relu(_same_conv(x, p["conv"], kernel=kernel, dilation=dilation)), p["bn"])


def _res2net(x, p, *, kernel: int, dilation: int):
    chunks = torch.chunk(x, RES2NET_SCALE, dim=1)
    outs = [chunks[0]]
    y = None
    for i in range(1, RES2NET_SCALE):
        inp = chunks[i] if i == 1 else chunks[i] + y
        y = _tdnn(inp, p["blocks"][i - 1], kernel=kernel, dilation=dilation)
        outs.append(y)
    return torch.cat(outs, dim=1)


def _se_block(x, p):
    s = x.mean(dim=2, keepdim=True)
    s = F.relu(_same_conv(s, p["conv1"], kernel=1))
    s = torch.sigmoid(_same_conv(s, p["conv2"], kernel=1))
    return s * x


def _se_res2net(x, p, *, kernel: int, dilation: int):
    residual = _same_conv(x, p["shortcut"], kernel=1) if "shortcut" in p else x
    y = _tdnn(x, p["tdnn1"], kernel=1)
    y = _res2net(y, p["res2net"], kernel=kernel, dilation=dilation)
    y = _tdnn(y, p["tdnn2"], kernel=1)
    return _se_block(y, p["se"]) + residual


def _asp(x, p):
    """Attentive statistics pooling with global context (the reference's
    AttentiveStatisticsPooling): (B, C, T) -> (B, 2C)."""
    eps = 1e-12
    t = x.shape[2]
    mean = x.mean(dim=2, keepdim=True)
    std = torch.sqrt(torch.clamp((x - mean).square().mean(dim=2, keepdim=True), min=eps))
    attn = torch.cat([x, mean.expand(-1, -1, t), std.expand(-1, -1, t)], dim=1)
    attn = _tdnn(attn, p["tdnn"], kernel=1)
    w = torch.softmax(_same_conv(torch.tanh(attn), p["conv"], kernel=1), dim=2)
    mean = (w * x).sum(dim=2, keepdim=True)
    std = torch.sqrt(torch.clamp((w * (x - mean).square()).sum(dim=2), min=eps))
    return torch.cat([mean[:, :, 0], std], dim=1)


@torch.inference_mode()
def embed(params: Params, feats):
    """feats: (B, T, n_mels) -> speaker embeddings (B, lin_neurons), on
    the parameters' device."""
    x = _tdnn(feats.transpose(1, 2), params["blocks"][0], kernel=KERNELS[0],
              dilation=DILATIONS[0])
    xl = []
    for i in range(1, len(CHANNELS) - 1):
        x = _se_res2net(x, params["blocks"][i], kernel=KERNELS[i], dilation=DILATIONS[i])
        xl.append(x)
    x = _tdnn(torch.cat(xl, dim=1), params["mfa"], kernel=KERNELS[-1], dilation=DILATIONS[-1])
    x = _affine(_asp(x, params["asp"])[:, :, None], params["asp_bn"])
    return _same_conv(x, params["fc"], kernel=1)[:, :, 0]


def params_device(params) -> torch.device:
    return params["fc"]["w"].device


# ---------------------------------------------------------------------------
# checkpoints (BN folding; the reference's module names)
# ---------------------------------------------------------------------------

def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32)


def _conv_from(sd, prefix):
    out = {"w": _f32(sd[f"{prefix}.conv.weight"])}          # (Cout, Cin, K)
    if f"{prefix}.conv.bias" in sd:
        out["b"] = _f32(sd[f"{prefix}.conv.bias"])
    return out


def _bn_from(sd, prefix, eps=1e-5):
    gamma, beta = _f32(sd[f"{prefix}.norm.weight"]), _f32(sd[f"{prefix}.norm.bias"])
    mean, var = _f32(sd[f"{prefix}.norm.running_mean"]), _f32(sd[f"{prefix}.norm.running_var"])
    scale = gamma / torch.sqrt(var + eps)
    return {"scale": scale, "shift": beta - mean * scale}


def _tdnn_from(sd, prefix):
    return {"conv": _conv_from(sd, f"{prefix}.conv"), "bn": _bn_from(sd, f"{prefix}.norm")}


def params_from_state_dict(sd) -> Params:
    """A reference ECAPA_TDNN state dict -> the tree, BatchNorms folded
    (JAX :126-163).  A missing weight is a BadRequest."""
    try:
        p: dict = {"blocks": [_tdnn_from(sd, "blocks.0")]}
        for i in range(1, len(CHANNELS) - 1):
            bp = f"blocks.{i}"
            blk = {
                "tdnn1": _tdnn_from(sd, f"{bp}.tdnn1"),
                "res2net": {"blocks": [_tdnn_from(sd, f"{bp}.res2net_block.blocks.{j}")
                                       for j in range(RES2NET_SCALE - 1)]},
                "tdnn2": _tdnn_from(sd, f"{bp}.tdnn2"),
                "se": {"conv1": _conv_from(sd, f"{bp}.se_block.conv1"),
                       "conv2": _conv_from(sd, f"{bp}.se_block.conv2")},
            }
            if f"{bp}.shortcut.conv.weight" in sd:
                blk["shortcut"] = _conv_from(sd, f"{bp}.shortcut")
            p["blocks"].append(blk)
        p["mfa"] = _tdnn_from(sd, "mfa")
        p["asp"] = {"tdnn": _tdnn_from(sd, "asp.tdnn"), "conv": _conv_from(sd, "asp.conv")}
        p["asp_bn"] = _bn_from(sd, "asp_bn")
        p["fc"] = _conv_from(sd, "fc")
    except KeyError as e:
        raise BadRequest(f"not an ECAPA-TDNN state dict: no {e}") from e
    return p


def load_ecapa_ckpt(path: str, device="cuda") -> Params:
    """An ECAPA state dict file (speechbrain's embedding_model.ckpt, with
    or without the "embedding_model." prefix) -> the tree on `device`
    (JAX :165)."""
    dev = resolve_device(device)
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # noqa: BLE001 — an unreadable file is the caller's
        raise BadRequest(f"{path}: not an ECAPA-TDNN checkpoint ({e!r})") from e
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if any(k.startswith("embedding_model.") for k in sd):
        sd = {k[len("embedding_model."):]: v for k, v in sd.items()
              if k.startswith("embedding_model.")}
    return tree_to(params_from_state_dict(sd), dev)
