"""FCPE pitch estimator in PyTorch: a conformer mel pitch estimator with
FAVOR+ attention.

Counterpart of `rvc_maker_tpu/models/fcpe.py` (reference
main/library/predictors/FCPE.py, inference only):
  * mel front end (16 kHz, 128 mels, n_fft / win 1024, hop 160, the
    asymmetric (win - hop) / 2 pad, magnitude eps 1e-9, log floor 1e-5)
  * input stack: conv3 -> GroupNorm(4) -> LeakyReLU(0.01) -> conv3
  * N conformer layers: x += FAVOR+ self-attention(LN(x)) when the layer
    has one; x += conv module (LN -> 1x1 -> GLU -> depthwise k31 -> SiLU
    -> 1x1)
  * sigmoid salience over 360 cent bins -> local weighted-argmax cents ->
    f0 = 10 * 2^(cents / 1200), 0 below the confidence threshold
  * NaN-aware linear interpolation to a requested frame count

Params: plain dicts of torch tensors in torch layouts (conv (Cout, Cin /
groups, K), linear (Cout, Cin)), with the JAX package's names; a layer's
"attn" is None in conv-only (current) checkpoints.  The FAVOR+
projection matrices are buffers of the reference checkpoints, so
inference is deterministic.  Both generations load: "current"
(CFNaiveMelPE, fcpe.pt) and "legacy" (PCmer, fcpe_legacy.pt).
"""

from __future__ import annotations

import io
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.nn import conv1d, layer_norm, linear
from ..ops.stft import frame_signal, hann_window, mel_filterbank
from .vocoders import interp_linear

Params = Any


def fcpe_mel(audio_16k, *, n_mels: int = 128, n_fft: int = 1024,
             win: int = 1024, hop: int = 160, fmax: float = 8000.0):
    """(B, L) -> (B, L // hop + 1, n_mels) log-mel."""
    b, L = audio_16k.shape
    pad_left = (win - hop) // 2
    pad_right = max((win - hop + 1) // 2, win - L - pad_left)
    # reflect needs pads shorter than the input; a short input pads zeros
    mode = "reflect" if pad_right < L else "constant"
    y = F.pad(audio_16k.to(torch.float32)[:, None], (pad_left, pad_right), mode=mode)[:, 0]
    window = torch.as_tensor(hann_window(win), device=y.device)
    spec = torch.fft.rfft(frame_signal(y, n_fft, hop) * window, n=n_fft, dim=-1)
    mag = torch.sqrt(spec.real.square() + spec.imag.square() + 1e-9)
    basis = torch.as_tensor(mel_filterbank(16000, n_fft, n_mels, 0.0, fmax, htk=False),
                            device=y.device)
    mel = torch.log(torch.clamp(torch.matmul(mag, basis.T), min=1e-5))
    n_frames = L // hop + 1
    if n_frames > mel.shape[1]:
        mel = torch.cat([mel, mel[:, -1:]], dim=1)
    return mel[:, :n_frames]


# ---------------------------------------------------------------------------
# FAVOR+ (performer) attention, reference FCPE.py:87-130, 556-630
# ---------------------------------------------------------------------------

def _softmax_kernel(data, projection, is_query: bool, eps: float = 1e-4):
    """data: (B, H, T, d); projection: (m, d).  The query path subtracts
    its row max before exp; the key path does not, and adds eps inside."""
    normalizer = data.shape[-1] ** -0.25
    ratio = projection.shape[0] ** -0.5
    dash = torch.einsum("bhid,jd->bhij", normalizer * data, projection)
    diag = (data.square().sum(dim=-1) / 2.0 * normalizer ** 2)[..., None]
    if is_query:
        return ratio * (torch.exp(dash - diag - dash.amax(dim=-1, keepdim=True)) + eps)
    return ratio * torch.exp(dash - diag + eps)


def _linear_attention(q, k, v):
    ctx = torch.einsum("bhnd,bhne->bhde", k, v)
    denom = 1.0 / (torch.einsum("bhnd,bhd->bhn", q, k.sum(dim=-2)) + 1e-8)
    return torch.einsum("bhde,bhnd,bhn->bhne", ctx, q, denom)


def _self_attention(p: Params, x, n_heads: int = 8):
    b, t, _ = x.shape
    # the reference's head width is 64 whatever the model width: take it
    # from the weights (inner = 64 * heads, FCPE.py:586-589)
    inner = p["q"]["w"].shape[0]
    d = inner // n_heads

    def heads(lp):
        return linear(x, lp["w"], lp["b"]).reshape(b, t, n_heads, d).transpose(1, 2)

    q = _softmax_kernel(heads(p["q"]), p["projection"], True)
    k = _softmax_kernel(heads(p["k"]), p["projection"], False)
    out = _linear_attention(q, k, heads(p["v"]))
    return linear(out.transpose(1, 2).reshape(b, t, inner), p["o"]["w"], p["o"]["b"])


# ---------------------------------------------------------------------------
# conformer conv module and the layers
# ---------------------------------------------------------------------------

def _group_norm(x, gamma, beta, groups: int = 4, eps: float = 1e-5):
    """x: (B, C, T); statistics per (C / groups channels x T) of each row."""
    return F.group_norm(x, groups, gamma, beta, eps)


def _conformer_conv(p: Params, x, kernel: int = 31):
    """x: (B, T, C) -> (B, T, C)."""
    y = layer_norm(x, p["ln"]["gamma"], p["ln"]["beta"])
    y = F.glu(linear(y, p["pw1"]["w"], p["pw1"]["b"]), dim=-1)
    y = conv1d(y.transpose(1, 2), p["dw"]["w"], p["dw"]["b"], padding=kernel // 2,
               groups=y.shape[-1])
    y = F.silu(y).transpose(1, 2)
    return linear(y, p["pw2"]["w"], p["pw2"]["b"])


def salience(p: Params, mel):
    """mel: (B, T, n_mels) -> (B, T, out_dims) sigmoid salience."""
    x = conv1d(mel.transpose(1, 2), p["in_conv1"]["w"], p["in_conv1"]["b"], padding=1)
    x = _group_norm(x, p["in_gn"]["gamma"], p["in_gn"]["beta"])
    x = F.leaky_relu(x, 0.01)
    x = conv1d(x, p["in_conv2"]["w"], p["in_conv2"]["b"], padding=1).transpose(1, 2)
    for lp in p["layers"]:
        if lp.get("attn") is not None:
            x = x + _self_attention(lp["attn"], layer_norm(x, lp["ln"]["gamma"],
                                                           lp["ln"]["beta"]))
        x = x + _conformer_conv(lp["conv"], x)
    x = layer_norm(x, p["norm"]["gamma"], p["norm"]["beta"])
    return torch.sigmoid(linear(x, p["out"]["w"], p["out"]["b"]))


# ---------------------------------------------------------------------------
# decode (reference cents_local_decoder + cent_to_f0)
# ---------------------------------------------------------------------------

def decode_local(y, cent_table, threshold: float = 0.05):
    """y: (B, T, out_dims) -> f0 (B, T) Hz, 0 where the confidence is at
    or below `threshold`."""
    out_dims = y.shape[-1]
    conf = y.amax(dim=-1)
    idx = torch.clamp(y.argmax(dim=-1)[..., None] + torch.arange(9, device=y.device) - 4,
                      0, out_dims - 1)
    y_l = torch.gather(y, -1, idx)
    cents = (cent_table[idx] * y_l).sum(dim=-1) / y_l.sum(dim=-1)
    f0 = 10.0 * torch.pow(2.0, cents / 1200.0)
    return torch.where(conf > threshold, f0, 0.0)


def interp_to_length(f0, target_len: int):
    """The reference's output_interp_target_length (FCPE.py:698-701):
    zeros -> NaN, linear interpolation, NaN -> 0."""
    x = torch.where(f0 == 0.0, torch.nan, f0)[:, None, :]
    out = interp_linear(x, target_len)[:, 0]
    return torch.where(torch.isnan(out), 0.0, out)


def infer(params: Params, audio_16k, *, threshold: float = 0.05,
          p_len: int | None = None):
    """(B, L) 16 kHz -> f0 (B, p_len or L // 160 + 1) Hz.  The salience
    net runs in its weights' dtype (fp32 or bf16); the mel and the decode,
    with the cent table, stay fp32."""
    net_dtype = params["in_conv1"]["w"].dtype
    y = salience(params, fcpe_mel(audio_16k).to(net_dtype)).to(torch.float32)
    f0 = decode_local(y, params["cent_table"].to(torch.float32), threshold)
    if p_len is not None and p_len != f0.shape[1]:
        f0 = interp_to_length(f0, p_len)
    return f0


# ---------------------------------------------------------------------------
# reference checkpoint import
# ---------------------------------------------------------------------------

def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).contiguous()


def _wb(sd, prefix) -> dict:
    out = {"w": _f32(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["b"] = _f32(sd[f"{prefix}.bias"])
    return out


def _wn_linear(sd, prefix) -> dict:
    """A weight-normed Linear, g * v / ||v|| folded (norm per output row)."""
    from ..interop.pth import folded_weight

    return {"w": folded_weight(sd, prefix), "b": _f32(sd[f"{prefix}.bias"])}


def _ln(sd, prefix) -> dict:
    return {"gamma": _f32(sd[f"{prefix}.weight"]), "beta": _f32(sd[f"{prefix}.bias"])}


def params_from_state_dict(sd, *, legacy: bool = False) -> Params:
    """A CFNaiveMelPE (current) or PCmer (legacy) state dict -> the port's
    tree.

    current keys: input_stack.{0,1,3}, net.encoder_layers.{i}.(norm|attn|
    conformer.net.{0,2,4.conv,6}), norm, output_proj, cent_table
    legacy keys: stack.{0,1,3}, decoder._layers.{i}.(norm|attn|
    conformer.net.{0,2,4.conv,6}), norm, dense_out, cent_table
    The layer count comes from the keys.
    """
    stem = "stack" if legacy else "input_stack"
    layers_prefix = "decoder._layers" if legacy else "net.encoder_layers"
    n_layers = 0
    while f"{layers_prefix}.{n_layers}.norm.weight" in sd:
        n_layers += 1
    p: dict = {
        "in_conv1": _wb(sd, f"{stem}.0"),
        "in_gn": _ln(sd, f"{stem}.1"),
        "in_conv2": _wb(sd, f"{stem}.3"),
        "norm": _ln(sd, "norm"),
        "out": _wn_linear(sd, "dense_out" if legacy else "output_proj"),
        "cent_table": _f32(sd["cent_table"]),
        "layers": [],
    }
    for i in range(n_layers):
        lp = f"{layers_prefix}.{i}"
        net = f"{lp}.conformer.net"
        # conv-only checkpoints have no attention sub-module: the only
        # constructible configuration of the reference's current-gen layer
        attn = None
        if f"{lp}.attn.to_q.weight" in sd:
            attn = {k: _wb(sd, f"{lp}.attn.to_{m}")
                    for k, m in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "out"))}
            attn["projection"] = _f32(sd[f"{lp}.attn.fast_attention.projection_matrix"])
        pw1, pw2 = _wb(sd, f"{net}.2"), _wb(sd, f"{net}.6")
        p["layers"].append({
            "ln": _ln(sd, f"{lp}.norm"),
            "attn": attn,
            "conv": {"ln": _ln(sd, f"{net}.0"),
                     "pw1": {"w": pw1["w"][:, :, 0], "b": pw1["b"]},
                     "dw": _wb(sd, f"{net}.4.conv"),
                     "pw2": {"w": pw2["w"][:, :, 0], "b": pw2["b"]}},
        })
    return p


def load_fcpe_ckpt(path: str) -> tuple[Params, bool]:
    """fcpe.pt / fcpe_legacy.pt -> (params, legacy).

    The released files are AES-256-CBC encrypted at rest with the key the
    reference ships (FCPE.py:28-40); plain files load unchanged.  Legacy
    checkpoints carry "config", current ones "config_dict"."""
    from ..interop.modelcrypt import maybe_decrypt

    with open(path, "rb") as fh:
        raw = maybe_decrypt(fh.read())
    ckpt = torch.load(io.BytesIO(raw), map_location="cpu", weights_only=False)
    legacy = "config" in ckpt
    return params_from_state_dict(ckpt["model"], legacy=legacy), legacy


def cent_table(out_dims: int = 360, f0_min: float = 32.70, f0_max: float = 1975.5):
    """The reference's cent_table buffer: out_dims cents evenly spaced from
    f0_min to f0_max (cents = 1200 log2(f / 10))."""
    return np.linspace(1200 * np.log2(f0_min / 10.0), 1200 * np.log2(f0_max / 10.0),
                       out_dims).astype(np.float32)
