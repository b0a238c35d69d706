"""HuBERT/ContentVec content encoder in PyTorch (feature extraction).

Counterpart of `rvc_maker_tpu/models/hubert.py` (reference vendored
fairseq HuBERT): conv front end with a masked GroupNorm on its first
layer, LayerNorm + 512->768 projection, grouped positional conv
(k=128, groups=16, last column trimmed), post-LN transformer layers with
exact (erf) GELU and an fp32 softmax.  v2 features are layer 12 (768-d);
v1 is layer 9 through `final_proj` (256-d).

Params: plain dicts of torch tensors in torch layout; `layers` is a
list of per-layer dicts (the JAX package stacks them for lax.scan).

int8: `extract_features(..., use_int8=True)` runs the six transformer
matmuls of each layer as W8A8 products with per-token activation scales
(`ops.int8_conv.linear_w8a8`, from the w_q / w_scale that
`prequantize_hubert` attached), as JAX `_qlin` does.
`params_from_fairseq_state_dict` loads a fairseq checkpoint, folding the
positional conv's weight-norm.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..interop.pth import folded_weight
from ..ops.int8_conv import linear_w8a8
from ..ops.nn import conv1d, layer_norm, linear

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


def _qlin(x, c, use_int8: bool):
    """`linear`, or its W8A8 twin (JAX `_qlin`)."""
    if use_int8:
        return linear_w8a8(x, c["w"], c.get("b"), w_q=c.get("w_q"), w_scale=c.get("w_scale"))
    return linear(x, c["w"], c.get("b"))


def _row_parallel(x, c, reduce):
    """A linear layer whose input features are split over ranks: the
    partial product summed over them by `reduce`, the bias added once,
    after it (JAX `parallel/tensor.py`: the psum at the o / fc2 boundary)."""
    y = linear(x, c["w"])
    reduce(y)
    return y + c["b"]


def _self_attention(lp: Params, x, attn_bias, use_int8: bool = False, reduce=None):
    """fairseq self-attention, eval mode.  x: (B, T, C); attn_bias:
    (B, 1, 1, T) additive or None.  Softmax in fp32.  Under tensor
    parallelism (`reduce` given) q, k and v hold this rank's heads."""
    b, t, c = x.shape
    d = c // N_HEADS
    h = lp["q"]["w"].shape[0] // d

    def heads(y):
        return y.reshape(b, t, h, d).transpose(1, 2)

    q = heads(_qlin(x, lp["q"], use_int8) * (d ** -0.5))
    k = heads(_qlin(x, lp["k"], use_int8))
    v = heads(_qlin(x, lp["v"], use_int8))
    scores = torch.matmul(q, k.transpose(-1, -2))
    if attn_bias is not None:
        scores = scores + attn_bias
    p_attn = torch.softmax(scores.to(torch.float32), dim=-1).to(x.dtype)
    out = torch.matmul(p_attn, v).transpose(1, 2).reshape(b, t, h * d)
    if reduce is not None:
        return _row_parallel(out, lp["o"], reduce)
    return _qlin(out, lp["o"], use_int8)


def _encoder_layer(lp: Params, x, attn_bias, use_int8: bool = False, reduce=None):
    """Post-LN transformer layer (fairseq layer_norm_first=False)."""
    y = _self_attention(lp["attn"], x, attn_bias, use_int8, reduce)
    x = layer_norm(x + y, lp["ln1"]["gamma"], lp["ln1"]["beta"])
    hidden = _gelu(_qlin(x, lp["fc1"], use_int8))
    y = (_qlin(hidden, lp["fc2"], use_int8) if reduce is None
         else _row_parallel(hidden, lp["fc2"], reduce))
    return layer_norm(x + y, lp["ln2"]["gamma"], lp["ln2"]["beta"])


def extract_features(params: Params, source, lengths=None, *,
                     output_layer: int = 12, use_int8: bool = False, reduce=None):
    """source: (B, L) 16 kHz; lengths: (B,) valid samples or None;
    use_int8: the transformer's matmuls in W8A8 (module docstring);
    reduce: the in-place sum over ranks of tensor-parallel params
    (`parallel/tensor.py`).  Returns (features (B, T, 768), frame_lengths
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
        x = _encoder_layer(lp, x, attn_bias, use_int8, reduce)
    return x[:, :t], fl


def final_proj(params: Params, feats):
    """v1 projection 768 -> 256."""
    return linear(feats, params["final_proj"]["w"], params["final_proj"]["b"])


# ---------------------------------------------------------------------------
# fairseq HuBERT/ContentVec checkpoint import
# ---------------------------------------------------------------------------

def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).contiguous()


def _lin(sd, prefix) -> dict:
    return {"w": _f32(sd[f"{prefix}.weight"]), "b": _f32(sd[f"{prefix}.bias"])}


def _ln(sd, prefix) -> dict:
    return {"gamma": _f32(sd[f"{prefix}.weight"]), "beta": _f32(sd[f"{prefix}.bias"])}


def params_from_fairseq_state_dict(sd, n_layers: int | None = None) -> Params:
    """A fairseq state dict -> the port's tree.  n_layers: the transformer
    layers to load (default: every layer the state dict holds)."""
    if n_layers is None:
        n_layers = sum(1 for k in sd if k.startswith("encoder.layers.")
                       and k.endswith(".fc1.weight"))
    p: dict = {"frontend": {
        "convs": [{"w": _f32(sd[f"feature_extractor.conv_layers.{i}.0.weight"])}
                  for i in range(len(CONV_LAYERS))],
        "gn": _ln(sd, "feature_extractor.conv_layers.0.2")}}
    p["ln_feats"] = _ln(sd, "layer_norm")
    p["post_proj"] = _lin(sd, "post_extract_proj")
    # fairseq's weight_norm(dim=2): the norm runs over (Cout, Cin) for
    # each kernel position
    p["pos_conv"] = {"w": folded_weight(sd, "encoder.pos_conv.0", norm_dims=(0, 1)),
                     "b": _f32(sd["encoder.pos_conv.0.bias"])}
    p["ln_pre"] = _ln(sd, "encoder.layer_norm")
    p["layers"] = []
    for i in range(n_layers):
        lp = f"encoder.layers.{i}"
        p["layers"].append({
            "attn": {"q": _lin(sd, f"{lp}.self_attn.q_proj"),
                     "k": _lin(sd, f"{lp}.self_attn.k_proj"),
                     "v": _lin(sd, f"{lp}.self_attn.v_proj"),
                     "o": _lin(sd, f"{lp}.self_attn.out_proj")},
            "ln1": _ln(sd, f"{lp}.self_attn_layer_norm"),
            "fc1": _lin(sd, f"{lp}.fc1"),
            "fc2": _lin(sd, f"{lp}.fc2"),
            "ln2": _ln(sd, f"{lp}.final_layer_norm"),
        })
    if "final_proj.weight" in sd:
        p["final_proj"] = _lin(sd, "final_proj")
    return p


def load_hubert_pt(path: str) -> Params:
    """A fairseq HuBERT/ContentVec checkpoint file (its "model" entry, or
    a bare state dict) -> the port's tree."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    return params_from_fairseq_state_dict(state.get("model", state))


def params_from_transformers_state_dict(sd) -> Params:
    """A transformers HubertModel state dict (reference utils.py:155-166,
    embedders_mode "transformers" / "spin": HubertModel with a final_proj
    head) -> the port's tree.  The HF graph is fairseq's post-LN encoder
    under other key names: translate them, then load as fairseq."""
    import re

    out = {}
    for k, v in sd.items():
        if k == "masked_spec_embed":
            continue
        nk = k.replace("encoder.pos_conv_embed.conv", "encoder.pos_conv.0")
        nk = re.sub(r"feature_extractor\.conv_layers\.(\d+)\.conv\.",
                    r"feature_extractor.conv_layers.\1.0.", nk)
        nk = nk.replace("feature_extractor.conv_layers.0.layer_norm.",
                        "feature_extractor.conv_layers.0.2.")
        nk = nk.replace("feature_projection.layer_norm.", "layer_norm.")
        nk = nk.replace("feature_projection.projection.", "post_extract_proj.")
        nk = re.sub(r"encoder\.layers\.(\d+)\.attention\.", r"encoder.layers.\1.self_attn.", nk)
        nk = re.sub(r"encoder\.layers\.(\d+)\.layer_norm\.",
                    r"encoder.layers.\1.self_attn_layer_norm.", nk)
        nk = nk.replace(".feed_forward.intermediate_dense.", ".fc1.")
        nk = nk.replace(".feed_forward.output_dense.", ".fc2.")
        out[nk] = v
    return params_from_fairseq_state_dict(out)


def load_transformers_dir(path: str) -> Params:
    """A transformers HuBERT directory (model.safetensors or
    pytorch_model.bin inside) or one such weights file -> the port's tree.
    `safetensors` is imported only for a .safetensors file."""
    import os

    candidates = ([path] if os.path.isfile(path) else
                  [os.path.join(path, n) for n in ("model.safetensors", "pytorch_model.bin")])
    for c in candidates:
        if not os.path.isfile(c):
            continue
        if c.endswith(".safetensors"):
            from safetensors.torch import load_file

            sd = load_file(c)
        else:
            sd = torch.load(c, map_location="cpu", weights_only=False)
        return params_from_transformers_state_dict(
            {k.removeprefix("hubert."): v for k, v in sd.items()})
    raise FileNotFoundError(f"no weights file found under {path}")
