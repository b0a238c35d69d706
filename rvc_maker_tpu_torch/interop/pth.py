"""Load the reference interchange `.pth` voice model into the port.

Counterpart of `rvc_maker_tpu/interop/torch_import.py` for the
inference tree: {"weight": state_dict, "config": [18 hparams], "f0",
"version", "vocoder", ...} (reference train.py:724-744).  Weight-norm is
folded at load (w = g * v / ||v||, norm over every dim but 0) from
either spelling:
  * `{p}.parametrizations.weight.original0/original1`
  * `{p}.weight_g` / `{p}.weight_v`
Weights stay in torch layout; 1x1 convs become linear (Cout, Cin)
weights and the resblock convs are packed as `ops/resblock.py` takes
them.  Only the NSF-HiFiGAN decoder of f0 models is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from ..config import ModelConfig, model_config_from_ckpt_list

Params = Any


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(np.asarray(t.detach().cpu().numpy() if
                                      isinstance(t, torch.Tensor) else t,
                                      dtype=np.float32))


def folded_weight(sd: Mapping[str, Any], prefix: str,
                  norm_dims: tuple[int, ...] | None = None) -> torch.Tensor:
    """Effective weight in torch layout, folding weight-norm if present:
    w = g * v / ||v||, the norm over `norm_dims` (default: every dim
    but 0, torch's weight_norm(dim=0))."""
    if f"{prefix}.weight" in sd:
        return _f32(sd[f"{prefix}.weight"])
    if f"{prefix}.weight_g" in sd:
        g, v = sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"]
    elif f"{prefix}.parametrizations.weight.original0" in sd:
        g = sd[f"{prefix}.parametrizations.weight.original0"]
        v = sd[f"{prefix}.parametrizations.weight.original1"]
    else:
        raise KeyError(f"no weight found for {prefix!r}")
    g = _f32(g).double()
    v = _f32(v).double()
    if norm_dims is None:
        norm_dims = tuple(range(1, v.dim()))
    norm = v.square().sum(dim=norm_dims, keepdim=True).sqrt()
    return (g * (v / norm)).float()


def _bias(sd, prefix):
    key = f"{prefix}.bias"
    return _f32(sd[key]) if key in sd else None


def _conv(sd, prefix) -> dict:
    out = {"w": folded_weight(sd, prefix)}
    b = _bias(sd, prefix)
    if b is not None:
        out["b"] = b
    return out


def _conv1x1(sd, prefix) -> dict:
    out = _conv(sd, prefix)
    out["w"] = out["w"][:, :, 0].contiguous()
    return out


def _ln(sd, prefix) -> dict:
    return {"gamma": _f32(sd[f"{prefix}.gamma"]), "beta": _f32(sd[f"{prefix}.beta"])}


def _wavenet(sd, prefix, n_layers: int) -> dict:
    p = {"in_layers": [_conv(sd, f"{prefix}.in_layers.{i}") for i in range(n_layers)],
         "res_skip": [_conv1x1(sd, f"{prefix}.res_skip_layers.{i}")
                      for i in range(n_layers)]}
    if any(k.startswith(f"{prefix}.cond_layer.") for k in sd):
        p["cond"] = _conv1x1(sd, f"{prefix}.cond_layer")
    return p


def pack_resblock(convs1, convs2) -> dict:
    """Torch-layout (Cout, Cin, k) conv dicts of one resblock ->
    {"w1", "w2": (D, k, Cin, Cout), "b1", "b2": (D, C)}."""
    return {
        "w1": torch.stack([c["w"].permute(2, 1, 0) for c in convs1]).contiguous(),
        "b1": torch.stack([c["b"] for c in convs1]).contiguous(),
        "w2": torch.stack([c["w"].permute(2, 1, 0) for c in convs2]).contiguous(),
        "b2": torch.stack([c["b"] for c in convs2]).contiguous(),
    }


def synthesizer_params_from_state_dict(sd: Mapping[str, Any],
                                       cfg: ModelConfig) -> Params:
    """Map a reference Synthesizer state_dict onto the port's tree."""
    if not cfg.use_f0 or cfg.vocoder != "Default" \
            or "dec.m_source.l_linear.weight" not in sd:
        raise NotImplementedError(
            "only the NSF-HiFiGAN decoder of f0 models is ported")
    enc_layers = []
    for i in range(cfg.n_layers):
        ap = f"enc_p.encoder.attn_layers.{i}"
        enc_layers.append({
            "attn": {"q": _conv1x1(sd, f"{ap}.conv_q"),
                     "k": _conv1x1(sd, f"{ap}.conv_k"),
                     "v": _conv1x1(sd, f"{ap}.conv_v"),
                     "o": _conv1x1(sd, f"{ap}.conv_o"),
                     "emb_rel_k": _f32(sd[f"{ap}.emb_rel_k"]),
                     "emb_rel_v": _f32(sd[f"{ap}.emb_rel_v"])},
            "norm1": _ln(sd, f"enc_p.encoder.norm_layers_1.{i}"),
            "ffn": {"conv1": _conv(sd, f"enc_p.encoder.ffn_layers.{i}.conv_1"),
                    "conv2": _conv(sd, f"enc_p.encoder.ffn_layers.{i}.conv_2")},
            "norm2": _ln(sd, f"enc_p.encoder.norm_layers_2.{i}"),
        })
    enc_p = {"emb_phone": _conv(sd, "enc_p.emb_phone"),
             "encoder": {"layers": enc_layers},
             "proj": _conv1x1(sd, "enc_p.proj"),
             "emb_pitch": {"w": _f32(sd["enc_p.emb_pitch.weight"])}}
    flow_layers = [{"pre": _conv1x1(sd, f"flow.flows.{2 * i}.pre"),
                    "enc": _wavenet(sd, f"flow.flows.{2 * i}.enc", n_layers=3),
                    "post": _conv1x1(sd, f"flow.flows.{2 * i}.post")}
                   for i in range(4)]

    n_up = len(cfg.upsample_rates)
    nk = len(cfg.resblock_kernel_sizes)
    resblocks = []
    for j in range(n_up * nk):
        n_d = len(cfg.resblock_dilation_sizes[j % nk])
        base = f"dec.resblocks.{j}"
        resblocks.append(pack_resblock(
            [_conv(sd, f"{base}.convs1.{k}") for k in range(n_d)],
            [_conv(sd, f"{base}.convs2.{k}") for k in range(n_d)]))
    dec = {
        "conv_pre": _conv(sd, "dec.conv_pre"),
        "ups": [_conv(sd, f"dec.ups.{i}") for i in range(n_up)],
        "noise_convs": [_conv(sd, f"dec.noise_convs.{i}") for i in range(n_up)],
        "source": {"l_linear": _conv(sd, "dec.m_source.l_linear")},
        "resblocks": resblocks,
        "conv_post": _conv(sd, "dec.conv_post"),
    }
    if "dec.cond.weight" in sd:
        dec["cond"] = _conv1x1(sd, "dec.cond")
    return {"enc_p": enc_p, "flow": {"layers": flow_layers}, "dec": dec,
            "emb_g": {"w": _f32(sd["emb_g.weight"])}}


def load_synthesizer_pth(path: str):
    """Reference interchange .pth -> (params, ModelConfig, meta dict)."""
    cpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = cpt["weight"]
    version = cpt.get("version", "v1")
    cfg_list = list(cpt["config"])
    # the reference patches spk_embed_dim from the embedding table
    cfg_list[-3] = sd["emb_g.weight"].shape[0]
    cfg = model_config_from_ckpt_list(cfg_list, use_f0=bool(cpt.get("f0", 1)),
                                      version=version,
                                      vocoder=cpt.get("vocoder", "Default"))
    emb_dim = int(sd["enc_p.emb_phone.weight"].shape[1])
    if emb_dim != cfg.text_enc_hidden_dim:
        cfg = dataclasses.replace(cfg, text_enc_hidden_dim=emb_dim)
    params = synthesizer_params_from_state_dict(sd, cfg)
    meta = {k: v for k, v in cpt.items() if k != "weight"}
    return params, cfg, meta
