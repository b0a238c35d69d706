"""The reference interchange `.pth` files: voice models and pretrained G/D.

Counterpart of `rvc_maker_tpu/interop/torch_import.py` and
`torch_export.py`.  The inference file is {"weight": state_dict,
"config": [18 hparams], "f0", "version", "vocoder", ...} (reference
train.py:724-744).  Weight-norm is folded at load (w = g * v / ||v||,
norm over every dim but 0) from either spelling:
  * `{p}.parametrizations.weight.original0/original1`
  * `{p}.weight_g` / `{p}.weight_v`
Weights stay in torch layout; 1x1 convs become linear (Cout, Cin)
weights and the resblock convs are packed as `ops/resblock.py` takes
them.  Training checkpoints (pretrained G / D, {"model": state_dict})
load with `load_pretrained_g` (folded, with the posterior encoder) and
`load_pretrained_d` (live (g, v, b) pairs).  `export_synthesizer_pth`
writes the inference file back.  Every decoder the reference writes
loads and exports: NSF-HiFiGAN (`dec.resblocks`), the plain Generator of
f0-less models (`dec.ups_and_resblocks`, no `enc_p.emb_pitch`),
MRF-HiFi-GAN (`dec.upsamples`, `dec.mrfs`) and RefineGAN
(`dec.upsample_conv_blocks`), chosen by `synthesizer.decoder_kind` from
the file's "f0" and "vocoder".  The resblocks of the first three are
packed for the kernel; RefineGAN's keep torch layout.
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch

from ..config import (ModelConfig, RVCConfig, model_config_from_ckpt_list,
                      model_config_to_ckpt_list)
from ..models.discriminator import periods_for
from ..models.synthesizer import decoder_kind

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


def _packed(sd, cfg: ModelConfig, name) -> list:
    """Every resblock of a HiFi-GAN decoder, stage by stage, packed;
    name(j, c, k) is the key prefix of conv c (1, 2) at dilation k of
    the j-th resblock."""
    nk = len(cfg.resblock_kernel_sizes)
    return [pack_resblock(
        [_conv(sd, name(j, 1, k)) for k in range(len(cfg.resblock_dilation_sizes[j % nk]))],
        [_conv(sd, name(j, 2, k)) for k in range(len(cfg.resblock_dilation_sizes[j % nk]))])
        for j in range(len(cfg.upsample_rates) * nk)]


def _decoder_from_state_dict(sd, cfg: ModelConfig) -> Params:
    """The decoder `decoder_kind(cfg)` names, from the reference's module
    names (JAX interop/torch_import.py:177-227, vocoders.py:204-267)."""
    kind = decoder_kind(cfg)
    n_up = len(cfg.upsample_rates)
    nk = len(cfg.resblock_kernel_sizes)
    if kind == "refinegan":
        return _refinegan_from_state_dict(sd, n_up)
    if kind == "plain":
        # ups and resblocks interleave in one ModuleList (reference
        # synthesizers.py:27-33): stage i at i*(1+nk), its resblock j
        # at i*(1+nk)+1+j
        dec = {"conv_pre": _conv(sd, "dec.conv_pre"),
               "ups": [_conv(sd, f"dec.ups_and_resblocks.{i * (1 + nk)}")
                       for i in range(n_up)],
               "resblocks": _packed(sd, cfg, lambda j, c, k: (
                   f"dec.ups_and_resblocks.{j // nk * (1 + nk) + 1 + j % nk}.convs{c}.{k}"))}
    else:
        mrf = kind == "mrf"
        dec = {"conv_pre": _conv(sd, "dec.conv_pre"),
               "ups": [_conv(sd, f"dec.{'upsamples' if mrf else 'ups'}.{i}")
                       for i in range(n_up)],
               "noise_convs": [_conv(sd, f"dec.noise_convs.{i}") for i in range(n_up)],
               "source": {"l_linear": _conv(sd, "dec.m_source.l_linear")},
               "resblocks": _packed(sd, cfg, (
                   lambda j, c, k: f"dec.mrfs.{j // nk}.{j % nk}.layers.{k}.conv{c}")
                   if mrf else (lambda j, c, k: f"dec.resblocks.{j}.convs{c}.{k}"))}
    dec["conv_post"] = _conv(sd, "dec.conv_post")
    if "dec.cond.weight" in sd:
        dec["cond"] = _conv1x1(sd, "dec.cond")
    return dec


def _refinegan_from_state_dict(sd, n_up: int) -> Params:
    dec = {"source": {"merge": {"w": folded_weight(sd, "dec.m_source.merge.0")}},
           "pre_conv": _conv(sd, "dec.pre_conv"), "mel_conv": _conv(sd, "dec.mel_conv"),
           "downsample_blocks": [_conv(sd, f"dec.downsample_blocks.{i}")
                                 for i in range(n_up)],
           "upsample_conv_blocks": [], "conv_post": _conv(sd, "dec.conv_post")}
    for i in range(n_up):
        bp = f"dec.upsample_conv_blocks.{i}"
        dec["upsample_conv_blocks"].append({
            "input_conv": _conv(sd, f"{bp}.input_conv"),
            "blocks": [{"adain1": {"weight": _f32(sd[f"{bp}.blocks.{j}.0.weight"])},
                        "res": {f"convs{c}": [_conv(sd, f"{bp}.blocks.{j}.1.convs{c}.{k}")
                                              for k in range(3)] for c in (1, 2)},
                        "adain2": {"weight": _f32(sd[f"{bp}.blocks.{j}.2.weight"])}}
                       for j in range(3)]})
    if "dec.cond.weight" in sd:
        dec["cond"] = _conv1x1(sd, "dec.cond")
    return dec


def synthesizer_params_from_state_dict(sd: Mapping[str, Any],
                                       cfg: ModelConfig) -> Params:
    """Map a reference Synthesizer state_dict onto the port's tree."""
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
             "proj": _conv1x1(sd, "enc_p.proj")}
    if "enc_p.emb_pitch.weight" in sd:            # f0 models only
        enc_p["emb_pitch"] = {"w": _f32(sd["enc_p.emb_pitch.weight"])}
    flow_layers = [{"pre": _conv1x1(sd, f"flow.flows.{2 * i}.pre"),
                    "enc": _wavenet(sd, f"flow.flows.{2 * i}.enc", n_layers=3),
                    "post": _conv1x1(sd, f"flow.flows.{2 * i}.post")}
                   for i in range(4)]
    params = {"enc_p": enc_p, "flow": {"layers": flow_layers},
              "dec": _decoder_from_state_dict(sd, cfg),
              "emb_g": {"w": _f32(sd["emb_g.weight"])}}
    if "enc_q.pre.weight" in sd:        # training checkpoints only
        params["enc_q"] = {"pre": _conv1x1(sd, "enc_q.pre"),
                           "enc": _wavenet(sd, "enc_q.enc", n_layers=16),
                           "proj": _conv1x1(sd, "enc_q.proj")}
    return params


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


# ---------------------------------------------------------------------------
# training checkpoints: pretrained G / D (reference train.py:778-794)
# ---------------------------------------------------------------------------

def _state_dict_of(path: str):
    cpt = torch.load(path, map_location="cpu", weights_only=False)
    return cpt["model"] if "model" in cpt else cpt["weight"]


def load_pretrained_g(path: str, cfg: ModelConfig) -> Params:
    """A training checkpoint or pretrained G (with enc_q) -> the port's
    training tree, weight norm folded."""
    return synthesizer_params_from_state_dict(_state_dict_of(path), cfg)


def _wn_pair(sd, prefix) -> dict:
    """Live (g, v, b) of a weight-normed conv, in torch layout."""
    if f"{prefix}.weight_g" in sd:
        g, v = sd[f"{prefix}.weight_g"], sd[f"{prefix}.weight_v"]
    else:
        g = sd[f"{prefix}.parametrizations.weight.original0"]
        v = sd[f"{prefix}.parametrizations.weight.original1"]
    return {"g": _f32(g), "v": _f32(v), "b": _f32(sd[f"{prefix}.bias"])}


def discriminator_params_from_state_dict(sd, version: str = "v2") -> Params:
    """A reference MultiPeriodDiscriminator state dict -> the port's tree."""
    return {"s": {"convs": [_wn_pair(sd, f"discriminators.0.convs.{j}")
                            for j in range(6)],
                  "post": _wn_pair(sd, "discriminators.0.conv_post")},
            "p": [{"convs": [_wn_pair(sd, f"discriminators.{i}.convs.{j}")
                             for j in range(5)],
                   "post": _wn_pair(sd, f"discriminators.{i}.conv_post")}
                  for i in range(1, len(periods_for(version)) + 1)]}


def load_pretrained_d(path: str, version: str = "v2") -> Params:
    return discriminator_params_from_state_dict(_state_dict_of(path), version)


# ---------------------------------------------------------------------------
# export (counterpart of rvc_maker_tpu/interop/torch_export.py)
# ---------------------------------------------------------------------------

def _cpu(v) -> torch.Tensor:
    return v.detach().float().cpu()


def _emit(sd, prefix, w, b=None, weight_normed: bool = False):
    """Write one module's tensors.  A weight-normed module gets g = the
    per-output-channel norm of w and v = w, which give back w exactly."""
    w = _cpu(w)
    if weight_normed:
        sd[f"{prefix}.parametrizations.weight.original0"] = torch.sqrt(
            torch.sum(torch.square(w), dim=tuple(range(1, w.dim())), keepdim=True))
        sd[f"{prefix}.parametrizations.weight.original1"] = w
    else:
        sd[f"{prefix}.weight"] = w
    if b is not None:
        sd[f"{prefix}.bias"] = _cpu(b)


def _emit_ln(sd, prefix, p):
    sd[f"{prefix}.gamma"] = _cpu(p["gamma"])
    sd[f"{prefix}.beta"] = _cpu(p["beta"])


def _emit_1x1(sd, prefix, p, weight_normed: bool = False):
    _emit(sd, prefix, p["w"][:, :, None], p.get("b"), weight_normed)


def _emit_wavenet(sd, prefix, p):
    for i, lp in enumerate(p["in_layers"]):
        _emit(sd, f"{prefix}.in_layers.{i}", lp["w"], lp["b"], True)
    for i, lp in enumerate(p["res_skip"]):
        _emit_1x1(sd, f"{prefix}.res_skip_layers.{i}", lp, True)
    if "cond" in p:
        _emit_1x1(sd, f"{prefix}.cond_layer", p["cond"], True)


def _emit_packed(sd, resblocks, name, weight_normed: bool = True):
    """Unpack each resblock's (D, k, Cin, Cout) convs; name(j, c, k) is
    the key prefix of conv c (1, 2) at dilation k of resblock j."""
    for j, rb in enumerate(resblocks):
        for c in (1, 2):
            w, b = rb[f"w{c}"], rb[f"b{c}"]
            for k in range(w.shape[0]):
                _emit(sd, name(j, c, k), w[k].permute(2, 1, 0), b[k], weight_normed)


def _emit_decoder(sd, dec, cfg: ModelConfig):
    """The port's decoder -> the reference's module names (JAX
    torch_export.py: the NSF and `ups_and_resblocks` branches :116-147,
    `_export_mrf_dec` :152, `_export_refinegan_dec` :172)."""
    kind = decoder_kind(cfg)
    nk = len(cfg.resblock_kernel_sizes)
    if kind == "refinegan":
        sd["dec.m_source.merge.0.weight"] = _cpu(dec["source"]["merge"]["w"])
        for name in ("pre_conv", "mel_conv"):
            _emit(sd, f"dec.{name}", dec[name]["w"], dec[name]["b"], True)
        for i, lp in enumerate(dec["downsample_blocks"]):
            _emit(sd, f"dec.downsample_blocks.{i}", lp["w"], lp["b"], True)
        for i, blk in enumerate(dec["upsample_conv_blocks"]):
            bp = f"dec.upsample_conv_blocks.{i}"
            _emit(sd, f"{bp}.input_conv", blk["input_conv"]["w"], blk["input_conv"]["b"])
            for j, b2 in enumerate(blk["blocks"]):
                sd[f"{bp}.blocks.{j}.0.weight"] = _cpu(b2["adain1"]["weight"])
                sd[f"{bp}.blocks.{j}.2.weight"] = _cpu(b2["adain2"]["weight"])
                for c in (1, 2):
                    for k, conv in enumerate(b2["res"][f"convs{c}"]):
                        _emit(sd, f"{bp}.blocks.{j}.1.convs{c}.{k}", conv["w"], conv["b"],
                              True)
        _emit(sd, "dec.conv_post", dec["conv_post"]["w"], None, True)
    elif kind == "mrf":
        _emit(sd, "dec.m_source.l_linear", dec["source"]["l_linear"]["w"],
              dec["source"]["l_linear"]["b"])
        _emit(sd, "dec.conv_pre", dec["conv_pre"]["w"], dec["conv_pre"]["b"], True)
        for i, lp in enumerate(dec["ups"]):
            _emit(sd, f"dec.upsamples.{i}", lp["w"], lp["b"], True)
        for i, lp in enumerate(dec["noise_convs"]):
            _emit(sd, f"dec.noise_convs.{i}", lp["w"], lp["b"])
        _emit_packed(sd, dec["resblocks"],
                     lambda j, c, k: f"dec.mrfs.{j // nk}.{j % nk}.layers.{k}.conv{c}")
        _emit(sd, "dec.conv_post", dec["conv_post"]["w"], dec["conv_post"]["b"], True)
    else:
        _emit(sd, "dec.conv_pre", dec["conv_pre"]["w"], dec["conv_pre"]["b"])
        if kind == "plain":
            for i, lp in enumerate(dec["ups"]):
                _emit(sd, f"dec.ups_and_resblocks.{i * (1 + nk)}", lp["w"], lp["b"], True)
            _emit_packed(sd, dec["resblocks"], lambda j, c, k: (
                f"dec.ups_and_resblocks.{j // nk * (1 + nk) + 1 + j % nk}.convs{c}.{k}"))
        else:
            for i, lp in enumerate(dec["ups"]):
                _emit(sd, f"dec.ups.{i}", lp["w"], lp["b"], True)
            for i, lp in enumerate(dec["noise_convs"]):
                _emit(sd, f"dec.noise_convs.{i}", lp["w"], lp["b"])
            _emit_packed(sd, dec["resblocks"], lambda j, c, k: f"dec.resblocks.{j}.convs{c}.{k}")
            _emit(sd, "dec.m_source.l_linear", dec["source"]["l_linear"]["w"],
                  dec["source"]["l_linear"]["b"])
        _emit(sd, "dec.conv_post", dec["conv_post"]["w"])
    if "cond" in dec:
        _emit_1x1(sd, "dec.cond", dec["cond"])


def synthesizer_state_dict(params: Params,
                           cfg: ModelConfig) -> "OrderedDict[str, torch.Tensor]":
    """The port's tree -> a reference Synthesizer state dict (fp32, CPU),
    without the posterior encoder."""
    sd: OrderedDict = OrderedDict()
    enc_p = params["enc_p"]
    _emit(sd, "enc_p.emb_phone", enc_p["emb_phone"]["w"], enc_p["emb_phone"]["b"])
    if "emb_pitch" in enc_p:
        sd["enc_p.emb_pitch.weight"] = _cpu(enc_p["emb_pitch"]["w"])
    for i, lp in enumerate(enc_p["encoder"]["layers"]):
        ap = f"enc_p.encoder.attn_layers.{i}"
        for k in ("q", "k", "v", "o"):
            _emit_1x1(sd, f"{ap}.conv_{k}", lp["attn"][k])
        for k in ("emb_rel_k", "emb_rel_v"):
            sd[f"{ap}.{k}"] = _cpu(lp["attn"][k])
        _emit_ln(sd, f"enc_p.encoder.norm_layers_1.{i}", lp["norm1"])
        for j in (1, 2):
            conv = lp["ffn"][f"conv{j}"]
            _emit(sd, f"enc_p.encoder.ffn_layers.{i}.conv_{j}", conv["w"], conv["b"])
        _emit_ln(sd, f"enc_p.encoder.norm_layers_2.{i}", lp["norm2"])
    _emit_1x1(sd, "enc_p.proj", enc_p["proj"])
    for i, lp in enumerate(params["flow"]["layers"]):
        fp = f"flow.flows.{2 * i}"
        _emit_1x1(sd, f"{fp}.pre", lp["pre"])
        _emit_wavenet(sd, f"{fp}.enc", lp["enc"])
        _emit_1x1(sd, f"{fp}.post", lp["post"])
    _emit_decoder(sd, params["dec"], cfg)
    sd["emb_g.weight"] = _cpu(params["emb_g"]["w"])
    return sd


def export_synthesizer_pth(params: Params, cfg: RVCConfig, path: str, *,
                           epoch: int = 0, step: int = 0, author: str = "") -> None:
    """Write the interchange .pth: fp16 tensors, enc_q stripped, the
    config list and metadata (reference train.py:724-744)."""
    sd = synthesizer_state_dict(params, cfg.model)
    hasher = hashlib.sha256()
    for k in sorted(sd):
        hasher.update(k.encode())
        hasher.update(sd[k].contiguous().numpy().tobytes())
    torch.save({
        "weight": OrderedDict((k, v.contiguous().half()) for k, v in sd.items()),
        "config": model_config_to_ckpt_list(cfg.model),
        "sr": cfg.model.sr,
        "f0": int(cfg.model.use_f0),
        "version": cfg.version,
        "vocoder": cfg.model.vocoder,
        "epoch": epoch,
        "step": step,
        "author": author,
        "creation_date": datetime.datetime.now().isoformat(),
        "model_hash": hasher.hexdigest(),
    }, path)
