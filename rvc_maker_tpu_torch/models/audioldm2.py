"""AudioLDM2's audio stack in PyTorch: VAE, dual-stream UNet, SpeechT5
HiFi-GAN vocoder (counterpart of JAX `models/audioldm2.py`).

The diffusers / transformers models the reference drives
(main/library/audioldm2/models.py:169-320), as plain functions on dict
trees of tensors in torch's layouts: mel "images" and latents are
(B, C, T, F), conv weights OIHW, linear weights (out, in).  Each part
keeps JAX's numerics (GroupNorm eps 1e-6, the asymmetric (0, 1) pad of
each stride-2 downsample, nearest x2 upsampling, cos-before-sin
timestep features, the GEGLU split order `a, gate` with erf GELU).

Attention: the VAE's single-head mid attention and the UNet's
transformer attention run `F.scaled_dot_product_attention`; the JAX
package computes them in XLA, outside any Pallas kernel.  At a 10 s
input the UNet's first level has 4,016 positions (the VAE's mid block
as many), where an explicit softmax matrix would be large.

One UNet divergence from JAX: where a latent side is not a multiple of
2**(levels - 1), each upsample is a nearest resize to the size of the
skip it meets, as diffusers' UNet2DConditionModel resizes
(`upsample_size`); at every size JAX takes (an exact x2) the two are
equal, and at the others JAX's concatenation fails.

The vocoder's resblocks are the TPU kernel's function (leaky ReLU 0.1,
k = 3/7/11, dilations 1/3/5), so `vocoder_apply` runs them through
`ops/resblock.py` `fused_resblock` (`csrc/resblock_tc.cu` on the card in
fp32) wherever the kernel takes the shape, and through the plain
F.conv1d chain elsewhere (`_on_kernel`: a rule by width, kernel size,
dilation and slope, not a caught failure).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ..interop.pth import pack_resblock
from ..ops import resblock as rb_ops

Params = Any


# ---------------------------------------------------------------------------
# shared 2-D primitives (B, C, T, F)
# ---------------------------------------------------------------------------

def conv2d(x, p, *, stride: int = 1, padding: int = 1):
    """x: (B, Cin, H, W); p["w"]: (Cout, Cin, Kh, Kw)."""
    return F.conv2d(x, p["w"], p.get("b"), stride=stride, padding=padding)


def linear(x, p):
    return F.linear(x, p["w"], p.get("b"))


def group_norm(x, gamma, beta, *, groups: int = 32, eps: float = 1e-6):
    """torch.nn.GroupNorm over channel axis 1, JAX's eps."""
    return F.group_norm(x, groups, gamma, beta, eps)


def _gn(x, p, groups: int):
    return group_norm(x, p["gamma"], p["beta"], groups=groups)


def _layer_norm(x, p, eps: float = 1e-5):
    return F.layer_norm(x, (x.shape[-1],), p["gamma"], p["beta"], eps)


def _resnet(p: Params, x, temb=None, *, groups: int = 32):
    """GN -> SiLU -> conv3x3 [-> +time] -> GN -> SiLU -> conv3x3, with a
    1x1 shortcut when the width changes (diffusers ResnetBlock2D)."""
    h = conv2d(F.silu(_gn(x, p["gn1"], groups)), p["conv1"])
    if temb is not None and "time" in p:
        h = h + linear(F.silu(temb), p["time"])[:, :, None, None]
    h = conv2d(F.silu(_gn(h, p["gn2"], groups)), p["conv2"])
    if "shortcut" in p:
        x = conv2d(x, p["shortcut"], padding=0)
    return x + h


def _tokens(x):
    """(B, C, H, W) -> (B, H*W, C), positions in JAX's (H, W) order."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h * w).transpose(1, 2)


def _untokens(y, like):
    return y.transpose(1, 2).reshape(like.shape)


def _spatial_attn(p: Params, x, *, groups: int = 32):
    """Single-head self-attention over H*W positions (VAE mid block)."""
    y = _tokens(_gn(x, p["gn"], groups))
    q, k, v = (linear(y, p[n])[:, None] for n in ("q", "k", "v"))
    a = F.scaled_dot_product_attention(q, k, v)[:, 0]
    return x + _untokens(linear(a, p["o"]), x)


def _downsample(x, p):
    """diffusers Downsample2D: asymmetric (0, 1) pad, stride-2 conv."""
    return conv2d(F.pad(x, (0, 1, 0, 1)), p, stride=2, padding=0)


# ---------------------------------------------------------------------------
# VAE (AutoencoderKL role)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 1
    latent_channels: int = 8
    block_out_channels: tuple = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_groups: int = 32
    scaling_factor: float = 0.18215


def _vae_mid(m, h, g):
    return _resnet(m["res2"], _spatial_attn(m["attn"], _resnet(m["res1"], h, groups=g),
                                            groups=g), groups=g)


def vae_encode_mode(p: Params, cfg: VAEConfig, x):
    """mel (B, 1, T, F) -> latent mode * scaling_factor (B, Z, T/2^n,
    F/2^n) (reference vae_encode, models.py:183-186: .latent_dist.mode())."""
    g, e = cfg.norm_groups, p["enc"]
    h = conv2d(x, e["conv_in"])
    for blk in e["down"]:
        for r in blk["res"]:
            h = _resnet(r, h, groups=g)
        if "down" in blk:
            h = _downsample(h, blk["down"])
    h = _vae_mid(e["mid"], h, g)
    h = conv2d(F.silu(_gn(h, e["gn_out"], g)), e["conv_out"])
    h = conv2d(h, p["quant"], padding=0)
    return h[:, :h.shape[1] // 2] * cfg.scaling_factor


def vae_decode(p: Params, cfg: VAEConfig, z):
    """latent (B, Z, t, f) -> mel (B, 1, T, F); inverts scaling_factor
    first (reference vae_decode models.py:188-189).  The decoder has
    layers_per_block + 1 resnets per up block."""
    g, d = cfg.norm_groups, p["dec"]
    h = conv2d(z / cfg.scaling_factor, p["post_quant"], padding=0)
    h = _vae_mid(d["mid"], conv2d(h, d["conv_in"]), g)
    for blk in d["up"]:
        for r in blk["res"]:
            h = _resnet(r, h, groups=g)
        if "upconv" in blk:
            h = conv2d(F.interpolate(h, scale_factor=2.0, mode="nearest"), blk["upconv"])
    return conv2d(F.silu(_gn(h, d["gn_out"], g)), d["conv_out"])


def state_tensor(t) -> torch.Tensor:
    """A state dict's value (tensor or numpy array) as an fp32 tensor."""
    return torch.as_tensor(t).detach().float().contiguous()


def vae_params_from_state_dict(sd) -> Params:
    """diffusers AutoencoderKL state dict -> the port's tree (JAX
    `vae_params_from_state_dict`; torch's layouts kept).  The AudioLDM2
    VAE layout: encoder / decoder {conv_in, {down,up}_blocks.N.resnets.M,
    downsamplers / upsamplers.0.conv, mid_block.resnets.{0,1} +
    attentions.0, conv_norm_out, conv_out} plus quant_conv /
    post_quant_conv."""
    def pair(prefix, a="w", b="b"):
        return {a: state_tensor(sd[f"{prefix}.weight"]), b: state_tensor(sd[f"{prefix}.bias"])}

    def gn(prefix):
        return pair(prefix, "gamma", "beta")

    def resnet(prefix):
        p = {"gn1": gn(f"{prefix}.norm1"), "conv1": pair(f"{prefix}.conv1"),
             "gn2": gn(f"{prefix}.norm2"), "conv2": pair(f"{prefix}.conv2")}
        if f"{prefix}.conv_shortcut.weight" in sd:
            p["shortcut"] = pair(f"{prefix}.conv_shortcut")
        return p

    def attn(prefix):
        return {"gn": gn(f"{prefix}.group_norm"),
                "q": pair(f"{prefix}.to_q"), "k": pair(f"{prefix}.to_k"),
                "v": pair(f"{prefix}.to_v"), "o": pair(f"{prefix}.to_out.0")}

    def side(name):
        out = {"conv_in": pair(f"{name}.conv_in"), "gn_out": gn(f"{name}.conv_norm_out"),
               "conv_out": pair(f"{name}.conv_out"),
               "mid": {"res1": resnet(f"{name}.mid_block.resnets.0"),
                       "attn": attn(f"{name}.mid_block.attentions.0"),
                       "res2": resnet(f"{name}.mid_block.resnets.1")}}
        kind = "down_blocks" if name == "encoder" else "up_blocks"
        blocks, li = [], 0
        while f"{name}.{kind}.{li}.resnets.0.conv1.weight" in sd:
            blk, j = {"res": []}, 0
            while f"{name}.{kind}.{li}.resnets.{j}.conv1.weight" in sd:
                blk["res"].append(resnet(f"{name}.{kind}.{li}.resnets.{j}"))
                j += 1
            if f"{name}.{kind}.{li}.downsamplers.0.conv.weight" in sd:
                blk["down"] = pair(f"{name}.{kind}.{li}.downsamplers.0.conv")
            if f"{name}.{kind}.{li}.upsamplers.0.conv.weight" in sd:
                blk["upconv"] = pair(f"{name}.{kind}.{li}.upsamplers.0.conv")
            blocks.append(blk)
            li += 1
        out["down" if name == "encoder" else "up"] = blocks
        return out

    return {"enc": side("encoder"), "dec": side("decoder"),
            "quant": pair("quant_conv"), "post_quant": pair("post_quant_conv")}


# ---------------------------------------------------------------------------
# UNet with dual text conditioning
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 8
    block_out_channels: tuple = (128, 256, 384)
    layers_per_block: int = 2
    n_heads: int = 8
    cross_dim: int = 768       # GPT2 generated-embedding stream
    cross_dim_1: int = 1024    # T5/CLAP projected stream
    norm_groups: int = 32
    time_embed_mult: int = 4
    # Per-attention-slot cross dims, in diffusers order (JAX UNetConfig):
    # None self-attends twice, index <= 1 attends the GPT2 stream, index
    # > 1 the T5 stream.
    cross_dims: tuple | None = None
    # If set, per-slot head count = channels // head_dim; else n_heads.
    head_dim: int | None = None

    @property
    def slot_dims(self) -> tuple:
        if self.cross_dims is not None:
            return tuple(self.cross_dims)
        return (None, self.cross_dim, self.cross_dim_1)

    def heads_for(self, channels: int) -> int:
        return channels // self.head_dim if self.head_dim else self.n_heads


def timestep_embedding(t, dim: int):
    """diffusers Timesteps(flip_sin_to_cos=True, shift=0): (B,) -> (B, dim)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _attention(ap, q_in, kv_in, *, n_heads: int):
    """diffusers Attention: to_q / to_k / to_v without bias, to_out.0 with."""
    b, tq, c = q_in.shape
    d = c // n_heads

    def heads(y):
        return y.reshape(b, y.shape[1], n_heads, d).transpose(1, 2)

    o = F.scaled_dot_product_attention(heads(linear(q_in, ap["q"])), heads(linear(kv_in, ap["k"])),
                                       heads(linear(kv_in, ap["v"])))
    return linear(o.transpose(1, 2).reshape(b, tq, c), ap["o"])


def _tblock(p: Params, x, kv, *, n_heads: int):
    """diffusers BasicTransformerBlock: pre-LN self-attention, pre-LN
    second attention (on kv, or on itself when kv is None), pre-LN GEGLU
    feed-forward."""
    h = _layer_norm(x, p["ln1"])
    x = x + _attention(p["attn1"], h, h, n_heads=n_heads)
    h = _layer_norm(x, p["ln2"])
    x = x + _attention(p["attn2"], h, h if kv is None else kv, n_heads=n_heads)
    a, gate = linear(_layer_norm(x, p["ln3"]), p["ff1"]).chunk(2, dim=-1)
    return x + linear(a * F.gelu(gate), p["ff2"])


def _transformer2d(p: Params, x, kv, *, n_heads: int, groups: int):
    """One diffusers Transformer2DModel (norm, proj_in, blocks, proj_out,
    + residual), attending kv (or itself when kv is None)."""
    y = linear(_tokens(_gn(x, p["gn"], groups)), p["proj_in"])
    for blk in p["blocks"]:
        y = _tblock(blk, y, kv, n_heads=n_heads)
    return x + _untokens(linear(y, p["proj_out"]), x)


def _attn_slots(slots, cfg: UNetConfig, x, eh0, eh1, *, groups: int):
    """One res layer's attention slots in diffusers order: a slot whose
    cross dim is None self-attends; index <= 1 attends eh0 (the GPT2
    stream); index > 1 attends eh1 (the T5 stream)."""
    if len(slots) != len(cfg.slot_dims):
        raise ValueError(
            f"{len(slots)} attention slots but cfg.slot_dims has "
            f"{len(cfg.slot_dims)} entries — slot routing would silently "
            "drop transformers; rebuild cfg from the checkpoint "
            "(unet_params_from_state_dict returns the matching config)")
    heads = cfg.heads_for(x.shape[1])
    for idx, (slot, dim) in enumerate(zip(slots, cfg.slot_dims)):
        kv = None if dim is None else (eh0 if idx <= 1 else eh1)
        x = _transformer2d(slot, x, kv, n_heads=heads, groups=groups)
    return x


def unet_forward(p: Params, cfg: UNetConfig, sample, timestep, eh0, eh1):
    """sample: (B, Z, t, f); timestep: (B,) int; eh0: (B, S0, cross_dim)
    the GPT2 stream; eh1: (B, S1, cross_dim_1) the T5 stream."""
    g = cfg.norm_groups
    temb = timestep_embedding(timestep, cfg.block_out_channels[0])
    temb = linear(F.silu(linear(temb, p["time_mlp1"])), p["time_mlp2"])

    h = conv2d(sample, p["conv_in"])
    skips = [h]
    for blk in p["down"]:
        for j, r in enumerate(blk["res"]):
            h = _resnet(r, h, temb, groups=g)
            # a block without attention (diffusers DownBlock2D) has no "attn"
            if "attn" in blk:
                h = _attn_slots(blk["attn"][j], cfg, h, eh0, eh1, groups=g)
            skips.append(h)
        if "down" in blk:
            h = _downsample(h, blk["down"])
            skips.append(h)
    m = p["mid"]
    h = _resnet(m["res1"], h, temb, groups=g)
    if m.get("attn"):
        h = _attn_slots(m["attn"], cfg, h, eh0, eh1, groups=g)
    h = _resnet(m["res2"], h, temb, groups=g)

    for blk in p["up"]:
        for j, r in enumerate(blk["res"]):
            h = _resnet(r, torch.cat([h, skips.pop()], dim=1), temb, groups=g)
            if "attn" in blk:
                h = _attn_slots(blk["attn"][j], cfg, h, eh0, eh1, groups=g)
        if "upconv" in blk:
            # nearest to the next skip's size: x2 wherever JAX's repeat fits
            h = conv2d(F.interpolate(h, size=skips[-1].shape[2:], mode="nearest"),
                       blk["upconv"])
    return conv2d(F.silu(_gn(h, p["gn_out"], g)), p["conv_out"])


def unet_params_from_state_dict(sd, *, head_dim: int | None = 8, norm_groups: int = 32,
                                time_embed_mult: int = 4):
    """diffusers AudioLDM2UNet2DConditionModel state dict -> (params, cfg)
    (JAX `unet_params_from_state_dict`, torch's layouts kept).

    The structure follows the weights: block widths from the resnet
    convs, layers_per_block from the resnet count, the slot count and
    each slot's cross dim from the attentions (a slot whose attn2.to_k
    input width equals the inner width is the double-self-attention None
    slot).  Every key must be consumed: leftovers and absences raise, as
    in JAX.  Transformer2DModel's proj_in / proj_out may be 1x1 convs or
    linears; both become a token linear."""
    consumed: set = set()

    def take(key):
        if key not in sd:
            raise KeyError(f"UNet checkpoint missing key {key!r}")
        consumed.add(key)
        return state_tensor(sd[key])

    def pair(prefix, a="w", b="b"):
        return {a: take(f"{prefix}.weight"), b: take(f"{prefix}.bias")}

    def norm(prefix):
        return pair(prefix, "gamma", "beta")

    def proj(prefix):
        w = take(f"{prefix}.weight")
        return {"w": w[:, :, 0, 0].contiguous() if w.dim() == 4 else w,
                "b": take(f"{prefix}.bias")}

    def attn(prefix):
        return {"q": {"w": take(f"{prefix}.to_q.weight")},
                "k": {"w": take(f"{prefix}.to_k.weight")},
                "v": {"w": take(f"{prefix}.to_v.weight")},
                "o": pair(f"{prefix}.to_out.0")}

    def tblock(prefix):
        return {"ln1": norm(f"{prefix}.norm1"), "attn1": attn(f"{prefix}.attn1"),
                "ln2": norm(f"{prefix}.norm2"), "attn2": attn(f"{prefix}.attn2"),
                "ln3": norm(f"{prefix}.norm3"), "ff1": pair(f"{prefix}.ff.net.0.proj"),
                "ff2": pair(f"{prefix}.ff.net.2")}

    def transformer2d(prefix):
        blocks, li = [], 0
        while f"{prefix}.transformer_blocks.{li}.norm1.weight" in sd:
            blocks.append(tblock(f"{prefix}.transformer_blocks.{li}"))
            li += 1
        return {"gn": norm(f"{prefix}.norm"), "proj_in": proj(f"{prefix}.proj_in"),
                "blocks": blocks, "proj_out": proj(f"{prefix}.proj_out")}

    def resnet(prefix):
        p = {"gn1": norm(f"{prefix}.norm1"), "conv1": pair(f"{prefix}.conv1"),
             "gn2": norm(f"{prefix}.norm2"), "conv2": pair(f"{prefix}.conv2")}
        if f"{prefix}.time_emb_proj.weight" in sd:
            p["time"] = pair(f"{prefix}.time_emb_proj")
        if f"{prefix}.conv_shortcut.weight" in sd:
            p["shortcut"] = pair(f"{prefix}.conv_shortcut")
        return p

    def slots_of(prefix):
        out, k = [], 0
        while f"{prefix}.attentions.{k}.norm.weight" in sd:
            out.append(transformer2d(f"{prefix}.attentions.{k}"))
            k += 1
        return out

    def block(prefix, down: bool):
        blk, j = {"res": []}, 0
        while f"{prefix}.resnets.{j}.norm1.weight" in sd:
            blk["res"].append(resnet(f"{prefix}.resnets.{j}"))
            j += 1
        n_res, flat = j, slots_of(prefix)
        if flat:
            if len(flat) % n_res:
                raise ValueError(f"{prefix}: {len(flat)} attentions not divisible by "
                                 f"{n_res} resnets")
            per = len(flat) // n_res
            blk["attn"] = [flat[i * per:(i + 1) * per] for i in range(n_res)]
        if down and f"{prefix}.downsamplers.0.conv.weight" in sd:
            blk["down"] = pair(f"{prefix}.downsamplers.0.conv")
        if not down and f"{prefix}.upsamplers.0.conv.weight" in sd:
            blk["upconv"] = pair(f"{prefix}.upsamplers.0.conv")
        return blk

    p = {"time_mlp1": pair("time_embedding.linear_1"),
         "time_mlp2": pair("time_embedding.linear_2"),
         "conv_in": pair("conv_in"), "gn_out": norm("conv_norm_out"),
         "conv_out": pair("conv_out"), "down": [], "up": []}
    i = 0
    while f"down_blocks.{i}.resnets.0.norm1.weight" in sd:
        p["down"].append(block(f"down_blocks.{i}", down=True))
        i += 1
    p["mid"] = {"res1": resnet("mid_block.resnets.0"), "res2": resnet("mid_block.resnets.1"),
                "attn": slots_of("mid_block")}
    i = 0
    while f"up_blocks.{i}.resnets.0.norm1.weight" in sd:
        p["up"].append(block(f"up_blocks.{i}", down=False))
        i += 1

    leftover = sorted(set(sd) - consumed)
    if leftover:
        raise ValueError(f"{len(leftover)} unconsumed UNet checkpoint keys (layout "
                         f"drift?): {leftover[:8]}...")

    # the config, inferred from the imported weights
    widths = tuple(int(blk["res"][0]["conv1"]["w"].shape[0]) for blk in p["down"])
    attn_layers = [layer for blk in p["down"] + p["up"] for layer in blk.get("attn", [])]
    if p["mid"]["attn"]:
        attn_layers.append(p["mid"]["attn"])
    if not attn_layers:
        raise ValueError("UNet checkpoint has no attention blocks")
    per = len(attn_layers[0])
    bad = [len(s) for s in attn_layers if len(s) != per]
    if bad:
        raise ValueError(
            f"inconsistent attention-slot counts across blocks: {per} vs "
            f"{sorted(set(bad))} — the forward's slot routing assumes one "
            "uniform cross_attention_dim list (diffusers config-level)")

    def kv_widths(layer):
        inner = layer[0]["proj_in"]["w"].shape[1]
        return [None if (kd := int(s["blocks"][0]["attn2"]["k"]["w"].shape[1])) == inner
                else kd for s in layer]

    cross_dims = kv_widths(attn_layers[0])
    # every other attention layer must route the same kv widths slot for slot
    for li, layer in enumerate(attn_layers[1:], start=1):
        for si, (got, want) in enumerate(zip(kv_widths(layer), cross_dims)):
            if got != want:
                raise ValueError(
                    f"attention layer {li} slot {si} kv width {got} != "
                    f"{want} inferred from the first layer — non-uniform "
                    "cross_attention_dim is not supported by the slot "
                    "routing")
    cfg = UNetConfig(in_channels=int(p["conv_in"]["w"].shape[1]), block_out_channels=widths,
                     layers_per_block=len(p["down"][0]["res"]), norm_groups=norm_groups,
                     time_embed_mult=time_embed_mult, cross_dims=tuple(cross_dims),
                     head_dim=head_dim)
    return p, cfg


# ---------------------------------------------------------------------------
# SpeechT5 HiFi-GAN vocoder (transformers layout)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class VocoderConfig:
    model_in_dim: int = 64
    upsample_initial_channel: int = 512
    upsample_rates: tuple = (5, 4, 2, 2, 2)
    upsample_kernel_sizes: tuple = (16, 16, 8, 4, 4)
    resblock_kernel_sizes: tuple = (3, 7, 11)
    resblock_dilation_sizes: tuple = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    normalize_before: bool = True
    leaky_slope: float = 0.1


def _on_kernel(channels: int, kernel_size: int, dilations, slope: float) -> bool:
    """Whether a resblock runs `fused_resblock` (the hand kernel on the
    card): a width in `SUPPORTED_C`, a kernel size in `SUPPORTED_K`,
    dilations up to `MAX_DILATION` and the kernel's slope 0.1.  The
    published vocoder's first stage (C = 512) is wider than any width
    the kernel takes, so it runs the plain F.conv1d chain
    (`ops/resblock.py` `_resblock`); so does any other slope."""
    return (channels in rb_ops.SUPPORTED_C and kernel_size in rb_ops.SUPPORTED_K
            and all(1 <= d <= rb_ops.MAX_DILATION for d in dilations)
            and slope == rb_ops.LRELU_SLOPE)


def vocoder_apply(p: Params, cfg: VocoderConfig, spectrogram):
    """(B, T, model_in_dim) log-mel -> (B, T * prod(rates)) waveform
    (transformers SpeechT5HifiGan.forward, as JAX computes it).  Each
    stage averages its resblocks: `fused_resblock` where `_on_kernel`
    holds, the plain chain `_resblock` at the config's slope elsewhere."""
    x = spectrogram
    if cfg.normalize_before:
        x = (x - p["mean"]) / p["scale"]
    x = F.conv1d(x.transpose(1, 2), p["conv_pre"]["w"], p["conv_pre"]["b"], padding=3)
    slope, n_k = cfg.leaky_slope, len(cfg.resblock_kernel_sizes)
    for i, rate in enumerate(cfg.upsample_rates):
        k = cfg.upsample_kernel_sizes[i]
        x = F.conv_transpose1d(F.leaky_relu(x, slope), p["ups"][i]["w"], p["ups"][i]["b"],
                               stride=rate, padding=(k - rate) // 2).contiguous()
        acc = None
        for j, (kk, dils) in enumerate(zip(cfg.resblock_kernel_sizes,
                                           cfg.resblock_dilation_sizes)):
            rb, dils = p["resblocks"][i * n_k + j], tuple(dils)
            args = (x, rb["w1"], rb["b1"], rb["w2"], rb["b2"])
            if _on_kernel(x.shape[1], kk, dils, slope):
                y = rb_ops.fused_resblock(*args, kernel_size=kk, dilations=dils)
            else:
                y = rb_ops._resblock(*args, kernel_size=kk, dilations=dils, slope=slope)
            acc = y if acc is None else acc + y
        x = acc / n_k
    x = F.conv1d(F.leaky_relu(x, slope), p["conv_post"]["w"], p["conv_post"]["b"], padding=3)
    return torch.tanh(x)[:, 0]


def vocoder_params_from_state_dict(sd) -> Params:
    """transformers SpeechT5HifiGan state dict (weight-normed convs, as
    weight_g / weight_v or parametrizations.weight.original0 / 1; the
    weight is materialised in float64, as JAX does) -> the port's tree:
    convs (Cout, Cin, K), transposed convs (Cin, Cout, K), each stage's
    resblocks packed for `fused_resblock`."""
    def weight(prefix):
        if f"{prefix}.weight" in sd:
            return state_tensor(sd[f"{prefix}.weight"])
        par = f"{prefix}.parametrizations.weight.original"
        g = torch.as_tensor(sd[par + "0"] if par + "0" in sd else sd[f"{prefix}.weight_g"])
        v = torch.as_tensor(sd[par + "1"] if par + "1" in sd else sd[f"{prefix}.weight_v"])
        g, v = g.double(), v.double()
        norm = torch.sqrt(torch.sum(v ** 2, dim=tuple(range(1, v.dim())), keepdim=True))
        return (g * v / norm).float().contiguous()

    def conv(prefix):
        out = {"w": weight(prefix)}
        if f"{prefix}.bias" in sd:
            out["b"] = state_tensor(sd[f"{prefix}.bias"])
        return out

    def n_children(prefix):
        n = 0
        while any(k.startswith(f"{prefix}.{n}.") for k in sd):
            n += 1
        return n

    p = {"mean": state_tensor(sd["mean"]), "scale": state_tensor(sd["scale"]),
         "conv_pre": conv("conv_pre"), "conv_post": conv("conv_post"),
         "ups": [conv(f"upsampler.{i}") for i in range(n_children("upsampler"))],
         "resblocks": []}
    for i in range(n_children("resblocks")):
        n = n_children(f"resblocks.{i}.convs1")
        p["resblocks"].append(pack_resblock(
            [conv(f"resblocks.{i}.convs1.{j}") for j in range(n)],
            [conv(f"resblocks.{i}.convs2.{j}") for j in range(n)]))
    return p
