"""AudioLDM2's text conditioning in PyTorch (counterpart of JAX
`models/audioldm2_text.py`).

The three text encoders the reference drives through transformers /
diffusers (main/library/audioldm2/models.py:196-222 encode_text), as
plain functions on dict trees of tensors (linear weights (out, in)):

  * the CLAP text branch: RoBERTa (position ids cumsum(mask) * mask +
    pad_token_id), the tanh pooler on token 0, the ReLU projection ->
    one vector per prompt;
  * the Flan-T5 encoder: RMS norms, no 1/sqrt(d) scaling, bidirectional
    relative-position buckets, gated `gelu_new` feed-forward;
  * the AudioLDM2 projection (two linears, learned SOS / EOS tokens,
    streams concatenated);
  * GPT2 run on embeddings: `generate_language_model` appends the last
    hidden state per step, a full pass per new token with no cache, as
    JAX does.

Sequences here are a prompt's tokens, so the attention is an explicit
softmax with JAX's additive -1e9 masks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from .audioldm2 import state_tensor

Params = Any


def _lin(x, p):
    return F.linear(x, p["w"], p.get("b"))


def _ln(x, p, eps: float):
    return F.layer_norm(x, (x.shape[-1],), p["gamma"], p["beta"], eps)


def _gelu_new(x):
    return F.gelu(x, approximate="tanh")


def _mha(q, k, v, n_heads: int, bias=None, scale: bool = True):
    """(B, T, C) attention; bias: (B|1, 1|H, Tq, Tk) additive."""
    b, tq, c = q.shape
    d = c // n_heads

    def heads(y):
        return y.reshape(b, y.shape[1], n_heads, d).transpose(1, 2)

    scores = heads(q) @ heads(k).transpose(-1, -2)
    if scale:
        scores = scores / math.sqrt(d)
    if bias is not None:
        scores = scores + bias
    out = torch.softmax(scores, dim=-1) @ heads(v)
    return out.transpose(1, 2).reshape(b, tq, c)


def _mask_bias(mask):
    """(B, T) mask -> (B, 1, 1, T) additive bias, -1e9 where masked."""
    return (1.0 - mask.float())[:, None, None, :] * -1e9


# ---------------------------------------------------------------------------
# CLAP text branch (RoBERTa + pooler + projection)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ClapTextConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    n_layers: int = 12
    n_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    pad_token_id: int = 1
    projection_dim: int = 512
    layer_norm_eps: float = 1e-12


def clap_get_text_features(p: Params, cfg: ClapTextConfig, input_ids, attention_mask):
    """transformers ClapTextModelWithProjection.get_text_features: the
    RoBERTa encoder -> tanh pooler on token 0 -> linear / ReLU / linear.
    input_ids / attention_mask: (B, T) integer tensors."""
    mask = attention_mask.float()
    pos_ids = (torch.cumsum(mask, dim=1) * mask).to(torch.int64) + cfg.pad_token_id
    emb = p["word_emb"][input_ids.long()] + p["pos_emb"][pos_ids] + p["type_emb"][0]
    x = _ln(emb, p["emb_ln"], cfg.layer_norm_eps)
    bias = _mask_bias(mask)
    for lp in p["layers"]:
        a = _mha(_lin(x, lp["q"]), _lin(x, lp["k"]), _lin(x, lp["v"]), cfg.n_heads, bias)
        x = _ln(x + _lin(a, lp["attn_out"]), lp["ln1"], cfg.layer_norm_eps)
        h = _lin(F.gelu(_lin(x, lp["fc1"])), lp["fc2"])
        x = _ln(x + h, lp["ln2"], cfg.layer_norm_eps)
    pooled = torch.tanh(_lin(x[:, 0], p["pooler"]))
    return _lin(torch.relu(_lin(pooled, p["proj1"])), p["proj2"])


def clap_params_from_state_dict(sd) -> Params:
    """transformers ClapTextModelWithProjection state dict -> the port's tree."""
    def lin(prefix):
        return {"w": state_tensor(sd[f"{prefix}.weight"]), "b": state_tensor(sd[f"{prefix}.bias"])}

    def ln(prefix):
        return {"gamma": state_tensor(sd[f"{prefix}.weight"]),
                "beta": state_tensor(sd[f"{prefix}.bias"])}

    tm = "text_model"
    p = {"word_emb": state_tensor(sd[f"{tm}.embeddings.word_embeddings.weight"]),
         "pos_emb": state_tensor(sd[f"{tm}.embeddings.position_embeddings.weight"]),
         "type_emb": state_tensor(sd[f"{tm}.embeddings.token_type_embeddings.weight"]),
         "emb_ln": ln(f"{tm}.embeddings.LayerNorm"), "pooler": lin(f"{tm}.pooler.dense"),
         "proj1": lin("text_projection.linear1"), "proj2": lin("text_projection.linear2"),
         "layers": []}
    i = 0
    while f"{tm}.encoder.layer.{i}.attention.self.query.weight" in sd:
        base = f"{tm}.encoder.layer.{i}"
        p["layers"].append({
            "q": lin(f"{base}.attention.self.query"), "k": lin(f"{base}.attention.self.key"),
            "v": lin(f"{base}.attention.self.value"),
            "attn_out": lin(f"{base}.attention.output.dense"),
            "ln1": ln(f"{base}.attention.output.LayerNorm"),
            "fc1": lin(f"{base}.intermediate.dense"), "fc2": lin(f"{base}.output.dense"),
            "ln2": ln(f"{base}.output.LayerNorm")})
        i += 1
    return p


# ---------------------------------------------------------------------------
# T5 encoder
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    n_layers: int = 24
    n_heads: int = 16
    rel_buckets: int = 32
    rel_max_distance: int = 128
    layer_norm_eps: float = 1e-6


def _t5_rms_norm(x, weight, eps):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * weight


def _t5_rel_bucket(rel_pos, num_buckets: int, max_distance: int):
    """Bidirectional relative position buckets (transformers
    _relative_position_bucket)."""
    num_buckets //= 2
    ret = torch.where(rel_pos > 0, num_buckets, 0)
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    val_large = max_exact + (torch.log(n.float() / max_exact + 1e-9)
                             / math.log(max_distance / max_exact)
                             * (num_buckets - max_exact)).to(torch.int64)
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, val_large)


def t5_encode(p: Params, cfg: T5Config, input_ids, attention_mask):
    """(B, T) -> (B, T, d_model), T5EncoderModel's last_hidden_state."""
    x = p["emb"][input_ids.long()]
    pos = torch.arange(input_ids.shape[1], device=x.device)
    buckets = _t5_rel_bucket(pos[None, :] - pos[:, None], cfg.rel_buckets,
                             cfg.rel_max_distance)            # memory - query
    bias = p["rel_bias"][buckets].permute(2, 0, 1)[None] + _mask_bias(attention_mask)
    for lp in p["layers"]:
        h = _t5_rms_norm(x, lp["ln1"], cfg.layer_norm_eps)
        a = _mha(_lin(h, lp["q"]), _lin(h, lp["k"]), _lin(h, lp["v"]), cfg.n_heads, bias,
                 scale=False)                                  # T5 does not scale by sqrt(d)
        x = x + _lin(a, lp["o"])
        h = _t5_rms_norm(x, lp["ln2"], cfg.layer_norm_eps)
        x = x + _lin(_gelu_new(_lin(h, lp["wi0"])) * _lin(h, lp["wi1"]), lp["wo"])
    return _t5_rms_norm(x, p["final_ln"], cfg.layer_norm_eps)


def t5_params_from_state_dict(sd) -> Params:
    def lin(prefix):
        return {"w": state_tensor(sd[f"{prefix}.weight"])}

    p = {"emb": state_tensor(sd["shared.weight"]),
         "rel_bias": state_tensor(sd["encoder.block.0.layer.0.SelfAttention"
                                   ".relative_attention_bias.weight"]),
         "final_ln": state_tensor(sd["encoder.final_layer_norm.weight"]), "layers": []}
    i = 0
    while f"encoder.block.{i}.layer.0.SelfAttention.q.weight" in sd:
        base = f"encoder.block.{i}.layer"
        p["layers"].append({
            "q": lin(f"{base}.0.SelfAttention.q"), "k": lin(f"{base}.0.SelfAttention.k"),
            "v": lin(f"{base}.0.SelfAttention.v"), "o": lin(f"{base}.0.SelfAttention.o"),
            "ln1": state_tensor(sd[f"{base}.0.layer_norm.weight"]),
            "wi0": lin(f"{base}.1.DenseReluDense.wi_0"),
            "wi1": lin(f"{base}.1.DenseReluDense.wi_1"),
            "wo": lin(f"{base}.1.DenseReluDense.wo"),
            "ln2": state_tensor(sd[f"{base}.1.layer_norm.weight"])})
        i += 1
    return p


# ---------------------------------------------------------------------------
# GPT2 on embeddings + diffusers generate_language_model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GPT2Config:
    n_embd: int = 768
    n_layers: int = 12
    n_heads: int = 12
    layer_norm_eps: float = 1e-5


def gpt2_forward_embeds(p: Params, cfg: GPT2Config, inputs_embeds, attention_mask=None):
    """GPT2Model on precomputed input embeddings (B, T, C)."""
    t = inputs_embeds.shape[1]
    x = inputs_embeds + p["wpe"][:t][None]
    causal = torch.tril(torch.ones((t, t), device=x.device))
    bias = (1.0 - causal)[None, None] * -1e9
    if attention_mask is not None:
        bias = bias + _mask_bias(attention_mask)
    eps = cfg.layer_norm_eps
    for lp in p["layers"]:
        q, k, v = _lin(_ln(x, lp["ln1"], eps), lp["c_attn"]).chunk(3, dim=-1)
        x = x + _lin(_mha(q, k, v, cfg.n_heads, bias), lp["c_proj"])
        x = x + _lin(_gelu_new(_lin(_ln(x, lp["ln2"], eps), lp["c_fc"])), lp["mlp_proj"])
    return _ln(x, p["ln_f"], eps)


def generate_language_model(p: Params, cfg: GPT2Config, inputs_embeds, attention_mask=None,
                            max_new_tokens: int = 8):
    """diffusers AudioLDM2Pipeline.generate_language_model: each step runs
    the whole embedding sequence through GPT2 and appends the last hidden
    state; returns the max_new_tokens generated positions (B, n, C)."""
    for _ in range(max_new_tokens):
        out = gpt2_forward_embeds(p, cfg, inputs_embeds, attention_mask)
        inputs_embeds = torch.cat([inputs_embeds, out[:, -1:, :]], dim=1)
        if attention_mask is not None:
            attention_mask = torch.cat(
                [attention_mask, attention_mask.new_ones((attention_mask.shape[0], 1))], dim=1)
    return inputs_embeds[:, -max_new_tokens:, :]


def gpt2_params_from_state_dict(sd) -> Params:
    """transformers GPT2Model state dict (its Conv1D weights are stored
    (in, out) and are transposed here to the linears' (out, in))."""
    def conv1d_lin(prefix):
        return {"w": state_tensor(sd[f"{prefix}.weight"]).T.contiguous(),
                "b": state_tensor(sd[f"{prefix}.bias"])}

    def ln(prefix):
        return {"gamma": state_tensor(sd[f"{prefix}.weight"]),
                "beta": state_tensor(sd[f"{prefix}.bias"])}

    p = {"wpe": state_tensor(sd["wpe.weight"]), "ln_f": ln("ln_f"), "layers": []}
    if "wte.weight" in sd:
        p["wte"] = state_tensor(sd["wte.weight"])
    i = 0
    while f"h.{i}.ln_1.weight" in sd:
        p["layers"].append({"ln1": ln(f"h.{i}.ln_1"), "c_attn": conv1d_lin(f"h.{i}.attn.c_attn"),
                            "c_proj": conv1d_lin(f"h.{i}.attn.c_proj"), "ln2": ln(f"h.{i}.ln_2"),
                            "c_fc": conv1d_lin(f"h.{i}.mlp.c_fc"),
                            "mlp_proj": conv1d_lin(f"h.{i}.mlp.c_proj")})
        i += 1
    return p


# ---------------------------------------------------------------------------
# AudioLDM2 projection model
# ---------------------------------------------------------------------------

def projection_forward(p: Params, hidden_states, hidden_states_1, attention_mask=None,
                       attention_mask_1=None):
    """diffusers AudioLDM2ProjectionModel: project each stream to the
    language model's width, wrap each in its learned SOS / EOS tokens,
    concatenate the streams (and masks) along the sequence axis."""
    def one(h, m, proj, sos, eos):
        h = _lin(h, proj)
        b = h.shape[0]
        h = torch.cat([sos.expand(b, 1, -1), h, eos.expand(b, 1, -1)], dim=1)
        if m is not None:
            ones = m.new_ones((b, 1))
            m = torch.cat([ones, m, ones], dim=1)
        return h, m

    h0, m0 = one(hidden_states, attention_mask, p["proj"], p["sos"], p["eos"])
    h1, m1 = one(hidden_states_1, attention_mask_1, p["proj_1"], p["sos_1"], p["eos_1"])
    h = torch.cat([h0, h1], dim=1)
    if m0 is not None and m1 is not None:
        return h, torch.cat([m0, m1], dim=1)
    return h, None


def projection_params_from_state_dict(sd) -> Params:
    return {"proj": {"w": state_tensor(sd["projection.weight"]),
                     "b": state_tensor(sd["projection.bias"])},
            "proj_1": {"w": state_tensor(sd["projection_1.weight"]),
                       "b": state_tensor(sd["projection_1.bias"])},
            "sos": state_tensor(sd["sos_embed"]), "eos": state_tensor(sd["eos_embed"]),
            "sos_1": state_tensor(sd["sos_embed_1"]), "eos_1": state_tensor(sd["eos_embed_1"])}
