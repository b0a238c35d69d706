"""Demucs v4 family in PyTorch: HDemucs / HTDemucs source separation
(counterpart of JAX `models/demucs.py`).

Runs the reference's vendored demucs (main/library/uvr5_separator/demucs/
{demucs,hdemucs,htdemucs}.py) for inference over the models the toolkit
ships: htdemucs / htdemucs_ft / htdemucs_6s (hybrid transformer) and
hdemucs_mmi (hybrid spectrogram, BLSTM + LocalState DConv branches).

Layouts are PyTorch's, the state dict's own: the frequency branch is
(B, C, F, T), the time branch (B, C, T).  Both output paths are here:
complex-as-channels (`cac`, every shipped model) and magnitude masks
through Wiener EM (`wiener_mask`, for `cac=False` checkpoints).  The
STFT is `torch.stft` (cuFFT on the card); its inverse divides by the
overlap-added squared window clamped at 1e-11 (`ops/stft.py` `istft`,
an `F.fold` overlap-add), as JAX does.  Convolutions, the LSTM and the
attention are cuDNN / cuBLAS / SDPA calls: the JAX package has no Pallas
kernel on this path.

The parameters are a tree of tensors in PyTorch layouts, in the JAX
tree's structure (`params_from_state_dict`; `interop/from_jax.py`
`demucs_from_jax` carries a JAX tree over), each BLSTM an `nn.LSTM`.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.stft import hann_window, istft

Params = Any


# ---------------------------------------------------------------------------
# spectral helpers (reference hdemucs.py spectro / ispectro / pad1d)
# ---------------------------------------------------------------------------

def _pad1d(x, pad_left: int, pad_right: int, mode: str = "constant"):
    """Padding of the last axis that allows reflect on a short input
    (reference pad1d): what reflect cannot take is zero-padded first."""
    length = x.shape[-1]
    if mode == "reflect":
        max_pad = max(pad_left, pad_right)
        if length <= max_pad:
            extra = max_pad - length + 1
            extra_right = min(pad_right, extra)
            extra_left = extra - extra_right
            x = F.pad(x, (extra_left, extra_right))
            pad_left -= extra_left
            pad_right -= extra_right
    return F.pad(x, (pad_left, pad_right), mode=mode)


def _window(n_fft: int, like: torch.Tensor) -> torch.Tensor:
    real = like.real.dtype if like.is_complex() else like.dtype
    return torch.as_tensor(hann_window(n_fft), device=like.device, dtype=real)


def _spectro(x, n_fft: int, hop: int):
    """torch.stft(normalized=True, center=True, reflect) of the last axis.
    x: (..., L) -> complex (..., F, T)."""
    shape = x.shape
    z = torch.stft(x.reshape(-1, shape[-1]), n_fft, hop_length=hop, win_length=n_fft,
                   window=_window(n_fft, x), center=True, pad_mode="reflect",
                   normalized=True, onesided=True, return_complex=True)
    return z.reshape(*shape[:-1], z.shape[-2], z.shape[-1])


def _ispectro(z, hop: int, length: int):
    """The inverse of `_spectro` (torch.istft(normalized=True,
    center=True)) with JAX's edges: the overlap-added squared window is
    clamped at 1e-11.  z: (..., F, T) -> (..., length)."""
    shape = z.shape
    n_fft = 2 * shape[-2] - 2
    spec = z.reshape(-1, shape[-2], shape[-1]).transpose(1, 2) * (n_fft ** 0.5)
    y = istft(spec, n_fft=n_fft, hop_length=hop, win_length=n_fft,
              window=hann_window(n_fft), length=length)
    return y.reshape(*shape[:-2], length)


# ---------------------------------------------------------------------------
# small blocks
# ---------------------------------------------------------------------------

def _group_norm(x, groups: int, gamma, beta, eps: float = 1e-5):
    """GroupNorm of channel axis 1 as mean / variance reductions.
    F.group_norm's CUDA kernel gives each (sample, group) row one thread
    block, and a GroupNorm(1) of the time branch spans a whole window
    (millions of values) in one row."""
    xg = x.reshape(x.shape[0], groups, -1)
    var, mean = torch.var_mean(xg, dim=-1, keepdim=True, correction=0)
    xg = (xg - mean) * torch.rsqrt(var + eps)
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 2)
    return xg.reshape(x.shape) * gamma.reshape(shape) + beta.reshape(shape)


def _norm(p, x):
    """GroupNorm of channel axis 1 (p["groups"] groups), or nothing."""
    if p is None:
        return x
    return _group_norm(x, p.get("groups", 1), p["gamma"], p["beta"])


def _conv(x, p, **kw):
    conv = F.conv2d if x.dim() == 4 else F.conv1d
    return conv(x, p["w"], p.get("b"), **kw)


def _convt(x, p, stride: int):
    if x.dim() == 4:
        return F.conv_transpose2d(x, p["w"], p.get("b"), stride=(stride, 1))
    return F.conv_transpose1d(x, p["w"], p.get("b"), stride=stride)


def _rewrite(x, p):
    """The 1 + 2 * context rewrite conv, padded to keep the size."""
    w = p["w"]
    pad = (w.shape[2] // 2, w.shape[3] // 2) if w.dim() == 4 else w.shape[2] // 2
    return _conv(x, p, padding=pad)


# ---------------------------------------------------------------------------
# DConv branch (reference demucs.py:86-115) with LocalState and BLSTM
# ---------------------------------------------------------------------------

BLSTM_MAX_STEPS = 200


def make_blstm(weights: dict) -> torch.nn.LSTM:
    """A bidirectional nn.LSTM (batch first) holding the reference BLSTM's
    weights, by torch's own names (weight_ih_l0, ..._reverse)."""
    n_layers = sum(1 for k in weights if k.startswith("weight_ih_l") and "reverse" not in k)
    hidden = weights["weight_hh_l0"].shape[1]
    lstm = torch.nn.LSTM(weights["weight_ih_l0"].shape[1], hidden, num_layers=n_layers,
                         bidirectional=True, batch_first=True)
    lstm.load_state_dict({k: torch.as_tensor(v, dtype=torch.float32) for k, v in weights.items()})
    return lstm.eval().requires_grad_(False)


def _blstm_apply(p, x):
    """2-layer bidirectional LSTM + linear, in frames of 200 steps with
    half-overlap stitching above that (reference demucs.py BLSTM,
    skip=True).  x: (B, C, T)."""
    b, c, t = x.shape
    h = x.transpose(1, 2)                                   # (B, T, C)
    framed = t > BLSTM_MAX_STEPS
    if framed:
        width = BLSTM_MAX_STEPS
        stride = width // 2
        nframes = int(math.ceil((t - width) / stride)) + 1
        total = stride * (nframes - 1) + width
        h = F.pad(h, (0, 0, 0, total - t)).unfold(1, width, stride)    # (B, N, C, width)
        h = h.transpose(2, 3).reshape(b * nframes, width, c)
    h = F.linear(p["lstm"](h)[0], p["linear"]["w"], p["linear"]["b"])
    if framed:
        frames = h.reshape(b, nframes, width, c)
        limit = stride // 2
        outs = [frames[:, 0, :-limit]]
        outs += [frames[:, k, limit:-limit] for k in range(1, nframes - 1)]
        outs.append(frames[:, nframes - 1, limit:])
        h = torch.cat(outs, dim=1)[:, :t]
    return h.transpose(1, 2) + x


def _local_state_apply(p, x, *, heads: int = 4, ndecay: int = 4):
    """LocalState decaying local attention (reference demucs.py:117-166).
    The softmax runs over the key axis (dim 2), the diagonal at -100.
    x: (B, C, T)."""
    b, c, t = x.shape
    idx = torch.arange(t, device=x.device, dtype=x.dtype)
    delta = idx[:, None] - idx[None, :]

    def heads_of(name):                                     # (B, H, D, T)
        return _conv(x, p[name]).reshape(b, heads, -1, t)

    queries, keys = heads_of("query"), heads_of("key")
    dots = torch.einsum("bhct,bhcs->bhts", keys, queries) / (keys.shape[2] ** 0.5)
    decays = torch.arange(1, ndecay + 1, device=x.device, dtype=x.dtype)
    decay_q = torch.sigmoid(heads_of("query_decay")) / 2.0
    decay_kernel = -decays[:, None, None] * delta.abs() / (ndecay ** 0.5)
    dots = dots + torch.einsum("fts,bhfs->bhts", decay_kernel, decay_q)
    eye = torch.eye(t, dtype=torch.bool, device=x.device)
    dots = dots.masked_fill(eye, -100.0)
    weights = torch.softmax(dots, dim=2)
    result = torch.einsum("bhts,bhct->bhcs", weights, heads_of("content")).reshape(b, c, t)
    return x + _conv(result, p["proj"])


def _dconv_apply(p, x):
    """Residual compressed dilated branches.  x: (B, C, T)."""
    for layer in p["layers"]:
        y = _conv(x, layer["conv1"], dilation=layer["dilation"],
                  padding=layer["dilation"] * (layer["kernel"] // 2))
        y = F.gelu(_norm(layer.get("norm1"), y))
        if "lstm" in layer:
            y = _blstm_apply(layer["lstm"], y)
        if "attn" in layer:
            y = _local_state_apply(layer["attn"], y)
        y = F.glu(_norm(layer.get("norm2"), _conv(y, layer["conv2"])), dim=1)
        x = x + y * layer["scale"][:, None]
    return x


def _dconv_any(p, y):
    """The DConv branch on the time layout, or on each frequency row of
    the frequency layout (B, C, F, T)."""
    if y.dim() == 3:
        return _dconv_apply(p, y)
    b, c, f, t = y.shape
    y2 = _dconv_apply(p, y.permute(0, 2, 1, 3).reshape(b * f, c, t))
    return y2.reshape(b, f, c, t).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# encoder / decoder layers (reference hdemucs.py HEncLayer / HDecLayer)
# ---------------------------------------------------------------------------

def _henc_apply(p, x, inject=None):
    """Frequency variant: x (B, C, F, T); time variant: x (B, C, T)."""
    freq, stride = p["freq"], p["stride"]
    if not freq and x.dim() == 4:
        # the deepest layer takes the F = 1 frequency branch flattened
        # (reference HEncLayer.forward view(B, -1, T))
        b, c, f, t = x.shape
        x = x.reshape(b, c * f, t)
    if freq:
        y = _conv(x, p["conv"], stride=(stride, 1), padding=(p["pad"], 0))
    else:
        le = x.shape[-1]
        if le % stride != 0:
            x = F.pad(x, (0, stride - le % stride))
        y = _conv(x, p["conv"], stride=stride, padding=p["pad"])
    if p.get("empty"):
        return y
    if inject is not None:
        if inject.dim() == 3 and y.dim() == 4:
            inject = inject[:, :, None]                     # (B, C, 1, T)
        y = y + inject
    y = F.gelu(_norm(p.get("norm1"), y))
    if "dconv" in p:
        y = _dconv_any(p["dconv"], y)
    if "rewrite" in p:
        return F.glu(_norm(p.get("norm2"), _rewrite(y, p["rewrite"])), dim=1)
    return y


def _hdec_apply(p, x, skip, length):
    """Returns (z, pre).  Frequency variant: x (B, C, F, T)."""
    freq, stride = p["freq"], p["stride"]
    if freq and x.dim() == 3:
        # reference HDecLayer.forward view(B, chin, -1, T)
        b, c_total, t = x.shape
        x = x.reshape(b, p["chin"], c_total // p["chin"], t)
    if not p.get("empty"):
        x = x + skip
        y = x
        if "rewrite" in p:
            y = F.glu(_norm(p.get("norm1"), _rewrite(x, p["rewrite"])), dim=1)
        if "dconv" in p:
            y = _dconv_any(p["dconv"], y)
    else:
        y = x
    z = _norm(p.get("norm2"), _convt(y, p["conv_tr"], stride))
    if freq:
        if p["pad"]:
            z = z[:, :, p["pad"]:-p["pad"], :]
    else:
        z = z[..., p["pad"]:p["pad"] + length]
    if not p["last"]:
        z = F.gelu(z)
    return z, y


# ---------------------------------------------------------------------------
# the cross transformer (reference htdemucs.py)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _sin_embedding_on(kind: str, device: torch.device, *shape) -> torch.Tensor:
    """A sinusoidal embedding on `device`, uploaded once per shape (a full
    window's 2D one is 5 MB)."""
    emb = _sin_embedding_2d(*shape) if kind == "2d" else _sin_embedding_1d(*shape)
    return torch.as_tensor(emb, device=device)


def _sin_embedding_1d(length: int, dim: int, max_period: float = 10000.0) -> np.ndarray:
    pos = np.arange(length)[:, None]
    adim = np.arange(dim // 2)[None, :]
    phase = pos / (max_period ** (adim / (dim // 2 - 1)))
    return np.concatenate([np.cos(phase), np.sin(phase)], axis=-1).astype(np.float32)


def _sin_embedding_2d(d_model: int, height: int, width: int,
                      max_period: float = 10000.0) -> np.ndarray:
    """(height * width tokens in (t, f) order, d_model): the reference's
    create_2d_sin_embedding rearranged '(t1 fr) c'."""
    pe = np.zeros((d_model, height, width), np.float32)
    half = d_model // 2
    div = np.exp(np.arange(0.0, half, 2) * -(math.log(max_period) / half))
    pos_w = np.arange(width)[:, None]
    pos_h = np.arange(height)[:, None]
    pe[0:half:2] = np.sin(pos_w * div).T[:, None, :].repeat(height, axis=1)
    pe[1:half:2] = np.cos(pos_w * div).T[:, None, :].repeat(height, axis=1)
    pe[half::2] = np.sin(pos_h * div).T[:, :, None].repeat(width, axis=2)
    pe[half + 1::2] = np.cos(pos_h * div).T[:, :, None].repeat(width, axis=2)
    return pe.transpose(2, 1, 0).reshape(height * width, d_model)


def _layer_norm(x, p):
    return F.layer_norm(x, (x.shape[-1],), p["gamma"], p["beta"], eps=1e-5)


def _mha_packed(p, q_in, kv_in, n_heads: int):
    """nn.MultiheadAttention with a packed in_proj, the attention by SDPA.
    q_in: (B, T, C), kv_in: (B, S, C)."""
    c = q_in.shape[-1]
    w, bias = p["in_w"], p["in_b"]
    q = F.linear(q_in, w[:c], bias[:c])
    k = F.linear(kv_in, w[c:2 * c], bias[c:2 * c])
    v = F.linear(kv_in, w[2 * c:], bias[2 * c:])
    b, tq, _ = q.shape
    d = c // n_heads

    def split(u):
        return u.reshape(b, -1, n_heads, d).transpose(1, 2)

    out = F.scaled_dot_product_attention(split(q), split(k), split(v))
    return F.linear(out.transpose(1, 2).reshape(b, tq, c), p["out"]["w"], p["out"]["b"])


def _t_layer(p, x, n_heads: int, cross_k=None):
    """Norm-first transformer layer, self or cross, with LayerScale and a
    GroupNorm(1) output norm (the shipped HTDemucs configuration).  In a
    cross layer `norm2k` (the reference's norm2) normalizes the keys and
    `norm2` (its norm3) the feed-forward input.  x: (B, T, C)."""
    q = _layer_norm(x, p["norm1"])
    if cross_k is None:
        k = q
    else:
        k = _layer_norm(cross_k, p["norm2k"]) if "norm2k" in p else cross_k
    x = x + _mha_packed(p["attn"], q, k, n_heads) * p["gamma1"]
    y = _layer_norm(x, p["norm2"])
    y = F.linear(F.gelu(F.linear(y, p["fc1"]["w"], p["fc1"]["b"])), p["fc2"]["w"], p["fc2"]["b"])
    x = x + y * p["gamma2"]
    if "norm_out" in p:
        x = _group_norm(x.transpose(1, 2), 1, p["norm_out"]["gamma"],
                        p["norm_out"]["beta"]).transpose(1, 2)
    return x


def _cross_transformer(p, x, xt, n_heads: int):
    """x: (B, C, F, T1) frequency tokens; xt: (B, C, T2) time tokens.
    Self layers at even indices, cross layers at odd ones (cross_first
    False)."""
    b, c, f, t1 = x.shape
    tokens = _layer_norm(x.permute(0, 3, 2, 1).reshape(b, t1 * f, c), p["norm_in"])
    tokens = tokens + _sin_embedding_on("2d", x.device, c, f, t1)
    xt = _layer_norm(xt.transpose(1, 2), p["norm_in_t"])
    xt = xt + _sin_embedding_on("1d", x.device, xt.shape[1], c)
    for i, lp in enumerate(p["layers"]):
        if i % 2 == 0:
            tokens = _t_layer(lp["z"], tokens, n_heads)
            xt = _t_layer(lp["t"], xt, n_heads)
        else:
            old = tokens
            tokens = _t_layer(lp["z"], tokens, n_heads, cross_k=xt)
            xt = _t_layer(lp["t"], xt, n_heads, cross_k=old)
    return tokens.reshape(b, t1, f, c).permute(0, 3, 2, 1), xt.transpose(1, 2)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DemucsConfig:
    sources: tuple[str, ...] = ("drums", "bass", "other", "vocals")
    audio_channels: int = 2
    nfft: int = 4096
    depth: int = 4
    stride: int = 4
    kernel_size: int = 8
    time_stride: int = 2
    freq_emb_scale: float = 0.2
    cac: bool = True
    wiener_iters: int = 0
    wiener_residual: bool = False
    has_transformer: bool = True
    t_heads: int = 8
    samplerate: int = 44100
    segment: float = 40.0
    use_train_segment: bool = True


# ---------------------------------------------------------------------------
# Wiener EM filtering (cac=False checkpoints; reference hdemucs.py:111-188)
# ---------------------------------------------------------------------------
#
# Complex64 einsums over the whole window, as JAX writes them; frames
# go in 300-frame windows zero-padded at the end (zero frames add nothing
# to the EM statistics, and their outputs are dropped).

WIENER_WIN = 300


def _invert_2x2(m):
    """Batched complex 2x2 (or 1x1) inverse over the last two dims."""
    if m.shape[-1] == 1:
        return 1.0 / m
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    inv_det = 1.0 / det
    row0 = torch.stack([m[..., 1, 1], -m[..., 0, 1]], dim=-1)
    row1 = torch.stack([-m[..., 1, 0], m[..., 0, 0]], dim=-1)
    return inv_det[..., None, None] * torch.stack([row0, row1], dim=-2)


def expectation_maximization(y, x, iterations: int = 2, eps: float = 1e-10):
    """y: (T, F, C, S) complex source estimates; x: (T, F, C) complex
    mix.  Returns the refined y (reference hdemucs.py:111-168)."""
    c = x.shape[-1]
    reg = float(np.sqrt(np.float32(eps))) * torch.eye(c, dtype=x.dtype, device=x.device)
    for _ in range(iterations):
        v = torch.mean(y.abs() ** 2, dim=2)                 # (T, F, S)
        weight = eps + v.sum(dim=0)                         # (F, S)
        cov = torch.einsum("tfcs,tfds->fcds", y, y.conj())
        r = cov / weight[:, None, None, :]                  # (F, C, C, S)
        vc = v.to(x.dtype)
        cxx = reg + torch.einsum("tfs,fcds->tfcd", vc, r)
        inv = _invert_2x2(cxx)
        # y_j = v_j * (R_j @ inv_Cxx) @ x   (hdemucs.py:152-166)
        y = torch.einsum("fcds,tfde,tfs,tfe->tfcs", r, inv, vc, x)
    return y


def wiener(mag_spectrograms, mix_stft, iterations: int = 1, *, softmask: bool = False,
           residual: bool = False, scale_factor: float = 10.0, eps: float = 1e-10):
    """mag_spectrograms: (T, F, C, S) non-negative source magnitudes;
    mix_stft: (T, F, C) complex.  Returns (T, F, C, S [+1 if residual])
    complex (reference hdemucs.py:170-188)."""
    if softmask:
        mask = mag_spectrograms / (eps + mag_spectrograms.sum(dim=-1, keepdim=True))
        y = mix_stft[..., None] * mask
    else:
        angle = torch.angle(mix_stft)[..., None]
        y = (mag_spectrograms * torch.exp(1j * angle)).to(mix_stft.dtype)
    if residual:
        y = torch.cat([y, mix_stft[..., None] - y.sum(dim=-1, keepdim=True)], dim=-1)
    if iterations == 0:
        return y
    max_abs = torch.clamp(torch.sqrt(torch.max(mix_stft.abs() ** 2)) / scale_factor, min=1.0)
    y = expectation_maximization(y / max_abs, mix_stft / max_abs, iterations, eps=eps)
    return y * max_abs


def wiener_mask(mag_out, mix_stft, niters: int, residual: bool = False,
                win_len: int = WIENER_WIN):
    """Windowed Wiener EM over a whole track (reference _wiener,
    hdemucs.py:651-677).  mag_out: (B, S, C, F, T) magnitudes;
    mix_stft: (B, C, F, T) complex -> (B, S, C, F, T) complex."""
    t = mag_out.shape[-1]
    mags = mag_out.permute(0, 4, 3, 2, 1)                  # (B, T, F, C, S)
    mix = mix_stft.permute(0, 3, 2, 1)                     # (B, T, F, C)
    outs = []
    for bi in range(mag_out.shape[0]):
        chunks = []
        for pos in range(0, t, win_len):
            m_chunk = mags[bi, pos:pos + win_len]
            x_chunk = mix[bi, pos:pos + win_len]
            n = m_chunk.shape[0]
            if n < win_len:
                m_chunk = F.pad(m_chunk, (0, 0, 0, 0, 0, 0, 0, win_len - n))
                x_chunk = F.pad(x_chunk, (0, 0, 0, 0, 0, win_len - n))
            chunks.append(wiener(m_chunk, x_chunk, niters, residual=residual)[:n])
        outs.append(torch.cat(chunks, dim=0))
    out = torch.stack(outs, dim=0)                          # (B, T, F, C, S')
    if residual:
        out = out[..., :-1]
    return out.permute(0, 4, 3, 2, 1)


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def params_device(params) -> torch.device:
    """The device the parameter tree lives on."""
    return params["encoder"][0]["conv"]["w"].device


def apply_model_single(params: Params, cfg: DemucsConfig, mix):
    """mix: (B, audio_channels, L) on the parameters' device ->
    (B, n_sources, audio_channels, L)."""
    length = mix.shape[-1]
    if cfg.use_train_segment:
        training_length = int(cfg.segment * cfg.samplerate)
        if length < training_length:
            mix = F.pad(mix, (0, training_length - length))
    cur_len = mix.shape[-1]

    hop = cfg.nfft // 4
    le = int(math.ceil(cur_len / hop))
    pad = hop // 2 * 3
    padded = _pad1d(mix, pad, pad + le * hop - cur_len, mode="reflect")
    z = _spectro(padded, cfg.nfft, hop)[..., :-1, :]
    z = z[..., 2:2 + le]

    b, c, fq, t = z.shape
    if cfg.cac:
        # complex as channels: (B, C, F, T) complex -> (B, 2C, F, T)
        x = torch.stack([z.real, z.imag], dim=2).reshape(b, c * 2, fq, t)
    else:
        # magnitudes; the phases come back through Wiener EM
        x = z.abs()

    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    std = x.std(dim=(1, 2, 3), keepdim=True)               # ddof 1
    x = (x - mean) / (1e-5 + std)

    xt = mix
    meant = xt.mean(dim=(1, 2), keepdim=True)
    stdt = xt.std(dim=(1, 2), keepdim=True)
    xt = (xt - meant) / (1e-5 + stdt)

    saved, saved_t, lengths, lengths_t = [], [], [], []
    for idx, enc in enumerate(params["encoder"]):
        lengths.append(x.shape[-1])
        inject = None
        if idx < len(params["tencoder"]):
            lengths_t.append(xt.shape[-1])
            tenc = params["tencoder"][idx]
            xt = _henc_apply(tenc, xt)
            if not tenc.get("empty"):
                saved_t.append(xt)
            else:
                inject = xt
        x = _henc_apply(enc, x, inject)
        if idx == 0 and "freq_emb" in params:
            emb = params["freq_emb"]                        # (F, C)
            x = x + cfg.freq_emb_scale * emb.t()[None, :, :, None]
        saved.append(x)

    if cfg.has_transformer:
        # HTDemucs: the transformer's outputs feed the decoders
        x, xt = _cross_transformer(params["transformer"], x, xt, cfg.t_heads)
    else:
        # HDemucs: the decoders start from zero (the skips carry the
        # signal); the first time decoder's input comes from `pre`
        x = torch.zeros_like(saved[-1])
        xt = None

    offset = cfg.depth - len(params["tdecoder"])
    for idx, dec in enumerate(params["decoder"]):
        x, pre = _hdec_apply(dec, x, saved.pop(-1), lengths.pop(-1))
        if idx >= offset:
            tdec = params["tdecoder"][idx - offset]
            length_t = lengths_t.pop(-1)
            if tdec.get("empty"):
                xt, _ = _hdec_apply(tdec, pre[:, :, 0], None, length_t)
            else:
                xt, _ = _hdec_apply(tdec, xt, saved_t.pop(-1), length_t)

    s = len(cfg.sources)
    x = x * std + mean                                      # (B, S*{2C|C}, F, T)
    if cfg.cac:
        x = x.reshape(b, s, cfg.audio_channels, 2, fq, t)
        zout = torch.complex(x[:, :, :, 0], x[:, :, :, 1])
    else:
        # masks -> complex through the normalized mix's phase or Wiener EM
        # (reference _mask, hdemucs.py:636-649)
        m = x.reshape(b, s, cfg.audio_channels, fq, t)
        if cfg.wiener_iters < 0:
            zout = z[:, None] / (1e-8 + z.abs()[:, None]) * m
        else:
            zout = wiener_mask(m, z, cfg.wiener_iters, cfg.wiener_residual)

    zp = F.pad(zout, (2, 2, 0, 1))
    le2 = hop * int(math.ceil(cur_len / hop)) + 2 * pad
    xs = _ispectro(zp, hop, le2)[..., pad:pad + cur_len]

    xt = xt.reshape(b, s, cfg.audio_channels, cur_len)
    xt = xt * stdt.reshape(b, 1, 1, 1) + meant.reshape(b, 1, 1, 1)
    return (xs + xt)[..., :length]


# ---------------------------------------------------------------------------
# the state dict importer (reference module names, PyTorch layouts)
# ---------------------------------------------------------------------------

def _f32(v) -> torch.Tensor:
    v = torch.as_tensor(v)
    return v.float() if v.is_floating_point() else v


def _imp_param(sd, prefix):
    out = {"w": _f32(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["b"] = _f32(sd[f"{prefix}.bias"])
    return out


def _imp_norm(sd, prefix, groups=1):
    if f"{prefix}.weight" not in sd:
        return None
    return {"gamma": _f32(sd[f"{prefix}.weight"]), "beta": _f32(sd[f"{prefix}.bias"]),
            "groups": groups}


def _imp_dconv(sd, prefix):
    if f"{prefix}.layers.0.0.weight" not in sd:
        return None
    layers = []
    d = 0
    while f"{prefix}.layers.{d}.0.weight" in sd:
        lp = f"{prefix}.layers.{d}"
        layer = {"conv1": _imp_param(sd, f"{lp}.0"), "norm1": _imp_norm(sd, f"{lp}.1"),
                 "kernel": sd[f"{lp}.0.weight"].shape[-1], "dilation": 2 ** d}
        # the optional BLSTM and LocalState sit after the activation
        idx = 3
        if f"{lp}.{idx}.lstm.weight_ih_l0" in sd:
            head = f"{lp}.{idx}.lstm."
            layer["lstm"] = {
                "lstm": make_blstm({k[len(head):]: v for k, v in sd.items()
                                    if k.startswith(head)}),
                "linear": _imp_param(sd, f"{lp}.{idx}.linear")}
            idx += 1
        if f"{lp}.{idx}.content.weight" in sd:
            layer["attn"] = {name: _imp_param(sd, f"{lp}.{idx}.{name}")
                             for name in ("content", "query", "key", "query_decay", "proj")}
            idx += 1
        layer["conv2"] = _imp_param(sd, f"{lp}.{idx}")
        layer["norm2"] = _imp_norm(sd, f"{lp}.{idx + 1}")
        layer["scale"] = _f32(sd[f"{lp}.{idx + 3}.scale"])
        layers.append(layer)
        d += 1
    return {"layers": layers}


def _geometry(depth: int, *, nfft: int = 4096, stride: int = 4, kernel_size: int = 8,
              time_stride: int = 2, norm_starts: int = 4):
    """The reference constructor's per-layer geometry loop."""
    freqs = nfft // 2
    plans = []
    for index in range(depth):
        norm = index >= norm_starts
        freq = freqs > 1
        stri, ker = stride, kernel_size
        if not freq:
            ker, stri = time_stride * 2, time_stride
        pad = True
        last_freq = False
        if freq and freqs <= kernel_size:
            ker = freqs
            pad = False
            last_freq = True
        plans.append(dict(ker=ker, stride=stri, freq=freq, pad=(ker // 4 if pad else 0),
                          norm=norm, last_freq=last_freq))
        if freq:
            freqs = 1 if freqs <= kernel_size else freqs // stride
    return plans


def _imp_layer(sd, prefix, plan, *, freq: bool, decoder: bool, empty=False, last=False,
               norm_groups=4):
    """One HEncLayer / HDecLayer.  Every time layer runs at stride 4,
    pad 2 (the tencoder's kernel 8), as the JAX importer sets it."""
    p = {"freq": freq, "stride": plan["stride"] if freq else 4,
         "pad": plan["pad"] if freq else 2}
    if decoder:
        p["last"] = last
        p["conv_tr"] = _imp_param(sd, f"{prefix}.conv_tr")
    else:
        p["conv"] = _imp_param(sd, f"{prefix}.conv")
    if empty:
        p["empty"] = True
        if decoder and plan["norm"]:
            p["norm2"] = _imp_norm(sd, f"{prefix}.norm2", norm_groups)
        return p
    if plan["norm"]:
        # the encoder's norm1 follows its conv, the decoder's its rewrite
        p["norm2" if decoder else "norm1"] = _imp_norm(
            sd, f"{prefix}.{'norm2' if decoder else 'norm1'}", norm_groups)
    if f"{prefix}.rewrite.weight" in sd:
        p["rewrite"] = _imp_param(sd, f"{prefix}.rewrite")
        if plan["norm"]:
            name = "norm1" if decoder else "norm2"
            p[name] = _imp_norm(sd, f"{prefix}.{name}", norm_groups)
    dc = _imp_dconv(sd, f"{prefix}.dconv")
    if dc is not None:
        p["dconv"] = dc
    if decoder and freq:
        p["chin"] = p["conv_tr"]["w"].shape[0]
    return p


def _imp_t_layer(sd, prefix, cross: bool):
    attn = "cross_attn" if cross else "self_attn"
    ln = lambda name: {"gamma": _f32(sd[f"{prefix}.{name}.weight"]),  # noqa: E731
                       "beta": _f32(sd[f"{prefix}.{name}.bias"])}
    p = {"attn": {"in_w": _f32(sd[f"{prefix}.{attn}.in_proj_weight"]),
                  "in_b": _f32(sd[f"{prefix}.{attn}.in_proj_bias"]),
                  "out": _imp_param(sd, f"{prefix}.{attn}.out_proj")},
         "fc1": _imp_param(sd, f"{prefix}.linear1"), "fc2": _imp_param(sd, f"{prefix}.linear2"),
         "norm1": ln("norm1"),
         "gamma1": _f32(sd[f"{prefix}.gamma_1.scale"]),
         "gamma2": _f32(sd[f"{prefix}.gamma_2.scale"])}
    if cross:
        p["norm2k"] = ln("norm2")      # the key branch's norm
        p["norm2"] = ln("norm3")       # the feed-forward's norm
    else:
        p["norm2"] = ln("norm2")
    if f"{prefix}.norm_out.weight" in sd:
        p["norm_out"] = _imp_norm(sd, f"{prefix}.norm_out")
    return p


def params_from_state_dict(sd, cfg: DemucsConfig) -> Params:
    """An HTDemucs / HDemucs state dict (the reference modules' names) ->
    the parameter tree `apply_model_single` reads, on the CPU (JAX
    `htdemucs_params_from_state_dict`).  freq_emb is scaled by its
    emb_scale (10) here."""
    plans = _geometry(cfg.depth, nfft=cfg.nfft, stride=cfg.stride,
                      kernel_size=cfg.kernel_size, time_stride=cfg.time_stride)
    p: dict = {"encoder": [], "decoder": [], "tencoder": [], "tdecoder": []}
    for i, plan in enumerate(plans):
        p["encoder"].append(_imp_layer(sd, f"encoder.{i}", plan, freq=plan["freq"],
                                       decoder=False))
        if plan["freq"]:
            p["tencoder"].append(_imp_layer(sd, f"tencoder.{i}", plan, freq=False,
                                            decoder=False, empty=plan["last_freq"]))
    # the decoder lists are stored deepest first (reference insert(0, ...))
    for di in range(cfg.depth):
        plan = plans[cfg.depth - 1 - di]
        p["decoder"].append(_imp_layer(sd, f"decoder.{di}", plan, freq=plan["freq"],
                                       decoder=True, last=di == cfg.depth - 1))
    n_tdec = sum(1 for plan in plans if plan["freq"])
    for di in range(n_tdec):
        plan = plans[n_tdec - 1 - di]
        p["tdecoder"].append(_imp_layer(sd, f"tdecoder.{di}", plan, freq=False, decoder=True,
                                        empty=plan["last_freq"], last=di == n_tdec - 1))
    if "freq_emb.embedding.weight" in sd:
        p["freq_emb"] = _f32(sd["freq_emb.embedding.weight"]) * 10.0     # emb_scale
    if any(k.startswith("crosstransformer") for k in sd):
        tp: dict = {"norm_in": {"gamma": _f32(sd["crosstransformer.norm_in.weight"]),
                                "beta": _f32(sd["crosstransformer.norm_in.bias"])},
                    "norm_in_t": {"gamma": _f32(sd["crosstransformer.norm_in_t.weight"]),
                                  "beta": _f32(sd["crosstransformer.norm_in_t.bias"])},
                    "layers": []}
        i = 0
        while f"crosstransformer.layers.{i}.norm1.weight" in sd:
            cross = f"crosstransformer.layers.{i}.cross_attn.in_proj_weight" in sd
            tp["layers"].append({"z": _imp_t_layer(sd, f"crosstransformer.layers.{i}", cross),
                                 "t": _imp_t_layer(sd, f"crosstransformer.layers_t.{i}", cross)})
            i += 1
        p["transformer"] = tp
    return p
