"""Plain PyTorch layers of the reference: a frozen copy of the port's
`ops/nn.py` (weights in torch layouts).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

LRELU_SLOPE = 0.1  # reference: main/library/algorithm/residuals.py:14


def leaky_relu(x, slope: float = LRELU_SLOPE):
    return F.leaky_relu(x, slope)


def conv1d(x, w, b=None, *, stride: int = 1, dilation: int = 1,
           padding: int | tuple[int, int] = 0, groups: int = 1):
    """1-D convolution on (B, Cin, T).  padding: symmetric int or an
    asymmetric (lo, hi) pair of zero-padding."""
    if isinstance(padding, tuple):
        lo, hi = padding
        if lo or hi:
            x = F.pad(x, (lo, hi))
        padding = 0
    return F.conv1d(x, w, b, stride=stride, padding=padding,
                    dilation=dilation, groups=groups)


def conv_transpose1d(x, w, b=None, *, stride: int, padding: int = 0,
                     output_padding: int = 0):
    """Transposed 1-D convolution, torch.nn.ConvTranspose1d semantics.
    x: (B, Cin, T); w: (Cin, Cout, K).  Output length:
    (T - 1) * stride - 2 * padding + K + output_padding."""
    return F.conv_transpose1d(x, w, b, stride=stride, padding=padding,
                              output_padding=output_padding)


def linear(x, w, b=None):
    """x: (..., Cin); w: (Cout, Cin)."""
    return F.linear(x, w, b)


def linear_as_input(x, w, b=None):
    """`linear` in x's dtype, the weights cast to it: what jnp.matmul's
    type promotion does when an fp32 source (the sine sources, which stay
    fp32) meets bf16 weights."""
    return F.linear(x, w.to(x.dtype), None if b is None else b.to(x.dtype))


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """LayerNorm over the last axis."""
    return F.layer_norm(x, (x.shape[-1],), gamma, beta, eps)


def embedding(table, ids):
    """table: (V, C); ids: integer tensor."""
    return F.embedding(ids, table)


def sequence_mask(lengths, max_length: int):
    """(B,) lengths -> (B, T) bool mask. Reference commons.py:43-46."""
    pos = torch.arange(max_length, device=lengths.device)[None, :]
    return pos < lengths[:, None]


def fused_gate(x, g):
    """WaveNet gated activation: tanh(a) * sigmoid(b), [a, b] =
    split(x + g) over the LAST axis.  Reference commons.py:35-41."""
    a, b = torch.chunk(x + g, 2, dim=-1)
    return torch.tanh(a) * torch.sigmoid(b)


def weight_norm_w(g, v):
    """Materialize a weight-normalized kernel: w = g * v / ||v||, the norm
    over every axis but the output channels (axis 0 of torch's conv
    layouts; torch weight_norm(dim=0)).  The discriminators keep (g, v)
    live during training."""
    norm = torch.sqrt(torch.sum(torch.square(v), dim=tuple(range(1, v.dim())),
                                keepdim=True))
    return g * v / norm


def slice_segments(x, ids_str, segment_size: int):
    """Per-sample time slices x[b, s_b : s_b + segment_size].

    x: (B, T, ...); ids_str: (B,) start indices.  A start is taken as
    jax.lax.dynamic_slice_in_dim takes it: a negative one counts from
    the end (+T), then it is clamped to [0, T - segment_size], so padded
    batches whose lengths are near or below segment_size never read past
    the end.  Reference commons.py:14-25."""
    t = x.shape[1]
    start = ids_str.to(torch.int64)
    start = torch.clamp(torch.where(start < 0, start + t, start), 0, t - segment_size)
    idx = start[:, None] + torch.arange(segment_size, device=x.device)[None, :]
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]
