"""Multi-period discriminator and the GAN / KL losses of the reference:
a frozen copy of the port's `models/discriminator.py`.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from .nn import LRELU_SLOPE, leaky_relu, weight_norm_w

Params = Any

PERIODS_V1 = (2, 3, 5, 7, 11, 17)
PERIODS_V2 = (2, 3, 5, 7, 11, 17, 23, 37)


def periods_for(version: str):
    return PERIODS_V2 if version == "v2" else PERIODS_V1


def s_convs(width_div: int = 1):
    """DiscriminatorS conv ladder: (cin, cout, k, stride, groups, pad).
    width_div > 1 shrinks channels and groups for small test configs (1
    is the reference architecture)."""
    def c(x):
        return max(x // width_div, 1)
    return (
        (1, c(16), 15, 1, 1, 7),
        (c(16), c(64), 41, 4, c(4), 20),
        (c(64), c(256), 41, 4, c(16), 20),
        (c(256), c(1024), 41, 4, c(64), 20),
        (c(1024), c(1024), 41, 4, c(256), 20),
        (c(1024), c(1024), 5, 1, 1, 2),
    )


def p_channels(width_div: int = 1):
    """DiscriminatorP ladder (kernel (5, 1), stride (3, 1), pad (2, 0))."""
    def c(x):
        return max(x // width_div, 1)
    return ((1, c(32)), (c(32), c(128)), (c(128), c(512)),
            (c(512), c(1024)), (c(1024), c(1024)))


def _wn_conv1d(x, p, *, stride=1, groups=1, padding=0):
    return F.conv1d(x, weight_norm_w(p["g"], p["v"]), p["b"], stride=stride,
                    groups=groups, padding=padding)


def _wn_conv2d_t1(x, p, *, stride: int):
    """Conv2d with a (k, 1) kernel over (time / period, period)."""
    w = weight_norm_w(p["g"], p["v"])                 # (Cout, Cin, k, 1)
    return F.conv2d(x, w, p["b"], stride=(stride, 1),
                    padding=((w.shape[2] - 1) // 2, 0))


def disc_s_apply(p: Params, x, width_div: int = 1):
    """x: (B, T, 1) waveform.  Returns (logits (B, n), fmaps (B, C, T'))."""
    x = x.transpose(1, 2)
    fmap = []
    for cp, (_, _, _, s, g, pad) in zip(p["convs"], s_convs(width_div)):
        x = leaky_relu(_wn_conv1d(x, cp, stride=s, groups=g, padding=pad),
                       LRELU_SLOPE)
        fmap.append(x)
    x = _wn_conv1d(x, p["post"], padding=1)
    fmap.append(x)
    return x.flatten(1), fmap


def disc_p_apply(p: Params, x, period: int):
    """x: (B, T, 1).  Reflect-pad T to a multiple of the period and fold
    the period into a second spatial axis (reference train.py:665-667).
    Returns (logits (B, n), fmaps (B, C, T', period))."""
    b, t, _ = x.shape
    x = x.transpose(1, 2)
    if t % period != 0:
        pad = period - (t % period)
        x = F.pad(x, (0, pad), mode="reflect")
        t = t + pad
    x = x.reshape(b, 1, t // period, period)
    fmap = []
    for cp in p["convs"]:
        x = leaky_relu(_wn_conv2d_t1(x, cp, stride=3), LRELU_SLOPE)
        fmap.append(x)
    x = _wn_conv2d_t1(x, p["post"], stride=1)
    fmap.append(x)
    return x.flatten(1), fmap


def mpd_apply(params: Params, y, y_hat, periods=PERIODS_V2, width_div: int = 1):
    """All discriminators on real and generated waveforms (B, T, 1).
    Returns (y_d_rs, y_d_gs, fmap_rs, fmap_gs)."""
    y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
    for apply, p, arg in [(disc_s_apply, params["s"], width_div)] + [
            (disc_p_apply, dp, period) for dp, period in zip(params["p"], periods)]:
        lr, fr = apply(p, y, arg)
        lg, fg = apply(p, y_hat, arg)
        y_d_rs.append(lr)
        fmap_rs.append(fr)
        y_d_gs.append(lg)
        fmap_gs.append(fg)
    return y_d_rs, y_d_gs, fmap_rs, fmap_gs


# ---------------------------------------------------------------------------
# losses (reference train.py:286-325)
# ---------------------------------------------------------------------------

def feature_loss(fmap_r, fmap_g):
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.detach() - gl))
    return loss * 2.0


def discriminator_loss(disc_real, disc_gen):
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real, disc_gen):
        r = torch.mean(torch.square(1.0 - dr))
        g = torch.mean(torch.square(dg))
        loss = loss + r + g
        r_losses.append(r)
        g_losses.append(g)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs):
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        l = torch.mean(torch.square(1.0 - dg))
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses


def kl_loss(z_p, logs_q, m_p, logs_p, z_mask, mask_sum=None):
    """KL(q || p) between the flowed posterior and the prior (train.py:
    317-325).  All (B, T, C) except z_mask (B, T, 1).  mask_sum: the
    denominator, sum(z_mask) unless given (a rank of a sharded step gives
    the global batch's, so that the ranks' terms sum to the global KL)."""
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * torch.square(z_p - m_p) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / (torch.sum(z_mask) if mask_sum is None else mask_sum)
