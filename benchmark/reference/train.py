"""One training step of the reference: the port's `pipelines/train.py`
`make_train_step` in fp32 on one process, in plain PyTorch, in the
reference toolkit's order (train.py:541-606, 286-325): the generator's
forward on the given noise, the discriminators' step on the detached
output and their AdamW update, then the generator's losses (mel L1 x
c_mel, KL x c_kl, feature matching, adversarial) against the updated
discriminators, its gradients and its AdamW update.
"""

from __future__ import annotations

import torch

from . import discriminator as disc
from . import synthesizer as syn
from .nn import slice_segments
from .stft import mel_spectrogram, spec_to_mel


def leaves(tree) -> list:
    """Tensors of a nested dict / list tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def trainable(tree):
    if isinstance(tree, dict):
        return {k: trainable(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [trainable(v) for v in tree]
    return tree.detach().to(torch.float32).clone().requires_grad_(True)


def optimizer(tree, train: dict) -> torch.optim.AdamW:
    return torch.optim.AdamW(leaves(tree), lr=train["learning_rate"],
                             betas=tuple(train["betas"]), eps=train["eps"],
                             weight_decay=train["weight_decay"])


def _apply(opt, params, grads):
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


def step(cfg, data: dict, train: dict, params_g, params_d, opt_g, opt_d, batch: dict,
         noise: dict) -> dict:
    """One step in place.  batch: phone, phone_lengths, pitch, pitchf,
    spec, spec_lengths, wave, sid; noise: post_noise, ids_slice,
    dec_noise.  Returns the loss terms and the gradients (leaf order)."""
    lg, ld = leaves(params_g), leaves(params_d)
    y_hat, ids_slice, _, y_mask, (_, z_p, m_p, logs_p, m_q, logs_q) = syn.train_forward(
        params_g, cfg, batch["phone"], batch["phone_lengths"], batch["pitch"],
        batch["pitchf"], batch["spec"], batch["spec_lengths"], batch["sid"],
        post_noise=noise["post_noise"], ids_slice=noise["ids_slice"],
        dec_noise=noise["dec_noise"])
    hop, seg = data["hop_length"], train["segment_size"]
    wave_slice = slice_segments(batch["wave"], ids_slice * hop, seg)
    y_d_r, y_d_g, _, _ = disc.mpd_apply(params_d, wave_slice, y_hat.detach())
    loss_d = disc.discriminator_loss(y_d_r, y_d_g)[0]
    grads_d = torch.autograd.grad(loss_d, ld)
    _apply(opt_d, ld, grads_d)

    mel = spec_to_mel(batch["spec"], n_fft=data["filter_length"],
                      n_mels=data["n_mel_channels"], sample_rate=data["sample_rate"],
                      fmin=data["mel_fmin"], fmax=data["mel_fmax"])
    y_mel = slice_segments(mel, ids_slice, seg // hop)
    y_hat_mel = mel_spectrogram(y_hat[:, :, 0], n_fft=data["filter_length"],
                                num_mels=data["n_mel_channels"],
                                sample_rate=data["sample_rate"], hop_length=hop,
                                win_length=data["win_length"], fmin=data["mel_fmin"],
                                fmax=data["mel_fmax"])
    _, y_d_g, fmap_r, fmap_g = disc.mpd_apply(params_d, wave_slice, y_hat)
    loss_mel = torch.mean(torch.abs(y_mel - y_hat_mel)) * train["c_mel"]
    loss_kl = disc.kl_loss(z_p, logs_q, m_p, logs_p, y_mask) * train["c_kl"]
    loss_fm = disc.feature_loss(fmap_r, fmap_g)
    loss_adv = disc.generator_loss(y_d_g)[0]
    loss_g = loss_adv + loss_fm + loss_mel + loss_kl
    grads_g = torch.autograd.grad(loss_g, lg)
    _apply(opt_g, lg, grads_g)
    return {"loss_g": loss_g.detach(), "loss_d": loss_d.detach(), "grads_g": grads_g,
            "grads_d": grads_d}
