"""GAN training step in PyTorch.

Counterpart of `rvc_maker_tpu/pipelines/train.py` (reference
train.py:746-986): per batch a D step, then a G step against the
updated D; AdamW(0.8, 0.99, eps 1e-9, weight decay 0.01), the learning
rate decayed 0.999875 per epoch; G loss = LSGAN adversarial + 2x
feature matching + 45x mel L1 + 1x KL.

The step keeps the JAX package's shared-forward structure: ONE generator
forward; the D step on y_hat.detach(); the G loss against the updated D;
ONE backward through the generator.  The state is updated in place
(parameters, AdamW moments, step), the PyTorch idiom, where the JAX step
returns a new state.  Noise (the posterior noise, the slice ids, the
decoder's noise) comes in explicitly or is drawn from the state's
torch.Generator, whose state a checkpoint keeps for an exact resume.

Every decoder trains (NSF, f0-less, MRF-HiFi-GAN, RefineGAN), in fp32 or
in the JAX package's bf16 mode, with or without checkpointed forwards
(`make_train_step`).

Each part of the step runs under a torch.profiler range: train.g_forward,
train.d_step, train.g_loss, train.g_backward, train.optim.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..config import RVCConfig
from ..device import resolve_device
from ..interop import from_jax
from ..models import discriminator as disc
from ..models import synthesizer as syn
from ..ops.nn import cast_floats, slice_segments
from ..ops.stft import mel_spectrogram, spec_to_mel
from ..parallel import distributed as dist_mod
from ..parallel.mesh import all_reduce_, replicate, rows_of

def tree_leaves(tree) -> list:
    """Tensors of a nested dict/list tree, in a fixed order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@dataclasses.dataclass(frozen=True)
class Batch:
    """One padded training batch (reference bucketed collate, train.py:
    541-606): numpy arrays from `data.batches_for_epoch`, or tensors."""
    phone: Any          # (B, T, emb_dim), features repeated x2 in time
    phone_lengths: Any  # (B,)
    pitch: Any          # (B, T) int coarse f0
    pitchf: Any         # (B, T) Hz
    spec: Any           # (B, T, spec_channels)
    spec_lengths: Any   # (B,)
    wave: Any           # (B, T * hop, 1)
    sid: Any            # (B,)

    def to(self, device, half: Optional[torch.dtype] = None, *,
           half_spec: bool = False) -> "Batch":
        """The batch as tensors on `device`.  half: phone and wave cast to
        it on the host before the copy (the bf16 step casts them anyway,
        and the copy halves; JAX train_loop.py:316-330).  half_spec: spec
        cast to `half` too (the loop's RVC_TPU_BF16_SPEC=1, JAX
        train_loop.py:331-341); the mel target then comes from the rounded
        values."""
        def conv(a, dtype):
            a = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
            return a.to(dtype).to(device)
        f, i = torch.float32, torch.int64
        return Batch(phone=conv(self.phone, half or f),
                     phone_lengths=conv(self.phone_lengths, i),
                     pitch=conv(self.pitch, i), pitchf=conv(self.pitchf, f),
                     spec=conv(self.spec, half if half_spec and half else f),
                     spec_lengths=conv(self.spec_lengths, i),
                     wave=conv(self.wave, half or f), sid=conv(self.sid, i))


@dataclasses.dataclass
class TrainState:
    step: int
    params_g: Any
    params_d: Any
    opt_g: torch.optim.AdamW
    opt_d: torch.optim.AdamW
    lr: float                     # current learning rate (decayed per epoch)
    generator: torch.Generator    # draws the step's noise when none is given


def make_optimizer(params, cfg: RVCConfig) -> torch.optim.AdamW:
    """torch.optim.AdamW with weight decay 0.01: the decoupled decay of
    optax.adamw, which the JAX package uses."""
    t = cfg.train
    return torch.optim.AdamW(tree_leaves(params), lr=t.learning_rate, betas=t.betas,
                             eps=t.eps, weight_decay=0.01)


def _trainable(tree, device: torch.device):
    """A copy of a param tree on `device` in fp32, every tensor a fresh
    leaf that requires grad (the caller's tree is left as it was)."""
    if isinstance(tree, dict):
        return {k: _trainable(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_trainable(v, device) for v in tree)
    return tree.detach().to(device=device, dtype=torch.float32,
                            copy=True).requires_grad_(True)


def init_state(cfg: RVCConfig, params_g=None, params_d=None, *,
               device: torch.device | str = "cuda", disc_width_div: int = 1,
               seed: Optional[int] = None) -> TrainState:
    """A fresh training state on `device`.  params_g / params_d are the
    port's trees (generator with `enc_q`); absent ones are drawn from
    `seed` (default cfg.train.seed) like the JAX package's init.
    device="cuda" raises when no card is present."""
    seed = cfg.train.seed if seed is None else seed
    if params_g is None:
        params_g = from_jax.synthesizer_from_jax(
            from_jax.random_synthesizer_tree(cfg.model, seed), cfg.model, train=True)
    if params_d is None:
        params_d = from_jax.discriminator_from_jax(
            from_jax.random_discriminator_tree(cfg.version, disc_width_div, seed + 1))
    device = resolve_device(device)
    trees = [_trainable(tree, device) for tree in (params_g, params_d)]
    return TrainState(step=0, params_g=trees[0], params_d=trees[1],
                      opt_g=make_optimizer(trees[0], cfg),
                      opt_d=make_optimizer(trees[1], cfg),
                      lr=cfg.train.learning_rate,
                      generator=torch.Generator(device=device).manual_seed(seed + 777))


def decay_lr(state: TrainState, cfg: RVCConfig) -> None:
    """Per-epoch exponential decay (reference train.py:796)."""
    state.lr = state.lr * cfg.train.lr_decay


def _global_norm(grads):
    return torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))


def _apply(opt: torch.optim.AdamW, leaves, grads, lr: float) -> None:
    for leaf, g in zip(leaves, grads):
        leaf.grad = g
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    for leaf in leaves:
        leaf.grad = None


class RangeTimer:
    """CUDA events at the edges of each training range, on the current
    stream: device milliseconds per range, including the backward that
    autograd runs on its own thread, which a torch.profiler range on the
    calling thread does not hold.  A range's device span counts the time
    the device waits for the host inside it; the host clock per range is
    kept beside it."""

    def __init__(self):
        self.events: list[tuple[str, Any, Any, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        yield
        end.record()
        self.events.append((name, start, end, 1e3 * (time.perf_counter() - t0)))

    def ms(self) -> tuple[dict, dict]:
        """(device ms, host ms) per range name."""
        torch.cuda.synchronize()
        device: dict = {}
        host: dict = {}
        for name, start, end, host_ms in self.events:
            device[name] = device.get(name, 0.0) + start.elapsed_time(end)
            host[name] = host.get(name, 0.0) + host_ms
        return device, host


def _cast_batch(batch: Batch, dtype: torch.dtype) -> Batch:
    """The batch's float fields (phone, pitchf, spec, wave) in dtype; the
    int fields as they are (JAX `cast_floats` of the Batch pytree)."""
    return dataclasses.replace(batch, phone=batch.phone.to(dtype),
                               pitchf=batch.pitchf.to(dtype),
                               spec=batch.spec.to(dtype), wave=batch.wave.to(dtype))


def _checkpointed(fn):
    """fn under torch.utils.checkpoint: its activations are dropped after
    the forward and recomputed in the backward (JAX `jax.checkpoint`).
    Nothing inside draws random numbers (the step draws its noise first),
    so no RNG state is stashed."""
    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return run


def make_train_step(cfg: RVCConfig, disc_width_div: int = 1, *, sharded: bool = False):
    """Returns train_step(state, batch, *, noise=None, timer=None,
    keep_grads=False) -> metrics, which updates `state` in place.

    batch: a Batch of tensors on the state's device.  noise: optional
    dict with post_noise, ids_slice and dec_noise (see
    synthesizer.train_noise); what it lacks is drawn from the state's
    generator before the forward.  timer: a RangeTimer.
    keep_grads adds the gradient lists `grads_g` and `grads_d` (in
    tree_leaves order) to the metrics.

    cfg.train.remat runs the generator forward and each discriminator
    application under torch.utils.checkpoint, recomputed in the backward
    (JAX train.py:145-147; the reference's --checkpointing).
    cfg.train.bf16 is the JAX package's mixed precision
    (train.py:111-118): fp32 master params and AdamW state; the params and
    the batch's floats are cast to bf16 inside the differentiated
    functions, so the gradients land in fp32; the posterior noise and the
    decoder's normals are drawn in bf16; the mel and KL losses compute in
    fp32 (the mel target from the spec in fp32, a bf16-fed spec too), the
    sine phases stay fp32; no loss scaling.

    sharded: each rank of the process group holds its rows of the global
    batch (`make_sharded_train_step`)."""
    mcfg, dcfg, tcfg = cfg.model, cfg.data, cfg.train
    rank, world = ((dist_mod.process_index(), dist_mod.process_count()) if sharded
                   else (0, 1))
    # the sum over the ranks (a one-process step sums nothing, even in a
    # process that is one rank of a group)
    reduce = all_reduce_ if world > 1 else list
    half = torch.bfloat16 if tcfg.bf16 else None
    seg_frames = tcfg.segment_size // dcfg.hop_length
    periods = disc.periods_for(cfg.version)

    def forward_g(params_g, batch: Batch, noise: dict):
        if half is not None:
            params_g, batch = cast_floats(params_g, half), _cast_batch(batch, half)
        y_hat, _, _, y_mask, latents = syn.train_forward(
            params_g, mcfg, batch.phone, batch.phone_lengths,
            batch.pitch if mcfg.use_f0 else None, batch.pitchf, batch.spec,
            batch.spec_lengths, batch.sid, **noise)
        if half is not None:      # the KL loss and its mask in fp32
            latents = tuple(v.float() for v in latents)
            y_mask = y_mask.float()
        return y_hat, y_mask, latents

    def mpd(params_d, wave_slice, y_hat):
        if half is not None:
            params_d = cast_floats(params_d, half)
            wave_slice, y_hat = wave_slice.to(half), y_hat.to(half)
        out = disc.mpd_apply(params_d, wave_slice, y_hat, periods, disc_width_div)
        return out if half is None else cast_floats(out, torch.float32)

    if tcfg.remat:
        forward_g, mpd = _checkpointed(forward_g), _checkpointed(mpd)

    def train_step(state: TrainState, batch: Batch, *, noise: Optional[dict] = None,
                   timer: Optional[RangeTimer] = None, keep_grads: bool = False):
        leaves_g = tree_leaves(state.params_g)
        leaves_d = tree_leaves(state.params_d)
        noise = noise or {}
        n_rows = batch.spec.shape[0] * world
        # this rank's share of each row mean over the global batch
        share = 1.0 / world
        with _range("train.g_forward", timer):
            noise = syn.train_noise(mcfg, batch.spec, batch.spec_lengths, state.generator,
                                    dtype=half, rows=rows_of(n_rows, rank, world),
                                    n_rows=n_rows, **noise)
            y_hat, y_mask, latents = forward_g(state.params_g, batch, noise)
            ids_slice = noise["ids_slice"]
            wave_slice = slice_segments(batch.wave, ids_slice * dcfg.hop_length,
                                        tcfg.segment_size)

        with _range("train.d_step", timer):
            y_d_r, y_d_g, _, _ = mpd(state.params_d, wave_slice, y_hat.detach())
            loss_d = disc.discriminator_loss(y_d_r, y_d_g)[0] * share
            grads_d = torch.autograd.grad(loss_d, leaves_d)
            with _range("train.all_reduce", timer):
                grads_d = reduce(grads_d)
            _apply(state.opt_d, leaves_d, grads_d, state.lr)

        with _range("train.g_loss", timer):
            _, z_p, m_p, logs_p, m_q, logs_q = latents
            mel = spec_to_mel(batch.spec.float(), n_fft=dcfg.filter_length,
                              n_mels=dcfg.n_mel_channels, sample_rate=dcfg.sample_rate,
                              fmin=dcfg.mel_fmin, fmax=dcfg.mel_fmax)
            y_mel = slice_segments(mel, ids_slice, seg_frames)
            y_hat_mel = mel_spectrogram(
                y_hat[:, :, 0], n_fft=dcfg.filter_length,
                num_mels=dcfg.n_mel_channels, sample_rate=dcfg.sample_rate,
                hop_length=dcfg.hop_length, win_length=dcfg.win_length,
                fmin=dcfg.mel_fmin, fmax=dcfg.mel_fmax)
            _, y_d_g, fmap_r, fmap_g = mpd(state.params_d, wave_slice, y_hat)
            loss_mel = torch.mean(torch.abs(y_mel - y_hat_mel)) * tcfg.c_mel * share
            # KL divides by the mask's sum over the global batch
            mask_sum = reduce([y_mask.detach().sum()])[0]
            loss_kl = disc.kl_loss(z_p, logs_q, m_p, logs_p, y_mask, mask_sum) * tcfg.c_kl
            loss_fm = disc.feature_loss(fmap_r, fmap_g) * share
            loss_adv = disc.generator_loss(y_d_g)[0] * share
            loss_g = loss_adv + loss_fm + loss_mel + loss_kl

        with _range("train.g_backward", timer):
            grads_g = torch.autograd.grad(loss_g, leaves_g)
        with _range("train.all_reduce", timer):
            grads_g = reduce(grads_g)

        with _range("train.optim", timer):
            _apply(state.opt_g, leaves_g, grads_g, state.lr)
            # every rank returns the global batch's values
            losses = reduce([torch.stack([v.detach().float() for v in (
                loss_g, loss_d, loss_mel, loss_kl, loss_fm, loss_adv)])])[0]
            metrics = dict(zip(("loss_g", "loss_d", "loss_mel", "loss_kl", "loss_fm",
                                "loss_adv"), losses.unbind()),
                           grad_norm_g=_global_norm(grads_g),
                           grad_norm_d=_global_norm(grads_d), lr=state.lr)
        state.step += 1
        if keep_grads:
            metrics.update(grads_g=list(grads_g), grads_d=list(grads_d))
        return metrics

    return train_step


def make_sharded_train_step(cfg: RVCConfig, disc_width_div: int = 1):
    """The train step of one rank of the process group (JAX
    `make_sharded_train_step`, whose batch XLA shards over a mesh): the
    batch holds this rank's rows of the global batch (`data.
    batches_for_epoch(rank=, num_replicas=)`), the parameters and
    optimizer state are the same on every rank (`replicate_state`), and
    the step equals one process's step on the global batch:

      * the noise is the global batch's, drawn from the state's generator
        (the same on every rank) or given for the global batch, and each
        rank keeps its rows;
      * every row-mean loss term is weighted by this rank's share of the
        rows, and KL divides by the mask's sum over all ranks, so the
        ranks' terms sum to the global losses;
      * the gradients are summed over the ranks (one all-reduce per dtype
        for D, one for G), then the norms and AdamW read the sums, so the
        parameters stay equal on every rank;
      * the returned losses are the global batch's.

    The step takes gradients with torch.autograd.grad, which
    DistributedDataParallel's hooks would not see; the reduction is the
    explicit counterpart of XLA's psum.  In a single process it is
    `make_train_step`."""
    return make_train_step(cfg, disc_width_div, sharded=True)


def replicate_state(state: TrainState) -> None:
    """Every rank takes rank 0's state (JAX `replicate`): parameters,
    AdamW moments and step counters, the step, the learning rate and the
    noise generator's state."""
    if dist_mod.process_count() == 1:
        return
    tensors = tree_leaves(state.params_g) + tree_leaves(state.params_d)
    for opt in (state.opt_g, state.opt_d):
        for group in opt.param_groups:
            for p in group["params"]:
                tensors += [v for v in opt.state.get(p, {}).values()
                            if isinstance(v, torch.Tensor)]
    gen = state.generator.get_state()
    scalars = torch.tensor([state.step, state.lr], dtype=torch.float64)
    replicate(tensors + [gen, scalars])
    state.generator.set_state(gen)
    state.step, state.lr = int(scalars[0]), float(scalars[1])


@contextlib.contextmanager
def _range(name: str, timer: Optional[RangeTimer]):
    """A torch.profiler range, timed by `timer` when one is given."""
    with record_function(name), (timer(name) if timer is not None
                                 else contextlib.nullcontext()):
        yield
