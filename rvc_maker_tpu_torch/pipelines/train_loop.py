"""Epoch loop, checkpoint / exact resume, and inference-weight export.

Counterpart of `rvc_maker_tpu/pipelines/train_loop.py` (reference
train.py run / train_and_evaluate), for every decoder and in fp32 or
bf16, with or without checkpointed forwards (cfg.train.bf16 / remat), on
one device or on every rank of the process group that the environment
describes (`parallel/distributed.py`): per-epoch learning rate decay, a
`ckpt_latest.pt` checkpoint (and `ckpt_e{N}.pt` unless
save_only_latest), the interchange `.pth` exported
at save epochs, the overtraining detector on EMA-smoothed losses with its
JSON, metrics logged every `log_interval` steps (to TensorBoard under
`tb/` unless the caller gives a log_writer, with a generated sample and
its mel image at save epochs).  SIGTERM saves and stops; across ranks a
MAX all-reduce of the stop flag after every step (and before the save
decision) takes all of them out at the same step, wherever the signal
landed (the JAX loop stops only the signalled process).

The checkpoint holds G, D, both AdamW states, the step, the learning
rate and the state of the generator that draws the step noise, so a
resumed run continues exactly where the saved one stopped.

Across ranks each rank trains on its device (`rank_device`) on its rows
of every global batch with the sharded step, which keeps the parameters
equal on every rank; every rank starts from rank 0's state (after the
init, a pretrained load or a resume) and resumes from the same
checkpoint; only rank 0 writes (cleanup, TensorBoard, checkpoints, the
`.pth`, the overtraining detector's JSON), between barriers; the step's
losses are the global batch's, so every rank takes the same overtraining
decision.

RVC_TPU_RESUME_HASH (set) logs the restored params' sha256 on a resume;
RVC_TPU_BF16_SPEC=1 feeds a bf16 run's spectrogram in bf16.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import signal
import threading
import time
from typing import Callable, Optional

import torch

from ..config import RVCConfig
from ..interop.pth import export_synthesizer_pth, load_pretrained_d, load_pretrained_g
from ..models import synthesizer as syn
from ..ops.stft import mel_spectrogram
from ..parallel import distributed as dist_mod
from . import data as data_mod
from . import train as train_mod

logger = logging.getLogger(__name__)

LATEST = "ckpt_latest.pt"


def save_checkpoint(state: train_mod.TrainState, path: str, *, epoch: int = 0) -> None:
    torch.save({"epoch": epoch, "step": state.step, "lr": state.lr,
                "params_g": state.params_g, "params_d": state.params_d,
                "opt_g": state.opt_g.state_dict(), "opt_d": state.opt_d.state_dict(),
                "generator": state.generator.get_state()}, path)


def params_hash(params) -> str:
    """sha256 over a param tree's leaves in `train.tree_leaves` order,
    each moved to the CPU, contiguous, as raw bytes."""
    h = hashlib.sha256()
    for leaf in train_mod.tree_leaves(params):
        h.update(leaf.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


def state_params_hash(state: train_mod.TrainState) -> str:
    """sha256 of params_g (JAX `state_params_hash`): a resumed run logs it
    under RVC_TPU_RESUME_HASH, and `params_hash(torch.load(ckpt)
    ["params_g"])` in another process gives the same digest when the
    restore is exact.  The leaves lie in the port's layouts, so the
    digest is not the JAX package's."""
    return params_hash(state.params_g)


def load_checkpoint(path: str, state: train_mod.TrainState) -> int:
    """Restore a checkpoint into `state` (same config and device) in
    place.  Returns the epoch it was saved at."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    with torch.no_grad():
        for key in ("params_g", "params_d"):
            for dst, src in zip(train_mod.tree_leaves(getattr(state, key)),
                                train_mod.tree_leaves(ckpt[key]), strict=True):
                dst.copy_(src)
    state.opt_g.load_state_dict(ckpt["opt_g"])
    state.opt_d.load_state_dict(ckpt["opt_d"])
    state.step, state.lr = int(ckpt["step"]), float(ckpt["lr"])
    state.generator.set_state(ckpt["generator"])
    return int(ckpt["epoch"])


class OvertrainingDetector:
    """EMA-smoothed generator and discriminator loss watcher with JSON
    persistence (reference train.py:899-953).  The discriminator has
    twice the generator's window and a tighter epsilon (0.004 vs 0.01);
    training stops when either side's count of consecutive flagged
    epochs reaches its window."""

    def __init__(self, threshold_g: int = 50, smoothing: float = 0.987):
        self.smoothing = smoothing
        self.threshold_g = threshold_g
        self.loss_gen_history: list[float] = []
        self.smoothed_gen: list[float] = []
        self.loss_disc_history: list[float] = []
        self.smoothed_disc: list[float] = []
        self.consecutive_gen = 0
        self.consecutive_disc = 0

    @staticmethod
    def _check(history: list[float], threshold: int, epsilon: float) -> bool:
        """Any uptick in the window -> overtraining; any real improvement
        -> fine; a flat window -> overtraining (train.py:899-904)."""
        if len(history) < threshold + 1:
            return False
        for i in range(-threshold, -1):
            if history[i + 1] > history[i]:
                return True
            if abs(history[i + 1] - history[i]) >= epsilon:
                return False
        return True

    def _ema(self, history: list[float], new_value: float) -> float:
        s = (new_value if not history
             else self.smoothing * history[-1] + (1 - self.smoothing) * new_value)
        history.append(s)
        return s

    def update(self, loss_g: float, loss_d: float) -> bool:
        self.loss_gen_history.append(float(loss_g))
        self._ema(self.smoothed_gen, float(loss_g))
        self.loss_disc_history.append(float(loss_d))
        self._ema(self.smoothed_disc, float(loss_d))
        self.consecutive_gen = (self.consecutive_gen + 1 if self._check(
            self.smoothed_gen, self.threshold_g, 0.01) else 0)
        self.consecutive_disc = (self.consecutive_disc + 1 if self._check(
            self.smoothed_disc, self.threshold_g * 2, 0.004) else 0)
        return (self.consecutive_gen == self.threshold_g
                or self.consecutive_disc == self.threshold_g * 2)

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"loss_disc_history": self.loss_disc_history,
                       "smoothed_loss_disc_history": self.smoothed_disc,
                       "loss_gen_history": self.loss_gen_history,
                       "smoothed_loss_gen_history": self.smoothed_gen}, f)

    def load_json(self, path: str) -> None:
        if not os.path.isfile(path):
            return
        with open(path) as f:
            d = json.load(f)
        self.loss_disc_history = list(d.get("loss_disc_history", []))
        self.smoothed_disc = list(d.get("smoothed_loss_disc_history", []))
        self.loss_gen_history = list(d.get("loss_gen_history", []))
        self.smoothed_gen = list(d.get("smoothed_loss_gen_history", []))


def train(exp_dir: str, cfg: RVCConfig, *, total_epochs: int, batch_size: int = 8,
          save_every_epoch: int = 5, save_only_latest: bool = True,
          pretrain_g: str = "", pretrain_d: str = "", author: str = "",
          model_name: str = "", overtraining_detector: bool = True,
          overtraining_threshold: int = 50, save_every_weights: bool = True,
          cache_data: bool = False, cleanup: bool = False,
          log_writer: Optional[Callable[[int, dict], None]] = None,
          device: str | torch.device = "cuda",
          disc_width_div: int = 1) -> train_mod.TrainState:
    """Train from the experiment dir (expects filelist.txt).

    pretrain_g / pretrain_d: reference-format pretrained checkpoints,
    the initialization when no checkpoint exists to resume (reference
    train.py:778-794); otherwise the weights are drawn from
    cfg.train.seed.  author / model_name go into the exported weights;
    save_every_weights=False exports them only at the end.
    log_writer(step, metrics) is called every cfg.train.log_interval
    steps.  device="cuda" raises without a card.

    Under the environment contract of `parallel/distributed.py` this
    process is one rank: batch_size is its rows (the global batch is
    batch_size x ranks, as JAX's is batch_size x devices) and "cuda"
    means this rank's card (`rank_device`)."""
    dist_mod.ensure_initialized(device)
    rank, world = dist_mod.process_index(), dist_mod.process_count()
    primary = rank == 0
    dev = dist_mod.rank_device(device)
    if cleanup and primary:
        shutil.rmtree(os.path.join(exp_dir, "tb"), ignore_errors=True)
        for f in os.listdir(exp_dir) if os.path.isdir(exp_dir) else []:
            if f.startswith("ckpt_") or f.endswith("s.pth"):
                os.remove(os.path.join(exp_dir, f))
    dist_mod.sync_global("cleanup")    # no rank looks for a checkpoint before it

    dataset = data_mod.TrainingDataset(os.path.join(exp_dir, "filelist.txt"), cfg,
                                       cache_in_memory=cache_data)
    logger.info("dataset: %d rows; device %s; rank %d of %d", len(dataset), dev, rank,
                world)

    tb = None
    if log_writer is None and primary:
        from .tb_logging import TensorBoardLogger

        tb = TensorBoardLogger(os.path.join(exp_dir, "tb"))

        def log_writer(step, metrics):
            tb.scalars(step, {f"loss/{k}" if k.startswith("loss") else k: v
                              for k, v in metrics.items()})
            tb.flush()

    latest = os.path.join(exp_dir, LATEST)
    resume = os.path.isfile(latest)
    params_g = (load_pretrained_g(pretrain_g, cfg.model)
                if pretrain_g and not resume else None)
    params_d = (load_pretrained_d(pretrain_d, cfg.version)
                if pretrain_d and not resume else None)
    state = train_mod.init_state(cfg, params_g, params_d, device=dev,
                                 disc_width_div=disc_width_div)
    start_epoch = 1
    if resume:
        start_epoch = load_checkpoint(latest, state) + 1
        logger.info("resumed from %s at step %d (epoch %d)", latest, state.step,
                    start_epoch - 1)
        if os.environ.get("RVC_TPU_RESUME_HASH"):
            # the restored state's digest, which another process computes
            # from the file on disk to show the restore exact
            logger.info("resume params_g sha256=%s step=%d", state_params_hash(state),
                        state.step)
    train_mod.replicate_state(state)

    step_fn = train_mod.make_sharded_train_step(cfg, disc_width_div)
    detector = OvertrainingDetector(threshold_g=overtraining_threshold)
    training_json = os.path.join(exp_dir, "training_data.json")
    detector.load_json(training_json)

    stop = {"now": False}

    def _sigterm(signum, frame):
        logger.warning("SIGTERM: saving a checkpoint and stopping")
        stop["now"] = True

    # signal.signal raises off the main thread; only the main thread
    # registers the handler
    on_main = threading.current_thread() is threading.main_thread()
    old_handler = signal.signal(signal.SIGTERM, _sigterm) if on_main else None
    half = torch.bfloat16 if cfg.train.bf16 else None
    # the bf16 spec feed of a bf16 run (JAX train_loop.py:331-341), off by default
    half_spec = half is not None and os.environ.get("RVC_TPU_BF16_SPEC", "0") == "1"
    try:
        for epoch in range(start_epoch, total_epochs + 1):
            t0 = time.time()
            n_batches = 0
            metrics = None
            for batch in data_mod.batches_for_epoch(
                    dataset, batch_size=batch_size * world, epoch=epoch,
                    seed=cfg.train.seed, rank=rank, num_replicas=world):
                batch = batch.to(dev, half, half_spec=half_spec)
                metrics = step_fn(state, batch)
                n_batches += 1
                if state.step % cfg.train.log_interval == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    logger.info("epoch %d step %d: %s", epoch, state.step,
                                {k: round(v, 4) for k, v in m.items()})
                    if log_writer is not None:
                        log_writer(state.step, m)
                if world > 1:
                    # a SIGTERM reaches one rank: every rank leaves at this step
                    stop["now"] = dist_mod.any_rank(stop["now"])
                if stop["now"]:
                    break
            train_mod.decay_lr(state, cfg)
            loss_g = float(metrics["loss_g"]) if n_batches else 0.0
            loss_d = float(metrics["loss_d"]) if n_batches else 0.0
            if overtraining_detector and epoch > 1 and detector.update(loss_g, loss_d):
                logger.warning("overtraining at epoch %d (smoothed loss_g %.3f, "
                               "loss_d %.3f): saving and stopping", epoch,
                               detector.smoothed_gen[-1], detector.smoothed_disc[-1])
                stop["now"] = True
            if overtraining_detector and primary:
                detector.save_json(training_json)
            logger.info("epoch %d done (%d batches, %.1f s) loss_g %.4f loss_d %.4f",
                        epoch, n_batches, time.time() - t0, loss_g, loss_d)
            # the ranks agree on stopping before they choose to save; a
            # signal after this point counts at the next step
            stopping = dist_mod.any_rank(stop["now"]) if world > 1 else stop["now"]
            if epoch % save_every_epoch == 0 or stopping or epoch == total_epochs:
                # the parameters are the same on every rank: rank 0 writes,
                # and no rank goes on before it has
                dist_mod.sync_global("pre-save")
                if primary:
                    save_checkpoint(state, latest, epoch=epoch)
                if primary and not save_only_latest:
                    save_checkpoint(state, os.path.join(exp_dir, f"ckpt_e{epoch}.pt"),
                                    epoch=epoch)
                if primary and (save_every_weights or epoch == total_epochs or stopping):
                    name = model_name or os.path.basename(os.path.normpath(exp_dir))
                    export_synthesizer_pth(
                        state.params_g, cfg,
                        os.path.join(exp_dir, f"{name}_{epoch}e_{state.step}s.pth"),
                        epoch=epoch, step=state.step, author=author)
                if tb is not None and n_batches:
                    _log_eval_sample(tb, state, cfg, batch, state.step)
                dist_mod.sync_global("post-save")
            if stopping:
                break
    finally:
        if on_main:
            signal.signal(signal.SIGTERM, old_handler)
        if tb is not None:
            tb.close()
    return state


def _log_eval_sample(tb, state: train_mod.TrainState, cfg: RVCConfig,
                     batch: train_mod.Batch, step: int) -> None:
    """The generated audio and its mel image for the first item of the
    last batch, every decoder on zero noise (reference train_and_evaluate
    eval block, train.py:883-895; JAX train_loop.py:418-452)."""
    try:
        m = cfg.model
        p = state.params_g
        with torch.inference_mode():
            phone = batch.phone[:1].float()
            t = phone.shape[1]
            lengths = torch.clamp(batch.phone_lengths[:1], max=t)
            pitch = batch.pitch[:1] if m.use_f0 else None
            z = torch.zeros((1, t, m.inter_channels), device=phone.device)
            noise = _zeros_like(syn.decoder_noise(m, 1, t, torch.Generator(phone.device),
                                                  phone.device))
            wav = syn.infer_any(p, m, phone, lengths, pitch, batch.pitchf[:1].float(),
                                batch.sid[:1], z, noise)[0, :, 0].float()
            mel = mel_spectrogram(wav[None], n_fft=cfg.data.filter_length,
                                  num_mels=cfg.data.n_mel_channels, sample_rate=m.sr,
                                  hop_length=cfg.data.hop_length,
                                  win_length=cfg.data.win_length, fmin=0.0, fmax=None)[0]
        tb.audio(step, "eval/generated", wav.cpu().numpy(), m.sr)
        tb.mel_image(step, "eval/mel_generated", mel.cpu().numpy())
        tb.flush()
    except Exception:  # noqa: BLE001 — eval logging must never kill training
        logger.exception("eval sample logging failed")


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros_like(v) for v in tree)
    return torch.zeros_like(tree)
