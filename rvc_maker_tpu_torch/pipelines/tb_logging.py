"""TensorBoard observability — scalars, mel images, generated audio.

A copy of `rvc_maker_tpu/pipelines/tb_logging.py` (the port imports
nothing of the JAX package).  Reference behavior (train.py:883-895,
summarize:244-255, plot_spectrogram_to_numpy:212-232): every
log_interval steps write the loss scalars + lr + grad norms, mel-spectrogram images of ground-truth
vs generated slices, and an inference sample on a fixed reference batch.
A separate launcher starts tensorboard over the experiment dir
(reference app/tensorboard.py).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional

import numpy as np

logger = logging.getLogger(__name__)


def plot_spectrogram_to_numpy(spectrogram: np.ndarray) -> np.ndarray:
    """(n_mels, T) -> HWC uint8 image (matplotlib, agg backend)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 2))
    im = ax.imshow(spectrogram, aspect="auto", origin="lower",
                   interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.xlabel("Frames")
    plt.ylabel("Channels")
    plt.tight_layout()
    fig.canvas.draw()
    data = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    data = data.reshape(fig.canvas.get_width_height()[::-1] + (4,))[:, :, :3]
    plt.close(fig)
    return data


class TensorBoardLogger:
    """Thin writer wrapper; degrades to a no-op if tensorboard is absent,
    and leaves the mel images out if matplotlib or PIL is."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.images = True
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.writer: Optional[Any] = SummaryWriter(log_dir=log_dir)
        except Exception as e:  # pragma: no cover
            from ..utils.i18n import tr

            logger.warning("%s", tr("tensorboard_unavailable", e=e))
            self.writer = None

    def scalars(self, step: int, values: dict) -> None:
        if self.writer is None:
            return
        for k, v in values.items():
            self.writer.add_scalar(k, float(v), step)

    def mel_image(self, step: int, tag: str, mel: np.ndarray) -> None:
        """mel: (T, n_mels) or (n_mels, T) log-mel."""
        if self.writer is None or not self.images:
            return
        if mel.shape[0] > mel.shape[1]:
            mel = mel.T
        try:
            self.writer.add_image(tag, plot_spectrogram_to_numpy(mel), step,
                                  dataformats="HWC")
        except ImportError as e:
            logger.warning("mel images left out: %s", e)
            self.images = False

    def audio(self, step: int, tag: str, wav: np.ndarray, sr: int) -> None:
        if self.writer is None:
            return
        self.writer.add_audio(tag, wav.reshape(1, -1), step, sample_rate=sr)

    def flush(self) -> None:
        if self.writer is not None:
            self.writer.flush()

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


def launch_tensorboard(logdir: str, port: int = 6006) -> str:
    """Programmatic tensorboard launcher (reference app/tensorboard.py)."""
    from tensorboard import program

    tb = program.TensorBoard()
    tb.configure(argv=[None, "--logdir", logdir, "--port", str(port)])
    return tb.launch()
