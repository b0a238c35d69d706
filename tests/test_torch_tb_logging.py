"""The port's TensorBoard logger (pipelines/tb_logging.py): the scalars,
the generated audio and the mel image land in the event file, and without
matplotlib the mel image is left out with one warning while the rest is
still written."""

import logging
import sys

import numpy as np

from rvc_maker_tpu_torch.pipelines.tb_logging import TensorBoardLogger


def _tags(log_dir) -> dict:
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(log_dir))
    acc.Reload()
    return acc.Tags()


def _log_step(tb: TensorBoardLogger, step: int) -> None:
    tb.scalars(step, {"loss/loss_g": 1.5})
    tb.audio(step, "eval/generated", np.zeros(800, np.float32), 16000)
    tb.mel_image(step, "eval/mel_generated", np.zeros((40, 8), np.float32))
    tb.flush()


def test_logger_writes_scalars_audio_and_mel_image(tmp_path):
    tb = TensorBoardLogger(str(tmp_path))
    _log_step(tb, 1)
    tb.close()
    tags = _tags(tmp_path)
    assert tags["scalars"] == ["loss/loss_g"]
    assert tags["audio"] == ["eval/generated"]
    assert tags["images"] == ["eval/mel_generated"]


def test_mel_image_left_out_without_matplotlib(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "matplotlib", None)    # its import raises
    tb = TensorBoardLogger(str(tmp_path))
    with caplog.at_level(logging.WARNING):
        _log_step(tb, 1)
        _log_step(tb, 2)
    tb.close()
    assert not tb.images
    assert caplog.text.count("mel images left out") == 1
    tags = _tags(tmp_path)
    assert tags["scalars"] == ["loss/loss_g"] and tags["audio"] == ["eval/generated"]
    assert tags["images"] == []
