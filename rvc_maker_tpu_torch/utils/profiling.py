"""Tracing and profiling helpers (counterpart of JAX `utils/profiling.py`).

- `stage_timer(name, device)`: a context manager that logs the wall ms of
  its block, fenced on the device: it synchronizes a CUDA device at entry
  and at exit, so the time is the stage's own device work, not what was
  queued before it or is still queued after it.
- `torch_trace(logdir)`: torch.profiler over the block, written to
  logdir as a Chrome trace (chrome://tracing or Perfetto).
- RVC_TPU_PROFILE=1 turns on the fenced per-stage timings inside
  `ConvertPipeline.convert_batch` (off by default: fencing serializes the
  host with the device).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger(__name__)

PROFILE_ENV = "RVC_TPU_PROFILE"


def profiling_enabled() -> bool:
    return os.environ.get(PROFILE_ENV, "") not in ("", "0", "false")


def _fence(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class stage_timer:
    """with stage_timer("rmvpe", device): ...   (then .ms holds the time)"""

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device
        self.ms = None
        self._t0 = 0.0

    def __enter__(self):
        _fence(self.device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _fence(self.device)
        self.ms = (time.perf_counter() - self._t0) * 1000.0
        logger.info("stage %s: %.1f ms", self.name, self.ms)
        return False


@contextlib.contextmanager
def torch_trace(logdir: str):
    """torch.profiler trace of the block (host ops, and the card's kernels
    when there is one) into logdir/trace.json; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("trace written to %s", path)
