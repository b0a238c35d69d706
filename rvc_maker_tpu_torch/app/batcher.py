"""Dynamic request batching for conversion serving.

Counterpart of JAX `app/batcher.py`.  Concurrent convert requests ride
one `convert_batch`: the worker collects requests for up to
``max_wait_ms`` (or until ``max_batch`` accumulate), groups them by
settings and then by speaker id, pads each group to the pipeline's 1 s
length bucket and its batch to a power of two (capped at
``max_batch``), runs it, and hands each caller its own rows back.  The
queue is bounded: a full queue raises `BatcherOverloaded`, which the
server answers with 503 and a retry.

Used by the web server when RVC_TPU_BATCH_SERVE=1; also a library
surface for any custom serving loop.  The worker thread runs under
torch.inference_mode (grad mode is thread-local in PyTorch).
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _valid_out_samples(n_in: int, upp: int) -> int:
    """Output samples derived from n_in input samples: HuBERT's VALID
    conv front end eats the edges, its frames are doubled and the decoder
    upsamples by upp.  Past this, a padded request decodes its padding."""
    from ..models.hubert import CONV_LAYERS

    fl = n_in
    for (_, k, s) in CONV_LAYERS:
        fl = (fl - k) // s + 1
    return max(fl, 0) * 2 * upp


class BatcherOverloaded(RuntimeError):
    """The request queue is at capacity: backpressure instead of
    unbounded memory growth under sustained overload."""


@dataclass
class _Request:
    audio: np.ndarray                 # (L,) float32 at 16 kHz
    sid: int
    settings: Any
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[Exception] = None


class ConvertBatcher:
    """Groups concurrent convert requests into device batches."""

    def __init__(self, pipeline, *, max_batch: int = 16,
                 max_wait_ms: float = 25.0, max_queue: int = 64, run=None):
        """run(fn, *args): where the worker calls `convert_batch` (the
        server's device thread); by default in the worker itself."""
        self.pipeline = pipeline
        self._call = run or (lambda fn, *args: fn(*args))
        self.max_batch = max_batch
        self.max_queue = max_queue
        self.max_wait = max_wait_ms / 1000.0
        self._q: queue.Queue[_Request] = queue.Queue(maxsize=max_queue)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="convert-batcher")
        self._thread.start()

    # -- client side ------------------------------------------------------

    def convert(self, audio_16k: np.ndarray, sid: int, settings,
                timeout: float = 300.0) -> np.ndarray:
        """Blocking convert; safe from many threads at once."""
        req = _Request(np.asarray(audio_16k, np.float32), int(sid), settings)
        try:
            self._q.put_nowait(req)
        except queue.Full:
            raise BatcherOverloaded(
                f"request queue full ({self.max_queue}); retry later") from None
        if not req.event.wait(timeout):
            raise TimeoutError("conversion timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)

    # -- worker -----------------------------------------------------------

    def _drain(self) -> list[_Request]:
        """Block for one request, then collect more until max_wait or
        max_batch."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _run(self):
        with torch.inference_mode():
            while not self._stop.is_set():
                batch = self._drain()
                groups: dict[Any, list[_Request]] = {}
                for r in batch:
                    groups.setdefault(self._settings_key(r.settings), []).append(r)
                for reqs in groups.values():
                    self._run_group(reqs)

    @staticmethod
    def _settings_key(settings) -> tuple:
        if dataclasses.is_dataclass(settings):
            return tuple(sorted(dataclasses.asdict(settings).items()))
        return (id(settings),)

    def _pad_batch(self, audio: np.ndarray, lengths: np.ndarray):
        """Repeat the last row up to the next power of two, capped at
        max_batch (the operator's memory budget)."""
        b = len(audio)
        b_pad = min(1 << (b - 1).bit_length(), self.max_batch)
        if b_pad > b:
            audio = np.concatenate([audio, np.repeat(audio[-1:], b_pad - b, 0)])
            lengths = np.concatenate([lengths, np.repeat(lengths[-1:], b_pad - b)])
        return audio, lengths

    def _run_group(self, reqs: list[_Request]):
        from ..pipelines.convert import _bucket_length

        try:
            lengths = np.asarray([len(r.audio) for r in reqs], np.int64)
            L = _bucket_length(int(lengths.max()))
            audio = np.zeros((len(reqs), L), np.float32)
            for i, r in enumerate(reqs):
                audio[i, : len(r.audio)] = r.audio
            by_sid: dict[int, list[int]] = {}
            for i, r in enumerate(reqs):
                by_sid.setdefault(r.sid, []).append(i)
            upp = self.pipeline.cfg.upp
            for sid, idxs in by_sid.items():
                sub_audio, sub_lengths = self._pad_batch(audio[idxs], lengths[idxs])
                wav, _ = self._call(self.pipeline.convert_batch, sub_audio, sub_lengths,
                                    sid, reqs[idxs[0]].settings)
                wav = wav[: len(idxs)].float().cpu().numpy()
                for j, i in enumerate(idxs):
                    n_in = len(reqs[i].audio)
                    n_out = min(n_in * upp // 160, _valid_out_samples(n_in, upp),
                                wav.shape[1])
                    reqs[i].result = wav[j][:n_out]
                    reqs[i].event.set()
            logger.info("batched convert: %d request(s), %d sid group(s)",
                        len(reqs), len(by_sid))
        except Exception as e:  # noqa: BLE001 — reported to every waiter
            logger.exception("batched convert failed")
            for r in reqs:
                r.error = e
                r.event.set()
