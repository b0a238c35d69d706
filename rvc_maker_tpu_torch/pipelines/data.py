"""Training data: filelist -> bucketed, padded batches (host numpy).

Counterpart of `rvc_maker_tpu/pipelines/data.py` (reference train.py
TextAudioLoaderMultiNSFsid :327-400, DistributedBucketSampler
:541-606):
  * filelist rows `wav|feature.npy|f0|f0nsf|sid`
  * features repeated x2 in time, capped at 900 frames; spec, wave and
    f0 truncated to the common length
  * the linear spectrogram (`ops.stft.spectrogram`, on the host's CPU)
    cached beside the wav as .spec.npy
  * length buckets (boundaries 100..900 frames), an epoch-seeded
    shuffle, each batch padded to the longest item of its bucket (to the
    bucket bound when it is sharded over ranks)
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import RVCConfig
from ..ops.stft import spectrogram
from ..utils.audio import read_wav
from .train import Batch

BUCKET_BOUNDARIES = (100, 200, 300, 400, 500, 600, 700, 800, 900)


class TrainingDataset:
    def __init__(self, filelist_path: str, cfg: RVCConfig,
                 cache_in_memory: bool = False):
        """cache_in_memory: keep decoded items in RAM after the first load
        (the reference's cache_data_in_gpu, train.py:824, in host RAM)."""
        self.cfg = cfg
        with open(filelist_path) as f:
            self.rows = [line.strip().split("|") for line in f if line.strip()]
        self.emb_dim = cfg.model.text_enc_hidden_dim
        self._cache: dict | None = {} if cache_in_memory else None

    def __len__(self):
        return len(self.rows)

    def _spec(self, wav_path: str, audio: np.ndarray) -> np.ndarray:
        cache = wav_path.replace(".wav", ".spec.npy")
        if os.path.exists(cache):
            return np.load(cache, allow_pickle=False)
        d = self.cfg.data
        with torch.no_grad():
            spec = spectrogram(torch.from_numpy(np.ascontiguousarray(audio[None])),
                               n_fft=d.filter_length, hop_length=d.hop_length,
                               win_length=d.win_length)[0].numpy()
        np.save(cache, spec, allow_pickle=False)
        return spec

    def load_item(self, i: int):
        if self._cache is not None and i in self._cache:
            return self._cache[i]
        item = self._load_item(i)
        if self._cache is not None:
            self._cache[i] = item
        return item

    def _load_item(self, i: int):
        wav_path, feat_path, f0_path, f0nsf_path, sid = self.rows[i]
        audio, sr = read_wav(wav_path)
        if sr != self.cfg.data.sample_rate:
            raise ValueError(f"{wav_path}: sr {sr} != {self.cfg.data.sample_rate}")
        phone = np.repeat(np.load(feat_path), 2, axis=0)
        n = min(phone.shape[0], 900)
        phone = phone[:n].astype(np.float32)
        pitch = np.load(f0_path)[:n].astype(np.int32)
        pitchf = np.load(f0nsf_path)[:n].astype(np.float32)
        spec = self._spec(wav_path, audio)           # (T_spec, n_fft//2+1)
        n_min = min(n, spec.shape[0], len(pitch))
        hop = self.cfg.data.hop_length
        return dict(phone=phone[:n_min], pitch=pitch[:n_min], pitchf=pitchf[:n_min],
                    spec=spec[:n_min], wave=audio[: n_min * hop], sid=int(sid),
                    length=n_min)

    def frame_length(self, i: int) -> int:
        """Length estimate for bucketing: float32 wav samples per hop."""
        return os.path.getsize(self.rows[i][0]) // (4 * self.cfg.data.hop_length)


def _bucket_of(length: int) -> int:
    for b in BUCKET_BOUNDARIES:
        if length <= b:
            return b
    return BUCKET_BOUNDARIES[-1]


def batches_for_epoch(dataset: TrainingDataset, *, batch_size: int, epoch: int,
                      seed: int = 1234, rank: int = 0, num_replicas: int = 1):
    """Yield numpy Batches: an epoch-seeded shuffle, grouped by length
    bucket, full batches only.  Deterministic given (epoch, seed), so a
    resumed run sees the same batches.

    batch_size is the global batch.  With num_replicas > 1 (one per rank)
    every rank walks the same job list and yields its rows of each global
    batch, items rank, rank + num_replicas, ...; the time axis is pinned
    to the bucket bound, so every rank's rows have the same shape (JAX
    data.py:104; the reference's DistributedBucketSampler, train.py:585).
    The global batch is the ranks' rows in rank order."""
    if batch_size % num_replicas:
        raise ValueError(f"batch {batch_size} does not split over {num_replicas} replicas")
    rs = np.random.RandomState(seed + epoch)
    order = rs.permutation(len(dataset))

    buckets: dict[int, list[int]] = {}
    for i in order:
        buckets.setdefault(_bucket_of(dataset.frame_length(i)), []).append(i)

    jobs = []
    for b, idxs in sorted(buckets.items()):
        for k in range(0, len(idxs) - batch_size + 1, batch_size):
            jobs.append((b, idxs[k : k + batch_size]))
    rs.shuffle(jobs)

    hop = dataset.cfg.data.hop_length
    emb = dataset.emb_dim
    spec_ch = dataset.cfg.model.spec_channels
    for bound, idxs in jobs:
        items = [dataset.load_item(i) for i in idxs[rank::num_replicas]]
        # with several ranks t must not depend on this rank's items
        t = bound if num_replicas > 1 else min(bound, max(it["length"] for it in items))
        t = max(t, dataset.cfg.model.segment_size + 1)
        B = len(items)
        phone = np.zeros((B, t, emb), np.float32)
        pitch = np.zeros((B, t), np.int32)
        pitchf = np.zeros((B, t), np.float32)
        spec = np.zeros((B, t, spec_ch), np.float32)
        wave = np.zeros((B, t * hop, 1), np.float32)
        lengths = np.zeros((B,), np.int32)
        sid = np.zeros((B,), np.int32)
        for j, it in enumerate(items):
            n = min(it["length"], t)
            phone[j, :n] = it["phone"][:n]
            pitch[j, :n] = it["pitch"][:n]
            pitchf[j, :n] = it["pitchf"][:n]
            spec[j, :n] = it["spec"][:n]
            w = it["wave"][: n * hop]
            wave[j, : len(w), 0] = w
            lengths[j] = n
            sid[j] = it["sid"]
        yield Batch(phone=phone, phone_lengths=lengths, pitch=pitch, pitchf=pitchf,
                    spec=spec, spec_lengths=lengths, wave=wave, sid=sid)
