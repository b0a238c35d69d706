"""Dataset preprocessing: slice -> normalize -> segment -> write wavs.

A copy of `rvc_maker_tpu/pipelines/preprocess.py` (host numpy/scipy; no
device work).  Reference: main/inference/preprocess.py.  Behavior:
  * walk dataset dir; top-level files are speaker 0, numeric subdirs are
    speaker ids
  * optional 48 Hz high-pass (5th-order butter, lfilter) + peak-normalize
    to 0.9 with alpha=0.75 soft mix (rejecting clips peaking > 2.5)
  * silence-slicing on RMS frames (threshold -42 dB, min_length 1.5 s,
    min_interval 0.4 s, hop 15 ms, max_sil_kept 0.5 s)
  * cut to `per`-second windows with 0.3 s overlap
  * write `sliced_audios/{sid}_{idx0}_{idx1}.wav` at model sr and
    `sliced_audios_16k/...` at 16 kHz
Parallel over files with ProcessPoolExecutor.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ProcessPoolExecutor, as_completed

import numpy as np
from scipy import signal as sp_signal

from ..utils.audio import load_audio, resample, save_wav

logger = logging.getLogger(__name__)

SAMPLE_RATE_16K = 16000
OVERLAP = 0.3
MAX_AMPLITUDE = 0.9
ALPHA = 0.75
HIGH_PASS_CUTOFF = 48


def frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """RMS of centered frames (constant pad), one value per hop."""
    pad = frame_length // 2
    yp = np.pad(y, (pad, pad))
    n = 1 + (len(yp) - frame_length) // hop_length
    starts = np.arange(n) * hop_length
    idx = starts[:, None] + np.arange(frame_length)[None, :]
    return np.sqrt(np.mean(np.square(yp[idx]), axis=1))


class SilenceSlicer:
    """RMS-threshold silence slicer.

    Splits audio at sustained silences, keeping at most `max_sil_kept`
    frames of silence around each cut; same behavior contract as the
    reference Slicer (preprocess.py:45-117).
    """

    def __init__(self, sr: int, threshold_db: float = -40.0,
                 min_length_ms: int = 5000, min_interval_ms: int = 300,
                 hop_ms: int = 20, max_sil_kept_ms: int = 5000):
        if not min_length_ms >= min_interval_ms >= hop_ms:
            raise ValueError("need min_length >= min_interval >= hop")
        if not max_sil_kept_ms >= hop_ms:
            raise ValueError("need max_sil_kept >= hop")
        min_interval = sr * min_interval_ms / 1000
        self.threshold = 10 ** (threshold_db / 20.0)
        self.hop_size = round(sr * hop_ms / 1000)
        self.win_size = min(round(min_interval), 4 * self.hop_size)
        self.min_length = round(sr * min_length_ms / 1000 / self.hop_size)
        self.min_interval = round(min_interval / self.hop_size)
        self.max_sil_kept = round(sr * max_sil_kept_ms / 1000 / self.hop_size)

    def slice(self, waveform: np.ndarray) -> list[np.ndarray]:
        return [waveform[b:e] for b, e in self.bounds(waveform)]

    def bounds(self, waveform: np.ndarray) -> list[tuple[int, int]]:
        """The (start, end) sample positions of the pieces `slice` cuts."""
        samples = waveform if waveform.ndim == 1 else waveform.mean(axis=0)
        n = samples.shape[0]
        if n <= self.min_length:
            return [(0, n)]
        rms = frame_rms(samples, self.win_size, self.hop_size)

        cuts: list[tuple[int, int]] = []   # (silence_cut_start, silence_cut_end)
        sil_start = None
        clip_start = 0
        for i, r in enumerate(rms):
            if r < self.threshold:
                if sil_start is None:
                    sil_start = i
                continue
            if sil_start is None:
                continue
            leading = sil_start == 0 and i > self.max_sil_kept
            middle = (i - sil_start >= self.min_interval
                      and i - clip_start >= self.min_length)
            if not leading and not middle:
                sil_start = None
                continue
            if i - sil_start <= self.max_sil_kept:
                pos = int(rms[sil_start : i + 1].argmin()) + sil_start
                cuts.append((0, pos) if sil_start == 0 else (pos, pos))
                clip_start = pos
            elif i - sil_start <= self.max_sil_kept * 2:
                pos = int(rms[i - self.max_sil_kept : sil_start + self.max_sil_kept + 1].argmin())
                pos += i - self.max_sil_kept
                pos_r = int(rms[i - self.max_sil_kept : i + 1].argmin()) + i - self.max_sil_kept
                if sil_start == 0:
                    cuts.append((0, pos_r))
                    clip_start = pos_r
                else:
                    pos_l = int(rms[sil_start : sil_start + self.max_sil_kept + 1].argmin()) + sil_start
                    cuts.append((min(pos_l, pos), max(pos_r, pos)))
                    clip_start = max(pos_r, pos)
            else:
                pos_r = int(rms[i - self.max_sil_kept : i + 1].argmin()) + i - self.max_sil_kept
                if sil_start == 0:
                    cuts.append((0, pos_r))
                else:
                    pos_l = int(rms[sil_start : sil_start + self.max_sil_kept + 1].argmin()) + sil_start
                    cuts.append((pos_l, pos_r))
                clip_start = pos_r
            sil_start = None

        total = rms.shape[0]
        if sil_start is not None and total - sil_start >= self.min_interval:
            pos = int(rms[sil_start : min(total, sil_start + self.max_sil_kept) + 1].argmin()) + sil_start
            cuts.append((pos, total + 1))

        if not cuts:
            return [(0, n)]
        out = []

        def piece(b, e):
            return b * self.hop_size, min(n, e * self.hop_size)

        if cuts[0][0] > 0:
            out.append(piece(0, cuts[0][0]))
        for a, b in zip(cuts[:-1], cuts[1:]):
            out.append(piece(a[1], b[0]))
        if cuts[-1][1] < total:
            out.append(piece(cuts[-1][1], total))
        return [(b, e) for b, e in out if e > b]


def normalize_audio(audio: np.ndarray) -> np.ndarray | None:
    """Peak-normalize with soft alpha mix; reject pathological clips
    (reference preprocess.py:142-145)."""
    peak = np.abs(audio).max()
    if peak > 2.5:
        return None
    return (audio / peak * (MAX_AMPLITUDE * ALPHA)) + (1 - ALPHA) * audio


def _process_one(args):
    (path, idx0, sid, sr, per, gt_dir, k16_dir, cut, effects) = args
    audio = load_audio(path, sr)
    if effects:
        bh, ah = sp_signal.butter(N=5, Wn=HIGH_PASS_CUTOFF, btype="high", fs=sr)
        audio = sp_signal.lfilter(bh, ah, audio)
        audio = normalize_audio(audio)
        if audio is None:
            return 0
    idx1 = 0
    written = 0

    def write_segment(seg):
        nonlocal idx1, written
        name = f"{sid}_{idx0}_{idx1}.wav"
        save_wav(os.path.join(gt_dir, name), seg.astype(np.float32), sr,
                 subtype="float32")
        save_wav(os.path.join(k16_dir, name),
                 resample(seg.astype(np.float32), sr, SAMPLE_RATE_16K),
                 SAMPLE_RATE_16K, subtype="float32")
        idx1 += 1
        written += 1

    if cut:
        slicer = SilenceSlicer(sr, threshold_db=-42, min_length_ms=1500,
                               min_interval_ms=400, hop_ms=15,
                               max_sil_kept_ms=500)
        for segment in slicer.slice(audio):
            i = 0
            while True:
                start = int(sr * (per - OVERLAP) * i)
                i += 1
                if len(segment[start:]) > (per + OVERLAP) * sr:
                    write_segment(segment[start : start + int(per * sr)])
                else:
                    write_segment(segment[start:])
                    break
    else:
        write_segment(audio)
    return written


def preprocess_dataset(input_root: str, exp_dir: str, sr: int,
                       per: float = 3.7, num_workers: int = 2,
                       cut: bool = True, effects: bool = True) -> int:
    """Returns number of segments written."""
    gt_dir = os.path.join(exp_dir, "sliced_audios")
    k16_dir = os.path.join(exp_dir, "sliced_audios_16k")
    os.makedirs(gt_dir, exist_ok=True)
    os.makedirs(k16_dir, exist_ok=True)

    files = []
    idx = 0
    for root, _, names in os.walk(input_root):
        sid = 0 if os.path.abspath(root) == os.path.abspath(input_root) \
            else int(os.path.basename(root))
        for f in sorted(names):
            if f.lower().endswith(("wav",)):
                files.append((os.path.join(root, f), idx, sid, sr, per,
                              gt_dir, k16_dir, cut, effects))
                idx += 1

    t0 = time.time()
    total = 0
    if num_workers <= 1:
        for args in files:
            total += _process_one(args)
    else:
        with ProcessPoolExecutor(max_workers=num_workers) as ex:
            futures = [ex.submit(_process_one, a) for a in files]
            for fut in as_completed(futures):
                total += fut.result()
    logger.info("preprocess done in %.1f s [%d files -> %d segments]",
                time.time() - t0, len(files), total)
    return total


def cut_with_positions(audio: np.ndarray, sr: int, *, db_thresh: float = -60,
                       min_interval_ms: int = 250):
    """Silence-split keeping sample positions: [(chunk, start, end), ...].

    The split_audio path of conversion (reference utils.py:172-237 `cut`),
    with SilenceSlicer's rules.  The JAX package finds each chunk's start
    by scanning the audio for it; the positions here are the slicer's own
    cut points, which are where that scan lands."""
    slicer = SilenceSlicer(sr, threshold_db=db_thresh, min_interval_ms=min_interval_ms)
    return [(audio[b:e], b, e) for b, e in slicer.bounds(audio)]


def restore_positions(segments, total_len: int, dtype=np.float32) -> np.ndarray:
    """Reassemble processed segments at their (scaled) positions with
    silence in the gaps (reference utils.py:239-250 `restore`).

    segments: [(start, end, processed_audio), ...] in sample positions
    the caller scaled to the output rate."""
    out = []
    last_end = 0
    for start, end, seg in segments:
        if start > last_end:
            out.append(np.zeros(start - last_end, dtype=dtype))
        out.append(np.asarray(seg, dtype=dtype))
        last_end = end
    if last_end < total_len:
        out.append(np.zeros(total_len - last_end, dtype=dtype))
    return np.concatenate(out, axis=-1)
