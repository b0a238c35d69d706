"""Speaker diarization and diarized conversion (counterpart of JAX
`speaker/diarize.py`; reference app.py convert_with_whisper:1022-1164).

Whisper's segments (or an energy VAD) cut the audio; each segment gets
an ECAPA embedding; agglomerative clustering groups the segments into
one cluster per voice model; each segment is converted with its
cluster's pipeline and placed, silence-padded, at the output rate.

The JAX package clusters with scikit-learn, which the card's machine
lacks.  `AgglomerativeClustering(n_clusters=k)` with no connectivity
builds its tree with `scipy.cluster.hierarchy.ward` and numbers the
clusters in the order of `_hc_cut`'s heap list, which is not sorted;
`cluster_labels` does both, so that the labels, which decide which voice
converts which segment, are scikit-learn's label for label.
"""

from __future__ import annotations

import heapq
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..models import ecapa_tdnn
from ..ops.stft import hann_window, mel_filterbank, stft_magnitude

SR = 16000


def fbank(audio_16k: np.ndarray, n_mels: int = 80, device="cpu") -> torch.Tensor:
    """(L,) -> (T, n_mels) log-mel features on `device` (25 ms window,
    10 ms hop, HTK mel; JAX :30-39)."""
    x = torch.as_tensor(np.asarray(audio_16k, np.float32)[None], device=device)
    power = stft_magnitude(x, n_fft=400, hop_length=160, win_length=400,
                           window=hann_window(400), center=True).square()
    fb = torch.as_tensor(mel_filterbank(SR, 400, n_mels, 0.0, 8000.0, htk=True), device=device)
    return torch.log(torch.clamp(power @ fb.T, min=1e-10))[0]


def energy_vad_segments(audio: np.ndarray, *, min_seg_s: float = 1.0,
                        max_seg_s: float = 10.0,
                        threshold_db: float = -40.0) -> list[tuple[int, int]]:
    """Voiced stretches split at silences (the segmenter without Whisper;
    JAX :42-80)."""
    frame, hop = 400, 160
    pad = frame // 2
    xp = np.pad(audio.astype(np.float64), (pad, pad))
    n = 1 + (len(xp) - frame) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    rms = np.sqrt(np.mean(np.square(xp[idx]), axis=1))
    voiced = rms > 10 ** (threshold_db / 20.0)

    segments = []
    start = None
    for i, v in enumerate(voiced):
        if v and start is None:
            start = i
        elif not v and start is not None:
            segments.append((start * hop, i * hop))
            start = None
    if start is not None:
        segments.append((start * hop, len(audio)))

    # merge short gaps, then the min and max lengths
    merged: list[tuple[int, int]] = []
    for s, e in segments:
        if merged and s - merged[-1][1] < int(0.3 * SR):
            merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    out = []
    for s, e in merged:
        if e - s < int(min_seg_s * SR):
            continue
        while e - s > int(max_seg_s * SR):
            out.append((s, s + int(max_seg_s * SR)))
            s += int(max_seg_s * SR)
        out.append((s, e))
    return out


def _descendants(node: int, children: np.ndarray, n_leaves: int) -> list[int]:
    leaves, stack = [], [node]
    while stack:
        i = stack.pop()
        if i < n_leaves:
            leaves.append(i)
        else:
            stack.extend(children[i - n_leaves])
    return leaves


def cluster_labels(x: np.ndarray, n_clusters: int) -> np.ndarray:
    """`AgglomerativeClustering(n_clusters).fit_predict(x)` (ward, no
    connectivity), label for label: scipy's ward tree, cut as scikit-
    learn's `_hc_cut` cuts it, each cluster numbered by its place in the
    heap of (negated) node ids."""
    from scipy.cluster import hierarchy

    n_leaves = len(x)
    children = hierarchy.ward(x)[:, :2].astype(np.intp)
    nodes = [-(int(max(children[-1])) + 1)]
    for _ in range(n_clusters - 1):
        these = children[-nodes[0] - n_leaves]
        heapq.heappush(nodes, -int(these[0]))
        heapq.heappushpop(nodes, -int(these[1]))
    labels = np.zeros(n_leaves, dtype=np.intp)
    for i, node in enumerate(nodes):
        labels[_descendants(-node, children, n_leaves)] = i
    return labels


def segment_embeddings(audio: np.ndarray, segments: Sequence[tuple[int, int]],
                       ecapa_params: Any) -> np.ndarray:
    """(n_segments, 192) unit-norm ECAPA embeddings, one segment at a
    time on the parameters' device."""
    device = ecapa_tdnn.params_device(ecapa_params)
    embs = []
    for (s, e) in segments:
        emb = ecapa_tdnn.embed(ecapa_params, fbank(audio[s:e], device=device)[None])
        emb = emb[0].cpu().numpy()
        embs.append(emb / (np.linalg.norm(emb) + 1e-9))
    return np.stack(embs)


def cluster_speakers(audio: np.ndarray, segments: Sequence[tuple[int, int]],
                     ecapa_params: Any, num_speakers: int = 2) -> np.ndarray:
    """Each segment's speaker label (JAX :83-97)."""
    embs = segment_embeddings(audio, segments, ecapa_params)
    if len(segments) <= num_speakers:
        return np.arange(len(segments))
    return cluster_labels(embs, num_speakers)


def whisper_segments(audio_16k: np.ndarray, model: Any, tokenizer: Any) -> list[tuple[int, int]]:
    """Segment boundaries from Whisper's transcription."""
    from .transcribe import segments_to_sample_ranges, transcribe

    return segments_to_sample_ranges(transcribe(model, tokenizer, audio_16k))


def convert_with_diarization(audio_16k: np.ndarray, pipelines: Sequence[Any],
                             settings_list: Sequence[Any], ecapa_params: Any,
                             sids: Optional[Sequence[int]] = None,
                             segments: Optional[Sequence[tuple[int, int]]] = None,
                             whisper=None):
    """Convert each segment with the pipeline of its speaker's cluster;
    the gaps stay silent (JAX :107-149).

    pipelines / settings_list: one per speaker, cycled.  whisper: an
    optional (model, tokenizer) pair; with it Whisper cuts the segments,
    else the energy VAD.  Segments are cut to the audio, and those left empty dropped.
    Returns the waveform at pipelines[0].cfg.sr."""
    if segments is None and whisper is not None:
        segments = whisper_segments(audio_16k, *whisper)
    if segments is None:
        segments = energy_vad_segments(audio_16k)
    # a segment past the audio's end holds no samples to embed or convert
    # (JAX passes it on and fails in the fbank's reflect pad)
    n = len(audio_16k)
    segments = [(s, min(e, n)) for s, e in segments if min(e, n) > s]
    if not segments:
        return np.zeros(0, np.float32)
    labels = cluster_speakers(audio_16k, segments, ecapa_params, num_speakers=len(pipelines))
    sids = sids or [0] * len(pipelines)

    out_sr = pipelines[0].cfg.sr
    total = int(len(audio_16k) / SR * out_sr)
    out = np.zeros(total, np.float32)
    for (s, e), lab in zip(segments, labels):
        pipe = pipelines[lab % len(pipelines)]
        st = settings_list[lab % len(settings_list)]
        seg_out = pipe.convert_utterance(audio_16k[s:e], sids[lab % len(sids)], st)
        o_s = int(s / SR * out_sr)
        n = min(len(seg_out), total - o_s)
        out[o_s: o_s + n] = seg_out[:n]
    return out
