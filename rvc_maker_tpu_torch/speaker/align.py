"""Word-level timestamps by cross-attention DTW (counterpart of JAX
`speaker/align.py`; reference whisper.py:175-273).

Teacher-force the decoder over the transcript, take the cross-attention
scores of the alignment heads, normalize and median-filter them over
time, and dynamic-time-warp the text positions against the audio
frames; word boundaries come from the tokenizer's word split and the
DTW's jump times.  The decoder pass runs on the model's device; the
O(N x M) trellis is sequential and runs in numpy, as in JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import whisper as wmod
from .whisper_tokenizer import WhisperTokenizer

TOKENS_PER_SECOND = wmod.SAMPLE_RATE // (wmod.HOP_LENGTH * 2)   # 50


@dataclasses.dataclass
class WordTiming:
    word: str
    tokens: list[int]
    start: float
    end: float
    probability: float


def dtw(cost: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The monotonic path through a (N_text, M_time) cost matrix:
    (text_indices, time_indices)."""
    n, m = cost.shape
    acc = np.full((n + 1, m + 1), np.inf)
    acc[0, 0] = 0.0
    trace = np.full((n + 1, m + 1), -1, np.int32)
    trace[0, :] = 2
    trace[:, 0] = 1
    for i in range(1, n + 1):
        c_diag = acc[i - 1, :-1]
        c_up = acc[i - 1, 1:]
        row = acc[i]
        ti = trace[i]
        for j in range(1, m + 1):
            c0, c1, c2 = c_diag[j - 1], c_up[j - 1], row[j - 1]
            if c0 <= c1 and c0 <= c2:
                best, t = c0, 0
            elif c1 <= c2:
                best, t = c1, 1
            else:
                best, t = c2, 2
            row[j] = cost[i - 1, j - 1] + best
            ti[j] = t
    i, j = n, m
    text_idx, time_idx = [], []
    while i > 0 and j > 0:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.array(text_idx[::-1], np.int64), np.array(time_idx[::-1], np.int64)


def median_filter_time(x: np.ndarray, width: int) -> np.ndarray:
    """Median filter along the last axis with reflect padding."""
    if width <= 1 or x.shape[-1] <= 1:
        return x
    pad = width // 2
    if x.shape[-1] <= pad:
        return x
    xp = np.concatenate([x[..., 1: pad + 1][..., ::-1], x, x[..., -pad - 1: -1][..., ::-1]],
                        axis=-1)
    windows = np.stack([xp[..., k: k + x.shape[-1]] for k in range(width)], axis=-1)
    return np.median(windows, axis=-1)


@torch.inference_mode()
def find_alignment(model: wmod.Whisper, tok: WhisperTokenizer, text_tokens: list[int],
                   audio_features, num_frames: int, *,
                   alignment_heads: np.ndarray | None = None, medfilt_width: int = 7,
                   qk_scale: float = 1.0) -> list[WordTiming]:
    """audio_features: the encoded padded 30 s window (B = 1); num_frames:
    the mel frames of its content (JAX :96-150)."""
    if len(text_tokens) == 0:
        return []
    if alignment_heads is None:
        alignment_heads = wmod.default_alignment_heads(model.dims)

    sot_seq = tok.sot_sequence()
    tokens = [*sot_seq, tok.no_timestamps, *text_tokens, tok.eot]
    logits, qk = model.decoder.with_cross_qk(
        torch.as_tensor([tokens], dtype=torch.long, device=audio_features.device),
        audio_features)
    sot_len = len(sot_seq)
    probs = torch.softmax(logits[0, sot_len:, : tok.eot], dim=-1).cpu().numpy()
    text_token_probs = probs[np.arange(len(text_tokens)), text_tokens].tolist()

    # (n_layer, 1, n_head, T, S) -> the selected heads (H, T, S')
    qk = qk[:, 0].double().cpu().numpy()
    layers, heads = np.nonzero(alignment_heads)
    w = qk[layers, heads][:, :, : num_frames // 2] * qk_scale
    w = np.exp(w - w.max(axis=-1, keepdims=True))
    w = w / w.sum(axis=-1, keepdims=True)
    mean = w.mean(axis=-2, keepdims=True)
    std = w.std(axis=-2, keepdims=True)                 # ddof = 0
    w = median_filter_time((w - mean) / (std + 1e-12), medfilt_width)

    matrix = w.mean(axis=0)[sot_len:-1]
    text_indices, time_indices = dtw(-matrix)

    words, word_tokens = tok.split_to_word_tokens(text_tokens + [tok.eot])
    if len(word_tokens) <= 1:
        return []
    word_boundaries = np.pad(np.cumsum([len(t) for t in word_tokens[:-1]]), (1, 0))
    jumps = np.pad(np.diff(text_indices), (1, 0), constant_values=1).astype(bool)
    jump_times = time_indices[jumps] / TOKENS_PER_SECOND

    return [
        WordTiming(word, tks, float(start), float(end), float(np.mean(text_token_probs[i:j])))
        for word, tks, start, end, i, j in zip(
            words, word_tokens, jump_times[word_boundaries[:-1]],
            jump_times[word_boundaries[1:]], word_boundaries[:-1], word_boundaries[1:])
    ]


def merge_punctuations(alignment: list[WordTiming],
                       prepended: str = "\"'“¿([{-",
                       appended: str = "\"'.。,，!！?？:：”)]}、") -> None:
    """Fold leading / trailing punctuation into the neighbouring words
    (reference whisper.py:247-273)."""
    i, j = len(alignment) - 2, len(alignment) - 1
    while i >= 0:
        prev, after = alignment[i], alignment[j]
        if prev.word.startswith(" ") and prev.word.strip() in prepended:
            after.word = prev.word + after.word
            after.tokens = prev.tokens + after.tokens
            prev.word, prev.tokens = "", []
        else:
            j = i
        i -= 1
    i, j = 0, 1
    while j < len(alignment):
        prev, after = alignment[i], alignment[j]
        if not prev.word.endswith(" ") and after.word in appended:
            prev.word = prev.word + after.word
            prev.tokens = prev.tokens + after.tokens
            after.word, after.tokens = "", []
        else:
            i = j
        j += 1
    alignment[:] = [w for w in alignment if w.word]


def add_word_timestamps(segments: list[dict], model: wmod.Whisper, tok: WhisperTokenizer,
                        audio_features, num_frames: int, time_offset: float = 0.0,
                        **kwargs) -> None:
    """segment["words"] = [{word, start, end, probability}] from one
    alignment of the segments' text tokens together (JAX align.py
    add_word_timestamps; no hallucination heuristics)."""
    if not segments:
        return
    text_tokens_per_segment = [[t for t in seg["tokens"] if t < tok.eot] for seg in segments]
    text_tokens = [t for seg in text_tokens_per_segment for t in seg]
    alignment = find_alignment(model, tok, text_tokens, audio_features, num_frames, **kwargs)
    durations = np.array([w.end - w.start for w in alignment])
    durations = durations[durations > 0]
    median_dur = min(0.7, float(np.median(durations)) if len(durations) else 0.0)
    max_dur = median_dur * 2
    sentence_end = ".。!！?？"
    for i in range(1, len(alignment)):
        if alignment[i].end - alignment[i].start > max_dur > 0:
            if alignment[i].word in sentence_end:
                alignment[i].end = alignment[i].start + max_dur
            elif alignment[i - 1].word in sentence_end:
                alignment[i].start = alignment[i].end - max_dur
    merge_punctuations(alignment)

    word_index = 0
    for seg, seg_tokens in zip(segments, text_tokens_per_segment):
        saved: list[dict] = []
        remaining = len(seg_tokens)
        while word_index < len(alignment) and remaining > 0:
            w = alignment[word_index]
            saved.append({"word": w.word, "start": time_offset + w.start,
                          "end": time_offset + w.end, "probability": w.probability})
            remaining -= len([t for t in w.tokens if t < tok.eot])
            word_index += 1
        seg["words"] = saved
