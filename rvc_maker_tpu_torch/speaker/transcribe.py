"""Segment-level transcription: 30 s windows -> timestamped segments
(counterpart of JAX `speaker/transcribe.py`).

The reference's transcribe_function (whisper.py:299-520) as the
diarized-conversion flow uses it: per window, decode at rising
temperatures until the result passes the compression-ratio and
avg-logprob gates, skip no-speech windows, split on timestamp tokens,
and optionally attach DTW word timestamps.  The mel, the encoder and the
decoder run on the model's device.
"""

from __future__ import annotations

import logging
import zlib
from typing import Sequence

import numpy as np
import torch

from ..models import whisper as wmod
from .whisper_tokenizer import WhisperTokenizer

logger = logging.getLogger(__name__)


def compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    return len(data) / len(zlib.compress(data)) if data else 0.0


def decode_with_fallback(model: wmod.Whisper, tok: WhisperTokenizer, feats, *,
                         suppress, temperatures: Sequence[float],
                         compression_ratio_threshold: float | None = 2.4,
                         logprob_threshold: float | None = -1.0,
                         rng=None, beam_size: int | None = None,
                         patience: float | None = None,
                         best_of: int | None = None) -> dict:
    """Retry at the next temperature while the transcript is too
    repetitive (compression ratio) or too unlikely (avg logprob) (JAX
    :33-87).  At temperature 0 a beam_size switches to beam search; at
    temperature > 0 a best_of draws that many samples and keeps the most
    likely."""
    dec = model.decoder
    kw = dict(eot=tok.eot, suppress=suppress, timestamp_begin=tok.timestamp_begin,
              no_speech_token=tok.no_speech)
    result: dict = {}
    for t in temperatures:
        if float(t) == 0.0 and beam_size is not None:
            result = wmod.beam_decode(dec, feats, tok.sot_sequence(), beam_size=beam_size,
                                      patience=patience, **kw)
        elif float(t) > 0.0 and best_of is not None and best_of > 1:
            tries = [wmod.decode_window(dec, feats, tok.sot_sequence(), temperature=float(t),
                                        rng=rng, **kw) for _ in range(best_of)]
            result = max(tries, key=lambda r: r["avg_logprob"])
        else:
            result = wmod.decode_window(dec, feats, tok.sot_sequence(), temperature=float(t),
                                        rng=rng, **kw)
        result["temperature"] = float(t)
        result["text"] = tok.decode([x for x in result["tokens"] if x < tok.eot]).strip()
        result["compression_ratio"] = compression_ratio(result["text"])
        needs_fallback = (
            (compression_ratio_threshold is not None
             and result["compression_ratio"] > compression_ratio_threshold)
            or (logprob_threshold is not None and result["avg_logprob"] < logprob_threshold))
        if not needs_fallback:
            break
        logger.debug("fallback: t=%.1f cr=%.2f lp=%.2f", t, result["compression_ratio"],
                     result["avg_logprob"])
    return result


def _split_on_timestamps(tok: WhisperTokenizer, tokens, time_offset: float,
                         chunk_len: int):
    """<|t0|> text <|t1|> <|t2|> text ... -> segments, and the last
    timestamp's seconds (how far the window advances)."""
    segments: list[dict] = []
    cur_start = None
    cur_tokens: list[int] = []
    last_ts_sec = 0.0
    for t in tokens:
        if t >= tok.timestamp_begin:
            sec = tok.timestamp_to_seconds(t)
            if cur_start is None:
                cur_start = sec
            else:
                if cur_tokens:
                    segments.append({"start": time_offset + cur_start,
                                     "end": time_offset + sec, "tokens": cur_tokens,
                                     "text": tok.decode(cur_tokens).strip()})
                last_ts_sec = sec
                cur_start = None
                cur_tokens = []
        else:
            cur_tokens.append(t)
    if cur_start is not None and cur_tokens:
        end = min(chunk_len / wmod.SAMPLE_RATE, 30.0)
        segments.append({"start": time_offset + cur_start, "end": time_offset + end,
                         "tokens": cur_tokens, "text": tok.decode(cur_tokens).strip()})
        last_ts_sec = end
    return segments, last_ts_sec


@torch.inference_mode()
def transcribe(model: wmod.Whisper, tok: WhisperTokenizer, audio16k: np.ndarray, *,
               max_windows: int = 100, suppress_non_speech: bool = True,
               temperature: Sequence[float] | float = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
               compression_ratio_threshold: float | None = 2.4,
               logprob_threshold: float | None = -1.0,
               no_speech_threshold: float | None = 0.6,
               word_timestamps: bool = False,
               alignment_heads: np.ndarray | None = None,
               beam_size: int | None = None, patience: float | None = None,
               best_of: int | None = None, seed: int = 0) -> list[dict]:
    """audio16k: (L,) -> [{"start", "end", "text", "tokens"[, "words"]}]
    (JAX :89-188)."""
    suppress = list(tok.non_speech_tokens()) if suppress_non_speech else []
    suppress += [tok.sot, tok.no_speech, tok.no_timestamps, tok.sot_prev]
    suppress = np.asarray(suppress, np.int64)
    temperatures = ([temperature] if isinstance(temperature, (int, float))
                    else list(temperature))
    rng = np.random.default_rng(seed)
    device = next(model.parameters()).device

    segments: list[dict] = []
    seek = 0  # in samples
    n = len(audio16k)
    windows = 0
    while seek < n and windows < max_windows:
        windows += 1
        chunk = audio16k[seek: seek + wmod.N_SAMPLES]
        time_offset = seek / wmod.SAMPLE_RATE
        padded = np.zeros(wmod.N_SAMPLES, np.float32)
        padded[: len(chunk)] = chunk

        mel = wmod.log_mel(torch.as_tensor(padded[None], device=device), model.dims.n_mels)
        feats = model.encoder(mel)
        result = decode_with_fallback(
            model, tok, feats, suppress=suppress, temperatures=temperatures,
            compression_ratio_threshold=compression_ratio_threshold,
            logprob_threshold=logprob_threshold, rng=rng, beam_size=beam_size,
            patience=patience, best_of=best_of)

        # no-speech skip (whisper.py:371-376): confident silence and the
        # logprob gate failed -> a whole window on
        if (no_speech_threshold is not None
                and result["no_speech_prob"] > no_speech_threshold
                and not (logprob_threshold is not None
                         and result["avg_logprob"] >= logprob_threshold)):
            seek += wmod.N_SAMPLES
            continue

        window_segments, last_ts_sec = _split_on_timestamps(tok, result["tokens"],
                                                            time_offset, len(chunk))
        if word_timestamps and window_segments:
            from .align import add_word_timestamps

            num_frames = max(2, len(chunk) // wmod.HOP_LENGTH)
            add_word_timestamps(window_segments, model, tok, feats, num_frames,
                                time_offset=time_offset, alignment_heads=alignment_heads)
        segments.extend(window_segments)

        advance = int(last_ts_sec * wmod.SAMPLE_RATE)
        seek += advance if advance > 0 else wmod.N_SAMPLES
    return segments


def segments_to_sample_ranges(segments: list[dict],
                              sr: int = wmod.SAMPLE_RATE) -> list[tuple[int, int]]:
    return [(int(s["start"] * sr), int(s["end"] * sr)) for s in segments]
