"""Whisper speech recognition in PyTorch (counterpart of JAX `models/whisper.py`).

The reference's vendored Whisper (main/library/speaker_diarization/
whisper.py) for the diarized-conversion flow: the log-mel front end
((x + 4) / 4 of a log10 mel power floored at max - 8), a conv stem and a
sinusoidal-position transformer encoder, a token / learned-position
decoder with causal self-attention and cross-attention, and the output
projection tied to the token embedding.

The modules carry the reference's state-dict names (`Whisper.load_state_dict`
reads a checkpoint's `model_state_dict` as it is).  As in JAX, q alone is
scaled by d^-0.5 (the reference scales q and k by d^-0.25 each), k has no
bias, and every GELU is exact.  Self- and cross-attention run
`F.scaled_dot_product_attention` (the JAX package computes them in XLA,
not in Pallas); the cross-QK pass computes its pre-softmax scores
explicitly, since word alignment reads them.

Decoding: `decode_step` runs one token against a preallocated
(n_layer, B, n_text_ctx, C) self-K/V cache, written in place at `index`
(JAX's dynamic_update_slice); the keys past `index` take no part in the
attention (JAX masks them to -inf, which gives them a softmax weight of
exactly 0).  `init_cache` projects the cross-attention K/V once per
window.  The decoding loops (`greedy_decode`, `decode_window`,
`beam_decode`) keep their host logic in numpy, as JAX does: token
suppression, the timestamp monotonicity mask, float64 log-softmax and
`np.random.Generator` sampling in JAX's draw order, so that the same
logits give the same tokens.
"""

from __future__ import annotations

import base64
import dataclasses
import gzip

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..errors import BadRequest
from ..ops.stft import hann_window, mel_filterbank, stft_magnitude

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE
N_FRAMES = N_SAMPLES // HOP_LENGTH


@dataclasses.dataclass(frozen=True)
class WhisperDims:
    """Whisper base by default (JAX models/whisper.py:40-50)."""
    n_mels: int = 80
    n_audio_ctx: int = 1500
    n_audio_state: int = 512
    n_audio_head: int = 8
    n_audio_layer: int = 6
    n_vocab: int = 51865
    n_text_ctx: int = 448
    n_text_state: int = 512
    n_text_head: int = 8
    n_text_layer: int = 6


def log_mel(audio, n_mels: int = 80):
    """(B, L) -> (B, n_mels, L // 160): the STFT with center=True, its last
    frame dropped, the power's slaney mel, log10, floored at max - 8,
    (x + 4) / 4 (JAX models/whisper.py:53-67)."""
    mag = stft_magnitude(audio, n_fft=N_FFT, hop_length=HOP_LENGTH, win_length=N_FFT,
                         window=hann_window(N_FFT), center=True)
    power = mag[:, :-1, :].square()
    fb = torch.as_tensor(mel_filterbank(SAMPLE_RATE, N_FFT, n_mels, 0.0, 8000.0, htk=False),
                         device=power.device, dtype=power.dtype)
    log_spec = torch.log10(torch.clamp(power @ fb.T, min=1e-10))
    floor = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
    log_spec = torch.maximum(log_spec, floor)
    return ((log_spec + 4.0) / 4.0).transpose(1, 2)


def sinusoids(length: int, channels: int) -> np.ndarray:
    """The encoder's position table (JAX `_sinusoids`)."""
    inc = -np.log(10000.0) / (channels // 2 - 1)
    scaled = np.arange(length)[:, None] * np.exp(inc * np.arange(channels // 2))[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def _heads(x, n_head: int):
    b, t, c = x.shape
    return x.reshape(b, t, n_head, c // n_head).transpose(1, 2)


def _merge(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


class MultiHeadAttention(nn.Module):
    """The reference's MultiHeadAttention: query / key (no bias) / value / out."""

    def __init__(self, n_state: int, n_head: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)

    def attend(self, q, k, v, *, causal: bool = False, return_qk: bool = False):
        """q: (B, T, C) projected; k, v: (B, S, C) projected.  q alone is
        scaled by d^-0.5 (JAX :91).  return_qk: also the pre-softmax
        scores (B, H, T, S) (JAX :97, :101)."""
        d = q.shape[-1] // self.n_head
        qh = _heads(q, self.n_head) * d ** -0.5
        kh, vh = _heads(k, self.n_head), _heads(v, self.n_head)
        causal = causal and q.shape[1] > 1
        if return_qk:
            scores = qh @ kh.transpose(-1, -2)
            if causal:
                t, s = scores.shape[-2:]
                scores = scores + torch.full((t, s), float("-inf"), device=q.device,
                                             dtype=q.dtype).triu(1)
            out = torch.softmax(scores, dim=-1) @ vh
            return self.out(_merge(out)), scores
        out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal, scale=1.0)
        return self.out(_merge(out))

    def forward(self, x, xa=None, *, causal: bool = False, return_qk: bool = False):
        src = x if xa is None else xa
        return self.attend(self.query(x), self.key(src), self.value(src), causal=causal,
                           return_qk=return_qk)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, n_head: int, cross_attention: bool = False):
        super().__init__()
        self.attn = MultiHeadAttention(n_state, n_head)
        self.attn_ln = nn.LayerNorm(n_state)
        self.cross_attn = MultiHeadAttention(n_state, n_head) if cross_attention else None
        self.cross_attn_ln = nn.LayerNorm(n_state) if cross_attention else None
        self.mlp = nn.Sequential(nn.Linear(n_state, 4 * n_state), nn.GELU(),
                                 nn.Linear(4 * n_state, n_state))
        self.mlp_ln = nn.LayerNorm(n_state)

    def forward(self, x, xa=None, *, causal: bool = False, return_cross_qk: bool = False):
        x = x + self.attn(self.attn_ln(x), causal=causal)
        qk = None
        if self.cross_attn is not None:
            y = self.cross_attn(self.cross_attn_ln(x), xa, return_qk=return_cross_qk)
            if return_cross_qk:
                y, qk = y
            x = x + y
        x = x + self.mlp(self.mlp_ln(x))
        return (x, qk) if return_cross_qk else x


class AudioEncoder(nn.Module):
    """`encode_audio` (JAX :127-137): mel (B, n_mels, T <= 3000) ->
    features (B, T // 2, n_audio_state)."""

    def __init__(self, dims: WhisperDims):
        super().__init__()
        c = dims.n_audio_state
        self.conv1 = nn.Conv1d(dims.n_mels, c, 3, padding=1)
        self.conv2 = nn.Conv1d(c, c, 3, stride=2, padding=1)
        # JAX computes its own table (the checkpoint's copy is not read)
        self.register_buffer("positional_embedding",
                             torch.from_numpy(sinusoids(dims.n_audio_ctx, c)), persistent=False)
        self.blocks = nn.ModuleList(ResidualAttentionBlock(c, dims.n_audio_head)
                                    for _ in range(dims.n_audio_layer))
        self.ln_post = nn.LayerNorm(c)

    def forward(self, mel):
        x = F.gelu(self.conv1(mel))
        x = F.gelu(self.conv2(x)).transpose(1, 2)
        x = x + self.positional_embedding[: x.shape[1]]
        for block in self.blocks:
            x = block(x)
        return self.ln_post(x)


class TextDecoder(nn.Module):
    """`decode_logits` (JAX :140-150) as forward, and
    `decode_logits_with_cross_qk` (JAX :153-168)."""

    def __init__(self, dims: WhisperDims):
        super().__init__()
        c = dims.n_text_state
        self.token_embedding = nn.Embedding(dims.n_vocab, c)
        self.positional_embedding = nn.Parameter(torch.empty(dims.n_text_ctx, c))
        self.blocks = nn.ModuleList(ResidualAttentionBlock(c, dims.n_text_head, True)
                                    for _ in range(dims.n_text_layer))
        self.ln = nn.LayerNorm(c)

    def _embed(self, tokens, offset: int = 0):
        return (self.token_embedding(tokens)
                + self.positional_embedding[offset: offset + tokens.shape[-1]])

    def logits(self, x):
        return self.ln(x) @ self.token_embedding.weight.T

    def forward(self, tokens, audio_features):
        """tokens (B, T) int -> logits (B, T, n_vocab), the full pass."""
        x = self._embed(tokens)
        for block in self.blocks:
            x = block(x, audio_features, causal=True)
        return self.logits(x)

    def with_cross_qk(self, tokens, audio_features):
        """-> (logits (B, T, n_vocab), qk (n_layer, B, n_head, T, S)):
        the teacher-forced pass with each layer's cross-attention scores
        (the matrices word alignment reads)."""
        x = self._embed(tokens)
        qks = []
        for block in self.blocks:
            x, qk = block(x, audio_features, causal=True, return_cross_qk=True)
            qks.append(qk)
        return self.logits(x), torch.stack(qks)


class Whisper(nn.Module):
    def __init__(self, dims: WhisperDims):
        super().__init__()
        self.dims = dims
        self.encoder = AudioEncoder(dims)
        self.decoder = TextDecoder(dims)


def default_alignment_heads(dims: WhisperDims) -> np.ndarray:
    """(n_text_layer, n_text_head) bool: every head of the upper half of
    the decoder layers (JAX :171)."""
    mask = np.zeros((dims.n_text_layer, dims.n_text_head), bool)
    mask[dims.n_text_layer // 2:] = True
    return mask


def alignment_heads_from_dump(dump: bytes, dims: WhisperDims) -> np.ndarray:
    """A base85 + gzip alignment-head mask, as Whisper checkpoints'
    metadata writes it (JAX :180)."""
    raw = gzip.decompress(base64.b85decode(dump))
    return np.frombuffer(raw, dtype=bool).copy().reshape(dims.n_text_layer, dims.n_text_head)


# ---------------------------------------------------------------------------
# cached decoding
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DecodeCache:
    self_k: torch.Tensor     # (n_layer, B, n_text_ctx, C), written in place
    self_v: torch.Tensor
    cross_k: torch.Tensor    # (n_layer, B, S, C)
    cross_v: torch.Tensor
    index: int = 0           # tokens written so far


@torch.inference_mode()
def init_cache(decoder: TextDecoder, audio_features) -> DecodeCache:
    """The zero self-K/V cache and the cross-attention K/V of the window,
    projected once (JAX :203-216)."""
    b = audio_features.shape[0]
    nl, (ctx, c) = len(decoder.blocks), decoder.positional_embedding.shape
    dev, dt = audio_features.device, audio_features.dtype
    cross_k = torch.stack([blk.cross_attn.key(audio_features) for blk in decoder.blocks])
    cross_v = torch.stack([blk.cross_attn.value(audio_features) for blk in decoder.blocks])
    return DecodeCache(self_k=torch.zeros(nl, b, ctx, c, device=dev, dtype=dt),
                       self_v=torch.zeros(nl, b, ctx, c, device=dev, dtype=dt),
                       cross_k=cross_k, cross_v=cross_v)


@torch.inference_mode()
def decode_step(decoder: TextDecoder, token, cache: DecodeCache):
    """token: (B,) int -> logits (B, n_vocab); the cache is written at
    cache.index in place and its index advanced (JAX :240-268)."""
    i = cache.index
    x = decoder._embed(token[:, None], offset=i)
    for li, blk in enumerate(decoder.blocks):
        y = blk.attn_ln(x)
        cache.self_k[li, :, i] = blk.attn.key(y)[:, 0]
        cache.self_v[li, :, i] = blk.attn.value(y)[:, 0]
        x = x + blk.attn.attend(blk.attn.query(y), cache.self_k[li, :, : i + 1],
                                cache.self_v[li, :, : i + 1])
        y = blk.cross_attn_ln(x)
        x = x + blk.cross_attn.attend(blk.cross_attn.query(y), cache.cross_k[li],
                                      cache.cross_v[li])
        x = x + blk.mlp(blk.mlp_ln(x))
    cache.index = i + 1
    return decoder.logits(x)[:, 0]


def _tokens(t, b: int, device) -> torch.Tensor:
    return torch.full((b,), int(t), dtype=torch.long, device=device)


def _prompt(decoder, feats, initial_tokens, no_speech_token, b: int):
    """The cache after the prompt, the last logits and the no-speech
    probability read at the SOT position (JAX whisper.py:346)."""
    cache = init_cache(decoder, feats)
    logits, no_speech_prob = None, 0.0
    for i, t in enumerate(initial_tokens):
        logits = decode_step(decoder, _tokens(t, b, feats.device), cache)
        if i == 0 and no_speech_token is not None:
            no_speech_prob = float(torch.softmax(logits[0], dim=-1)[no_speech_token])
    return cache, logits, no_speech_prob


def _mask_timestamps(lg, out, timestamp_begin):
    """Timestamps must not go back: those below the last one are
    suppressed."""
    if timestamp_begin is not None and out:
        last_ts = [tk for tk in out if tk >= timestamp_begin]
        if last_ts:
            lg[timestamp_begin: last_ts[-1]] = -np.inf


@torch.inference_mode()
def greedy_decode(decoder: TextDecoder, audio_features, initial_tokens: list[int], *,
                  eot: int, max_tokens: int = 224, suppress=None,
                  timestamp_begin: int | None = None) -> list[int]:
    """Greedy decoding of one window: the generated tokens, without the
    prompt and the eot (JAX :271)."""
    b = audio_features.shape[0]
    cache, logits, _ = _prompt(decoder, audio_features, initial_tokens, None, b)
    out: list[int] = []
    for _ in range(max_tokens):
        lg = logits[0].float().cpu().numpy()
        if suppress is not None:
            lg[suppress] = -np.inf
        _mask_timestamps(lg, out, timestamp_begin)
        cur = int(np.argmax(lg))
        if cur == eot:
            break
        out.append(cur)
        logits = decode_step(decoder, _tokens(cur, b, audio_features.device), cache)
    return out


def _log_softmax64(lg: np.ndarray) -> np.ndarray:
    m = lg.max(axis=-1, keepdims=True)
    return lg - np.log(np.sum(np.exp(lg - m), axis=-1, keepdims=True)) - m


@torch.inference_mode()
def decode_window(decoder: TextDecoder, audio_features, initial_tokens: list[int], *,
                  eot: int, max_tokens: int = 224, suppress=None,
                  timestamp_begin: int | None = None, temperature: float = 0.0, rng=None,
                  no_speech_token: int | None = None) -> dict:
    """One decoding attempt with the statistics of the temperature
    fallback (JAX :304-358): greedy at temperature 0, else a draw from
    softmax(logits / t) with `rng` (np.random.Generator, default_rng(0)
    when None).  Returns {tokens, avg_logprob, no_speech_prob}."""
    b = audio_features.shape[0]
    cache, logits, no_speech_prob = _prompt(decoder, audio_features, initial_tokens,
                                            no_speech_token, b)
    out: list[int] = []
    sum_logprob = 0.0
    if rng is None:
        rng = np.random.default_rng(0)
    for _ in range(max_tokens):
        lg = logits[0].double().cpu().numpy()
        if suppress is not None:
            lg[suppress] = -np.inf
        _mask_timestamps(lg, out, timestamp_begin)
        logprobs = _log_softmax64(lg)
        if temperature > 0:
            z = lg / temperature
            pz = np.exp(z - z.max())
            pz = pz / pz.sum()
            cur = int(rng.choice(len(pz), p=pz))
        else:
            cur = int(np.argmax(lg))
        sum_logprob += float(logprobs[cur])
        if cur == eot:
            break
        out.append(cur)
        logits = decode_step(decoder, _tokens(cur, b, audio_features.device), cache)
    # averaged over the generated tokens and the eot, as whisper does
    return {"tokens": out, "avg_logprob": sum_logprob / (len(out) + 1),
            "no_speech_prob": no_speech_prob}


def _rearrange_cache(cache: DecodeCache, idx) -> None:
    """Reorder the beams of the self-K/V cache (JAX :361; the reference's
    rearrange_kv_cache)."""
    idx = torch.as_tensor(idx, dtype=torch.long, device=cache.self_k.device)
    cache.self_k = cache.self_k[:, idx]
    cache.self_v = cache.self_v[:, idx]


@torch.inference_mode()
def beam_decode(decoder: TextDecoder, audio_features, initial_tokens: list[int], *, eot: int,
                beam_size: int = 5, patience: float | None = None, max_tokens: int = 224,
                suppress=None, timestamp_begin: int | None = None,
                no_speech_token: int | None = None) -> dict:
    """Beam search over one window (JAX :369-465, the reference's
    BeamSearchDecoder): each beam proposes its top beam_size + 1 tokens,
    candidates are deduplicated by sequence, EOT candidates retire to a
    finished pool of at most round(beam_size * patience), the best
    beam_size live sequences go on with the cache rearranged to their
    source beams.  The pick is the best sum-logprob / length.
    audio_features: (1, S, C)."""
    patience = patience or 1.0
    max_candidates = int(round(beam_size * patience))
    if max_candidates <= 0:
        raise ValueError(f"beam_size {beam_size} x patience {patience} keeps no candidate")
    k = beam_size
    feats = audio_features.repeat_interleave(k, dim=0)
    cache, logits, no_speech_prob = _prompt(decoder, feats, initial_tokens, no_speech_token, k)

    beams: list[tuple[int, ...]] = [tuple() for _ in range(k)]
    sum_logprobs = np.zeros(k, np.float64)
    finished: dict[tuple[int, ...], float] = {}

    for _ in range(max_tokens):
        lg = logits.double().cpu().numpy()              # (k, V)
        if suppress is not None:
            lg[:, suppress] = -np.inf
        for j, seq in enumerate(beams):
            _mask_timestamps(lg[j], list(seq), timestamp_begin)
        logprobs = _log_softmax64(lg)

        scores: dict[tuple[int, ...], float] = {}
        sources: dict[tuple[int, ...], int] = {}
        for j in range(k):
            for tok in np.argsort(logprobs[j])[::-1][: k + 1]:
                seq = beams[j] + (int(tok),)
                scores[seq] = sum_logprobs[j] + float(logprobs[j, tok])
                sources[seq] = j
        next_beams, src_idx = [], []
        new_sum = np.zeros(k, np.float64)
        for seq in sorted(scores, key=scores.get, reverse=True):
            if seq[-1] == eot:
                if len(finished) < max_candidates:
                    finished[seq[:-1]] = scores[seq]
            else:
                new_sum[len(next_beams)] = scores[seq]
                next_beams.append(seq)
                src_idx.append(sources[seq])
                if len(next_beams) == k:
                    break
        if len(next_beams) < k:          # degenerate: every candidate ended
            break
        beams, sum_logprobs = next_beams, new_sum
        _rearrange_cache(cache, src_idx)
        tok = torch.as_tensor([seq[-1] for seq in beams], dtype=torch.long,
                              device=feats.device)
        logits = decode_step(decoder, tok, cache)
        if len(finished) >= max_candidates:
            break

    if len(finished) < beam_size:        # the live beams finish with an EOT
        for j in np.argsort(sum_logprobs)[::-1]:
            if len(finished) >= beam_size:
                break
            finished.setdefault(beams[int(j)], float(sum_logprobs[int(j)]))

    # the ranking divides by the generated tokens (eot excluded); the
    # reported avg_logprob by len + 1, as DecodingTask.run does
    best_seq, best_score = max(finished.items(),
                               key=lambda item: item[1] / max(len(item[0]), 1))
    return {"tokens": list(best_seq), "avg_logprob": best_score / (len(best_seq) + 1),
            "no_speech_prob": no_speech_prob}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def params_from_state_dict(sd, dims: WhisperDims, device="cpu") -> Whisper:
    """A reference Whisper state dict (`model_state_dict` of a `.pt`) ->
    the model in fp32 on `device` (JAX :507).  The encoder's stored
    position table is not read (the model computes its own, as JAX does);
    a missing or misshapen weight is a BadRequest."""
    model = Whisper(dims)
    sd = {k: v.float() if v.is_floating_point() else v for k, v in sd.items()
          if k not in ("encoder.positional_embedding", "alignment_heads")}
    try:
        model.load_state_dict(sd, strict=True)
    except RuntimeError as e:
        raise BadRequest(f"not a Whisper state dict of {dims}: {e}") from e
    return model.eval().to(resolve_device(device))


def load_whisper_pt(path: str, device="cuda") -> Whisper:
    """A Whisper checkpoint {dims, model_state_dict} -> the model on
    `device` (JAX :526; dims on `model.dims`)."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        dims = WhisperDims(**ckpt["dims"])
        sd = ckpt["model_state_dict"]
    except Exception as e:  # noqa: BLE001 — an unreadable file is the caller's
        raise BadRequest(f"{path}: not a Whisper checkpoint ({e!r})") from e
    return params_from_state_dict(sd, dims, device)
