"""MDX-Net stem separation (counterpart of JAX `pipelines/mdx.py`; the
reference MDXSeparator, main/library/architectures/mdx_separator.py).

MDX models are ONNX spectrogram-masking U-Nets over the stacked real /
imaginary stereo STFT, (B, 4, dim_f, dim_t).  The graph runs on
`interop/onnx_run.py` on its device (the card unless the caller asks for
the CPU), and so does the rest of a chunk:

    stft -> zero the 3 lowest bins -> model (+/- denoise pair) -> istft

then the windowed overlap-add of the chunks, of which only the trimmed
stem comes back to the host.  Chunking, overlap, trim and compensation
follow the reference demix loop (demix:162-249, run_model:251-273).
Nothing is cached between calls: the port compiles nothing, and the
chunk windows are made per call.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..device import full_fp32
from ..errors import BadRequest
from ..ops.stft import istft, stft_complex


@dataclasses.dataclass(frozen=True)
class MDXParams:
    """A model's hyperparameters: the reference takes them from its hash ->
    registry yaml (separator.py:255-273); here they are given, or read
    from the graph's metadata and input shape (`params_from_graph`)."""

    n_fft: int
    dim_f: int
    dim_t: int           # frames per model window (2**mdx_dim_t_set)
    compensate: float = 1.0
    segment_size: int | None = None   # defaults to dim_t
    overlap: float = 0.25
    hop_length: int = 1024
    enable_denoise: bool = False

    @property
    def seg(self) -> int:
        return self.segment_size or self.dim_t


def params_from_graph(graph, **overrides) -> MDXParams:
    """dim_f / dim_t from the graph's static input shape (MDX models are
    exported with a fixed (B, 4, dim_f, dim_t)), n_fft / hop_length /
    compensate from its metadata, then `overrides`.  An n_fft found
    nowhere is a BadRequest."""
    vi = graph.graph.input[0]
    shape = vi.type.tensor_type.shape if vi.type and vi.type.tensor_type else None
    dims = [d.dim_value for d in shape.dim] if shape else []
    md = graph.metadata
    kw = {}
    if len(dims) == 4 and dims[2] and dims[3]:
        kw["dim_f"], kw["dim_t"] = int(dims[2]), int(dims[3])
    for k in ("n_fft", "dim_f", "dim_t", "hop_length"):
        if k in md:
            kw[k] = int(md[k])
    if "compensate" in md:
        kw["compensate"] = float(md["compensate"])
    kw.update(overrides)
    if "n_fft" not in kw:
        raise BadRequest("n_fft is not recoverable from the MDX graph: pass n_fft= "
                         "(the reference takes it from its model registry)")
    return MDXParams(**kw)


def _hann(n: int) -> np.ndarray:
    # periodic hann (torch.hann_window(periodic=True))
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def mdx_stft(x, *, n_fft: int, hop: int, dim_f: int):
    """x: (B, 2, T) -> (B, 4, dim_f, frames), [re, im] per channel
    (reference STFT.__call__:275-293: reflect center pad, hann)."""
    b, c, t = x.shape
    spec = stft_complex(x.reshape(b * c, t), n_fft=n_fft, hop_length=hop, win_length=n_fft,
                        window=_hann(n_fft), center=True, pad_mode="reflect")
    spec = spec.transpose(1, 2)                             # (BC, bins, frames)
    out = torch.stack([spec.real, spec.imag], dim=1)        # (BC, 2, bins, frames)
    out = out.reshape(b, c * 2, n_fft // 2 + 1, spec.shape[-1])
    return out[:, :, :dim_f, :].to(x.dtype)


def mdx_istft(spec, *, n_fft: int, hop: int, length: int):
    """(B, 4, dim_f, frames) -> (B, 2, length): torch.istft's windowed
    overlap-add over the summed squared window (clamped at 1e-11), then
    the center trim of n_fft // 2."""
    b, c2, dim_f, n_frames = spec.shape
    n_bins = n_fft // 2 + 1
    spec = torch.nn.functional.pad(spec, (0, 0, 0, n_bins - dim_f))
    spec = spec.reshape(b * (c2 // 2), 2, n_bins, n_frames)
    z = torch.complex(spec[:, 0], spec[:, 1]).transpose(1, 2)    # (BC, frames, bins)
    out = istft(z, n_fft=n_fft, hop_length=hop, win_length=n_fft, window=_hann(n_fft),
                length=length)
    return out.reshape(b, c2 // 2, length)


# ---------------------------------------------------------------------------
# the model on a batch of chunks, and the chunked demix
# ---------------------------------------------------------------------------

def _graph_batch_static_one(graph) -> bool:
    """True when the graph was exported with a fixed batch of 1: then the
    chunks go through it one at a time instead of as one batch."""
    try:
        return graph.graph.input[0].type.tensor_type.shape.dim[0].dim_value == 1
    except (AttributeError, IndexError, TypeError):
        return False


def _run_graph(graph, spek):
    return graph.run({graph.input_names[0]: spek})[0]


def _apply_graph(graph, p: MDXParams, spek):
    """The model on (N, 4, dim_f, dim_t); with denoise, the mean of the
    model on spek and minus the model on -spek (reference
    mdx_separator.py:261-264), the pair in one batched call unless the
    graph's batch is a fixed 1, which takes one call per chunk."""
    if graph is None:                       # is_match_mix: the identity
        return spek
    if _graph_batch_static_one(graph):
        outs = []
        for s in spek.split(1):
            if p.enable_denoise:
                outs.append(_run_graph(graph, s) * 0.5 - _run_graph(graph, -s) * 0.5)
            else:
                outs.append(_run_graph(graph, s))
        return torch.cat(outs, dim=0)
    if p.enable_denoise:
        neg, pos = _run_graph(graph, torch.cat([-spek, spek], dim=0)).chunk(2, dim=0)
        return pos * 0.5 - neg * 0.5
    return _run_graph(graph, spek)


def _run_model(graph, p: MDXParams, mix):
    """(N, 2, chunk) -> (N, 2, chunk): stft, the 3 lowest bins zeroed
    (reference run_model:256), the model, istft."""
    spek = mdx_stft(mix, n_fft=p.n_fft, hop=p.hop_length, dim_f=p.dim_f)
    spek[:, :, :3, :] = 0.0
    pred = _apply_graph(graph, p, spek)
    return mdx_istft(pred, n_fft=p.n_fft, hop=p.hop_length, length=mix.shape[-1])


def mdx_demix(graph, mix: np.ndarray, p: MDXParams, *,
              is_match_mix: bool = False) -> np.ndarray:
    """The reference demix (:162-249): hann-windowed overlap-add of the
    model over chunks (of the identity with is_match_mix, at overlap
    0.02).  mix: (2, T) float32 -> (2, T) float32.  Runs on the graph's
    device; the overlap-add stays there and only the trimmed stem comes
    back, in float16 under RVC_TPU_FETCH_F16=1."""
    dev = graph.device
    trim = p.n_fft // 2
    chunk_size = p.hop_length * (p.seg - 1)
    overlap = 0.02 if is_match_mix else p.overlap
    gen_size = chunk_size - 2 * trim
    pad = gen_size + trim - (mix.shape[-1] % gen_size)
    mixture = np.concatenate((np.zeros((2, trim), np.float32), mix.astype(np.float32),
                              np.zeros((2, pad), np.float32)), axis=1)
    step = int((1 - overlap) * chunk_size)
    total_len = mixture.shape[-1]

    starts = list(range(0, total_len, step))
    parts = np.zeros((len(starts), 2, chunk_size), np.float32)
    windows = np.zeros((len(starts), chunk_size), np.float32)
    divider = np.zeros(total_len, np.float64)
    for i, start in enumerate(starts):
        end = min(start + chunk_size, total_len)
        actual = end - start
        parts[i, :, :actual] = mixture[:, start:end]
        w = (np.hanning(actual) if overlap != 0 else np.ones(actual)).astype(np.float32)
        windows[i, :actual] = w
        divider[start:end] += w
    div = np.maximum(divider, 1e-10).astype(np.float32)
    scale = 1.0 if is_match_mix else p.compensate

    with full_fp32(dev), torch.inference_mode():
        batch = torch.as_tensor(parts, device=dev)
        tar = _run_model(None if is_match_mix else graph, p, batch)
        tar = tar * torch.as_tensor(windows, device=dev)[:, None, :]
        out = torch.zeros((2, total_len), dtype=tar.dtype, device=dev)
        for i, start in enumerate(starts):
            n = min(chunk_size, total_len - start)
            out[:, start:start + n] += tar[i, :, :n]
        out = out / torch.as_tensor(div, device=dev)
        out = out[:, trim:trim + mix.shape[-1]] * scale
        if os.environ.get("RVC_TPU_FETCH_F16", "0") == "1":
            out = out.half()
        return out.cpu().numpy().astype(np.float32)


def mdx_separate(graph, mix: np.ndarray, p: MDXParams, *, invert_using_spec: bool = False,
                 normalization_threshold: float = 0.9):
    """The reference MDXSeparator.separate (:62-104): (primary, secondary)
    stems, each (2, T)."""
    from . import spec_tools as st

    mix = st.normalize(mix.astype(np.float32), max_peak=normalization_threshold)
    source = mdx_demix(graph, mix, p)
    primary = st.normalize(source, max_peak=normalization_threshold)
    if invert_using_spec:
        raw_mix = mdx_demix(graph, mix, p, is_match_mix=True)
        secondary = st.invert_stem(raw_mix, source, device=graph.device)
    else:
        secondary = (mix.T - source.T).T
    return primary, secondary
