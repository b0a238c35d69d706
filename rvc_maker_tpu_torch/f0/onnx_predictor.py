"""ONNX F0 predictors (the reference's --f0_onnx, library/utils.py:23-27).

Counterpart of `rvc_maker_tpu/f0/onnx_predictor.py`.  The reference runs
`rmvpe.onnx` / `crepe_*.onnx` / `fcpe*.onnx` through onnxruntime; here
the graph runs on `interop/onnx_run.py`'s executor on the graph's device,
between the port's own front ends (mel, framing) and decoders
(local-average cents, Viterbi).

Graph I/O (reference usage):
  * RMVPE:  mel (B, 128, T) -> salience (B, T, 360)          (RMVPE.py:214)
  * CREPE:  frames (N, 1024) -> probs (N, 360)               (CREPE.py:95)
  * FCPE:   mel (B, T, 128) + threshold () -> f0 (B, T, 1)   (FCPE.py:791)
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _run_batch(graph, x, extra=None):
    """The graph's first output on x (B, ...) as its first input; a graph
    traced at a fixed batch of 1 runs row by row."""
    feeds = dict(extra or {})
    vi = next(v for v in graph.graph.input if v.name == graph.input_names[0])
    dims = vi.type.tensor_type.shape.dim if vi.type is not None and vi.type.tensor_type else []
    if dims and dims[0].dim_value == 1 and x.shape[0] > 1:
        return torch.cat([graph.run({**feeds, graph.input_names[0]: x[i:i + 1]})[0]
                          for i in range(x.shape[0])])
    return graph.run({**feeds, graph.input_names[0]: x})[0]


def rmvpe_onnx_infer(graph, audio_16k, *, thred: float = 0.03,
                     f0_min: float | None = None, f0_max: float | None = None):
    """audio_16k (B, L) -> f0 (B, L // 160 + 1) Hz through an rmvpe.onnx
    graph; the mel reflect-padded to a multiple of 32 frames, as
    `models/rmvpe.py` `infer` pads it."""
    from ..models.rmvpe import decode_cents
    from ..ops.stft import rmvpe_mel

    mel = rmvpe_mel(torch.as_tensor(audio_16k, device=graph.device))
    n_frames = mel.shape[-1]
    pad_to = 32 * ((n_frames - 1) // 32 + 1)
    mel = F.pad(mel, (0, pad_to - n_frames), mode="reflect")
    hidden = _run_batch(graph, mel.to(torch.float32))
    f0 = decode_cents(hidden[:, :n_frames].to(torch.float32), thred=thred)
    if f0_min is not None:
        f0 = torch.where((f0 < f0_min) | (f0 > f0_max), 0.0, f0)
    return f0


def crepe_probs(graph, audio_16k, hop_length: int):
    """(B, L) -> (B, 1 + L // hop, 360) through a crepe_*.onnx graph, on
    `models/crepe.py`'s framing (frames of all rows in one run)."""
    from ..models import crepe as crepe_mod

    frames = crepe_mod.frame_audio(torch.as_tensor(audio_16k, device=graph.device),
                                   hop_length)
    b, t, _ = frames.shape
    probs = graph.run({graph.input_names[0]: frames.reshape(b * t, -1)})[0]
    return probs.reshape(b, t, -1)


def crepe_onnx_infer(graph, audio_16k, *, hop_length: int = 160, fmin: float = 50.0,
                     fmax: float = 1100.0, mangio: bool = False, filter_radius: int = 3):
    """audio_16k (L,) -> f0 (T,) numpy through a crepe_*.onnx graph, with
    `models/crepe.py`'s Viterbi / argmax decode."""
    from ..models import crepe as crepe_mod

    x = torch.as_tensor(np.asarray(audio_16k, np.float32))[None]
    probs = crepe_probs(graph, x, hop_length)[0].cpu().numpy()   # (T, 360)
    if mangio:
        bins = probs.argmax(axis=-1)
        f0 = crepe_mod.bins_to_frequency(bins, dither=np.zeros_like(bins, float))
        return np.where(probs.max(axis=-1) > 1e-3, f0, 0.0)
    f0, periodicity = crepe_mod.decode(probs[None], fmin=fmin, fmax=fmax,
                                       return_periodicity=True)
    f0 = crepe_mod.mean_filter(f0, 3)
    periodicity = crepe_mod.median_filter(periodicity, filter_radius)
    return np.where(periodicity > 0.1, f0, 0.0)[0]


def fcpe_onnx_infer(graph, audio_16k, *, threshold: float = 0.03, p_len: int | None = None):
    """audio_16k (B, L) -> f0 (B, p_len) Hz through an fcpe .onnx graph,
    which takes the mel and the threshold and gives Hz (FCPE.py:791)."""
    from ..models.fcpe import fcpe_mel, interp_to_length

    mel = fcpe_mel(torch.as_tensor(audio_16k, device=graph.device))
    extra = ({graph.input_names[1]: torch.tensor(threshold, dtype=torch.float32)}
             if len(graph.input_names) > 1 else {})
    f0 = _run_batch(graph, mel.to(torch.float32), extra)
    if f0.dim() == 3:
        f0 = f0[..., 0]
    if p_len is not None:
        f0 = interp_to_length(f0, p_len)
    return f0
