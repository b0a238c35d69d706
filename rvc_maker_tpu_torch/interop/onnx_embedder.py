"""ONNX embedder interchange (HuBERT / ContentVec `.onnx` mode).

Counterpart of `rvc_maker_tpu/interop/onnx_embedder.py`.  The
reference's embedder loader has three modes: fairseq .pt, onnxruntime
.onnx, transformers directory (library/utils.py:131-170).  The first
and third are `models/hubert.py`'s loaders; this module adds the .onnx
mode, run on the card by `interop/onnx_run.py`, and the export of the
port's HuBERT to .onnx.

Graph interface (what the export writes; torch-exported ContentVec
graphs with a single waveform input load too):
    inputs : source (1, L) f32, lengths (1,) i32
    outputs: feats (1, T, C)  [C = 768 v2 raw layer 12, 256 v1 projected]
Metadata: embedder_info JSON {version, max_samples, min_samples}.

The port's dynamic export holds for L >= DYNAMIC_MIN_SAMPLES (720, two
frames: torch.export proves the trace for a frame count above 1 only),
where the JAX exporter's holds from MIN_SAMPLES (400); `features` pads
shorter audio to the graph's minimum, which the `lengths` input masks
out of the valid frames.
"""

from __future__ import annotations

import json
import os

import torch
import torch.nn.functional as F

from ..models import hubert as hubert_mod
from . import onnx_proto as proto
from .onnx_export import export_onnx
from .onnx_run import OnnxGraph


def n_frames(n_samples: int) -> int:
    """Conv front end frames of an input length (320x downsampling)."""
    t = int(n_samples)
    for _dim, k, stride in hubert_mod.CONV_LAYERS:
        t = (t - k) // stride + 1
    return t


def _min_samples() -> int:
    """Shortest waveform that gives one front-end frame (the stack's
    receptive field, 400 samples)."""
    r = 1
    for _dim, k, stride in reversed(hubert_mod.CONV_LAYERS):
        r = (r - 1) * stride + k
    return r


MIN_SAMPLES = _min_samples()
DYNAMIC_MIN_SAMPLES = MIN_SAMPLES + 320


def export_embedder(params, path: str, *, version: str = "v2", max_samples: int = 160000,
                    dynamic: bool = True) -> str:
    """Export HuBERT params (`models/hubert.py` tree) to .onnx: v2 layer
    12, v1 layer 9 through final_proj.  dynamic=True (default) marks the
    waveform axis symbolic; dynamic=False gives a graph of capacity
    max_samples (default 10 s at 16 kHz)."""
    L = int(max_samples)

    def fwd(p, source, lengths):
        feats, _ = hubert_mod.extract_features(p, source, lengths,
                                               output_layer=12 if version == "v2" else 9)
        return hubert_mod.final_proj(p, feats) if version == "v1" else feats

    min_samples = DYNAMIC_MIN_SAMPLES if dynamic else MIN_SAMPLES
    args = (torch.zeros(1, max(L, min_samples)), torch.full((1,), max(L, min_samples),
                                                            dtype=torch.int32))
    model = export_onnx(
        fwd, args, params=params, input_names=["source", "lengths"], output_names=["feats"],
        dynamic_axes={"source": {1: "l"}} if dynamic else None,
        dim_constraints=[f"l >= {min_samples}"] if dynamic else (),
        metadata={"embedder_info": json.dumps(
            {"version": version, "max_samples": "dynamic" if dynamic else L,
             "min_samples": min_samples})})
    proto.save_model(model, path)
    return path


class OnnxEmbedder:
    """In place of the HuBERT params tree in ConvertPipeline's feature
    stage: features(audio, lengths) -> (B, T, C) on `device` (the card
    unless the caller passes "cpu")."""

    def __init__(self, path: str, *, device="cuda"):
        self.graph = OnnxGraph(path, device=device)
        self.device = self.graph.device
        info = json.loads(self.graph.metadata.get("embedder_info", "{}"))
        self.version = info.get("version", "v2")
        ms = info.get("max_samples") or 0
        # dynamic exports and torch graphs (no metadata) serve any length;
        # only static graphs carry a numeric capacity
        self.dynamic = ms in (0, "dynamic")
        self.max_samples = None if self.dynamic else int(ms)
        self.min_samples = int(info.get("min_samples", 0) or 0)
        self._has_lengths = "lengths" in self.graph.input_names

    def features(self, audio, lengths):
        """audio (B, L), lengths (B,) -> features (B, n_frames(L), C): the
        audio padded to the graph's minimum or capacity (more than the
        capacity raises), run row by row, trimmed to L's frames."""
        b, L = audio.shape
        if self.dynamic:
            cap = max(L, self.min_samples)
        else:
            cap = self.max_samples or L
            if L > cap:
                raise ValueError(f"audio bucket {L} exceeds the embedder graph capacity {cap}; "
                                 f"re-export with a larger max_samples (or use the default "
                                 f"dynamic export)")
        audio = torch.as_tensor(audio)
        if L < cap:
            audio = F.pad(audio, (0, cap - L))
        lengths = torch.as_tensor(lengths).to(torch.int32)
        rows = []
        for i in range(b):
            feeds = {"source": audio[i:i + 1]}
            if self._has_lengths:
                feeds["lengths"] = lengths[i:i + 1]
            rows.append(self.graph.run(feeds)[0][0])
        return torch.stack(rows)[:, : n_frames(L)]


def load_embedder(path_or_params, *, device="cuda"):
    """A .onnx path (an OnnxEmbedder on `device`), a fairseq .pt path, a
    transformers directory, or an already built params tree (returned as
    it is): the reference's load_embedders_model."""
    if isinstance(path_or_params, str):
        if path_or_params.endswith(".onnx"):
            return OnnxEmbedder(path_or_params, device=device)
        if os.path.isdir(path_or_params):
            return hubert_mod.load_transformers_dir(path_or_params)
        return hubert_mod.load_hubert_pt(path_or_params)
    return path_or_params
