"""ONNX voice-model interchange: export a `.pth` voice model to `.onnx`,
and run `.onnx` voice models in the conversion pipeline.

Counterpart of `rvc_maker_tpu/interop/onnx_voice.py`, with its file
contract (reference main/library/algorithm/onnx_export.py:16-50 for the
export, main/inference/convert.py:545-552 for the load):

  * inputs `phone` (1, T, emb), `phone_lengths` (1,), `pitch` (1, T),
    `pitchf` (1, T), `ds` (1,), `rnd` (1, T, inter) and `sine_noise`
    (1, T*upp, 1), NTC; an f0-less model takes phone, phone_lengths, ds
    and rnd; output `audio` (1, T*upp);
  * metadata `model_info` (the reference's summary JSON), `config_list`
    (the 18 hyperparameters), `max_frames` ("dynamic" or the capacity),
    `min_frames` (21 when dynamic: the rel-attention band's minimum) and
    `layout` ("NTC");
  * the default export is dynamic on the frame axis (one file serves any
    length >= 21 frames; the loader pads shorter chunks);
    `dynamic=False` gives a graph of fixed capacity `max_frames`.

The export traces the port's `models/synthesizer.py` `infer` with
`interop/onnx_export.py`; the graph runs on the card through
`interop/onnx_run.py`.  Graphs in the torch convention of the reference
exporter (only `model_info`, `rnd` as (1, inter, T), no `sine_noise`)
load too, their config rebuilt from `preset(version, sr)`.
"""

from __future__ import annotations

import dataclasses
import json

import torch
import torch.nn.functional as F

from ..config import model_config_from_ckpt_list, model_config_to_ckpt_list, preset
from . import onnx_proto as proto
from .onnx_export import export_onnx
from .onnx_run import OnnxGraph

INPUT_NAMES_F0 = ["phone", "phone_lengths", "pitch", "pitchf", "ds", "rnd", "sine_noise"]
INPUT_NAMES_NOF0 = ["phone", "phone_lengths", "ds", "rnd"]
MIN_FRAMES = 21  # 2 * rel_attn_window_size + 1


def export_voice_model(pth_path: str, onnx_path: str, *, max_frames: int = 200,
                       dynamic: bool = True) -> str:
    """Export a reference-format `.pth` voice model to ONNX (the JAX
    `export_voice_model`'s contract, module docstring).  The trace runs
    on the CPU.  Only the NSF-HiFiGAN decoder (and the plain decoder of
    f0-less models) is covered, as in the JAX package."""
    from ..models import synthesizer as syn
    from .pth import load_synthesizer_pth

    params, cfg, meta = load_synthesizer_pth(pth_path)
    if cfg.vocoder != "Default":
        raise NotImplementedError(f"ONNX export currently covers the NSF-HiFiGAN decoder; "
                                  f"model uses {cfg.vocoder}")
    T = int(max_frames)
    emb = cfg.text_enc_hidden_dim
    i32 = torch.int32
    if cfg.use_f0:
        def fwd(p, phone, phone_lengths, pitch, pitchf, ds, rnd, sine_noise):
            return syn.infer(p, cfg, phone, phone_lengths, pitch, pitchf, ds, rnd,
                             sine_noise)[0][:, :, 0]

        args = (torch.zeros(1, T, emb), torch.full((1,), T, dtype=i32),
                torch.zeros(1, T, dtype=i32), torch.zeros(1, T), torch.zeros(1, dtype=i32),
                torch.zeros(1, T, cfg.inter_channels), torch.zeros(1, T * cfg.upp, 1))
        input_names = INPUT_NAMES_F0
        dyn = {"phone": {1: "t"}, "pitch": {1: "t"}, "pitchf": {1: "t"}, "rnd": {1: "t"},
               "sine_noise": {1: f"{cfg.upp}*t"}}
    else:
        def fwd(p, phone, phone_lengths, ds, rnd):
            return syn.infer(p, cfg, phone, phone_lengths, None, None, ds, rnd,
                             None)[0][:, :, 0]

        args = (torch.zeros(1, T, emb), torch.full((1,), T, dtype=i32),
                torch.zeros(1, dtype=i32), torch.zeros(1, T, cfg.inter_channels))
        input_names = INPUT_NAMES_NOF0
        dyn = {"phone": {1: "t"}, "rnd": {1: "t"}}

    model_info = {
        "model_name": meta.get("model_name"),
        "author": meta.get("author"),
        "epoch": meta.get("epoch"),
        "step": meta.get("step"),
        "version": meta.get("version", "v1"),
        "sr": cfg.sr,
        "f0": int(cfg.use_f0),
        "model_hash": meta.get("model_hash"),
        "creation_date": meta.get("creation_date"),
        "vocoder": cfg.vocoder,
        "text_enc_hidden_dim": emb,
    }
    model = export_onnx(
        fwd, args, params=params, input_names=input_names, output_names=["audio"],
        dynamic_axes=dyn if dynamic else None,
        dim_constraints=[f"t >= {MIN_FRAMES}"] if dynamic else (),
        metadata={
            "model_info": json.dumps(model_info),
            "config_list": json.dumps(model_config_to_ckpt_list(cfg)),
            "max_frames": "dynamic" if dynamic else str(T),
            "min_frames": str(MIN_FRAMES) if dynamic else "0",
            "layout": "NTC",
        })
    proto.save_model(model, onnx_path)
    return onnx_path


class OnnxVoiceModel:
    """A `.onnx` voice model that ConvertPipeline takes in place of the
    params tree: `synth` runs the graph on `device` (the card unless the
    caller passes "cpu")."""

    def __init__(self, path: str, *, device="cuda"):
        self.graph = OnnxGraph(path, device=device)
        self.device = self.graph.device
        md = self.graph.metadata
        if "model_info" not in md:
            raise ValueError(f"{path}: no model_info metadata, not an RVC voice model")
        self.info = json.loads(md["model_info"])
        self.version = self.info.get("version", "v1")
        self.use_f0 = bool(self.info.get("f0", 1))
        emb = self.info.get("text_enc_hidden_dim")
        if "config_list" in md:
            self.cfg = model_config_from_ckpt_list(
                json.loads(md["config_list"]), use_f0=self.use_f0, version=self.version,
                vocoder=self.info.get("vocoder", "Default"))
            if emb and emb != self.cfg.text_enc_hidden_dim:
                self.cfg = dataclasses.replace(self.cfg, text_enc_hidden_dim=int(emb))
            self.torch_layout = md.get("layout") != "NTC"
        else:
            # the reference's torch export embeds only model_info
            # (onnx_export.py:50): RVC checkpoints are preset-shaped, so
            # the config comes from (version, sr), inter_channels from the
            # graph's own `rnd` input (1, inter, T)
            self.cfg = preset(self.version, int(self.info.get("sr", 40000))).model
            if emb:
                self.cfg = dataclasses.replace(self.cfg, text_enc_hidden_dim=int(emb))
            if not self.use_f0 and self.cfg.use_f0:
                self.cfg = dataclasses.replace(self.cfg, use_f0=False)
            for vi in self.graph.graph.input:
                if vi.name == "rnd" and vi.type is not None:
                    dims = vi.type.tensor_type.shape.dim
                    if len(dims) == 3 and dims[1].dim_value:
                        self.cfg = dataclasses.replace(self.cfg,
                                                       inter_channels=int(dims[1].dim_value))
            self.torch_layout = True  # rnd rides (1, inter, T)
        mf = md.get("max_frames", "")
        # dynamic graphs (the default export, and torch exports) have no
        # capacity; min_frames is the rel-attention band's minimum
        self.dynamic = mf in ("", "dynamic")
        self.max_frames = None if self.dynamic else int(mf)
        self.min_frames = int(md.get("min_frames", 0) or 0)

    def synth(self, feats, frame_lengths, pitch, pitchf, sid, z_noise, sine_noise):
        """In place of `synthesizer.infer(...)[0][..., 0]`: the waveform
        (B, T*upp) on the device.  A dynamic graph gets chunks padded up
        to its minimum, a static one to its capacity (more frames than it
        holds raise); the graph runs row by row (it was traced at B = 1)."""
        cfg = self.cfg
        b, t = feats.shape[0], feats.shape[1]
        if self.dynamic:
            cap = max(t, self.min_frames)
        else:
            cap = self.max_frames or t
            if t > cap:
                raise ValueError(
                    f"chunk has {t} frames but the ONNX graph was exported with "
                    f"max_frames={cap}; re-export with a larger capacity (or use the "
                    f"default dynamic export)")
        pad = cap - t
        if pad:
            feats = F.pad(feats, (0, 0, 0, pad))
            pitchf = F.pad(pitchf, (0, pad))
            if pitch is not None:
                pitch = F.pad(pitch, (0, pad))
            z_noise = F.pad(z_noise, (0, 0, 0, pad))
            if sine_noise is not None:
                sine_noise = F.pad(sine_noise, (0, 0, 0, pad * cfg.upp))
        known = set(self.graph.input_names)
        rows = []
        for i in range(b):
            feeds = {"phone": feats[i:i + 1], "phone_lengths": frame_lengths[i:i + 1],
                     "ds": sid[i:i + 1], "rnd": z_noise[i:i + 1]}
            if self.use_f0:
                feeds.update(pitch=pitch[i:i + 1], pitchf=pitchf[i:i + 1],
                             sine_noise=sine_noise[i:i + 1])
            if self.torch_layout:
                # torch convention: rnd (1, inter, T), no sine_noise input,
                # audio may keep a channel axis
                feeds["rnd"] = feeds["rnd"].transpose(1, 2)
                feeds = {k: v for k, v in feeds.items() if k in known}
                rows.append(self.graph.run(feeds)[0].reshape(-1))
            else:
                rows.append(self.graph.run(feeds)[0][0])
        return torch.stack(rows)[:, : t * cfg.upp]


def load_voice_model(path: str, *, device="cuda"):
    """A voice model by its extension: (synth, cfg, meta), synth a params
    tree (.pth, on the CPU) or an OnnxVoiceModel on `device` (.onnx)."""
    if str(path).endswith(".onnx"):
        vm = OnnxVoiceModel(path, device=device)
        return vm, vm.cfg, dict(vm.info)
    from .pth import load_synthesizer_pth

    return load_synthesizer_pth(path)
