"""Model management utilities: fusion, info, hash — host-side .pth ops.

A copy of `rvc_maker_tpu/utils/model_tools.py` (torch.load / torch.save on
the host).  A fused `.pth` loads in `interop/pth.py` `load_synthesizer_pth`.

Reference: app.py fushion_model_pth:554-630 (weighted blend of two
interchange checkpoints), model_info:658 (metadata reader), plus the
sha256 model hash the trainer embeds (train.py:724-744).
"""

from __future__ import annotations

import datetime
import hashlib
import os
from collections import OrderedDict
from typing import Any

from ..errors import BadRequest


def _strip_training_ckpt(ckpt) -> dict:
    """G_*.pth training checkpoints hold {'model': sd}; inference weights
    hold {'weight': sd}. Normalize to a weight dict without enc_q."""
    sd = ckpt["model"] if "model" in ckpt else ckpt["weight"]
    return {k: v for k, v in sd.items() if "enc_q" not in k}


def fuse_models(pth_1: str, pth_2: str, out_path: str, ratio: float = 0.5,
                info: str = "") -> str:
    """Blend two same-architecture checkpoints: out = r*a + (1-r)*b.

    Speaker embedding tables of different sizes are blended over the
    common prefix (reference app.py:607-610). Returns out_path.  Models
    of different rates or architectures are a BadRequest.
    """
    import torch

    ckpt1 = torch.load(pth_1, map_location="cpu", weights_only=False)
    ckpt2 = torch.load(pth_2, map_location="cpu", weights_only=False)
    if ckpt1["sr"] != ckpt2["sr"]:
        raise BadRequest(f"sample rates differ: {ckpt1['sr']} vs {ckpt2['sr']}")

    sd1 = _strip_training_ckpt(ckpt1)
    sd2 = _strip_training_ckpt(ckpt2)
    if sorted(sd1) != sorted(sd2):
        raise BadRequest("architectures differ (key sets not equal)")

    out: dict = {"weight": OrderedDict()}
    for key in sd1:
        a, b = sd1[key], sd2[key]
        if key == "emb_g.weight" and a.shape != b.shape:
            n = min(a.shape[0], b.shape[0])
            out["weight"][key] = (ratio * a[:n].float()
                                  + (1 - ratio) * b[:n].float()).half()
        else:
            out["weight"][key] = (ratio * a.float()
                                  + (1 - ratio) * b.float()).half()

    for meta in ("config", "sr", "f0", "version", "vocoder"):
        if meta in ckpt1:
            out[meta] = ckpt1[meta]
    out["infos"] = info or f"fused {os.path.basename(pth_1)} + {os.path.basename(pth_2)} @ {ratio}"
    out["creation_date"] = datetime.datetime.now().isoformat()
    out["model_hash"] = model_hash_of_state_dict(out["weight"])
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.save(out, out_path)
    return out_path


def model_hash_of_state_dict(sd) -> str:
    import numpy as np

    hasher = hashlib.sha256()
    for k in sorted(sd):
        v = sd[k]
        arr = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        hasher.update(k.encode())
        hasher.update(np.ascontiguousarray(arr).tobytes())
    return hasher.hexdigest()


def model_info(path: str) -> dict[str, Any]:
    """Read interchange checkpoint metadata (reference model_info app.py:658)."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("weight", ckpt.get("model", {}))
    n_params = sum(int(getattr(v, "numel", lambda: 0)()) for v in sd.values())
    return {
        "path": path,
        "sr": ckpt.get("sr"),
        "f0": ckpt.get("f0"),
        "version": ckpt.get("version"),
        "vocoder": ckpt.get("vocoder", "Default"),
        "epoch": ckpt.get("epoch"),
        "step": ckpt.get("step"),
        "author": ckpt.get("author"),
        "creation_date": ckpt.get("creation_date"),
        "model_hash": ckpt.get("model_hash"),
        "infos": ckpt.get("infos"),
        "n_parameters": n_params,
        "n_speakers": (sd["emb_g.weight"].shape[0]
                       if "emb_g.weight" in sd else None),
    }
