"""Tensor parallelism for the HuBERT encoder (JAX `parallel/tensor.py`).

Each rank holds a slice of every transformer layer: q, k, v and fc1 split
on their output features (its heads, its part of the FFN's hidden width),
o and fc2 on their input features.  Each rank computes its heads and its
hidden slice; one all-reduce after o and one after fc2 sum the partial
products, and those two layers' biases are added once, after the sum.
Everything else is the same on every rank.  JAX annotates the same
shardings and lets GSPMD insert the two psums per layer.

Layouts (`models/hubert.py`, one dict per layer, torch (out, in) weights):
  layers[i].attn.{q,k,v}.w (C, C), .b (C,)  -> split dim 0 (heads)
  layers[i].fc1.w (4C, C), .b (4C,)         -> split dim 0 (hidden)
  layers[i].attn.o.w (C, C), fc2.w (C, 4C)  -> split dim 1
  layers[i].attn.o.b, fc2.b                 -> whole (added after the sum)
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from ..models import hubert as hubert_mod
from . import distributed as dist_mod
from . import mesh

_COLUMN = ("q", "k", "v", "fc1")
_ROW = ("o", "fc2")


def hubert_tp_spec(path: tuple[str, ...]) -> Optional[int]:
    """The dim along which a HuBERT leaf is split (its path of keys and
    list indices, as strings), or None when every rank holds it whole."""
    if "layers" not in path:
        return None
    layer, leaf = path[-2], path[-1]
    if layer in _COLUMN:
        return 0
    if layer in _ROW and leaf == "w":
        return 1
    return None


def shard_hubert_tp(params: Any, rank: int | None = None, world: int | None = None) -> Any:
    """This rank's HuBERT params under tensor parallelism (JAX
    `shard_hubert_tp`).  The heads (12) and the FFN width (3072) must split
    evenly over the ranks."""
    rank = dist_mod.process_index() if rank is None else rank
    world = dist_mod.process_count() if world is None else world

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (str(i),)) for i, v in enumerate(tree))
        dim = hubert_tp_spec(path)
        if dim is None:
            return tree
        if hubert_mod.N_HEADS % world:
            raise ValueError(f"{hubert_mod.N_HEADS} heads do not split over {world} ranks")
        return torch.as_tensor(tree).chunk(world, dim=dim)[rank].contiguous()

    return walk(params, ())


def tp_extract_features(params: Any, audio, lengths=None, *, version: str = "v2"):
    """HuBERT features from this rank's tensor-parallel params
    (`shard_hubert_tp`), the same on every rank (JAX
    `tp_extract_features`): layer 12 for v2, layer 9 through `final_proj`
    for v1."""
    def reduce(y):
        mesh.all_reduce_([y])

    feats, _ = hubert_mod.extract_features(params, audio, lengths,
                                           output_layer=12 if version == "v2" else 9,
                                           reduce=reduce)
    if version == "v1":
        feats = hubert_mod.final_proj(params, feats)
    return feats
