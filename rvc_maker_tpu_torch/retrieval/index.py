"""Exact k-NN feature retrieval (counterpart of
`rvc_maker_tpu/retrieval/index.py`).

The dense index matrix is searched exactly (k = 8, squared L2) with one
matmul and a top-k, and the query is blended with its neighbours under
inverse-square-distance weights (reference convert.py:349-359).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .faiss_io import read_index


@dataclasses.dataclass
class FeatureIndex:
    vectors: np.ndarray          # (N, D) float32
    version: str = "v2"          # v1 (256-d) | v2 (768-d)
    sample_rate: int = 16000


def topk_l2(queries, vectors, *, k: int = 8):
    """queries: (..., D); vectors: (N, D).  Returns (squared distances
    (..., k) ascending, indices (..., k)).  Distances are q² − 2q·x + x²
    in fp32, as the JAX package computes them, so neighbour order
    matches."""
    q2 = queries.square().sum(dim=-1, keepdim=True)
    x2 = vectors.square().sum(dim=-1)
    d2 = q2 - 2.0 * torch.matmul(queries, vectors.T) + x2
    neg, idx = torch.topk(-d2, k, dim=-1)
    return -neg, idx


def retrieval_blend(feats, vectors, index_rate, *, k: int = 8):
    """feats: (B, T, D); vectors: (N, D); index_rate in [0, 1].
    out = blend(neighbours) * rate + feats * (1 - rate)."""
    d2, idx = topk_l2(feats, vectors, k=k)
    w = 1.0 / torch.clamp(d2, min=1e-12).square()
    w = w / w.sum(dim=-1, keepdim=True)
    blended = (vectors[idx] * w[..., None]).sum(dim=-2)
    return blended * index_rate + feats * (1.0 - index_rate)


def load_index(path: str) -> FeatureIndex:
    """Load the JAX package's `.npz` index, a faiss `.index` file (the
    format of every RVC user's `added_*.index`, densified as the
    reference's faiss.read_index + reconstruct_n does) or a reference
    `total_fea.npy` dense matrix."""
    if path.endswith((".npy", ".index")):
        vec = (np.load(path) if path.endswith(".npy")
               else read_index(path).reconstruct_n()).astype(np.float32)
        return FeatureIndex(vectors=vec,
                            version="v1" if vec.shape[1] == 256 else "v2")
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    return FeatureIndex(vectors=data["vectors"].astype(np.float32),
                        version=meta.get("version", "v2"),
                        sample_rate=meta.get("sample_rate", 16000))
