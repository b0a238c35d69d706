"""Exact k-NN feature retrieval and the index build (counterpart of
`rvc_maker_tpu/retrieval/index.py`).

The dense index matrix is searched exactly (k = 8, squared L2) with one
matmul and a top-k, and the query is blended with its neighbours under
inverse-square-distance weights (reference convert.py:349-359).

The build (reference create_index.py): shuffle the extracted features,
compress them to 10,000 centroids with mini-batch Lloyd k-means on the
device when there are more than 2e5 rows, keep the dense matrix
(`build_index`), save it as `.npz` (`save_index`).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..device import resolve_device
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


def kmeans(x, n_clusters: int, *, n_iters: int = 25, batch_size: int = 16384,
           generator: torch.Generator | None = None, init_idx=None, batch_idx=None):
    """Mini-batch Lloyd k-means on x's device (JAX index.py:85-125).

    x: (N, D) float tensor.  The initial centroids are the rows
    `init_idx` (n_clusters,) and iteration i's batch the rows
    `batch_idx[i]` (batch_size,), each drawn without replacement from
    `generator` when not given.  Per iteration: each batch row goes to
    its nearest centroid (`topk_l2`), the rows are summed per centroid
    (`index_add_`), and a centroid that got rows moves to the batch mean
    at the rate (rows now) / (rows so far, from 1).  Returns the
    (n_clusters, D) centroids."""
    n = x.shape[0]
    batch_size = min(batch_size, n)
    dev = x.device

    def draw(k):
        gdev = generator.device if generator is not None else dev
        return torch.randperm(n, generator=generator, device=gdev)[:k]

    init_idx = draw(n_clusters) if init_idx is None else torch.as_tensor(init_idx)
    centroids = x[init_idx.to(dev)].clone()
    counts = torch.ones(n_clusters, device=dev, dtype=x.dtype)
    ones = torch.ones(batch_size, device=dev, dtype=x.dtype)
    for i in range(n_iters):
        rows = draw(batch_size) if batch_idx is None else torch.as_tensor(batch_idx[i])
        batch = x[rows.to(dev)]
        assign = topk_l2(batch, centroids, k=1)[1][:, 0]
        sums = torch.zeros_like(centroids).index_add_(0, assign, batch)
        cnt = torch.zeros_like(counts).index_add_(0, assign, ones)
        counts = counts + cnt
        rate = (cnt / counts)[:, None]
        mean = sums / torch.clamp(cnt, min=1.0)[:, None]
        centroids = torch.where((cnt > 0)[:, None],
                                centroids * (1 - rate) + mean * rate, centroids)
    return centroids


def build_index(features: np.ndarray, *, version: str = "v2", max_rows: float = 2e5,
                n_clusters: int = 10000, seed: int = 0,
                device: str | torch.device = "cuda") -> FeatureIndex:
    """Reference create_index.py: the rows shuffled (numpy, `seed`), then
    k-means to `n_clusters` centroids on `device` (its generator seeded
    with `seed`) when there are more than `max_rows`; the dense matrix
    otherwise.  device="cuda" raises when no card is present."""
    dev = resolve_device(device)
    feats = np.ascontiguousarray(features, dtype=np.float32)
    feats = feats[np.random.RandomState(seed).permutation(feats.shape[0])]
    if feats.shape[0] > max_rows:
        x = torch.as_tensor(feats, device=dev)
        gen = torch.Generator(dev).manual_seed(seed)
        feats = kmeans(x, n_clusters, generator=gen).cpu().numpy()
    return FeatureIndex(vectors=feats, version=version)


def save_index(index: FeatureIndex, path: str) -> None:
    """The `.npz` that `load_index` reads (JAX `save_index`)."""
    np.savez_compressed(path, vectors=index.vectors,
                        meta=json.dumps({"version": index.version,
                                         "sample_rate": index.sample_rate}))


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
