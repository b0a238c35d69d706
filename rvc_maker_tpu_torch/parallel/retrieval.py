"""Row-sharded retrieval blend (JAX `parallel/retrieval.py`).

The index's rows are split over the ranks (`shard_index_rows`, padding
rows far from any feature so they never win).  Each rank searches its
rows exactly (`retrieval.index.topk_l2`), the ranks exchange each
query's k best squared distances (k scalars per query per rank) and
merge them into the global top-k, which every rank computes alike; a
winner's place in the merged list names the rank that owns it and its
place in that rank's own list, so the row indices never travel.  The
blend is an all-reduce of each rank's weighted sum over the winners it
owns, so no feature vector crosses ranks.
"""

from __future__ import annotations

import torch

from ..retrieval.index import topk_l2
from . import distributed as dist_mod
from . import mesh

SENTINEL = 1e6    # the padding rows' value in every column (JAX's)


def shard_index_rows(vectors, rank: int | None = None, world: int | None = None):
    """This rank's rows of the (N, D) index (numpy or a tensor), padded to
    a multiple of the ranks with sentinel rows (JAX `shard_index_rows`).
    Returns a tensor on the index's device."""
    vectors = torch.as_tensor(vectors)
    world = dist_mod.process_count() if world is None else world
    pad = (-len(vectors)) % world
    if pad:
        vectors = torch.cat([vectors, vectors.new_full((pad, vectors.shape[1]), SENTINEL)])
    return vectors[mesh.rows_of(len(vectors), rank, world)]


def sharded_retrieval_blend(feats, vec_shard, index_rate, *, k: int = 8):
    """feats: (B, T, D), the same on every rank; vec_shard: this rank's
    (N / ranks, D) rows.  Returns the blended features of
    `retrieval.index.retrieval_blend` over the whole index, on every rank."""
    world, rank = dist_mod.process_count(), dist_mod.process_index()
    d2_local, idx_local = topk_l2(feats, vec_shard, k=k)           # (B, T, k)
    # every rank's k best distances, in rank order: (B, T, world * k)
    d2_all = mesh.all_gather_rows(d2_local[None], world)
    d2_all = d2_all.permute(1, 2, 0, 3).reshape(*d2_local.shape[:-1], world * k)
    neg, sel = torch.topk(-d2_all, k, dim=-1)
    w = 1.0 / torch.clamp(-neg, min=1e-12).square()
    w = w / w.sum(dim=-1, keepdim=True)
    mine = sel // k == rank
    idx = torch.gather(idx_local, -1, torch.where(mine, sel % k, 0))
    contrib = (vec_shard[idx] * (w * mine)[..., None]).sum(dim=-2)
    blended = mesh.all_reduce_([contrib])[0]
    return blended * index_rate + feats * (1.0 - index_rate)
