"""Data parallelism over the ranks of the process group (JAX `parallel/mesh.py`).

Where the JAX package places arrays on a mesh (`shard_leading`: batch
rows over the 'data' axis; `replicate`: parameters on every device) and
lets XLA insert the collectives, each rank here holds its rows and a
full copy of the parameters, and calls the collectives itself:
`replicate` broadcasts from rank 0, `all_reduce_` sums (XLA's psum),
`all_gather_rows` reassembles a row-sharded result.

Every collective flattens its tensors into one buffer per dtype and
issues one call per buffer.  Gloo takes CUDA tensors for `all_reduce`
and `broadcast` but has no CUDA `all_gather`, so rows are gathered by
an all-reduce of a zero-filled global buffer, which works on both
backends.  NCCL takes only CUDA tensors: CPU tensors (AdamW's step
counters, a generator's state) travel through this rank's card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..device import tree_rows
from . import distributed as dist_mod


def rows_of(n: int, rank: int | None = None, world: int | None = None) -> slice:
    """This rank's contiguous block of n rows (JAX shards the leading axis
    in equal blocks, in rank order)."""
    rank = dist_mod.process_index() if rank is None else rank
    world = dist_mod.process_count() if world is None else world
    if n % world:
        raise ValueError(f"{n} rows do not split over {world} ranks")
    b = n // world
    return slice(rank * b, (rank + 1) * b)


def shard_leading(tree, rank: int | None = None, world: int | None = None):
    """This rank's rows of every array in a tree (a dataclass such as
    `train.Batch`, nested dicts / lists, tensors or numpy arrays)."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: shard_leading(getattr(tree, f.name), rank, world)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: shard_leading(v, rank, world) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_leading(v, rank, world) for v in tree)
    return tree_rows(tree, rows_of(len(tree), rank, world))


def _comm_device(t: torch.Tensor) -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _flat_apply(tensors: Sequence[torch.Tensor], op: Callable[[torch.Tensor], None]) -> None:
    """op on one flat buffer per (dtype, device), the results copied back
    into `tensors` in place."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, _comm_device(t)), []).append(i)
    with torch.no_grad():
        for (_, dev), idx in groups.items():
            t = tensors[idx[0]]
            if len(idx) == 1 and t.device == dev and t.is_contiguous():
                op(t)
                continue
            flat = torch.cat([tensors[i].reshape(-1).to(dev) for i in idx])
            op(flat)
            off = 0
            for i in idx:
                t = tensors[i]
                t.copy_(flat[off:off + t.numel()].view(t.shape))
                off += t.numel()


def all_reduce_(tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Sum every tensor over the ranks, in place (XLA's psum of the
    gradients).  Returns them as a list."""
    tensors = list(tensors)
    if dist_mod.process_count() > 1 and tensors:
        _flat_apply(tensors, dist.all_reduce)
    return tensors


def replicate(tensors: Sequence[torch.Tensor]) -> None:
    """Overwrite every tensor with rank 0's, in place (JAX `replicate`):
    after it all ranks hold the same parameters and optimizer state."""
    if dist_mod.process_count() > 1 and tensors:
        _flat_apply(list(tensors), lambda flat: dist.broadcast(flat, src=0))


def all_gather_rows(local: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The (n_rows, ...) tensor whose `rows_of(n_rows)` block on each rank
    is that rank's `local`: a zero-filled global buffer, summed over the
    ranks (exact: every element has one non-zero term)."""
    if dist_mod.process_count() == 1:
        return local
    out = local.new_zeros((n_rows,) + tuple(local.shape[1:]))
    out[rows_of(n_rows)] = local
    _flat_apply([out], dist.all_reduce)
    return out


def pad_rows(a: np.ndarray, world: int) -> np.ndarray:
    """Rows repeated from the last one up to a multiple of `world` (JAX's
    mesh conversion pads an uneven batch so; the copies are trimmed off
    the results)."""
    pad = (-len(a)) % world
    return np.concatenate([a, np.repeat(a[-1:], pad, 0)]) if pad else a
