"""Process-group bootstrap: one process per rank (JAX `parallel/distributed.py`).

The JAX package runs one controller per host and lets XLA place the
collectives on a global mesh; the port runs one process per rank, each
on its own device (`rank_device`), with `torch.distributed` collectives
where XLA inserted them.

Environment contract (the JAX package's):
    RVC_COORDINATOR_ADDRESS  host:port of rank 0 (a TCP store), or a URL
                             such as file:///path (a file store)
    RVC_NUM_PROCESSES        world size
    RVC_PROCESS_ID           this process's rank
With none of them set this is a single-process no-op, so every pipeline
calls `ensure_initialized()` unconditionally.  RVC_MULTIHOST=1 (JAX: ask
a TPU pod's metadata server for the three) has no counterpart on the
card and raises.

The backend is chosen by rule: NCCL when every rank has a card of its
own (the ranks of one host, one card each), gloo on the CPU or when ranks
share a card.  A failed init raises; it never turns into another backend.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

logger = logging.getLogger(__name__)

ENV_VARS = ("RVC_COORDINATOR_ADDRESS", "RVC_NUM_PROCESSES", "RVC_PROCESS_ID")
# a collective or barrier that waits longer than this fails the run
TIMEOUT = datetime.timedelta(minutes=10)


def env_contract(environ=None) -> Optional[tuple[str, int, int]]:
    """(init URL, world size, rank) from the environment, or None in a
    single process.  A partial or malformed contract raises ValueError."""
    env = os.environ if environ is None else environ
    address = env.get("RVC_COORDINATOR_ADDRESS", "")
    if not address:
        if env.get("RVC_MULTIHOST", "") == "1":
            raise RuntimeError(
                "RVC_MULTIHOST=1 asks for a TPU pod's auto-detection, which has no "
                "counterpart on the card: set " + ", ".join(ENV_VARS) + " instead")
        return None
    try:
        world = int(env["RVC_NUM_PROCESSES"])
        rank = int(env["RVC_PROCESS_ID"])
    except (KeyError, ValueError) as e:
        raise ValueError("RVC_COORDINATOR_ADDRESS is set, so RVC_NUM_PROCESSES and "
                         f"RVC_PROCESS_ID must be integers: {e!r}") from e
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"RVC_PROCESS_ID={rank} is not a rank of RVC_NUM_PROCESSES={world}")
    url = address if "://" in address else f"tcp://{address}"
    return url, world, rank


def backend_for(device_type: str, world: int) -> str:
    """NCCL when each of the `world` ranks has a card of its own, else gloo
    (the CPU, or ranks sharing a card: NCCL refuses two ranks on one card)."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def ensure_initialized(device: str | torch.device = "cuda") -> bool:
    """Join the process group that the environment describes, once per
    process; `device` is where this rank computes (it picks the backend).
    Returns True when more than one rank takes part."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    contract = env_contract()
    if contract is None:
        return False
    url, world, rank = contract
    dev_type = torch.device(device).type
    backend = backend_for(dev_type, world)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device, rank=rank))
    logger.info("init_process_group(%s, %s, world %d, rank %d)", backend, url, world, rank)
    dist.init_process_group(backend, init_method=url, world_size=world, rank=rank,
                            timeout=TIMEOUT)
    return world > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """Only rank 0 writes checkpoints, weights and logs (the reference's
    rank-0 guards, train.py:883-895, 919-924)."""
    return process_index() == 0


def rank_device(device: str | torch.device = "cuda", *, rank: Optional[int] = None
                ) -> torch.device:
    """This rank's device: the CPU when asked for, else cuda:(rank % cards)
    (ranks share cards round-robin when there are fewer cards than ranks),
    or the card named by an explicit index.  A card that is asked for but
    missing raises."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return resolve_device(dev)
    resolve_device(dev)
    n = torch.cuda.device_count()
    rank = process_index() if rank is None else rank
    index = rank % n if dev.index is None else dev.index
    if index >= n:
        raise RuntimeError(f"rank {rank}: cuda:{index} asked for, but this host has "
                           f"{n} card(s)")
    return torch.device("cuda", index)


def local_batch_size(global_batch: int) -> int:
    """Rows each rank holds of a global batch."""
    n = process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over {n} ranks")
    return global_batch // n


def sync_global(name: str = "sync") -> None:
    """Barrier across ranks (around checkpoint saves)."""
    if process_count() > 1:
        logger.debug("barrier %s", name)
        dist.barrier()


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is True on any: a MAX all-reduce of
    one int (on this rank's card under NCCL, else on the CPU).  One
    process returns `flag`."""
    if process_count() == 1:
        return bool(flag)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()
