"""Device selection for the port's entry points."""

from __future__ import annotations

import copy

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return `device` as a torch.device.

    A CUDA device that is not available is an error: the entry points
    never carry on on the CPU in its place.  The CPU is used only when
    the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def tree_to(tree, device: torch.device, dtype: torch.dtype | None = None):
    """Copy every tensor (and nn.Module) of a nested dict/list tree to
    `device`.  A module is copied before it moves (Module.to works in
    place), so the caller's tree stays where it was."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device, dtype) for v in tree)
    if isinstance(tree, torch.nn.Module):
        return copy.deepcopy(tree).to(device=device)
    if isinstance(tree, torch.Tensor):
        if dtype is not None and tree.is_floating_point():
            return tree.to(device=device, dtype=dtype)
        return tree.to(device=device)
    return tree
