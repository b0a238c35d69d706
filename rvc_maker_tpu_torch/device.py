"""Device selection for the port's entry points."""

from __future__ import annotations

import contextlib
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


def use_full_fp32(device: torch.device) -> None:
    """The entry points' precision policy: on the card, fp32 convolutions
    and matmuls run in full fp32, never TF32 (PyTorch lets cuDNN use TF32
    by default, which moves a v2-48k conversion's waveform by about 9e-2,
    chip_smoke.py phase 11).  The flags are process-wide, so the process's
    entry point (the server's `set_device`, the CLI) sets them once; bf16
    compute does not read them."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def full_fp32(device: torch.device):
    """`use_full_fp32` for one block only, for a library function that
    must not change the process's flags: they are restored on the way
    out."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    use_full_fp32(device)
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


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


def tree_rows(tree, rows):
    """Rows `rows` (a slice or an index tensor) of every array of a nested
    dict/list/tuple tree (numpy arrays become tensors)."""
    if isinstance(tree, dict):
        return {k: tree_rows(v, rows) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_rows(v, rows) for v in tree)
    return torch.as_tensor(tree)[rows]


def tree_cat(trees: list):
    """The trees' arrays concatenated along rows, leaf by leaf (trees of
    one layout)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_cat([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(tree_cat(list(v)) for v in zip(*trees))
    return torch.cat([torch.as_tensor(t) for t in trees])
