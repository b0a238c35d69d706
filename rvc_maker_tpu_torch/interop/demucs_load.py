"""Load demucs-format checkpoints (.th) and yaml bags (counterpart of JAX
`interop/demucs_load.py`).

Reference: demucs/states.py load_model (a torch pickle holding {klass,
args, kwargs, state}) and demucs_separator.py LocalRepo / BagOnlyRepo
(signature .th files and .yaml bags with per-source weights).

The pickled `klass` names the demucs package's module path (for example
demucs.htdemucs.HTDemucs).  Stub modules registered under those paths
resolve it to a marker class instead of the model; the architecture
comes from the class name, and the state dict goes through
`models/demucs.py` `params_from_state_dict`.  The stubs are flagged
`_rvc_shim`, as the JAX package's are, so both packages' shims live in
one process; a real `demucs` package, where one is imported, wins.  The
port's markers carry their shim module as `__module__`, so a package
that holds one pickles and unpickles through either package's shims.

A bag is read by a small parser of the demucs bag format (`models`,
`weights`, `segment`; flow or block lists), since PyYAML may be absent.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import types
from typing import Any

from ..device import resolve_device, tree_to
from ..errors import BadRequest
from ..models.demucs import DemucsConfig, params_from_state_dict
from ..utils import yaml_lite

ARCH_MODULES = {"htdemucs": ("HTDemucs",), "hdemucs": ("HDemucs",), "demucs": ("Demucs",)}
SHIM_ROOTS = ("demucs", "main.library.uvr5_separator.demucs")


class _ArchMarker:
    """Stands in for a pickled demucs model class; never constructed."""

    arch = "unknown"


_MARKERS: dict = {}


def marker_class(root: str, module: str, name: str) -> type:
    """The port's marker for class `name` of `root.module` (made once)."""
    key = f"{root}.{module}.{name}"
    if key not in _MARKERS:
        _MARKERS[key] = type(name, (_ArchMarker,), {"arch": name, "__module__": f"{root}.{module}",
                                                    "__qualname__": name})
    return _MARKERS[key]


def install_demucs_shims() -> None:
    """Make pickled demucs classes loadable without their packages, at the
    upstream paths (demucs.htdemucs.HTDemucs) and the reference's vendored
    ones (main.library.uvr5_separator.demucs.htdemucs.HTDemucs).  A stub
    module another package's shims made (flag `_rvc_shim`) is reused and
    gets the port's markers."""
    for root_name in SHIM_ROOTS:
        top = root_name.split(".")[0]
        if top in sys.modules and not getattr(sys.modules[top], "_rvc_shim", False):
            continue                    # a real package owns this namespace
        parts = root_name.split(".")
        for i in range(len(parts)):
            name = ".".join(parts[:i + 1])
            if name not in sys.modules:
                m = types.ModuleType(name)
                m._rvc_shim = True
                sys.modules[name] = m
        root = sys.modules[root_name]
        for mod_name, classes in ARCH_MODULES.items():
            full = f"{root_name}.{mod_name}"
            m = sys.modules.get(full) or types.ModuleType(full)
            m._rvc_shim = True
            for c in classes:
                setattr(m, c, marker_class(root_name, mod_name, c))
            setattr(root, mod_name, m)
            sys.modules[full] = m


def config_from(klass, kwargs: dict) -> DemucsConfig:
    """The DemucsConfig of a pickled class and its constructor kwargs."""
    name = getattr(klass, "arch", None) or getattr(klass, "__name__", "")
    has_transformer = "HT" in name or kwargs.get("t_layers", 0) > 0
    return DemucsConfig(
        sources=tuple(kwargs.get("sources", ("drums", "bass", "other", "vocals"))),
        audio_channels=kwargs.get("audio_channels", 2),
        nfft=kwargs.get("nfft", 4096),
        depth=kwargs.get("depth", 4 if has_transformer else 6),
        stride=kwargs.get("stride", 4),
        kernel_size=kwargs.get("kernel_size", 8),
        time_stride=kwargs.get("time_stride", 2),
        freq_emb_scale=kwargs.get("freq_emb", 0.2),
        cac=kwargs.get("cac", True),
        wiener_iters=kwargs.get("wiener_iters", 0),
        wiener_residual=kwargs.get("wiener_residual", False),
        has_transformer=has_transformer,
        t_heads=kwargs.get("t_heads", 8),
        samplerate=kwargs.get("samplerate", 44100),
        segment=float(kwargs.get("segment", 40.0)),
        use_train_segment=kwargs.get("use_train_segment", True) if has_transformer else False,
    )


def load_demucs_th(path_or_package, *, device="cuda") -> tuple[Any, DemucsConfig]:
    """A demucs .th checkpoint (or its unpickled dict) -> (the parameter
    tree on `device`, DemucsConfig).  `device` is the card unless the
    caller passes "cpu"; a quantized checkpoint is a BadRequest."""
    import torch

    dev = resolve_device(device)
    install_demucs_shims()
    if isinstance(path_or_package, dict):
        package = path_or_package
    else:
        package = torch.load(path_or_package, map_location="cpu", weights_only=False)
    cfg = config_from(package["klass"], dict(package.get("kwargs", {})))
    state = package["state"]
    if state.get("__quantized"):
        raise BadRequest("quantized demucs checkpoints are not supported")
    return tree_to(params_from_state_dict(state, cfg), dev), cfg


# ---------------------------------------------------------------------------
# the bag file
# ---------------------------------------------------------------------------

def parse_bag(text: str) -> dict:
    """The demucs bag format: top-level `key: value` lines whose values are
    scalars, flow lists (which may span lines) or block lists of such
    items (`utils/yaml_lite.py`)."""
    bag = yaml_lite.load(text, source="the bag")
    if not isinstance(bag, dict):
        raise BadRequest("the bag's top level is not a mapping")
    return bag


def load_demucs_bag(yaml_path: str, repo_dir: str | None = None, *, device="cuda"):
    """A yaml bag -> [(params, cfg, per_source_weights), ...] for
    pipelines/separate.py `apply_bag` (reference BagOnlyRepo /
    BagOfModels); each member's `.th` is found by its signature prefix
    in `repo_dir` (the bag's directory by default)."""
    dev = resolve_device(device)
    with open(yaml_path, encoding="utf-8") as f:
        bag = parse_bag(f.read())
    if not bag.get("models"):
        raise BadRequest(f"{yaml_path}: the bag names no models")
    repo = repo_dir or os.path.dirname(yaml_path)
    weights = bag.get("weights")
    out = []
    for i, sig in enumerate(bag["models"]):
        matches = sorted(fn for fn in os.listdir(repo)
                         if fn.startswith(str(sig)) and fn.endswith(".th"))
        if not matches:
            raise BadRequest(f"bag member {sig}.th not found in {repo}")
        params, cfg = load_demucs_th(os.path.join(repo, matches[0]), device=dev)
        if "segment" in bag:
            cfg = dataclasses.replace(cfg, segment=float(bag["segment"]))
        w = weights[i] if weights else [1.0] * len(cfg.sources)
        out.append((params, cfg, w))
    return out
