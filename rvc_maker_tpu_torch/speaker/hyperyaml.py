"""hyperpyyaml-lite: speechbrain model directories (counterpart of JAX
`speaker/hyperyaml.py`).

speechbrain's `hyperparams.yaml` is HyperPyYAML: plain YAML plus the tags
`!new:pkg.Class`, `!name:pkg.fn`, `!ref <key>` and `!apply:pkg.fn`.  The
JAX package reads it with PyYAML, which the card's machine lacks; here
the stdlib parser of `utils/yaml_lite.py` reads the subset those files
use and builds the dict the JAX loader builds:

- `!new:x.y.Class` -> {**mapping, "_new": "x.y.Class"}, or
  {"_args": [...], "_new": ...} on a sequence, {"_new": ...} on a scalar
- `!name:x.y.fn`   -> {"_name": "x.y.fn"};  `!apply:x.y.fn` -> {"_apply": ...}
- `!ref <key>` and strings holding `<key>` -> the top-level value,
  substituted recursively (no arithmetic)

Anything outside the subset raises `errors.BadRequest` and names the line.
`load_speechbrain_ecapa(dir)` builds the ECAPA tree from such a directory
(hyperparams.yaml + embedding_model.ckpt).
"""

from __future__ import annotations

import os
import re
from typing import Any

from ..errors import BadRequest
from ..utils import yaml_lite

_REF = re.compile(r"<([^<>]+)>")


def _construct(tag: str, kind: str, value, where: str):
    """A tagged node as the JAX loader's constructors build it
    (`_make_loader` :30-55)."""
    for prefix in ("!new:", "!name:", "!apply:"):
        if tag.startswith(prefix):
            name = tag[len(prefix):]
            if prefix == "!name:":
                return {"_name": name}
            if prefix == "!apply:":
                return {"_apply": name}
            if kind == "mapping":
                return {**value, "_new": name}
            return {"_args": value, "_new": name} if kind == "sequence" else {"_new": name}
    if tag == "!ref":
        if kind != "scalar":
            raise BadRequest(f"{where}: !ref takes a scalar, not a {kind}")
        return value                    # resolved in a second pass
    raise BadRequest(f"{where}: tag {tag} is outside the supported subset "
                     "(!new:, !name:, !ref, !apply:)")


def _resolve(value: Any, root: dict) -> Any:
    if isinstance(value, str):
        m = _REF.fullmatch(value.strip())
        if m and m.group(1) in root:
            return _resolve(root[m.group(1)], root)

        def sub(match):
            key = match.group(1)
            return str(_resolve(root[key], root)) if key in root else match.group(0)

        return _REF.sub(sub, value)
    if isinstance(value, dict):
        return {k: _resolve(v, root) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve(v, root) for v in value]
    return value


def load_hyperpyyaml_lite(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        raw = yaml_lite.load(f.read(), tag=_construct, source=path)
    if not isinstance(raw, dict):
        raise BadRequest(f"{path}: the top level is not a mapping")
    return {k: _resolve(v, raw) for k, v in raw.items()}


def load_speechbrain_ecapa(model_dir: str, device="cuda"):
    """A speechbrain spkrec-ecapa directory -> (params on `device`, info):
    hyperparams.yaml locates the embedding model and its features, and
    embedding_model.ckpt holds the weights (JAX :77-109)."""
    from ..models.ecapa_tdnn import load_ecapa_ckpt

    h = load_hyperpyyaml_lite(os.path.join(model_dir, "hyperparams.yaml"))
    emb = h.get("embedding_model")
    if not (isinstance(emb, dict) and str(emb.get("_new", "")).endswith("ECAPA_TDNN")):
        raise BadRequest("hyperparams.yaml has no ECAPA_TDNN embedding_model entry")
    feats = h.get("compute_features", {})
    info = {
        "input_size": emb.get("input_size"),
        "channels": emb.get("channels"),
        "lin_neurons": emb.get("lin_neurons", 192),
        "n_mels": (feats.get("n_mels") if isinstance(feats, dict) else None)
        or emb.get("input_size"),
        "sample_rate": h.get("sample_rate", 16000),
    }
    return load_ecapa_ckpt(os.path.join(model_dir, "embedding_model.ckpt"), device), info


def load_ecapa(path: str, device="cuda"):
    """An ECAPA checkpoint file, or a speechbrain directory holding one:
    the tree on `device`."""
    if os.path.isdir(path):
        return load_speechbrain_ecapa(path, device)[0]
    from ..models.ecapa_tdnn import load_ecapa_ckpt

    return load_ecapa_ckpt(path, device)
