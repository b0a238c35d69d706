"""Lazy pretrained-model bootstrap (a copy of JAX `utils/bootstrap.py`;
reference library/utils.py:24-87).

The reference downloads every model it needs on first use from a
HuggingFace repo.  The `ensure_*` functions resolve the local path under
`$RVC_TPU_ASSETS/models/...` (default `assets/`) and download a file
that is missing; without a network the error names the file to place
there by hand.

Registry mirrors check_predictors / check_embedders /
check_spk_diarization (library/utils.py) and the pretrained G/D map
(app.py:1310-1320).
"""

from __future__ import annotations

import logging
import os
import re

logger = logging.getLogger(__name__)

HF_BASE = "https://huggingface.co/AnhP/Vietnamese-RVC-Project/resolve/main/"
ASSETS = os.environ.get("RVC_TPU_ASSETS", "assets")

# F0 method -> predictor checkpoint (library/utils.py:29)
PREDICTOR_FILES = {
    **dict.fromkeys(["rmvpe", "rmvpe-legacy"], "rmvpe.pt"),
    **dict.fromkeys(["fcpe"], "fcpe.pt"),
    **dict.fromkeys(["fcpe-legacy"], "fcpe_legacy.pt"),
    **dict.fromkeys(["harvest", "dio"], None),  # native C++ here, no blob
}
for _cap in ("full", "large", "medium", "small", "tiny"):
    PREDICTOR_FILES[f"crepe-{_cap}"] = f"crepe_{_cap}.pth"
    PREDICTOR_FILES[f"mangio-crepe-{_cap}"] = f"crepe_{_cap}.pth"
# --f0_onnx variants (library/utils.py:24-29): same graphs, .onnx files
PREDICTOR_FILES.update({
    "rmvpe-onnx": "rmvpe.onnx", "rmvpe-legacy-onnx": "rmvpe.onnx",
    "fcpe-onnx": "fcpe.onnx", "fcpe-legacy-onnx": "fcpe_legacy.onnx",
})
for _cap in ("full", "large", "medium", "small", "tiny"):
    PREDICTOR_FILES[f"crepe-{_cap}-onnx"] = f"crepe_{_cap}.onnx"
    PREDICTOR_FILES[f"mangio-crepe-{_cap}-onnx"] = f"crepe_{_cap}.onnx"

EMBEDDER_NAMES = ("contentvec_base", "hubert_base", "japanese_hubert_base",
                  "korean_hubert_base", "chinese_hubert_base", "spin")


def _download(url: str, path: str) -> str:
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    from .downloads import download_url

    logger.info("bootstrap: downloading %s", url)
    try:
        return download_url(url, path)
    except Exception as e:  # noqa: BLE001 — surface an actionable message
        raise RuntimeError(
            f"could not download {url} ({e}); in offline deployments "
            f"place the file at {path}") from e


def methods_of(method: str) -> list[str]:
    """hybrid[a+b] -> [a, b]; plain method -> [method]
    (reference check_predictors, library/utils.py:31-36)."""
    m = re.search(r"hybrid\[(.+)\]", method)
    if m:
        return [s.strip() for s in m.group(1).split("+")]
    return [method]


def ensure_predictor(method: str) -> dict[str, str]:
    """Resolve (downloading if needed) every predictor checkpoint the
    method needs.  Returns {method: local_path} for methods that use a
    checkpoint (yin/pyin/pm/swipe/dio/harvest need none)."""
    out = {}
    for m in methods_of(method):
        fname = PREDICTOR_FILES.get(m)
        if fname is None:
            continue
        path = os.path.join(ASSETS, "models", "predictors", fname)
        out[m] = _download(f"{HF_BASE}predictors/{fname}", path)
    return out


def ensure_embedder(name: str = "contentvec_base",
                    mode: str = "fairseq") -> str:
    """Resolve an embedder checkpoint (reference check_embedders,
    library/utils.py:40-64).  mode: fairseq | onnx | transformers | spin."""
    if mode == "spin":
        mode, name = "transformers", "spin"
    if name not in EMBEDDER_NAMES:
        raise ValueError(f"unknown embedder {name!r}")
    base = os.path.join(ASSETS, "models", "embedders")
    if mode == "fairseq":
        return _download(f"{HF_BASE}embedders/fairseq/{name}.pt",
                         os.path.join(base, f"{name}.pt"))
    if mode == "onnx":
        return _download(f"{HF_BASE}embedders/onnx/{name}.onnx",
                         os.path.join(base, f"{name}.onnx"))
    if mode == "transformers":
        sub = "spin" if name == "spin" else f"transformers/{name}"
        model_dir = os.path.join(base, name)
        _download(f"{HF_BASE}embedders/{sub}/model.safetensors",
                  os.path.join(model_dir, "model.safetensors"))
        _download(f"{HF_BASE}embedders/{sub}/config.json",
                  os.path.join(model_dir, "config.json"))
        return model_dir
    raise ValueError(f"unknown embedders mode {mode!r}")


def ensure_spk_diarization(model_size: str = "small") -> dict[str, str]:
    """Whisper + speechbrain ECAPA bundle (library/utils.py:66-76)."""
    out = {}
    wpath = os.path.join(ASSETS, "models", "speaker_diarization", "models",
                         f"{model_size}.pt")
    out["whisper"] = _download(
        f"{HF_BASE}speaker_diarization/{model_size}.pt", wpath)
    sb_dir = os.path.join(ASSETS, "models", "speaker_diarization", "models",
                          "speechbrain")
    for f in ("classifier.ckpt", "config.json", "embedding_model.ckpt",
              "hyperparams.yaml", "mean_var_norm_emb.ckpt"):
        out[f] = _download(f"{HF_BASE}speaker_diarization/speechbrain/{f}",
                           os.path.join(sb_dir, f))
    return out


def ensure_pretrained(version: str, sample_rate: int,
                      vocoder: str = "Default") -> tuple[str, str]:
    """Pretrained G/D pair for training init (reference app.py:1310-1320:
    downloads from the same repo's pretrained_v1/v2 trees)."""
    tree = {"Default": f"pretrained_{version}",
            "MRF HiFi-GAN": "pretrained_mrf_hifigan",
            "RefineGAN": "pretrained_refinegan"}.get(vocoder,
                                                     f"pretrained_{version}")
    base = os.path.join(ASSETS, "models", tree)
    g = _download(f"{HF_BASE}{tree}/G{sample_rate // 1000}k.pth",
                  os.path.join(base, f"G{sample_rate // 1000}k.pth"))
    d = _download(f"{HF_BASE}{tree}/D{sample_rate // 1000}k.pth",
                  os.path.join(base, f"D{sample_rate // 1000}k.pth"))
    return g, d
