"""IVF coarse quantization for the faiss-format index file.

Counterpart of `rvc_maker_tpu/retrieval/ivf.py`.  Reference
create_index.py:66-83 builds `IVF{nlist},Flat` with nlist =
min(16 sqrt(N), N / 39) and nprobe 1; `build_ivf_file` writes that
layout, so the `added_*.index` files load in any faiss-based RVC tool.
The coarse k-means runs on the device (`index.kmeans`); the
nearest-centroid assignment runs in float64 on the host, as the JAX
package's does, so that both packages write the same bytes for the same
centroids.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .faiss_io import write_ivf_flat
from .index import kmeans


def reference_nlist(n: int) -> int:
    return max(1, min(int(16 * np.sqrt(n)), n // 39 if n >= 39 else 1))


def build_ivf_file(vectors: np.ndarray, path: str, *, nlist: int | None = None,
                   seed: int = 0, device: str | torch.device = "cuda") -> int:
    """Coarse-quantize `vectors` and write a faiss IndexIVFFlat file: the
    mean for one list, else k-means to `nlist` on `device` (its generator
    seeded with `seed`).  Returns nlist."""
    vectors = np.ascontiguousarray(vectors, np.float32)
    n = vectors.shape[0]
    nlist = reference_nlist(n) if nlist is None else nlist
    if nlist <= 1:
        centroids = vectors.mean(axis=0, keepdims=True)
    else:
        dev = resolve_device(device)
        centroids = kmeans(torch.as_tensor(vectors, device=dev), nlist,
                           generator=torch.Generator(dev).manual_seed(seed)).cpu().numpy()
    # nearest-centroid assignment, blocked to bound memory
    assign = np.empty(n, np.int64)
    c64 = centroids.astype(np.float64)
    c_sq = np.sum(c64 ** 2, axis=1)
    for lo in range(0, n, 65536):
        blk = vectors[lo : lo + 65536].astype(np.float64)
        assign[lo : lo + len(blk)] = np.argmin(c_sq[None, :] - 2.0 * (blk @ c64.T), axis=1)
    write_ivf_flat(path, vectors, centroids, assign)
    return int(nlist)
