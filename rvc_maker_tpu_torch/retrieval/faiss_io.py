"""Reader and writer of faiss `.index` files, with no faiss dependency.

Counterpart of `rvc_maker_tpu/retrieval/faiss_io.py` (the port keeps its
own copy; it imports nothing of the JAX package).  Every RVC user's
`added_*.index` is an `IndexIVFFlat` written by faiss; the reference
densifies it with `faiss.read_index` + `reconstruct_n` (reference
convert.py:394-395), and so does `load_index`.  `write_ivf_flat` writes
that layout (reference create_index.py:66-83) byte for byte as the JAX
package does.

Binary layout, from the published faiss serialization
(faiss/impl/index_read.cpp), little-endian:

  IndexIVFFlat ("IwFl")
    common header: int32 d, int64 ntotal, int64 dummy x 2 (= 1 << 20),
                   uint8 is_trained, int32 metric_type,
                   [float32 metric_arg if metric_type > 1]
    int64 nlist, int64 nprobe
    nested quantizer index (IndexFlat "IxF2"/"IxFI"):
      common header, then VECTOR codes: int64 count + payload; modern
      files store uint8 codes (count = ntotal * d * 4), legacy files
      store float32 xb (count = ntotal * d); both are read
    direct map: uint8 type, VECTOR<int64> array
    inverted lists ("ilar"): int64 nlist, int64 code_size,
      "full": VECTOR<uint64> sizes, then per list ids (int64 x n) and
      codes (uint8 x n * code_size, float32 vectors for Flat)

  A standalone IndexFlat ("IxF2"/"IxFI") is read too.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np


def _fourcc(s: str) -> int:
    return int.from_bytes(s.encode(), "little")


_FLAT = (_fourcc("IxF2"), _fourcc("IxFI"))
_METRIC_L2 = 1


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def _unpack(self, fmt: str, size: int):
        if self.off + size > len(self.data):
            raise ValueError("truncated index file")
        (v,) = struct.unpack_from(fmt, self.data, self.off)
        self.off += size
        return v

    def u32(self) -> int:
        return self._unpack("<I", 4)

    def i32(self) -> int:
        return self._unpack("<i", 4)

    def i64(self) -> int:
        return self._unpack("<q", 8)

    def u8(self) -> int:
        return self._unpack("<B", 1)

    def f32(self) -> float:
        return self._unpack("<f", 4)

    def raw(self, n: int) -> bytes:
        b = self.data[self.off : self.off + n]
        if len(b) != n:
            raise ValueError("truncated index file")
        self.off += n
        return b

    def vector(self, dtype) -> np.ndarray:
        count = self.i64()
        return np.frombuffer(self.raw(count * np.dtype(dtype).itemsize), dtype=dtype)


@dataclass
class IvfFlatIndex:
    d: int
    metric: int
    centroids: np.ndarray                         # (nlist, d) float32
    ids: list = field(default_factory=list)       # per-list int64 arrays
    codes: list = field(default_factory=list)     # per-list (n, d) float32
    nprobe: int = 1

    @property
    def ntotal(self) -> int:
        return int(sum(len(i) for i in self.ids))

    def reconstruct_n(self) -> np.ndarray:
        """Dense (ntotal, d), row i the vector of id i (faiss
        reconstruct_n; reference convert.py:395 big_npy)."""
        out = np.zeros((self.ntotal, self.d), np.float32)
        seen = np.zeros(self.ntotal, bool)
        for ids, vecs in zip(self.ids, self.codes):
            if len(ids) and (ids.min() < 0 or ids.max() >= self.ntotal):
                raise ValueError("ids outside 0..ntotal-1; cannot reconstruct densely")
            out[ids] = vecs
            seen[ids] = True
        if not seen.all():
            raise ValueError("non-contiguous ids; cannot reconstruct densely")
        return out


def _read_header(r: _Reader):
    d = r.i32()
    ntotal = r.i64()
    r.i64(), r.i64()                  # dummies
    is_trained = r.u8()
    metric = r.i32()
    if metric > 1:
        r.f32()                       # metric_arg
    return d, ntotal, bool(is_trained), metric


def _read_flat_vectors(r: _Reader, d: int, ntotal: int) -> np.ndarray:
    count = r.i64()
    if count == ntotal * d:                       # legacy float32 xb
        return np.frombuffer(r.raw(count * 4), np.float32).reshape(ntotal, d).copy()
    if count == ntotal * d * 4:                   # modern uint8 codes
        return np.frombuffer(r.raw(count), np.uint8).view(np.float32).reshape(ntotal, d).copy()
    raise ValueError(f"unexpected flat storage count {count} for ntotal={ntotal} d={d}")


def read_index(path_or_bytes) -> IvfFlatIndex:
    """Parse an IVF-Flat (or plain Flat) faiss index file."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            data = f.read()
    r = _Reader(data)
    h = r.u32()
    if h in _FLAT:
        d, ntotal, _, metric = _read_header(r)
        vecs = _read_flat_vectors(r, d, ntotal)
        return IvfFlatIndex(d=d, metric=metric, centroids=vecs[:0],
                            ids=[np.arange(ntotal, dtype=np.int64)], codes=[vecs])
    if h != _fourcc("IwFl"):
        raise ValueError(f"unsupported index fourcc {h:#x} ({h.to_bytes(4, 'little')!r})")
    d, ntotal, _, metric = _read_header(r)
    nlist = r.i64()
    nprobe = r.i64()

    qh = r.u32()
    if qh not in _FLAT:
        raise ValueError(f"unsupported quantizer fourcc {qh:#x}")
    qd, qn, _, _ = _read_header(r)
    if (qd, qn) != (d, nlist):
        raise ValueError(f"quantizer is {qn} x {qd}, expected {nlist} x {d}")
    centroids = _read_flat_vectors(r, d, nlist)

    r.u8()                            # direct-map type
    r.vector(np.int64)                # direct-map array

    ih = r.u32()
    if ih != _fourcc("ilar"):
        raise ValueError(f"unsupported inverted-list fourcc {ih:#x}")
    il_nlist = r.i64()
    code_size = r.i64()
    if (il_nlist, code_size) != (nlist, d * 4):
        raise ValueError(f"inverted lists {il_nlist} x {code_size} bytes, expected "
                         f"{nlist} x {d * 4}")
    lh = r.u32()
    if lh != _fourcc("full"):
        raise ValueError(f"unsupported list storage fourcc {lh:#x}")
    sizes = r.vector(np.uint64).astype(np.int64)
    if len(sizes) != nlist:
        raise ValueError(f"{len(sizes)} list sizes for {nlist} lists")
    idx = IvfFlatIndex(d=d, metric=metric, centroids=centroids, nprobe=nprobe)
    for n in sizes:
        n = int(n)
        idx.ids.append(np.frombuffer(r.raw(n * 8), np.int64).copy())
        idx.codes.append(np.frombuffer(r.raw(n * code_size), np.uint8)
                         .view(np.float32).reshape(n, d).copy())
    if idx.ntotal != ntotal:
        raise ValueError(f"lists hold {idx.ntotal} vectors, header says {ntotal}")
    return idx


# ---------------------------------------------------------------------------
# writing (reference create_index.py output)
# ---------------------------------------------------------------------------

class _Writer:
    def __init__(self):
        self.parts: list[bytes] = []

    def u32(self, v):
        self.parts.append(struct.pack("<I", v))

    def i32(self, v):
        self.parts.append(struct.pack("<i", v))

    def i64(self, v):
        self.parts.append(struct.pack("<q", v))

    def u8(self, v):
        self.parts.append(struct.pack("<B", v))

    def raw(self, b):
        self.parts.append(bytes(b))

    def vector_bytes(self, b: bytes):
        """WRITEVECTOR of a uint8 vector (element count == byte count)."""
        self.i64(len(b))
        self.raw(b)

    def vector_i64(self, arr: np.ndarray):
        """WRITEVECTOR of an int64/size_t vector (count = elements)."""
        self.i64(len(arr))
        self.raw(np.ascontiguousarray(arr).tobytes())

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


def _write_header(w: _Writer, d: int, ntotal: int):
    w.i32(d)
    w.i64(ntotal)
    w.i64(1 << 20)
    w.i64(1 << 20)
    w.u8(1)          # is_trained
    w.i32(_METRIC_L2)


def write_ivf_flat(path: str, vectors: np.ndarray, centroids: np.ndarray,
                   assignments: np.ndarray) -> None:
    """Write an L2 IndexIVFFlat file with nprobe 1, as the reference's
    `IVF{nlist},Flat` is, that faiss can read back.

    vectors: (N, d) float32 in id order; assignments: (N,) list index of
    each vector (nearest centroid); centroids: (nlist, d).  Each list
    holds its ids in ascending order."""
    vectors = np.ascontiguousarray(vectors, np.float32)
    centroids = np.ascontiguousarray(centroids, np.float32)
    n, d = vectors.shape
    nlist = centroids.shape[0]
    w = _Writer()
    w.u32(_fourcc("IwFl"))
    _write_header(w, d, n)
    w.i64(nlist)
    w.i64(1)         # nprobe
    # quantizer: IndexFlatL2 with the centroids (modern uint8 codes)
    w.u32(_FLAT[0])
    _write_header(w, d, nlist)
    w.vector_bytes(centroids.tobytes())
    # direct map: NoMap, empty array
    w.u8(0)
    w.i64(0)
    # inverted lists
    w.u32(_fourcc("ilar"))
    w.i64(nlist)
    w.i64(d * 4)
    w.u32(_fourcc("full"))
    assignments = np.asarray(assignments, np.int64)
    order = np.argsort(assignments, kind="stable")       # ids ascending per list
    sizes = np.bincount(assignments, minlength=nlist).astype(np.uint64)
    w.vector_i64(sizes)
    bounds = np.concatenate([[0], np.cumsum(sizes.astype(np.int64))])
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        ids = order[lo:hi]
        w.raw(ids.tobytes())
        w.raw(vectors[ids].tobytes())
    with open(path, "wb") as f:
        f.write(w.getvalue())
