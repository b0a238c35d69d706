"""The port's own `.safetensors` reader (no `safetensors` package).

The format: an 8-byte little-endian header length N, N bytes of JSON
mapping each tensor's name to {"dtype", "shape", "data_offsets": [begin,
end]} (offsets into the byte buffer that follows the header; an optional
"__metadata__" entry holds strings), then the buffer.  The card's machine
has no `safetensors` package, so the HuBERT loader (`models/hubert.py`
`load_transformers_dir`) and the AudioLDM2 checkpoint importer
(`edit/stack.py` `load_components_from_dir`) read through `load_file`.

Dtypes read: F32, F16, BF16 and the integer types; any other dtype, and a
header whose offsets or sizes do not fit the file, raise `BadRequest`.
"""

from __future__ import annotations

import json
import math
import os
import struct

import torch

from ..errors import BadRequest

DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8,
    "U64": torch.uint64, "U32": torch.uint32, "U16": torch.uint16, "U8": torch.uint8,
}


def read_header(data: bytes | bytearray, path: str) -> tuple[dict, int]:
    """(the tensors' header entries, the buffer's offset in `data`),
    every entry checked against the file's size."""
    if len(data) < 8:
        raise BadRequest(f"{path}: {len(data)} bytes, too short for a safetensors header")
    (n,) = struct.unpack("<Q", bytes(data[:8]))
    if n > len(data) - 8:
        raise BadRequest(f"{path}: header of {n} bytes overruns the file ({len(data)} bytes)")
    try:
        header = json.loads(bytes(data[8:8 + n]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise BadRequest(f"{path}: unreadable safetensors header ({e})") from None
    if not isinstance(header, dict):
        raise BadRequest(f"{path}: the safetensors header is not a JSON object")
    header.pop("__metadata__", None)
    start, size = 8 + n, len(data) - 8 - n
    for name, e in header.items():
        if not isinstance(e, dict) or e.get("dtype") not in DTYPES:
            dt = e.get("dtype") if isinstance(e, dict) else e
            raise BadRequest(f"{path}: tensor {name!r} has dtype {dt!r}; the reader takes "
                             f"{', '.join(DTYPES)}")
        shape, offs = e.get("shape"), e.get("data_offsets")
        if (not isinstance(shape, list) or not all(isinstance(s, int) and s >= 0 for s in shape)
                or not isinstance(offs, list) or len(offs) != 2
                or not all(isinstance(o, int) for o in offs)):
            raise BadRequest(f"{path}: tensor {name!r} has a malformed shape or offsets")
        begin, end = offs
        want = math.prod(shape) * DTYPES[e["dtype"]].itemsize
        if not 0 <= begin <= end <= size:
            raise BadRequest(f"{path}: tensor {name!r} offsets [{begin}, {end}] overrun the "
                             f"{size}-byte buffer")
        if end - begin != want:
            raise BadRequest(f"{path}: tensor {name!r} holds {end - begin} bytes, its shape "
                             f"{shape} and dtype {e['dtype']} need {want}")
    return header, start


def load_file(path: str, device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """Every tensor of the `.safetensors` file at `path`, in its header's
    order, as tensors of their own (nothing aliases the file's bytes) on
    `device`."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no such safetensors file {path!r}")
    with open(path, "rb") as f:
        data = bytearray(f.read())
    header, start = read_header(data, path)
    out = {}
    for name, e in header.items():
        dtype, shape = DTYPES[e["dtype"]], e["shape"]
        begin, end = e["data_offsets"]
        if end == begin:
            t = torch.empty(shape, dtype=dtype)
        else:
            t = torch.frombuffer(data, dtype=dtype, count=(end - begin) // dtype.itemsize,
                                 offset=start + begin).reshape(shape).clone()
        out[name] = t.to(device)
    return out
