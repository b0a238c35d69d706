"""ctypes binding of the FLAC decoder (counterpart of
`rvc_maker_tpu/native/__init__.py:152-181`).

The library is the repo's native/src/flacdec.cpp, built alone with g++
at first use into rvc_maker_tpu_torch/_build/ (`ops/build.py`
`load_host`); `make` and the prebuilt library of native/build/ are not
used.  A failed build raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops import build

_U8_P = ctypes.POINTER(ctypes.c_uint8)
_INT_P = ctypes.POINTER(ctypes.c_int)
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load_host("flacdec")
        lib.flac_probe.restype = ctypes.c_int
        lib.flac_probe.argtypes = [_U8_P, ctypes.c_longlong, _INT_P, _INT_P, _INT_P,
                                   ctypes.POINTER(ctypes.c_longlong)]
        lib.flac_decode.restype = ctypes.c_longlong
        lib.flac_decode.argtypes = [_U8_P, ctypes.c_longlong,
                                    ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong]
        _lib = lib
    return _lib


def flac_probe(data: bytes) -> dict:
    """The stream's STREAMINFO: sample rate, channels, bits per sample
    and total samples per channel (0 when the encoder did not know)."""
    lib = _load()
    buf = np.frombuffer(data, np.uint8)
    sr, ch, bps, total = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    err = lib.flac_probe(buf.ctypes.data_as(_U8_P), len(buf), ctypes.byref(sr),
                         ctypes.byref(ch), ctypes.byref(bps), ctypes.byref(total))
    if err:
        raise ValueError(f"not a decodable FLAC stream (err {err})")
    return dict(sample_rate=int(sr.value), channels=int(ch.value), bps=int(bps.value),
                total=int(total.value))


def flac_decode(data: bytes) -> tuple[np.ndarray, int]:
    """Decode a FLAC stream -> (float32 audio in [-1, 1], (T,) mono or
    (T, C), sample rate): the int samples over 2^(bps - 1)."""
    lib = _load()
    info = flac_probe(data)
    ch, bps = info["channels"], info["bps"]
    buf = np.frombuffer(data, np.uint8)
    cap = ((info["total"] or (len(data) * 8 // max(bps, 1) + 65536)) * ch + 65536 * ch)
    out = np.zeros(cap, np.int32)
    n = lib.flac_decode(buf.ctypes.data_as(_U8_P), len(buf),
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap)
    if n < 0:
        raise ValueError(f"FLAC decode failed (err {-n})")
    pcm = out[:n].astype(np.float32) / float(1 << (bps - 1))
    if ch > 1:
        pcm = pcm.reshape(-1, ch)
    return pcm, info["sample_rate"]
