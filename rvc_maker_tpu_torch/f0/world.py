"""ctypes binding of the WORLD-style F0 estimators: dio, stonemask and
harvest (counterpart of `rvc_maker_tpu/native/__init__.py:36-149`).

The library is the repo's native/src/worldlike.cpp, built alone with g++
at first use into rvc_maker_tpu_torch/_build/ (`ops/build.py`
`load_host`); `make` and the prebuilt library of native/build/ are not
used.  A failed build raises: no estimator here falls back to another.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops import build

_DBL_P = ctypes.POINTER(ctypes.c_double)
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load_host("worldlike")
        lib.worldlike_num_frames.restype = ctypes.c_int
        lib.worldlike_num_frames.argtypes = [ctypes.c_int, ctypes.c_double, ctypes.c_double]
        for fn in (lib.worldlike_dio, lib.worldlike_harvest):
            fn.restype = None
            fn.argtypes = [_DBL_P, ctypes.c_int, ctypes.c_double, ctypes.c_double,
                           ctypes.c_double, ctypes.c_double, _DBL_P, _DBL_P]
        lib.worldlike_stonemask.restype = None
        lib.worldlike_stonemask.argtypes = [_DBL_P, ctypes.c_int, ctypes.c_double, _DBL_P,
                                            _DBL_P, ctypes.c_int, _DBL_P]
        _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_DBL_P)


def _estimate(fn_name: str, x, fs: int, f0_floor: float, f0_ceil: float,
              frame_period: float):
    lib = _load()
    x = np.ascontiguousarray(x, np.float64)
    n_frames = lib.worldlike_num_frames(len(x), float(fs), float(frame_period))
    t = np.zeros(n_frames, np.float64)
    f0 = np.zeros(n_frames, np.float64)
    getattr(lib, fn_name)(_ptr(x), len(x), float(fs), float(f0_floor), float(f0_ceil),
                          float(frame_period), _ptr(t), _ptr(f0))
    return f0, t


def dio(x: np.ndarray, fs: int, *, f0_floor: float = 50.0, f0_ceil: float = 1100.0,
        frame_period: float = 10.0):
    """WORLD-dio-style F0: (f0 (T,), time axis (T,)) float64, the
    reference PYWORLD.dio's return (WORLD_WRAPPER.py:56-81)."""
    return _estimate("worldlike_dio", x, fs, f0_floor, f0_ceil, frame_period)


def harvest(x: np.ndarray, fs: int, *, f0_floor: float = 50.0, f0_ceil: float = 1100.0,
            frame_period: float = 10.0):
    """Harvest F0 (Morise, INTERSPEECH 2017; reference PYWORLD.harvest,
    WORLD_WRAPPER.py:32-54): (f0 (T,), time axis (T,)) float64."""
    return _estimate("worldlike_harvest", x, fs, f0_floor, f0_ceil, frame_period)


def stonemask(x: np.ndarray, fs: int, time_axis: np.ndarray, f0: np.ndarray) -> np.ndarray:
    """Refine an F0 contour (reference PYWORLD.stonemask,
    WORLD_WRAPPER.py:83-89)."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float64)
    t = np.ascontiguousarray(time_axis, np.float64)
    f0 = np.ascontiguousarray(f0, np.float64)
    out = np.zeros_like(f0)
    lib.worldlike_stonemask(_ptr(x), len(x), float(fs), _ptr(t), _ptr(f0), len(f0), _ptr(out))
    return out
