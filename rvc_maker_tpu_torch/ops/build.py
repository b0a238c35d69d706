"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `rvc_maker_tpu_torch/csrc/` becomes one shared library
with a plain C interface, compiled for `sm_90a` at first use into
`rvc_maker_tpu_torch/_build/` (listed in .gitignore).  The library name
carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  Nothing is downloaded.
The C++ host libraries (`HOST_SOURCES`) build the same way with g++.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = {"resblock": "resblock.cu", "resblock_tc": "resblock_tc.cu",
           "resblock_tc_bf16": "resblock_tc_bf16.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# wall seconds of each source's nvcc in the builds of this process
build_seconds: dict[str, float] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _command(name: str, out: str) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out, str(CSRC_DIR / SOURCES[name])]


def build_all(names=None) -> dict[str, str]:
    """Compile every named kernel (default: all) that is not built yet,
    one nvcc per source, all started together.  Returns each compiler's
    output (ptxas registers / shared memory / spills) by name; raises
    if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (tmp, target, subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))

    def finish(proc):
        out, _ = proc.communicate()
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(max(1, len(procs))) as pool:
        done = {name: pool.submit(finish, proc) for name, (_, _, proc) in procs.items()}
    logs = {name: "" for name in names}
    failed = []
    for name, (tmp, target, proc) in procs.items():
        logs[name], build_seconds[name] = done[name].result()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{logs[name]}")
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


# C++ host libraries: name -> source.  The WORLD-style F0 estimators and
# the FLAC decoder are the repo's own native/src/worldlike.cpp and
# flacdec.cpp, each built alone with the flags of native/Makefile; the
# library the Makefile builds is never loaded.
HOST_SOURCES = {"worldlike": PACKAGE_DIR.parent / "native" / "src" / "worldlike.cpp",
                "flacdec": PACKAGE_DIR.parent / "native" / "src" / "flacdec.cpp"}
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-march=native", "-Wall", "-shared")


@functools.lru_cache(maxsize=1)
def _native_target() -> bytes:
    """What -march=native resolves to on this machine (g++'s report), so
    that a library built for one CPU is not loaded on another."""
    return subprocess.run([_cxx(), "-march=native", "-Q", "--help=target"],
                          capture_output=True, check=True).stdout


def _cxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: it builds the port's C++ host libraries")
    return found


def host_library_path(name: str) -> Path:
    src = HOST_SOURCES[name].read_bytes()
    h = hashlib.sha256(src + " ".join(CXX_FLAGS).encode() + _native_target()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The C++ host library `name`, compiled with g++ on first use (its
    seconds in `build_seconds`).  A failed build raises."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            target = host_library_path(name)
            if not target.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                t0 = time.perf_counter()
                proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", tmp, str(HOST_SOURCES[name])],
                                      capture_output=True, text=True)
                build_seconds[name] = time.perf_counter() - t0
                if proc.returncode != 0:
                    os.unlink(tmp)
                    raise RuntimeError(f"{name}: g++ exited {proc.returncode}\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, target)
            lib = _loaded[name] = ctypes.CDLL(str(target))
        return lib


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.rvc_cuda_error_string.argtypes = [ctypes.c_int]
            lib.rvc_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def error_string(lib: ctypes.CDLL, code: int) -> str:
    return lib.rvc_cuda_error_string(int(code)).decode(errors="replace")
