"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `rvc_maker_tpu_torch/csrc/` becomes one shared library
with a plain C interface, compiled for `sm_90a` at first use into
`rvc_maker_tpu_torch/_build/` (listed in .gitignore).  The library name
carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.  Nothing is downloaded.
"""

from __future__ import annotations

import ctypes
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
SOURCES = {"resblock": "resblock.cu", "resblock_tc": "resblock_tc.cu"}
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
