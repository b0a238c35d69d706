"""Warm start: run the serving shapes once before traffic arrives.

Counterpart of JAX `utils/warmup.py`.  Eager PyTorch compiles nothing
per shape, so the JAX module's persistent compilation cache
(`enable_compilation_cache`) has no counterpart here: the kernels' one
compile is `nvcc`, whose output `ops/build.py` keeps in `_build/` across
processes.  What a first request still pays is the first use of each
shape: the kernel libraries' load (and their build, in a fresh
checkout), cuDNN's and cuBLAS's handles and algorithm choice, and the
caching allocator's growth.  `warm_pipeline` pays them up front.
cuDNN's execution plans are kept per thread, so a warm-up helps only
the thread it runs on (the server warms on its device thread).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

logger = logging.getLogger(__name__)


def load_route_kernels(pipe) -> list[str]:
    """Build (if needed) and load the kernel libraries that the
    pipeline's decode launches: the resblock route of each decode stage's
    width at the pipeline's dtype.  Nothing on the CPU, or for a decoder
    without resblocks on the kernel (RefineGAN).  Returns the routes."""
    from ..models.synthesizer import decoder_kind
    from ..ops import resblock as rb

    if pipe.device.type != "cuda" or decoder_kind(pipe.cfg) == "refinegan":
        return []
    c, routes = pipe.cfg.upsample_initial_channel, set()
    for _ in pipe.cfg.upsample_rates:
        c //= 2
        routes.add(rb._route("cuda", pipe.dtype, c))
    for route in sorted(routes):
        rb._library(route)
    return sorted(routes)


def warm_pipeline(pipe, settings=None, *, seconds=(3,), batches=(1,),
                  fetch: bool = True) -> float:
    """Run zero audio through both serve paths at the given shapes.

    The two paths run different shapes for the same n-second request: the
    batcher feeds n seconds into `convert_batch`, while `convert_utterance`
    reflect-pads x_pad seconds per side on the host first, which makes an
    (n + 2 * x_pad)-second chunk.  So `convert_batch` runs at every
    (batch, seconds) pair, and `convert_utterance` once per batch-1
    entry.  On the card the route's kernels are loaded first
    (`load_route_kernels`).  fetch: wait for the device after each call.
    A failed pass raises: a server that could not warm does not serve.
    Returns the wall seconds spent."""
    from ..pipelines.convert import SAMPLE_RATE, ConvertSettings

    if settings is None:
        settings = ConvertSettings(f0_method=(
            "rmvpe" if pipe.rmvpe_params is not None else "yin"))
    t0 = time.perf_counter()
    device = getattr(pipe, "device", None)
    if device is not None:
        load_route_kernels(pipe)
    for b in batches:
        for sec in seconds:
            L = int(sec) * SAMPLE_RATE
            audio = np.zeros((int(b), L), np.float32)
            lengths = np.full((int(b),), L, np.int64)
            pipe.convert_batch(audio, lengths, 0, settings)
            if int(b) == 1:
                pipe.convert_utterance(audio[0], 0, settings)
            if fetch and device is not None and device.type == "cuda":
                torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    logger.info("warmup done: batches=%s seconds=%s in %.1f s",
                list(batches), list(seconds), dt)
    return dt


def parse_warm_spec(spec: str):
    """'1x3,4x5' -> [(1, 3), (4, 5)] (batch, seconds) pairs; a single
    integer means batch 1: '3,5' == '1x3,1x5'."""
    pairs = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        b, s = part.split("x", 1) if "x" in part else ("1", part)
        pairs.append((int(b), int(s)))
    return pairs
