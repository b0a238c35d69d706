"""Batch conversion, closed loop: `ConvertPipeline.convert_batch` back to
back from one caller, each batch `rows` voices of `seconds` at 16 kHz
handed over as host arrays, the noise given (`z_noise=`, `noise=`).

Parameters (the cell's file): rows, seconds, pool (distinct batches the
loop cycles through), f0_method, index_rate, protect, sid, check_batches
(window batches the reference judges, drawn from the seed), limits.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from benchmark import convert_common as cc
from benchmark import roofline
from benchmark.reference import convert as ref_convert


def setup_inputs(ctx) -> None:
    """The models, the pool of batches and their noise, from the seed."""
    p, dev = ctx.params, ctx.device
    models = cc.build_models(ctx.config, ctx.seed, dev)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed % (2 ** 63) + 11)
    samples = int(16000 * p["seconds"])
    p_len = ref_convert.frames(samples)
    pool = [cc.voices(p["rows"], p["seconds"], gen, dev).cpu().numpy()
            for _ in range(p["pool"])]
    noise = cc.noise_pool(p["pool"], p["rows"], p_len, ctx.config["model"], gen, dev)
    lengths = np.full((p["rows"],), samples, dtype=np.int64)
    ctx.state.update(models=models, pool=pool, noise=noise, lengths=lengths,
                     settings=cc.program_settings(p), samples=samples)


def setup(ctx) -> None:
    setup_inputs(ctx)
    st, p = ctx.state, ctx.params
    pipe = st["pipe"] = cc.program_pipeline(ctx.config, st["models"], ctx.device)
    pool, noise, lengths = st["pool"], st["noise"], st["lengths"]
    pipe.convert_batch(pool[0], lengths, p["sid"], ctx.state["settings"],
                       z_noise=noise[0][0], noise={"sine": noise[0][1]})   # warm-up


def window(ctx, seconds: float) -> dict:
    st, p = ctx.state, ctx.params
    pipe, settings, lengths = st["pipe"], st["settings"], st["lengths"]
    outs = []
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        j = i % p["pool"]
        z, sine = st["noise"][j]
        outs.append(pipe.convert_batch(st["pool"][j], lengths, p["sid"], settings,
                                       z_noise=z, noise={"sine": sine}))
        i += 1
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st["outs"] = outs
    audio_s = i * p["rows"] * p["seconds"]
    shapes = cc.resblock_launches(ctx.config, p["rows"], st["samples"])
    work = {"audio_s": audio_s, "batches": i, "resblock_shapes": shapes * i,
            "resblock_dtype": "float32", "dtype": "float32"}
    return {"metrics": {"convert_audio_s_per_s": audio_s / dt}, "attempted": i,
            "failed": 0, "work": work, "ranges": cc.RANGES}


def trace_work(ctx, work: dict) -> None:
    """The model's operations in the traced window (after it closed)."""
    p = ctx.params
    work["model_flops"] = work["batches"] * roofline.convert_flops(ctx.config, p["rows"],
                                                           ctx.state["samples"], p["index_rate"])


def free(ctx) -> None:
    """Keep the judged batches' outputs on the host; free the rest."""
    st, p = ctx.state, ctx.params
    n = len(st["outs"])
    rng = random.Random(ctx.seed * 7 + 5)
    picks = sorted(rng.sample(range(n), min(p["check_batches"], n)))
    st["judged"] = [(k, st["outs"][k][0].cpu(), st["outs"][k][1].cpu()) for k in picks]
    for key in ("outs", "pipe"):
        st.pop(key, None)


def check(ctx) -> list:
    """The reference on each judged batch's inputs: RMVPE's f0 against
    the program's pitch, and the waveform on the program's pitch."""
    return judge(ctx, ctx.state.pop("judged"))


def judge(ctx, judged) -> list:
    st, p = ctx.state, ctx.params
    ref = cc.reference_models(st.pop("models"))
    cfg = ref_convert.model_cfg(ctx.config["model"])
    lengths = torch.as_tensor(st["lengths"], device=ctx.device)
    off = wave = 0.0
    with torch.inference_mode():
        for k, wav, pitchf in judged:
            j = k % p["pool"]
            audio = torch.as_tensor(st["pool"][j], device=ctx.device)
            z, sine = st["noise"][j]
            ref_wav, _, own = ref_convert.convert_rows(
                ref, cfg, audio, lengths, sid=p["sid"], index_rate=p["index_rate"],
                protect=p["protect"], z_noise=z, sine=sine,
                pitchf=pitchf.to(ctx.device))
            off = max(off, cc.f0_frames_off(pitchf, own.cpu()))
            wave = max(wave, cc.wave_gap(wav, ref_wav.cpu()))
    lim = p["limits"]
    return [("f0_frames_off", off, lim["f0_frames_off"]), ("wave_gap", wave, lim["wave_gap"])]


def control(ctx) -> list:
    """The control: the reference in the program's place with TF32 on
    (the precision below the configuration's fp32), on the first
    `check_batches` batches of the pool, judged as the program is."""
    setup_inputs(ctx)
    st, p = ctx.state, ctx.params
    ref = cc.reference_models(st["models"])
    cfg = ref_convert.model_cfg(ctx.config["model"])
    lengths = torch.as_tensor(st["lengths"], device=ctx.device)
    judged = []
    with cc.tf32(True), torch.inference_mode():
        for k in range(min(p["check_batches"], p["pool"])):
            z, sine = st["noise"][k]
            wav, pitchf, _ = ref_convert.convert_rows(
                ref, cfg, torch.as_tensor(st["pool"][k], device=ctx.device), lengths,
                sid=p["sid"], index_rate=p["index_rate"], protect=p["protect"],
                z_noise=z, sine=sine)
            judged.append((k, wav.cpu(), pitchf.cpu()))
    del ref
    return judge(ctx, judged)
