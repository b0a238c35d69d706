"""Whole-song conversion, closed loop: `ConvertPipeline.convert_utterance`
on one song after another at B = 1, fp32 with TF32 off, with the chunk
budget x_pad / x_query / x_center / x_max of the cell's file; each
chunk's noise given (`noise_fn=`, the same buffers cut to the chunk).

The songs' lengths are the fixed ladder `song_seconds`, in its order,
their voices drawn from the seed, so every seed converts the same chunk
shapes in the same order (a window holds a cycle and a half of the
ladder, so an order drawn per seed would change the mix it measures);
set-up converts every chunk shape once.  The program's pitch of
each chunk is read where `convert_utterance` gets it (its own
`convert_batch`'s return), so that the reference judges the waveform on
it apart from RMVPE's run-to-run wobble, and RMVPE on its own.

Parameters: song_seconds, f0_method, index_rate, protect,
sid, x_pad, x_query, x_center, x_max, check_songs, limits.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from benchmark import convert_common as cc
from benchmark import roofline
from benchmark.reference import convert as ref_convert


def _chunk_params(p: dict) -> dict:
    return {k: p[k] for k in ("x_pad", "x_query", "x_center", "x_max")}


def setup_inputs(ctx) -> None:
    p, dev = ctx.params, ctx.device
    models = cc.build_models(ctx.config, ctx.seed, dev)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed % (2 ** 63) + 23)
    songs = [cc.voices(1, [s], gen, dev)[0].cpu().numpy() for s in p["song_seconds"]]
    chunks = [ref_convert.chunks(s, **_chunk_params(p))[1] for s in songs]
    longest = max(c.shape[1] for cs in chunks for c, _ in cs)
    z, sine = cc.noise_pool(1, 1, ref_convert.frames(longest), ctx.config["model"], gen, dev)[0]
    ctx.state.update(models=models, songs=songs, chunks=chunks, z=z, sine=sine,
                     settings=cc.program_settings(p))


def noise_fn(ctx):
    z, sine = ctx.state["z"], ctx.state["sine"]
    upp = ref_convert.model_cfg(ctx.config["model"]).upp

    def fn(b: int, p_len: int):
        return z[:b, :p_len], {"sine": sine[:b, :p_len * upp]}
    return fn


def setup(ctx) -> None:
    setup_inputs(ctx)
    st, p = ctx.state, ctx.params
    pipe = st["pipe"] = cc.program_pipeline(ctx.config, st["models"], ctx.device)
    fn = noise_fn(ctx)
    seen = set()
    for cs in st["chunks"]:                      # every chunk shape once
        for chunk, n in cs:
            if chunk.shape[1] in seen:
                continue
            seen.add(chunk.shape[1])
            z, noise = fn(1, ref_convert.frames(chunk.shape[1]))
            pipe.convert_batch(chunk, np.asarray([n]), p["sid"], st["settings"],
                               z_noise=z, noise=noise)
    # the pitch of every chunk the window converts, as the pipeline gets it
    st["pitches"] = pitches = []
    inner = pipe.convert_batch

    def recording(*a, **kw):
        wav, pitchf = inner(*a, **kw)
        pitches.append(pitchf)
        return wav, pitchf
    pipe.convert_batch = recording


def window(ctx, seconds: float) -> dict:
    st, p = ctx.state, ctx.params
    pipe, fn = st["pipe"], noise_fn(ctx)
    st["pitches"].clear()
    outs = []
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        outs.append(pipe.convert_utterance(st["songs"][n % len(st["songs"])], p["sid"],
                                           st["settings"], noise_fn=fn))
        n += 1
    if ctx.device == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st["outs"] = outs
    order = [k % len(st["songs"]) for k in range(n)]
    audio_s = sum(len(st["songs"][j]) / 16000.0 for j in order)
    shapes = [s for j in order for c, _ in st["chunks"][j]
              for s in cc.resblock_launches(ctx.config, 1, c.shape[1])]
    work = {"audio_s": audio_s, "songs": n, "order": order, "resblock_shapes": shapes,
            "resblock_dtype": "float32", "dtype": "float32"}
    return {"metrics": {"song_audio_s_per_s": audio_s / dt}, "attempted": n,
            "failed": 0, "work": work, "ranges": cc.RANGES}


def trace_work(ctx, work: dict) -> None:
    p = ctx.params
    work["model_flops"] = sum(roofline.convert_flops(ctx.config, 1, c.shape[1], p["index_rate"])
                              for j in work["order"] for c, _ in ctx.state["chunks"][j])


def free(ctx) -> None:
    """Keep the judged songs' outputs and chunk pitches on the host."""
    st, p = ctx.state, ctx.params
    n = len(st["outs"])
    picks = sorted(random.Random(ctx.seed * 7 + 3).sample(range(n), min(p["check_songs"], n)))
    starts, at = [], 0
    for k in range(n):
        starts.append(at)
        at += len(st["chunks"][k % len(st["songs"])])
    st["judged"] = [(k % len(st["songs"]), st["outs"][k],
                     [x.cpu() for x in st["pitches"][starts[k]:starts[k] + len(
                         st["chunks"][k % len(st["songs"])])]]) for k in picks]
    for key in ("outs", "pipe", "pitches"):
        st.pop(key, None)


def judge(ctx, judged) -> list:
    """Each judged song converted by the reference chunk by chunk: RMVPE's
    f0 of each chunk against the program's, the song assembled from the
    reference's chunk waveforms on the program's pitch against the
    program's song."""
    st, p = ctx.state, ctx.params
    ref = cc.reference_models(st.pop("models"))
    cfg = ref_convert.model_cfg(ctx.config["model"])
    fn = noise_fn(ctx)
    off = wave = 0.0
    with torch.inference_mode():
        for j, song, pitches in judged:
            pieces = []
            for (chunk, n), pitchf in zip(st["chunks"][j], pitches):
                audio = torch.as_tensor(chunk, device=ctx.device)
                z, noise = fn(1, ref_convert.frames(chunk.shape[1]))
                wav, _, own = ref_convert.convert_rows(
                    ref, cfg, audio, torch.tensor([n], device=ctx.device), sid=p["sid"],
                    index_rate=p["index_rate"], protect=p["protect"], z_noise=z,
                    sine=noise["sine"], pitchf=pitchf.to(ctx.device))
                off = max(off, cc.f0_frames_off(pitchf, own.cpu()))
                pieces.append((wav[0].cpu().numpy(), n))
            ref_song = ref_convert.assemble(pieces, cfg.upp, cfg.sr, p["x_pad"])
            if ref_song.shape != song.shape:
                wave = float("inf")
            else:
                wave = max(wave, cc.wave_gap(song, ref_song))
    lim = p["limits"]
    return [("f0_frames_off", off, lim["f0_frames_off"]), ("wave_gap", wave, lim["wave_gap"])]


def check(ctx) -> list:
    return judge(ctx, ctx.state.pop("judged"))


def control(ctx) -> list:
    """The control: the reference with TF32 on in the program's place on
    the first `check_songs` songs, judged as the program is."""
    setup_inputs(ctx)
    st, p = ctx.state, ctx.params
    ref = cc.reference_models(st["models"])
    cfg = ref_convert.model_cfg(ctx.config["model"])
    fn = noise_fn(ctx)
    judged = []
    with cc.tf32(True), torch.inference_mode():
        for j in range(min(p["check_songs"], len(st["songs"]))):
            pieces, pitches = [], []
            for chunk, n in st["chunks"][j]:
                z, noise = fn(1, ref_convert.frames(chunk.shape[1]))
                wav, pitchf, _ = ref_convert.convert_rows(
                    ref, cfg, torch.as_tensor(chunk, device=ctx.device),
                    torch.tensor([n], device=ctx.device), sid=p["sid"],
                    index_rate=p["index_rate"], protect=p["protect"], z_noise=z,
                    sine=noise["sine"])
                pieces.append((wav[0].cpu().numpy(), n))
                pitches.append(pitchf.cpu())
            judged.append((j, ref_convert.assemble(pieces, cfg.upp, cfg.sr, p["x_pad"]),
                           pitches))
    del ref
    return judge(ctx, judged)
