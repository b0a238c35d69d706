#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:
  1. device   the card's name and power limit; no card -> exit 1.
  2. build    every kernel of the port from rvc_maker_tpu_torch/csrc/
              (one nvcc per source, started together), with ptxas's
              registers / shared memory / spills.
  3. kernels  each kernel against its plain PyTorch version at the
              shapes the main path gives it (fp32 max abs err <=
              1e-4 * max(1, |ref|max); bf16 correlation > 0.99), then
              timed with CUDA events: kernel, plain version, and the
              library yardstick (a cuDNN F.conv1d chain, never used by
              the port), beside the least time the card could take.
  4. main     the port's ConvertPipeline at the full v2 / 48 kHz width
              (12-layer HuBERT, full RMVPE, 10,000 x 768 index, random
              weights from a seed): convert_batch on 2 x 10 s and
              convert_utterance on one 45 s utterance (longer than x_max,
              so it is split).  Kernel launch counts are zeroed just
              before and read just after.  Then the utterance once more
              (its chunk shapes seen once), and each call once more under
              torch.profiler: device time by stage and by kernel, and the
              device's busy share of the wall time.
  5. parity   the same model and noise on a 2 s input on the CPU (plain
              versions) and on the card: waveform max abs err <= 1e-3 and
              the RMVPE argmax equal on every frame.

fp32 throughout, with TF32 off for cuDNN and matmuls (the parity path).
The line before the last holds the kernels' JSON summary; the last line
is {"ok": true, "device": {...}}.  Details go to chiprun_out/chip_smoke.json.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

H100_FP32_FLOPS = 67e12      # CUDA-core fp32 peak, H100 SXM data sheet
H100_BF16_FLOPS = 989e12     # dense bf16 tensor-core peak
H100_BYTES_PER_S = 3.35e12   # HBM3
RESULTS = {}


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() over `iters` launches, after warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: the resblock kernel against its plain version
# ---------------------------------------------------------------------------

def library_resblock(x, wt1, b1, wt2, b2, k, dilations):
    """The same resblock as a chain of cuDNN F.conv1d with weights laid
    out for cuDNN beforehand ((D, Cout, Cin, k) contiguous)."""
    F = torch.nn.functional
    for i, d in enumerate(dilations):
        y = F.conv1d(F.leaky_relu(x, 0.1), wt1[i], b1[i], dilation=d,
                     padding=(k * d - d) // 2)
        y = F.conv1d(F.leaky_relu(y, 0.1), wt2[i], b2[i], padding=(k - 1) // 2)
        x = x + y
    return x


def check_resblock(stage_shapes, kernels, dilations, card: str):
    from rvc_maker_tpu_torch.ops import resblock as rb

    gen = torch.Generator().manual_seed(0)
    rows, worst = [], 0.0
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bf16_ms=0.0,
                  flops=0, bytes=0)
    saved = rb.resblock_launches
    for (b, c, t) in stage_shapes:
        for k in kernels:
            D = len(dilations)
            scale = 0.5 / (k * c) ** 0.5
            x = (torch.randn(b, c, t, generator=gen) * 0.3).cuda()
            w1 = (torch.randn(D, k, c, c, generator=gen) * scale).cuda()
            w2 = (torch.randn(D, k, c, c, generator=gen) * scale).cuda()
            b1 = (torch.randn(D, c, generator=gen) * 0.1).cuda()
            b2 = (torch.randn(D, c, generator=gen) * 0.1).cuda()
            args = (x, w1, b1, w2, b2)
            kw = dict(kernel_size=k, dilations=dilations)
            ref = rb._resblock(*args, **kw)
            got = rb.fused_resblock(*args, **kw)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            worst = max(worst, err)
            argsb = tuple(a.bfloat16() for a in args)
            gotb = rb.fused_resblock(*argsb, **kw).float()
            corr = torch.corrcoef(torch.stack([gotb.flatten(), ref.flatten()]))[0, 1].item()
            wt1 = w1.permute(0, 3, 2, 1).contiguous()
            wt2 = w2.permute(0, 3, 2, 1).contiguous()
            iters = 10
            ms = cuda_ms(lambda: rb.fused_resblock(*args, **kw), iters)
            plain_ms = cuda_ms(lambda: rb._resblock(*args, **kw), iters)
            lib_ms = cuda_ms(lambda: library_resblock(x, wt1, b1, wt2, b2, k, dilations), iters)
            bf16_ms = cuda_ms(lambda: rb.fused_resblock(*argsb, **kw), iters)
            flops = rb.resblock_flops(b, t, c, k, D)
            nbytes = 4 * (2 * b * c * t + w1.numel() + w2.numel() + b1.numel() + b2.numel())
            bound_ms = 1e3 * max(flops / H100_FP32_FLOPS, nbytes / H100_BYTES_PER_S)
            smem = {d: rb.smem_bytes(c, k, d) for d in dilations}
            rows.append(dict(B=b, C=c, T=t, k=k, smem_bytes=smem, max_abs_err=err,
                             tol=tol, bf16_corr=corr, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bf16_ms=bf16_ms, flops=flops,
                             bytes=nbytes, bound_ms=bound_ms, roofline_share=bound_ms / ms))
            log(f"  resblock B={b} C={c} T={t} k={k}: shared memory per block "
                + ", ".join(f"{v / 1024:.1f} KB at d={d}" for d, v in smem.items()))
            log(f"  resblock B={b} C={c} T={t} k={k}: err {err:.3e} (tol {tol:.1e}) "
                f"bf16 corr {corr:.6f} | kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                f"library {lib_ms:.3f} ms, bf16 kernel {bf16_ms:.3f} ms | "
                f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB, bound {bound_ms:.3f} ms "
                f"(fp32 ops), roofline share {bound_ms / ms:.3f}")
            if not err <= tol:
                raise AssertionError(f"resblock C={c} k={k}: err {err} > {tol}")
            if not corr > 0.99:
                raise AssertionError(f"resblock bf16 C={c} k={k}: corr {corr}")
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                           ("bf16_ms", bf16_ms), ("flops", flops), ("bytes", nbytes)):
                totals[key] += v
            del x, w1, w2, b1, b2, args, argsb, ref, got, gotb, wt1, wt2
    rb.resblock_launches = saved      # comparison launches do not count
    torch.cuda.empty_cache()
    fl_ms = 1e3 * totals["flops"] / H100_FP32_FLOPS
    by_ms = 1e3 * totals["bytes"] / H100_BYTES_PER_S
    totals.update(bound_ms=max(fl_ms, by_ms),
                  bound_by="operations" if fl_ms >= by_ms else "bytes",
                  bf16_bound_ms=1e3 * max(totals["flops"] / H100_BF16_FLOPS,
                                          totals["bytes"] / 2 / H100_BYTES_PER_S),
                  max_abs_err=worst)
    log(f"  one decode's 12 resblocks: kernel {totals['ms']:.3f} ms, plain "
        f"{totals['plain_ms']:.3f} ms, library {totals['library_ms']:.3f} ms, bf16 kernel "
        f"{totals['bf16_ms']:.3f} ms; {totals['flops'] / 1e12:.3f} TFLOP, "
        f"{totals['bytes'] / 1e9:.3f} GB -> bound {totals['bound_ms']:.3f} ms "
        f"({totals['bound_by']}), roofline share {totals['bound_ms'] / totals['ms']:.3f}; "
        f"on {card}")
    return rows, totals


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def random_model(seed: int = 0):
    """v2-48k synthesizer, 12-layer HuBERT, full RMVPE and a 10,000-row
    index, drawn from a seed.  The decoder's upsampling and output convs
    are scaled up so that the waveform spans a good part of [-1, 1] and
    the 1e-3 parity bound is tight."""
    from rvc_maker_tpu_torch.config import preset
    from rvc_maker_tpu_torch.interop import from_jax

    cfg = preset("v2", 48000).model
    synth = from_jax.random_synthesizer_tree(cfg, seed=seed)
    for u in synth["dec"]["ups"]:
        u["w"] *= 5.0
    synth["dec"]["conv_post"]["w"] *= 5.0
    index = np.random.RandomState(seed + 3).randn(10000, 768).astype(np.float32)
    return cfg, dict(
        synth_params=from_jax.synthesizer_from_jax(synth, cfg),
        hubert_params=from_jax.hubert_from_jax(from_jax.random_hubert_tree(seed + 1)),
        rmvpe_params=from_jax.rmvpe_from_jax(from_jax.random_rmvpe_tree(seed + 2)),
        index_vectors=index)


def voice(seconds: float, f0: float, seed: int) -> np.ndarray:
    tt = np.arange(int(16000 * seconds)) / 16000
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.05 * np.sin(2 * np.pi * 3 * tt))) / 16000
    x = sum(0.3 / h * np.sin(h * phase) for h in (1, 2, 3))
    return (x + 0.01 * np.random.RandomState(seed).randn(len(tt))).astype(np.float32)


def profile_call(label, fn, wall_s):
    """torch.profiler over one more fn(): device time in all, by stage
    (the pipeline's `convert.*` ranges), in the resblock kernel, and by
    kernel; the busy share is the device time over `wall_s`, the same
    call's wall time without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    by_kernel, stages = {}, {}
    for e in events:
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time_total / 1e3
        elif e.device_type == DeviceType.CPU and e.name.startswith("convert."):
            stages[e.name] = stages.get(e.name, 0.0) + e.device_time_total / 1e3
    device_ms = sum(by_kernel.values())
    if device_ms == 0:
        log("  profile: device time not measured (the profiler saw no kernels)")
        return dict(device_ms=None)
    resblock_ms = sum(v for k, v in by_kernel.items() if "resblock_step_kernel" in k)
    # the resblock kernel is launched through ctypes, under no aten op, so
    # the profiler ties its time to no range: it belongs to the synthesizer
    stages["convert.synthesizer"] = stages.get("convert.synthesizer", 0.0) + resblock_ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    res = dict(device_ms=device_ms, wall_ms=1e3 * wall_s,
               busy_share=device_ms / (1e3 * wall_s), stages_ms=stages,
               unattributed_ms=device_ms - sum(stages.values()),
               resblock_ms=resblock_ms, resblock_share=resblock_ms / device_ms,
               top_kernels_ms=dict(top))
    log(f"  profile of {label}: device {device_ms:.3f} ms of "
        f"{1e3 * wall_s:.3f} ms wall (busy share {res['busy_share']:.3f}); resblock "
        f"kernel {resblock_ms:.3f} ms ({res['resblock_share']:.3f} of device time)")
    log("  by stage: " + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
        + f", outside the stages {res['unattributed_ms']:.3f} ms")
    for name, ms in top:
        log(f"    {ms:9.3f} ms  {name[:110]}")
    return res


def main_path(cfg, model):
    from rvc_maker_tpu_torch.ops import resblock as rb
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings

    pipe = ConvertPipeline(model["synth_params"], cfg, model["hubert_params"],
                           version="v2", rmvpe_params=model["rmvpe_params"],
                           index_vectors=model["index_vectors"], device="cuda")
    settings = ConvertSettings(index_rate=0.5)
    L = 16000 * 10
    batch = np.stack([voice(10.0, 150.0, 1), voice(10.0, 230.0, 2)])
    lengths = np.array([L, L])
    long = voice(45.0, 190.0, 3)
    n_resblocks = len(cfg.upsample_rates) * len(cfg.resblock_kernel_sizes)
    per_decode = sum(len(d) for d in cfg.resblock_dilation_sizes) * len(cfg.upsample_rates)

    pipe.convert_batch(batch, lengths, 0, settings)       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    rb.resblock_launches = 0
    t0 = time.perf_counter()
    wav, pitchf = pipe.convert_batch(batch, lengths, 0, settings)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    batch_launches = rb.resblock_launches
    t0 = time.perf_counter()
    out = pipe.convert_utterance(long, 0, settings)
    torch.cuda.synchronize()
    t_utt = time.perf_counter() - t0
    launches = rb.resblock_launches
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()           # again, its chunk shapes now seen once
    pipe.convert_utterance(long, 0, settings)
    torch.cuda.synchronize()
    t_utt_warm = time.perf_counter() - t0

    p_len = pipe.frames(L)
    if tuple(wav.shape) != (2, p_len * cfg.upp):
        raise AssertionError(f"batch wav shape {tuple(wav.shape)}")
    if not torch.isfinite(wav).all() or not np.isfinite(out).all():
        raise AssertionError("non-finite output")
    if batch_launches != per_decode:
        raise AssertionError(f"convert_batch launched {batch_launches}, "
                             f"expected {per_decode}")
    utt_launches = launches - batch_launches
    if utt_launches < 2 * per_decode or utt_launches % per_decode:
        raise AssertionError(f"convert_utterance launched {utt_launches}: "
                             "expected one decode per chunk, at least 2 chunks")
    if abs(len(out) - 45.0 * cfg.sr) > 2 * cfg.upp:
        raise AssertionError(f"utterance output {len(out)} samples")
    res = dict(batch_wav_shape=list(wav.shape), batch_s=t_batch,
               batch_audio_s_per_s=20.0 / t_batch, utterance_s=t_utt,
               utterance_audio_s_per_s=45.0 / t_utt, utterance_warm_s=t_utt_warm,
               utterance_chunks=utt_launches // per_decode,
               resblock_launches=launches, launches_per_decode=per_decode,
               resblocks_per_decode=n_resblocks, max_memory_allocated=peak,
               wav_absmax=float(wav.abs().max()), voiced_frames=float((pitchf > 0).float().mean()))
    log(f"  convert_batch 2 x 10 s: {t_batch:.3f} s wall ({20.0 / t_batch:.2f} audio-s/s), "
        f"wav {tuple(wav.shape)}, |wav|max {res['wav_absmax']:.3f}, "
        f"resblock launches {batch_launches}")
    log(f"  convert_utterance 45 s: {t_utt:.3f} s wall ({45.0 / t_utt:.2f} audio-s/s), "
        f"{res['utterance_chunks']} chunks, {len(out)} samples; a second call "
        f"{t_utt_warm:.3f} s")
    log(f"  resblock launches on the main path: {launches}; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    res["profile_batch"] = profile_call(
        "convert_batch 2 x 10 s", lambda: pipe.convert_batch(batch, lengths, 0, settings),
        t_batch)
    res["profile_utterance"] = profile_call(
        "convert_utterance 45 s", lambda: pipe.convert_utterance(long, 0, settings),
        t_utt_warm)
    del pipe
    torch.cuda.empty_cache()
    return res


def card_vs_cpu(cfg, model):
    from rvc_maker_tpu_torch.models import rmvpe as rmvpe_mod
    from rvc_maker_tpu_torch.ops import resblock as rb
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings

    audio = voice(2.0, 200.0, 4)[None]
    lengths = np.array([audio.shape[1]])
    settings = ConvertSettings(index_rate=0.5)
    outs, sal = {}, {}
    for dev in ("cpu", "cuda"):
        pipe = ConvertPipeline(model["synth_params"], cfg, model["hubert_params"],
                               version="v2", rmvpe_params=model["rmvpe_params"],
                               index_vectors=model["index_vectors"], device=dev)
        p_len = pipe.frames(audio.shape[1])
        zs, ss = pipe.noise_shapes(1, p_len)
        gen = torch.Generator().manual_seed(11)
        z, s = torch.randn(zs, generator=gen), torch.randn(ss, generator=gen)
        before = rb.resblock_launches
        wav, _ = pipe.convert_batch(audio, lengths, 0, settings, z_noise=z, sine_noise=s)
        if dev == "cuda" and rb.resblock_launches == before:
            raise AssertionError("the card's decode did not launch the kernel")
        outs[dev] = wav.cpu().numpy()
        with torch.inference_mode():
            _, h = rmvpe_mod.infer(pipe.rmvpe_params,
                                   torch.as_tensor(audio, device=pipe.device),
                                   return_salience=True)
        sal[dev] = h.cpu().numpy()
        del pipe
    err = float(np.abs(outs["cpu"] - outs["cuda"]).max())
    argmax_equal = bool((sal["cpu"].argmax(-1) == sal["cuda"].argmax(-1)).all())
    log(f"  card vs CPU, 2 s: waveform max abs err {err:.3e} (|wav|max "
        f"{np.abs(outs['cpu']).max():.3f}), RMVPE argmax equal on all "
        f"{sal['cpu'].shape[1]} frames: {argmax_equal}")
    if not err <= 1e-3:
        raise AssertionError(f"card vs CPU waveform err {err}")
    if not argmax_equal:
        raise AssertionError("RMVPE argmax differs between card and CPU")
    return dict(wave_max_abs_err=err, rmvpe_argmax_equal=argmax_equal)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no card", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from rvc_maker_tpu_torch.ops import build
    from rvc_maker_tpu_torch.ops import resblock as rb

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[1 device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    RESULTS["device"] = dict(name=name, nvidia_smi=smi, torch=torch.__version__,
                             cuda=torch.version.cuda)

    t0 = time.perf_counter()
    logs = build.build_all()
    RESULTS["build_s"] = time.perf_counter() - t0
    log(f"[2 build] {list(logs)} in {RESULTS['build_s']:.1f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    from rvc_maker_tpu_torch.config import preset
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline

    cfg = preset("v2", 48000).model
    shapes, t, c = [], ConvertPipeline.frames(16000 * 10), cfg.upsample_initial_channel
    for u in cfg.upsample_rates:
        t, c = t * u, c // 2
        shapes.append((2, c, t))
    log(f"[3 kernels] resblock at the main path's stage shapes {shapes}")
    rows, totals = check_resblock(shapes, cfg.resblock_kernel_sizes,
                                  tuple(cfg.resblock_dilation_sizes[0]), smi)
    RESULTS["resblock"] = dict(rows=rows, totals=totals)

    log("[4 main] building the v2-48k pipeline with random weights")
    model_cfg, model = random_model()
    RESULTS["main_path"] = main_path(model_cfg, model)

    log("[5 parity] card against CPU")
    RESULTS["parity"] = card_vs_cpu(model_cfg, model)
    RESULTS["total_s"] = time.perf_counter() - t_start
    log(f"done in {RESULTS['total_s']:.1f} s")

    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(RESULTS, f, indent=1)

    kernels = [dict(
        name="resblock", route="cuda", source="rvc_maker_tpu_torch/csrc/resblock.cu",
        replaces="rvc_maker_tpu/ops/pallas_resblock.py:147",
        launches=RESULTS["main_path"]["resblock_launches"],
        max_abs_err=totals["max_abs_err"], ms=totals["ms"], plain_ms=totals["plain_ms"],
        bound_ms=totals["bound_ms"], bound_by=totals["bound_by"],
        library_ms=totals["library_ms"])]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
