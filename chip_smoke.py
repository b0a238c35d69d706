#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:
  1. device   the card's name and power limit; no card -> exit 1.
  2. build    every kernel of the port from rvc_maker_tpu_torch/csrc/
              (one nvcc per source, started together), with each
              source's build time and ptxas's registers / spills.
  3. kernels  each kernel against its plain PyTorch version at the
              shapes the main path gives it: fp32 through the tensor-core
              kernel (resblock_tc.cu, the route of every fp32 width) and
              through the FMA kernel (resblock.cu), each max abs err <=
              1e-4 * max(1, |ref|max); bf16 (resblock.cu) correlation >
              0.99.  Then timed with CUDA events: the tensor-core kernel,
              the FMA kernel in fp32 (its earlier version), the plain
              version, and the library yardstick (a cuDNN F.conv1d chain,
              never used by the port), beside two bounds: the fp32
              CUDA-core one and the 3xTF32 one (3 x flops at the dense
              TF32 rate), the roofline share taken against the latter.
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
  6. train-kernel  the resblock as an autograd Function at the training
              path's four stage shapes (B = 8, a 36-frame segment): the
              forward against the plain chain, and the gradients of x, w1,
              b1, w2, b2 against torch.autograd through the plain chain
              with its leaky-ReLU slopes pinned at the kernel's step
              inputs (the derivative jumps at 0, and the two forwards
              differ by rounding; a slope may move only where the
              pre-activation is within the forward tolerance of 0), each
              <= 1e-4 * max(1, |ref|max); forward and backward timed.
  7. train    the training flow at the full v2 / 48 kHz width: 32 voiced
              3.5 s WAVs made from a seed -> preprocess -> extract (RMVPE
              and 12-layer HuBERT on the card) -> train one epoch at B = 8
              (4 steps, random weights from a seed) -> the exported .pth
              into ConvertPipeline on the card, one utterance converted.
              Launch counts are zeroed before train() and read after: 36
              per step.  Then one more step three ways: wall time, device
              ms per training range (CUDA events at the range edges) and
              under torch.profiler (device time, busy share).
  8. train-parity  one train step of a narrow model (decode C = 128..16,
              k = 3/7/11) from the same state and explicit noise on the
              CPU and on the card: each loss term <= 1e-4 relative, each
              gradient leaf <= 1e-3 * its max |g|.

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
H100_TF32_FLOPS = 494.7e12   # dense TF32 tensor-core peak; 3xTF32 spends 3 per flop
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


def bounds_ms(flops: float, nbytes: float):
    """(fp32 CUDA-core bound, 3xTF32 tensor-core bound, what bounds the
    latter) in ms: the larger of the operations at the peak rate and the
    bytes at the memory rate."""
    by_ms = 1e3 * nbytes / H100_BYTES_PER_S
    tc_ms = 1e3 * 3 * flops / H100_TF32_FLOPS
    return (max(1e3 * flops / H100_FP32_FLOPS, by_ms), max(tc_ms, by_ms),
            "operations" if tc_ms >= by_ms else "bytes")


def reset_counts(rb, counts=(0, 0)):
    """Set the resblock launch counts (all, tensor-core) and return the old ones."""
    old = rb.resblock_launches, rb.resblock_tc_launches
    rb.resblock_launches, rb.resblock_tc_launches = counts
    return old


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
    rows, worst, worst_fma = [], 0.0, 0.0
    totals = dict(ms=0.0, fma_ms=0.0, plain_ms=0.0, library_ms=0.0, bf16_ms=0.0,
                  flops=0, bytes=0)
    saved = reset_counts(rb)
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
            if rb.resblock_tc_launches != len(dilations):
                raise AssertionError(f"fp32 C={c} did not take the tensor-core kernel")
            got_fma = rb._fma_resblock(*args, **kw)
            err = (got - ref).abs().max().item()
            fma_err = (got_fma - ref).abs().max().item()
            tol = 1e-4 * max(1.0, ref.abs().max().item())
            worst, worst_fma = max(worst, err), max(worst_fma, fma_err)
            argsb = tuple(a.bfloat16() for a in args)
            gotb = rb.fused_resblock(*argsb, **kw).float()
            corr = torch.corrcoef(torch.stack([gotb.flatten(), ref.flatten()]))[0, 1].item()
            wt1 = w1.permute(0, 3, 2, 1).contiguous()
            wt2 = w2.permute(0, 3, 2, 1).contiguous()
            iters = 10
            ms = cuda_ms(lambda: rb.fused_resblock(*args, **kw), iters)
            fma_ms = cuda_ms(lambda: rb._fma_resblock(*args, **kw), iters)
            plain_ms = cuda_ms(lambda: rb._resblock(*args, **kw), iters)
            lib_ms = cuda_ms(lambda: library_resblock(x, wt1, b1, wt2, b2, k, dilations), iters)
            bf16_ms = cuda_ms(lambda: rb.fused_resblock(*argsb, **kw), iters)
            flops = rb.resblock_flops(b, t, c, k, D)
            nbytes = 4 * (2 * b * c * t + w1.numel() + w2.numel() + b1.numel() + b2.numel())
            fp32_bound_ms, bound_ms, _ = bounds_ms(flops, nbytes)
            smem = {d: rb.smem_bytes(c, k, d) for d in dilations}
            rows.append(dict(B=b, C=c, T=t, k=k, smem_bytes_tc=smem, max_abs_err=err,
                             fma_max_abs_err=fma_err, tol=tol, bf16_corr=corr, ms=ms,
                             fma_ms=fma_ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bf16_ms=bf16_ms, flops=flops, bytes=nbytes, bound_ms=bound_ms,
                             fp32_bound_ms=fp32_bound_ms, roofline_share=bound_ms / ms))
            log(f"  resblock B={b} C={c} T={t} k={k}: tensor-core kernel shared memory "
                "per block " + ", ".join(f"{v / 1024:.1f} KB at d={d}" for d, v in smem.items()))
            log(f"  resblock B={b} C={c} T={t} k={k}: err tc {err:.3e} fma {fma_err:.3e} "
                f"(tol {tol:.1e}) bf16 corr {corr:.6f} | tc kernel {ms:.3f} ms, fma kernel "
                f"{fma_ms:.3f} ms, plain {plain_ms:.3f} ms, library {lib_ms:.3f} ms, bf16 "
                f"fma kernel {bf16_ms:.3f} ms | {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB, "
                f"bound 3xTF32 {bound_ms:.3f} ms / fp32 {fp32_bound_ms:.3f} ms, roofline "
                f"share {bound_ms / ms:.3f}")
            if not (err <= tol and fma_err <= tol):
                raise AssertionError(f"resblock C={c} k={k}: err {err}, fma {fma_err} > {tol}")
            if not corr > 0.99:
                raise AssertionError(f"resblock bf16 C={c} k={k}: corr {corr}")
            for key, v in (("ms", ms), ("fma_ms", fma_ms), ("plain_ms", plain_ms),
                           ("library_ms", lib_ms), ("bf16_ms", bf16_ms), ("flops", flops),
                           ("bytes", nbytes)):
                totals[key] += v
            del x, w1, w2, b1, b2, args, argsb, ref, got, got_fma, gotb, wt1, wt2
            reset_counts(rb)
    reset_counts(rb, saved)           # comparison launches do not count
    torch.cuda.empty_cache()
    fp32_bound, bound, bound_by = bounds_ms(totals["flops"], totals["bytes"])
    totals.update(bound_ms=bound, bound_by=bound_by, fp32_bound_ms=fp32_bound,
                  bf16_bound_ms=1e3 * max(totals["flops"] / H100_BF16_FLOPS,
                                          totals["bytes"] / 2 / H100_BYTES_PER_S),
                  max_abs_err=worst, fma_max_abs_err=worst_fma)
    log(f"  one decode's 12 resblocks: tc kernel {totals['ms']:.3f} ms, fma kernel "
        f"{totals['fma_ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, library "
        f"{totals['library_ms']:.3f} ms, bf16 fma kernel {totals['bf16_ms']:.3f} ms; "
        f"{totals['flops'] / 1e12:.3f} TFLOP, {totals['bytes'] / 1e9:.3f} GB -> bound "
        f"3xTF32 {bound:.3f} ms ({bound_by}) / fp32 {fp32_bound:.3f} ms, roofline share "
        f"{bound / totals['ms']:.3f}; on {card}")
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


def is_resblock_kernel(name: str) -> bool:
    return "resblock_tc_step_kernel" in name or "resblock_step_kernel" in name


def profile_call(label, fn, wall_s):
    """torch.profiler over one more fn(): device time in all, by stage
    (the pipeline's `convert.*` ranges, as the profiler ties kernels to
    them; what it ties to none is "outside the stages"), in the resblock
    kernels, and by kernel; the busy share is the device time over
    `wall_s`, the same call's wall time without the profiler."""
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
    resblock_ms = sum(v for k, v in by_kernel.items() if is_resblock_kernel(k))
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

    reset_counts(rb)
    t0 = time.perf_counter()
    wav, pitchf = pipe.convert_batch(batch, lengths, 0, settings)
    torch.cuda.synchronize()
    t_batch = time.perf_counter() - t0
    batch_launches, batch_tc = rb.resblock_launches, rb.resblock_tc_launches
    t0 = time.perf_counter()
    out = pipe.convert_utterance(long, 0, settings)
    torch.cuda.synchronize()
    t_utt = time.perf_counter() - t0
    launches, tc_launches = rb.resblock_launches, rb.resblock_tc_launches
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
    if not batch_launches == batch_tc == per_decode:
        raise AssertionError(f"convert_batch launched {batch_launches} ({batch_tc} on the "
                             f"tensor cores), expected {per_decode}")
    if tc_launches != launches:
        raise AssertionError(f"{launches - tc_launches} fp32 steps missed resblock_tc")
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
               resblock_launches=launches, resblock_tc_launches=tc_launches,
               launches_per_decode=per_decode,
               resblocks_per_decode=n_resblocks, max_memory_allocated=peak,
               wav_absmax=float(wav.abs().max()), voiced_frames=float((pitchf > 0).float().mean()))
    log(f"  convert_batch 2 x 10 s: {t_batch:.3f} s wall ({20.0 / t_batch:.2f} audio-s/s), "
        f"wav {tuple(wav.shape)}, |wav|max {res['wav_absmax']:.3f}, "
        f"resblock launches {batch_launches}")
    log(f"  convert_utterance 45 s: {t_utt:.3f} s wall ({45.0 / t_utt:.2f} audio-s/s), "
        f"{res['utterance_chunks']} chunks, {len(out)} samples; a second call "
        f"{t_utt_warm:.3f} s")
    log(f"  resblock launches on the main path: {launches}, {tc_launches} of them "
        f"resblock_tc; peak device memory "
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
        before = rb.resblock_tc_launches
        wav, _ = pipe.convert_batch(audio, lengths, 0, settings, z_noise=z, sine_noise=s)
        if dev == "cuda" and rb.resblock_tc_launches == before:
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


# ---------------------------------------------------------------------------
# phase 6: the resblock's autograd Function at the training shapes
# ---------------------------------------------------------------------------

def check_resblock_train(stage_shapes, kernels, dilations, card: str):
    from rvc_maker_tpu_torch.ops import resblock as rb

    gen = torch.Generator().manual_seed(1)
    names = ("x", "w1", "b1", "w2", "b2")
    rows, worst_fwd, worst_grad, worst_flip = [], 0.0, 0.0, 0.0
    saved = reset_counts(rb)
    for (b, c, t) in stage_shapes:
        stage = dict(B=b, C=c, T=t, fwd_ms=0.0, fma_fwd_ms=0.0, plain_fwd_ms=0.0,
                     fwd_bwd_ms=0.0, plain_fwd_bwd_ms=0.0,
                     library_fwd_ms=0.0, flops=0, bytes=0)
        for k in kernels:
            D = len(dilations)
            scale = 0.5 / (k * c) ** 0.5
            args = [(torch.randn(b, c, t, generator=gen) * 0.3).cuda(),
                    (torch.randn(D, k, c, c, generator=gen) * scale).cuda(),
                    (torch.randn(D, c, generator=gen) * 0.1).cuda(),
                    (torch.randn(D, k, c, c, generator=gen) * scale).cuda(),
                    (torch.randn(D, c, generator=gen) * 0.1).cuda()]
            cot = torch.randn(b, c, t, generator=gen).cuda()
            kw = dict(kernel_size=k, dilations=dilations)
            ref = rb._resblock(*args, **kw)
            got = rb.fused_resblock(*args, **kw)
            fwd_err = (got - ref).abs().max().item()
            fwd_tol = 1e-4 * max(1.0, ref.abs().max().item())
            leaves = [a.detach().requires_grad_(True) for a in args]
            out = rb.fused_resblock(*leaves, **kw)
            if out.grad_fn is None:
                raise AssertionError("fused_resblock on the card returned no grad_fn")
            g_kernel = torch.autograd.grad(out, leaves, cot)
            # the reference: the plain chain with its leaky-ReLU slopes pinned
            # at the kernel's step inputs, since the kernel agrees with it to
            # rounding and leaky_relu's derivative jumps at 0
            steps = rb._forward_steps(*args, k, dilations)
            pinned, flip = rb._resblock_at_slopes(*leaves, **kw, step_inputs=steps[:-1])
            worst_flip = max(worst_flip, flip)
            if not flip <= fwd_tol:
                raise AssertionError(f"train resblock C={c} k={k}: a slope moved at a "
                                     f"pre-activation of {flip}")
            g_plain = torch.autograd.grad(pinned, leaves, cot)
            grad_err = {}
            for name, gk, gp in zip(names, g_kernel, g_plain):
                err = (gk - gp).abs().max().item()
                tol = 1e-4 * max(1.0, gp.abs().max().item())
                grad_err[name] = (err, tol)
                worst_grad = max(worst_grad, err)
            worst_fwd = max(worst_fwd, fwd_err)
            iters = 5
            fwd_ms = cuda_ms(lambda: rb.fused_resblock(*args, **kw), iters)
            fma_ms = cuda_ms(lambda: rb._fma_resblock(*args, **kw), iters)
            plain_ms = cuda_ms(lambda: rb._resblock(*args, **kw), iters)
            fb_ms = cuda_ms(lambda: torch.autograd.grad(
                rb.fused_resblock(*leaves, **kw), leaves, cot), iters)
            plain_fb_ms = cuda_ms(lambda: torch.autograd.grad(
                rb._resblock(*leaves, **kw), leaves, cot), iters)
            wt1 = args[1].permute(0, 3, 2, 1).contiguous()
            wt2 = args[3].permute(0, 3, 2, 1).contiguous()
            lib_ms = cuda_ms(lambda: library_resblock(args[0], wt1, args[2], wt2, args[4],
                                                      k, dilations), iters)
            flops = rb.resblock_flops(b, t, c, k, D)
            nbytes = 4 * (2 * b * c * t + sum(a.numel() for a in args[1:]))
            log(f"  train resblock B={b} C={c} T={t} k={k}: forward err {fwd_err:.3e} "
                f"(tol {fwd_tol:.1e}); slopes pinned at |pre-activation| <= {flip:.2e}; "
                "grad err " + ", ".join(
                    f"{nm} {e:.3e} (tol {tl:.1e})" for nm, (e, tl) in grad_err.items())
                + f" | tc kernel fwd {fwd_ms:.3f} ms, fma kernel fwd {fma_ms:.3f} ms, "
                f"plain fwd {plain_ms:.3f} ms, fwd+bwd "
                f"{fb_ms:.3f} ms (bwd "
                f"{fb_ms - fwd_ms:.3f}); plain fwd+bwd {plain_fb_ms:.3f} ms; library fwd "
                f"{lib_ms:.3f} ms")
            if not fwd_err <= fwd_tol:
                raise AssertionError(f"train resblock C={c} k={k}: forward err {fwd_err}")
            for nm, (e, tl) in grad_err.items():
                if not e <= tl:
                    raise AssertionError(f"train resblock C={c} k={k}: grad {nm} err {e} > {tl}")
            for key, v in (("fwd_ms", fwd_ms), ("fma_fwd_ms", fma_ms),
                           ("plain_fwd_ms", plain_ms), ("fwd_bwd_ms", fb_ms),
                           ("plain_fwd_bwd_ms", plain_fb_ms), ("library_fwd_ms", lib_ms),
                           ("flops", flops), ("bytes", nbytes)):
                stage[key] += v
            del args, leaves, out, ref, got, g_kernel, g_plain, cot, wt1, wt2, steps, pinned
            reset_counts(rb)
        stage["bwd_ms"] = stage["fwd_bwd_ms"] - stage["fwd_ms"]
        stage["fwd_fp32_bound_ms"], stage["fwd_bound_ms"], _ = bounds_ms(stage["flops"],
                                                                          stage["bytes"])
        rows.append(stage)
        log(f"  stage C={c}: tc kernel fwd {stage['fwd_ms']:.3f} ms (bound 3xTF32 "
            f"{stage['fwd_bound_ms']:.3f} / fp32 {stage['fwd_fp32_bound_ms']:.3f}), fma kernel "
            f"fwd {stage['fma_fwd_ms']:.3f} ms, plain fwd {stage['plain_fwd_ms']:.3f} ms, bwd "
            f"{stage['bwd_ms']:.3f} ms, plain fwd+bwd {stage['plain_fwd_bwd_ms']:.3f} ms, "
            f"library fwd {stage['library_fwd_ms']:.3f} ms")
    reset_counts(rb, saved)           # comparison launches do not count
    torch.cuda.empty_cache()
    tot = {key: sum(r[key] for r in rows) for key in
           ("fwd_ms", "fma_fwd_ms", "plain_fwd_ms", "bwd_ms", "fwd_bwd_ms",
            "plain_fwd_bwd_ms", "library_fwd_ms", "flops", "bytes", "fwd_bound_ms",
            "fwd_fp32_bound_ms")}
    log(f"  one generator forward's 12 resblocks at B = 8: tc kernel {tot['fwd_ms']:.3f} ms "
        f"(bound 3xTF32 {tot['fwd_bound_ms']:.3f} / fp32 {tot['fwd_fp32_bound_ms']:.3f}, fma "
        f"kernel {tot['fma_fwd_ms']:.3f}, plain {tot['plain_fwd_ms']:.3f}, library "
        f"{tot['library_fwd_ms']:.3f}), their backward {tot['bwd_ms']:.3f} ms, plain "
        f"fwd+bwd {tot['plain_fwd_bwd_ms']:.3f} ms; max err fwd {worst_fwd:.3e}, grad "
        f"{worst_grad:.3e} (slopes pinned at |pre-activation| <= {worst_flip:.2e}); on {card}")
    return dict(rows=rows, totals=tot, max_fwd_err=worst_fwd, max_grad_err=worst_grad,
                max_pinned_preactivation=worst_flip)


# ---------------------------------------------------------------------------
# phases 7 and 8: training
# ---------------------------------------------------------------------------

def write_dataset(root: str, n_files: int, seconds: float, sr: int, seed: int):
    from rvc_maker_tpu_torch.utils.audio import save_wav

    os.makedirs(os.path.join(root, "0"), exist_ok=True)
    rs = np.random.RandomState(seed)
    tt = np.arange(int(sr * seconds)) / sr
    for i in range(n_files):
        f0 = 110.0 + 150.0 * rs.rand()
        phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.05 * np.sin(2 * np.pi * 4 * tt))) / sr
        x = sum(0.3 / h * np.sin(h * phase) for h in (1, 2, 3, 4))
        save_wav(os.path.join(root, "0", f"s{i:03d}.wav"),
                 (x + 0.01 * rs.randn(len(tt))).astype(np.float32), sr)


def train_flow(model, card: str):
    import dataclasses
    import tempfile

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rvc_maker_tpu_torch.config import preset
    from rvc_maker_tpu_torch.interop.pth import load_synthesizer_pth
    from rvc_maker_tpu_torch.ops import resblock as rb
    from rvc_maker_tpu_torch.pipelines import data as data_mod
    from rvc_maker_tpu_torch.pipelines import extract as ex
    from rvc_maker_tpu_torch.pipelines import train as tr
    from rvc_maker_tpu_torch.pipelines import train_loop
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings
    from rvc_maker_tpu_torch.pipelines.preprocess import preprocess_dataset

    cfg = preset("v2", 48000)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, log_interval=1))
    per_step = sum(len(d) for d in cfg.model.resblock_dilation_sizes) * len(
        cfg.model.upsample_rates)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        exp = os.path.join(tmp, "voice")
        write_dataset(os.path.join(tmp, "dataset"), 32, 3.5, 48000, seed=5)
        t0 = time.perf_counter()
        n_seg = preprocess_dataset(os.path.join(tmp, "dataset"), exp, 48000, per=3.7,
                                   num_workers=4)
        res["preprocess_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        nf = ex.extract_f0(exp, model["rmvpe_params"], device="cuda")
        ne = ex.extract_embeddings(exp, model["hubert_params"], version="v2", device="cuda")
        ex.write_mute_fixture(exp, cfg, model["hubert_params"], "v2", device="cuda")
        ex.generate_filelist(exp, cfg, "v2", seed=0)
        torch.cuda.synchronize()
        res["extract_s"] = time.perf_counter() - t0
        if not n_seg == nf == ne == 32:
            raise AssertionError(f"segments {n_seg}, f0 {nf}, features {ne}: expected 32")
        log(f"  preprocess {n_seg} segments in {res['preprocess_s']:.2f} s; extract "
            f"(RMVPE + HuBERT on the card) in {res['extract_s']:.2f} s")

        stamps, metrics = [], []

        def log_writer(step, m):
            stamps.append(time.perf_counter())
            metrics.append(m)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(rb)
        t0 = time.perf_counter()
        state = train_loop.train(exp, cfg, total_epochs=1, batch_size=8,
                                 save_every_epoch=1, device="cuda", log_writer=log_writer)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        launches, tc_launches = rb.resblock_launches, rb.resblock_tc_launches
        peak = torch.cuda.max_memory_allocated()
        steps = state.step
        if steps < 3 or not launches == tc_launches == per_step * steps:
            raise AssertionError(f"{steps} steps, {launches} resblock launches ({tc_launches} "
                                 f"resblock_tc): expected >= 3 steps and {per_step} "
                                 "tensor-core launches per step")
        for m in metrics:
            if not all(np.isfinite(v) for v in m.values()):
                raise AssertionError(f"non-finite training metrics {m}")
        gaps = np.diff(stamps)
        warm_s = float(np.mean(gaps))
        res.update(steps=steps, resblock_launches=launches, resblock_tc_launches=tc_launches,
                   launches_per_step=launches // steps,
                   train_s=t_train, first_step_s=stamps[0] - t0, warm_step_s=warm_s,
                   steps_per_s=1.0 / warm_s, max_memory_allocated=peak,
                   losses=[{k: v for k, v in m.items() if k.startswith(("loss", "grad"))}
                           for m in metrics])
        log(f"  train(): {steps} steps at B = 8 in {t_train:.3f} s; first step "
            f"{res['first_step_s']:.3f} s, warm step {warm_s:.4f} s ({1.0 / warm_s:.3f} "
            f"steps/s, the loop's own step-to-step time); peak device memory "
            f"{peak / 2**30:.2f} GiB; resblock launches {launches} ({launches // steps} per step)")
        for i, m in enumerate(metrics):
            log(f"    step {i + 1}: " + ", ".join(f"{k} {v:.4f}" for k, v in m.items()
                                                if k != "lr"))

        pths = sorted(f for f in os.listdir(exp) if f.endswith(".pth"))
        if pths != [f"voice_1e_{steps}s.pth"]:
            raise AssertionError(f"exported weights {pths}")
        params, mcfg, meta = load_synthesizer_pth(os.path.join(exp, pths[0]))
        pipe = ConvertPipeline(params, mcfg, model["hubert_params"], version="v2",
                               rmvpe_params=model["rmvpe_params"], device="cuda")
        reset_counts(rb)
        out = pipe.convert_utterance(voice(5.0, 180.0, 9), 0, ConvertSettings())
        if not np.isfinite(out).all() or abs(len(out) - 5.0 * mcfg.sr) > 2 * mcfg.upp:
            raise AssertionError(f"converted utterance: {len(out)} samples, finite "
                                 f"{np.isfinite(out).all()}")
        if rb.resblock_launches != per_step:
            raise AssertionError(f"conversion launched {rb.resblock_launches}")
        res.update(exported=pths[0], convert_samples=len(out),
                   convert_absmax=float(np.abs(out).max()))
        log(f"  exported {pths[0]} (step {meta['step']}); converted 5 s on the card: "
            f"{len(out)} samples at {mcfg.sr} Hz, |out|max {res['convert_absmax']:.3f}")
        del pipe

        # one more step, three ways, on the trained state
        dataset = data_mod.TrainingDataset(os.path.join(exp, "filelist.txt"), cfg)
        batch = next(data_mod.batches_for_epoch(dataset, batch_size=8, epoch=2)).to("cuda")
        step_fn = tr.make_train_step(cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        timer = tr.RangeTimer()
        step_fn(state, batch, timer=timer)
        ranges, ranges_host = timer.ms()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step_fn(state, batch)
            torch.cuda.synchronize()
        by_kernel = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
                by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time_total / 1e3
        device_ms = sum(by_kernel.values())
        resblock_ms = sum(v for k, v in by_kernel.items() if is_resblock_kernel(k))
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
        res["profile"] = dict(step_wall_ms=wall_ms, ranges_ms=ranges,
                              ranges_host_ms=ranges_host,
                              ranges_sum_ms=sum(ranges.values()), device_ms=device_ms,
                              busy_share=device_ms / wall_ms if device_ms else None,
                              resblock_kernel_ms=resblock_ms, top_kernels_ms=dict(top),
                              batch_frames=int(batch.spec.shape[1]))
        log(f"  one step (T = {batch.spec.shape[1]} frames): {wall_ms:.3f} ms wall; device ms "
            "per range (CUDA events) / host ms: " + ", ".join(
                f"{k} {v:.3f} / {ranges_host[k]:.3f}" for k, v in ranges.items()))
        if device_ms:
            log(f"  profiler: device {device_ms:.3f} ms of {wall_ms:.3f} ms wall (busy share "
                f"{device_ms / wall_ms:.3f}); resblock kernel {resblock_ms:.3f} ms; on {card}")
            for name, ms in top:
                log(f"    {ms:9.3f} ms  {name[:110]}")
        else:
            log("  profiler: device time not measured (the profiler saw no kernels)")
        del state, batch
    torch.cuda.empty_cache()
    return res


def _narrow_train_config():
    from rvc_maker_tpu_torch.config import DataConfig, ModelConfig, RVCConfig, TrainConfig

    return RVCConfig(
        version="v2", train=TrainConfig(segment_size=8 * 64),
        data=DataConfig(sample_rate=6400, filter_length=256, hop_length=64, win_length=256,
                        n_mel_channels=32),
        model=ModelConfig(spec_channels=129, segment_size=8, inter_channels=32,
                          hidden_channels=32, filter_channels=64, n_heads=2, n_layers=1,
                          kernel_size=3, upsample_rates=(4, 4, 2, 2),
                          upsample_initial_channel=256, upsample_kernel_sizes=(8, 8, 4, 4),
                          spk_embed_dim=4, gin_channels=16, sr=6400, text_enc_hidden_dim=96))


def train_parity():
    from rvc_maker_tpu_torch.interop import from_jax
    from rvc_maker_tpu_torch.ops import resblock as rb
    from rvc_maker_tpu_torch.pipelines import train as tr

    cfg = _narrow_train_config()
    b, t, seg, upp = 4, 24, cfg.model.segment_size, cfg.model.upp
    rs = np.random.RandomState(0)
    lengths = np.array([t, t, seg + 2, t - 5], np.int32)
    batch = tr.Batch(phone=rs.randn(b, t, 96).astype(np.float32), phone_lengths=lengths,
                     pitch=rs.randint(1, 256, (b, t)),
                     pitchf=(rs.rand(b, t) * 200 + 80).astype(np.float32),
                     spec=np.abs(rs.randn(b, t, 129)).astype(np.float32), spec_lengths=lengths,
                     wave=(rs.randn(b, t * 64, 1) * 0.1).astype(np.float32), sid=rs.randint(0, 4, b))
    noise = dict(post_noise=rs.randn(b, t, 32).astype(np.float32),
                 ids_slice=np.array([0, 16, 1, 9], np.int32),
                 sine_noise=rs.randn(b, seg * upp, 1).astype(np.float32))
    params_g = from_jax.synthesizer_from_jax(from_jax.random_synthesizer_tree(cfg.model, 4),
                                             cfg.model, train=True)
    params_d = from_jax.discriminator_from_jax(from_jax.random_discriminator_tree("v2", 16, 5))
    out = {}
    for dev in ("cpu", "cuda"):
        state = tr.init_state(cfg, params_g, params_d, device=dev, disc_width_div=16)
        saved = reset_counts(rb)
        m = tr.make_train_step(cfg, 16)(
            state, batch.to(dev), keep_grads=True,
            noise={k: torch.as_tensor(v, device=dev) for k, v in noise.items()})
        launched = reset_counts(rb, saved)  # comparison launches do not count
        if launched != ((0, 0) if dev == "cpu" else (36, 36)):
            raise AssertionError(f"{dev}: {launched} resblock launches (all, tc)")
        out[dev] = m
    worst_loss = 0.0
    for k in ("loss_g", "loss_d", "loss_mel", "loss_kl", "loss_fm", "loss_adv"):
        a, r = float(out["cuda"][k]), float(out["cpu"][k])
        rel = abs(a - r) / max(abs(r), 1e-30)
        worst_loss = max(worst_loss, rel)
        if not rel <= 1e-4:
            raise AssertionError(f"card vs CPU {k}: {a} vs {r} (rel {rel:.2e})")
    worst_grad, n_zero = 0.0, 0
    for name in ("grads_g", "grads_d"):
        got, ref = out["cuda"][name], out["cpu"][name]
        floor = 1e-6 * max(g.abs().max().item() for g in ref)
        for i, (a, r) in enumerate(zip(got, ref)):
            a = a.cpu()
            r_max = r.abs().max().item()
            if r_max < floor:         # an exact-zero gradient: rounding noise on both
                n_zero += 1
                if not a.abs().max().item() < floor:
                    raise AssertionError(f"{name}[{i}]: card {a.abs().max().item()} "
                                         f"where the CPU is at rounding level")
                continue
            rel = (a - r).abs().max().item() / r_max
            worst_grad = max(worst_grad, rel)
            if not rel <= 1e-3:
                raise AssertionError(f"{name}[{i}] {tuple(r.shape)}: rel err {rel:.2e}")
    log(f"  card vs CPU, one narrow train step: loss terms max rel err {worst_loss:.3e} "
        f"(tol 1e-4); gradient leaves max err / max|g| {worst_grad:.3e} (tol 1e-3) over "
        f"{len(out['cpu']['grads_g'])} G and {len(out['cpu']['grads_d'])} D leaves "
        f"({n_zero} at rounding level on both)")
    return dict(loss_max_rel_err=worst_loss, grad_max_rel_err=worst_grad,
                zero_grad_leaves=n_zero)


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
    RESULTS["build_s_by_source"] = dict(build.build_seconds)
    log(f"[2 build] {list(logs)} in {RESULTS['build_s']:.1f} s; each source's nvcc, "
        "all started together: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in build.build_seconds.items()))
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

    train_shapes, t, c = [], cfg.segment_size, cfg.upsample_initial_channel
    for u in cfg.upsample_rates:
        t, c = t * u, c // 2
        train_shapes.append((8, c, t))
    log(f"[6 train-kernel] resblock forward and gradients at the training shapes {train_shapes}")
    RESULTS["train_kernel"] = check_resblock_train(
        train_shapes, cfg.resblock_kernel_sizes, tuple(cfg.resblock_dilation_sizes[0]), smi)

    log("[7 train] preprocess -> extract -> train -> export -> convert at v2-48k")
    RESULTS["train"] = train_flow(model, smi)
    del model

    log("[8 train-parity] one narrow train step, card against CPU")
    RESULTS["train_parity"] = train_parity()
    RESULTS["total_s"] = time.perf_counter() - t_start
    log(f"done in {RESULTS['total_s']:.1f} s")

    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(RESULTS, f, indent=1)

    main, train, tk = RESULTS["main_path"], RESULTS["train"], RESULTS["train_kernel"]
    routes = {"cpu": "plain", "cuda fp32, C in " + str(list(rb.TC_WIDTHS)): "resblock_tc",
              "cuda bf16": "resblock"}
    common = dict(route="cuda", replaces="rvc_maker_tpu/ops/pallas_resblock.py:147",
                  plain_ms=totals["plain_ms"], library_ms=totals["library_ms"],
                  fma_ms=totals["fma_ms"], fp32_bound_ms=totals["fp32_bound_ms"],
                  tf32x3_bound_ms=totals["bound_ms"], launches_per_decode=main["launches_per_decode"],
                  launches_per_train_step=train["launches_per_step"], routes=routes,
                  train_fwd_ms=tk["totals"]["fwd_ms"], train_fma_fwd_ms=tk["totals"]["fma_fwd_ms"],
                  train_fwd_bound_ms=tk["totals"]["fwd_bound_ms"],
                  grad_max_abs_err=tk["max_grad_err"])
    kernels = [
        dict(name="resblock_tc", source="rvc_maker_tpu_torch/csrc/resblock_tc.cu",
             launches=main["resblock_tc_launches"], launches_train=train["resblock_tc_launches"],
             max_abs_err=totals["max_abs_err"], ms=totals["ms"], bound_ms=totals["bound_ms"],
             bound_by=totals["bound_by"], roofline_share=totals["bound_ms"] / totals["ms"],
             **common),
        # the wrapper's count: every resblock step of the path; fp32 steps
        # route to resblock_tc, so launches_fma is what reached this source
        dict(name="resblock", source="rvc_maker_tpu_torch/csrc/resblock.cu",
             launches=main["resblock_launches"], launches_train=train["resblock_launches"],
             launches_fma=main["resblock_launches"] - main["resblock_tc_launches"],
             max_abs_err=totals["fma_max_abs_err"], ms=totals["fma_ms"],
             bound_ms=totals["fp32_bound_ms"],
             bound_by="operations" if totals["flops"] / H100_FP32_FLOPS
             >= totals["bytes"] / H100_BYTES_PER_S else "bytes",
             bf16_ms=totals["bf16_ms"], **common)]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
