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
              through the FMA kernel (resblock.cu, on no route), each max
              abs err <= 1e-4 * max(1, |ref|max); bf16 through the bf16
              tensor-core kernel (resblock_tc_bf16.cu, the route of every
              bf16 width) and through resblock.cu, each max abs err
              against the bf16 plain chain <= 4 bf16 ulps of its
              |ref|max, and correlation > 0.99 against the fp32 plain
              chain.  Then timed with CUDA events: the tensor-core
              kernel, the FMA kernel in fp32 (its earlier version), the
              plain version, and the library yardstick (a cuDNN F.conv1d
              chain, never used by the port), beside two bounds: the fp32
              CUDA-core one and the 3xTF32 one (3 x flops at the dense
              TF32 rate), the roofline share taken against the latter;
              and in bf16 the bf16 tensor-core kernel, resblock.cu, the
              plain chain and the cuDNN chain beside the bf16 bound (flops
              at the dense bf16 rate).
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
  9. vocoders the other decoders at the full v2 / 48 kHz width (random
              weights from a seed; phase 4's HuBERT, RMVPE and index): an
              f0-less model (the plain decoder), MRF-HiFi-GAN and
              RefineGAN.  Each: convert_batch on 2 x 10 s after a warm-up,
              wall time, peak memory and a torch.profiler breakdown;
              launch counts zeroed before and read after (36 on
              resblock_tc for f0-less and MRF, 0 for RefineGAN, whose
              leaky-ReLU slope 0.2 the kernel does not take); card against
              CPU on 2 s with the same explicit noise: the RMVPE f0 <= 1e-2
              Hz, the waveform on the CPU's f0 <= 1e-3, and each device on
              its own f0 <= 1e-3 for f0-less and RefineGAN (printed for
              MRF, whose 9-harmonic source turns the f0's rounding into
              ~1e-3 of waveform); the harmonic source alone is printed.
 10. f0       phase 4's model with every other F0 method, its networks at
              full width (random weights from a seed): FCPE current (128
              mels, 512 wide, 6 conv-only layers), FCPE legacy (512 wide,
              12 layers of FAVOR+ attention, 8 heads of 64, a 266 x 64
              projection), CREPE full.  Each method: convert_batch on 2 x
              10 s after a warm-up, wall time, the F0 stage's device and
              host ms (its profiler range; CREPE's network in its own),
              device time and busy share, peak memory, 36 resblock_tc
              launches per call.  Card against
              CPU on 2 s, same explicit noise: each device method's f0
              (voicing equal, <= 1e-2 Hz where both voiced; CREPE's
              probabilities <= 1e-4 and its Viterbi path equal on >= 99 %
              of frames) and the waveform of the card's pipeline given the
              CPU's f0 <= 1e-3; each host method's f0 identical and the
              waveform <= 1e-3.  The WORLD library's g++ build (phase 2)
              is timed beside nvcc.
 11. serve    the port's HTTP server (`app/server.py`, in a thread on
              127.0.0.1, device cuda) on phase 4's model written as the
              files a user serves (voice .pth, rmvpe.pt, fairseq HuBERT .pt,
              index .npy), in fp32 and in bf16 (set through /api/settings):
              a cold pipeline's first 5 s request, `warm(buckets="5,4x5")`,
              the first request after it and the mean of 3 more, each with
              its launches counted (36 resblock_tc per fp32 decode; 36
              resblock_tc_bf16 and no other per bf16 one), each response
              equal to the direct convert_utterance within 1 int16 step;
              4 concurrent requests through the batcher (device batch
              shapes, latencies, audio-s/s, peak memory), each within 2e-3
              of its row of the same batch run directly, the last upp
              samples excluded.  bf16 against fp32 on a yin request:
              waveform correlation > 0.98 and max abs < 0.1, pitchf within
              rtol 1e-5 / atol 1e-4; the rmvpe f0 distance printed.  One
              fp32 request sent after cuDNN's TF32 is set to PyTorch's
              default (on) and the server's set_device is called again
              equals the TF32-off response within 1 int16 step
              (set_device turns TF32 off); a direct call with TF32 on
              prints its distance.  Each precision's direct call: its
              wall time without HTTP, in this thread and from a new
              thread each time (the server runs requests on one device
              thread because cuDNN's plans are kept per thread), its host
              functions by own time (cProfile), and one call under
              torch.profiler.

fp32 with TF32 off for cuDNN and matmuls (the parity path) unless a phase
says otherwise; phases 3 and 11 also run bf16.
The line before the last holds the kernels' JSON summary; the last line
is {"ok": true, "device": {...}}.  Details go to chiprun_out/chip_smoke.json.
"""

import json
import math
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


def reset_counts(rb, counts=(0, 0, 0)):
    """Set the resblock launch counts (all, resblock_tc, resblock_tc_bf16)
    and return the old ones."""
    old = rb.resblock_launches, rb.resblock_tc_launches, rb.resblock_tc_bf16_launches
    rb.resblock_launches, rb.resblock_tc_launches, rb.resblock_tc_bf16_launches = counts
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


BF16_ULPS = 4     # bf16 kernel vs the bf16 plain chain: max abs <= 4 ulps of |ref|max


def bf16_ulp(v: float) -> float:
    """The spacing of bf16 values (8 significant bits) at |v|."""
    return 2.0 ** (math.frexp(v)[1] - 8)


def check_resblock(stage_shapes, kernels, dilations, card: str):
    from rvc_maker_tpu_torch.ops import resblock as rb

    gen = torch.Generator().manual_seed(0)
    rows, worst, worst_fma = [], 0.0, 0.0
    totals = dict(ms=0.0, fma_ms=0.0, plain_ms=0.0, library_ms=0.0, bf16_ms=0.0,
                  bf16_fma_ms=0.0, bf16_plain_ms=0.0, bf16_library_ms=0.0, flops=0, bytes=0)
    worst_bf16, worst_bf16_fma = 0.0, 0.0
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
            torch.cuda.synchronize()
            if rb.resblock_tc_bf16_launches != len(dilations):
                raise AssertionError(f"bf16 C={c} did not take the bf16 tensor-core kernel")
            gotb_fma = rb._fma_resblock(*argsb, **kw).float()
            corr = torch.corrcoef(torch.stack([gotb.flatten(), ref.flatten()]))[0, 1].item()
            corr_fma = torch.corrcoef(torch.stack([gotb_fma.flatten(), ref.flatten()]))[0, 1].item()
            # bf16 against the plain chain on the same bf16 inputs
            refb = rb._resblock(*argsb, **kw).float()
            bf16_err = (gotb - refb).abs().max().item()
            bf16_fma_err = (gotb_fma - refb).abs().max().item()
            bf16_tol = BF16_ULPS * bf16_ulp(refb.abs().max().item())
            wt1 = w1.permute(0, 3, 2, 1).contiguous()
            wt2 = w2.permute(0, 3, 2, 1).contiguous()
            wt1b, b1b, wt2b, b2b = (a.bfloat16() for a in (wt1, b1, wt2, b2))
            iters = 10
            ms = cuda_ms(lambda: rb.fused_resblock(*args, **kw), iters)
            fma_ms = cuda_ms(lambda: rb._fma_resblock(*args, **kw), iters)
            plain_ms = cuda_ms(lambda: rb._resblock(*args, **kw), iters)
            lib_ms = cuda_ms(lambda: library_resblock(x, wt1, b1, wt2, b2, k, dilations), iters)
            bf16_ms = cuda_ms(lambda: rb.fused_resblock(*argsb, **kw), iters)
            bf16_fma_ms = cuda_ms(lambda: rb._fma_resblock(*argsb, **kw), iters)
            bf16_plain_ms = cuda_ms(lambda: rb._resblock(*argsb, **kw), iters)
            bf16_lib_ms = cuda_ms(lambda: library_resblock(argsb[0], wt1b, b1b, wt2b, b2b, k,
                                                           dilations), iters)
            worst_bf16 = max(worst_bf16, bf16_err)
            worst_bf16_fma = max(worst_bf16_fma, bf16_fma_err)
            flops = rb.resblock_flops(b, t, c, k, D)
            nbytes = 4 * (2 * b * c * t + w1.numel() + w2.numel() + b1.numel() + b2.numel())
            fp32_bound_ms, bound_ms, _ = bounds_ms(flops, nbytes)
            bf16_bound_ms = 1e3 * max(flops / H100_BF16_FLOPS, nbytes / 2 / H100_BYTES_PER_S)
            smem = {d: rb.smem_bytes(c, k, d) for d in dilations}
            smem_bf16 = {d: rb.smem_bytes(c, k, d, torch.bfloat16) for d in dilations}
            rows.append(dict(B=b, C=c, T=t, k=k, smem_bytes_tc=smem, smem_bytes_tc_bf16=smem_bf16,
                             max_abs_err=err, fma_max_abs_err=fma_err, tol=tol, bf16_corr=corr,
                             bf16_fma_corr=corr_fma, bf16_max_abs_err=bf16_err,
                             bf16_fma_max_abs_err=bf16_fma_err, bf16_tol=bf16_tol, ms=ms,
                             fma_ms=fma_ms, plain_ms=plain_ms, library_ms=lib_ms, bf16_ms=bf16_ms,
                             bf16_fma_ms=bf16_fma_ms, bf16_plain_ms=bf16_plain_ms,
                             bf16_library_ms=bf16_lib_ms, flops=flops, bytes=nbytes, bound_ms=bound_ms,
                             fp32_bound_ms=fp32_bound_ms, roofline_share=bound_ms / ms,
                             bf16_bound_ms=bf16_bound_ms, bf16_roofline_share=bf16_bound_ms / bf16_ms))
            log(f"  resblock B={b} C={c} T={t} k={k}: shared memory per block, tc "
                + ", ".join(f"{v / 1024:.1f} KB at d={d}" for d, v in smem.items())
                + "; tc_bf16 " + ", ".join(f"{v / 1024:.1f} KB at d={d}" for d, v in smem_bf16.items()))
            log(f"  resblock B={b} C={c} T={t} k={k}: err tc {err:.3e} fma {fma_err:.3e} "
                f"(tol {tol:.1e}) | tc kernel {ms:.3f} ms, fma kernel {fma_ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, library {lib_ms:.3f} ms | {flops / 1e9:.1f} GFLOP, "
                f"{nbytes / 1e6:.1f} MB, bound 3xTF32 {bound_ms:.3f} ms / fp32 "
                f"{fp32_bound_ms:.3f} ms, roofline share {bound_ms / ms:.3f}")
            log(f"  resblock B={b} C={c} T={t} k={k} bf16: tc_bf16 kernel {bf16_ms:.3f} ms, fma "
                f"kernel {bf16_fma_ms:.3f} ms, plain {bf16_plain_ms:.3f} ms, library "
                f"{bf16_lib_ms:.3f} ms, bound {bf16_bound_ms:.3f} ms, roofline share "
                f"{bf16_bound_ms / bf16_ms:.3f} | err vs the bf16 plain chain tc_bf16 "
                f"{bf16_err:.3e} fma {bf16_fma_err:.3e} (tol {bf16_tol:.3e}), corr vs fp32 "
                f"{corr:.6f} / {corr_fma:.6f}")
            if not (err <= tol and fma_err <= tol):
                raise AssertionError(f"resblock C={c} k={k}: err {err}, fma {fma_err} > {tol}")
            if not (min(corr, corr_fma) > 0.99 and max(bf16_err, bf16_fma_err) <= bf16_tol):
                raise AssertionError(f"resblock bf16 C={c} k={k}: corr {corr} / fma {corr_fma}, "
                                     f"err vs the bf16 plain chain {bf16_err} / fma "
                                     f"{bf16_fma_err} > {bf16_tol}")
            for key, v in (("ms", ms), ("fma_ms", fma_ms), ("plain_ms", plain_ms),
                           ("library_ms", lib_ms), ("bf16_ms", bf16_ms),
                           ("bf16_fma_ms", bf16_fma_ms), ("bf16_plain_ms", bf16_plain_ms),
                           ("bf16_library_ms", bf16_lib_ms), ("flops", flops),
                           ("bytes", nbytes)):
                totals[key] += v
            del x, w1, w2, b1, b2, args, argsb, ref, refb, got, got_fma, gotb, gotb_fma, wt1, wt2
            del wt1b, b1b, wt2b, b2b
            reset_counts(rb)
    reset_counts(rb, saved)           # comparison launches do not count
    torch.cuda.empty_cache()
    fp32_bound, bound, bound_by = bounds_ms(totals["flops"], totals["bytes"])
    totals.update(bound_ms=bound, bound_by=bound_by, fp32_bound_ms=fp32_bound,
                  bf16_bound_ms=1e3 * max(totals["flops"] / H100_BF16_FLOPS,
                                          totals["bytes"] / 2 / H100_BYTES_PER_S),
                  max_abs_err=worst, fma_max_abs_err=worst_fma, bf16_max_abs_err=worst_bf16,
                  bf16_fma_max_abs_err=worst_bf16_fma)
    log(f"  one decode's 12 resblocks: tc kernel {totals['ms']:.3f} ms, fma kernel "
        f"{totals['fma_ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, library "
        f"{totals['library_ms']:.3f} ms; bf16: tc_bf16 kernel {totals['bf16_ms']:.3f} ms, fma "
        f"kernel {totals['bf16_fma_ms']:.3f} ms, plain {totals['bf16_plain_ms']:.3f} ms, "
        f"library {totals['bf16_library_ms']:.3f} ms, bound {totals['bf16_bound_ms']:.3f} ms "
        f"(roofline share {totals['bf16_bound_ms'] / totals['bf16_ms']:.3f}); "
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
    return any(k in name for k in ("resblock_tc_step_kernel", "resblock_tc_bf16_step_kernel",
                                   "resblock_step_kernel"))


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
    # the host side: self CPU time by op and CUDA runtime call
    host = {e.key: e.self_cpu_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CPU}
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:6]
    res = dict(device_ms=device_ms, wall_ms=1e3 * wall_s,
               busy_share=device_ms / (1e3 * wall_s), stages_ms=stages,
               unattributed_ms=device_ms - sum(stages.values()),
               resblock_ms=resblock_ms, resblock_share=resblock_ms / device_ms,
               top_kernels_ms=dict(top), top_host_self_ms=dict(top_host))
    log(f"  profile of {label}: device {device_ms:.3f} ms of "
        f"{1e3 * wall_s:.3f} ms wall (busy share {res['busy_share']:.3f}); resblock "
        f"kernel {resblock_ms:.3f} ms ({res['resblock_share']:.3f} of device time)")
    log("  by stage: " + ", ".join(f"{k} {v:.3f} ms" for k, v in stages.items())
        + f", outside the stages {res['unattributed_ms']:.3f} ms")
    for name, ms in top:
        log(f"    {ms:9.3f} ms  {name[:110]}")
    log("  host self time: " + ", ".join(f"{k[:40]} {v:.3f} ms" for k, v in top_host))
    return res


def wall_inference(fn, *args) -> float:
    """Wall seconds of fn(*args) under inference mode (grad mode is
    thread-local, so a new thread starts without it)."""
    with torch.inference_mode():
        t0 = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t0


def host_profile(fn, n: int = 12) -> dict:
    """cProfile over one fn(): the n functions with the most own host
    seconds (tottime; a call that waits for the device counts its wait).
    Python 3.12's cProfile sees every thread, so the idle waits of the
    server's other threads (queue, lock, selector) are left out."""
    import cProfile
    import pstats

    idle = ("queue.py", "threading.py", "selectors.py", "socketserver.py")
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    rows = [(k, v) for k, v in pstats.Stats(prof).stats.items()
            if not (os.path.basename(k[0]) in idle
                    or k[2] in ("<method 'acquire' of '_thread.lock' objects>",
                                "<method 'poll' of 'select.poll' objects>",
                                "<method 'poll' of 'select.epoll' objects>"))]
    rows = sorted(rows, key=lambda kv: -kv[1][2])[:n]
    return {f"{os.path.basename(f)}:{line}({name})": tt
            for (f, line, name), (_, _, tt, _, _) in rows}


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
        z, noise = pipe.draw_noise(1, p_len, torch.Generator().manual_seed(11))
        before = rb.resblock_tc_launches
        wav, _ = pipe.convert_batch(audio, lengths, 0, settings, z_noise=z, noise=noise)
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
        if launched != ((0, 0, 0) if dev == "cpu" else (36, 36, 0)):
            raise AssertionError(f"{dev}: {launched} resblock launches (all, tc, tc_bf16)")
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


# ---------------------------------------------------------------------------
# phase 9: the f0-less, MRF-HiFi-GAN and RefineGAN decoders
# ---------------------------------------------------------------------------

VOCODER_KINDS = (("f0less", "Default", False), ("mrf", "MRF HiFi-GAN", True),
                 ("refinegan", "RefineGAN", True))
F0_TOL_HZ = 1e-2     # RMVPE f0, card against CPU on the 2 s input


def vocoder_model(kind: str, vocoder: str, use_f0: bool, seed: int):
    """v2-48k synthesizer of one decoder kind from a seed, its decode
    scaled up as phase 4's is, so that the waveform spans a good part of
    [-1, 1]."""
    from rvc_maker_tpu_torch.config import preset
    from rvc_maker_tpu_torch.interop import from_jax

    cfg = preset("v2", 48000, vocoder=vocoder, pitch_guidance=use_f0).model
    tree = from_jax.random_synthesizer_tree(cfg, seed=seed)
    dec = tree["dec"]
    if kind == "refinegan":
        for blk in dec["upsample_conv_blocks"]:
            blk["input_conv"]["w"] *= 5.0
    else:
        for u in dec["ups"]:
            u["w"] *= 5.0
    dec["conv_post"]["w"] *= 5.0
    return cfg, from_jax.synthesizer_from_jax(tree, cfg)


def source_diff(cfg, kind, f0, noise, device):
    """Max |card - CPU| of the decoder's harmonic source alone on the f0
    (1, p_len) of the CPU run (MRF and RefineGAN; None otherwise)."""
    from rvc_maker_tpu_torch.models import vocoders as voc

    if kind == "f0less":
        return None
    f0_up = (voc._upsample_nearest(f0, cfg.upp) if kind == "mrf" else
             voc.interp_linear(f0[:, None], f0.shape[1] * cfg.upp)[:, 0])
    h = voc.MRF_HARMONICS if kind == "mrf" else 0
    with torch.inference_mode():
        out = [voc._harmonic_source(f0_up.to(dev), h, noise["source"].to(dev),
                                    noise["rand_ini"].to(dev), sample_rate=cfg.sr).cpu()
               for dev in ("cpu", device)]
    return float((out[0] - out[1]).abs().max())


def vocoders_phase(model, card: str):
    from rvc_maker_tpu_torch.ops import resblock as rb
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings

    settings = ConvertSettings(index_rate=0.5)
    L = 16000 * 10
    batch = np.stack([voice(10.0, 150.0, 1), voice(10.0, 230.0, 2)])
    lengths = np.array([L, L])
    short = voice(2.0, 200.0, 4)[None]
    aux = dict(hubert_params=model["hubert_params"], rmvpe_params=model["rmvpe_params"],
               index_vectors=model["index_vectors"])
    res = {}
    for i, (kind, vocoder, use_f0) in enumerate(VOCODER_KINDS):
        cfg, synth = vocoder_model(kind, vocoder, use_f0, seed=20 + i)
        per_decode = (0 if kind == "refinegan" else
                      sum(len(d) for d in cfg.resblock_dilation_sizes) * len(cfg.upsample_rates))
        pipe = ConvertPipeline(synth, cfg, aux["hubert_params"], version="v2",
                               rmvpe_params=aux["rmvpe_params"],
                               index_vectors=aux["index_vectors"], device="cuda")
        pipe.convert_batch(batch, lengths, 0, settings)       # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(rb)
        t0 = time.perf_counter()
        wav, _ = pipe.convert_batch(batch, lengths, 0, settings)
        torch.cuda.synchronize()
        t_batch = time.perf_counter() - t0
        launches, tc_launches = rb.resblock_launches, rb.resblock_tc_launches
        peak = torch.cuda.max_memory_allocated()
        p_len = pipe.frames(L)
        if tuple(wav.shape) != (2, p_len * cfg.upp) or not torch.isfinite(wav).all():
            raise AssertionError(f"{kind}: wav {tuple(wav.shape)}, finite "
                                 f"{bool(torch.isfinite(wav).all())}")
        if not launches == tc_launches == per_decode:
            raise AssertionError(f"{kind}: convert_batch launched {launches} ({tc_launches} "
                                 f"on resblock_tc), expected {per_decode}")
        why = ("" if per_decode else ": RefineGAN's resblocks take leaky-ReLU slope 0.2 and "
               "the kernel computes slope 0.1, so they run the F.conv1d chain")
        log(f"  {kind} ({vocoder}, f0 {use_f0}): convert_batch 2 x 10 s {t_batch:.3f} s wall "
            f"({20.0 / t_batch:.2f} audio-s/s), |wav|max {float(wav.abs().max()):.3f}, peak "
            f"device memory {peak / 2**30:.2f} GiB; resblock launches {launches}, "
            f"{tc_launches} on resblock_tc{why}")
        r = dict(batch_s=t_batch, batch_audio_s_per_s=20.0 / t_batch,
                 resblock_launches=launches, resblock_tc_launches=tc_launches,
                 launches_per_decode=per_decode, max_memory_allocated=peak,
                 wav_absmax=float(wav.abs().max()))
        r["profile_batch"] = profile_call(
            f"{kind} convert_batch 2 x 10 s",
            lambda: pipe.convert_batch(batch, lengths, 0, settings), t_batch)
        del pipe, wav
        torch.cuda.empty_cache()

        outs, f0s = {}, {}
        pipes = {dev: ConvertPipeline(synth, cfg, aux["hubert_params"], version="v2",
                                      rmvpe_params=aux["rmvpe_params"],
                                      index_vectors=aux["index_vectors"], device=dev)
                 for dev in ("cpu", "cuda")}
        z, noise = pipes["cpu"].draw_noise(1, pipes["cpu"].frames(short.shape[1]),
                                           torch.Generator().manual_seed(11))
        # each device with its own RMVPE f0, then the card once more on the
        # CPU's f0: cuDNN's rounding in RMVPE puts the card's f0 ~2e-3 Hz
        # from the CPU's, and an MRF source sums its 9th harmonic's phase
        # over every sample, so the MRF waveform is held on one f0 and the
        # f0 itself on its own bound
        for dev, pipe in (*pipes.items(), ("cuda, CPU f0", pipes["cuda"])):
            if dev == "cuda, CPU f0":
                pipe._f0 = lambda audio, settings, d=pipe.device: f0s["cpu"].to(d)
            before = rb.resblock_tc_launches
            w, f0s[dev] = pipe.convert_batch(short, np.array([short.shape[1]]), 0, settings,
                                             z_noise=z, noise=noise)
            outs[dev] = w.cpu().numpy()
            if dev != "cpu" and rb.resblock_tc_launches - before != per_decode:
                raise AssertionError(f"{kind}: the card's 2 s decode launched "
                                     f"{rb.resblock_tc_launches - before}")
        err = float(np.abs(outs["cpu"] - outs["cuda, CPU f0"]).max())
        own_err = float(np.abs(outs["cpu"] - outs["cuda"]).max())
        src = source_diff(cfg, kind, f0s["cpu"], noise, "cuda")
        f0_err = float((f0s["cpu"] - f0s["cuda"].cpu()).abs().max())
        r.update(wave_max_abs_err=err, own_f0_wave_max_abs_err=own_err,
                 source_max_abs_err=src, f0_max_abs_err=f0_err)
        log(f"  {kind} card vs CPU, 2 s, one f0: waveform max abs err {err:.3e} (|wav|max "
            f"{np.abs(outs['cpu']).max():.3f}); each on its own RMVPE f0 ({f0_err:.3e} Hz "
            f"apart) {own_err:.3e}" + ("" if src is None else
                                       f"; the harmonic source alone, on one f0, {src:.3e}"))
        del pipes
        torch.cuda.empty_cache()
        if not err <= 1e-3:
            raise AssertionError(f"{kind}: card vs CPU waveform err {err}")
        if not f0_err <= F0_TOL_HZ:
            raise AssertionError(f"{kind}: card vs CPU RMVPE f0 err {f0_err} Hz")
        if kind != "mrf" and not own_err <= 1e-3:
            raise AssertionError(f"{kind}: card vs CPU waveform err {own_err}, "
                                 "each on its own f0")
        res[kind] = r
    log(f"  on {card}")
    return res


# ---------------------------------------------------------------------------
# phase 10: every other F0 method
# ---------------------------------------------------------------------------

F0_TIMED = ("yin", "fcpe", "fcpe-legacy", "crepe-full", "mangio-crepe-full", "pyin",
            "harvest", "dio", "swipe", "pm", "hybrid[rmvpe+fcpe+harvest]")
F0_DEVICE_CHECKED = ("yin", "fcpe", "fcpe-legacy", "crepe-full")
F0_HOST_CHECKED = ("pyin", "harvest", "dio", "swipe", "pm")


def f0_networks(seed: int = 30):
    """FCPE in both layouts and CREPE full at the reference widths, from a
    seed.  CREPE's classifier is scaled up so that its bins peak and the
    Viterbi path is decided by the weights, not by rounding."""
    from rvc_maker_tpu_torch.interop import from_jax

    crepe = from_jax.random_crepe_tree(seed + 2, "full")
    crepe["classifier"]["w"] *= 8.0
    return dict(
        fcpe=from_jax.fcpe_from_jax(from_jax.random_fcpe_tree(seed, 512, 6)),
        fcpe_legacy=from_jax.fcpe_from_jax(from_jax.random_fcpe_tree(seed + 1, 512, 12,
                                                                     legacy=True)),
        crepe=from_jax.crepe_from_jax(crepe))


def f0_pipeline(cfg, model, nets, device):
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline

    return ConvertPipeline(model["synth_params"], cfg, model["hubert_params"], version="v2",
                           rmvpe_params=model["rmvpe_params"], fcpe_params=nets["fcpe"],
                           crepe_params=nets["crepe"], index_vectors=model["index_vectors"],
                           device=device)


def use_fcpe(pipe, nets, method):
    """The pipeline's FCPE params for `method`: the legacy tree for
    fcpe-legacy (both live on the device; only the reference is swapped)."""
    if not hasattr(pipe, "_fcpe_by_layout"):
        from rvc_maker_tpu_torch.device import tree_to

        pipe._fcpe_by_layout = {False: pipe.fcpe_params,
                                True: tree_to(nets["fcpe_legacy"], pipe.device, torch.float32)}
    pipe.fcpe_params = pipe._fcpe_by_layout[method == "fcpe-legacy"]


def f0_range_ms(label, fn, wall_s, range_name):
    """profile_call, plus the device ms and host (CPU) ms of each
    `convert.*` range, the F0 stage's (`range_name`) among them; CREPE's
    network has its own range inside the host stage's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel, ranges = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + e.device_time_total / 1e3
        elif e.device_type == DeviceType.CPU and e.name.startswith("convert."):
            dev, host = ranges.get(e.name, (0.0, 0.0))
            ranges[e.name] = (dev + e.device_time_total / 1e3, host + e.cpu_time_total / 1e3)
    device_ms = sum(by_kernel.values())
    if not device_ms:
        log(f"    profile of {label}: device time not measured (the profiler saw no kernels)")
        return dict(device_ms=None)
    dev_ms, host_ms = ranges.get(range_name, (0.0, 0.0))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    res = dict(device_ms=device_ms, f0_range=range_name, f0_device_ms=dev_ms,
               f0_host_ms=host_ms, ranges_device_host_ms=ranges,
               busy_share=device_ms / (1e3 * wall_s), top_kernels_ms=dict(top))
    log(f"    profile of {label}: device {device_ms:.3f} ms (busy share "
        f"{res['busy_share']:.3f}); " + "; ".join(
            f"{k} device {d:.3f} ms, host {h:.3f} ms" for k, (d, h) in ranges.items()
            if k == range_name or k == "convert.crepe"))
    return res


def f0_timing(cfg, model, nets, card: str):
    from rvc_maker_tpu_torch.ops import resblock as rb
    from rvc_maker_tpu_torch.pipelines.convert import F0_RANGES, HOST_F0_RANGE, ConvertSettings

    batch = np.stack([voice(10.0, 150.0, 1), voice(10.0, 230.0, 2)])
    L = batch.shape[1]
    lengths = np.array([L, L])
    per_decode = sum(len(d) for d in cfg.resblock_dilation_sizes) * len(cfg.upsample_rates)
    pipe = f0_pipeline(cfg, model, nets, "cuda")
    res = {}
    for m in F0_TIMED:
        use_fcpe(pipe, nets, m)
        settings = ConvertSettings(index_rate=0.5, f0_method=m)
        pipe.convert_batch(batch, lengths, 0, settings)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(rb)
        t0 = time.perf_counter()
        wav, pitchf = pipe.convert_batch(batch, lengths, 0, settings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, tc = rb.resblock_launches, rb.resblock_tc_launches
        peak = torch.cuda.max_memory_allocated()
        if not launches == tc == per_decode:
            raise AssertionError(f"{m}: convert_batch launched {launches} ({tc} on "
                                 f"resblock_tc), expected {per_decode}")
        if tuple(wav.shape) != (2, pipe.frames(L) * cfg.upp) or not torch.isfinite(wav).all():
            raise AssertionError(f"{m}: wav {tuple(wav.shape)}")
        voiced = float((pitchf > 0).float().mean())
        log(f"  {m}: convert_batch 2 x 10 s {wall:.3f} s wall ({20.0 / wall:.2f} audio-s/s), "
            f"peak device memory {peak / 2**30:.2f} GiB, voiced share {voiced:.3f}, "
            f"resblock_tc launches {tc}")
        r = dict(batch_s=wall, batch_audio_s_per_s=20.0 / wall, max_memory_allocated=peak,
                 resblock_launches=launches, resblock_tc_launches=tc, voiced_share=voiced)
        r["profile"] = f0_range_ms(f"{m} convert_batch", lambda: pipe.convert_batch(
            batch, lengths, 0, settings), wall, F0_RANGES.get(m, HOST_F0_RANGE))
        res[m] = r
    del pipe
    torch.cuda.empty_cache()
    log(f"  on {card}")
    return res


def crepe_path_check(method, cpu_pipe, card_pipe, audio):
    """CREPE on the 2 s input, card against CPU: probabilities <=
    1e-4 and the Viterbi path equal on >= 99 % of the frames."""
    from rvc_maker_tpu_torch.models import crepe as crepe_mod

    probs = {}
    with torch.inference_mode():
        for name, pipe in (("cpu", cpu_pipe), ("cuda", card_pipe)):
            probs[name] = crepe_mod.predict_probs(
                pipe.crepe_params, torch.as_tensor(audio, device=pipe.device), 160).cpu().numpy()
    err = float(np.abs(probs["cpu"] - probs["cuda"]).max())
    paths = {k: crepe_mod.decode(v, 50.0, 1100.0) for k, v in probs.items()}
    same = paths["cpu"] == paths["cuda"]
    log(f"  {method} probabilities max abs err {err:.3e}; Viterbi path equal on "
        f"{int(same.sum())} of {same.size} frames")
    if not err <= 1e-4:
        raise AssertionError(f"CREPE probabilities card vs CPU {err}")
    if not same.mean() >= 0.99:
        raise AssertionError(f"CREPE path equal on {int(same.sum())} of {same.size}")
    return dict(probs_max_abs_err=err, path_equal_frames=int(same.sum()),
                frames=int(same.size)), same[0]


def f0_card_vs_cpu(cfg, model, nets):
    from rvc_maker_tpu_torch.ops import resblock as rb
    from rvc_maker_tpu_torch.pipelines.convert import ConvertSettings

    audio = voice(2.0, 200.0, 4)[None]
    lengths = np.array([audio.shape[1]])
    per_decode = sum(len(d) for d in cfg.resblock_dilation_sizes) * len(cfg.upsample_rates)
    pipes = {dev: f0_pipeline(cfg, model, nets, dev) for dev in ("cpu", "cuda")}
    z, noise = pipes["cpu"].draw_noise(1, pipes["cpu"].frames(audio.shape[1]),
                                       torch.Generator().manual_seed(11))
    res = {}
    for m in F0_DEVICE_CHECKED + F0_HOST_CHECKED:
        settings = ConvertSettings(index_rate=0.5, f0_method=m)
        f0, wav = {}, {}
        for dev, pipe in pipes.items():
            use_fcpe(pipe, nets, m)
            with torch.inference_mode():
                f0[dev] = pipe._f0(torch.as_tensor(audio, device=pipe.device), settings).cpu()
        # the CPU's waveform, and the card's on the CPU's f0
        for dev in ("cpu", "cuda"):
            pipe = pipes[dev]
            pipe._f0 = lambda a, s, d=pipe.device: f0["cpu"].to(d)
            before = rb.resblock_tc_launches
            w, _ = pipe.convert_batch(audio, lengths, 0, settings, z_noise=z, noise=noise)
            del pipe._f0
            wav[dev] = w.cpu().numpy()
            if dev == "cuda" and rb.resblock_tc_launches - before != per_decode:
                raise AssertionError(f"{m}: the card's 2 s decode launched "
                                     f"{rb.resblock_tc_launches - before}")
        a, b = f0["cpu"].numpy()[0], f0["cuda"].numpy()[0]
        r = {}
        mask = np.ones_like(a, bool)
        if m.startswith("crepe"):
            r, path_same = crepe_path_check(m, pipes["cpu"], pipes["cuda"], audio)
            # the mean and median filters span 3 frames of the path
            mask = path_same & np.roll(path_same, 1) & np.roll(path_same, -1)
        voicing_equal = bool(((a > 0) == (b > 0))[mask].all())
        both = mask & (a > 0) & (b > 0)
        f0_err = float(np.abs(a - b)[both].max()) if both.any() else 0.0
        err = float(np.abs(wav["cpu"] - wav["cuda"]).max())
        r.update(f0_max_abs_err_hz=f0_err, voicing_equal=voicing_equal,
                 f0_identical=bool(np.array_equal(a, b)), f0_frames_held=int(mask.sum()),
                 voiced_frames=int(both.sum()), wave_max_abs_err=err,
                 wav_absmax=float(np.abs(wav["cpu"]).max()))
        log(f"  {m} card vs CPU, 2 s: f0 {f0_err:.3e} Hz on {int(both.sum())} voiced of "
            f"{int(mask.sum())} frames held, voicing equal {voicing_equal}, identical "
            f"{r['f0_identical']}; waveform on the CPU's f0 {err:.3e} (|wav|max "
            f"{r['wav_absmax']:.3f})")
        if m in F0_HOST_CHECKED and not r["f0_identical"]:
            raise AssertionError(f"{m}: the host f0 differs between the two runs")
        if not (voicing_equal and f0_err <= F0_TOL_HZ):
            raise AssertionError(f"{m}: card vs CPU f0 {f0_err} Hz, voicing equal "
                                 f"{voicing_equal}")
        if not err <= 1e-3:
            raise AssertionError(f"{m}: card vs CPU waveform err {err}")
        res[m] = r
    del pipes
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 11: serving over HTTP, fp32 and bf16
# ---------------------------------------------------------------------------

SERVE_S = 5                     # seconds of each served request
SERVE_BATCH_TOL = 2e-3          # JAX tests/test_batcher.py


def write_serve_files(d: str, cfg, model, seed: int = 0) -> dict:
    """Phase 4's model as the files a user serves: the voice .pth (fp16,
    as the reference writes it), rmvpe.pt (phase 4's RMVPE tree with
    random BatchNorm statistics), a fairseq HuBERT .pt (phase 4's tree)
    and the index as .npy.  Returns the request's file fields."""
    from rvc_maker_tpu_torch.config import RVCConfig
    from rvc_maker_tpu_torch.interop import from_jax
    from rvc_maker_tpu_torch.interop.pth import export_synthesizer_pth

    files = dict(model=os.path.join(d, "voice.pth"), rmvpe=os.path.join(d, "rmvpe.pt"),
                 embedder=os.path.join(d, "hubert_base.pt"),
                 index=os.path.join(d, "total_fea.npy"))
    export_synthesizer_pth(model["synth_params"], RVCConfig(version="v2", model=cfg),
                           files["model"])
    torch.save(from_jax.rmvpe_state_dict(from_jax.random_rmvpe_tree(seed + 2),
                                         np.random.RandomState(seed + 5)), files["rmvpe"])
    torch.save({"model": from_jax.hubert_state_dict(from_jax.random_hubert_tree(seed + 1))},
               files["embedder"])
    np.save(files["index"], model["index_vectors"])
    return files


def wav_b64(audio16: np.ndarray) -> str:
    import base64
    import io

    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, 16000, (np.clip(audio16, -1, 1) * 32767).astype(np.int16))
    return base64.b64encode(buf.getvalue()).decode()


def decode_wav(b64: str) -> np.ndarray:
    """A response's WAV as its int16 samples."""
    import base64
    import io

    from scipy.io import wavfile

    return wavfile.read(io.BytesIO(base64.b64decode(b64)))[1]


def post(port: int, path: str, obj: dict, timeout: float = 600.0):
    """POST JSON to the server on 127.0.0.1 (http.client: no proxy is
    consulted); returns (status, body)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(obj),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def served(port, req, expect=200):
    """One /api/convert; the response's int16 samples and its wall s."""
    t0 = time.perf_counter()
    code, body = post(port, "/api/convert", req)
    dt = time.perf_counter() - t0
    if code != expect:
        raise AssertionError(f"/api/convert answered {code}: {body.get('error')}")
    return decode_wav(body["audio_b64"]), dt


def corr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def serve_precision(srv, port, files, precision: str, per_decode: int):
    """One precision's serving measurements and checks (module docstring,
    phase 11).  Returns (results, the pipeline, the yin response)."""
    import threading

    from rvc_maker_tpu_torch.ops import resblock as rb
    from rvc_maker_tpu_torch.pipelines.convert import ConvertSettings

    code, body = post(port, "/api/settings", {"precision": precision})
    if code != 200 or body["precision"] != precision:
        raise AssertionError(f"/api/settings: {code} {body}")
    audio = voice(SERVE_S, 170.0, 21)
    req = dict(files, audio_b64=wav_b64(audio), f0_method="rmvpe", index_rate=0.5)
    res = {}

    srv._STATE.update(pipeline=None, pipeline_key=None)        # a cold pipeline
    _, res["cold_first_request_s"] = served(port, req)
    srv._STATE.update(pipeline=None, pipeline_key=None)
    t0 = time.perf_counter()
    res["warm_passes_s"] = srv.warm(files["model"], files["index"], files["rmvpe"],
                                    files["embedder"], buckets=f"{SERVE_S},4x{SERVE_S}")
    res["warm_s"] = time.perf_counter() - t0
    pipe = srv._get_pipeline(files["model"], files["index"], files["rmvpe"],
                             files["embedder"])
    want = torch.bfloat16 if precision == "bf16" else None
    if pipe.compute_dtype is not want:
        raise AssertionError(f"{precision}: the pipeline runs {pipe.compute_dtype}")

    # one request at a time, each with its launches counted
    times, launches = [], []
    for _ in range(4):
        reset_counts(rb)
        got, dt = served(port, req)
        times.append(dt)
        launches.append((rb.resblock_launches, rb.resblock_tc_launches,
                         rb.resblock_tc_bf16_launches))
    res.update(first_after_warm_s=times[0], steady_s=float(np.mean(times[1:])),
               launches=launches)
    want_counts = ((per_decode, per_decode, 0) if precision == "fp32"
                   else (per_decode, 0, per_decode))
    if any(c != want_counts for c in launches):
        raise AssertionError(f"{precision} serve: (all, resblock_tc, resblock_tc_bf16) "
                             f"launches per request {launches}, expected {want_counts} for "
                             "one decode each")
    res["resblock_tc_launches"] = sum(c[1] for c in launches)
    res["resblock_tc_bf16_launches"] = sum(c[2] for c in launches)
    res["resblock_fma_launches"] = sum(a - tc - tb for a, tc, tb in launches)

    # the served response against the direct call on the server's pipeline
    audio16 = srv._request_audio(req)
    settings = ConvertSettings(pitch=0, index_rate=0.5, protect=0.33, f0_method="rmvpe")
    saved = reset_counts(rb)
    direct = pipe.convert_utterance(audio16, 0, settings)
    reset_counts(rb, saved)
    direct16 = (np.clip(direct, -1, 1) * 32767).astype(np.int16)
    if got.shape != direct16.shape:
        raise AssertionError(f"served {got.shape} vs direct {direct16.shape}")
    steps = int(np.abs(got.astype(np.int32) - direct16).max())
    res["served_vs_direct_int16_steps"] = steps
    if steps > 1:
        raise AssertionError(f"{precision}: served response {steps} int16 steps from direct")
    if not np.abs(got).max() > 1000:
        raise AssertionError(f"{precision}: served waveform near silent")

    # the direct call's wall time (no HTTP), the host functions that take
    # it (cProfile), and one call under torch.profiler
    saved = reset_counts(rb)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        pipe.convert_utterance(audio16, 0, settings)
        walls.append(time.perf_counter() - t0)
    res["direct_s"] = float(np.mean(walls))
    # the same call from a new thread each time, as a handler thread would
    # make it without the server's device thread (cuDNN's plans per thread)
    fresh = []
    for _ in range(3):
        th = threading.Thread(target=lambda: fresh.append(wall_inference(
            pipe.convert_utterance, audio16, 0, settings)))
        th.start()
        th.join()
    res["direct_fresh_thread_s"] = fresh
    res["host_tottime_s"] = host_profile(lambda: pipe.convert_utterance(audio16, 0, settings))
    res["profile"] = profile_call(f"{precision} 5 s request (direct)",
                                  lambda: pipe.convert_utterance(audio16, 0, settings),
                                  res["direct_s"])
    reset_counts(rb, saved)

    # cuDNN's TF32 at PyTorch's default (on): the server's entry point
    # (set_device) turns it off, so a request served after it is
    # unchanged; the flags on around a direct call give what TF32 costs
    if precision == "fp32":
        saved = reset_counts(rb)
        try:
            torch.backends.cudnn.allow_tf32 = True
            srv.set_device("cuda")
            flags_off = not (torch.backends.cudnn.allow_tf32
                             or torch.backends.cuda.matmul.allow_tf32)
            same, _ = served(port, req)
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            tf32 = pipe.convert_utterance(audio16, 0, settings)
        finally:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            reset_counts(rb, saved)
        res["tf32_default_int16_steps"] = int(np.abs(same.astype(np.int32) - got).max())
        res["tf32_on_max_abs"] = float(np.abs(np.clip(tf32, -1, 1) - np.clip(direct, -1, 1)).max())
        if not flags_off or res["tf32_default_int16_steps"] > 1:
            raise AssertionError(f"fp32 with TF32 flags at PyTorch's default: flags off after "
                                 f"set_device {flags_off}, {res['tf32_default_int16_steps']} "
                                 "int16 steps from the TF32-off response")

    # the batcher: 4 concurrent requests, the device batches recorded
    calls, orig = [], pipe.convert_batch

    def recording(audio_b, lengths, sid, s, **kw):
        calls.append((np.array(audio_b), np.array(lengths), sid, s))
        return orig(audio_b, lengths, sid, s, **kw)

    pipe.convert_batch = recording
    os.environ["RVC_TPU_BATCH_SERVE"] = "1"
    reqs = [dict(files, audio_b64=wav_b64(voice(SERVE_S, f, 30 + i)), f0_method="rmvpe",
                 index_rate=0.5) for i, f in enumerate((140.0, 180.0, 220.0, 260.0))]
    outs, lat = [None] * 4, [None] * 4
    try:
        from concurrent.futures import ThreadPoolExecutor

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(served, port, r) for r in reqs]
            for i, f in enumerate(futs):
                outs[i], lat[i] = f.result()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        del os.environ["RVC_TPU_BATCH_SERVE"]
        del pipe.convert_batch
    res.update(batch_shapes=[list(c[0].shape) for c in calls], batch_latency_s=lat,
               batch_wall_s=wall, batch_audio_s_per_s=4 * SERVE_S / wall,
               batch_peak_bytes=peak)
    # each response against its row of the same device batch, run directly
    upp, worst = pipe.cfg.upp, 0.0
    for r, out in zip(reqs, outs):
        a16 = srv._request_audio(r)
        for audio_b, lengths, sid, s in calls:
            rows = [j for j in range(len(audio_b))
                    if np.array_equal(audio_b[j, :len(a16)], a16)]
            if rows:
                break
        else:
            raise AssertionError("a batched request is in no device batch")
        wav = pipe.convert_batch(audio_b, lengths, sid, s)[0][rows[0]].cpu().numpy()
        got_f = out.astype(np.float64) / 32768.0
        k = len(got_f) - upp
        ref = np.clip(wav[:k], -1, 1)
        err = float(np.abs(got_f[:k] - ref).max())
        worst = max(worst, err)
        if not np.all(np.abs(got_f[:k] - ref) <= SERVE_BATCH_TOL * (1 + np.abs(ref))):
            raise AssertionError(f"{precision}: batched response {err} from its direct row")
    res["batched_vs_direct_max_abs"] = worst

    yin, _ = served(port, dict(req, f0_method="yin"))
    log(f"  {precision}: cold first request {res['cold_first_request_s']:.3f} s; warm "
        f"{res['warm_s']:.3f} s ({res['warm_passes_s']:.3f} s of passes); first after warm-up "
        f"{res['first_after_warm_s']:.3f} s, mean of 3 more {res['steady_s']:.3f} s; launches "
        f"per request {launches}; served vs direct {steps} int16 steps")
    log(f"  {precision} batcher: device batches {res['batch_shapes']}, latency "
        + ", ".join(f"{x:.3f}" for x in lat) + f" s, {res['batch_audio_s_per_s']:.2f} "
        f"audio-s/s, peak {peak / 2**30:.2f} GiB, vs direct max abs {worst:.3e} (tol "
        f"{SERVE_BATCH_TOL})")
    log(f"  {precision} direct convert_utterance (no HTTP): {res['direct_s']:.3f} s, from a "
        "new thread each: " + ", ".join(f"{x:.3f}" for x in fresh) + " s; host "
        "tottime: " + ", ".join(f"{k} {v * 1e3:.1f} ms"
                                for k, v in list(res["host_tottime_s"].items())[:8]))
    if "tf32_on_max_abs" in res:
        log(f"  fp32 with cuDNN TF32 at PyTorch's default before set_device: "
            f"{res['tf32_default_int16_steps']} int16 steps from the TF32-off response "
            f"(set_device turns it off); a direct call with TF32 on: "
            f"{res['tf32_on_max_abs']:.3e} max abs from it off")
    return res, pipe, yin


def serve_phase(cfg, model):
    import tempfile
    import threading
    from http.server import ThreadingHTTPServer

    from rvc_maker_tpu_torch.app import server as srv
    from rvc_maker_tpu_torch.pipelines.convert import ConvertSettings

    per_decode = sum(len(d) for d in cfg.resblock_dilation_sizes) * len(cfg.upsample_rates)
    res = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        files = write_serve_files(d, cfg, model)
        res["files_s"] = time.perf_counter() - t0
        srv.SETTINGS_PATH = os.path.join(d, "settings.json")
        srv.set_device("cuda")
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.Handler)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            port = httpd.server_address[1]
            pipes, yins = {}, {}
            for precision in ("fp32", "bf16"):
                res[precision], pipes[precision], yins[precision] = serve_precision(
                    srv, port, files, precision, per_decode)
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(30)
            if srv._STATE.get("batcher") is not None:
                srv._STATE["batcher"].close()
            srv._STATE.update(pipeline=None, pipeline_key=None, batcher=None,
                              batcher_pipe=None)

    # bf16 against fp32: the served yin responses, and the direct pitchf
    a, b = yins["fp32"].astype(np.float64), yins["bf16"].astype(np.float64)
    res["bf16_vs_fp32_yin"] = dict(corr=corr(a, b),
                                   max_abs=float(np.abs(a - b).max() / 32768.0))
    audio = voice(SERVE_S, 170.0, 21)[None]
    f0 = {}
    for method in ("yin", "rmvpe"):
        s = ConvertSettings(f0_method=method, index_rate=0.5, deterministic=True)
        f0[method] = {p: pipes[p].convert_batch(audio, [audio.shape[1]], 0, s)[1].cpu().numpy()
                      for p in pipes}
    pf = f0["yin"]
    res["bf16_vs_fp32_yin"]["pitchf_max_abs"] = float(np.abs(pf["bf16"] - pf["fp32"]).max())
    r32, r16 = f0["rmvpe"]["fp32"], f0["rmvpe"]["bf16"]
    both = (r32 > 0) & (r16 > 0)
    res["bf16_vs_fp32_rmvpe_f0"] = dict(
        max_abs_hz_where_both_voiced=float(np.abs(r32 - r16)[both].max()) if both.any() else 0.0,
        voicing_differs_share=float(((r32 > 0) != (r16 > 0)).mean()),
        frames_over_1hz_share=float((np.abs(r32 - r16) > 1.0).mean()))
    y = res["bf16_vs_fp32_yin"]
    log(f"  bf16 vs fp32, served yin request: corr {y['corr']:.6f}, max abs {y['max_abs']:.3e}; "
        f"direct pitchf max abs {y['pitchf_max_abs']:.3e} Hz; rmvpe f0: "
        + ", ".join(f"{k} {v:.3e}" for k, v in res["bf16_vs_fp32_rmvpe_f0"].items()))
    np.testing.assert_allclose(pf["bf16"], pf["fp32"], rtol=1e-5, atol=1e-4)
    if not (y["corr"] > 0.98 and y["max_abs"] < 0.1):
        raise AssertionError(f"bf16 vs fp32: corr {y['corr']}, max abs {y['max_abs']}")
    del pipes
    torch.cuda.empty_cache()
    return res


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
    # the WORLD F0 library's g++ alongside the kernels' nvcc
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(build.load_host, "worldlike")
        logs = build.build_all()
        world.result()
    RESULTS["build_s"] = time.perf_counter() - t0
    RESULTS["build_s_by_source"] = dict(build.build_seconds)
    log(f"[2 build] {list(logs)} + worldlike in {RESULTS['build_s']:.1f} s; each source's "
        "nvcc (and the WORLD library's g++), all started together: " + ", ".join(
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

    log("[8 train-parity] one narrow train step, card against CPU")
    RESULTS["train_parity"] = train_parity()

    log("[9 vocoders] f0-less, MRF-HiFi-GAN and RefineGAN conversion at v2-48k "
        f"({time.perf_counter() - t_start:.1f} s in)")
    RESULTS["vocoders"] = vocoders_phase(model, smi)

    log(f"[10 f0] every other F0 method at v2-48k ({time.perf_counter() - t_start:.1f} s in)")
    nets = f0_networks()
    log("  FCPE current: 128 mels, 512 wide, 6 conv-only layers; FCPE legacy: 512 wide, "
        f"{len(nets['fcpe_legacy']['layers'])} layers of FAVOR+ attention (8 heads of "
        f"{nets['fcpe_legacy']['layers'][0]['attn']['q']['w'].shape[0] // 8}, projection "
        f"{tuple(nets['fcpe_legacy']['layers'][0]['attn']['projection'].shape)}); CREPE full: "
        + "/".join(str(c["w"].shape[0]) for c in nets["crepe"]["convs"]) + " channels")
    RESULTS["f0_methods"] = dict(timing=f0_timing(model_cfg, model, nets, smi))
    RESULTS["f0_methods"]["card_vs_cpu"] = f0_card_vs_cpu(model_cfg, model, nets)
    del nets

    log(f"[11 serve] the HTTP server on phase 4's model files, fp32 and bf16 "
        f"({time.perf_counter() - t_start:.1f} s in)")
    t0 = time.perf_counter()
    RESULTS["serve"] = serve_phase(model_cfg, model)
    RESULTS["serve"]["phase_s"] = time.perf_counter() - t0
    del model
    RESULTS["total_s"] = time.perf_counter() - t_start
    log(f"done in {RESULTS['total_s']:.1f} s")

    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(RESULTS, f, indent=1)

    main, train, tk = RESULTS["main_path"], RESULTS["train"], RESULTS["train_kernel"]
    voc, serve = RESULTS["vocoders"], RESULTS["serve"]
    routes = {"cpu": "plain", "cuda fp32, C in " + str(list(rb.TC_WIDTHS)): "resblock_tc",
              "cuda bf16, C in " + str(list(rb.SUPPORTED_C)): "resblock_tc_bf16"}
    common = dict(route="cuda", replaces="rvc_maker_tpu/ops/pallas_resblock.py:147",
                  launches_per_decode=main["launches_per_decode"], routes=routes)
    fp32 = dict(plain_ms=totals["plain_ms"], library_ms=totals["library_ms"],
                fma_ms=totals["fma_ms"], fp32_bound_ms=totals["fp32_bound_ms"],
                tf32x3_bound_ms=totals["bound_ms"],
                launches_per_train_step=train["launches_per_step"],
                train_fwd_ms=tk["totals"]["fwd_ms"], train_fma_fwd_ms=tk["totals"]["fma_fwd_ms"],
                train_fwd_bound_ms=tk["totals"]["fwd_bound_ms"],
                grad_max_abs_err=tk["max_grad_err"])
    # the bf16 times: the plain chain and cuDNN's in bf16, beside the bf16
    # bound (operations at the dense bf16 rate)
    bf16 = dict(
        plain_ms=totals["bf16_plain_ms"], library_ms=totals["bf16_library_ms"],
        bound_ms=totals["bf16_bound_ms"],
        bound_by="operations" if totals["flops"] / H100_BF16_FLOPS
        >= totals["bytes"] / 2 / H100_BYTES_PER_S else "bytes",
        tolerance=f"max abs vs the bf16 plain chain <= {BF16_ULPS} bf16 ulps of its "
                  "|ref|max, and corr > 0.99 vs the fp32 plain chain")
    kernels = [
        dict(name="resblock_tc", source="rvc_maker_tpu_torch/csrc/resblock_tc.cu",
             launches=main["resblock_tc_launches"], launches_train=train["resblock_tc_launches"],
             launches_f0less=voc["f0less"]["resblock_tc_launches"],
             launches_mrf=voc["mrf"]["resblock_tc_launches"],
             launches_refinegan=voc["refinegan"]["resblock_tc_launches"],
             launches_f0_methods={m: r["resblock_tc_launches"]
                                  for m, r in RESULTS["f0_methods"]["timing"].items()},
             launches_serve_fp32=serve["fp32"]["resblock_tc_launches"],
             max_abs_err=totals["max_abs_err"], ms=totals["ms"], bound_ms=totals["bound_ms"],
             bound_by=totals["bound_by"], roofline_share=totals["bound_ms"] / totals["ms"],
             **common, **fp32),
        # the bf16 route, which the served bf16 path runs: its launches
        # there; fma_ms is resblock.cu's bf16 time, its earlier version
        dict(name="resblock_tc_bf16", source="rvc_maker_tpu_torch/csrc/resblock_tc_bf16.cu",
             launches=serve["bf16"]["resblock_tc_bf16_launches"],
             launches_serve_bf16=serve["bf16"]["resblock_tc_bf16_launches"],
             max_abs_err=totals["bf16_max_abs_err"], ms=totals["bf16_ms"],
             fma_ms=totals["bf16_fma_ms"],
             roofline_share=totals["bf16_bound_ms"] / totals["bf16_ms"], **common, **bf16),
        # resblock.cu, on no path (its launches on the main paths are 0):
        # its bf16 times, and its fp32 ones under fp32_*
        dict(name="resblock", source="rvc_maker_tpu_torch/csrc/resblock.cu",
             launches=main["resblock_launches"] - main["resblock_tc_launches"]
             + serve["bf16"]["resblock_fma_launches"],
             launches_serve_bf16=serve["bf16"]["resblock_fma_launches"],
             launches_main_fma=main["resblock_launches"] - main["resblock_tc_launches"],
             max_abs_err=totals["bf16_fma_max_abs_err"], ms=totals["bf16_fma_ms"],
             fp32_ms=totals["fma_ms"], fp32_max_abs_err=totals["fma_max_abs_err"],
             fp32_plain_ms=totals["plain_ms"], fp32_library_ms=totals["library_ms"],
             **common, **bf16)]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
