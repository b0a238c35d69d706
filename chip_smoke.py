#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:
  1. device   the card's name and power limit; no card -> exit 1.
  2. build    every kernel of the port from rvc_maker_tpu_torch/csrc/
              (one nvcc per source, started together), with each
              source's build time and ptxas's registers / spills (for
              resblock_tc and resblock_tc_bf16 each (C, k) instantiation
              on one line; a spill at any of them fails); beside
              them the g++ builds of the WORLD library and the FLAC
              decoder (native/src/worldlike.cpp, flacdec.cpp).
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
              at the dense bf16 rate).  Per stage (C, T) a line of the fp32
              times summed over k beside the 3xTF32 bound and its share,
              with resblock_tc's time tile and blocks at each k; the
              weights' split (`_tc_pack`) timed on its own; and per stage
              a line of the bf16 times summed over k (resblock_tc_bf16,
              cuDNN's bf16 chain, the plain bf16 chain, resblock.cu)
              beside the bf16 bound and its share, with
              resblock_tc_bf16's time tile and blocks at each k.
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
              <= 1e-4 * max(1, |ref|max); forward and backward timed, and
              per stage a line as in phase 3; where the tile leaves fewer
              blocks than SMs (C = 256), the tile that gives every SM a
              block timed beside it.
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
              10 s (pyin, harvest and the hybrid with harvest, host F0
              on one thread: 2 x 2 s)
              after a warm-up, wall time, the F0 stage's device and
              host ms (its profiler range; CREPE's network in its own),
              device time and busy share, peak memory, 36 resblock_tc
              launches per call.  Card against
              CPU on 2 s, same explicit noise: each device method's f0
              (voicing equal, <= 1e-2 Hz where both voiced; CREPE's
              probabilities <= 1e-4 and its Viterbi path equal on >= 99 %
              of frames) and the waveform of the card's pipeline given the
              CPU's f0 <= 1e-3; each host method's f0 identical (its
              decode is the device methods').  The WORLD library's g++
              build (phase 2)
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

 12. train-all  (a) the autograd resblock in bf16 at phase 6's shapes:
              the forward against the bf16 plain chain (4 bf16 ulps), the
              gradients against fp32 autograd through the plain chain at
              pinned slopes (within 4 bf16 ulps of |ref|max or twice the
              plain bf16 chain's own distance), timed beside cuDNN's bf16
              chain and the bf16 bound, per stage with resblock_tc_bf16's
              time tile and blocks at each k.  (b) train() at v2-48k, B = 8 on
              phase 7's segments: the f0-less decoder, MRF-HiFi-GAN and
              RefineGAN (4 steps each), NSF in bf16 (4 steps) and NSF in
              bf16 with checkpointing (2 steps); launches counted: 36
              resblock_tc per step (f0-less, MRF), 0 (RefineGAN), 36 and 72
              resblock_tc_bf16 per step (bf16, bf16 + checkpointing), plus
              36 resblock_tc of the TensorBoard eval sample (0 for RefineGAN);
              finite losses, peak memory, three more steps' ms per range and
              one step's device ms under the profiler; each exported .pth
              converts 2 s.  (c) `cli extract --f0-method yin`
              without --embedder-path (a random HuBERT), and hybrid[rmvpe+yin]
              against the nanmedian of its members run as it runs them;
              phase 7's batched rmvpe within 1e-2 Hz of the per-segment
              run on 99% of the frames.  (d) build_index on
              250,000 x 768 random features (k-means to 10,000 centroids on
              the card, timed alone too), build_ivf_file (nlist 256), the file
              read back to the same vectors, `cli convert --index` on it.
              (e) phase 8's narrow step card against CPU for MRF fp32 (its
              tolerances) and NSF bf16 (losses within 0.1 relative, the G
              gradient norm within 0.25).

 13. audio-tools  on phase 11's served files (phase 4's model): `cli
              convert` with a preset JSON (cleaner, formant shifting, pitch)
              on a 10 s 48 kHz FLAC the port writes, exported as FLAC: 36
              resblock_tc launches, and the FLAC read back within 1 int16
              step of the same steps run in process (the CLI's own pipeline
              builder); FLAC encode / decode and formant_shift timed on the
              host.  reduce_noise on the card against the CPU on that
              output and on 30 s at 48 kHz (3 chunks), both modes, max abs
              <= 1e-4, each side timed.  `cli tts --model` against a
              loopback read-aloud server (tests/read_aloud_fake.py, the
              port's ws.py framing): 36 launches.  The HTTP server's /api/tts in
              fp32: 36 launches, converted on the device thread, within 1
              int16 step of the direct call; /api/effects, /api/model_info
              and /api/fuse answer 200.  Each step's wall ms printed.
 14. int8     the W8A8 mode.  csrc/conv1d_w8a8_ws.cu (the route: int8
              mma.sync on ldmatrix fragments, weight-stationary persistent
              blocks) and csrc/conv1d_w8a8.cu (its first version, on no
              route) at the 54 conv shapes of an int8 decode of 2 x 10 s
              (C = 256 / 128 / 64, k = 3 / 7 / 11, dilations 1 / 3 / 5,
              conv2 with the residual add), each against the plain version
              (quantize, im2col, torch._int_mm): the route's kernel with 0
              elements apart, the first version within 1 bf16 ulp of
              |ref|max; timed in turns (the route's kernel, the first
              version, cuDNN's bf16 F.conv1d on the same shapes, the
              route's kernel; 20 launches each; cuDNN is the yardstick:
              PyTorch has no int8 conv) and by name under torch.profiler,
              per stage and per decode, beside the bound (int8 operations
              at 1,979 TOPS, bytes at 3.35 TB/s) in aggregate and summed
              per launch; ptxas's registers and spills per tile choice.
              Then phase 4's model in bf16 without and with RVC_TPU_INT8=1
              (set for the phase), and with RVC_TPU_INT8_SCOPE=decode too:
              the int8 pipeline's build and calibration timed;
              convert_batch 2 x 10 s on the same noise with yin and with
              rmvpe (index 0.5): launches counted (54 conv1d_w8a8_ws, 0
              conv1d_w8a8 and 9 resblock_tc_bf16 per int8 decode, 36
              resblock_tc_bf16 per bf16 one), each int8 mode against bf16
              held on yin at corr > 0.995 and relative L2 < 0.1 (JAX's
              gate is 0.98 / 0.2) and printed on rmvpe, each rmvpe call
              profiled; and audit_int8_scales on a 10 s voice (54 finite
              ratios > 0).

 15. parallel two spawned ranks (`rvc_maker_tpu_torch/parallel/`, the
              environment contract on a 127.0.0.1 TCP store; gloo when they
              share the card, NCCL with a card each), each on its card, at
              v2-48k: (a) train() on phase 7's segments, global B = 8 (4
              rows per rank, 4 steps): 36 resblock_tc launches per step on
              each rank, only rank 0 writes, the parameters bitwise equal
              on both ranks; (b) the sharded step from a fresh state against
              one process's step on the global batch (losses rtol 2e-4,
              each gradient leaf 1e-3 x its max |g|), bitwise equal across
              ranks after 3 steps, each rank's step wall ms, the gradient
              all-reduce's ms (CUDA events) and busy share beside one
              process's step; (c) sharded convert_batch of 2 x 10 s (one row
              per rank, 36 launches each) against one process converting
              each row at batch 1, the shape a rank converts, on the same
              noise and the ranks' pitch (waveform <= 1e-3; RMVPE's f0
              moves by ~1e-3 Hz from run to run, which the NSF source's
              phase turns into up to ~0.1 over 10 s), and on its own pitch
              (f0 <= 1e-2 Hz from the ranks'), wall s each; one process at
              batch 2 beside it, each distance and the pitch frames apart
              printed; (d) the sharded blend on 250,000 x 768 rows
              against retrieval_blend (rtol 1e-4 / atol 1e-5); (e) 12-layer
              tensor-parallel HuBERT (6 heads per rank) against
              extract_features (rtol 2e-3 / atol 2e-4).  Rank 0 runs every
              one-process reference; any rank that fails fails the script.
 16. onnx     ONNX interop at phase 4's width, fp32: (a) phase 4's model
              as a .pth through `cli export-onnx` (dynamic frame axis),
              then ConvertPipeline on the card with the .onnx
              (`interop/onnx_run.py` runs the graph, its convs on cuDNN: 0
              resblock launches) against the same .pth, same noise, 2 x 10
              s: waveform <= 1e-3; (b) phase 4's 12-layer HuBERT exported,
              statically for 10 s rows, `OnnxEmbedder.features` against
              extract_features (rtol 1e-3 / atol 1e-4); (c) phase 4's RMVPE
              exported statically for 2 x 1,024 mel frames (its BiGRU one
              ONNX GRU node), the --f0-onnx route's f0 (`device_f0` on the
              graph) against native RMVPE within 1e-2 Hz; (d) each export's
              wall s and node count, and each route's wall s and profiler
              device ms beside the native one's.  The three exports run
              together, each in a process of its own on the host CPU.
 17. separate  vocal and music separation, fp32: (a) a full-width HTDemucs
              (the demucs v4 constructor's channels 48, growth 2, nfft
              4096, depth 4, 5 transformer layers of 8 heads, 4 sources,
              44.1 kHz, segment 10 s; random weights from a seed) written
              as a reference .th, `cli separate` on a 20 s stereo song (3
              windows, 1 shift), then `separate_vocals` on it timed and
              under torch.profiler; (b) one 10 s window of it, card
              against CPU <= 1e-3, and a small HDemucs (BLSTM + LocalState)
              and a cac=False HDemucs (Wiener EM), each one 4 s window card
              against CPU <= 1e-3; (c) a stand-in MDX-Net graph at the UVR
              "Inst HQ" I/O ((1, 4, 3072, 256), n_fft 6144, hop 1024)
              exported by `interop/onnx_export.py`, `cli separate` with it,
              `mdx_separate` timed and profiled, `mdx_demix` on 8 s card
              against CPU <= 1e-4 x max(1, |ref|max); (d) `/api/separate`
              with the .th and the .onnx, both 200; (e) `cli separate-music
              --backing --reverb` with the stand-in graph for every pass.
              Each driven call runs with the resblock counts zeroed just
              before and read just after: 0, the path runs no hand kernel.
 18. speaker  Whisper, ECAPA-TDNN and diarized conversion, fp32: (a)
              Whisper base (the JAX package's default dims, ~74 M
              parameters, random weights from a seed shaped to write
              timestamped text: `from_jax.random_whisper_tree(transcript=
              True)`) as a reference .pt and a synthetic multilingual
              .tiktoken of the released size (50,257 ranks), `cli
              transcribe --word-timestamps` on a 39 s voice (two windows),
              then with --beam-size 5, each with its wall s and decode steps
              per second, and one window's transcription under
              torch.profiler (device ms, busy share); (b) card against CPU
              on one window: log_mel <= 1e-4, encoder features <= 1e-3 x
              max|ref|, a fixed 32-token sequence's teacher-forced logits
              <= 1e-3 x max|ref|, the cached steps against the full pass
              <= 1e-4 x max|ref| on each device, greedy tokens equal up to
              the first step whose CPU top-2 margin is under 1e-3; (c)
              ECAPA-TDNN in speechbrain's state-dict names, in a directory
              with a hyperparams.yaml that the port's parser reads,
              embeddings card against CPU <= 1e-4 x max|ref|; (d) `cli
              diarize-convert` on a 20 s two-speaker signal (two f0 ranges
              in turn, with gaps) with phase 4's model and a second one
              from another seed, by the energy VAD and by --whisper: 36
              resblock_tc launches per converted segment, the cluster labels
              equal to the CPU's on the same segments, wall s; (e)
              `/api/convert_whisper` answers 200.
 19. edit     AudioLDM2 editing, fp32: (a) the stack at the published
              cvssp/audioldm2 widths (`edit/stack.py` `published_dims`:
              CLAP text RoBERTa-base, the flan-T5-large encoder, GPT2 with
              8 new tokens, the UNet (128, 256, 384, 640) with slots (None,
              768, 1024), the VAE (128, 256, 512), the SpeechT5 HiFi-GAN
              at 1,024 channels; ~1 B parameters, random weights drawn on
              the card from a seed, the byte tokenizer) edits a 10 s 44.1
              kHz stereo song at the reference's defaults (50 steps,
              t_start 45: 144 UNet calls) into a 44.1 kHz stereo WAV: wall
              s, peak GiB, the resblock counts zeroed before and read after
              (36 resblock_tc: the vocoder's C = 256 / 128 / 64 / 32 stages;
              its C = 512 stage runs the plain chain); then the edit cut to
              10 steps, its wall, and under torch.profiler by stage
              (edit.text, edit.inversion, edit.reverse, edit.vae,
              edit.vocoder) with the busy share.  (b) Card against CPU at
              full width on 2 s: the log-mel, VAE encode and decode, CLAP,
              T5, GPT2 generation, one UNet step and the vocoder, each on
              the CPU's inputs within 1e-4 x max(1, |ref|max); the 10-step
              edit with the same explicit noise, waveform within 1e-3.  (c)
              Each kernel resblock of the vocoder at its stage shape (B = 1,
              T = 20,080 / 40,160 / 80,320 / 160,640) with the stack's
              weights: resblock_tc against the plain chain within 1e-4 x
              max(1, |ref|max), timed
              beside the plain chain and a cuDNN F.conv1d chain, with the
              bound; the C = 512 stage's plain chain timed.  (d) `cli edit
              --toy-stack` and `/api/audio_edit` with toy_stack answer 0 /
              200.

 20. spec-tools  the spectral tools and the dataset builder, fp32, each
              driven with the resblock counts zeroed before and read after
              (0: no resblock on this path): (a) `cli create-dataset` on
              phase 17's 20 s 44.1 kHz song and a 48 kHz mono copy of it
              (resampled), with phase 17's full-width HTDemucs `.th`,
              --clean-dataset and 1 s skipped at each end: the files
              written, wall s, and `create_dataset` in process under
              torch.profiler (device ms, busy share); card against CPU on
              a 3 s cut within 1e-3 (phase 17's Demucs bound).  (b)
              `ensemble_inputs` on phase 17's two vocal stems (HTDemucs and
              the MDX stand-in) with Max Spec, Min Spec and Average.  (c)
              `align_audio` of the song against a copy delayed by 300
              samples at -0.5 dB (align_window [0.0625, 0.5],
              align_intro_val [1, 2], db_analysis (0.0, [-0.5, 0.0, 0.5]),
              phase_shifts 180, is_spec_match): the coarse lags must be
              -300 at both probes on both devices; on 20 s and on a 5 s
              cut, card and CPU wall s, the profiler's device ms; the
              batched float64 cross-correlation and the whole window search
              timed alone (CUDA events).  (d) the two-band
              `cmb_spectrogram_to_wave` round trip (JAX
              tests/test_spec_tools.py:365's parameter set) on the song.
              (b)-(d): card against CPU within 1e-5 x max(1, |ref|max).
 21. tools    the training and weight tools (rvc_maker_tpu_torch/tools/) at
              v2-48k: (a) `e2e_train run` on the card: a voiced corpus of
              8 x 10 s from a seed, cli preprocess, extract (yin, a random
              HuBERT), index, train --bf16 at B = 8 for 6 epochs (save every
              3) with RVC_TPU_RESUME_HASH, SIGTERM once epoch 3 is done, the
              checkpoint's params digest computed in another process, the
              resumed train, cli convert of 5 s with the last .pth: phase A
              exits 0 with ckpt_latest.pt, the resumed run logs that digest
              and step (byte-exact), every epoch 1-6 is done once, the
              conversion is 5 s at 48 kHz and finite; the first and last
              smoothed loss_g printed.  Then the trained .pth converts 2 s in
              this process (fp32, 36 resblock_tc launches), profiled, card
              against CPU on the CPU's RMVPE f0 <= 1e-3.  (b)
              `int8_gate_rehearsal` on that .pth and 6 s of the corpus's
              first file: mel_l1, mel_max and snr_db of int8 against bf16 for
              RVC_TPU_INT8_SCOPE decode and decode,hubert,rmvpe, with each
              arm's launches (bf16: 36 resblock_tc_bf16; int8: 54
              conv1d_w8a8_ws and 9 resblock_tc_bf16).  (c)
              `train_ab_overlay` at v2-32k: 6 files x 6 s, B = 8, 3 epochs
              per arm, RVC_TPU_BF16_SPEC 0 and 1: each arm's 3 epochs
              finite, their first epoch's loss_g apart.  (d)
              `validate_real_weights --lenient` on links to files of
              earlier phases (phase 4's voice .pth, HuBERT .pt and rmvpe.pt
              as phase 12 wrote them, (a)'s index pair and trained .pth,
              phase 16's voice .onnx, phase 17's .th and MDX stand-in .onnx,
              phase 18's Whisper .pt): no FAIL, PASS for synth_pth,
              hubert_pt, rmvpe_pt, faiss_index and bf16_gate; each check's
              status and bf16_gate's mel_l1 printed.  Each part's s.

The run ends with each phase's s.

fp32 with TF32 off for cuDNN and matmuls (the parity path) unless a phase
says otherwise; phases 3, 11 and 12 also run bf16, phases 14 and 21 bf16 and
int8.
The line before the last holds the kernels' JSON summary, the line before
it nvidia-smi's name and power limit; the last line is {"ok": true,
"device": {...}}.  Details go to chiprun_out/chip_smoke.json.
"""

import functools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
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


def driven(res: dict, label: str, fn, device: str = "cuda", none_on: str | None = None):
    """fn() with the resblock launch counts zeroed just before and read
    just after, into res["launches"][label], and its wall s (the card
    synchronised when `device` is "cuda") into res[f"{label}_wall_s"].
    none_on: the path's name where it must launch no resblock."""
    from rvc_maker_tpu_torch.ops import resblock as rb

    old = reset_counts(rb)
    t0 = time.perf_counter()
    try:
        out = fn()
        if device == "cuda":
            torch.cuda.synchronize()
    finally:
        counts = reset_counts(rb, old)
    res[f"{label}_wall_s"] = time.perf_counter() - t0
    res["launches"][label] = dict(zip(("resblock", "resblock_tc", "resblock_tc_bf16"), counts))
    if none_on and any(counts):
        raise AssertionError(f"{label}: resblock launches {counts} on {none_on}")
    return out


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


def stage_line(path: str, st: dict, card: str) -> str:
    """One resblock stage's times summed over its kernel sizes: resblock_tc,
    resblock.cu, the plain chain and cuDNN's chain, beside the 3xTF32 bound,
    and the time tile and blocks of each k."""
    return (f"  {path} stage B={st['B']} C={st['C']} T={st['T']}: resblock_tc "
            f"{st['ms']:.3f} ms, resblock.cu {st['fma_ms']:.3f}, plain {st['plain_ms']:.3f}, "
            f"cuDNN chain {st['library_ms']:.3f}; 3xTF32 bound {st['bound_ms']:.3f} ms, share "
            f"{st['bound_ms'] / st['ms']:.3f}; tiles " + ", ".join(
                f"k={k}: {v['time_tile']} rows x {v['blocks']} blocks"
                for k, v in st["tiles"].items()) + f"; on {card}")


def bf16_stage_line(path: str, st: dict, card: str) -> str:
    """One resblock stage's bf16 times summed over its kernel sizes:
    resblock_tc_bf16 beside cuDNN's bf16 chain and the bf16 bound, with
    resblock_tc_bf16's time tile and blocks at each k."""
    return (f"  {path} stage B={st['B']} C={st['C']} T={st['T']} bf16: resblock_tc_bf16 "
            f"{st['bf16_ms']:.3f} ms, cuDNN bf16 chain {st['bf16_library_ms']:.3f}, plain bf16 "
            f"{st['bf16_plain_ms']:.3f}" + (f", resblock.cu bf16 {st['bf16_fma_ms']:.3f}"
                                            if "bf16_fma_ms" in st else "")
            + f"; bf16 bound {st['bf16_bound_ms']:.3f} ms, share "
            f"{st['bf16_bound_ms'] / st['bf16_ms']:.3f}; tiles " + ", ".join(
                f"k={k}: {v['time_tile']} rows x {v['blocks']} blocks"
                for k, v in st["bf16_tiles"].items()) + f"; on {card}")


def check_resblock(stage_shapes, kernels, dilations, card: str):
    from rvc_maker_tpu_torch.ops import resblock as rb

    gen = torch.Generator().manual_seed(0)
    rows, worst, worst_fma = [], 0.0, 0.0
    totals = dict(ms=0.0, fma_ms=0.0, plain_ms=0.0, library_ms=0.0, bf16_ms=0.0,
                  bf16_fma_ms=0.0, bf16_plain_ms=0.0, bf16_library_ms=0.0, flops=0, bytes=0)
    worst_bf16, worst_bf16_fma = 0.0, 0.0
    saved = reset_counts(rb)
    stages = []
    for (b, c, t) in stage_shapes:
        stage = dict(B=b, C=c, T=t, ms=0.0, fma_ms=0.0, plain_ms=0.0, library_ms=0.0,
                     pack_ms=0.0, bound_ms=0.0, tiles={}, bf16_ms=0.0, bf16_fma_ms=0.0,
                     bf16_plain_ms=0.0, bf16_library_ms=0.0, bf16_bound_ms=0.0, bf16_tiles={})
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
            pack_ms = cuda_ms(lambda: rb._tc_pack(w1, w2), iters)
            worst_bf16 = max(worst_bf16, bf16_err)
            worst_bf16_fma = max(worst_bf16_fma, bf16_fma_err)
            flops = rb.resblock_flops(b, t, c, k, D)
            nbytes = 4 * (2 * b * c * t + w1.numel() + w2.numel() + b1.numel() + b2.numel())
            fp32_bound_ms, bound_ms, _ = bounds_ms(flops, nbytes)
            tt = rb.tc_time_tile("tc", b, t, c, k)
            stage["tiles"][k] = dict(time_tile=tt, blocks=b * -(-t // tt))
            for key, v in (("ms", ms), ("fma_ms", fma_ms), ("plain_ms", plain_ms),
                           ("library_ms", lib_ms), ("pack_ms", pack_ms), ("bound_ms", bound_ms)):
                stage[key] += v
            bf16_bound_ms = 1e3 * max(flops / H100_BF16_FLOPS, nbytes / 2 / H100_BYTES_PER_S)
            ttb = rb.tc_time_tile("tc_bf16", b, t, c, k)
            stage["bf16_tiles"][k] = dict(time_tile=ttb, blocks=b * -(-t // ttb))
            for key, v in (("bf16_ms", bf16_ms), ("bf16_fma_ms", bf16_fma_ms),
                           ("bf16_plain_ms", bf16_plain_ms), ("bf16_library_ms", bf16_lib_ms),
                           ("bf16_bound_ms", bf16_bound_ms)):
                stage[key] += v
            smem = {d: rb.smem_bytes(c, k, d) for d in dilations}
            smem_bf16 = {d: rb.smem_bytes(c, k, d, torch.bfloat16) for d in dilations}
            rows.append(dict(B=b, C=c, T=t, k=k, smem_bytes_tc=smem, smem_bytes_tc_bf16=smem_bf16,
                             max_abs_err=err, fma_max_abs_err=fma_err, tol=tol, bf16_corr=corr,
                             bf16_fma_corr=corr_fma, bf16_max_abs_err=bf16_err,
                             bf16_fma_max_abs_err=bf16_fma_err, bf16_tol=bf16_tol, ms=ms,
                             fma_ms=fma_ms, plain_ms=plain_ms, library_ms=lib_ms, bf16_ms=bf16_ms,
                             bf16_fma_ms=bf16_fma_ms, bf16_plain_ms=bf16_plain_ms,
                             bf16_library_ms=bf16_lib_ms, pack_ms=pack_ms, time_tile=tt,
                             blocks=b * -(-t // tt), flops=flops, bytes=nbytes, bound_ms=bound_ms,
                             fp32_bound_ms=fp32_bound_ms, roofline_share=bound_ms / ms,
                             bf16_bound_ms=bf16_bound_ms, bf16_roofline_share=bf16_bound_ms / bf16_ms))
            log(f"  resblock B={b} C={c} T={t} k={k}: shared memory per block, tc "
                + ", ".join(f"{v / 1024:.1f} KB at d={d}" for d, v in smem.items())
                + "; tc_bf16 " + ", ".join(f"{v / 1024:.1f} KB at d={d}" for d, v in smem_bf16.items()))
            log(f"  resblock B={b} C={c} T={t} k={k}: err tc {err:.3e} fma {fma_err:.3e} "
                f"(tol {tol:.1e}) | tc kernel {ms:.3f} ms (its weights' split {pack_ms:.3f} "
                f"ms of it; time tile {tt}, {b * -(-t // tt)} blocks), fma kernel {fma_ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, library {lib_ms:.3f} ms | {flops / 1e9:.1f} GFLOP, "
                f"{nbytes / 1e6:.1f} MB, bound 3xTF32 {bound_ms:.3f} ms / fp32 "
                f"{fp32_bound_ms:.3f} ms, roofline share {bound_ms / ms:.3f}")
            log(f"  resblock B={b} C={c} T={t} k={k} bf16: tc_bf16 kernel {bf16_ms:.3f} ms, fma "
                f"kernel {bf16_fma_ms:.3f} ms, plain {bf16_plain_ms:.3f} ms, library "
                f"{bf16_lib_ms:.3f} ms, bound {bf16_bound_ms:.3f} ms, roofline share "
                f"{bf16_bound_ms / bf16_ms:.3f}, time tile {ttb} x {b * -(-t // ttb)} blocks "
                f"| err vs the bf16 plain chain tc_bf16 "
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
        stages.append(stage)
        log(stage_line("conversion", stage, card))
        log(bf16_stage_line("conversion", stage, card))
    reset_counts(rb, saved)           # comparison launches do not count
    torch.cuda.empty_cache()
    fp32_bound, bound, bound_by = bounds_ms(totals["flops"], totals["bytes"])
    totals.update(bound_ms=bound, bound_by=bound_by, fp32_bound_ms=fp32_bound,
                  bf16_bound_ms=1e3 * max(totals["flops"] / H100_BF16_FLOPS,
                                          totals["bytes"] / 2 / H100_BYTES_PER_S),
                  max_abs_err=worst, fma_max_abs_err=worst_fma, bf16_max_abs_err=worst_bf16,
                  bf16_fma_max_abs_err=worst_bf16_fma, stages=stages)
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


# what the profiler's own event list leaves out (profiler_util._filter_name)
_PROFILER_UTILITY_OPS = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new", "profiler::_record_function_exit",
    "aten::is_leaf", "aten::output_nr", "aten::_version"))


def kineto_figures(events, prefix: str = "convert.") -> dict:
    """by_kernel (device ms), stages (device ms by range `prefix`*),
    stages_host (host ms of those ranges), host_self (self ms by CPU
    event name) and runtime (host ms by CUDA runtime call) from the
    profiler's raw Kineto events, tied as the profiler's own event tree
    ties them but without building that tree in Python (84.7 s for the
    tens of thousands of launches of a 10-step edit, 12-21 s for one
    train step, on the host of an NVIDIA H100 80GB HBM3, 700 W): a kernel
    counts in every `prefix` range that holds the op launching it (its
    linked correlation id) on that op's thread; an event's self time is
    its span less its direct children's on its thread."""
    from torch.autograd import DeviceType

    kernels, cpu, launcher = [], [], {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                kernels.append(e)
        elif (e.device_type() == DeviceType.CPU and not e.is_async()
              and e.start_thread_id() == e.end_thread_id()
              and e.name() not in _PROFILER_UTILITY_OPS):
            cpu.append(e)
            if e.linked_correlation_id() == 0:
                launcher[e.correlation_id()] = e.start_thread_id()
    # a runtime call (cudaLaunchKernel) sits on the thread of the op that made it
    by_thread = {}
    for e in cpu:
        tid = e.start_thread_id()
        if e.linked_correlation_id():
            tid = launcher.get(e.linked_correlation_id(), tid)
        by_thread.setdefault(tid, []).append(e)
    host_self, runtime, ranges_of, stages_host = {}, {}, {}, {}
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e.start_ns(), -e.end_ns()))
        stack = []                      # [event, self ns, the prefix ranges holding it]
        for e in evs:
            while stack and (e.start_ns() >= stack[-1][0].end_ns()
                             or e.end_ns() > stack[-1][0].end_ns()):
                top = stack.pop()
                host_self[top[0].name()] = host_self.get(top[0].name(), 0) + top[1]
            held = stack[-1][2] if stack else ()
            if stack:
                stack[-1][1] -= e.duration_ns()
            if e.name().startswith(prefix):
                held = held + (e.name(),)
                stages_host[e.name()] = stages_host.get(e.name(), 0.0) + e.duration_ns() / 1e6
            if e.linked_correlation_id() == 0:
                ranges_of[e.correlation_id()] = held
            elif e.name().startswith("cuda"):
                runtime[e.name()] = runtime.get(e.name(), 0.0) + e.duration_ns() / 1e6
            stack.append([e, e.duration_ns(), held])
        for top in stack:
            host_self[top[0].name()] = host_self.get(top[0].name(), 0) + top[1]
    by_kernel, stages = {}, {}
    for e in kernels:
        ms = e.duration_ns() / 1e6
        by_kernel[e.name()] = by_kernel.get(e.name(), 0.0) + ms
        for name in ranges_of.get(e.linked_correlation_id(), ()):
            stages[name] = stages.get(name, 0.0) + ms
    return dict(by_kernel=by_kernel, stages=stages, stages_host=stages_host,
                host_self={k: v / 1e6 for k, v in host_self.items()}, runtime=runtime)


def profile_call(label, fn, wall_s, prefix: str = "convert."):
    """torch.profiler over one more fn(): device time in all, by stage
    (the `prefix` ranges, as the profiler ties kernels to them; what it
    ties to none is "outside the stages"), in the resblock kernels, and
    by kernel; the host's self time by op and its CUDA runtime calls
    (`kineto_figures`); the busy share is the device time over `wall_s`,
    the same call's wall time without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fig = kineto_figures(prof.profiler.kineto_results.events(), prefix)
    read_s = time.perf_counter() - t0
    by_kernel, stages, host, runtime = (fig[k] for k in ("by_kernel", "stages", "host_self",
                                                          "runtime"))
    device_ms = sum(by_kernel.values())
    if device_ms == 0:
        log("  profile: device time not measured (the profiler saw no kernels)")
        return dict(device_ms=None)
    resblock_ms = sum(v for k, v in by_kernel.items() if is_resblock_kernel(k))
    w8a8_ms = sum(v for k, v in by_kernel.items() if "conv1d_w8a8" in k)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:6]
    res = dict(device_ms=device_ms, wall_ms=1e3 * wall_s,
               busy_share=device_ms / (1e3 * wall_s), stages_ms=stages,
               unattributed_ms=device_ms - sum(stages.values()),
               resblock_ms=resblock_ms, resblock_share=resblock_ms / device_ms,
               w8a8_ms=w8a8_ms, top_kernels_ms=dict(top), top_host_self_ms=dict(top_host),
               cuda_runtime_host_ms=dict(sorted(runtime.items(), key=lambda kv: -kv[1])[:4]),
               read_s=read_s)
    log(f"  profile of {label}: device {device_ms:.3f} ms of "
        f"{1e3 * wall_s:.3f} ms wall (busy share {res['busy_share']:.3f}); resblock "
        f"kernel {resblock_ms:.3f} ms ({res['resblock_share']:.3f} of device time)"
        + (f"; conv1d_w8a8 {w8a8_ms:.3f} ms" if w8a8_ms else "")
        + f"; events read in {read_s:.1f} s")
    if stages:
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
                     library_fwd_ms=0.0, pack_ms=0.0, flops=0, bytes=0, tiles={})
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
            pack_ms = cuda_ms(lambda: rb._tc_pack(args[1], args[3]), iters)
            tt = rb.tc_time_tile("tc", b, t, c, k)
            stage["tiles"][k] = dict(time_tile=tt, blocks=b * -(-t // tt))
            if b * -(-t // tt) < rb.CARD_SMS:
                # the tile that gives every SM a block, beside the rule's one wave
                tt_all = -(-t // -(-rb.CARD_SMS // b))
                stage["tiles"][k]["every_sm"] = dict(
                    time_tile=tt_all, blocks=b * -(-t // tt_all),
                    ms=cuda_ms(lambda: rb._launch_steps("tc", *args, k, dilations,
                                                        time_tile=tt_all), iters),
                    rule_ms=cuda_ms(lambda: rb._launch_steps("tc", *args, k, dilations,
                                                             time_tile=tt), iters))
            log(f"  train resblock B={b} C={c} T={t} k={k}: forward err {fwd_err:.3e} "
                f"(tol {fwd_tol:.1e}); slopes pinned at |pre-activation| <= {flip:.2e}; "
                "grad err " + ", ".join(
                    f"{nm} {e:.3e} (tol {tl:.1e})" for nm, (e, tl) in grad_err.items())
                + f" | tc kernel fwd {fwd_ms:.3f} ms (its weights' split {pack_ms:.3f} ms of "
                f"it; time tile {tt}, {b * -(-t // tt)} blocks"
                + ("".join(f"; {v['blocks']} blocks of {v['time_tile']} rows {v['ms']:.3f} ms "
                           f"against {v['rule_ms']:.3f}" for v in [stage["tiles"][k]["every_sm"]])
                   if "every_sm" in stage["tiles"][k] else "")
                + f"), fma kernel fwd {fma_ms:.3f} ms, "
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
                           ("pack_ms", pack_ms), ("flops", flops), ("bytes", nbytes)):
                stage[key] += v
            del args, leaves, out, ref, got, g_kernel, g_plain, cot, wt1, wt2, steps, pinned
            reset_counts(rb)
        stage["bwd_ms"] = stage["fwd_bwd_ms"] - stage["fwd_ms"]
        stage["fwd_fp32_bound_ms"], stage["fwd_bound_ms"], _ = bounds_ms(stage["flops"],
                                                                          stage["bytes"])
        rows.append(stage)
        log(stage_line("training", dict(stage, ms=stage["fwd_ms"], fma_ms=stage["fma_fwd_ms"],
                                        plain_ms=stage["plain_fwd_ms"],
                                        library_ms=stage["library_fwd_ms"],
                                        bound_ms=stage["fwd_bound_ms"]), card))
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


def train_flow(model, card: str, tmp: str):
    """Phase 7 in `tmp`; the experiment dir tmp/voice stays for phase 12."""
    import dataclasses

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
    by_kernel = kineto_figures(prof.profiler.kineto_results.events())["by_kernel"]
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


def _narrow_train_config(vocoder: str = "Default", bf16: bool = False):
    from rvc_maker_tpu_torch.config import DataConfig, ModelConfig, RVCConfig, TrainConfig

    return RVCConfig(
        version="v2", train=TrainConfig(segment_size=8 * 64, bf16=bf16),
        data=DataConfig(sample_rate=6400, filter_length=256, hop_length=64, win_length=256,
                        n_mel_channels=32),
        model=ModelConfig(spec_channels=129, segment_size=8, inter_channels=32,
                          hidden_channels=32, filter_channels=64, n_heads=2, n_layers=1,
                          kernel_size=3, upsample_rates=(4, 4, 2, 2),
                          upsample_initial_channel=256, upsample_kernel_sizes=(8, 8, 4, 4),
                          spk_embed_dim=4, gin_channels=16, sr=6400, text_enc_hidden_dim=96,
                          vocoder=vocoder))


def train_parity(vocoder: str = "Default", bf16: bool = False):
    """One narrow train step (decode C = 128..16, k = 3/7/11) from the same
    state and explicit noise on the CPU and on the card.  fp32: each loss
    term <= 1e-4 relative, each gradient leaf <= 1e-3 * its max |g|.  bf16
    (the JAX package's bf16 tests' gates): loss_g, loss_d, loss_mel and
    loss_kl within 0.1 relative, the G gradient norm within 0.25."""
    from rvc_maker_tpu_torch.interop import from_jax
    from rvc_maker_tpu_torch.models.vocoders import MRF_HARMONICS
    from rvc_maker_tpu_torch.ops import resblock as rb
    from rvc_maker_tpu_torch.pipelines import train as tr

    cfg = _narrow_train_config(vocoder, bf16)
    b, t, seg, upp = 4, 24, cfg.model.segment_size, cfg.model.upp
    rs = np.random.RandomState(0)
    lengths = np.array([t, t, seg + 2, t - 5], np.int32)
    batch = tr.Batch(phone=rs.randn(b, t, 96).astype(np.float32), phone_lengths=lengths,
                     pitch=rs.randint(1, 256, (b, t)),
                     pitchf=(rs.rand(b, t) * 200 + 80).astype(np.float32),
                     spec=np.abs(rs.randn(b, t, 129)).astype(np.float32), spec_lengths=lengths,
                     wave=(rs.randn(b, t * 64, 1) * 0.1).astype(np.float32), sid=rs.randint(0, 4, b))
    post = rs.randn(b, t, 32).astype(np.float32)
    ids = np.array([0, 16, 1, 9], np.int32)
    if vocoder == "Default":
        dec = {"sine": rs.randn(b, seg * upp, 1).astype(np.float32)}
    else:
        ini = rs.rand(b, MRF_HARMONICS + 1).astype(np.float32)
        ini[:, 0] = 0.0
        dec = {"source": rs.randn(b, seg * upp, MRF_HARMONICS + 1).astype(np.float32),
               "rand_ini": ini}
    dtype = torch.bfloat16 if bf16 else torch.float32
    params_g = from_jax.synthesizer_from_jax(from_jax.random_synthesizer_tree(cfg.model, 4),
                                             cfg.model, train=True)
    params_d = from_jax.discriminator_from_jax(from_jax.random_discriminator_tree("v2", 16, 5))
    per_step = sum(len(d) for d in cfg.model.resblock_dilation_sizes) * len(
        cfg.model.upsample_rates)
    want = (per_step, 0, per_step) if bf16 else (per_step, per_step, 0)
    out = {}
    for dev in ("cpu", "cuda"):
        state = tr.init_state(cfg, params_g, params_d, device=dev, disc_width_div=16)
        noise = dict(post_noise=torch.as_tensor(post, device=dev).to(dtype),
                     ids_slice=torch.as_tensor(ids, device=dev),
                     dec_noise={k: torch.as_tensor(v, device=dev).to(
                         torch.float32 if k == "rand_ini" else dtype) for k, v in dec.items()})
        saved = reset_counts(rb)
        m = tr.make_train_step(cfg, 16)(state, batch.to(dev), keep_grads=True, noise=noise)
        launched = reset_counts(rb, saved)  # comparison launches do not count
        if launched != ((0, 0, 0) if dev == "cpu" else want):
            raise AssertionError(f"{dev}: {launched} resblock launches (all, tc, tc_bf16)")
        out[dev] = m
    name = f"{vocoder}{' bf16' if bf16 else ''}"
    if bf16:
        rel = {k: abs(float(out["cuda"][k]) - float(out["cpu"][k]))
               / max(abs(float(out["cpu"][k])), 1e-6)
               for k in ("loss_g", "loss_d", "loss_mel", "loss_kl", "grad_norm_g")}
        log(f"  card vs CPU, one narrow {name} train step: relative differences "
            + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
            + " (tol 0.1 for the losses, 0.25 for grad_norm_g)")
        for k, v in rel.items():
            if not v < (0.25 if k == "grad_norm_g" else 0.1):
                raise AssertionError(f"card vs CPU bf16 {k}: rel {v:.3e}")
        return dict(relative_differences=rel)
    worst_loss = 0.0
    for k in ("loss_g", "loss_d", "loss_mel", "loss_kl", "loss_fm", "loss_adv"):
        a, r = float(out["cuda"][k]), float(out["cpu"][k])
        rel = abs(a - r) / max(abs(r), 1e-30)
        worst_loss = max(worst_loss, rel)
        if not rel <= 1e-4:
            raise AssertionError(f"card vs CPU {k}: {a} vs {r} (rel {rel:.2e})")
    worst_grad, n_zero = 0.0, 0
    for gname in ("grads_g", "grads_d"):
        got, ref = out["cuda"][gname], out["cpu"][gname]
        floor = 1e-6 * max(g.abs().max().item() for g in ref)
        for i, (a, r) in enumerate(zip(got, ref)):
            a = a.cpu()
            r_max = r.abs().max().item()
            if r_max < floor:         # an exact-zero gradient: rounding noise on both
                n_zero += 1
                if not a.abs().max().item() < floor:
                    raise AssertionError(f"{gname}[{i}]: card {a.abs().max().item()} "
                                         f"where the CPU is at rounding level")
                continue
            rel = (a - r).abs().max().item() / r_max
            worst_grad = max(worst_grad, rel)
            if not rel <= 1e-3:
                raise AssertionError(f"{name} {gname}[{i}] {tuple(r.shape)}: rel err {rel:.2e}")
    log(f"  card vs CPU, one narrow {name} train step: loss terms max rel err "
        f"{worst_loss:.3e} (tol 1e-4); gradient leaves max err / max|g| {worst_grad:.3e} "
        f"(tol 1e-3) over {len(out['cpu']['grads_g'])} G and {len(out['cpu']['grads_d'])} D "
        f"leaves ({n_zero} at rounding level on both)")
    return dict(loss_max_rel_err=worst_loss, grad_max_rel_err=worst_grad,
                zero_grad_leaves=n_zero)


# ---------------------------------------------------------------------------
# phase 9: the f0-less, MRF-HiFi-GAN and RefineGAN decoders
# ---------------------------------------------------------------------------

VOCODER_KINDS = (("f0less", "Default", False), ("mrf", "MRF HiFi-GAN", True),
                 ("refinegan", "RefineGAN", True))
F0_TOL_HZ = 1e-2     # RMVPE f0, card against CPU on the 2 s input
BATCHED_F0_SHARE = 0.01   # frames where batched and per-segment RMVPE may part (phase 12c)


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
# one host thread: timed on 2 x 2 s, not 2 x 10 s (the hybrid for its harvest)
F0_SHORT = ("pyin", "harvest", "hybrid[rmvpe+fcpe+harvest]")
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
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fig = kineto_figures(prof.profiler.kineto_results.events())
    by_kernel = fig["by_kernel"]
    ranges = {k: (fig["stages"].get(k, 0.0), v) for k, v in fig["stages_host"].items()}
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

    long = np.stack([voice(10.0, 150.0, 1), voice(10.0, 230.0, 2)])
    per_decode = sum(len(d) for d in cfg.resblock_dilation_sizes) * len(cfg.upsample_rates)
    pipe = f0_pipeline(cfg, model, nets, "cuda")
    res = {}
    for m in F0_TIMED:
        batch = long[:, :2 * 16000] if m in F0_SHORT else long
        L = batch.shape[1]
        lengths = np.array([L, L])
        seconds = 2 * L / 16000
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
        log(f"  {m}: convert_batch 2 x {seconds / 2:.0f} s {wall:.3f} s wall "
            f"({seconds / wall:.2f} audio-s/s), "
            f"peak device memory {peak / 2**30:.2f} GiB, voiced share {voiced:.3f}, "
            f"resblock_tc launches {tc}")
        r = dict(batch_s=wall, batch_seconds=seconds, batch_audio_s_per_s=seconds / wall,
                 max_memory_allocated=peak,
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
        # the CPU's waveform, and the card's on the CPU's f0; a host method's
        # f0 is the same on both sides (checked below), so its decode adds
        # nothing to the device methods' and is not run again
        for dev in ("cpu", "cuda") if m in F0_DEVICE_CHECKED else ():
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
        err = float(np.abs(wav["cpu"] - wav["cuda"]).max()) if wav else 0.0
        r.update(f0_max_abs_err_hz=f0_err, voicing_equal=voicing_equal,
                 f0_identical=bool(np.array_equal(a, b)), f0_frames_held=int(mask.sum()),
                 voiced_frames=int(both.sum()), wave_max_abs_err=err if wav else None,
                 wav_absmax=float(np.abs(wav["cpu"]).max()) if wav else None)
        log(f"  {m} card vs CPU, 2 s: f0 {f0_err:.3e} Hz on {int(both.sum())} voiced of "
            f"{int(mask.sum())} frames held, voicing equal {voicing_equal}, identical "
            f"{r['f0_identical']}" + (f"; waveform on the CPU's f0 {err:.3e} (|wav|max "
                                      f"{r['wav_absmax']:.3f})" if wav else ""))
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


# ---------------------------------------------------------------------------
# phase 12: training every decoder and mode, extract, the index build
# ---------------------------------------------------------------------------

def check_resblock_train_bf16(stage_shapes, kernels, dilations, card: str):
    """The autograd resblock in bf16 (resblock_tc_bf16.cu forward, the
    backward recomputed in cuDNN bf16) at the training stage shapes.  The
    forward against the bf16 plain chain (4 bf16 ulps of |ref|max); the
    gradients of x, w1, b1, w2, b2 against fp32 autograd through the plain
    chain with its slopes pinned at the kernel's step inputs, beside the
    bf16 plain chain's own autograd against the same reference: each
    within the larger of 4 bf16 ulps of |ref|max and twice the plain bf16
    chain's distance.  Timed: the kernel's forward, cuDNN's bf16 chain
    (the library yardstick), the plain bf16 chain, forward + backward of
    both, beside the bf16 bound."""
    from rvc_maker_tpu_torch.ops import resblock as rb

    gen = torch.Generator().manual_seed(2)
    names = ("x", "w1", "b1", "w2", "b2")
    rows, worst = [], dict(fwd=0.0, grad_over_tol=0.0)
    saved = reset_counts(rb)
    for (b, c, t) in stage_shapes:
        stage = dict(B=b, C=c, T=t, fwd_ms=0.0, plain_fwd_ms=0.0, library_fwd_ms=0.0,
                     fwd_bwd_ms=0.0, plain_fwd_bwd_ms=0.0, flops=0, bytes=0, bf16_tiles={})
        for k in kernels:
            D = len(dilations)
            scale = 0.5 / (k * c) ** 0.5
            args = [(torch.randn(b, c, t, generator=gen) * 0.3).cuda().bfloat16(),
                    (torch.randn(D, k, c, c, generator=gen) * scale).cuda().bfloat16(),
                    (torch.randn(D, c, generator=gen) * 0.1).cuda().bfloat16(),
                    (torch.randn(D, k, c, c, generator=gen) * scale).cuda().bfloat16(),
                    (torch.randn(D, c, generator=gen) * 0.1).cuda().bfloat16()]
            cot = torch.randn(b, c, t, generator=gen).cuda().bfloat16()
            kw = dict(kernel_size=k, dilations=dilations)
            ref = rb._resblock(*args, **kw).float()
            rb.resblock_tc_bf16_launches = 0
            got = rb.fused_resblock(*args, **kw).float()
            if rb.resblock_tc_bf16_launches != D:
                raise AssertionError(f"bf16 C={c} did not take the bf16 tensor-core kernel")
            fwd_err = (got - ref).abs().max().item()
            fwd_tol = BF16_ULPS * bf16_ulp(ref.abs().max().item())
            leaves = [a.detach().requires_grad_(True) for a in args]
            g_kernel = torch.autograd.grad(rb.fused_resblock(*leaves, **kw), leaves, cot)
            g_plain = torch.autograd.grad(rb._resblock(*leaves, **kw), leaves, cot)
            steps = rb._forward_steps(*args, k, dilations)
            leaves32 = [a.float().detach().requires_grad_(True) for a in args]
            pinned, flip = rb._resblock_at_slopes(
                *leaves32, **kw, step_inputs=[s.float() for s in steps[:-1]])
            g_ref = torch.autograd.grad(pinned, leaves32, cot.float())
            grad = {}
            for nm, gk, gp, gr in zip(names, g_kernel, g_plain, g_ref):
                if gk.dtype != torch.bfloat16:
                    raise AssertionError(f"bf16 gradient of {nm} came back in {gk.dtype}")
                e_k = (gk.float() - gr).abs().max().item()
                e_p = (gp.float() - gr).abs().max().item()
                tol = max(BF16_ULPS * bf16_ulp(gr.abs().max().item()), 2 * e_p)
                grad[nm] = (e_k, e_p, tol)
                worst["grad_over_tol"] = max(worst["grad_over_tol"], e_k / tol)
            worst["fwd"] = max(worst["fwd"], fwd_err)
            iters = 5
            fwd_ms = cuda_ms(lambda: rb.fused_resblock(*args, **kw), iters)
            plain_ms = cuda_ms(lambda: rb._resblock(*args, **kw), iters)
            wt1 = args[1].permute(0, 3, 2, 1).contiguous()
            wt2 = args[3].permute(0, 3, 2, 1).contiguous()
            lib_ms = cuda_ms(lambda: library_resblock(args[0], wt1, args[2], wt2, args[4],
                                                      k, dilations), iters)
            fb_ms = cuda_ms(lambda: torch.autograd.grad(
                rb.fused_resblock(*leaves, **kw), leaves, cot), iters)
            plain_fb_ms = cuda_ms(lambda: torch.autograd.grad(
                rb._resblock(*leaves, **kw), leaves, cot), iters)
            flops = rb.resblock_flops(b, t, c, k, D)
            nbytes = 2 * (2 * b * c * t + sum(a.numel() for a in args[1:]))
            ttb = rb.tc_time_tile("tc_bf16", b, t, c, k)
            stage["bf16_tiles"][k] = dict(time_tile=ttb, blocks=b * -(-t // ttb))
            log(f"  train resblock bf16 B={b} C={c} T={t} k={k}: forward err {fwd_err:.3e} "
                f"(tol {fwd_tol:.3e}); grad err kernel / plain bf16 vs fp32 pinned ("
                + ", ".join(f"{nm} {ek:.3e} / {ep:.3e} tol {tl:.3e}"
                            for nm, (ek, ep, tl) in grad.items())
                + f"), slopes pinned at |pre-activation| <= {flip:.2e} | tc_bf16 fwd "
                f"{fwd_ms:.3f} ms, library (cuDNN bf16) fwd {lib_ms:.3f} ms, plain bf16 fwd "
                f"{plain_ms:.3f} ms, fwd+bwd {fb_ms:.3f} ms, plain fwd+bwd {plain_fb_ms:.3f} ms; "
                f"time tile {ttb} x {b * -(-t // ttb)} blocks")
            if not fwd_err <= fwd_tol:
                raise AssertionError(f"train resblock bf16 C={c} k={k}: forward err {fwd_err}")
            for nm, (ek, ep, tl) in grad.items():
                if not ek <= tl:
                    raise AssertionError(f"train resblock bf16 C={c} k={k}: grad {nm} err "
                                         f"{ek} > {tl}")
            for key, v in (("fwd_ms", fwd_ms), ("plain_fwd_ms", plain_ms),
                           ("library_fwd_ms", lib_ms), ("fwd_bwd_ms", fb_ms),
                           ("plain_fwd_bwd_ms", plain_fb_ms), ("flops", flops),
                           ("bytes", nbytes)):
                stage[key] += v
            del args, leaves, leaves32, ref, got, g_kernel, g_plain, g_ref, cot, wt1, wt2, steps
            del pinned
        stage["bound_ms"] = 1e3 * max(stage["flops"] / H100_BF16_FLOPS,
                                      stage["bytes"] / H100_BYTES_PER_S)
        rows.append(stage)
        log(bf16_stage_line("training", dict(
            stage, bf16_ms=stage["fwd_ms"], bf16_library_ms=stage["library_fwd_ms"],
            bf16_plain_ms=stage["plain_fwd_ms"], bf16_bound_ms=stage["bound_ms"]), card)
            + f"; fwd+bwd {stage['fwd_bwd_ms']:.3f} ms, plain fwd+bwd "
            f"{stage['plain_fwd_bwd_ms']:.3f} ms")
    reset_counts(rb, saved)           # comparison launches do not count
    torch.cuda.empty_cache()
    tot = {key: sum(r[key] for r in rows) for key in
           ("fwd_ms", "plain_fwd_ms", "library_fwd_ms", "fwd_bwd_ms", "plain_fwd_bwd_ms",
            "flops", "bytes")}
    tot["bound_ms"] = 1e3 * max(tot["flops"] / H100_BF16_FLOPS, tot["bytes"] / H100_BYTES_PER_S)
    tot["bound_by"] = ("operations" if tot["flops"] / H100_BF16_FLOPS
                       >= tot["bytes"] / H100_BYTES_PER_S else "bytes")
    log(f"  one bf16 generator forward's 12 resblocks at B = 8: tc_bf16 {tot['fwd_ms']:.3f} ms "
        f"(bound {tot['bound_ms']:.3f}, {tot['bound_by']}), library (cuDNN bf16) "
        f"{tot['library_fwd_ms']:.3f} ms, plain bf16 {tot['plain_fwd_ms']:.3f} ms; fwd+bwd "
        f"{tot['fwd_bwd_ms']:.3f} ms, plain {tot['plain_fwd_bwd_ms']:.3f} ms; max forward err "
        f"{worst['fwd']:.3e}, worst gradient err / tol {worst['grad_over_tol']:.3f}; on {card}")
    return dict(rows=rows, totals=tot, max_fwd_err=worst["fwd"],
                max_grad_err_over_tol=worst["grad_over_tol"])


# (name, vocoder, pitch guidance, bf16, remat, steps, the kernel that runs,
# its launches per step)
TRAIN_RUNS = (("f0less", "Default", False, False, False, 4, "tc", 36),
              ("mrf", "MRF HiFi-GAN", True, False, False, 4, "tc", 36),
              ("refinegan", "RefineGAN", True, False, False, 4, None, 0),
              ("nsf_bf16", "Default", True, True, False, 4, "tc_bf16", 36),
              ("nsf_bf16_ckpt", "Default", True, True, True, 2, "tc_bf16", 72))


def train_decoder(run, exp_src: str, work: str, model, card: str) -> dict:
    """One TRAIN_RUNS entry: train() on phase 7's extracted segments for
    its steps at v2-48k, B = 8, with its default TensorBoard writer (the
    eval sample decodes once in fp32 on the card), launches counted; more
    steps timed by range; the exported .pth converted on 2 s."""
    import dataclasses
    import importlib.util
    import logging

    from rvc_maker_tpu_torch.config import preset
    from rvc_maker_tpu_torch.interop.pth import load_synthesizer_pth
    from rvc_maker_tpu_torch.ops import resblock as rb
    from rvc_maker_tpu_torch.pipelines import data as data_mod
    from rvc_maker_tpu_torch.pipelines import train as tr
    from rvc_maker_tpu_torch.pipelines import train_loop
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings

    name, vocoder, pitch, bf16, remat, n_steps, route, per_step = run
    cfg = preset("v2", 48000, vocoder=vocoder, pitch_guidance=pitch)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, log_interval=1, bf16=bf16, remat=remat))
    exp = os.path.join(work, name)
    os.makedirs(exp)
    # phase 7's voiced segments, 8 rows per step (the outputs go to `exp`)
    with open(os.path.join(exp_src, "filelist.txt")) as f:
        rows = [r for r in f.read().splitlines() if "/mute/" not in r]
    with open(os.path.join(exp, "filelist.txt"), "w") as f:
        f.write("\n".join(rows[:8 * n_steps]))
    # the loop's log records: each step's metrics (rounded to 4 places)
    # and time, and a failed eval sample, which the loop only logs
    records = []
    handler = logging.Handler(logging.INFO)
    handler.emit = records.append
    loop_log = logging.getLogger(train_loop.__name__)
    level = loop_log.level
    loop_log.addHandler(handler)
    loop_log.setLevel(logging.INFO)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(rb)
    t0, t0_clock = time.perf_counter(), time.time()      # log records carry time.time()
    try:
        state = train_loop.train(exp, cfg, total_epochs=1, batch_size=8, save_every_epoch=1,
                                 device="cuda")
    finally:
        loop_log.removeHandler(handler)
        loop_log.setLevel(level)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    steps = [r for r in records if r.msg.startswith("epoch %d step %d")]
    stamps, metrics = [r.created for r in steps], [r.args[2] for r in steps]
    failed = [logging.Formatter().format(r) for r in records if r.levelno >= logging.ERROR]
    if failed or not os.path.isdir(os.path.join(exp, "tb")):
        raise AssertionError(f"{name}: eval sample / TensorBoard: " + "\n".join(failed))
    # what the card's machine has of TensorBoard's writer and its images
    res_tb = {m: importlib.util.find_spec(m) is not None
              for m in ("tensorboard", "matplotlib", "PIL")}
    launches = (rb.resblock_launches, rb.resblock_tc_launches, rb.resblock_tc_bf16_launches)
    peak = torch.cuda.max_memory_allocated()
    eval_tc = 0 if route is None else 36       # the eval sample's fp32 decode
    train_n = per_step * n_steps
    want = (train_n + eval_tc, (train_n if route == "tc" else 0) + eval_tc,
            train_n if route == "tc_bf16" else 0)
    if state.step != n_steps or len(metrics) != n_steps or launches != want:
        raise AssertionError(f"{name}: {state.step} steps ({len(metrics)} logged), launches "
                             f"(all, tc, tc_bf16) {launches}, expected {n_steps} steps and "
                             f"{want}")
    for m in metrics:
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{name}: non-finite training metrics {m}")
    res = dict(steps=state.step, launches=launches[0], launches_tc=launches[1],
               launches_tc_bf16=launches[2], launches_eval_sample=eval_tc,
               tensorboard_modules=res_tb,
               launches_per_step=(launches[0] - eval_tc) // n_steps,
               train_s=t_train, first_step_s=stamps[0] - t0_clock,
               warm_step_s=float(np.mean(np.diff(stamps))) if len(stamps) > 1 else None,
               max_memory_allocated=peak,
               losses=[{k: v for k, v in m.items() if k.startswith(("loss", "grad"))}
                       for m in metrics])
    # three more steps: wall time, ms per range (CUDA events at the
    # range edges), their means; then one under torch.profiler
    dataset = data_mod.TrainingDataset(os.path.join(exp, "filelist.txt"), cfg)
    batch = next(data_mod.batches_for_epoch(dataset, batch_size=8, epoch=2)).to(
        "cuda", torch.bfloat16 if bf16 else None)
    step_fn = tr.make_train_step(cfg)
    timer, reps = tr.RangeTimer(), 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step_fn(state, batch, timer=timer)
    torch.cuda.synchronize()
    res["step_wall_ms"] = 1e3 * (time.perf_counter() - t0) / reps
    ranges, ranges_host = timer.ms()
    res["ranges_ms"] = {k: v / reps for k, v in ranges.items()}
    res["ranges_host_ms"] = {k: v / reps for k, v in ranges_host.items()}
    # the ranges' CUDA-event spans hold the device's waits on the host
    res["step_range_ms"] = sum(res["ranges_ms"].values())
    log(f"  {name}: {n_steps} steps at B = 8 in {t_train:.3f} s (first step "
        f"{res['first_step_s']:.3f} s); resblock launches per step {res['launches_per_step']} "
        f"(tc {launches[1]}, tc_bf16 {launches[2]}, the eval sample's {eval_tc} tc among them); peak {peak / 2**30:.2f} GiB; the mean "
        f"of {reps} more steps: {res['step_wall_ms']:.3f} ms wall, ms per range (CUDA events, the device's "
        "waits on the host included) "
        + ", ".join(f"{k} {v:.3f}" for k, v in res["ranges_ms"].items())
        + f" (sum {res['step_range_ms']:.3f}); TensorBoard's modules present: {res_tb}; "
        f"on {card}")
    res["profile"] = profile_call(f"one {name} step", lambda: step_fn(state, batch),
                                  res["step_wall_ms"] / 1e3)
    res["step_device_ms"] = res["profile"]["device_ms"]
    for i, m in enumerate(metrics):
        log(f"    step {i + 1}: " + ", ".join(f"{k} {v:.4f}" for k, v in m.items()
                                            if k != "lr"))
    del state, batch, step_fn
    torch.cuda.empty_cache()

    pths = [f for f in os.listdir(exp) if f.endswith(".pth")]
    if pths != [f"{name}_1e_{n_steps}s.pth"]:
        raise AssertionError(f"{name}: exported weights {pths}")
    params, mcfg, meta = load_synthesizer_pth(os.path.join(exp, pths[0]))
    if (mcfg.vocoder, mcfg.use_f0) != (vocoder, pitch):
        raise AssertionError(f"{name}: the .pth says {mcfg.vocoder}, f0 {mcfg.use_f0}")
    pipe = ConvertPipeline(params, mcfg, model["hubert_params"], version="v2",
                           rmvpe_params=model["rmvpe_params"], device="cuda")
    reset_counts(rb)
    out = pipe.convert_utterance(voice(2.0, 170.0, 13), 0, ConvertSettings())
    conv_launches = rb.resblock_tc_launches
    if not np.isfinite(out).all() or abs(len(out) - 2.0 * mcfg.sr) > 2 * mcfg.upp:
        raise AssertionError(f"{name}: converted {len(out)} samples, finite "
                             f"{np.isfinite(out).all()}")
    want_conv = 0 if route is None else 36
    if conv_launches != want_conv or rb.resblock_launches != want_conv:
        raise AssertionError(f"{name}: conversion launched {rb.resblock_launches} "
                             f"({conv_launches} tc), expected {want_conv}")
    res.update(exported=pths[0], pth=os.path.join(exp, pths[0]), convert_samples=len(out),
               convert_absmax=float(np.abs(out).max()), convert_launches=conv_launches)
    log(f"  {name}: exported {pths[0]}; converted 2 s on the card: {len(out)} samples, "
        f"|out|max {res['convert_absmax']:.3f}, {conv_launches} resblock_tc launches")
    del pipe
    torch.cuda.empty_cache()
    return res


def extract_phase(exp_src: str, work: str, model) -> dict:
    """extract through the CLI with yin and no --embedder-path (a random
    HuBERT), and extract_f0 with hybrid[rmvpe+yin], on phase 7's segments;
    the hybrid is the per-frame nanmedian of its members, each run as the
    hybrid runs it (rmvpe one segment at a time).  Phase 7's batched rmvpe
    is held to the per-segment one on all but BATCHED_F0_SHARE of the
    frames: the two round differently, and on random weights a frame near
    a tie of RMVPE's argmax can land on another bin."""
    import shutil

    from rvc_maker_tpu_torch import cli
    from rvc_maker_tpu_torch.pipelines import extract as ex

    res = {}
    exp = os.path.join(work, "extract")
    for sub in ("sliced_audios", "sliced_audios_16k"):
        shutil.copytree(os.path.join(exp_src, sub), os.path.join(exp, sub))
    t0 = time.perf_counter()
    rc = cli.main(["extract", "--exp-dir", exp, "--f0-method", "yin"])
    torch.cuda.synchronize()
    res["cli_yin_s"] = time.perf_counter() - t0
    names = sorted(os.listdir(os.path.join(exp, "f0_voiced")))
    n_feat = len(os.listdir(os.path.join(exp, "v2_extracted")))
    if rc != 0 or len(names) != 32 or n_feat != 32:
        raise AssertionError(f"cli extract: rc {rc}, {len(names)} f0 files, {n_feat} features")
    yin = {n: np.load(os.path.join(exp, "f0_voiced", n)) for n in names}
    hyb_dir = os.path.join(work, "extract_hybrid")
    os.makedirs(hyb_dir)
    os.symlink(os.path.join(exp, "sliced_audios_16k"), os.path.join(hyb_dir, "sliced_audios_16k"))
    t0 = time.perf_counter()
    n = ex.extract_f0(hyb_dir, model["rmvpe_params"], method="hybrid[rmvpe+yin]",
                      device="cuda")
    res["hybrid_s"] = time.perf_counter() - t0
    one_dir = os.path.join(work, "extract_rmvpe_one")
    os.makedirs(one_dir)
    os.symlink(os.path.join(exp, "sliced_audios_16k"), os.path.join(one_dir, "sliced_audios_16k"))
    ex.extract_f0(one_dir, model["rmvpe_params"], method="rmvpe", batch_size=1, device="cuda")
    batched_dir = os.path.join(exp_src, "f0_voiced")
    worst, voiced, batched_worst, batched_off, frames = 0.0, [], 0.0, 0, 0
    for name in names:
        hyb = np.load(os.path.join(hyb_dir, "f0_voiced", name))
        rmvpe = np.load(os.path.join(one_dir, "f0_voiced", name))
        stack = np.vstack([rmvpe, yin[name]]).astype(np.float64)
        want = np.nan_to_num(np.nanmedian(np.where(stack < 0.001, np.nan, stack), axis=0))
        worst = max(worst, float(np.abs(hyb - want).max()))
        voiced.append(float((hyb > 0).mean()))
        gap = np.abs(np.load(os.path.join(batched_dir, name)).astype(np.float64) - rmvpe)
        batched_worst = max(batched_worst, float(gap.max()))
        batched_off += int((gap > F0_TOL_HZ).sum())
        frames += gap.size
    res.update(segments=n, hybrid_vs_members_max_hz=worst,
               hybrid_voiced_share=float(np.mean(voiced)),
               yin_voiced_share=float(np.mean([(f > 0).mean() for f in yin.values()])),
               batched_rmvpe_max_hz=batched_worst, batched_rmvpe_frames_off=batched_off,
               rmvpe_frames=frames)
    log(f"  cli extract --f0-method yin, no --embedder-path (random HuBERT): 32 segments in "
        f"{res['cli_yin_s']:.2f} s, voiced share {res['yin_voiced_share']:.3f}; "
        f"hybrid[rmvpe+yin] in {res['hybrid_s']:.2f} s, voiced share "
        f"{res['hybrid_voiced_share']:.3f}, {worst:.3e} Hz from the nanmedian of its members "
        f"(rmvpe one segment at a time, and the yin run); phase 7's batched rmvpe "
        f"{batched_worst:.3e} Hz from the per-segment one, {batched_off} of {frames} frames "
        f"beyond {F0_TOL_HZ} Hz")
    if n != 32 or not worst <= F0_TOL_HZ:
        raise AssertionError(f"hybrid extract: {n} segments, {worst} Hz from its members")
    if not batched_off <= BATCHED_F0_SHARE * frames:
        raise AssertionError(f"batched rmvpe: {batched_off} of {frames} frames beyond "
                             f"{F0_TOL_HZ} Hz of the per-segment run")
    return res


INDEX_ROWS, INDEX_DIM, INDEX_CLUSTERS, INDEX_NLIST = 250_000, 768, 10_000, 256


def index_phase(work: str, serve_files: dict, pth: str, card: str) -> dict:
    """build_index on 250,000 x 768 random features (k-means to 10,000
    centroids on the card), build_ivf_file (nlist 256) on its result, read
    back; then `cli convert --index` on that file."""
    from rvc_maker_tpu_torch import cli
    from rvc_maker_tpu_torch.retrieval import faiss_io
    from rvc_maker_tpu_torch.retrieval.index import build_index, kmeans, load_index
    from rvc_maker_tpu_torch.retrieval.ivf import build_ivf_file
    from rvc_maker_tpu_torch.utils.audio import save_wav

    gen = torch.Generator("cuda").manual_seed(31)
    feats = torch.randn(INDEX_ROWS, INDEX_DIM, generator=gen, device="cuda").cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = build_index(feats, version="v2", seed=0, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if index.vectors.shape != (INDEX_CLUSTERS, INDEX_DIM) or not np.isfinite(index.vectors).all():
        raise AssertionError(f"build_index: {index.vectors.shape}")
    # the k-means alone on the card, on the same shuffled rows and seed
    x = torch.as_tensor(feats[np.random.RandomState(0).permutation(INDEX_ROWS)], device="cuda")
    kmeans(x, INDEX_CLUSTERS, n_iters=2, generator=torch.Generator("cuda").manual_seed(1))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    cent = kmeans(x, INDEX_CLUSTERS, generator=torch.Generator("cuda").manual_seed(0))
    end.record()
    torch.cuda.synchronize()
    kmeans_ms = start.elapsed_time(end)
    rerun = float(np.abs(cent.cpu().numpy() - index.vectors).max())
    del x, cent
    torch.cuda.empty_cache()
    path = os.path.join(work, "added_voice_v2.index")
    t0 = time.perf_counter()
    nlist = build_ivf_file(index.vectors, path, nlist=INDEX_NLIST, device="cuda")
    ivf_s = time.perf_counter() - t0
    back = faiss_io.read_index(path)
    same = np.array_equal(back.reconstruct_n(), index.vectors)
    if nlist != INDEX_NLIST or back.centroids.shape != (INDEX_NLIST, INDEX_DIM) or not same:
        raise AssertionError(f"ivf file: nlist {nlist}, read back equal {same}")
    # the k-means work: per iteration the batch's distances to every
    # centroid (2 B K D), the segment sums and the update
    it_flops = 2 * 16384 * INDEX_CLUSTERS * INDEX_DIM
    res = dict(rows=INDEX_ROWS, dim=INDEX_DIM, clusters=INDEX_CLUSTERS, iters=25, batch=16384,
               build_index_s=build_s, kmeans_ms=kmeans_ms,
               kmeans_fp32_bound_ms=1e3 * 25 * it_flops / H100_FP32_FLOPS,
               kmeans_rerun_max_abs=rerun, ivf_s=ivf_s, ivf_nlist=nlist,
               ivf_bytes=os.path.getsize(path), read_back_equal=same)
    log(f"  build_index 250,000 x 768 -> 10,000 centroids in {build_s:.3f} s wall; k-means "
        f"alone {kmeans_ms:.3f} ms on the card (25 iterations at batch 16,384; its distance "
        f"matmuls at the fp32 CUDA-core peak {res['kmeans_fp32_bound_ms']:.3f} ms), "
        f"{rerun:.3e} from build_index's centroids (index_add_ sums in a varying order); "
        f"build_ivf_file (nlist 256) {ivf_s:.3f} s, {res['ivf_bytes']} bytes, read back "
        f"equal: {same}; on {card}")
    wav = os.path.join(work, "in2s.wav")
    save_wav(wav, voice(2.0, 160.0, 17), 16000)
    out = os.path.join(work, "out_index.wav")
    t0 = time.perf_counter()
    rc = cli.main(["convert", "--input", wav, "--output", out, "--model", pth,
                   "--rmvpe-path", serve_files["rmvpe"], "--hubert-path", serve_files["embedder"],
                   "--index", path, "--index-rate", "0.75"])
    res["cli_convert_s"] = time.perf_counter() - t0
    from rvc_maker_tpu_torch.utils.audio import read_wav

    audio, sr = read_wav(out)
    if rc != 0 or not np.isfinite(audio).all() or abs(len(audio) / sr - 2.0) > 0.1:
        raise AssertionError(f"cli convert --index: rc {rc}, {len(audio)} samples at {sr}")
    res["cli_convert_samples"] = len(audio)
    log(f"  cli convert --index {os.path.basename(path)} (load_index reads "
        f"{load_index(path).vectors.shape}): {len(audio)} samples at {sr} Hz in "
        f"{res['cli_convert_s']:.2f} s")
    return res


def train_all(model, work: str, card: str) -> dict:
    """Phase 12; res["part_s"] holds each part's s."""
    from rvc_maker_tpu_torch.config import preset

    res = {"part_s": {}}
    t_part = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        res["part_s"][name] = now - t_part[0]
        t_part[0] = now

    cfg = preset("v2", 48000).model
    shapes, t, c = [], cfg.segment_size, cfg.upsample_initial_channel
    for u in cfg.upsample_rates:
        t, c = t * u, c // 2
        shapes.append((8, c, t))
    log(f"  [12a] bf16 autograd resblock at the training shapes {shapes}")
    res["train_kernel_bf16"] = check_resblock_train_bf16(
        shapes, cfg.resblock_kernel_sizes, tuple(cfg.resblock_dilation_sizes[0]), card)
    part("12a")
    exp_src = os.path.join(work, "voice")
    log("  [12b] train every decoder and mode at v2-48k, B = 8, on phase 7's segments")
    res["runs"] = {}
    for run in TRAIN_RUNS:
        res["runs"][run[0]] = train_decoder(run, exp_src, work, model, card)
        part(f"12b_{run[0]}")
    log("  [12c] extract")
    res["extract"] = extract_phase(exp_src, work, model)
    part("12c")
    log("  [12d] index")
    serve_dir = os.path.join(work, "serve_files")
    os.makedirs(serve_dir)
    res["index"] = index_phase(work, write_serve_files(serve_dir, cfg, model),
                               res["runs"]["mrf"]["pth"], card)
    part("12d")
    log("  [12e] narrow train steps, card against CPU: MRF fp32, NSF bf16")
    res["parity_mrf"] = train_parity("MRF HiFi-GAN")
    res["parity_bf16"] = train_parity(bf16=True)
    part("12e")
    log("  phase 12's parts, s: " + ", ".join(f"{k} {v:.1f}" for k, v in res["part_s"].items()))
    return res


# ---------------------------------------------------------------------------
# phase 13: the rest of cli convert and the host audio tools
# ---------------------------------------------------------------------------

AUDIO_CONVERT_S = 10            # the FLAC input of `cli convert`
AUDIO_GATE_S = 30               # the noise gate's long signal: 3 chunks at 48 kHz
GATE_TOL = 1e-4                 # reduce_noise, card against CPU (cuFFT, cuDNN rounding)
AUDIO_PRESET = dict(cleaner=True, clean_strength=0.7, formant_shifting=True,
                    formant_qfrency=1.0, formant_timbre=1.2, pitch=2)


def timed(label, fn, *args, **kw):
    """fn(*args, **kw) and its wall ms, printed."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    ms = 1e3 * (time.perf_counter() - t0)
    log(f"  {label}: {ms:.1f} ms")
    return out, ms


def launches_of(rb, fn, *args):
    """fn(*args) with the resblock launch counts zeroed just before and
    read just after: (result, (all, resblock_tc, resblock_tc_bf16))."""
    saved = reset_counts(rb)
    try:
        out = fn(*args)
        return out, (rb.resblock_launches, rb.resblock_tc_launches, rb.resblock_tc_bf16_launches)
    finally:
        reset_counts(rb, saved)


def gate_card_vs_cpu(x: np.ndarray, sr: int, label: str) -> dict:
    """reduce_noise on the card against the CPU in both modes: the
    distance and each side's wall ms (the card's after one warm-up call)."""
    from rvc_maker_tpu_torch.utils.noisereduce import reduce_noise

    res = {}
    for stationary in (False, True):
        mode = "stationary" if stationary else "nonstationary"
        reduce_noise(x, sr, stationary=stationary, device="cuda")
        torch.cuda.synchronize()
        card, card_ms = timed(f"reduce_noise {label} {mode} on the card", reduce_noise, x, sr,
                              stationary=stationary, device="cuda")
        cpu, cpu_ms = timed(f"reduce_noise {label} {mode} on the CPU", reduce_noise, x, sr,
                            stationary=stationary, device="cpu")
        err = float(np.abs(card - cpu).max())
        log(f"  reduce_noise {label} {mode}: card vs CPU max abs {err:.3e} (tol {GATE_TOL})")
        if not (np.isfinite(card).all() and card.shape == x.shape and err <= GATE_TOL):
            raise AssertionError(f"reduce_noise {label} {mode}: card vs CPU {err}")
        res[mode] = dict(max_abs=err, card_ms=card_ms, cpu_ms=cpu_ms)
    return res


def cli_convert_step(cli, rb, files, d: str, per_decode: int) -> dict:
    """`cli convert` with a preset (cleaner, formant shifting, pitch) on a
    10 s 48 kHz FLAC written by the port, exported as FLAC; against the
    same steps run in process."""
    from rvc_maker_tpu_torch.utils import audio as A
    from rvc_maker_tpu_torch.utils.noisereduce import reduce_noise
    from rvc_maker_tpu_torch.utils.pitchshift import formant_shift
    from rvc_maker_tpu_torch.utils.presets import (apply_preset_to_args, load_preset,
                                                   save_preset)

    res = {}
    x48 = A.resample(voice(AUDIO_CONVERT_S, 160.0, 31), 16000, 48000)
    _, res["flac_encode_ms"] = timed(f"save_wav FLAC, {AUDIO_CONVERT_S} s at 48 kHz",
                                     A.save_wav, os.path.join(d, "in.flac"), x48, 48000)
    back, res["flac_decode_ms"] = timed(f"read_wav FLAC, {AUDIO_CONVERT_S} s at 48 kHz",
                                        A.read_wav, os.path.join(d, "in.flac"))
    if not np.abs(back[0] - np.clip(x48, -1, 1)).max() <= 1.0 / 32768:
        raise AssertionError("FLAC round trip off by more than one int16 step")
    a16 = A.load_audio(os.path.join(d, "in.flac"), 16000)
    _, res["formant_shift_ms"] = timed(f"formant_shift, {AUDIO_CONVERT_S} s at 16 kHz",
                                       formant_shift, a16, 16000, quefrency=1.0, timbre=1.2)
    save_preset(os.path.join(d, "preset.json"), **AUDIO_PRESET)
    argv = ["convert", "--input", os.path.join(d, "in.flac"),
            "--output", os.path.join(d, "out.wav"), "--model", files["model"],
            "--rmvpe-path", files["rmvpe"], "--hubert-path", files["embedder"],
            "--index", files["index"], "--preset", os.path.join(d, "preset.json"),
            "--export-format", "flac"]
    (rc, counts), res["cli_ms"] = timed("cli convert --preset --export-format flac "
                                        "(loads the files, builds the pipeline)",
                                        launches_of, rb, cli.main, argv)
    res["launches"] = counts
    if rc != 0 or counts != (per_decode, per_decode, 0):
        raise AssertionError(f"cli convert: rc {rc}, launches (all, tc, tc_bf16) {counts}, "
                             f"expected {per_decode} on resblock_tc")
    got, sr = A.read_wav(os.path.join(d, "out.flac"))

    # the same steps in process: the CLI's own pipeline builder on the
    # same flags, then formant shift, peak, conversion, gate, FLAC's rounding
    args = cli.build_parser().parse_args(argv)
    apply_preset_to_args(args, load_preset(args.preset))
    pipe, settings = cli._build_convert_pipeline(args)
    audio = A.peak_normalize(formant_shift(a16, 16000, quefrency=args.formant_qfrency,
                                               timbre=args.formant_timbre))
    raw, res["convert_ms"] = timed("convert_utterance (in process)", pipe.convert_utterance,
                                   audio, 0, settings)
    ref, res["reduce_noise_ms"] = timed("reduce_noise of the output on the card",
                                        reduce_noise, raw, pipe.cfg.sr,
                                        prop_decrease=args.clean_strength, device="cuda")
    want = np.clip(np.round(np.clip(ref, -1, 1).astype(np.float64) * 32768), -32768, 32767)
    steps = float(np.abs(got.astype(np.float64) * 32768 - want).max()) if \
        got.shape == want.shape else float("inf")
    res["flac_vs_in_process_int16_steps"] = steps
    log(f"  the FLAC read back against the steps in process: {steps:.0f} int16 steps; "
        f"{len(got) / sr:.2f} s at {sr} Hz, |out|max {np.abs(got).max():.3f}")
    if sr != pipe.cfg.sr or steps > 1 or not np.abs(got).max() > 1000 / 32768:
        raise AssertionError(f"cli convert FLAC: sr {sr}, {steps} int16 steps from in process")
    res["gate_on_output"] = gate_card_vs_cpu(raw, pipe.cfg.sr, "of the converted 10 s")
    del pipe
    return res


def tts_steps(cli, rb, files, d: str, per_decode: int) -> dict:
    """`cli tts --model` and the four served routes against a loopback
    read-aloud server."""
    import threading
    from http.server import ThreadingHTTPServer

    from rvc_maker_tpu_torch.app import server as srv
    from rvc_maker_tpu_torch.pipelines.convert import ConvertSettings
    from rvc_maker_tpu_torch.utils import audio as A
    from rvc_maker_tpu_torch.utils.tts import _read_tts_output

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from read_aloud_fake import FakeReadAloudServer, pcm_wav_bytes

    res = {}
    speech = pcm_wav_bytes(A.resample(voice(5, 210.0, 32), 16000, 24000))
    tts = FakeReadAloudServer(speech)
    saved_url = os.environ.get("RVC_TPU_EDGE_TTS_URL")
    os.environ["RVC_TPU_EDGE_TTS_URL"] = tts.url
    httpd = None
    try:
        argv = ["tts", "--text", "hello", "--output", os.path.join(d, "tts.wav"),
                "--model", files["model"], "--rmvpe-path", files["rmvpe"],
                "--hubert-path", files["embedder"], "--index", files["index"],
                "--convert-output", os.path.join(d, "tts_converted.wav")]
        (rc, counts), res["cli_tts_ms"] = timed("cli tts --model", launches_of, rb,
                                                cli.main, argv)
        res["cli_tts_launches"] = counts
        out, sr = A.read_wav(os.path.join(d, "tts_converted.wav"))
        if rc != 0 or counts != (per_decode, per_decode, 0) or sr != 48000 or \
                abs(len(out) / sr - 5.0) > 0.05 or not np.isfinite(out).all():
            raise AssertionError(f"cli tts --model: rc {rc}, launches {counts}, "
                                 f"{len(out)} samples at {sr} Hz")

        srv.SETTINGS_PATH = os.path.join(d, "settings.json")
        srv.set_device("cuda")
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.Handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        port = httpd.server_address[1]
        code, body = post(port, "/api/settings", {"precision": "fp32"})
        if code != 200:
            raise AssertionError(f"/api/settings: {code} {body}")
        req = dict(files, text="hello", endpoint=tts.url, f0_method="rmvpe", index_rate=0.5,
                   pitch=1)
        post(port, "/api/tts", req)                    # builds the pipeline, warms it
        pipe = srv._get_pipeline(files["model"], files["index"], files["rmvpe"],
                                 files["embedder"])
        threads = []
        orig = pipe.convert_utterance

        def spy(*a, **kw):
            threads.append(threading.current_thread().name)
            return orig(*a, **kw)

        pipe.convert_utterance = spy
        ((code, body), counts), res["serve_tts_ms"] = timed(
            "/api/tts with a voice (fp32)", launches_of, rb, post, port, "/api/tts", req)
        del pipe.convert_utterance
        res["serve_tts_launches"] = counts
        if code != 200 or counts != (per_decode, per_decode, 0) or threads != ["rvc-device_0"]:
            raise AssertionError(f"/api/tts: {code} {body.get('error')}, launches {counts}, "
                                 f"converted on {threads}")
        with open(os.path.join(d, "speech.wav"), "wb") as f:
            f.write(speech)
        audio16 = A.peak_normalize(A.resample(
            _read_tts_output(os.path.join(d, "speech.wav"), 24000), 24000, 16000))
        direct, _ = launches_of(rb, pipe.convert_utterance, audio16, 0, ConvertSettings(
            pitch=1, index_rate=0.5, protect=0.33, f0_method="rmvpe"))
        direct16 = (np.clip(direct, -1, 1) * 32767).astype(np.int16)
        got = decode_wav(body["converted_b64"])
        steps = int(np.abs(got.astype(np.int32) - direct16).max()) if \
            got.shape == direct16.shape else 1 << 16
        res["serve_tts_vs_direct_int16_steps"] = steps
        log(f"  /api/tts against the direct call: {steps} int16 steps")
        if steps > 1 or decode_wav(body["audio_b64"]).shape != (24000 * 5,):
            raise AssertionError(f"/api/tts: {steps} int16 steps from the direct call")

        fx = dict(audio_b64=wav_b64(voice(5, 190.0, 33)), reverb=True, chorus=True,
                  compressor=True, pitchshift=True, pitch_shift=2.0)
        for path, r in (("/api/effects", fx), ("/api/model_info", {"model": files["model"]}),
                        ("/api/fuse", {"a": files["model"], "b": files["model"], "ratio": 0.4,
                                       "out": os.path.join(d, "fused.pth")})):
            (code, body), res[path] = timed(path, post, port, path, r)
            if code != 200:
                raise AssertionError(f"{path}: {code} {body.get('error')}")
        if not os.path.isfile(os.path.join(d, "fused.pth")):
            raise AssertionError("/api/fuse wrote no file")
    finally:
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
            srv._STATE.update(pipeline=None, pipeline_key=None)
        tts.close()
        if saved_url is None:
            os.environ.pop("RVC_TPU_EDGE_TTS_URL", None)
        else:
            os.environ["RVC_TPU_EDGE_TTS_URL"] = saved_url
    return res


def audio_tools_phase(cfg, model, work: str) -> dict:
    """Phase 13 (module docstring), on phase 11's served files."""
    from rvc_maker_tpu_torch import cli
    from rvc_maker_tpu_torch.ops import resblock as rb

    per_decode = sum(len(d) for d in cfg.resblock_dilation_sizes) * len(cfg.upsample_rates)
    d = os.path.join(work, "audio_tools")
    os.makedirs(d, exist_ok=True)
    files, files_ms = timed("the served files (phase 11's)", write_serve_files, d, cfg, model)
    res = dict(files_ms=files_ms)
    res["convert"] = cli_convert_step(cli, rb, files, d, per_decode)
    rs = np.random.RandomState(34)
    tt = np.arange(AUDIO_GATE_S * 48000) / 48000
    long = (0.4 * np.sin(2 * np.pi * 220 * tt) + 0.05 * rs.randn(len(tt))).astype(np.float32)
    res["gate_30s"] = gate_card_vs_cpu(long, 48000, f"{AUDIO_GATE_S} s at 48 kHz")
    res.update(tts_steps(cli, rb, files, d, per_decode))
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 14: the int8 W8A8 mode
# ---------------------------------------------------------------------------

H100_INT8_OPS = 1979e12      # dense int8 tensor-core peak, H100 SXM data sheet
W8A8_REPLACES = "rvc_maker_tpu/ops/int8_conv.py:179"   # conv1d_w8a8 (XLA, no Pallas kernel)


def w8a8_shapes(cfg, batch: int = 2, seconds: float = 10.0):
    """The int8 decode's convs on batch x seconds: for each stage at C >=
    64, resblock and dilation, (B, C, T, k, dilation, is_conv2); conv2
    has dilation 1 and the residual add.  54 at v2-48k."""
    from rvc_maker_tpu_torch.ops.int8_conv import DECODE_MIN_C
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline

    out, t, c = [], ConvertPipeline.frames(int(16000 * seconds)), cfg.upsample_initial_channel
    for u in cfg.upsample_rates:
        t, c = t * u, c // 2
        if c < DECODE_MIN_C:
            continue
        for k, dils in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            for d in dils:
                out += [(batch, c, t, k, d, False), (batch, c, t, k, 1, True)]
    return out


def ptxas_summary(text: str) -> list:
    """ptxas -v's lines per kernel entry: the entry (its template
    arguments), registers, spill stores and loads (bytes)."""
    out, cur = [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
            cur = dict(entry=name, registers=None, spill_stores=None, spill_loads=None)
            out.append(cur)
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(line.split("Used")[1].split("registers")[0])
        elif cur is not None and "spill stores" in line:
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if found:
                cur["spill_stores"], cur["spill_loads"] = map(int, found.groups())
    return out


def resblock_ptxas(text: str, kernel: str) -> list:
    """ptxas -v's registers and spills of each (C, k) instantiation of a
    resblock kernel template."""
    out = []
    for ent in ptxas_summary(text):
        found = re.search(kernel + r"ILi(\d+)ELi(\d+)E", ent["entry"])
        if found:
            out.append(dict(C=int(found[1]), K=int(found[2]), registers=ent["registers"],
                            spill_stores=ent["spill_stores"], spill_loads=ent["spill_loads"]))
    return out


TC_SOURCES = ("resblock_tc", "resblock_tc_bf16")
TC_INSTANTIATIONS = 15           # 5 widths x 3 kernel sizes of each tensor-core kernel


def resblock_ptxas_gate(logs: dict) -> dict:
    """Each tensor-core resblock kernel's ptxas figures per (C, k), from
    `build.build_all`'s logs (an earlier build's read back).  Raises
    unless all 15 instantiations of each are reported, none spilling."""
    rows = {src: resblock_ptxas(logs.get(src, ""), src + "_step_kernel") for src in TC_SOURCES}
    counts = {src: len(r) for src, r in rows.items()}
    spilled = [(src, e["C"], e["K"]) for src, r in rows.items() for e in r
               if e["spill_stores"] or e["spill_loads"]]
    if set(counts.values()) != {TC_INSTANTIATIONS} or spilled:
        raise AssertionError(f"ptxas: instantiations reported {counts} (expected "
                             f"{TC_INSTANTIATIONS} each), spills at {spilled}")
    return rows


def ws_template(entry: str) -> str:
    """'C=.. MB=.. TN=.. NB=.. CL=..' from a mangled conv1d_w8a8_ws_kernel entry."""
    args = entry.split("conv1d_w8a8_ws_kernelI")[-1]
    vals = [int(v) for v in re.findall(r"Li(\d+)E", args)[:5]]
    return " ".join(f"{k}={v}" for k, v in zip(("C", "MB", "TN", "NB", "CL"), vals))


def profile_w8a8(cases, iters: int) -> dict:
    """torch.profiler over each stage's convs (cases: (C, name -> fn)),
    one session per C, each conv launched `iters` times: each kernel's
    device ms per decode.  The profiler misses a few of the W8A8 kernels'
    ctypes launches, so each of those is the mean over the launches it
    recorded (one kernel each) times the stage's convs, beside the count
    recorded against the count made; cuDNN's (every other kernel, several
    per call) is the sum over the session divided by `iters`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for c in sorted({cc for cc, _ in cases}, reverse=True):
        sel = [fns for cc, fns in cases if cc == c]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for fns in sel:
                for fn in fns.values():
                    for _ in range(iters):
                        fn()
            torch.cuda.synchronize()
        ms, seen = {"ws": 0.0, "old": 0.0, "lib": 0.0}, {"ws": 0, "old": 0}
        for e in prof.events():
            if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
                continue
            key = ("ws" if "conv1d_w8a8_ws_kernel" in e.name else
                   "old" if "conv1d_w8a8_kernel" in e.name else "lib")
            ms[key] += e.device_time_total / 1e3
            seen[key] = seen.get(key, 0) + 1
        out[c] = dict(prof_ms=ms["ws"] / max(seen["ws"], 1) * len(sel),
                      prof_old_ms=ms["old"] / max(seen["old"], 1) * len(sel),
                      prof_library_ms=ms["lib"] / iters, seen_ws=seen["ws"],
                      seen_old=seen["old"], made=iters * len(sel))
    return out


def check_w8a8(shapes, card: str, ptxas_text: str = ""):
    """The W8A8 kernels against the plain version at each shape (the
    leaky ReLU fused, conv2 with the residual add): csrc/conv1d_w8a8_ws.cu
    (the route) with 0 elements apart, csrc/conv1d_w8a8.cu (its first
    version, on no route) within 1 bf16 ulp of |ref|max, as before.
    Then timed in turns with CUDA events, 20 launches each: the route's
    kernel, the first version, cuDNN's bf16 F.conv1d (the yardstick:
    PyTorch has no int8 conv), the route's kernel again; the plain
    version; and each of the three's device time by name under
    torch.profiler (10 launches each, one session per stage, kernels
    summed by name), since the ctypes launches may pace the events at
    10-20 us a launch."""
    from rvc_maker_tpu_torch.ops import int8_conv as q

    F = torch.nn.functional
    gen = torch.Generator().manual_seed(14)
    saved = q.conv1d_w8a8_ws_launches, q.conv1d_w8a8_launches
    rows, cases = [], []
    keys = ("ms", "ms_first", "ms_second", "old_ms", "plain_ms", "library_ms", "ops", "bytes",
            "bound_ms")
    tot = {k: 0.0 for k in keys}
    worst, worst_ulps, n_diff, worst_old, n_diff_old = 0.0, 0.0, 0, 0.0, 0
    iters, prof_iters = 20, 10
    for (b, c, t, k, d, second) in shapes:
        x = (torch.randn(b, c, t, generator=gen) * 0.5).cuda().bfloat16()
        r = (torch.randn(b, c, t, generator=gen) * 0.5).cuda().bfloat16() if second else None
        w = torch.randn(k, c, c, generator=gen) * (0.5 / (k * c) ** 0.5)
        w_q, w_s = q.quantize_weight(w)
        w_q, w_s = w_q.transpose(1, 2).contiguous().cuda(), w_s.cuda()
        bias = (torch.randn(c, generator=gen) * 0.1).cuda().bfloat16()
        a_s = q.activation_scale(q.lrelu(x)).reshape(1)
        kw = dict(dilation=d, apply_lrelu=True, residual=r)
        ref = q._conv1d_w8a8_plain(x, w_q, w_s, bias, a_s, **kw)
        got = q.conv1d_w8a8(x, w_q, w_s, bias, a_scale=a_s, **kw)
        old = q.conv1d_w8a8_kernel(x, w_q, w_s, bias, a_s, kernel="conv1d_w8a8", **kw)
        torch.cuda.synchronize()
        ref, got, old = ref.float(), got.float(), old.float()
        err = (got - ref).abs().max().item()
        err_old = (old - ref).abs().max().item()
        ulp = bf16_ulp(ref.abs().max().item())
        diff = int((got != ref).sum().item())
        diff_old = int((old != ref).sum().item())
        wt = w.permute(2, 1, 0).contiguous().cuda().bfloat16()

        def convs(x=x, w_q=w_q, w_s=w_s, bias=bias, a_s=a_s, kw=kw, wt=wt, k=k, d=d):
            return dict(
                ws=lambda: q.conv1d_w8a8_kernel(x, w_q, w_s, bias, a_s, **kw),
                old=lambda: q.conv1d_w8a8_kernel(x, w_q, w_s, bias, a_s, kernel="conv1d_w8a8",
                                                 **kw),
                lib=lambda: F.conv1d(x, wt, bias, dilation=d, padding=(k * d - d) // 2))

        cases.append((c, convs()))
        ws, first, lib = cases[-1][1]["ws"], cases[-1][1]["old"], cases[-1][1]["lib"]

        ms_a = cuda_ms(ws, iters)
        old_ms = cuda_ms(first, iters)
        lib_ms = cuda_ms(lib, iters)
        ms_b = cuda_ms(ws, iters)
        plain_ms = cuda_ms(lambda: q._conv1d_w8a8_plain(x, w_q, w_s, bias, a_s, **kw), 5)
        ops = q.conv1d_w8a8_ops(b, t, c, k)
        nbytes = 2 * b * c * t * (3 if second else 2) + k * c * c + 4 * c + 2 * c + 4
        bound = 1e3 * max(ops / H100_INT8_OPS, nbytes / H100_BYTES_PER_S)
        ms = (ms_a + ms_b) / 2
        row = dict(B=b, C=c, T=t, k=k, dilation=d, residual=second,
                   tiles=q.WS_TILES[(c, k)], smem_bytes=q.smem_bytes(c, k, d),
                   smem_bytes_first=q.smem_bytes(c, k, d, kernel="conv1d_w8a8"),
                   max_abs_err=err, ulp=ulp, elements_differing=diff,
                   max_abs_err_first=err_old, elements_differing_first=diff_old,
                   ms=ms, ms_first=ms_a, ms_second=ms_b, old_ms=old_ms,
                   plain_ms=plain_ms,
                   library_ms=lib_ms, ops=ops, bytes=nbytes, bound_ms=bound,
                   roofline_share=bound / ms)
        rows.append(row)
        worst, worst_ulps, n_diff = max(worst, err), max(worst_ulps, err / ulp), n_diff + diff
        worst_old, n_diff_old = max(worst_old, err_old), n_diff_old + diff_old
        for key in keys:
            tot[key] += row[key]
        if diff:
            raise AssertionError(f"conv1d_w8a8_ws C={c} T={t} k={k} d={d}: {diff} elements "
                                 f"differ from the plain version (max {err})")
        if err_old > ulp:
            raise AssertionError(f"conv1d_w8a8 C={c} T={t} k={k} d={d}: err {err_old} > 1 "
                                 f"bf16 ulp {ulp}")
        del ref, got, old
    prof = profile_w8a8(cases, prof_iters)
    del cases
    for key in ("prof_ms", "prof_old_ms", "prof_library_ms"):
        tot[key] = sum(p[key] for p in prof.values())
    seen = {k: sum(p[k] for p in prof.values()) for k in ("seen_ws", "seen_old", "made")}
    tot["profiler_launches"] = seen
    q.conv1d_w8a8_ws_launches, q.conv1d_w8a8_launches = saved   # comparisons do not count
    torch.cuda.empty_cache()
    op_ms = 1e3 * tot["ops"] / H100_INT8_OPS
    by_ms = 1e3 * tot["bytes"] / H100_BYTES_PER_S
    tot.update(max_abs_err=worst, max_err_in_ulps=worst_ulps, elements_differing=n_diff,
               max_abs_err_first=worst_old, elements_differing_first=n_diff_old,
               ops_ms=op_ms, bytes_ms=by_ms, sum_bound_ms=tot["bound_ms"],
               bound_ms=max(op_ms, by_ms), bound_by="operations" if op_ms >= by_ms else "bytes")
    ptxas = [dict(e, tiles=ws_template(e["entry"])) for e in ptxas_summary(ptxas_text)
             if "conv1d_w8a8_ws_kernel" in e["entry"]]
    tot["ptxas"] = ptxas
    for e in ptxas:
        log(f"  conv1d_w8a8_ws {e['tiles']}: {e['registers']} registers, spill stores "
            f"{e['spill_stores']} / loads {e['spill_loads']} bytes")
    tot["stages"] = {}
    for c in sorted({r["C"] for r in rows}, reverse=True):
        sel = [r for r in rows if r["C"] == c]
        st = {key: sum(r[key] for r in sel) for key in keys}
        st.update(prof[c])
        st.update(convs=len(sel), T=sel[0]["T"], smem_max=max(r["smem_bytes"] for r in sel),
                  share=st["bound_ms"] / st["ms"])
        tot["stages"][c] = st
        log(f"  W8A8 C={c} T={st['T']}: {len(sel)} convs; conv1d_w8a8_ws {st['ms']:.3f} ms "
            f"(runs {st['ms_first']:.3f} / {st['ms_second']:.3f}; profiler {st['prof_ms']:.3f}, "
            f"{st['seen_ws']} of {st['made']} launches seen), conv1d_w8a8 {st['old_ms']:.3f} "
            f"(profiler {st['prof_old_ms']:.3f}, {st['seen_old']} seen), cuDNN bf16 "
            f"{st['library_ms']:.3f} (profiler {st['prof_library_ms']:.3f}), plain "
            f"{st['plain_ms']:.3f}; bound summed per launch {st['bound_ms']:.3f} ms, share "
            f"{st['share']:.3f}; shared memory {st['smem_max'] / 1024:.1f} KB at most")
    log(f"  one int8 decode's {len(shapes)} W8A8 convs: conv1d_w8a8_ws {tot['ms']:.3f} ms "
        f"(profiler {tot['prof_ms']:.3f}), conv1d_w8a8 {tot['old_ms']:.3f} (profiler "
        f"{tot['prof_old_ms']:.3f}), cuDNN bf16 F.conv1d {tot['library_ms']:.3f} (profiler "
        f"{tot['prof_library_ms']:.3f}; the profiler saw {seen['seen_ws']} / {seen['seen_old']} "
        f"of the {seen['made']} launches of each W8A8 kernel), plain "
        f"{tot['plain_ms']:.3f}; {tot['ops'] / 1e12:.3f} "
        f"TOP ({op_ms:.3f} ms at 1,979 TOPS), {tot['bytes'] / 1e9:.3f} GB ({by_ms:.3f} ms at "
        f"3.35 TB/s) -> bound {tot['bound_ms']:.3f} ms ({tot['bound_by']}), summed per launch "
        f"{tot['sum_bound_ms']:.3f} ms; roofline share {tot['bound_ms'] / tot['ms']:.3f} "
        f"(per launch {tot['sum_bound_ms'] / tot['ms']:.3f}); conv1d_w8a8_ws {n_diff} elements "
        f"differ, conv1d_w8a8 max err {worst_old:.3e} ({n_diff_old} differ); on {card}")
    return rows, tot


def int8_phase(cfg, model, card: str) -> dict:
    """Phase 14's pipeline part: phase 4's model in bf16, without and with
    RVC_TPU_INT8=1 (set for the phase), and with RVC_TPU_INT8_SCOPE=decode
    (only the decode in int8; the scope is read at construction), on 2 x
    10 s."""
    from rvc_maker_tpu_torch.ops import int8_conv as q
    from rvc_maker_tpu_torch.ops import resblock as rb
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings

    def build():
        return ConvertPipeline(model["synth_params"], cfg, model["hubert_params"],
                               version="v2", rmvpe_params=model["rmvpe_params"],
                               index_vectors=model["index_vectors"], device="cuda",
                               compute_dtype=torch.bfloat16)

    per_decode = len(w8a8_shapes(cfg))          # two W8A8 convs per dilation step
    steps = sum(len(d) for d in cfg.resblock_dilation_sizes) * len(cfg.upsample_rates)
    narrow = steps - per_decode // 2           # the steps of the C < 64 stages
    batch = np.stack([voice(10.0, 150.0, 1), voice(10.0, 230.0, 2)])
    lengths = np.array([batch.shape[1]] * 2)
    res = {}
    saved_env = os.environ.get("RVC_TPU_INT8")
    saved_scope = os.environ.get("RVC_TPU_INT8_SCOPE")
    os.environ.pop("RVC_TPU_INT8", None)
    os.environ.pop("RVC_TPU_INT8_SCOPE", None)
    pipes = {"bf16": build()}
    os.environ["RVC_TPU_INT8"] = "1"
    try:
        t0 = time.perf_counter()
        pipes["int8"] = build()
        torch.cuda.synchronize()
        res["build_s"] = time.perf_counter() - t0
        os.environ["RVC_TPU_INT8_SCOPE"] = "decode"
        pipes["int8_decode"] = build()
        os.environ.pop("RVC_TPU_INT8_SCOPE", None)
        p8 = pipes["int8"]
        if getattr(p8.use_int8, "mode", None) != "static" or len(p8.use_int8.sigs) != per_decode:
            raise AssertionError(f"int8 pipeline not calibrated: {p8.use_int8}")
        t0 = time.perf_counter()
        p8._int8_calibrate()
        torch.cuda.synchronize()
        res["calibration_s"] = time.perf_counter() - t0
        scales = p8.use_int8.scales.cpu().numpy()
        log(f"  int8 pipeline built in {res['build_s']:.3f} s (bf16 cast, prequantize, "
            f"calibration); calibration alone {res['calibration_s']:.3f} s; {len(scales)} site "
            f"scales {scales.min():.3e} .. {scales.max():.3e}")
        p_len = p8.frames(batch.shape[1])
        z, noise = p8.draw_noise(2, p_len, torch.Generator(device="cuda").manual_seed(21))
        wavs = {}
        for method in ("yin", "rmvpe"):
            settings = ConvertSettings(index_rate=0.5, f0_method=method)
            for name, pipe in pipes.items():
                pipe.convert_batch(batch, lengths, 0, settings, z_noise=z, noise=noise)
                torch.cuda.synchronize()
                reset_counts(rb)
                q.conv1d_w8a8_ws_launches = q.conv1d_w8a8_launches = 0
                t0 = time.perf_counter()
                wav, _ = pipe.convert_batch(batch, lengths, 0, settings, z_noise=z, noise=noise)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = dict(conv1d_w8a8_ws=q.conv1d_w8a8_ws_launches,
                              conv1d_w8a8=q.conv1d_w8a8_launches,
                              resblock_tc_bf16=rb.resblock_tc_bf16_launches,
                              resblock_tc=rb.resblock_tc_launches,
                              resblock=rb.resblock_launches)
                wavs[method, name] = wav.float().cpu().numpy()
                r = res.setdefault(f"{method}_{name}", {})
                r.update(batch_s=wall, audio_s_per_s=20.0 / wall, launches=counts)
                expect = (dict(conv1d_w8a8_ws=per_decode, conv1d_w8a8=0,
                               resblock_tc_bf16=narrow, resblock_tc=0, resblock=narrow)
                          if name != "bf16" else
                          dict(conv1d_w8a8_ws=0, conv1d_w8a8=0, resblock_tc_bf16=steps,
                               resblock_tc=0, resblock=steps))
                log(f"  {method} {name}: convert_batch 2 x 10 s {wall:.3f} s wall, launches "
                    f"{counts}")
                if counts != expect:
                    raise AssertionError(f"{method} {name}: launches {counts}, expected {expect}")
                if method == "rmvpe":
                    r["profile"] = profile_call(
                        f"{name} convert_batch 2 x 10 s (rmvpe, index 0.5)",
                        lambda: pipe.convert_batch(batch, lengths, 0, settings, z_noise=z,
                                                   noise=noise), wall)
            for name in ("int8", "int8_decode"):
                a, b = wavs[method, name], wavs[method, "bf16"]
                corr_ = corr(a.ravel(), b.ravel())
                rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
                key = f"{method}_quality" + ("" if name == "int8" else "_decode")
                res[key] = dict(corr=corr_, rel_l2=rel, max_abs=float(np.abs(a - b).max()),
                                finite=bool(np.isfinite(a).all()))
                log(f"  {method}: {name} against bf16 on the same noise: corr {corr_:.6f}, "
                    f"relative L2 {rel:.4f}, max abs {np.abs(a - b).max():.3e}")
                # JAX's gate is corr > 0.98, relative L2 < 0.2; the card held 0.995 / 0.1
                if method == "yin" and not (np.isfinite(a).all() and corr_ > 0.995 and rel < 0.1):
                    raise AssertionError(f"int8 quality gate ({name}): corr {corr_}, rel {rel}")
        t0 = time.perf_counter()
        ratio = p8.audit_int8_scales(voice(10.0, 190.0, 3))
        res["audit"] = dict(s=time.perf_counter() - t0, sites=len(ratio),
                            min=float(ratio.min()), max=float(ratio.max()))
        log(f"  audit_int8_scales on a 10 s voice: {len(ratio)} ratios "
            f"{ratio.min():.3f} .. {ratio.max():.3f} in {res['audit']['s']:.3f} s")
        if not (len(ratio) == per_decode and np.isfinite(ratio).all() and (ratio > 0).all()):
            raise AssertionError(f"audit ratios {ratio}")
    finally:
        for var, saved in (("RVC_TPU_INT8", saved_env), ("RVC_TPU_INT8_SCOPE", saved_scope)):
            if saved is None:
                os.environ.pop(var, None)
            else:
                os.environ[var] = saved
    res["launches_per_decode"] = dict(conv1d_w8a8_ws=per_decode, conv1d_w8a8=0,
                                      resblock_tc_bf16=narrow)
    del pipes
    torch.cuda.empty_cache()
    log(f"  on {card}")
    return res


# ---------------------------------------------------------------------------
# phase 16: ONNX interop (rvc_maker_tpu_torch/interop/onnx_*.py)
# ---------------------------------------------------------------------------

ONNX_WAVE_TOL = 1e-3            # the .onnx route against the .pth route on the card
ONNX_F0_TOL = 1e-2              # Hz, the --f0-onnx route against native RMVPE


# the embedder and RMVPE exports, each in a process of its own (sys.argv:
# the params tree's file, the .onnx to write); they print their seconds.
# Both are static, at the shapes (b) and (c) run (10 s rows, 2 x 1,024
# mel frames): a dynamic trace costs 3-4x the host time, and the CPU
# tests hold the dynamic exports of both
_EXPORT_EMBEDDER = """
import sys, time, torch
from rvc_maker_tpu_torch.interop.onnx_embedder import export_embedder
p = torch.load(sys.argv[1], weights_only=False)
t0 = time.perf_counter()
export_embedder(p, sys.argv[2], max_samples=160000, dynamic=False)
print("EXPORT_S", time.perf_counter() - t0)
"""
_EXPORT_RMVPE = """
import sys, time, torch
from rvc_maker_tpu_torch.interop import onnx_proto
from rvc_maker_tpu_torch.interop.onnx_export import export_onnx
from rvc_maker_tpu_torch.models.rmvpe import e2e_apply
p = torch.load(sys.argv[1], weights_only=False)
t0 = time.perf_counter()
m = export_onnx(e2e_apply, (torch.zeros(2, 128, 1024),), params=p, input_names=["mel"],
                output_names=["hidden"])
onnx_proto.save_model(m, sys.argv[2])
print("EXPORT_S", time.perf_counter() - t0)
"""


def onnx_exports(d: str, cfg, model) -> dict:
    """The three exports of phase 16, run together, each in its own
    process on the host CPU: `cli export-onnx` of phase 4's model as a
    .pth, export_embedder of its HuBERT, export_onnx of its RMVPE.
    Returns the paths and each one's export s (inside its process; the
    CLI's is its whole process, start-up included)."""
    import subprocess

    from rvc_maker_tpu_torch.config import RVCConfig
    from rvc_maker_tpu_torch.interop.pth import export_synthesizer_pth

    here = os.path.dirname(os.path.abspath(__file__))
    pth = os.path.join(d, "voice.pth")
    export_synthesizer_pth(model["synth_params"], RVCConfig(version="v2", model=cfg), pth)
    trees = {}
    for name in ("hubert", "rmvpe"):
        trees[name] = os.path.join(d, f"{name}_tree.pt")
        torch.save(model[f"{name}_params"], trees[name])
    out = dict(pth=pth, voice=os.path.join(d, "voice.onnx"),
               embedder=os.path.join(d, "hubert.onnx"), rmvpe=os.path.join(d, "rmvpe.onnx"))
    cmds = {"voice": [sys.executable, "-m", "rvc_maker_tpu_torch.cli", "export-onnx",
                      "--model", pth, "--output", out["voice"]],
            "embedder": [sys.executable, "-c", _EXPORT_EMBEDDER, trees["hubert"],
                         out["embedder"]],
            "rmvpe": [sys.executable, "-c", _EXPORT_RMVPE, trees["rmvpe"], out["rmvpe"]]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(c, cwd=here, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                 text=True) for k, c in cmds.items()}
    try:
        for k, proc in procs.items():        # the voice's first: its time is its process's
            text, _ = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"the {k} export failed:\n{text[-3000:]}")
            secs = [float(line.split()[1]) for line in text.splitlines()
                    if line.startswith("EXPORT_S")]
            out[f"{k}_export_s"] = secs[0] if secs else time.perf_counter() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["exports_wall_s"] = time.perf_counter() - t0
    return out


def onnx_phase(cfg, model, work: str) -> dict:
    """Phase 16 (module docstring): phase 4's model through `cli
    export-onnx` and ConvertPipeline on the card against the `.pth`
    route, phase 4's HuBERT and RMVPE exported and run against their
    native routes, each route's wall s and profiler device ms."""
    from rvc_maker_tpu_torch.interop.onnx_embedder import OnnxEmbedder
    from rvc_maker_tpu_torch.interop.onnx_run import OnnxGraph
    from rvc_maker_tpu_torch.interop.onnx_voice import OnnxVoiceModel
    from rvc_maker_tpu_torch.interop.pth import load_synthesizer_pth
    from rvc_maker_tpu_torch.models import hubert as hubert_mod
    from rvc_maker_tpu_torch.models import rmvpe as rmvpe_mod
    from rvc_maker_tpu_torch.ops import resblock as rb
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings, device_f0

    d = os.path.join(work, "onnx")
    os.makedirs(d, exist_ok=True)
    files = onnx_exports(d, cfg, model)
    res = {k: v for k, v in files.items() if k.endswith("_s")}
    log(f"  the three exports together, each in its own process: {res['exports_wall_s']:.1f} s "
        f"wall (voice {res['voice_export_s']:.1f} s, process start-up included; embedder "
        f"{res['embedder_export_s']:.1f} s; RMVPE {res['rmvpe_export_s']:.1f} s)")
    # (a) the voice model from cli export-onnx (dynamic), both routes on
    # the same noise
    vm = OnnxVoiceModel(files["voice"], device="cuda")
    res["voice_nodes"] = vm.graph.node_count
    res["voice_bytes"] = os.path.getsize(files["voice"])
    params, pcfg, _ = load_synthesizer_pth(files["pth"])
    rest = dict(version="v2", rmvpe_params=model["rmvpe_params"],
                index_vectors=model["index_vectors"], device="cuda")
    pipes = {"pth": ConvertPipeline(params, pcfg, model["hubert_params"], **rest),
             "onnx": ConvertPipeline(vm, vm.cfg, model["hubert_params"], **rest)}
    settings = ConvertSettings(index_rate=0.5)
    L = 16000 * 10
    batch = np.stack([voice(10.0, 150.0, 1), voice(10.0, 230.0, 2)])
    lengths = np.array([L, L])
    p_len = ConvertPipeline.frames(L)
    z, noise = pipes["pth"].draw_noise(2, p_len, torch.Generator("cuda").manual_seed(16))
    wavs, walls, launches = {}, {}, {}
    for route, pipe in pipes.items():
        pipe.convert_batch(batch, lengths, 0, settings, z_noise=z, noise=noise)  # warm-up
        torch.cuda.synchronize()
        saved = reset_counts(rb)
        t0 = time.perf_counter()
        wav, _ = pipe.convert_batch(batch, lengths, 0, settings, z_noise=z, noise=noise)
        torch.cuda.synchronize()
        walls[route] = time.perf_counter() - t0
        launches[route] = rb.resblock_launches
        reset_counts(rb, saved)
        wavs[route] = wav.cpu().numpy()
    err = float(np.abs(wavs["onnx"] - wavs["pth"]).max())
    res.update(voice_wave_max_abs_err=err, wav_absmax=float(np.abs(wavs["pth"]).max()),
               wall_s=walls, resblock_launches=launches)
    log(f"  (a) the v2-48k voice from cli export-onnx: {res['voice_nodes']} nodes, "
        f"{res['voice_bytes'] / 2**20:.1f} MiB; convert_batch 2 x 10 s: .onnx "
        f"{walls['onnx']:.3f} s wall, .pth {walls['pth']:.3f} s; waveform max abs err "
        f"{err:.3e} (|wav|max {res['wav_absmax']:.3f}); resblock launches .onnx "
        f"{launches['onnx']}, .pth {launches['pth']}")
    if not err <= ONNX_WAVE_TOL or not np.isfinite(wavs["onnx"]).all():
        raise AssertionError(f".onnx vs .pth waveform err {err}")
    if launches["onnx"] != 0 or launches["pth"] == 0:
        raise AssertionError(f"resblock launches {launches}: the .onnx route runs cuDNN")
    res["profile"] = {route: profile_call(
        f"convert_batch 2 x 10 s, the .{route} route",
        lambda p=pipe: p.convert_batch(batch, lengths, 0, settings, z_noise=z, noise=noise),
        walls[route]) for route, pipe in pipes.items()}
    del pipes, vm
    # (b) the 12-layer HuBERT
    emb = OnnxEmbedder(files["embedder"], device="cuda")
    res["embedder_nodes"] = emb.graph.node_count
    audio = torch.as_tensor(batch, device="cuda")
    ln = torch.as_tensor(np.array([L, L - 16000]), device="cuda")
    hp = tree_cuda(model["hubert_params"])
    with torch.inference_mode():
        ref = hubert_mod.extract_features(hp, audio, ln)[0]
        got = emb.features(audio, ln)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = emb.features(audio, ln)
        torch.cuda.synchronize()
        res["embedder_wall_s"] = time.perf_counter() - t0
    excess = float(((got - ref).abs() - 1e-3 * ref.abs()).max())
    res["embedder_max_abs_err"] = float((got - ref).abs().max())
    log(f"  (b) 12-layer HuBERT: {res['embedder_nodes']} nodes; features of 2 x 10 s "
        f"{tuple(got.shape)} in {res['embedder_wall_s']:.3f} s, max abs err "
        f"{res['embedder_max_abs_err']:.3e}")
    if tuple(got.shape) != tuple(ref.shape) or not excess <= 1e-4:
        raise AssertionError(f"embedder: beyond rtol 1e-3 / atol 1e-4 by {excess}")
    del emb, hp
    # (c) RMVPE through the --f0-onnx route (the pipeline's device_f0 on a graph)
    graph = OnnxGraph(files["rmvpe"], device="cuda")
    rp = tree_cuda(model["rmvpe_params"])
    with torch.inference_mode():
        ref = rmvpe_mod.infer(rp, audio)
        got = device_f0("rmvpe", audio, lambda name, m: graph)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = device_f0("rmvpe", audio, lambda name, m: graph)
        torch.cuda.synchronize()
        res["rmvpe_wall_s"] = time.perf_counter() - t0
    f0_err = float((got - ref).abs().max())
    res.update(rmvpe_nodes=graph.node_count, rmvpe_f0_max_abs_err_hz=f0_err)
    log(f"  (c) RMVPE: {graph.node_count} nodes; the --f0-onnx route's f0 of 2 x 10 s in "
        f"{res['rmvpe_wall_s']:.3f} s, max abs err {f0_err:.3e} Hz against native RMVPE")
    if not f0_err <= ONNX_F0_TOL:
        raise AssertionError(f"--f0-onnx f0 err {f0_err} Hz")
    del graph, rp
    torch.cuda.empty_cache()
    return res


def tree_cuda(tree):
    from rvc_maker_tpu_torch.device import tree_to

    return tree_to(tree, torch.device("cuda"), torch.float32)


# ---------------------------------------------------------------------------
# phase 15: two ranks (rvc_maker_tpu_torch/parallel/)
# ---------------------------------------------------------------------------

PARALLEL_WORLD = 2


def _params_sha(state) -> str:
    import hashlib

    from rvc_maker_tpu_torch.pipelines import train as tr

    h = hashlib.sha256()
    for t in tr.tree_leaves(state.params_g) + tr.tree_leaves(state.params_d):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _max_grad_err(got, ref) -> dict:
    """The largest |got - ref| over max |ref| of a gradient leaf (with the
    leaf's index and shape), over the leaves above 1e-6 of the tree's
    largest gradient (exact zeros hold rounding noise on both sides:
    there both must stay under that floor)."""
    floor = 1e-6 * max(g.abs().max().item() for g in ref)
    worst = dict(rel=0.0, leaf=None, shape=None)
    for i, (a, r) in enumerate(zip(got, ref)):
        r_max = r.abs().max().item()
        if r_max < floor:
            if not a.abs().max().item() < floor:
                raise AssertionError(f"gradient leaf {i}: {a.abs().max().item()} where the "
                                     "one-process step is at rounding level")
            continue
        rel = (a - r).abs().max().item() / r_max
        if rel > worst["rel"]:
            worst = dict(rel=rel, leaf=i, shape=list(r.shape))
    return worst


def _global_batch(dataset, rank_batches):
    """The one-process batch: the ranks' rows in rank order."""
    from rvc_maker_tpu_torch.pipelines import train as tr

    return tr.Batch(**{f: np.concatenate([getattr(b, f) for b in rank_batches])
                       for f in ("phone", "phone_lengths", "pitch", "pitchf", "spec",
                                 "spec_lengths", "wave", "sid")})


def _wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def parallel_rank(rank: int, world: int, address: str, work: str) -> None:
    """One rank of phase 15, spawned: the environment contract, then (a)
    train() on phase 7's segments, (b) the sharded step against the
    one-process step, timed, (c) sharded conversion, (d) the sharded blend,
    (e) tensor-parallel HuBERT.  Rank 0 runs each one-process reference.
    Results go to work/rank{rank}.json."""
    import dataclasses
    import shutil as _shutil

    os.environ.update(RVC_COORDINATOR_ADDRESS=address, RVC_NUM_PROCESSES=str(world),
                      RVC_PROCESS_ID=str(rank))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    from rvc_maker_tpu_torch.config import preset
    from rvc_maker_tpu_torch.device import tree_rows, tree_to
    from rvc_maker_tpu_torch.models import hubert as hubert_mod
    from rvc_maker_tpu_torch.ops import resblock as rb
    from rvc_maker_tpu_torch.parallel import distributed as dist_mod
    from rvc_maker_tpu_torch.parallel.retrieval import shard_index_rows, sharded_retrieval_blend
    from rvc_maker_tpu_torch.parallel.tensor import shard_hubert_tp, tp_extract_features
    from rvc_maker_tpu_torch.pipelines import data as data_mod
    from rvc_maker_tpu_torch.pipelines import train as tr
    from rvc_maker_tpu_torch.pipelines import train_loop
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings
    from rvc_maker_tpu_torch.retrieval.index import retrieval_blend

    dist_mod.ensure_initialized("cuda")
    dev = dist_mod.rank_device("cuda")
    res = dict(rank=rank, device=str(dev), backend=torch.distributed.get_backend())
    primary = rank == 0
    cfg = preset("v2", 48000)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, log_interval=1))

    # (a) train() across the ranks: 4 rows each of every global batch of 8
    exp = os.path.join(work, "voice_2r")
    if primary:
        os.makedirs(exp)
        _shutil.copy(os.path.join(work, "voice", "filelist.txt"), exp)
    dist_mod.sync_global("exp dir")
    stamps = []
    reset_counts(rb)
    t0 = time.perf_counter()
    state = train_loop.train(exp, cfg, total_epochs=1, batch_size=4, save_every_epoch=1,
                             device="cuda", log_writer=lambda s, m: stamps.append(
                                 (time.perf_counter(), m)))
    torch.cuda.synchronize()
    if primary:
        log(f"  rank 0: (a) train() in {time.perf_counter() - t0:.1f} s")
    res["train"] = dict(
        steps=state.step, s=time.perf_counter() - t0, launches=rb.resblock_launches,
        tc_launches=rb.resblock_tc_launches, first_step_s=stamps[0][0] - t0,
        warm_step_s=float(np.mean(np.diff([s for s, _ in stamps]))),
        losses=[{k: v for k, v in m.items() if k.startswith("loss")} for _, m in stamps],
        params_sha=_params_sha(state), max_memory_allocated=torch.cuda.max_memory_allocated(dev),
        files=sorted(os.listdir(exp)) if primary else None)
    del state
    torch.cuda.empty_cache()

    # (b) the sharded step from a fresh state against one process's step
    dataset = data_mod.TrainingDataset(os.path.join(exp, "filelist.txt"), cfg)
    rank_batches = [next(data_mod.batches_for_epoch(dataset, batch_size=8, epoch=2,
                                                    seed=cfg.train.seed, rank=r,
                                                    num_replicas=world))
                    for r in range(world)]
    batch = rank_batches[rank].to(dev)
    step = tr.make_sharded_train_step(cfg)
    state = tr.init_state(cfg, device=dev)
    # the parity step on deterministic cuDNN algorithms, so that its
    # distance from one process repeats from run to run
    torch.backends.cudnn.deterministic = True
    reset_counts(rb)
    m = step(state, batch, keep_grads=True)
    torch.cuda.synchronize()
    step_launches = rb.resblock_tc_launches
    parity = None
    if primary:
        ref_state = tr.init_state(cfg, device=dev)
        gbatch = _global_batch(dataset, rank_batches).to(dev)
        ref = tr.make_train_step(cfg)(ref_state, gbatch, keep_grads=True)
        loss_rel = {k: abs(float(m[k]) - float(ref[k])) / abs(float(ref[k]))
                    for k in ("loss_g", "loss_d", "loss_mel", "loss_kl", "loss_fm", "loss_adv")}
        parity = dict(loss_rel=loss_rel, grad_rel_g=_max_grad_err(m["grads_g"], ref["grads_g"]),
                      grad_rel_d=_max_grad_err(m["grads_d"], ref["grads_d"]),
                      mask_frames=[int(b.spec_lengths.sum()) for b in rank_batches])
        del ref
    del m
    torch.backends.cudnn.deterministic = False
    dist_mod.sync_global("parity")
    # two more sharded steps, the last by range (CUDA events), then one
    # under the profiler; rank 0 times one process's step on the global
    # batch while rank 1 waits at a barrier
    _, wall1 = _wall(lambda: step(state, batch))
    timer = tr.RangeTimer()
    _, wall2 = _wall(lambda: step(state, batch, timer=timer))
    ranges, _ = timer.ms()
    res["params_sha_after_steps"] = _params_sha(state)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_prof = _wall(lambda: step(state, batch))
    device_ms = sum(kineto_figures(prof.profiler.kineto_results.events())["by_kernel"].values())
    res["step"] = dict(frames=int(batch.spec.shape[1]), rows=int(batch.spec.shape[0]),
                       tc_launches=step_launches, wall_ms=[1e3 * wall1, 1e3 * wall2],
                       ranges_ms=ranges, all_reduce_ms=ranges.get("train.all_reduce"),
                       device_ms=device_ms or None,
                       busy_share=device_ms / (1e3 * wall_prof) if device_ms else None,
                       parity=parity)
    if primary:
        tr.make_train_step(cfg)(ref_state, gbatch)       # warm
        timer1 = tr.RangeTimer()
        _, one_wall = _wall(lambda: tr.make_train_step(cfg)(ref_state, gbatch, timer=timer1))
        res["step"]["one_process"] = dict(rows=int(gbatch.spec.shape[0]),
                                          wall_ms=1e3 * one_wall, ranges_ms=timer1.ms()[0])
        del ref_state, gbatch
    dist_mod.sync_global("one-process step")
    if primary:
        log("  rank 0: (b) the sharded step against one process, timed")
    del state, batch
    torch.cuda.empty_cache()

    # (c) sharded conversion of 2 x 10 s: one row per rank
    cfg_m, model = random_model()
    audio = np.stack([voice(10.0, 150.0, 1), voice(10.0, 230.0, 2)])
    lengths = np.full(2, 16000 * 10)
    settings = ConvertSettings(index_rate=0.5)
    pipe = ConvertPipeline(model["synth_params"], cfg_m, model["hubert_params"], version="v2",
                           rmvpe_params=model["rmvpe_params"],
                           index_vectors=model["index_vectors"], device="cuda", sharded=True)
    pipe.convert_batch(audio, lengths, 0, settings)          # warm
    reset_counts(rb)
    (wav, pitchf), conv_s = _wall(lambda: pipe.convert_batch(audio, lengths, 0, settings))
    res["convert"] = dict(wall_s=conv_s, tc_launches=rb.resblock_tc_launches,
                          launches=rb.resblock_launches)
    wav, pitchf = wav.cpu().numpy(), pitchf.cpu().numpy()
    del pipe
    if primary:
        one = ConvertPipeline(model["synth_params"], cfg_m, model["hubert_params"],
                              version="v2", rmvpe_params=model["rmvpe_params"],
                              index_vectors=model["index_vectors"], device="cuda")
        one.convert_batch(audio, lengths, 0, settings)
        (wav2, pitchf2), one_s = _wall(lambda: one.convert_batch(audio, lengths, 0, settings))
        # each row at batch 1, the shape a rank converts, on the noise one
        # process draws for the batch; with the ranks' pitch held (the
        # check: RMVPE's f0 moves by rounding from run to run, ~1e-3 Hz,
        # and the NSF source integrates it over the 10 s into a phase that
        # moves the waveform by up to ~0.1), and with each row's own pitch
        z, dn = one.batch_noise(len(audio), audio.shape[1],
                                torch.Generator(device=one.device).manual_seed(0))

        def rows_at_batch1(pitch=None):
            outs = []
            for i in range(len(audio)):
                if pitch is not None:
                    one._f0 = lambda a, st, i=i: torch.as_tensor(pitch[i:i + 1],
                                                                 device=one.device)
                outs.append(one.convert_batch(audio[i:i + 1], lengths[i:i + 1], 0, settings,
                                              z_noise=z[i:i + 1],
                                              noise=tree_rows(dn, slice(i, i + 1))))
                one.__dict__.pop("_f0", None)
            return (torch.cat([w for w, _ in outs]).cpu().numpy(),
                    torch.cat([p for _, p in outs]).cpu().numpy())

        wav1, pitchf1 = rows_at_batch1(pitchf)
        wav1f, pitchf1f = rows_at_batch1()
        wav2, pitchf2 = wav2.cpu().numpy(), pitchf2.cpu().numpy()

        def apart(p, q):
            frames = np.argwhere(np.abs(p - q) > 1e-3)
            return dict(frames=int(len(frames)), first=frames[:8].tolist(),
                        max_abs_err_hz=float(np.abs(p - q).max()))

        def distance(w, p):
            return dict(max_abs_err=float(np.abs(wav - w).max()),
                        row_max_abs_err=np.abs(wav - w).max(axis=1).tolist(),
                        pitchf_apart=apart(pitchf, p))

        res["convert"].update(one_process_wall_s=one_s, max_abs_err=float(
            np.abs(wav - wav1).max()), absmax=float(np.abs(wav1).max()),
            finite=bool(np.isfinite(wav).all()), shape=list(wav.shape),
            row_max_abs_err=np.abs(wav - wav1).max(axis=1).tolist(),
            pitchf_held=bool(np.array_equal(pitchf1, pitchf)),
            own_pitch=distance(wav1f, pitchf1f), batch2=distance(wav2, pitchf2),
            own_pitch_vs_batch2=apart(pitchf1f, pitchf2))
        del one
    dist_mod.sync_global("one-process conversion")
    if primary:
        log("  rank 0: (c) sharded conversion")
    torch.cuda.empty_cache()

    # (d) the blend on 250,000 x 768 rows, 125,000 per rank
    gen = torch.Generator(dev).manual_seed(41)
    vectors = torch.randn(INDEX_ROWS, INDEX_DIM, generator=gen, device=dev)
    feats = torch.randn(2, 499, INDEX_DIM, generator=gen, device=dev)
    shard = shard_index_rows(vectors)
    sharded_retrieval_blend(feats, shard, 0.5)
    out, blend_s = _wall(lambda: sharded_retrieval_blend(feats, shard, 0.5))
    res["blend"] = dict(rows=INDEX_ROWS, rows_per_rank=int(shard.shape[0]), wall_ms=1e3 * blend_s)
    del shard
    if primary:
        retrieval_blend(feats, vectors, 0.5)
        ref, one_s = _wall(lambda: retrieval_blend(feats, vectors, 0.5))
        res["blend"].update(one_process_wall_ms=1e3 * one_s, max_abs_err=float(
            (out - ref).abs().max()), tol_ok=bool(torch.allclose(out, ref, rtol=1e-4,
                                                                  atol=1e-5)))
        del ref
    del vectors, feats, out
    dist_mod.sync_global("one-process blend")
    torch.cuda.empty_cache()

    # (e) tensor-parallel 12-layer HuBERT on the 2 x 10 s
    hubert = tree_to(model["hubert_params"], dev)
    tp_params = shard_hubert_tp(hubert)
    x = torch.as_tensor(audio, device=dev)
    ln = torch.as_tensor(lengths, device=dev)
    with torch.inference_mode():
        tp_extract_features(tp_params, x, ln)
        tp_out, tp_s = _wall(lambda: tp_extract_features(tp_params, x, ln))
        res["tp"] = dict(layers=len(hubert["layers"]), wall_ms=1e3 * tp_s,
                         heads_per_rank=tp_params["layers"][0]["attn"]["q"]["w"].shape[0] // 64)
        if primary:
            hubert_mod.extract_features(hubert, x, ln)
            (ref, _), one_s = _wall(lambda: hubert_mod.extract_features(hubert, x, ln))
            res["tp"].update(one_process_wall_ms=1e3 * one_s,
                             max_abs_err=float((tp_out - ref).abs().max()),
                             tol_ok=bool(torch.allclose(tp_out, ref, rtol=2e-3, atol=2e-4)))
    dist_mod.shutdown()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def parallel_phase(work: str, card: str) -> dict:
    """Phase 15: `parallel_rank` in PARALLEL_WORLD spawned processes on
    127.0.0.1 (the backend by rule: gloo when they share a card, NCCL
    with a card each); any rank that fails fails the phase.  The ranks'
    results are checked here."""
    import socket

    import torch.multiprocessing as mp

    from rvc_maker_tpu_torch.parallel import distributed as dist_mod

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{s.getsockname()[1]}"
    backend = dist_mod.backend_for("cuda", PARALLEL_WORLD)
    log(f"  {PARALLEL_WORLD} ranks on {torch.cuda.device_count()} card(s): {backend}, "
        f"store at tcp://{address}")
    t0 = time.perf_counter()
    ctx = mp.start_processes(parallel_rank, args=(PARALLEL_WORLD, address, work),
                             nprocs=PARALLEL_WORLD, join=False, start_method="spawn")
    while not ctx.join(5.0):          # raises when a rank failed
        if time.perf_counter() - t0 > 600:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("phase 15: ranks still running after 600 s")
    ranks = []
    for r in range(PARALLEL_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    res = dict(backend=backend, ranks=ranks, spawn_s=time.perf_counter() - t0)
    r0 = ranks[0]
    per_step = 36
    for r in ranks:
        tr_ = r["train"]
        if not (tr_["steps"] == 4 and tr_["tc_launches"] == tr_["launches"] == per_step * 4):
            raise AssertionError(f"rank {r['rank']} train(): {tr_['steps']} steps, "
                                 f"{tr_['tc_launches']} resblock_tc of {tr_['launches']}")
        if r["step"]["tc_launches"] != per_step or r["convert"]["tc_launches"] != per_step:
            raise AssertionError(f"rank {r['rank']}: {r['step']['tc_launches']} launches per "
                                 f"step, {r['convert']['tc_launches']} per decode")
    for key in ("train", "after_steps"):
        shas = {r["train"]["params_sha"] if key == "train" else r["params_sha_after_steps"]
                for r in ranks}
        if len(shas) != 1:
            raise AssertionError(f"parameters differ across ranks ({key})")
    want = sorted(["filelist.txt", "ckpt_latest.pt", "training_data.json", "voice_2r_1e_4s.pth"])
    if r0["train"]["files"] != want:
        raise AssertionError(f"rank 0 wrote {r0['train']['files']}")
    par = r0["step"]["parity"]
    if not (max(par["loss_rel"].values()) <= 2e-4 and par["grad_rel_g"]["rel"] <= 1e-3
            and par["grad_rel_d"]["rel"] <= 1e-3):
        raise AssertionError(f"sharded step against one process: {par}")
    conv = r0["convert"]
    if not (conv["finite"] and conv["pitchf_held"] and conv["max_abs_err"] <= 1e-3
            and conv["own_pitch"]["pitchf_apart"]["max_abs_err_hz"] <= 1e-2):
        raise AssertionError(f"sharded conversion against one process: {conv}")
    if not (r0["blend"]["tol_ok"] and r0["tp"]["tol_ok"]):
        raise AssertionError(f"blend {r0['blend']}, tensor-parallel HuBERT {r0['tp']}")
    step = [r["step"] for r in ranks]
    log(f"  train(): {r0['train']['steps']} steps at 2 x 4 rows, {per_step} resblock_tc "
        f"launches per step on each rank; rank 0 wrote {r0['train']['files']}, the parameters "
        f"are bitwise equal on both ranks; warm step "
        + " / ".join(f"{r['train']['warm_step_s']:.4f}" for r in ranks) + " s per rank")
    log(f"  sharded step against one process on the global batch of 8 (mask frames per rank "
        f"{par['mask_frames']}): losses max rel {max(par['loss_rel'].values()):.3e} (tol 2e-4), "
        f"gradient leaves max err / max|g| G {par['grad_rel_g']['rel']:.3e} (leaf "
        f"{par['grad_rel_g']['leaf']} {par['grad_rel_g']['shape']}) D "
        f"{par['grad_rel_d']['rel']:.3e} (tol 1e-3; deterministic cuDNN); bitwise equal "
        f"across ranks after 3 steps")
    log("  step wall ms per rank (4 rows each): " + "; ".join(
        f"rank {r['rank']} {s['wall_ms'][0]:.3f} / {s['wall_ms'][1]:.3f}, gradient all-reduce "
        f"{s['all_reduce_ms']:.3f} ms (CUDA events, waits included), profiler device "
        f"{s['device_ms'] or 0:.3f} ms (busy share {s['busy_share'] or 0:.3f})"
        for r, s in zip(ranks, step))
        + f"; one process, 8 rows: {step[0]['one_process']['wall_ms']:.3f} ms")
    log(f"  sharded convert_batch 2 x 10 s: {conv['wall_s']:.3f} / "
        f"{ranks[1]['convert']['wall_s']:.3f} s wall per rank, one process "
        f"{conv['one_process_wall_s']:.3f} s; waveform {conv['max_abs_err']:.3e} from one "
        f"process converting each row at batch 1 on the ranks' pitch (tol 1e-3, |out|max "
        f"{conv['absmax']:.3f}); on its own pitch {conv['own_pitch']['max_abs_err']:.3e} "
        f"(rows {conv['own_pitch']['row_max_abs_err']}; pitch frames apart "
        f"{conv['own_pitch']['pitchf_apart']}, tol 1e-2 Hz); at batch 2 "
        f"{conv['batch2']['max_abs_err']:.3e} (rows {conv['batch2']['row_max_abs_err']}; "
        f"pitch frames apart {conv['batch2']['pitchf_apart']}); batch 1 against batch 2 "
        f"{conv['own_pitch_vs_batch2']}")
    blend = r0["blend"]
    log(f"  sharded blend {INDEX_ROWS:,} x {INDEX_DIM} ({blend['rows_per_rank']} rows per "
        f"rank): {blend['wall_ms']:.3f} ms, one process {blend['one_process_wall_ms']:.3f} "
        f"ms, max abs {blend['max_abs_err']:.3e}; tensor-parallel HuBERT "
        f"({r0['tp']['layers']} layers, {r0['tp']['heads_per_rank']} heads per rank): "
        f"{r0['tp']['wall_ms']:.3f} ms, one process {r0['tp']['one_process_wall_ms']:.3f} ms, "
        f"max abs {r0['tp']['max_abs_err']:.3e}; on {card}")
    return res


# ---------------------------------------------------------------------------
# phase 17: vocal and music separation (models/demucs.py, pipelines/
# separate.py, pipelines/mdx.py, pipelines/separate_music.py)
# ---------------------------------------------------------------------------

SEP_SR = 44100
SEP_SECONDS = 20.0                # the song: 3 HTDemucs windows of 10 s at overlap 0.25
SEP_TOL = 1e-3                    # Demucs stems, card against CPU (TF32 off)
MDX_CARD_TOL = 1e-4               # mdx_demix, card against CPU, x max(1, |ref|max)
# the demucs v4 HTDemucs constructor's widths: channels 48 (growth 2), nfft 4096,
# depth 4, 5 transformer layers of 8 heads, 4 sources at 44.1 kHz, segment 10 s
HTDEMUCS_WIDTHS = dict(channels=48, t_layers=5)
# UVR MDX-Net "Inst HQ" graphs' I/O: (1, 4, dim_f 3072, dim_t 256), n_fft 6144, hop 1024
MDX_IO = (1, 4, 3072, 256)
MDX_CPU_SECONDS = 8.0             # the part of the song mdx_demix runs on both devices


def separation_song(seconds: float, sr: int = SEP_SR, seed: int = 17) -> np.ndarray:
    """(L, 2) float32: a sung line (harmonics with vibrato) panned left of
    centre over a bass line and noise bursts on the beat, from `seed`."""
    rs = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 220.0 * (1 + 0.03 * np.sin(2 * np.pi * 5 * t)) * 2 ** (np.floor(t) % 3 / 12)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voice = sum(0.25 / h * np.sin(h * phase) for h in (1, 2, 3, 4))
    bass = 0.2 * np.sin(2 * np.pi * 55 * t)
    drums = 0.3 * rs.randn(len(t)) * np.exp(-20 * (t % 0.5))
    left, right = 0.7 * voice + bass + drums, 0.4 * voice + bass + 0.8 * drums
    return (0.5 * np.stack([left, right], axis=1)).astype(np.float32)


def write_wav_file(path: str, audio: np.ndarray, sr: int) -> str:
    from scipy.io import wavfile

    wavfile.write(path, sr, (np.clip(audio, -1, 1) * 32767).astype(np.int16))
    return path


def write_demucs_th(path: str, sd: dict, cfg, arch: str, **kwargs) -> str:
    """The reference demucs package {klass, args, kwargs, state}, its klass
    the port's marker pickled under demucs.<module>.<arch>."""
    from rvc_maker_tpu_torch.interop import demucs_load

    demucs_load.install_demucs_shims()
    kwargs = dict(sources=list(cfg.sources), audio_channels=cfg.audio_channels, nfft=cfg.nfft,
                  depth=cfg.depth, samplerate=cfg.samplerate, segment=cfg.segment,
                  cac=cfg.cac, wiener_iters=cfg.wiener_iters,
                  wiener_residual=cfg.wiener_residual, **kwargs)
    torch.save({"klass": demucs_load.marker_class("demucs", arch.lower(), arch), "args": (),
                "kwargs": kwargs, "state": sd}, path)
    return path


def mdx_stand_in(p, spek):
    """A stand-in for an MDX-Net U-Net, (B, 4, F, T) -> (B, 4, F, T): a
    3x3 conv, one level down (stride 2) and up (2x2 transposed), a skip,
    a 1x1 conv out."""
    F = torch.nn.functional
    h1 = torch.relu(F.conv2d(spek, p["c1"]["w"], p["c1"]["b"], padding=1))
    h2 = torch.relu(F.conv2d(h1, p["c2"]["w"], p["c2"]["b"], stride=2, padding=1))
    up = torch.relu(F.conv_transpose2d(h2, p["up"]["w"], p["up"]["b"], stride=2))
    return F.conv2d(up + h1, p["out"]["w"], p["out"]["b"])


def mdx_stand_in_params(width: int = 32, seed: int = 17) -> dict:
    rs = np.random.RandomState(seed)

    def conv(cout, cin, k, transposed=False):
        shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
        return {"w": torch.as_tensor(rs.randn(*shape).astype(np.float32) / math.sqrt(cin * k * k)),
                "b": torch.as_tensor(rs.randn(cout).astype(np.float32) * 0.02)}

    return {"c1": conv(width, 4, 3), "c2": conv(2 * width, width, 3),
            "up": conv(width, 2 * width, 2, transposed=True), "out": conv(4, width, 1)}


def demucs_card_vs_cpu(cfg, sd, seconds: float, device: str, seed: int) -> dict:
    """apply_model_single on one window of `seconds`, on `device` and on
    the CPU, TF32 off: max abs of the stems."""
    from rvc_maker_tpu_torch.device import full_fp32, tree_to
    from rvc_maker_tpu_torch.models import demucs as demucs_mod

    params = demucs_mod.params_from_state_dict(sd, cfg)
    mix = torch.as_tensor(separation_song(seconds, cfg.samplerate, seed).T[None].copy())
    dev = torch.device(device)
    with torch.inference_mode(), full_fp32(dev):
        t0 = time.perf_counter()
        ref = demucs_mod.apply_model_single(params, cfg, mix).numpy()
        cpu_s = time.perf_counter() - t0
        got = demucs_mod.apply_model_single(tree_to(params, dev), cfg, mix.to(dev)).cpu().numpy()
    err = float(np.abs(got - ref).max())
    if not (np.isfinite(got).all() and got.shape == ref.shape == (1, len(cfg.sources),
                                                                      cfg.audio_channels,
                                                                      mix.shape[-1])):
        raise AssertionError(f"demucs stems: shape {got.shape}, finite {np.isfinite(got).all()}")
    if err > SEP_TOL:
        raise AssertionError(f"demucs stems card against CPU: max abs {err} > {SEP_TOL}")
    return dict(max_abs_err=err, stems_std=float(ref.std()), cpu_s=cpu_s)


def separate_phase(work: str, device: str = "cuda", htdemucs=HTDEMUCS_WIDTHS,
                   small=dict(channels=16), mdx_io=MDX_IO, mdx_hop: int = 1024) -> dict:
    """Phase 17 (module docstring).  `device` and the sizes are arguments
    for a rehearsal on the CPU at small widths."""
    import dataclasses
    import threading
    from http.server import ThreadingHTTPServer

    from rvc_maker_tpu_torch import cli
    from rvc_maker_tpu_torch.app import server as srv
    from rvc_maker_tpu_torch.interop import onnx_proto
    from rvc_maker_tpu_torch.interop.demucs_load import load_demucs_th
    from rvc_maker_tpu_torch.interop.from_jax import random_demucs_state_dict
    from rvc_maker_tpu_torch.interop.onnx_export import export_onnx
    from rvc_maker_tpu_torch.interop.onnx_run import OnnxGraph
    from rvc_maker_tpu_torch.models.demucs import DemucsConfig
    from rvc_maker_tpu_torch.pipelines import mdx as mdx_mod
    from rvc_maker_tpu_torch.pipelines.separate import separate_vocals
    from scipy.io import wavfile

    d = os.path.join(work, "separate")
    os.makedirs(d, exist_ok=True)
    dev_flag = [] if device == "cuda" else ["--device", device]
    res: dict = {"launches": {}}
    song = separation_song(SEP_SECONDS)
    song_path = write_wav_file(os.path.join(d, "song.wav"), song, SEP_SR)

    def sep_driven(label, fn):
        """`driven` (separation runs no resblock: 0), with the device's
        peak GiB."""
        torch.cuda.reset_peak_memory_stats()
        out = driven(res, label, fn, none_on="the separation path")
        res[f"{label}_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  {label}: {res[f'{label}_wall_s']:.3f} s wall, peak "
            f"{res[f'{label}_peak_gib']:.2f} GiB, resblock launches 0")
        return out

    def read_stem(path, frames):
        sr, x = wavfile.read(path)
        x = x.astype(np.float64) / 32768.0
        if sr != SEP_SR or x.shape != (frames, 2) or not np.isfinite(x).all() or x.std() < 1e-3:
            raise AssertionError(f"{path}: sr {sr}, shape {x.shape}, std {x.std()}")
        return x

    # (a) full-width HTDemucs as a .th through `cli separate`, 3 windows, 1 shift
    cfg = DemucsConfig(nfft=4096, depth=4, segment=10.0, samplerate=SEP_SR, t_heads=8)
    t0 = time.perf_counter()
    sd = random_demucs_state_dict(cfg, seed=17, **htdemucs)
    th = write_demucs_th(os.path.join(d, "htdemucs.th"), sd, cfg, "HTDemucs",
                         t_layers=htdemucs["t_layers"], channels=htdemucs["channels"])
    res["htdemucs"] = dict(parameters=int(sum(v.numel() for v in sd.values())),
                           write_s=time.perf_counter() - t0)
    log(f"  HTDemucs {htdemucs}: {res['htdemucs']['parameters']:,} parameters, "
        f"written in {res['htdemucs']['write_s']:.1f} s")
    v_path, i_path = os.path.join(d, "v.wav"), os.path.join(d, "i.wav")
    sep_driven("cli_separate_th", lambda: cli.main(
        ["separate", "--model", th, "--input", song_path, "--output-vocals", v_path,
         "--output-instrumental", i_path, "--shifts", "1", *dev_flag]))
    vocals = read_stem(v_path, len(song))
    inst = read_stem(i_path, len(song))
    res["htdemucs"]["stems_std"] = [float(vocals.std()), float(inst.std())]
    # the same separation in process, once for its wall time and once profiled
    params, _ = load_demucs_th(th, device=device)
    sep_driven("separate_vocals", lambda: separate_vocals(params, cfg, song, SEP_SR, shifts=1))
    if device == "cuda":
        res["htdemucs"]["profile"] = profile_call(
            "separate_vocals, 20 s, 3 windows, 1 shift",
            lambda: separate_vocals(params, cfg, song, SEP_SR, shifts=1),
            res["separate_vocals_wall_s"])
    del params
    # (b) card against CPU: one 10 s window of the full-width model, then a
    # small HDemucs (BLSTM + LocalState) and a cac=False HDemucs (Wiener EM)
    res["htdemucs"]["card_vs_cpu"] = demucs_card_vs_cpu(cfg, sd, 10.0, device, 18)
    log(f"  HTDemucs one 10 s window card against CPU: max abs "
        f"{res['htdemucs']['card_vs_cpu']['max_abs_err']:.3e} (stems std "
        f"{res['htdemucs']['card_vs_cpu']['stems_std']:.3e}; CPU "
        f"{res['htdemucs']['card_vs_cpu']['cpu_s']:.1f} s)")
    del sd
    hd = DemucsConfig(nfft=4096, depth=6, has_transformer=False, segment=4.0,
                      use_train_segment=False)
    for name, c in (("hdemucs", hd), ("hdemucs_wiener", dataclasses.replace(
            hd, cac=False, wiener_iters=1, wiener_residual=True))):
        res[name] = demucs_card_vs_cpu(c, random_demucs_state_dict(c, seed=19, **small), 4.0,
                                       device, 20)
        log(f"  {name} {small} one 4 s window card against CPU: max abs "
            f"{res[name]['max_abs_err']:.3e} (stems std {res[name]['stems_std']:.3e})")

    # (c) a stand-in MDX-Net graph at the Inst HQ I/O, exported by the port
    t0 = time.perf_counter()
    onnx_path = os.path.join(d, "mdx_inst_hq.onnx")
    model = export_onnx(mdx_stand_in, (torch.zeros(mdx_io),), params=mdx_stand_in_params(),
                        input_names=["input"], output_names=["output"])
    onnx_proto.save_model(model, onnx_path)
    res["mdx"] = dict(export_s=time.perf_counter() - t0, io=list(mdx_io))
    n_fft = 2 * mdx_io[2]                # dim_f 3072 of n_fft 6144's 3073 bins
    mdx_flags = ["--mdx-n-fft", str(n_fft), "--mdx-hop", str(mdx_hop)]
    mv, mi = os.path.join(d, "mv.wav"), os.path.join(d, "mi.wav")
    sep_driven("cli_separate_onnx", lambda: cli.main(
        ["separate", "--model", onnx_path, "--input", song_path, "--output-vocals", mv,
         "--output-instrumental", mi, *mdx_flags, *dev_flag]))
    read_stem(mv, len(song))
    read_stem(mi, len(song))
    graph = OnnxGraph(onnx_path, device=device)
    p = mdx_mod.params_from_graph(graph, n_fft=n_fft, hop_length=mdx_hop, compensate=1.035)
    mix = song.T.copy()
    sep_driven("mdx_separate", lambda: mdx_mod.mdx_separate(graph, mix, p))
    if device == "cuda":
        res["mdx"]["profile"] = profile_call(
            "mdx_separate, 20 s", lambda: mdx_mod.mdx_separate(graph, mix, p),
            res["mdx_separate_wall_s"])
    part = mix[:, :int(MDX_CPU_SECONDS * SEP_SR)]
    got = mdx_mod.mdx_demix(graph, part, p)
    t0 = time.perf_counter()
    ref = mdx_mod.mdx_demix(OnnxGraph(onnx_path, device="cpu"), part, p)
    res["mdx"]["cpu_s"] = time.perf_counter() - t0
    err = float(np.abs(got - ref).max())
    res["mdx"]["card_vs_cpu_max_abs_err"] = err
    bound = MDX_CARD_TOL * max(1.0, float(np.abs(ref).max()))
    log(f"  MDX stand-in {mdx_io}: exported in {res['mdx']['export_s']:.1f} s; mdx_demix on "
        f"{MDX_CPU_SECONDS:.0f} s card against CPU max abs {err:.3e} (bound {bound:.3e}; CPU "
        f"{res['mdx']['cpu_s']:.1f} s)")
    if not np.isfinite(got).all() or err > bound:
        raise AssertionError(f"mdx_demix card against CPU: max abs {err} > {bound}")
    del graph

    # (d) /api/separate with the .th and with the .onnx
    srv.SETTINGS_PATH = os.path.join(d, "settings.json")
    srv.set_device(device)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        import base64
        import io

        buf = io.BytesIO()
        wavfile.write(buf, SEP_SR, (song[:5 * SEP_SR].mean(axis=1) * 32767).astype(np.int16))
        audio_b64 = base64.b64encode(buf.getvalue()).decode()
        for kind, model_path in (("th", th), ("onnx", onnx_path)):
            req = {"audio_b64": audio_b64, "model": model_path, "mdx_n_fft": n_fft,
                   "mdx_hop": mdx_hop}
            code, body = sep_driven(f"api_separate_{kind}",
                                lambda r=req: post(httpd.server_address[1], "/api/separate", r))
            if code != 200:
                raise AssertionError(f"/api/separate ({kind}) answered {code}: {body.get('error')}")
            stems = [decode_wav(body[k]) for k in ("vocals_b64", "instrumental_b64")]
            if body["sr"] != SEP_SR or any(s.shape != (5 * SEP_SR,) for s in stems):
                raise AssertionError(f"/api/separate ({kind}): sr {body['sr']}, "
                                     f"shapes {[s.shape for s in stems]}")
            res[f"api_separate_{kind}_code"] = code
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(30)

    # (e) `cli separate-music` with the karaoke split and dereverb, every
    # pass the stand-in graph
    out_dir = os.path.join(d, "stems")
    sep_driven("cli_separate_music", lambda: cli.main(
        ["separate-music", "--input", song_path, "--output", out_dir, "--model-name", onnx_path,
         "--kara-model", onnx_path, "--reverb-model", onnx_path, "--backing", "--reverb",
         *mdx_flags, *dev_flag]))
    stems = sorted(os.listdir(os.path.join(out_dir, "song")))
    want = sorted(f"{s}.wav" for s in ("Original_Vocals", "Instruments", "Main_Vocals",
                                       "Backing_Vocals", "Original_Vocals_No_Reverb",
                                       "Main_Vocals_No_Reverb"))
    if stems != want:
        raise AssertionError(f"separate-music wrote {stems}, not {want}")
    for stem in stems:
        read_stem(os.path.join(out_dir, "song", stem), len(song))
    res["separate_music_stems"] = stems
    res["resblock_launches"] = sum(sum(c.values()) for c in res["launches"].values())
    # what phase 20 reads: the song, the .th, and the two vocal stems
    res["files"] = dict(song=song_path, th=th, vocals=v_path, mdx_vocals=mv)
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 18: the speaker stack (models/whisper.py, models/ecapa_tdnn.py,
# speaker/)
# ---------------------------------------------------------------------------

WHISPER_TOL = 1e-3          # encoder features and logits, card against CPU, x max|ref|
CACHED_TOL = 1e-4           # cached decode steps against the full pass, x max|ref|
MARGIN = 1e-3               # greedy tokens compared up to a CPU top-2 margin under this
SPEAKER_SR = 16000


def two_speaker_signal(seconds: float, seed: int = 18) -> np.ndarray:
    """Voiced stretches of two f0 ranges in turn (130 and 260 Hz, 1.4 s
    each) with 0.55 s gaps, at 16 kHz."""
    parts, i = [], 0
    while sum(len(p) for p in parts) < seconds * SPEAKER_SR:
        parts += [voice(1.4, (130.0, 260.0)[i % 2], seed + i),
                  np.zeros(int(0.55 * SPEAKER_SR), np.float32)]
        i += 1
    return np.concatenate(parts)[: int(seconds * SPEAKER_SR)]


def top2_margins(logits: np.ndarray, tokens: list, timestamp_begin: int) -> list:
    """Each greedy step's top-2 logit margin, the timestamp mask applied
    as the decoding applies it."""
    out = []
    for j in range(len(tokens)):
        lg = logits[j].astype(np.float64).copy()
        last = [t for t in tokens[:j] if t >= timestamp_begin]
        if last:
            lg[timestamp_begin: last[-1]] = -np.inf
        a, b = np.sort(lg)[-2:]
        out.append(float(b - a))
    return out


def whisper_card_vs_cpu(model_card, model_cpu, tok, audio16: np.ndarray,
                        device: str = "cuda") -> dict:
    """Phase 18 (b): one window's front end, encoder, decoder, cached
    steps and greedy tokens on both devices (`device` the card's)."""
    from rvc_maker_tpu_torch.models import whisper as wm

    res = {}
    padded = np.zeros(wm.N_SAMPLES, np.float32)
    padded[: min(len(audio16), wm.N_SAMPLES)] = audio16[: wm.N_SAMPLES]
    x = torch.from_numpy(padded[None])
    with torch.inference_mode():
        mel = {"cuda": wm.log_mel(x.to(device)), "cpu": wm.log_mel(x)}
        res["log_mel_max_abs_err"] = float((mel["cuda"].cpu() - mel["cpu"]).abs().max())
        t0 = time.perf_counter()
        feats = {"cpu": model_cpu.encoder(mel["cpu"])}
        res["cpu_encoder_s"] = time.perf_counter() - t0
        feats["cuda"] = model_card.encoder(mel["cuda"])
        ref = feats["cpu"]
        res["encoder_rel_err"] = float((feats["cuda"].cpu() - ref).abs().max() / ref.abs().max())
        seq = tok.sot_sequence() + [int(t) for t in
                                    np.random.RandomState(18).randint(0, tok.eot, 29)]
        logits, cached = {}, {}
        for d, m in (("cuda", model_card), ("cpu", model_cpu)):
            tokens = torch.tensor([seq], device=device if d == "cuda" else "cpu")
            logits[d] = m.decoder(tokens, feats[d])[0].cpu()
            cache = wm.init_cache(m.decoder, feats[d])
            steps = torch.stack([wm.decode_step(m.decoder, tokens[:, i], cache)[0]
                                 for i in range(len(seq))]).cpu()
            cached[d] = float((steps - logits[d]).abs().max() / logits[d].abs().max())
        res["logits_rel_err"] = float((logits["cuda"] - logits["cpu"]).abs().max()
                                      / logits["cpu"].abs().max())
        res["cached_vs_full_rel_err"] = cached
    kw = dict(eot=tok.eot, timestamp_begin=tok.timestamp_begin)
    greedy = {d: wm.greedy_decode(m.decoder, feats[d], tok.sot_sequence(), **kw)
              for d, m in (("cuda", model_card), ("cpu", model_cpu))}
    with torch.inference_mode():
        full = model_cpu.decoder(torch.tensor([tok.sot_sequence() + greedy["cpu"]]),
                                 feats["cpu"])[0].numpy()
    margins = top2_margins(full[len(tok.sot_sequence()) - 1:], greedy["cpu"] + [tok.eot],
                           tok.timestamp_begin)
    first_low = next((j for j, mg in enumerate(margins) if mg < MARGIN), None)
    upto = len(margins) if first_low is None else first_low
    res.update(greedy_tokens=len(greedy["cpu"]), first_low_margin_step=first_low,
               min_margin=min(margins), greedy_compared=upto,
               greedy_equal=(greedy["cuda"] + [tok.eot])[:upto]
               == (greedy["cpu"] + [tok.eot])[:upto])
    log(f"  (b) one window card against CPU: log_mel max abs {res['log_mel_max_abs_err']:.3e} "
        f"(bound 1e-4); encoder {res['encoder_rel_err']:.3e} x max|ref| (bound {WHISPER_TOL}; "
        f"CPU {res['cpu_encoder_s']:.2f} s); 32-token logits {res['logits_rel_err']:.3e} x "
        f"max|ref| (bound {WHISPER_TOL}); cached vs full card {cached['cuda']:.3e}, CPU "
        f"{cached['cpu']:.3e} (bound {CACHED_TOL}); greedy {res['greedy_tokens']} tokens, equal "
        f"over the first {upto} ({'no step' if first_low is None else f'step {first_low}'} "
        f"with a CPU top-2 margin under {MARGIN}; smallest margin {res['min_margin']:.3e})")
    bad = [k for k, v, b in (("log_mel", res["log_mel_max_abs_err"], 1e-4),
                             ("encoder", res["encoder_rel_err"], WHISPER_TOL),
                             ("logits", res["logits_rel_err"], WHISPER_TOL),
                             ("cached card", cached["cuda"], CACHED_TOL),
                             ("cached cpu", cached["cpu"], CACHED_TOL)) if not v <= b]
    if bad or not res["greedy_equal"]:
        raise AssertionError(f"Whisper card against CPU: {bad or 'greedy tokens differ'}")
    return res


def write_ecapa_dir(d: str, seed: int = 18) -> str:
    """A speechbrain spkrec-ecapa-style directory: hyperparams.yaml and
    embedding_model.ckpt (the reference's state-dict names, weights from
    a seed)."""
    from rvc_maker_tpu_torch.interop import from_jax

    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "hyperparams.yaml"), "w") as f:
        f.write("# ECAPA big for speaker verification (speechbrain spkrec-ecapa-voxceleb)\n"
                "n_mels: 80\npretrained_path: speechbrain/spkrec-ecapa-voxceleb\n"
                "compute_features: !new:speechbrain.lobes.features.Fbank\n"
                "    n_mels: !ref <n_mels>\n"
                "embedding_model: !new:speechbrain.lobes.models.ECAPA_TDNN.ECAPA_TDNN\n"
                "    input_size: !ref <n_mels>\n"
                "    channels: [512, 512, 512, 512, 1536]\n"
                "    kernel_sizes: [5, 3, 3, 3, 1]\n    dilations: [1, 2, 3, 4, 1]\n"
                "    attention_channels: 128\n    lin_neurons: 192\n"
                "modules:\n    embedding_model: !ref <embedding_model>\n"
                "pretrainer: !new:speechbrain.utils.parameter_transfer.Pretrainer\n"
                "    paths:\n        embedding_model: !ref <pretrained_path>/"
                "embedding_model.ckpt\n")
    torch.save(from_jax.ecapa_state_dict(from_jax.random_ecapa_tree(seed),
                                         np.random.RandomState(seed + 1)),
               os.path.join(d, "embedding_model.ckpt"))
    return d


def speaker_phase(work: str, cfg, model, device: str = "cuda", whisper_dims=None,
                  per_segment: int = 36) -> dict:
    """Phase 18 (module docstring).  `device`, `whisper_dims` and
    `per_segment` (the resblock_tc launches of one converted segment) are
    arguments for a rehearsal on the CPU at small widths."""
    import dataclasses
    import threading
    from http.server import ThreadingHTTPServer

    from rvc_maker_tpu_torch import cli
    from rvc_maker_tpu_torch.app import server as srv
    from rvc_maker_tpu_torch.config import RVCConfig
    from rvc_maker_tpu_torch.interop import from_jax
    from rvc_maker_tpu_torch.interop.pth import export_synthesizer_pth
    from rvc_maker_tpu_torch.models import ecapa_tdnn as ec
    from rvc_maker_tpu_torch.models import whisper as wm
    from rvc_maker_tpu_torch.speaker import diarize as di
    from rvc_maker_tpu_torch.speaker import transcribe as tr
    from rvc_maker_tpu_torch.speaker.hyperyaml import load_speechbrain_ecapa
    from rvc_maker_tpu_torch.speaker.whisper_tokenizer import WhisperTokenizer
    from rvc_maker_tpu_torch.utils.audio import read_wav

    d = os.path.join(work, "speaker")
    os.makedirs(d, exist_ok=True)
    dev_flag = [] if device == "cuda" else ["--device", device]
    res: dict = {"launches": {}}

    # (a) Whisper base as a reference .pt, a synthetic vocabulary
    dims = whisper_dims or wm.WhisperDims()
    t0 = time.perf_counter()
    tree = from_jax.random_whisper_tree(dims, seed=18, transcript=True)
    w_path = from_jax.write_whisper_pt(os.path.join(d, "whisper.pt"), tree, dims)
    vocab = from_jax.write_tiktoken_vocab(os.path.join(d, "multilingual.tiktoken"))
    res["whisper"] = dict(dims=dataclasses.asdict(dims), write_s=time.perf_counter() - t0,
                          parameters=int(sum(v.numel() for v in
                                             from_jax.whisper_state_dict(tree).values())))
    del tree
    log(f"  Whisper {dims.n_audio_state} wide, {dims.n_audio_layer} + {dims.n_text_layer} "
        f"layers: {res['whisper']['parameters']:,} parameters; .pt and vocabulary written in "
        f"{res['whisper']['write_s']:.1f} s")
    speech = two_speaker_signal(39.0, seed=40)
    speech_path = write_wav_file(os.path.join(d, "speech.wav"), speech, SPEAKER_SR)
    steps, windows = [], []
    orig_step, orig_mel = wm.decode_step, wm.log_mel

    def counted_step(*a, **kw):
        steps.append(1)
        return orig_step(*a, **kw)

    def counted_mel(*a, **kw):
        windows.append(1)
        return orig_mel(*a, **kw)

    wm.decode_step, wm.log_mel = counted_step, counted_mel
    try:
        for label, flags in (("words", ["--word-timestamps"]), ("beam5", ["--beam-size", "5"])):
            out_json = os.path.join(d, f"segments_{label}.json")
            steps.clear()
            windows.clear()
            t0 = time.perf_counter()
            cli.main(["transcribe", "--model", w_path, "--vocab", vocab, "--input",
                      speech_path, "--output", out_json, *flags, *dev_flag])
            wall = time.perf_counter() - t0
            with open(out_json, encoding="utf-8") as f:
                segs = json.load(f)
            n_words = sum(len(s.get("words", [])) for s in segs)
            res[f"transcribe_{label}"] = dict(wall_s=wall, decode_steps=len(steps),
                                              steps_per_s=len(steps) / wall,
                                              windows=len(windows),
                                              segments=len(segs), words=n_words,
                                              last_end_s=segs[-1]["end"] if segs else None)
            log(f"  (a) cli transcribe {' '.join(flags)} on {len(speech) / SPEAKER_SR:.0f} s: "
                f"{wall:.3f} s wall (model load included), {len(windows)} windows, "
                f"{len(steps)} decode steps ({len(steps) / wall:.1f} per s of wall), "
                f"{len(segs)} segments, {n_words} words")
            if len(segs) < 10 or (label == "words" and not n_words):
                raise AssertionError(f"cli transcribe {flags}: {len(segs)} segments, "
                                     f"{n_words} words")
    finally:
        wm.decode_step, wm.log_mel = orig_step, orig_mel
    whisper_card = wm.load_whisper_pt(w_path, device=device)
    whisper_cpu = wm.load_whisper_pt(w_path, device="cpu")
    tok = WhisperTokenizer(vocab)
    window = speech[: 20 * SPEAKER_SR]
    t0 = time.perf_counter()
    tr.transcribe(whisper_card, tok, window, max_windows=1)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr.transcribe(whisper_card, tok, window, max_windows=1)
    wall = min(wall, time.perf_counter() - t0)
    res["window_wall_s"] = wall
    if device == "cuda":
        res["window_profile"] = profile_call(
            "one window's transcribe (20 s, greedy)",
            lambda: tr.transcribe(whisper_card, tok, window, max_windows=1), wall)

    # (b) card against CPU on one window
    res["card_vs_cpu"] = whisper_card_vs_cpu(whisper_card, whisper_cpu, tok, window, device)
    del whisper_card, whisper_cpu

    # (c) ECAPA-TDNN from a speechbrain-style directory
    ecapa_dir = write_ecapa_dir(os.path.join(d, "spkrec-ecapa"))
    ecapa_card, info = load_speechbrain_ecapa(ecapa_dir, device=device)
    ecapa_cpu, _ = load_speechbrain_ecapa(ecapa_dir, device="cpu")
    feats = torch.stack([di.fbank(speech[i * 48000:(i + 1) * 48000]) for i in range(2)])
    got = ec.embed(ecapa_card, feats.to(device)).cpu()
    ref = ec.embed(ecapa_cpu, feats)
    res["ecapa"] = dict(info=info, rel_err=float((got - ref).abs().max() / ref.abs().max()))
    log(f"  (c) ECAPA-TDNN from {os.path.basename(ecapa_dir)}/ (hyperparams.yaml: "
        f"{info}), 2 x 3 s embeddings card against CPU {res['ecapa']['rel_err']:.3e} x "
        "max|ref| (bound 1e-4)")
    if not res["ecapa"]["rel_err"] <= 1e-4:
        raise AssertionError(f"ECAPA card against CPU: {res['ecapa']['rel_err']}")

    # (d) cli diarize-convert with phase 4's model and another, VAD and Whisper
    files = write_serve_files(d, cfg, model)
    tree_b = from_jax.random_synthesizer_tree(cfg, seed=18)
    for u in tree_b["dec"]["ups"]:
        u["w"] *= 5.0
    tree_b["dec"]["conv_post"]["w"] *= 5.0
    model_b = os.path.join(d, "voice_b.pth")
    export_synthesizer_pth(from_jax.synthesizer_from_jax(tree_b, cfg),
                           RVCConfig(version="v2", model=cfg), model_b)
    del tree_b
    talk = two_speaker_signal(19.5, seed=60)
    talk_path = write_wav_file(os.path.join(d, "talk.wav"), talk, SPEAKER_SR)
    talk16, _ = read_wav(talk_path)
    orig_cluster = di.cluster_speakers

    def labelled(fn, labels):
        """fn() with `labels` receiving the diarization's segments and
        labels."""
        def capturing(audio, segments, *a, **kw):
            out = orig_cluster(audio, segments, *a, **kw)
            labels.extend(zip(segments, out.tolist()))
            return out

        di.cluster_speakers = capturing
        try:
            return fn()
        finally:
            di.cluster_speakers = orig_cluster

    for label, flags in (("diarize_vad", []),
                         ("diarize_whisper", ["--whisper", w_path, "--vocab", vocab])):
        labels: list = []
        out_wav = os.path.join(d, f"{label}.wav")
        driven(res, label, lambda: labelled(lambda: cli.main(
            ["diarize-convert", "--input", talk_path, "--output", out_wav,
             "--model", files["model"], "--model-b", model_b, "--ecapa", ecapa_dir,
             "--hubert-path", files["embedder"], "--rmvpe-path", files["rmvpe"], *flags,
             *dev_flag]), labels), device)
        out, out_sr = read_wav(out_wav)
        segs = [s for s, _ in labels]
        card_labels = [lab for _, lab in labels]
        cpu_labels = di.cluster_speakers(talk16, segs, ecapa_cpu, num_speakers=2).tolist()
        tc = res["launches"][label]["resblock_tc"]
        res[label] = dict(segments=len(segs), labels=card_labels, cpu_labels=cpu_labels,
                          resblock_tc_launches=tc, out_s=len(out) / out_sr,
                          out_peak=float(np.abs(out).max()))
        log(f"  (d) cli diarize-convert {label[8:]}: {res[f'{label}_wall_s']:.3f} s wall, "
            f"{len(segs)} segments, labels {card_labels} (CPU {cpu_labels}), resblock_tc "
            f"launches {tc} ({per_segment} x {len(segs)} expected), output "
            f"{len(out) / out_sr:.2f} s at {out_sr} Hz, peak {res[label]['out_peak']:.3f}")
        if (card_labels != cpu_labels or tc != per_segment * len(segs) or len(segs) < 4
                or len(set(card_labels)) != 2 or not np.isfinite(out).all()
                or abs(len(out) / out_sr - len(talk16) / SPEAKER_SR) > 0.01):
            raise AssertionError(f"cli diarize-convert {label}: {res[label]}")

    # (e) /api/convert_whisper on the card
    srv.SETTINGS_PATH = os.path.join(d, "settings.json")
    srv.set_device(device)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        req = {"audio_b64": wav_b64(talk[: 8 * SPEAKER_SR]), "model_a": files["model"],
               "model_b": model_b, "ecapa": ecapa_dir, "embedder": files["embedder"],
               "rmvpe": files["rmvpe"], "f0_method": "rmvpe", "index_rate": 0.0}
        code, body = driven(res, "api_convert_whisper", lambda: post(
            httpd.server_address[1], "/api/convert_whisper", req), device)
        if code != 200:
            raise AssertionError(f"/api/convert_whisper answered {code}: {body.get('error')}")
        wav = decode_wav(body["audio_b64"])
        res["api_convert_whisper"] = dict(code=code, sr=body["sr"], samples=int(len(wav)),
                                          launches=res["launches"]["api_convert_whisper"])
        log(f"  (e) /api/convert_whisper: {code}, {len(wav) / body['sr']:.2f} s at "
            f"{body['sr']} Hz, {res['api_convert_whisper_wall_s']:.3f} s wall, resblock_tc "
            f"launches {res['launches']['api_convert_whisper']['resblock_tc']}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(30)
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


EDIT_SR = 44100
EDIT_SECONDS = 10.0               # the edited song; 1,004 mel frames, a 251 x 16 latent
EDIT_STEPS, EDIT_T_START = 50, 45   # the reference's defaults: 2 x (50 + 22) = 144 UNet calls
EDIT_PROFILE_STEPS = 10           # the profiled edit, cut to 10 steps
EDIT_CPU_SECONDS = 2.0            # card against CPU at full width
EDIT_TOL = 1e-4                   # modules, card against CPU, x max(1, |ref|max)
EDIT_WAVE_TOL = 1e-3              # the edited waveform, card against CPU
EDIT_PROMPTS = ("a solo piano melody", "a solo violin melody")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _time_ms(fn, iters: int, device) -> float:
    """cuda_ms on the card; the host clock's mean elsewhere (a rehearsal)."""
    if torch.device(device).type == "cuda":
        return cuda_ms(fn, iters)
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return 1e3 * (time.perf_counter() - t0) / iters


def _rel_err(got, ref) -> float:
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"shape {tuple(got.shape)} vs {tuple(ref.shape)}, or not finite")
    return (got - ref).abs().max().item() / max(1.0, ref.abs().max().item())


def edit_vocoder_kernels(stack, frames: int, device, card: str) -> dict:
    """(c) of phase 19: each resblock of the vocoder's stages at C in
    SUPPORTED_C (the stack's own weights, B = 1, T of a `frames`-frame
    mel), through `fused_resblock` (resblock_tc on the card) against the
    plain chain, <= 1e-4 x max(1, |ref|max); timed beside the plain chain
    and a cuDNN F.conv1d chain, with the bound.  The C = 512 stage, which
    runs the plain chain, is timed too."""
    from rvc_maker_tpu_torch.models import audioldm2 as am
    from rvc_maker_tpu_torch.ops import resblock as rb

    cfg, p = stack.voc_cfg, stack.params["vocoder"]
    gen = torch.Generator(device=device).manual_seed(19)
    rows, worst = [], 0.0
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, flops=0, bytes=0, c512_plain_ms=0.0,
               c512_library_ms=0.0)
    saved = reset_counts(rb)
    t, c = frames, cfg.upsample_initial_channel
    n_k = len(cfg.resblock_kernel_sizes)
    for i, rate in enumerate(cfg.upsample_rates):
        t, c = t * rate, c // 2
        for j, (k, dils) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)):
            dils, rbp = tuple(dils), p["resblocks"][i * n_k + j]
            x = torch.randn(1, c, t, generator=gen, device=device) * 0.3
            args = (x, rbp["w1"], rbp["b1"], rbp["w2"], rbp["b2"])
            wt1 = rbp["w1"].permute(0, 3, 2, 1).contiguous()
            wt2 = rbp["w2"].permute(0, 3, 2, 1).contiguous()
            kw = dict(kernel_size=k, dilations=dils)
            if not am._on_kernel(c, k, dils, cfg.leaky_slope):
                tot["c512_plain_ms"] += _time_ms(lambda: rb._resblock(
                    *args, slope=cfg.leaky_slope, **kw), 3, device)
                tot["c512_library_ms"] += _time_ms(lambda: library_resblock(
                    x, wt1, rbp["b1"], wt2, rbp["b2"], k, dils), 3, device)
                continue
            ref = rb._resblock(*args, **kw)
            reset_counts(rb)
            got = rb.fused_resblock(*args, **kw)
            _sync(device)
            if torch.device(device).type == "cuda" and rb.resblock_tc_launches != len(dils):
                raise AssertionError(f"vocoder C={c} k={k} did not take resblock_tc")
            err = (got - ref).abs().max().item()
            tol = EDIT_TOL * max(1.0, ref.abs().max().item())
            ms = _time_ms(lambda: rb.fused_resblock(*args, **kw), 10, device)
            plain_ms = _time_ms(lambda: rb._resblock(*args, **kw), 10, device)
            lib_ms = _time_ms(lambda: library_resblock(x, wt1, rbp["b1"], wt2, rbp["b2"], k, dils),
                              10, device)
            flops = rb.resblock_flops(1, t, c, k, len(dils))
            nbytes = 4 * (2 * c * t + sum(v.numel() for v in args[1:]))
            _, bound_ms, bound_by = bounds_ms(flops, nbytes)
            rows.append(dict(C=c, T=t, k=k, max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, flops=flops, bytes=nbytes, bound_ms=bound_ms,
                             bound_by=bound_by))
            log(f"  vocoder resblock C={c} T={t} k={k}: err {err:.3e} (tol {tol:.1e}) | "
                f"resblock_tc {ms:.3f} ms, plain {plain_ms:.3f} ms, cuDNN {lib_ms:.3f} ms, "
                f"bound {bound_ms:.3f} ms ({bound_by})")
            if not err <= tol:
                raise AssertionError(f"vocoder resblock C={c} k={k}: err {err} > {tol}")
            worst = max(worst, err)
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                           ("flops", flops), ("bytes", nbytes)):
                tot[key] += v
            del x, args, wt1, wt2, ref, got
    reset_counts(rb, saved)            # comparison launches do not count
    fp32_bound, bound, bound_by = bounds_ms(tot["flops"], tot["bytes"])
    tot.update(max_abs_err=worst, bound_ms=bound, bound_by=bound_by, fp32_bound_ms=fp32_bound,
               launches_per_call=3 * len(rows), rows=rows)
    log(f"  one vocoder call's {len(rows)} kernel resblocks ({tot['flops'] / 1e9:.1f} GFLOP, "
        f"{tot['bytes'] / 1e6:.1f} MB): resblock_tc {tot['ms']:.3f} ms, plain "
        f"{tot['plain_ms']:.3f} ms, cuDNN {tot['library_ms']:.3f} ms, bound 3xTF32 "
        f"{bound:.3f} ms ({bound_by}) / fp32 {fp32_bound:.3f} ms, roofline share "
        f"{bound / tot['ms']:.3f}; the C = 512 stage on the plain chain "
        f"{tot['c512_plain_ms']:.3f} ms (cuDNN {tot['c512_library_ms']:.3f} ms); on {card}")
    return tot


def edit_phase(work: str, card: str, device: str = "cuda", dims: dict | None = None,
               per_call: int = 36, compare: bool | None = None) -> dict:
    """Phase 19 (module docstring).  `device`, `dims` (the stack's sizes,
    `edit/stack.py` `published_dims()` by default), `per_call` (the
    resblock_tc launches of one vocoder call) and `compare` (run (b),
    by default on the card) are arguments for a rehearsal on the CPU at
    small widths."""
    import threading
    from http.server import ThreadingHTTPServer

    from rvc_maker_tpu_torch import cli
    from rvc_maker_tpu_torch.app import server as srv
    from rvc_maker_tpu_torch.device import tree_to
    from rvc_maker_tpu_torch.edit import pipeline as ep
    from rvc_maker_tpu_torch.edit import stack as st
    from rvc_maker_tpu_torch.interop.from_jax import random_audioldm2_stack
    from rvc_maker_tpu_torch.models import audioldm2 as am
    from rvc_maker_tpu_torch.models import audioldm2_text as at
    from rvc_maker_tpu_torch.ops import resblock as rb
    from rvc_maker_tpu_torch.utils.audio import read_wav, resample

    d = os.path.join(work, "edit")
    os.makedirs(d, exist_ok=True)
    on_card = torch.device(device).type == "cuda"
    res: dict = {"launches": {}, "part_s": {}}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        res["part_s"][name] = now - t_part
        t_part = now

    # (a) the full-width stack from a seed, a 10 s edit at the reference's defaults
    t0 = time.perf_counter()
    stack = random_audioldm2_stack(19, device, dims)
    _sync(device)
    leaves = []

    def collect(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                collect(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                collect(v)
        elif isinstance(tree, torch.Tensor):
            leaves.append(tree.numel())

    for name in ("vae", "unet", "vocoder", "clap", "t5", "gpt2", "proj"):
        leaves.clear()
        collect(stack.params[name])
        res.setdefault("parameters", {})[name] = int(sum(leaves))
    res["build_s"] = time.perf_counter() - t0
    log(f"  stack from a seed on {device} in {res['build_s']:.1f} s: "
        + ", ".join(f"{k} {v / 1e6:.1f} M" for k, v in res["parameters"].items())
        + f" ({sum(res['parameters'].values()) / 1e9:.3f} B parameters)")
    song = separation_song(EDIT_SECONDS, EDIT_SR, seed=19)
    src = write_wav_file(os.path.join(d, "song.wav"), song, EDIT_SR)
    unet_calls = []
    orig_unet = am.unet_forward

    def counted_unet(*a, **kw):
        unet_calls.append(1)
        return orig_unet(*a, **kw)

    def run_edit(steps, out_name, stack_=stack, dev=device, **kw):
        return ep.edit(src, os.path.join(d, out_name), stack=stack_, source_prompt=EDIT_PROMPTS[0],
                       target_prompt=EDIT_PROMPTS[1], steps=steps, t_start=EDIT_T_START,
                       sr=EDIT_SR, device=dev, **kw)

    am.unet_forward = counted_unet
    try:
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        reset_counts(rb)
        t0 = time.perf_counter()
        out = run_edit(EDIT_STEPS, "edited.wav")
        _sync(device)
        wall = time.perf_counter() - t0
        counts = reset_counts(rb)
    finally:
        am.unet_forward = orig_unet
    res["launches"]["edit"] = dict(zip(("resblock", "resblock_tc", "resblock_tc_bf16"), counts))
    res["unet_calls"] = len(unet_calls)
    want_calls = 2 * (EDIT_STEPS + int(EDIT_T_START / 100 * EDIT_STEPS))
    wav, sr = read_wav(out)
    res["edit"] = dict(wall_s=wall, steps=EDIT_STEPS, t_start=EDIT_T_START, seconds=EDIT_SECONDS,
                       out_shape=list(wav.shape), out_sr=sr, out_rms=float(np.sqrt(np.mean(wav ** 2))),
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None)
    log(f"  edit {EDIT_SECONDS:.0f} s, {EDIT_STEPS} steps, t_start {EDIT_T_START}: "
        f"{wall:.3f} s wall, {len(unet_calls)} UNet calls, launches {res['launches']['edit']}, "
        f"out {wav.shape} at {sr} Hz (rms {res['edit']['out_rms']:.4f}), peak "
        f"{res['edit']['peak_gib'] if res['edit']['peak_gib'] is None else round(res['edit']['peak_gib'], 2)} GiB")
    if len(unet_calls) != want_calls:
        raise AssertionError(f"{len(unet_calls)} UNet calls, not {want_calls}")
    if counts[1] != per_call or counts[0] != per_call or counts[2] != 0:
        raise AssertionError(f"edit launches {counts}, not {per_call} resblock_tc")
    if (sr != EDIT_SR or wav.ndim != 2 or wav.shape[1] != 2 or not np.isfinite(wav).all()
            or abs(wav.shape[0] / EDIT_SR - EDIT_SECONDS) > 0.05 or res["edit"]["out_rms"] == 0):
        raise AssertionError(f"edited file: {wav.shape} at {sr} Hz")

    # the same edit cut to 10 steps, its wall, then under torch.profiler by stage
    t0 = time.perf_counter()
    run_edit(EDIT_PROFILE_STEPS, "edited10.wav")
    _sync(device)
    wall10 = time.perf_counter() - t0
    res["edit10_wall_s"] = wall10
    part("a_edits")
    if on_card:
        res["profile"] = profile_call(f"edit, {EDIT_PROFILE_STEPS} steps",
                                      lambda: run_edit(EDIT_PROFILE_STEPS, "edited10.wav"),
                                      wall10, prefix="edit.")
    part("a_profile")

    # (b) card against CPU at full width on 2 s, the same explicit noise
    if on_card if compare is None else compare:
        cpu = st.AudioLDM2Stack(vae_cfg=stack.vae_cfg, unet_cfg=stack.unet_cfg,
                                voc_cfg=stack.voc_cfg, clap_cfg=stack.clap_cfg,
                                t5_cfg=stack.t5_cfg, gpt2_cfg=stack.gpt2_cfg,
                                params=tree_to(stack.params, torch.device("cpu")),
                                tokenize=stack.tokenize, max_new_tokens=stack.max_new_tokens,
                                n_mels=stack.n_mels, device="cpu")
        t0 = time.perf_counter()
        a16 = resample(song[:int(EDIT_CPU_SECONDS * EDIT_SR)].mean(axis=1), EDIT_SR, 16000)
        errs = {}
        with torch.inference_mode():
            mel = cpu.get_mel(a16)[0]
            errs["log_mel"] = _rel_err(stack.get_mel(a16)[0], mel)
            w = cpu.vae_encode(mel)
            errs["vae_encode"] = _rel_err(stack.vae_encode(mel.to(device)), w)
            errs["vae_decode"] = _rel_err(stack.vae_decode(w.to(device)), cpu.vae_decode(w))
            ids, mask, t5_ids, t5_mask = (torch.as_tensor(v) for v in
                                          stack.tokenize(EDIT_PROMPTS[0]))
            pc, pd = cpu.params, stack.params
            clap = at.clap_get_text_features(pc["clap"], cpu.clap_cfg, ids, mask)
            errs["clap"] = _rel_err(at.clap_get_text_features(
                pd["clap"], stack.clap_cfg, ids.to(device), mask.to(device)), clap)
            t5 = at.t5_encode(pc["t5"], cpu.t5_cfg, t5_ids, t5_mask)
            errs["t5"] = _rel_err(at.t5_encode(pd["t5"], stack.t5_cfg, t5_ids.to(device),
                                               t5_mask.to(device)), t5)
            proj, pmask = at.projection_forward(pc["proj"], clap[:, None], t5,
                                                torch.ones((1, 1), dtype=torch.int32), t5_mask)
            gpt = at.generate_language_model(pc["gpt2"], cpu.gpt2_cfg, proj, pmask,
                                             max_new_tokens=cpu.max_new_tokens)
            errs["gpt2_generate"] = _rel_err(at.generate_language_model(
                pd["gpt2"], stack.gpt2_cfg, proj.to(device), pmask.to(device),
                max_new_tokens=stack.max_new_tokens), gpt)
            step = torch.tensor([int(EDIT_T_START / 100 * 1000)], dtype=torch.int32)
            eps = am.unet_forward(pc["unet"], cpu.unet_cfg, w[None], step, gpt, t5)
            errs["unet_step"] = _rel_err(am.unet_forward(
                pd["unet"], stack.unet_cfg, w[None].to(device), step.to(device), gpt.to(device),
                t5.to(device)), eps)
            vmel = cpu.vae_decode(w)
            errs["vocoder"] = _rel_err(torch.as_tensor(stack.decode_to_mel(vmel.to(device))),
                                       torch.as_tensor(cpu.decode_to_mel(vmel)))
        res["card_vs_cpu"] = dict(errs)
        log("  card against CPU, full width, 2 s: " + ", ".join(
            f"{k} {v:.3e}" for k, v in errs.items()) + f" (x max(1, |ref|max); tol {EDIT_TOL} "
            "for all but log_mel, printed: a log of |STFT| clamped at 1e-5, where cuFFT's and "
            "the CPU's roundings of near-silent bins differ)")
        bad = {k: v for k, v in errs.items() if k != "log_mel" and not v <= EDIT_TOL}
        if bad:
            raise AssertionError(f"edit modules card against CPU: {bad} > {EDIT_TOL}")
        src2 = write_wav_file(os.path.join(d, "song2.wav"),
                              song[:int(EDIT_CPU_SECONDS * EDIT_SR)], EDIT_SR)
        noise = torch.randn((EDIT_PROFILE_STEPS, *w.shape),
                            generator=torch.Generator().manual_seed(19))
        outs = []
        for dev, stk in ((device, stack), ("cpu", cpu)):
            outs.append(read_wav(ep.edit(
                src2, os.path.join(d, f"edited2_{dev}.wav"), stack=stk,
                source_prompt=EDIT_PROMPTS[0], target_prompt=EDIT_PROMPTS[1],
                steps=EDIT_PROFILE_STEPS, t_start=EDIT_T_START, sr=EDIT_SR, device=dev,
                noise=noise))[0])
        wave_err = float(np.abs(outs[0] - outs[1]).max())
        res["card_vs_cpu"].update(edit_waveform=wave_err, cpu_s=time.perf_counter() - t0)
        log(f"  edit of 2 s at {EDIT_PROFILE_STEPS} steps, card against CPU: waveform max abs "
            f"{wave_err:.3e} (tol {EDIT_WAVE_TOL}); the CPU side {res['card_vs_cpu']['cpu_s']:.1f} s")
        if outs[0].shape != outs[1].shape or not wave_err <= EDIT_WAVE_TOL:
            raise AssertionError(f"edit card against CPU: {wave_err} > {EDIT_WAVE_TOL}")
        del cpu, pc
        if on_card:
            torch.cuda.empty_cache()

    part("b")

    # (c) the kernel against its plain version at the vocoder's stage shapes
    frames = 1 + int(EDIT_SECONDS * 16000) // 160
    frames += -frames % 4                           # the VAE's front pad
    res["vocoder_kernels"] = edit_vocoder_kernels(stack, frames, device, card)
    del stack
    if on_card:
        torch.cuda.empty_cache()

    part("c")

    # (d) `cli edit --toy-stack` and /api/audio_edit with toy_stack
    dev_flag = [] if on_card else ["--device", device]
    t0 = time.perf_counter()
    rc = cli.main(["edit", "--input-path", src, "--output-path", os.path.join(d, "cli.wav"),
                   "--toy-stack", "--steps", str(EDIT_PROFILE_STEPS), *dev_flag])
    res["cli_edit"] = dict(rc=rc, wall_s=time.perf_counter() - t0)
    if rc != 0 or read_wav(os.path.join(d, "cli.wav"))[1] != EDIT_SR:
        raise AssertionError(f"cli edit --toy-stack: rc {rc}")
    srv.SETTINGS_PATH = os.path.join(d, "settings.json")
    srv.set_device(device)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), srv.Handler)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        t0 = time.perf_counter()
        code, body = post(httpd.server_address[1], "/api/audio_edit",
                          {"input": src, "output": os.path.join(d, "api.wav"), "toy_stack": True,
                           "steps": EDIT_PROFILE_STEPS, "source_prompt": EDIT_PROMPTS[0],
                           "target_prompt": EDIT_PROMPTS[1]})
        res["api_audio_edit"] = dict(code=code, wall_s=time.perf_counter() - t0)
        if code != 200 or read_wav(body["output"])[1] != EDIT_SR:
            raise AssertionError(f"/api/audio_edit answered {code}: {body.get('error')}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(30)
    part("d")
    log(f"  cli edit --toy-stack rc {rc} in {res['cli_edit']['wall_s']:.2f} s; /api/audio_edit "
        f"{code} in {res['api_audio_edit']['wall_s']:.2f} s; parts (s): "
        + ", ".join(f"{k} {v:.1f}" for k, v in res["part_s"].items()))
    return res

# ---------------------------------------------------------------------------
# phase 20: the spectral tools and the dataset builder (pipelines/
# spec_tools.py, pipelines/create_dataset.py, cli create-dataset)
# ---------------------------------------------------------------------------

SPEC_TOL = 1e-5                   # spec_tools, card against CPU, x max(1, |ref|max)
ALIGN_DELAY = 300                 # samples the take lags the song
ALIGN_DB = -0.5                   # the take's gain
ALIGN_CPU_SECONDS = 5.0           # the cut the CPU aligns beside the card
DATASET_CPU_SECONDS = 3.0         # the cut create_dataset runs on both devices


def two_band_mp(st):
    """The two-band VR parameter set of JAX tests/test_spec_tools.py:365
    `_two_band_mp` (the released UVR parameter JSONs are not in the
    repository)."""
    return st.ModelParameters({
        "bins": 1025, "pre_filter_start": 1000, "pre_filter_stop": 1020,
        "band": {
            1: {"sr": 22050, "hl": 512, "n_fft": 1024, "crop_start": 0, "crop_stop": 400,
                "lpf_start": 300, "lpf_stop": 380, "hpf_start": 0, "hpf_stop": 0},
            2: {"sr": 44100, "hl": 1024, "n_fft": 2048, "crop_start": 100, "crop_stop": 725,
                "hpf_start": 150, "hpf_stop": 100, "lpf_start": 0, "lpf_stop": 0}}})


def spec_close(label: str, got: np.ndarray, ref: np.ndarray, tol: float = SPEC_TOL) -> float:
    """max abs of got - ref, failing beyond tol x max(1, |ref|max) or on
    a shape or a non-finite value."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError(f"{label}: shape {got.shape} against {ref.shape}, finite "
                             f"{np.isfinite(got).all()}")
    err = float(np.abs(got - ref).max())
    bound = tol * max(1.0, float(np.abs(ref).max()))
    log(f"  {label}: card against CPU max abs {err:.3e} (bound {bound:.3e})")
    if err > bound:
        raise AssertionError(f"{label}: card against CPU max abs {err} > {bound}")
    return err


def read_float(path: str):
    from scipy.io import wavfile

    sr, x = wavfile.read(path)
    return sr, (x.astype(np.float64) / 32768.0 if x.dtype == np.int16 else x.astype(np.float64))


def spec_tools_phase(work: str, sep: dict, card: str, device: str = "cuda") -> dict:
    """Phase 20 (module docstring).  sep: phase 17's results, whose files
    it reads.  `device` is an argument for a rehearsal on the CPU."""
    from scipy.io import wavfile

    from rvc_maker_tpu_torch import cli
    from rvc_maker_tpu_torch.interop.demucs_load import load_demucs_th
    from rvc_maker_tpu_torch.pipelines import create_dataset as cd
    from rvc_maker_tpu_torch.pipelines import spec_tools as st
    from rvc_maker_tpu_torch.utils.audio import read_wav, resample

    d = os.path.join(work, "spec_tools")
    os.makedirs(d, exist_ok=True)
    on_card = device == "cuda"
    dev_flag = [] if on_card else ["--device", device]
    files = sep["files"]
    res: dict = {"launches": {}}

    # `driven` on `device` and on the CPU (the path runs no resblock: 0)
    on_dev = functools.partial(driven, res, device=device, none_on="the spec_tools path")
    on_cpu = functools.partial(driven, res, device="cpu", none_on="the spec_tools path")

    # (a) cli create-dataset: phase 17's song and a 48 kHz mono copy of it,
    # the full-width HTDemucs .th, the noise gate, 1 s skipped at each end
    song, sr = read_wav(files["song"])
    m48 = write_wav_file(os.path.join(d, "song_48k_mono.wav"),
                         resample(song.mean(axis=1), sr, 48000), 48000)
    out_dir = os.path.join(d, "dataset")
    ds_flags = ["--separator-model", files["th"], "--clean-dataset", "--skip-start", "1", "1",
                "--skip-end", "1", "1", "--sample-rate", str(SEP_SR)]
    on_dev("cli_create_dataset", lambda: cli.main(
        ["create-dataset", files["song"], m48, "--output", out_dir, *ds_flags, *dev_flag]))
    written = sorted(os.listdir(out_dir))
    frames = int((SEP_SECONDS - 2) * SEP_SR)
    for name in written:
        w_sr, x = read_float(os.path.join(out_dir, name))
        if w_sr != SEP_SR or x.shape != (frames,) or not np.isfinite(x).all() or x.std() < 1e-4:
            raise AssertionError(f"create-dataset wrote {name}: sr {w_sr}, shape {x.shape}")
    if written != ["dataset_0.wav", "dataset_1.wav"]:
        raise AssertionError(f"create-dataset wrote {written}")
    res["dataset_files"] = written
    separator = load_demucs_th(files["th"], device=device)
    kw = dict(sample_rate=SEP_SR, separator=separator, clean_dataset=True,
              skip_start=["1", "1"], skip_end=["1", "1"], device=device)
    on_dev("create_dataset", lambda: cd.create_dataset([files["song"], m48],
                                                        os.path.join(d, "ds2"), **kw))
    if on_card:
        res["create_dataset_profile"] = profile_call(
            "create_dataset, 2 inputs of 20 s (18 s kept), HTDemucs and the noise gate",
            lambda: cd.create_dataset([files["song"], m48], os.path.join(d, "ds3"), **kw),
            res["create_dataset_wall_s"])
    log(f"  (a) cli create-dataset: {written} ({frames} samples at {SEP_SR} Hz each) in "
        f"{res['cli_create_dataset_wall_s']:.3f} s wall (the .th load included); "
        f"create_dataset in process {res['create_dataset_wall_s']:.3f} s; on {card}")
    cut = write_wav_file(os.path.join(d, "cut.wav"), song[:int(DATASET_CPU_SECONDS * SEP_SR)],
                         SEP_SR)
    one = dict(sample_rate=SEP_SR, clean_dataset=True)
    got = cd.create_dataset([cut], os.path.join(d, "cut_card"), device=device,
                            separator=separator, **one)
    ref = on_cpu("create_dataset_cut_cpu", lambda: cd.create_dataset(
        [cut], os.path.join(d, "cut_cpu"), device="cpu",
        separator=load_demucs_th(files["th"], device="cpu"), **one))
    g, r = read_float(got[0])[1], read_float(ref[0])[1]
    err = float(np.abs(g - r).max())
    res["create_dataset_cut_max_abs_err"] = err
    log(f"  (a) create_dataset on {DATASET_CPU_SECONDS:.0f} s, card against CPU: max abs "
        f"{err:.3e} (bound {SEP_TOL}; CPU {res['create_dataset_cut_cpu_wall_s']:.1f} s)")
    if g.shape != r.shape or not np.isfinite(g).all() or err > SEP_TOL:
        raise AssertionError(f"create_dataset card against CPU: max abs {err}, shapes "
                             f"{g.shape} / {r.shape}")
    del separator

    # (b) ensemble_inputs on phase 17's two vocal stems (HTDemucs, the MDX
    # stand-in): Max Spec, Min Spec, Average
    stems = [files["vocals"], files["mdx_vocals"]]
    for alg in (st.MAX_SPEC, st.MIN_SPEC, st.AVERAGE):
        tag = alg.lower().replace(" ", "_")
        outs = {dv: os.path.join(d, f"ens_{tag}_{dv}.wav") for dv in (device, "cpu")}
        on_dev(f"ensemble_{tag}", lambda a=alg: st.ensemble_inputs(
            stems, a, 1.0, "FLOAT", outs[device], device=device))
        on_cpu(f"ensemble_{tag}_cpu", lambda a=alg: st.ensemble_inputs(
            stems, a, 1.0, "FLOAT", outs["cpu"], device="cpu"))
        res[f"ensemble_{tag}_max_abs_err"] = spec_close(
            f"(b) ensemble_inputs {alg} on 2 x 20 s ({res[f'ensemble_{tag}_wall_s']:.3f} s; CPU "
            f"{res[f'ensemble_{tag}_cpu_wall_s']:.3f} s)",
            read_float(outs[device])[1], read_float(outs["cpu"])[1])
    if on_card:
        res["ensemble_profile"] = profile_call(
            "ensemble_inputs Max Spec, 2 x 20 s", lambda: st.ensemble_inputs(
                stems, st.MAX_SPEC, 1.0, "FLOAT", os.path.join(d, "ens_prof.wav"), device=device),
            res["ensemble_max_spec_wall_s"])

    # (c) align_audio of the song against a copy delayed by 300 samples at
    # -0.5 dB, its coarse lags recorded
    take = np.concatenate([np.zeros((ALIGN_DELAY, 2), np.float32), song[:-ALIGN_DELAY]])
    take = (take * 10 ** (ALIGN_DB / 20)).astype(np.float32)
    paths = {}
    for secs in (SEP_SECONDS, ALIGN_CPU_SECONDS):
        n = int(secs * SEP_SR)
        paths[secs] = (write_wav_file(os.path.join(d, f"mix_{secs:g}.wav"), song[:n], SEP_SR),
                       os.path.join(d, f"take_{secs:g}.wav"))
        wavfile.write(paths[secs][1], SEP_SR, take[:n])
    lags: list = []
    xcorr_lag = st._xcorr_lag

    def recording(a, b):
        lag = xcorr_lag(a, b)
        lags.append(lag)
        return lag

    def align(secs, dv):
        out = (os.path.join(d, f"aligned_{secs:g}_{dv}.wav"),
               os.path.join(d, f"sub_{secs:g}_{dv}.wav"))
        del lags[:]
        st.align_audio(*paths[secs], *out, "FLOAT", True, None, None, [0.0625, 0.5], [1, 2],
                       (0.0, [-0.5, 0.0, 0.5]), None, st.POSITIVE_PHASE, 180, False, True,
                       device=dv)
        return out, list(lags)

    st._xcorr_lag = recording
    try:
        outs, out_lags = {}, {}
        for secs in (SEP_SECONDS, ALIGN_CPU_SECONDS):
            outs[secs, device], out_lags[secs, device] = on_dev(
                f"align_{secs:g}s", lambda s=secs: align(s, device))
            outs[secs, "cpu"], out_lags[secs, "cpu"] = on_cpu(
                f"align_{secs:g}s_cpu", lambda s=secs: align(s, "cpu"))
        if on_card:
            res["align_profile"] = profile_call(f"align_audio, {SEP_SECONDS:.0f} s stereo",
                                                lambda: align(SEP_SECONDS, device),
                                                res[f"align_{SEP_SECONDS:g}s_wall_s"])
    finally:
        st._xcorr_lag = xcorr_lag
    res["align_coarse_lags"] = {f"{s:g}s {dv}": v for (s, dv), v in out_lags.items()}
    if any(v != [-ALIGN_DELAY] * 2 for v in out_lags.values()):
        raise AssertionError(f"align_audio coarse lags {res['align_coarse_lags']}, not "
                             f"{-ALIGN_DELAY} at both probes")
    for secs in (SEP_SECONDS, ALIGN_CPU_SECONDS):
        for k, what in enumerate(("aligned", "residual")):
            res[f"align_{secs:g}s_{what}_max_abs_err"] = spec_close(
                f"(c) align_audio {secs:g} s, the {what}", read_float(outs[secs, device][k])[1],
                read_float(outs[secs, "cpu"][k])[1])
    sub = read_float(outs[SEP_SECONDS, device][1])[1][:-ALIGN_DELAY]
    res["align_residual_db"] = float(20 * np.log10(np.sqrt(np.mean(sub ** 2))
                                                   / np.sqrt(np.mean(song[:-ALIGN_DELAY] ** 2))))
    log(f"  (c) align_audio: recovered delay {ALIGN_DELAY} samples (coarse lag "
        f"{out_lags[SEP_SECONDS, device][0]} at both probes, on both devices); residual "
        f"{res['align_residual_db']:.1f} dB under the song; {SEP_SECONDS:.0f} s: "
        f"{res[f'align_{SEP_SECONDS:g}s_wall_s']:.3f} s wall (CPU "
        f"{res[f'align_{SEP_SECONDS:g}s_cpu_wall_s']:.3f} s); {ALIGN_CPU_SECONDS:.0f} s: "
        f"{res[f'align_{ALIGN_CPU_SECONDS:g}s_wall_s']:.3f} s (CPU "
        f"{res[f'align_{ALIGN_CPU_SECONDS:g}s_cpu_wall_s']:.3f} s); on {card}")
    # the batched cross-correlation alone, at both window sizes over the
    # 20 s stereo song: its device ms (cuFFT), and the whole window search's
    if on_card:
        mix_t = torch.as_tensor(read_float(paths[SEP_SECONDS][0])[1].T.copy(), device=device)
        take_t = torch.as_tensor(take.T.astype(np.float64) * 10 ** (0.5 / 20), device=device)
        res["xcorr"] = {}
        for secs in (0.0625, 0.5):
            win = int(SEP_SR * secs)
            n_w = len(range(0, mix_t.shape[1] - win, win // 2))
            taper = torch.as_tensor(np.hanning(win), device=device)
            wm = (mix_t.unfold(-1, win, win // 2)[:, :n_w] * taper).flatten(0, 1)
            wi = (take_t.unfold(-1, win, win // 2)[:, :n_w] * taper).flatten(0, 1)
            variants = torch.stack([wi, -wi], dim=1)
            row = dict(windows=int(wm.shape[0]), variants=2, gains=3, fft_points=1 << (
                2 * win - 2).bit_length())
            row["xcorr_ms"] = cuda_ms(lambda: st._xcorr_full(wm[:, None], variants), 5)
            row["realign_ms"] = cuda_ms(lambda: st._realign_window(
                wm, wi, (0.0, [-0.5, 0.0, 0.5]), 180), 5)
            res["xcorr"][f"{secs:g}s"] = row
            log(f"  (c) window {secs:g} s: {row['windows']} windows x 2 variants, "
                f"{row['fft_points']}-point float64 FFTs: cross-correlation {row['xcorr_ms']:.3f} "
                f"ms, the whole search (3 gains) {row['realign_ms']:.3f} ms (CUDA events)")

    # (d) cmb_spectrogram_to_wave round trip on the two-band set
    mp = two_band_mp(st)
    wave = np.ascontiguousarray(song.T)

    def round_trip(dv):
        specs = {}
        for b, band in mp.param["band"].items():
            wb = st._resample(wave, SEP_SR, band["sr"])
            specs[b] = st.wave_to_spectrogram(wb, band["hl"], band["n_fft"], mp, b, device=dv)
        comb = st.combine_spectrograms(specs, mp, device=dv)
        return st.cmb_spectrogram_to_wave(comb, mp, device=dv)

    got = on_dev("cmb_round_trip", lambda: round_trip(device))
    ref = on_cpu("cmb_round_trip_cpu", lambda: round_trip("cpu"))
    n = min(got.shape[1], wave.shape[1])
    res["cmb_corr_with_input"] = float(np.corrcoef(got[0, :n], wave[0, :n])[0, 1])
    res["cmb_max_abs_err"] = spec_close(
        f"(d) cmb_spectrogram_to_wave round trip of 20 s on the two-band set "
        f"({res['cmb_round_trip_wall_s']:.3f} s; CPU {res['cmb_round_trip_cpu_wall_s']:.3f} s; "
        f"{got.shape[1]} samples, correlation with the input {res['cmb_corr_with_input']:.4f})",
        got, ref)
    res["resblock_launches"] = sum(sum(c.values()) for c in res["launches"].values())
    return res


# ---------------------------------------------------------------------------
# phase 21: the training and weight tools (rvc_maker_tpu_torch/tools/)
# ---------------------------------------------------------------------------

# (a) e2e_train: files x seconds of corpus, epochs, B, the epoch after which
# SIGTERM goes, save every; (c) the A/B overlay: files (6 s each), epochs, B
E2E_RUN = dict(files=8, seconds=10.0, epochs=6, batch=8, kill=3, save_every=3)
AB_RUN = dict(files=6, epochs=3, batch=8)
GATE_S = 6.0                      # (b) the int8 gate's utterance
TOOLS_PASS = ("synth_pth", "hubert_pt", "rmvpe_pt", "faiss_index", "bf16_gate")


def validator_dir(d: str, work: str, e2e_exp: str, pth: str) -> dict:
    """A directory of links to model files that earlier phases wrote:
    phase 12's copies of phase 4's voice .pth, fairseq HuBERT .pt and
    rmvpe.pt (work/serve_files), (a)'s `cli index` pair (`added_*.index`
    and its `total_fea.npy`) and trained .pth, and where they are kept
    phase 16's voice .onnx, phase 17's HTDemucs .th and MDX stand-in .onnx
    and phase 18's Whisper .pt.  Returns {link name: target}."""
    links = {"voice.pth": os.path.join(work, "serve_files", "voice.pth"),
             "hubert_base.pt": os.path.join(work, "serve_files", "hubert_base.pt"),
             "rmvpe.pt": os.path.join(work, "serve_files", "rmvpe.pt"),
             "total_fea.npy": os.path.join(e2e_exp, "total_fea.npy"),
             os.path.basename(pth): pth,
             "voice.onnx": os.path.join(work, "onnx", "voice.onnx"),
             "htdemucs.th": os.path.join(work, "separate", "htdemucs.th"),
             "mdx_inst_hq.onnx": os.path.join(work, "separate", "mdx_inst_hq.onnx"),
             "whisper.pt": os.path.join(work, "speaker", "whisper.pt")}
    links.update({f: os.path.join(e2e_exp, f) for f in os.listdir(e2e_exp)
                  if f.startswith("added_") and f.endswith(".index")})
    os.makedirs(d, exist_ok=True)
    kept = {}
    for name, target in links.items():
        if os.path.isfile(target):
            os.symlink(target, os.path.join(d, name))
            kept[name] = target
    return kept


def tools_phase(work: str, card: str, device: str = "cuda", e2e=E2E_RUN, ab=AB_RUN,
                gate_s: float = GATE_S, per_decode: int = 36, narrow: int = 9,
                w8a8_per_decode: int = 54) -> dict:
    """Phase 21 (module docstring).  One decode's launches on the card:
    per_decode resblock steps (bf16 and fp32), `narrow` of them (below C
    = 64) in an int8 decode beside w8a8_per_decode W8A8 convs.  `device`
    and the runs' counts are arguments for a rehearsal on the CPU at small
    widths, with e2e_train.CLI pointed at a narrowed CLI; the launch
    counts are checked on the card only."""
    from concurrent.futures import ThreadPoolExecutor

    from rvc_maker_tpu_torch.interop import from_jax
    from rvc_maker_tpu_torch.interop.pth import load_synthesizer_pth
    from rvc_maker_tpu_torch.models.hubert import load_hubert_pt
    from rvc_maker_tpu_torch.ops import int8_conv as q
    from rvc_maker_tpu_torch.ops import resblock as rb
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline, ConvertSettings
    from rvc_maker_tpu_torch.tools import e2e_train, train_ab_overlay
    from rvc_maker_tpu_torch.tools import int8_gate_rehearsal as gate
    from rvc_maker_tpu_torch.tools import validate_real_weights as vrw

    d = os.path.join(work, "tools")
    os.makedirs(d, exist_ok=True)
    res: dict = {"launches": {}, "part_s": {}}
    on_card = device == "cuda"

    def part(label, fn):
        t0 = time.perf_counter()
        out = fn()
        res["part_s"][label] = time.perf_counter() - t0
        log(f"  [21{label}] done in {res['part_s'][label]:.1f} s")
        return out

    # (c) the A/B overlay runs in CLI processes of its own beside (a)'s: both
    # are paced by their processes' start-up on the host, and the card has
    # room for both; it is read after (a), before (b) sets the int8 switches
    # in this process's environment, which its processes would inherit
    abd = os.path.join(d, "ab")

    def overlay():
        t0 = time.perf_counter()
        out = train_ab_overlay.main(
            ["--workdir", abd, "--files", str(ab["files"]), "--epochs", str(ab["epochs"]),
             "--batch-size", str(ab["batch"])] + ([] if on_card else ["--cpu"]))
        return out, time.perf_counter() - t0

    pool = ThreadPoolExecutor(1)
    overlay_run = pool.submit(overlay)

    # (a) the end-to-end run through the CLI: bf16 training with a SIGTERM
    # after epoch `kill`, the hashed resume, cli convert
    wd = os.path.join(d, "e2e")

    def e2e_run():
        e2e_train.gen_dataset(os.path.join(wd, "dataset"), e2e["files"], seconds=e2e["seconds"])
        args = ["run", "--workdir", wd, "--files", str(e2e["files"]), "--epochs",
                str(e2e["epochs"]), "--batch-size", str(e2e["batch"]), "--kill-epoch",
                str(e2e["kill"]), "--save-every", str(e2e["save_every"])]
        return e2e_train.run(e2e_train.build_parser().parse_args(
            args + ([] if on_card else ["--cpu"])))

    s = res["e2e"] = part("a e2e_train", e2e_run)
    log(f"  e2e_train: {s['segments']} segments; stages s {s['stages']}; phase A rc "
        f"{s['phase_a_rc']}; checkpoint step {s['ckpt_step_at_kill']} sha256 "
        f"{s['ckpt_sha256'][:16]}..., resumed step {s['resume_step']} sha256 "
        f"{s['resume_sha256'][:16]}...: byte-exact {s['resume_byte_exact']}; epochs done "
        f"{s['epochs_done']}; smoothed loss_g first {s['smoothed_g_first']}, last "
        f"{s['smoothed_g_last']}; {s['exported_pth']} through cli convert: "
        f"{s['convert_out_sec']} s at {s['convert_out_sr']} Hz, finite {s['convert_finite']}")
    exp = os.path.join(wd, "exp")
    pth = os.path.join(exp, s["exported_pth"])
    params, mcfg, _ = load_synthesizer_pth(pth)
    if not s["resume_byte_exact"]:
        raise AssertionError(f"phase 21 (a): the resume is not byte-exact: {s}")
    if s["epochs_done"] != list(range(1, e2e["epochs"] + 1)):
        raise AssertionError(f"phase 21 (a): epochs done {s['epochs_done']}")
    if not (s["convert_finite"] and s["convert_out_sr"] == mcfg.sr
            and abs(s["convert_out_sec"] - 5.0) <= 0.02):
        raise AssertionError(f"phase 21 (a): conversion {s['convert_out_sec']} s at "
                             f"{s['convert_out_sr']} Hz, finite {s['convert_finite']}")

    # the trained .pth converting 2 s in this process (the HuBERT the run
    # extracted with, a random RMVPE), launches counted, profiled, and card
    # against CPU on the CPU's RMVPE f0 (phase 9)
    nets = dict(hubert=load_hubert_pt(os.path.join(wd, "hubert_random.pt")),
                rmvpe=from_jax.rmvpe_from_jax(from_jax.random_rmvpe_tree(1234)))

    def trained_convert():
        short = voice(2.0, 200.0, 4)[None]
        lengths = np.array([short.shape[1]])
        settings = ConvertSettings()
        pipes = {dev: ConvertPipeline(params, mcfg, nets["hubert"], version="v2",
                                      rmvpe_params=nets["rmvpe"], device=dev)
                 for dev in dict.fromkeys(("cpu", device))}
        z, noise = pipes["cpu"].draw_noise(1, pipes["cpu"].frames(short.shape[1]),
                                           torch.Generator().manual_seed(11))
        w_cpu, f0_cpu = pipes["cpu"].convert_batch(short, lengths, 0, settings, z_noise=z,
                                                   noise=noise)
        pipe = pipes[device]
        pipe._f0 = lambda audio, st, dv=pipe.device: f0_cpu.to(dv)

        def run():
            return pipe.convert_batch(short, lengths, 0, settings, z_noise=z, noise=noise)[0]
        run()                                   # its shapes' first call
        w = driven(res, "trained_convert", run, device)
        counts = res["launches"]["trained_convert"]
        want = dict(resblock=per_decode, resblock_tc=per_decode, resblock_tc_bf16=0)
        if on_card and counts != want:
            raise AssertionError(f"phase 21 (a): the trained model's decode launched {counts}, "
                                 f"expected {want}")
        err = float((w.cpu() - w_cpu).abs().max())
        res["trained_convert"] = dict(wave_max_abs_err=err,
                                      wav_absmax=float(w_cpu.abs().max()))
        if on_card:
            res["trained_convert"]["profile"] = profile_call(
                "the trained model's convert_batch 2 s (fp32, the CPU's f0)", run,
                res["trained_convert_wall_s"])
        log(f"  the trained {s['exported_pth']} converting 2 s in process: {counts} launches, "
            f"card against CPU on the CPU's f0 max abs {err:.3e} (|wav|max "
            f"{res['trained_convert']['wav_absmax']:.3f})")
        if not err <= 1e-3:
            raise AssertionError(f"phase 21 (a): card against CPU {err}")
        del pipes, pipe

    part("a trained convert", trained_convert)

    o, res["part_s"]["c A/B overlay (beside (a))"] = part("c A/B overlay, its wait after (a)",
                                                          overlay_run.result)
    pool.shutdown()
    res["overlay"] = {k: v for k, v in o.items() if k not in ("base", "variant")}
    arms = {k: o[k]["epoch_loss_g"] for k in ("base", "variant")}
    res["overlay"]["epoch_loss_g"] = arms
    log(f"  overlay ({o['env']}): loss_g per epoch base {arms['base']}, variant "
        f"{arms['variant']}; tail_delta {o['tail_delta']}, tail_rel {o['tail_rel']}, both "
        f"decreasing {o['both_decreasing']}; its own "
        f"{res['part_s']['c A/B overlay (beside (a))']:.1f} s")
    for k, v in arms.items():
        if len(v) != ab["epochs"] or not np.isfinite(v).all():
            raise AssertionError(f"phase 21 (c): the {k} arm's epochs {v}")
    if arms["base"][0] == arms["variant"][0]:
        raise AssertionError(f"phase 21 (c): the arms' first epoch loss_g are equal {arms}")

    # (b) the int8 gate on the trained .pth and one file of its corpus
    def on_arm(name, pipe, run):
        old = reset_counts(rb)
        q.conv1d_w8a8_ws_launches = q.conv1d_w8a8_launches = 0
        try:
            out = run()
            if on_card:
                torch.cuda.synchronize()
        finally:
            counts = reset_counts(rb, old)
        got = dict(zip(("resblock", "resblock_tc", "resblock_tc_bf16"), counts),
                   conv1d_w8a8_ws=q.conv1d_w8a8_ws_launches, conv1d_w8a8=q.conv1d_w8a8_launches)
        res["launches"][f"int8_gate_{name}"] = got
        want = (dict(resblock=per_decode, resblock_tc=0, resblock_tc_bf16=per_decode,
                     conv1d_w8a8_ws=0, conv1d_w8a8=0) if name == "bf16" else
                dict(resblock=narrow, resblock_tc=0, resblock_tc_bf16=narrow,
                     conv1d_w8a8_ws=w8a8_per_decode, conv1d_w8a8=0))
        if on_card and got != want:
            raise AssertionError(f"phase 21 (b): the {name} arm launched {got}, expected {want}")
        return out

    wav = os.path.join(wd, "dataset", "0", "s000.wav")
    g = res["int8_gate"] = part("b int8 gate", lambda: gate.rehearse(
        pth, wav, seconds=gate_s, device=device, nets=nets, on_arm=on_arm))
    for scope, r in g["scopes"].items():
        log(f"  int8 gate scope {scope} on the trained weights, {g['seconds']:.1f} s of "
            f"s000.wav: mel_l1 {r['mel_l1']:.6f}, mel_max {r['mel_max']:.4f}, snr_db "
            f"{r['snr_db']:.4f}, passes the gate (mel_l1 < 1.0) {r['passes_gate']}; launches "
            f"{res['launches'][f'int8_gate_{scope}']}")
    log(f"  bf16 arm launches {res['launches']['int8_gate_bf16']}")
    del nets

    # (d) the validator, --lenient, on links to files of earlier phases
    vd = os.path.join(d, "assets")
    res["validator_files"] = validator_dir(vd, work, exp, pth)
    log(f"  validator directory: {sorted(res['validator_files'])}")
    v = driven(res, "validator", lambda: part("d validator", lambda: vrw.validate(
        vd, lenient=True, device=device, printer=lambda line: log("    " + line))), device)
    res["validator"] = v
    status = {k: r["status"] for k, r in v["results"].items()}
    log(f"  validator: {status}; bf16_gate mel_l1 "
        f"{v['results']['bf16_gate'].get('mel_l1')}; summary {v['summary']}")
    if v["summary"]["fail"] or any(status.get(k) != "PASS" for k in TOOLS_PASS):
        raise AssertionError(f"phase 21 (d): validator {status}")
    log("  phase 21's parts, s: " + ", ".join(f"{k} {t:.1f}" for k, t in
                                              res["part_s"].items()) + f"; on {card}")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; no card", file=sys.stderr)
        return 1
    work = tempfile.mkdtemp(prefix="chip_smoke_")     # phases 7 and 12
    try:
        return run(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def run(work: str) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from rvc_maker_tpu_torch.ops import build
    from rvc_maker_tpu_torch.ops import resblock as rb

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    marks: list = []                  # (phase, its start), in the order they run

    def mark(phase):
        marks.append((phase, time.perf_counter()))

    mark(1)

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[1 device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    RESULTS["device"] = dict(name=name, nvidia_smi=smi, torch=torch.__version__,
                             cuda=torch.version.cuda)

    mark(2)
    t0 = time.perf_counter()
    # the host libraries' g++ (the WORLD F0 library, the FLAC decoder) alongside
    # the kernels' nvcc
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(lambda: [build.load_host(n) for n in build.HOST_SOURCES])
        logs = build.build_all()
        host.result()
    RESULTS["build_s"] = time.perf_counter() - t0
    RESULTS["build_s_by_source"] = dict(build.build_seconds)
    log(f"[2 build] {list(logs)} + worldlike + flacdec in {RESULTS['build_s']:.1f} s; each "
        "source's nvcc (and the WORLD library's and the FLAC decoder's g++, one after the "
        "other), all started together: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in build.build_seconds.items()))
    for src, text in logs.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")
    rows = resblock_ptxas_gate(logs)
    RESULTS["resblock_tc_ptxas"] = rows["resblock_tc"]
    RESULTS["resblock_tc_bf16_ptxas"] = rows["resblock_tc_bf16"]
    for src, src_rows in rows.items():
        log(f"  {src} per instantiation (C, k): registers, spill stores / loads in bytes: "
            + "; ".join(f"({e['C']}, {e['K']}) {e['registers']}, {e['spill_stores']} / "
                        f"{e['spill_loads']}" for e in src_rows))

    from rvc_maker_tpu_torch.config import preset
    from rvc_maker_tpu_torch.pipelines.convert import ConvertPipeline

    cfg = preset("v2", 48000).model
    shapes, t, c = [], ConvertPipeline.frames(16000 * 10), cfg.upsample_initial_channel
    for u in cfg.upsample_rates:
        t, c = t * u, c // 2
        shapes.append((2, c, t))
    mark(3)
    log(f"[3 kernels] resblock at the main path's stage shapes {shapes}")
    rows, totals = check_resblock(shapes, cfg.resblock_kernel_sizes,
                                  tuple(cfg.resblock_dilation_sizes[0]), smi)
    RESULTS["resblock"] = dict(rows=rows, totals=totals)

    mark(4)
    log("[4 main] building the v2-48k pipeline with random weights")
    model_cfg, model = random_model()
    RESULTS["main_path"] = main_path(model_cfg, model)

    mark(5)
    log("[5 parity] card against CPU")
    RESULTS["parity"] = card_vs_cpu(model_cfg, model)

    train_shapes, t, c = [], cfg.segment_size, cfg.upsample_initial_channel
    for u in cfg.upsample_rates:
        t, c = t * u, c // 2
        train_shapes.append((8, c, t))
    mark(6)
    log(f"[6 train-kernel] resblock forward and gradients at the training shapes {train_shapes}")
    RESULTS["train_kernel"] = check_resblock_train(
        train_shapes, cfg.resblock_kernel_sizes, tuple(cfg.resblock_dilation_sizes[0]), smi)

    mark(7)
    log("[7 train] preprocess -> extract -> train -> export -> convert at v2-48k")
    RESULTS["train"] = train_flow(model, smi, work)

    mark(8)
    log("[8 train-parity] one narrow train step, card against CPU")
    RESULTS["train_parity"] = train_parity()

    mark(9)
    log("[9 vocoders] f0-less, MRF-HiFi-GAN and RefineGAN conversion at v2-48k "
        f"({time.perf_counter() - t_start:.1f} s in)")
    RESULTS["vocoders"] = vocoders_phase(model, smi)

    mark(10)
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

    mark(11)
    log(f"[11 serve] the HTTP server on phase 4's model files, fp32 and bf16 "
        f"({time.perf_counter() - t_start:.1f} s in)")
    RESULTS["serve"] = serve_phase(model_cfg, model)

    mark(12)
    log(f"[12 train-all] every decoder and training mode, extract, the index build "
        f"({time.perf_counter() - t_start:.1f} s in)")
    RESULTS["train_all"] = train_all(model, work, smi)

    mark(13)
    log(f"[13 audio-tools] cli convert with a preset and FLAC, the noise gate, cli tts, "
        f"/api/tts and the host routes ({time.perf_counter() - t_start:.1f} s in)")
    RESULTS["audio_tools"] = audio_tools_phase(model_cfg, model, work)

    mark(14)
    shapes14 = w8a8_shapes(model_cfg)
    log(f"[14 int8] the W8A8 mode: csrc/conv1d_w8a8_ws.cu (the route) and csrc/conv1d_w8a8.cu "
        f"(its first version) at the int8 decode's {len(shapes14)} conv shapes, then the int8 "
        f"pipeline ({time.perf_counter() - t_start:.1f} s in)")
    rows14, tot14 = check_w8a8(shapes14, smi, logs.get("conv1d_w8a8_ws", ""))
    RESULTS["int8"] = dict(rows=rows14, totals=tot14,
                           pipeline=int8_phase(model_cfg, model, smi))
    torch.cuda.empty_cache()

    mark(15)
    log(f"[15 parallel] {PARALLEL_WORLD} ranks: train(), the sharded step, sharded conversion, "
        f"the sharded blend, tensor-parallel HuBERT ({time.perf_counter() - t_start:.1f} s in)")
    RESULTS["parallel"] = parallel_phase(work, smi)

    mark(16)
    log(f"[16 onnx] cli export-onnx and the .onnx voice model, embedder and RMVPE on the "
        f"card against their native routes ({time.perf_counter() - t_start:.1f} s in)")
    RESULTS["onnx"] = onnx_phase(model_cfg, model, work)

    mark(17)
    log(f"[17 separate] HTDemucs at full width and a stand-in MDX-Net graph through cli "
        f"separate, /api/separate and cli separate-music ({time.perf_counter() - t_start:.1f} "
        "s in)")
    RESULTS["separate"] = separate_phase(work)

    mark(18)
    log(f"[18 speaker] Whisper transcription, ECAPA-TDNN, cli diarize-convert and "
        f"/api/convert_whisper ({time.perf_counter() - t_start:.1f} s in)")
    RESULTS["speaker"] = speaker_phase(work, model_cfg, model)
    del model
    torch.cuda.empty_cache()

    mark(19)
    log(f"[19 edit] AudioLDM2 at the published widths: a 10 s edit, card against CPU, the "
        f"vocoder's resblocks on resblock_tc, cli edit and /api/audio_edit "
        f"({time.perf_counter() - t_start:.1f} s in)")
    RESULTS["edit"] = edit_phase(work, smi)

    mark(20)
    log(f"[20 spec-tools] cli create-dataset, ensemble_inputs, align_audio and the two-band "
        f"cmb_spectrogram_to_wave round trip ({time.perf_counter() - t_start:.1f} s in)")
    RESULTS["spec_tools"] = spec_tools_phase(work, RESULTS["separate"], smi)
    torch.cuda.empty_cache()

    mark(21)
    log(f"[21 tools] e2e_train (SIGTERM, hashed resume), the int8 gate on its trained weights, "
        f"the bf16-spec A/B overlay and the weights validator "
        f"({time.perf_counter() - t_start:.1f} s in)")
    RESULTS["tools"] = tools_phase(work, smi)
    mark(None)
    RESULTS["total_s"] = time.perf_counter() - t_start
    RESULTS["phase_s"] = {str(p): round(t1 - t0, 3)
                          for (p, t0), (_, t1) in zip(marks, marks[1:])}
    log("each phase's s: " + ", ".join(
        f"{p} {v:.1f}" for p, v in RESULTS["phase_s"].items()))
    log(f"done in {RESULTS['total_s']:.1f} s")

    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(RESULTS, f, indent=1)

    main, train, tk = RESULTS["main_path"], RESULTS["train"], RESULTS["train_kernel"]
    voc, serve, ta = RESULTS["vocoders"], RESULTS["serve"], RESULTS["train_all"]
    at = RESULTS["audio_tools"]
    i8p, i8t = RESULTS["int8"]["pipeline"], RESULTS["int8"]["totals"]
    runs, tkb = ta["runs"], ta["train_kernel_bf16"]["totals"]
    par_ranks = RESULTS["parallel"]["ranks"]
    edit = RESULTS["edit"]
    ev = edit["vocoder_kernels"]

    def sep_launches(kernel: str) -> int:
        """Phase 17's launches of a resblock kernel over its driven calls."""
        return sum(c[kernel] for c in RESULTS["separate"]["launches"].values())

    def spec_launches(kernel: str) -> int:
        """Phase 20's launches of a resblock kernel over its driven calls."""
        return sum(c[kernel] for c in RESULTS["spec_tools"]["launches"].values())

    tl = RESULTS["tools"]["launches"]
    gate_arms = [k for k in tl if k.startswith("int8_gate_") and k != "int8_gate_bf16"]

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
    # launches_train_*: phase 12's train() runs, each with its eval
    # sample's fp32 decode (36 resblock_tc; the bf16 runs' tc launches)
    kernels = [
        dict(name="resblock_tc", source="rvc_maker_tpu_torch/csrc/resblock_tc.cu",
             launches=main["resblock_tc_launches"], launches_train=train["resblock_tc_launches"],
             launches_f0less=voc["f0less"]["resblock_tc_launches"],
             launches_mrf=voc["mrf"]["resblock_tc_launches"],
             launches_refinegan=voc["refinegan"]["resblock_tc_launches"],
             launches_f0_methods={m: r["resblock_tc_launches"]
                                  for m, r in RESULTS["f0_methods"]["timing"].items()},
             launches_serve_fp32=serve["fp32"]["resblock_tc_launches"],
             launches_train_f0less=runs["f0less"]["launches_tc"],
             launches_train_mrf=runs["mrf"]["launches_tc"],
             launches_train_refinegan=runs["refinegan"]["launches_tc"],
             launches_train_bf16_eval_sample=runs["nsf_bf16"]["launches_tc"],
             launches_cli_convert=at["convert"]["launches"][1],
             launches_cli_tts=at["cli_tts_launches"][1],
             launches_serve_tts=at["serve_tts_launches"][1],
             # phase 15, each rank's own count
             launches_parallel_train_per_rank=[r["train"]["tc_launches"] for r in par_ranks],
             launches_parallel_step_per_rank=[r["step"]["tc_launches"] for r in par_ranks],
             launches_parallel_convert_per_rank=[r["convert"]["tc_launches"]
                                                 for r in par_ranks],
             # phase 16: the .onnx voice model runs its convs on cuDNN
             launches_onnx=RESULTS["onnx"]["resblock_launches"]["onnx"],
             # phase 17: separation runs no resblock (Demucs, MDX-Net)
             launches_separate=sep_launches("resblock_tc"),
             # phase 20: spec_tools and create_dataset run none either
             launches_spec_tools=spec_launches("resblock_tc"),
             # phase 18: 36 per diarized segment (fp32)
             launches_diarize_vad=RESULTS["speaker"]["launches"]["diarize_vad"]["resblock_tc"],
             launches_diarize_whisper=RESULTS["speaker"]["launches"]["diarize_whisper"][
                 "resblock_tc"],
             launches_api_convert_whisper=RESULTS["speaker"]["launches"][
                 "api_convert_whisper"]["resblock_tc"],
             # phase 19: the edit's one vocoder call, and its four kernel stages
             # (B = 1, 1,004 mel frames) timed beside the plain and cuDNN chains
             launches_edit=edit["launches"]["edit"]["resblock_tc"],
             # phase 21: the trained .pth's 2 s conversion, the validator's
             # fp32 forwards (synth_pth, bf16_gate's fp32 arm)
             launches_tools_trained_convert=tl["trained_convert"]["resblock_tc"],
             launches_validator=tl["validator"]["resblock_tc"],
             edit_vocoder=dict(ms=ev["ms"], plain_ms=ev["plain_ms"],
                               library_ms=ev["library_ms"], bound_ms=ev["bound_ms"],
                               bound_by=ev["bound_by"], max_abs_err=ev["max_abs_err"],
                               c512_plain_ms=ev["c512_plain_ms"],
                               c512_library_ms=ev["c512_library_ms"]),
             max_abs_err=totals["max_abs_err"], ms=totals["ms"], bound_ms=totals["bound_ms"],
             bound_by=totals["bound_by"], roofline_share=totals["bound_ms"] / totals["ms"],
             # per stage, in conversion (phase 3) and in the training forward
             # (phase 6): the times, the bound and the time tiles; ptxas's
             # registers and spills per instantiation (phase 2)
             stages=[{k: v for k, v in st.items() if not k.startswith("bf16")}
                     for st in totals["stages"]],
             train_stages=[{k: st[k] for k in ("B", "C", "T", "fwd_ms", "fma_fwd_ms",
                                               "plain_fwd_ms", "library_fwd_ms", "pack_ms",
                                               "fwd_bound_ms", "tiles")} for st in tk["rows"]],
             ptxas=RESULTS["resblock_tc_ptxas"],
             **common, **fp32),
        # the bf16 route, which the served bf16 path runs: its launches
        # there; fma_ms is resblock.cu's bf16 time, its earlier version
        dict(name="resblock_tc_bf16", source="rvc_maker_tpu_torch/csrc/resblock_tc_bf16.cu",
             launches=serve["bf16"]["resblock_tc_bf16_launches"],
             launches_serve_bf16=serve["bf16"]["resblock_tc_bf16_launches"],
             launches_train_bf16=runs["nsf_bf16"]["launches_tc_bf16"],
             launches_train_bf16_checkpointing=runs["nsf_bf16_ckpt"]["launches_tc_bf16"],
             launches_separate=sep_launches("resblock_tc_bf16"),
             launches_spec_tools=spec_launches("resblock_tc_bf16"),
             launches_edit=edit["launches"]["edit"]["resblock_tc_bf16"],
             # phase 21: the int8 gate's bf16 arm and its int8 arms (the
             # decode's C < 64 stages), the validator's bf16_gate
             launches_int8_gate_bf16=tl["int8_gate_bf16"]["resblock_tc_bf16"],
             launches_int8_gate_int8={k[len("int8_gate_"):]: tl[k]["resblock_tc_bf16"]
                                      for k in gate_arms},
             launches_validator=tl["validator"]["resblock_tc_bf16"],
             train_fwd_ms=tkb["fwd_ms"], train_fwd_bound_ms=tkb["bound_ms"],
             train_fwd_library_ms=tkb["library_fwd_ms"], train_fwd_plain_ms=tkb["plain_fwd_ms"],
             max_abs_err=totals["bf16_max_abs_err"], ms=totals["bf16_ms"],
             fma_ms=totals["bf16_fma_ms"],
             roofline_share=totals["bf16_bound_ms"] / totals["bf16_ms"],
             # per stage, in conversion (phase 3) and in the training forward
             # (phase 12a): the times, the bound and the time tiles; ptxas's
             # registers and spills per instantiation (phase 2)
             stages=[{k: st[k] for k in ("B", "C", "T", "bf16_ms", "bf16_library_ms",
                                         "bf16_plain_ms", "bf16_fma_ms", "bf16_bound_ms",
                                         "bf16_tiles")} for st in totals["stages"]],
             train_stages=[{k: st[k] for k in ("B", "C", "T", "fwd_ms", "library_fwd_ms",
                                               "plain_fwd_ms", "bound_ms", "bf16_tiles")}
                           for st in ta["train_kernel_bf16"]["rows"]],
             ptxas=RESULTS["resblock_tc_bf16_ptxas"], **common, **bf16),
        # resblock.cu, on no path (its launches on the main paths are 0):
        # its bf16 times, and its fp32 ones under fp32_*
        dict(name="resblock", source="rvc_maker_tpu_torch/csrc/resblock.cu",
             launches=main["resblock_launches"] - main["resblock_tc_launches"]
             + serve["bf16"]["resblock_fma_launches"],
             launches_serve_bf16=serve["bf16"]["resblock_fma_launches"],
             launches_main_fma=main["resblock_launches"] - main["resblock_tc_launches"],
             launches_separate=sep_launches("resblock") - sep_launches("resblock_tc")
             - sep_launches("resblock_tc_bf16"),
             launches_spec_tools=spec_launches("resblock") - spec_launches("resblock_tc")
             - spec_launches("resblock_tc_bf16"),
             launches_tools=sum(c["resblock"] - c["resblock_tc"] - c["resblock_tc_bf16"]
                                for c in tl.values()),
             max_abs_err=totals["bf16_fma_max_abs_err"], ms=totals["bf16_fma_ms"],
             fp32_ms=totals["fma_ms"], fp32_max_abs_err=totals["fma_max_abs_err"],
             fp32_plain_ms=totals["plain_ms"], fp32_library_ms=totals["library_ms"],
             **common, **bf16),
        # the int8 decode's W8A8 conv: its times summed over one decode's 54
        # convs; library_ms is cuDNN's bf16 F.conv1d on the same shapes.
        # conv1d_w8a8_ws is the route; conv1d_w8a8, its first version, is on
        # no route (0 launches on the main path), timed beside it
        dict(name="conv1d_w8a8_ws", route="cuda",
             source="rvc_maker_tpu_torch/csrc/conv1d_w8a8_ws.cu", replaces=W8A8_REPLACES,
             launches=i8p["rmvpe_int8"]["launches"]["conv1d_w8a8_ws"],
             launches_per_decode=i8p["launches_per_decode"]["conv1d_w8a8_ws"],
             launches_yin=i8p["yin_int8"]["launches"]["conv1d_w8a8_ws"],
             launches_decode_scope=i8p["rmvpe_int8_decode"]["launches"]["conv1d_w8a8_ws"],
             # phase 21: the int8 gate's arms on the trained weights, per scope
             launches_int8_gate={k[len("int8_gate_"):]: tl[k]["conv1d_w8a8_ws"]
                                 for k in gate_arms},
             max_abs_err=i8t["max_abs_err"], elements_differing=i8t["elements_differing"],
             ms=i8t["ms"], profiler_ms=i8t["prof_ms"],
             profiler_launches_seen=i8t["profiler_launches"]["seen_ws"],
             profiler_launches_made=i8t["profiler_launches"]["made"], plain_ms=i8t["plain_ms"],
             bound_ms=i8t["bound_ms"], bound_by=i8t["bound_by"],
             sum_bound_ms=i8t["sum_bound_ms"], library_ms=i8t["library_ms"],
             library_profiler_ms=i8t["prof_library_ms"],
             roofline_share=i8t["bound_ms"] / i8t["ms"],
             stages_ms={c: st["ms"] for c, st in i8t["stages"].items()},
             first_version_ms=i8t["old_ms"],
             library="cuDNN bf16 F.conv1d at the same shapes (PyTorch has no int8 conv)",
             tolerance="0 elements differing from the plain version (_int_mm)",
             routes={"cpu": "plain", "cuda bf16, C in " + str([64, 128, 256]): "conv1d_w8a8_ws"}),
        dict(name="conv1d_w8a8", route="cuda", source="rvc_maker_tpu_torch/csrc/conv1d_w8a8.cu",
             replaces=W8A8_REPLACES,
             launches=i8p["rmvpe_int8"]["launches"]["conv1d_w8a8"],
             launches_per_decode=i8p["launches_per_decode"]["conv1d_w8a8"],
             launches_int8_gate={k[len("int8_gate_"):]: tl[k]["conv1d_w8a8"]
                                 for k in gate_arms},
             max_abs_err=i8t["max_abs_err_first"], ms=i8t["old_ms"],
             profiler_ms=i8t["prof_old_ms"],
             profiler_launches_seen=i8t["profiler_launches"]["seen_old"],
             profiler_launches_made=i8t["profiler_launches"]["made"], plain_ms=i8t["plain_ms"],
             bound_ms=i8t["bound_ms"], bound_by=i8t["bound_by"],
             library_ms=i8t["library_ms"], roofline_share=i8t["bound_ms"] / i8t["old_ms"],
             stages_ms={c: st["old_ms"] for c, st in i8t["stages"].items()},
             library="cuDNN bf16 F.conv1d at the same shapes (PyTorch has no int8 conv)",
             tolerance="max abs vs the plain version (_int_mm) <= 1 bf16 ulp of |ref|max",
             routes={"cpu": "plain", "cuda": "none (conv1d_w8a8_ws is the route)"})]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
