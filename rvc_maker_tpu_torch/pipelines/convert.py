"""Voice conversion pipeline in PyTorch (the port's main path).

Counterpart of `rvc_maker_tpu/pipelines/convert.py`:

    audio16k (B, L) --> f0 --> HuBERT feats --> retrieval blend
        --> x2 frame repeat --> protect mix --> synthesizer.infer_any --> wav

The host keeps file I/O, the 48 Hz Butterworth high-pass, the split of
long audio at low-energy points, the reflect pads and the RMS mix.  The
device step runs eagerly on `device`; chunks of one bucket length form
a batch, microbatched by `max_device_batch`.

Every decoder of the JAX package converts: NSF-HiFiGAN, the plain
decoder of f0-less models, MRF-HiFi-GAN and RefineGAN
(`synthesizer.decoder_kind`).  An f0-less model gets no coarse pitch;
as in the JAX package, it still runs F0, whose f0 sets `protect`'s
unvoiced frames (the reference toolkit skips both for such models).

F0 methods: every one the JAX package runs.  On the device
(`device_f0`): rmvpe, rmvpe-legacy, yin, fcpe, fcpe-legacy.  On the host
(`host_f0_member`, JAX convert.py:652-751): dio (+ stonemask), harvest, swipe,
pm, pyin, crepe-<capacity> and mangio-crepe-<capacity> (CREPE's network
on the device, its Viterbi on the host), and hybrid[a+b+...], the
per-frame nanmedian of its members.  `f0_file` overwrites the contour
with an external one; `convert_split` converts the voiced pieces of a
silence-split utterance.

ONNX (JAX convert.py:142, :190, :379-402, :464-475, :509-534, :696): an
`interop.onnx_voice.OnnxVoiceModel` takes the synthesizer's place, an
`interop.onnx_embedder.OnnxEmbedder` HuBERT's, and an
`interop.onnx_run.OnnxGraph` RMVPE's, FCPE's or CREPE's (the reference's
--f0_onnx, `f0/onnx_predictor.py`).  Each graph runs on the pipeline's
device, fp32 whatever the compute dtype, and never in int8; a graph
loaded for another device raises.

Noise: the step takes the prior noise `z_noise` (B, p_len, inter) and
the decoder's noise, a dict laid out as `synthesizer.decoder_noise`
draws it; `convert_batch` draws both from its `torch.Generator` when
the caller gives none, so a caller can hold the random draws (and a
test can feed the exact draws of the JAX package).

Precision: `compute_dtype=None` runs fp32 (the parity path; the entry
points turn TF32 off on the card);
`torch.bfloat16` is the JAX package's bf16 mode, which the server runs
by default: the weights of the synthesizer, HuBERT, RMVPE and FCPE, the
index vectors, the features stage's audio and index rate, and the noise
are cast to bf16, while the mels, the F0 decodes, the sine sources and
CREPE stay fp32 and the waveform comes back fp32 (JAX convert.py:83-146,
:462-466, :508-547).  On the card bf16 resblocks run
`csrc/resblock_tc_bf16.cu` (`ops/resblock.py` `_route`).

int8 (JAX convert.py:118-363): in bf16 with RVC_TPU_INT8=1 the pipeline
quantizes the stages RVC_TPU_INT8_SCOPE names (default all; `ops/int8_conv.py`):
the decode's resblock convs at C >= 64 run the W8A8 kernel
`csrc/conv1d_w8a8_ws.cu` (the C < 64 stage stays on `resblock_tc_bf16`),
HuBERT's matmuls and RMVPE's deep convs `torch._int_mm`.  The weights
are quantized after the bf16 cast, so their fp32 scales stay fp32.  An
NSF model calibrates one activation scale per decode conv at
construction (`_int8_calibrate`; RVC_TPU_INT8_DYNAMIC=1 skips it,
RVC_TPU_INT8_CALIB_WAV calibrates on a user's audio) and RVC_TPU_INT8_AUDIT=1
audits the first real input against them (`audit_int8_scales`).  The
CLI has no bf16 mode, so it never quantizes; the server's bf16
pipelines do.

Profiling: with RVC_TPU_PROFILE=1 `convert_batch` logs each stage's
wall ms, fenced on the device (`utils/profiling.py`), as JAX
convert.py:874-927 does.

Sharded (`ConvertPipeline(sharded=True)`, JAX `mesh=`, convert.py:91-160,
:836-870): the rows of `convert_batch` split over the ranks of the
process group.  Every rank passes the same global batch; an uneven one
is padded by repeating its last row; each rank converts its rows on its
own card through the hand kernels (the JAX mesh path turns its Pallas
kernel off; the port has no reason to); the results are gathered on every
rank and the padding rows trimmed.  The noise is what one process would
draw for the whole batch, so the rows equal a single process's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
from typing import Any, Callable, Optional

import numpy as np
import torch
from scipy import signal as sp_signal
from torch.profiler import record_function

from ..config import ModelConfig
from ..device import resolve_device, tree_cat, tree_rows, tree_to
from ..f0 import onnx_predictor
from ..f0.common import NOTE_FREQS, autotune_f0, coarse_f0, shift_f0
from ..f0.yin import yin
from ..interop.onnx_embedder import OnnxEmbedder
from ..interop.onnx_run import OnnxGraph
from ..interop.onnx_voice import OnnxVoiceModel
from ..models import fcpe as fcpe_mod
from ..models import hubert as hubert_mod
from ..models import rmvpe as rmvpe_mod
from ..models import synthesizer as syn
from ..ops import int8_conv
from ..ops.int8_conv import Int8Ctx, Int8SiteMismatch
from ..ops.nn import cast_floats, interp_nearest_x2
from ..parallel import distributed as dist_mod
from ..parallel import mesh
from ..retrieval.index import retrieval_blend
from ..utils.audio import load_audio, resample
from ..utils.i18n import tr
from ..utils.profiling import profiling_enabled, stage_timer

logger = logging.getLogger(__name__)

SAMPLE_RATE = 16000
WINDOW = 160
# 48 Hz 5th-order Butterworth high-pass (reference convert.py:30)
_BH, _AH = sp_signal.butter(N=5, Wn=48, btype="high", fs=SAMPLE_RATE)

NoiseFn = Callable[[int, int], tuple[torch.Tensor, dict]]

DEVICE_F0 = ("rmvpe", "rmvpe-legacy", "yin", "fcpe", "fcpe-legacy")
# the torch.profiler range of each F0 stage; chip_smoke.py reads them
F0_RANGES = {"rmvpe": "convert.rmvpe", "rmvpe-legacy": "convert.rmvpe",
             "yin": "convert.yin", "fcpe": "convert.fcpe", "fcpe-legacy": "convert.fcpe"}
HOST_F0_RANGE = "convert.host_f0"
CREPE_RANGE = "convert.crepe"


def f0_members(method: str) -> list[str]:
    """The F0 methods `method` runs: itself, or a hybrid's members."""
    if method.startswith("hybrid["):
        return [m.strip() for m in method[len("hybrid["):-1].split("+")]
    return [method]


def device_f0(method: str, audio, params, *, rmvpe_int8: bool = False) -> torch.Tensor:
    """A device method on (B, L) 16 kHz audio on the device -> f0 (B,
    frames) Hz at pitch 0, no autotune (JAX `_f0_raw`).  params(name,
    method) gives the network `name`'s params ("rmvpe", "fcpe") and
    raises when they are not loaded; rmvpe_int8 runs RMVPE's deep convs
    in int8."""
    if method in ("rmvpe", "rmvpe-legacy"):
        kw = {"f0_min": 50.0, "f0_max": 1100.0} if method == "rmvpe-legacy" else {}
        p = params("rmvpe", method)
        if isinstance(p, OnnxGraph):
            return onnx_predictor.rmvpe_onnx_infer(p, audio, **kw)
        return rmvpe_mod.infer(p, audio, use_int8=rmvpe_int8, **kw)
    if method in ("fcpe", "fcpe-legacy"):
        p = params("fcpe", method)
        infer = onnx_predictor.fcpe_onnx_infer if isinstance(p, OnnxGraph) else fcpe_mod.infer
        return infer(p, audio, threshold=0.03, p_len=audio.shape[1] // WINDOW + 1)
    if method == "yin":
        return yin(audio, sr=SAMPLE_RATE, fmin=50.0, fmax=1100.0, hop_length=WINDOW)
    raise ValueError(f"unknown f0 method {method!r}")


def _crepe_probs(params, audio: np.ndarray, hop: int, device) -> np.ndarray:
    """CREPE's probabilities (1, T, 360) of one row, on the device."""
    from ..models import crepe as crepe_mod

    with record_function(CREPE_RANGE):
        x = torch.as_tensor(audio, device=device)
        if isinstance(params, OnnxGraph):
            return onnx_predictor.crepe_probs(params, x, hop).cpu().numpy()
        return crepe_mod.predict_probs(params, x, hop_length=hop).cpu().numpy()


def host_f0_member(method: str, row: np.ndarray, *, hop_length: int, params,
                   device, rmvpe_int8: bool = False) -> np.ndarray:
    """One F0 method on one 16 kHz row (L,) -> f0 Hz at the method's own
    frame rate, NaN where pyin and mangio-crepe find no pitch (JAX
    convert.py `_host_f0`'s member loop).  The host methods run on the
    host (CREPE's network on `device`, its Viterbi on the host); a device
    method (a hybrid's member) runs on `device` on this row alone.
    params(name, method) as `device_f0` takes it, "crepe" too; rmvpe_int8
    as `device_f0` takes it."""
    from ..models import crepe as crepe_mod

    m = method
    if m in ("dio", "harvest"):
        from ..f0 import world

        fn = world.harvest if m == "harvest" else world.dio
        f0, t = fn(row.astype(np.float64), SAMPLE_RATE, f0_floor=50.0,
                   f0_ceil=1100.0, frame_period=10.0)
        if m == "dio":
            f0 = world.stonemask(row.astype(np.float64), SAMPLE_RATE, t, f0)
        return f0
    if m == "swipe":
        from ..f0.swipe import swipe

        return swipe(row, SAMPLE_RATE, f0_floor=50.0, f0_ceil=1100.0)[0]
    if m == "pm":
        from ..f0.praat_ac import praat_ac

        return praat_ac(row, SAMPLE_RATE, f0_floor=50.0, f0_ceil=1100.0,
                        voicing_threshold=0.6)
    if m.startswith("mangio-crepe"):
        # reference convert.py:215-228: quantile normalization, the
        # settings' hop, Viterbi, NaN below 0.001 Hz
        x = row.astype(np.float32)
        x = x / np.quantile(np.abs(x), 0.999)
        probs = _crepe_probs(params("crepe", m), x[None], hop_length, device)
        f0 = crepe_mod.decode(probs, 50.0, 1100.0)[0]
        return np.where(f0 < 0.001, np.nan, f0)
    if m.startswith("crepe"):
        # reference convert.py:230-237: hop = window, mean(f0, 3),
        # median(periodicity, 3), gate at periodicity 0.1
        probs = _crepe_probs(params("crepe", m), row[None], WINDOW, device)
        f0, pd = crepe_mod.decode(probs, 50.0, 1100.0, return_periodicity=True)
        f0 = crepe_mod.mean_filter(f0, 3)
        pd = crepe_mod.median_filter(pd, 3)
        f0[pd < 0.1] = 0.0
        return f0[0]
    if m == "pyin":
        from ..f0.pyin import pyin

        f0 = pyin(row, SAMPLE_RATE, fmin=50.0, fmax=1100.0, hop_length=hop_length)[0]
        return np.where(f0 < 0.001, np.nan, f0)
    if m in DEVICE_F0:
        with record_function(F0_RANGES[m]):
            x = torch.as_tensor(row[None], device=device)
            return device_f0(m, x, params, rmvpe_int8=rmvpe_int8)[0].cpu().numpy()
    raise ValueError(f"unknown f0 method {m!r}")


def host_f0_row(method: str, row: np.ndarray, *, hop_length: int, params, device,
                extract_rule: bool = False, rmvpe_int8: bool = False) -> np.ndarray:
    """One row, one method or hybrid[...] -> float64 f0 Hz at len(row) //
    160 + 1 frames: each member resampled to that length (reference
    convert.py:299-300), a hybrid's members merged by their per-frame
    nanmedian, NaN set to 0 (convert.py:281), as JAX convert.py
    `_host_f0` does.  extract_rule is JAX extract.py `_host_f0_single`'s:
    each member's NaN set to 0 before the resampling and a hybrid's zeros
    taken as NaN before the median.  rmvpe_int8 reaches an RMVPE member."""
    p_len = len(row) // WINDOW + 1
    stack = []
    for m in f0_members(method):
        f0 = np.asarray(host_f0_member(m, row, hop_length=hop_length, params=params,
                                       device=device, rmvpe_int8=rmvpe_int8),
                        np.float64).ravel()
        if extract_rule:
            f0 = np.nan_to_num(f0)
        stack.append(np.interp(np.linspace(0, len(f0) - 1, p_len), np.arange(len(f0)), f0))
    if len(stack) == 1:
        return np.nan_to_num(stack[0])
    if extract_rule:
        stack = [np.where(f0 < 0.001, np.nan, f0) for f0 in stack]
    return np.nan_to_num(np.nanmedian(np.vstack(stack), axis=0))


@dataclasses.dataclass(frozen=True)
class ConvertSettings:
    """User-facing conversion knobs (reference convert.py CLI flags)."""

    pitch: int = 0                     # transpose, semitones
    index_rate: float = 0.0
    protect: float = 0.33
    f0_method: str = "rmvpe"           # module docstring: the methods
    f0_autotune: bool = False
    f0_autotune_strength: float = 1.0
    volume_envelope: float = 1.0       # RMS mix rate
    resample_sr: int = 0
    # chunk budget, seconds (reference x_pad/x_query/x_center/x_max)
    x_pad: int = 1
    x_query: int = 6
    x_center: int = 38
    x_max: int = 41
    filter_radius: int = 3             # carried; JAX reads it only for ONNX CREPE
    hop_length: int = 160              # mangio-crepe / pyin frame hop
    f0_file: str = ""                  # external "time,f0" contour file
    deterministic: bool = False        # draw from a fresh seed-0 generator


def _bucket_length(n: int, bucket: int = SAMPLE_RATE) -> int:
    """Round up to a whole bucket (default: 1 s of 16 kHz samples)."""
    return int(np.ceil(max(n, bucket) / bucket)) * bucket


class ConvertPipeline:
    """Model params on one device plus the conversion step."""

    def __init__(self, synth_params: Any, model_cfg: ModelConfig,
                 hubert_params: Any, version: str = "v2",
                 rmvpe_params: Any = None, fcpe_params: Any = None,
                 crepe_params: Any = None,
                 index_vectors: Optional[np.ndarray] = None,
                 max_device_batch: int = 8, device: str | torch.device = "cuda",
                 compute_dtype: torch.dtype | None = None,
                 int8_noise_fn: NoiseFn | None = None, sharded: bool = False):
        """Params are the port's trees (`interop.pth`, `interop.from_jax`,
        the models' `params_from_state_dict` / loaders); they are moved to
        `device` in fp32, then cast to `compute_dtype` when it is given
        (torch.bfloat16: the bf16 mode of the module docstring; CREPE's
        params and FCPE's cent table stay fp32).  Each F0 network's params
        are needed only by the methods that run it; a method whose params
        are missing raises when it is called.  device="cuda" raises when no
        card is present.

        fp32 on the card runs under the process's TF32 flags; the port's
        entry points (the server, the CLI) turn TF32 off
        (`device.use_full_fp32`).

        int8 (module docstring) is set up here from the environment.
        int8_noise_fn(b, p_len) -> (z_noise, decoder noise) supplies the
        calibration pass's noise (default: a generator on the device
        seeded 0), as `convert_utterance`'s noise_fn does.

        sharded: `convert_batch` splits its rows over the ranks of the
        process group that the environment describes (module docstring);
        "cuda" is then this rank's card (`rank_device`)."""
        if compute_dtype not in (None, torch.bfloat16):
            raise ValueError(f"compute_dtype must be None or torch.bfloat16, got {compute_dtype}")
        self.sharded = sharded
        if sharded:
            dist_mod.ensure_initialized(device)
            self.device = dist_mod.rank_device(device)
        else:
            self.device = resolve_device(device)
        self.cfg = model_cfg
        self.version = version
        self.max_device_batch = max_device_batch
        self.compute_dtype = compute_dtype
        f32 = torch.float32

        def prep(tree):
            if isinstance(tree, (OnnxGraph, OnnxVoiceModel, OnnxEmbedder)):
                if tree.device.type != self.device.type or (
                        None not in (tree.device.index, self.device.index)
                        and tree.device.index != self.device.index):
                    raise ValueError(f"an ONNX graph loaded for {tree.device} given to a "
                                     f"pipeline on {self.device}")
                return tree
            tree = tree_to(tree, self.device, f32)
            return tree if compute_dtype is None else cast_floats(tree, compute_dtype)

        self.synth_params = prep(synth_params)
        self.hubert_params = prep(hubert_params)
        self.rmvpe_params = prep(rmvpe_params)
        self.fcpe_params = prep(fcpe_params)
        if fcpe_params is not None and not isinstance(fcpe_params, OnnxGraph):
            # a decode table, not a weight
            self.fcpe_params["cent_table"] = tree_to(fcpe_params["cent_table"], self.device, f32)
        self.crepe_params = (prep(crepe_params) if isinstance(crepe_params, OnnxGraph)
                             else tree_to(crepe_params, self.device, f32))
        self.index_vectors = (None if index_vectors is None else
                              torch.as_tensor(np.asarray(index_vectors, np.float32),
                                              device=self.device).to(self.dtype))
        self.int8_noise_fn = int8_noise_fn
        self._int8_setup()

    # -- int8 (JAX convert.py:118-363) ------------------------------------

    def _int8_setup(self) -> None:
        """The stage flags from RVC_TPU_INT8 / RVC_TPU_INT8_SCOPE, the
        weights quantized after the bf16 cast (their scales stay fp32),
        and the decode's calibration for an NSF model.  A calibration
        that meets a divergent site (Int8SiteMismatch) falls back to
        dynamic scales; any other error, a kernel's build or launch
        among them, propagates."""
        on = int8_conv.int8_enabled(self.compute_dtype)
        scope = int8_conv.int8_scope() if on else frozenset()
        # an ONNX graph runs as it was exported, never in int8
        self.use_int8 = "decode" in scope and not isinstance(self.synth_params, OnnxVoiceModel)
        self.use_int8_hubert = ("hubert" in scope
                                and not isinstance(self.hubert_params, OnnxEmbedder))
        self.use_int8_rmvpe = "rmvpe" in scope and not isinstance(self.rmvpe_params, OnnxGraph)
        if self.use_int8 and syn.decoder_kind(self.cfg) in ("nsf", "plain"):
            self.synth_params = int8_conv.prequantize_decode(self.synth_params)
        if self.use_int8_hubert:
            self.hubert_params = int8_conv.prequantize_hubert(self.hubert_params)
        if self.use_int8_rmvpe:
            self.rmvpe_params = int8_conv.prequantize_rmvpe(self.rmvpe_params)
        if (self.use_int8 and syn.decoder_kind(self.cfg) == "nsf"
                and os.environ.get("RVC_TPU_INT8_DYNAMIC", "0") != "1"):
            try:
                self._int8_calibrate()
            except Int8SiteMismatch as e:
                logger.warning("%s", tr("int8_calibration_failed", e=e))
                self.use_int8 = Int8Ctx("dynamic")

    @staticmethod
    def _calibration_audio() -> np.ndarray:
        """(2, 1 s) of speech-like calibration audio (JAX
        `_calibration_audio`): formant-shaped glottal pulses on a
        120 -> 260 Hz glide with vibrato, and a chirp with noise bursts and
        clicks at 0.95, the wideband worst case.  RVC_TPU_INT8_CALIB_WAV
        names a user's audio instead: its two loudest 1 s windows."""
        path = os.environ.get("RVC_TPU_INT8_CALIB_WAV", "")
        if path:
            return _loudest_windows(np.asarray(load_audio(path, SAMPLE_RATE), np.float32))
        tt = np.arange(SAMPLE_RATE) / SAMPLE_RATE
        rng = np.random.default_rng(0)
        f0 = 120.0 * (260.0 / 120.0) ** tt * (1 + 0.03 * np.sin(2 * np.pi * 5 * tt))
        phase = np.cumsum(f0) / SAMPLE_RATE
        voiced = np.zeros(SAMPLE_RATE, np.float32)
        voiced[np.nonzero(np.diff(np.floor(phase)) > 0)[0]] = 1.0
        for fc, bw in ((700.0, 130.0), (1800.0, 160.0)):
            r = np.exp(-np.pi * bw / SAMPLE_RATE)
            a = [1.0, -2 * r * np.cos(2 * np.pi * fc / SAMPLE_RATE), r * r]
            voiced = sp_signal.lfilter([1.0], a, voiced)
        voiced = 0.9 * voiced / max(np.abs(voiced).max(), 1e-6)
        chirp = sp_signal.chirp(tt, 80.0, 1.0, 6000.0).astype(np.float32)
        burst_env = (np.sin(2 * np.pi * 4 * tt) > 0.6).astype(np.float32)
        noise = rng.standard_normal(SAMPLE_RATE).astype(np.float32)
        wide = 0.5 * chirp + 0.5 * burst_env * noise
        wide[::2000] += 1.0
        wide = 0.95 * wide / max(np.abs(wide).max(), 1e-6)
        return np.stack([voiced, wide]).astype(np.float32)

    def _int8_scale_pass(self, audio: np.ndarray):
        """(per-site scales with the margin, signatures) of one
        calibrate-mode pass over (B, L) audio through the real path: yin
        F0, features at index rate 0, the synthesizer at protect 0.5,
        noise from `int8_noise_fn` (JAX `_int8_scale_pass`).  The scales
        come to the host in one copy."""
        ctx = Int8Ctx("calibrate")
        with torch.inference_mode():
            a = torch.as_tensor(audio, device=self.device, dtype=torch.float32)
            lengths = torch.full((a.shape[0],), a.shape[1], dtype=torch.int64,
                                 device=self.device)
            settings = ConvertSettings(f0_method="yin", index_rate=0.0, protect=0.5)
            f0 = self._f0(a, settings)
            feats, feats0 = self._features(a, lengths, settings)
            p_len = min(a.shape[1] // WINDOW, feats.shape[1])
            if self.int8_noise_fn is not None:
                z, noise = self.int8_noise_fn(a.shape[0], p_len)
                z = torch.as_tensor(z, device=self.device).to(self.dtype)
                noise = self._noise_to_device(noise)
            else:
                z, noise = self.draw_noise(a.shape[0], p_len,
                                           torch.Generator(device=self.device).manual_seed(0))
            sid = torch.zeros(a.shape[0], dtype=torch.int64, device=self.device)
            self._synth(feats[:, :p_len], feats0[:, :p_len], f0[:, :p_len], lengths, sid,
                        settings.protect, z, noise, use_int8=ctx)
        return int8_conv.calibration_scales(ctx.collected, ctx.collected_sigs)

    def _int8_calibrate(self) -> None:
        """Record the decode's per-site scales on the calibration audio,
        then play them back: self.use_int8 becomes a static Int8Ctx."""
        scales, sigs = self._int8_scale_pass(self._calibration_audio())
        self.use_int8 = Int8Ctx("static", torch.as_tensor(scales, device=self.device), sigs)

    def audit_int8_scales(self, audio: np.ndarray) -> np.ndarray:
        """Each site's amax on real audio (its two loudest 1 s windows)
        over the calibrated scale; a warning when any exceeds 1 (int8
        clips there).  Returns the per-site ratios (JAX
        `audit_int8_scales`).  RVC_TPU_INT8_AUDIT=1 runs it on the first
        `convert_utterance` input."""
        baked = self.use_int8
        if not isinstance(baked, Int8Ctx) or baked.mode != "static":
            raise ValueError("audit requires a calibrated static Int8Ctx")
        observed, _ = self._int8_scale_pass(_loudest_windows(np.asarray(audio, np.float32)))
        ratio = observed / np.maximum(baked.scales.cpu().numpy(), 1e-12)
        hot = np.nonzero(ratio > 1.0)[0]
        if hot.size:
            logger.warning("%s", tr("int8_audit_hot", hot=int(hot.size), total=int(ratio.size),
                                    ratio=f"{float(ratio.max()):.2f}",
                                    site=int(ratio.argmax())))
        return ratio

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the networks and the decode run in."""
        return self.compute_dtype or torch.float32

    # -- the device step ------------------------------------------------

    def _params(self, name: str, method: str):
        p = getattr(self, f"{name}_params")
        if p is None:
            raise ValueError(f"{name}_params not loaded: f0 method {method!r} needs them")
        return p

    def _f0(self, audio, settings: ConvertSettings):
        """(B, L) on the device -> f0 (B, frames) on the device, shifted
        and autotuned; each stage in its own profiler range."""
        m = settings.f0_method
        if m in DEVICE_F0:
            with record_function(F0_RANGES[m]):
                f0 = shift_f0(device_f0(m, audio, self._params,
                                        rmvpe_int8=self.use_int8_rmvpe), settings.pitch)
                if settings.f0_autotune and settings.f0_autotune_strength > 0:
                    f0 = autotune_f0(f0, settings.f0_autotune_strength)
                return f0
        with record_function(HOST_F0_RANGE):
            # the host methods read the exact input the caller gave
            f0 = self._host_f0(m, audio.cpu().numpy(), settings)
            return torch.as_tensor(f0, device=self.device)

    def _host_f0(self, method: str, audio_batch: np.ndarray,
                 settings: ConvertSettings) -> np.ndarray:
        """F0 of the host methods and of hybrid[...] (reference convert.py
        get_f0 / get_f0_hybrid:283-323), row by row (`host_f0_row`), line
        for line as JAX `_host_f0`.  Returns (B, L // 160 + 1) float32 Hz,
        shifted and autotuned on the host."""
        out = np.stack([host_f0_row(method, row, hop_length=settings.hop_length,
                                    params=self._params, device=self.device,
                                    rmvpe_int8=self.use_int8_rmvpe)
                        for row in audio_batch]).astype(np.float32)
        out = out * (2.0 ** (settings.pitch / 12.0))
        if settings.f0_autotune:
            nearest = NOTE_FREQS[np.argmin(np.abs(out[..., None] - NOTE_FREQS), axis=-1)]
            out = out + (nearest - out) * settings.f0_autotune_strength
        return out

    def _features(self, audio, lengths, settings: ConvertSettings):
        # the audio and the index rate in the compute dtype (JAX
        # convert.py:462-466); the F0 stage has read the fp32 audio
        audio = audio.to(self.dtype)
        index_rate = float(torch.tensor(settings.index_rate, dtype=self.dtype))
        if isinstance(self.hubert_params, OnnxEmbedder):
            # the graph holds the v1 projection; it runs in fp32
            feats = self.hubert_params.features(audio.to(torch.float32),
                                                lengths).to(self.dtype)
        else:
            feats, _ = hubert_mod.extract_features(
                self.hubert_params, audio, lengths,
                output_layer=12 if self.version == "v2" else 9, use_int8=self.use_int8_hubert)
            if self.version == "v1":
                feats = hubert_mod.final_proj(self.hubert_params, feats)
        feats0 = feats
        if self.index_vectors is not None and settings.index_rate > 0:
            feats = retrieval_blend(feats, self.index_vectors, index_rate)
        return interp_nearest_x2(feats), interp_nearest_x2(feats0)

    def _synth(self, feats, feats0, f0, lengths, sid, protect, z_noise, noise,
               use_int8=None):
        """The synthesizer on the features; use_int8 (default the
        pipeline's own) reaches the decode."""
        p_len = feats.shape[1]
        pitchf = f0[:, :p_len]
        pitch = coarse_f0(pitchf) if self.cfg.use_f0 else None
        if protect < 0.5:
            # restore the original features on unvoiced frames; the fp32
            # weights cast to the features' dtype, as JAX does
            pitchff = torch.where(pitchf > 0, 1.0, protect)[:, :, None]
            feats = (feats * pitchff.to(feats.dtype)
                     + feats0 * (1.0 - pitchff).to(feats.dtype))
        frame_lengths = torch.clamp(
            torch.div(lengths, WINDOW, rounding_mode="floor"), max=p_len)
        if isinstance(self.synth_params, OnnxVoiceModel):
            # the graph on the same noise as the params would take, in fp32
            f32 = torch.float32
            sine = noise.get("sine")
            wav = self.synth_params.synth(
                feats.to(f32), frame_lengths, pitch, pitchf, sid, z_noise.to(f32),
                None if sine is None else sine.to(f32))
            return wav.to(f32), pitchf
        wav = syn.infer_any(self.synth_params, self.cfg, feats, frame_lengths,
                            pitch, pitchf, sid, z_noise, noise,
                            use_int8=self.use_int8 if use_int8 is None else use_int8)
        return wav[:, :, 0].to(torch.float32), pitchf

    def draw_noise(self, b: int, p_len: int, generator: torch.Generator):
        """(z_noise (b, p_len, inter), the decoder's noise dict), drawn in
        that order from `generator` on its device, in the compute dtype
        (JAX convert.py:544-547; `rand_ini` fp32)."""
        z = self._draw_z(b, p_len, generator)
        return z, syn.decoder_noise(self.cfg, b, p_len, generator, generator.device,
                                    self.dtype)

    def _draw_z(self, b: int, p_len: int, generator: torch.Generator):
        return torch.randn((b, p_len, self.cfg.inter_channels), generator=generator,
                           device=generator.device, dtype=self.dtype)

    def _noise_to_device(self, noise: dict) -> dict:
        """The decoder's noise on the device in the compute dtype, its
        uniform `rand_ini` phases in fp32."""
        out = tree_to(noise, self.device, self.dtype)
        if "rand_ini" in noise:
            out["rand_ini"] = torch.as_tensor(noise["rand_ini"]).to(self.device, torch.float32)
        return out

    @staticmethod
    def frames(n_samples: int) -> int:
        """p_len of a bucket of n_samples: min(L // 160, feature frames),
        the features being HuBERT's 50 Hz frames repeated twice."""
        feat = hubert_mod.frame_lengths(torch.tensor(n_samples)).item()
        return min(n_samples // WINDOW, 2 * int(feat))

    @torch.inference_mode()
    def convert_batch(self, audio_batch, lengths, sid: int,
                      settings: ConvertSettings, *, z_noise=None,
                      noise: dict | None = None,
                      generator: torch.Generator | None = None):
        """audio_batch: (B, L) float32 at 16 kHz, padded to one bucket;
        lengths: (B,) valid samples.  Returns (wav (B, p_len * upp),
        pitchf (B, p_len)) on the pipeline's device, p_len =
        min(L // 160, feature frames).

        z_noise and the decoder's `noise` (`synthesizer.decoder_noise`'s
        layout) cover the whole batch; what is absent is drawn per
        microbatch from `generator` (default, and always with
        settings.deterministic: a fresh one seeded 0), z before the
        decoder's noise as in `draw_noise`.  Given noise is cast to the
        compute dtype.  settings.f0_file overwrites the f0 after the F0
        stage (`_apply_f0_file`).  The waveform is fp32 in both modes.
        A sharded pipeline converts its rank's rows (module docstring)."""
        if generator is None or settings.deterministic:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if self.sharded and dist_mod.process_count() > 1:
            return self._convert_sharded(audio_batch, lengths, sid, settings, z_noise,
                                         noise, generator)
        return self._convert_rows(audio_batch, lengths, sid, settings, z_noise, noise,
                                  generator)

    def _convert_sharded(self, audio_batch, lengths, sid, settings, z_noise, noise,
                         generator):
        """This rank's rows of the batch padded to a multiple of the ranks,
        on the noise one process draws for the whole batch (microbatch by
        microbatch, z first), then every rank's results gathered through
        an all-reduce of a zero-filled buffer (gloo has no CUDA
        all_gather) and the padding rows trimmed."""
        audio = np.asarray(audio_batch.cpu() if isinstance(audio_batch, torch.Tensor)
                           else audio_batch, np.float32)
        lengths = np.asarray(lengths.cpu() if isinstance(lengths, torch.Tensor) else lengths)
        b, L = audio.shape
        p_len = self.frames(L)
        zs, dns = [], []
        for lo in range(0, b, self.max_device_batch):
            n = min(self.max_device_batch, b - lo)
            if z_noise is None:
                zs.append(self._draw_z(n, p_len, generator))
            if noise is None:
                dns.append(syn.decoder_noise(self.cfg, n, p_len, generator, generator.device,
                                             self.dtype))
        z_noise = torch.cat(zs) if z_noise is None else z_noise
        noise = tree_cat(dns) if noise is None else noise
        world = dist_mod.process_count()
        order = mesh.pad_rows(np.arange(b), world)
        mine = torch.as_tensor(order[mesh.rows_of(len(order))])
        wav, pitchf = self._convert_rows(
            audio[mine.numpy()], lengths[mine.numpy()], sid, settings,
            tree_rows(z_noise, mine), tree_rows(noise, mine), generator)
        return (mesh.all_gather_rows(wav, len(order))[:b],
                mesh.all_gather_rows(pitchf, len(order))[:b])

    def _convert_rows(self, audio_batch, lengths, sid, settings, z_noise, noise, generator):
        """`convert_batch` on this device, microbatched."""
        audio = torch.as_tensor(np.asarray(audio_batch, np.float32)
                                if not isinstance(audio_batch, torch.Tensor)
                                else audio_batch, device=self.device,
                                dtype=torch.float32)
        lengths = torch.as_tensor(np.asarray(lengths) if not isinstance(
            lengths, torch.Tensor) else lengths, device=self.device,
            dtype=torch.int64)
        b_total = audio.shape[0]
        mdb = self.max_device_batch
        prof = profiling_enabled()

        def timed(name):
            return stage_timer(name, self.device) if prof else contextlib.nullcontext()

        wavs, pitchfs = [], []
        for lo in range(0, b_total, mdb):
            hi = min(lo + mdb, b_total)
            a, ln = audio[lo:hi], lengths[lo:hi]
            # named ranges: a torch.profiler trace sums each stage's
            # device time under them (chip_smoke.py reads them); the F0
            # stage's range is set by its method, in `_f0`
            with timed(f"f0:{settings.f0_method}"):
                f0 = self._f0(a, settings)
                if settings.f0_file:
                    f0 = torch.as_tensor(_apply_f0_file(f0.cpu().numpy(), settings),
                                         device=self.device)
            with timed("features"), record_function("convert.hubert_retrieval"):
                feats, feats0 = self._features(a, ln, settings)
            p_len = min(a.shape[1] // WINDOW, feats.shape[1])
            # only the noise the caller did not give is drawn, z first
            if z_noise is None:
                zn = self._draw_z(hi - lo, p_len, generator).to(self.device)
            else:
                zn = torch.as_tensor(z_noise, device=self.device)[lo:hi].to(self.dtype)
            if noise is None:
                dn = self._noise_to_device(syn.decoder_noise(
                    self.cfg, hi - lo, p_len, generator, generator.device, self.dtype))
            else:
                dn = self._noise_to_device(tree_rows(noise, slice(lo, hi)))
            sid_t = torch.full((hi - lo,), sid, dtype=torch.int64,
                               device=self.device)
            with timed("synth"), record_function("convert.synthesizer"):
                wav, pitchf = self._synth(feats[:, :p_len], feats0[:, :p_len],
                                          f0[:, :p_len], ln, sid_t,
                                          settings.protect, zn, dn)
            wavs.append(wav)
            pitchfs.append(pitchf)
        return torch.cat(wavs, 0), torch.cat(pitchfs, 0)

    # -- one utterance (reference VC.pipeline) ---------------------------

    def convert_utterance(self, audio16k: np.ndarray, sid: int,
                          settings: ConvertSettings, *,
                          noise_fn: NoiseFn | None = None) -> np.ndarray:
        """One utterance with the reference's chunking and padding
        (convert.py:388-458).  Returns the waveform at the model's rate.

        noise_fn(b, p_len) -> (z_noise, decoder noise), when given, supplies
        each chunk's noise; otherwise every chunk draws from a generator
        seeded 0, as the JAX pipeline draws every chunk from PRNGKey(0).
        With RVC_TPU_INT8_AUDIT=1 the first input that is not silence is
        audited against the calibrated scales first (`audit_int8_scales`)."""
        s = settings
        if (os.environ.get("RVC_TPU_INT8_AUDIT", "0") == "1"
                and not getattr(self, "_int8_audited", False)
                and getattr(self.use_int8, "mode", None) == "static"
                and np.abs(audio16k).max() > 1e-6):
            self._int8_audited = True
            self.audit_int8_scales(audio16k)
        tgt_sr = self.cfg.sr
        t_pad = SAMPLE_RATE * s.x_pad
        t_pad_tgt = tgt_sr * s.x_pad
        t_pad2 = t_pad * 2
        t_query = SAMPLE_RATE * s.x_query
        t_center = SAMPLE_RATE * s.x_center
        t_max = SAMPLE_RATE * s.x_max

        audio = sp_signal.filtfilt(_BH, _AH, audio16k).astype(np.float32)
        opt_ts = []
        audio_pad = np.pad(audio, (WINDOW // 2, WINDOW // 2), mode="reflect")
        if audio_pad.shape[0] > t_max:
            audio_sum = np.zeros_like(audio)
            for i in range(WINDOW):
                audio_sum += audio_pad[i : i - WINDOW]
            for t in range(t_center, audio.shape[0], t_center):
                w = np.abs(audio_sum[t - t_query : t + t_query])
                opt_ts.append(t - t_query + int(np.where(w == w.min())[0][0]))

        audio_pad = np.pad(audio, (t_pad, t_pad), mode="reflect")
        bounds = []
        sstart = 0
        tcur = None
        for t in opt_ts:
            tcur = t // WINDOW * WINDOW
            bounds.append((sstart, tcur + t_pad2 + WINDOW))
            sstart = tcur
        bounds.append((sstart if tcur is not None else 0, audio_pad.shape[0]))

        pieces = []
        for lo, hi in bounds:
            chunk = audio_pad[lo:hi]
            L = _bucket_length(len(chunk))
            padded = np.zeros((1, L), np.float32)
            padded[0, : len(chunk)] = chunk
            z_noise = noise = None
            if noise_fn is not None:
                z_noise, noise = noise_fn(1, self.frames(L))
            wav, _ = self.convert_batch(padded, np.asarray([len(chunk)]), sid,
                                        s, z_noise=z_noise, noise=noise)
            wav = wav[0].cpu().numpy()
            n_out = min((len(chunk) // WINDOW) * self.cfg.upp, wav.shape[0])
            pieces.append(wav[:n_out][t_pad_tgt:-t_pad_tgt]
                          if n_out > 2 * t_pad_tgt else wav[:n_out])
        out = np.concatenate(pieces) if len(pieces) > 1 else pieces[0]

        if s.volume_envelope != 1.0:
            out = change_rms(audio, SAMPLE_RATE, out, tgt_sr, s.volume_envelope)
        peak = np.abs(out).max() / 0.99
        if peak > 1:
            out = out / peak
        if s.resample_sr not in (0, tgt_sr) and s.resample_sr >= SAMPLE_RATE:
            out = resample(out, tgt_sr, s.resample_sr)
        return out.astype(np.float32)


def _loudest_windows(audio: np.ndarray) -> np.ndarray:
    """The two loudest 1 s windows (2, 16000) of 16 kHz audio, zero-padded
    to 2 s first (JAX `_calibration_audio`, `audit_int8_scales`)."""
    audio = audio.reshape(-1)
    if audio.size < 2 * SAMPLE_RATE:
        audio = np.pad(audio, (0, 2 * SAMPLE_RATE - audio.size))
    win = audio[:audio.size - audio.size % SAMPLE_RATE].reshape(-1, SAMPLE_RATE)
    order = np.argsort((win ** 2).sum(axis=1))[::-1]
    return np.ascontiguousarray(win[order[:2]])


SPLIT_DB_THRESH = -60
SPLIT_MIN_INTERVAL_MS = 500


def _apply_f0_file(f0: np.ndarray, settings: ConvertSettings) -> np.ndarray:
    """Overwrite the contour with an external "time,f0" file (reference
    convert.py:314-316): its values interpolated to 100 frames/s, written
    from the end of the x_pad reflect pad on."""
    with open(settings.f0_file) as f:
        rows = [[float(v) for v in line.split(",")]
                for line in f.read().strip().split("\n") if line.strip()]
    inp = np.asarray(rows, np.float32)
    tf0 = SAMPLE_RATE // WINDOW                          # 100 frames/s
    n = int(np.round((inp[:, 0].max() - inp[:, 0].min()) * tf0 + 1))
    replace = np.interp(np.arange(n), inp[:, 0] * tf0, inp[:, 1])
    start = settings.x_pad * tf0
    stop = min(start + len(replace), f0.shape[1])
    out = np.array(f0)
    out[:, start:stop] = replace[: stop - start]
    return out


def convert_split(pipe: ConvertPipeline, audio16k: np.ndarray, sid: int,
                  settings: ConvertSettings, *,
                  noise_fn: NoiseFn | None = None) -> np.ndarray:
    """split_audio mode (reference convert.py:497-510): silence-cut the
    utterance, convert each voiced piece with `convert_utterance`, and
    put the pieces back at their positions scaled to the model's rate,
    silence in the gaps."""
    from .preprocess import cut_with_positions, restore_positions

    chunks = cut_with_positions(audio16k, SAMPLE_RATE, db_thresh=SPLIT_DB_THRESH,
                                min_interval_ms=SPLIT_MIN_INTERVAL_MS)
    scale = pipe.cfg.sr / SAMPLE_RATE
    converted = []
    for chunk, start, _ in chunks:
        out = pipe.convert_utterance(chunk, sid, settings, noise_fn=noise_fn)
        converted.append((int(start * scale), int(start * scale) + len(out), out))
    return restore_positions(converted, int(len(audio16k) * scale))


def _frame_rms(x: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    """Center-padded frame RMS (librosa.feature.rms numerics)."""
    pad = frame_length // 2
    xp = np.pad(x.astype(np.float64), (pad, pad))
    n = 1 + (len(xp) - frame_length) // hop_length
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)[None, :]
    return np.sqrt(np.mean(np.square(xp[idx]), axis=1))


def _upsample_linear(v: np.ndarray, t: int) -> np.ndarray:
    """Linear resample to t samples, half-pixel coordinates, as the
    reference's F.interpolate(mode="linear", align_corners=False)."""
    x = torch.from_numpy(np.ascontiguousarray(v, np.float32))[None, None]
    return torch.nn.functional.interpolate(x, size=t, mode="linear").numpy()[0, 0]


def change_rms(source: np.ndarray, source_sr: int, target: np.ndarray,
               target_sr: int, rate: float) -> np.ndarray:
    """RMS volume-envelope mix (reference convert.py:150-152)."""
    rms1 = _frame_rms(source, source_sr // 2 * 2, source_sr // 2)
    rms2 = _frame_rms(target, target_sr // 2 * 2, target_sr // 2)
    t = len(target)
    x1 = _upsample_linear(rms1, t)
    x2 = np.maximum(_upsample_linear(rms2, t), 1e-6)
    return (target * (np.power(x1, 1 - rate) * np.power(x2, rate - 1))).astype(np.float32)
