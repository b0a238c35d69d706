"""W8A8 int8 inference mode: the decode's resblock convs, HuBERT's
matmuls and RMVPE's deep U-Net convs in int8.

Counterpart of `rvc_maker_tpu/ops/int8_conv.py`.  Switched on by
RVC_TPU_INT8=1, only in the bf16 mode (`int8_enabled`), and only where
an inference entry point threads `use_int8` (`ConvertPipeline`): the
rounding has zero gradient, so no training path takes it.

  * weights: symmetric int8 per output channel, scale amax / 127,
    quantized once at pipeline construction (`prequantize_decode`,
    `prequantize_hubert`, `prequantize_rmvpe`); the scales stay fp32.
  * activations: symmetric int8, round(x / scale) half to even (as
    jnp.round), clipped to +-127.  The decode's convs take one scale per
    tensor, recorded per conv site by a calibration pass (`Int8Ctx`
    "calibrate", played back by "static") or computed per call
    ("dynamic"); HuBERT's matmuls one per token; RMVPE's convs one per
    tensor, per call.
  * products accumulate exactly in int32; the epilogue is
    float(acc) * (a_scale * w_scale) + b, in that order.

The decode's W8A8 dilated conv (`conv1d_w8a8`) is a hand-written kernel
on the card, `csrc/conv1d_w8a8_ws.cu` (int8 `mma.sync.m16n8k32` on
`ldmatrix` fragments, weight-stationary persistent blocks, asynchronous
input windows), with the resblock's leaky ReLU fused into its prologue
and the residual add into its epilogue.  Its first version,
`csrc/conv1d_w8a8.cu`, computes the same function on no route;
`conv1d_w8a8_kernel` launches either by name, for timing.  The JAX package computes it in XLA
(`lax.conv_general_dilated` with an int32 result): it is not a Pallas
kernel, but PyTorch has no int8 convolution on CUDA.  A CPU tensor takes
`_conv1d_w8a8_plain` (an im2col and `torch._int_mm`); a CUDA tensor
launches the kernel or raises.  `linear_w8a8` and `conv2d_w8a8` are
plain int8 matrix products (`torch._int_mm`, over an im2col for the 3x3
conv), as the JAX package leaves them to XLA.

Layouts are the port's: (B, C, T) activations; the decode's packed
resblock weights (D, k, C_in, C_out) quantize over (k, C_in) per C_out
and keep their codes as (D, k, C_out, C_in) for the kernel; linear
weights (C_out, C_in); conv2d weights (C_out, C_in, 3, 3).
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading

import numpy as np
import torch
import torch.nn.functional as F
from torch._C._profiler import _RecordFunctionFast

from . import build

logger = logging.getLogger(__name__)

LRELU_SLOPE = 0.1
SUPPORTED_C = (64, 128, 256)      # widths the W8A8 kernels take
SUPPORTED_K = (3, 7, 11)
MAX_DILATION = 5
DECODE_MIN_C = 64                  # the decode's int8 gate (JAX `_resblock`)
RMVPE_INT8_MIN_CIN = 128
CALIBRATION_MARGIN = 1.05

# kernel launches since the last reset: the route's kernel and the first
# version, on no route
conv1d_w8a8_ws_launches = 0
conv1d_w8a8_launches = 0

ROUTE_KERNEL = "conv1d_w8a8_ws"
KERNELS = ("conv1d_w8a8_ws", "conv1d_w8a8")

# csrc/conv1d_w8a8_ws.cu's tiles per (C, K): (MB output channels per block,
# TN time columns per tile, NB bf16 window buffers, CL: 0 for warps split
# into a quantize group and an MMA group, 1 for all warps on each phase,
# C / MB for a cluster of blocks sharing one int8 window); its `dispatch`
# table
WS_TILES = {**{(64, k): (64, 256, 2, 0) for k in SUPPORTED_K},
            (128, 3): (128, 128, 2, 1), (128, 7): (128, 64, 2, 0), (128, 11): (64, 128, 1, 0),
            (256, 3): (64, 128, 2, 4), (256, 7): (64, 64, 2, 4), (256, 11): (32, 128, 2, 8)}
MAX_SMEM = 232448                  # bytes a block may use on sm_90


def int8_enabled(dtype) -> bool:
    """RVC_TPU_INT8=1 and the bf16 mode: the fp32 path never quantizes."""
    return os.environ.get("RVC_TPU_INT8", "0") == "1" and dtype == torch.bfloat16


def int8_scope() -> frozenset:
    """The stages RVC_TPU_INT8=1 quantizes: all by default, or the
    subset RVC_TPU_INT8_SCOPE=decode,hubert,rmvpe names.  An unknown token
    is warned about (a typo would otherwise drop the stage meant)."""
    s = os.environ.get("RVC_TPU_INT8_SCOPE", "all").strip()
    known = frozenset({"decode", "hubert", "rmvpe"})
    if s in ("", "all"):
        return known
    toks = frozenset(x.strip() for x in s.split(",") if x.strip())
    unknown = toks - known
    if unknown:
        logger.warning("RVC_TPU_INT8_SCOPE: unknown stage(s) %s ignored (known: %s)",
                       sorted(unknown), sorted(known))
    return toks


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

def _quantize(w, dims):
    """Symmetric per-channel int8 over `dims`: (codes, fp32 scales with
    `dims` reduced away)."""
    w = w.to(torch.float32)
    scale = torch.clamp(w.abs().amax(dim=dims, keepdim=True), min=1e-8) / 127.0
    w_q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_q, scale.squeeze(dims)


def quantize_weight(w):
    """(..., k, C_in, C_out) conv weights -> (int8 codes in that layout,
    (..., C_out) fp32 scales): JAX `quantize_weight` per conv."""
    return _quantize(w, (-3, -2))


def quantize_linear_weight(w):
    """(..., C_out, C_in) linear weights -> (int8 codes, (..., C_out)
    scales): JAX `quantize_linear_weight` on the transposed layout."""
    return _quantize(w, (-1,))


def quantize_conv2d_weight(w):
    """(C_out, C_in, kh, kw) -> (int8 codes, (C_out,) scales): JAX
    `quantize_conv2d_weight` on HWIO."""
    return _quantize(w, (1, 2, 3))


def activation_scale(x):
    """max(amax |x|, 1e-8) / 127 over the whole tensor, fp32, on x's device."""
    return torch.clamp(x.to(torch.float32).abs().amax(), min=1e-8) / 127.0


def _quantize_act(x, a_scale):
    """round(x_f32 / a_scale), clipped to +-127, as int8: a division, as
    JAX does (a reciprocal multiply rounds otherwise)."""
    return torch.clamp(torch.round(x.to(torch.float32) / a_scale), -127, 127).to(torch.int8)


def lrelu(x):
    """The int8 route's leaky ReLU, in x's dtype as JAX's: the slope is a
    value of that dtype (bf16: 0.10009765625), the product rounded to it."""
    return torch.where(x >= 0, x, x * torch.tensor(LRELU_SLOPE, dtype=x.dtype, device=x.device))


def _int_mm(a, w_q):
    """(M, K) int8 @ (N, K) int8 transposed -> (M, N) int32, exact.  On
    the card `torch._int_mm` wants more than 16 rows (K and N multiples
    of 8): a short input is padded with zero rows."""
    m = a.shape[0]
    if m <= 16:
        a = F.pad(a, (0, 0, 0, 17 - m))
    return torch._int_mm(a.contiguous(), w_q.t())[:m]


# ---------------------------------------------------------------------------
# the decode's W8A8 dilated conv: kernel and plain version
# ---------------------------------------------------------------------------

def _conv1d_w8a8_plain(x, w_q, w_scale, b, a_scale, *, dilation: int, apply_lrelu: bool,
                       residual):
    """The kernel's plain version: quantize, im2col, `torch._int_mm`."""
    if apply_lrelu:
        x = lrelu(x)
    bsz, c_in, t = x.shape
    k, c_out, _ = w_q.shape
    pad = (k - 1) * dilation // 2
    xq = F.pad(_quantize_act(x, a_scale), (pad, pad))
    cols = xq.unfold(2, (k - 1) * dilation + 1, 1)[..., ::dilation]     # (B, C_in, T, k)
    cols = cols.permute(0, 2, 3, 1).reshape(bsz * t, k * c_in)
    acc = _int_mm(cols, w_q.permute(1, 0, 2).reshape(c_out, k * c_in))
    y = acc.to(torch.float32) * (a_scale * w_scale)
    if b is not None:
        y = y + b.to(torch.float32)
    y = y.reshape(bsz, t, c_out).transpose(1, 2).to(x.dtype)
    return y if residual is None else y + residual


def _check_conv(x, w_q, w_scale, b, a_scale, dilation, residual):
    if x.dim() != 3 or x.dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bf16 (B, C, T), got {x.dtype} {tuple(x.shape)}")
    bsz, c, t = x.shape
    k = w_q.shape[0]
    if c not in SUPPORTED_C or k not in SUPPORTED_K or tuple(w_q.shape) != (k, c, c):
        raise ValueError(f"the kernel takes C in {SUPPORTED_C}, k in {SUPPORTED_K} and "
                         f"w_q (k, C, C); got x C={c}, w_q {tuple(w_q.shape)}")
    if not 1 <= dilation <= MAX_DILATION:
        raise ValueError(f"the kernel takes dilations 1..{MAX_DILATION}, got {dilation}")
    if w_q.dtype != torch.int8 or w_scale.dtype != torch.float32 or a_scale.dtype != torch.float32:
        raise ValueError("w_q must be int8, w_scale and a_scale fp32")
    if tuple(w_scale.shape) != (c,) or a_scale.numel() != 1:
        raise ValueError("w_scale must be (C,) and a_scale one value")
    if b is None or tuple(b.shape) != (c,) or b.dtype != torch.bfloat16:
        raise ValueError("the kernel takes a bf16 bias (C,)")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype):
        raise ValueError("residual must match x")
    for v in (x, w_q, w_scale, b, a_scale) + (() if residual is None else (residual,)):
        if v.device != x.device:
            raise ValueError("every operand must be on x's device")
        if not v.is_contiguous():
            raise ValueError("every operand must be contiguous")
    if bsz == 0 or t == 0:
        raise ValueError("empty input")


def ws_layout(channels: int, kernel_size: int, dilation: int) -> dict:
    """csrc/conv1d_w8a8_ws.cu's shared memory (`layout`) at (C, K, dil)
    and the table's tiles (MB, TN, NB, CL): byte offsets of the int8
    window `x8`, the bf16 windows `xb`, the output tile `ot` and the
    copies' mbarriers `bar` after the weights ([K][MB][C] int8), the
    `total`, and the window's rows `r8`, 16-byte chunks `nch` and chunk
    pitch `nchp` (1 mod 8)."""
    mb, tn, nb, cl = WS_TILES[(channels, kernel_size)]
    r8 = (tn + (kernel_size - 1) * dilation + 7 + 7) & ~7
    nch = r8 // 8
    nchp = nch + ((1 - nch) & 7)
    x8 = mb * channels * kernel_size
    xb = x8 + (2 if cl != 1 else 1) * r8 * channels
    ot = xb + nb * (channels // cl if cl > 1 else channels) * nchp * 16
    bar = ot + mb * (tn + 8) * 2
    return dict(x8=x8, xb=xb, ot=ot, bar=bar, total=bar + 8 * (nb + 1), r8=r8, nch=nch,
                nchp=nchp)


def ws_smem_bytes(channels: int, kernel_size: int, dilation: int) -> int:
    """Dynamic shared memory of one conv1d_w8a8_ws launch (the mirror of
    the kernel's `layout`)."""
    return ws_layout(channels, kernel_size, dilation)["total"]


def _library(kernel: str = ROUTE_KERNEL):
    """(library, launch, smem query) of one of `KERNELS`, built on first use."""
    lib = build.load(kernel)
    fn = getattr(lib, "rvc_" + kernel)
    smem = getattr(lib, f"rvc_{kernel}_smem_bytes")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        smem.argtypes = [ctypes.c_int] * 3
        smem.restype = ctypes.c_size_t
    return lib, fn, smem


def smem_bytes(channels: int, kernel_size: int, dilation: int,
               kernel: str = ROUTE_KERNEL) -> int:
    """Dynamic shared memory of one launch, as the kernel's library
    reports it (0: shape not taken)."""
    return int(_library(kernel)[2](channels, kernel_size, dilation))


def _launch(x, w_q, w_scale, b, a_scale, *, dilation: int, apply_lrelu: bool, residual,
            kernel: str = ROUTE_KERNEL):
    global conv1d_w8a8_launches, conv1d_w8a8_ws_launches
    if kernel not in KERNELS:
        raise ValueError(f"unknown W8A8 kernel {kernel!r} (known: {KERNELS})")
    _check_conv(x, w_q, w_scale, b, a_scale, dilation, residual)
    lib, fn, _ = _library(kernel)
    bsz, c, t = x.shape
    out = torch.empty_like(x)
    # an op-scope range (as Inductor wraps its Triton launches), so that the
    # profiler ties the ctypes launch to the caller's ranges
    with torch.cuda.device(x.device), _RecordFunctionFast(kernel):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), b.data_ptr(),
                a_scale.data_ptr(), 0 if residual is None else residual.data_ptr(),
                bsz, c, t, w_q.shape[0], int(dilation), int(apply_lrelu), stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: {build.error_string(lib, rc)} "
                           f"(code {rc})")
    if kernel == "conv1d_w8a8_ws":
        conv1d_w8a8_ws_launches += 1
    else:
        conv1d_w8a8_launches += 1
    return out


def conv1d_w8a8_kernel(x, w_q, w_scale, b, a_scale, *, dilation: int, apply_lrelu: bool,
                       residual=None, kernel: str = ROUTE_KERNEL):
    """One launch of the W8A8 kernel `kernel` (one of `KERNELS`) on CUDA
    tensors.  For timing the kernels side by side; the route is
    `conv1d_w8a8`."""
    if x.device.type != "cuda":
        raise ValueError(f"{kernel} runs on a CUDA tensor, got {x.device}")
    return _launch(x, w_q, w_scale, b, a_scale.reshape(1), dilation=dilation,
                   apply_lrelu=apply_lrelu, residual=residual, kernel=kernel)


def _on_card(x) -> bool:
    """A CUDA tensor launches the kernel; a CPU one takes the plain version."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type == "cuda"


def conv1d_w8a8(x, w_q, w_scale, b=None, *, a_scale=None, dilation: int = 1,
                apply_lrelu: bool = False, residual=None):
    """W8A8 conv with "same" zero padding ((k - 1) * dilation / 2 each side).

    x: (B, C_in, T); w_q: (k, C_out, C_in) int8; w_scale: (C_out,) fp32;
    b: (C_out,) or None; a_scale: a one-value fp32 tensor (a static site
    scale or a dynamic one on x's device), None for x's own
    (`activation_scale`, after the leaky ReLU).  apply_lrelu quantizes
    `lrelu(x)` instead of x; residual, (B, C_out, T), is added to the
    output in its dtype.  Returns x's dtype.  A CPU tensor takes the
    plain version; a CUDA tensor launches csrc/conv1d_w8a8_ws.cu (bf16,
    C = C_in = C_out in SUPPORTED_C) or raises."""
    if a_scale is None:
        a_scale = activation_scale(lrelu(x) if apply_lrelu else x)
    if _on_card(x):
        return _launch(x, w_q, w_scale, b, a_scale.reshape(1), dilation=dilation,
                       apply_lrelu=apply_lrelu, residual=residual)
    return _conv1d_w8a8_plain(x, w_q, w_scale, b, a_scale, dilation=dilation,
                              apply_lrelu=apply_lrelu, residual=residual)


def conv1d_w8a8_ops(batch: int, length: int, channels: int, kernel_size: int) -> int:
    """int8 operations of one conv (a multiply and an add per tap)."""
    return 2 * batch * length * kernel_size * channels * channels


# ---------------------------------------------------------------------------
# calibration contexts
# ---------------------------------------------------------------------------

class Int8SiteMismatch(ValueError):
    """A static context met a conv site unlike the one it calibrated."""


class Int8Ctx:
    """The context threaded through a decode in place of a use_int8 bool.

    "dynamic":   each conv's activation scale from its own input
    "calibrate": as dynamic, and each site's scale (a device tensor) and
                 signature are recorded in `collected` / `collected_sigs`
    "static":    the site scales `scales` (fp32, one per site, on the
                 decode's device) are played back; `sigs` cross-checks each
                 site's (k, C_in, C_out, dilation), and a divergent decode
                 raises Int8SiteMismatch

    A site is a conv's position in the decode's call order, counted per
    thread from `reset_sites` (two server threads may decode at once)."""

    def __init__(self, mode: str = "dynamic", scales=None, sigs=None):
        if mode not in ("dynamic", "calibrate", "static"):
            raise ValueError(f"unknown Int8Ctx mode {mode!r}")
        if mode == "static" and scales is None:
            raise ValueError("static Int8Ctx requires calibrated scales")
        self.mode = mode
        self.scales = None if scales is None else torch.as_tensor(scales, dtype=torch.float32)
        self.sigs = list(sigs) if sigs is not None else None
        self.collected: list = []
        self.collected_sigs: list = []
        self._tls = threading.local()

    def reset_sites(self) -> None:
        """Called at the top of each decode: the site order restarts."""
        self._tls.i = 0

    def _next_site(self) -> int:
        i = getattr(self._tls, "i", 0)
        self._tls.i = i + 1
        return i

    def conv(self, x, w_q, w_scale, b, *, dilation: int, apply_lrelu: bool = False,
             residual=None):
        """`conv1d_w8a8` at the next site, with its scale by the mode."""
        k, c_out, c_in = w_q.shape
        sig = (int(k), int(c_in), int(c_out), int(dilation))
        i = self._next_site()
        if self.mode == "static":
            if self.sigs is not None and (i >= len(self.sigs) or tuple(self.sigs[i]) != sig):
                raise Int8SiteMismatch(
                    f"int8 site {i} signature {sig} != calibrated "
                    f"{self.sigs[i] if i < len(self.sigs) else '<missing>'}")
            a_scale = self.scales[i:i + 1]
        else:
            a_scale = activation_scale(lrelu(x) if apply_lrelu else x).reshape(1)
            if self.mode == "calibrate":
                self.collected.append(a_scale)
                self.collected_sigs.append(sig)
        return conv1d_w8a8(x, w_q, w_scale, b, a_scale=a_scale, dilation=dilation,
                           apply_lrelu=apply_lrelu, residual=residual)


def as_ctx(use_int8):
    """The threaded use_int8 value as an Int8Ctx, or None."""
    if isinstance(use_int8, Int8Ctx):
        return use_int8
    return Int8Ctx("dynamic") if use_int8 else None


def calibration_scales(collected, sigs) -> tuple[np.ndarray, list]:
    """A calibration pass's site scales, moved to the host in one copy,
    times a 1.05 margin for inputs a little hotter than the calibration
    audio (int8 clips beyond it); and the signatures."""
    if not collected:
        return np.zeros(0, np.float32), list(sigs)
    host = torch.cat([s.reshape(1) for s in collected]).cpu().numpy().astype(np.float32)
    return host * np.float32(CALIBRATION_MARGIN), list(sigs)


# ---------------------------------------------------------------------------
# weights, once per pipeline
# ---------------------------------------------------------------------------

def prequantize_decode(params):
    """A copy of the synthesizer tree whose decode resblocks carry
    w1_q / w2_q ((D, k, C_out, C_in) int8, the kernel's layout) and
    w1_scale / w2_scale ((D, C_out) fp32) beside their packed weights."""
    if "dec" not in params or "resblocks" not in params["dec"]:
        return params
    params = dict(params)
    dec = params["dec"] = dict(params["dec"])
    rbs = []
    for rb in dec["resblocks"]:
        rb = dict(rb)
        for name in ("w1", "w2"):
            if isinstance(rb.get(name), torch.Tensor) and rb[name].dim() == 4:
                w_q, scale = quantize_weight(rb[name])
                rb[name + "_q"] = w_q.transpose(-1, -2).contiguous()
                rb[name + "_scale"] = scale.contiguous()
        rbs.append(rb)
    dec["resblocks"] = rbs
    return params


def _with_linear_q(c):
    c = dict(c)
    c["w_q"], c["w_scale"] = quantize_linear_weight(c["w"])
    return c


def prequantize_hubert(params):
    """A copy of a HuBERT tree whose six transformer matmuls per layer
    (attention q, k, v, o; fc1, fc2) carry w_q / w_scale."""
    if not isinstance(params, dict) or "layers" not in params:
        return params
    params = dict(params)
    layers = []
    for lp in params["layers"]:
        lp = dict(lp)
        lp["attn"] = {k: _with_linear_q(v) if k in ("q", "k", "v", "o") else v
                      for k, v in lp["attn"].items()}
        for name in ("fc1", "fc2"):
            lp[name] = _with_linear_q(lp[name])
        layers.append(lp)
    params["layers"] = layers
    return params


def prequantize_rmvpe(params):
    """A copy of an RMVPE tree whose residual blocks' conv1 / conv2 with
    C_in >= RMVPE_INT8_MIN_CIN carry w_q / w_scale."""
    def walk(node):
        if isinstance(node, dict):
            node = {k: walk(v) for k, v in node.items()}
            for key in ("conv1", "conv2"):
                c = node.get(key)
                if (isinstance(c, dict) and isinstance(c.get("w"), torch.Tensor)
                        and c["w"].dim() == 4 and c["w"].shape[1] >= RMVPE_INT8_MIN_CIN):
                    c = dict(c)
                    c["w_q"], c["w_scale"] = quantize_conv2d_weight(c["w"])
                    node[key] = c
            return node
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


# ---------------------------------------------------------------------------
# HuBERT's and RMVPE's int8 products (library int8 GEMMs)
# ---------------------------------------------------------------------------

def linear_w8a8(x, w, b=None, *, w_q=None, w_scale=None):
    """`ops.nn.linear` in W8A8: x (..., C_in); w (C_out, C_in).  The
    activations quantize per token (last-axis amax).  Returns x's dtype."""
    if w_q is None or w_scale is None:
        w_q, w_scale = quantize_linear_weight(w)
    a_scale = torch.clamp(x.to(torch.float32).abs().amax(dim=-1, keepdim=True),
                          min=1e-8) / 127.0
    lead = x.shape[:-1]
    acc = _int_mm(_quantize_act(x, a_scale).reshape(-1, x.shape[-1]), w_q)
    y = acc.reshape(*lead, w_q.shape[0]).to(torch.float32) * (a_scale * w_scale)
    if b is not None:
        y = y + b.to(torch.float32)
    return y.to(x.dtype)


def conv2d_w8a8(x, w, *, padding: int = 1, w_q=None, w_scale=None):
    """A stride-1 2-D conv in W8A8 on (B, C_in, H, W) with one dynamic
    activation scale per tensor: an int8 im2col of the kh x kw window and
    `torch._int_mm`.  w: (C_out, C_in, kh, kw).  Returns x's dtype."""
    if w_q is None or w_scale is None:
        w_q, w_scale = quantize_conv2d_weight(w)
    a_scale = activation_scale(x)
    bsz, c_in, h, wd = x.shape
    c_out, _, kh, kw = w_q.shape
    xq = F.pad(_quantize_act(x, a_scale), (padding,) * 4)
    ho, wo = h + 2 * padding - kh + 1, wd + 2 * padding - kw + 1
    cols = torch.stack([xq[:, :, i:i + ho, j:j + wo] for i in range(kh) for j in range(kw)],
                       dim=-1)                                    # (B, C_in, H, W, kh*kw)
    cols = cols.permute(0, 2, 3, 1, 4).reshape(bsz * ho * wo, c_in * kh * kw)
    acc = _int_mm(cols, w_q.reshape(c_out, -1))
    y = acc.to(torch.float32) * (a_scale * w_scale)
    return y.reshape(bsz, ho, wo, c_out).permute(0, 3, 1, 2).to(x.dtype)
