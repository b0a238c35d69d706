"""HiFi-GAN resblock: the hand-written CUDA kernel and its plain version.

`fused_resblock` runs one resblock,

    for d in dilations:  x = x + conv_{k,1}(lrelu(conv_{k,d}(lrelu(x))))

with zero padding at the sequence edges, as the CUDA kernel in
`csrc/resblock.cu` (one launch per dilation step) for a tensor on the
card, and as `_resblock`, the plain F.conv1d chain, for a tensor on the
CPU.  It replaces the Pallas TPU kernel `rvc_maker_tpu/ops/
pallas_resblock.py` `fused_resblock`; `_resblock` is the counterpart of
`rvc_maker_tpu/models/synthesizer.py` `_resblock`.

Layout: x is (B, C, T), torch's conv layout, used for the whole decode.
Weights are packed once at load as (D, k, C_in, C_out) (the JAX
package's (k, C_in, C_out) per conv, stacked over the D dilations) and
biases as (D, C), so each kernel step reads one contiguous slab.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

LRELU_SLOPE = 0.1
SUPPORTED_C = (16, 32, 64, 128, 256)
SUPPORTED_K = (3, 7, 11)
MAX_DILATION = 5      # csrc/resblock.cu kMaxDil
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (one per dilation step)
resblock_launches = 0


def _resblock(x, w1, b1, w2, b2, *, kernel_size: int, dilations):
    """Plain eager version: x (B, C, T); w (D, k, C_in, C_out); b (D, C)."""
    k = kernel_size
    for i, d in enumerate(dilations):
        y = F.leaky_relu(x, LRELU_SLOPE)
        y = F.conv1d(y, w1[i].permute(2, 1, 0), b1[i], dilation=d,
                     padding=(k * d - d) // 2)
        y = F.leaky_relu(y, LRELU_SLOPE)
        y = F.conv1d(y, w2[i].permute(2, 1, 0), b2[i], padding=(k - 1) // 2)
        x = x + y
    return x


def _check(x, w1, b1, w2, b2, kernel_size, dilations):
    if x.dim() != 3:
        raise ValueError(f"x must be (B, C, T), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {x.dtype}")
    b, c, t = x.shape
    D, k = len(dilations), kernel_size
    if c not in SUPPORTED_C or k not in SUPPORTED_K:
        raise ValueError(f"kernel takes C in {SUPPORTED_C} and k in "
                         f"{SUPPORTED_K}, got C={c}, k={k}")
    if any(not 1 <= int(d) <= MAX_DILATION for d in dilations):
        raise ValueError(f"kernel takes dilations in 1..{MAX_DILATION}, got {dilations}")
    for name, w in (("w1", w1), ("w2", w2)):
        if tuple(w.shape) != (D, k, c, c):
            raise ValueError(f"{name} must be {(D, k, c, c)}, got {tuple(w.shape)}")
    for name, v in (("b1", b1), ("b2", b2)):
        if tuple(v.shape) != (D, c):
            raise ValueError(f"{name} must be {(D, c)}, got {tuple(v.shape)}")
    for v in (x, w1, b1, w2, b2):
        if v.device != x.device or v.dtype != x.dtype:
            raise ValueError("x, weights and biases must share device and dtype")
        if not v.is_contiguous():
            raise ValueError("x, weights and biases must be contiguous")
    if b == 0 or t == 0:
        raise ValueError("empty input")


def _library():
    lib = build.load("resblock")
    fn = lib.rvc_resblock_step
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.rvc_resblock_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.rvc_resblock_smem_bytes.restype = ctypes.c_size_t
    return lib


def smem_bytes(channels: int, kernel_size: int, dilation: int,
               dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one kernel launch (0: shape not taken)."""
    return int(_library().rvc_resblock_smem_bytes(channels, kernel_size, dilation,
                                                  _DTYPE_CODE[dtype]))


def fused_resblock(x, w1, b1, w2, b2, *, kernel_size: int, dilations):
    """One resblock.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (once per dilation) or raises."""
    global resblock_launches
    if x.device.type == "cpu":
        return _resblock(x, w1, b1, w2, b2, kernel_size=kernel_size,
                         dilations=dilations)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, w1, b1, w2, b2, kernel_size, dilations)
    lib = _library()
    b, c, t = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for i, d in enumerate(dilations):
            out = torch.empty_like(x)
            rc = lib.rvc_resblock_step(
                x.data_ptr(), out.data_ptr(), w1[i].data_ptr(), b1[i].data_ptr(),
                w2[i].data_ptr(), b2[i].data_ptr(), b, c, t, kernel_size,
                int(d), _DTYPE_CODE[x.dtype], stream)
            if rc != 0:
                raise RuntimeError(f"resblock kernel launch failed: "
                                   f"{build.error_string(lib, rc)} (code {rc})")
            resblock_launches += 1
            x = out
    return x


def resblock_flops(batch: int, length: int, channels: int, kernel_size: int,
                   n_dilations: int) -> int:
    """Operations of one resblock (the TPU kernel's CostEstimate count)."""
    return 2 * 2 * n_dilations * batch * length * kernel_size * channels * channels
