"""HiFi-GAN resblock: the hand-written CUDA kernels and their plain version.

`fused_resblock` runs one resblock,

    for d in dilations:  x = x + conv_{k,1}(lrelu(conv_{k,d}(lrelu(x))))

with zero padding at the sequence edges, one kernel launch per dilation
step for a tensor on the card, and `_resblock`, the plain F.conv1d chain,
for a tensor on the CPU.  `_route` picks the kernel from the device, the
dtype and the width alone:

    cpu                               -> the plain steps
    cuda, fp32, C in TC_WIDTHS        -> csrc/resblock_tc.cu (3xTF32 mma.sync)
    cuda, bf16 (or fp32 outside them) -> csrc/resblock.cu (fp32 FMA)

A failed build or launch raises; no route is taken because another
failed.  It replaces the Pallas TPU kernel `rvc_maker_tpu/ops/
pallas_resblock.py` `fused_resblock`; `_resblock` is the counterpart of
`rvc_maker_tpu/models/synthesizer.py` `_resblock`.

Layout: x is (B, C, T), torch's conv layout, used for the whole decode.
Weights are packed once at load as (D, k, C_in, C_out) (the JAX
package's (k, C_in, C_out) per conv, stacked over the D dilations) and
biases as (D, C), so each kernel step reads one contiguous slab.

Gradients: `fused_resblock` is a torch.autograd.Function.  Its forward
(the kernel on the card, the plain steps on the CPU) keeps the D step
inputs x_0..x_{D-1}, which are the kernel's own per-step outputs, so
saving them costs nothing extra.  Its backward recomputes each step's
branch conv2(lrelu(conv1(lrelu(x_i)))) in PyTorch ops, in reverse, and
differentiates it with torch.autograd.grad: the same code on both
devices, so the CPU tests cover it.  The TPU kernel has no backward
kernel (the JAX package trains through the plain `_resblock`), so the
backward is not a kernel here either.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

LRELU_SLOPE = 0.1
SUPPORTED_C = (16, 32, 64, 128, 256)
SUPPORTED_K = (3, 7, 11)
MAX_DILATION = 5      # csrc/resblock.cu and resblock_tc.cu kMaxDil
TC_WIDTHS = SUPPORTED_C   # fp32 widths that csrc/resblock_tc.cu takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset (one per dilation step): all of
# them, and those of the tensor-core kernel
resblock_launches = 0
resblock_tc_launches = 0


def _branch(x, w1, b1, w2, b2, k: int, d: int):
    """One dilation step's residual branch; w (k, C_in, C_out); b (C,)."""
    y = F.leaky_relu(x, LRELU_SLOPE)
    y = F.conv1d(y, w1.permute(2, 1, 0), b1, dilation=d, padding=(k * d - d) // 2)
    y = F.leaky_relu(y, LRELU_SLOPE)
    return F.conv1d(y, w2.permute(2, 1, 0), b2, padding=(k - 1) // 2)


def _resblock(x, w1, b1, w2, b2, *, kernel_size: int, dilations):
    """Plain eager version: x (B, C, T); w (D, k, C_in, C_out); b (D, C)."""
    for i, d in enumerate(dilations):
        x = x + _branch(x, w1[i], b1[i], w2[i], b2[i], kernel_size, d)
    return x


def _slope(v):
    """d leaky_relu / dv as autograd takes it: 1 where v > 0, else the slope."""
    return torch.where(v > 0, 1.0, LRELU_SLOPE).to(v.dtype)


def _resblock_at_slopes(x, w1, b1, w2, b2, *, kernel_size: int, dilations, step_inputs):
    """A gradient reference for a forward through a kernel.  The plain
    chain from x, each leaky ReLU replaced by its slope at the kernel's
    step inputs x_0..x_{D-1} (`step_inputs`), as the backward of
    `fused_resblock` recomputes them.  leaky_relu's derivative jumps at 0,
    so two forwards that differ by rounding have gradients that differ by
    O(1) wherever a pre-activation lies within that rounding of 0; at
    pinned slopes the two gradients are comparable.  Returns (output, the
    largest |pre-activation| of this chain where a pinned slope differs
    from its own), which is of rounding size when the forwards agree."""
    k, worst = kernel_size, 0.0
    for i, d in enumerate(dilations):
        wt1, pad1 = w1[i].permute(2, 1, 0), (k * d - d) // 2
        with torch.no_grad():
            s1 = _slope(step_inputs[i])
            s2 = _slope(F.conv1d(F.leaky_relu(step_inputs[i], LRELU_SLOPE), wt1, b1[i],
                                 dilation=d, padding=pad1))
        v1 = F.conv1d(x * s1, wt1, b1[i], dilation=d, padding=pad1)
        for v, s in ((x, s1), (v1, s2)):
            flip = _slope(v.detach()) != s
            if flip.any():
                worst = max(worst, v.detach()[flip].abs().max().item())
        x = x + F.conv1d(v1 * s2, w2[i].permute(2, 1, 0), b2[i], padding=(k - 1) // 2)
    return x, worst


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


def _route(device_type: str, dtype: torch.dtype, channels: int) -> str:
    """"plain", "tc" (csrc/resblock_tc.cu) or "fma" (csrc/resblock.cu)."""
    if device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise ValueError(f"unsupported device {device_type}")
    return "tc" if dtype == torch.float32 and channels in TC_WIDTHS else "fma"


def _library(route: str = "fma"):
    if route == "tc":
        lib = build.load("resblock_tc")
        if lib.rvc_resblock_tc_step.argtypes is None:
            lib.rvc_resblock_tc_step.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
            lib.rvc_resblock_tc_step.restype = ctypes.c_int
            lib.rvc_resblock_tc_smem_bytes.argtypes = [ctypes.c_int] * 3
            lib.rvc_resblock_tc_smem_bytes.restype = ctypes.c_size_t
        return lib
    lib = build.load("resblock")
    if lib.rvc_resblock_step.argtypes is None:
        lib.rvc_resblock_step.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.rvc_resblock_step.restype = ctypes.c_int
        lib.rvc_resblock_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.rvc_resblock_smem_bytes.restype = ctypes.c_size_t
    return lib


def smem_bytes(channels: int, kernel_size: int, dilation: int,
               dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one launch of the kernel that `_route` picks
    for a CUDA tensor of this dtype and width (0: shape not taken)."""
    if _route("cuda", dtype, channels) == "tc":
        return int(_library("tc").rvc_resblock_tc_smem_bytes(channels, kernel_size,
                                                            dilation))
    return int(_library().rvc_resblock_smem_bytes(channels, kernel_size, dilation,
                                                  _DTYPE_CODE[dtype]))


def _launch_steps(route: str, x, w1, b1, w2, b2, kernel_size: int, dilations):
    """[x_0, ..., x_D] through the route's kernel, one launch per step;
    raises if a launch fails."""
    global resblock_launches, resblock_tc_launches
    _check(x, w1, b1, w2, b2, kernel_size, dilations)
    lib = _library(route)
    b, c, t = x.shape
    xs = [x]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for i, d in enumerate(dilations):
            out = torch.empty_like(x)
            ptrs = (xs[-1].data_ptr(), out.data_ptr(), w1[i].data_ptr(), b1[i].data_ptr(),
                    w2[i].data_ptr(), b2[i].data_ptr())
            if route == "tc":
                rc = lib.rvc_resblock_tc_step(*ptrs, b, c, t, kernel_size, int(d), stream)
            else:
                rc = lib.rvc_resblock_step(*ptrs, b, c, t, kernel_size, int(d),
                                           _DTYPE_CODE[x.dtype], stream)
            if rc != 0:
                raise RuntimeError(f"resblock {route} kernel launch failed: "
                                   f"{build.error_string(lib, rc)} (code {rc})")
            resblock_launches += 1
            resblock_tc_launches += route == "tc"
            xs.append(out)
    return xs


def _forward_steps(x, w1, b1, w2, b2, kernel_size: int, dilations):
    """[x_0, ..., x_D]: the input and each dilation step's output.  A CPU
    tensor takes the plain steps; a CUDA tensor launches `_route`'s
    kernel once per step or raises."""
    route = _route(x.device.type, x.dtype, x.shape[1] if x.dim() == 3 else 0)
    if route != "plain":
        return _launch_steps(route, x, w1, b1, w2, b2, kernel_size, dilations)
    xs = [x]
    for i, d in enumerate(dilations):
        xs.append(xs[-1] + _branch(xs[-1], w1[i], b1[i], w2[i], b2[i], kernel_size, d))
    return xs


def _fma_resblock(x, w1, b1, w2, b2, *, kernel_size: int, dilations):
    """The resblock through csrc/resblock.cu whatever the dtype: the
    tensor-core kernel's earlier version, for timing beside it.  No path
    calls it."""
    return _launch_steps("fma", x, w1, b1, w2, b2, kernel_size, tuple(dilations))[-1]


class _FusedResblock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, kernel_size, dilations):
        xs = _forward_steps(x, w1, b1, w2, b2, kernel_size, dilations)
        ctx.kernel_size, ctx.dilations = kernel_size, dilations
        ctx.save_for_backward(w1, b1, w2, b2, *xs[:-1])
        return xs[-1]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        w1, b1, w2, b2, *xs = ctx.saved_tensors
        grads = [torch.zeros_like(v) for v in (w1, b1, w2, b2)]
        with torch.enable_grad():
            for i in reversed(range(len(ctx.dilations))):
                ins = [v.detach().requires_grad_(True)
                       for v in (xs[i], w1[i], b1[i], w2[i], b2[i])]
                y = _branch(*ins, ctx.kernel_size, ctx.dilations[i])
                g_x, *g_w = torch.autograd.grad(y, ins, grad)
                for acc, g in zip(grads, g_w):
                    acc[i] = g
                grad = grad + g_x
        return (grad, *grads, None, None)


def fused_resblock(x, w1, b1, w2, b2, *, kernel_size: int, dilations):
    """One resblock, differentiable in x and the packed weights.  A CPU
    tensor takes the plain version; a CUDA tensor launches `_route`'s
    kernel (once per dilation) or raises."""
    return _FusedResblock.apply(x, w1, b1, w2, b2, kernel_size, tuple(dilations))


def resblock_flops(batch: int, length: int, channels: int, kernel_size: int,
                   n_dilations: int) -> int:
    """Operations of one resblock (the TPU kernel's CostEstimate count)."""
    return 2 * 2 * n_dilations * batch * length * kernel_size * channels * channels
