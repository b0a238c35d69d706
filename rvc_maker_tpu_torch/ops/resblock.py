"""HiFi-GAN resblock: the hand-written CUDA kernels and their plain version.

`fused_resblock` runs one resblock,

    for d in dilations:  x = x + conv_{k,1}(lrelu(conv_{k,d}(lrelu(x))))

with zero padding at the sequence edges, one kernel launch per dilation
step for a tensor on the card, and `_resblock`, the plain F.conv1d chain,
for a tensor on the CPU.  `_route` picks the kernel from the device, the
dtype and the width alone:

    cpu                               -> the plain steps
    cuda, fp32, C in TC_WIDTHS        -> csrc/resblock_tc.cu (3xTF32 mma.sync.m16n8k8)
    cuda, bf16, C in SUPPORTED_C      -> csrc/resblock_tc_bf16.cu (bf16 mma.sync.m16n8k16)

A failed build or launch raises; no route is taken because another
failed.  In the int8 mode (RVC_TPU_INT8=1, bf16) the decode sends its
stages of C >= 64 to the W8A8 conv instead (`models/synthesizer.py`
`_int8_resblock`, csrc/conv1d_w8a8_ws.cu), so only its narrower stages
reach this module's bf16 route.  csrc/resblock.cu (fp32 FMA on the CUDA cores, either dtype) is
on no route; `_fma_resblock` times it beside the tensor-core kernels.
They replace the Pallas TPU kernel `rvc_maker_tpu/ops/pallas_resblock.py`
`fused_resblock`; `_resblock` is the counterpart of
`rvc_maker_tpu/models/synthesizer.py` `_resblock`.

Layout: x is (B, C, T), torch's conv layout, used for the whole decode.
Weights are packed once at load as (D, k, C_in, C_out) (the JAX
package's (k, C_in, C_out) per conv, stacked over the D dilations) and
biases as (D, C), so each kernel step reads one contiguous slab.  The
fp32 tensor-core kernel takes its weights split into two TF32 planes in
its own stage order, which `_tc_pack` makes once per call (as JAX's
`pack_resblock_weights` packs outside its kernel); the bf16 one takes
the packed weights as they lie.  Both take a time tile that
`tc_time_tile` chooses per launch from their config tables.

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
MAX_DILATION = 5      # kMaxDil of every csrc/resblock*.cu
TC_WIDTHS = SUPPORTED_C   # fp32 widths that csrc/resblock_tc.cu takes
# csrc/resblock_tc.cu `Cfg` per width: (KC input channels per stage,
# MT_MAX m-tiles of 16 rows of conv1 at most, WM warps along time, blocks
# an SM holds)
TC_TILES = {256: (16, 8, 2, 1), 128: (32, 8, 2, 1), 64: (16, 8, 4, 2), 32: (16, 16, 8, 2),
            16: (16, 32, 8, 1)}
# csrc/resblock_tc_bf16.cu `Cfg` per width, the same columns
TC_BF16_TILES = {256: (64, 8, 2, 1), 128: (64, 8, 2, 2), 64: (32, 16, 4, 2), 32: (32, 32, 8, 2),
                 16: (16, 32, 8, 2)}
CARD_SMS = 132            # streaming multiprocessors of an H100 SXM
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TC_TABLES = {"tc": TC_TILES, "tc_bf16": TC_BF16_TILES}   # route -> its config table

# kernel launches since the last reset (one per dilation step): all of
# them, and those of each tensor-core kernel
resblock_launches = 0
resblock_tc_launches = 0
resblock_tc_bf16_launches = 0
# route -> (csrc library, prefix of its C functions)
_LIBRARIES = {"tc": ("resblock_tc", "rvc_resblock_tc"),
              "tc_bf16": ("resblock_tc_bf16", "rvc_resblock_tc_bf16"),
              "fma": ("resblock", "rvc_resblock")}


def _branch(x, w1, b1, w2, b2, k: int, d: int, slope: float = LRELU_SLOPE):
    """One dilation step's residual branch; w (k, C_in, C_out); b (C,)."""
    y = F.leaky_relu(x, slope)
    y = F.conv1d(y, w1.permute(2, 1, 0), b1, dilation=d, padding=(k * d - d) // 2)
    y = F.leaky_relu(y, slope)
    return F.conv1d(y, w2.permute(2, 1, 0), b2, padding=(k - 1) // 2)


def _resblock(x, w1, b1, w2, b2, *, kernel_size: int, dilations, slope: float = LRELU_SLOPE):
    """Plain eager version: x (B, C, T); w (D, k, C_in, C_out); b (D, C).
    `slope` other than the kernel's 0.1 serves resblocks no kernel takes
    (`models/audioldm2.py` `vocoder_apply`)."""
    for i, d in enumerate(dilations):
        x = x + _branch(x, w1[i], b1[i], w2[i], b2[i], kernel_size, d, slope)
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
    """"plain", "tc" (csrc/resblock_tc.cu), "tc_bf16" (csrc/resblock_tc_bf16.cu)
    or, for a width no kernel takes, "fma", which `_check` then refuses."""
    if device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise ValueError(f"unsupported device {device_type}")
    if dtype == torch.float32 and channels in TC_WIDTHS:
        return "tc"
    if dtype == torch.bfloat16 and channels in SUPPORTED_C:
        return "tc_bf16"
    return "fma"


def _library(route: str):
    """The route's kernel library, built on first use; its step function
    takes (x, out, w1, b1, w2, b2, B, C, T, K, dil, time tile, stream)
    (tc_bf16), (x, out, w1, b1, w2, b2, B, C, T, K, dil, dtype code,
    stream) (fma), and the tc route's (x, out, `_tc_pack` slab, b1, b2,
    B, C, T, K, dil, time tile, stream)."""
    name, prefix = _LIBRARIES[route]
    lib = build.load(name)
    step, smem = getattr(lib, prefix + "_step"), getattr(lib, prefix + "_smem_bytes")
    if step.argtypes is None:
        if route == "tc":
            step.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            smem.argtypes = [ctypes.c_int] * 4
        else:   # tc_bf16: its time tile; fma: resblock.cu's dtype code
            step.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            smem.argtypes = [ctypes.c_int] * 4
        step.restype = ctypes.c_int
        smem.restype = ctypes.c_size_t
    return lib, step, smem


def tc_time_tile(route: str, batch: int, length: int, channels: int, kernel_size: int,
                 sms: int = CARD_SMS) -> int:
    """Output rows per block of the tensor-core kernel of `route` ("tc":
    csrc/resblock_tc.cu, config table `TC_TILES`; "tc_bf16":
    csrc/resblock_tc_bf16.cu, `TC_BF16_TILES`) for one launch on (B, C,
    T) at kernel size k.  A block streams both convs' weights whatever
    its tile, so the longest tile the kernel takes (MT_MAX m-tiles of conv1, which covers conv2's
    k - 1 halo rows) reads them fewest times.  Where an SM holds one block
    (fp32 C = 16, 128, 256; bf16 C = 256), the grid (tiles x B blocks)
    runs in whole waves: the rows are cut into as many tiles of equal
    length as fill the waves the longest tile needs, so that no SM idles
    in the last one.  Where it holds two, a block starts as soon as one
    ends, and the rows are cut only while the grid has fewer blocks than
    the SMs hold.  No tile is cut below 17 rows (2 m-tiles of conv2, so that
    conv1's halo stays under a third of its rows)."""
    _, mt_max, _, per_sm = _TC_TABLES[route][channels]
    slots = sms * per_sm
    longest = -(-length // (16 * mt_max - (kernel_size - 1)))
    waves = -(-batch * longest // slots) if per_sm == 1 else 1
    tiles = max(longest, min(waves * slots // batch, -(-length // 17)))
    return -(-length // tiles)


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the bits (round to 10 mantissa bits, ties away
    from zero) of finite fp32 values."""
    return ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tc_pack(w1, w2):
    """The weights of every step of both convs for csrc/resblock_tc.cu:
    split once into TF32 planes, hi = rna(w), lo = rna(w - hi), and laid
    out as the kernel's shared memory holds them, (D, conv, C / KC, k,
    plane, C_out, KC) contiguous: stage (chunk, tap) of a conv is one slab
    of 2 x C x KC words that the kernel copies as it lies, each C_out row's
    16-byte chunks placed as `_tc_swizzle` says."""
    D, k, c, _ = w1.shape
    kc = TC_TILES[c][0]
    w = torch.stack([w1, w2], 1)                             # (D, 2, k, C_in, C_out)
    hi = _tf32_rna(w)
    p = torch.stack([hi, _tf32_rna(w - hi)], 3)              # (D, 2, k, 2, C_in, C_out)
    p = p.view(D, 2, k, 2, c // kc, kc // 4, 4, c).permute(0, 1, 4, 2, 3, 7, 5, 6)
    return p[(...,) + _tc_swizzle(c, kc // 4, w.device) + (slice(None),)].reshape(
        D, 2, c // kc, k, 2, c, kc).contiguous()


_SWIZZLES: dict = {}


def _tc_swizzle(rows: int, chunks: int, device) -> tuple:
    """Index pair (row, chunk) that gathers, for each row of an image of
    `chunks` 16-byte chunks a row, the chunk that csrc/resblock_tc.cu `swz`
    places there: chunk c of row r lies at c ^ key(r), so that any 8
    consecutive rows of one chunk fall on 8 distinct bank groups."""
    key = (rows, chunks, str(device))
    if key not in _SWIZZLES:
        r = torch.arange(rows, device=device)[:, None]
        _SWIZZLES[key] = (r, torch.arange(chunks, device=device)
                          ^ (r & 7 if chunks >= 8 else (r >> 1) & 3))
    return _SWIZZLES[key]


def smem_bytes(channels: int, kernel_size: int, dilation: int,
               dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one launch of the kernel that `_route` picks
    for a CUDA tensor of this dtype and width (0: shape not taken); for a
    tensor-core kernel at its longest time tile."""
    route = _route("cuda", dtype, channels)
    if route in _TC_TABLES:
        longest = 16 * _TC_TABLES[route][channels][1] - (kernel_size - 1)
        return int(_library(route)[2](channels, kernel_size, dilation, longest))
    extra = (_DTYPE_CODE[dtype],) if route == "fma" else ()
    return int(_library(route)[2](channels, kernel_size, dilation, *extra))


def _launch_steps(route: str, x, w1, b1, w2, b2, kernel_size: int, dilations,
                  time_tile: int | None = None):
    """[x_0, ..., x_D] through the route's kernel, one launch per step;
    raises if a launch fails.  time_tile: a tensor-core route's rows per
    block (default `tc_time_tile`'s choice over its table)."""
    global resblock_launches, resblock_tc_launches, resblock_tc_bf16_launches
    _check(x, w1, b1, w2, b2, kernel_size, dilations)
    lib, step, _ = _library(route)
    b, c, t = x.shape
    if route == "tc":
        pack = _tc_pack(w1, w2)
        weights = [(pack[i].data_ptr(), b1[i].data_ptr(), b2[i].data_ptr())
                   for i in range(len(dilations))]
    else:
        weights = [(w1[i].data_ptr(), b1[i].data_ptr(), w2[i].data_ptr(), b2[i].data_ptr())
                   for i in range(len(dilations))]
    if route in _TC_TABLES:
        extra = (time_tile or tc_time_tile(route, b, t, c, kernel_size),)
    else:
        extra = (_DTYPE_CODE[x.dtype],)
    xs = [x]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for i, d in enumerate(dilations):
            out = torch.empty_like(x)
            rc = step(xs[-1].data_ptr(), out.data_ptr(), *weights[i], b, c, t, kernel_size,
                      int(d), *extra, stream)
            if rc != 0:
                raise RuntimeError(f"resblock {route} kernel launch failed: "
                                   f"{build.error_string(lib, rc)} (code {rc})")
            resblock_launches += 1
            resblock_tc_launches += route == "tc"
            resblock_tc_bf16_launches += route == "tc_bf16"
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
    tensor-core kernels' earlier version, for timing beside them.  No path
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
