// W8A8 dilated conv1d of the int8 decode for Hopper (sm_90a): bf16 in
// and out, int8 operands, int32 accumulation, each product one
// mma.sync.m16n8k32 on s8.  Plain C interface, bound from Python with
// ctypes (rvc_maker_tpu_torch/ops/int8_conv.py `conv1d_w8a8`).
//
// Replaces: rvc_maker_tpu/ops/int8_conv.py `conv1d_w8a8`, which the JAX
// package runs in XLA (lax.conv_general_dilated, int32 result), not in
// a Pallas kernel; PyTorch has no int8 convolution on CUDA.  One launch
// computes, on (B, C, T) with "same" zero padding p = (K-1)*dil/2:
//
//     v    = lrelu ? bf16(x >= 0 ? x : x * bf16(0.1)) : x     (prologue)
//     x_q  = clip(round_half_even(v / a_scale), -127, 127)     (int8)
//     acc  = sum_{j, ci} w_q[j][co][ci] * x_q[ci][t - p + j*dil]   (int32, exact)
//     y    = bf16(float(acc) * (a_scale * w_scale[co]) + b[co])
//     out  = residual ? bf16(float(y) + float(residual)) : y   (epilogue)
//
// in JAX's order: a division (not a reciprocal), the two scales
// multiplied first, no fused multiply-add.  a_scale is read from device
// memory (a calibrated site scale or a dynamic amax), so no launch waits
// on the host.  The leaky ReLU's slope is 0.1 rounded to bf16, the
// value a bf16 multiply by 0.1 takes (JAX's bf16 leaky_relu).
//
// What bounds it.  2*B*T*K*C^2 int8 operations against one bf16 read of
// x (and of the residual) and one bf16 write: at the decode's shapes
// (C = 64..256, K = 3..11) the bytes bound it at 3.35 TB/s, not the
// 1,979 TOPS of int8; the fusions keep each conv at one pass in and one
// pass out.  This first version is simple: the weights are re-read from
// L2 by every block.
//
// Design.  A block owns TT = 16384 / C time columns (256, 128, 64) x all
// C output channels of one batch row; 8 warps, each a 64-channel x
// 32-column tile (4 m-tiles x 4 n-tiles, 64 int32 accumulators).
//   Staging: the block's input window [t0 - p, t0 + TT + (K-1)*dil - p)
//   is quantized on load into shared memory once, time-major: row r
//   holds C int8 channels (ci contiguous), rows outside [0, T) zero.
//   Taps: for each j, the tap's C_out x C_in int8 weights (the wrapper
//   keeps w_q as (K, C_out, C_in)) are copied to shared memory with
//   cp.async, then C/32 k-steps of 16 MMAs, the B operand read at row
//   offset j*dil.
// GEMM: M = C_out, N = time, K = C_in in steps of 32.  Fragments of
// m16n8k32 s8 (PTX ISA, "Matrix Fragments for mma.m16n8k32"), g = lane
// >> 2, q = lane & 3, byte i of a register the lower address:
//   a0 = A[g][4q..4q+3], a1 = A[g+8][4q..], a2 = A[g][16+4q..],
//   a3 = A[g+8][16+4q..]; b0 = B[4q..4q+3][g], b1 = B[16+4q..][g];
//   c0..c3 = D[g][2q], D[g][2q+1], D[g+8][2q], D[g+8][2q+1].
// A[co][ci] is a weight row and B[ci][t] a staged time row, so each
// fragment register is one aligned 32-bit shared load.  Rows are RS = C
// + 16 bytes apart (RS/4 = 4 or 20 mod 32 words), so the 8 rows g of a
// load fall on distinct 4-bank groups: no bank conflicts.
// tests/test_torch_int8.py holds a numpy model of this index arithmetic
// (`w8a8_kernel_model`) against the plain version, bank checks included.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpM = 4;                 // m-tiles (16 output channels) per warp
constexpr int kWarpN = 4;                 // n-tiles (8 time columns) per warp
constexpr int kMaxDil = 5;
constexpr float kSlope = 0.10009765625f;  // 0.1 rounded to bf16
constexpr size_t kMaxSmem = 232448;       // bytes a block may use on sm_90

template <int C>
struct Tile {
  static constexpr int WM = C / (16 * kWarpM);   // warps across C_out
  static constexpr int WN = kWarps / WM;          // warps across time
  static constexpr int TT = WN * kWarpN * 8;      // time columns per block
  static constexpr int RS = C + 16;               // shared row stride, bytes
  static_assert(WM * 16 * kWarpM == C && kWarps % WM == 0, "unsupported width");
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// d += A(16x32, s8) @ B(32x8, s8), int32
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
conv1d_w8a8_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                   const int8_t* __restrict__ wq, const float* __restrict__ wscale,
                   const __nv_bfloat16* __restrict__ bias, const float* __restrict__ ascale,
                   const __nv_bfloat16* __restrict__ res, int T, int K, int dil, int lrelu) {
  using P = Tile<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ws = smem;                    // [C_out][RS]: one tap's weights
  unsigned char* xs = smem + C * P::RS;        // [rows][RS]: the quantized window
  const int span = (K - 1) * dil;
  const int rows = P::TT + span;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int wm = warp % P::WM;
  const int wn = warp / P::WM;
  const int t0 = blockIdx.x * P::TT;
  const size_t base = (size_t)blockIdx.y * C * T;
  const __nv_bfloat16* xb = x + base;
  const int tstart = t0 - span / 2;            // time of staged row 0
  const float s = *ascale;

  // ---- stage: one 32-bit word = 4 channels of one time row ----------
  // consecutive threads take consecutive times: coalesced bf16 loads
  for (int idx = tid; idx < (C / 4) * rows; idx += kThreads) {
    const int cg = idx / rows;
    const int r = idx - cg * rows;
    const int t = tstart + r;
    uint32_t word = 0u;
    if (t >= 0 && t < T) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = __bfloat162float(xb[(size_t)(4 * cg + i) * T + t]);
        if (lrelu) v = __bfloat162float(__float2bfloat16_rn(v >= 0.f ? v : __fmul_rn(v, kSlope)));
        const int qv = min(127, max(-127, __float2int_rn(__fdiv_rn(v, s))));
        word |= (uint32_t)(qv & 0xFF) << (8 * i);
      }
    }
    *reinterpret_cast<uint32_t*>(xs + r * P::RS + 4 * cg) = word;
  }

  int acc[kWarpM][kWarpN][4];
#pragma unroll
  for (int im = 0; im < kWarpM; ++im)
#pragma unroll
    for (int in = 0; in < kWarpN; ++in)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[im][in][r] = 0;

  // this lane's fragment rows: weights of its m-tiles, window rows of its n-tiles
  const unsigned char* a_row = ws + (wm * kWarpM * 16 + g) * P::RS + 4 * q;
  const unsigned char* b_row = xs + (wn * kWarpN * 8 + g) * P::RS + 4 * q;

  for (int j = 0; j < K; ++j) {
    __syncthreads();   // the window is staged; every warp is done with tap j-1
    const int8_t* wj = wq + (size_t)j * C * C;
    for (int i = tid; i < C * (C / 16); i += kThreads) {
      const int row = i / (C / 16);
      const int col = (i - row * (C / 16)) * 16;
      cp_async16(ws + row * P::RS + col, wj + (size_t)row * C + col);
    }
    cp_async_wait_all();
    __syncthreads();
    const unsigned char* bj = b_row + j * dil * P::RS;
#pragma unroll 2
    for (int kk = 0; kk < C; kk += 32) {
      uint32_t a[kWarpM][4], b[kWarpN][2];
#pragma unroll
      for (int im = 0; im < kWarpM; ++im) {
        const unsigned char* p = a_row + im * 16 * P::RS + kk;
        a[im][0] = lds32(p);
        a[im][1] = lds32(p + 8 * P::RS);
        a[im][2] = lds32(p + 16);
        a[im][3] = lds32(p + 8 * P::RS + 16);
      }
#pragma unroll
      for (int in = 0; in < kWarpN; ++in) {
        const unsigned char* p = bj + in * 8 * P::RS + kk;
        b[in][0] = lds32(p);
        b[in][1] = lds32(p + 16);
      }
#pragma unroll
      for (int im = 0; im < kWarpM; ++im)
#pragma unroll
        for (int in = 0; in < kWarpN; ++in) mma_s8(acc[im][in], a[im], b[in]);
    }
  }

  // ---- epilogue: scale, bias, bf16, residual ------------------------
#pragma unroll
  for (int im = 0; im < kWarpM; ++im) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = (wm * kWarpM + im) * 16 + g + 8 * h;
      const float sc = __fmul_rn(s, wscale[co]);
      const float bc = __bfloat162float(bias[co]);
#pragma unroll
      for (int in = 0; in < kWarpN; ++in) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = t0 + (wn * kWarpN + in) * 8 + 2 * q + e;
          if (t < T) {
            const size_t o = base + (size_t)co * T + t;
            float y = __fadd_rn(__fmul_rn(__int2float_rn(acc[im][in][2 * h + e]), sc), bc);
            __nv_bfloat16 yb = __float2bfloat16_rn(y);
            if (res) yb = __float2bfloat16_rn(__fadd_rn(__bfloat162float(yb),
                                                        __bfloat162float(res[o])));
            out[o] = yb;
          }
        }
      }
    }
  }
}

// Launches one conv, or, with smem_query set, only reports the dynamic
// shared memory it would take.
template <int C>
cudaError_t launch(const __nv_bfloat16* x, __nv_bfloat16* out, const int8_t* wq,
                   const float* wscale, const __nv_bfloat16* bias, const float* ascale,
                   const __nv_bfloat16* res, int B, int T, int K, int dil, int lrelu,
                   cudaStream_t stream, size_t* smem_query) {
  using P = Tile<C>;
  if ((K != 3 && K != 7 && K != 11) || dil < 1 || dil > kMaxDil) return cudaErrorInvalidValue;
  const size_t smem = (size_t)P::RS * (C + P::TT + (K - 1) * dil);
  if (smem_query) {
    *smem_query = smem;
    return cudaSuccess;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(conv1d_w8a8_kernel<C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((T + P::TT - 1) / P::TT, B);
  conv1d_w8a8_kernel<C><<<grid, kThreads, smem, stream>>>(x, out, wq, wscale, bias, ascale,
                                                           res, T, K, dil, lrelu);
  return cudaGetLastError();
}

cudaError_t dispatch(const __nv_bfloat16* x, __nv_bfloat16* out, const int8_t* wq,
                     const float* wscale, const __nv_bfloat16* bias, const float* ascale,
                     const __nv_bfloat16* res, int B, int C, int T, int K, int dil, int lrelu,
                     cudaStream_t s, size_t* q) {
  switch (C) {
    case 64: return launch<64>(x, out, wq, wscale, bias, ascale, res, B, T, K, dil, lrelu, s, q);
    case 128: return launch<128>(x, out, wq, wscale, bias, ascale, res, B, T, K, dil, lrelu, s, q);
    case 256: return launch<256>(x, out, wq, wscale, bias, ascale, res, B, T, K, dil, lrelu, s, q);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One W8A8 conv.  x, out, residual: (B, C, T) bf16 contiguous, out
// distinct from both (residual may be null); w_q: (K, C_out, C_in) int8
// contiguous, 16-byte aligned; w_scale: (C,) fp32; bias: (C,) bf16;
// a_scale: one fp32 in device memory.  C in {64, 128, 256}, K in {3, 7,
// 11}, 1 <= dil <= 5; lrelu != 0 applies the leaky ReLU before
// quantizing.  Returns cudaGetLastError() after launch.
int rvc_conv1d_w8a8(const void* x, void* out, const void* w_q, const void* w_scale,
                    const void* bias, const void* a_scale, const void* residual, int B, int C,
                    int T, int K, int dil, int lrelu, void* stream) {
  if (B <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w_q) % 16) return (int)cudaErrorMisalignedAddress;
  return (int)dispatch(static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
                       static_cast<const int8_t*>(w_q), static_cast<const float*>(w_scale),
                       static_cast<const __nv_bfloat16*>(bias),
                       static_cast<const float*>(a_scale),
                       static_cast<const __nv_bfloat16*>(residual), B, C, T, K, dil, lrelu,
                       static_cast<cudaStream_t>(stream), nullptr);
}

// Dynamic shared memory, in bytes, of one launch at (C, K, dil); 0 for a
// shape the kernel does not take.
size_t rvc_conv1d_w8a8_smem_bytes(int C, int K, int dil) {
  size_t smem = 0;
  if (dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, C, 1, K, dil,
               0, nullptr, &smem) != cudaSuccess)
    return 0;
  return smem;
}

const char* rvc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
