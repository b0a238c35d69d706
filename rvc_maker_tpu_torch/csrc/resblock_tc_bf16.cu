// Fused HiFi-GAN resblock step for Hopper (sm_90a) on the tensor cores in
// bf16: bf16 in and out, fp32 accumulation, each product one
// mma.sync.m16n8k8 with bf16 operands.  Plain C interface, bound from
// Python with ctypes (rvc_maker_tpu_torch/ops/resblock.py, route "tc_bf16").
//
// Replaces: rvc_maker_tpu/ops/pallas_resblock.py `fused_resblock` (Pallas
// TPU kernel, body `_kernel`) in bf16, as csrc/resblock_tc.cu does in
// fp32; one dilation step d computes
//
//     t = bf16(lrelu(conv_{k,d}(bf16(lrelu(x))) + b1))  ; rows outside [0, T): 0
//     x = bf16(x + conv_{k,1}(t) + b2)                   ; rows outside [0, T) read as 0
//
// rounding lrelu(x) and the intermediate to bf16 where the Pallas kernel
// does (pallas_resblock.py:113, :119) and the output once.  The Pallas
// kernel keeps x in fp32 across the dilations of one resblock; this
// launch reads and writes bf16, so x is rounded between steps.
//
// What bounds it.  2*2*B*T*k*C^2 flops per step against one read and one
// write of (B, C, T) bf16: compute-bound.  A bf16 x bf16 product is exact
// in fp32, so one MMA per product keeps fp32 accumulation's accuracy; the
// dense bf16 rate is 989 TFLOP/s.
//
// The design is resblock_tc.cu's.  One launch per dilation step; a block
// owns TT output rows x all C channels of one batch row (TT = 16384 / C:
// 64 .. 1024); conv1 covers the conv2 halo; each step stages kCI = 8 input
// channels: lrelu(x) (loaded into registers a step ahead) and the k taps
// of w1 or w2 (a two-slot cp.async ring); conv1's output stays in shared
// memory with b1, lrelu and zeros outside [0, T); the conv2 epilogue adds
// b2 and x and writes along time through an fp32 tile in shared memory.
//
// The GEMMs.  Each conv is a sum over taps j of shifted products
// A_j (M time rows x 8 staged channels) @ W_j (8 x C_out), one m16n8k8 per
// 16-row m-tile, 8-column n-tile and tap:
//   conv1: A_j[m][c] = lrelu(x)[c][m + j*dil], M1 = TT + 2*HC rounded up
//          to 16 rows (HC = (k-1)/2);
//   conv2: A_j[m][c] = t[c][m + j], M = TT.
// Fragment maps of m16n8k8 bf16 (CUTLASS cute/arch/mma_sm80.hpp
// SM80_16x8x8_F32BF16BF16F32_TN), g = lane >> 2, q = lane & 3: a0 =
// A[g][2q..2q+1], a1 = A[g+8][2q..2q+1], each one 32-bit register of a
// bf16 pair (the lower column in the low half); b0 = B[2q..2q+1][g];
// c0..c3 = D[g][2q], D[g][2q+1], D[g+8][2q], D[g+8][2q+1].
//   A: lrelu(x) and the intermediate are staged as [channel pair][row]
//      32-bit words (__nv_bfloat162), so a0 is one 32-bit shared load at
//      any row offset j*dil or j; with a row stride of 8 (mod 32) words,
//      lane (g, q) reads bank 8q + g.  The conv1 epilogue's (c0, c1) are
//      two adjacent channels at one row: one intermediate word.
//   B: the weights keep their (k, C_in, C_out) layout, staged as
//      [tap][kCI][CS] bf16 with CS = C + 8; ldmatrix.trans gives b0 of one
//      n-tile from the 8 rows of an 8 x 8 tile.  A row is (C + 8) / 2 = 4
//      (mod 8) words, so the 8 rows fall on distinct 4-bank groups.
// tests/test_torch_resblock.py holds a numpy model of this index
// arithmetic (tc_bf16_step_model) against the plain chain and the Pallas
// kernel, with every fragment load checked for bank conflicts.
//
// Warp tiling: 8 warps; a warp owns NTW = min(4, C/8) n-tiles side by
// side and every WM-th m-tile (WN = C/(8*NTW) warps across N, WM = 8/WN
// across M), so one A fragment feeds NTW MMAs at every width from 32 up.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCI = 8;               // input channels staged per step: MMA K
constexpr int kCP = kCI / 2;         // channel pairs staged per step
constexpr int kMaxDil = 5;           // largest dilation the x staging holds
constexpr float kSlope = 0.1f;
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

__host__ __device__ constexpr int stride8(int n) {   // least s >= n, s = 8 mod 32
  return n + ((8 - n) % 32 + 32) % 32;
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : v * kSlope; }

// two floats rounded to bf16 (to nearest, ties to even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ float lo_bf16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }

// d += A(16x8) @ B(8x8), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// N transposed 8 x 8 bf16 tiles from shared memory: lanes 8i..8i+7 give
// the addresses of tile i's rows 0..7; r[i] = rows 2q, 2q+1 of column g
template <int N>
__device__ __forceinline__ void ldsm_trans(uint32_t* r, const void* row);
template <>
__device__ __forceinline__ void ldsm_trans<1>(uint32_t* r, const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
               : "=r"(r[0]) : "r"(s));
}
template <>
__device__ __forceinline__ void ldsm_trans<2>(uint32_t* r, const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}
template <>
__device__ __forceinline__ void ldsm_trans<4>(uint32_t* r, const void* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int C, int K>
struct TcTile {
  static constexpr int TT = 16384 / C;             // output rows per block
  static constexpr int HC = (K - 1) / 2;           // conv2 halo
  static constexpr int M1 = (TT + 2 * HC + 15) / 16 * 16;  // conv1 rows
  static constexpr int MT1 = M1 / 16;              // m-tiles of conv1
  static constexpr int MT2 = TT / 16;              // m-tiles of conv2
  static constexpr int NTW = C / 8 < 4 ? C / 8 : 4;  // n-tiles per warp
  static constexpr int WN = C / 8 / NTW;           // warps across N
  static constexpr int WM = kWarps / WN;           // warps across M
  static constexpr int MTW1 = (MT1 + WM - 1) / WM; // m-tiles per warp, conv1
  static constexpr int MTW2 = (MT2 + WM - 1) / WM; // m-tiles per warp, conv2
  static constexpr int CS = C + 8;                 // staged weight row stride, bf16
  static constexpr int S1 = stride8(M1);           // intermediate row stride, words
  static constexpr int TTP = TT + 4;               // output tile row stride, floats
  static constexpr int XPT =                       // staged x words per thread
      (kCP * stride8(M1 + (K - 1) * kMaxDil) + kThreads - 1) / kThreads;
  static constexpr int WSZ = K * kCI * CS;         // one weight stage, bf16
  static constexpr int WCH = kCI * C / 8;          // 16-byte chunks per tap
  static constexpr int NSTEP = C / kCI;
  static_assert(C % 16 == 0 && WN * NTW * 8 == C && kWarps % WN == 0, "unsupported width");
  static_assert(TT % 32 == 0, "the output tile's row stride is 4 mod 32 floats");
  static_assert(NSTEP % 2 == 0, "the weight double buffer alternates per step");
};

template <int C, int K>
__global__ void __launch_bounds__(kThreads, 1)
resblock_tc_bf16_step_kernel(const __nv_bfloat16* __restrict__ x,
                             __nv_bfloat16* __restrict__ out,
                             const __nv_bfloat16* __restrict__ w1,
                             const __nv_bfloat16* __restrict__ b1,
                             const __nv_bfloat16* __restrict__ w2,
                             const __nv_bfloat16* __restrict__ b2, int Tlen, int dil) {
  using P = TcTile<C, K>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][K][kCI][CS]
  uint32_t* t1s = reinterpret_cast<uint32_t*>(ws + 2 * P::WSZ);    // [C/2][S1] pairs
  const int xrs = stride8(P::M1 + (K - 1) * dil);                  // staged x row stride
  uint32_t* xs = t1s + (C / 2) * P::S1;                            // [2][kCP][xrs] pairs

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int wn = warp % P::WN;
  const int wm = warp / P::WN;
  const int t0 = blockIdx.x * P::TT;
  const __nv_bfloat16* xb = x + (size_t)blockIdx.y * C * Tlen;
  __nv_bfloat16* ob = out + (size_t)blockIdx.y * C * Tlen;
  const int xstart = t0 - P::HC - P::HC * dil;   // time of xs row 0

  // -- staging ---------------------------------------------------------
  // this thread's staged x words: offset of its pair's even channel from
  // channel ci0's row start, or -1 where the word lies off the sequence
  int xoff[P::XPT];
#pragma unroll
  for (int i = 0; i < P::XPT; ++i) {
    const int idx = tid + i * kThreads;
    const int cp = idx / xrs;
    const int t = xstart + (idx - cp * xrs);
    xoff[i] = (idx < kCP * xrs && t >= 0 && t < Tlen) ? 2 * cp * Tlen + t : -1;
  }
  uint32_t xreg[P::XPT];                 // raw bf16 pairs of x
  auto load_x = [&](int ci0) {           // channels ci0 .. ci0 + kCI
    const __nv_bfloat16* src = xb + (size_t)ci0 * Tlen;
#pragma unroll
    for (int i = 0; i < P::XPT; ++i)
      xreg[i] = xoff[i] >= 0 ? (uint32_t)__bfloat16_as_ushort(src[xoff[i]]) |
                                   ((uint32_t)__bfloat16_as_ushort(src[xoff[i] + Tlen]) << 16)
                             : 0u;
  };
  auto store_x = [&](int buf) {          // bf16(lrelu(x)), one word per pair
    uint32_t* dst = xs + buf * kCP * xrs;
#pragma unroll
    for (int i = 0; i < P::XPT; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < kCP * xrs)
        dst[idx] = pack_bf16(lrelu(lo_bf16(xreg[i])), lrelu(hi_bf16(xreg[i])));
    }
  };
  auto stage_w = [&](const __nv_bfloat16* w, int ci0, int buf) {  // K taps x kCI rows
    __nv_bfloat16* dst = ws + buf * P::WSZ;
    for (int i = tid; i < K * P::WCH; i += kThreads) {
      const int j = i / P::WCH;
      const int r = i - j * P::WCH;
      const int row = r / (C / 8);
      const int col = (r - row * (C / 8)) * 8;
      cp_async16(dst + (j * kCI + row) * P::CS + col,
                 w + (size_t)j * C * C + (size_t)(ci0 + row) * C + col);
    }
  };
  // B fragments of tap j for this warp's n-tiles: lane 8i + r addresses
  // row r of n-tile i
  const int b_off = (lane & 7) * P::CS + (wn * P::NTW + ((lane >> 3) & (P::NTW - 1))) * 8;
  auto load_b = [&](const __nv_bfloat16* wsb, int j, uint32_t* b) {
    ldsm_trans<P::NTW>(b, wsb + j * kCI * P::CS + b_off);
  };

  // ---- conv1 over rows [t0 - HC, t0 - HC + M1) ----------------------
  float acc1[P::MTW1][P::NTW][4];
#pragma unroll
  for (int im = 0; im < P::MTW1; ++im)
#pragma unroll
    for (int in = 0; in < P::NTW; ++in)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc1[im][in][r] = 0.f;

  load_x(0);
  stage_w(w1, 0, 0);
  cp_async_commit();
  for (int s = 0; s < P::NSTEP; ++s) {
    store_x(s & 1);
    cp_async_wait_all();
    __syncthreads();   // step s staged; every thread is past step s-1
    if (s + 1 < P::NSTEP) {
      load_x((s + 1) * kCI);
      stage_w(w1, (s + 1) * kCI, (s + 1) & 1);
    } else {
      stage_w(w2, 0, 0);               // conv2's first step
    }
    cp_async_commit();
    const __nv_bfloat16* wsb = ws + (s & 1) * P::WSZ;
    const uint32_t* xa = xs + (s & 1) * kCP * xrs + q * xrs + g;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      uint32_t b[P::NTW];
      load_b(wsb, j, b);
      const uint32_t* xj = xa + j * dil;
#pragma unroll
      for (int im = 0; im < P::MTW1; ++im) {
        const int mt = wm + P::WM * im;
        if (P::MT1 % P::WM == 0 || mt < P::MT1) {
          const uint32_t a0 = xj[mt * 16], a1 = xj[mt * 16 + 8];
#pragma unroll
          for (int in = 0; in < P::NTW; ++in) mma_bf16(acc1[im][in], a0, a1, b[in]);
        }
      }
    }
  }

  // ---- bf16(lrelu(+ b1)), 0 outside the sequence -> shared memory ---
#pragma unroll
  for (int im = 0; im < P::MTW1; ++im) {
    const int mt = wm + P::WM * im;
    if (P::MT1 % P::WM == 0 || mt < P::MT1) {
#pragma unroll
      for (int in = 0; in < P::NTW; ++in) {
        const int n = (wn * P::NTW + in) * 8 + 2 * q;
        const float bn0 = __bfloat162float(b1[n]), bn1 = __bfloat162float(b1[n + 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + g + 8 * h;
          const int t = t0 - P::HC + m;
          t1s[(n / 2) * P::S1 + m] =
              (t >= 0 && t < Tlen)
                  ? pack_bf16(lrelu(acc1[im][in][2 * h] + bn0), lrelu(acc1[im][in][2 * h + 1] + bn1))
                  : 0u;
        }
      }
    }
  }

  // ---- conv2 over rows [t0, t0 + TT) from shared memory -------------
  float acc2[P::MTW2][P::NTW][4];
#pragma unroll
  for (int im = 0; im < P::MTW2; ++im)
#pragma unroll
    for (int in = 0; in < P::NTW; ++in)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc2[im][in][r] = 0.f;

  for (int s = 0; s < P::NSTEP; ++s) {
    cp_async_wait_all();
    __syncthreads();   // step s staged (and, at s = 0, t1s complete)
    if (s + 1 < P::NSTEP) stage_w(w2, (s + 1) * kCI, (s + 1) & 1);
    cp_async_commit();
    const __nv_bfloat16* wsb = ws + (s & 1) * P::WSZ;
    const uint32_t* ta = t1s + (s * kCP + q) * P::S1 + g;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      uint32_t b[P::NTW];
      load_b(wsb, j, b);
#pragma unroll
      for (int im = 0; im < P::MTW2; ++im) {
        const int mt = wm + P::WM * im;
        if (P::MT2 % P::WM == 0 || mt < P::MT2) {
          const uint32_t a0 = ta[mt * 16 + j], a1 = ta[mt * 16 + 8 + j];
#pragma unroll
          for (int in = 0; in < P::NTW; ++in) mma_bf16(acc2[im][in], a0, a1, b[in]);
        }
      }
    }
  }

  // ---- + b2 into an fp32 tile over the staging buffers, then
  // ---- bf16(x + tile) along time ------------------------------------
  __syncthreads();     // every thread is done reading ws and t1s
  float* tile = reinterpret_cast<float*>(smem_raw);   // [C][TTP]
#pragma unroll
  for (int im = 0; im < P::MTW2; ++im) {
    const int mt = wm + P::WM * im;
    if (P::MT2 % P::WM == 0 || mt < P::MT2) {
#pragma unroll
      for (int in = 0; in < P::NTW; ++in) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int m = mt * 16 + g + 8 * (r >> 1);
          const int n = (wn * P::NTW + in) * 8 + 2 * q + (r & 1);
          tile[n * P::TTP + m] = acc2[im][in][r] + __bfloat162float(b2[n]);
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < C * P::TT; idx += kThreads) {
    const int n = idx / P::TT;
    const int r = idx - n * P::TT;
    const int t = t0 + r;
    if (t < Tlen) {
      const size_t o = (size_t)n * Tlen + t;
      ob[o] = __float2bfloat16_rn(__bfloat162float(xb[o]) + tile[n * P::TTP + r]);
    }
  }
}

// Launches one step, or, with smem_query set, only reports the dynamic
// shared memory the launch would take.
template <int C, int K>
cudaError_t launch(const __nv_bfloat16* x, __nv_bfloat16* out, const __nv_bfloat16* w1,
                   const __nv_bfloat16* b1, const __nv_bfloat16* w2,
                   const __nv_bfloat16* b2, int B, int Tlen, int dil, cudaStream_t stream,
                   size_t* smem_query) {
  using P = TcTile<C, K>;
  if (dil > kMaxDil) return cudaErrorInvalidValue;
  const size_t xrs = (size_t)stride8(P::M1 + (K - 1) * dil);
  const size_t staging = 2 * sizeof(__nv_bfloat16) * (size_t)P::WSZ +
                         sizeof(uint32_t) * ((size_t)(C / 2) * P::S1 + 2 * kCP * xrs);
  const size_t tile = sizeof(float) * (size_t)C * P::TTP;
  const size_t smem = staging > tile ? staging : tile;
  if (smem_query) {
    *smem_query = smem;
    return cudaSuccess;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(resblock_tc_bf16_step_kernel<C, K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tlen + P::TT - 1) / P::TT, B);
  resblock_tc_bf16_step_kernel<C, K><<<grid, kThreads, smem, stream>>>(x, out, w1, b1, w2,
                                                                        b2, Tlen, dil);
  return cudaGetLastError();
}

using bf16p = const __nv_bfloat16*;

template <int C>
cudaError_t dispatch_k(bf16p x, __nv_bfloat16* out, bf16p w1, bf16p b1, bf16p w2, bf16p b2,
                       int B, int Tlen, int K, int dil, cudaStream_t s, size_t* q) {
  switch (K) {
    case 3: return launch<C, 3>(x, out, w1, b1, w2, b2, B, Tlen, dil, s, q);
    case 7: return launch<C, 7>(x, out, w1, b1, w2, b2, B, Tlen, dil, s, q);
    case 11: return launch<C, 11>(x, out, w1, b1, w2, b2, B, Tlen, dil, s, q);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(bf16p x, __nv_bfloat16* out, bf16p w1, bf16p b1, bf16p w2, bf16p b2,
                     int B, int C, int Tlen, int K, int dil, cudaStream_t s, size_t* q) {
  switch (C) {
    case 16: return dispatch_k<16>(x, out, w1, b1, w2, b2, B, Tlen, K, dil, s, q);
    case 32: return dispatch_k<32>(x, out, w1, b1, w2, b2, B, Tlen, K, dil, s, q);
    case 64: return dispatch_k<64>(x, out, w1, b1, w2, b2, B, Tlen, K, dil, s, q);
    case 128: return dispatch_k<128>(x, out, w1, b1, w2, b2, B, Tlen, K, dil, s, q);
    case 256: return dispatch_k<256>(x, out, w1, b1, w2, b2, B, Tlen, K, dil, s, q);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One dilation step of a resblock in bf16: out = x + conv2(lrelu(conv1(
// lrelu(x)))), fp32 accumulation.  x, out: (B, C, T) contiguous, distinct
// buffers.  w1, w2: (K, C_in, C_out) contiguous (this step's taps),
// 16-byte aligned; b1, b2: (C,).  All six bf16.  C in {16, 32, 64, 128,
// 256}, K in {3, 7, 11}, 1 <= dil <= 5.  Returns cudaGetLastError() after
// launch.
int rvc_resblock_tc_bf16_step(const void* x, void* out, const void* w1, const void* b1,
                              const void* w2, const void* b2, int B, int C, int T, int K,
                              int dil, void* stream) {
  if (B <= 0 || T <= 0 || dil <= 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) % 16)
    return (int)cudaErrorMisalignedAddress;
  return (int)dispatch(static_cast<bf16p>(x), static_cast<__nv_bfloat16*>(out),
                       static_cast<bf16p>(w1), static_cast<bf16p>(b1),
                       static_cast<bf16p>(w2), static_cast<bf16p>(b2), B, C, T, K, dil,
                       static_cast<cudaStream_t>(stream), nullptr);
}

// Dynamic shared memory, in bytes, of one step at (C, K, dil); 0 for a
// shape the kernel does not take.
size_t rvc_resblock_tc_bf16_smem_bytes(int C, int K, int dil) {
  size_t smem = 0;
  if (dil <= 0 || dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, C, 1,
                           K, dil, nullptr, &smem) != cudaSuccess)
    return 0;
  return smem;
}

const char* rvc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
