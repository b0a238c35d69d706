// Fused HiFi-GAN resblock step for Hopper (sm_90a) on the tensor cores:
// fp32 in and out, fp32 accumulation, each product in 3xTF32 through
// mma.sync.m16n8k4.  Plain C interface, bound from Python with ctypes
// (rvc_maker_tpu_torch/ops/resblock.py, route "tc").
//
// Replaces: rvc_maker_tpu/ops/pallas_resblock.py `fused_resblock`
// (Pallas TPU kernel, body `_kernel`), as csrc/resblock.cu does; one
// dilation step d computes
//
//     t = conv_{k,d}(lrelu(x)) + b1      ; rows outside [0, T) read as 0
//     t = lrelu(t)                       ; zeroed outside [0, T)
//     x = x + conv_{k,1}(t) + b2         ; rows outside [0, T) read as 0
//
// What bounds it.  2*2*B*T*k*C^2 flops per step against one read and one
// write of (B, C, T): compute-bound.  csrc/resblock.cu runs them as fp32
// FMA on the CUDA cores, 67 TFLOP/s at most; the tensor cores take TF32
// at 495 TFLOP/s (dense), and three TF32 products per fp32 product keep
// fp32's accuracy (below), so 165 TFLOP/s of fp32 work is the ceiling.
//
// The design is resblock.cu's, with its two inner FMA loops replaced by
// MMAs.  One launch per dilation step; a block owns TT output rows x all
// C channels of one batch row (TT = 16384 / C: 64 .. 1024); conv1 covers
// the conv2 halo; each step stages kCI = 4 input channels: lrelu(x)
// (loaded into registers a step ahead) and the k taps of w1 or w2 (a
// two-slot cp.async ring); conv1's output stays in shared memory with
// b1, lrelu and zeros outside [0, T); the conv2 epilogue adds b2 and x
// and writes along time through shared memory.
//
// The GEMMs.  Each conv is a sum over taps j of shifted products
// A_j (M time rows x 4 staged channels) @ W_j (4 x C_out), one
// m16n8k4 per 16-row m-tile, 8-column n-tile and tap:
//   conv1: A_j[m][c] = lrelu(x)[c][m + j*dil], M1 = TT + 2*HC rounded up
//          to 16 rows (HC = (k-1)/2);
//   conv2: A_j[m][c] = t[c][m + j], M = TT.
// There is no im2col buffer: a fragment is read straight from the staged
// rows at offset j*dil or j.  Fragment maps of m16n8k4 TF32 (CUTLASS
// cute/arch/mma_sm80.hpp SM80_16x8x4_F32TF32TF32F32_TN), g = lane >> 2,
// q = lane & 3: a0 = A[g][q], a1 = A[g+8][q]; b0 = B[q][g]; c0..c3 =
// D[g][2q], D[g][2q+1], D[g+8][2q], D[g+8][2q+1].  They are loaded with
// plain 32-bit shared loads, which take any row offset (ldmatrix and WMMA
// want aligned rows, which the offsets j*dil break).  The row strides
// make every fragment load conflict-free: the staged x [c][row] and the
// intermediate [c][row] have a row stride of 8 (mod 32) words, so lane
// (g, q) reads bank 8q + g; the staged weights [tap][c][co] a co stride
// of C + 8.  tests/test_torch_resblock.py holds a numpy model of this
// index arithmetic (tc_step_model) against the plain chain.
//
// 3xTF32.  Each fp32 operand v is split where its fragment is loaded:
// hi = rna_tf32(v), lo = rna_tf32(v - hi); then three MMAs, small terms
// first: (a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi).  One pass alone errs
// by about 3e-4 of the result at k = 11, C = 256; three passes stay
// within 3x of fp32 FMA summed in the same order (numpy emulation in the
// same test file).  The split at load leaves shared memory fp32.
//
// Warp tiling: 8 warps, WN = min(8, C/8) across N, WM = 8/WN across M;
// a warp owns C/(8*WN) n-tiles side by side and every WM-th m-tile, its
// accumulators in registers (at C = 256: 5 x 4 tiles in conv1).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCI = 4;               // input channels staged per step: MMA K
constexpr int kMaxDil = 5;           // largest dilation the x staging holds
constexpr float kSlope = 0.1f;
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

__host__ __device__ constexpr int stride8(int n) {   // least s >= n, s = 8 mod 32
  return n + ((8 - n) % 32 + 32) % 32;
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : v * kSlope; }

// cvt.rna.tf32.f32 (round to nearest, ties away from zero) for finite v,
// in two integer operations instead of a conversion instruction
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// d += A(16x4) @ B(4x8), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float* d, uint32_t a0, uint32_t a1, uint32_t b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// d += A @ B in 3xTF32, small terms first
__device__ __forceinline__ void mma_3xtf32(float* d, uint32_t a0h, uint32_t a0l,
                                           uint32_t a1h, uint32_t a1l, uint32_t bh,
                                           uint32_t bl) {
  mma_tf32(d, a0l, a1l, bh);
  mma_tf32(d, a0h, a1h, bl);
  mma_tf32(d, a0h, a1h, bh);
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
  static constexpr int WN = C / 8 < kWarps ? C / 8 : kWarps;  // warps across N
  static constexpr int WM = kWarps / WN;           // warps across M
  static constexpr int NTW = C / 8 / WN;           // n-tiles per warp
  static constexpr int MTW1 = (MT1 + WM - 1) / WM; // m-tiles per warp, conv1
  static constexpr int MTW2 = (MT2 + WM - 1) / WM; // m-tiles per warp, conv2
  static constexpr int CS = C + 8;                 // staged weight row stride
  static constexpr int S1 = stride8(M1);           // intermediate row stride
  static constexpr int TTP = TT + 4;               // output tile row stride
  static constexpr int XPT =                       // staged x values per thread
      (kCI * stride8(M1 + (K - 1) * kMaxDil) + kThreads - 1) / kThreads;
  static constexpr int WSZ = K * kCI * CS;         // one weight stage, floats
  static constexpr int WCH = kCI * C / 4;          // 16-byte chunks per tap
  static constexpr int NSTEP = C / kCI;
  static_assert(C % 8 == 0 && (C / 8) % WN == 0, "unsupported width");
  static_assert(TT % 16 == 0 && TTP <= S1, "the output tile reuses the intermediate");
  static_assert(NSTEP % 2 == 0, "the weight double buffer alternates per step");
};

template <int C, int K>
__global__ void __launch_bounds__(kThreads, 1)
resblock_tc_step_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const float* __restrict__ w1, const float* __restrict__ b1,
                        const float* __restrict__ w2, const float* __restrict__ b2,
                        int Tlen, int dil) {
  using P = TcTile<C, K>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ws = reinterpret_cast<float*>(smem_raw);   // [2][K][kCI][CS]
  float* t1s = ws + 2 * P::WSZ;                     // [C][S1]
  const int xrs = stride8(P::M1 + (K - 1) * dil);   // staged x row stride
  float* xs = t1s + C * P::S1;                      // [2][kCI][xrs]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int wn = warp % P::WN;
  const int wm = warp / P::WN;
  const int t0 = blockIdx.x * P::TT;
  const float* xb = x + (size_t)blockIdx.y * C * Tlen;
  float* ob = out + (size_t)blockIdx.y * C * Tlen;
  const int xstart = t0 - P::HC - P::HC * dil;   // time of xs row 0

  // -- staging ---------------------------------------------------------
  // this thread's staged x slots: offset from channel ci0's row start,
  // or -1 where the slot lies off the sequence (it stages 0)
  int xoff[P::XPT];
#pragma unroll
  for (int i = 0; i < P::XPT; ++i) {
    const int idx = tid + i * kThreads;
    const int cc = idx / xrs;
    const int t = xstart + (idx - cc * xrs);
    xoff[i] = (idx < kCI * xrs && t >= 0 && t < Tlen) ? cc * Tlen + t : -1;
  }
  float xreg[P::XPT];
  auto load_x = [&](int ci0) {        // raw x of channels ci0 .. ci0 + kCI
    const float* src = xb + (size_t)ci0 * Tlen;
#pragma unroll
    for (int i = 0; i < P::XPT; ++i) xreg[i] = xoff[i] >= 0 ? src[xoff[i]] : 0.f;
  };
  auto store_x = [&](int buf) {
    float* dst = xs + buf * kCI * xrs;
#pragma unroll
    for (int i = 0; i < P::XPT; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < kCI * xrs) dst[idx] = lrelu(xreg[i]);
    }
  };
  auto stage_w = [&](const float* w, int ci0, int buf) {   // K taps x kCI rows of w
    float* dst = ws + buf * P::WSZ;
    for (int i = tid; i < K * P::WCH; i += kThreads) {
      const int j = i / P::WCH;
      const int r = i - j * P::WCH;
      const int row = r / (C / 4);
      const int col = (r - row * (C / 4)) * 4;
      cp_async16(dst + (j * kCI + row) * P::CS + col,
                 w + (size_t)j * C * C + (size_t)(ci0 + row) * C + col);
    }
  };
  // B fragments of tap j for this warp's n-tiles, split into hi and lo
  auto load_b = [&](const float* wsb, int j, uint32_t* bh, uint32_t* bl) {
    const float* wrow = wsb + (j * kCI + q) * P::CS + wn * P::NTW * 8 + g;
#pragma unroll
    for (int in = 0; in < P::NTW; ++in) split_tf32(wrow[in * 8], bh[in], bl[in]);
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
    const float* wsb = ws + (s & 1) * P::WSZ;
    const float* xa = xs + (s & 1) * kCI * xrs + q * xrs + g;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      uint32_t bh[P::NTW], bl[P::NTW];
      load_b(wsb, j, bh, bl);
      const float* xj = xa + j * dil;
#pragma unroll
      for (int im = 0; im < P::MTW1; ++im) {
        const int mt = wm + P::WM * im;
        if (P::MT1 % P::WM == 0 || mt < P::MT1) {
          uint32_t a0h, a0l, a1h, a1l;
          split_tf32(xj[mt * 16], a0h, a0l);
          split_tf32(xj[mt * 16 + 8], a1h, a1l);
#pragma unroll
          for (int in = 0; in < P::NTW; ++in)
            mma_3xtf32(acc1[im][in], a0h, a0l, a1h, a1l, bh[in], bl[in]);
        }
      }
    }
  }

  // ---- + b1, zero outside the sequence, lrelu -> shared memory ------
#pragma unroll
  for (int im = 0; im < P::MTW1; ++im) {
    const int mt = wm + P::WM * im;
    if (P::MT1 % P::WM == 0 || mt < P::MT1) {
#pragma unroll
      for (int in = 0; in < P::NTW; ++in) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int m = mt * 16 + g + 8 * (r >> 1);
          const int n = (wn * P::NTW + in) * 8 + 2 * q + (r & 1);
          const int t = t0 - P::HC + m;
          t1s[n * P::S1 + m] = (t >= 0 && t < Tlen) ? lrelu(acc1[im][in][r] + __ldg(b1 + n)) : 0.f;
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
    const float* wsb = ws + (s & 1) * P::WSZ;
    const float* ta = t1s + (s * kCI + q) * P::S1 + g;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      uint32_t bh[P::NTW], bl[P::NTW];
      load_b(wsb, j, bh, bl);
#pragma unroll
      for (int im = 0; im < P::MTW2; ++im) {
        const int mt = wm + P::WM * im;
        if (P::MT2 % P::WM == 0 || mt < P::MT2) {
          uint32_t a0h, a0l, a1h, a1l;
          split_tf32(ta[mt * 16 + j], a0h, a0l);
          split_tf32(ta[mt * 16 + 8 + j], a1h, a1l);
#pragma unroll
          for (int in = 0; in < P::NTW; ++in)
            mma_3xtf32(acc2[im][in], a0h, a0l, a1h, a1l, bh[in], bl[in]);
        }
      }
    }
  }

  // ---- + b2 into a tile in shared memory, then x + tile along time --
  __syncthreads();     // every thread is done reading t1s
  float* tile = t1s;   // [C][TTP]
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
          tile[n * P::TTP + m] = acc2[im][in][r] + __ldg(b2 + n);
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
      ob[o] = xb[o] + tile[n * P::TTP + r];
    }
  }
}

// Launches one step, or, with smem_query set, only reports the dynamic
// shared memory the launch would take.
template <int C, int K>
cudaError_t launch(const float* x, float* out, const float* w1, const float* b1,
                   const float* w2, const float* b2, int B, int Tlen, int dil,
                   cudaStream_t stream, size_t* smem_query) {
  using P = TcTile<C, K>;
  if (dil > kMaxDil) return cudaErrorInvalidValue;
  const size_t xrs = (size_t)stride8(P::M1 + (K - 1) * dil);
  const size_t smem =
      sizeof(float) * (2 * (size_t)P::WSZ + (size_t)C * P::S1 + 2 * kCI * xrs);
  if (smem_query) {
    *smem_query = smem;
    return cudaSuccess;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(resblock_tc_step_kernel<C, K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tlen + P::TT - 1) / P::TT, B);
  resblock_tc_step_kernel<C, K><<<grid, kThreads, smem, stream>>>(x, out, w1, b1, w2, b2,
                                                                   Tlen, dil);
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch_k(const float* x, float* out, const float* w1, const float* b1,
                       const float* w2, const float* b2, int B, int Tlen, int K,
                       int dil, cudaStream_t s, size_t* q) {
  switch (K) {
    case 3: return launch<C, 3>(x, out, w1, b1, w2, b2, B, Tlen, dil, s, q);
    case 7: return launch<C, 7>(x, out, w1, b1, w2, b2, B, Tlen, dil, s, q);
    case 11: return launch<C, 11>(x, out, w1, b1, w2, b2, B, Tlen, dil, s, q);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const float* x, float* out, const float* w1, const float* b1,
                     const float* w2, const float* b2, int B, int C, int Tlen, int K,
                     int dil, cudaStream_t s, size_t* q) {
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

// One dilation step of a resblock in fp32: out = x + conv2(lrelu(conv1(
// lrelu(x)))).  x, out: (B, C, T) contiguous, distinct buffers.  w1, w2:
// (K, C_in, C_out) contiguous (this step's taps), 16-byte aligned; b1,
// b2: (C,).  C in {16, 32, 64, 128, 256}, K in {3, 7, 11}, 1 <= dil <= 5.
// Returns cudaGetLastError() after launch.
int rvc_resblock_tc_step(const void* x, void* out, const void* w1, const void* b1,
                         const void* w2, const void* b2, int B, int C, int T, int K,
                         int dil, void* stream) {
  if (B <= 0 || T <= 0 || dil <= 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) % 16)
    return (int)cudaErrorMisalignedAddress;
  return (int)dispatch(static_cast<const float*>(x), static_cast<float*>(out),
                       static_cast<const float*>(w1), static_cast<const float*>(b1),
                       static_cast<const float*>(w2), static_cast<const float*>(b2), B, C,
                       T, K, dil, static_cast<cudaStream_t>(stream), nullptr);
}

// Dynamic shared memory, in bytes, of one step at (C, K, dil); 0 for a
// shape the kernel does not take.
size_t rvc_resblock_tc_smem_bytes(int C, int K, int dil) {
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
