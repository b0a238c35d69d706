// Fused HiFi-GAN resblock step for Hopper (sm_90a), fp32 or bf16 in/out,
// fp32 accumulation.  Plain C interface, bound from Python with ctypes
// (rvc_maker_tpu_torch/ops/resblock.py).
//
// Replaces: rvc_maker_tpu/ops/pallas_resblock.py `fused_resblock`
// (Pallas TPU kernel, body `_kernel`).  One resblock is, for each
// dilation d in (1, 3, 5):
//
//     t = conv_{k,d}(lrelu(x)) + b1      ; rows outside [0, T) read as 0
//     t = lrelu(t)                       ; zeroed outside [0, T)
//     x = x + conv_{k,1}(t) + b2         ; rows outside [0, T) read as 0
//
// with leaky-ReLU slope 0.1.  That is the reference's zero conv padding
// at the sequence edges, which the TPU kernel reproduces by re-zeroing
// out-of-sequence rows after every conv.
//
// Why the TPU design does not carry over.  The TPU kernel keeps one time
// tile plus a halo of sum_d c*(d+1) rows per side (60 rows at k=11, c =
// (k-1)/2) in VMEM, runs all three dilations on it, and keeps every
// weight of the resblock resident.  At C=256 in fp32 the tile and one
// intermediate need about 2 * (T_tile + 120) * 1 KB, and one conv's
// weights 11 * 256 * 256 * 4 B = 2.9 MB: neither fits the 227 KB of
// shared memory a Hopper block can use.
//
// The design here.  One launch per dilation step (3 per resblock, 36 per
// v2-48k decode).  A block owns TT output rows x all C channels of one
// batch row; x is (B, C, T) with time contiguous, the layout cuDNN and
// F.conv_transpose1d use for the rest of the decode, so the port needs
// no transposes around the kernel.
//   1. conv1 for TT + 2c rows (the halo that conv2 needs) x C channels,
//      as a register-tiled product: each thread holds RM1 rows x 8
//      channels of accumulators.  Each step stages 4 input channels:
//      their k taps of w1 (cp.async, double-buffered, so the next
//      step's weights stream in from L2 while this step computes) and
//      lrelu(x) (loaded into registers a step ahead, double-buffered).
//      One barrier per step.
//   2. + b1, zero outside [0, T), lrelu; the result stays in shared
//      memory (C x (TT + 2c) fp32, about 80 KB at every stage width:
//      TT = 64/128/256/512/1024 for C = 256/128/64/32/16).
//   3. conv2 from that buffer, w2 staged the same way; + b2 + x, staged
//      through shared memory so that x is read and the output written
//      along time, coalesced.  The intermediate never touches device
//      memory, and x is read once (plus halo) and written once per step.
//
// What bounds it.  Per resblock 2*2*D*B*T*k*C^2 flops against one read
// and one write of (B, T, C) per step: about 900 flops per byte at
// v2-48k, so it is compute-bound.  This version uses fp32 FMA on the
// CUDA cores (67 TFLOP/s peak), in fp32 and in bf16; tensor cores
// (mma/wgmma) are later work.  The halo recompute of conv1 costs
// (TT + 2c) / TT, at most 16 %.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCI = 4;               // input channels staged per step
constexpr int kMaxDil = 5;           // largest dilation the x staging holds
constexpr float kSlope = 0.1f;
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on sm_90

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : v * kSlope; }

// four consecutive values from shared memory as float (one vector load)
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
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

template <typename T, int C, int K>
struct Tile {
  static constexpr int RN = 8;                     // channels per thread
  static constexpr int TN = C / RN;                // threads across channels
  static constexpr int TM = kThreads / TN;         // threads across rows
  static constexpr int RM2 = 8;                    // conv2 rows per thread
  static constexpr int TT = TM * RM2;              // output rows per block
  static constexpr int HC = (K - 1) / 2;           // conv2 halo
  static constexpr int RM1 = RM2 + (2 * HC + TM - 1) / TM;  // conv1 rows per thread
  static constexpr int M1 = RM1 * TM;              // conv1 rows per block, >= TT + 2*HC
  static constexpr int S1 = M1 + 1;                // odd row stride: no bank conflicts
  static constexpr int TTP = TT + 1;               // output tile row stride
  static constexpr int XPT =                       // staged x values per thread
      (kCI * (M1 + (K - 1) * kMaxDil) + kThreads - 1) / kThreads;
  static constexpr int WSZ = K * kCI * C;          // one weight stage, elements
  static constexpr int WCH = kCI * C * (int)sizeof(T) / 16;  // 16-byte chunks per tap
  static constexpr int NSTEP = C / kCI;
  static_assert(C % RN == 0 && kThreads % TN == 0, "unsupported width");
  static_assert(NSTEP % 2 == 0, "the weight double buffer alternates per step");
  static_assert(kCI * C * (int)sizeof(T) % 16 == 0, "cp.async moves 16 bytes");
};

template <typename T, int C, int K>
__global__ void __launch_bounds__(kThreads, 1)
resblock_step_kernel(const T* __restrict__ x, T* __restrict__ out,
                     const T* __restrict__ w1, const T* __restrict__ b1,
                     const T* __restrict__ w2, const T* __restrict__ b2,
                     int Tlen, int dil) {
  using P = Tile<T, C, K>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ws = reinterpret_cast<T*>(smem_raw);                  // [2][K][kCI][C]
  float* t1s = reinterpret_cast<float*>(ws + 2 * P::WSZ);  // [C][S1]
  const int xr = P::M1 + (K - 1) * dil;                    // staged x rows
  float* xs = t1s + C * P::S1;                             // [2][kCI][xr]

  const int tid = threadIdx.x;
  const int tn = tid % P::TN;
  const int tm = tid / P::TN;
  const int t0 = blockIdx.x * P::TT;
  const T* xb = x + (size_t)blockIdx.y * C * Tlen;
  T* ob = out + (size_t)blockIdx.y * C * Tlen;
  const int xstart = t0 - P::HC - P::HC * dil;   // time of xs row 0

  // this thread's 8 channels: 4 in each half, so that each half is one
  // conflict-free vector load from the staged weights
  auto chan = [&](int jn) { return (jn < 4 ? 0 : C / 2) + tn * 4 + (jn & 3); };

  // -- staging ---------------------------------------------------------
  // this thread's staged x slots: offset from channel ci0's row start,
  // or -1 where the slot lies off the sequence (it stages 0)
  int xoff[P::XPT];
#pragma unroll
  for (int q = 0; q < P::XPT; ++q) {
    const int idx = tid + q * kThreads;
    const int cc = idx / xr;
    const int t = xstart + (idx - cc * xr);
    xoff[q] = (idx < kCI * xr && t >= 0 && t < Tlen) ? cc * Tlen + t : -1;
  }
  T xreg[P::XPT];
  auto load_x = [&](int ci0) {        // raw x of channels ci0 .. ci0 + kCI
    const T* src = xb + (size_t)ci0 * Tlen;
#pragma unroll
    for (int q = 0; q < P::XPT; ++q)
      xreg[q] = xoff[q] >= 0 ? src[xoff[q]] : from_f<T>(0.f);
  };
  auto store_x = [&](int buf) {
    float* dst = xs + buf * kCI * xr;
#pragma unroll
    for (int q = 0; q < P::XPT; ++q) {
      const int idx = tid + q * kThreads;
      if (idx < kCI * xr) dst[idx] = lrelu(to_f(xreg[q]));
    }
  };
  auto stage_w = [&](const T* w, int ci0, int buf) {   // K taps x kCI rows of w
    unsigned char* dst = reinterpret_cast<unsigned char*>(ws + buf * P::WSZ);
    for (int q = tid; q < K * P::WCH; q += kThreads) {
      const int j = q / P::WCH;
      const int r = q - j * P::WCH;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          w + (size_t)j * C * C + (size_t)ci0 * C);
      cp_async16(dst + (size_t)j * kCI * C * sizeof(T) + r * 16, src + r * 16);
    }
  };

  // ---- conv1 over rows [t0 - HC, t0 - HC + M1) ----------------------
  float acc1[P::RM1][P::RN];
#pragma unroll
  for (int i = 0; i < P::RM1; ++i)
#pragma unroll
    for (int jn = 0; jn < P::RN; ++jn) acc1[i][jn] = 0.f;

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
    const T* wsb = ws + (s & 1) * P::WSZ;
    const float* xsb = xs + (s & 1) * kCI * xr;
#pragma unroll
    for (int cc = 0; cc < kCI; ++cc) {
      const float* xrow = xsb + cc * xr + tm;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float bv[P::RN];
        const T* wrow = wsb + (j * kCI + cc) * C + tn * 4;
        load4(wrow, bv);
        load4(wrow + C / 2, bv + 4);
        const int off = j * dil;
#pragma unroll
        for (int i = 0; i < P::RM1; ++i) {
          const float a = xrow[P::TM * i + off];
#pragma unroll
          for (int jn = 0; jn < P::RN; ++jn) acc1[i][jn] = fmaf(a, bv[jn], acc1[i][jn]);
        }
      }
    }
  }

  // ---- + b1, zero outside the sequence, lrelu -> shared memory ------
#pragma unroll
  for (int i = 0; i < P::RM1; ++i) {
    const int m = tm + P::TM * i;
    const int t = t0 - P::HC + m;
    const bool in_seq = t >= 0 && t < Tlen;
#pragma unroll
    for (int jn = 0; jn < P::RN; ++jn) {
      const int n = chan(jn);
      t1s[n * P::S1 + m] = in_seq ? lrelu(acc1[i][jn] + to_f(b1[n])) : 0.f;
    }
  }

  // ---- conv2 over rows [t0, t0 + TT) from shared memory -------------
  float acc2[P::RM2][P::RN];
#pragma unroll
  for (int i = 0; i < P::RM2; ++i)
#pragma unroll
    for (int jn = 0; jn < P::RN; ++jn) acc2[i][jn] = 0.f;

  for (int s = 0; s < P::NSTEP; ++s) {
    cp_async_wait_all();
    __syncthreads();   // step s staged (and, at s = 0, t1s complete)
    if (s + 1 < P::NSTEP) stage_w(w2, (s + 1) * kCI, (s + 1) & 1);
    cp_async_commit();
    const T* wsb = ws + (s & 1) * P::WSZ;
#pragma unroll
    for (int cc = 0; cc < kCI; ++cc) {
      const float* trow = t1s + (s * kCI + cc) * P::S1 + tm;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        float bv[P::RN];
        const T* wrow = wsb + (j * kCI + cc) * C + tn * 4;
        load4(wrow, bv);
        load4(wrow + C / 2, bv + 4);
#pragma unroll
        for (int i = 0; i < P::RM2; ++i) {
          const float a = trow[P::TM * i + j];
#pragma unroll
          for (int jn = 0; jn < P::RN; ++jn) acc2[i][jn] = fmaf(a, bv[jn], acc2[i][jn]);
        }
      }
    }
  }

  // ---- + b2 into a tile in shared memory, then x + tile along time --
  __syncthreads();     // every thread is done reading t1s
  float* tile = t1s;   // [C][TTP]
#pragma unroll
  for (int i = 0; i < P::RM2; ++i) {
    const int r = tm + P::TM * i;
#pragma unroll
    for (int jn = 0; jn < P::RN; ++jn) {
      const int n = chan(jn);
      tile[n * P::TTP + r] = acc2[i][jn] + to_f(b2[n]);
    }
  }
  __syncthreads();
  for (int idx = tid; idx < C * P::TT; idx += kThreads) {
    const int n = idx / P::TT;
    const int r = idx - n * P::TT;
    const int t = t0 + r;
    if (t < Tlen) {
      const size_t o = (size_t)n * Tlen + t;
      ob[o] = from_f<T>(to_f(xb[o]) + tile[n * P::TTP + r]);
    }
  }
}

// Launches one step, or, with smem_query set, only reports the dynamic
// shared memory the launch would take.
template <typename T, int C, int K>
cudaError_t launch(const void* x, void* out, const void* w1, const void* b1,
                   const void* w2, const void* b2, int B, int Tlen, int dil,
                   cudaStream_t stream, size_t* smem_query) {
  using P = Tile<T, C, K>;
  if (dil > kMaxDil) return cudaErrorInvalidValue;
  const size_t xr = (size_t)P::M1 + (size_t)(K - 1) * dil;
  const size_t smem = sizeof(T) * 2 * P::WSZ +
      sizeof(float) * ((size_t)C * P::S1 + 2 * kCI * xr);
  if (smem_query) {
    *smem_query = smem;
    return cudaSuccess;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(resblock_step_kernel<T, C, K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Tlen + P::TT - 1) / P::TT, B);
  resblock_step_kernel<T, C, K><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<const T*>(b2),
      Tlen, dil);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t dispatch_k(const void* x, void* out, const void* w1, const void* b1,
                       const void* w2, const void* b2, int B, int Tlen, int K,
                       int dil, cudaStream_t s, size_t* q) {
  switch (K) {
    case 3: return launch<T, C, 3>(x, out, w1, b1, w2, b2, B, Tlen, dil, s, q);
    case 7: return launch<T, C, 7>(x, out, w1, b1, w2, b2, B, Tlen, dil, s, q);
    case 11: return launch<T, C, 11>(x, out, w1, b1, w2, b2, B, Tlen, dil, s, q);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const void* x, void* out, const void* w1, const void* b1,
                     const void* w2, const void* b2, int B, int C, int Tlen,
                     int K, int dil, cudaStream_t s, size_t* q) {
  switch (C) {
    case 16: return dispatch_k<T, 16>(x, out, w1, b1, w2, b2, B, Tlen, K, dil, s, q);
    case 32: return dispatch_k<T, 32>(x, out, w1, b1, w2, b2, B, Tlen, K, dil, s, q);
    case 64: return dispatch_k<T, 64>(x, out, w1, b1, w2, b2, B, Tlen, K, dil, s, q);
    case 128: return dispatch_k<T, 128>(x, out, w1, b1, w2, b2, B, Tlen, K, dil, s, q);
    case 256: return dispatch_k<T, 256>(x, out, w1, b1, w2, b2, B, Tlen, K, dil, s, q);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_dtype(const void* x, void* out, const void* w1, const void* b1,
                           const void* w2, const void* b2, int B, int C, int T,
                           int K, int dil, int dtype, cudaStream_t s, size_t* q) {
  if (dtype == 0) return dispatch<float>(x, out, w1, b1, w2, b2, B, C, T, K, dil, s, q);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, out, w1, b1, w2, b2, B, C, T, K, dil, s, q);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One dilation step of a resblock: out = x + conv2(lrelu(conv1(lrelu(x)))).
// x, out: (B, C, T) contiguous, distinct buffers.  w1, w2: (K, C_in,
// C_out) contiguous (this step's taps), 16-byte aligned; b1, b2: (C,).
// dtype: 0 = fp32, 1 = bf16 (all six tensors).  1 <= dil <= 5.  Returns
// cudaGetLastError() after launch.
int rvc_resblock_step(const void* x, void* out, const void* w1, const void* b1,
                      const void* w2, const void* b2, int B, int C, int T, int K,
                      int dil, int dtype, void* stream) {
  if (B <= 0 || T <= 0 || dil <= 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) % 16)
    return (int)cudaErrorMisalignedAddress;
  return (int)dispatch_dtype(x, out, w1, b1, w2, b2, B, C, T, K, dil, dtype,
                             static_cast<cudaStream_t>(stream), nullptr);
}

// Dynamic shared memory, in bytes, of one step at (C, K, dil, dtype);
// 0 for a shape the kernel does not take.
size_t rvc_resblock_smem_bytes(int C, int K, int dil, int dtype) {
  size_t smem = 0;
  if (dil <= 0 || dispatch_dtype(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                 1, C, 1, K, dil, dtype, nullptr, &smem) != cudaSuccess)
    return 0;
  return smem;
}

const char* rvc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
