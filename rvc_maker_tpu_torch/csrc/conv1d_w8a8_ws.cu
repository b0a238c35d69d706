// W8A8 dilated conv1d of the int8 decode for Hopper (sm_90a), redesigned
// for the card: weight-stationary persistent blocks, asynchronous input
// windows, ldmatrix fragments, an epilogue staged through shared memory,
// and either warps split into a quantize group and an MMA group or
// clusters of blocks sharing one quantized window.  Plain C interface,
// bound from Python with ctypes (rvc_maker_tpu_torch/ops/int8_conv.py
// `conv1d_w8a8`, the route of every CUDA tensor).  csrc/conv1d_w8a8.cu,
// its first version, computes the same function and stays on no route.
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
// bit for bit as csrc/conv1d_w8a8.cu and JAX: a correctly rounded
// division (as __fdiv_rn, not a reciprocal multiply; `div_rn`), the two
// scales multiplied first, no fused multiply-add in the epilogue
// (__fmul_rn / __fadd_rn), the slope 0.1 rounded to bf16.
//
// What bounds it.  2*B*T*K*C^2 int8 operations against one bf16 read of
// x (and of the residual) and one bf16 write: over a v2-48k decode the
// bytes bound it (3.35 TB/s), the C = 256, K = 11 convs the operations
// (1,979 TOPS).  What held the first version back: every block re-read
// each tap's weights from L2 behind a blocking copy, 1.5 shared loads per
// MMA, 2-byte global loads staged without overlap, scattered 2-byte
// stores, and 1.42 waves at C = 256.  On the card the quantize pass (a
// division per input element) and the MMAs each take about a third of a
// tile's time, and they do not overlap the copies unless different warps
// run them.
//
// Design.
//   Weight-stationary: block (x, y) owns output channels [y*MB, y*MB+MB)
//   and copies their weights for all K taps into shared memory once per
//   launch ([K][MB][C] bytes, 16-byte cp.async).  The grid is persistent:
//   (n, C/MB) blocks, n sized from the occupancy to fill the SMs, each
//   block walking the (batch row, time tile) pairs tau = x, x + n, ...
//   Blocks of one tau run together, so the window's second read comes
//   from L2.
//   Input ring: NB bf16 windows (C channels x R8 times, [channel][16-byte
//   chunk], a pitch of 1 mod 8 chunks), filled by 16-byte cp.async of the
//   chunks inside [0, T), each buffer's copies tracked by its own mbarrier
//   (cp.async.mbarrier.arrive.noinc): window k + NB is issued as soon as
//   window k is quantized.  The residual tile (conv2) is copied the same
//   way into the output tile after the previous tile's stores.  (Bulk
//   copies, one per channel row on an mbarrier, were timed too and were
//   slower: the copy engine takes rows of 128-640 bytes one at a time.)
//   The window starts at the multiple of 8 at or below t0 - p, so its
//   chunks are aligned in device memory, and the tap shift is an ldmatrix
//   row offset (off0 + j*dil), which costs nothing.
//   Split warps (CL = 0): warps 0-3 copy and quantize tile k + 1 into one
//   of two int8 windows while warps 4-7 run tile k's MMAs, epilogue and
//   stores from the other, handing the windows over on named barriers
//   (full / empty), so that the division's ALU work runs beside the
//   tensor cores and the copies.  (Eight quantize warps were timed too:
//   no faster at C = 64, where 384 threads leave too few registers for
//   TN 256, and only a few per cent at C = 128.)
//   Clusters (CL = C / MB, C = 256): the C / MB blocks of a time tile form
//   a cluster; each copies and quantizes C / CL channels and writes its
//   codes into every block's window (st.shared::cluster), one cluster
//   barrier per tile and two windows in turn, so that each input element
//   is quantized once, not C / MB times.
//   Quantize pass: a unit is 4 channels x 8 times (four 16-byte shared
//   loads, channel 4*g4 + ((k + (g4 >> 1)) & 3) at load k: conflict-free
//   with the odd pitch), through the leaky ReLU (bf16x2 conversions) and
//   a branch-free correctly rounded division, written as 8 time rows x 4
//   int8 channels into the int8 window ([R8][C], ci contiguous): the B
//   operand.  A chunk outside [0, T) is written as zeros without being
//   read.  Units of 32 values keep the threads evenly loaded.
//   Fragments: m16n8k32 s8 (PTX ISA, "Matrix Fragments for
//   mma.m16n8k32"): a0..a3 are ldmatrix.x4's four 8x8 b16 matrices (rows
//   0-7 / 8-15 x bytes 0-15 / 16-31 of a 16 x 32 weight tile), b0, b1 of
//   two n-tiles one more ldmatrix.x4 (time rows x ci bytes).  The MMA
//   warps (8, or 4 when split) lie 2 along C_out x the rest along time,
//   each MT m-tiles x NT n-tiles: (MT + NT/2) ldmatrix per MT*NT MMAs.
//   Swizzle: in the int8 images (weights and window, rows of C bytes),
//   16-byte chunk c of row r sits at c ^ (r & 7) (C >= 128) or c ^ ((r >>
//   1) & 3) (C = 64, two rows per 128 bytes), so the 8 consecutive rows of
//   any ldmatrix matrix fall on distinct bank groups, at any tap shift.
//   The weights are copied with 16-byte cp.async, once per launch: a bulk
//   copy (cp.async.bulk) lands a row linearly and cannot permute its
//   chunks (a tensor map's swizzle could, at the cost of the driver API).
//   Epilogue: scale, bias and bf16 in registers, written as bf16 pairs
//   into the output tile in shared memory ([MB][TN + 8], conflict-free),
//   which holds the residual tile; the sum is written back in place and
//   leaves in 16-byte stores along T.
//   A T that is not a multiple of 8 (or an unaligned tensor) loads the
//   window and the residual and stores the output element by element,
//   into and from the same shared images; the decode's T are multiples
//   of 8.
//
// Tiles per (C, K) (`dispatch`: MB, TN, NB, CL; shared memory at dil = 5),
// chosen on the card against alternatives that were built for the choice
// and then removed (timed by chip_smoke.py phase 14 on an NVIDIA H100 80GB
// HBM3 at 700 W, in turns with the table; ms over each (C, K)'s six v2-48k
// decode convs, K = 3 / 7 / 11; PERF.md):
//   C = 64:   64, 256, 2, split (K = 11: 203,800 B); MT 2 x NT 16.  0.586
//             / 0.681 / 0.778 ms; all warps on each phase (CL 1) 0.594 /
//             0.691 / 0.795, split with TN 128 0.672 / 0.771 / 0.905.
//   C = 128:  K = 3: 128, 128, 2, 1 (205,848): 0.654 ms; TN 64 0.871, a
//             cluster of two at MB 64 0.987.  K = 7: 128, 64, 2, split
//             (229,400): 0.937; CL 1 1.143, the cluster 1.216.  K = 11:
//             64, 128, 1, split (207,888): 1.280; the cluster 1.448.
//   C = 256:  K = 3: 64, 128, 2, cluster of 4 (195,608); K = 7: 64, 64,
//             2, cluster of 4 (211,992); K = 11: 32, 128, 2, cluster of 8
//             (222,744), whose 64-row weights (176 KB) would leave no room
//             for a window.  Without a cluster each block quantizes the
//             whole window, C / MB times per tile.
// tests/test_torch_int8.py holds a numpy model of this kernel's index
// arithmetic (`ws_kernel_model`: the swizzles, ldmatrix's lane maps, the
// tile walk, the ring, the clusters' shared window, the quantize pass,
// the staged epilogue, bank conflicts and unwritten bytes) bitwise
// against the plain version, and mirrors `layout` (`ws_smem_bytes`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;            // a block's threads, split warps aside
constexpr int kQuantWarps = 4;           // split warps: the quantize group
constexpr int kWarpsMma = 4;             // and the MMA group
constexpr int kWM = 2;                    // warps along C_out
constexpr int kWN = 4;                    // warps along time
constexpr int kMaxDil = 5;
constexpr int kMaxDevices = 16;
constexpr float kSlope = 0.10009765625f;  // 0.1 rounded to bf16
constexpr size_t kMaxSmem = 232448;       // bytes a block may use on sm_90

// CL: 1; C / MB: the blocks of one time tile form a cluster, each copies
// and quantizes C / CL channels of the window and writes its int8 codes
// into every block's window (distributed shared memory); or 0: the
// block's warps split into two groups of four, one copying and quantizing
// tile k + 1 while the other runs tile k's MMAs, epilogue and stores.
template <int C, int MB, int TN, int NB, int CL>
struct Tile {
  static constexpr bool SPLIT = CL == 0;
  // threads of the block, of the quantize role, of the MMA role
  static constexpr int THREADS = SPLIT ? (kQuantWarps + kWarpsMma) * 32 : kThreads;
  static constexpr int RQ = SPLIT ? kQuantWarps * 32 : kThreads;
  static constexpr int RM = SPLIT ? kWarpsMma * 32 : kThreads;
  static constexpr int WN = SPLIT ? kWarpsMma / kWM : kWN;     // MMA warps along time
  static constexpr int MT = MB / (16 * kWM);   // m-tiles per warp
  static constexpr int NT = TN / (8 * WN);     // n-tiles per warp
  static constexpr int U = C / 16;             // 16-byte chunks per int8 row
  static constexpr int CC = CL > 1 ? C / CL : C;   // window channels this block copies
  static constexpr int G4 = CC / 4;            // quantize units per window chunk
  static constexpr int OTP = TN + 8;           // output tile pitch, bf16 elements
  static_assert(MT >= 1 && MT * 16 * kWM == MB && C % MB == 0, "unsupported MB");
  static_assert(NT >= 2 && NT % 2 == 0 && NT * 8 * WN == TN, "unsupported TN");
  static_assert(NB == 1 || NB == 2, "one or two window buffers");
  static_assert(CL <= 1 || (CL == C / MB && CL <= 8 && G4 % 8 == 0), "unsupported cluster");
};

// Shared memory: weights [K][MB][C] int8, the int8 window [R8][C] (two
// with a cluster or split warps: one being written while the other is
// read), NB bf16 windows [C / CL][NCHP][8], the output tile [MB][TN + 8]
// bf16, and the mbarriers of the NB windows' and the residual's copies.
struct Layout {
  size_t x8, xb, ot, bar, total;
  int r8, nch, nchp;
};

__host__ __device__ inline Layout layout(int C, int MB, int TN, int NB, int CL, int K,
                                         int dil) {
  Layout L;
  L.r8 = (TN + (K - 1) * dil + 7 + 7) & ~7;    // window rows: off0 < 8 plus the taps' span
  L.nch = L.r8 / 8;
  L.nchp = L.nch + ((1 - L.nch) & 7);           // a pitch of 1 mod 8 chunks
  L.x8 = (size_t)MB * C * K;
  L.xb = L.x8 + (size_t)(CL != 1 ? 2 : 1) * L.r8 * C;
  L.ot = L.xb + (size_t)NB * (CL > 1 ? C / CL : C) * L.nchp * 16;
  L.bar = L.ot + (size_t)MB * (TN + 8) * 2;
  L.total = L.bar + 8 * (NB + 1);
  return L;
}

// chunk key of an int8 image row (rows of C bytes)
template <int C>
__device__ __forceinline__ int row_key(int row) {
  return C >= 128 ? (row & 7) : ((row >> 1) & 3);
}
template <int C>
__device__ __forceinline__ int i8_off(int row, int chunk) {
  return row * C + 16 * (chunk ^ row_key<C>(row));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronous
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// the barrier's next phase also waits for this thread's cp.async issued so far
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// (a phase that never completes is a fault of the kernel: after about 2^28
// polls it traps rather than hang the card)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
// distributed shared memory: the address of `addr` in block `rank` of the
// cluster, a 32-bit store there, and the cluster-wide barrier
__device__ __forceinline__ unsigned mapa(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(unsigned addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// named barriers of the split warps (0 is __syncthreads)
constexpr int kBarFull = 1;       // + k & 1: the int8 window of tile k is written
constexpr int kBarEmpty = 3;      // + k & 1: its MMAs have read it
constexpr int kBarQuant = 5;      // the quantize warps
constexpr int kBarMma = 6;        // the MMA warps
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += A(16x32, s8) @ B(32x8, s8), int32
__device__ __forceinline__ void mma_s8(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t lo16) {
  return __uint_as_float(lo16 << 16);
}
// (bf16(lo), bf16(hi)) packed, lo in the low half
__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// v / s correctly rounded, as __fdiv_rn, without its range check and
// branch: r = RN(1/s); q0 = RN(v r) is within 2 ulps, one correction
// with the remainder makes it faithful, and a second gives RN(v / s)
// (Markstein's theorem: r within half an ulp of 1/s, the remainder exact
// by the FMA).  The caller keeps |v / s| < 128, so nothing overflows, and
// a remainder underflows only where |v / s| < 2^-20 (the code is 0).
__device__ __forceinline__ float div_rn(float v, float s, float r) {
  const float q0 = __fmul_rn(v, r);
  const float q1 = __fmaf_rn(__fmaf_rn(-s, q0, v), r, q0);
  return __fmaf_rn(__fmaf_rn(-s, q1, v), r, q1);
}

// clip(round_half_even(v / s), -127, 127); thr = 128 s (exact): beyond it
// the code is +-127 whatever the quotient, and NaN gives 0 as
// __float2int_rn does.
__device__ __forceinline__ int quantize(float v, float s, float r, float thr) {
  const float q = fabsf(v) >= thr ? copysignf(127.f, v) : div_rn(v, s, r);
  return min(127, max(-127, __float2int_rn(q)));
}

// two bf16 (the low and high halves of w) through the leaky ReLU:
// bf16(x >= 0 ? x : x * slope), as max(x, x * slope) since slope < 1
__device__ __forceinline__ uint32_t lrelu2(uint32_t w) {
  const float a = __uint_as_float(w << 16);
  const float b = __uint_as_float(w & 0xFFFF0000u);
  const __nv_bfloat162 p =
      __floats2bfloat162_rn(fmaxf(a, __fmul_rn(a, kSlope)), fmaxf(b, __fmul_rn(b, kSlope)));
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The codes of channel group gg (4 channels) at time rows 8u + (e ^ F):
// in this block's window, or in every window of the cluster.
template <int C, int CL, int F>
__device__ __forceinline__ void store_rows(unsigned x8, int u, int gg, const uint32_t* o) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const unsigned a = x8 + i8_off<C>(8 * u + (e ^ F), gg >> 2) + 4 * (gg & 3);
    if (CL <= 1) {
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(o[e ^ F]) : "memory");
    } else {
#pragma unroll
      for (int rk = 0; rk < CL; ++rk) st_cluster(mapa(a, rk), o[e ^ F]);
    }
  }
}

// One quantize unit: channels 4*g4..4*g4+3 x the 8 times of window chunk
// u (four 16-byte loads), written as 8 time rows of 4 int8 channels; a
// chunk outside [0, T) (live == false) is written as zeros unread.  The
// k-th load reads channel 4*g4 + ((k + (g4 >> 1)) & 3): with a window
// pitch of 1 mod 8 chunks, 8 consecutive g4 then fall on 8 bank groups.
template <int C, int CL, bool LRELU>
__device__ __forceinline__ void quantize_unit(const unsigned char* src, unsigned x8, int nchp,
                                              int g4, int gg, int u, bool live, float s,
                                              float r, float thr) {
  uint32_t o[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) o[e] = 0u;
  if (live) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int pos = (kk + (g4 >> 1)) & 3;       // the channel's byte in the row's word
      const unsigned sel = (0x3210u & ~(0xFu << (4 * pos))) | (4u << (4 * pos));
      const uint4 raw =
          *reinterpret_cast<const uint4*>(src + ((4 * g4 + pos) * nchp + u) * 16);
      const uint32_t wd[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const uint32_t w = LRELU ? lrelu2(wd[h]) : wd[h];
        o[2 * h] = __byte_perm(o[2 * h], (uint32_t)quantize(__uint_as_float(w << 16), s, r, thr),
                               sel);
        o[2 * h + 1] = __byte_perm(
            o[2 * h + 1], (uint32_t)quantize(__uint_as_float(w & 0xFFFF0000u), s, r, thr), sel);
      }
    }
  }
  // A warp's 32 units cover 32 / G4 values of u; at each store
  // they write rows 8u + (e ^ f(u)), so that those rows fall on distinct
  // banks: f = u & 1 at C = 64 (two rows per 128 bytes), else (u mod R)
  // x 8 / R for R values of u (their chunks' keys then differ).
  constexpr int G4 = (CL > 1 ? C / CL : C) / 4;   // units per window chunk
  constexpr int R = G4 >= 32 ? 1 : 32 / G4;
  const int f = C == 64 ? (u & 1) : (u % R) * (8 / R);
  switch (f) {
    case 0: store_rows<C, CL, 0>(x8, u, gg, o); break;
    case 1: store_rows<C, CL, 1>(x8, u, gg, o); break;
    case 2: store_rows<C, CL, 2>(x8, u, gg, o); break;
    case 4: store_rows<C, CL, 4>(x8, u, gg, o); break;
    default: store_rows<C, CL, 6>(x8, u, gg, o); break;
  }
}

template <int C, int MB, int TN, int NB, int CL>
__global__ void __launch_bounds__(Tile<C, MB, TN, NB, CL>::THREADS, 1)
conv1d_w8a8_ws_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ out,
                      const int8_t* __restrict__ wq, const float* __restrict__ wscale,
                      const __nv_bfloat16* __restrict__ bias, const float* __restrict__ ascale,
                      const __nv_bfloat16* __restrict__ res, int B, int T, int K, int dil,
                      int lrelu, int aligned) {
  using P = Tile<C, MB, TN, NB, CL>;
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(C, MB, TN, NB, CL, K, dil);
  unsigned char* const w_s = smem;
  unsigned char* const x8 = smem + L.x8;
  unsigned char* const xb = smem + L.xb;
  uint16_t* const ot = reinterpret_cast<uint16_t*>(smem + L.ot);
  uint64_t* const bar_x = reinterpret_cast<uint64_t*>(smem + L.bar);   // [NB]
  uint64_t* const bar_r = bar_x + NB;
  const int nch = L.nch, nchp = L.nchp;
  const int pad = (K - 1) * dil / 2;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  // split warps: 0-3 copy and quantize, 4-7 run the MMAs, the epilogue and
  // the stores; rt is a thread's index within its role
  const bool q_role = !P::SPLIT || warp < kQuantWarps;
  const int rt = P::SPLIT && !q_role ? tid - P::RQ : tid;
  const int mwarp = P::SPLIT ? warp - kQuantWarps : warp;
  const int wm = mwarp % kWM;
  const int wn = mwarp / kWM;
  const int m0 = blockIdx.y * MB;
  const int cb = CL > 1 ? (int)blockIdx.y * P::CC : 0;   // the window channels it copies
  const int ntt = (T + TN - 1) / TN;            // time tiles per batch row
  const int ntiles = B * ntt;
  const int my = (int)blockIdx.x < ntiles ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                                          : 0;
  const float s = *ascale;
  const float s_rcp = __frcp_rn(s);
  const float s_thr = __fmul_rn(128.f, s);

  if (tid == 0) {
    for (int i = 0; i < NB; ++i) mbar_init(bar_x + i, P::RQ);
    mbar_init(bar_r, P::RM);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // ---- the block's weights, all taps, once ---------------------------
  for (int i = tid; i < K * MB * P::U; i += P::THREADS) {
    const int chunk = i % P::U;
    const int row = (i / P::U) % MB;
    const int j = i / (P::U * MB);
    cp_async16(w_s + j * MB * C + i8_off<C>(row, chunk),
               wq + ((size_t)j * C + m0 + row) * C + 16 * chunk);
  }

  // the k-th tile of this block: batch row and first time column
  auto tile = [&](int k, int& b, int& t0) {
    const int tau = blockIdx.x + k * gridDim.x;
    b = tau / ntt;
    t0 = (tau - b * ntt) * TN;
  };
  // The window of tile k into buffer buf: rows from the multiple of 8 at
  // or below t0 - pad.  Aligned: the chunks inside [0, T), 16 bytes a
  // thread (cp.async), consecutive threads along a row; the quantize pass
  // zeroes the others unread.  Otherwise element by element, zeros
  // outside [0, T).
  auto load_window = [&](int k, int buf) {
    int b, t0;
    tile(k, b, t0);
    const int wst = (t0 - pad) & ~7;
    const __nv_bfloat16* xg = x + ((size_t)b * C + cb) * T;
    unsigned char* dst0 = xb + (size_t)buf * P::CC * nchp * 16;
    if (aligned) {
      const int u0 = (max(wst, 0) - wst) / 8;
      const int nu = (min(wst + L.r8, T) - wst) / 8 - u0;
      for (int i = rt; i < P::CC * nu; i += P::RQ) {
        const int c = i / nu;
        const int u = u0 + (i - c * nu);
        cp_async16(dst0 + (c * nchp + u) * 16, xg + (size_t)c * T + wst + 8 * u);
      }
      cp_async_arrive(bar_x + buf);
    } else {
      const int r8 = L.r8;
      for (int i = rt; i < P::CC * r8; i += P::RQ) {
        const int c = i / r8;
        const int r = i - c * r8;
        const int t = wst + r;
        const uint16_t v = (t >= 0 && t < T) ? __bfloat16_as_ushort(xg[(size_t)c * T + t]) : 0;
        reinterpret_cast<uint16_t*>(dst0 + (c * nchp + (r >> 3)) * 16)[r & 7] = v;
      }
    }
  };
  // The residual of tile k into the output tile (16-byte cp.async, or
  // element by element).
  auto load_residual = [&](int k) {
    int b, t0;
    tile(k, b, t0);
    const __nv_bfloat16* rg = res + ((size_t)b * C + m0) * T + t0;
    const int n = min(TN, T - t0);
    if (aligned) {
      for (int i = rt; i < MB * (n / 8); i += P::RM) {
        const int row = i / (n / 8);
        const int v = i - row * (n / 8);
        cp_async16(ot + row * P::OTP + 8 * v, rg + (size_t)row * T + 8 * v);
      }
      cp_async_arrive(bar_r);
    } else {
      for (int i = rt; i < MB * n; i += P::RM) {
        const int row = i / n;
        const int c = i - row * n;
        ot[row * P::OTP + c] = __bfloat16_as_ushort(rg[(size_t)row * T + c]);
      }
    }
  };

  // this thread's output channels: scales and biases for all tiles, read
  // by the MMA threads only (a split quantize warp's wm is negative: its
  // channels would lie before the tensors' first element)
  float sc[P::MT][2] = {}, bc[P::MT][2] = {};
  if (!P::SPLIT || !q_role) {
#pragma unroll
    for (int im = 0; im < P::MT; ++im)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = m0 + (wm * P::MT + im) * 16 + g + 8 * h;
        sc[im][h] = __fmul_rn(s, wscale[co]);
        bc[im][h] = __bfloat162float(bias[co]);
      }
  }

  // ldmatrix lane roles: row within the 8x8 matrix, and which matrix
  const int lr = lane & 7;
  const int lmid = (lane >> 3) & 1;
  const int lhi = lane >> 4;
  const unsigned w_base = smem_u32(w_s);
  const unsigned x8_base0 = smem_u32(x8);
  unsigned a_row[P::MT];
  int a_x[P::MT];
#pragma unroll
  for (int im = 0; im < P::MT; ++im) {
    const int ra = (wm * P::MT + im) * 16 + lr + 8 * lmid;
    a_row[im] = w_base + ra * C;
    a_x[im] = lhi ^ row_key<C>(ra);
  }
  // the int8 window of tile k (two in turn with a cluster or split warps)
  auto x8_of = [&](int k) { return x8_base0 + (CL != 1 ? (k & 1) * L.r8 * C : 0); };

  // ---- quantize: bf16 window (buffer k % NB) -> int8 window ------------
  auto quantize_tile = [&](int k) {
    int b, t0;
    tile(k, b, t0);
    const int wst = (t0 - pad) & ~7;
    const unsigned char* src = xb + (size_t)(k % NB) * P::CC * nchp * 16;
    const int units = P::G4 * nch;
    if (lrelu) {
      for (int i = rt; i < units; i += P::RQ) {
        const int u = i / P::G4;
        const int g4 = i - u * P::G4;
        const int t = wst + 8 * u;
        quantize_unit<C, CL, true>(src, x8_of(k), nchp, g4, cb / 4 + g4, u,
                                   !aligned || (t >= 0 && t < T), s, s_rcp, s_thr);
      }
    } else {
      for (int i = rt; i < units; i += P::RQ) {
        const int u = i / P::G4;
        const int g4 = i - u * P::G4;
        const int t = wst + 8 * u;
        quantize_unit<C, CL, false>(src, x8_of(k), nchp, g4, cb / 4 + g4, u,
                                    !aligned || (t >= 0 && t < T), s, s_rcp, s_thr);
      }
    }
  };

  // ---- MMAs over all taps and C_in, epilogue and stores ----------------
  auto mma_tile = [&](int k) {
    int b, t0;
    tile(k, b, t0);
    const int off0 = (t0 - pad) - ((t0 - pad) & ~7);
    const unsigned x8_base = x8_of(k);
    int acc[P::MT][P::NT][4];
#pragma unroll
    for (int im = 0; im < P::MT; ++im)
#pragma unroll
      for (int in = 0; in < P::NT; ++in)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[im][in][r] = 0;

#pragma unroll 1
    for (int j = 0; j < K; ++j) {
      const unsigned wj = j * MB * C;
      unsigned b_row[P::NT / 2];
      int b_x[P::NT / 2];
#pragma unroll
      for (int pp = 0; pp < P::NT / 2; ++pp) {
        const int rb = wn * P::NT * 8 + pp * 16 + 8 * lhi + lr + off0 + j * dil;
        b_row[pp] = x8_base + rb * C;
        b_x[pp] = lmid ^ row_key<C>(rb);
      }
#pragma unroll
      for (int kc = 0; kc < C / 32; ++kc) {
        uint32_t a[P::MT][4], bfr[P::NT][2];
#pragma unroll
        for (int im = 0; im < P::MT; ++im)
          ldsm_x4(a[im], a_row[im] + wj + 16 * ((2 * kc) ^ a_x[im]));
#pragma unroll
        for (int pp = 0; pp < P::NT / 2; ++pp) {
          uint32_t r[4];
          ldsm_x4(r, b_row[pp] + 16 * ((2 * kc) ^ b_x[pp]));
          bfr[2 * pp][0] = r[0];
          bfr[2 * pp][1] = r[1];
          bfr[2 * pp + 1][0] = r[2];
          bfr[2 * pp + 1][1] = r[3];
        }
#pragma unroll
        for (int im = 0; im < P::MT; ++im)
#pragma unroll
          for (int in = 0; in < P::NT; ++in) mma_s8(acc[im][in], a[im], bfr[in]);
      }
    }
    // the split MMA warps release the int8 window to the quantize warps
    if (P::SPLIT) named_arrive(kBarEmpty + (k & 1), P::THREADS);

    // epilogue: scale, bias, bf16, residual, via the output tile
    if (res && aligned) mbar_wait(bar_r, (uint32_t)(k & 1));        // residual k
#pragma unroll
    for (int im = 0; im < P::MT; ++im) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = (wm * P::MT + im) * 16 + g + 8 * h;
#pragma unroll
        for (int in = 0; in < P::NT; ++in) {
          const int n = (wn * P::NT + in) * 8 + 2 * q;
          uint32_t* p = reinterpret_cast<uint32_t*>(ot + row * P::OTP + n);
          // both columns' bf16 in one packed conversion, each rounded alone
          uint32_t y = bf16x2_bits(
              __fadd_rn(__fmul_rn(__int2float_rn(acc[im][in][2 * h]), sc[im][h]), bc[im][h]),
              __fadd_rn(__fmul_rn(__int2float_rn(acc[im][in][2 * h + 1]), sc[im][h]),
                        bc[im][h]));
          if (res) {
            const uint32_t rv = *p;
            y = bf16x2_bits(
                __fadd_rn(bf16_bits_to_float(y & 0xFFFFu), bf16_bits_to_float(rv & 0xFFFFu)),
                __fadd_rn(bf16_bits_to_float(y >> 16), bf16_bits_to_float(rv >> 16)));
          }
          *p = y;
        }
      }
    }
    if (P::SPLIT) {
      named_sync(kBarMma, P::RM);
    } else {
      __syncthreads();
    }
    // the tile leaves: 16-byte stores along T, or element by element
    uint16_t* og = reinterpret_cast<uint16_t*>(out) + ((size_t)b * C + m0) * T + t0;
    const int n = min(TN, T - t0);
    if (aligned) {                // a row's 16-byte chunks on consecutive threads
      for (int i = rt; i < MB * (TN / 8); i += P::RM) {
        const int row = i / (TN / 8);
        const int v = i - row * (TN / 8);
        if (8 * v < n)
          *reinterpret_cast<uint4*>(og + (size_t)row * T + 8 * v) =
              *reinterpret_cast<const uint4*>(ot + row * P::OTP + 8 * v);
      }
    } else {
      for (int i = rt; i < MB * n; i += P::RM) {
        const int row = i / n;
        const int c = i - row * n;
        og[(size_t)row * T + c] = ot[row * P::OTP + c];
      }
    }
    if (P::SPLIT) {               // the output tile is free
      named_sync(kBarMma, P::RM);
    } else {
      __syncthreads();
    }
    if (res && k + 1 < my) load_residual(k + 1);
  };

  // ---- prologue: the first tiles' windows and residual ---------------
  // Each copy's threads arrive on its buffer's mbarrier (cp.async
  // .mbarrier.arrive.noinc), so that a buffer is waited for alone: window
  // k + NB is issued as soon as window k is quantized, the residual of
  // tile k + 1 after tile k's stores.  The weights precede window 0.
  if (q_role)
    for (int i = 0; i < NB && i < my; ++i) load_window(i, i);
  if ((!P::SPLIT || !q_role) && res && my > 0) load_residual(0);
  if (P::SPLIT || !aligned) {     // the MMA warps wait on no window: the weights now
    cp_async_wait_all();
    __syncthreads();
  }
  if (CL > 1) cluster_sync();     // every block of the cluster runs before any writes to it

  if (!P::SPLIT) {
    for (int k = 0; k < my; ++k) {
      if (aligned) mbar_wait(bar_x + k % NB, (uint32_t)((k / NB) % 2));   // window k
      quantize_tile(k);
      // the int8 window is written (by the whole cluster), buffer k % NB read
      if (CL > 1) {
        cluster_sync();
      } else {
        __syncthreads();
      }
      if (k + NB < my) load_window(k + NB, k % NB);   // into the buffer just read
      mma_tile(k);
    }
  } else if (q_role) {
    for (int k = 0; k < my; ++k) {
      if (!aligned) named_sync(kBarQuant, P::RQ);      // the element-wise copies
      if (k >= 2) named_sync(kBarEmpty + (k & 1), P::THREADS);   // tile k-2's MMAs are done
      if (aligned) mbar_wait(bar_x + k % NB, (uint32_t)((k / NB) % 2));
      quantize_tile(k);
      named_sync(kBarQuant, P::RQ);                    // buffer k % NB read
      if (k + NB < my) load_window(k + NB, k % NB);
      named_arrive(kBarFull + (k & 1), P::THREADS);
    }
    for (int k = max(0, my - 2); k < my; ++k) named_sync(kBarEmpty + (k & 1), P::THREADS);
  } else {
    for (int k = 0; k < my; ++k) {
      named_sync(kBarFull + (k & 1), P::THREADS);      // the int8 window of tile k
      mma_tile(k);
    }
  }
  cp_async_wait_all();
}

// Per-device state, filled on first use: SM counts, and per instantiation
// whether the shared-memory attribute is set (a function attribute is per
// context) and the occupancy by (K, dil).  A failed query is not kept.
std::atomic<int> g_sms[kMaxDevices];

int current_device() {
  int dev = -1;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return -1;
  return dev;
}

int sm_count(int dev) {
  int n = g_sms[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    g_sms[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

// Launches one conv at tiles (MB, TN, NB, CL), or, with smem_query set,
// only reports the dynamic shared memory it would take.
template <int C, int MB, int TN, int NB, int CL>
cudaError_t launch(const __nv_bfloat16* x, __nv_bfloat16* out, const int8_t* wq,
                   const float* wscale, const __nv_bfloat16* bias, const float* ascale,
                   const __nv_bfloat16* res, int B, int T, int K, int dil, int lrelu,
                   cudaStream_t stream, size_t* smem_query) {
  const Layout L = layout(C, MB, TN, NB, CL, K, dil);
  if (smem_query) {
    *smem_query = L.total;
    return cudaSuccess;
  }
  if (L.total > kMaxSmem) return cudaErrorInvalidValue;
  const int dev = current_device();
  if (dev < 0) return cudaErrorInvalidDevice;
  auto kernel = conv1d_w8a8_ws_kernel<C, MB, TN, NB, CL>;
  // once per device and instantiation: the attribute, then occupancy by (K, dil)
  static std::atomic<int> attr_set[kMaxDevices];
  if (!attr_set[dev].load(std::memory_order_acquire)) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (e != cudaSuccess) return e;
    attr_set[dev].store(1, std::memory_order_release);
  }
  const int aligned = T % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(res) % 16 == 0;
  const int ntiles = B * ((T + TN - 1) / TN);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute cluster[1];
  cfg.blockDim = dim3(Tile<C, MB, TN, NB, CL>::THREADS);
  cfg.dynamicSmemBytes = L.total;
  cfg.stream = stream;
  if (CL > 1) {
    cluster[0].id = cudaLaunchAttributeClusterDimension;
    cluster[0].val.clusterDim.x = 1;
    cluster[0].val.clusterDim.y = CL;
    cluster[0].val.clusterDim.z = 1;
    cfg.attrs = cluster;
    cfg.numAttrs = 1;
  }
  // how many (clusters of) C / MB blocks run at once
  static std::atomic<int> occ[kMaxDevices][12][kMaxDil + 1];
  int groups = occ[dev][K][dil].load(std::memory_order_relaxed);
  if (groups == 0) {
    cudaError_t e;
    if (CL > 1) {
      cfg.gridDim = dim3(1, CL);
      e = cudaOccupancyMaxActiveClusters(&groups, kernel, &cfg);
    } else {
      int per_sm = 0;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, Tile<C, MB, TN, NB, CL>::THREADS, L.total);
      groups = per_sm * sm_count(dev) / (C / MB);
    }
    if (e != cudaSuccess) return e;
    if (groups < 1) return cudaErrorInvalidConfiguration;
    occ[dev][K][dil].store(groups, std::memory_order_relaxed);
  }
  // persistent blocks: as many as run at once, then as few as take the same rounds
  const int rounds = (ntiles + groups - 1) / groups;
  const int nblk = (ntiles + rounds - 1) / rounds;
  cfg.gridDim = dim3(nblk, C / MB);
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, out, wq, wscale, bias, ascale, res, B, T,
                                     K, dil, lrelu, aligned);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The tiles of (C, K)
cudaError_t dispatch(const __nv_bfloat16* x, __nv_bfloat16* out, const int8_t* wq,
                     const float* wscale, const __nv_bfloat16* bias, const float* ascale,
                     const __nv_bfloat16* res, int B, int C, int T, int K, int dil, int lrelu,
                     cudaStream_t s, size_t* q) {
  if ((K != 3 && K != 7 && K != 11) || dil < 1 || dil > kMaxDil) return cudaErrorInvalidValue;
#define RVC_WS(c, m, t, n, l) \
  return launch<c, m, t, n, l>(x, out, wq, wscale, bias, ascale, res, B, T, K, dil, lrelu, s, q)
  if (C == 64) RVC_WS(64, 64, 256, 2, 0);
  if (C == 128 && K == 3) RVC_WS(128, 128, 128, 2, 1);
  if (C == 128 && K == 7) RVC_WS(128, 128, 64, 2, 0);
  if (C == 128) RVC_WS(128, 64, 128, 1, 0);
  if (C == 256 && K == 3) RVC_WS(256, 64, 128, 2, 4);
  if (C == 256 && K == 7) RVC_WS(256, 64, 64, 2, 4);
  if (C == 256) RVC_WS(256, 32, 128, 2, 8);
#undef RVC_WS
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One W8A8 conv at the tiles of (C, K).  x, out, residual: (B, C, T)
// bf16 contiguous, out distinct from both (residual may be null); w_q:
// (K, C_out, C_in) int8 contiguous, 16-byte aligned; w_scale: (C,) fp32;
// bias: (C,) bf16; a_scale: one fp32 in device memory.  C in {64, 128,
// 256}, K in {3, 7, 11}, 1 <= dil <= 5; lrelu != 0 applies the leaky ReLU
// before quantizing.  Returns cudaGetLastError() after launch.
int rvc_conv1d_w8a8_ws(const void* x, void* out, const void* w_q, const void* w_scale,
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
size_t rvc_conv1d_w8a8_ws_smem_bytes(int C, int K, int dil) {
  size_t smem = 0;
  if (dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, C, 1, K, dil, 0,
               nullptr, &smem) != cudaSuccess)
    return 0;
  return smem;
}

const char* rvc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
