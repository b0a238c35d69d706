// Fused HiFi-GAN resblock step for Hopper (sm_90a) on the tensor cores:
// fp32 in and out, fp32 accumulation, each product in 3xTF32 through
// mma.sync.m16n8k8.  Plain C interface, bound from Python with ctypes
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
// write of (B, C, T): compute-bound.  The tensor cores take TF32 at 494.7
// TFLOP/s (dense); three TF32 products per fp32 product keep fp32's
// accuracy (below), so 3 x flops at that rate is the bound (165 TFLOP/s
// of fp32 work; csrc/resblock.cu's fp32 FMA peaks at 67).  mma.sync itself
// reaches about two thirds of that rate (csrc/tools/tf32_mma_rate.cu).
// Beside it, every block streams both convs' weights, split into two TF32
// planes (2 x 2 x k x C^2 words), from L2, so the longer a block's time
// tile the fewer times they are read.
//
// Design (each point against what held the earlier m16n8k4 design back: a
// split per fragment load, the smallest TF32 MMA, 4 channels per barrier,
// one n-tile a warp at C <= 64, a fixed time tile, spills at k = 11).
//  1. Each operand is split once (hi = rna_tf32(v), lo = rna_tf32(v -
//     hi)).  The wrapper splits the weights and lays them out as the ring
//     holds them (ops/resblock.py `_tc_pack`); the staging pass applies
//     lrelu to x and writes a chunk's rows as two TF32 planes; conv1's
//     epilogue writes the intermediate as two planes, or at C = 256 in
//     fp32, each chunk of which is split into an image of its own before
//     conv2's taps (T1F: half the bytes a row, so 128-row tiles fit).  The
//     inner loop is ldmatrix and mma.sync only.
//  2. mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (PTX ISA, the
//     m16n8k8 .tf32 fragments), g = lane >> 2, q = lane & 3: a0..a3 =
//     A[g][q], A[g+8][q], A[g][q+4], A[g+8][q+4]; b0, b1 = B[q][g],
//     B[q+4][g]; c0..c3 = D[g][2q], D[g][2q+1], D[g+8][2q], D[g+8][2q+1].
//     A 16-byte row of four fp32 words is an 8 x 8 b16 ldmatrix row, and
//     lane (g, q) receives word q of row g of each matrix: so with A
//     staged time-major ([time][channel], channels contiguous) one
//     ldmatrix.x4 gives a0..a3 of an m-tile (matrices: rows 0-7 / 8-15 x
//     channels 0-3 / 4-7), and with the weights staged [C_out][channel]
//     one ldmatrix.x4 gives b0, b1 of two n-tiles.  A tap's shift (j*d in
//     conv1, j in conv2) is a row offset of the per-lane row addresses.
//     Every image is swizzled: 16-byte chunk c of row r sits at c ^ key(r)
//     (`swz`), so the 8 rows an ldmatrix matrix reads fall on 8 distinct
//     bank groups whatever the shift.
//  3. A stage is one tap x KC input channels (KC = 32 at C = 128, else 16:
//     2-4 k-steps of 8).  A ring of RING stages holds the weights, filled
//     with 16-byte cp.async and tracked with mbarriers (full: the copies
//     landed; empty: the 8 MMA warps are done with a slot): by a producer
//     warp, or at C = 256 (whose 4 x 8 warp tiles need more than the 168
//     registers a thread keeps beside a ninth warp) by the MMA warps
//     themselves, a stage ahead.  The loop runs channel chunk outer, taps
//     inner, so one chunk of x (its window of rows, copied raw with the
//     chunk's first stage) serves all k taps, and the ring fits in shared
//     memory at C = 256, k = 11.
//  4. 8 MMA warps, WM along time x WN along C_out, each MTW m-tiles x NTW
//     n-tiles (`Cfg`): at least 2 x 2 at every width (4 x 8 at C = 256, 4
//     x 4 at 128, 2 x 4 at 64 and 32, 4 x 2 at 16), so each A pair feeds
//     3 x NTW MMAs and each B pair 3 x MTW.  The accumulators of the warp's
//     tile stay in registers across both convs.  At C = 32 and 64 two
//     blocks share an SM (<= 113 KB, <= 102 registers), so one block's
//     staging and epilogue run beside the other's MMAs.
//  5. The time tile TT is a launch argument, chosen per launch from (B, T,
//     C, k) by the wrapper (`tc_time_tile`): the longest that shared
//     memory takes (MT_MAX m-tiles of conv1, which covers conv2's k - 1
//     halo rows: MT1 = ceil((TT + k - 1) / 16) m-tiles of conv1, MT2 =
//     ceil(TT / 16) of conv2), then cut so that the grid (ceil(T / TT), B)
//     fills its waves of blocks.  The arithmetic of an output does not
//     depend on the tile.
//
// 3xTF32.  Three MMAs per fp32 product, small terms first: (a_lo, b_hi),
// (a_hi, b_lo), (a_hi, b_hi).  One pass alone errs by about 3e-4 of the
// result at k = 11, C = 256; three stay within 3x of fp32 FMA summed in the
// same order (numpy emulation in tests/test_torch_resblock.py).
//
// Shared memory (`layout`): during conv1 the raw x chunk ([KC][XRP] fp32
// as in device memory) and its image ([XR][KC] x 2 planes, XR = 16*MT1 +
// (k-1)*d); the intermediate ([16*MT1][C]: x 2 planes after them,
// overlaying them, or in fp32 before them at C = 256, whose conv2 chunk
// images then overlay conv1's); the ring; the mbarriers.  Where the
// intermediate is split whole, conv2's last m-tile reads up to k - 1 rows
// past it (the ring's words): only rows past TT, whose outputs are never
// written, read them.
//
// tests/test_torch_resblock.py holds a numpy model of this kernel
// (`tc_step_model`, `tc_layout`, `TC_CFG`): the staged images, the
// swizzles, ldmatrix's lane maps, the m16n8k8 fragments, the ring's
// stages, the time tile, 3xTF32 in this order, with NaN in every word the
// kernel never writes.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMmaWarps = 8;
constexpr int kConsumers = kMmaWarps * 32;    // the MMA warps' threads
constexpr int kMaxDil = 5;
constexpr float kSlope = 0.1f;
constexpr size_t kMaxSmem = 232448;           // bytes a block may use on sm_90
constexpr int kBarMma = 1;                    // named barrier of the MMA warps

// Per width: KC input channels per stage, MT_MAX m-tiles of conv1 at most,
// WM warps along time (WN = 8 / WM along C_out), RING weight stages in
// the ring, MINB blocks an SM holds, T1F (the intermediate kept in fp32),
// PRODUCER (a ninth warp fills the ring).  Chosen by timing alternatives on
// the card (PERF.md).  Mirrored by ops/resblock.py `TC_TILES` and by the
// tests' model.
template <int C> struct Cfg;
template <> struct Cfg<256> { static constexpr int KC = 16, MT_MAX = 8, WM = 2, RING = 2, MINB = 1, T1F = 1, PRODUCER = 0; };
template <> struct Cfg<128> { static constexpr int KC = 32, MT_MAX = 8, WM = 2, RING = 3, MINB = 1, T1F = 0, PRODUCER = 1; };
template <> struct Cfg<64> { static constexpr int KC = 16, MT_MAX = 8, WM = 4, RING = 3, MINB = 2, T1F = 0, PRODUCER = 1; };
template <> struct Cfg<32> { static constexpr int KC = 16, MT_MAX = 16, WM = 8, RING = 3, MINB = 2, T1F = 0, PRODUCER = 1; };
template <> struct Cfg<16> { static constexpr int KC = 16, MT_MAX = 32, WM = 8, RING = 3, MINB = 1, T1F = 0, PRODUCER = 1; };

template <int C, int K>
struct Tile {
  static constexpr int KC = Cfg<C>::KC;
  static constexpr int MT_MAX = Cfg<C>::MT_MAX;
  static constexpr int WM = Cfg<C>::WM;
  static constexpr int RING = Cfg<C>::RING;
  static constexpr int MINB = Cfg<C>::MINB;
  static constexpr bool T1F = Cfg<C>::T1F;
  static constexpr bool PRODUCER = Cfg<C>::PRODUCER;
  static constexpr int THREADS = kConsumers + (PRODUCER ? 32 : 0);
  static constexpr int ISSUERS = PRODUCER ? 32 : kConsumers;   // threads that fill the ring
  static constexpr int WN = kMmaWarps / WM;
  static constexpr int NTW = C / 8 / WN;         // n-tiles per warp
  static constexpr int MTW = MT_MAX / WM;        // m-tiles per warp, at most
  static constexpr int HC = (K - 1) / 2;
  static constexpr int NCH = C / KC;             // channel chunks per conv
  static constexpr int CPR = KC / 4;             // 16-byte chunks per staged row
  static constexpr int STAGES1 = NCH * K;        // stages of one conv
  static constexpr int STAGE_WORDS = 2 * C * KC; // hi and lo planes of a stage
  static_assert(NTW >= 2 && NTW % 2 == 0 && MTW >= 2, "a warp takes 2 x 2 tiles or more");
  static_assert(C % KC == 0 && KC % 8 == 0, "unsupported chunk");
  static_assert(K >= RING, "a chunk's raw x is reused only after its first RING taps");
};

struct Layout {
  int xr, xrp, r2;             // x image rows; raw rows (16-byte multiple); conv2 image rows
  size_t image, raw, t1, ring, bars, total;   // byte offsets; total bytes
};

// t1f: the intermediate is kept in fp32 and each chunk of it split into
// an image of its own before conv2's taps (at C = 256: half the bytes a
// row, so twice the rows), else split whole in conv1's epilogue.
__host__ __device__ inline Layout layout(int C, int KC, int ring, bool t1f, int K, int mt1,
                                         int dil) {
  Layout L;
  L.xr = 16 * mt1 + (K - 1) * dil;
  L.xrp = (L.xr + 3 + 3) & ~3;
  L.r2 = 16 * mt1 + K - 1;
  const size_t image = (size_t)2 * L.xr * KC * 4, raw = (size_t)KC * L.xrp * 4;
  if (t1f) {                   // [t1 fp32][x image + raw | conv2 image][ring]
    const size_t img2 = (size_t)2 * L.r2 * KC * 4;
    L.t1 = 0;
    L.image = (size_t)16 * mt1 * C * 4;
    L.raw = L.image + image;
    L.ring = L.image + (((image + raw > img2 ? image + raw : img2) + 15) & ~(size_t)15);
  } else {                     // [x image + raw | t1 hi, lo][ring]
    const size_t t1 = (size_t)2 * 16 * mt1 * C * 4;
    const size_t u = ((image + raw > t1 ? image + raw : t1) + 15) & ~(size_t)15;
    L.image = 0;
    L.raw = image;
    L.t1 = u - t1;
    L.ring = u;
  }
  L.bars = L.ring + (size_t)ring * 2 * C * KC * 4;
  L.total = L.bars + 2 * ring * 8;
  return L;
}

// the 16-byte chunk of chunk c of row r in an image of cpr chunks a row
template <int CPR>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(CPR == 4 || CPR % 8 == 0, "unsupported row");
  return c ^ (CPR >= 8 ? (r & 7) : ((r >> 1) & 3));
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : v * kSlope; }

// cvt.rna.tf32.f32 (round to nearest, ties away from zero) for finite v,
// in two integer operations
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 (or 4) bytes global -> shared, asynchronous; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
// the barrier's phase also waits for this thread's cp.async issued so far
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
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
__device__ __forceinline__ void mma_sync_bar() {
  asm volatile("bar.sync %0, %1;\n" ::"r"(kBarMma), "r"(kConsumers) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += A(16x8) @ B(8x8), TF32 in, fp32 accumulate
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage's MMAs for a warp: A rows mt*16 + .. + shift of an image of
// CPR_A chunks a row (hi plane at a_hi, lo plane a_plane bytes on), its
// chunks from cbase; the stage's weights at w_hi (lo plane w_plane bytes
// on).  3xTF32, small terms first: lo x hi, hi x lo, hi x hi.
template <int C, int K, int CPR_A>
__device__ __forceinline__ void stage_mma(float (*acc)[Tile<C, K>::NTW][4], unsigned a_hi,
                                          unsigned a_plane, int shift, int cbase, int mt_act,
                                          unsigned w_hi, int lane, int wm, int wn) {
  using P = Tile<C, K>;
  constexpr unsigned w_plane = (unsigned)C * P::KC * 4;
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);   // A: matrix row
  const int lch = lane >> 4;                              // A: channel half
#pragma unroll
  for (int ks = 0; ks < P::KC / 8; ++ks) {
    uint32_t bh[P::NTW / 2][4], bl[P::NTW / 2][4];
#pragma unroll
    for (int p = 0; p < P::NTW / 2; ++p) {
      const int n = (wn * P::NTW + 2 * p + (lane >> 4)) * 8 + (lane & 7);
      const unsigned off = (unsigned)(n * P::CPR + swz<P::CPR>(n, 2 * ks + ((lane >> 3) & 1))) * 16;
      ldsm_x4(bh[p], w_hi + off);
      ldsm_x4(bl[p], w_hi + w_plane + off);
    }
    const uint32_t* bp[3] = {&bh[0][0], &bl[0][0], &bh[0][0]};   // B of each pass
    if constexpr (P::NTW >= 8) {
      // a wide warp tile: one m-tile's A at a time; its NTW MMAs of a pass
      // lie between two into one accumulator
#pragma unroll
      for (int i = 0; i < P::MTW; ++i) {
        const int mt = wm + P::WM * i;
        if (mt < mt_act) {
          const int row = mt * 16 + lrow + shift;
          const unsigned off =
              (unsigned)(row * CPR_A + swz<CPR_A>(row, cbase + 2 * ks + lch)) * 16;
          uint32_t a[2][4];
          ldsm_x4(a[0], a_hi + off);
          ldsm_x4(a[1], a_hi + a_plane + off);
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int n = 0; n < P::NTW; ++n)
              mma_tf32(acc[i][n], a[pass == 0], bp[pass][4 * (n >> 1) + 2 * (n & 1)],
                       bp[pass][4 * (n >> 1) + 2 * (n & 1) + 1]);
        }
      }
    } else {
      // all the warp's A first, then each pass over all its tiles: MTW x
      // NTW MMAs between two into one accumulator
      uint32_t ah[P::MTW][4], al[P::MTW][4];
#pragma unroll
      for (int i = 0; i < P::MTW; ++i) {
        const int mt = wm + P::WM * i;
        if (mt < mt_act) {
          const int row = mt * 16 + lrow + shift;
          const unsigned off =
              (unsigned)(row * CPR_A + swz<CPR_A>(row, cbase + 2 * ks + lch)) * 16;
          ldsm_x4(ah[i], a_hi + off);
          ldsm_x4(al[i], a_hi + a_plane + off);
        }
      }
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int i = 0; i < P::MTW; ++i)
          if (wm + P::WM * i < mt_act)
#pragma unroll
            for (int n = 0; n < P::NTW; ++n)
              mma_tf32(acc[i][n], pass == 0 ? al[i] : ah[i],
                       bp[pass][4 * (n >> 1) + 2 * (n & 1)],
                       bp[pass][4 * (n >> 1) + 2 * (n & 1) + 1]);
    }
  }
}

template <int C, int K>
__global__ void __launch_bounds__(Tile<C, K>::THREADS, Tile<C, K>::MINB)
resblock_tc_step_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const float* __restrict__ wpack, const float* __restrict__ b1,
                        const float* __restrict__ b2, int Tlen, int dil, int TT, int mt1_launch,
                        int aligned) {
  using P = Tile<C, K>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ring = P::RING;
  const Layout L = layout(C, P::KC, ring, P::T1F, K, mt1_launch, dil);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + ring;
  const unsigned s_image = smem_u32(smem + L.image);
  const unsigned s_raw = smem_u32(smem + L.raw);
  const unsigned s_t1 = smem_u32(smem + L.t1);
  const unsigned s_ring = smem_u32(smem + L.ring);
  const float* raw = reinterpret_cast<const float*>(smem + L.raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = blockIdx.x * TT;
  const int rows = min(TT, Tlen - t0);                   // outputs of this block
  const int mt1 = min(mt1_launch, (rows + 2 * P::HC + 15) / 16);
  const int mt2 = (rows + 15) / 16;
  const int xstart = t0 - P::HC - P::HC * dil;           // time of image row 0
  const float* xb = x + (size_t)blockIdx.y * C * Tlen;
  float* ob = out + (size_t)blockIdx.y * C * Tlen;
  // raw row 0 is time xa; image row r reads raw row r + sh
  const int sh = aligned ? ((xstart % 4) + 4) % 4 : 0;
  const int xa = xstart - sh;

  if (tid == 0) {
    for (int s = 0; s < ring; ++s) {
      mbar_init(full + s, P::ISSUERS);
      mbar_init(empty + s, kMmaWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Stage g of the ring (weights of conv g / STAGES1, chunk, tap), with x
  // chunk ci's raw rows at stage (ci, 0), issued by threads t, t + nt, ..;
  // their copies complete the slot's full barrier.
  const int xr = 16 * mt1 + (K - 1) * dil;   // this block's image rows
  auto issue = [&](int g, int t, int nt) {
    const int slot = g % ring;
    const float* src = wpack + (size_t)g * P::STAGE_WORDS;
    const unsigned dst = s_ring + (unsigned)slot * P::STAGE_WORDS * 4;
#pragma unroll 4
    for (int i = t; i < P::STAGE_WORDS / 4; i += nt)   // laid out as it lands
      cp_async16(dst + 16 * i, src + 4 * i, 16);
    if (g < P::STAGES1 && g % K == 0) {
      const float* xc = xb + (size_t)(g / K) * P::KC * Tlen;
      if (aligned) {
        const int nq = (xr + sh + 3) / 4;   // 16-byte chunks of a channel's rows
        for (int i = t; i < P::KC * nq; i += nt) {
          const int c = i / nq;
          const int u = i - c * nq;
          const int tt = xa + 4 * u;
          const bool ok = tt >= 0 && tt + 4 <= Tlen;
          cp_async16(s_raw + (unsigned)(c * L.xrp + 4 * u) * 4,
                     ok ? xc + (size_t)c * Tlen + tt : xb, ok ? 16 : 0);
        }
      } else {
        for (int i = t; i < P::KC * xr; i += nt) {
          const int c = i / xr;
          const int r = i - c * xr;
          const int tt = xa + r;
          const bool ok = tt >= 0 && tt < Tlen;
          cp_async4(s_raw + (unsigned)(c * L.xrp + r) * 4, ok ? xc + (size_t)c * Tlen + tt : xb,
                    ok ? 4 : 0);
        }
      }
    }
    cp_async_arrive(full + slot);
  };
  constexpr int kStages = 2 * P::STAGES1;

  if constexpr (P::PRODUCER) {
    if (warp == kMmaWarps) {
      // ---- the producer warp: each stage once its slot is free
      for (int g = 0; g < kStages; ++g) {
        if (g >= ring) mbar_wait(empty + g % ring, (uint32_t)((g / ring - 1) & 1));
        issue(g, lane, 32);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      return;
    }
  } else {
    for (int g = 0; g + 1 < ring; ++g) issue(g, tid, kConsumers);
  }
  // Without a producer warp the MMA warps issue stage g + ring - 1 before
  // they wait for stage g, once every warp is done with stage g - 1.
  auto refill = [&](int g) {
    if constexpr (!P::PRODUCER) {
      if (g + ring - 1 < kStages) {
        if (g >= 1) mbar_wait(empty + (g - 1) % ring, (uint32_t)(((g - 1) / ring) & 1));
        issue(g + ring - 1, tid, kConsumers);
      }
    }
  };

  // ---- the MMA warps ---------------------------------------------------
  const int wn = warp % P::WN;
  const int wm = warp / P::WN;
  const int g8 = lane >> 2;
  const int q = lane & 3;
  const unsigned image_plane = (unsigned)xr * P::KC * 4;
  const unsigned t1_plane = (unsigned)16 * mt1_launch * C * 4;

  float acc[P::MTW][P::NTW][4];
#pragma unroll
  for (int i = 0; i < P::MTW; ++i)
#pragma unroll
    for (int n = 0; n < P::NTW; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][n][r] = 0.f;

  int g = 0;
  // ---- conv1 over rows [t0 - HC, t0 - HC + 16*mt1): chunk outer, tap inner
#pragma unroll 1
  for (int ci = 0; ci < P::NCH; ++ci) {
    if (ci > 0) mma_sync_bar();        // every warp is done with chunk ci - 1's image
    mbar_wait(full + g % ring, (uint32_t)((g / ring) & 1));   // raw chunk ci landed
    // lrelu(x) split into the image [row][KC] x 2 planes, rows along the lanes
#pragma unroll
    for (int cq = 0; cq < P::CPR; ++cq) {
      for (int r = tid; r < xr; r += kConsumers) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(lrelu(raw[(cq * 4 + e) * L.xrp + r + sh]), hi[e], lo[e]);
        const unsigned off = (unsigned)(r * P::CPR + swz<P::CPR>(r, cq)) * 16;
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(s_image + off),
                     "r"(hi[0]), "r"(hi[1]), "r"(hi[2]), "r"(hi[3]) : "memory");
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(s_image + image_plane + off),
                     "r"(lo[0]), "r"(lo[1]), "r"(lo[2]), "r"(lo[3]) : "memory");
      }
    }
    mma_sync_bar();                    // the image is complete
#pragma unroll 1
    for (int j = 0; j < K; ++j, ++g) {
      const int slot = g % ring;
      refill(g);
      mbar_wait(full + slot, (uint32_t)((g / ring) & 1));
      stage_mma<C, K, P::CPR>(acc, s_image, image_plane, j * dil, 0, mt1,
                              s_ring + (unsigned)slot * P::STAGE_WORDS * 4, lane, wm, wn);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }
  }

  // ---- + b1, lrelu, zero outside [0, T), split -> the intermediate -----
  mma_sync_bar();                      // every warp is done with conv1's image
#pragma unroll
  for (int i = 0; i < P::MTW; ++i) {
    const int mt = wm + P::WM * i;
    if (mt < mt1) {
#pragma unroll
      for (int n = 0; n < P::NTW; ++n) {
        const int col = (wn * P::NTW + n) * 8 + 2 * q;
        const float bb0 = __ldg(b1 + col), bb1 = __ldg(b1 + col + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + g8 + 8 * h;
          const int t = t0 - P::HC + m;
          const bool in = t >= 0 && t < Tlen;
          const float v0 = in ? lrelu(acc[i][n][2 * h] + bb0) : 0.f;
          const float v1 = in ? lrelu(acc[i][n][2 * h + 1] + bb1) : 0.f;
          const unsigned off =
              (unsigned)(m * (C / 4) + swz<C / 4>(m, col >> 2)) * 16 + (col & 3) * 4;
          if constexpr (P::T1F) {
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(s_t1 + off), "f"(v0),
                         "f"(v1) : "memory");
          } else {
            uint32_t h0, l0, h1, l1;
            split_tf32(v0, h0, l0);
            split_tf32(v1, h1, l1);
            asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(s_t1 + off), "r"(h0),
                         "r"(h1) : "memory");
            asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(s_t1 + t1_plane + off),
                         "r"(l0), "r"(l1) : "memory");
          }
          acc[i][n][2 * h] = 0.f;
          acc[i][n][2 * h + 1] = 0.f;
        }
      }
    }
  }
  mma_sync_bar();                      // the intermediate is complete

  // ---- conv2 over rows [t0, t0 + 16*mt2) from the intermediate ---------
  const int r2 = 16 * mt2 + 2 * P::HC;         // rows conv2's taps read
  const unsigned img2_plane = (unsigned)L.r2 * P::KC * 4;
#pragma unroll 1
  for (int ci = 0; ci < P::NCH; ++ci) {
    if constexpr (P::T1F) {
      // chunk ci of the fp32 intermediate split into its image [row][KC]
      if (ci > 0) mma_sync_bar();      // every warp is done with chunk ci - 1's image
#pragma unroll
      for (int cq = 0; cq < P::CPR; ++cq) {
        for (int r = tid; r < r2; r += kConsumers) {
          float v[4] = {0.f, 0.f, 0.f, 0.f};
          if (r < 16 * mt1)
            asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                         : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                         : "r"(s_t1 + (unsigned)(r * (C / 4) + swz<C / 4>(r, ci * P::CPR + cq)) * 16)
                         : "memory");
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(v[e], hi[e], lo[e]);
          const unsigned off = (unsigned)(r * P::CPR + swz<P::CPR>(r, cq)) * 16;
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(s_image + off),
                       "r"(hi[0]), "r"(hi[1]), "r"(hi[2]), "r"(hi[3]) : "memory");
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(s_image + img2_plane + off),
                       "r"(lo[0]), "r"(lo[1]), "r"(lo[2]), "r"(lo[3]) : "memory");
        }
      }
      mma_sync_bar();                  // the image is complete
    }
#pragma unroll 1
    for (int j = 0; j < K; ++j, ++g) {
      const int slot = g % ring;
      refill(g);
      mbar_wait(full + slot, (uint32_t)((g / ring) & 1));
      if constexpr (P::T1F)
        stage_mma<C, K, P::CPR>(acc, s_image, img2_plane, j, 0, mt2,
                                s_ring + (unsigned)slot * P::STAGE_WORDS * 4, lane, wm, wn);
      else
        stage_mma<C, K, C / 4>(acc, s_t1, t1_plane, j, ci * P::CPR, mt2,
                               s_ring + (unsigned)slot * P::STAGE_WORDS * 4, lane, wm, wn);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }
  }

  // ---- x + (acc + b2) for the block's rows, straight from the fragments
  //      (lanes g of one channel write 8 consecutive times: 32-byte sectors)
#pragma unroll
  for (int i = 0; i < P::MTW; ++i) {
    const int mt = wm + P::WM * i;
    if (mt < mt2) {
#pragma unroll
      for (int n = 0; n < P::NTW; ++n) {
        const int col = (wn * P::NTW + n) * 8 + 2 * q;
        const float bb0 = __ldg(b2 + col), bb1 = __ldg(b2 + col + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + g8 + 8 * h;
          if (m < rows) {
            const size_t o = (size_t)col * Tlen + t0 + m;
            ob[o] = xb[o] + (acc[i][n][2 * h] + bb0);
            ob[o + Tlen] = xb[o + Tlen] + (acc[i][n][2 * h + 1] + bb1);
          }
        }
      }
    }
  }
}

// Launches one step, or, with smem_query set, only reports the dynamic
// shared memory the launch would take.
template <int C, int K>
cudaError_t launch(const float* x, float* out, const float* wpack, const float* b1,
                   const float* b2, int B, int Tlen, int dil, int TT, cudaStream_t stream,
                   size_t* smem_query) {
  using P = Tile<C, K>;
  if (dil < 1 || dil > kMaxDil || TT < 1) return cudaErrorInvalidValue;
  const int mt1 = (TT + 2 * P::HC + 15) / 16;
  if (mt1 > P::MT_MAX) return cudaErrorInvalidValue;
  const size_t smem = layout(C, P::KC, P::RING, P::T1F, K, mt1, dil).total;
  if (smem_query) {
    *smem_query = smem;
    return cudaSuccess;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(resblock_tc_step_kernel<C, K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int aligned = Tlen % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const dim3 grid((Tlen + TT - 1) / TT, B);
  resblock_tc_step_kernel<C, K><<<grid, P::THREADS, smem, stream>>>(x, out, wpack, b1, b2, Tlen,
                                                                    dil, TT, mt1, aligned);
  return cudaGetLastError();
}

template <int C>
cudaError_t dispatch_k(const float* x, float* out, const float* wp, const float* b1,
                       const float* b2, int B, int Tlen, int K, int dil, int TT,
                       cudaStream_t s, size_t* q) {
  switch (K) {
    case 3: return launch<C, 3>(x, out, wp, b1, b2, B, Tlen, dil, TT, s, q);
    case 7: return launch<C, 7>(x, out, wp, b1, b2, B, Tlen, dil, TT, s, q);
    case 11: return launch<C, 11>(x, out, wp, b1, b2, B, Tlen, dil, TT, s, q);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const float* x, float* out, const float* wp, const float* b1,
                     const float* b2, int B, int C, int Tlen, int K, int dil, int TT,
                     cudaStream_t s, size_t* q) {
  switch (C) {
    case 16: return dispatch_k<16>(x, out, wp, b1, b2, B, Tlen, K, dil, TT, s, q);
    case 32: return dispatch_k<32>(x, out, wp, b1, b2, B, Tlen, K, dil, TT, s, q);
    case 64: return dispatch_k<64>(x, out, wp, b1, b2, B, Tlen, K, dil, TT, s, q);
    case 128: return dispatch_k<128>(x, out, wp, b1, b2, B, Tlen, K, dil, TT, s, q);
    case 256: return dispatch_k<256>(x, out, wp, b1, b2, B, Tlen, K, dil, TT, s, q);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One dilation step of a resblock in fp32: out = x + conv2(lrelu(conv1(
// lrelu(x)))).  x, out: (B, C, T) contiguous, distinct buffers.  wpack:
// this step's weights, both convs, split and laid out by ops/resblock.py
// `_tc_pack` ([conv][C / KC][K][hi, lo][C_out][KC] fp32 words, each row's
// 16-byte chunks swizzled as `swz`), 16-byte aligned; b1, b2: (C,).  C in {16, 32, 64, 128, 256}, K in {3, 7, 11},
// 1 <= dil <= 5; tt: output rows per block (`tc_time_tile`).  Returns
// cudaGetLastError() after launch.
int rvc_resblock_tc_step(const void* x, void* out, const void* wpack, const void* b1,
                         const void* b2, int B, int C, int T, int K, int dil, int tt,
                         void* stream) {
  if (B <= 0 || T <= 0 || dil <= 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(wpack) % 16) return (int)cudaErrorMisalignedAddress;
  return (int)dispatch(static_cast<const float*>(x), static_cast<float*>(out),
                       static_cast<const float*>(wpack), static_cast<const float*>(b1),
                       static_cast<const float*>(b2), B, C, T, K, dil, tt,
                       static_cast<cudaStream_t>(stream), nullptr);
}

// Dynamic shared memory, in bytes, of one step at (C, K, dil) with tt
// output rows per block; 0 for a shape the kernel does not take.
size_t rvc_resblock_tc_smem_bytes(int C, int K, int dil, int tt) {
  size_t smem = 0;
  if (dil <= 0 || dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, 1, C, 1, K, dil, tt,
                           nullptr, &smem) != cudaSuccess)
    return 0;
  return smem;
}

const char* rvc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
