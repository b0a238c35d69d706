// Fused HiFi-GAN resblock step for Hopper (sm_90a) on the tensor cores in
// bf16: bf16 in and out, fp32 accumulation, each product one
// mma.sync.m16n8k16 with bf16 operands.  Plain C interface, bound from
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
// dense bf16 rate is 989 TFLOP/s, of which mma.sync itself reaches a part
// (csrc/tools/bf16_mma_rate.cu).  Beside it, every block streams both
// convs' weights (2 x k x C^2 bf16) from L2, so the longer a block's time
// tile the fewer times they are read.
//
// Design (csrc/resblock_tc.cu's, fitted to bf16, where no operand needs
// splitting; each point against what held the m16n8k8 design back).
//  1. mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (PTX ISA, the
//     m16n8k16 .bf16 fragments; CUTLASS SM80_16x8x16_F32BF16BF16F32_TN),
//     g = lane >> 2, q = lane & 3: a0..a3 = A[g][2q..2q+1], A[g+8][2q..],
//     A[g][2q+8..], A[g+8][2q+8..]; b0, b1 = B[2q..2q+1][g], B[2q+8..2q+9]
//     [g]; c0..c3 = D[g][2q], D[g][2q+1], D[g+8][2q], D[g+8][2q+1].  Twice
//     m16n8k8's work an instruction.
//  2. A from one ldmatrix.x4 per m-tile and k16 step.  lrelu(x) and the
//     intermediate are staged time-major ([row][channel], channels
//     contiguous): a 16-byte chunk is 8 channels of one row, and ldmatrix's
//     matrices are rows 0-7 / 8-15 x channels 0-7 / 8-15 of the m-tile.  A
//     tap's shift (j*d in conv1, j in conv2) is a row offset of the
//     per-lane addresses.  Every image is swizzled: chunk c of row r sits
//     at c ^ key(r) (`swz`), so the 8 rows an ldmatrix matrix reads fall on
//     8 distinct bank groups whatever the shift.
//  3. B from ldmatrix.x4.trans with the weights as they lie, (D, k, C_in,
//     C_out): a stage is one tap x KC input channels, KC rows of C_out,
//     copied with 16-byte cp.async by all 256 threads into a swizzled slot
//     of a ring of RING stages, one cp.async group a stage: as it starts
//     stage g each thread waits for its own copies of stage g, one barrier
//     makes everyone's visible and frees the slot of stage g - 1, and stage
//     g + RING - 1 goes into it.  One x4.trans gives b0, b1 of two
//     n-tiles.  The loop runs channel chunk outer, taps inner, so one chunk
//     of x serves all k taps.  No host-side pack.
//  4. 8 MMA warps, WM along time x WN along C_out, each MTW m-tiles x NTW
//     n-tiles (`Cfg`, 2 x 2 or more at every width, 4 x 8 at C = 256);
//     the accumulators stay in registers across both convs.  Where `Cfg`
//     says MINB = 2, two blocks share an SM (<= 113 KB, <= 128 registers).
//  5. 16-byte staging and stores.  The raw x chunk ([KC][8-row chunks] as
//     in device memory, from the 8-aligned time at or before the window's
//     first row) lands by 16-byte cp.async; the staging pass transposes
//     it with ldmatrix.x4.trans (8 channels x 8 times a matrix: each lane
//     gets a channel pair at one time), applies lrelu, rounds to bf16 and
//     writes 32-bit words of the image; the image's row 0 is that aligned
//     time, so the window's shift is one more row offset.  The epilogue
//     adds b2 into an fp32 tile in shared memory and writes bf16(x + tile)
//     along time, 8 samples (16 bytes) a load of x and a store.  Where T
//     is 4 mod 8 (C = 256 at an odd number of frames) each 16-byte piece
//     is two 8-byte ones; where T is not a multiple of 4 or a pointer is
//     not aligned, x is staged and the output written 2 bytes at a time.
//  6. The time tile TT is a launch argument, chosen per launch from (B, T,
//     C, k) by the wrapper (`tc_time_tile` over `TC_BF16_TILES`): the
//     longest that MT_MAX m-tiles of conv1 take, cut so that the grid runs
//     in whole waves (one block an SM) or fills the SMs (two).  MT1 =
//     ceil((TT + k - 1) / 16) m-tiles of conv1, MT2 = ceil(TT / 16) of
//     conv2.  The arithmetic of an output does not depend on the tile.
//
// Shared memory (`layout`): during conv1 the x image ([IR][KC] bf16) and
// the raw chunk ([KC][XRPC] 16-byte chunks, XRPC odd so that the 8
// channel rows of a transposing ldmatrix fall on distinct bank groups);
// the intermediate ([16*MT1][C] bf16) laid over them after conv1; the
// ring (RING x [KC][C] bf16); after conv2 the fp32 output tile
// ([C][16*MT1 + 12]) over all of these.  Conv2's last m-tile reads up to
// k - 1 rows past the intermediate (the ring's words): only rows past TT,
// whose outputs are never written, read them.
//
// tests/test_torch_resblock.py holds a numpy model of this kernel
// (`tc_bf16_step_model`, `tc_bf16_layout`, `TC_BF16_CFG`): the staged
// images, the swizzles, ldmatrix's lane maps (x4, x4.trans), the m16n8k16
// fragments, the ring's stages, the time tile, with NaN in every word the
// kernel never writes and a bank check on every shared access above.

#include <cuda_bf16.h>
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
constexpr int kTilePad = 12;                  // fp32 tile row: 16*MT1 + 12 words

// Per width: KC input channels per stage, MT_MAX m-tiles of conv1 at most,
// WM warps along time (WN = 8 / WM along C_out), RING weight stages in
// the ring, MINB blocks an SM holds.  Chosen by timing alternatives on
// the card (PERF.md, csrc/tools/resblock_tc_tune.py).  Mirrored by
// ops/resblock.py `TC_BF16_TILES` and by the tests' model.
template <int C> struct Cfg;
template <> struct Cfg<256> { static constexpr int KC = 64, MT_MAX = 8, WM = 2, RING = 3, MINB = 1; };
template <> struct Cfg<128> { static constexpr int KC = 64, MT_MAX = 8, WM = 2, RING = 3, MINB = 2; };
template <> struct Cfg<64> { static constexpr int KC = 32, MT_MAX = 16, WM = 4, RING = 3, MINB = 2; };
template <> struct Cfg<32> { static constexpr int KC = 32, MT_MAX = 32, WM = 8, RING = 3, MINB = 2; };
template <> struct Cfg<16> { static constexpr int KC = 16, MT_MAX = 32, WM = 8, RING = 3, MINB = 2; };

template <int C, int K>
struct Tile {
  static constexpr int KC = Cfg<C>::KC;
  static constexpr int MT_MAX = Cfg<C>::MT_MAX;
  static constexpr int WM = Cfg<C>::WM;
  static constexpr int RING = Cfg<C>::RING;
  static constexpr int MINB = Cfg<C>::MINB;
  static constexpr int THREADS = kConsumers;
  static constexpr int WN = kMmaWarps / WM;
  static constexpr int NTW = C / 8 / WN;         // n-tiles per warp
  static constexpr int MTW = MT_MAX / WM;        // m-tiles per warp, at most
  static constexpr int HC = (K - 1) / 2;
  static constexpr int NCH = C / KC;             // channel chunks per conv
  static constexpr int CPR_X = KC / 8;           // 16-byte chunks per x image row
  static constexpr int CPR_T = C / 8;            // .. per intermediate row, per weight row
  static constexpr int STAGES1 = NCH * K;        // stages of one conv
  static constexpr int STAGE_BYTES = KC * C * 2;
  static_assert(NTW >= 2 && NTW % 2 == 0 && MTW >= 2, "a warp takes 2 x 2 tiles or more");
  static_assert(C % KC == 0 && KC % 16 == 0, "unsupported chunk");
  static_assert(RING >= 2 && (NCH == 1 || K >= RING),
                "a chunk's raw x is copied again only once every warp staged it");
};

struct Layout {
  int xrpc;                    // raw 16-byte chunks per channel row (odd)
  size_t image, raw, t1, ring, total;   // byte offsets; total bytes
};

// mt1: conv1's m-tiles at the launch's tile; every block's fit in it.
__host__ __device__ inline Layout layout(int C, int KC, int ring, int K, int mt1, int dil) {
  Layout L;
  const int xr = 16 * mt1 + (K - 1) * dil;     // rows conv1's taps read
  const int xrc = (xr + 7 + 7) / 8;            // 8-row chunks from the aligned time before
  L.xrpc = xrc | 1;
  const size_t image = (size_t)8 * xrc * KC * 2, raw = (size_t)KC * L.xrpc * 16;
  const size_t t1 = (size_t)16 * mt1 * C * 2;
  const size_t u = ((image + raw > t1 ? image + raw : t1) + 15) & ~(size_t)15;
  L.image = 0;                 // [x image + raw | t1][ring], the fp32 tile over all
  L.raw = image;
  L.t1 = u - t1;
  L.ring = u;
  const size_t ring_end = L.ring + (size_t)ring * KC * C * 2;
  const size_t tile = (size_t)C * (16 * mt1 + kTilePad) * 4;
  L.total = ring_end > tile ? ring_end : tile;
  return L;
}

// the 16-byte chunk of chunk c of row r in an image of CPR chunks a row:
// any 8 consecutive rows of one chunk fall on 8 distinct bank groups
template <int CPR>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(CPR == 1 || CPR == 2 || CPR == 4 || CPR % 8 == 0, "unsupported row");
  if constexpr (CPR >= 8) return c ^ (r & 7);
  else return c ^ ((r / (8 / CPR)) & (CPR - 1));
}

__device__ __forceinline__ float lrelu(float v) { return v >= 0.f ? v : v * kSlope; }

// two floats rounded to bf16 (to nearest, ties to even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ float lo_bf16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t u) { return __uint_as_float(u & 0xFFFF0000u); }
// bf16(lrelu(.)) of both halves of a bf16 pair
__device__ __forceinline__ uint32_t lrelu_pair(uint32_t u) {
  return pack_bf16(lrelu(lo_bf16(u)), lrelu(hi_bf16(u)));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronous; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async8(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// this thread's cp.async groups but the newest N have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void mma_sync_bar() {
  asm volatile("bar.sync %0, %1;\n" ::"r"(kBarMma), "r"(kConsumers) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void st_shared_b32(unsigned addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
// d += A(16x16) @ B(16x8), bf16 in, fp32 accumulate (registers only: the
// compiler may schedule it between the fragment loads)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage's MMAs for a warp: A rows mt*16 + .. + shift of an image of
// CPR_A chunks a row at a_base, its chunks from cbase; the stage's weights
// ([KC][C] bf16, rows swizzled) at w.  Per k16 step the warp's B (NTW / 2
// x4.trans), then per m-tile its A (one x4) and NTW MMAs.
template <int C, int K, int CPR_A>
__device__ __forceinline__ void stage_mma(float (*acc)[Tile<C, K>::NTW][4], unsigned a_base,
                                          int shift, int cbase, int mt_act, unsigned w,
                                          int lane, int wm, int wn) {
  using P = Tile<C, K>;
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);   // matrix row: A time, B channel
  const int lch = lane >> 4;                              // A: channel half; B: n-tile of a pair
#pragma unroll
  for (int ks = 0; ks < P::KC / 16; ++ks) {
    uint32_t b[P::NTW / 2][4];
#pragma unroll
    for (int p = 0; p < P::NTW / 2; ++p) {
      const int r = ks * 16 + lrow;
      const int c = wn * P::NTW + 2 * p + lch;
      ldsm_x4_trans(b[p], w + (unsigned)(r * P::CPR_T + swz<P::CPR_T>(r, c)) * 16);
    }
#pragma unroll
    for (int i = 0; i < P::MTW; ++i) {
      const int mt = wm + P::WM * i;
      if (mt < mt_act) {
        const int row = mt * 16 + lrow + shift;
        uint32_t a[4];
        ldsm_x4(a, a_base + (unsigned)(row * CPR_A + swz<CPR_A>(row, cbase + 2 * ks + lch)) * 16);
#pragma unroll
        for (int n = 0; n < P::NTW; ++n)
          mma_bf16(acc[i][n], a, b[n >> 1][2 * (n & 1)], b[n >> 1][2 * (n & 1) + 1]);
      }
    }
  }
}

template <int C, int K>
__global__ void __launch_bounds__(Tile<C, K>::THREADS, Tile<C, K>::MINB)
resblock_tc_bf16_step_kernel(const __nv_bfloat16* __restrict__ x,
                             __nv_bfloat16* __restrict__ out,
                             const __nv_bfloat16* __restrict__ w1,
                             const __nv_bfloat16* __restrict__ b1,
                             const __nv_bfloat16* __restrict__ w2,
                             const __nv_bfloat16* __restrict__ b2, int Tlen, int dil, int TT,
                             int mt1_launch, int vec) {
  using P = Tile<C, K>;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ring = P::RING;
  const Layout L = layout(C, P::KC, ring, K, mt1_launch, dil);
  const unsigned s_image = smem_u32(smem + L.image);
  const unsigned s_raw = smem_u32(smem + L.raw);
  const unsigned s_t1 = smem_u32(smem + L.t1);
  const unsigned s_ring = smem_u32(smem + L.ring);
  const unsigned s_tile = smem_u32(smem);

  // vec: bf16 elements a global access of x and out moves (8, 4, or 1)
  const bool aligned = vec > 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = blockIdx.x * TT;
  const int rows = min(TT, Tlen - t0);                   // outputs of this block
  const int mt1 = min(mt1_launch, (rows + 2 * P::HC + 15) / 16);
  const int mt2 = (rows + 15) / 16;
  const int xstart = t0 - P::HC - P::HC * dil;           // time of the window's first row
  const __nv_bfloat16* xb = x + (size_t)blockIdx.y * C * Tlen;
  __nv_bfloat16* ob = out + (size_t)blockIdx.y * C * Tlen;
  // image row 0 is time xa, 8-aligned where the raw chunk is copied whole;
  // the window's row r is image row r + sh
  const int sh = aligned ? (xstart & 7) : 0;
  const int xa = xstart - sh;
  const int xr = 16 * mt1 + (K - 1) * dil;               // this block's window rows
  const int xrc = (xr + sh + 7) / 8;                     // its 8-row chunks

  // Stage g of the ring (conv g / STAGES1, chunk, tap j: rows j*C + chunk
  // of that conv's (k, C_in, C_out) weights), issued by every thread, with
  // x chunk ci's raw rows at stage (ci, 0) where x is copied whole.
  auto issue = [&](int g) {
    const int slot = g % ring;
    const int conv = g / P::STAGES1;
    const int ci = (g - conv * P::STAGES1) / K;
    const int j = g % K;
    const __nv_bfloat16* src = (conv ? w2 : w1) + ((size_t)j * C + ci * P::KC) * C;
    const unsigned dst = s_ring + (unsigned)slot * P::STAGE_BYTES;
#pragma unroll 1
    for (int i = tid; i < P::KC * P::CPR_T; i += kConsumers) {
      const int r = i / P::CPR_T;
      cp_async16(dst + (unsigned)(r * P::CPR_T + swz<P::CPR_T>(r, i - r * P::CPR_T)) * 16,
                 src + 8 * i, 16);
    }
    if (aligned && conv == 0 && j == 0) {
      const __nv_bfloat16* xc = xb + (size_t)ci * P::KC * Tlen;
      for (int i = tid; i < P::KC * xrc; i += kConsumers) {
        const int c = i / xrc;
        const int u = i - c * xrc;
        const int tt = xa + 8 * u;
        const unsigned dst = s_raw + (unsigned)(c * L.xrpc + u) * 16;
        if (vec == 8) {
          const bool ok = tt >= 0 && tt + 8 <= Tlen;
          cp_async16(dst, ok ? xc + (size_t)c * Tlen + tt : xb, ok ? 16 : 0);
        } else {                       // two 4-time halves, each whole in [0, T) or zeros
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool ok = tt + 4 * h >= 0 && tt + 4 * h + 4 <= Tlen;
            cp_async8(dst + 8 * h, ok ? xc + (size_t)c * Tlen + tt + 4 * h : xb, ok ? 8 : 0);
          }
        }
      }
    }
  };
  constexpr int kStages = 2 * P::STAGES1;
  for (int g = 0; g + 1 < ring; ++g) {
    if (g < kStages) issue(g);
    cp_async_commit();
  }
  // Stage g: this thread's copies of it landed (ring - 2 groups after it
  // may still be in flight); the barrier makes every thread's visible and
  // means every warp is done with stage g - 1, whose slot takes stage g +
  // ring - 1.
  auto acquire = [&](int g) {
    cp_async_wait<ring - 2>();
    mma_sync_bar();
    if (g + ring - 1 < kStages) issue(g + ring - 1);
    cp_async_commit();
  };

  // ---- the MMA warps ---------------------------------------------------
  const int wn = warp % P::WN;
  const int wm = warp / P::WN;
  const int g8 = lane >> 2;
  const int q = lane & 3;

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
    acquire(g);                        // raw chunk ci; every warp done with chunk ci - 1's image
    // bf16(lrelu(x)) -> the image [row][KC], channel pairs in 32-bit words
    if (aligned) {
      // matrix b: channels 8*(b % CPR_X) .. + 7 x the 8 times of raw chunk
      // b / CPR_X, transposed: lane (g8, q) holds channels 2q, 2q + 1 at
      // time g8, word q of that row's chunk
      const int nblk = xrc * P::CPR_X;
      for (int b0 = warp * 4; b0 < nblk; b0 += kMmaWarps * 4) {
        const int bl = min(b0 + (lane >> 3), nblk - 1);
        const int ch = (bl % P::CPR_X) * 8 + (lane & 7);
        uint32_t v[4];
        ldsm_x4_trans(v, s_raw + (unsigned)(ch * L.xrpc + bl / P::CPR_X) * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int b = b0 + i;
          if (b < nblk) {
            const int row = 8 * (b / P::CPR_X) + g8;
            st_shared_b32(s_image + (unsigned)((row * P::CPR_X + swz<P::CPR_X>(row, b % P::CPR_X)) * 4 + q) * 4,
                          lrelu_pair(v[i]));
          }
        }
      }
    } else {
      // x 2 bytes at a time: word p (channels 2p, 2p + 1) of row r
      const __nv_bfloat16* xc = xb + (size_t)ci * P::KC * Tlen;
      for (int i = tid; i < (P::KC / 2) * xr; i += kConsumers) {
        const int r = i / (P::KC / 2);
        const int p = i - r * (P::KC / 2);
        const int tt = xstart + r;
        uint32_t v = 0u;
        if (tt >= 0 && tt < Tlen) {
          const __nv_bfloat16* s = xc + (size_t)(2 * p) * Tlen + tt;
          v = lrelu_pair((uint32_t)__bfloat16_as_ushort(s[0]) |
                         ((uint32_t)__bfloat16_as_ushort(s[Tlen]) << 16));
        }
        st_shared_b32(s_image + (unsigned)((r * P::CPR_X + swz<P::CPR_X>(r, p >> 2)) * 4 + (p & 3)) * 4, v);
      }
    }
    mma_sync_bar();                    // the image is complete
#pragma unroll 1
    for (int j = 0; j < K; ++j, ++g) {
      if (j > 0) acquire(g);
      stage_mma<C, K, P::CPR_X>(acc, s_image, j * dil + sh, 0, mt1,
                                s_ring + (unsigned)(g % ring) * P::STAGE_BYTES, lane, wm, wn);
    }
  }

  // ---- bf16(lrelu(+ b1)), 0 outside [0, T) -> the intermediate [row][C]
  mma_sync_bar();                      // every warp is done with conv1's image
#pragma unroll
  for (int i = 0; i < P::MTW; ++i) {
    const int mt = wm + P::WM * i;
    if (mt < mt1) {
#pragma unroll
      for (int n = 0; n < P::NTW; ++n) {
        const int col = (wn * P::NTW + n) * 8 + 2 * q;
        const float bb0 = __bfloat162float(b1[col]), bb1 = __bfloat162float(b1[col + 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 16 + g8 + 8 * h;
          const int t = t0 - P::HC + m;
          const bool in = t >= 0 && t < Tlen;
          const uint32_t v = in ? pack_bf16(lrelu(acc[i][n][2 * h] + bb0),
                                            lrelu(acc[i][n][2 * h + 1] + bb1)) : 0u;
          st_shared_b32(s_t1 + (unsigned)((m * P::CPR_T + swz<P::CPR_T>(m, col >> 3)) * 4 + q) * 4, v);
          acc[i][n][2 * h] = 0.f;
          acc[i][n][2 * h + 1] = 0.f;
        }
      }
    }
  }
  mma_sync_bar();                      // the intermediate is complete

  // ---- conv2 over rows [t0, t0 + 16*mt2) from the intermediate ---------
#pragma unroll 1
  for (int ci = 0; ci < P::NCH; ++ci) {
#pragma unroll 1
    for (int j = 0; j < K; ++j, ++g) {
      acquire(g);
      stage_mma<C, K, P::CPR_T>(acc, s_t1, j, ci * P::CPR_X, mt2,
                                s_ring + (unsigned)(g % ring) * P::STAGE_BYTES, lane, wm, wn);
    }
  }

  // ---- acc + b2 -> the fp32 tile [C][16*mt1_launch + 12], output row m at
  //      m + (t0 & 7), so that 8-aligned times are 16-byte aligned there
  cp_async_wait<0>();
  mma_sync_bar();                      // every warp is done with the ring and t1
  const int str = 16 * mt1_launch + kTilePad;
  const int toff = t0 & 7;
#pragma unroll
  for (int i = 0; i < P::MTW; ++i) {
    const int mt = wm + P::WM * i;
    if (mt < mt2) {
#pragma unroll
      for (int n = 0; n < P::NTW; ++n) {
        const int col = (wn * P::NTW + n) * 8 + 2 * q;
        const float bb0 = __bfloat162float(b2[col]), bb1 = __bfloat162float(b2[col + 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned off = (unsigned)(col * str + mt * 16 + g8 + 8 * h + toff) * 4;
          asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(s_tile + off), "f"(acc[i][n][2 * h] + bb0)
                       : "memory");
          asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(s_tile + off + str * 4),
                       "f"(acc[i][n][2 * h + 1] + bb1) : "memory");
        }
      }
    }
  }
  mma_sync_bar();                      // the tile is complete

  // ---- bf16(x + tile) along time.  Chunk u of a channel is the 8 times
  //      from t0 - toff + 8u: where x is aligned, the block's whole chunks
  //      [u0, u1) 16 bytes at a time, then the rows before and after them
  //      (all rows where it is not) 2 bytes at a time along time
  const int u0 = aligned ? (toff + 7) / 8 : 0;
  const int u1 = aligned ? (toff + rows) / 8 : 0;
  const int nw = max(u1 - u0, 0);
  constexpr int kBatch = 4;                              // x loads in flight a thread
  for (int i0 = tid; i0 < C * nw; i0 += kBatch * kConsumers) {
    uint4 xv[kBatch];
#pragma unroll
    for (int s = 0; s < kBatch; ++s) {
      const int i = i0 + s * kConsumers;
      if (i < C * nw) {
        const int col = i / nw;
        const size_t o = (size_t)col * Tlen + t0 + 8 * (u0 + i - col * nw) - toff;
        if (vec == 8) {
          asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(xv[s].x), "=r"(xv[s].y), "=r"(xv[s].z), "=r"(xv[s].w)
                       : "l"(xb + o));
        } else {
          asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n"
                       : "=r"(xv[s].x), "=r"(xv[s].y) : "l"(xb + o));
          asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];\n"
                       : "=r"(xv[s].z), "=r"(xv[s].w) : "l"(xb + o + 4));
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kBatch; ++s) {
      const int i = i0 + s * kConsumers;
      if (i < C * nw) {
        const int col = i / nw;
        const int u = u0 + i - col * nw;
        const size_t o = (size_t)col * Tlen + t0 + 8 * u - toff;
        const unsigned tp = s_tile + (unsigned)(col * str + 8 * u) * 4;
        // the two 16-byte halves, lanes 4-7 of each quarter warp the second
        // first, so that the 8 lanes of a phase fall on distinct bank groups
        const unsigned h = (lane >> 2) & 1;
        float4 v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                       : "=f"(v[e].x), "=f"(v[e].y), "=f"(v[e].z), "=f"(v[e].w)
                       : "r"(tp + 16 * (h ^ e)) : "memory");
        const float4 lo = h ? v[1] : v[0], hi = h ? v[0] : v[1];
        const float f[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const uint32_t xw[4] = {xv[s].x, xv[s].y, xv[s].z, xv[s].w};
        uint32_t ow[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ow[e] = pack_bf16(lo_bf16(xw[e]) + f[2 * e], hi_bf16(xw[e]) + f[2 * e + 1]);
        if (vec == 8) {
          asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(ob + o), "r"(ow[0]),
                       "r"(ow[1]), "r"(ow[2]), "r"(ow[3]) : "memory");
        } else {
          asm volatile("st.global.v2.u32 [%0], {%1, %2};\n" ::"l"(ob + o), "r"(ow[0]),
                       "r"(ow[1]) : "memory");
          asm volatile("st.global.v2.u32 [%0], {%1, %2};\n" ::"l"(ob + o + 4), "r"(ow[2]),
                       "r"(ow[3]) : "memory");
        }
      }
    }
  }
  const int mh = aligned ? min(rows, 8 * u0 - toff) : rows;       // rows before the chunks
  const int mtl = aligned ? max(mh, 8 * u1 - toff) : rows;        // first row after them
  const int ns = mh + rows - mtl;
  const float* tile = reinterpret_cast<const float*>(smem);
  for (int i = tid; i < C * ns; i += kConsumers) {
    const int col = i / ns;
    const int e = i - col * ns;
    const int m = e < mh ? e : mtl + e - mh;
    const size_t o = (size_t)col * Tlen + t0 + m;
    ob[o] = __float2bfloat16_rn(__bfloat162float(xb[o]) + tile[col * str + m + toff]);
  }
}

// Launches one step, or, with smem_query set, only reports the dynamic
// shared memory the launch would take.
template <int C, int K>
cudaError_t launch(const __nv_bfloat16* x, __nv_bfloat16* out, const __nv_bfloat16* w1,
                   const __nv_bfloat16* b1, const __nv_bfloat16* w2, const __nv_bfloat16* b2,
                   int B, int Tlen, int dil, int TT, cudaStream_t stream, size_t* smem_query) {
  using P = Tile<C, K>;
  if (dil < 1 || dil > kMaxDil || TT < 1) return cudaErrorInvalidValue;
  const int mt1 = (TT + 2 * P::HC + 15) / 16;
  if (mt1 > P::MT_MAX) return cudaErrorInvalidValue;
  const size_t smem = layout(C, P::KC, P::RING, K, mt1, dil).total;
  if (smem_query) {
    *smem_query = smem;
    return cudaSuccess;
  }
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(resblock_tc_bf16_step_kernel<C, K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const uintptr_t xo = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  const int vec = Tlen % 8 == 0 && xo % 16 == 0 ? 8 : Tlen % 4 == 0 && xo % 8 == 0 ? 4 : 1;
  const dim3 grid((Tlen + TT - 1) / TT, B);
  resblock_tc_bf16_step_kernel<C, K><<<grid, P::THREADS, smem, stream>>>(
      x, out, w1, b1, w2, b2, Tlen, dil, TT, mt1, vec);
  return cudaGetLastError();
}

using bf16p = const __nv_bfloat16*;

template <int C>
cudaError_t dispatch_k(bf16p x, __nv_bfloat16* out, bf16p w1, bf16p b1, bf16p w2, bf16p b2,
                       int B, int Tlen, int K, int dil, int TT, cudaStream_t s, size_t* q) {
  switch (K) {
    case 3: return launch<C, 3>(x, out, w1, b1, w2, b2, B, Tlen, dil, TT, s, q);
    case 7: return launch<C, 7>(x, out, w1, b1, w2, b2, B, Tlen, dil, TT, s, q);
    case 11: return launch<C, 11>(x, out, w1, b1, w2, b2, B, Tlen, dil, TT, s, q);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(bf16p x, __nv_bfloat16* out, bf16p w1, bf16p b1, bf16p w2, bf16p b2,
                     int B, int C, int Tlen, int K, int dil, int TT, cudaStream_t s, size_t* q) {
  switch (C) {
    case 16: return dispatch_k<16>(x, out, w1, b1, w2, b2, B, Tlen, K, dil, TT, s, q);
    case 32: return dispatch_k<32>(x, out, w1, b1, w2, b2, B, Tlen, K, dil, TT, s, q);
    case 64: return dispatch_k<64>(x, out, w1, b1, w2, b2, B, Tlen, K, dil, TT, s, q);
    case 128: return dispatch_k<128>(x, out, w1, b1, w2, b2, B, Tlen, K, dil, TT, s, q);
    case 256: return dispatch_k<256>(x, out, w1, b1, w2, b2, B, Tlen, K, dil, TT, s, q);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// One dilation step of a resblock in bf16: out = x + conv2(lrelu(conv1(
// lrelu(x)))), fp32 accumulation.  x, out: (B, C, T) contiguous, distinct
// buffers.  w1, w2: (K, C_in, C_out) contiguous (this step's taps),
// 16-byte aligned; b1, b2: (C,).  All six bf16.  C in {16, 32, 64, 128,
// 256}, K in {3, 7, 11}, 1 <= dil <= 5; tt: output rows per block
// (`tc_time_tile`).  Returns cudaGetLastError() after launch.
int rvc_resblock_tc_bf16_step(const void* x, void* out, const void* w1, const void* b1,
                              const void* w2, const void* b2, int B, int C, int T, int K,
                              int dil, int tt, void* stream) {
  if (B <= 0 || T <= 0 || dil <= 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w1) | reinterpret_cast<uintptr_t>(w2)) % 16)
    return (int)cudaErrorMisalignedAddress;
  return (int)dispatch(static_cast<bf16p>(x), static_cast<__nv_bfloat16*>(out),
                       static_cast<bf16p>(w1), static_cast<bf16p>(b1),
                       static_cast<bf16p>(w2), static_cast<bf16p>(b2), B, C, T, K, dil, tt,
                       static_cast<cudaStream_t>(stream), nullptr);
}

// Dynamic shared memory, in bytes, of one step at (C, K, dil) with tt
// output rows per block; 0 for a shape the kernel does not take.
size_t rvc_resblock_tc_bf16_smem_bytes(int C, int K, int dil, int tt) {
  size_t smem = 0;
  if (dil <= 0 || dispatch(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, C, 1, K,
                           dil, tt, nullptr, &smem) != cudaSuccess)
    return 0;
  return smem;
}

const char* rvc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
