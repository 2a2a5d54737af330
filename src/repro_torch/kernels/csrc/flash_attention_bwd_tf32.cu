// K7's VJP in float32, on Hopper's TF32 tensor cores (sm_90a).  The
// formulas, the launch order (dq, which writes D = <dO, o> first, then
// dk/dv, which reads it) and the bf16 route are flash_attention_bwd.cu's;
// this file holds the float32 route: flash_bwd_dq_tf32_kernel and
// flash_bwd_dkdv_tf32_kernel.  Like the bf16 route it replaces no TPU
// kernel (the reference trains through XLA's autodiff of L.attention,
// src/repro/models/transformer/layers.py:152).
//
// Bound.  The products S, dP, dV, dK and dQ, 2 * pairs * (3 hd + 2 hd_v)
// flops over the pairs the masks keep, at the TF32 peak (495 TFLOP/s),
// against q, k, v, o, dO, lse read once and dq, dk, dv written once.  At
// Qwen2.5-14B's training shape (4 x 1024, 40 / 8 x 128, causal) that is
// 0.217 ms; the two kernels take 7 products (dq recomputes S and dP,
// 0.304 ms at the peak), each in three TF32 passes (0.91 ms).
//
// Arithmetic (as the TF32 forward, flash_attention.cu): one TF32 pass
// keeps 10 of float32's 23 mantissa bits and misses the float32 bound (1e-4
// of the largest gradient; tests/test_torch_attention_bwd.py emulates
// both), so every operand x of every product is split into hi =
// cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi) and each product takes
// three TF32 passes, hi hi + hi lo + lo hi.  P and dS are split too.
//
// Layouts.  TF32 wgmma reads a shared-memory operand K-major only (the
// reduction dim contiguous) and takes its A operand from shared memory or
// registers.  Every product is written so that its B operand is a tile as
// it lies in shared memory, rows along N and the reduction contiguous,
// and its A operand is read into registers by the threads themselves
// (any layout will do there), so no tile is ever copied transposed:
//   dq block (64 query rows):
//     S     = Q K^T      A: Q (raw, resident), split in registers;  B: K hi/lo
//     dP    = dO V^T     A: dO (raw, resident), split in registers; B: V hi/lo
//     dQ^T += K^T dS^T   A: K^T read from K hi/lo;  B: dS hi/lo (query rows,
//                        keys contiguous: the accumulator's own layout)
//   dk/dv block (64 keys):
//     S^T   = K Q^T      A: K (raw, resident), split in registers;  B: Q hi/lo
//     dP^T  = V dO^T     A: V (raw, resident), split in registers;  B: dO hi/lo
//     dV^T += dO^T P     A: dO^T read from dO hi/lo;  B: P^T hi/lo (key rows)
//     dK^T += Q^T dS     A: Q^T read from Q hi/lo;    B: dS^T hi/lo
// The accumulating products run transposed (the gradient's width is M, in
// m-tiles of 64; hd 96 takes two, the second half empty), so P^T and dS^T
// go to shared memory in the layout the accumulator holds them, and their
// k-steps need no permutation (the forward permutes V^T's keys because it
// feeds P from registers).  A fragment: a thread holds rows r, r + 8 and
// k-slots t, t + 4 (r = 16 warp + lane / 4, t = lane % 4); raw tiles are
// read as TMA swizzled them (128-byte swizzle: the 16-byte unit XORed
// with the row mod 8), a warp's 32 reads of a register on 32 banks.
// Fragments of the raw products are loaded and split a group of k-steps
// at a time into one of two register buffers, the next group's loads
// running while the previous group's wgmmas do (wgmma.wait_group 1 before
// a buffer is reused).
//
// Blocks.  dq: 160 threads, a consumer warpgroup and a producer warp
// whose one thread issues TMA: Q and dO of the block's 64 rows once, K
// and V tiles of BK keys (64 to width 128, so that S and dP are m64n64
// products and Q's and dO's fragments are reloaded once every 64 keys; 32
// at the (192, *) pairs, 16 at 256, as shared memory allows) into a ring
// of stages with full/empty mbarriers; the consumers
// split K and V (hi over the landed tile, lo beside), write dS hi/lo, and
// free the stage once their fragments of K are in registers.  The grid
// runs the query tiles last first (the longest causal rows lead).
// dk/dv: 384 threads, a producer warpgroup (K and V of 64 keys once; Q and
// dO tiles of BQ queries, 32, 16 at width 256, into a ring of landing
// stages) and two consumer warpgroups split by output, as the
// bf16 dk/dv kernel: warpgroup 0 splits Q (hi over the landed tile, lo
// into the one Q lo buffer), computes S^T and P^T (written hi/lo for
// both) and accumulates dV^T; warpgroup 1 splits dO, computes dP^T,
// reads P^T and writes dS^T hi/lo and accumulates dK^T.  Only the landed
// tiles take stages: the lo, P^T and dS^T buffers are single, a barrier
// of both warpgroups before each tile's splits, so 32-query tiles fit two
// stages at width 128 (with a stage each for every buffer, 32-query
// tiles fit one stage and 16-query tiles two; scripts/k7_tf32_vjp_tiles.py
// times the choices).  setmaxnreg moves
// registers from the producer (24) to the consumers (240); a producer warp
// in a 288-thread block instead left ptxas at 168 registers, spilling and
// serializing wgmmas at four pairs.  Within ptxas's 168 registers a
// thread, warpgroup 0 holds dV^T (128 registers at width 256) beside one
// k-step of K's fragments at a time there, two elsewhere (GK_DKDV; more
// spilled).  Each walks the G query heads of its kv head in order.
// Shared memory: the raw resident tiles 256 (hd + hd_v) bytes; dq's
// stage 8 BK (hd + hd_v) beside dS hi/lo; dk/dv's single buffers BQ (4
// (hd + hd_v) + 1024) and stage 4 BQ (hd + hd_v); two stages where they
// fit (TileT; every pair within the 227 KB a block may use,
// bwd_launch_plan states the same numbers).
//
// No float atomics: each gradient element is one accumulator slot summed
// over the walked tiles in order, bitwise repeatable.  Masks only on the
// tiles that cross the diagonal, the window edge, Sq or Skv; rows past Sq
// and keys past Skv arrive as zeros from TMA and read as P = 0; hd 80
// runs on the hd-96 tiles with maps 80 wide (TMA fills columns 80-95 with
// zeros), as the forward does, and stores only the tensors' columns.
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int ROWS = 64;            // a block's own rows; the M of every wgmma
constexpr int CHUNK = ROWS * 128;   // a 32-column chunk of a 64-row tile
constexpr int SMEM_MAX = 232448;    // the dynamic shared memory a block may use
constexpr int DQ_THREADS = 160;     // a consumer warpgroup and a producer warp
constexpr int DKDV_THREADS = 384;   // a producer warpgroup and two consumer warpgroups

// element strides (batch, head, position) of each tensor; the last dim is
// contiguous
struct Strides {
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
};

// HD, HDV: the q/k and v tile widths (hd 80 on the 96-wide tiles)
template <int HD, int HDV>
struct TileT {
  static_assert(HD % 32 == 0 && HDV % 32 == 0, "rows of whole 128-byte chunks");
  static constexpr int W = HD + HDV;
  static constexpr int MT = (HD + 63) / 64, MTV = (HDV + 63) / 64;  // m-tiles of dQ^T / dK^T, dV^T
  // k-steps a register group of the raw products, in dq and in dk/dv
  static constexpr int GK = HD >= 256 ? 2 : 4;
  static constexpr int GK_DKDV = HD >= 256 ? 1 : 2;
  // dq: slack, Q and dO, dS hi/lo; a stage holds K (hi), K lo, V (hi), V lo
  static constexpr int BK = W <= 256 ? 64 : (W <= 384 ? 32 : 16);
  static constexpr int GT_DQ = BK / 8 < 4 ? BK / 8 : 4;   // k-steps a group of dQ^T
  static constexpr int DQ_FIXED = 1024 + 256 * W + 512 * BK;
  static constexpr int DQ_STAGE = 8 * BK * W;
  static constexpr int DQ_STAGES = DQ_FIXED + 2 * DQ_STAGE + 8 * 5 <= SMEM_MAX ? 2 : 1;
  static constexpr int SMEM_DQ = DQ_FIXED + DQ_STAGES * DQ_STAGE + 8 * (1 + 2 * DQ_STAGES);
  // dk/dv: slack, K and V, the single buffers (Q lo, dO lo, P^T hi/lo,
  // dS^T hi/lo); a stage holds Q and dO as they land (then their hi)
  static constexpr int BQ = W <= 384 ? 32 : 16;
  // k-steps a group of dV^T / dK^T (two at the (192, *) pairs, whose
  // m-tiles take 96 registers)
  static constexpr int GT_DKDV = HD >= 192 && BQ > 16 ? 2 : BQ / 8;
  static constexpr int DKDV_FIXED = 1024 + 256 * W + BQ * (4 * W + 1024);
  static constexpr int DKDV_STAGE = 4 * BQ * W;
  static constexpr int DKDV_STAGES = DKDV_FIXED + 2 * DKDV_STAGE + 8 * 5 <= SMEM_MAX ? 2 : 1;
  static constexpr int SMEM_DKDV = DKDV_FIXED + DKDV_STAGES * DKDV_STAGE + 8 * (1 + 2 * DKDV_STAGES);
  static_assert(SMEM_DQ <= SMEM_MAX && SMEM_DKDV <= SMEM_MAX, "a block's shared memory");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// a TMA-landed float32 tile of 16-byte units, U for each of 128 threads:
// hi over the tile in place and lo into `lo`, byte for byte (so in the
// tile's swizzled layout); the loads of a batch of up to 8 units issue
// before its splits
template <int U>
__device__ __forceinline__ void split_tile(uint8_t* tile, uint8_t* lo, int tid) {
  constexpr int BATCH = U % 8 == 0 ? 8 : (U % 6 == 0 ? 6 : 4);
  static_assert(U % BATCH == 0, "whole batches");
#pragma unroll
  for (int k0 = 0; k0 < U; k0 += BATCH) {
    float4 x[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      x[k] = *reinterpret_cast<const float4*>(tile + 16 * (tid + 128 * (k0 + k)));
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      uint4 h, l;
      hopper::split_tf32(x[k].x, h.x, l.x);
      hopper::split_tf32(x[k].y, h.y, l.y);
      hopper::split_tf32(x[k].z, h.z, l.z);
      hopper::split_tf32(x[k].w, h.w, l.w);
      *reinterpret_cast<uint4*>(tile + 16 * (tid + 128 * (k0 + k))) = h;
      *reinterpret_cast<uint4*>(lo + 16 * (tid + 128 * (k0 + k))) = l;
    }
  }
}

// the TF32 hi/lo A fragment of k-step kk of a raw 64-row float32 tile
// (32-column chunks of CHUNK bytes, 128-byte swizzle): (row, column) (r,
// t), (r + 8, t), (r, t + 4), (r + 8, t + 4) of the k-step's 8 columns
__device__ __forceinline__ void frag_raw(const uint8_t* a, int kk, int r, int t,
                                         uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const uint8_t* row = a + (kk / 4) * CHUNK + r * 128 + 4 * t;
  const int u = 2 * (kk % 4), x = r & 7;
  const float v0 = *reinterpret_cast<const float*>(row + ((u ^ x) << 4));
  const float v1 = *reinterpret_cast<const float*>(row + 1024 + ((u ^ x) << 4));
  const float v2 = *reinterpret_cast<const float*>(row + (((u + 1) ^ x) << 4));
  const float v3 = *reinterpret_cast<const float*>(row + 1024 + (((u + 1) ^ x) << 4));
  hopper::split_tf32(v0, hi[0], lo[0]);
  hopper::split_tf32(v1, hi[1], lo[1]);
  hopper::split_tf32(v2, hi[2], lo[2]);
  hopper::split_tf32(v3, hi[3], lo[3]);
}

// the A fragment of T^T at m-tile mt and k-step kk: T an R-row tile of
// WIDTH columns (hi and lo, 32-column chunks of R rows, 128-byte swizzle),
// so A's rows are T's columns 64 mt + (r, r + 8) and its k-slots T's rows
// 8 kk + (t, t + 4); columns past WIDTH read as 0
template <int R, int WIDTH>
__device__ __forceinline__ void frag_t(const uint8_t* th, const uint8_t* tl, int mt, int kk,
                                       int r, int t, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int d = 64 * mt + r + 8 * (e & 1);
    const int row = 8 * kk + t + 4 * (e >> 1);
    const bool in = WIDTH % 64 == 0 || d < WIDTH;
    const int dd = in ? d : 0;
    const uint32_t off = (dd / 32) * (R * 128) + row * 128 +
                         ((((dd % 32) >> 2) ^ (row & 7)) << 4) + 4 * (dd & 3);
    const uint32_t h = *reinterpret_cast<const uint32_t*>(th + off);
    const uint32_t l = *reinterpret_cast<const uint32_t*>(tl + off);
    hi[e] = in ? h : 0u;
    lo[e] = in ? l : 0u;
  }
}

// acc (64 x N) += A (64 x 8) B^T (N x 8), A the tf32 fragment
template <int N>
__device__ __forceinline__ void mma(float (&acc)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16)
    hopper::wgmma_tf32_rs_n16(acc, a, db);
  else if constexpr (N == 32)
    hopper::wgmma_tf32_rs_n32(acc, a, db);
  else
    hopper::wgmma_tf32_rs_n64(acc, a, db);
}

// acc (64 x N) += A B^T over KS k-steps: A the raw 64-row tile `a`, split
// into hi/lo in registers GK k-steps at a time into buffer (group + P0) %
// 2; B hi/lo N-row tiles of 32-column chunks at bh, bl.  Three products a
// k-step, hi hi + hi lo + lo hi.  Every group is committed; none waited on
// at the end
template <int N, int KS, int GK, int P0>
__device__ __forceinline__ void mma_raw(float (&acc)[N / 2], uint32_t (&ah)[2][GK][4],
                                        uint32_t (&al)[2][GK][4], const uint8_t* a, uint32_t bh,
                                        uint32_t bl, int r, int t) {
  static_assert(KS % GK == 0, "whole groups");
#pragma unroll
  for (int g = 0; g < KS / GK; ++g) {
    const int b = (g + P0) & 1;
    hopper::wgmma_wait<1>();   // the group that read buffer b is done
#pragma unroll
    for (int j = 0; j < GK; ++j) frag_raw(a, g * GK + j, r, t, ah[b][j], al[b][j]);
    hopper::fence_regs(ah[b]);
    hopper::fence_regs(al[b]);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < GK; ++j) {
      const int kk = g * GK + j;
      const uint32_t at = (kk / 4) * (N * 128) + (kk % 4) * 32;
      const uint64_t dh = hopper::make_desc(bh + at, 16, 1024, 128);
      const uint64_t dl = hopper::make_desc(bl + at, 16, 1024, 128);
      mma<N>(acc, ah[b][j], dh);
      mma<N>(acc, ah[b][j], dl);
      mma<N>(acc, al[b][j], dh);
    }
    hopper::wgmma_commit();
  }
}

// a 64-row tile of R floats a row (dS, P^T, dS^T) as wgmma reads it: rows
// of SW bytes (64- or 128-byte swizzle), in chunks of CW columns
template <int R>
struct Narrow {
  static constexpr int SW = R >= 32 ? 128 : 4 * R;
  static constexpr int CW = SW / 4;
  static constexpr int CHB = ROWS * SW;   // bytes of a chunk
  // the byte of element (row, col)
  static __device__ __forceinline__ uint32_t at(int row, int col) {
    return (col / CW) * CHB + hopper::swz<SW>(row * SW + (col % CW) * 4);
  }
  // the descriptor of k-step kk (columns 8 kk .. 8 kk + 7) at byte `addr`
  static __device__ __forceinline__ uint64_t desc(uint32_t addr, int kk) {
    return hopper::make_desc(addr + ((8 * kk) / CW) * CHB + ((8 * kk) % CW) * 4, 16, 8 * SW,
                             SW);
  }
};

// acc[mt] (64 x 64) += T^T B^T for every m-tile: A = T^T (frag_t of the
// R-row tile T hi/lo, WIDTH columns), B hi/lo 64-row Narrow<R> tiles; the
// MT * R / 8 (m-tile, k-step) pairs in groups of GT k-steps of one m-tile,
// two register buffers alternating; every group committed, the last not
// waited on
template <int MT, int R, int WIDTH, int GT>
__device__ __forceinline__ void mma_t(float (&acc)[MT][32], uint32_t (&ah)[2][GT][4],
                                      uint32_t (&al)[2][GT][4], const uint8_t* th,
                                      const uint8_t* tl, uint32_t bh, uint32_t bl, int r, int t) {
  constexpr int KS = R / 8;
  static_assert(KS % GT == 0, "groups within an m-tile");
#pragma unroll
  for (int g = 0; g < MT * KS / GT; ++g) {
    const int b = g & 1, mt = (g * GT) / KS;
    hopper::wgmma_wait<1>();
#pragma unroll
    for (int j = 0; j < GT; ++j)
      frag_t<R, WIDTH>(th, tl, mt, (g * GT + j) % KS, r, t, ah[b][j], al[b][j]);
    hopper::fence_regs(ah[b]);
    hopper::fence_regs(al[b]);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < GT; ++j) {
      const int kk = (g * GT + j) % KS;
      const uint64_t dh = Narrow<R>::desc(bh, kk), dl = Narrow<R>::desc(bl, kk);
      hopper::wgmma_tf32_rs_n64(acc[mt], ah[b][j], dh);
      hopper::wgmma_tf32_rs_n64(acc[mt], ah[b][j], dl);
      hopper::wgmma_tf32_rs_n64(acc[mt], al[b][j], dh);
    }
    hopper::wgmma_commit();
  }
}

// a 64 x R accumulator (rows r, r + 8; columns 8 j + cq, + 1) split into
// hi and lo Narrow<R> tiles, as mma_t's B reads them
template <int R>
__device__ __forceinline__ void store_split(uint8_t* th, uint8_t* tl, const float (&x)[R / 2],
                                            int r, int cq) {
#pragma unroll
  for (int jn = 0; jn < R / 8; ++jn)
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const uint32_t o = Narrow<R>::at(r + 8 * i2, 8 * jn + cq);
      uint2 h, l;
      hopper::split_tf32(x[4 * jn + 2 * i2], h.x, l.x);
      hopper::split_tf32(x[4 * jn + 2 * i2 + 1], h.y, l.y);
      *reinterpret_cast<uint2*>(th + o) = h;
      *reinterpret_cast<uint2*>(tl + o) = l;
    }
}

// tensor maps over (width, position, head, batch) in float32, boxes of 32
// columns x 64 rows (the block's own tensors) or x BK / BQ (the walked)
template <int HD, int HDV>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_bwd_dq_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, const float* __restrict__ o,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ D, float* __restrict__ dq, const Strides st, int G,
                         int Sq, int Skv, int hd, int hd_v, int causal, int window, float scale) {
  using T = TileT<HD, HDV>;
  constexpr int BK = T::BK, S = T::DQ_STAGES, GK = T::GK, MT = T::MT;
  constexpr int K_BYTES = 4 * BK * HD, V_BYTES = 4 * BK * HDV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);   // raw, resident
  uint8_t* sdO = sQ + 256 * HD;
  uint8_t* sdSh = sdO + 256 * HDV;     // dS hi and lo: 64 query rows of BK keys
  uint8_t* sdSl = sdSh + 256 * BK;
  uint8_t* sStage = sdSl + 256 * BK;   // a stage: K (hi), K lo, V (hi), V lo
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sStage + S * T::DQ_STAGE);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + S;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;   // last query tile first
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y, kh = h / G, off = Skv - Sq;
  // the key tiles any row of this block sees
  const int qlast = min(q0 + ROWS, Sq) - 1 + off;
  const int kv_end = causal ? min(Skv, qlast + 1) : Skv;
  const int kv_begin = window ? max(0, q0 + off - window + 1) : 0;
  const int t_begin = kv_begin / BK, t_end = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 4);   // one arrival per consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warp: one thread issues every copy
    if (threadIdx.x == 128) {
      hopper::mbar_expect_tx(full_q, 256 * (HD + HDV));
      for (int c = 0; c < HD / 32; ++c)
        hopper::tma_load_4d(sQ + c * CHUNK, &tq, full_q, 32 * c, q0, h, b);
      for (int c = 0; c < HDV / 32; ++c)
        hopper::tma_load_4d(sdO + c * CHUNK, &tdo, full_q, 32 * c, q0, h, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % S;
        uint8_t* stg = sStage + s * T::DQ_STAGE;
        hopper::mbar_wait(empty + s, ((i / S) & 1) ^ 1);
        hopper::mbar_expect_tx(full + s, K_BYTES + V_BYTES);
        for (int c = 0; c < HD / 32; ++c)
          hopper::tma_load_4d(stg + c * BK * 128, &tk, full + s, 32 * c, t * BK, kh, b);
        for (int c = 0; c < HDV / 32; ++c)
          hopper::tma_load_4d(stg + 2 * K_BYTES + c * BK * 128, &tv, full + s, 32 * c, t * BK,
                              kh, b);
      }
    }
    return;
  }

  // the consumer warpgroup: a thread holds query rows r and r + 8 of its
  // warp's 16 in S and dP (columns 8 j + cq, + 1), and rows (columns of
  // dQ) 64 mt + r, + 8 of dQ^T (columns: queries 8 j + cq, + 1)
  const int tid = threadIdx.x, lane = tid & 31, t4 = lane & 3;
  const int r = (tid >> 5) * 16 + (lane >> 2), cq = 2 * t4;
  const long long bh = (long long)b * H + h;
  const int rows[2] = {q0 + r, q0 + r + 8};

  // D = <dO, o> of the thread's two rows: the quad's 4 threads sum columns
  // 8 j + cq, + 1 in order, then the quad adds its parts in a fixed tree;
  // lse in log2 units.  The loads of 8 column pairs issue before their sums
  float Dr[2] = {0.f, 0.f}, L2[2];
  const float* orow[2];
  const float* drow[2];
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    orow[i2] = o + b * st.o[0] + h * st.o[1] + (long long)rows[i2] * st.o[2];
    drow[i2] = dout + b * st.dout[0] + h * st.dout[1] + (long long)rows[i2] * st.dout[2];
    L2[i2] = rows[i2] < Sq ? lse[bh * Sq + rows[i2]] * LOG2E : 0.f;
  }
  constexpr int PAIRS = HDV / 8;
#pragma unroll
  for (int j0 = 0; j0 < PAIRS; j0 += 8) {
    float x[2][8][2], y[2][8][2];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * (j0 + jj) + cq + e;
          const bool in = j0 + jj < PAIRS && c < hd_v && rows[i2] < Sq;
          x[i2][jj][e] = in ? orow[i2][c] : 0.f;
          y[i2][jj][e] = in ? drow[i2][c] : 0.f;
        }
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) Dr[i2] = fmaf(x[i2][jj][e], y[i2][jj][e], Dr[i2]);
  }
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    Dr[i2] += __shfl_xor_sync(0xffffffffu, Dr[i2], 1);
    Dr[i2] += __shfl_xor_sync(0xffffffffu, Dr[i2], 2);
    if (t4 == 0 && rows[i2] < Sq) D[bh * Sq + rows[i2]] = Dr[i2];
  }

  const float scale_log2 = scale * LOG2E;
  const int wfirst = q0 + off, wlast = qlast;
  const bool rows_edge = q0 + ROWS > Sq;
  const uint32_t dsh_addr = hopper::smem_u32(sdSh), dsl_addr = hopper::smem_u32(sdSl);
  float dqt[MT][32];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int x = 0; x < 32; ++x) dqt[mt][x] = 0.f;
  uint32_t ah[2][GK][4], al[2][GK][4];
  uint32_t kth[2][T::GT_DQ][4], ktl[2][T::GT_DQ][4];
  hopper::mbar_wait(full_q, 0);

  for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
    const int s = i % S, k0 = t * BK;
    uint8_t* sK = sStage + s * T::DQ_STAGE;
    uint8_t* sKl = sK + K_BYTES;
    uint8_t* sV = sKl + K_BYTES;
    uint8_t* sVl = sV + V_BYTES;
    hopper::mbar_wait(full + s, (i / S) & 1);
    // K and V: hi in place, lo beside
    split_tile<K_BYTES / 2048>(sK, sKl, tid);
    split_tile<V_BYTES / 2048>(sV, sVl, tid);
    hopper::fence_proxy_async();
    // every warp's splits are in, and its products of the previous tile
    // are done with dS
    hopper::named_barrier(1, 128);

    // S = Q K^T, then dP = dO V^T, one register pipeline
    float sc[BK / 2], dp[BK / 2];
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) sc[x] = dp[x] = 0.f;
    mma_raw<BK, HD / 8, GK, 0>(sc, ah, al, sQ, hopper::smem_u32(sK), hopper::smem_u32(sKl), r,
                               t4);
    mma_raw<BK, HDV / 8, GK, (HD / 8 / GK) & 1>(dp, ah, al, sdO, hopper::smem_u32(sV),
                                                hopper::smem_u32(sVl), r, t4);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    // P, masked only on tiles that cross the diagonal, the window edge, Skv
    // or Sq; dS = P (dP - D)
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) sc[x] = exp2f(sc[x] * scale_log2 - L2[(x >> 1) & 1]);
    if (rows_edge || k0 + BK > Skv || (causal && k0 + BK - 1 > wfirst) ||
        (window && k0 <= wlast - window)) {
#pragma unroll
      for (int jn = 0; jn < BK / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * jn + cq + (e & 1);
          const int row = rows[e >> 1], qp = row + off;
          const bool ok = row < Sq && kpos < Skv && (!causal || kpos <= qp) &&
                          (!window || kpos > qp - window);
          if (!ok) sc[4 * jn + e] = 0.f;
        }
    }
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) sc[x] *= dp[x] - Dr[(x >> 1) & 1];
    store_split<BK>(sdSh, sdSl, sc, r, cq);
    hopper::fence_proxy_async();
    hopper::named_barrier(1, 128);

    // dQ^T += K^T dS^T; once this warp's fragments of K are in registers
    // (and its S and dP are done), the stage takes the next tile
    mma_t<MT, BK, HD, T::GT_DQ>(dqt, kth, ktl, sK, sKl, dsh_addr, dsl_addr, r, t4);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + s);
    hopper::wgmma_wait<0>();
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) hopper::fence_regs(dqt[mt]);

  // dQ[q, d] = scale dQ^T[d, q], the tensor's columns only
  float* dqb = dq + b * st.dq[0] + h * st.dq[1];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int jn = 0; jn < 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 64 * mt + r + 8 * (e >> 1), qr = q0 + 8 * jn + cq + (e & 1);
        if (d < hd && qr < Sq) dqb[(long long)qr * st.dq[2] + d] = scale * dqt[mt][4 * jn + e];
      }
}

template <int HD, int HDV>
__global__ void __launch_bounds__(DKDV_THREADS, 1)
flash_bwd_dkdv_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse,
                           const float* __restrict__ D, float* __restrict__ dk,
                           float* __restrict__ dv, const Strides st, int H, int Sq, int Skv, int hd,
                           int hd_v, int causal, int window, float scale) {
  using T = TileT<HD, HDV>;
  constexpr int BQ = T::BQ, S = T::DKDV_STAGES, GK = T::GK_DKDV;
  constexpr int Q_BYTES = 4 * BQ * HD, DO_BYTES = 4 * BQ * HDV, P_BYTES = 256 * BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);   // raw, resident
  uint8_t* sV = sK + 256 * HD;
  // the single buffers of the tile in hand, then the ring of landed tiles
  uint8_t* sQl = sV + 256 * HDV;
  uint8_t* sdOl = sQl + Q_BYTES;
  uint8_t* sPh = sdOl + DO_BYTES;
  uint8_t* sPl = sPh + P_BYTES;
  uint8_t* sSh = sPl + P_BYTES;
  uint8_t* sSl = sSh + P_BYTES;
  uint8_t* sStage = sSl + P_BYTES;   // a stage: Q, then dO, as TMA lands them
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sStage + S * T::DKDV_STAGE);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + S;

  const int k0 = blockIdx.x * ROWS;   // the first key tiles see the most queries
  const int kh = blockIdx.y, b = blockIdx.z, G = H / gridDim.y, off = Skv - Sq;
  // the query tiles that see a key of this tile
  const int klast = min(k0 + ROWS, Skv) - 1;
  const int q_begin = causal ? max(0, k0 - off) : 0;
  const int q_end = window ? min(Sq, klast + window - off) : Sq;
  const int i_begin = q_begin / BQ;
  const int i_end = q_end > q_begin ? (q_end + BQ - 1) / BQ : i_begin;

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_kv, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // producer warpgroup: one thread issues every copy
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(full_kv, 256 * (HD + HDV));
      for (int c = 0; c < HD / 32; ++c)
        hopper::tma_load_4d(sK + c * CHUNK, &tk, full_kv, 32 * c, k0, kh, b);
      for (int c = 0; c < HDV / 32; ++c)
        hopper::tma_load_4d(sV + c * CHUNK, &tv, full_kv, 32 * c, k0, kh, b);
      int it = 0;
      for (int g = 0; g < G; ++g)
        for (int ti = i_begin; ti < i_end; ++ti, ++it) {
          const int s = it % S;
          uint8_t* stg = sStage + s * T::DKDV_STAGE;
          hopper::mbar_wait(empty + s, ((it / S) & 1) ^ 1);
          hopper::mbar_expect_tx(full + s, Q_BYTES + DO_BYTES);
          for (int c = 0; c < HD / 32; ++c)
            hopper::tma_load_4d(stg + c * BQ * 128, &tq, full + s, 32 * c, ti * BQ, kh * G + g,
                                b);
          for (int c = 0; c < HDV / 32; ++c)
            hopper::tma_load_4d(stg + Q_BYTES + c * BQ * 128, &tdo, full + s, 32 * c,
                                ti * BQ, kh * G + g, b);
        }
    }
    return;
  }

  // consumers: in S^T and dP^T a thread holds keys k0 + r, + 8 of its
  // warp's 16 and query columns 8 j + cq, + 1 of the walked tile; in dV^T
  // and dK^T rows (gradient columns) 64 mt + r, + 8 and keys 8 j + cq, + 1
  hopper::setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int t128 = threadIdx.x & 127, lane = t128 & 31, t4 = lane & 3;
  const int r = (t128 >> 5) * 16 + (lane >> 2), cq = 2 * t4;
  const float scale_log2 = scale * LOG2E;
  const bool keys_edge = k0 + ROWS > Skv;
  uint32_t ah[2][GK][4], al[2][GK][4];
  uint32_t th[2][T::GT_DKDV][4], tl[2][T::GT_DKDV][4];
  hopper::mbar_wait(full_kv, 0);

  if (cw == 0) {
    constexpr int MTV = T::MTV;
    float dvt[MTV][32];
#pragma unroll
    for (int mt = 0; mt < MTV; ++mt)
#pragma unroll
      for (int x = 0; x < 32; ++x) dvt[mt][x] = 0.f;
    int it = 0;
    for (int g = 0; g < G; ++g) {
      const float* lse_h = lse + ((long long)b * H + kh * G + g) * Sq;
      for (int ti = i_begin; ti < i_end; ++ti, ++it) {
        const int s = it % S, i0 = ti * BQ;
        uint8_t* sQ = sStage + s * T::DKDV_STAGE;
        uint8_t* sdO = sQ + Q_BYTES;
        // lse (log2 units) of the thread's query columns
        float l2[BQ / 4];
#pragma unroll
        for (int jn = 0; jn < BQ / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = i0 + 8 * jn + cq + e;
            l2[2 * jn + e] = qc < Sq ? lse_h[qc] * LOG2E : 0.f;
          }
        hopper::mbar_wait(full + s, (it / S) & 1);
        // both warpgroups are done with the previous tile's single buffers
        hopper::named_barrier(4, 256);
        split_tile<Q_BYTES / 2048>(sQ, sQl, t128);
        hopper::fence_proxy_async();
        hopper::named_barrier(1, 256);   // Q and dO are split

        // S^T = K Q^T
        float pt[BQ / 2];
#pragma unroll
        for (int x = 0; x < BQ / 2; ++x) pt[x] = 0.f;
        mma_raw<BQ, HD / 8, GK, 0>(pt, ah, al, sK, hopper::smem_u32(sQ), hopper::smem_u32(sQl),
                                   r, t4);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(pt);
        // P^T; the mask only on tiles that cross the diagonal, the window
        // edge, Skv or Sq
        const bool edge = keys_edge || i0 + BQ > Sq || (causal && i0 + off < k0 + ROWS - 1) ||
                          (window && k0 <= i0 + BQ - 1 + off - window);
#pragma unroll
        for (int jn = 0; jn < BQ / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * jn + e;
            float p = exp2f(pt[x] * scale_log2 - l2[2 * jn + (e & 1)]);
            if (edge) {
              const int qp = i0 + 8 * jn + cq + (e & 1) + off;
              const int key = k0 + r + 8 * (e >> 1);
              if (!(qp - off < Sq && key < Skv && (!causal || key <= qp) &&
                    (!window || key > qp - window)))
                p = 0.f;
            }
            pt[x] = p;
          }
        store_split<BQ>(sPh, sPl, pt, r, cq);
        hopper::fence_proxy_async();
        hopper::named_barrier(2, 256);   // P^T is in shared memory for both warpgroups

        // dV^T += dO^T P
        mma_t<MTV, BQ, HDV, T::GT_DKDV>(dvt, th, tl, sdO, sdOl, hopper::smem_u32(sPh), hopper::smem_u32(sPl),
                            r, t4);
        hopper::wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty + s);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MTV; ++mt) hopper::fence_regs(dvt[mt]);
    float* dvb = dv + b * st.dv[0] + kh * st.dv[1];
#pragma unroll
    for (int mt = 0; mt < MTV; ++mt)
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 64 * mt + r + 8 * (e >> 1), key = k0 + 8 * jn + cq + (e & 1);
          if (d < hd_v && key < Skv) dvb[(long long)key * st.dv[2] + d] = dvt[mt][4 * jn + e];
        }
  } else {
    constexpr int MT = T::MT;
    float dkt[MT][32];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int x = 0; x < 32; ++x) dkt[mt][x] = 0.f;
    int it = 0;
    for (int g = 0; g < G; ++g) {
      const float* D_h = D + ((long long)b * H + kh * G + g) * Sq;
      for (int ti = i_begin; ti < i_end; ++ti, ++it) {
        const int s = it % S, i0 = ti * BQ;
        uint8_t* sQ = sStage + s * T::DKDV_STAGE;
        uint8_t* sdO = sQ + Q_BYTES;
        float dd[BQ / 4];
#pragma unroll
        for (int jn = 0; jn < BQ / 8; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = i0 + 8 * jn + cq + e;
            dd[2 * jn + e] = qc < Sq ? D_h[qc] : 0.f;
          }
        hopper::mbar_wait(full + s, (it / S) & 1);
        hopper::named_barrier(4, 256);
        split_tile<DO_BYTES / 2048>(sdO, sdOl, t128);
        hopper::fence_proxy_async();
        hopper::named_barrier(1, 256);

        // dP^T = V dO^T
        float dpt[BQ / 2];
#pragma unroll
        for (int x = 0; x < BQ / 2; ++x) dpt[x] = 0.f;
        mma_raw<BQ, HDV / 8, GK, 0>(dpt, ah, al, sV, hopper::smem_u32(sdO),
                                    hopper::smem_u32(sdOl), r, t4);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dpt);
        // dS^T = P^T (dP^T - D), P^T = hi + lo from warpgroup 0 at this
        // thread's own slots
        hopper::named_barrier(2, 256);
#pragma unroll
        for (int jn = 0; jn < BQ / 8; ++jn)
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            const uint32_t o = Narrow<BQ>::at(r + 8 * i2, 8 * jn + cq);
            const float2 ph = *reinterpret_cast<const float2*>(sPh + o);
            const float2 pl = *reinterpret_cast<const float2*>(sPl + o);
            const int x = 4 * jn + 2 * i2;
            dpt[x] = (ph.x + pl.x) * (dpt[x] - dd[2 * jn]);
            dpt[x + 1] = (ph.y + pl.y) * (dpt[x + 1] - dd[2 * jn + 1]);
          }
        store_split<BQ>(sSh, sSl, dpt, r, cq);
        hopper::fence_proxy_async();
        hopper::named_barrier(3, 128);   // this warpgroup's dS^T is in

        // dK^T += Q^T dS
        mma_t<MT, BQ, HD, T::GT_DKDV>(dkt, th, tl, sQ, sQl, hopper::smem_u32(sSh), hopper::smem_u32(sSl), r,
                          t4);
        hopper::wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty + s);
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) hopper::fence_regs(dkt[mt]);
    float* dkb = dk + b * st.dk[0] + kh * st.dk[1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 64 * mt + r + 8 * (e >> 1), key = k0 + 8 * jn + cq + (e & 1);
          if (d < hd && key < Skv)
            dkb[(long long)key * st.dk[2] + d] = scale * dkt[mt][4 * jn + e];
        }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout, *lse;
  void *D, *dq, *dk, *dv;
  Strides st;
  int B, H, K, Sq, Skv, causal, window;
  float scale;
  cudaStream_t stream;
};

// a float32 map over (width, position, heads, batch) of a tensor with
// element strides st = (batch, head, position), boxes of 32 columns x
// `rows`, 128-byte swizzle; the wrapper has checked TMA's alignment
int make_map(CUtensorMap* map, const void* ptr, int width, int S, int heads, int B,
             const long long* st, int rows) {
  const long long dims[4] = {width, S, heads, B};
  const long long strides[3] = {st[2], st[1], st[0]};
  const int box[4] = {32, rows, 1, 1};
  return hopper::make_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, dims, strides, box,
                             128);
}

// HD and HDV are the tile's widths, hd <= HD and hd_v <= HDV the tensors'
// (the maps' width axis)
template <int HD, int HDV>
int launch(const Args& a, int hd, int hd_v, int dkdv) {
  using T = TileT<HD, HDV>;
  const Strides& st = a.st;
  const int rq = dkdv ? T::BQ : ROWS, rk = dkdv ? ROWS : T::BK;
  CUtensorMap mq, mk, mv, mdo;
  int err = make_map(&mq, a.q, hd, a.Sq, a.H, a.B, st.q, rq);
  if (!err) err = make_map(&mk, a.k, hd, a.Skv, a.K, a.B, st.k, rk);
  if (!err) err = make_map(&mv, a.v, hd_v, a.Skv, a.K, a.B, st.v, rk);
  if (!err) err = make_map(&mdo, a.dout, hd_v, a.Sq, a.H, a.B, st.dout, rq);
  if (err) return err;
  const float* lse = static_cast<const float*>(a.lse);
  if (!dkdv) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_tf32_kernel<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM_DQ);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((a.Sq + ROWS - 1) / ROWS, a.H, a.B);
    flash_bwd_dq_tf32_kernel<HD, HDV><<<grid, DQ_THREADS, T::SMEM_DQ, a.stream>>>(
        mq, mk, mv, mdo, static_cast<const float*>(a.o), static_cast<const float*>(a.dout), lse,
        static_cast<float*>(a.D), static_cast<float*>(a.dq), st, a.H / a.K, a.Sq, a.Skv, hd, hd_v,
        a.causal, a.window, a.scale);
    return (int)cudaGetLastError();
  }
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_tf32_kernel<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM_DKDV);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Skv + ROWS - 1) / ROWS, a.K, a.B);
  flash_bwd_dkdv_tf32_kernel<HD, HDV><<<grid, DKDV_THREADS, T::SMEM_DKDV, a.stream>>>(
      mq, mk, mv, mdo, lse, static_cast<const float*>(a.D), static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), st, a.H, a.Sq, a.Skv, hd, hd_v, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

// the instance of a (q/k, v) width pair (hd 80 on the hd-96 tiles), or
// cudaErrorInvalidValue
int dispatch(const Args& a, int hd, int hd_v, int dkdv) {
  if (hd == 192 && hd_v == 128) return launch<192, 128>(a, hd, hd_v, dkdv);
  if (hd == 192 && hd_v == 192) return launch<192, 192>(a, hd, hd_v, dkdv);
  if (hd != hd_v) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64: return launch<64, 64>(a, hd, hd_v, dkdv);
    case 80:
    case 96: return launch<96, 96>(a, hd, hd_v, dkdv);
    case 128: return launch<128, 128>(a, hd, hd_v, dkdv);
    case 256: return launch<256, 256>(a, hd, hd_v, dkdv);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(const void* q, const void* k, const void* v, const void* o, const void* dout,
        const void* lse, void* D, void* dq, void* dk, void* dv, const long long* strides, int B,
        int H, int K, int Sq, int Skv, int hd, int hd_v, int causal, int window, float scale,
        int dkdv, void* stream) {
  if (B == 0 || H == 0 || Sq == 0 || Skv == 0) return 0;
  Args a{q, k, v, o, dout, lse, D, dq, dk, dv, {}, B, H, K, Sq, Skv, causal, window, scale,
         static_cast<cudaStream_t>(stream)};
  long long* st = &a.st.q[0];
  for (int i = 0; i < 24; ++i) st[i] = strides[i];
  return dispatch(a, hd, hd_v, dkdv);
}

}  // namespace

// float32 tensors; strides: 24 element strides, (batch, head, position) of
// q, k, v, o, dO, dq, dk, dv in turn (the last dim of each contiguous); lse
// and D contiguous (B, H, Sq) float32.  flash_attention_bwd_tf32_dq writes
// D and dq and must run before flash_attention_bwd_tf32_dkdv, which reads D
// and writes dk and dv.  q, k, v and dO are read through TMA maps (the
// wrapper has checked their alignment).  Returns cudaGetLastError() after
// the launch, or hopper::TENSOR_MAP_ERROR + a CUresult if a map was refused.
extern "C" int flash_attention_bwd_tf32_dq(const void* q, const void* k, const void* v,
                                           const void* o, const void* dout, const void* lse,
                                           void* D, void* dq, void* dk, void* dv,
                                           const long long* strides, int B, int H, int K, int Sq,
                                           int Skv, int hd, int hd_v, int causal, int window,
                                           float scale, void* stream) {
  return run(q, k, v, o, dout, lse, D, dq, dk, dv, strides, B, H, K, Sq, Skv, hd, hd_v, causal,
             window, scale, 0, stream);
}

extern "C" int flash_attention_bwd_tf32_dkdv(const void* q, const void* k, const void* v,
                                             const void* o, const void* dout, const void* lse,
                                             void* D, void* dq, void* dk, void* dv,
                                             const long long* strides, int B, int H, int K,
                                             int Sq, int Skv, int hd, int hd_v, int causal,
                                             int window, float scale, void* stream) {
  return run(q, k, v, o, dout, lse, D, dq, dk, dv, strides, B, H, K, Sq, Skv, hd, hd_v, causal,
             window, scale, 1, stream);
}

// the dynamic shared memory of a block of the dq (dkdv = 0) or dk/dv
// kernel at a width pair (0 for a pair it does not take):
// bwd_launch_plan states the same numbers, and chip_smoke.py holds them
// together
extern "C" int flash_attention_bwd_tf32_smem(int hd, int hd_v, int dkdv) {
#define K7T_SMEM(HD, HDV) \
  return dkdv ? TileT<HD, HDV>::SMEM_DKDV : TileT<HD, HDV>::SMEM_DQ
  if (hd == 192 && hd_v == 128) K7T_SMEM(192, 128);
  if (hd == 192 && hd_v == 192) K7T_SMEM(192, 192);
  if (hd != hd_v) return 0;
  switch (hd) {
    case 64: K7T_SMEM(64, 64);
    case 80:
    case 96: K7T_SMEM(96, 96);
    case 128: K7T_SMEM(128, 128);
    case 256: K7T_SMEM(256, 256);
    default: return 0;
  }
#undef K7T_SMEM
}
