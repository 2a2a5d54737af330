// K7's VJP: the backward of flash attention (flash_attention.cu) for
// Hopper (sm_90a).
//
// For batch b, head h (kv head h / G), query i and key j, with the masks
// of the forward (queries aligned to the END of the kv axis, qpos = i +
// Skv - Sq; causal, window, or none) and lse the forward's row
// log-sum-exp:
//       P_ij  = exp(scale * <q_i, k_j> - lse_i)       (0 where masked)
//       D_i   = <dO_i, o_i>
//       dS_ij = P_ij * (<dO_i, v_j> - D_i)
//       dV_j  = sum_{h in group} sum_i P_ij dO_i
//       dK_j  = scale * sum_{h in group} sum_i dS_ij q_i
//       dQ_i  = scale * sum_j dS_ij k_j
// (FlashAttention-2's backward).  Replaces no TPU kernel: the reference
// trains through XLA's autodiff of L.attention
// (src/repro/models/transformer/layers.py:152) and never differentiates
// its Pallas kernel; the port's forward on the card is K7, so its
// gradient is a kernel too.
//
// Two kernels a route, launched in this order on one stream: dq (which
// first writes D for its rows to a (B, H, Sq) float32 scratch) and then
// dk/dv (which reads D).  No float atomics: every output element is
// summed by one thread (or one wgmma accumulator slot) in one order, so
// both routes are bitwise repeatable.  GQA's sum over the group runs
// inside a dk/dv block, in a fixed order.
//
// Bound.  The minimum work is 2.5x the forward's: the products S, dP, dV,
// dK and dQ, 2 * pairs * (3 hd + 2 hd_v) flops over the pairs the masks
// keep, against q, k, v, o, dO, lse read once and dq, dk, dv written once.
// At Qwen2.5-14B's training shape (4 x 1024, 40 / 8 x 128, causal) that is
// about 107 GFLOP (0.109 ms at the bf16 tensor-core peak) against 88 MB.
//
// bf16: flash_bwd_dq_wgmma_kernel and flash_bwd_dkdv_wgmma_kernel, on the
// tensor cores.  Both are built as the forward's bf16 kernel is: 384
// threads, a producer warpgroup whose one thread issues every TMA load
// (mbarriers full/empty per stage) and two consumer warpgroups of 64 rows
// (setmaxnreg moves registers from the producer, 24, to the consumers,
// 240), tiles of 64 rows in 128-byte swizzle (64-byte at the hd-96 tiles,
// whose 192-byte rows are three 64-byte chunks).  Every product is one
// wgmma shape of forward.cu's: S-like products take both operands from
// shared memory K-major (m64n64k16), and the accumulating products take
// their A operand from registers (P or dS, packed to bf16 in the
// accumulator's own layout, which is the A fragment's) and their B
// operand MN-major (wgmma_rs_n{64,96,128,192,256}).
//   dq: one block per (head, batch, 128 query rows, the last tile first);
//     each consumer warpgroup owns 64 rows: it sums D = <dO, o> for them
//     (a quad of threads a row, columns 8 j + 2 t, then the quad, in a
//     fixed order), keeps Q and dO resident (TMA), and walks the 64-key
//     tiles of K and V that its block's rows see (a ring of 2 stages, 1 at
//     hd 256) with S = Q K^T and dP = dO V^T (both issued before either is
//     waited on), P = exp2(S scale log2e - lse log2e) and dS = P (dP - D)
//     in the accumulator registers, and dQ += dS K (K MN-major).
//   dk/dv: one block per (64 keys, kv head, batch), K and V resident; it
//     walks the G query heads of its group and, for each, the 64-row
//     query tiles that see one of its keys (a ring of 2 stages of Q and
//     dO).  The two consumer warpgroups split the work by output: the
//     first computes S^T = K Q^T, P^T in registers, hands P^T in float32
//     to the second through shared memory (two buffers, one named barrier
//     a tile), and accumulates dV += P^T dO; the second computes dP^T = V
//     dO^T, dS^T = P^T (dP^T - D) and accumulates dK += dS^T Q.  So each
//     warpgroup holds one accumulator (dV or dK: 64 x width in float32, 128
//     registers a thread at width 256) beside one 64 x 64 product.
//   P and dS are rounded to bf16 for the accumulating products, as the
//   forward rounds P for P V, FlashAttention's backward does, and the
//   TPU kernel's default-precision dots would: chip_smoke.py's bound adds
//   2^-8 * sum |dS||k| (dq), 2^-8 * sum |dS||q| (dk) and 2^-8 * sum P |dO|
//   (dv) for it.  S, dP, D and the exponentials stay in float32.
//   Masks: only tiles that cross the diagonal, the window edge, Skv or Sq
//   test their pairs; rows past Sq and keys past Skv arrive as zeros from
//   TMA, read as P = 0, and the TMA stores clip them.  hd 80 runs on the
//   hd-96 tiles with maps 80 wide (TMA fills columns 80-95 with zeros; the
//   stores write 80 columns), as the forward does.
//
// float32: flash_attention_bwd_tf32.cu, on the TF32 tensor cores (its own
// library, flash_bwd_dq_tf32_kernel and flash_bwd_dkdv_tf32_kernel).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// element strides (batch, head, position) of each tensor; the last dim is
// contiguous
struct Strides {
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
};

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 384;   // a producer warpgroup and two consumer warpgroups
constexpr int TC_ROWS = 64;       // rows of a consumer warpgroup, and of every tile
constexpr int SMEM_MAX = 232448;  // the dynamic shared memory a block may use

// HD: the q/k tile width; HDV: the v tile width (HD but for MLA's (192,
// 128)).  A 64-row tile at a width is W / CW chunks of CH bytes, each
// 1024-byte aligned, as TMA writes them.
template <int HD, int HDV>
struct TcTile {
  static constexpr int SW = HD % 64 == 0 ? 128 : 64;   // swizzle = bytes of a chunk row
  static constexpr int CW = SW / 2;                    // bf16 columns per chunk
  static constexpr int NC = HD / CW;                   // chunks of a Q or K row
  static constexpr int NCV = HDV / CW;                 // chunks of a V or dO row
  static_assert(HDV % CW == 0 && HDV <= HD, "V rows of whole chunks");
  static constexpr int CH = TC_ROWS * SW;              // one chunk of a 64-row tile
  static constexpr int K_BYTES = NC * CH;              // a 64-row tile at the q/k width
  static constexpr int V_BYTES = NCV * CH;             // at the v width
  // dq: slack to align the base to 1024, Q and dO of 128 rows, a ring of
  // K and V tiles, the 1 + 3 * stages barriers; 2 stages where they fit
  static constexpr int DQ_FIXED = 1024 + 2 * (K_BYTES + V_BYTES);
  static constexpr int DQ_STAGES =
      DQ_FIXED + 2 * (K_BYTES + V_BYTES) + 8 * 7 <= SMEM_MAX ? 2 : 1;
  static constexpr int SMEM_DQ =
      DQ_FIXED + DQ_STAGES * (K_BYTES + V_BYTES) + 8 * (1 + 3 * DQ_STAGES);
  // dk/dv: slack, K and V of 64 keys, a ring of 2 stages of Q and dO, two
  // 64 x 64 float32 buffers of P^T, the 1 + 2 * stages barriers
  static constexpr int DKDV_STAGES = 2;
  static constexpr int PT_FLOATS = TC_ROWS * TC_ROWS;
  static constexpr int SMEM_DKDV = 1024 + (1 + DKDV_STAGES) * (K_BYTES + V_BYTES) +
                                   2 * 4 * PT_FLOATS + 8 * (1 + 2 * DKDV_STAGES);
  static_assert(SMEM_DQ <= SMEM_MAX && SMEM_DKDV <= SMEM_MAX, "a block's shared memory");
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a 64 x 64 accumulator (rows r, r + 8 of the thread's warp; columns 8 j
// + cq, + 1) as the bf16 A fragments of its 4 k-steps of 16 columns
__device__ __forceinline__ void to_frags(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// acc (64 x W, float32) += A (64 x 16, the bf16 fragment) * B (16 x W,
// MN-major in shared memory), W the accumulator's width
template <int W>
__device__ __forceinline__ void mma_rs(float (&acc)[W / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (W == 64)
    hopper::wgmma_rs_n64(acc, a, db);
  else if constexpr (W == 96)
    hopper::wgmma_rs_n96(acc, a, db);
  else if constexpr (W == 128)
    hopper::wgmma_rs_n128(acc, a, db);
  else if constexpr (W == 192)
    hopper::wgmma_rs_n192(acc, a, db);
  else
    hopper::wgmma_rs_n256(acc, a, db);
}

// D (64 x 64) = A B^T over W columns: A and B 64-row tiles of NCH-byte
// chunks in shared memory, both K-major (W / 16 k-steps)
template <int W, int SW>
__device__ __forceinline__ void mma_ss_64(float (&d)[32], uint32_t a_addr, int a_chunk,
                                          uint32_t b_addr, int b_chunk) {
  constexpr int CW = SW / 2;
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    const int c = kk / (CW / 16), j = kk % (CW / 16);
    hopper::wgmma_ss_n64(d, hopper::make_desc(a_addr + c * a_chunk + j * 32, 16, 8 * SW, SW),
                         hopper::make_desc(b_addr + c * b_chunk + j * 32, 16, 8 * SW, SW),
                         kk > 0);
  }
}

// acc += A B over the 64 rows of B: A the fragments of a 64 x 64 tile, B
// a 64-row tile of CH-byte chunks read MN-major
template <int W, int SW>
__device__ __forceinline__ void mma_rs_tile(float (&acc)[W / 2], const uint32_t (&a)[4][4],
                                            uint32_t b_addr, int b_chunk) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    mma_rs<W>(acc, a[kk], hopper::make_desc(b_addr + kk * 16 * SW, b_chunk, 8 * SW, SW));
}

// an accumulator of W columns times `mul`, in bf16, into a tile of
// `chunk`-byte chunks at `dst` (1024-byte aligned), swizzled as the maps
// expect: rows r, r + 8 of the thread's warp
template <int W, int SW>
__device__ __forceinline__ void store_tile(uint8_t* dst, int chunk, const float (&acc)[W / 2],
                                           float mul, int r, int cq) {
  constexpr int CW = SW / 2;
#pragma unroll
  for (int jn = 0; jn < W / 8; ++jn) {
    const int col = 8 * jn + cq;
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2)
      *reinterpret_cast<uint32_t*>(
          dst + hopper::swz<SW>((col / CW) * chunk + (r + 8 * i2) * SW + (col % CW) * 2)) =
          pack_bf16(mul * acc[4 * jn + 2 * i2], mul * acc[4 * jn + 2 * i2 + 1]);
  }
}

// tensor maps over (width, position, head, batch), boxes of CW x 64 rows:
// q, k, v, dO read; dq, or dk and dv, written
template <int HD, int HDV>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tdq,
                          const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          float* __restrict__ D, const Strides st, int G, int Sq, int Skv,
                          int hd_v, int causal, int window, float scale) {
  using T = TcTile<HD, HDV>;
  constexpr int SW = T::SW, CW = T::CW, NC = T::NC, NCV = T::NCV, CH = T::CH, S = T::DQ_STAGES;
  constexpr int QCH = 2 * CH;   // a chunk of the block's 128 rows
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = align1024(smem_raw);
  uint8_t* sdO = sQ + 2 * T::K_BYTES;
  uint8_t* sK = sdO + 2 * T::V_BYTES;   // S K tiles
  uint8_t* sV = sK + S * T::K_BYTES;    // S V tiles
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sV + S * T::V_BYTES);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + S;
  uint64_t* empty = full_v + S;

  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * 2 * TC_ROWS;   // last query tile first
  const int kh = h / G, off = Skv - Sq;
  // the key tiles any row of this block sees
  const int qlast = min(q0 + 2 * TC_ROWS, Sq) - 1 + off;
  const int kv_end = causal ? min(Skv, qlast + 1) : Skv;
  const int kv_begin = window ? max(0, q0 + off - window + 1) : 0;
  const int t_begin = kv_begin / TC_ROWS;
  const int t_end = (kv_end + TC_ROWS - 1) / TC_ROWS;

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full_k + s, 1);
      hopper::mbar_init(full_v + s, 1);
      hopper::mbar_init(empty + s, 8);   // one arrival per consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // producer: one thread issues every copy
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(full_q, 2 * (T::K_BYTES + T::V_BYTES));
      for (int w = 0; w < 2; ++w) {
        for (int c = 0; c < NC; ++c)
          hopper::tma_load_4d(sQ + c * QCH + w * CH, &tq, full_q, c * CW, q0 + w * TC_ROWS, h, b);
        for (int c = 0; c < NCV; ++c)
          hopper::tma_load_4d(sdO + c * QCH + w * CH, &tdo, full_q, c * CW, q0 + w * TC_ROWS, h,
                              b);
      }
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % S;
        hopper::mbar_wait(empty + s, ((i / S) & 1) ^ 1);
        hopper::mbar_expect_tx(full_k + s, T::K_BYTES);
        for (int c = 0; c < NC; ++c)
          hopper::tma_load_4d(sK + s * T::K_BYTES + c * CH, &tk, full_k + s, c * CW,
                              t * TC_ROWS, kh, b);
        hopper::mbar_expect_tx(full_v + s, T::V_BYTES);
        for (int c = 0; c < NCV; ++c)
          hopper::tma_load_4d(sV + s * T::V_BYTES + c * CH, &tv, full_v + s, c * CW,
                              t * TC_ROWS, kh, b);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63; a thread
  // holds rows r and r + 8 of its warp's 16, columns 8 j + cq, + 1
  hopper::setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int t128 = threadIdx.x & 127, lane = t128 & 31;
  const int r = (t128 >> 5) * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const int rbase = q0 + cw * TC_ROWS;
  const int rows[2] = {rbase + r, rbase + r + 8};
  const long long bh = (long long)b * H + h;
  const float scale_log2 = scale * LOG2E;

  // D = <dO, o> of the thread's two rows: the quad's 4 threads sum
  // columns 8 j + cq, + 1 in order, then the quad adds its 4 parts in a
  // fixed tree; and lse in log2 units (rows past Sq: masked below).  The
  // loads go in batches of 8 column pairs a row, every load of a batch
  // before its sums
  float Dr[2] = {0.f, 0.f}, L2[2];
  const __nv_bfloat16* orow[2];
  const __nv_bfloat16* drow[2];
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    orow[i2] = o + b * st.o[0] + h * st.o[1] + rows[i2] * st.o[2];
    drow[i2] = dout + b * st.dout[0] + h * st.dout[1] + rows[i2] * st.dout[2];
    L2[i2] = rows[i2] < Sq ? lse[bh * Sq + rows[i2]] * LOG2E : 0.f;
  }
  constexpr int PAIRS = HDV / 8;   // column pairs a thread sums, at most
#pragma unroll
  for (int j0 = 0; j0 < PAIRS; j0 += 8) {
    __nv_bfloat162 a[2][8], d[2][8];
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 8 * (j0 + jj) + cq;
        const bool in = j0 + jj < PAIRS && c < hd_v && rows[i2] < Sq;
        a[i2][jj] = in ? *reinterpret_cast<const __nv_bfloat162*>(orow[i2] + c)
                       : __floats2bfloat162_rn(0.f, 0.f);
        d[i2][jj] = in ? *reinterpret_cast<const __nv_bfloat162*>(drow[i2] + c)
                       : __floats2bfloat162_rn(0.f, 0.f);
      }
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 x = __bfloat1622float2(a[i2][jj]), y = __bfloat1622float2(d[i2][jj]);
        Dr[i2] = fmaf(x.x, y.x, Dr[i2]);
        Dr[i2] = fmaf(x.y, y.y, Dr[i2]);
      }
  }
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    Dr[i2] += __shfl_xor_sync(0xffffffffu, Dr[i2], 1);
    Dr[i2] += __shfl_xor_sync(0xffffffffu, Dr[i2], 2);
    if ((lane & 3) == 0 && rows[i2] < Sq) D[bh * Sq + rows[i2]] = Dr[i2];
  }

  const uint32_t q_addr = hopper::smem_u32(sQ) + cw * CH;
  const uint32_t do_addr = hopper::smem_u32(sdO) + cw * CH;
  const int wfirst = rbase + off;
  const int wlast = min(rbase + TC_ROWS, Sq) - 1 + off;
  const bool rows_edge = rbase + TC_ROWS > Sq;
  float dq[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) dq[x] = 0.f;
  hopper::mbar_wait(full_q, 0);

  for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
    const int s = i % S;
    const uint32_t parity = (i / S) & 1;
    const int k0 = t * TC_ROWS;
    const uint32_t k_addr = hopper::smem_u32(sK + s * T::K_BYTES);
    const uint32_t v_addr = hopper::smem_u32(sV + s * T::V_BYTES);

    // S = Q K^T, then dP = dO V^T, both in flight before either is read
    float sc[32], dp[32];
    hopper::mbar_wait(full_k + s, parity);
    hopper::wgmma_fence();
    mma_ss_64<HD, SW>(sc, q_addr, QCH, k_addr, CH);
    hopper::wgmma_commit();
    hopper::mbar_wait(full_v + s, parity);
    hopper::wgmma_fence();
    mma_ss_64<HDV, SW>(dp, do_addr, QCH, v_addr, CH);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(sc);

    // P; the mask only on tiles that cross the diagonal, the window edge,
    // Skv or Sq for some row of this warpgroup
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] = exp2f(sc[x] * scale_log2 - L2[(x >> 1) & 1]);
    if (rows_edge || k0 + TC_ROWS > Skv || (causal && k0 + TC_ROWS - 1 > wfirst) ||
        (window && k0 <= wlast - window)) {
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * jn + cq + (e & 1);
          const int row = rows[e >> 1], qp = row + off;
          const bool ok = row < Sq && kpos < Skv && (!causal || kpos <= qp) &&
                          (!window || kpos > qp - window);
          if (!ok) sc[4 * jn + e] = 0.f;
        }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
    // dS = P (dP - D), packed to bf16 A fragments
#pragma unroll
    for (int x = 0; x < 32; ++x) sc[x] *= dp[x] - Dr[(x >> 1) & 1];
    uint32_t ds[4][4];
    to_frags(sc, ds);

    // dQ += dS K, K read MN-major
    hopper::fence_regs(ds);
    hopper::fence_regs(dq);
    hopper::wgmma_fence();
    mma_rs_tile<HD, SW>(dq, ds, k_addr, CH);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + s);   // this warp is done with the stage
  }

  // epilogue: scale dQ in bf16 into this warpgroup's (dead) Q rows, then
  // one TMA store per chunk
  uint8_t* sO = sQ + cw * CH;
  store_tile<HD, SW>(sO, QCH, dq, scale, r, cq);
  hopper::fence_proxy_async();
  hopper::named_barrier(1 + cw, 128);
  if (t128 == 0 && rbase < Sq) {
    for (int c = 0; c < NC; ++c) hopper::tma_store_4d(&tdq, sO + c * QCH, c * CW, rbase, h, b);
    hopper::tma_store_commit_and_wait_read();
  }
}

template <int HD, int HDV>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tdk,
                            const __grid_constant__ CUtensorMap tdv,
                            const float* __restrict__ lse, const float* __restrict__ D, int H,
                            int Sq, int Skv, int causal, int window, float scale) {
  using T = TcTile<HD, HDV>;
  constexpr int SW = T::SW, CW = T::CW, NC = T::NC, NCV = T::NCV, CH = T::CH;
  constexpr int S = T::DKDV_STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = align1024(smem_raw);
  uint8_t* sV = sK + T::K_BYTES;
  uint8_t* sQ = sV + T::V_BYTES;        // S Q tiles
  uint8_t* sdO = sQ + S * T::K_BYTES;   // S dO tiles
  float* sP = reinterpret_cast<float*>(sdO + S * T::V_BYTES);   // 2 x P^T, float32
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(sP + 2 * T::PT_FLOATS);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + S;

  const int k0 = blockIdx.x * TC_ROWS;   // the first key tiles see the most queries
  const int kh = blockIdx.y, b = blockIdx.z, G = H / gridDim.y, off = Skv - Sq;
  // the query tiles that see a key of this tile
  const int klast = min(k0 + TC_ROWS, Skv) - 1;
  const int q_begin = causal ? max(0, k0 - off) : 0;
  const int q_end = window ? min(Sq, klast + window - off) : Sq;
  const int i_begin = q_begin / TC_ROWS;
  const int i_end = q_end > q_begin ? (q_end + TC_ROWS - 1) / TC_ROWS : i_begin;

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
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(full_kv, T::K_BYTES + T::V_BYTES);
      for (int c = 0; c < NC; ++c)
        hopper::tma_load_4d(sK + c * CH, &tk, full_kv, c * CW, k0, kh, b);
      for (int c = 0; c < NCV; ++c)
        hopper::tma_load_4d(sV + c * CH, &tv, full_kv, c * CW, k0, kh, b);
      int it = 0;
      for (int g = 0; g < G; ++g)
        for (int ti = i_begin; ti < i_end; ++ti, ++it) {
          const int s = it % S;
          hopper::mbar_wait(empty + s, ((it / S) & 1) ^ 1);
          hopper::mbar_expect_tx(full + s, T::K_BYTES + T::V_BYTES);
          for (int c = 0; c < NC; ++c)
            hopper::tma_load_4d(sQ + s * T::K_BYTES + c * CH, &tq, full + s, c * CW,
                                ti * TC_ROWS, kh * G + g, b);
          for (int c = 0; c < NCV; ++c)
            hopper::tma_load_4d(sdO + s * T::V_BYTES + c * CH, &tdo, full + s, c * CW,
                                ti * TC_ROWS, kh * G + g, b);
        }
    }
    return;
  }

  // consumers: a thread holds keys k0 + r and k0 + r + 8 of its warp's 16,
  // query columns 8 j + cq, + 1 of the walked tile; warpgroup 0 owns dV,
  // warpgroup 1 dK
  hopper::setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int t128 = threadIdx.x & 127, lane = t128 & 31;
  const int r = (t128 >> 5) * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const uint32_t k_addr = hopper::smem_u32(sK), v_addr = hopper::smem_u32(sV);
  const float scale_log2 = scale * LOG2E;
  const bool keys_edge = k0 + TC_ROWS > Skv;
  hopper::mbar_wait(full_kv, 0);

  if (cw == 0) {
    float dv[HDV / 2];
#pragma unroll
    for (int x = 0; x < HDV / 2; ++x) dv[x] = 0.f;
    int it = 0;
    for (int g = 0; g < G; ++g) {
      const float* lse_h = lse + ((long long)b * H + kh * G + g) * Sq;
      for (int ti = i_begin; ti < i_end; ++ti, ++it) {
        const int s = it % S, i0 = ti * TC_ROWS;
        const uint32_t q_addr = hopper::smem_u32(sQ + s * T::K_BYTES);
        const uint32_t do_addr = hopper::smem_u32(sdO + s * T::V_BYTES);
        // lse (log2 units) of the thread's 16 query columns
        float l2[16];
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = i0 + 8 * jn + cq + e;
            l2[2 * jn + e] = qc < Sq ? lse_h[qc] * LOG2E : 0.f;
          }
        // S^T = K Q^T
        float pt[32];
        hopper::mbar_wait(full + s, (it / S) & 1);
        hopper::wgmma_fence();
        mma_ss_64<HD, SW>(pt, k_addr, CH, q_addr, CH);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(pt);
        // P^T; the mask only on tiles that cross the diagonal, the window
        // edge, Skv or Sq
        const bool edge = keys_edge || i0 + TC_ROWS > Sq ||
                          (causal && i0 + off < k0 + TC_ROWS - 1) ||
                          (window && k0 <= i0 + TC_ROWS - 1 + off - window);
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
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
        // hand P^T to warpgroup 1 (two buffers: the barrier of the next
        // tile orders this buffer's reads before its next write)
        float* pbuf = sP + (it & 1) * T::PT_FLOATS;
#pragma unroll
        for (int x = 0; x < 32; ++x) pbuf[x * 128 + t128] = pt[x];
        hopper::named_barrier(1, 256);
        // dV += P^T dO, dO read MN-major
        uint32_t pa[4][4];
        to_frags(pt, pa);
        hopper::fence_regs(pa);
        hopper::fence_regs(dv);
        hopper::wgmma_fence();
        mma_rs_tile<HDV, SW>(dv, pa, do_addr, CH);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dv);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty + s);
      }
    }
    // every product of both warpgroups is done with K and V: dV in bf16
    // into V's tile, then one TMA store per chunk
    hopper::named_barrier(2, 256);
    store_tile<HDV, SW>(sV, CH, dv, 1.f, r, cq);
    hopper::fence_proxy_async();
    hopper::named_barrier(3, 128);
    if (t128 == 0) {
      for (int c = 0; c < NCV; ++c) hopper::tma_store_4d(&tdv, sV + c * CH, c * CW, k0, kh, b);
      hopper::tma_store_commit_and_wait_read();
    }
  } else {
    float dk[HD / 2];
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) dk[x] = 0.f;
    int it = 0;
    for (int g = 0; g < G; ++g) {
      const float* D_h = D + ((long long)b * H + kh * G + g) * Sq;
      for (int ti = i_begin; ti < i_end; ++ti, ++it) {
        const int s = it % S, i0 = ti * TC_ROWS;
        const uint32_t q_addr = hopper::smem_u32(sQ + s * T::K_BYTES);
        const uint32_t do_addr = hopper::smem_u32(sdO + s * T::V_BYTES);
        float dd[16];
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = i0 + 8 * jn + cq + e;
            dd[2 * jn + e] = qc < Sq ? D_h[qc] : 0.f;
          }
        // dP^T = V dO^T
        float dpt[32];
        hopper::mbar_wait(full + s, (it / S) & 1);
        hopper::wgmma_fence();
        mma_ss_64<HDV, SW>(dpt, v_addr, CH, do_addr, CH);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dpt);
        // dS^T = P^T (dP^T - D), P^T from warpgroup 0
        hopper::named_barrier(1, 256);
        const float* pbuf = sP + (it & 1) * T::PT_FLOATS;
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = 4 * jn + e;
            dpt[x] = pbuf[x * 128 + t128] * (dpt[x] - dd[2 * jn + (e & 1)]);
          }
        // dK += dS^T Q, Q read MN-major
        uint32_t da[4][4];
        to_frags(dpt, da);
        hopper::fence_regs(da);
        hopper::fence_regs(dk);
        hopper::wgmma_fence();
        mma_rs_tile<HD, SW>(dk, da, q_addr, CH);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dk);
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(empty + s);
      }
    }
    hopper::named_barrier(2, 256);
    store_tile<HD, SW>(sK, CH, dk, scale, r, cq);
    hopper::fence_proxy_async();
    hopper::named_barrier(4, 128);
    if (t128 == 0) {
      for (int c = 0; c < NC; ++c) hopper::tma_store_4d(&tdk, sK + c * CH, c * CW, k0, kh, b);
      hopper::tma_store_commit_and_wait_read();
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

// a bf16 map over (width, position, heads, batch) of a tensor with element
// strides st = (batch, head, position), boxes of CW x 64 rows; the wrapper
// has checked TMA's alignment
int make_map(CUtensorMap* map, const void* ptr, int width, int S, int heads, int B,
             const long long* st, int cw, int sw) {
  const long long dims[4] = {width, S, heads, B};
  const long long strides[3] = {st[2], st[1], st[0]};
  const int box[4] = {cw, TC_ROWS, 1, 1};
  return hopper::make_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, dims, strides, box,
                             sw);
}

// HD and HDV are the tile's widths, hd <= HD and hd_v <= HDV the tensors'
// (the maps' width axis): TMA fills a box's columns past hd with zeros and
// the stores clip them
template <int HD, int HDV>
int launch_wgmma(const Args& a, int hd, int hd_v, int dkdv) {
  using T = TcTile<HD, HDV>;
  const Strides& st = a.st;
  CUtensorMap mq, mk, mv, mdo, m1, m2;
  int err = make_map(&mq, a.q, hd, a.Sq, a.H, a.B, st.q, T::CW, T::SW);
  if (!err) err = make_map(&mk, a.k, hd, a.Skv, a.K, a.B, st.k, T::CW, T::SW);
  if (!err) err = make_map(&mv, a.v, hd_v, a.Skv, a.K, a.B, st.v, T::CW, T::SW);
  if (!err) err = make_map(&mdo, a.dout, hd_v, a.Sq, a.H, a.B, st.dout, T::CW, T::SW);
  if (!dkdv) {
    if (!err) err = make_map(&m1, a.dq, hd, a.Sq, a.H, a.B, st.dq, T::CW, T::SW);
    if (err) return err;
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_wgmma_kernel<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM_DQ);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(a.H, a.B, (a.Sq + 2 * TC_ROWS - 1) / (2 * TC_ROWS));
    flash_bwd_dq_wgmma_kernel<HD, HDV><<<grid, TC_THREADS, T::SMEM_DQ, a.stream>>>(
        mq, mk, mv, mdo, m1, static_cast<const __nv_bfloat16*>(a.o),
        static_cast<const __nv_bfloat16*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<float*>(a.D), st, a.H / a.K, a.Sq, a.Skv, hd_v, a.causal, a.window,
        a.scale);
    return (int)cudaGetLastError();
  }
  if (!err) err = make_map(&m1, a.dk, hd, a.Skv, a.K, a.B, st.dk, T::CW, T::SW);
  if (!err) err = make_map(&m2, a.dv, hd_v, a.Skv, a.K, a.B, st.dv, T::CW, T::SW);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma_kernel<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM_DKDV);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Skv + TC_ROWS - 1) / TC_ROWS, a.K, a.B);
  flash_bwd_dkdv_wgmma_kernel<HD, HDV><<<grid, TC_THREADS, T::SMEM_DKDV, a.stream>>>(
      mq, mk, mv, mdo, m1, m2, static_cast<const float*>(a.lse),
      static_cast<const float*>(a.D), a.H, a.Sq, a.Skv, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

// the instance of a (q/k, v) width pair (hd 80 on the hd-96 tiles), or
// cudaErrorInvalidValue
int dispatch(const Args& a, int hd, int hd_v, int dkdv) {
  if (hd == 192 && hd_v == 128) return launch_wgmma<192, 128>(a, hd, hd_v, dkdv);
  if (hd == 192 && hd_v == 192) return launch_wgmma<192, 192>(a, hd, hd_v, dkdv);
  if (hd != hd_v) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64: return launch_wgmma<64, 64>(a, hd, hd_v, dkdv);
    case 80:
    case 96: return launch_wgmma<96, 96>(a, hd, hd_v, dkdv);
    case 128: return launch_wgmma<128, 128>(a, hd, hd_v, dkdv);
    case 256: return launch_wgmma<256, 256>(a, hd, hd_v, dkdv);
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

// bf16 tensors; strides: 24 element strides, (batch, head, position) of q,
// k, v, o, dO, dq, dk, dv in turn (the last dim of each contiguous); lse
// and D are contiguous (B, H, Sq) float32.  flash_attention_bwd_dq writes D
// and dq and must run before flash_attention_bwd_dkdv, which reads D and
// writes dk and dv.  Every tensor but o goes through a TMA map (the wrapper
// has checked their alignment).  Returns cudaGetLastError() after the
// launch, or hopper::TENSOR_MAP_ERROR + a CUresult if a TMA map was
// refused.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* D, void* dq,
                                      void* dk, void* dv, const long long* strides, int B, int H,
                                      int K, int Sq, int Skv, int hd, int hd_v, int causal,
                                      int window, float scale, void* stream) {
  return run(q, k, v, o, dout, lse, D, dq, dk, dv, strides, B, H, K, Sq, Skv, hd, hd_v, causal,
             window, scale, 0, stream);
}

extern "C" int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse, void* D,
                                        void* dq, void* dk, void* dv, const long long* strides,
                                        int B, int H, int K, int Sq, int Skv, int hd, int hd_v,
                                        int causal, int window, float scale, void* stream) {
  return run(q, k, v, o, dout, lse, D, dq, dk, dv, strides, B, H, K, Sq, Skv, hd, hd_v, causal,
             window, scale, 1, stream);
}

// the dynamic shared memory of a block of the dq (dkdv = 0) or dkdv kernel
// at a width pair (0 for a pair it does not take): bwd_launch_plan states
// the same numbers, and chip_smoke.py holds them together
extern "C" int flash_attention_bwd_smem(int hd, int hd_v, int dkdv) {
#define K7B_SMEM(TW, TWV) return dkdv ? TcTile<TW, TWV>::SMEM_DKDV : TcTile<TW, TWV>::SMEM_DQ
  if (hd == 192 && hd_v == 128) K7B_SMEM(192, 128);
  if (hd == 192 && hd_v == 192) K7B_SMEM(192, 192);
  if (hd != hd_v) return 0;
  switch (hd) {
    case 64: K7B_SMEM(64, 64);
    case 80:
    case 96: K7B_SMEM(96, 96);
    case 128: K7B_SMEM(128, 128);
    case 256: K7B_SMEM(256, 256);
    default: return 0;
  }
#undef K7B_SMEM
}
