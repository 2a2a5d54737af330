// Flash attention (causal / sliding-window, GQA) for Hopper (sm_90a).
//
// K7  flash_attention_fwd   for batch b, head h (kv head h / G), query i:
//       qpos  = i + Skv - Sq            (queries aligned to the END of kv)
//       valid = (!causal || kpos <= qpos) && (!window || kpos > qpos - window)
//       s_j   = scale * <q[b,h,i], k[b,h/G,j]>          over valid j
//       out[b,h,i] = (sum_j exp(s_j - m) v[b,h/G,j]) / max(sum_j exp(s_j - m), 1e-30)
//     in float32, written in q's dtype.  Replaces
//     src/repro/kernels/flash_attention.py:71 (flash_attention_pallas,
//     whose pallas_call is at :90; kernel body _kernel :26).  Forward
//     only.  A row with no valid key writes 0 (the wrapper refuses the
//     only shapes that have one: causal with Sq > Skv, and Skv 0).
//
// Every tensor is read through its strides (batch, head, position; the
// last dim contiguous) by 4-d TMA maps over (hd, position, head, batch),
// so the model passes its (B, S, H, hd) tensors as (B, H, S, hd) views
// without a transpose copy, and the output is written the same way.
// v and the output may be narrower than q and k (hd_v < hd: MLA, below).
// TMA needs a 16-byte-aligned base and byte strides in multiples of 16
// (the wrapper's launch_plan checks both and names the tensor).  Ragged
// Q and K tiles arrive as zeros and are masked; the store clips rows
// past Sq.
//
// Bound.  2*Sq*Skv*hd*2 flops per (b, h) (QK^T and PV), fewer under the
// causal or window mask; q, k, v read and o written once.  At
// Phi-3-mini's prefill (B 8, 32 x 96, S 1024, causal) that is about 51.5
// GFLOP against 201 MB in bf16 (the bf16 tensor-core peak, 989 TFLOP/s,
// 0.05 ms, and the memory rate, 3.35 TB/s, 0.06 ms, are close) and 403 MB
// in float32 (0.12 ms of memory time against 0.10 ms of TF32 tensor-core
// time at 495 TFLOP/s: bound by bytes).
//
// Two routes, chosen by dtype (the wrapper says which it takes); both
// run the online softmax in registers in float32 (scores in log2 units,
// exp2; a row's max and sum reduced over the 4 threads of its quad in a
// fixed order), mask only the tiles that cross the diagonal, the window
// edge or Skv, skip the tiles no row sees, and run the query tiles last
// first (the longest causal rows lead).  The bf16 grid is (H, B, query
// tiles), the G query heads of one kv head side by side sharing its tiles
// in L2; the float32 grid is (query tiles, H, B), so that the blocks in
// flight are the query tiles of a few heads and read the same K and V
// tiles.
//
// bf16: flash_fwd_wgmma_kernel.  One block of 384 threads per 128 query
// rows: a producer warpgroup whose one thread only issues TMA (Q once; K
// and V tiles of BK keys into a ring of STAGES stages, full/empty
// mbarriers per stage, K and V on separate full barriers), and two
// consumer warpgroups of 64 query rows each; setmaxnreg moves registers
// from the producer (24) to the consumers (240).  A consumer issues S =
// Q K^T as wgmma m64nBKk16 (both operands from swizzled shared memory),
// turns P into bf16 A fragments in registers (the accumulator layout is
// the bf16 A layout) and issues O += P V as wgmma m64n{hd}k16 with V as a
// transposed (MN-major) B operand.  The epilogue divides by max(l,
// 1e-30), writes bf16 O into the warpgroup's dead Q rows and TMA-stores
// it.  BK is 128 keys for hd <= 192 and 64 at hd 256 (the O accumulator
// alone is 128 registers a thread); swizzle 128 B, 64 B at hd 96
// (192-byte rows: three 32-column chunks).  P is rounded to bf16 for the
// PV product, as the TPU kernel's default-precision jnp.dot(p, v) and
// FlashAttention do: it adds at most 2^-8 * (sum_j p_j |v_j|) / l to an
// output.
//
// float32: flash_fwd_tf32_kernel, also on the tensor cores.  TF32 keeps
// 10 of float32's 23 mantissa bits, so one TF32 product per operand
// pair misses phase 8's float32 bound (1e-4 of the largest output): in a
// CPU emulation at hd 96, S 1024, 8 heads, causal, random normal inputs,
// a single pass errs by 5.0e-4 of it.  Each operand x is split into hi =
// cvt.rna.tf32(x), stored explicitly, and lo = cvt.rna.tf32(x - hi), the
// remainder of that very hi, and each product takes three TF32 passes:
//       S  = Qh Kh^T + Qh Kl^T + Ql Kh^T,   O += Ph Vh + Ph Vl + Pl Vh
// (the dropped lo*lo term is 2^-22 relative; 3.6e-7 in the emulation).
// One block of 160 threads per 64 query rows: a consumer warpgroup and a
// producer warp whose one thread issues TMA (Q once; raw float32 K and V
// tiles of BK keys into one stage with full/empty mbarriers).  The
// consumers split Q once (hi over the raw tile, lo beside) and each
// landed tile: K hi over raw K and K lo beside, V into V^T hi and lo.
// Bound: 51.5 GFLOP at Phi-3's prefill is 0.10 ms at the TF32 peak and
// its 403 MB 0.12 ms of memory time, so bytes bound the function; the
// three passes of each product make 0.31 ms of TF32 tensor time.  What
// holds a single warpgroup back is latency (the splits, the softmax and
// the waits on its own wgmmas, with no other warps to hide them): 32-key
// tiles, and K hi in place, keep a block at 109 KB at hd 96, so two
// blocks share an SM and each hides the other's latency (faster than one
// block on 64-key tiles, on an H100).  The stage is freed
// once every warp's Q K^T has read K hi, and the next tile loads during
// the softmax and P V.
// What the design does about the three constraints of TF32 wgmma:
//   - shared-memory operands are K-major only: Q and K arrive K-major
//     (hd contiguous) and their hi/lo parts keep TMA's swizzled layout
//     byte for byte; V does not, so the split pass writes V^T (keys
//     contiguous, the canonical K-major layout) -- the transpose costs no
//     extra pass;
//   - the tf32 A fragment of k8 is not the float32 accumulator's layout
//     (a thread holds key columns {t, t+4} of a k-step in the fragment
//     and {2t, 2t+1} in the accumulator): instead of shuffling P within
//     the quad, the split pass writes V^T's keys in the matching order
//     (k-slot c of each 8 holds key 2c for c < 4 and 2(c-4)+1 after),
//     so P's accumulator registers are the fragment as they stand; the
//     sum over keys runs in one fixed order, bitwise repeatable;
//   - shared memory: a float32 tile is twice a bf16 one and the split
//     doubles it again: Q hi/lo + K (then K hi) + K lo + raw V + V^T
//     hi/lo take 73, 109, 145 and 209 KB of the 227 KB at hd 64, 96, 128
//     and 256, and 193 KB at MLA's (192, 128) (tiles of 32 keys, 16 at
//     hd 256, whose V^T rows of 64 B take a 64-byte swizzle): two blocks
//     an SM at hd 64 and 96, one at 128, 256 and (192, 128).
// The epilogue writes float32 O / max(l, 1e-30) over Q hi and TMA-stores
// it.  No float atomics, and the passes accumulate in a fixed order.
//
// hd 80 (Zamba2-2.7B) runs on both routes' hd-96 instances, with the
// maps' head axis 80 wide (launch_*'s hd beside the tile's HD).  A
// 160-byte bf16 row is no whole number of 64- or 128-byte swizzle chunks
// (nor a 320-byte float32 row of 128-byte ones), but TMA fills a box's
// columns past the tensor's edge with zeros: the third 32-column chunk of
// Q, K and V reads columns 64-79 and 16 zeros.  Q K^T over 96 columns then
// adds exact zeros to the 80-column sums (its last k-step of 16 is all
// zeros), P V writes 16 zero columns, and the TMA store clips them.  The
// softmax scale is the caller's 1/sqrt(80).  Cost: a sixth of the tile's
// MMA work and shared-memory traffic is padding; no new instance is built.
//
// MLA (DeepSeek-V3's prefill): q and k 192 wide (128 columns decompressed
// from the latent + 64 rotary), v 128, 128 heads (H == K).  Both kernels
// take the q/k tile width HD and the v tile width HDV as template
// arguments (HDV == HD at every other width, where the code is what one
// width gave).  bf16: Q K^T over 192 columns is three 64-column chunks of
// 128-byte swizzle, twelve k16 steps; P V is wgmma m64n128k16 into
// o[HDV / 2] from V's two chunks; O goes out through two of Q's three
// chunks.  Shared memory counts K at 192 and V at 128: Q 48 KB + two
// stages of K 48 KB and V 32 KB = 209 KB, with 128-key tiles (counting V
// at 192 would be 241 KB, over the 227 KB a block may use).  The
// registers a consumer holds are hd 128's (o 64, S 64, P 32).  float32:
// 24 k8 steps of Q K^T, V^T hi/lo 128 wide, P V m64n128k8; one block an
// SM at 193 KB.  Bound at the served prefill (B 8, S 1024, causal): 1.34
// GB of q, k, v and out in bf16 (0.40 ms at 3.35 TB/s) against 344
// GFLOP (0.35 ms at 989 TFLOP/s): bound by bytes.
//
// (192, 192): q, k and v 192 wide (train_lm_100m's reduced Qwen2.5 at
// d_model 768 over 4 heads).  bf16: two stages of 128-key K and V tiles
// would take 192 KB beside Q's 48 KB, past the 227 KB a block may use, so
// the tiles hold 64 keys (145 KB), as at hd 256; P V is wgmma m64n192k16.
// float32: 32-key tiles as at (192, 128), 217 KB, one block an SM.
//
// For training, the caller passes an lse tensor and each row's
// log-sum-exp, m ln 2 + ln l (m the row max in log2 units), is written
// beside O: flash_attention_bwd.cu recomputes P from it.  Serving passes
// null and the kernels write nothing more.
//
// Sums run in a fixed order in both: bitwise repeatable.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper.cuh"

namespace {

constexpr float NEG = -1e30f;

// a 4-d map over (hd, position, heads, batch) of a tensor with element
// strides st = (batch, head, position); the wrapper has checked TMA's
// alignment
int make_map(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* ptr, int hd,
             int S, int heads, int B, const long long* st, int box_cols, int box_rows, int sw) {
  const long long dims[4] = {hd, S, heads, B};
  const long long strides[3] = {st[2], st[1], st[0]};
  const int box[4] = {box_cols, box_rows, 1, 1};
  return hopper::make_map_4d(map, type, esize, ptr, dims, strides, box, sw);
}

// ---------------------------------------------------------------------------
// the bf16 route: wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 128;        // query rows per block
constexpr int TC_ROWS = 64;       // query rows per consumer warpgroup
constexpr int TC_THREADS = 384;   // a producer warpgroup and two consumer warpgroups
constexpr int TC_STAGES = 2;      // K/V tiles in flight

// HD: the q/k tile width; HDV: the v (and output) tile width, HD but for
// MLA's (192, 128)
template <int HD, int HDV>
struct Tile {
  // keys per kv tile: 128, but 64 at hd 256 and at (192, 192), whose two
  // stages of 128-key K and V tiles (192 KB) leave no room for Q
  static constexpr int BK = HD <= 192 && HD + HDV <= 320 ? 128 : 64;
  static constexpr int SW = HD % 64 == 0 ? 128 : 64;  // swizzle = bytes of a chunk row
  static constexpr int CW = SW / 2;                   // bf16 columns per chunk
  static constexpr int NC = HD / CW;                  // chunks of a Q or K row
  static constexpr int NCV = HDV / CW;                // chunks of a V or O row
  static_assert(HDV % CW == 0 && HDV <= HD, "V rows of whole chunks, O within Q's rows");
  static constexpr int Q_CHUNK = TC_BQ * SW;          // bytes of one chunk of the Q tile
  static constexpr int KV_CHUNK = BK * SW;
  static constexpr int Q_BYTES = NC * Q_CHUNK;
  static constexpr int K_BYTES = NC * KV_CHUNK;       // one K tile
  static constexpr int V_BYTES = NCV * KV_CHUNK;      // one V tile
  // slack to align the base to 1024, the tiles, the 1 + 3 * STAGES barriers
  static constexpr int SMEM = 1024 + Q_BYTES + TC_STAGES * (K_BYTES + V_BYTES) + 8 * (1 + 3 * TC_STAGES);
};

// the row log-sum-exp (natural units) for the backward, (B, H, Sq)
// float32: one lane of each quad writes rows `row` and `row + 8` from the
// row max m (log2 units) and the quad's summed l
__device__ __forceinline__ void write_lse(float* lse, int h, int b, int H, int Sq, int row,
                                          int lane, float m0, float m1, float l0, float l1) {
  if (lane & 3) return;
  float* dst = lse + ((long long)b * H + h) * Sq;
  if (row < Sq) dst[row] = m0 * 0.6931471805599453f + logf(l0);
  if (row + 8 < Sq) dst[row + 8] = m1 * 0.6931471805599453f + logf(l1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// tensor maps over (hd, position, head, batch); Q and O in boxes of CW x
// 64 rows (one consumer warpgroup), K and V in boxes of CW x BK keys
template <int HD, int HDV>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to, float* __restrict__ lse,
                       int G, int Sq, int Skv, int causal, int window, float scale_log2) {
  using T = Tile<HD, HDV>;
  constexpr int BK = T::BK, SW = T::SW, CW = T::CW, NC = T::NC, NCV = T::NCV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + T::Q_BYTES;                  // TC_STAGES K tiles
  uint8_t* sV = sK + TC_STAGES * T::K_BYTES;      // TC_STAGES V tiles
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sV + TC_STAGES * T::V_BYTES);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + TC_STAGES;
  uint64_t* empty = full_v + TC_STAGES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TC_BQ;   // last query tile first
  const int kh = h / G;
  const int off = Skv - Sq;
  // the key tiles any row of this block sees
  const int qlast = min(q0 + TC_BQ, Sq) - 1 + off;
  const int kv_end = causal ? min(Skv, qlast + 1) : Skv;
  const int kv_begin = window ? max(0, q0 + off - window + 1) : 0;
  const int t_begin = kv_begin / BK;
  const int t_end = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, 1);
    for (int s = 0; s < TC_STAGES; ++s) {
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
      hopper::mbar_expect_tx(full_q, T::Q_BYTES);
      for (int c = 0; c < NC; ++c)
        for (int w = 0; w < 2; ++w)
          hopper::tma_load_4d(sQ + c * T::Q_CHUNK + w * TC_ROWS * SW, &tq, full_q, c * CW,
                              q0 + w * TC_ROWS, h, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        const int s = i % TC_STAGES;
        hopper::mbar_wait(empty + s, ((i / TC_STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(full_k + s, T::K_BYTES);
        for (int c = 0; c < NC; ++c)
          hopper::tma_load_4d(sK + s * T::K_BYTES + c * T::KV_CHUNK, &tk, full_k + s, c * CW,
                              t * BK, kh, b);
        hopper::mbar_expect_tx(full_v + s, T::V_BYTES);
        for (int c = 0; c < NCV; ++c)
          hopper::tma_load_4d(sV + s * T::V_BYTES + c * T::KV_CHUNK, &tv, full_v + s, c * CW,
                              t * BK, kh, b);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns query rows q0 + 64 cw .. + 63; a thread
  // holds rows r and r + 8 of its warp's 16, columns 8 j + cq, + 1
  hopper::setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int t128 = threadIdx.x & 127;
  const int lane = t128 & 31;
  const int r = (t128 >> 5) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int qpos = q0 + cw * TC_ROWS + r + off;
  const int wfirst = q0 + cw * TC_ROWS + off;
  const int wlast = min(q0 + cw * TC_ROWS + TC_ROWS, Sq) - 1 + off;
  const uint32_t q_addr = hopper::smem_u32(sQ) + cw * TC_ROWS * SW;

  float o[HDV / 2];
#pragma unroll
  for (int x = 0; x < HDV / 2; ++x) o[x] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  hopper::mbar_wait(full_q, 0);

  for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
    const int s = i % TC_STAGES;
    const uint32_t parity = (i / TC_STAGES) & 1;
    const int k0 = t * BK;
    const uint32_t k_addr = hopper::smem_u32(sK + s * T::K_BYTES);
    const uint32_t v_addr = hopper::smem_u32(sV + s * T::V_BYTES);

    // S = Q K^T over hd in k-steps of 16
    float sc[BK / 2];
    hopper::mbar_wait(full_k + s, parity);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int c = kk / (CW / 16), j = kk % (CW / 16);
      const uint64_t da = hopper::make_desc(q_addr + c * T::Q_CHUNK + j * 32, 16, 8 * SW, SW);
      const uint64_t db = hopper::make_desc(k_addr + c * T::KV_CHUNK + j * 32, 16, 8 * SW, SW);
      if constexpr (BK == 128)
        hopper::wgmma_ss_n128(sc, da, db, kk > 0);
      else
        hopper::wgmma_ss_n64(sc, da, db, kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);

    // scores in log2 units; the mask only on tiles that cross the
    // diagonal, the window edge or Skv for some row of this warpgroup
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) sc[x] *= scale_log2;
    if (k0 + BK > Skv || (causal && k0 + BK - 1 > wfirst) || (window && k0 <= wlast - window)) {
#pragma unroll
      for (int jn = 0; jn < BK / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * jn + cq + (e & 1);
          const int qp = qpos + 8 * (e >> 1);
          const bool ok = kpos < Skv && (!causal || kpos <= qp) && (!window || kpos > qp - window);
          if (!ok) sc[4 * jn + e] = -CUDART_INF_F;
        }
    }

    // online softmax: the row max over the quad's 4 threads, fixed order
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int jn = 0; jn < BK / 8; ++jn) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * jn], sc[4 * jn + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * jn + 2], sc[4 * jn + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int jn = 0; jn < BK / 8; ++jn) {
      sc[4 * jn] = exp2f(sc[4 * jn] - m0);
      sc[4 * jn + 1] = exp2f(sc[4 * jn + 1] - m0);
      sc[4 * jn + 2] = exp2f(sc[4 * jn + 2] - m1);
      sc[4 * jn + 3] = exp2f(sc[4 * jn + 3] - m1);
      rs0 += sc[4 * jn] + sc[4 * jn + 1];
      rs1 += sc[4 * jn + 2] + sc[4 * jn + 3];
    }
    // each thread keeps its own part of the row sums; the quad adds them
    // at the end
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int jn = 0; jn < HDV / 8; ++jn) {
      o[4 * jn] *= a0;
      o[4 * jn + 1] *= a0;
      o[4 * jn + 2] *= a1;
      o[4 * jn + 3] *= a1;
    }
    // P in bf16 as the A fragments of the k-steps of 16 keys
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }

    // O += P V, V read transposed (MN-major) from its chunks
    hopper::mbar_wait(full_v + s, parity);
    hopper::fence_regs(pa);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = hopper::make_desc(v_addr + kk * 16 * SW, T::KV_CHUNK, 8 * SW, SW);
      if constexpr (HDV == 64)
        hopper::wgmma_rs_n64(o, pa[kk], db);
      else if constexpr (HDV == 96)
        hopper::wgmma_rs_n96(o, pa[kk], db);
      else if constexpr (HDV == 128)
        hopper::wgmma_rs_n128(o, pa[kk], db);
      else if constexpr (HDV == 192)
        hopper::wgmma_rs_n192(o, pa[kk], db);
      else
        hopper::wgmma_rs_n256(o, pa[kk], db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(o);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(empty + s);   // this warp is done with the stage
  }

  // epilogue: O / max(l, 1e-30) in bf16 into this warpgroup's (dead) Q
  // rows, swizzled as the map expects, then one TMA store per chunk
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr) write_lse(lse, h, b, gridDim.x, Sq, q0 + cw * TC_ROWS + r, lane, m0, m1, l0, l1);
  uint8_t* sO = sQ + cw * TC_ROWS * SW;
#pragma unroll
  for (int jn = 0; jn < HDV / 8; ++jn) {
    const int col = 8 * jn + cq;
    const int byte = (col % CW) * 2;
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int row = r + 8 * i2;
      const int unit = (byte >> 4) ^ (SW == 128 ? (row & 7) : ((row >> 1) & 3));
      const float den = i2 ? d1 : d0;
      *reinterpret_cast<uint32_t*>(sO + (col / CW) * T::Q_CHUNK + row * SW + unit * 16 +
                                   (byte & 15)) =
          pack_bf16(o[4 * jn + 2 * i2] / den, o[4 * jn + 2 * i2 + 1] / den);
    }
  }
  hopper::fence_proxy_async();
  hopper::named_barrier(1 + cw, 128);
  if (t128 == 0 && q0 + cw * TC_ROWS < Sq) {
    for (int c = 0; c < NCV; ++c)
      hopper::tma_store_4d(&to, sO + c * T::Q_CHUNK, c * CW, q0 + cw * TC_ROWS, h, b);
    hopper::tma_store_commit_and_wait_read();
  }
}

// ---------------------------------------------------------------------------
// the float32 route: wgmma on TF32 hi/lo splits, TMA
// ---------------------------------------------------------------------------

constexpr int F_BQ = 64;          // query rows per block: one consumer warpgroup
constexpr int F_THREADS = 160;    // the consumer warpgroup and a producer warp

// HD and HDV as in Tile
template <int HD, int HDV>
struct TileF {
  static constexpr int BK = HD <= 192 ? 32 : 16;   // keys per kv tile
  static constexpr int NC = HD / 32;               // 128-byte chunks of a Q or K row
  static constexpr int NCV = HDV / 32;             // 128-byte chunks of a V or O row
  static_assert(HDV % 32 == 0 && HDV <= HD, "V rows of whole chunks, O within Q's rows");
  static constexpr int Q_CHUNK = F_BQ * 128;
  static constexpr int KV_CHUNK = BK * 128;
  static constexpr int Q_BYTES = NC * Q_CHUNK;     // 64 x HD float32
  static constexpr int K_BYTES = NC * KV_CHUNK;    // BK x HD float32
  static constexpr int V_BYTES = NCV * KV_CHUNK;   // BK x HDV float32 (and each V^T part)
  static constexpr int VT_SW = BK >= 32 ? 128 : 4 * BK;  // V^T rows: BK keys, swizzle
  static constexpr int VT_CW = VT_SW / 4;          // keys per chunk of a V^T row
  static constexpr int VT_CHUNK = HDV * VT_SW;
  // Q hi (over raw Q) and lo; K (raw, then hi), K lo; raw V; V^T hi, lo;
  // 3 barriers
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + 2 * K_BYTES + 3 * V_BYTES + 8 * 3;
  // two blocks fit on an SM (228 KB, 1 KB of it reserved per block) at hd
  // 64 and 96
  static constexpr int BLOCKS = SMEM + 1024 <= 228 * 1024 / 2 ? 2 : 1;
};

// the hi and lo TF32 parts of a float4, elementwise
__device__ __forceinline__ void split4(const float4 x, uint4& hi, uint4& lo) {
  hopper::split_tf32(x.x, hi.x, lo.x);
  hopper::split_tf32(x.y, hi.y, lo.y);
  hopper::split_tf32(x.z, hi.z, lo.z);
  hopper::split_tf32(x.w, hi.w, lo.w);
}

// a tile of 16-byte units, U for each of 128 threads: hi over the tile in
// place, lo into `lo`, byte for byte (so in the tile's swizzled layout);
// the loads of up to 8 units issue before their splits
template <int U>
__device__ __forceinline__ void split_tile(uint8_t* tile, uint8_t* lo, int tid) {
  constexpr int BATCH = U <= 8 ? U : (U % 8 == 0 ? 8 : 6);   // U is 4, 6, 8, 12, 16, 32 or 48
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
      split4(x[k], h, l);
      *reinterpret_cast<uint4*>(tile + 16 * (tid + 128 * (k0 + k))) = h;
      *reinterpret_cast<uint4*>(lo + 16 * (tid + 128 * (k0 + k))) = l;
    }
  }
}

// tensor maps over (hd, position, head, batch) in float32 with 128-byte
// swizzle: Q and O in boxes of 32 x 64 rows, K and V in boxes of 32 x BK
template <int HD, int HDV>
__global__ void __launch_bounds__(F_THREADS, TileF<HD, HDV>::BLOCKS)
flash_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to, float* __restrict__ lse, int G,
                      int Sq, int Skv, int causal, int window, float scale_log2) {
  using T = TileF<HD, HDV>;
  constexpr int BK = T::BK, NC = T::NC, NCV = T::NCV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);  // Q, Q hi, O
  uint8_t* sQl = sQ + T::Q_BYTES;
  uint8_t* sK = sQl + T::Q_BYTES;    // raw K and V as TMA writes them; K hi over K
  uint8_t* sV = sK + T::K_BYTES;
  uint8_t* sKl = sV + T::V_BYTES;
  uint8_t* sVh = sKl + T::K_BYTES;   // V^T hi and lo, keys in the A fragment's order
  uint8_t* sVl = sVh + T::V_BYTES;
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sVl + T::V_BYTES);
  uint64_t* full_kv = full_q + 1;
  uint64_t* empty = full_kv + 1;

  // the query tiles of one head run side by side (last first), then the
  // heads that share a kv head: the blocks in flight read the same K and V
  // tiles, from L2
  const int q0 = (gridDim.x - 1 - blockIdx.x) * F_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / G;
  const int off = Skv - Sq;
  const int qlast = min(q0 + F_BQ, Sq) - 1 + off;
  const int kv_end = causal ? min(Skv, qlast + 1) : Skv;
  const int kv_begin = window ? max(0, q0 + off - window + 1) : 0;
  const int t_begin = kv_begin / BK;
  const int t_end = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, 1);
    hopper::mbar_init(full_kv, 1);
    hopper::mbar_init(empty, 4);   // one arrival per consumer warp
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warp: one thread issues every copy
    if (threadIdx.x == 128) {
      hopper::mbar_expect_tx(full_q, T::Q_BYTES);
      for (int c = 0; c < NC; ++c)
        hopper::tma_load_4d(sQ + c * T::Q_CHUNK, &tq, full_q, c * 32, q0, h, b);
      for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
        hopper::mbar_wait(empty, (i & 1) ^ 1);
        hopper::mbar_expect_tx(full_kv, T::K_BYTES + T::V_BYTES);
        for (int c = 0; c < NC; ++c)
          hopper::tma_load_4d(sK + c * T::KV_CHUNK, &tk, full_kv, c * 32, t * BK, kh, b);
        for (int c = 0; c < NCV; ++c)
          hopper::tma_load_4d(sV + c * T::KV_CHUNK, &tv, full_kv, c * 32, t * BK, kh, b);
      }
    }
    return;
  }

  // the consumer warpgroup owns query rows q0 .. q0 + 63; a thread holds
  // rows r and r + 8 of its warp's 16, columns 8 j + cq, + 1
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = (tid >> 5) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int qpos = q0 + r + off;
  const int wfirst = q0 + off;
  const int wlast = qlast;
  const uint32_t qh_addr = hopper::smem_u32(sQ), ql_addr = hopper::smem_u32(sQl);
  const uint32_t kh_addr = hopper::smem_u32(sK), kl_addr = hopper::smem_u32(sKl);
  const uint32_t vh_addr = hopper::smem_u32(sVh), vl_addr = hopper::smem_u32(sVl);

  // Q: hi in place, lo beside, in TMA's swizzled layout
  hopper::mbar_wait(full_q, 0);
  split_tile<T::Q_BYTES / 16 / 128>(sQ, sQl, tid);

  float o[HDV / 2];
#pragma unroll
  for (int x = 0; x < HDV / 2; ++x) o[x] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
    const int k0 = t * BK;
    hopper::mbar_wait(full_kv, i & 1);
    // every warp's products on the previous tile are done with the splits
    hopper::named_barrier(1, 128);
    // K: hi in place and lo beside, in TMA's layout, byte for byte
    split_tile<T::K_BYTES / 16 / 128>(sK, sKl, tid);
    // V^T: item (column n, quarter g of a k-step pair) takes keys key0 +
    // {0, 2, 4, 6} of raw V to k-slots 4 g .. 4 g + 3 of V^T's row n
#pragma unroll
    for (int k = 0; k < HDV * BK / 4 / 128; ++k) {
      const int it = tid + 128 * k;
      const int n = it % HDV, g = it / HDV;
      const int key0 = 8 * (g >> 1) + (g & 1);
      const uint32_t col = (n / 32) * T::KV_CHUNK + (n % 32) * 4;
      float4 x;
      x.x = *reinterpret_cast<const float*>(sV + hopper::swz<128>(col + (key0 + 0) * 128));
      x.y = *reinterpret_cast<const float*>(sV + hopper::swz<128>(col + (key0 + 2) * 128));
      x.z = *reinterpret_cast<const float*>(sV + hopper::swz<128>(col + (key0 + 4) * 128));
      x.w = *reinterpret_cast<const float*>(sV + hopper::swz<128>(col + (key0 + 6) * 128));
      uint4 hi, lo;
      split4(x, hi, lo);
      const uint32_t dst = hopper::swz<T::VT_SW>(((4 * g) / T::VT_CW) * T::VT_CHUNK +
                                                 n * T::VT_SW + ((4 * g) % T::VT_CW) * 4);
      *reinterpret_cast<uint4*>(sVh + dst) = hi;
      *reinterpret_cast<uint4*>(sVl + dst) = lo;
    }
    hopper::fence_proxy_async();
    hopper::named_barrier(1, 128);

    // S = Qh Kh^T + Qh Kl^T + Ql Kh^T over hd in k-steps of 8
    float sc[BK / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      const int c = kk / 4, j = kk % 4;
      const uint64_t qh = hopper::make_desc(qh_addr + c * T::Q_CHUNK + j * 32, 16, 1024, 128);
      const uint64_t ql = hopper::make_desc(ql_addr + c * T::Q_CHUNK + j * 32, 16, 1024, 128);
      const uint64_t khd = hopper::make_desc(kh_addr + c * T::KV_CHUNK + j * 32, 16, 1024, 128);
      const uint64_t kld = hopper::make_desc(kl_addr + c * T::KV_CHUNK + j * 32, 16, 1024, 128);
      if constexpr (BK == 32) {
        hopper::wgmma_tf32_ss_n32(sc, qh, khd, kk > 0);
        hopper::wgmma_tf32_ss_n32(sc, qh, kld, 1);
        hopper::wgmma_tf32_ss_n32(sc, ql, khd, 1);
      } else {
        hopper::wgmma_tf32_ss_n16(sc, qh, khd, kk > 0);
        hopper::wgmma_tf32_ss_n16(sc, qh, kld, 1);
        hopper::wgmma_tf32_ss_n16(sc, ql, khd, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);
    // this warp's products are done with K hi: once every warp says so,
    // the stage loads the next tile during this one's softmax and P V
    __syncwarp();
    if ((tid & 31) == 0) hopper::mbar_arrive(empty);

    // scores in log2 units; the mask only on tiles that cross the
    // diagonal, the window edge or Skv for some row of this block
#pragma unroll
    for (int x = 0; x < BK / 2; ++x) sc[x] *= scale_log2;
    if (k0 + BK > Skv || (causal && k0 + BK - 1 > wfirst) || (window && k0 <= wlast - window)) {
#pragma unroll
      for (int jn = 0; jn < BK / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * jn + cq + (e & 1);
          const int qp = qpos + 8 * (e >> 1);
          const bool ok = kpos < Skv && (!causal || kpos <= qp) && (!window || kpos > qp - window);
          if (!ok) sc[4 * jn + e] = -CUDART_INF_F;
        }
    }

    // online softmax: the row max over the quad's 4 threads, fixed order
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int jn = 0; jn < BK / 8; ++jn) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * jn], sc[4 * jn + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * jn + 2], sc[4 * jn + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int jn = 0; jn < BK / 8; ++jn) {
      sc[4 * jn] = exp2f(sc[4 * jn] - m0);
      sc[4 * jn + 1] = exp2f(sc[4 * jn + 1] - m0);
      sc[4 * jn + 2] = exp2f(sc[4 * jn + 2] - m1);
      sc[4 * jn + 3] = exp2f(sc[4 * jn + 3] - m1);
      rs0 += sc[4 * jn] + sc[4 * jn + 1];
      rs1 += sc[4 * jn + 2] + sc[4 * jn + 3];
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
#pragma unroll
    for (int jn = 0; jn < HDV / 8; ++jn) {
      o[4 * jn] *= a0;
      o[4 * jn + 1] *= a0;
      o[4 * jn + 2] *= a1;
      o[4 * jn + 3] *= a1;
    }
    // P's hi and lo as the tf32 A fragments of the k-steps of 8 keys: the
    // fragment's (row, k-slot) pairs (r, t), (r+8, t), (r, t+4), (r+8, t+4)
    // hold keys 2t, 2t, 2t+1, 2t+1 (V^T's k-slots were written to match)
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      hopper::split_tf32(sc[4 * kk], ph[kk][0], pl[kk][0]);
      hopper::split_tf32(sc[4 * kk + 2], ph[kk][1], pl[kk][1]);
      hopper::split_tf32(sc[4 * kk + 1], ph[kk][2], pl[kk][2]);
      hopper::split_tf32(sc[4 * kk + 3], ph[kk][3], pl[kk][3]);
    }

    // O += Ph Vh + Ph Vl + Pl Vh
    hopper::fence_regs(ph);
    hopper::fence_regs(pl);
    hopper::fence_regs(o);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const uint32_t at = ((8 * kk) / T::VT_CW) * T::VT_CHUNK + ((8 * kk) % T::VT_CW) * 4;
      const uint64_t vh = hopper::make_desc(vh_addr + at, 16, 8 * T::VT_SW, T::VT_SW);
      const uint64_t vl = hopper::make_desc(vl_addr + at, 16, 8 * T::VT_SW, T::VT_SW);
      if constexpr (HDV == 64) {
        hopper::wgmma_tf32_rs_n64(o, ph[kk], vh);
        hopper::wgmma_tf32_rs_n64(o, ph[kk], vl);
        hopper::wgmma_tf32_rs_n64(o, pl[kk], vh);
      } else if constexpr (HDV == 96) {
        hopper::wgmma_tf32_rs_n96(o, ph[kk], vh);
        hopper::wgmma_tf32_rs_n96(o, ph[kk], vl);
        hopper::wgmma_tf32_rs_n96(o, pl[kk], vh);
      } else if constexpr (HDV == 128) {
        hopper::wgmma_tf32_rs_n128(o, ph[kk], vh);
        hopper::wgmma_tf32_rs_n128(o, ph[kk], vl);
        hopper::wgmma_tf32_rs_n128(o, pl[kk], vh);
      } else if constexpr (HDV == 192) {
        hopper::wgmma_tf32_rs_n192(o, ph[kk], vh);
        hopper::wgmma_tf32_rs_n192(o, ph[kk], vl);
        hopper::wgmma_tf32_rs_n192(o, pl[kk], vh);
      } else {
        hopper::wgmma_tf32_rs_n256(o, ph[kk], vh);
        hopper::wgmma_tf32_rs_n256(o, ph[kk], vl);
        hopper::wgmma_tf32_rs_n256(o, pl[kk], vh);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(o);
  }

  // epilogue: O / max(l, 1e-30) in float32 over Q hi, swizzled as the map
  // expects, then one TMA store per chunk
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (lse != nullptr) write_lse(lse, h, b, gridDim.y, Sq, q0 + r, lane, m0, m1, l0, l1);
  hopper::named_barrier(1, 128);   // every warp's products are done reading Q hi
#pragma unroll
  for (int jn = 0; jn < HDV / 8; ++jn) {
    const int col = 8 * jn + cq;
#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int row = r + 8 * i2;
      const float den = i2 ? d1 : d0;
      *reinterpret_cast<float2*>(
          sQ + hopper::swz<128>((col / 32) * T::Q_CHUNK + row * 128 + (col % 32) * 4)) =
          make_float2(o[4 * jn + 2 * i2] / den, o[4 * jn + 2 * i2 + 1] / den);
    }
  }
  hopper::fence_proxy_async();
  hopper::named_barrier(1, 128);
  if (tid == 0) {
    for (int c = 0; c < NCV; ++c)
      hopper::tma_store_4d(&to, sQ + c * T::Q_CHUNK, c * 32, q0, h, b);
    hopper::tma_store_commit_and_wait_read();
  }
}

// HD and HDV are the tile's widths, hd <= HD and hd_v <= HDV the tensors'
// (the maps' head axis): TMA fills a box's columns past hd with zeros and
// the store clips them
template <int HD, int HDV>
int launch_tf32(const void* q, const void* k, const void* v, void* o, float* lse,
                const long long* st, int B, int H, int K, int Sq, int Skv, int hd, int hd_v,
                int causal, int window, float scale, cudaStream_t stream) {
  using T = TileF<HD, HDV>;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap mq, mk, mv, mo;
  int err = make_map(&mq, F32, 4, q, hd, Sq, H, B, st, 32, F_BQ, 128);
  if (!err) err = make_map(&mk, F32, 4, k, hd, Skv, K, B, st + 3, 32, T::BK, 128);
  if (!err) err = make_map(&mv, F32, 4, v, hd_v, Skv, K, B, st + 6, 32, T::BK, 128);
  if (!err) err = make_map(&mo, F32, 4, o, hd_v, Sq, H, B, st + 9, 32, F_BQ, 128);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tf32_kernel<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + F_BQ - 1) / F_BQ, H, B);
  flash_fwd_tf32_kernel<HD, HDV><<<grid, F_THREADS, T::SMEM, stream>>>(
      mq, mk, mv, mo, lse, H / K, Sq, Skv, causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// HD and HDV as in launch_tf32
template <int HD, int HDV>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                 const long long* st, int B, int H, int K, int Sq, int Skv, int hd, int hd_v,
                 int causal, int window, float scale, cudaStream_t stream) {
  using T = Tile<HD, HDV>;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mq, mk, mv, mo;
  int err = make_map(&mq, BF16, 2, q, hd, Sq, H, B, st, T::CW, TC_ROWS, T::SW);
  if (!err) err = make_map(&mk, BF16, 2, k, hd, Skv, K, B, st + 3, T::CW, T::BK, T::SW);
  if (!err) err = make_map(&mv, BF16, 2, v, hd_v, Skv, K, B, st + 6, T::CW, T::BK, T::SW);
  if (!err) err = make_map(&mo, BF16, 2, o, hd_v, Sq, H, B, st + 9, T::CW, TC_ROWS, T::SW);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<HD, HDV>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (Sq + TC_BQ - 1) / TC_BQ);
  flash_fwd_wgmma_kernel<HD, HDV><<<grid, TC_THREADS, T::SMEM, stream>>>(
      mq, mk, mv, mo, lse, H / K, Sq, Skv, causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// the instance of a (q/k, v) width pair, or cudaErrorInvalidValue: equal
// widths 64, 80 (on the 96-wide tiles: the third chunk holds 16 zeros),
// 96, 128 and 256, and MLA's (192, 128)
template <bool BF16>
int dispatch(const void* q, const void* k, const void* v, void* o, float* lse,
             const long long* st, int B, int H, int K, int Sq, int Skv, int hd, int hd_v,
             int causal, int window, float scale, cudaStream_t s) {
#define K7_LAUNCH(HD, HDV)                                                                   \
  return BF16 ? launch_wgmma<HD, HDV>(q, k, v, o, lse, st, B, H, K, Sq, Skv, hd, hd_v,      \
                                      causal, window, scale, s)                              \
              : launch_tf32<HD, HDV>(q, k, v, o, lse, st, B, H, K, Sq, Skv, hd, hd_v,       \
                                     causal, window, scale, s)
  if (hd == 192 && hd_v == 128) K7_LAUNCH(192, 128);
  if (hd == 192 && hd_v == 192) K7_LAUNCH(192, 192);
  if (hd != hd_v) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64: K7_LAUNCH(64, 64);
    case 80:
    case 96: K7_LAUNCH(96, 96);
    case 128: K7_LAUNCH(128, 128);
    case 256: K7_LAUNCH(256, 256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K7_LAUNCH
}

}  // namespace

// strides: 12 element strides, (batch, head, position) of q, k, v, o in
// turn; hd is q's and k's width, hd_v v's and o's; is_bf16 selects bf16
// tensors and the bf16 kernel (else float32 and the TF32 split kernel).
// lse: null (serving), or a contiguous (B, H, Sq) float32 tensor that
// takes each row's log-sum-exp for the backward.  Returns
// cudaGetLastError() after the launch, or hopper::TENSOR_MAP_ERROR + a
// CUresult if a TMA map was refused.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, const long long* strides, int B, int H, int K,
                                   int Sq, int Skv, int hd, int hd_v, int causal, int window,
                                   float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (Sq == 0 || B == 0 || H == 0) return 0;
  return is_bf16 ? dispatch<true>(q, k, v, o, l, strides, B, H, K, Sq, Skv, hd, hd_v, causal,
                                  window, scale, s)
                 : dispatch<false>(q, k, v, o, l, strides, B, H, K, Sq, Skv, hd, hd_v, causal,
                                   window, scale, s);
}

// the dynamic shared memory a block of the (hd, hd_v) kernel asks for (0
// for a pair it does not take): launch_plan states the same number, and
// chip_smoke.py holds the two together
extern "C" int flash_attention_smem(int hd, int hd_v, int is_bf16) {
  if (hd == 192 && hd_v == 128) return is_bf16 ? Tile<192, 128>::SMEM : TileF<192, 128>::SMEM;
  if (hd == 192 && hd_v == 192) return is_bf16 ? Tile<192, 192>::SMEM : TileF<192, 192>::SMEM;
  if (hd != hd_v) return 0;
  switch (hd) {
    case 64: return is_bf16 ? Tile<64, 64>::SMEM : TileF<64, 64>::SMEM;
    case 80:   // the hd-96 tiles
    case 96: return is_bf16 ? Tile<96, 96>::SMEM : TileF<96, 96>::SMEM;
    case 128: return is_bf16 ? Tile<128, 128>::SMEM : TileF<128, 128>::SMEM;
    case 256: return is_bf16 ? Tile<256, 256>::SMEM : TileF<256, 256>::SMEM;
    default: return 0;
  }
}
