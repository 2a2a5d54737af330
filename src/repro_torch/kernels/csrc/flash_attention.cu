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
// last dim contiguous), so the model passes its (B, S, H, hd) tensors as
// (B, H, S, hd) views without a transpose copy, and the output is
// written the same way.
//
// Bound.  2*Sq*Skv*hd*2 flops per (b, h) (QK^T and PV), fewer under the
// causal or window mask; q, k, v read and o written once.  At
// Phi-3-mini's prefill (B 8, 32 x 96, S 1024, causal, bf16) that is
// about 51 GFLOP against 201 MB: the bf16 tensor-core peak (989 TFLOP/s,
// 0.05 ms) and the memory rate (3.35 TB/s, 0.06 ms) are close.
//
// Two routes, chosen by dtype (the wrapper says which it takes):
//
// bf16: flash_fwd_wgmma_kernel, on the tensor cores.  One block of 384
// threads per (head, batch, 128 query rows): a producer warpgroup whose
// one thread only issues TMA (Q once; K and V tiles of BK keys into a
// ring of STAGES stages, full/empty mbarriers per stage, K and V on
// separate full barriers), and two consumer warpgroups of 64 query rows
// each; setmaxnreg moves registers from the producer (24) to the
// consumers (240).  A consumer issues S = Q K^T as wgmma m64nBKk16 (both
// operands from swizzled shared memory), masks only the tiles that cross
// the diagonal, the window edge or Skv, runs the online softmax in
// registers (scores in log2 units, exp2; a row's max and sum reduced over
// the 4 threads of its quad in a fixed order), turns P into bf16 A
// fragments in registers (the accumulator layout is the A layout) and
// issues O += P V as wgmma m64n{hd}k16 with V as a transposed (MN-major)
// B operand.  The epilogue divides by max(l, 1e-30) in float32, writes
// bf16 O into the warpgroup's Q rows in shared memory (Q is dead) and
// TMA-stores it to the strided output; rows past Sq are clipped by TMA,
// as ragged Q and K tiles arrive as zeros and are masked.  BK is 128
// keys for hd <= 128 and 64 at hd 256 (the O accumulator alone is 128
// registers a thread); swizzle 128 B for hd 64, 128, 256 and 64 B for hd
// 96 (192-byte rows: three 32-column chunks).  Grid (H, B, query tiles):
// the G query heads of one kv head run side by side and share its tiles
// in L2, and the query tiles run last first, the longest causal rows
// leading.  P is rounded to bf16 for the PV product, as the TPU kernel's
// default-precision jnp.dot(p, v) and FlashAttention do: it adds at most
// 2^-8 * (sum_j p_j |v_j|) / l to an output.
//
// float32: flash_fwd_kernel, the first kernel, on the CUDA cores.  One
// block per (query tile of 64, head, batch), 8 warps, 8 query rows per
// warp; a loop over key/value tiles of 64 staged in shared memory as
// float32; the online softmax (running max m, denominator l, accumulator
// of 8 rows x hd/32 columns per lane) stays in registers, so the (Sq,
// Skv) matrix never reaches device memory, which is what the TPU kernel
// exists for.  Score tiles are 8 rows x 2 keys per lane from float4
// shared-memory reads (K rows padded by 4 floats: conflict-free); the
// probabilities of a tile pass through a per-warp shared buffer into the
// PV product.  Tiles wholly above the diagonal or outside the window are
// skipped.  Bound by operations on the CUDA cores, far from either bound.
//
// Sums run in a fixed order in both: bitwise repeatable.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per kv tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;     // query rows per warp
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

struct Strides {
  long long b, h, s;   // elements, for batch, head and position
};

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * HD + BK * (HD + 4) + BK * HD + BQ * BK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so, int G,
                 int Sq, int Skv, int causal, int window, float scale) {
  constexpr int KS = HD + 4;         // padded K row: column reads hit distinct banks
  constexpr int DPL = HD / 32;       // output columns per lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // BQ x HD, scaled
  float* Ks = Qs + BQ * HD;                      // BK x KS
  float* Vs = Ks + BK * KS;                      // BK x HD
  float* Ps = Vs + BK * HD;                      // BQ x BK, each warp its ROWS rows

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / G;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int off = Skv - Sq;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kh * sk.h;
  const T* vb = v + b * sv.b + kh * sv.h;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i - r * HD;
    const int qi = q0 + r;
    Qs[i] = qi < Sq ? to_f(qb[qi * sq.s + d]) * scale : 0.f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.f;
  }

  // the key range any row of this tile can see
  const int qfirst = q0 + off;
  const int qlast = min(q0 + BQ, Sq) - 1 + off;
  const int kv_end = causal ? min(Skv, qlast + 1) : Skv;
  const int kv_begin = window ? max(0, qfirst - window + 1) : 0;
  const int t_end = (kv_end + BK - 1) / BK;
  float* Pw = Ps + warp * ROWS * BK;

  for (int t = kv_begin / BK; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile's K, V and P reads are done
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i - r * HD;
      const int kj = k0 + r;
      const bool ok = kj < Skv;
      Ks[r * KS + d] = ok ? to_f(kb[kj * sk.s + d]) : 0.f;
      Vs[r * HD + d] = ok ? to_f(vb[kj * sv.s + d]) : 0.f;
    }
    __syncthreads();

    // scores of this warp's rows against keys lane and lane + 32
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(Ks + lane * KS + d);
      const float4 kc = *reinterpret_cast<const float4*>(Ks + (lane + 32) * KS + d);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(Qs + (warp * ROWS + r) * HD + d);
        s[r][0] += qv.x * ka.x + qv.y * ka.y + qv.z * ka.z + qv.w * ka.w;
        s[r][1] += qv.x * kc.x + qv.y * kc.y + qv.z * kc.z + qv.w * kc.w;
      }
    }

    // mask, online softmax; the probabilities go to this warp's P rows
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + warp * ROWS + r + off;
      bool ok[2];
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = k0 + lane + 32 * c;
        ok[c] = kpos < Skv && (!causal || kpos <= qpos) && (!window || kpos > qpos - window);
        if (ok[c]) mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[r], mx);
      const float p0 = ok[0] ? expf(s[r][0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(s[r][1] - m_new) : 0.f;
      float rs = p0 + p1;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, w);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
      Pw[r * BK + lane] = p0;
      Pw[r * BK + lane + 32] = p1;
    }
    __syncwarp();

    // acc[r][c] += sum_j P[r][j] * V[j][lane + 32 c]
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float vv[4][DPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < DPL; ++c) vv[jj][c] = Vs[(j + jj) * HD + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 p = *reinterpret_cast<const float4*>(Pw + r * BK + j);
#pragma unroll
        for (int c = 0; c < DPL; ++c)
          acc[r][c] += p.x * vv[0][c] + p.y * vv[1][c] + p.z * vv[2][c] + p.w * vv[3][c];
      }
    }
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qi = q0 + warp * ROWS + r;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPL; ++c) store(ob + qi * so.s + lane + 32 * c, acc[r][c] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, const long long* st, int B,
           int H, int K, int Sq, int Skv, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]}, sv{st[6], st[7], st[8]},
      so{st[9], st[10], st[11]};
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, HD><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, sv, so, H / K, Sq, Skv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, const long long* st, int B,
             int H, int K, int Sq, int Skv, int hd, int causal, int window, float scale,
             cudaStream_t stream) {
  switch (hd) {
    case 64: return launch<T, 64>(q, k, v, o, st, B, H, K, Sq, Skv, causal, window, scale, stream);
    case 96: return launch<T, 96>(q, k, v, o, st, B, H, K, Sq, Skv, causal, window, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, st, B, H, K, Sq, Skv, causal, window, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, st, B, H, K, Sq, Skv, causal, window, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// the bf16 route: wgmma and TMA
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 128;        // query rows per block
constexpr int TC_ROWS = 64;       // query rows per consumer warpgroup
constexpr int TC_THREADS = 384;   // a producer warpgroup and two consumer warpgroups
constexpr int TC_STAGES = 2;      // K/V tiles in flight

template <int HD>
struct Tile {
  static constexpr int BK = HD <= 128 ? 128 : 64;     // keys per kv tile
  static constexpr int SW = HD % 64 == 0 ? 128 : 64;  // swizzle = bytes of a chunk row
  static constexpr int CW = SW / 2;                   // bf16 columns per chunk
  static constexpr int NC = HD / CW;                  // chunks per row
  static constexpr int Q_CHUNK = TC_BQ * SW;          // bytes of one chunk of the Q tile
  static constexpr int KV_CHUNK = BK * SW;
  static constexpr int Q_BYTES = NC * Q_CHUNK;
  static constexpr int KV_BYTES = NC * KV_CHUNK;      // one K or one V tile
  // slack to align the base to 1024, the tiles, the 1 + 3 * STAGES barriers
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * TC_STAGES * KV_BYTES + 8 * (1 + 3 * TC_STAGES);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// tensor maps over (hd, position, head, batch); Q and O in boxes of CW x
// 64 rows (one consumer warpgroup), K and V in boxes of CW x BK keys
template <int HD>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to, int G, int Sq, int Skv,
                       int causal, int window, float scale_log2) {
  using T = Tile<HD>;
  constexpr int BK = T::BK, SW = T::SW, CW = T::CW, NC = T::NC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + T::Q_BYTES;                  // TC_STAGES K tiles
  uint8_t* sV = sK + TC_STAGES * T::KV_BYTES;     // TC_STAGES V tiles
  uint64_t* full_q = reinterpret_cast<uint64_t*>(sV + TC_STAGES * T::KV_BYTES);
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
        hopper::mbar_expect_tx(full_k + s, T::KV_BYTES);
        for (int c = 0; c < NC; ++c)
          hopper::tma_load_4d(sK + s * T::KV_BYTES + c * T::KV_CHUNK, &tk, full_k + s, c * CW,
                              t * BK, kh, b);
        hopper::mbar_expect_tx(full_v + s, T::KV_BYTES);
        for (int c = 0; c < NC; ++c)
          hopper::tma_load_4d(sV + s * T::KV_BYTES + c * T::KV_CHUNK, &tv, full_v + s, c * CW,
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

  float o[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) o[x] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
  hopper::mbar_wait(full_q, 0);

  for (int t = t_begin, i = 0; t < t_end; ++t, ++i) {
    const int s = i % TC_STAGES;
    const uint32_t parity = (i / TC_STAGES) & 1;
    const int k0 = t * BK;
    const uint32_t k_addr = hopper::smem_u32(sK + s * T::KV_BYTES);
    const uint32_t v_addr = hopper::smem_u32(sV + s * T::KV_BYTES);

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
    for (int jn = 0; jn < HD / 8; ++jn) {
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
      if constexpr (HD == 64)
        hopper::wgmma_rs_n64(o, pa[kk], db);
      else if constexpr (HD == 96)
        hopper::wgmma_rs_n96(o, pa[kk], db);
      else if constexpr (HD == 128)
        hopper::wgmma_rs_n128(o, pa[kk], db);
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
  uint8_t* sO = sQ + cw * TC_ROWS * SW;
#pragma unroll
  for (int jn = 0; jn < HD / 8; ++jn) {
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
    for (int c = 0; c < NC; ++c)
      hopper::tma_store_4d(&to, sO + c * T::Q_CHUNK, c * CW, q0 + cw * TC_ROWS, h, b);
    hopper::tma_store_commit_and_wait_read();
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no -lcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a failed encode returns TENSOR_MAP_ERROR + its CUresult
constexpr int TENSOR_MAP_ERROR = 10000;

// a 4-d map over (hd, S, heads, B) of a bf16 tensor with element strides
// st = (batch, head, position); the wrapper has checked TMA's alignment
int make_map(CUtensorMap* map, const void* ptr, int hd, int S, int heads, int B,
             const long long* st, int box_cols, int box_rows, int sw) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return TENSOR_MAP_ERROR + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)heads, (cuuint64_t)B};
  // a dim of size 1 is never stepped along: any multiple of 16 will do
  const cuuint64_t strides[3] = {S > 1 ? 2 * (cuuint64_t)st[2] : 16,
                                 heads > 1 ? 2 * (cuuint64_t)st[1] : 16,
                                 B > 1 ? 2 * (cuuint64_t)st[0] : 16};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                          strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERROR + (int)res;
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, const long long* st,
                 int B, int H, int K, int Sq, int Skv, int causal, int window, float scale,
                 cudaStream_t stream) {
  using T = Tile<HD>;
  CUtensorMap mq, mk, mv, mo;
  int err = make_map(&mq, q, HD, Sq, H, B, st, T::CW, TC_ROWS, T::SW);
  if (!err) err = make_map(&mk, k, HD, Skv, K, B, st + 3, T::CW, T::BK, T::SW);
  if (!err) err = make_map(&mv, v, HD, Skv, K, B, st + 6, T::CW, T::BK, T::SW);
  if (!err) err = make_map(&mo, o, HD, Sq, H, B, st + 9, T::CW, TC_ROWS, T::SW);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (Sq + TC_BQ - 1) / TC_BQ);
  flash_fwd_wgmma_kernel<HD><<<grid, TC_THREADS, T::SMEM, stream>>>(
      mq, mk, mv, mo, H / K, Sq, Skv, causal, window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int dispatch_wgmma(const void* q, const void* k, const void* v, void* o, const long long* st,
                   int B, int H, int K, int Sq, int Skv, int hd, int causal, int window,
                   float scale, cudaStream_t s) {
  switch (hd) {
    case 64: return launch_wgmma<64>(q, k, v, o, st, B, H, K, Sq, Skv, causal, window, scale, s);
    case 96: return launch_wgmma<96>(q, k, v, o, st, B, H, K, Sq, Skv, causal, window, scale, s);
    case 128: return launch_wgmma<128>(q, k, v, o, st, B, H, K, Sq, Skv, causal, window, scale, s);
    case 256: return launch_wgmma<256>(q, k, v, o, st, B, H, K, Sq, Skv, causal, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides, (batch, head, position) of q, k, v, o in
// turn; is_bf16 selects bf16 tensors and the wgmma kernel (else float32
// and the CUDA-core kernel).  Returns cudaGetLastError() after the
// launch, or TENSOR_MAP_ERROR + a CUresult if a TMA map was refused.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const long long* strides, int B, int H, int K, int Sq,
                                   int Skv, int hd, int causal, int window, float scale,
                                   int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq == 0 || B == 0 || H == 0) return 0;
  return is_bf16 ? dispatch_wgmma(q, k, v, o, strides, B, H, K, Sq, Skv, hd, causal, window,
                                  scale, s)
                 : dispatch<float>(q, k, v, o, strides, B, H, K, Sq, Skv, hd, causal, window,
                                   scale, s);
}
