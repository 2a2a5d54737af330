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
//     only shapes that have one: causal with Sq > Skv).
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
// 0.05 ms) and the memory rate (3.35 TB/s, 0.06 ms) are close.  This
// first kernel runs on the CUDA cores in float32, so it is bound by
// operations and far from either.  What the design does: one block per
// (query tile of 64, head, batch), 8 warps, 8 query rows per warp; a
// loop over key/value tiles of 64 staged in shared memory as float32;
// the online softmax (running max m, denominator l, accumulator of 8
// rows x hd/32 columns per lane) stays in registers, so the (Sq, Skv)
// matrix never reaches device memory, which is what the TPU kernel
// exists for.  Score tiles are 8 rows x 2 keys per lane from float4
// shared-memory reads (K rows padded by 4 floats: conflict-free); the
// probabilities of a tile pass through a per-warp shared buffer into
// the PV product.  Tiles wholly above the diagonal or outside the window
// are skipped.  Sums run in a fixed order: bitwise repeatable.
// Tensor-core (mma / wgmma) tiles are the later, faster version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per kv tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = BQ / WARPS;     // query rows per warp
constexpr float NEG = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

}  // namespace

// strides: 12 element strides, (batch, head, position) of q, k, v, o in
// turn; is_bf16 selects bf16 tensors (else float32).  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const long long* strides, int B, int H, int K, int Sq,
                                   int Skv, int hd, int causal, int window, float scale,
                                   int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Sq == 0 || B == 0 || H == 0) return 0;
  return is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, strides, B, H, K, Sq, Skv, hd, causal,
                                           window, scale, s)
                 : dispatch<float>(q, k, v, o, strides, B, H, K, Sq, Skv, hd, causal, window,
                                   scale, s);
}
