// K7's VJP: the backward of flash attention (flash_attention.cu) for
// Hopper (sm_90a), on the CUDA cores.
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
// Two kernels, launched in this order on one stream:
//   flash_bwd_dq_kernel    one block per (query tile of TB rows, head,
//       batch).  A prologue computes D for its rows (one warp a row, a
//       fixed shuffle tree) and writes it to a (B, H, Sq) float32 scratch;
//       then it walks the key tiles its rows see (TS keys each),
//       recomputes S and dP, forms dS in shared memory and accumulates
//       dQ = dS K in registers.
//   flash_bwd_dkdv_kernel  one block per (key tile of TB rows, kv head,
//       batch).  It walks the G query heads of its group and, for each,
//       every query tile (TS rows) that sees a key of its tile, recomputes
//       S and dP, and accumulates dV = P^T dO and dK = dS^T Q in registers.
//       GQA's sum over the group runs inside the block in a fixed order.
// No float atomics: every output element is summed by one thread in one
// order, so both kernels are bitwise repeatable.
//
// Every product is a 16 x 16 grid of threads over its output, each thread
// holding rows ty + 16 a and columns tx + 16 c (a register tile), its
// operands read from shared memory rows padded to an odd stride (width +
// 1): a warp's 16 column threads read 16 distinct banks, its 2 row values
// are broadcasts.  Inputs arrive in their own dtype (bf16 or float32),
// are widened to float32 in shared memory, and every sum runs in float32;
// the outputs are written in the inputs' dtype.  Tiles: TB = 64 owned rows
// at widths up to 128 (32 above, where the register tiles of dK and dV
// would pass 64 values each), TS = 32 walked rows.
//
// Bound.  The minimum work is 2.5x the forward's: the products S, dP, dV,
// dK and dQ, 2 * pairs * (3 hd + 2 hd_v) flops over the pairs the masks
// keep, against q, k, v, o, dO, lse read once and dq, dk, dv written once.
// At Qwen2.5-14B's training shape (4 x 1024, 40 / 8 x 128, causal) that is
// about 107 GFLOP (0.109 ms at the bf16 tensor-core peak) against 88 MB.
// These kernels recompute S and dP in both passes (7 products, not 5) and
// run them on the CUDA cores (67 TFLOP/s of float32 FMA): a design that is
// simple and right first, whose time PERF.md records; the tensor cores
// (wgmma) are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;   // a 16 x 16 grid of threads over each product's output
constexpr int TS = 32;         // rows of the walked tile: keys in dq, queries in dkdv
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// element strides (batch, head, position) of each tensor; the last dim is
// contiguous
struct Strides {
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
};

template <int HD, int HDV>
struct BwdTile {
  static constexpr int TB = HD <= 128 ? 64 : 32;       // rows a block owns
  static constexpr int LDK = HD + 1, LDV = HDV + 1;    // padded shared rows
  // dkdv: K and V (TB rows), Q and dO (TS rows), P and dS (TS x TB), lse and D
  static constexpr int SMEM_DKDV =
      4 * ((TB + TS) * (LDK + LDV) + 2 * TS * (TB + 1) + 2 * TS);
  // dq: Q and dO (TB rows), K and V (TS rows), dS (TB x TS), lse and D
  static constexpr int SMEM_DQ = 4 * ((TB + TS) * (LDK + LDV) + TB * (TS + 1) + 2 * TB);
};

// rows [r0, r0 + R) of a (position, W) slab with row stride `stride` into
// shared rows of W + 1 floats; rows at or past `rows` read as zeros
template <int R, int W, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, long long stride,
                                          int r0, int rows, int tid) {
  for (int i = tid; i < R * W; i += THREADS) {
    const int r = i / W, c = i - r * W;
    dst[r * (W + 1) + c] = r0 + r < rows ? to_f(src[(long long)(r0 + r) * stride + c]) : 0.f;
  }
}

// the forward's mask at (query position qpos, key position kpos)
__device__ __forceinline__ bool keep(int qpos, int kpos, int Skv, int causal, int window) {
  return kpos < Skv && (!causal || kpos <= qpos) && (!window || kpos > qpos - window);
}

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ D, T* __restrict__ dq,
                    const Strides st, int G, int Sq, int Skv, int causal, int window,
                    float scale) {
  using BT = BwdTile<HD, HDV>;
  constexpr int TB = BT::TB, LDK = BT::LDK, LDV = BT::LDV;
  constexpr int MI = TB / 16, MJ = TS / 16, MD = HD / 16;
  extern __shared__ float sm[];
  float* sQ = sm;                    // TB x LDK
  float* sdO = sQ + TB * LDK;        // TB x LDV
  float* sK = sdO + TB * LDV;        // TS x LDK
  float* sV = sK + TS * LDK;         // TS x LDV
  float* sdS = sV + TS * LDV;        // TB x (TS + 1)
  float* sL = sdS + TB * (TS + 1);   // TB: lse in log2 units
  float* sD = sL + TB;               // TB

  const int q0 = (gridDim.x - 1 - blockIdx.x) * TB;   // last query tile first
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y, kh = h / G;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, warp = tid >> 5, lane = tid & 31;
  const int off = Skv - Sq;
  const float scale_log2 = scale * LOG2E;
  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + kh * st.k[1];
  const T* vb = v + b * st.v[0] + kh * st.v[1];
  const T* ob = o + b * st.o[0] + h * st.o[1];
  const T* dob = dout + b * st.dout[0] + h * st.dout[1];
  const long long row0 = ((long long)b * H + h) * Sq;

  load_rows<TB, HD>(sQ, qb, st.q[2], q0, Sq, tid);
  load_rows<TB, HDV>(sdO, dob, st.dout[2], q0, Sq, tid);
  __syncthreads();
  // D = <dO, o> a row: one warp a row, lanes over the columns, a fixed tree
  for (int i = warp; i < TB; i += THREADS / 32) {
    const int row = q0 + i;
    float acc = 0.f;
    if (row < Sq) {
      const T* orow = ob + (long long)row * st.o[2];
      for (int c = lane; c < HDV; c += 32) acc += sdO[i * LDV + c] * to_f(orow[c]);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
    if (lane == 0) {
      sD[i] = acc;
      sL[i] = row < Sq ? lse[row0 + row] * LOG2E : 0.f;
      if (row < Sq) D[row0 + row] = acc;
    }
  }

  // the key tiles any row of this block sees
  const int qlast = min(q0 + TB, Sq) - 1 + off;
  const int kv_end = causal ? min(Skv, qlast + 1) : Skv;
  const int kv_begin = window ? max(0, q0 + off - window + 1) : 0;
  float acc[MI][MD];
#pragma unroll
  for (int a = 0; a < MI; ++a)
#pragma unroll
    for (int c = 0; c < MD; ++c) acc[a][c] = 0.f;

  for (int k0 = (kv_begin / TS) * TS; k0 < kv_end; k0 += TS) {
    __syncthreads();   // the previous tile's K, V and dS reads are done
    load_rows<TS, HD>(sK, kb, st.k[2], k0, Skv, tid);
    load_rows<TS, HDV>(sV, vb, st.v[2], k0, Skv, tid);
    __syncthreads();
    // S = Q K^T and dP = dO V^T: rows ty + 16 a, keys tx + 16 c
    float s[MI][MJ], dp[MI][MJ];
#pragma unroll
    for (int a = 0; a < MI; ++a)
#pragma unroll
      for (int c = 0; c < MJ; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float x[MI], y[MJ];
#pragma unroll
      for (int a = 0; a < MI; ++a) x[a] = sQ[(ty + 16 * a) * LDK + d];
#pragma unroll
      for (int c = 0; c < MJ; ++c) y[c] = sK[(tx + 16 * c) * LDK + d];
#pragma unroll
      for (int a = 0; a < MI; ++a)
#pragma unroll
        for (int c = 0; c < MJ; ++c) s[a][c] += x[a] * y[c];
    }
#pragma unroll 4
    for (int d = 0; d < HDV; ++d) {
      float x[MI], y[MJ];
#pragma unroll
      for (int a = 0; a < MI; ++a) x[a] = sdO[(ty + 16 * a) * LDV + d];
#pragma unroll
      for (int c = 0; c < MJ; ++c) y[c] = sV[(tx + 16 * c) * LDV + d];
#pragma unroll
      for (int a = 0; a < MI; ++a)
#pragma unroll
        for (int c = 0; c < MJ; ++c) dp[a][c] += x[a] * y[c];
    }
#pragma unroll
    for (int a = 0; a < MI; ++a)
#pragma unroll
      for (int c = 0; c < MJ; ++c) {
        const int i = ty + 16 * a, j = tx + 16 * c;
        const int row = q0 + i;
        float p = 0.f;
        if (row < Sq && keep(row + off, k0 + j, Skv, causal, window))
          p = exp2f(s[a][c] * scale_log2 - sL[i]);
        sdS[i * (TS + 1) + j] = p * (dp[a][c] - sD[i]);
      }
    __syncthreads();
    // dQ += dS K: rows ty + 16 a, columns tx + 16 c
#pragma unroll 4
    for (int j = 0; j < TS; ++j) {
      float x[MI], y[MD];
#pragma unroll
      for (int a = 0; a < MI; ++a) x[a] = sdS[(ty + 16 * a) * (TS + 1) + j];
#pragma unroll
      for (int c = 0; c < MD; ++c) y[c] = sK[j * LDK + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < MI; ++a)
#pragma unroll
        for (int c = 0; c < MD; ++c) acc[a][c] += x[a] * y[c];
    }
  }

  T* dqb = dq + b * st.dq[0] + h * st.dq[1];
#pragma unroll
  for (int a = 0; a < MI; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < MD; ++c)
      store(dqb + (long long)row * st.dq[2] + tx + 16 * c, scale * acc[a][c]);
  }
}

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ D, T* __restrict__ dk, T* __restrict__ dv,
                      const Strides st, int H, int Sq, int Skv, int causal, int window,
                      float scale) {
  using BT = BwdTile<HD, HDV>;
  constexpr int TB = BT::TB, LDK = BT::LDK, LDV = BT::LDV;
  constexpr int MI = TS / 16, MJ = TB / 16, MD = HD / 16, MV = HDV / 16;
  extern __shared__ float sm[];
  float* sK = sm;                    // TB x LDK
  float* sV = sK + TB * LDK;         // TB x LDV
  float* sQ = sV + TB * LDV;         // TS x LDK
  float* sdO = sQ + TS * LDK;        // TS x LDV
  float* sP = sdO + TS * LDV;        // TS x (TB + 1)
  float* sdS = sP + TS * (TB + 1);   // TS x (TB + 1)
  float* sL = sdS + TS * (TB + 1);   // TS: lse in log2 units
  float* sD = sL + TS;               // TS

  const int k0 = blockIdx.x * TB;
  const int kh = blockIdx.y, b = blockIdx.z, K = gridDim.y, G = H / K;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int off = Skv - Sq;
  const float scale_log2 = scale * LOG2E;
  load_rows<TB, HD>(sK, k + b * st.k[0] + kh * st.k[1], st.k[2], k0, Skv, tid);
  load_rows<TB, HDV>(sV, v + b * st.v[0] + kh * st.v[1], st.v[2], k0, Skv, tid);

  // the query rows that see a key of this tile
  const int klast = min(k0 + TB, Skv) - 1;
  const int q_begin = causal ? max(0, k0 - off) : 0;
  const int q_end = window ? min(Sq, klast + window - off) : Sq;
  float dka[MJ][MD], dva[MJ][MV];
#pragma unroll
  for (int c = 0; c < MJ; ++c) {
#pragma unroll
    for (int e = 0; e < MD; ++e) dka[c][e] = 0.f;
#pragma unroll
    for (int e = 0; e < MV; ++e) dva[c][e] = 0.f;
  }

  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qb = q + b * st.q[0] + h * st.q[1];
    const T* dob = dout + b * st.dout[0] + h * st.dout[1];
    const long long row0 = ((long long)b * H + h) * Sq;
    for (int i0 = (q_begin / TS) * TS; i0 < q_end; i0 += TS) {
      __syncthreads();   // the previous tile's reads are done (and K, V landed)
      load_rows<TS, HD>(sQ, qb, st.q[2], i0, Sq, tid);
      load_rows<TS, HDV>(sdO, dob, st.dout[2], i0, Sq, tid);
      for (int i = tid; i < TS; i += THREADS) {
        const int row = i0 + i;
        sL[i] = row < Sq ? lse[row0 + row] * LOG2E : 0.f;
        sD[i] = row < Sq ? D[row0 + row] : 0.f;
      }
      __syncthreads();
      // S = Q K^T and dP = dO V^T: queries ty + 16 a, keys tx + 16 c
      float s[MI][MJ], dp[MI][MJ];
#pragma unroll
      for (int a = 0; a < MI; ++a)
#pragma unroll
        for (int c = 0; c < MJ; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float x[MI], y[MJ];
#pragma unroll
        for (int a = 0; a < MI; ++a) x[a] = sQ[(ty + 16 * a) * LDK + d];
#pragma unroll
        for (int c = 0; c < MJ; ++c) y[c] = sK[(tx + 16 * c) * LDK + d];
#pragma unroll
        for (int a = 0; a < MI; ++a)
#pragma unroll
          for (int c = 0; c < MJ; ++c) s[a][c] += x[a] * y[c];
      }
#pragma unroll 4
      for (int d = 0; d < HDV; ++d) {
        float x[MI], y[MJ];
#pragma unroll
        for (int a = 0; a < MI; ++a) x[a] = sdO[(ty + 16 * a) * LDV + d];
#pragma unroll
        for (int c = 0; c < MJ; ++c) y[c] = sV[(tx + 16 * c) * LDV + d];
#pragma unroll
        for (int a = 0; a < MI; ++a)
#pragma unroll
          for (int c = 0; c < MJ; ++c) dp[a][c] += x[a] * y[c];
      }
#pragma unroll
      for (int a = 0; a < MI; ++a)
#pragma unroll
        for (int c = 0; c < MJ; ++c) {
          const int i = ty + 16 * a, j = tx + 16 * c;
          const int row = i0 + i;
          float p = 0.f;
          if (row < Sq && keep(row + off, k0 + j, Skv, causal, window))
            p = exp2f(s[a][c] * scale_log2 - sL[i]);
          sP[i * (TB + 1) + j] = p;
          sdS[i * (TB + 1) + j] = p * (dp[a][c] - sD[i]);
        }
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q: keys ty + 16 c, columns tx + 16 e
#pragma unroll 2
      for (int i = 0; i < TS; ++i) {
        float pa[MJ], sa[MJ], yo[MV], yq[MD];
#pragma unroll
        for (int c = 0; c < MJ; ++c) {
          pa[c] = sP[i * (TB + 1) + ty + 16 * c];
          sa[c] = sdS[i * (TB + 1) + ty + 16 * c];
        }
#pragma unroll
        for (int e = 0; e < MV; ++e) yo[e] = sdO[i * LDV + tx + 16 * e];
#pragma unroll
        for (int e = 0; e < MD; ++e) yq[e] = sQ[i * LDK + tx + 16 * e];
#pragma unroll
        for (int c = 0; c < MJ; ++c) {
#pragma unroll
          for (int e = 0; e < MV; ++e) dva[c][e] += pa[c] * yo[e];
#pragma unroll
          for (int e = 0; e < MD; ++e) dka[c][e] += sa[c] * yq[e];
        }
      }
    }
  }

  T* dkb = dk + b * st.dk[0] + kh * st.dk[1];
  T* dvb = dv + b * st.dv[0] + kh * st.dv[1];
#pragma unroll
  for (int c = 0; c < MJ; ++c) {
    const int row = k0 + ty + 16 * c;
    if (row >= Skv) continue;
#pragma unroll
    for (int e = 0; e < MD; ++e)
      store(dkb + (long long)row * st.dk[2] + tx + 16 * e, scale * dka[c][e]);
#pragma unroll
    for (int e = 0; e < MV; ++e) store(dvb + (long long)row * st.dv[2] + tx + 16 * e, dva[c][e]);
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

template <typename T, int HD, int HDV>
int launch(const Args& a, int dkdv) {
  using BT = BwdTile<HD, HDV>;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  float* D = static_cast<float*>(a.D);
  if (!dkdv) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, HD, HDV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         BT::SMEM_DQ);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((a.Sq + BT::TB - 1) / BT::TB, a.H, a.B);
    flash_bwd_dq_kernel<T, HD, HDV><<<grid, THREADS, BT::SMEM_DQ, a.stream>>>(
        q, k, v, static_cast<const T*>(a.o), dout, lse, D, static_cast<T*>(a.dq), a.st,
        a.H / a.K, a.Sq, a.Skv, a.causal, a.window, a.scale);
    return (int)cudaGetLastError();
  }
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, HD, HDV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       BT::SMEM_DKDV);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Skv + BT::TB - 1) / BT::TB, a.K, a.B);
  flash_bwd_dkdv_kernel<T, HD, HDV><<<grid, THREADS, BT::SMEM_DKDV, a.stream>>>(
      q, k, v, dout, lse, D, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.st, a.H, a.Sq,
      a.Skv, a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

// the instance of a (q/k, v) width pair (every pair of the forward, hd 80
// at its own width), or cudaErrorInvalidValue
template <typename T>
int dispatch(const Args& a, int hd, int hd_v, int dkdv) {
  if (hd == 192 && hd_v == 128) return launch<T, 192, 128>(a, dkdv);
  if (hd == 192 && hd_v == 192) return launch<T, 192, 192>(a, dkdv);
  if (hd != hd_v) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 64: return launch<T, 64, 64>(a, dkdv);
    case 80: return launch<T, 80, 80>(a, dkdv);
    case 96: return launch<T, 96, 96>(a, dkdv);
    case 128: return launch<T, 128, 128>(a, dkdv);
    case 256: return launch<T, 256, 256>(a, dkdv);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(const void* q, const void* k, const void* v, const void* o, const void* dout,
        const void* lse, void* D, void* dq, void* dk, void* dv, const long long* strides, int B,
        int H, int K, int Sq, int Skv, int hd, int hd_v, int causal, int window, float scale,
        int is_bf16, int dkdv, void* stream) {
  if (B == 0 || H == 0 || Sq == 0 || Skv == 0) return 0;
  Args a{q, k, v, o, dout, lse, D, dq, dk, dv, {}, B, H, K, Sq, Skv, causal, window, scale,
         static_cast<cudaStream_t>(stream)};
  long long* st = &a.st.q[0];
  for (int i = 0; i < 24; ++i) st[i] = strides[i];
  return is_bf16 ? dispatch<__nv_bfloat16>(a, hd, hd_v, dkdv)
                 : dispatch<float>(a, hd, hd_v, dkdv);
}

}  // namespace

// strides: 24 element strides, (batch, head, position) of q, k, v, o, dO,
// dq, dk, dv in turn (the last dim of each contiguous); lse and D are
// contiguous (B, H, Sq) float32.  flash_attention_bwd_dq writes D and dq
// and must run before flash_attention_bwd_dkdv, which reads D and writes
// dk and dv.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                      const void* dout, const void* lse, void* D, void* dq,
                                      void* dk, void* dv, const long long* strides, int B, int H,
                                      int K, int Sq, int Skv, int hd, int hd_v, int causal,
                                      int window, float scale, int is_bf16, void* stream) {
  return run(q, k, v, o, dout, lse, D, dq, dk, dv, strides, B, H, K, Sq, Skv, hd, hd_v, causal,
             window, scale, is_bf16, 0, stream);
}

extern "C" int flash_attention_bwd_dkdv(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse, void* D,
                                        void* dq, void* dk, void* dv, const long long* strides,
                                        int B, int H, int K, int Sq, int Skv, int hd, int hd_v,
                                        int causal, int window, float scale, int is_bf16,
                                        void* stream) {
  return run(q, k, v, o, dout, lse, D, dq, dk, dv, strides, B, H, K, Sq, Skv, hd, hd_v, causal,
             window, scale, is_bf16, 1, stream);
}

// the dynamic shared memory of a block of the dq (dkdv = 0) or dkdv
// kernel at a width pair (0 for a pair it does not take): bwd_launch_plan
// states the same numbers, and chip_smoke.py holds them together
extern "C" int flash_attention_bwd_smem(int hd, int hd_v, int dkdv) {
#define K7B_SMEM(HD, HDV) return dkdv ? BwdTile<HD, HDV>::SMEM_DKDV : BwdTile<HD, HDV>::SMEM_DQ
  if (hd == 192 && hd_v == 128) K7B_SMEM(192, 128);
  if (hd == 192 && hd_v == 192) K7B_SMEM(192, 192);
  if (hd != hd_v) return 0;
  switch (hd) {
    case 64: K7B_SMEM(64, 64);
    case 80: K7B_SMEM(80, 80);
    case 96: K7B_SMEM(96, 96);
    case 128: K7B_SMEM(128, 128);
    case 256: K7B_SMEM(256, 256);
    default: return 0;
  }
#undef K7B_SMEM
}
