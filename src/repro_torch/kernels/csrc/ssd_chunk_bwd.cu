// K8's VJP: the backward of the Mamba2 SSD chunk state (ssd_chunk.cu) for
// Hopper (sm_90a), on the CUDA cores.
//
// The forward: state[c,h,p,n] = sum_l w_l x[c,l,h,p] Bm[c,l,g,n] with
// g = h / (H/G), w_l = exp(cumA_L - cumA_l) dt_l and cumA the running sum
// of dt * A[h] over the chunk's positions.  Given G = d state (C, H, P, N)
// float32, with u[l,p] = sum_n G[h,p,n] Bm[l,g,n]:
//       dx[l,h,p]   = w_l u[l,p]
//       dBm[l,g,n]  = sum_{h in g} w_l sum_p G[h,p,n] x[l,h,p]
//       dw_l        = sum_p x[l,h,p] u[l,p]
//       ddt_j       = dw_j exp(cumA_L - cumA_j) + A_h sum_{l<j} dw_l w_l
//       dA_h        = sum_j dt_j sum_{l<j} dw_l w_l
// (the last is sum_l dw_l w_l sum_{j>l} dt_j, summed in the order that
// needs no difference of running sums).  Replaces no TPU kernel: the
// reference trains through XLA's autodiff of its `states` einsum
// (src/repro/models/transformer/ssm.py:109) and never differentiates its
// Pallas kernel (src/repro/kernels/ssd_chunk.py:42); the port's forward
// on the card is K8, so its gradient is a kernel too.
//
// ssd_bwd_kernel: one block per (chunk, group), 256 threads.  Each warp
// first takes the prefix sums of dt * A of some of the group's heads over
// the whole chunk, in the forward's order (so w is the forward's, bit for
// bit).  The block then walks the chunk in tiles of 64 positions and,
// inside a tile, the group's heads in order: per head, u = Bm G_h^T (64 x
// P) gives dx and the partial dw; v = x G_h (64 x N) times w adds into the
// tile's dBm, held in registers across the heads, so dBm's sum over the
// H/G heads has one fixed order; warp 0 then takes the exclusive prefix of
// dw * w over the tile (carried across tiles a head) for ddt and the
// chunk's dA partial.  dA leaves as (C, H) partials, which the caller sums
// over chunks.  No float atomics: bitwise repeatable.  Products on a 16 x
// 16 grid of threads, operands in shared rows padded to an odd stride, as
// in flash_attention_bwd.cu; x and Bm in bf16 or float32, every sum in
// float32, dx and dBm written in the inputs' dtype, ddt and dA float32.
//
// Bound: 4 C H L P N flops (u and v) against x, Bm, dt, G read once and
// dx, dBm, ddt, dA written once.  At Mamba2-780m's widths (48 x 64, N
// 128, chunks of 256) the bytes and the flops over the CUDA cores' 67
// TFLOP/s are of one order; a (chunk, group) block walks 48 heads, so
// at batch 2 x 1024 the grid holds 8 blocks: the design buys the fixed
// order of dBm's sum with parallelism, and PERF.md records its time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TL = 64;   // positions per tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// inclusive prefix sum of w[0 .. L) by one warp in one fixed order, the
// forward's (ssd_chunk.cu): lane i sums its run of positions in order,
// then the runs are offset by a shuffle scan of their totals
__device__ __forceinline__ void prefix_sum(float* w, int L, int lane) {
  const int run = (L + 31) / 32;
  const int lo = min(L, lane * run), hi = min(L, lo + run);
  float tot = 0.f;
  for (int l = lo; l < hi; ++l) {
    tot += w[l];
    w[l] = tot;
  }
  float incl = tot;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += up;
  }
  const float before = incl - tot;
  for (int l = lo; l < hi; ++l) w[l] += before;
}

template <int P, int N>
struct SsdBwd {
  static constexpr int LDB = N + 1, LDX = P + 1, LDG = N + 1;
  // Bm and x tiles, G_h, the dw partials (TL x 16), w, e, dt, dw * w
  static constexpr int FIXED = TL * LDB + TL * LDX + P * LDG + TL * 16 + 4 * TL;
};

// bytes of dynamic shared memory: the fixed part, the R x L prefix sums,
// and each head's carry and dA partial
template <int P, int N>
int smem_bytes(int R, int L) {
  return 4 * (SsdBwd<P, N>::FIXED + R * L + 2 * R);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
               const T* __restrict__ Bm, const float* __restrict__ gs, T* __restrict__ dx,
               T* __restrict__ dBm, float* __restrict__ ddt, float* __restrict__ dA_part, int L,
               int H, long long xc, long long xl, long long xh, long long bc, long long bl,
               long long bg) {
  using S = SsdBwd<P, N>;
  constexpr int LDB = S::LDB, LDX = S::LDX, LDG = S::LDG;
  constexpr int MA = TL / 16, MP = P / 16, MN = N / 16;
  extern __shared__ float sm[];
  float* sB = sm;                  // TL x LDB: Bm
  float* sX = sB + TL * LDB;       // TL x LDX: x of the head
  float* sG = sX + TL * LDX;       // P x LDG: G of the head
  float* red = sG + P * LDG;       // TL x 16: partial dw, then dw in column 0
  float* sw = red + TL * 16;       // TL: w
  float* se = sw + TL;             // TL: exp(cumA_L - cumA_l)
  float* sdt = se + TL;            // TL: dt
  float* sq = sdt + TL;            // TL: dw * w
  const int G = gridDim.y, R = H / G;
  float* cum = sq + TL;            // R x L: running sums of dt * A
  float* carry = cum + R * L;      // R: sum of dw * w over the earlier tiles
  float* dAacc = carry + R;        // R: the chunk's dA partial

  const int c = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15, warp = tid >> 5, lane = tid & 31;
  const float* dtc = dt + (long long)c * L * H;
  for (int r = warp; r < R; r += THREADS / 32) {
    const int h = g * R + r;
    const float a = A[h];
    float* cr = cum + r * L;
    for (int l = lane; l < L; l += 32) cr[l] = dtc[(long long)l * H + h] * a;
    __syncwarp();
    prefix_sum(cr, L, lane);
    if (lane == 0) {
      carry[r] = 0.f;
      dAacc[r] = 0.f;
    }
  }

  const T* xb = x + c * xc;
  const T* bb = Bm + c * bc + g * bg;
  for (int l0 = 0; l0 < L; l0 += TL) {
    __syncthreads();   // the prefix sums are done; the previous tile's reads too
    for (int i = tid; i < TL * N; i += THREADS) {
      const int r = i / N, n = i - r * N;
      sB[r * LDB + n] = l0 + r < L ? to_f(bb[(long long)(l0 + r) * bl + n]) : 0.f;
    }
    float dbm[MA][MN];
#pragma unroll
    for (int m = 0; m < MA; ++m)
#pragma unroll
      for (int k = 0; k < MN; ++k) dbm[m][k] = 0.f;

    for (int r = 0; r < R; ++r) {
      const int h = g * R + r;
      const float a = A[h];
      __syncthreads();   // the previous head's reads are done
      for (int i = tid; i < TL * P; i += THREADS) {
        const int row = i / P, p = i - row * P;
        sX[row * LDX + p] =
            l0 + row < L ? to_f(xb[(long long)(l0 + row) * xl + (long long)h * xh + p]) : 0.f;
      }
      const float* gh = gs + ((long long)c * H + h) * P * N;
      for (int i = tid; i < P * N; i += THREADS) {
        const int p = i / N, n = i - p * N;
        sG[p * LDG + n] = gh[i];
      }
      for (int i = tid; i < TL; i += THREADS) {
        const int l = l0 + i;
        float e = 0.f, d = 0.f;
        if (l < L) {
          e = expf(cum[r * L + L - 1] - cum[r * L + l]);
          d = dtc[(long long)l * H + h];
        }
        se[i] = e;
        sdt[i] = d;
        sw[i] = e * d;
      }
      __syncthreads();

      // u = Bm G_h^T: positions ty + 16 m, columns p = tx + 16 k
      float u[MA][MP];
#pragma unroll
      for (int m = 0; m < MA; ++m)
#pragma unroll
        for (int k = 0; k < MP; ++k) u[m][k] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float xa[MA], yb[MP];
#pragma unroll
        for (int m = 0; m < MA; ++m) xa[m] = sB[(ty + 16 * m) * LDB + n];
#pragma unroll
        for (int k = 0; k < MP; ++k) yb[k] = sG[(tx + 16 * k) * LDG + n];
#pragma unroll
        for (int m = 0; m < MA; ++m)
#pragma unroll
          for (int k = 0; k < MP; ++k) u[m][k] += xa[m] * yb[k];
      }
      // dx = w u, and this thread's part of dw = sum_p x u
#pragma unroll
      for (int m = 0; m < MA; ++m) {
        const int i = ty + 16 * m, l = l0 + i;
        float part = 0.f;
#pragma unroll
        for (int k = 0; k < MP; ++k) {
          const int p = tx + 16 * k;
          part += sX[i * LDX + p] * u[m][k];
          if (l < L) store(dx + (((long long)c * L + l) * H + h) * P + p, sw[i] * u[m][k]);
        }
        red[i * 16 + tx] = part;
      }
      // v = x G_h: positions ty + 16 m, columns n = tx + 16 k; dBm += w v
      float vv[MA][MN];
#pragma unroll
      for (int m = 0; m < MA; ++m)
#pragma unroll
        for (int k = 0; k < MN; ++k) vv[m][k] = 0.f;
#pragma unroll 4
      for (int p = 0; p < P; ++p) {
        float xa[MA], yb[MN];
#pragma unroll
        for (int m = 0; m < MA; ++m) xa[m] = sX[(ty + 16 * m) * LDX + p];
#pragma unroll
        for (int k = 0; k < MN; ++k) yb[k] = sG[p * LDG + tx + 16 * k];
#pragma unroll
        for (int m = 0; m < MA; ++m)
#pragma unroll
          for (int k = 0; k < MN; ++k) vv[m][k] += xa[m] * yb[k];
      }
#pragma unroll
      for (int m = 0; m < MA; ++m)
#pragma unroll
        for (int k = 0; k < MN; ++k) dbm[m][k] += sw[ty + 16 * m] * vv[m][k];
      __syncthreads();   // the dw partials are in

      if (tid < TL) {
        float dw = 0.f;
#pragma unroll
        for (int t = 0; t < 16; ++t) dw += red[tid * 16 + t];
        red[tid * 16] = dw;
        sq[tid] = dw * sw[tid];
      }
      __syncthreads();
      if (warp == 0) {
        // the exclusive prefix of dw * w over the chunk, two positions a
        // lane in order, then ddt and this tile's part of dA
        const float before_tile = carry[r];
        const float q0 = sq[2 * lane], q1 = sq[2 * lane + 1];
        const float run = q0 + q1;
        float incl = run;
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
          const float up = __shfl_up_sync(0xffffffffu, incl, s);
          if (lane >= s) incl += up;
        }
        const float pre[2] = {before_tile + (incl - run), before_tile + (incl - run) + q0};
        float dap = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int i = 2 * lane + j, l = l0 + i;
          if (l < L) {
            ddt[((long long)c * L + l) * H + h] = red[i * 16] * se[i] + a * pre[j];
            dap += sdt[i] * pre[j];
          }
        }
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) dap += __shfl_xor_sync(0xffffffffu, dap, s);
        const float total = __shfl_sync(0xffffffffu, incl, 31);
        __syncwarp();
        if (lane == 0) {
          carry[r] = before_tile + total;
          dAacc[r] += dap;
        }
      }
    }

#pragma unroll
    for (int m = 0; m < MA; ++m) {
      const int l = l0 + ty + 16 * m;
      if (l >= L) continue;
#pragma unroll
      for (int k = 0; k < MN; ++k)
        store(dBm + (((long long)c * L + l) * G + g) * N + tx + 16 * k, dbm[m][k]);
    }
  }
  __syncthreads();
  for (int r = tid; r < R; r += THREADS) dA_part[(long long)c * H + g * R + r] = dAacc[r];
}

template <typename T, int P, int N>
int launch(const void* x, const float* dt, const float* A, const void* Bm, const float* gs,
           void* dx, void* dBm, float* ddt, float* dA_part, const long long* st, int C, int L,
           int H, int G, cudaStream_t stream) {
  const int smem = smem_bytes<P, N>(H / G, L);
  cudaError_t e = cudaFuncSetAttribute(ssd_bwd_kernel<T, P, N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ssd_bwd_kernel<T, P, N><<<dim3(C, G), THREADS, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), gs, static_cast<T*>(dx),
      static_cast<T*>(dBm), ddt, dA_part, L, H, st[0], st[1], st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const float* dt, const float* A, const void* Bm, const float* gs,
             void* dx, void* dBm, float* ddt, float* dA_part, const long long* st, int C, int L,
             int H, int P, int G, int N, cudaStream_t s) {
  if (P == 64 && N == 128)
    return launch<T, 64, 128>(x, dt, A, Bm, gs, dx, dBm, ddt, dA_part, st, C, L, H, G, s);
  if (P == 64 && N == 64)
    return launch<T, 64, 64>(x, dt, A, Bm, gs, dx, dBm, ddt, dA_part, st, C, L, H, G, s);
  if (P == 32 && N == 16)
    return launch<T, 32, 16>(x, dt, A, Bm, gs, dx, dBm, ddt, dA_part, st, C, L, H, G, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: x's (chunk, position, head) and Bm's (chunk, position, group)
// element strides, the last dim of each contiguous; dt (C, L, H) and the
// state's cotangent (C, H, P, N) float32 contiguous; dx (C, L, H, P) and
// dBm (C, L, G, N) contiguous in x's dtype, ddt (C, L, H) and dA_part (C,
// H) float32.  (P, N): (64, 128), (64, 64) or (32, 16).  Returns
// cudaGetLastError() after the launch.
extern "C" int ssd_chunk_state_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                                   const void* gs, void* dx, void* dBm, void* ddt, void* dA_part,
                                   const long long* strides, int C, int L, int H, int P, int G,
                                   int N, int is_bf16, void* stream) {
  if (C == 0 || L == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* g = static_cast<const float*>(gs);
  float* ddtf = static_cast<float*>(ddt);
  float* dAf = static_cast<float*>(dA_part);
  return is_bf16 ? dispatch<__nv_bfloat16>(x, dtf, Af, Bm, g, dx, dBm, ddtf, dAf, strides, C, L,
                                           H, P, G, N, s)
                 : dispatch<float>(x, dtf, Af, Bm, g, dx, dBm, ddtf, dAf, strides, C, L, H, P,
                                   G, N, s);
}

// the dynamic shared memory a block asks for at (P, N) with R heads a
// group over chunks of L positions (0 for widths it does not take):
// ssd_chunk.bwd_launch_plan states the same number
extern "C" int ssd_chunk_state_bwd_smem(int P, int N, int R, int L) {
  if (P == 64 && N == 128) return smem_bytes<64, 128>(R, L);
  if (P == 64 && N == 64) return smem_bytes<64, 64>(R, L);
  if (P == 32 && N == 16) return smem_bytes<32, 16>(R, L);
  return 0;
}
