// Mamba2 SSD per-chunk state for Hopper (sm_90a).
//
// K8  ssd_chunk_state   for chunk c and head h (group g = h / (H/G)):
//       cum_l = sum_{i<=l} dt[c,i,h] * A[h]                (in order, float32)
//       w_l   = exp(cum_{L-1} - cum_l) * dt[c,l,h]
//       out[c,h,p,n] = sum_l w_l * x[c,l,h,p] * Bm[c,l,g,n]   (float32)
//     Replaces src/repro/kernels/ssd_chunk.py:42 (ssd_chunk_state_pallas,
//     whose pallas_call is at :55; kernel body _kernel :22), the
//     "chunk state" step of the SSD algorithm (arXiv:2405.21060); the
//     reference's model computes the same einsum in XLA
//     (src/repro/models/transformer/ssm.py:107-110).  Forward only.
//
// x and Bm are read through their strides (chunk, position, head or
// group; the last dim contiguous), so the model passes the (B*nc, L, H,
// P) and (B*nc, L, G, N) views of its conv output without a copy; the
// group of a head is an index, never a repeated copy of Bm.  dt is
// (chunks, L, H) contiguous float32, A (H,) float32, out (chunks, H, P, N)
// contiguous float32.  x and Bm are both bf16 or both float32.
//
// Bound.  2*L*P*N flops per (chunk, head) plus a few per position; x read
// once, Bm once per group, dt once, out written once.  At Mamba2-780m's
// prefill (32 chunks of 256, 48 heads of 64, N 128, G 1, bf16) that is
// 6.4 GFLOP against about 104 MB: the memory rate bounds it (0.03 ms at
// 3.35 TB/s; 6.5 us of bf16 tensor-core time).  What the design does:
// one block per (head, chunk), 256 threads.  Warp 0 takes the prefix sum
// of dt*A over the chunk (each lane a contiguous run, then a shuffle scan
// of the 32 run totals) and the block forms w in shared memory; then the
// (P x L) * (L x N) product streams L in tiles of 32 positions, staged in
// shared memory as float32 with x already scaled by w, each thread
// holding a 4 x 8 tile of the output in registers (columns 4j..4j+3 and
// N/2+4j..N/2+4j+3, so a quarter-warp's float4 reads hit distinct banks).
// No atomics: bitwise repeatable.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int LT = 32;               // positions per staged tile
constexpr int TP = 4;                // output rows (p) per thread
constexpr int TN = 8;                // output columns (n) per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm, float* __restrict__ out,
                 int L, int H, int P, int N, int rep, long long xc, long long xl, long long xh,
                 long long bc, long long bl, long long bg) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // LT x P: w_l * x[l, p]
  float* bs = xs + LT * P;                      // LT x N: Bm[l, n]
  float* w = bs + LT * N;                       // L: dt*A, then the prefix sum, then w
  float* dts = w + L;                           // L: dt

  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const int g = h / rep;
  const int tid = threadIdx.x;
  const float a = A[h];
  const float* dtc = dt + (long long)c * L * H + h;
  for (int l = tid; l < L; l += THREADS) {
    const float d = dtc[(long long)l * H];
    dts[l] = d;
    w[l] = d * a;
  }
  __syncthreads();
  if (tid < 32) {
    // inclusive prefix sum: lane i sums its run in order, then the runs
    // are offset by a shuffle scan of their totals
    const int run = (L + 31) / 32;
    const int lo = min(L, tid * run), hi = min(L, lo + run);
    float tot = 0.f;
    for (int l = lo; l < hi; ++l) {
      tot += w[l];
      w[l] = tot;
    }
    float incl = tot;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, s);
      if (tid >= s) incl += up;
    }
    const float before = incl - tot;
    for (int l = lo; l < hi; ++l) w[l] += before;
  }
  __syncthreads();
  const float last = w[L - 1];
  __syncthreads();
  for (int l = tid; l < L; l += THREADS) w[l] = expf(last - w[l]) * dts[l];

  const T* xb = x + c * xc + h * xh;
  const T* bb = Bm + c * bc + g * bg;
  const int tiles_n = N / TN;
  const int tiles = (P / TP) * tiles_n;
  float* ob = out + ((long long)c * H + h) * P * N;

  for (int t0 = 0; t0 < tiles; t0 += THREADS) {
    const int tile = t0 + tid;
    const bool mine = tile < tiles;
    const int p0 = mine ? (tile / tiles_n) * TP : 0;
    const int n0 = mine ? (tile % tiles_n) * (TN / 2) : 0;
    float acc[TP][TN];
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int l0 = 0; l0 < L; l0 += LT) {
      const int lt = min(LT, L - l0);
      __syncthreads();   // w is written; the previous tile's reads are done
      for (int i = tid; i < lt * P; i += THREADS) {
        const int r = i / P, p = i - r * P;
        xs[i] = w[l0 + r] * to_f(xb[(l0 + r) * xl + p]);
      }
      for (int i = tid; i < lt * N; i += THREADS) {
        const int r = i / N, n = i - r * N;
        bs[i] = to_f(bb[(l0 + r) * bl + n]);
      }
      __syncthreads();
      if (mine) {
        for (int r = 0; r < lt; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + r * P + p0);
          const float4 b0 = *reinterpret_cast<const float4*>(bs + r * N + n0);
          const float4 b1 = *reinterpret_cast<const float4*>(bs + r * N + N / 2 + n0);
          const float xr[TP] = {xv.x, xv.y, xv.z, xv.w};
          const float br[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < TP; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] += xr[i] * br[j];
        }
      }
    }
    if (mine) {
#pragma unroll
      for (int i = 0; i < TP; ++i) {
        float* row = ob + (long long)(p0 + i) * N;
        *reinterpret_cast<float4*>(row + n0) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(row + N / 2 + n0) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm, float* out,
           const long long* st, int C, int L, int H, int P, int G, int N,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (2 * L + LT * (P + N));
  cudaError_t err = cudaFuncSetAttribute(ssd_state_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, C);
  ssd_state_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), out, L, H, P, N, H / G,
      st[0], st[1], st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 6 element strides, (chunk, position, head) of x then (chunk,
// position, group) of Bm.  P % 4 == 0 and N % 8 == 0 (the wrapper
// checks).  is_bf16 selects bf16 x and Bm (else float32).  Returns
// cudaGetLastError() after the launch.
extern "C" int ssd_chunk_state_fwd(const void* x, const float* dt, const float* A,
                                   const void* Bm, float* out, const long long* strides, int C,
                                   int L, int H, int P, int G, int N, int is_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 0 || H == 0 || L == 0) return 0;
  return is_bf16 ? launch<__nv_bfloat16>(x, dt, A, Bm, out, strides, C, L, H, P, G, N, s)
                 : launch<float>(x, dt, A, Bm, out, strides, C, L, H, P, G, N, s);
}
