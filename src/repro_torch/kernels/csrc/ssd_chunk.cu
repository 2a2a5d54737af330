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
// contiguous float32.  x and Bm are both bf16 or both float32.  Both
// routes take the prefix sum of dt*A in one order (prefix_sum) and use
// no atomics: bitwise repeatable.
//
// Bound.  2*L*P*N flops per (chunk, head) plus a few per position; x read
// once, Bm once per group, dt once, out written once.  At Mamba2-780m's
// prefill (32 chunks of 256, 48 heads of 64, N 128, G 1, bf16) that is
// 6.4 GFLOP against about 104 MB, half of it the float32 output: the
// memory rate bounds it (0.031 ms at 3.35 TB/s; 6.5 us of bf16
// tensor-core time).  In float32 the inputs double (about 157 MB, 0.047
// ms); the flops at the card's TF32 tensor-core rate (495 TFLOP/s) take
// 0.013 ms, so bytes bound it too (the CUDA-core kernel below runs them
// at the 67 TFLOP/s float32 rate, 0.096 ms, and cannot reach it).
//
// Two routes, chosen by dtype and shape (the wrapper's launch_plan says
// which):
//
// bf16 at P 64, N 64 or 128 and L <= 256 (Mamba2-780m's widths, and
// Zamba2-2.7B's N 64), the served path: ssd_state_wgmma_kernel<N>, on the
// tensor cores.  One product per (chunk, head), out (P x N) = A (P x L) B
// (L x N) with A = (w * x)^T and B = Bm, as one warpgroup's m64nN tile,
// the reduction over the chunk's L <= 256 positions in 16 k-steps of
// 16.  At Mamba2's widths the 3.2 G multiply-adds alone take about 0.1
// ms on the CUDA cores, three times the byte bound, so no CUDA-core
// design reaches it; the tensor cores take them in bf16.  The decay weight w_l runs along the reduction axis
// and has to be folded into x before the product, and rounding w*x once
// to bf16 misses the float32 bound of phase 8 (1e-4 of the largest
// output): 2.2e-3 of it in a CPU emulation at 4 chunks x 256, 8 heads x
// 64, N 128, G 1.  So w*x is split into hi = bf16(w*x) and lo = bf16(w*x
// - hi) (packed conversions, two values each), Bm is exact in bf16, and
// each k-step issues two wgmmas on the same B (1.1e-5 in the emulation).
// A block of 160 threads (a consumer warpgroup and a producer warp) owns
// one (chunk, group) and a run of its heads (at most 16, 32 at N 64, as
// many as shared memory holds the weights of, so that the grid (C, G,
// runs) fits in one wave wherever it can): the producer's one thread
// TMA-loads the chunk's whole Bm tile once (256 x N bf16, 64 KB at N
// 128: read once per block, not once per head) and each head's x tile
// (256 x 64 bf16, 32 KB) into a ring of 2 stages, through 4-d maps over
// the model's strided views, x as (P, H, L, C) and Bm as (N, G, L, C)
// (positions past L arrive as zeros).  Meanwhile the consumers take the
// weights of all the run's heads at once, a warp per head, so no head
// waits on dt's loads or on a barrier of its own.  Per head they split
// w*x in place (hi over the raw tile, lo beside: 128-byte rows, so a
// 16-byte unit's row is its position whatever the swizzle); both A parts
// and B are read MN-major (transposed: p and n contiguous), which bf16
// wgmma takes.  The output, half the traffic, leaves through shared
// memory (swizzled as the map expects) and one TMA store per 32 columns,
// not as scattered 8-byte stores, and the store's read overlaps the next
// head.  209 KB of shared memory at N 128 (177 KB at N 64): one block an
// SM, the grid (C, G, runs) about one block per SM.
//
// float32, and bf16 at any other width (P % 4 == 0, N % 8 == 0, any L:
// the reduced configs): ssd_state_kernel<T>, on the CUDA cores (no served
// cell runs float32, and both its operands would need splitting).  One
// block per (head, chunk), 256 threads.  Warp 0 takes the prefix sum and the block
// forms w in shared memory; then the (P x L) * (L x N) product streams L
// in tiles of 32 positions, staged in shared memory with x already scaled
// by w, each thread holding a 4 x 8 tile of the output in registers
// (columns 4j..4j+3 and N/2+4j..N/2+4j+3, so a quarter-warp's float4
// reads hit distinct banks).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// inclusive prefix sum of w[0 .. L) by one warp, in one fixed order: lane
// i sums its run of positions in order, then the runs are offset by a
// shuffle scan of their totals
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

// ---------------------------------------------------------------------------
// the CUDA-core kernel: float32, and bf16 off the tensor-core tile
// ---------------------------------------------------------------------------

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
  if (tid < 32) prefix_sum(w, L, tid);
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
int launch_cuda_core(const void* x, const float* dt, const float* A, const void* Bm, float* out,
                     const long long* st, int C, int L, int H, int P, int G, int N,
                     cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (2 * L + LT * (P + N));
  cudaError_t err = cudaFuncSetAttribute(ssd_state_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, C);
  ssd_state_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), out, L, H, P, N, H / G, st[0],
      st[1], st[2], st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int TC_P = 64;            // wgmma M: the head width P
constexpr int TC_L = 256;           // positions a chunk may have
constexpr int TC_THREADS = 160;     // a consumer warpgroup and a producer warp
constexpr int X_STAGES = 2;         // x tiles in flight
constexpr int X_BYTES = TC_L * TC_P * 2;     // one head's x tile: TC_L rows of 128 B
constexpr int BM_CHUNK = TC_L * 128;         // 64 columns of the chunk's Bm
constexpr int O_CHUNK = TC_P * 128;          // 32 columns of one head's output
// heads a block walks, at most: their weights fill the shared memory
// that N leaves (a grid of more blocks than SMs runs in two waves)
template <int N>
constexpr int W_HEADS = N == 64 ? 32 : 16;
// slack to align the base to 1024; Bm; the x ring (w*x hi in place); w*x
// lo; the output tile; the weights of the block's heads; barriers
template <int N>
constexpr int TC_SMEM = 1024 + (N / 64) * BM_CHUNK + X_STAGES * X_BYTES + X_BYTES +
                        (N / 32) * O_CHUNK + 4 * W_HEADS<N> * TC_L + 8 * (1 + 2 * X_STAGES);

// maps: x over (P, H, L, C) and Bm over (N, G, L, C) in bf16, boxes of 64
// x 1 x 256 x 1; out over (N, P, H, C) in float32, boxes of 32 x 64 x 1 x
// 1; all with 128-byte swizzle.  Block (c, g, run): heads g * rep + run *
// hpc + i for i < hpc that lie in group g.  N, the state width, is 64 or
// 128: the wgmma's N, in chunks of 64 columns.
template <int N>
__global__ void __launch_bounds__(TC_THREADS, 1)
ssd_state_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tb,
                       const __grid_constant__ CUtensorMap to, const float* __restrict__ dt,
                       const float* __restrict__ A, int L, int H, int rep, int hpc) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sB = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sX = sB + (N / 64) * BM_CHUNK;     // X_STAGES raw x tiles, then w*x hi
  uint8_t* sXl = sX + X_STAGES * X_BYTES;     // w*x lo
  uint8_t* sO = sXl + X_BYTES;                // the output tile
  float* w = reinterpret_cast<float*>(sO + (N / 32) * O_CHUNK);   // W_HEADS x TC_L
  uint64_t* full_b = reinterpret_cast<uint64_t*>(w + W_HEADS<N> * TC_L);
  uint64_t* full_x = full_b + 1;
  uint64_t* empty = full_x + X_STAGES;

  const int c = blockIdx.x;
  const int g = blockIdx.y;
  const int h0 = g * rep + blockIdx.z * hpc;
  const int nh = min(hpc, rep - (int)blockIdx.z * hpc);
  if (nh <= 0) return;

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_b, 1);
    for (int s = 0; s < X_STAGES; ++s) {
      hopper::mbar_init(full_x + s, 1);
      hopper::mbar_init(empty + s, 1);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warp: one thread issues every copy
    if (threadIdx.x == 128) {
      hopper::mbar_expect_tx(full_b, (N / 64) * BM_CHUNK);
      for (int k = 0; k < N / 64; ++k)
        hopper::tma_load_4d(sB + k * BM_CHUNK, &tb, full_b, 64 * k, g, 0, c);
      for (int i = 0; i < nh; ++i) {
        const int s = i % X_STAGES;
        hopper::mbar_wait(empty + s, ((i / X_STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(full_x + s, X_BYTES);
        hopper::tma_load_4d(sX + s * X_BYTES, &tx, full_x + s, 0, h0 + i, 0, c);
      }
    }
    return;
  }

  // the consumer warpgroup; a thread holds output rows (p) r and r + 8 of
  // its warp's 16, columns (n) 8 j + cq, + 1
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = (tid >> 5) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const float* dtc = dt + (long long)c * L * H;
  const uint32_t b_addr = hopper::smem_u32(sB), xl_addr = hopper::smem_u32(sXl);
  float acc[N / 2];

  // the weights of every head of the run at once, w_l = exp(cum_{L-1} -
  // cum_l) * dt_l (0 past L), while Bm and the first x tiles load: warp v
  // takes heads v, v + 4, ...  The prefix sum is prefix_sum's, in the same
  // order, but each lane keeps its run of dt in registers, so that its
  // loads are in flight together and dt is read once (through shared
  // memory, as prefix_sum takes it, the kernel was slower on an H100)
  {
    const int run = (L + 31) / 32;   // at most 8 positions a lane
    const int lo = min(L, lane * run), hi = min(L, lo + run);
    const int owner = (L - 1) / run;
    for (int j = tid >> 5; j < nh; j += 4) {
      const int h = h0 + j;
      const float a = A[h];
      float d[8], cum[8];
      float tot = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        d[k] = lo + k < hi ? dtc[(long long)(lo + k) * H + h] : 0.f;
        if (lo + k < hi) tot += d[k] * a;
        cum[k] = tot;
      }
      float incl = tot;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, s);
        if (lane >= s) incl += up;
      }
      const float before = incl - tot;
      const float last = __shfl_sync(0xffffffffu, tot + before, owner);
      float* wj = w + j * TC_L;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (lo + k < hi) wj[lo + k] = expf(last - (cum[k] + before)) * d[k];
      for (int l = L + lane; l < TC_L; l += 32) wj[l] = 0.f;
    }
  }
  hopper::named_barrier(1, 128);

  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i, s = i % X_STAGES;
    uint8_t* xs = sX + s * X_BYTES;

    // w*x: hi in place, lo beside; a 16-byte unit's row is its position
    const float* wi = w + i * TC_L;
    hopper::mbar_wait(full_x + s, (i / X_STAGES) & 1);
    for (int u = tid; u < X_BYTES / 16; u += 128) {
      const float wl = wi[u >> 3];
      const uint4 raw = *reinterpret_cast<const uint4*>(xs + 16 * u);
      const uint32_t* xv = reinterpret_cast<const uint32_t*>(&raw);
      uint32_t hv[4], lv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // bf16 to float32: the bits moved up by 16
        const float x0 = __uint_as_float(xv[e] << 16), x1 = __uint_as_float(xv[e] & 0xffff0000u);
        hopper::split_bf16x2(wl * x0, wl * x1, hv[e], lv[e]);
      }
      *reinterpret_cast<uint4*>(xs + 16 * u) = make_uint4(hv[0], hv[1], hv[2], hv[3]);
      *reinterpret_cast<uint4*>(sXl + 16 * u) = make_uint4(lv[0], lv[1], lv[2], lv[3]);
    }
    hopper::fence_proxy_async();
    hopper::named_barrier(1, 128);   // the split is written
    if (i == 0) hopper::mbar_wait(full_b, 0);

    // out = (w x)hi^T Bm + (w x)lo^T Bm over the positions in k-steps of
    // 16: A and B MN-major, one 128-byte chunk of A, N / 64 of B.  All 16
    // k-steps, unrolled (rows past L are zeros): a loop bound known only
    // at run time makes ptxas serialize the wgmmas
    const uint32_t xh_addr = hopper::smem_u32(xs);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < TC_L / 16; ++j) {
      const uint64_t ah = hopper::make_desc(xh_addr + j * 2048, X_BYTES, 1024, 128);
      const uint64_t al = hopper::make_desc(xl_addr + j * 2048, X_BYTES, 1024, 128);
      const uint64_t bd = hopper::make_desc(b_addr + j * 2048, BM_CHUNK, 1024, 128);
      if constexpr (N == 128) {
        hopper::wgmma_ss_n128_mn(acc, ah, bd, j > 0);
        hopper::wgmma_ss_n128_mn(acc, al, bd, 1);
      } else {
        hopper::wgmma_ss_n64_mn(acc, ah, bd, j > 0);
        hopper::wgmma_ss_n64_mn(acc, al, bd, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    // the previous head's output has left the tile (read by TMA), and
    // every warp's products are done with the stage and with w*x lo
    if (tid == 0) hopper::tma_store_wait_read();
    hopper::named_barrier(1, 128);
    if (tid == 0) hopper::mbar_arrive(empty + s);

    // epilogue: the output tile in 32-column chunks, swizzled as the map
    // expects, then one TMA store per chunk, read out while the next head
    // runs
#pragma unroll
    for (int jn = 0; jn < N / 8; ++jn) {
      const int n = 8 * jn + cq;
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int p = r + 8 * i2;
        *reinterpret_cast<float2*>(
            sO + hopper::swz<128>((n / 32) * O_CHUNK + p * 128 + (n % 32) * 4)) =
            make_float2(acc[4 * jn + 2 * i2], acc[4 * jn + 2 * i2 + 1]);
      }
    }
    hopper::fence_proxy_async();
    hopper::named_barrier(1, 128);
    if (tid == 0) {
      for (int k = 0; k < N / 32; ++k)
        hopper::tma_store_4d(&to, sO + k * O_CHUNK, 32 * k, 0, h, c);
      hopper::tma_store_commit();
    }
  }
  if (tid == 0) hopper::tma_store_wait_read();
}

template <int N>
int launch_wgmma(const void* x, const float* dt, const float* A, const void* Bm, float* out,
                 const long long* st, int C, int L, int H, int P, int G, cudaStream_t stream) {
  if (P != TC_P || L > TC_L) return (int)cudaErrorInvalidValue;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mx, mb, mo;
  const long long xd[4] = {P, H, L, C}, xs[3] = {st[2], st[1], st[0]};
  const long long bd[4] = {N, G, L, C}, bs[3] = {st[5], st[4], st[3]};
  const long long od[4] = {N, P, H, C}, os[3] = {N, (long long)P * N, (long long)H * P * N};
  const int in_box[4] = {64, 1, TC_L, 1}, out_box[4] = {32, TC_P, 1, 1};
  int err = hopper::make_map_4d(&mx, BF16, 2, x, xd, xs, in_box, 128);
  if (!err) err = hopper::make_map_4d(&mb, BF16, 2, Bm, bd, bs, in_box, 128);
  if (!err)
    err = hopper::make_map_4d(&mo, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, od, os, out_box, 128);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(ssd_state_wgmma_kernel<N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM<N>);
  if (e != cudaSuccess) return (int)e;
  // about one block per SM: each (chunk, group) splits its heads into runs
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int rep = H / G;
  int runs = max(1, min(rep, sms / max(1, C * G)));
  runs = max(runs, (rep + W_HEADS<N> - 1) / W_HEADS<N>);   // the weights fit in shared memory
  const int hpc = (rep + runs - 1) / runs;
  const dim3 grid(C, G, (rep + hpc - 1) / hpc);
  ssd_state_wgmma_kernel<N><<<grid, TC_THREADS, TC_SMEM<N>, stream>>>(mx, mb, mo, dt, A, L, H,
                                                                      rep, hpc);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 6 element strides, (chunk, position, head) of x then (chunk,
// position, group) of Bm.  is_bf16 selects bf16 x and Bm (else float32);
// tensor_cores the wgmma kernel (bf16 only: P 64, N 64 or 128, L <= 256,
// and TMA's alignment), else the CUDA-core kernel (P % 4 == 0, N % 8 ==
// 0).  The wrapper's launch_plan picks the route and checks its shapes.
// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue for
// a route that does not take the shape, or hopper::TENSOR_MAP_ERROR + a
// CUresult if a TMA map was refused.
extern "C" int ssd_chunk_state_fwd(const void* x, const float* dt, const float* A,
                                   const void* Bm, float* out, const long long* strides, int C,
                                   int L, int H, int P, int G, int N, int is_bf16,
                                   int tensor_cores, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 0 || H == 0 || L == 0) return 0;
  if (tensor_cores) {
    if (!is_bf16) return (int)cudaErrorInvalidValue;
    if (N == 128) return launch_wgmma<128>(x, dt, A, Bm, out, strides, C, L, H, P, G, s);
    if (N == 64) return launch_wgmma<64>(x, dt, A, Bm, out, strides, C, L, H, P, G, s);
    return (int)cudaErrorInvalidValue;
  }
  return is_bf16
             ? launch_cuda_core<__nv_bfloat16>(x, dt, A, Bm, out, strides, C, L, H, P, G, N, s)
             : launch_cuda_core<float>(x, dt, A, Bm, out, strides, C, L, H, P, G, N, s);
}

// the dynamic shared memory a tensor-core block asks for at state width N
// (0 for a width it does not take): launch_plan states the same number,
// and chip_smoke.py holds the two together
extern "C" int ssd_chunk_state_smem(int N) {
  return N == 128 ? TC_SMEM<128> : N == 64 ? TC_SMEM<64> : 0;
}
