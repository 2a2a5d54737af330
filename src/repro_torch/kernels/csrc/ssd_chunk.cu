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
// 0.013 ms a pass, 0.039 ms for the three passes below, so bytes bound it
// too (on the CUDA cores at the 67 TFLOP/s float32 rate they alone take
// 0.096 ms: no CUDA-core design reaches it).
//
// Three routes, chosen by dtype and shape (the wrapper's launch_plan
// says which):
//
// bf16 at P 64, N 64 or 128 and L <= 256 (Mamba2-780m's widths, and
// Zamba2-2.7B's N 64), the served path: ssd_state_wgmma_kernel<N>, on the
// tensor cores.  One product per (chunk, head), out (P x N) = A (P x L) B
// (L x N) with A = (w * x)^T and B = Bm, as one warpgroup's m64nN tile,
// the reduction over the chunk's L <= 256 positions in 16 k-steps of
// 16.  The decay weight w_l runs along the reduction axis
// and has to be folded into x before the product, and rounding w*x once
// to bf16 misses the float32 bound of phase 8 (1e-4 of the largest
// output): 2.2e-3 of it in a CPU emulation at 4 chunks x 256, 8 heads x
// 64, N 128, G 1.  So w*x is split into hi = bf16(w*x) and lo = bf16(w*x
// - hi) (packed conversions, two values each), Bm is exact in bf16, and
// each k-step issues two wgmmas on the same B (1.1e-5 in the emulation).
// float32 at the same widths (phase 10's float32 prefill, phase 15's
// cut): ssd_state_tf32_kernel, on the tensor cores in TF32.  One TF32
// pass misses the float32 bound (4.1e-4 of the largest output in a CPU
// emulation at 4 chunks x 256, 8 heads x 64, N 128, G 1), so A = (w*x)^T,
// formed in float32, and B = Bm are each split into hi = tf32(v) and lo =
// tf32(v - hi) (hopper::split_tf32, as K7's float32 route does) and each
// k-step of 8 positions issues three products, Ah Bh + Ah Bl + Al Bh
// (1.4e-5 of it in the emulation; 1.2e-7 against the exact product of
// the same float32 w*x: the float32 prefix sums of dt*A set the floor,
// not the split).  What the design does about TF32 wgmma's three
// constraints:
//   - shared-memory operands are K-major only, and both arrive MN-major
//     (x as (L, P), p contiguous; Bm as (L, N), n contiguous).  A comes
//     from registers instead (wgmma_tf32_rs_n64): each consumer thread
//     reads the elements of its fragment out of the TMA-landed raw x slab,
//     scales them by w_l and splits them in registers, so x is never
//     copied.  B is Bm^T hi and lo, written K-major (positions
//     contiguous) once per block by the consumers' split pass and shared
//     by the block's run of heads, as the bf16 kernel shares its Bm tile;
//   - the fragment's k-slots: a thread holds k-slots t and t + 4 of each
//     k-step of 8; k-slot k holds position 2 k for k < 4 and 2 (k - 4) + 1
//     after (Bm^T's rows are written in that order), so a thread reads
//     positions 2 t and 2 t + 1 of its two rows, and with TMA's 128-byte
//     swizzle (the 16-byte unit XORed with the position mod 8) a warp's
//     32 reads of one register hit 32 different banks;
//   - shared memory: Bm^T hi + lo at N 128 and L 256 alone would be 256
//     KB.  A block takes 64 state columns (N / 64 blocks a chunk, side by
//     side in the grid, so the chunk's x slabs come from L2 for the
//     second), so Bm^T hi + lo is 128 KB; x arrives in a ring of four
//     64-position slabs (64 KB, one chunk of a head: the stage is free as
//     soon as its fragments are in registers); the weights of up to 32
//     heads, 32 KB; barriers.  230464 bytes (TF_SMEM).  The output leaves
//     from the accumulator registers as 8-byte stores, each 32-byte
//     sector whole.
// A block of 160 threads (a consumer warpgroup and a producer warp whose
// one thread issues the TMA loads) owns one (chunk, column block, group)
// and a run of the group's heads; per head, the fragments of a slab are
// split into one of two register buffers while the previous slab's 24
// wgmmas run (wgmma.wait_group 1 before a buffer is reused), and a
// head's slab 0 while the previous head's last slab's do.  Every head
// takes all four slabs, zeros past L included: the consumers' path has
// no branch (fragments defined on a divergent path made ptxas serialize
// all 96 wgmmas of a head, 0.18 ms at Mamba2's widths on an H100).
//
// float32, and bf16, at any other width (P % 4 == 0, N % 8 == 0, any L:
// the reduced configs): ssd_state_kernel<T>, on the CUDA cores, each
// dtype counted apart.  One
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

// the decay weights of heads h0 .. h0 + nh - 1 (nh <= 4 * RUN_HEADS) of
// one chunk (dtc: the chunk's dt) into w, TC_L floats a head, w_l =
// exp(cum_{L-1} - cum_l) * dt_l and 0 past L, by a consumer warpgroup:
// warp v takes heads v, v + 4, ...  The prefix sum is prefix_sum's, in
// the same order, but each lane keeps its run of dt in registers, and a
// warp issues the loads of all its heads' runs before any sum, so that
// they are in flight together and dt is read once (through shared
// memory, as prefix_sum takes it, the kernel was slower on an H100)
constexpr int RUN_HEADS = 8;   // heads a warp takes, at most
__device__ __forceinline__ void run_weights(float* w, const float* __restrict__ dtc,
                                            const float* __restrict__ A, int L, int H, int h0,
                                            int nh, int tid) {
  const int lane = tid & 31;
  const int run = (L + 31) / 32;   // at most 8 positions a lane
  const int lo = min(L, lane * run), hi = min(L, lo + run);
  const int owner = (L - 1) / run;
  float d[RUN_HEADS][8], a[RUN_HEADS];
#pragma unroll
  for (int jj = 0; jj < RUN_HEADS; ++jj) {
    const int j = (tid >> 5) + 4 * jj;
    a[jj] = j < nh ? A[h0 + j] : 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      d[jj][k] = j < nh && lo + k < hi ? dtc[(long long)(lo + k) * H + h0 + j] : 0.f;
  }
#pragma unroll
  for (int jj = 0; jj < RUN_HEADS; ++jj) {
    const int j = (tid >> 5) + 4 * jj;
    if (j >= nh) break;   // warp-uniform
    float cum[8];
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (lo + k < hi) tot += d[jj][k] * a[jj];
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
      if (lo + k < hi) wj[lo + k] = expf(last - (cum[k] + before)) * d[jj][k];
    for (int l = L + lane; l < TC_L; l += 32) wj[l] = 0.f;
  }
}

static_assert(W_HEADS<64> <= 4 * RUN_HEADS && W_HEADS<128> <= 4 * RUN_HEADS,
              "run_weights takes every head of a block");

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

  // the weights of every head of the run, while Bm and the first x tiles
  // load
  run_weights(w, dtc, A, L, H, h0, nh, tid);
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

// ---------------------------------------------------------------------------
// float32: the TF32 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int TF_NB = 64;                      // state columns (n) a block takes
constexpr int TF_SLAB = 64;                    // positions a slab of x
constexpr int TF_STAGES = TC_L / TF_SLAB;      // slabs in flight: a whole chunk of x
constexpr int TF_XCHUNK = TF_SLAB * 128;       // 32 columns (p) of a slab, 128-byte rows
constexpr int TF_SLAB_BYTES = 2 * TF_XCHUNK;   // 64 x 64 float32
constexpr int TF_BT_CHUNK = TF_NB * 128;       // 32 positions of Bm^T's TF_NB rows
constexpr int TF_BT_BYTES = TC_L * TF_NB * 4;  // Bm^T hi (or lo): TF_NB x TC_L
constexpr int TF_HEADS = 32;                   // heads a block walks, at most
static_assert(TF_HEADS <= 4 * RUN_HEADS, "run_weights takes every head of a block");
// slack to align the base to 1024; Bm^T hi and lo; the x ring; the
// weights of the block's heads; barriers.  1024 + 131072 + 65536 + 32768
// + 64 = 230464 bytes of the 232448 a block may have
constexpr int TF_SMEM = 1024 + 2 * TF_BT_BYTES + TF_STAGES * TF_SLAB_BYTES +
                        4 * TF_HEADS * TC_L + 8 * 2 * TF_STAGES;

// A = (w x)^T of one x slab as the TF32 A fragments of its 8 k-steps,
// hi and lo: the fragment's (row, k-slot) pairs (r, t), (r + 8, t), (r,
// t + 4), (r + 8, t + 4) of k-step kk hold positions l, l, l + 1, l + 1,
// l = 8 kk + 2 t; xo holds the four reads' swizzled offsets at kk = 0 and
// wt points at w_{2 t} of the slab.  A warp's 32 reads of one register hit
// 32 banks (the swizzle XORs the 16-byte unit with l % 8 = 2 t or 2 t + 1)
__device__ __forceinline__ void split_slab(const uint8_t* xs, const float* wt,
                                           const uint32_t (&xo)[4], uint32_t (&ah)[8][4],
                                           uint32_t (&al)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const float2 wl = *reinterpret_cast<const float2*>(wt + 8 * kk);
    const uint8_t* row = xs + kk * 1024;
    hopper::split_tf32(wl.x * *reinterpret_cast<const float*>(row + xo[0]), ah[kk][0], al[kk][0]);
    hopper::split_tf32(wl.x * *reinterpret_cast<const float*>(row + xo[1]), ah[kk][1], al[kk][1]);
    hopper::split_tf32(wl.y * *reinterpret_cast<const float*>(row + xo[2]), ah[kk][2], al[kk][2]);
    hopper::split_tf32(wl.y * *reinterpret_cast<const float*>(row + xo[3]), ah[kk][3], al[kk][3]);
  }
}

// map: x over (P, H, L, C) in float32, boxes of 32 x 1 x 64 x 1, 128-byte
// swizzle.  Bm is read through its strides (bc, bl, bg) with plain loads.
// Block (c * nb + k, g, run) takes state columns 64 k .. 64 k + 63 of
// heads g * rep + run * hpc + i, i < hpc, that lie in group g; the nb
// blocks of one chunk run side by side and read its x tiles from L2.
__global__ void __launch_bounds__(TC_THREADS, 1)
ssd_state_tf32_kernel(const __grid_constant__ CUtensorMap tx, const float* __restrict__ Bm,
                      const float* __restrict__ dt, const float* __restrict__ A,
                      float* __restrict__ out, int L, int H, int N, int rep, int hpc, int nb,
                      long long bc, long long bl, long long bg) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sBh = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sBl = sBh + TF_BT_BYTES;
  uint8_t* sX = sBl + TF_BT_BYTES;                   // TF_STAGES raw x slabs
  float* w = reinterpret_cast<float*>(sX + TF_STAGES * TF_SLAB_BYTES);   // TF_HEADS x TC_L
  uint64_t* full = reinterpret_cast<uint64_t*>(w + TF_HEADS * TC_L);
  uint64_t* empty = full + TF_STAGES;

  const int c = blockIdx.x / nb;
  const int n0 = (blockIdx.x % nb) * TF_NB;
  const int g = blockIdx.y;
  const int h0 = g * rep + blockIdx.z * hpc;
  const int nh = min(hpc, rep - (int)blockIdx.z * hpc);
  if (nh <= 0) return;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TF_STAGES; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 4);   // one arrival per consumer warp
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer warp: one thread issues every copy, the slabs of the
    // block's heads in turn through the ring; every head takes all
    // TF_STAGES slabs (a slab past L arrives as zeros), so that the
    // consumers' path has no branch on L
    if (threadIdx.x == 128) {
      for (int i = 0, q = 0; i < nh; ++i)
        for (int s = 0; s < TF_STAGES; ++s, ++q) {
          const int st = s;   // q % TF_STAGES
          uint8_t* xs = sX + st * TF_SLAB_BYTES;
          hopper::mbar_wait(empty + st, ((q / TF_STAGES) & 1) ^ 1);
          hopper::mbar_expect_tx(full + st, TF_SLAB_BYTES);
          hopper::tma_load_4d(xs, &tx, full + st, 0, h0 + i, s * TF_SLAB, c);
          hopper::tma_load_4d(xs + TF_XCHUNK, &tx, full + st, 32, h0 + i, s * TF_SLAB, c);
        }
      // the consumers split a next head's slab 0 after each head, the
      // last one's too (unused): a copy of the last head's
      hopper::mbar_wait(empty, (nh & 1) ^ 1);
      hopper::mbar_expect_tx(full, TF_SLAB_BYTES);
      hopper::tma_load_4d(sX, &tx, full, 0, h0 + nh - 1, 0, c);
      hopper::tma_load_4d(sX + TF_XCHUNK, &tx, full, 32, h0 + nh - 1, 0, c);
    }
    return;
  }

  // the consumer warpgroup; a thread holds output rows (p) r and r + 8 of
  // its warp's 16, columns (n) 8 j + cq, + 1, and takes k-slots t and t + 4
  // of each k-step of A
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = (tid >> 5) * 16 + (lane >> 2);
  const int t = lane & 3;
  const int cq = 2 * t;

  run_weights(w, dt + (long long)c * L * H, A, L, H, h0, nh, tid);

  // Bm^T hi and lo, K-major (positions contiguous, 128-byte swizzle), for
  // the block's 64 columns, once for all its heads.  Item (n, u) takes
  // positions p0 + {0, 2, 4, 6}, p0 = 8 (u / 2) + u % 2, to k-slots 4 u ..
  // 4 u + 3 of row n: k-slot k of each 8 holds position 2 k for k < 4 and
  // 2 (k - 4) + 1 after, the order in which A's fragments take them
  {
    const float* bb = Bm + c * bc + g * bg + n0;
    constexpr int ITEMS = TF_NB * TC_L / 4 / 128;   // 32 a thread
    constexpr int BATCH = 16;                       // their loads in flight
#pragma unroll 1
    for (int k0 = 0; k0 < ITEMS; k0 += BATCH) {
      float4 v[BATCH];
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int it = tid + 128 * (k0 + k);
        const int n = it % TF_NB, u = it / TF_NB;
        const int p0 = 8 * (u >> 1) + (u & 1);
        float e[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int l = p0 + 2 * m;
          e[m] = l < L ? bb[l * bl + n] : 0.f;
        }
        v[k] = make_float4(e[0], e[1], e[2], e[3]);
      }
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int it = tid + 128 * (k0 + k);
        const int n = it % TF_NB, u = it / TF_NB;
        uint4 hi, lo;
        hopper::split_tf32(v[k].x, hi.x, lo.x);
        hopper::split_tf32(v[k].y, hi.y, lo.y);
        hopper::split_tf32(v[k].z, hi.z, lo.z);
        hopper::split_tf32(v[k].w, hi.w, lo.w);
        const uint32_t at = hopper::swz<128>((4 * u / 32) * TF_BT_CHUNK + n * 128 + (4 * u % 32) * 4);
        *reinterpret_cast<uint4*>(sBh + at) = hi;
        *reinterpret_cast<uint4*>(sBl + at) = lo;
      }
    }
  }
  hopper::fence_proxy_async();
  hopper::named_barrier(1, 128);   // Bm^T and the weights are written

  const uint32_t bh_addr = hopper::smem_u32(sBh), bl_addr = hopper::smem_u32(sBl);
  // this thread's four reads of a slab at k-step 0 (positions 2 t and 2 t
  // + 1, columns r and r + 8), swizzled; k-step kk lies 8 rows (1024
  // bytes) on, which the swizzle leaves alone (it XORs the 16-byte unit
  // with the row mod 8)
  const uint32_t c0 = (r / 32) * TF_XCHUNK + (r % 32) * 4;
  const uint32_t c1 = ((r + 8) / 32) * TF_XCHUNK + ((r + 8) % 32) * 4;
  const uint32_t xo[4] = {hopper::swz<128>(c0 + 2 * t * 128), hopper::swz<128>(c1 + 2 * t * 128),
                          hopper::swz<128>(c0 + (2 * t + 1) * 128),
                          hopper::swz<128>(c1 + (2 * t + 1) * 128)};
  float acc[TF_NB / 2];
  // the A fragments of a slab's 8 k-steps, hi and lo, in two buffers:
  // a slab's splits run while the previous slab's products do
  uint32_t ah[2][8][4], al[2][8][4];

  // the first head's slab 0; each later head's is split while the
  // previous head's last products run
  hopper::mbar_wait(full, 0);
  split_slab(sX, w + 2 * t, xo, ah[0], al[0]);

  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i;
    const float* wi = w + i * TC_L + 2 * t;
#pragma unroll
    for (int x = 0; x < TF_NB / 2; ++x) acc[x] = 0.f;

    // all TF_STAGES slabs, unrolled and without a branch: a loop bound
    // known only at run time, or fragments defined on a divergent path,
    // make ptxas serialize the wgmmas.  Head i's slab s lands in stage s.
#pragma unroll
    for (int s = 0; s < TF_STAGES; ++s) {
      const int b = s & 1;
      if (s > 0) {
        // the products of slab s - 2 are done with buffer b
        if (s >= 2) hopper::wgmma_wait<1>();
        hopper::mbar_wait(full + s, i & 1);
        split_slab(sX + s * TF_SLAB_BYTES, wi + s * TF_SLAB, xo, ah[b], al[b]);
      }

      // out += Ah Bh + Ah Bl + Al Bh over the slab's 8 k-steps (acc is
      // not fenced here: the previous slab's products are still writing
      // it, and a copy of it would make ptxas serialize the wgmmas)
      hopper::fence_regs(ah[b]);
      hopper::fence_regs(al[b]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int ks = 8 * s + kk;   // k-step of the chunk
        const uint32_t at = (ks / 4) * TF_BT_CHUNK + (ks % 4) * 32;
        const uint64_t bh = hopper::make_desc(bh_addr + at, 16, 1024, 128);
        const uint64_t bl = hopper::make_desc(bl_addr + at, 16, 1024, 128);
        hopper::wgmma_tf32_rs_n64(acc, ah[b][kk], bh);
        hopper::wgmma_tf32_rs_n64(acc, ah[b][kk], bl);
        hopper::wgmma_tf32_rs_n64(acc, al[b][kk], bh);
      }
      hopper::wgmma_commit();
      // this warp's reads of the slab are done (its fragments are in
      // registers): once every warp says so, the stage takes the next
      // head's slab
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty + s);
    }
    // the next head's slab 0 into buffer 0 once slab 2's products are
    // done, while slab 3's run (after the last head, the producer's copy,
    // never multiplied)
    hopper::wgmma_wait<1>();
    hopper::mbar_wait(full, (i + 1) & 1);
    split_slab(sX, w + min(i + 1, nh - 1) * TC_L + 2 * t, xo, ah[0], al[0]);
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);

    // epilogue: straight to device memory, each row's 8 bytes a thread
    // filling 32-byte sectors
    float* ob = out + ((long long)c * H + h) * TC_P * N + n0;
#pragma unroll
    for (int jn = 0; jn < TF_NB / 8; ++jn) {
      const int n = 8 * jn + cq;
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2)
        *reinterpret_cast<float2*>(ob + (long long)(r + 8 * i2) * N + n) =
            make_float2(acc[4 * jn + 2 * i2], acc[4 * jn + 2 * i2 + 1]);
    }
  }
}

int launch_tf32(const void* x, const float* dt, const float* A, const void* Bm, float* out,
                const long long* st, int C, int L, int H, int P, int G, int N,
                cudaStream_t stream) {
  if (P != TC_P || L > TC_L || N % TF_NB) return (int)cudaErrorInvalidValue;
  CUtensorMap mx;
  const long long xd[4] = {P, H, L, C}, xs[3] = {st[2], st[1], st[0]};
  const int box[4] = {32, 1, TF_SLAB, 1};
  const int err =
      hopper::make_map_4d(&mx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, xd, xs, box, 128);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(ssd_state_tf32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, TF_SMEM);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // about one block per SM: each (chunk, column block, group) splits its
  // heads into runs of at most TF_HEADS
  const int rep = H / G, nb = N / TF_NB;
  int runs = max(1, min(rep, sms / max(1, C * nb * G)));
  runs = max(runs, (rep + TF_HEADS - 1) / TF_HEADS);
  const int hpc = (rep + runs - 1) / runs;
  const dim3 grid(C * nb, G, (rep + hpc - 1) / hpc);
  ssd_state_tf32_kernel<<<grid, TC_THREADS, TF_SMEM, stream>>>(
      mx, static_cast<const float*>(Bm), dt, A, out, L, H, N, rep, hpc, nb, st[3], st[4], st[5]);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 6 element strides, (chunk, position, head) of x then (chunk,
// position, group) of Bm.  is_bf16 selects bf16 x and Bm (else float32);
// tensor_cores the tensor-core kernel of that dtype (P 64, N 64 or 128, L
// <= 256, and TMA's alignment of x, and in bf16 of Bm), else the
// CUDA-core kernel (P % 4 == 0, N % 8 == 0).  The wrapper's launch_plan picks the route and checks its shapes.
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
    if (!is_bf16) return launch_tf32(x, dt, A, Bm, out, strides, C, L, H, P, G, N, s);
    if (N == 128) return launch_wgmma<128>(x, dt, A, Bm, out, strides, C, L, H, P, G, s);
    if (N == 64) return launch_wgmma<64>(x, dt, A, Bm, out, strides, C, L, H, P, G, s);
    return (int)cudaErrorInvalidValue;
  }
  return is_bf16
             ? launch_cuda_core<__nv_bfloat16>(x, dt, A, Bm, out, strides, C, L, H, P, G, N, s)
             : launch_cuda_core<float>(x, dt, A, Bm, out, strides, C, L, H, P, G, N, s);
}

// the dynamic shared memory a tensor-core block asks for at state width N
// in bf16 or float32 (0 for a width the route does not take): launch_plan
// states the same number, and chip_smoke.py holds the two together
extern "C" int ssd_chunk_state_smem(int N, int is_bf16) {
  if (!is_bf16) return N == 64 || N == 128 ? TF_SMEM : 0;
  return N == 128 ? TC_SMEM<128> : N == 64 ? TC_SMEM<64> : 0;
}
