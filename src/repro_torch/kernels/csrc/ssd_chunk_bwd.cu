// K8's VJP: the backward of the Mamba2 SSD chunk state (ssd_chunk.cu) for
// Hopper (sm_90a).
//
// The forward: state[c,h,p,n] = sum_l w_l x[c,l,h,p] Bm[c,l,g,n] with
// g = h / (H/G), w_l = exp(cumA_L - cumA_l) dt_l and cumA the running sum
// of dt * A[h] over the chunk's positions.  Given G = d state (C, H, P, N)
// float32, with u[l,p] = sum_n G[h,p,n] Bm[l,g,n] and v[l,n] = sum_p
// x[l,h,p] G[h,p,n]:
//       dx[l,h,p]   = w_l u[l,p]
//       dBm[l,g,n]  = sum_{h in g} w_l v[l,n]
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
// Two kernels, launched in this order on one stream:
//   the tile kernel, one block per (64-position tile, chunk, run of RB
//     heads of one group): the products u and v of its heads at its
//     positions, in head order.  It writes dx; dw * w and dw * e (e_l =
//     exp(cumA_L - cumA_l)) a position and head, (C, L, H) float32
//     scratch; and its run's part of dBm, sum over the run's heads of w v,
//     held in registers across them, as (C, G, runs, L, N) float32
//     scratch.  Each block first takes the running sums of dt * A of its
//     heads over the whole chunk, in the forward's order (lanes sum runs
//     of positions in order, a shuffle scan offsets them).
//   ssd_bwd_scan_kernel: blocks of 4 warps, a warp per (chunk, head), take
//     the exclusive prefix of dw * w over the chunk in one fixed order
//     (lanes' runs, then a shuffle scan) and write ddt and the chunk's dA
//     partial (C, H), which the caller sums over chunks; then a thread per
//     4 elements of dBm sums the runs' parts in run order and writes dBm
//     in x's dtype.
// No float atomics: bitwise repeatable.  The grid of the tile kernel is
// what the old (chunk, group) grid lacked: at Mamba2-780m's training batch
// (2 x 1024, chunks of 256, 48 heads, G 1) RB = 6 gives 4 x 8 x 8 = 256
// blocks on 132 SMs (two a SM), where a (chunk, group) grid had 8.  The
// wrapper (bwd_launch_plan) picks RB and passes it.
//
// The tile kernel, at P 64 and N 64 or 128 (Mamba2-780m, Zamba2-2.7B):
// ssd_bwd_wgmma_kernel<T, N>, one warpgroup on the tensor cores.
//   u (64 positions x P) = Bm G_h^T: A = the Bm tile, B = G_h, both
//     K-major over n in shared memory (wgmma m64n64k16, N / 16 k-steps);
//   v (64 positions x N) = x G_h: A = x's bf16 fragments in registers,
//     read straight from device memory, B = G_h MN-major (the same tile:
//     rows p, n contiguous; wgmma m64nNk16, P / 16 k-steps).
//   G is float32: one rounding to bf16 misses the 1e-4 bound on ddt and
//   dA (2.3e-3 of the largest ddt and 3.9e-4 of dA against jax.vjp in a
//   CPU emulation at 2 chunks of 256, 8 x 64, N 128:
//   tests/test_torch_attention_bwd.py), so G_h is split in shared memory
//   into bf16 hi + lo (hopper::split_bf16x2, as K8's forward splits w x)
//   and each product takes both parts on the same A (at most 1.6e-5 of
//   any gradient's largest value in the emulation).  bf16 x and Bm are
//   exact.  float32 x and Bm are split the same way (Bm in shared memory,
//   x in registers) and each product takes three passes, hi hi + hi lo +
//   lo hi (the dropped lo lo term is 2^-18 relative; 1.6e-5 in the
//   emulation): the float32 route runs on the bf16 tensor cores too, with
//   no TF32 layout constraint (TF32 wgmma takes K-major operands only,
//   and v's B operand is MN-major).  dx = w u and dw = sum_p x u come out
//   of u's accumulator fragment (whose (row, column) pairs are x's
//   fragment's), dBm's part out of v's.
// At the reduced configs' P 32, N 16 (and any P % 4 == 0, N % 4 == 0):
// ssd_bwd_cuda_core_kernel<T, P, N>, the same decomposition on the CUDA
// cores (256 threads, 4 a position; u and v from float32 tiles in shared
// memory).
//
// Bound: 4 C H L P N flops (u and v) against x, Bm, dt, G read once and
// dx, dBm, ddt, dA written once.  At Mamba2-780m's training shape (8
// chunks of 256, 48 x 64, N 128, bf16) that is 3.2 GFLOP (3.3 us at the
// bf16 peak) against about 40 MB (11.8 us at 3.35 TB/s): bound by bytes.
// The split doubles the MMA work (triples it in float32), G is read by
// each of a chunk's 4 tiles (from L2 after the first), and the scratch
// adds (C, L, H) twice and (C, G, runs, L, N) once.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int TL = 64;   // positions a tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// the decay weights w_l and e_l = exp(cumA_L - cumA_l) of the block's nh
// heads h0 .. h0 + nh - 1 at positions l0 .. l0 + TL - 1 (0 past L) into
// sw and se, TL floats a head, by `warps` warps (warp v takes heads v, v +
// warps, ...).  The running sums go in the forward's order (ssd_chunk.cu's
// run_weights and prefix_sum): lane i sums its run of positions in order,
// a shuffle scan offsets the runs.  A lane loads its run in batches of 8
// positions, every load of a batch before its sums (dt is strided by H:
// loads one after another would wait for each other), and keeps the first
// batch (the whole run up to L 256) for the second pass
__device__ __forceinline__ void tile_weights(float* sw, float* se, const float* __restrict__ dtc,
                                             const float* __restrict__ A, int L, int H, int h0,
                                             int nh, int l0, int warp, int warps, int lane) {
  const int run = (L + 31) / 32;
  const int lo = min(L, lane * run), hi = min(L, lo + run);
  const int owner = (L - 1) / run;
  for (int j = warp; j < nh; j += warps) {
    const int h = h0 + j;
    const float a = A[h];
    float d0[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) d0[k] = lo + k < hi ? dtc[(long long)(lo + k) * H + h] : 0.f;
    float tot = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (lo + k < hi) tot += d0[k] * a;
    for (int l1 = lo + 8; l1 < hi; l1 += 8) {
      float d[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) d[k] = l1 + k < hi ? dtc[(long long)(l1 + k) * H + h] : 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (l1 + k < hi) tot += d[k] * a;
    }
    float incl = tot;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += up;
    }
    const float before = incl - tot;
    const float last = __shfl_sync(0xffffffffu, tot + before, owner);
    for (int i = lane; i < TL; i += 32) {
      sw[j * TL + i] = 0.f;
      se[j * TL + i] = 0.f;
    }
    __syncwarp();
    float cum = 0.f;
    for (int l1 = lo; l1 < hi; l1 += 8) {
      float d[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        d[k] = l1 == lo ? d0[k] : (l1 + k < hi ? dtc[(long long)(l1 + k) * H + h] : 0.f);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int l = l1 + k;
        if (l < hi) {
          cum += d[k] * a;
          if (l >= l0 && l < l0 + TL) {
            const float e = expf(last - (cum + before));
            se[j * TL + l - l0] = e;
            sw[j * TL + l - l0] = e * d[k];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the tensor-core tile kernel: P 64, N 64 or 128
// ---------------------------------------------------------------------------

constexpr int TC_P = 64;
constexpr int TC_THREADS = 128;          // one warpgroup
constexpr int TC_CHUNK = TL * 128;       // 64 columns of a 64-row bf16 tile

// bytes of dynamic shared memory: slack to align the base to 1024; the Bm
// tile (hi and lo in float32); G_h hi and lo; the next head's G_h in
// float32 as it arrives; w and e of RB heads
template <typename T, int N>
constexpr int tc_smem(int RB) {
  return 1024 + (sizeof(T) == 4 ? 2 : 1) * (N / 64) * TC_CHUNK + 2 * (N / 64) * TC_CHUNK +
         4 * TC_P * N + 2 * 4 * TL * RB;
}

// 16 bytes from device to shared memory, asynchronously (cp.async, L2 only)
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(hopper::smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a head's G (P x N float32, contiguous) into shared memory, in 16-byte
// copies that land while the block works
template <int N>
__device__ __forceinline__ void fetch_g(float* raw, const float* __restrict__ gh, int tid) {
#pragma unroll
  for (int k = 0; k < TC_P * N / 4 / TC_THREADS; ++k) {
    const int u = tid + TC_THREADS * k;
    cp_async_16(raw + 4 * u, gh + 4 * u);
  }
  cp_async_commit();
}

// 8 consecutive values of a row in float32 into bf16: one 16-byte unit
// (bf16 input: the unit as it is; float32: hi, and lo beside)
__device__ __forceinline__ void unit_hi_lo(const __nv_bfloat16* p, uint4& hi, uint4& lo) {
  hi = *reinterpret_cast<const uint4*>(p);
  lo = make_uint4(0, 0, 0, 0);
}
__device__ __forceinline__ void unit_hi_lo(const float* p, uint4& hi, uint4& lo) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  hopper::split_bf16x2(a.x, a.y, hi.x, lo.x);
  hopper::split_bf16x2(a.z, a.w, hi.y, lo.y);
  hopper::split_bf16x2(b.x, b.y, hi.z, lo.z);
  hopper::split_bf16x2(b.z, b.w, hi.w, lo.w);
}

// two consecutive values of x as a bf16 pair (hi) and its remainder (lo),
// and their float32 sum
__device__ __forceinline__ void pair_hi_lo(const __nv_bfloat16* p, uint32_t& hi, uint32_t& lo,
                                           float2& f) {
  hi = *reinterpret_cast<const uint32_t*>(p);
  lo = 0;
  f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void pair_hi_lo(const float* p, uint32_t& hi, uint32_t& lo,
                                           float2& f) {
  f = *reinterpret_cast<const float2*>(p);
  hopper::split_bf16x2(f.x, f.y, hi, lo);
}

// the (k-step kk, slot m) place of a thread's A fragment: row r (m even)
// or r + 8, columns 16 kk + cq (m < 2) or 16 kk + 8 + cq
__device__ __forceinline__ int frag_row(int m) { return 8 * (m & 1); }
__device__ __forceinline__ int frag_col(int kk, int m) { return 16 * kk + 8 * (m >> 1); }

// x (C, L, H, P), Bm (C, L, G, N) through their element strides, 16-byte
// aligned rows; dt (C, L, H), A (H,), gs (C, H, P, N) float32; dx (C, L, H,
// P) in T; qw, qe (C, L, H) float32; part (C, G, runs, L, N) float32.
// Block (tile, c, g * runs + run).
template <typename T, int N>
__global__ void __launch_bounds__(TC_THREADS)
ssd_bwd_wgmma_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const float* __restrict__ gs, T* __restrict__ dx, float* __restrict__ qw,
                     float* __restrict__ qe, float* __restrict__ part, int L, int H, int R,
                     int RB, long long xc, long long xl, long long xh, long long bc, long long bl,
                     long long bg) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NB = N / 64;                       // 64-column chunks of a Bm or G row
  constexpr int UNITS = N / 8;                     // 16-byte bf16 units of a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sB = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sBl = sB + NB * TC_CHUNK;               // float32 only: Bm lo
  uint8_t* sGh = sBl + (F32 ? NB * TC_CHUNK : 0);  // G_h hi, rows p, n contiguous
  uint8_t* sGl = sGh + NB * TC_CHUNK;              // G_h lo
  float* sRaw = reinterpret_cast<float*>(sGl + NB * TC_CHUNK);  // P x N: the next G_h
  float* sw = sRaw + TC_P * N;                                  // RB x TL
  float* se = sw + RB * TL;                                     // RB x TL

  const int l0 = blockIdx.x * TL, c = blockIdx.y;
  const int runs = (R + RB - 1) / RB;
  const int g = blockIdx.z / runs, run = blockIdx.z % runs;
  const int h0 = g * R + run * RB;
  const int nh = min(RB, R - run * RB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = warp * 16 + (lane >> 2), cq = 2 * (lane & 3);
  const float* dtc = dt + (long long)c * L * H;

  // the first head's G lands while the weights and the Bm tile are made
  fetch_g<N>(sRaw, gs + ((long long)c * H + h0) * TC_P * N, tid);
  tile_weights(sw, se, dtc, A, L, H, h0, nh, l0, warp, TC_THREADS / 32, lane);
  // the Bm tile, K-major (n contiguous), swizzled as a TMA box would be;
  // rows past L are zeros; a thread's loads first
  {
    constexpr int PER = TL * UNITS / TC_THREADS;   // 4 or 8 units a thread
    uint4 hi[PER], lo[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int u = tid + TC_THREADS * k, row = u / UNITS, cu = u % UNITS;
      hi[k] = lo[k] = make_uint4(0, 0, 0, 0);
      if (l0 + row < L)
        unit_hi_lo(Bm + c * bc + (l0 + row) * bl + g * bg + 8 * cu, hi[k], lo[k]);
    }
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int u = tid + TC_THREADS * k, row = u / UNITS, cu = u % UNITS;
      const uint32_t at = (cu / 8) * TC_CHUNK + hopper::swz<128>(row * 128 + (cu % 8) * 16);
      *reinterpret_cast<uint4*>(sB + at) = hi[k];
      if constexpr (F32) *reinterpret_cast<uint4*>(sBl + at) = lo[k];
    }
  }

  float dbm[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dbm[i] = 0.f;
  const uint32_t b_addr = hopper::smem_u32(sB), bl_addr = hopper::smem_u32(sBl);
  const uint32_t gh_addr = hopper::smem_u32(sGh), gl_addr = hopper::smem_u32(sGl);
  const int rows[2] = {l0 + r, l0 + r + 8};

  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i;
    // x's A fragments of the tile (4 k-steps of 16 columns p), hi and lo,
    // and their float32 values (u's fragment has the same places)
    uint32_t xa[4][4], xb[4][4];
    float2 xf[4][4];
    {
      const T* xr = x + c * xc + h * xh;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int l = l0 + r + frag_row(m);
          if (l < L) {
            pair_hi_lo(xr + l * xl + frag_col(kk, m) + cq, xa[kk][m], xb[kk][m], xf[kk][m]);
          } else {
            xa[kk][m] = xb[kk][m] = 0;
            xf[kk][m] = make_float2(0.f, 0.f);
          }
        }
    }
    // G_h has landed (every thread's copies), and every warp's products of
    // the previous head are done with G_h's split
    cp_async_wait_all();
    __syncthreads();
    // G_h (P x N float32) split into bf16 hi and lo: rows p, n contiguous,
    // 64-column chunks, swizzled
#pragma unroll
    for (int k = 0; k < TC_P * UNITS / TC_THREADS; ++k) {
      const int u = tid + TC_THREADS * k;
      const int p = u / UNITS, cu = u % UNITS;
      const float4 a = *reinterpret_cast<const float4*>(sRaw + 8 * u);
      const float4 b = *reinterpret_cast<const float4*>(sRaw + 8 * u + 4);
      uint4 hi, lo;
      hopper::split_bf16x2(a.x, a.y, hi.x, lo.x);
      hopper::split_bf16x2(a.z, a.w, hi.y, lo.y);
      hopper::split_bf16x2(b.x, b.y, hi.z, lo.z);
      hopper::split_bf16x2(b.z, b.w, hi.w, lo.w);
      const uint32_t at = (cu / 8) * TC_CHUNK + hopper::swz<128>(p * 128 + (cu % 8) * 16);
      *reinterpret_cast<uint4*>(sGh + at) = hi;
      *reinterpret_cast<uint4*>(sGl + at) = lo;
    }
    hopper::fence_proxy_async();
    __syncthreads();   // G_h's split (and, at the first head, Bm and w) is written
    // the next head's G lands during this head's products
    if (i + 1 < nh) fetch_g<N>(sRaw, gs + ((long long)c * H + h + 1) * TC_P * N, tid);

    // u = Bm G_h^T (K-major both), then v = x G_h (G_h MN-major), both in
    // flight before u is read
    float u[32], v[N / 2];
#pragma unroll
    for (int k = 0; k < N / 2; ++k) v[k] = 0.f;   // the register-sourced products accumulate
    hopper::fence_regs(xa);
    hopper::fence_regs(xb);
    hopper::fence_regs(v);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const int ch = kk / 4, j = kk % 4;
      const uint32_t ao = ch * TC_CHUNK + j * 32;
      const uint64_t bh = hopper::make_desc(b_addr + ao, 16, 1024, 128);
      const uint64_t gh = hopper::make_desc(gh_addr + ao, 16, 1024, 128);
      const uint64_t gl = hopper::make_desc(gl_addr + ao, 16, 1024, 128);
      hopper::wgmma_ss_n64(u, bh, gh, kk > 0);
      hopper::wgmma_ss_n64(u, bh, gl, 1);
      if constexpr (F32) hopper::wgmma_ss_n64(u, hopper::make_desc(bl_addr + ao, 16, 1024, 128), gh, 1);
    }
    hopper::wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t gh = hopper::make_desc(gh_addr + kk * 16 * 128, TC_CHUNK, 1024, 128);
      const uint64_t gl = hopper::make_desc(gl_addr + kk * 16 * 128, TC_CHUNK, 1024, 128);
      if constexpr (N == 128) {
        hopper::wgmma_rs_n128(v, xa[kk], gh);
        hopper::wgmma_rs_n128(v, xa[kk], gl);
        if constexpr (F32) hopper::wgmma_rs_n128(v, xb[kk], gh);
      } else {
        hopper::wgmma_rs_n64(v, xa[kk], gh);
        hopper::wgmma_rs_n64(v, xa[kk], gl);
        if constexpr (F32) hopper::wgmma_rs_n64(v, xb[kk], gh);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    hopper::fence_regs(u);

    // dx = w u and dw = sum_p x u: a thread's 16 columns of rows r, r + 8,
    // then the quad's 4 parts in a fixed tree
    const float w0 = sw[i * TL + r], w1 = sw[i * TL + r + 8];
    float dw0 = 0.f, dw1 = 0.f;
    T* dxr = dx + (long long)h * TC_P;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        // u's places (row r + frag_row(m), columns frag_col(kk, m) + cq, + 1)
        const int x0 = 8 * kk + 4 * (m >> 1) + 2 * (m & 1);
        const float a = u[x0], b = u[x0 + 1];
        if (m & 1) {
          dw1 = fmaf(xf[kk][m].x, a, dw1);
          dw1 = fmaf(xf[kk][m].y, b, dw1);
        } else {
          dw0 = fmaf(xf[kk][m].x, a, dw0);
          dw0 = fmaf(xf[kk][m].y, b, dw0);
        }
        const int l = rows[m & 1];
        const float wl = (m & 1) ? w1 : w0;
        if (l < L)
          store2(dxr + ((long long)c * L + l) * H * TC_P + frag_col(kk, m) + cq, wl * a, wl * b);
      }
    dw0 += __shfl_xor_sync(0xffffffffu, dw0, 1);
    dw1 += __shfl_xor_sync(0xffffffffu, dw1, 1);
    dw0 += __shfl_xor_sync(0xffffffffu, dw0, 2);
    dw1 += __shfl_xor_sync(0xffffffffu, dw1, 2);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        const int l = rows[i2];
        if (l < L) {
          const float dw = i2 ? dw1 : dw0;
          const long long at = ((long long)c * L + l) * H + h;
          qw[at] = dw * sw[i * TL + r + 8 * i2];
          qe[at] = dw * se[i * TL + r + 8 * i2];
        }
      }
    }

    // dBm's part += w v, in head order
    hopper::wgmma_wait<0>();
    hopper::fence_regs(v);
#pragma unroll
    for (int jn = 0; jn < N / 8; ++jn) {
      dbm[4 * jn] = fmaf(w0, v[4 * jn], dbm[4 * jn]);
      dbm[4 * jn + 1] = fmaf(w0, v[4 * jn + 1], dbm[4 * jn + 1]);
      dbm[4 * jn + 2] = fmaf(w1, v[4 * jn + 2], dbm[4 * jn + 2]);
      dbm[4 * jn + 3] = fmaf(w1, v[4 * jn + 3], dbm[4 * jn + 3]);
    }
  }

  // the run's part of dBm: rows r, r + 8, columns 8 j + cq, + 1
  float* pb = part + ((long long)(c * gridDim.z + blockIdx.z) * L) * N;
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    const int l = rows[i2];
    if (l >= L) continue;
#pragma unroll
    for (int jn = 0; jn < N / 8; ++jn)
      store2(pb + (long long)l * N + 8 * jn + cq, dbm[4 * jn + 2 * i2], dbm[4 * jn + 2 * i2 + 1]);
  }
}

// ---------------------------------------------------------------------------
// the CUDA-core tile kernel: any P % 4 == 0, N % 4 == 0 (the reduced configs)
// ---------------------------------------------------------------------------

constexpr int CC_THREADS = 256;   // 4 threads a position of the tile

// bytes of dynamic shared memory: the Bm, x and G_h tiles in float32,
// rows padded to an odd stride (a warp's 8 rows, or a quad's 4 columns p,
// on distinct banks), w and e of RB heads
template <int P, int N>
constexpr int cc_smem(int RB) {
  return 4 * (TL * (N + 1) + TL * (P + 1) + P * (N + 1) + 2 * TL * RB);
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(CC_THREADS)
ssd_bwd_cuda_core_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ A, const T* __restrict__ Bm,
                         const float* __restrict__ gs, T* __restrict__ dx,
                         float* __restrict__ qw, float* __restrict__ qe,
                         float* __restrict__ part, int L, int H, int R, int RB, long long xc,
                         long long xl, long long xh, long long bc, long long bl, long long bg) {
  constexpr int LDB = N + 1, LDX = P + 1, LDG = N + 1;
  extern __shared__ float sm[];
  float* sB = sm;               // TL x LDB
  float* sX = sB + TL * LDB;    // TL x LDX
  float* sG = sX + TL * LDX;    // P x LDG
  float* sw = sG + P * LDG;     // RB x TL
  float* se = sw + RB * TL;     // RB x TL

  const int l0 = blockIdx.x * TL, c = blockIdx.y;
  const int runs = (R + RB - 1) / RB;
  const int g = blockIdx.z / runs, run = blockIdx.z % runs;
  const int h0 = g * R + run * RB;
  const int nh = min(RB, R - run * RB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = tid >> 2, q = tid & 3, l = l0 + row;
  const float* dtc = dt + (long long)c * L * H;

  tile_weights(sw, se, dtc, A, L, H, h0, nh, l0, warp, CC_THREADS / 32, lane);
  {
    float v[TL * N / CC_THREADS];
#pragma unroll
    for (int k = 0; k < TL * N / CC_THREADS; ++k) {
      const int i = tid + CC_THREADS * k, rr = i / N, n = i % N;
      v[k] = l0 + rr < L ? to_f(Bm[c * bc + (l0 + rr) * bl + g * bg + n]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < TL * N / CC_THREADS; ++k) {
      const int i = tid + CC_THREADS * k;
      sB[(i / N) * LDB + i % N] = v[k];
    }
  }
  float dbm[N / 4];
#pragma unroll
  for (int k = 0; k < N / 4; ++k) dbm[k] = 0.f;

  for (int i = 0; i < nh; ++i) {
    const int h = h0 + i;
    // this head's x tile and G_h, every load before its store to shared
    // memory (loads one after another would wait for each other)
    constexpr int XPER = TL * P / CC_THREADS, GPER = (P * N + CC_THREADS - 1) / CC_THREADS;
    float xv[XPER], gv[GPER];
    const float* gh = gs + ((long long)c * H + h) * P * N;
#pragma unroll
    for (int k = 0; k < XPER; ++k) {
      const int e = tid + CC_THREADS * k, rr = e / P, p = e % P;
      xv[k] = l0 + rr < L ? to_f(x[c * xc + (l0 + rr) * xl + h * xh + p]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < GPER; ++k) {
      const int e = tid + CC_THREADS * k;
      gv[k] = e < P * N ? gh[e] : 0.f;
    }
    __syncthreads();   // the previous head's reads are done
#pragma unroll
    for (int k = 0; k < XPER; ++k) {
      const int e = tid + CC_THREADS * k;
      sX[(e / P) * LDX + e % P] = xv[k];
    }
#pragma unroll
    for (int k = 0; k < GPER; ++k) {
      const int e = tid + CC_THREADS * k;
      if (e < P * N) sG[(e / N) * LDG + e % N] = gv[k];
    }
    __syncthreads();
    const float wl = sw[i * TL + row];
    // u at columns p = q + 4 k: dx, and this thread's part of dw (rows
    // past L, a ragged or short chunk's, skip the products)
    float dw = 0.f;
    if (l < L) {
#pragma unroll
      for (int k = 0; k < P / 4; ++k) {
        const int p = q + 4 * k;
        float acc = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) acc = fmaf(sB[row * LDB + n], sG[p * LDG + n], acc);
        dw = fmaf(sX[row * LDX + p], acc, dw);
        store(dx + (((long long)c * L + l) * H + h) * P + p, wl * acc);
      }
    }
    dw += __shfl_xor_sync(0xffffffffu, dw, 1);
    dw += __shfl_xor_sync(0xffffffffu, dw, 2);
    if (q == 0 && l < L) {
      const long long at = ((long long)c * L + l) * H + h;
      qw[at] = dw * wl;
      qe[at] = dw * se[i * TL + row];
    }
    // v at columns n = q + 4 k; dBm's part += w v
    if (l < L) {
#pragma unroll
      for (int k = 0; k < N / 4; ++k) {
        const int n = q + 4 * k;
        float acc = 0.f;
#pragma unroll 4
        for (int p = 0; p < P; ++p) acc = fmaf(sX[row * LDX + p], sG[p * LDG + n], acc);
        dbm[k] = fmaf(wl, acc, dbm[k]);
      }
    }
  }
  if (l < L) {
    float* pb = part + ((long long)(c * gridDim.z + blockIdx.z) * L + l) * N;
#pragma unroll
    for (int k = 0; k < N / 4; ++k) pb[q + 4 * k] = dbm[k];
  }
}

// ---------------------------------------------------------------------------
// the scan: ddt, dA's partials, and dBm from its runs' parts
// ---------------------------------------------------------------------------

constexpr int SCAN_THREADS = 128;

// blocks [0, C * ceil(H / 4)): warp w of block (c, hb) takes head 4 hb +
// w; the rest, block (c, g, tile): dBm of 64 positions
template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
ssd_bwd_scan_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                    const float* __restrict__ qw, const float* __restrict__ qe,
                    const float* __restrict__ part, float* __restrict__ ddt,
                    float* __restrict__ dA_part, T* __restrict__ dBm, int C, int L, int H, int G,
                    int N, int runs) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hb = (H + 3) / 4;
  int bx = blockIdx.x;
  if (bx < C * hb) {
    const int c = bx / hb, h = (bx % hb) * 4 + warp;
    if (h >= H) return;
    // the exclusive prefix of dw * w over the chunk: lanes' runs in order,
    // offset by a shuffle scan of their totals
    const int run = (L + 31) / 32;
    const int lo = min(L, lane * run), hi = min(L, lo + run);
    const long long base = (long long)c * L * H + h;
    // a lane's run in batches of 8 positions, every load of a batch issued
    // before its sums (the run's sums in position order; past hi adds 0)
    float tot = 0.f;
    for (int l1 = lo; l1 < hi; l1 += 8) {
      float q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) q[k] = l1 + k < hi ? qw[base + (long long)(l1 + k) * H] : 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) tot += q[k];
    }
    float incl = tot;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, s);
      if (lane >= s) incl += up;
    }
    float pre = incl - tot;
    const float a = A[h];
    float dap = 0.f;
    for (int l1 = lo; l1 < hi; l1 += 8) {
      float q[8], e[8], d[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const long long at = base + (long long)(l1 + k) * H;
        const bool in = l1 + k < hi;
        q[k] = in ? qw[at] : 0.f;
        e[k] = in ? qe[at] : 0.f;
        d[k] = in ? dt[at] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (l1 + k < hi) {
          ddt[base + (long long)(l1 + k) * H] = e[k] + a * pre;
          dap += d[k] * pre;
          pre += q[k];
        }
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) dap += __shfl_xor_sync(0xffffffffu, dap, s);
    if (lane == 0) dA_part[(long long)c * H + h] = dap;
    return;
  }
  // dBm: a thread per 4 consecutive elements of a (chunk, group)'s L x N,
  // the runs' parts summed in run order
  bx -= C * hb;
  const int units = L * N / 4, per = (units + SCAN_THREADS - 1) / SCAN_THREADS;
  const int c = bx / (G * per), g = (bx / per) % G;
  const int u = (bx % per) * SCAN_THREADS + tid;
  if (u >= units) return;
  const float4* pg =
      reinterpret_cast<const float4*>(part + (long long)(c * G + g) * runs * L * N) + u;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int j = 0; j < runs; ++j) {
    const float4 v = pg[(long long)j * units];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  const int l = 4 * u / N, n = 4 * u % N;
  T* dst = dBm + (((long long)c * L + l) * G + g) * N + n;
  store2(dst, s.x, s.y);
  store2(dst + 2, s.z, s.w);
}

struct Args {
  const void *x, *dt, *A, *Bm, *gs;
  void *dx, *dBm, *ddt, *dA_part, *qw, *qe, *part;
  long long st[6];
  int C, L, H, P, G, N, RB;
  cudaStream_t stream;
};

template <typename T, int N>
int launch_wgmma(const Args& a) {
  const int R = a.H / a.G, runs = (R + a.RB - 1) / a.RB;
  const int smem = tc_smem<T, N>(a.RB);
  const cudaError_t e =
      cudaFuncSetAttribute(ssd_bwd_wgmma_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.L + TL - 1) / TL, a.C, a.G * runs);
  ssd_bwd_wgmma_kernel<T, N><<<grid, TC_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const T*>(a.Bm),
      static_cast<const float*>(a.gs), static_cast<T*>(a.dx), static_cast<float*>(a.qw),
      static_cast<float*>(a.qe), static_cast<float*>(a.part), a.L, a.H, R, a.RB, a.st[0],
      a.st[1], a.st[2], a.st[3], a.st[4], a.st[5]);
  return (int)cudaGetLastError();
}

template <typename T, int P, int N>
int launch_cuda_core(const Args& a) {
  const int R = a.H / a.G, runs = (R + a.RB - 1) / a.RB;
  const int smem = cc_smem<P, N>(a.RB);
  const cudaError_t e =
      cudaFuncSetAttribute(ssd_bwd_cuda_core_kernel<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.L + TL - 1) / TL, a.C, a.G * runs);
  ssd_bwd_cuda_core_kernel<T, P, N><<<grid, CC_THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const T*>(a.Bm),
      static_cast<const float*>(a.gs), static_cast<T*>(a.dx), static_cast<float*>(a.qw),
      static_cast<float*>(a.qe), static_cast<float*>(a.part), a.L, a.H, R, a.RB, a.st[0],
      a.st[1], a.st[2], a.st[3], a.st[4], a.st[5]);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile(const Args& a) {
  if (a.P == 64 && a.N == 128) return launch_wgmma<T, 128>(a);
  if (a.P == 64 && a.N == 64) return launch_wgmma<T, 64>(a);
  if (a.P == 32 && a.N == 16) return launch_cuda_core<T, 32, 16>(a);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_scan(const Args& a) {
  const int runs = (a.H / a.G + a.RB - 1) / a.RB;
  const int blocks = a.C * ((a.H + 3) / 4) +
                     a.C * a.G * ((a.L * a.N / 4 + SCAN_THREADS - 1) / SCAN_THREADS);
  ssd_bwd_scan_kernel<T><<<blocks, SCAN_THREADS, 0, a.stream>>>(
      static_cast<const float*>(a.dt), static_cast<const float*>(a.A),
      static_cast<const float*>(a.qw), static_cast<const float*>(a.qe),
      static_cast<const float*>(a.part), static_cast<float*>(a.ddt),
      static_cast<float*>(a.dA_part), static_cast<T*>(a.dBm), a.C, a.L, a.H, a.G, a.N, runs);
  return (int)cudaGetLastError();
}

int run(const void* x, const void* dt, const void* A, const void* Bm, const void* gs, void* dx,
        void* dBm, void* ddt, void* dA_part, void* qw, void* qe, void* part,
        const long long* strides, int C, int L, int H, int P, int G, int N, int RB, int is_bf16,
        int scan, void* stream) {
  if (C == 0 || L == 0 || H == 0) return 0;
  Args a{x, dt, A, Bm, gs, dx, dBm, ddt, dA_part, qw, qe, part, {}, C, L, H, P, G, N, RB,
         static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < 6; ++i) a.st[i] = strides[i];
  if (scan) return is_bf16 ? launch_scan<__nv_bfloat16>(a) : launch_scan<float>(a);
  return is_bf16 ? launch_tile<__nv_bfloat16>(a) : launch_tile<float>(a);
}

}  // namespace

// strides: x's (chunk, position, head) and Bm's (chunk, position, group)
// element strides, the last dim of each contiguous (16-byte-aligned rows
// and strides at P 64: the wrapper checks them); dt (C, L, H) and the
// state's cotangent gs (C, H, P, N) float32 contiguous; dx (C, L, H, P)
// and dBm (C, L, G, N) contiguous in x's dtype, ddt (C, L, H) and dA_part
// (C, H) float32; the scratch qw, qe (C, L, H) and part (C, G, runs, L, N)
// float32, runs = ceil((H / G) / RB).  (P, N): (64, 128), (64, 64) on the
// tensor cores, (32, 16) on the CUDA cores.  ssd_chunk_state_bwd_tile
// writes dx, qw, qe and part and must run before ssd_chunk_state_bwd_scan,
// which writes ddt, dA_part and dBm.  Returns cudaGetLastError() after the
// launch.
extern "C" int ssd_chunk_state_bwd_tile(const void* x, const void* dt, const void* A,
                                        const void* Bm, const void* gs, void* dx, void* dBm,
                                        void* ddt, void* dA_part, void* qw, void* qe, void* part,
                                        const long long* strides, int C, int L, int H, int P,
                                        int G, int N, int RB, int is_bf16, void* stream) {
  return run(x, dt, A, Bm, gs, dx, dBm, ddt, dA_part, qw, qe, part, strides, C, L, H, P, G, N,
             RB, is_bf16, 0, stream);
}

extern "C" int ssd_chunk_state_bwd_scan(const void* x, const void* dt, const void* A,
                                        const void* Bm, const void* gs, void* dx, void* dBm,
                                        void* ddt, void* dA_part, void* qw, void* qe, void* part,
                                        const long long* strides, int C, int L, int H, int P,
                                        int G, int N, int RB, int is_bf16, void* stream) {
  return run(x, dt, A, Bm, gs, dx, dBm, ddt, dA_part, qw, qe, part, strides, C, L, H, P, G, N,
             RB, is_bf16, 1, stream);
}

// the dynamic shared memory a tile block asks for at (P, N) with RB heads
// in bf16 or float32 (0 for widths it does not take):
// ssd_chunk.bwd_launch_plan states the same number
extern "C" int ssd_chunk_state_bwd_smem(int P, int N, int RB, int is_bf16) {
  if (P == 64 && N == 128) return is_bf16 ? tc_smem<__nv_bfloat16, 128>(RB) : tc_smem<float, 128>(RB);
  if (P == 64 && N == 64) return is_bf16 ? tc_smem<__nv_bfloat16, 64>(RB) : tc_smem<float, 64>(RB);
  if (P == 32 && N == 16) return cc_smem<32, 16>(RB);
  return 0;
}
