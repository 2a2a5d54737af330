// Edge-list aggregations over grouped layouts for Hopper (sm_90a).
//
// K1  gss_forward   out[d, j] = sum_{k in [row_ptr[d], row_ptr[d+1])}
//                               coef[order[k], j / (F/heads)] * h[idx[order[k]], j]
//     replaces src/repro/kernels/segment_sum.py:320 (_fused_impl, whose
//     pallas_call is at :345; kernel body _fused_kernel :287), reached
//     through gather_scale_segment_sum_pallas :456.  Over the src-grouped
//     layout with idx = edge_dst it is its own transpose, the dh of
//     _fused_bwd :441; with heads > 1 it is the dhs of the GAT VJP
//     (gat_fused.py:217), every head in one launch, and given a column
//     (E, heads) it also sums that column per head (the VJP's des).
// K2  seg_forward   out[d] = sum_{k in [row_ptr[d], row_ptr[d+1])}
//                             msgs[order[k]]
//     replaces src/repro/kernels/segment_sum.py:138 (_scatter_add, whose
//     pallas_call is at :152; kernel body _scatter_kernel :111), reached
//     through segment_sum_pallas :260.
// K5  gather_rows   out[order[k]] = g[seg[order[k]]] for k < nnz
//     replaces src/repro/kernels/segment_sum.py:196 (gather_rows_pallas,
//     whose pallas_call is at :221; kernel body _gather_kernel :171), the
//     VJP of K2 (_segment_sum_bwd :250).
// K6  edge_dot      out[order[k], hh] = <a[src_e, hh-th slice], b[dst_e, hh-th slice]>
//     replaces src/repro/kernels/segment_sum.py:390 (_edge_dot, whose
//     pallas_call is at :411; kernel body _edge_dot_kernel :362), the dcoef
//     of K1 (the GAT VJP takes its per-head dalpha in gat_fused.cu).
// K4  gssq_forward  K1 with h[s, j] = mn[s] + q[s, j] * scale[s], q uint8
//     replaces src/repro/kernels/segment_sum.py:531
//     (gather_scale_segment_sum_q_pallas, whose pallas_call is at :580;
//     kernel body _fused_q_kernel :493).  Forward only.
//
// (order, row_ptr) is a grouped layout DeviceGraph builds on the host:
// order lists the edges (masked pad slots left out) stably sorted by the
// grouping index (dst for the forward, src for the transpose), and
// row_ptr[d]..row_ptr[d+1] is group d's range.  K5 and K6 write only the
// listed edges; the wrapper zero-fills the output when some are unlisted.
//
// Bounds.  Every kernel here does one or two operations per element it
// moves, far below the card's float32 rate, so all are bound by bytes
// over 3.35 TB/s (U distinct rows read, nnz listed edges):
//   K1: 4*(U*F + D*F) + 12*nnz (+ 4*heads*nnz for the coefficient rows,
//       and 4*heads*(nnz + D) for a column)
//   K2: 4*(nnz*F + D*F) + 8*nnz
//   K5: 4*(U*F + nnz*F) + 8*nnz
//   K6: 4*(Ua*F + Ub*F + nnz*heads) + 12*nnz
//   K4: U*F + 8*U + 4*D*F + 12*nnz   (one byte per element read)
// What the design does about it: the TPU kernels build one-hot matrices
// because a TPU has no efficient scatter; here K1, K2 and K4 give each
// output row one block that walks its edge range, so the (E, F) message
// tensor never exists, every output row is written once with no atomics
// (sums run in edge order: bitwise repeatable), and the working set is a
// few registers per thread whatever num_src is.  K5 gives each warp 2
// listed edges and strides its lanes over their rows, 4 loads a lane in
// flight before the streaming stores; it reads each row once, in turn,
// when the caller passes the listed edges grouped by seg (GatherRows
// does when it has that layout).  K6 gives every (edge, head) one warp,
// lanes across the head's columns, summed by a fixed shuffle tree
// (no atomics: bitwise repeatable).  Loads are the widest vector (float4
// / float2 / float; uchar4 / uchar2 / uchar for K4) that divides the row
// width, the head width and the pointers' alignment, checked at launch:
// rows of 602 floats take float2, rows of 602 bytes uchar2.
#include <cuda_runtime.h>
#include <stdint.h>

template <int VEC>
struct VecT;
template <>
struct VecT<1> { using T = float; using Q = unsigned char; };
template <>
struct VecT<2> { using T = float2; using Q = uchar2; };
template <>
struct VecT<4> { using T = float4; using Q = uchar4; };

__device__ __forceinline__ void fma_vec(float& acc, float c, float x) { acc = fmaf(c, x, acc); }
__device__ __forceinline__ void fma_vec(float2& acc, float c, float2 x) {
  acc.x = fmaf(c, x.x, acc.x);
  acc.y = fmaf(c, x.y, acc.y);
}
__device__ __forceinline__ void fma_vec(float4& acc, float c, float4 x) {
  acc.x = fmaf(c, x.x, acc.x);
  acc.y = fmaf(c, x.y, acc.y);
  acc.z = fmaf(c, x.z, acc.z);
  acc.w = fmaf(c, x.w, acc.w);
}
__device__ __forceinline__ void add_vec(float& acc, float x) { acc += x; }
__device__ __forceinline__ void add_vec(float2& acc, float2 x) {
  acc.x += x.x;
  acc.y += x.y;
}
__device__ __forceinline__ void add_vec(float4& acc, float4 x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}
// dequantize in registers (mn + q * scale) and accumulate c * that
__device__ __forceinline__ void fma_dq(float& acc, float c, unsigned char q, float sc, float mn) {
  acc = fmaf(c, fmaf((float)q, sc, mn), acc);
}
__device__ __forceinline__ void fma_dq(float2& acc, float c, uchar2 q, float sc, float mn) {
  acc.x = fmaf(c, fmaf((float)q.x, sc, mn), acc.x);
  acc.y = fmaf(c, fmaf((float)q.y, sc, mn), acc.y);
}
__device__ __forceinline__ void fma_dq(float4& acc, float c, uchar4 q, float sc, float mn) {
  acc.x = fmaf(c, fmaf((float)q.x, sc, mn), acc.x);
  acc.y = fmaf(c, fmaf((float)q.y, sc, mn), acc.y);
  acc.z = fmaf(c, fmaf((float)q.z, sc, mn), acc.z);
  acc.w = fmaf(c, fmaf((float)q.w, sc, mn), acc.w);
}
template <typename T>
__device__ __forceinline__ T zero_vec();
template <>
__device__ __forceinline__ float zero_vec<float>() { return 0.f; }
template <>
__device__ __forceinline__ float2 zero_vec<float2>() { return make_float2(0.f, 0.f); }
template <>
__device__ __forceinline__ float4 zero_vec<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// One block per output row; thread t owns vector columns t, t +
// blockDim.x, ...  SCALED selects K1 (gather rows[idx[e]], scale by
// coef[e, head]) or K2 (row e of msgs, coefficient 1).  A vector never
// straddles two heads: the launch picks VEC dividing hd = F / heads.
// COL (K1 only) also sums the (E, heads) column col into col_out[d, head],
// in the same walk and edge order, by the thread that owns the head's
// first vector: the GAT VJP's des beside its dhs.
template <int VEC, bool SCALED, bool COL>
__global__ void segmented_rows_kernel(const float* __restrict__ rows,
                                      const int* __restrict__ idx,
                                      const float* __restrict__ coef,
                                      const float* __restrict__ col,
                                      const int* __restrict__ order,
                                      const int* __restrict__ row_ptr,
                                      float* __restrict__ out,
                                      float* __restrict__ col_out, int F, int heads) {
  using T = typename VecT<VEC>::T;
  const int d = blockIdx.x;
  const int nvec = F / VEC;
  const int hd = F / heads;
  const int k0 = row_ptr[d];
  const int k1 = row_ptr[d + 1];
  T* out_row = reinterpret_cast<T*>(out + (size_t)d * F);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    const int head = (v * VEC) / hd;
    const bool col_owner = COL && (v * VEC) % hd == 0;
    T acc = zero_vec<T>();
    float csum = 0.f;
    for (int k = k0; k < k1; ++k) {
      const int e = __ldg(order + k);
      if constexpr (SCALED) {
        const int s = __ldg(idx + e);
        const float c = __ldg(coef + (size_t)e * heads + head);
        const T x = __ldg(reinterpret_cast<const T*>(rows + (size_t)s * F) + v);
        fma_vec(acc, c, x);
        if (col_owner) csum += __ldg(col + (size_t)e * heads + head);
      } else {
        const T x = __ldg(reinterpret_cast<const T*>(rows + (size_t)e * F) + v);
        add_vec(acc, x);
      }
    }
    out_row[v] = acc;
    if (col_owner) col_out[(size_t)d * heads + head] = csum;
  }
}

// K4: as K1 with heads = 1, the rows read as VEC bytes and dequantized
template <int VEC>
__global__ void segmented_rows_q_kernel(const unsigned char* __restrict__ q,
                                        const float* __restrict__ mn,
                                        const float* __restrict__ scale,
                                        const int* __restrict__ idx,
                                        const float* __restrict__ coef,
                                        const int* __restrict__ order,
                                        const int* __restrict__ row_ptr,
                                        float* __restrict__ out, int F) {
  using T = typename VecT<VEC>::T;
  using Q = typename VecT<VEC>::Q;
  const int d = blockIdx.x;
  const int nvec = F / VEC;
  const int k0 = row_ptr[d];
  const int k1 = row_ptr[d + 1];
  T* out_row = reinterpret_cast<T*>(out + (size_t)d * F);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    T acc = zero_vec<T>();
    for (int k = k0; k < k1; ++k) {
      const int e = __ldg(order + k);
      const int s = __ldg(idx + e);
      const Q x = __ldg(reinterpret_cast<const Q*>(q + (size_t)s * F) + v);
      fma_dq(acc, __ldg(coef + e), x, __ldg(scale + s), __ldg(mn + s));
    }
    out_row[v] = acc;
  }
}

// K5: one warp per EPW listed edges (32-bit index math).  Lanes 0..EPW-1
// read the edges' order and seg entries, the warp shares them by
// shuffles; then each lane takes U vectors 32 apart of every edge's row
// per step, issuing all EPW * U loads before the EPW * U streaming stores
// (the (E, F) output is not read again here).  A copy: bitwise equal to
// the plain gather.
template <int VEC, int EPW, int U>
__global__ void gather_rows_kernel(const float* __restrict__ g, const int* __restrict__ seg,
                                   const int* __restrict__ order, float* __restrict__ out,
                                   int nnz, int nvec) {
  using T = typename VecT<VEC>::T;
  const int lane = threadIdx.x & 31;
  const int F = nvec * VEC;
  const int nwarps = (gridDim.x * blockDim.x) >> 5;
  for (int k0 = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * EPW; k0 < nnz;
       k0 += nwarps * EPW) {
    int my_e = 0, my_s = 0;
    if (lane < EPW && k0 + lane < nnz) {
      my_e = __ldg(order + k0 + lane);
      my_s = __ldg(seg + my_e);
    }
    const int n = min(EPW, nnz - k0);
    const T* src[EPW];
    T* dst[EPW];
#pragma unroll
    for (int i = 0; i < EPW; ++i) {
      const int e = __shfl_sync(0xffffffffu, my_e, i);
      const int s = __shfl_sync(0xffffffffu, my_s, i);
      src[i] = reinterpret_cast<const T*>(g + (size_t)s * F);
      dst[i] = reinterpret_cast<T*>(out + (size_t)e * F);
    }
    for (int v0 = lane; v0 < nvec; v0 += 32 * U) {
      T x[EPW][U];
#pragma unroll
      for (int i = 0; i < EPW; ++i)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (i < n && v0 + 32 * u < nvec) x[i][u] = __ldg(src[i] + v0 + 32 * u);
#pragma unroll
      for (int i = 0; i < EPW; ++i)
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (i < n && v0 + 32 * u < nvec) __stcs(dst[i] + v0 + 32 * u, x[i][u]);
    }
  }
}

// K6: one warp per (listed edge, head); w is uniform across the warp, so
// every lane takes part in each shuffle
__global__ void edge_dot_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                const int* __restrict__ src, const int* __restrict__ dst,
                                const int* __restrict__ order, float* __restrict__ out,
                                long long nwarps, int F, int heads) {
  const int lane = threadIdx.x & 31;
  const int hd = F / heads;
  const long long wstride = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; w < nwarps;
       w += wstride) {
    const long long k = w / heads;
    const int hh = (int)(w - k * heads);
    const int e = __ldg(order + k);
    const float* ar = a + (size_t)__ldg(src + e) * F + (size_t)hh * hd;
    const float* br = b + (size_t)__ldg(dst + e) * F + (size_t)hh * hd;
    float acc = 0.f;
    for (int j = lane; j < hd; j += 32) acc = fmaf(__ldg(ar + j), __ldg(br + j), acc);
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) out[(size_t)e * heads + hh] = acc;
  }
}

// widest vector (4, 2 or 1 elements of `elem` bytes) dividing `width`
// and the alignment of every pointer
static int vec_width(uintptr_t addr_bits, int elem, int width) {
  if (width % 4 == 0 && addr_bits % (4 * elem) == 0) return 4;
  if (width % 2 == 0 && addr_bits % (2 * elem) == 0) return 2;
  return 1;
}

static int block_threads(int nvec) {
  int threads = ((nvec + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  return threads;
}

static int grid_stride_blocks(long long threads_needed) {
  long long blocks = (threads_needed + 255) / 256;
  const long long cap = 132LL * 64;  // enough to fill every SM many times
  if (blocks > cap) blocks = cap;
  return (int)(blocks < 1 ? 1 : blocks);
}

template <bool SCALED, bool COL>
static int launch(const float* rows, const int* idx, const float* coef, const float* col,
                  const int* order, const int* row_ptr, float* out, float* col_out,
                  int num_dst, int F, int heads, cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(rows) | reinterpret_cast<uintptr_t>(out) |
                      (uintptr_t)(4 * F);
  // a vector stays inside one head: its width divides hd = F / heads
  const int vec = vec_width(a, 4, F / heads);
  const int threads = block_threads(F / vec);
  dim3 grid(num_dst);
  if (vec == 4)
    segmented_rows_kernel<4, SCALED, COL><<<grid, threads, 0, stream>>>(
        rows, idx, coef, col, order, row_ptr, out, col_out, F, heads);
  else if (vec == 2)
    segmented_rows_kernel<2, SCALED, COL><<<grid, threads, 0, stream>>>(
        rows, idx, coef, col, order, row_ptr, out, col_out, F, heads);
  else
    segmented_rows_kernel<1, SCALED, COL><<<grid, threads, 0, stream>>>(
        rows, idx, coef, col, order, row_ptr, out, col_out, F, heads);
  return (int)cudaGetLastError();
}

// K1; with col (E, heads) and col_out (num_dst, heads) given, also the
// column's segment sum
extern "C" int gss_forward(const float* h, const int* idx, const float* coef, const float* col,
                           const int* order, const int* row_ptr, float* out, float* col_out,
                           int num_dst, int F, int heads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (col != nullptr)
    return launch<true, true>(h, idx, coef, col, order, row_ptr, out, col_out, num_dst, F, heads,
                              st);
  return launch<true, false>(h, idx, coef, nullptr, order, row_ptr, out, nullptr, num_dst, F,
                             heads, st);
}

extern "C" int seg_forward(const float* msgs, const int* order, const int* row_ptr, float* out,
                           int num_dst, int F, void* stream) {
  return launch<false, false>(msgs, nullptr, nullptr, nullptr, order, row_ptr, out, nullptr,
                              num_dst, F, 1, static_cast<cudaStream_t>(stream));
}

extern "C" int gssq_forward(const unsigned char* q, const float* mn, const float* scale,
                            const int* idx, const float* coef, const int* order,
                            const int* row_ptr, float* out, int num_dst, int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the uint8 rows set the vector width (602-byte rows are 2-byte
  // aligned); the float output row must take the same width
  const int vq = vec_width(reinterpret_cast<uintptr_t>(q) | (uintptr_t)F, 1, F);
  const int vo = vec_width(reinterpret_cast<uintptr_t>(out) | (uintptr_t)(4 * F), 4, F);
  const int vec = vq < vo ? vq : vo;
  const int threads = block_threads(F / vec);
  if (vec == 4)
    segmented_rows_q_kernel<4><<<num_dst, threads, 0, st>>>(q, mn, scale, idx, coef, order,
                                                            row_ptr, out, F);
  else if (vec == 2)
    segmented_rows_q_kernel<2><<<num_dst, threads, 0, st>>>(q, mn, scale, idx, coef, order,
                                                            row_ptr, out, F);
  else
    segmented_rows_q_kernel<1><<<num_dst, threads, 0, st>>>(q, mn, scale, idx, coef, order,
                                                            row_ptr, out, F);
  return (int)cudaGetLastError();
}

extern "C" int gather_rows(const float* g, const int* seg, const int* order, float* out,
                           int nnz, int F, void* stream) {
  constexpr int EPW = 2, U = 2;   // edges per warp, vectors per lane and step
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(out) |
                      (uintptr_t)(4 * F);
  const int vec = vec_width(a, 4, F);
  const int nvec = F / vec;
  const long long warps = ((long long)nnz + EPW - 1) / EPW;
  long long blocks = (warps + 7) / 8;   // 8 warps a block
  if (blocks > 132LL * 256) blocks = 132LL * 256;   // the rest by the grid-stride loop
  if (blocks < 1) blocks = 1;
  if (vec == 4)
    gather_rows_kernel<4, EPW, U><<<(int)blocks, 256, 0, st>>>(g, seg, order, out, nnz, nvec);
  else if (vec == 2)
    gather_rows_kernel<2, EPW, U><<<(int)blocks, 256, 0, st>>>(g, seg, order, out, nnz, nvec);
  else
    gather_rows_kernel<1, EPW, U><<<(int)blocks, 256, 0, st>>>(g, seg, order, out, nnz, nvec);
  return (int)cudaGetLastError();
}

extern "C" int edge_dot(const float* a, const float* b, const int* src, const int* dst,
                        const int* order, float* out, int nnz, int F, int heads, void* stream) {
  const long long nwarps = (long long)nnz * heads;
  edge_dot_kernel<<<grid_stride_blocks(nwarps * 32), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, src, dst, order, out, nwarps, F, heads);
  return (int)cudaGetLastError();
}
