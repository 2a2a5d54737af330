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
// K6  edge_dot      out[order[k], hh] = <a[src[order[k]], hh-th slice], b[d, hh-th slice]>
//                   for k in [row_ptr[d], row_ptr[d+1]) of the dst-grouped layout
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
//   K6: 4*(Ua*F + Ud*F + nnz*heads) + 8*nnz + 4*(D + 1)   (Ud of D
//       destinations have edges)
//   K4: U*F + 8*U + 4*D*F + 12*nnz   (one byte per element read)
// What a scattered graph allows is less: when a destination's sources lie
// anywhere in h (the SBM gives classes to random node ids), each listed
// edge reads its whole row from device memory, so K1, K4 and K6 move nnz
// rows, not U, and that gather of nnz rows (plus the output and the
// indices) over 3.35 TB/s is the rate they can reach.
//
// What the design does about it: the TPU kernels build one-hot matrices
// because a TPU has no efficient scatter; here every output row is
// written once by the lanes that own it, so the (E, F) message tensor
// never exists, there are no atomics, and sums run in edge order
// (bitwise repeatable).
//   K1 and K4 (gss_lanes_kernel) walk lane groups (lanes.cuh): a group of
// G lanes (a power of two, at most a warp) owns HPG heads of one
// destination, each head LPH lanes, each lane VPL vectors of VEC floats
// (or bytes) of the head, so the bytes in flight no longer depend on the
// row width.  A head may be cut into NSL slices, a group each.  The plan
// comes from segment_sum.gss_plan in Python (lane_plan, the search K3
// uses, plus slices and edges in flight), in blocks of 64 threads.  Over
// a whole graph (bound by the rows in flight on each SM) a 602-wide row
// of float2 is one warp of 10 vectors a lane, a 41-wide row 4 lanes of 11
// floats (eight destinations a warp, every lane working), 4 x 10 one
// lane of 5 float2 a head; a lane has one edge's row in flight (two at 4
// x 10), which keeps its registers few and the resident warps many.  Over
// a served or mini-batch block (bound by its slowest destination's
// latency) a 602-wide row is two warps of 5 float2 a lane with 4 edges'
// rows in flight (K4: 2).  Each group walks its destination's edges in
// chunks of G: lane j loads order, idx and, with one head, the
// coefficient (and column) of edge j of the chunk -- with K4 also scale
// and mn of its source -- and the group shares them by shuffles; then
// each lane issues the row loads of NE edges before their FMAs.  Every
// output element is still acc = fmaf(c, x, acc) from zero in edge order
// (K4: fmaf(c, fmaf(q, scale, mn), acc)), and a column is summed in edge
// order by the first lane of its head, so the results are bitwise those
// of one thread per column walking the edges, as before this design.  A
// lane takes its vectors LPH apart, so each load instruction of a head's
// lanes reads consecutive vectors (VPL consecutive vectors a lane ran up
// to 2x slower).  K4 reads a row of 602 bytes (2-byte aligned) as 16-bit
// words, each kept packed in one register until its FMA.
//   K2 gives each output row one block that walks its edge range, thread
// t owning vector columns t, t + blockDim.x, ...  K5 gives each warp 2
// listed edges and strides its lanes over their rows, 4 loads a lane in
// flight before the streaming stores; it reads each row once, in turn,
// when the caller passes the listed edges grouped by seg (GatherRows
// does when it has that layout).  K6 (edge_dot_lanes_kernel) walks lane
// groups over the dst-grouped layout as K1 does, under its own plan
// (segment_sum.edge_dot_plan): a group holds its destination's b row in
// registers, loaded once, and takes each edge's dot per head as a lane's
// fma chain over its vectors, then a butterfly of shuffles over the
// head's lanes (no atomics: bitwise repeatable), so each listed edge
// reads only its a row.  Loads are the widest vector (float4
// / float2 / float; 4, 2 or 1 bytes for K4) that divides the row
// width, the head width and the pointers' alignment, checked at launch:
// rows of 602 floats take float2, rows of 602 bytes two bytes a load.
#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

// K1's and K4's blocks: 64 threads ran 0-5 % faster than 256 at every K1
// and K4 shape of chip_smoke.py (scripts/k1_lane_plans.py, PERF.md)
constexpr int GSS_THREADS = 64;

template <int VEC>
struct VecT;
template <>
struct VecT<1> { using T = float; };
template <>
struct VecT<2> { using T = float2; };
template <>
struct VecT<4> { using T = float4; };

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
template <typename T>
__device__ __forceinline__ T zero_vec();
template <>
__device__ __forceinline__ float zero_vec<float>() { return 0.f; }
template <>
__device__ __forceinline__ float2 zero_vec<float2>() { return make_float2(0.f, 0.f); }
template <>
__device__ __forceinline__ float4 zero_vec<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// K2: one block per output row; thread t owns vector columns t, t +
// blockDim.x, ... and adds row e of msgs over the row's edges in order.
template <int VEC>
__global__ void segmented_rows_kernel(const float* __restrict__ rows,
                                      const int* __restrict__ order,
                                      const int* __restrict__ row_ptr,
                                      float* __restrict__ out, int F) {
  using T = typename VecT<VEC>::T;
  const int d = blockIdx.x;
  const int nvec = F / VEC;
  const int k0 = row_ptr[d];
  const int k1 = row_ptr[d + 1];
  T* out_row = reinterpret_cast<T*>(out + (size_t)d * F);
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    T acc = zero_vec<T>();
    for (int k = k0; k < k1; ++k) {
      const int e = __ldg(order + k);
      add_vec(acc, __ldg(reinterpret_cast<const T*>(rows + (size_t)e * F) + v));
    }
    out_row[v] = acc;
  }
}

// One vector of a gathered row in registers: VEC floats (K1), or VEC
// bytes (K4) dequantized where they are used
template <int VEC, bool Q>
struct RowVec {
  float x[VEC];
  __device__ __forceinline__ void load(const float* rows, const unsigned char*, size_t off) {
    lanes::load_vec<VEC>(rows + off, x);
  }
  __device__ __forceinline__ float at(int t, float, float) const { return x[t]; }
};
template <int VEC>
struct QWord;
template <>
struct QWord<1> { using T = unsigned char; };
template <>
struct QWord<2> { using T = unsigned short; };
template <>
struct QWord<4> { using T = unsigned int; };
// K4's VEC bytes stay packed in one register (little-endian: byte t is
// column t) until their FMA
template <int VEC>
struct RowVec<VEC, true> {
  unsigned int b;
  __device__ __forceinline__ void load(const float*, const unsigned char* q, size_t off) {
    b = __ldg(reinterpret_cast<const typename QWord<VEC>::T*>(q + off));
  }
  __device__ __forceinline__ float at(int t, float sc, float mn) const {
    // the codec's own arithmetic, mn + q * scale, as one fma
    return fmaf((float)((b >> (8 * t)) & 0xffu), sc, mn);
  }
};

// K1 (Q false) and K4 (Q true: uint8 rows, heads 1) over lane groups.
// Lane j of a group loads edge j of each chunk of G edges; the group
// shares e, s (and, with one head, c and the column; with K4, scale[s]
// and mn[s]) by shuffles, then every lane issues the row loads of NE
// edges before their FMAs, which run in edge order.  A lane's vector u
// is vector LPH * u + lih of its head's slice: the head's lanes read
// consecutive vectors at each load.
template <int VEC, int VPL, int NE, bool Q>
__global__ void __launch_bounds__(GSS_THREADS)
    gss_lanes_kernel(const float* __restrict__ rows, const unsigned char* __restrict__ q,
                     const float* __restrict__ mn, const float* __restrict__ scale,
                     const int* __restrict__ idx, const float* __restrict__ coef,
                     const float* __restrict__ col, const int* __restrict__ order,
                     const int* __restrict__ row_ptr, float* __restrict__ out,
                     float* __restrict__ col_out, int num_dst, int heads, int hd, int nsl,
                     int hpg, int lph, int G) {
  using lanes::FULL;
  // a head's NSL slices are the Lane's heads h * NSL .. h * NSL + NSL - 1
  const lanes::Lane ln(row_ptr, num_dst, heads * nsl, hpg, lph, VPL, G);
  const int h = ln.h / nsl;
  const int F = heads * hd;
  const int nvh = hd / VEC;
  const int vb = (ln.h % nsl) * lph * VPL + ln.lih;
  const size_t col0 = (size_t)h * hd;
  // with one head the coefficient and the column are per edge, loaded
  // once by the edge's lane; with several, each lane loads its head's
  const bool one = heads == 1;
  const bool has_col = col != nullptr;
  const bool col_owner = has_col && ln.live && ln.h % nsl == 0 && ln.lih == 0;
  float acc[VPL][VEC];
#pragma unroll
  for (int u = 0; u < VPL; ++u)
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc[u][t] = 0.f;
  float csum = 0.f;

  // chunks of G edges; the loop runs while any group of the warp has some
  for (int kc = ln.k0; __any_sync(FULL, kc < ln.k1); kc += G) {
    const int n = max(0, min(G, ln.k1 - kc));
    int my_e, my_s;
    ln.chunk(order, idx, kc, G, my_e, my_s);
    float my_c = 0.f, my_col = 0.f, my_sc = 0.f, my_mn = 0.f;
    if (ln.gl < n) {
      if (one) {
        my_c = __ldg(coef + my_e);
        if (has_col) my_col = __ldg(col + my_e);
      }
      if constexpr (Q) {
        my_sc = __ldg(scale + my_s);
        my_mn = __ldg(mn + my_s);
      }
    }
    const int nmax = __reduce_max_sync(FULL, n);
    for (int i0 = 0; i0 < nmax; i0 += NE) {
      // the rows of NE edges in flight
      int e[NE];
      RowVec<VEC, Q> x[NE][VPL];
#pragma unroll
      for (int j = 0; j < NE; ++j) {
        const int s = __shfl_sync(FULL, my_s, i0 + j, G);
        e[j] = __shfl_sync(FULL, my_e, i0 + j, G);
        if (!ln.live || i0 + j >= n) continue;
        const size_t row = (size_t)s * F + col0;
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          const int v = vb + u * lph;
          if (v < nvh) x[j][u].load(rows, q, row + (size_t)v * VEC);
        }
      }
      // their coefficients (columns, dequantization constants)
      float c[NE], cv[NE], sc[NE], mnv[NE];
#pragma unroll
      for (int j = 0; j < NE; ++j) {
        c[j] = cv[j] = sc[j] = mnv[j] = 0.f;
        if (one) {
          c[j] = __shfl_sync(FULL, my_c, i0 + j, G);
          if (has_col) cv[j] = __shfl_sync(FULL, my_col, i0 + j, G);
        }
        if constexpr (Q) {
          sc[j] = __shfl_sync(FULL, my_sc, i0 + j, G);
          mnv[j] = __shfl_sync(FULL, my_mn, i0 + j, G);
        }
        if (!one && ln.live && i0 + j < n) {
          const size_t eh = (size_t)e[j] * heads + h;
          c[j] = __ldg(coef + eh);
          if (col_owner) cv[j] = __ldg(col + eh);
        }
      }
      // the FMAs, edge by edge in order
#pragma unroll
      for (int j = 0; j < NE; ++j) {
        if (!ln.live || i0 + j >= n) continue;
#pragma unroll
        for (int u = 0; u < VPL; ++u)
#pragma unroll
          for (int t = 0; t < VEC; ++t)
            acc[u][t] = fmaf(c[j], x[j][u].at(t, sc[j], mnv[j]), acc[u][t]);
        if (col_owner) csum += cv[j];
      }
    }
  }
  if (!ln.live) return;
  float* out_row = out + (size_t)ln.d * F + col0;
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    const int v = vb + u * lph;
    if (v < nvh) lanes::store_vec<VEC>(out_row + (size_t)v * VEC, acc[u]);
  }
  if (col_owner) col_out[(size_t)ln.d * heads + h] = csum;
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

// K6 over lane groups on the dst-grouped layout: a group owns HPG heads
// of destination d, holds b[d]'s vectors of them in registers (loaded
// once) and walks d's edges in chunks of G, lane j loading order and
// idx of edge j of the chunk and the group sharing them by shuffles;
// each lane issues the loads of NE edges' vectors of a before their
// FMAs.  A lane's partial dot runs over its slices, then its vectors
// (vector LPH * u + lih of the slice), then their elements, as one fma
// each from zero; the head's LPH lanes then add their partials by a
// butterfly of shuffles (offsets LPH / 2 .. 1: every lane ends with the
// same sum) and the head's first lane writes out[e, h] once.  A head
// wider than a warp of ED_MAX_VPL vectors is cut into NSL slices that
// the same lanes walk in turn, b's slice reloaded (from L1) for each.
template <int VEC, int VPL, int NE>
__global__ void __launch_bounds__(GSS_THREADS)
    edge_dot_lanes_kernel(const float* __restrict__ a, const float* __restrict__ b,
                          const int* __restrict__ idx, const int* __restrict__ order,
                          const int* __restrict__ row_ptr, float* __restrict__ out, int num_dst,
                          int heads, int hd, int nsl, int hpg, int lph, int G) {
  using lanes::FULL;
  const lanes::Lane ln(row_ptr, num_dst, heads, hpg, lph, VPL, G);
  const int F = heads * hd;
  const int nvh = hd / VEC;
  const int sw = lph * VPL;   // vectors a slice
  const size_t col0 = (size_t)ln.h * hd;
  const bool has_edges = ln.live && ln.k1 > ln.k0;   // b[d] is read only then
  float bv[VPL][VEC];
  auto load_b = [&](int sl) {
#pragma unroll
    for (int u = 0; u < VPL; ++u) {
      const int v = sl * sw + ln.lih + u * lph;
      if (has_edges && v < nvh)
        lanes::load_vec<VEC>(b + (size_t)ln.d * F + col0 + (size_t)v * VEC, bv[u]);
      else
#pragma unroll
        for (int t = 0; t < VEC; ++t) bv[u][t] = 0.f;
    }
  };
  load_b(0);

  // chunks of G edges; the loop runs while any group of the warp has some
  for (int kc = ln.k0; __any_sync(FULL, kc < ln.k1); kc += G) {
    const int n = max(0, min(G, ln.k1 - kc));
    int my_e, my_s;
    ln.chunk(order, idx, kc, G, my_e, my_s);
    const int nmax = __reduce_max_sync(FULL, n);
    for (int i0 = 0; i0 < nmax; i0 += NE) {
      int e[NE], s[NE];
#pragma unroll
      for (int j = 0; j < NE; ++j) {
        s[j] = __shfl_sync(FULL, my_s, i0 + j, G);
        e[j] = __shfl_sync(FULL, my_e, i0 + j, G);
      }
      float dot[NE];
#pragma unroll
      for (int j = 0; j < NE; ++j) dot[j] = 0.f;
      for (int sl = 0; sl < nsl; ++sl) {
        if (nsl > 1) load_b(sl);
        // the vectors of NE edges in flight, then their FMAs in order
        float x[NE][VPL][VEC];
#pragma unroll
        for (int j = 0; j < NE; ++j)
#pragma unroll
          for (int u = 0; u < VPL; ++u) {
            const int v = sl * sw + ln.lih + u * lph;
            if (ln.live && i0 + j < n && v < nvh)
              lanes::load_vec<VEC>(a + (size_t)s[j] * F + col0 + (size_t)v * VEC, x[j][u]);
            else
#pragma unroll
              for (int t = 0; t < VEC; ++t) x[j][u][t] = 0.f;
          }
#pragma unroll
        for (int j = 0; j < NE; ++j)
#pragma unroll
          for (int u = 0; u < VPL; ++u)
#pragma unroll
            for (int t = 0; t < VEC; ++t) dot[j] = fmaf(x[j][u][t], bv[u][t], dot[j]);
      }
      // the head's lanes add their partials; its first lane writes
      for (int o = lph >> 1; o > 0; o >>= 1)
#pragma unroll
        for (int j = 0; j < NE; ++j) dot[j] += __shfl_xor_sync(FULL, dot[j], o);
#pragma unroll
      for (int j = 0; j < NE; ++j)
        if (ln.live && ln.lih == 0 && i0 + j < n) out[(size_t)e[j] * heads + ln.h] = dot[j];
    }
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

// The K1 / K4 plan's limits, as segment_sum.gss_plan sets them: VPL
// vectors a lane (1..GSS_MAX_VPL) and NE edges in flight, the most of 4,
// 2 and 1 whose NE * VPL * VEC gathered elements a lane fit a budget:
// GSS_WHOLE_WORDS over a whole graph and for K4, GSS_MAX_WORDS for K1
// over a block.  Only the instances a plan can pick are built
// (segment_sum.gss_built).
constexpr int GSS_MAX_VPL = 12;
constexpr int GSS_WHOLE_WORDS = 24;
constexpr int GSS_MAX_WORDS = 80;

constexpr int gss_ne(int words, int budget) {
  return 4 * words <= budget ? 4 : 2 * words <= budget ? 2 : 1;
}

constexpr bool gss_instance(int vec, int vpl, int ne, bool q) {
  return ne == gss_ne(vpl * vec, GSS_WHOLE_WORDS) ||
         (!q && ne == gss_ne(vpl * vec, GSS_MAX_WORDS));
}

struct GssArgs {
  const float* rows;
  const unsigned char* q;
  const float *mn, *scale;
  const int* idx;
  const float *coef, *col;
  const int *order, *row_ptr;
  float *out, *col_out;
  int num_dst, heads, hd, vec, hpg, lph, vpl, nsl, G, ne;
  cudaStream_t st;
};

template <int VEC, int VPL, int NE, bool Q>
static int gss_launch(const GssArgs& a) {
  if constexpr (!gss_instance(VEC, VPL, NE, Q)) {
    return (int)cudaErrorInvalidValue;
  } else {
    const int blocks = lanes::grid_blocks(a.num_dst, a.heads * a.nsl, a.hpg, a.G, GSS_THREADS);
    gss_lanes_kernel<VEC, VPL, NE, Q><<<blocks, GSS_THREADS, 0, a.st>>>(
        a.rows, a.q, a.mn, a.scale, a.idx, a.coef, a.col, a.order, a.row_ptr, a.out, a.col_out,
        a.num_dst, a.heads, a.hd, a.nsl, a.hpg, a.lph, a.G);
    return (int)cudaGetLastError();
  }
}

template <int VEC, int VPL, bool Q>
static int gss_by_ne(const GssArgs& a) {
  switch (a.ne) {
    case 1: return gss_launch<VEC, VPL, 1, Q>(a);
    case 2: return gss_launch<VEC, VPL, 2, Q>(a);
    case 4: return gss_launch<VEC, VPL, 4, Q>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int VEC, bool Q, int VPL = 1>
static int gss_by_vpl(const GssArgs& a) {
  if (a.vpl == VPL) return gss_by_ne<VEC, VPL, Q>(a);
  if constexpr (VPL < GSS_MAX_VPL) return gss_by_vpl<VEC, Q, VPL + 1>(a);
  return (int)cudaErrorInvalidValue;
}

// the plan's checks: G a power of two up to a warp holding HPG * LPH
// lanes, LPH a power of two, NSL slices of LPH * VPL vectors of VEC
// covering hd, a built instance, and pointers aligned to the vector
template <bool Q>
static int gss_dispatch(const GssArgs& a, uintptr_t byte_bits) {
  const bool pow2 = a.G > 0 && a.G <= 32 && (a.G & (a.G - 1)) == 0 && a.lph > 0 &&
                    (a.lph & (a.lph - 1)) == 0;
  const int vec = a.vec;
  const bool vec_ok = (vec == 1 || vec == 2 || vec == 4) && a.hd % vec == 0;
  if (!pow2 || !vec_ok || a.hpg < 1 || a.hpg * a.lph > a.G || a.nsl < 1 || a.vpl < 1 ||
      a.vpl > GSS_MAX_VPL || (long long)a.nsl * a.lph * a.vpl * vec < a.hd ||
      byte_bits % (uintptr_t)(Q ? vec : 4 * vec) != 0 ||
      (reinterpret_cast<uintptr_t>(a.out) % (uintptr_t)(4 * vec)) != 0)
    return (int)cudaErrorInvalidValue;
  if (vec == 4) return gss_by_vpl<4, Q>(a);
  if (vec == 2) return gss_by_vpl<2, Q>(a);
  return gss_by_vpl<1, Q>(a);
}

// K6's plan limits, as segment_sum.edge_dot_plan sets them: VPL vectors a
// lane (1..ED_MAX_VPL) and NE edges in flight, the most of 4, 2 and 1
// whose NE * VPL * VEC elements of a a lane fit ED_WORDS (b's vectors
// take registers of their own)
constexpr int ED_MAX_VPL = 8;
constexpr int ED_WORDS = 32;

template <int VEC, int VPL = 1>
static int edge_dot_by_vpl(const float* a, const float* b, const int* idx, const int* order,
                           const int* row_ptr, float* out, int num_dst, int heads, int hd,
                           int vpl, int nsl, int hpg, int lph, int G, cudaStream_t st) {
  if (vpl == VPL) {
    constexpr int NE = gss_ne(VPL * VEC, ED_WORDS);
    const int blocks = lanes::grid_blocks(num_dst, heads, hpg, G, GSS_THREADS);
    edge_dot_lanes_kernel<VEC, VPL, NE><<<blocks, GSS_THREADS, 0, st>>>(
        a, b, idx, order, row_ptr, out, num_dst, heads, hd, nsl, hpg, lph, G);
    return (int)cudaGetLastError();
  }
  if constexpr (VPL < ED_MAX_VPL)
    return edge_dot_by_vpl<VEC, VPL + 1>(a, b, idx, order, row_ptr, out, num_dst, heads, hd,
                                         vpl, nsl, hpg, lph, G, st);
  return (int)cudaErrorInvalidValue;
}

// K1, under the lane plan (vec, hpg, lph, vpl, nsl, G) with NE edges in
// flight; with col (E, heads) and col_out (num_dst, heads) given, also
// the column's segment sum
extern "C" int gss_forward(const float* h, const int* idx, const float* coef, const float* col,
                           const int* order, const int* row_ptr, float* out, float* col_out,
                           int num_dst, int F, int heads, int vec, int hpg, int lph, int vpl,
                           int nsl, int G, int ne, void* stream) {
  if (heads < 1 || F % heads != 0) return (int)cudaErrorInvalidValue;
  const GssArgs a{h,     nullptr, nullptr, nullptr, idx, coef, col, order, row_ptr,
                  out,   col_out, num_dst, heads,   F / heads, vec, hpg, lph, vpl,
                  nsl,   G,       ne,      static_cast<cudaStream_t>(stream)};
  return gss_dispatch<false>(a, reinterpret_cast<uintptr_t>(h));
}

extern "C" int seg_forward(const float* msgs, const int* order, const int* row_ptr, float* out,
                           int num_dst, int F, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(msgs) | reinterpret_cast<uintptr_t>(out) |
                      (uintptr_t)(4 * F);
  const int vec = vec_width(a, 4, F);
  const int threads = block_threads(F / vec);
  if (vec == 4)
    segmented_rows_kernel<4><<<num_dst, threads, 0, st>>>(msgs, order, row_ptr, out, F);
  else if (vec == 2)
    segmented_rows_kernel<2><<<num_dst, threads, 0, st>>>(msgs, order, row_ptr, out, F);
  else
    segmented_rows_kernel<1><<<num_dst, threads, 0, st>>>(msgs, order, row_ptr, out, F);
  return (int)cudaGetLastError();
}

// K4 (one head), under the lane plan (vec, lph, vpl, nsl, G) with NE
// edges in flight; vec bytes of a row, and of the output row vec floats
extern "C" int gssq_forward(const unsigned char* q, const float* mn, const float* scale,
                            const int* idx, const float* coef, const int* order,
                            const int* row_ptr, float* out, int num_dst, int F, int vec, int lph,
                            int vpl, int nsl, int G, int ne, void* stream) {
  const GssArgs a{nullptr, q,   mn,  scale, idx, coef, nullptr, order, row_ptr,
                  out,     nullptr, num_dst, 1, F, vec, 1, lph, vpl,
                  nsl,     G,   ne,  static_cast<cudaStream_t>(stream)};
  return gss_dispatch<true>(a, reinterpret_cast<uintptr_t>(q));
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

// K6 over the dst-grouped layout under the lane plan (vec, hpg, lph,
// vpl, nsl, G) of segment_sum.edge_dot_plan: out[e, h] for the listed
// edges (out is (E, heads); unlisted edges are not written)
extern "C" int edge_dot(const float* a, const float* b, const int* src, const int* order,
                        const int* row_ptr, float* out, int num_dst, int F, int heads, int vec,
                        int hpg, int lph, int vpl, int nsl, int G, void* stream) {
  if (heads < 1 || F % heads != 0) return (int)cudaErrorInvalidValue;
  const int hd = F / heads;
  const bool pow2 = G > 0 && G <= 32 && (G & (G - 1)) == 0 && lph > 0 && (lph & (lph - 1)) == 0;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  if (!pow2 || !(vec == 1 || vec == 2 || vec == 4) || hd % vec != 0 || hpg < 1 ||
      hpg * lph > G || nsl < 1 || vpl < 1 || vpl > ED_MAX_VPL ||
      (long long)nsl * lph * vpl * vec < hd || bits % (uintptr_t)(4 * vec) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    return edge_dot_by_vpl<4>(a, b, src, order, row_ptr, out, num_dst, heads, hd, vpl, nsl, hpg,
                              lph, G, st);
  if (vec == 2)
    return edge_dot_by_vpl<2>(a, b, src, order, row_ptr, out, num_dst, heads, hd, vpl, nsl, hpg,
                              lph, G, st);
  return edge_dot_by_vpl<1>(a, b, src, order, row_ptr, out, num_dst, heads, hd, vpl, nsl, hpg,
                            lph, G, st);
}
