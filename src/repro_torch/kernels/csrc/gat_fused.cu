// GAT attention aggregation (K3) and the destination pass of its VJP for
// Hopper (sm_90a).
//
// K3  gat_forward   for destination d and head h, over the edges
//     k in [row_ptr[d], row_ptr[d+1]) (e = order[k], s = edge_src[e]):
//       z_e   = leaky_relu(es[s, h] + ed[d, h], 0.2)
//       m     = max_e z_e
//       l     = sum_e exp(z_e - m)
//       out[d, h*hd:(h+1)*hd] = (sum_e exp(z_e - m) * hs[s, h*hd:(h+1)*hd])
//                               / (l + 1e-9)
//     replaces src/repro/kernels/gat_fused.py:132 (_gat_impl, whose
//     pallas_call is at :163; kernel body _gat_kernel :68), reached
//     through gat_fused_attention_pallas :252.  When m_out and l_out are
//     given (a gradient is wanted), the kernel also stores each head's
//     final m and l there: the VJP recomputes the alphas from them.
//
// VJP gat_backward_dst   the destination pass of the VJP of K3
//     (src/repro/kernels/gat_fused.py:217, _gat_bwd): for destination d
//     and head h, over the same edges, with the forward's m and l,
//       alpha_e  = exp(z_e - m) / (l + 1e-9)
//       dalpha_e = <g[d, h-th slice], hs[s, h-th slice]>
//       s_dh     = sum_e alpha_e * dalpha_e
//       dpre_e   = alpha_e * (dalpha_e - s_dh) * (pre_e >= 0 ? 1 : 0.2)
//       ded[d, h] = sum_e dpre_e
//     and writes alpha and dpre (E, heads) for the source pass, which is
//     K1 over the src-grouped layout (segment_sum.cu, gss_forward with a
//     column): dhs[s] = sum_e alpha_e * g[dst_e], des[s, h] = sum_e dpre_e.
//     The reference takes dalpha from its _edge_dot kernel
//     (segment_sum.py:411) and the three sums from segment_sum; here they
//     are registers of one pass.
//
// (order, row_ptr) is the dst-grouped layout DeviceGraph builds on the
// host with the masked edges left out, so a masked edge is never read (its
// alpha and dpre stay the zeros the wrapper fills in), and a destination
// with no valid edge emits 0 / (0 + 1e-9) = 0 and a zero ded, as the
// reference does.
//
// Bounds.  A few operations per gathered element, so bytes bound both:
//   K3:  4*(U*H*hd + D*H*hd + U*H + D*H) + 12*E  (U <= E distinct source
//        rows of hs and es read, ed read and out written once, order +
//        edge_src per edge and row_ptr per destination; 8*D*H more when m
//        and l are stored)
//   dst pass: 4*(U*H*hd + D*H*hd + U*H + 3*D*H) + 8*E*H + 12*E + 4*D*H
//        (g, ed, m, l read and ded written once; alpha and dpre written)
// over 3.35 TB/s.  On GAT's graph the sources of a destination's edges
// lie anywhere in hs, so each edge reads a whole row from device memory
// and a gather of E rows, not the U distinct ones the bound counts, is
// what the card can reach (K1 over the same layout, a plain gather-sum of
// the same rows, takes about 2.5x that bound).
//
// What the design does about it.  A group of G lanes (a power of two, at
// most a warp) owns HPG heads of one destination; a block of 256 threads
// holds 256 / G groups.  Each head gets LPH
// lanes (a power of two), each lane VPL vectors of VEC floats of one
// head, VEC the widest load that divides hd, so a destination's row is
// read as whole vectors by lanes that all work: at hd 64, float4, 4
// lanes of 4 float4 a head, two destinations a warp; at hd 10, float2,
// one lane of 5 float2 a head, eight destinations a warp
// (segment_sum.lane_plan in Python makes the plan, lanes.cuh holds the
// Lane walk K1 and K4 share; over a whole graph the plan gives a lane 16
// floats, over a served block 8, whichever ran faster on the card).
// Each group walks its destination's edges once, one edge a
// step: lane j loads the order and edge_src entries of edge j of a chunk
// of G edges and the group shares them by shuffles.  The forward keeps a
// running max with a rescaled denominator and accumulator (the
// reference's online softmax); the dst pass reduces each head's dot
// product over its LPH lanes by a fixed xor-shuffle tree, so every lane
// of the head holds the same dalpha, and s_dh is a register sum in edge
// order.  The dst pass then walks the edges a second time, without the
// rows, the head's lanes taking every LPH-th edge: each lane kept its
// first edge's alpha and dalpha in registers (at degree 3 and 4 or 8
// lanes a head, the only one), the first walk left the others' dalpha in
// dpre's slot, stored by the lane that reads it back, and ded is the
// lanes' sums added by the same xor tree.  No atomics and a fixed
// summation order: the results are bitwise repeatable.
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

using lanes::FULL;
using lanes::Lane;
using lanes::load_vec;
using lanes::store_vec;
using lanes::THREADS;
constexpr float NEG_INF = -1e30f;
constexpr float SLOPE = 0.2f;

template <int VEC, int VPL>
__global__ void __launch_bounds__(THREADS)
    gat_forward_kernel(const float* __restrict__ hs, const float* __restrict__ es,
                       const float* __restrict__ ed, const int* __restrict__ edge_src,
                       const int* __restrict__ order, const int* __restrict__ row_ptr,
                       float* __restrict__ out, float* __restrict__ m_out,
                       float* __restrict__ l_out, int num_dst, int heads, int hd, int hpg,
                       int lph, int G) {
  const Lane ln(row_ptr, num_dst, heads, hpg, lph, VPL, G);
  const int width = heads * hd;
  const int nvh = hd / VEC;
  const float* cols = hs + (size_t)ln.h * hd + (size_t)ln.v0 * VEC;
  const float edh = ln.live ? __ldg(ed + (size_t)ln.d * heads + ln.h) : 0.f;
  float m = NEG_INF, l = 0.f;
  float acc[VPL][VEC];
#pragma unroll
  for (int u = 0; u < VPL; ++u)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[u][j] = 0.f;

  // chunks of G edges; the loop runs while any group of the warp has some
  for (int kc = ln.k0; __any_sync(FULL, kc < ln.k1); kc += G) {
    const int n = max(0, min(G, ln.k1 - kc));
    int my_e, my_s;
    ln.chunk(order, edge_src, kc, G, my_e, my_s);
    const int nmax = __reduce_max_sync(FULL, n);
    for (int i = 0; i < nmax; ++i) {
      const int src = __shfl_sync(FULL, my_s, i, G);
      if (!ln.live || i >= n) continue;
      const float pre = __ldg(es + (size_t)src * heads + ln.h) + edh;
      const float z = pre >= 0.f ? pre : SLOPE * pre;
      const float* row = cols + (size_t)src * width;
      float x[VPL][VEC];
#pragma unroll
      for (int u = 0; u < VPL; ++u) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) x[u][j] = 0.f;
        if (ln.v0 + u < nvh) load_vec<VEC>(row + u * VEC, x[u]);
      }
      // the online softmax: rescale the running sums to the new max (by 1
      // when it held; by 0 at the first edge, whose m is NEG_INF)
      const float mb = fmaxf(m, z);
      const float c = expf(m - mb);
      const float p = expf(z - mb);
      l = l * c + p;
#pragma unroll
      for (int u = 0; u < VPL; ++u)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[u][j] = fmaf(p, x[u][j], acc[u][j] * c);
      m = mb;
    }
  }
  if (!ln.live) return;
  float* out_row = out + (size_t)ln.d * width + (size_t)ln.h * hd + (size_t)ln.v0 * VEC;
  const float den = l + 1e-9f;
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
    if (ln.v0 + u >= nvh) continue;
    float y[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) y[j] = acc[u][j] / den;
    store_vec<VEC>(out_row + u * VEC, y);
  }
  if (ln.v0 == 0 && m_out != nullptr) {
    m_out[(size_t)ln.d * heads + ln.h] = m;
    l_out[(size_t)ln.d * heads + ln.h] = l;
  }
}

template <int VEC, int VPL>
__global__ void __launch_bounds__(THREADS)
    gat_backward_dst_kernel(const float* __restrict__ g, const float* __restrict__ hs,
                            const float* __restrict__ es, const float* __restrict__ ed,
                            const float* __restrict__ m_in, const float* __restrict__ l_in,
                            const int* __restrict__ edge_src, const int* __restrict__ order,
                            const int* __restrict__ row_ptr, float* alpha, float* dpre,
                            float* __restrict__ ded, int num_dst, int heads, int hd, int hpg,
                            int lph, int G) {
  const Lane ln(row_ptr, num_dst, heads, hpg, lph, VPL, G);
  const int width = heads * hd;
  const int nvh = hd / VEC;
  const size_t col0 = (size_t)ln.h * hd + (size_t)ln.v0 * VEC;
  const float* cols = hs + col0;
  const size_t dh = (size_t)ln.d * heads + ln.h;
  float gv[VPL][VEC];
#pragma unroll
  for (int u = 0; u < VPL; ++u) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) gv[u][j] = 0.f;
    if (ln.live && ln.v0 + u < nvh) load_vec<VEC>(g + (size_t)ln.d * width + col0 + u * VEC, gv[u]);
  }
  float edh = 0.f, mdh = 0.f, den = 1.f;
  if (ln.live) {
    edh = __ldg(ed + dh);
    mdh = __ldg(m_in + dh);
    den = __ldg(l_in + dh) + 1e-9f;
  }
  float s_dh = 0.f;
  // the lane's first edge of walk 2 (k0 + lih) stays in registers
  int e1 = -1;
  float a1 = 0.f, da1 = 0.f, slope1 = 1.f;

  // walk 1: alpha and dalpha per edge, s_dh in edge order
  for (int kc = ln.k0; __any_sync(FULL, kc < ln.k1); kc += G) {
    const int n = max(0, min(G, ln.k1 - kc));
    int my_e, my_s;
    ln.chunk(order, edge_src, kc, G, my_e, my_s);
    const int nmax = __reduce_max_sync(FULL, n);
    for (int i = 0; i < nmax; ++i) {
      const int e = __shfl_sync(FULL, my_e, i, G);
      const int src = __shfl_sync(FULL, my_s, i, G);
      const bool ok = ln.live && i < n;
      float part = 0.f, esv = 0.f;
      if (ok) {
        esv = __ldg(es + (size_t)src * heads + ln.h);
        const float* row = cols + (size_t)src * width;
#pragma unroll
        for (int u = 0; u < VPL; ++u) {
          if (ln.v0 + u >= nvh) continue;
          float x[VEC];
          load_vec<VEC>(row + u * VEC, x);
#pragma unroll
          for (int j = 0; j < VEC; ++j) part = fmaf(gv[u][j], x[j], part);
        }
      }
      // the head's LPH lanes are an aligned run of lanes: a fixed xor tree
      // leaves the same sum in each of them
      for (int o = lph >> 1; o > 0; o >>= 1) part += __shfl_xor_sync(FULL, part, o);
      if (!ok) continue;
      const float pre = esv + edh;
      const float z = pre >= 0.f ? pre : SLOPE * pre;
      const float a = expf(z - mdh) / den;
      s_dh = fmaf(a, part, s_dh);
      // the head's lane that takes the edge in walk 2, the (k - k0) %
      // LPH-th, stores alpha and keeps dalpha: in registers for its first
      // edge, in dpre's slot for the others
      if (i % lph == ln.lih) {
        alpha[(size_t)e * heads + ln.h] = a;
        if (kc + i == ln.k0 + ln.lih) {
          e1 = e;
          a1 = a;
          da1 = part;
          slope1 = pre >= 0.f ? 1.f : SLOPE;
        } else {
          dpre[(size_t)e * heads + ln.h] = part;   // dalpha, until walk 2
        }
      }
    }
  }
  // walk 2: dpre and ded, the head's LPH lanes taking every LPH-th edge;
  // past the first, alpha and dalpha are each lane's own stores of walk 1
  float ded_dh = 0.f;
  if (e1 >= 0) {
    ded_dh = a1 * (da1 - s_dh) * slope1;
    dpre[(size_t)e1 * heads + ln.h] = ded_dh;
  }
  if (ln.live) {
    for (int k = ln.k0 + ln.lih + lph; k < ln.k1; k += lph) {
      const int e = __ldg(order + k);
      const size_t eh = (size_t)e * heads + ln.h;
      const float pre = __ldg(es + (size_t)__ldg(edge_src + e) * heads + ln.h) + edh;
      const float dp = alpha[eh] * (dpre[eh] - s_dh) * (pre >= 0.f ? 1.f : SLOPE);
      dpre[eh] = dp;
      ded_dh += dp;
    }
  }
  for (int o = lph >> 1; o > 0; o >>= 1) ded_dh += __shfl_xor_sync(FULL, ded_dh, o);
  if (ln.live && ln.lih == 0) ded[dh] = ded_dh;
}

template <int VEC, int VPL>
static void launch_forward(cudaStream_t st, const float* hs, const float* es, const float* ed,
                           const int* edge_src, const int* order, const int* row_ptr, float* out,
                           float* m_out, float* l_out, int num_dst, int heads, int hd, int hpg,
                           int lph, int G) {
  const int blocks = lanes::grid_blocks(num_dst, heads, hpg, G);
  gat_forward_kernel<VEC, VPL><<<blocks, THREADS, 0, st>>>(
      hs, es, ed, edge_src, order, row_ptr, out, m_out, l_out, num_dst, heads, hd, hpg, lph, G);
}

template <int VEC, int VPL>
static void launch_backward_dst(cudaStream_t st, const float* g, const float* hs,
                                const float* es, const float* ed, const float* m, const float* l,
                                const int* edge_src, const int* order, const int* row_ptr,
                                float* alpha, float* dpre, float* ded, int num_dst, int heads,
                                int hd, int hpg, int lph, int G) {
  const int blocks = lanes::grid_blocks(num_dst, heads, hpg, G);
  gat_backward_dst_kernel<VEC, VPL><<<blocks, THREADS, 0, st>>>(
      g, hs, es, ed, m, l, edge_src, order, row_ptr, alpha, dpre, ded, num_dst, heads, hd, hpg,
      lph, G);
}

// one instance per (VEC, VPL) the lane plan can pick
#define GAT_DISPATCH(LAUNCH, VEC, ...)                       \
  switch (vpl) {                                             \
    case 1: LAUNCH<VEC, 1>(__VA_ARGS__); break;              \
    case 2: LAUNCH<VEC, 2>(__VA_ARGS__); break;              \
    case 3: LAUNCH<VEC, 3>(__VA_ARGS__); break;              \
    case 4: LAUNCH<VEC, 4>(__VA_ARGS__); break;              \
    case 5: LAUNCH<VEC, 5>(__VA_ARGS__); break;              \
    case 6: LAUNCH<VEC, 6>(__VA_ARGS__); break;              \
    case 7: LAUNCH<VEC, 7>(__VA_ARGS__); break;              \
    case 8: LAUNCH<VEC, 8>(__VA_ARGS__); break;              \
    default: return (int)cudaErrorInvalidValue;              \
  }

// the plan's checks: G a power of two up to a warp holding HPG * LPH
// lanes, LPH a power of two, VPL vectors of VEC floats covering hd
static bool plan_ok(int heads, int hd, int vec, int hpg, int lph, int vpl, int G) {
  const bool pow2 = G > 0 && G <= 32 && (G & (G - 1)) == 0 && lph > 0 && (lph & (lph - 1)) == 0;
  return pow2 && hpg > 0 && hpg <= heads && hpg * lph <= G && vpl >= 1 && vpl <= 8 &&
         (vec == 1 || vec == 2 || vec == 4) && hd % vec == 0 && lph * vpl * vec >= hd;
}

}  // namespace

extern "C" int gat_forward(const float* hs, const float* es, const float* ed, const int* edge_src,
                           const int* order, const int* row_ptr, float* out, float* m_out,
                           float* l_out, int num_dst, int heads, int hd, int vec, int hpg,
                           int lph, int vpl, int G, void* stream) {
  if (!plan_ok(heads, hd, vec, hpg, lph, vpl, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    GAT_DISPATCH(launch_forward, 4, st, hs, es, ed, edge_src, order, row_ptr, out, m_out, l_out,
                 num_dst, heads, hd, hpg, lph, G)
  } else if (vec == 2) {
    GAT_DISPATCH(launch_forward, 2, st, hs, es, ed, edge_src, order, row_ptr, out, m_out, l_out,
                 num_dst, heads, hd, hpg, lph, G)
  } else {
    GAT_DISPATCH(launch_forward, 1, st, hs, es, ed, edge_src, order, row_ptr, out, m_out, l_out,
                 num_dst, heads, hd, hpg, lph, G)
  }
  return (int)cudaGetLastError();
}

extern "C" int gat_backward_dst(const float* g, const float* hs, const float* es, const float* ed,
                                const float* m, const float* l, const int* edge_src,
                                const int* order, const int* row_ptr, float* alpha, float* dpre,
                                float* ded, int num_dst, int heads, int hd, int vec, int hpg,
                                int lph, int vpl, int G, void* stream) {
  if (!plan_ok(heads, hd, vec, hpg, lph, vpl, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    GAT_DISPATCH(launch_backward_dst, 4, st, g, hs, es, ed, m, l, edge_src, order, row_ptr,
                 alpha, dpre, ded, num_dst, heads, hd, hpg, lph, G)
  } else if (vec == 2) {
    GAT_DISPATCH(launch_backward_dst, 2, st, g, hs, es, ed, m, l, edge_src, order, row_ptr,
                 alpha, dpre, ded, num_dst, heads, hd, hpg, lph, G)
  } else {
    GAT_DISPATCH(launch_backward_dst, 1, st, g, hs, es, ed, m, l, edge_src, order, row_ptr,
                 alpha, dpre, ded, num_dst, heads, hd, hpg, lph, G)
  }
  return (int)cudaGetLastError();
}
