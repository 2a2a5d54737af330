// One-pass fused GAT attention aggregation for Hopper (sm_90a).
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
//     given (a gradient is wanted), lane 0 of each warp also stores its
//     head's final m and l there: the VJP (gat_fused.py:217) recomputes
//     the alphas elementwise from them.
//
// (order, row_ptr) is the dst-grouped layout DeviceGraph builds on the
// host with the masked edges left out, so a masked edge is never read,
// and a destination with no valid edge emits 0 / (0 + 1e-9) = 0, as the
// reference does.
//
// Bound.  A few operations per gathered element, so bytes bound it:
//   4*(U*H*hd + D*H*hd + U*H + D*H) + 12*E bytes  (U <= E distinct
//   source rows of hs and es read, ed read and out written once, order +
//   edge_src per edge and row_ptr per destination; the TPU formula
//   4*(E*H*hd + D*H*hd + E*H + D*H) + 12*E when every edge has its own
//   source; 8*D*H more when m and l are stored)
// over 3.35 TB/s.  What the design does about it: one block per
// destination, one warp per head, lanes across hd.  Each warp walks its
// destination's edge range twice, first for the max, then for the
// denominator and the weighted sum, so edge logits and alphas live only
// in registers and never reach device memory.  Every lane keeps the same
// running m and l (recomputed per lane: a handful of flops per edge) and
// its own hd columns of the accumulator; sums run in edge order with no
// atomics, so results are bitwise repeatable.  The working set does not
// depend on num_src.  The VJP needs no kernel of its own: it is K1 over
// the src-grouped layout (dhs), K6 (dalpha) and K2 (the three sums) in
// segment_sum.cu, with the alphas recomputed from m and l.
#include <cuda_runtime.h>

__global__ void gat_attention_kernel(const float* __restrict__ hs, const float* __restrict__ es,
                                     const float* __restrict__ ed,
                                     const int* __restrict__ edge_src,
                                     const int* __restrict__ order,
                                     const int* __restrict__ row_ptr, float* __restrict__ out,
                                     float* __restrict__ m_out, float* __restrict__ l_out,
                                     int heads, int hd) {
  const int d = blockIdx.x;
  const int h = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (h >= heads) return;
  const int k0 = row_ptr[d];
  const int k1 = row_ptr[d + 1];
  const int width = heads * hd;
  const float ed_dh = ed[(size_t)d * heads + h];

  float m = -1e30f;
  for (int k = k0; k < k1; ++k) {
    const int s = __ldg(edge_src + __ldg(order + k));
    float z = __ldg(es + (size_t)s * heads + h) + ed_dh;
    z = z >= 0.f ? z : 0.2f * z;
    m = fmaxf(m, z);
  }

  float* out_row = out + (size_t)d * width + (size_t)h * hd;
  // at least one sweep, so l is computed (and stored) even when hd == 0
  for (int j0 = 0; j0 < hd || j0 == 0; j0 += 32) {
    const int j = j0 + lane;
    float l = 0.f;
    float acc = 0.f;
    for (int k = k0; k < k1; ++k) {
      const int s = __ldg(edge_src + __ldg(order + k));
      float z = __ldg(es + (size_t)s * heads + h) + ed_dh;
      z = z >= 0.f ? z : 0.2f * z;
      const float p = expf(z - m);
      l += p;
      if (j < hd) acc = fmaf(p, __ldg(hs + (size_t)s * width + (size_t)h * hd + j), acc);
    }
    if (j < hd) out_row[j] = acc / (l + 1e-9f);
    if (j0 == 0 && lane == 0 && m_out != nullptr) {
      m_out[(size_t)d * heads + h] = m;
      l_out[(size_t)d * heads + h] = l;
    }
  }
}

extern "C" int gat_forward(const float* hs, const float* es, const float* ed, const int* edge_src,
                           const int* order, const int* row_ptr, float* out, float* m_out,
                           float* l_out, int num_dst, int heads, int hd, void* stream) {
  gat_attention_kernel<<<num_dst, 32 * heads, 0, static_cast<cudaStream_t>(stream)>>>(
      hs, es, ed, edge_src, order, row_ptr, out, m_out, l_out, heads, hd);
  return (int)cudaGetLastError();
}
