// Lane groups over a grouped edge layout, shared by the gather kernels of
// segment_sum.cu (K1, K4) and gat_fused.cu (K3 and its VJP's destination
// pass).
//
// A group of G lanes (a power of two, at most a warp) owns HPG heads of
// one destination, so a destination takes ceil(heads / HPG) groups; each
// head gets LPH lanes, each lane VPL vectors of VEC floats of it.  The
// plan comes from Python (segment_sum.lane_plan); a vector never
// straddles a head.
#pragma once
#include <cuda_runtime.h>

namespace lanes {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (VEC == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

// Where a lane sits: its destination d and its head h (group gid takes
// heads hb * HPG .. hb * HPG + HPG - 1 of destination d, gid = d * nhb +
// hb), its place lih among the head's LPH lanes and its first vector v0
// within the head; `live` lanes own columns of a real destination.
// k0..k1 is the destination's edge range.  K1 and K4 pass heads * NSL
// (virtual) heads and take head hv / NSL, slice hv % NSL of lane head hv.
struct Lane {
  int gl, d, h, lih, v0, k0, k1;
  bool has_d, live;
  __device__ Lane(const int* row_ptr, int num_dst, int heads, int hpg, int lph, int vpl, int G) {
    gl = threadIdx.x & (G - 1);
    const long long gid = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / G;
    const int nhb = (heads + hpg - 1) / hpg;
    has_d = gid / nhb < num_dst;
    d = has_d ? (int)(gid / nhb) : 0;
    h = (int)(gid % nhb) * hpg + gl / lph;
    live = has_d && gl / lph < hpg && h < heads;
    lih = gl % lph;
    v0 = lih * vpl;
    k0 = has_d ? __ldg(row_ptr + d) : 0;
    k1 = has_d ? __ldg(row_ptr + d + 1) : 0;
  }
  // this lane's edge of the chunk of G edges from kc: e = order[kc + gl],
  // s = idx[e] (0 past the range)
  __device__ void chunk(const int* order, const int* idx, int kc, int G, int& e, int& s) const {
    e = s = 0;
    if (gl < min(G, k1 - kc)) {
      e = __ldg(order + kc + gl);
      s = __ldg(idx + e);
    }
  }
};

// every (destination, head block) gets a group; a block of `threads`
// holds threads / G
static inline int grid_blocks(int num_dst, int heads, int hpg, int G, int threads = THREADS) {
  const long long groups = (long long)num_dst * ((heads + hpg - 1) / hpg);
  const int per_block = threads / G;
  return (int)((groups + per_block - 1) / per_block);
}

}  // namespace lanes
