// Destination-grouped segmented reductions for Hopper (sm_90a).
//
// K1  gss_forward   out[d] = sum_{k in [row_ptr[d], row_ptr[d+1])}
//                             coef[order[k]] * h[edge_src[order[k]]]
//     replaces src/repro/kernels/segment_sum.py:320 (_fused_impl, whose
//     pallas_call is at :345; kernel body _fused_kernel :287), reached
//     through gather_scale_segment_sum_pallas :456.
// K2  seg_forward   out[d] = sum_{k in [row_ptr[d], row_ptr[d+1])}
//                             msgs[order[k]]
//     replaces src/repro/kernels/segment_sum.py:138 (_scatter_add, whose
//     pallas_call is at :152; kernel body _scatter_kernel :111), reached
//     through segment_sum_pallas :260.
//
// (order, row_ptr) is the dst-grouped layout DeviceGraph builds on the
// host: order lists the edges (masked pad slots left out) stably sorted
// by destination, row_ptr[d]..row_ptr[d+1] is destination d's range.
//
// Bound.  Both kernels do one multiply-add per gathered element, far
// below the card's float32 rate, so they are bound by bytes:
//   K1: 4*(U*F + D*F) + 12*E bytes  (U <= E distinct source rows read,
//       D*F written, order + edge_src + coef per edge; 4*(E*F + D*F) +
//       12*E when every edge reads its own row)
//   K2: 4*(E*F + D*F) + 8*E bytes   (every message row is read once)
// over 3.35 TB/s.  What the design does about it: the TPU kernel builds
// one-hot matrices because a TPU has no efficient scatter; here each
// block owns one destination row and walks its edge range, so the (E, F)
// message tensor of K1 never exists, every output row is written once
// with no atomics (the sum runs in edge order: bitwise repeatable), and
// the working set is a few registers per thread whatever num_src is.
// Threads stride over features with the widest vector load (float4 /
// float2 / float) that divides F, so neighbouring threads read
// neighbouring addresses of the gathered row.
#include <cuda_runtime.h>
#include <stdint.h>

template <int VEC>
struct VecT;
template <>
struct VecT<1> { using T = float; };
template <>
struct VecT<2> { using T = float2; };
template <>
struct VecT<4> { using T = float4; };

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
template <typename T>
__device__ __forceinline__ T zero_vec();
template <>
__device__ __forceinline__ float zero_vec<float>() { return 0.f; }
template <>
__device__ __forceinline__ float2 zero_vec<float2>() { return make_float2(0.f, 0.f); }
template <>
__device__ __forceinline__ float4 zero_vec<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// One block per destination row; thread t owns vector columns
// t, t + blockDim.x, ...  SCALED selects K1 (gather h[edge_src[e]],
// scale by coef[e]) or K2 (row e of msgs, coefficient 1).
template <int VEC, bool SCALED>
__global__ void segmented_rows_kernel(const float* __restrict__ rows,
                                      const int* __restrict__ edge_src,
                                      const float* __restrict__ coef,
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
      if constexpr (SCALED) {
        const int s = __ldg(edge_src + e);
        const float c = __ldg(coef + e);
        const T x = __ldg(reinterpret_cast<const T*>(rows + (size_t)s * F) + v);
        fma_vec(acc, c, x);
      } else {
        const T x = __ldg(reinterpret_cast<const T*>(rows + (size_t)e * F) + v);
        add_vec(acc, x);
      }
    }
    out_row[v] = acc;
  }
}

static int vec_width(const void* rows, const void* out, int F) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(rows) | reinterpret_cast<uintptr_t>(out);
  if (F % 4 == 0 && a % 16 == 0) return 4;
  if (F % 2 == 0 && a % 8 == 0) return 2;
  return 1;
}

template <bool SCALED>
static int launch(const float* rows, const int* edge_src, const float* coef, const int* order,
                  const int* row_ptr, float* out, int num_dst, int F, cudaStream_t stream) {
  const int vec = vec_width(rows, out, F);
  const int nvec = F / vec;
  int threads = ((nvec + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  if (threads < 32) threads = 32;
  dim3 grid(num_dst);
  if (vec == 4)
    segmented_rows_kernel<4, SCALED><<<grid, threads, 0, stream>>>(rows, edge_src, coef, order,
                                                                  row_ptr, out, F);
  else if (vec == 2)
    segmented_rows_kernel<2, SCALED><<<grid, threads, 0, stream>>>(rows, edge_src, coef, order,
                                                                  row_ptr, out, F);
  else
    segmented_rows_kernel<1, SCALED><<<grid, threads, 0, stream>>>(rows, edge_src, coef, order,
                                                                  row_ptr, out, F);
  return (int)cudaGetLastError();
}

extern "C" int gss_forward(const float* h, const int* edge_src, const float* coef,
                           const int* order, const int* row_ptr, float* out, int num_dst, int F,
                           void* stream) {
  return launch<true>(h, edge_src, coef, order, row_ptr, out, num_dst, F,
                      static_cast<cudaStream_t>(stream));
}

extern "C" int seg_forward(const float* msgs, const int* order, const int* row_ptr, float* out,
                           int num_dst, int F, void* stream) {
  return launch<false>(msgs, nullptr, nullptr, order, row_ptr, out, num_dst, F,
                       static_cast<cudaStream_t>(stream));
}
