// RL004 clean: every launch opts in, checks and stays within its bounds
#include <cuda_runtime.h>

#include "rl004_bounds.cuh"

constexpr int THREADS = 256;
constexpr int SMALL_SMEM = 4 * 1024;   // "<<<" in a comment is no launch

__global__ void __launch_bounds__(THREADS) small_kernel(float* out) { out[threadIdx.x] = 0.f; }

template <int N>
__global__ void __launch_bounds__(N) tiled_kernel(float* out) {
  extern __shared__ float buf[];
  buf[threadIdx.x] = 1.f;
  out[threadIdx.x] = buf[threadIdx.x];
}

template <int N>
int launch_tiled(float* out, int bytes, cudaStream_t st) {
  const cudaError_t e =
      cudaFuncSetAttribute(tiled_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  tiled_kernel<N><<<1, N, bytes, st>>>(out);   // block N: template, skipped
  return (int)cudaGetLastError();
}

// the caller reads the error of this launcher's launch
static void launch_small(float* out, cudaStream_t st) {
  small_kernel<<<2, THREADS, SMALL_SMEM, st>>>(out);
}

extern "C" int entry(float* out, int bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch_small(out, st);
  small_kernel<<<1, fx::NARROW, 0, st>>>(out);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  const char* msg = "kernel<<<1, 1024, 99999>>>";   // a string, no launch
  (void)msg;
  return launch_tiled<128>(out, bytes, st);
}
