// RL004 true positives: launch-hygiene faults, one per form
#include <cuda_runtime.h>

#include "rl004_bounds.cuh"

__global__ void __launch_bounds__(256) small_kernel(float* out) { out[threadIdx.x] = 0.f; }

__global__ void big_kernel(float* out) {
  extern __shared__ float buf[];
  buf[threadIdx.x] = 1.f;
  out[threadIdx.x] = buf[threadIdx.x];
}

// (a): dynamic shared memory not known to fit, and no opt-in
extern "C" int launch_a(float* out, int bytes, void* stream) {
  big_kernel<<<1, 128, bytes, static_cast<cudaStream_t>(stream)>>>(out);
  return (int)cudaGetLastError();
}

// (b) and (a): the opt-in's result is dropped, so it does not count
extern "C" int launch_b(float* out, void* stream) {
  cudaFuncSetAttribute(big_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 65536);
  big_kernel<<<1, 128, 65536, static_cast<cudaStream_t>(stream)>>>(out);
  return (int)cudaGetLastError();
}

// (c): nobody reads the launch's error
static void launch_c(float* out, cudaStream_t st) { small_kernel<<<1, 256, 0, st>>>(out); }

extern "C" int entry_c(float* out, void* stream) {
  launch_c(out, static_cast<cudaStream_t>(stream));
  return 0;
}

// (d): more threads than the kernel's launch bounds (a header constant)
extern "C" int launch_d(float* out, void* stream) {
  small_kernel<<<1, fx::WIDE, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return (int)cudaGetLastError();
}
