// K002 bad twin: a launch sizes its shared memory by hand.
#include <cuda_runtime.h>

__global__ void rows_kernel(const float* x, float* y, int n) {
  extern __shared__ float row[];
  row[threadIdx.x] = x[threadIdx.x];
  __syncthreads();
  y[threadIdx.x] = row[n - 1 - threadIdx.x];
}

cudaError_t launch(const float* x, float* y, int n, cudaStream_t s) {
  const size_t bytes = static_cast<size_t>(n) * 4 + 64;
  rows_kernel<<<1, n, bytes, s>>>(x, y, n);
  return cudaGetLastError();
}
