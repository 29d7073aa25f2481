// K002 clean twin: the bytes come from an accountant with a Python twin.
#include <cuda_runtime.h>

#include "smem_budget.h"

__global__ void rows_kernel(const float* x, float* y, int n) {
  extern __shared__ float row[];
  row[threadIdx.x] = x[threadIdx.x];
  __syncthreads();
  y[threadIdx.x] = row[n - 1 - threadIdx.x];
}

cudaError_t launch(const float* x, float* y, int n, int k, cudaStream_t s) {
  const size_t bytes = rtt_smem::select_k_smem_bytes(k);
  rows_kernel<<<1, n, bytes, s>>>(x, y, n);
  return cudaGetLastError();
}
