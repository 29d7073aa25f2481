// K005 clean twin: every thread reaches the barrier.
__global__ void skewed_kernel(float* x) {
  const int lane = threadIdx.x & 31;
  if (lane < 16) x[threadIdx.x] *= 2.f;
  __syncthreads();
  x[threadIdx.x] += 1.f;
}
