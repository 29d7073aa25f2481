// K005 bad twin: half of each warp skips the block barrier.
__global__ void skewed_kernel(float* x) {
  const int lane = threadIdx.x & 31;
  if (lane < 16) {
    x[threadIdx.x] *= 2.f;
    __syncthreads();
  }
  x[threadIdx.x] += 1.f;
}
