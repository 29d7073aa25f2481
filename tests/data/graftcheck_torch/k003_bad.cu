// K003 bad twin: 16-byte async copies into a buffer aligned to 4 bytes.
__global__ void stage_kernel(const float4* src, float* dst) {
  extern __shared__ float buf[];
  const unsigned d =
      static_cast<unsigned>(__cvta_generic_to_shared(buf + 4 * threadIdx.x));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src + threadIdx.x) : "memory");
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncthreads();
  dst[threadIdx.x] = buf[4 * threadIdx.x];
}
