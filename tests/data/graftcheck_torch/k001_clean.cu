// K001 clean twin: the group is waited on before the buffer is read.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(src) : "memory");
}

__global__ void leaky_kernel(const float4* src, float* dst) {
  extern __shared__ __align__(16) float4 buf[];
  cp_async16(buf + threadIdx.x, src + threadIdx.x);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  dst[threadIdx.x] = buf[threadIdx.x].x;
}
