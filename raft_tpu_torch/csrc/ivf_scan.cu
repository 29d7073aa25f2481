// Unfused IVF probe scan: partial distances of every probed list slot.
//
// Replaces raft_tpu/ops/pallas_kernels.py:ivf_scan (_ivf_scan_kernel): for
// each (query, probe) pair and every slot of the probed list,
//   out[q, p, slot] = row_norms[list, slot] − 2·list_data[list, slot]·qres[q, p]
// with list = probes[q, p], in fp32 over f32 or bf16 list rows. The probed
// slab is read where it lies, so the [nq, P, pad, rot] gather never exists in
// device memory; the [nq, P, pad] partials go to a separate select_k, and the
// caller adds the query's norm and masks the unfilled slots (all pad slots are
// written). It serves the IVF requests the fused kernels decline: filtered,
// inner-product and cosine search, and k > 1024.
//
// Bound on the H100: by the function's own counts (each probed slab read once,
// the partials written once) the 2·rot operations per slot bound it. This
// first design reads a slab again for every query that probes it, from L2
// when the queries run close together, else from device memory, so reading
// the slabs is what limits it in practice.
//
// Design: one block per (query, probe). The block copies the query vector to
// shared memory and its warps take four slots at a time, the feature
// dimension spread over the lanes (coalesced reads of any rot, f32 or bf16
// elements read one at a time, so an odd rot needs no aligned vector load;
// fp32 accumulation; a shuffle reduction). A probe outside [0, n_lists) reads
// nothing and writes +inf to its slots.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // slots per warp step

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const int32_t* __restrict__ probes,
                const float* __restrict__ qres, const T* __restrict__ list_data,
                const float* __restrict__ row_norms, int n_lists, int pad,
                int rot, float* __restrict__ out) {
  extern __shared__ float qs[];  // [rot]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long qp = blockIdx.x;
  const int list = probes[qp];
  float* o = out + qp * pad;
  if (list < 0 || list >= n_lists) {  // uniform over the block
    for (int s = tid; s < pad; s += kThreads) o[s] = __int_as_float(0x7f800000);
    return;
  }
  for (int e = tid; e < rot; e += kThreads) qs[e] = qres[qp * rot + e];
  __syncthreads();
  const T* slab = list_data + static_cast<long long>(list) * pad * rot;
  const float* norms = row_norms + static_cast<long long>(list) * pad;

  for (int g = warp * kRows; g < pad; g += kRows * (kThreads / 32)) {
    float acc[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) acc[u] = 0.f;
    for (int dd = lane; dd < rot; dd += 32) {
      const float qv = qs[dd];
#pragma unroll
      for (int u = 0; u < kRows; ++u)
        if (g + u < pad)
          acc[u] = fmaf(to_f32(slab[static_cast<long long>(g + u) * rot + dd]),
                        qv, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) acc[u] = warp_sum(acc[u]);
    if (lane < kRows && g + lane < pad) {
      const float dot = lane == 0 ? acc[0] : lane == 1 ? acc[1]
                      : lane == 2 ? acc[2] : acc[3];
      o[g + lane] = __fsub_rn(norms[g + lane], __fmul_rn(2.f, dot));
    }
  }
}

template <typename T>
cudaError_t launch(const int32_t* probes, const float* qres,
                   const void* list_data, const float* row_norms,
                   long long n_pairs, int n_lists, int pad, int rot, float* out,
                   cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(rot) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ivf_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  ivf_scan_kernel<T><<<static_cast<unsigned>(n_pairs), kThreads, smem,
                       stream>>>(probes, qres,
                                 static_cast<const T*>(list_data), row_norms,
                                 n_lists, pad, rot, out);
  return cudaGetLastError();
}

}  // namespace

// probes [nq, P] int32, qres [nq, P, rot] f32, list_data [n_lists, pad, rot]
// f32 (data_is_bf16 = 0) or bf16, row_norms [n_lists, pad] f32 →
// out [nq, P, pad] f32.
extern "C" int ivf_scan(const void* probes, const void* qres,
                        const void* list_data, int data_is_bf16,
                        const void* row_norms, long long n_pairs, int n_lists,
                        int pad, int rot, void* out, void* stream) {
  const auto* p = static_cast<const int32_t*>(probes);
  const auto* q = static_cast<const float*>(qres);
  const auto* rn = static_cast<const float*>(row_norms);
  auto* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pairs < 1 || n_pairs > 0x7fffffffLL || rot < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      data_is_bf16
          ? launch<__nv_bfloat16>(p, q, list_data, rn, n_pairs, n_lists, pad,
                                  rot, o, s)
          : launch<float>(p, q, list_data, rn, n_pairs, n_lists, pad, rot, o,
                          s);
  return static_cast<int>(err);
}

extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
