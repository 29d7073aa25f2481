// Fused probe gather + scan + top-k for the IVF families.
//
// Replaces raft_tpu/ops/pallas_kernels.py:fused_ivf_topk
// (_fused_ivf_topk_kernel): for each (query, probe, slab rows) the partial
// distance ‖q‖² + ‖row‖² − 2·q·row (clamped at 0 when asked), slots whose id
// is < 0 masked to +inf, merged into the query's running top-k, so the
// [nq, P, list_pad] candidate slab never exists in device memory.
//
// Bound on the H100: reading the probed slabs. The work is 2·rot operations
// per row read (2·rot/4 per byte in fp32), well under the card's ratio of
// fp32 operations to bytes, and one block per query reads every slab it
// probes, so queries that probe the same list each read it again (from L2
// when they run close together, else from device memory).
//
// Design: one block per query, as a first design. The block walks its probes
// in probe order and each probed slab in 256-row chunks; a warp computes four
// rows at a time with the feature dimension spread over its lanes (coalesced
// reads of f32 or bf16 list data, fp32 accumulation, a shuffle reduction).
// Each chunk's survivors are merged into the query's carry by warp 0
// (topk_carry.cuh), in (probe, slot) order, which is the TPU kernel's order.
// The TPU kernel's rule that its slab tile divide list_pad was a VMEM rule;
// here any list_pad is scanned as it is.
#include <cuda_bf16.h>

#include "topk_carry.cuh"

namespace {

constexpr int kChunk = 256;  // slab rows per merge step
constexpr int kThreads = 256;

size_t ivf_smem_bytes(int rot, int k) {
  return static_cast<size_t>(kChunk) * 8 +  // survivors
         static_cast<size_t>(k) * 8 +       // carry
         16 +                               // survivor count
         static_cast<size_t>(rot) * 4;      // this probe's query vector
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct SlabIds {
  const int32_t* ids;
  __device__ int32_t operator()(uint32_t pos) const { return ids[pos]; }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_ivf_topk_kernel(const int32_t* __restrict__ probes,
                      const float* __restrict__ qres,
                      const float* __restrict__ qn,
                      const T* __restrict__ list_data,
                      const float* __restrict__ row_norms,
                      const int32_t* __restrict__ list_ids, int n_probes,
                      int n_lists, int pad, int rot, int k, int clamp,
                      float* __restrict__ out_v, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* skey = reinterpret_cast<unsigned long long*>(smem);
  uint32_t* cval = reinterpret_cast<uint32_t*>(skey + kChunk);
  int32_t* cid = reinterpret_cast<int32_t*>(cval + k);
  int* scount = reinterpret_cast<int*>(cid + k);
  float* qs = reinterpret_cast<float*>(scount + 4);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long q = blockIdx.x;
  for (int i = tid; i < k; i += kThreads) {
    cval[i] = rtt::kInfKey;
    cid[i] = -1;
  }
  if (tid == 0) *scount = 0;

  for (int j = 0; j < n_probes; ++j) {
    const long long qp = q * n_probes + j;
    const int list = probes[qp];
    __syncthreads();  // the previous probe is done with qs
    for (int e = tid; e < rot; e += kThreads) qs[e] = qres[qp * rot + e];
    __syncthreads();
    if (list < 0 || list >= n_lists) continue;  // uniform over the block
    const float base = qn[qp];
    const T* slab = list_data + static_cast<long long>(list) * pad * rot;
    const float* norms = row_norms + static_cast<long long>(list) * pad;
    const int32_t* ids = list_ids + static_cast<long long>(list) * pad;

    for (int r0 = 0; r0 < pad; r0 += kChunk) {
      const int rend = r0 + kChunk < pad ? r0 + kChunk : pad;
      const uint32_t thr = cval[k - 1];
      for (int g = r0 + warp * 4; g < rend; g += 4 * (kThreads / 32)) {
        float acc[4];
        bool ok[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          acc[u] = 0.f;
          ok[u] = g + u < rend && ids[g + u] >= 0;
        }
        for (int dd = lane; dd < rot; dd += 32) {
          const float qv = qs[dd];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (ok[u])
              acc[u] = fmaf(to_f32(slab[static_cast<long long>(g + u) * rot + dd]),
                            qv, acc[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] = warp_sum(acc[u]);
        const bool mine = lane == 0 ? ok[0] : lane == 1 ? ok[1]
                        : lane == 2 ? ok[2] : lane == 3 && ok[3];
        if (mine) {
          const float dot = lane == 0 ? acc[0] : lane == 1 ? acc[1]
                          : lane == 2 ? acc[2] : acc[3];
          float dist = __fsub_rn(__fadd_rn(base, norms[g + lane]),
                                 __fmul_rn(2.f, dot));
          if (clamp) dist = fmaxf(dist, 0.f);
          rtt::offer(rtt::float_key(dist), g + lane - r0, thr, skey, scount);
        }
      }
      __syncthreads();
      const int cnt = *scount;
      if (warp == 0 && cnt > 0) {
        rtt::warp_merge(cval, cid, k, skey, cnt, SlabIds{ids + r0});
        if (lane == 0) *scount = 0;
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < k; i += kThreads) {
    out_v[q * k + i] = rtt::key_float(cval[i]);
    out_i[q * k + i] = cid[i];
  }
}

template <typename T>
cudaError_t launch(const int32_t* probes, const float* qres, const float* qn,
                   const void* list_data, const float* row_norms,
                   const int32_t* list_ids, int nq, int n_probes, int n_lists,
                   int pad, int rot, int k, int clamp, float* out_v,
                   int32_t* out_i, cudaStream_t stream) {
  const size_t smem = ivf_smem_bytes(rot, k);
  cudaError_t err = cudaFuncSetAttribute(
      fused_ivf_topk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_ivf_topk_kernel<T><<<nq, kThreads, smem, stream>>>(
      probes, qres, qn, static_cast<const T*>(list_data), row_norms, list_ids,
      n_probes, n_lists, pad, rot, k, clamp, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_ivf_topk(const void* probes, const void* qres,
                              const void* qn, const void* list_data,
                              int data_is_bf16, const void* row_norms,
                              const void* list_ids, int nq, int n_probes,
                              int n_lists, int pad, int rot, int k, int clamp,
                              void* out_v, void* out_i, void* stream) {
  const auto* p = static_cast<const int32_t*>(probes);
  const auto* qr = static_cast<const float*>(qres);
  const auto* qnf = static_cast<const float*>(qn);
  const auto* rn = static_cast<const float*>(row_norms);
  const auto* li = static_cast<const int32_t*>(list_ids);
  auto* ov = static_cast<float*>(out_v);
  auto* oi = static_cast<int32_t*>(out_i);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      data_is_bf16
          ? launch<__nv_bfloat16>(p, qr, qnf, list_data, rn, li, nq, n_probes,
                                  n_lists, pad, rot, k, clamp, ov, oi, s)
          : launch<float>(p, qr, qnf, list_data, rn, li, nq, n_probes, n_lists,
                          pad, rot, k, clamp, ov, oi, s);
  return static_cast<int>(err);
}
