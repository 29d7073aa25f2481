// Fused PQ look-up-table build + code scan + top-k: ivf_pq's LUT engine.
//
// Replaces raft_tpu/ops/pallas_kernels.py:fused_pq_topk
// (_fused_pq_topk_kernel). For each query and each probed list, in probe
// order, the ADC distance of every slot of the list:
//
//   ‖q_rot − c_p‖² + Σ_s (‖cb[s, code_s]‖² − 2·⟨res_s, cb[s, code_s]⟩)
//
// with res = q_rot − c_p cut into pq_dim sub-vectors of pq_len, codes one
// byte each (pq_bits 8) and PER_SUBSPACE codebooks cb [pq_dim, 256, pq_len].
// The per-subspace terms are summed in subspace order, then ‖res‖² is added,
// with no clamp. Slots whose id is < 0 are +inf (never selected). Each
// distance is merged into the query's running top-k (topk_carry.cuh), so
// neither the [nq, P, pq_dim, 256] LUTs nor the [nq, P, list_pad] candidate
// slab ever exist in device memory.
//
// The TPU kernel did the LUT lookup as a one-hot compare/select per subspace
// because Mosaic has no gather. Here the LUT lives in shared memory and each
// row's codes index it directly.
//
// Bound on the H100: the operations. Per (query, probe) the LUT costs
// pq_dim·256·(2·pq_len + 2) FLOP and each scanned row pq_dim adds, at the
// fp32 rate outside the tensor cores; the probed codes and ids, read once,
// are a small fraction of that time. This first design reads them once per
// query instead (queries that probe the same list read it again, from L2
// when they run close together, else from device memory), and rebuilds the
// LUT per (query, probe) from codebooks read through L1/L2.
//
// Design: one block of 256 threads per query walks its probes in order.
// Per probe: the block writes the residual to shared memory, builds the
// probe's [pq_dim, 256] fp32 LUT there (one entry per thread and step,
// fp32 FMA, not TF32), then scans the list in chunks of 256 rows, one row
// per thread, loading its codes 16 bytes at a time where the row allows it
// and summing LUT entries by a shared-memory gather. A chunk's survivors
// are merged into the carry by warp 0 in (probe, slot) order, the TPU
// kernel's tie order. A faster design (a LUT layout without bank conflicts,
// fp16/fp8 LUTs, queries grouped per list) is later work.
#include <cstdint>

#include "topk_carry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;  // list rows per merge step: one per thread
constexpr int kBook = 256;   // codebook entries per subspace (pq_bits 8)
constexpr int kWarps = kThreads / 32;

// The formula of pq_topk_smem_bytes in ops/gpu_kernels.py.
size_t pq_smem_bytes(int pq_dim, int pq_len, int k) {
  return static_cast<size_t>(kChunk) * 8 +                      // survivors
         static_cast<size_t>(pq_dim) * kBook * 4 +               // LUT
         static_cast<size_t>(k) * 8 +                            // carry
         16 +                                                    // count
         static_cast<size_t>(pq_dim) * pq_len * 4 +              // residual
         (kWarps + 1) * 4;                                       // ‖res‖²
}

struct SlabIds {
  const int32_t* ids;
  __device__ int32_t operator()(uint32_t pos) const { return ids[pos]; }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc += the LUT entries of the four codes packed in `word`, subspaces
// s0 .. s0+3 (byte 0 of a row is the low byte of its first word).
__device__ __forceinline__ float add_word(float acc, uint32_t word,
                                          const float* lut_s0) {
#pragma unroll
  for (int b = 0; b < 4; ++b)
    acc = __fadd_rn(acc, lut_s0[b * kBook + ((word >> (8 * b)) & 0xffu)]);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
fused_pq_topk_kernel(const int32_t* __restrict__ probes,
                     const float* __restrict__ q_rot,
                     const float* __restrict__ centers_rot,
                     const float* __restrict__ codebooks,
                     const float* __restrict__ cb_norms,
                     const uint8_t* __restrict__ codes,
                     const int32_t* __restrict__ list_ids, int n_probes,
                     int n_lists, int pad, int pq_dim, int pq_len, int k,
                     int vec16, float* __restrict__ out_v,
                     int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* skey = reinterpret_cast<unsigned long long*>(smem);
  float* lut = reinterpret_cast<float*>(skey + kChunk);
  uint32_t* cval = reinterpret_cast<uint32_t*>(lut + pq_dim * kBook);
  int32_t* cid = reinterpret_cast<int32_t*>(cval + k);
  int* scount = reinterpret_cast<int*>(cid + k);
  const int rot = pq_dim * pq_len;
  float* res = reinterpret_cast<float*>(scount + 4);
  float* red = res + rot;  // per-warp partial sums of ‖res‖², then the total

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long q = blockIdx.x;
  for (int i = tid; i < k; i += kThreads) {
    cval[i] = rtt::kInfKey;
    cid[i] = -1;
  }
  if (tid == 0) *scount = 0;
  const float* qv = q_rot + q * rot;

  for (int j = 0; j < n_probes; ++j) {
    const int list = probes[q * n_probes + j];
    __syncthreads();  // the previous probe is done with res, lut and red
    if (list < 0 || list >= n_lists) continue;  // uniform over the block
    const float* cv = centers_rot + static_cast<long long>(list) * rot;
    float part = 0.f;
    for (int e = tid; e < rot; e += kThreads) {
      const float r = __fsub_rn(qv[e], cv[e]);
      res[e] = r;
      part = __fadd_rn(part, __fmul_rn(r, r));
    }
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();  // res and the partial sums are written
    if (tid == 0) {
      float base = 0.f;
      for (int w = 0; w < kWarps; ++w) base = __fadd_rn(base, red[w]);
      red[kWarps] = base;
    }
    // the probe's LUT: entry (s, c) = ‖cb[s, c]‖² − 2·⟨res_s, cb[s, c]⟩
    for (int e = tid; e < pq_dim * kBook; e += kThreads) {
      const float* rs = res + (e / kBook) * pq_len;
      const float* cb = codebooks + static_cast<long long>(e) * pq_len;
      float dot = 0.f;
      for (int l = 0; l < pq_len; ++l) dot = fmaf(rs[l], __ldg(cb + l), dot);
      lut[e] = __fsub_rn(__ldg(cb_norms + e), __fmul_rn(2.f, dot));
    }
    __syncthreads();  // the LUT and ‖res‖² are ready
    const float base = red[kWarps];
    const uint8_t* lcodes = codes + static_cast<long long>(list) * pad * pq_dim;
    const int32_t* ids = list_ids + static_cast<long long>(list) * pad;

    for (int r0 = 0; r0 < pad; r0 += kChunk) {
      const uint32_t thr = cval[k - 1];
      const int r = r0 + tid;
      if (r < pad && ids[r] >= 0) {
        const uint8_t* row = lcodes + static_cast<long long>(r) * pq_dim;
        float acc = 0.f;
        if (vec16) {
          for (int s0 = 0; s0 < pq_dim; s0 += 16) {
            const uint4 w = *reinterpret_cast<const uint4*>(row + s0);
            const float* l0 = lut + s0 * kBook;
            acc = add_word(acc, w.x, l0);
            acc = add_word(acc, w.y, l0 + 4 * kBook);
            acc = add_word(acc, w.z, l0 + 8 * kBook);
            acc = add_word(acc, w.w, l0 + 12 * kBook);
          }
        } else {
          for (int s = 0; s < pq_dim; ++s)
            acc = __fadd_rn(acc, lut[s * kBook + row[s]]);
        }
        rtt::offer(rtt::float_key(__fadd_rn(acc, base)), tid, thr, skey,
                   scount);
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

}  // namespace

extern "C" int fused_pq_topk(const void* probes, const void* q_rot,
                             const void* centers_rot, const void* codebooks,
                             const void* cb_norms, const void* codes,
                             const void* list_ids, int nq, int n_probes,
                             int n_lists, int pad, int pq_dim, int pq_len,
                             int k, int vec16, void* out_v, void* out_i,
                             void* stream) {
  const size_t smem = pq_smem_bytes(pq_dim, pq_len, k);
  cudaError_t err = cudaFuncSetAttribute(
      fused_pq_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_pq_topk_kernel<<<nq, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(probes), static_cast<const float*>(q_rot),
      static_cast<const float*>(centers_rot),
      static_cast<const float*>(codebooks), static_cast<const float*>(cb_norms),
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(list_ids),
      n_probes, n_lists, pad, pq_dim, pq_len, k, vec16,
      static_cast<float*>(out_v), static_cast<int32_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
