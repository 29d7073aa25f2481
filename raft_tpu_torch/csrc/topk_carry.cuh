// Shared top-k carry used by every kernel of raft_tpu_torch.
//
// Replaces the running VMEM carry of raft_tpu/ops/pallas_kernels.py
// (_extract_topk + the concat/re-extract merge of _topk_kernel,
// _fused_topk_kernel and _fused_ivf_topk_kernel). The TPU kernels merged a
// tile into the carry with k rounds of min/argmin over [carry | tile]; here a
// warp merges a short sorted survivor list into a sorted carry in shared
// memory, which gives the same order:
//   - ascending value;
//   - ties broken carry-first, then by position within the chunk (the
//     first-occurrence argmin of the TPU kernels);
//   - +inf is the sentinel: the carry starts as (+inf, -1), and a candidate
//     enters only if it is strictly below the carry's k-th value, so a row
//     with fewer than k finite candidates keeps id -1 in its tail, and a
//     legitimate -inf keeps its id. NaN never enters.
//
// Values are compared as order-preserving 32-bit keys (-0.0 is folded onto
// +0.0 first, as the TPU comparison treats them equal). A survivor is stored
// as the 64-bit key (value key << 32 | position in chunk), so one integer
// sort orders survivors by value and then by position.
//
// Bound: the carry is touched only by candidates that beat its k-th value, so
// after the first chunks the merge is rare and the kernels around it are
// bounded by their distance arithmetic or by reading their inputs.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace rtt {

constexpr uint32_t kInfKey = 0xff800000u;  // float_key(+inf)

__device__ __forceinline__ uint32_t float_key(float v) {
  const uint32_t u = __float_as_uint(__fadd_rn(v, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// Append (key, pos) to a row's survivor list if it beats the carry's k-th
// value `thr`. Any thread may call it; the list needs room for every
// candidate of one chunk.
__device__ __forceinline__ void offer(uint32_t key, uint32_t pos, uint32_t thr,
                                      unsigned long long* skey, int* scount) {
  if (key < thr) {
    const int s = atomicAdd(scount, 1);
    skey[s] = (static_cast<unsigned long long>(key) << 32) | pos;
  }
}

// Merge n >= 1 survivors into the carry (cval/cid, k entries, ascending).
// Called by all 32 lanes of one warp. `id_of(pos)` maps a survivor's
// position in its chunk to the id that is stored. skey needs room for n
// rounded up to a power of two.
template <class IdOf>
__device__ void warp_merge(uint32_t* cval, int32_t* cid, int k,
                           unsigned long long* skey, int n, IdOf id_of) {
  const int lane = threadIdx.x & 31;
  int p = 1;
  while (p < n) p <<= 1;
  for (int i = n + lane; i < p; i += 32) skey[i] = ~0ull;
  __syncwarp();
  // bitonic sort of the survivors by (value, position)
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (p >> 1); t += 32) {
        const int lo = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = skey[lo], b = skey[hi];
        const bool up = (lo & size) == 0;
        if ((a > b) == up) {
          skey[lo] = b;
          skey[hi] = a;
        }
      }
      __syncwarp();
    }
  }
  const int ns = n < k ? n : k;
  // carry slots below the first survivor's place do not move
  const uint32_t s0 = static_cast<uint32_t>(skey[0] >> 32);
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cval[mid] <= s0) lo = mid + 1; else hi = mid;
  }
  const int start = lo;
  // Merge path, written in place from the top down: output slot p reads
  // carry slots <= p only, and those are rewritten after this warp-wide
  // step has read them.
  for (int top = k; top > start; top -= 32) {
    const int p_out = top - 32 + lane;
    const bool active = p_out >= start;
    uint32_t v = 0;
    int32_t id = -1;
    if (active) {
      int a = p_out - ns > 0 ? p_out - ns : 0;
      int b = p_out;
      while (a < b) {  // a = carry entries among the first p_out outputs
        const int mid = (a + b) >> 1;
        const uint32_t sv = static_cast<uint32_t>(skey[p_out - mid - 1] >> 32);
        if (cval[mid] <= sv) a = mid + 1; else b = mid;
      }
      const int j = p_out - a;
      const bool take_carry =
          j >= ns || cval[a] <= static_cast<uint32_t>(skey[j] >> 32);
      if (take_carry) {
        v = cval[a];
        id = cid[a];
      } else {
        v = static_cast<uint32_t>(skey[j] >> 32);
        id = id_of(static_cast<uint32_t>(skey[j] & 0xffffffffu));
      }
    }
    __syncwarp();
    if (active) {
      cval[p_out] = v;
      cid[p_out] = id;
    }
    __syncwarp();
  }
}

// Insert one candidate (key, id) into the carry (cval/cid, k entries,
// ascending by (key, id)), dropping its last entry; a candidate not below
// the k-th entry changes nothing. Called by all 32 lanes of one warp with
// the same arguments. As the order is by (key, id), inserting candidates in
// any order gives the carry warp_merge gives. An empty slot is
// (kInfKey, -1), after every real entry.
__device__ __forceinline__ void warp_insert(uint32_t* cval, int32_t* cid,
                                            int k, uint32_t key, int32_t id) {
  const int lane = threadIdx.x & 31;
  const unsigned long long nv =
      (static_cast<unsigned long long>(key) << 32) | static_cast<uint32_t>(id);
  int pos = 0;
  for (int t = 0; t < k; t += 32) {
    const int j = t + lane;
    const bool less =
        j < k && ((static_cast<unsigned long long>(cval[j]) << 32) |
                  static_cast<uint32_t>(cid[j])) < nv;
    pos += __popc(__ballot_sync(0xffffffffu, less));
  }
  if (pos >= k) return;  // uniform over the warp
  // entries [pos, k - 1) move up one slot, the top 32 first, so that each
  // step reads slots that the steps above it have not written
  for (int t = (k - 1) / 32 * 32; t >= pos / 32 * 32; t -= 32) {
    const int j = t + lane;
    const bool move = j > pos && j < k;
    uint32_t v = 0;
    int32_t i = 0;
    if (move) {
      v = cval[j - 1];
      i = cid[j - 1];
    }
    __syncwarp();
    if (move) {
      cval[j] = v;
      cid[j] = i;
    }
    __syncwarp();
  }
  if (lane == 0) {
    cval[pos] = key;
    cid[pos] = id;
  }
  __syncwarp();
}

// ids of a streamed row: `ids[pos]` when given, else base + pos
struct RowIds {
  const int32_t* ids;
  long long base;
  __device__ int32_t operator()(uint32_t pos) const {
    return ids ? ids[pos] : static_cast<int32_t>(base + pos);
  }
};

constexpr int kSelectWarps = 8;   // rows per block, one warp each
constexpr int kSelectChunk = 128; // values a warp streams per merge step

__host__ __device__ inline size_t select_rows_smem_bytes(int k) {
  return static_cast<size_t>(kSelectWarps) *
         (static_cast<size_t>(kSelectChunk) * 8 + static_cast<size_t>(k) * 8 + 16);
}

// Streaming top-k of the rows of vals [b, n] (one warp per row): the row is
// read once, in chunks, and each chunk's survivors are merged into the
// warp's carry. `negate` selects the largest values. Also the merge step of
// fused_l2_topk's split scan, with in_ids giving each candidate's id.
__global__ void __launch_bounds__(kSelectWarps * 32)
select_rows_kernel(const float* __restrict__ vals,
                   const int32_t* __restrict__ in_ids, long long b, long long n,
                   int k, int negate, float* __restrict__ out_v,
                   int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned long long* skey_all = reinterpret_cast<unsigned long long*>(smem);
  uint32_t* cval_all =
      reinterpret_cast<uint32_t*>(skey_all + kSelectWarps * kSelectChunk);
  int32_t* cid_all = reinterpret_cast<int32_t*>(cval_all + kSelectWarps * k);
  int* count_all = reinterpret_cast<int*>(cid_all + kSelectWarps * k);
  unsigned long long* skey = skey_all + warp * kSelectChunk;
  uint32_t* cval = cval_all + warp * k;
  int32_t* cid = cid_all + warp * k;
  int* scount = count_all + warp;

  const long long row = static_cast<long long>(blockIdx.x) * kSelectWarps + warp;
  if (row >= b) return;  // warps are independent: no block-wide barrier below
  for (int i = lane; i < k; i += 32) {
    cval[i] = kInfKey;
    cid[i] = -1;
  }
  if (lane == 0) *scount = 0;
  __syncwarp();
  const float* rv = vals + row * n;
  const int32_t* ri = in_ids ? in_ids + row * n : nullptr;
  for (long long base = 0; base < n; base += kSelectChunk) {
    const uint32_t thr = cval[k - 1];
    for (int t = lane; t < kSelectChunk; t += 32) {
      const long long c = base + t;
      if (c < n) {
        const float v = rv[c];
        offer(float_key(negate ? -v : v), t, thr, skey, scount);
      }
    }
    __syncwarp();
    const int cnt = *scount;
    if (cnt > 0) {
      warp_merge(cval, cid, k, skey, cnt, RowIds{ri ? ri + base : nullptr, base});
      if (lane == 0) *scount = 0;
    }
    __syncwarp();
  }
  for (int j = lane; j < k; j += 32) {
    const float v = key_float(cval[j]);
    out_v[row * k + j] = negate ? -v : v;
    out_i[row * k + j] = cid[j];
  }
}

inline cudaError_t launch_select_rows(const float* vals, const int32_t* in_ids,
                                      long long b, long long n, int k,
                                      int negate, float* out_v, int32_t* out_i,
                                      cudaStream_t stream) {
  const size_t smem = select_rows_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      select_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (b + kSelectWarps - 1) / kSelectWarps;
  select_rows_kernel<<<static_cast<unsigned>(blocks), kSelectWarps * 32, smem,
                       stream>>>(vals, in_ids, b, n, k, negate, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace rtt

extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
