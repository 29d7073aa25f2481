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
//
// select_rows (select_k's kernel, and the per-query merge that ends
// fused_l2_topk over several database ranges and the grouped routes of
// fused_ivf_topk and fused_pq_topk) has two routes, chosen inside
// launch_select_rows so that its callers do not change: up to k = 32 a
// register carry (select_reg_kernel, below), above it the shared-memory
// carry of select_rows_kernel (warp_merge). warp_merge and warp_insert stay
// as the fused kernels' inner loops use them.
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

// ---- the register route of select_rows (k <= kRegMaxK)
//
// One warp a row, the carry in registers: lane j holds entry j as one 64-bit
// key (order key << 32 | position in the row) and, when the row has ids, the
// id beside it. The lanes above k hold entries past the k-th; the carry stays
// sorted over all 32 lanes. The threshold is entry k-1's order key, broadcast
// by one shuffle after every change: a candidate enters only strictly below
// it, so an equal value at a later position never does. The row is read in
// chunks of 32·V values, the next chunk's loads issued before the current
// chunk is filtered. On long rows a first pass bounds the k-th value: each
// lane keeps the two smallest order keys it reads (three min/max a value, no
// shuffle), and the k-th smallest of those 64 keys is at least the row's
// k-th, so the exact pass takes only candidates at or below it (a value
// above has k smaller ones). The row is then read again (from L1 or L2) and
// each 32-value step takes a ballot of the values below both the bound and
// the threshold:
//   - up to kRegInsertMax survivors are inserted in position order, each by
//     a ballot for its rank and a __shfl_up_sync of the entries above it
//     (the register form of warp_insert);
//   - more are sorted by a 32-lane bitonic network (15 shuffle stages), then
//     the lower half of carry ∪ survivors (carry[l] against survivor[31 - l])
//     is sorted by 5 more stages; the first step with survivors sorts them
//     straight into the empty carry.
// No shared memory, no __syncwarp: every lane runs every step of the row, so
// the full-mask shuffles and ballots always have all 32 lanes.
constexpr int kRegMaxK = 32;      // gpu_kernels.SELECT_REG_MAX_K
constexpr int kRegInsertMax = 16;  // gpu_kernels.SELECT_INSERT_MAX
constexpr long long kRegTwoPassMinN = 256;  // gpu_kernels.SELECT_TWO_PASS_MIN_N
constexpr int kRegMaxV = 8;       // gpu_kernels.SELECT_REG_MAX_V
constexpr int kRegWarps = 4;      // rows per block, one warp each
constexpr int kRegBlocksPerSm = 8;  // 32 rows an SM: at most 64 registers
constexpr uint32_t kNoKey = 0xffffffffu;  // +inf, NaN, past the row's end
constexpr unsigned kFull = 0xffffffffu;

// Values a lane loads a chunk: the row's 32-value steps rounded up to a power
// of two, at most kRegMaxV (gpu_kernels.plan_select_k mirrors it).
__host__ __device__ inline int select_reg_v(long long n) {
  int v = 1;
  while (v < kRegMaxV && 32LL * v < n) v <<= 1;
  return v;
}

// Rows longer than kRegTwoPassMinN take the bounding first pass.
__host__ __device__ inline bool select_reg_two_pass(long long n) {
  return n > kRegTwoPassMinN;
}

// The register route takes k <= kRegMaxK and rows whose positions fit the
// key's 32 bits.
__host__ __device__ inline bool select_reg_route(long long n, int k) {
  return k <= kRegMaxK && n < (1LL << 31);
}

// A candidate's order key; +inf and NaN (of either sign) never enter.
__device__ __forceinline__ uint32_t select_key(float v) {
  const uint32_t key = float_key(v);
  return (v != v || key >= kInfKey) ? kNoKey : key;
}

struct RegCarry {
  unsigned long long key;  // entry `lane`: (order key << 32) | position
  int32_t id;              // its id, when the row has ids
  uint32_t thr;            // order key of entry k - 1
  bool empty;              // no candidate has entered yet
};

// One compare-exchange stage of a 32-lane bitonic network over (key, id).
template <bool kIds>
__device__ __forceinline__ void reg_cas(unsigned long long& key, int32_t& id,
                                        int lane, int stride, bool up) {
  const unsigned long long other = __shfl_xor_sync(kFull, key, stride);
  const int32_t other_id = kIds ? __shfl_xor_sync(kFull, id, stride) : 0;
  const bool keep_min = ((lane & stride) == 0) == up;
  if (keep_min ? other < key : other > key) {
    key = other;
    if (kIds) id = other_id;
  }
}

template <bool kIds>
__device__ __forceinline__ void reg_sort32(unsigned long long& key,
                                           int32_t& id, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      reg_cas<kIds>(key, id, lane, stride, (lane & size) == 0);
  }
}

// More than kRegInsertMax survivors of a step (lane l's when `enter`): sort
// them, then merge them into the carry. Kept out of line, as a chunk's steps
// are unrolled and few take this path.
template <bool kIds>
__device__ __noinline__ RegCarry reg_sort_merge(RegCarry c, int lane,
                                                bool enter, uint32_t key,
                                                uint32_t pos, int32_t id) {
  unsigned long long nk =
      enter ? (static_cast<unsigned long long>(key) << 32) | pos : ~0ull;
  reg_sort32<kIds>(nk, id, lane);
  if (c.empty) {
    c.key = nk;
    if (kIds) c.id = id;
    return c;
  }
  const unsigned long long rk = __shfl_sync(kFull, nk, 31 - lane);
  const int32_t rid = kIds ? __shfl_sync(kFull, id, 31 - lane) : 0;
  if (rk < c.key) {
    c.key = rk;
    if (kIds) c.id = rid;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    reg_cas<kIds>(c.key, c.id, lane, stride, true);
  return c;
}

// Offer one 32-value step (lane l's candidate: order key, position, id);
// only keys at or below `limit` can be among the row's k smallest.
template <bool kIds>
__device__ __forceinline__ void reg_offer(RegCarry& c, int k, int lane,
                                          uint32_t key, uint32_t pos,
                                          int32_t id, uint32_t limit) {
  const bool enter = key < c.thr && key <= limit;
  const unsigned mask = __ballot_sync(kFull, enter);
  if (mask == 0u) return;
  if (__popc(mask) > kRegInsertMax) {
    c = reg_sort_merge<kIds>(c, lane, enter, key, pos, id);
  } else {
    const unsigned long long nk =
        (static_cast<unsigned long long>(key) << 32) | pos;
    for (unsigned m = mask; m != 0u; m &= m - 1u) {
      const int src = __ffs(m) - 1;
      const unsigned long long ek = __shfl_sync(kFull, nk, src);
      const int32_t eid = kIds ? __shfl_sync(kFull, id, src) : 0;
      const int rank = __popc(__ballot_sync(kFull, c.key < ek));
      if (rank >= k) continue;  // uniform: an earlier insertion raised the bar
      const unsigned long long up_key = __shfl_up_sync(kFull, c.key, 1);
      const int32_t up_id = kIds ? __shfl_up_sync(kFull, c.id, 1) : 0;
      if (lane == rank) {
        c.key = ek;
        if (kIds) c.id = eid;
      } else if (lane > rank) {
        c.key = up_key;
        if (kIds) c.id = up_id;
      }
    }
  }
  c.empty = false;
  c.thr = static_cast<uint32_t>(__shfl_sync(kFull, c.key, k - 1) >> 32);
}

template <int V, bool kIds>
__device__ __forceinline__ void reg_load(const float* rv, const int32_t* ri,
                                         long long n, long long base, int lane,
                                         float (&v)[V], int32_t (&id)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const long long c = base + 32 * j + lane;
    v[j] = c < n ? rv[c] : 0.0f;
    id[j] = kIds && c < n ? ri[c] : -1;
  }
}

__device__ __forceinline__ uint32_t reg_cas32(uint32_t x, int lane,
                                              int stride, bool up) {
  const uint32_t other = __shfl_xor_sync(kFull, x, stride);
  return ((lane & stride) == 0) == up ? min(x, other) : max(x, other);
}

__device__ __forceinline__ uint32_t reg_sort32_u32(uint32_t x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      x = reg_cas32(x, lane, stride, (lane & size) == 0);
  }
  return x;
}

// The first pass: an order key at least the row's k-th smallest (kNoKey when
// the row has fewer than k finite values), the k-th smallest of the lanes'
// two smallest keys.
template <int V>
__device__ __forceinline__ uint32_t reg_bound(const float* rv, long long n,
                                              int negate, int k, int lane) {
  uint32_t m0 = kNoKey, m1 = kNoKey;  // the lane's two smallest, m0 <= m1
  float cur[V], nxt[V] = {};
  int32_t no_id[V];
  reg_load<V, false>(rv, nullptr, n, 0, lane, cur, no_id);
  for (long long base = 0; base < n; base += 32LL * V) {
    if (base + 32LL * V < n)
      reg_load<V, false>(rv, nullptr, n, base + 32LL * V, lane, nxt, no_id);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const uint32_t key = base + 32 * j + lane < n
                               ? select_key(negate ? -cur[j] : cur[j])
                               : kNoKey;
      m1 = min(m1, max(key, m0));
      m0 = min(m0, key);
      cur[j] = nxt[j];
    }
  }
  // both sets sorted, then the lower half of their union (m0[l] against
  // m1[31 - l]) sorted: lane k-1 holds the k-th smallest of the 64
  m0 = reg_sort32_u32(m0, lane);
  m1 = reg_sort32_u32(m1, lane);
  uint32_t low = min(m0, __shfl_sync(kFull, m1, 31 - lane));
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1)
    low = reg_cas32(low, lane, stride, true);
  return __shfl_sync(kFull, low, k - 1);
}

template <int V, bool kIds>
__global__ void __launch_bounds__(kRegWarps * 32, kRegBlocksPerSm)
select_reg_kernel(const float* __restrict__ vals,
                  const int32_t* __restrict__ in_ids, long long b, long long n,
                  int k, int negate, int two_pass, float* __restrict__ out_v,
                  int32_t* __restrict__ out_i) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kRegWarps + (threadIdx.x >> 5);
  if (row >= b) return;  // the whole warp: no shuffle below misses a lane
  const float* rv = vals + row * n;
  const int32_t* ri = kIds ? in_ids + row * n : nullptr;
  const uint32_t limit = two_pass ? reg_bound<V>(rv, n, negate, k, lane)
                                  : kNoKey;
  RegCarry c{~0ull, -1, kNoKey, true};
  float cur[V], nxt[V] = {};
  int32_t cur_id[V], nxt_id[V] = {};
  reg_load<V, kIds>(rv, ri, n, 0, lane, cur, cur_id);
  for (long long base = 0; base < n; base += 32LL * V) {
    if (base + 32LL * V < n)  // the next chunk's loads go out first
      reg_load<V, kIds>(rv, ri, n, base + 32LL * V, lane, nxt, nxt_id);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const long long pos = base + 32 * j + lane;
      const uint32_t key =
          pos < n ? select_key(negate ? -cur[j] : cur[j]) : kNoKey;
      reg_offer<kIds>(c, k, lane, key, static_cast<uint32_t>(pos), cur_id[j],
                      limit);
    }
#pragma unroll
    for (int t = 0; t < V; ++t) {
      cur[t] = nxt[t];
      cur_id[t] = nxt_id[t];
    }
  }
  if (lane < k) {
    const uint32_t key = static_cast<uint32_t>(c.key >> 32);
    const float v = key == kNoKey ? __int_as_float(0x7f800000) : key_float(key);
    out_v[row * k + lane] = negate ? -v : v;
    out_i[row * k + lane] =
        key == kNoKey ? -1
                      : (kIds ? c.id : static_cast<int32_t>(c.key & 0xffffffffu));
  }
}

template <int V>
inline cudaError_t launch_select_reg(const float* vals, const int32_t* in_ids,
                                     long long b, long long n, int k,
                                     int negate, int two_pass, float* out_v,
                                     int32_t* out_i, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((b + kRegWarps - 1) / kRegWarps);
  if (in_ids)
    select_reg_kernel<V, true><<<blocks, kRegWarps * 32, 0, stream>>>(
        vals, in_ids, b, n, k, negate, two_pass, out_v, out_i);
  else
    select_reg_kernel<V, false><<<blocks, kRegWarps * 32, 0, stream>>>(
        vals, in_ids, b, n, k, negate, two_pass, out_v, out_i);
  return cudaGetLastError();
}

// The top k of each row of vals [b, n] (ids from in_ids when given, else the
// column): the register route when select_reg_route(n, k), with `v` values a
// lane a chunk (select_reg_v(n) when v is 0) and `passes` passes over the
// row (select_reg_two_pass(n) when 0), else the shared-memory carry of
// select_rows_kernel (route 1, up to MAX_K). `v` < 0 forces route 1.
inline cudaError_t launch_select_rows(const float* vals, const int32_t* in_ids,
                                      long long b, long long n, int k,
                                      int negate, float* out_v, int32_t* out_i,
                                      cudaStream_t stream, int v = 0,
                                      int passes = 0) {
  if (v >= 0 && select_reg_route(n, k)) {
    if (b == 0) return cudaSuccess;
    const int two = passes == 0 ? select_reg_two_pass(n) : passes == 2;
    switch (v == 0 ? select_reg_v(n) : v) {
      case 1: return launch_select_reg<1>(vals, in_ids, b, n, k, negate, two, out_v, out_i, stream);
      case 2: return launch_select_reg<2>(vals, in_ids, b, n, k, negate, two, out_v, out_i, stream);
      case 4: return launch_select_reg<4>(vals, in_ids, b, n, k, negate, two, out_v, out_i, stream);
      case 8: return launch_select_reg<8>(vals, in_ids, b, n, k, negate, two, out_v, out_i, stream);
      default: return cudaErrorInvalidValue;
    }
  }
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
