// CAGRA's greedy beam walk: one warp a query (the warp route), or one block
// a query for the beams beyond a warp's reach (the block route).
//
// Replaces raft_tpu/ops/pallas_kernels.py:fused_cagra_topk
// (_fused_cagra_kernel): per query, the itopk-entry beam (distance, id,
// "expanded" flag) lives in shared memory for the whole walk.
//   - Seeds stream in chunks. A seed equal to a beam entry or to an earlier
//     seed of its chunk is dropped, which keeps the first copy of each id
//     (an evicted first copy's later copies cannot re-enter: the beam only
//     gets better under the (distance, position) order). Seeds merge in
//     seed-position order on ties. So the chunk size does not change the
//     result.
//   - Each hop picks the `width` first unexpanded finite entries of the
//     sorted beam (the cheapest, lowest index on ties) and flags them; the
//     first pick finding nothing ends the walk (the done-freeze). The
//     parents' graph rows are the targets (-1 for invalid parents and edges,
//     ids outside [0, n) count as invalid); a target equal to a beam id or
//     to an earlier target is dropped.
//   - Scoring: element e of a row is added by lane (e / 4) % 32, each lane
//     in element order, then the 32 lane sums fold in halves (lanes l and
//     l ^ 16, then 8, 4, 2, 1); every product and sum is an explicit
//     __fmul_rn / __fadd_rn, so the order of additions is fixed and the
//     plain version (ops/gpu_kernels.py lane_order_sum) repeats it bitwise.
//     d = max(fl(fl(qn + vn) - fl(2 * dot)), 0).
//   - Merge: the finite targets (or seeds) are sorted by one 64-bit (value,
//     position) key and merged with the beam by rank: the beam first on
//     ties, then candidates in position order, the first itopk kept. This
//     is the first-occurrence extraction (_extract_topk_flagged) of the TPU
//     kernel, and the stable sort of the XLA engine. Distances compare as
//     topk_carry.cuh's float keys (-0.0 folded onto +0.0); +inf entries are
//     padding with id -1.
// Output: the first k entries of the beam (squared L2; the wrapper's caller
// applies the square root for L2SqrtExpanded).
//
// Bound on the H100: the rows the walk scores (dim * 4 bytes each, read at
// random) and the serial hops between them. A hop's gathers cannot start
// before its parent is known, so one query's walk is a chain of dependent
// global loads (graph row, then dataset rows); the card is kept busy by
// walking many queries at once.
//
// Warp route (gpu_kernels.plan_fused_cagra: itopk <= 256, width·degree <=
// 64): one warp walks one query and a block holds several queries' warps,
// each with its own slice of shared memory (two beam buffers, the query row,
// the sorted candidates), so nothing in a hop waits for a block barrier,
// only for __syncwarp. A hop's candidates live in registers, candidate j in
// lane j % 32 (two a lane above 32): the graph row is one coalesced load;
// a candidate is dropped against the beam by a broadcast compare of the
// beam's ids and against earlier candidates by __match_any_sync (the lowest
// lane keeps it); the rows are scored 8 at a time, the 8 rows' loads in
// flight before their products, and their lane sums fold in 9 shuffles
// (levels 16, 8 and 4 exchange half the rows, pairing the same operands as
// the xor ladder, so the sums are bitwise the ladder's); the keys are sorted
// by a bitonic network over the lanes and merged with the beam by rank. At
// 96 registers a thread, 20 queries walk on each SM at once.
// Block route (itopk up to 1024): one block of 128 threads per query, the
// same steps with block barriers between them.
#include "topk_carry.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // rows a warp scores at once

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline int cand_cap(int wd) {
  int p = 32;
  while (p < wd) p <<= 1;
  return p;
}

// the formula of ops/gpu_kernels.py cagra_topk_smem_bytes
__host__ __device__ inline size_t cagra_smem_bytes(int itopk, int dim,
                                                   int cap, int width) {
  return 2 * (2 * align16(static_cast<size_t>(itopk) * 4) +
              align16(static_cast<size_t>(itopk))) +
         align16(static_cast<size_t>(dim) * 4) +
         static_cast<size_t>(cap) * 8 +      // sort slots
         static_cast<size_t>(cap) * 8 +      // candidate ids and keys
         align16(static_cast<size_t>(width) * 4) + 16;
}

struct Beam {
  uint32_t* key;
  int32_t* id;
  uint8_t* fl;
};

__device__ __forceinline__ float lane_fold(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Ctx {
  const float* data;
  const float* qs;  // the query row in shared memory
  long long n;
  int dim, vec4, itopk;
  float qn;
  int32_t* cid;     // candidate ids [cap]
  uint32_t* ckey;   // candidate keys / drop marks [cap]
  unsigned long long* skey;  // sort slots [cap]
  int* scount;
};

// Drop candidates that are invalid, equal a beam id, or equal an earlier
// candidate. All threads.
__device__ void dedup(const Ctx& c, const Beam& b, int cnt) {
  const int tid = threadIdx.x;
  for (int j = tid; j < cnt; j += kThreads) {
    const int32_t t = c.cid[j];
    c.ckey[j] = (t < 0 || t >= c.n) ? 1u : 0u;
  }
  __syncthreads();
  const int pairs_b = cnt * c.itopk;
  for (int p = tid; p < pairs_b; p += kThreads) {
    const int j = p / c.itopk, i = p - j * c.itopk;
    if (c.cid[j] == b.id[i]) c.ckey[j] = 1u;
  }
  for (int p = tid; p < cnt * cnt; p += kThreads) {
    const int j = p / cnt, s = p - j * cnt;
    if (s < j && c.cid[j] == c.cid[s]) c.ckey[j] = 1u;
  }
  __syncthreads();
  for (int j = tid; j < cnt; j += kThreads)
    if (c.ckey[j]) c.cid[j] = -1;
  __syncthreads();
}

__device__ __forceinline__ void accumulate(float& dot, float& nrm, float v,
                                           float q) {
  dot = __fadd_rn(dot, __fmul_rn(v, q));
  nrm = __fadd_rn(nrm, __fmul_rn(v, v));
}

// ckey[j] = the float key of candidate j's distance (+inf for id -1).
__device__ void score(const Ctx& c, int cnt) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int base = warp * kRows; base < cnt; base += kWarps * kRows) {
    int32_t t[kRows];
    float dot[kRows], nrm[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      t[u] = base + u < cnt ? c.cid[base + u] : -1;
      dot[u] = 0.f;
      nrm[u] = 0.f;
    }
    if (c.vec4) {
      const float4* q4 = reinterpret_cast<const float4*>(c.qs);
      for (int g = lane; g < c.dim / 4; g += 32) {
        const float4 qv = q4[g];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (t[u] < 0) continue;
          const float4 v = reinterpret_cast<const float4*>(
              c.data + static_cast<long long>(t[u]) * c.dim)[g];
          accumulate(dot[u], nrm[u], v.x, qv.x);
          accumulate(dot[u], nrm[u], v.y, qv.y);
          accumulate(dot[u], nrm[u], v.z, qv.z);
          accumulate(dot[u], nrm[u], v.w, qv.w);
        }
      }
    } else {
      for (int g = lane; g * 4 < c.dim; g += 32) {
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          if (t[u] < 0) continue;
          const float* row = c.data + static_cast<long long>(t[u]) * c.dim;
          for (int e = g * 4; e < g * 4 + 4 && e < c.dim; ++e)
            accumulate(dot[u], nrm[u], row[e], c.qs[e]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      dot[u] = lane_fold(dot[u]);
      nrm[u] = lane_fold(nrm[u]);
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (lane == u && base + u < cnt) {
        uint32_t key = rtt::kInfKey;
        if (t[u] >= 0) {
          const float d = fmaxf(
              __fsub_rn(__fadd_rn(c.qn, nrm[u]), __fmul_rn(2.f, dot[u])), 0.f);
          key = rtt::float_key(d);
        }
        c.ckey[base + u] = key;
      }
    }
  }
  __syncthreads();
}

// Merge the finite candidates into the beam `cur`, writing `nxt`. Returns
// the number of finite candidates (uniform over the block).
__device__ int merge(const Ctx& c, const Beam& cur, const Beam& nxt, int cnt) {
  const int tid = threadIdx.x;
  if (tid == 0) *c.scount = 0;
  __syncthreads();
  for (int j = tid; j < cnt; j += kThreads) {
    if (c.ckey[j] < rtt::kInfKey) {
      const int s = atomicAdd(c.scount, 1);
      c.skey[s] = (static_cast<unsigned long long>(c.ckey[j]) << 32) |
                  static_cast<unsigned>(j);
    }
  }
  __syncthreads();
  const int ns = *c.scount;
  if (ns == 0) return 0;
  int p = 1;
  while (p < ns) p <<= 1;
  for (int i = ns + tid; i < p; i += kThreads) c.skey[i] = ~0ull;
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (p >> 1); t += kThreads) {
        const int lo = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = c.skey[lo], b = c.skey[hi];
        if ((a > b) == ((lo & size) == 0)) {
          c.skey[lo] = b;
          c.skey[hi] = a;
        }
      }
      __syncthreads();
    }
  }
  const int itopk = c.itopk;
  // a beam entry moves down by the candidates strictly below it
  for (int i = tid; i < itopk; i += kThreads) {
    const uint32_t key = cur.key[i];
    int lo = 0, hi = ns;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (static_cast<uint32_t>(c.skey[mid] >> 32) < key) lo = mid + 1;
      else hi = mid;
    }
    const int pos = i + lo;
    if (pos < itopk) {
      nxt.key[pos] = key;
      nxt.id[pos] = cur.id[i];
      nxt.fl[pos] = cur.fl[i];
    }
  }
  // a candidate moves down by the beam entries at or below it
  for (int j = tid; j < ns; j += kThreads) {
    const uint32_t key = static_cast<uint32_t>(c.skey[j] >> 32);
    int lo = 0, hi = itopk;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cur.key[mid] <= key) lo = mid + 1;
      else hi = mid;
    }
    const int pos = j + lo;
    if (pos < itopk) {
      nxt.key[pos] = key;
      nxt.id[pos] = c.cid[static_cast<uint32_t>(c.skey[j] & 0xffffffffu)];
      nxt.fl[pos] = 0;
    }
  }
  __syncthreads();
  return ns;
}

__global__ void __launch_bounds__(kThreads)
fused_cagra_kernel(const float* __restrict__ queries,
                   const float* __restrict__ data,
                   const int32_t* __restrict__ graph,
                   const int32_t* __restrict__ seeds,
                   const float* __restrict__ q_norms, long long n, int dim,
                   int degree, int n_seeds, int k, int itopk, int width,
                   int max_iter, int vec4, int cap, float* __restrict__ out_v,
                   int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ptr = smem;
  auto take = [&](size_t bytes) {
    unsigned char* p = ptr;
    ptr += align16(bytes);
    return p;
  };
  Beam beam[2];
  for (int b = 0; b < 2; ++b) {
    beam[b].key = reinterpret_cast<uint32_t*>(take(itopk * 4));
    beam[b].id = reinterpret_cast<int32_t*>(take(itopk * 4));
    beam[b].fl = take(itopk);
  }
  float* qs = reinterpret_cast<float*>(take(static_cast<size_t>(dim) * 4));
  unsigned long long* skey =
      reinterpret_cast<unsigned long long*>(take(static_cast<size_t>(cap) * 8));
  int32_t* cid = reinterpret_cast<int32_t*>(take(static_cast<size_t>(cap) * 4));
  uint32_t* ckey =
      reinterpret_cast<uint32_t*>(take(static_cast<size_t>(cap) * 4));
  int* par = reinterpret_cast<int*>(take(static_cast<size_t>(width) * 4));
  int* scount = reinterpret_cast<int*>(ptr);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long q = blockIdx.x;
  for (int e = tid; e < dim; e += kThreads) qs[e] = queries[q * dim + e];
  for (int i = tid; i < itopk; i += kThreads) {
    beam[0].key[i] = rtt::kInfKey;
    beam[0].id[i] = -1;
    beam[0].fl[i] = 0;
  }
  __syncthreads();
  const Ctx c{data, qs, n, dim, vec4, itopk, q_norms[q], cid, ckey, skey,
              scount};
  int cur = 0;

  // ---- seeds, in chunks of `cap`
  for (int base = 0; base < n_seeds; base += cap) {
    const int cnt = n_seeds - base < cap ? n_seeds - base : cap;
    for (int j = tid; j < cnt; j += kThreads)
      cid[j] = seeds[q * n_seeds + base + j];
    __syncthreads();
    dedup(c, beam[cur], cnt);
    score(c, cnt);
    if (merge(c, beam[cur], beam[cur ^ 1], cnt) > 0) cur ^= 1;
  }

  // ---- hops
  const int wd = width * degree;
  for (int it = 0; it < max_iter; ++it) {
    const Beam b = beam[cur];
    if (warp == 0) {
      int found = 0;
      for (int base = 0; base < itopk && found < width; base += 32) {
        const int i = base + lane;
        const bool ok = i < itopk && b.fl[i] == 0 && b.key[i] < rtt::kInfKey;
        unsigned m = __ballot_sync(0xffffffffu, ok);
        while (m != 0u && found < width) {
          if (lane == 0) par[found] = base + __ffs(m) - 1;
          m &= m - 1;
          ++found;
        }
      }
      if (lane == 0)
        for (int w = found; w < width; ++w) par[w] = -1;
      __syncwarp();
      for (int w = lane; w < found; w += 32) b.fl[par[w]] = 1;
    }
    __syncthreads();
    if (par[0] < 0) break;  // nothing left to expand: the walk is done
    for (int j = tid; j < wd; j += kThreads) {
      const int p = par[j / degree];
      cid[j] = p < 0 ? -1
                     : graph[static_cast<long long>(b.id[p]) * degree +
                             j % degree];
    }
    __syncthreads();
    dedup(c, b, wd);
    score(c, wd);
    if (merge(c, b, beam[cur ^ 1], wd) > 0) cur ^= 1;
  }

  const Beam b = beam[cur];
  for (int i = tid; i < k; i += kThreads) {
    out_v[q * k + i] = rtt::key_float(b.key[i]);
    out_i[q * k + i] = b.id[i];
  }
}

// ------------------------------------------------------------- warp route

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpMaxItopk = 256;
constexpr int kWarpsPerBlock = 4;  // queries a block (gpu_kernels.CAGRA_WARPS)
constexpr int kBatch = 8;          // rows scored, and folded, at once
// blocks an SM the registers allow: 96 registers a thread, 20 queries an
// SM (at 64, 32 queries, the walk spilled and took 17% longer; at 128, 16
// queries, 4% longer, on the H100 over a random graph of 1M rows)
constexpr int kBlocksPerSm = 5;

// the formula of ops/gpu_kernels.py cagra_warp_smem_bytes: one warp's slice
__host__ __device__ inline size_t warp_slice_bytes(int itopk, int dim,
                                                   int cpl, int width) {
  return 2 * (2 * align16(static_cast<size_t>(itopk) * 4) +
              align16(static_cast<size_t>(itopk))) +
         align16(static_cast<size_t>(dim) * 4) +
         static_cast<size_t>(32 * cpl) * 8 +  // sorted candidate keys
         align16(static_cast<size_t>(width) * 4);
}

struct WarpCtx {
  const float* data;
  const float* qs;  // the query row in the warp's slice
  long long n;
  int dim, vec4, itopk;
  float qn;
  unsigned long long* skey;  // the sorted candidate keys [32·cpl]
};

// p[0..7]: a lane's partial sums of 8 rows; afterwards p[0] holds row
// ((lane >> 4) & 1)·4 + ((lane >> 3) & 1)·2 + ((lane >> 2) & 1)'s sum over
// the 32 lanes. Levels 16, 8 and 4 exchange half the rows with the lane
// that far (each keeps the rows on its side of that bit), levels 2 and 1
// add the partner's sum of the row left: row r's partials pair as in the
// xor ladder (l with l ^ 16, then 8, 4, 2, 1), operands commuted at most,
// so each sum is bitwise the ladder's, in 9 shuffles for 8 rows.
__device__ __forceinline__ void fold_batch(float (&p)[kBatch]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = kBatch / 2, o = 16; h > 0; h >>= 1, o >>= 1) {
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? p[i] : p[i + h];
      const float keep = up ? p[i + h] : p[i];
      p[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, o));
    }
  }
  p[0] = __fadd_rn(p[0], __shfl_xor_sync(kFull, p[0], 2));
  p[0] = __fadd_rn(p[0], __shfl_xor_sync(kFull, p[0], 1));
}

// a lane that holds row r (< 8) after fold_batch
__device__ __forceinline__ int fold_lane(int r) {
  return ((r >> 2) & 1) * 16 + ((r >> 1) & 1) * 8 + (r & 1) * 4;
}

// The float key of row t (+inf for t < 0) of each lane, the 32 rows
// scored in batches of 8 whose loads are in flight together; called by all
// 32 lanes.
__device__ __forceinline__ uint32_t score_rows(const WarpCtx& c, int32_t t) {
  const int lane = threadIdx.x & 31;
  const unsigned valid = __ballot_sync(kFull, t >= 0);
  float dot_r = 0.f, nrm_r = 0.f;  // this lane's row
  const int groups = (c.dim + 3) / 4;
#pragma unroll 1
  for (int rb = 0; rb < 32; rb += kBatch) {
    if (((valid >> rb) & 0xffu) == 0u) continue;  // uniform over the warp
    float dot[kBatch], nrm[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) dot[u] = nrm[u] = 0.f;
    for (int g0 = 0; g0 < groups; g0 += 32) {
      const int g = g0 + lane;
      const bool has = g < groups;
      float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (has) {
        if (c.vec4) {
          qv = reinterpret_cast<const float4*>(c.qs)[g];
        } else {
          const int e = 4 * g;
          qv.x = c.qs[e];
          qv.y = e + 1 < c.dim ? c.qs[e + 1] : 0.f;
          qv.z = e + 2 < c.dim ? c.qs[e + 2] : 0.f;
          qv.w = e + 3 < c.dim ? c.qs[e + 3] : 0.f;
        }
      }
      float4 v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int32_t row = __shfl_sync(kFull, t, rb + u);
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row >= 0 && has) {
          const float* src = c.data + static_cast<long long>(row) * c.dim;
          if (c.vec4) {
            v[u] = __ldg(reinterpret_cast<const float4*>(src) + g);
          } else {
            const int e = 4 * g;
            v[u].x = __ldg(src + e);
            if (e + 1 < c.dim) v[u].y = __ldg(src + e + 1);
            if (e + 2 < c.dim) v[u].z = __ldg(src + e + 2);
            if (e + 3 < c.dim) v[u].w = __ldg(src + e + 3);
          }
        }
      }
      // zeros past dim, or for a row that is not scored, add nothing: a sum
      // that starts at +0.0 is never -0.0, and x + ±0.0 == x for every other x
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        accumulate(dot[u], nrm[u], v[u].x, qv.x);
        accumulate(dot[u], nrm[u], v[u].y, qv.y);
        accumulate(dot[u], nrm[u], v[u].z, qv.z);
        accumulate(dot[u], nrm[u], v[u].w, qv.w);
      }
    }
    fold_batch(dot);
    fold_batch(nrm);
    const int src = fold_lane(lane & (kBatch - 1));
    const float d = __shfl_sync(kFull, dot[0], src);
    const float n2 = __shfl_sync(kFull, nrm[0], src);
    if ((lane & ~(kBatch - 1)) == rb) {
      dot_r = d;
      nrm_r = n2;
    }
  }
  if (t < 0) return rtt::kInfKey;
  const float d =
      fmaxf(__fsub_rn(__fadd_rn(c.qn, nrm_r), __fmul_rn(2.f, dot_r)), 0.f);
  return rtt::float_key(d);
}

// Ascending bitonic sort of the 32·CPL keys, element i = 32·c + lane in
// key[c]; called by all 32 lanes.
template <int CPL>
__device__ __forceinline__ void sort_keys(unsigned long long (&key)[CPL]) {
  const int lane = threadIdx.x & 31;
  constexpr int N = 32 * CPL;
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // CPL == 2: both elements in this lane
        const unsigned long long a = key[0], b = key[CPL - 1];
        key[0] = a < b ? a : b;
        key[CPL - 1] = a < b ? b : a;
        continue;
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int i = 32 * c + lane;
        const unsigned long long other =
            __shfl_xor_sync(kFull, key[c], stride);
        const bool take_min = ((lane & stride) == 0) == ((i & size) == 0);
        const bool less = key[c] < other;
        key[c] = take_min == less ? key[c] : other;
      }
    }
  }
}

// Candidates t[c] (position 32·c + lane, -1 past cnt) against the beam
// `cur`: drop the invalid ones, those equal to a beam id and those equal to
// an earlier candidate; score, sort and merge the finite ones into `nxt`.
// Returns their count (uniform over the warp).
template <int CPL>
__device__ __forceinline__ int warp_step(const WarpCtx& c, const Beam& cur,
                                         const Beam& nxt, int32_t (&t)[CPL]) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  bool drop[CPL];
#pragma unroll
  for (int u = 0; u < CPL; ++u)
    drop[u] = t[u] < 0 || t[u] >= c.n;
  // the beam's ids, four at a time, each read by the 32 lanes at once
  int i = 0;
  for (; i + 4 <= c.itopk; i += 4) {
    const int4 b = *reinterpret_cast<const int4*>(cur.id + i);
#pragma unroll
    for (int u = 0; u < CPL; ++u)
      drop[u] = drop[u] || t[u] == b.x || t[u] == b.y || t[u] == b.z ||
                t[u] == b.w;
  }
  for (; i < c.itopk; ++i) {
    const int32_t b = cur.id[i];
#pragma unroll
    for (int u = 0; u < CPL; ++u) drop[u] = drop[u] || t[u] == b;
  }
  // earlier candidates: the lowest lane of equal ids keeps its own, and the
  // second row of lanes checks the first row's ids too
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    const unsigned same = __match_any_sync(kFull, t[u]);
    drop[u] = drop[u] || (same & below) != 0u;
  }
  if (CPL == 2) {
    for (int s = 0; s < 32; ++s) {  // every lane shuffles, dropped or not
      const int32_t first = __shfl_sync(kFull, t[0], s);
      drop[CPL - 1] = drop[CPL - 1] || first == t[CPL - 1];
    }
  }
  unsigned long long key[CPL];
  int ns = 0;
  int32_t tv[CPL];
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    tv[u] = drop[u] ? -1 : t[u];
    const unsigned any = __ballot_sync(kFull, tv[u] >= 0);
    uint32_t kv = rtt::kInfKey;
    if (any) kv = score_rows(c, tv[u]);
    const bool fin = kv < rtt::kInfKey;
    ns += __popc(__ballot_sync(kFull, fin));
    key[u] = fin ? (static_cast<unsigned long long>(kv) << 32) |
                       static_cast<uint32_t>(32 * u + lane)
                 : ~0ull;
  }
  if (ns == 0) return 0;
  sort_keys<CPL>(key);
#pragma unroll
  for (int u = 0; u < CPL; ++u) c.skey[32 * u + lane] = key[u];
  __syncwarp();
  const int itopk = c.itopk;
  // a beam entry moves down by the candidates strictly below it
  for (int b = lane; b < itopk; b += 32) {
    const uint32_t bk = cur.key[b];
    int lo = 0, hi = ns;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (static_cast<uint32_t>(c.skey[mid] >> 32) < bk) lo = mid + 1;
      else hi = mid;
    }
    const int pos = b + lo;
    if (pos < itopk) {
      nxt.key[pos] = bk;
      nxt.id[pos] = cur.id[b];
      nxt.fl[pos] = cur.fl[b];
    }
  }
  // a candidate moves down by the beam entries at or below it
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    const int j = 32 * u + lane;
    const auto p = static_cast<uint32_t>(key[u] & 0xffffffffu);
    int32_t id = __shfl_sync(kFull, tv[0], p & 31u);
    if (CPL == 2) {
      const int32_t id1 = __shfl_sync(kFull, tv[CPL - 1], p & 31u);
      if (p >= 32u) id = id1;
    }
    if (j < ns) {
      const auto kv = static_cast<uint32_t>(key[u] >> 32);
      int lo = 0, hi = itopk;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cur.key[mid] <= kv) lo = mid + 1;
        else hi = mid;
      }
      const int pos = j + lo;
      if (pos < itopk) {
        nxt.key[pos] = kv;
        nxt.id[pos] = id;
        nxt.fl[pos] = 0;
      }
    }
  }
  __syncwarp();
  return ns;
}

template <int CPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kBlocksPerSm)
fused_cagra_warp_kernel(const float* __restrict__ queries,
                        const float* __restrict__ data,
                        const int32_t* __restrict__ graph,
                        const int32_t* __restrict__ seeds,
                        const float* __restrict__ q_norms, int nq, long long n,
                        int dim, int degree, int n_seeds, int k, int itopk,
                        int width, int max_iter, int vec4,
                        float* __restrict__ out_v,
                        int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (q >= nq) return;  // warps are independent: no block barrier below
  unsigned char* ptr =
      smem + (threadIdx.x >> 5) * warp_slice_bytes(itopk, dim, CPL, width);
  auto take = [&](size_t bytes) {
    unsigned char* p = ptr;
    ptr += align16(bytes);
    return p;
  };
  Beam cur, nxt;  // swapped after each merge
  cur.key = reinterpret_cast<uint32_t*>(take(itopk * 4));
  cur.id = reinterpret_cast<int32_t*>(take(itopk * 4));
  cur.fl = take(itopk);
  nxt.key = reinterpret_cast<uint32_t*>(take(itopk * 4));
  nxt.id = reinterpret_cast<int32_t*>(take(itopk * 4));
  nxt.fl = take(itopk);
  float* qs = reinterpret_cast<float*>(take(static_cast<size_t>(dim) * 4));
  unsigned long long* skey =
      reinterpret_cast<unsigned long long*>(take(32 * CPL * 8));
  int* par = reinterpret_cast<int*>(ptr);

  for (int e = lane; e < dim; e += 32) qs[e] = queries[q * dim + e];
  for (int i = lane; i < itopk; i += 32) {
    cur.key[i] = rtt::kInfKey;
    cur.id[i] = -1;
    cur.fl[i] = 0;
  }
  __syncwarp();
  const WarpCtx c{data, qs, n, dim, vec4, itopk, q_norms[q], skey};
  constexpr int cap = 32 * CPL;
  int32_t t[CPL];
  auto step = [&]() {
    if (warp_step<CPL>(c, cur, nxt, t) > 0) {
      const Beam b = cur;
      cur = nxt;
      nxt = b;
    }
  };

  // ---- seeds, in chunks of cap
  for (int base = 0; base < n_seeds; base += cap) {
    const int cnt = n_seeds - base < cap ? n_seeds - base : cap;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int j = 32 * u + lane;
      t[u] = j < cnt ? seeds[q * n_seeds + base + j] : -1;
    }
    step();
  }

  // ---- hops
  const int wd = width * degree;
  for (int it = 0; it < max_iter; ++it) {
    const Beam b = cur;
    int found = 0;
    for (int base = 0; base < itopk && found < width; base += 32) {
      const int i = base + lane;
      const bool ok = i < itopk && b.fl[i] == 0 && b.key[i] < rtt::kInfKey;
      unsigned m = __ballot_sync(kFull, ok);
      while (m != 0u && found < width) {
        if (lane == 0) par[found] = base + __ffs(m) - 1;
        m &= m - 1;
        ++found;
      }
    }
    if (lane == 0)
      for (int w = found; w < width; ++w) par[w] = -1;
    __syncwarp();
    for (int w = lane; w < found; w += 32) b.fl[par[w]] = 1;
    if (found == 0) break;  // nothing left to expand: the walk is done
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int j = 32 * u + lane;
      t[u] = -1;
      if (j < wd) {
        const int p = par[j / degree];
        if (p >= 0)
          t[u] = graph[static_cast<long long>(b.id[p]) * degree + j % degree];
      }
    }
    __syncwarp();
    step();
  }

  for (int i = lane; i < k; i += 32) {
    out_v[q * k + i] = rtt::key_float(cur.key[i]);
    out_i[q * k + i] = cur.id[i];
  }
}

template <int CPL>
cudaError_t launch_warp(const float* queries, const float* data,
                        const int32_t* graph, const int32_t* seeds,
                        const float* q_norms, int nq, long long n, int dim,
                        int degree, int n_seeds, int k, int itopk, int width,
                        int max_iter, int vec4, int warps, float* out_v,
                        int32_t* out_i, cudaStream_t s) {
  const size_t smem = warps * warp_slice_bytes(itopk, dim, CPL, width);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cagra_warp_kernel<CPL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_cagra_warp_kernel<CPL><<<(nq + warps - 1) / warps, warps * 32, smem,
                                 s>>>(queries, data, graph, seeds, q_norms, nq,
                                      n, dim, degree, n_seeds, k, itopk, width,
                                      max_iter, vec4, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace

// queries [nq, dim] f32, data [n, dim] f32, graph [n, degree] int32, seeds
// [nq, n_seeds] int32, q_norms [nq] f32 → out_v [nq, k] f32, out_i [nq, k]
// int32. route 0: the warp route (itopk <= 256, width·degree <= 64), `warps`
// queries a block; route 1: the block route.
extern "C" int fused_cagra_topk(const void* queries, const void* data,
                                const void* graph, const void* seeds,
                                const void* q_norms, int nq, long long n,
                                int dim, int degree, int n_seeds, int k,
                                int itopk, int width, int max_iter, int vec4,
                                int route, int warps, void* out_v, void* out_i,
                                void* stream) {
  const auto* qf = static_cast<const float*>(queries);
  const auto* df = static_cast<const float*>(data);
  const auto* gi = static_cast<const int32_t*>(graph);
  const auto* si = static_cast<const int32_t*>(seeds);
  const auto* qn = static_cast<const float*>(q_norms);
  auto* ov = static_cast<float*>(out_v);
  auto* oi = static_cast<int32_t*>(out_i);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    const int wd = width * degree;
    if (itopk > kWarpMaxItopk || wd > 64 || wd < 1 || warps < 1 ||
        warps > kWarpsPerBlock)
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err =
        wd <= 32 ? launch_warp<1>(qf, df, gi, si, qn, nq, n, dim, degree,
                                  n_seeds, k, itopk, width, max_iter, vec4,
                                  warps, ov, oi, s)
                 : launch_warp<2>(qf, df, gi, si, qn, nq, n, dim, degree,
                                  n_seeds, k, itopk, width, max_iter, vec4,
                                  warps, ov, oi, s);
    return static_cast<int>(err);
  }
  const int cap = cand_cap(width * degree);
  const size_t smem = cagra_smem_bytes(itopk, dim, cap, width);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cagra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_cagra_kernel<<<nq, kThreads, smem, s>>>(
      qf, df, gi, si, qn, n, dim, degree, n_seeds, k, itopk, width, max_iter,
      vec4, cap, ov, oi);
  return static_cast<int>(cudaGetLastError());
}
