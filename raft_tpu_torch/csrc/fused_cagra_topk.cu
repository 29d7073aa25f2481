// CAGRA's greedy beam walk, one query per block.
//
// Replaces raft_tpu/ops/pallas_kernels.py:fused_cagra_topk
// (_fused_cagra_kernel): per query, the itopk-entry beam (distance, id,
// "expanded" flag) lives in shared memory for the whole walk.
//   - Seeds stream in chunks. A seed equal to a beam entry or to an earlier
//     seed of its chunk is dropped, which keeps the first copy of each id
//     (an evicted first copy's later copies cannot re-enter: the beam only
//     gets better under the (distance, position) order). Seeds merge in
//     seed-position order on ties.
//   - Each hop picks the `width` first unexpanded finite entries of the
//     sorted beam (the cheapest, lowest index on ties) and flags them; the
//     first pick finding nothing ends the walk (the done-freeze). The
//     parents' graph rows are the targets (-1 for invalid parents and edges,
//     ids outside [0, n) count as invalid); a target equal to a beam id or
//     to an earlier target is dropped.
//   - Scoring: one warp per row, four rows at a time. Element e of a row is
//     added by lane (e / 4) % 32, each lane in element order, then the lane
//     sums fold by the xor-shuffle ladder; every product and sum is an
//     explicit __fmul_rn / __fadd_rn, so the order of additions is fixed and
//     the plain version (ops/gpu_kernels.py lane_order_sum) repeats it
//     bitwise. d = max(fl(fl(qn + vn) - fl(2 * dot)), 0).
//   - Merge: the finite targets (or seeds) are sorted by one 64-bit (value,
//     position) key (bitonic, in shared memory) and merged with the beam by
//     rank: the beam first on ties, then candidates in position order, the
//     first itopk kept. This is the first-occurrence extraction
//     (_extract_topk_flagged) of the TPU kernel, and the stable sort of the
//     XLA engine. Distances compare as topk_carry.cuh's float keys (-0.0
//     folded onto +0.0); +inf entries are padding with id -1.
// Output: the first k entries of the beam (squared L2; the wrapper's caller
// applies the square root for L2SqrtExpanded).
//
// Bound on the H100: the rows the walk scores (dim * 4 bytes each, read at
// random) and the serial hops between them. A hop's gathers cannot start
// before its parent is known, so one query's walk is a chain of dependent
// global loads (graph row, then dataset rows); the card is kept busy by
// running many queries' blocks at once (128 threads and a few KB of shared
// memory each). Overlapping one hop's gathers with the next, a hash-table
// visited set and several queries per block at small itopk are later work.
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

}  // namespace

extern "C" int fused_cagra_topk(const void* queries, const void* data,
                                const void* graph, const void* seeds,
                                const void* q_norms, int nq, long long n,
                                int dim, int degree, int n_seeds, int k,
                                int itopk, int width, int max_iter, int vec4,
                                void* out_v, void* out_i, void* stream) {
  const int cap = cand_cap(width * degree);
  const size_t smem = cagra_smem_bytes(itopk, dim, cap, width);
  cudaError_t err = cudaFuncSetAttribute(
      fused_cagra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_cagra_kernel<<<nq, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(queries), static_cast<const float*>(data),
      static_cast<const int32_t*>(graph), static_cast<const int32_t*>(seeds),
      static_cast<const float*>(q_norms), n, dim, degree, n_seeds, k, itopk,
      width, max_iter, vec4, cap, static_cast<float*>(out_v),
      static_cast<int32_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
