// Fused probe gather + scan + top-k for the IVF families.
//
// Replaces raft_tpu/ops/pallas_kernels.py:fused_ivf_topk
// (_fused_ivf_topk_kernel): for each (query, probe, slab rows) the partial
// distance ‖q‖² + ‖row‖² − 2·q·row (clamped at 0 when asked), slots whose id
// is < 0 masked to +inf, merged into the query's running top-k, so the
// [nq, P, list_pad] candidate slab never exists in device memory. Ties
// resolve in (probe, slot) order, the TPU kernel's order.
//
// Bound on the H100: the product, 2·rot operations a scanned slot (about
// 1.2 ms at the fp32 peak for 10,000 queries × 32 probes of 1M rows), with
// the probed slabs read once (about 0.23 ms at 3.35 TB/s). A design that
// reads each slab once per (query, probe) is bound by those reads instead
// (about 151 GB for that batch): a list is probed by about 300 queries.
//
// Design (k <= gpu_kernels.IVF_TOPK_GROUPED_MAX_K, the grouped route; the
// plan is gpu_kernels.plan_fused_ivf):
//   1. the (query, probe) pairs are ordered by list on the device
//      (ivf_group.cuh, the grouping ivf_scan uses), in groups of 32 pairs;
//   2. a block is one work item, a group of one list's pairs and a run of
//      64-slot chunks, and runs ivf_scan's slab tile (ivf_group.cuh): the
//      chunks stream through shared memory once by cp.async, double
//      buffered, each pair's distances from its own qres vector (IVF-PQ's
//      residuals differ per probe) in fp32 from f32, bf16, fp16, int8 or
//      uint8 rows (ivfg::RowType). Chunks
//      past the run's last filled slot are not read. The epilogue of a
//      chunk compares each distance with its pair's k-th value in
//      registers. Up to k = 16 a pair's carry lives in the registers of its
//      16 lanes and a survivor goes in by shuffles (reg_insert); above, the
//      survivors are compacted by warp ballot and a warp merges them into
//      the sorted carries of its eight pairs in shared memory
//      (topk_carry.cuh). Each carry is ordered by (value, slot); a pair's
//      top-k of the run, its values and list ids, goes to the partials
//      [nq, P, runs, k];
//   3. a select_rows pass (topk_carry.cuh, the select_k kernel) takes each
//      query's top k of its P·runs·k partials, streamed in (probe, run,
//      rank) order with ties to the earlier: for equal values that is
//      (probe, slot) order, since a pair's ranks and runs follow its slots.
//   No atomic decides an order, so two runs are bitwise equal.
// Above that k a pair's carry no longer fits beside the slab buffers, and
// the per-query route takes over (route 1, fused_ivf_topk_kernel): one block
// per query walks its probes in order, one slab row per warp step, and
// merges each chunk's survivors into the query's carry.
#include "ivf_group.cuh"
#include "topk_carry.cuh"

namespace {

// ------------------------------------------------------ per-query route

constexpr int kChunk = 256;  // slab rows per merge step
constexpr int kThreads = 256;

size_t ivf_smem_bytes(int rot, int k) {
  return static_cast<size_t>(kChunk) * 8 +  // survivors
         static_cast<size_t>(k) * 8 +       // carry
         16 +                               // survivor count
         static_cast<size_t>(rot) * 4;      // this probe's query vector
}

using ivfg::to_f32;

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
cudaError_t launch_per_query(const int32_t* probes, const float* qres,
                             const float* qn, const void* list_data,
                             const float* row_norms, const int32_t* list_ids,
                             int nq, int n_probes, int n_lists, int pad,
                             int rot, int k, int clamp, float* out_v,
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

// ---------------------------------------------------------- grouped route

using ivfg::kR;
using ivfg::kRS;
using ivfg::kS;

struct SlotIds {  // a pair's carry keeps the slot; the list id comes last
  __device__ int32_t operator()(uint32_t pos) const {
    return static_cast<int32_t>(pos);
  }
};

// Merge the pending survivors of pairs r0 + b (bit b of f) into their
// carries, by the whole warp. Out of line: the epilogue's copies per pair
// would crowd the instruction cache.
__device__ __noinline__ void merge_pairs(unsigned f, int r0, uint32_t* cval,
                                         int32_t* cid, int k,
                                         unsigned long long* skey,
                                         const int* scount) {
  for (; f; f &= f - 1) {
    const int r = r0 + __ffs(f) - 1;
    const int n = scount[r];
    uint32_t* cv = cval + r * k;
    int32_t* ci = cid + r * k;
    unsigned long long* sk = skey + r * kS;
    if (n <= 4) {  // the common case: a few inserts beat a sort and a merge
      for (int i = 0; i < n; ++i)
        rtt::warp_insert(cv, ci, k, static_cast<uint32_t>(sk[i] >> 32),
                         static_cast<int32_t>(static_cast<uint32_t>(sk[i])));
    } else {
      rtt::warp_merge(cv, ci, k, sk, n, SlotIds{});
    }
    __syncwarp();
  }
}

struct GroupArgs {
  const float* qres;       // [pairs, rot]
  const float* qn;         // [pairs]
  const void* list_data;   // [n_lists, pad, rot]
  const float* row_norms;  // [n_lists, pad]
  const int32_t* list_ids;
  const int32_t* order;    // the grouping (ivfg::launch_group)
  const int32_t* list_start;
  const int32_t* list_count;
  const int32_t* group_end;
  int n_lists, pad, rot, k, clamp, chunks_per_run, runs;
  float* part_v;           // [pairs, runs, k]
  int32_t* part_i;
};

constexpr int kG = ivfg::kGroupPairs;
constexpr int kGroupedThreads = 128;

// Up to this k the carries live in registers (reg_insert), above it in
// shared memory (merge_pairs)
constexpr int kRegMaxK = 16;

// the formula of gpu_kernels.ivf_topk_smem_bytes: slab buffers, the
// group's query vectors, and above kRegMaxK a chunk's survivors of each
// pair, their counts and the pairs' carries
template <typename T>
size_t grouped_smem_bytes(int k) {
  return 2 * static_cast<size_t>(kS) * kRS * sizeof(T) +
         static_cast<size_t>(kG) * kRS * 4 +
         (k <= kRegMaxK ? 0
                        : static_cast<size_t>(kG) * kS * 8 + kG * 4 +
                              static_cast<size_t>(kG) * k * 8);
}

// an empty entry of a register carry: (+inf, slot -1), after every real one
constexpr unsigned long long kEmpty =
    (static_cast<unsigned long long>(rtt::kInfKey) << 32) | 0xffffffffu;

// Insert each half-warp's candidates into its own register carry: the 16
// lanes of a half hold the carry of one pair, entry l (ascending 64-bit
// (value key, slot) keys) in lane l, and `thr` its entry k - 1. A lane's
// candidate `key` (when `ok`) goes in only while below `thr`, the half's
// candidates one at a time in lane order; the result is the k smallest keys
// whatever the order. Called by all 32 lanes; no shared memory, no barrier.
__device__ __forceinline__ void reg_insert(unsigned long long& entry,
                                           unsigned long long& thr,
                                           unsigned long long key, bool ok,
                                           int k) {
  const int lane = threadIdx.x & 31, l = lane & 15, shift = lane & 16;
  bool pending = ok && key < thr;
  for (;;) {
    const unsigned half =
        (__ballot_sync(0xffffffffu, pending) >> shift) & 0xffffu;
    if (!__any_sync(0xffffffffu, half != 0)) break;
    const int src = half ? __ffs(half) - 1 : 0;
    const unsigned long long cand =
        __shfl_sync(0xffffffffu, key, shift + src);
    if (l == src) pending = false;
    const int pos = __popc(
        (__ballot_sync(0xffffffffu, entry < cand) >> shift) & 0xffffu);
    const unsigned long long prev = __shfl_up_sync(0xffffffffu, entry, 1, 16);
    if (half) entry = l == pos ? cand : l > pos ? prev : entry;
    thr = __shfl_sync(0xffffffffu, entry, k - 1, 16);
    pending = pending && key < thr;
  }
}

// Step 2 of the grouped route: ivf_scan's FMA tile (ivf_group.cuh) with
// the slab chunks double-buffered, 32 pairs and 128 threads: slots tx + 16i
// of a chunk, pairs 4·ty + p, so warp w holds pairs 8w..8w+7 (16 lanes a
// pair) and keeps their carries: in the registers of those 16 lanes for k
// up to kRegMaxK (REG), else in shared memory. V: elements of T a slab
// copy; VQ: floats a query load.
template <typename T, int V, int VQ, bool REG>
__global__ void __launch_bounds__(kGroupedThreads)
grouped_topk_kernel(const GroupArgs a) {
  constexpr int G = kG, NT = kGroupedThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufs = reinterpret_cast<T*>(smem_raw);  // 2 × [kS][kRS] slab rows
  float* qs = reinterpret_cast<float*>(smem_raw + 2 * kS * kRS * sizeof(T));
  unsigned long long* skey =
      reinterpret_cast<unsigned long long*>(qs + G * kRS);  // [G][kS]
  int* scount = reinterpret_cast<int*>(skey + G * kS);     // [G]
  uint32_t* cval = reinterpret_cast<uint32_t*>(scount + G);  // [G][k]
  int32_t* cid = reinterpret_cast<int32_t*>(cval + G * a.k);  // [G][k]
  __shared__ int pid[G];
  __shared__ int item[3];  // list, first pair, pairs
  __shared__ int s_end;

  const int k = a.k, rot = a.rot, pad = a.pad;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the block's work item: its list (n_lists for the probes outside [0,
  // n_lists), past it for blocks past the last group), its pairs, its run
  // of chunks [c_lo, c_end), which ends at the run's last filled slot
  if (tid < 32)
    ivfg::find_item(a.group_end, a.list_start, a.list_count, a.n_lists,
                    blockIdx.x, item);
  if (tid == 0) s_end = 0;
  __syncthreads();
  const int list = item[0];
  if (list > a.n_lists) return;  // uniform over the block
  const int np = item[2];
  if (tid < np) pid[tid] = a.order[item[1] + tid];
  const int run = blockIdx.y;
  const int n_chunks = (pad + kS - 1) / kS;
  const int c_lo = run * a.chunks_per_run;
  const int c_hi =
      c_lo + a.chunks_per_run < n_chunks ? c_lo + a.chunks_per_run : n_chunks;
  const int s_lo = c_lo * kS, s_hi = c_hi * kS < pad ? c_hi * kS : pad;
  const int32_t* lids = a.list_ids + static_cast<long long>(list) * pad;
  int last = 0;  // one past the run's last filled slot
  if (list < a.n_lists)
    for (int s = s_lo + tid; s < s_hi; s += NT)
      if (lids[s] >= 0) last = s + 1;
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0 && last > 0) atomicMax(&s_end, last);
  if (!REG)
    for (int i = tid; i < G * k; i += NT) {
      cval[i] = rtt::kInfKey;
      cid[i] = -1;
    }
  __syncthreads();
  const int c_end = s_end > s_lo ? c_lo + (s_end - s_lo + kS - 1) / kS : c_lo;

  const int tx = tid & 15, ty = tid >> 4;
  const bool busy = 8 * warp < np;  // uniform over the warp
  const T* lslab = static_cast<const T*>(a.list_data) +
                   static_cast<long long>(list) * pad * rot;
  const float* lnorms = a.row_norms + static_cast<long long>(list) * pad;
  const int n_r = (rot + kR - 1) / kR;  // feature steps a chunk
  const int steps = (c_end - c_lo) * n_r;
  auto issue = [&](int st) {
    const int c = c_lo + st / n_r, r0 = (st % n_r) * kR;
    const int rows = pad - c * kS < kS ? pad - c * kS : kS;
    ivfg::copy_slab<T, V, NT>(
        bufs + (st & 1) * kS * kRS,
        lslab + static_cast<long long>(c) * kS * rot, rot, rows, r0,
        rot - r0 < kR ? rot - r0 : kR);
    ivfg::cp_async_commit();
  };
  float qnr[4];
  uint32_t thr[4];                  // shared-memory carries: entry k - 1
  unsigned long long entry[4], rthr[4];  // register carries
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int pp = 4 * ty + p;
    qnr[p] = pp < np ? a.qn[pid[pp]] : 0.f;
    thr[p] = rtt::kInfKey;
    entry[p] = rthr[p] = kEmpty;
  }
  if (steps > 0 && n_r == 1)
    ivfg::stage_queries<VQ, G, NT>(qs, a.qres, pid, np, rot, 0, rot);
  float acc[4][4] = {};
  if (steps > 0) issue(0);
  for (int st = 0; st < steps; ++st) {
    const int c = c_lo + st / n_r, r0 = (st % n_r) * kR;
    const int rc = rot - r0 < kR ? rot - r0 : kR;
    if (st + 1 < steps) {
      issue(st + 1);
      ivfg::cp_async_wait<1>();
    } else {
      ivfg::cp_async_wait<0>();
    }
    if (n_r > 1)
      ivfg::stage_queries<VQ, G, NT>(qs, a.qres, pid, np, rot, r0, rc);
    __syncthreads();
    const T* xs = bufs + (st & 1) * kS * kRS;
    if (busy) ivfg::tile_product(acc, xs, qs, tx, ty, rc);
    if (busy && r0 + rc == rot) {
      // the chunk's last feature step: each distance against its pair's
      // k-th value; in registers each survivor goes into its pair's carry
      // at once, in shared memory a pair's survivors (16 lanes, 4 slots
      // each) are compacted by ballot into its buffer, then merged by the
      // warp
      const int s0 = c * kS;
      const int rows = pad - s0 < kS ? pad - s0 : kS;
      float nrm[4];
      bool filled[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = tx + 16 * i;
        filled[i] = s < rows && lids[s0 + s] >= 0;
        nrm[i] = filled[i] ? lnorms[s0 + s] : 0.f;
      }
      if constexpr (REG) {
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float dist = __fsub_rn(__fadd_rn(qnr[p], nrm[i]),
                                   __fmul_rn(2.f, acc[p][i]));
            if (a.clamp) dist = fmaxf(dist, 0.f);
            const uint32_t key = rtt::float_key(dist);
            reg_insert(entry[p], rthr[p],
                       (static_cast<unsigned long long>(key) << 32) |
                           static_cast<uint32_t>(s0 + tx + 16 * i),
                       4 * ty + p < np && filled[i] && key < rtt::kInfKey,
                       k);
            acc[p][i] = 0.f;
          }
      } else {
        const unsigned below = (1u << (lane & 15)) - 1u;
        unsigned flags = 0;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int pp = 4 * ty + p;
          int n = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t key = 0;
            bool ok = pp < np && filled[i];
            if (ok) {
              float dist = __fsub_rn(__fadd_rn(qnr[p], nrm[i]),
                                     __fmul_rn(2.f, acc[p][i]));
              if (a.clamp) dist = fmaxf(dist, 0.f);
              key = rtt::float_key(dist);
              ok = key < thr[p];
            }
            const unsigned half =
                (__ballot_sync(0xffffffffu, ok) >> (lane & 16)) & 0xffffu;
            if (ok)
              skey[pp * kS + n + __popc(half & below)] =
                  (static_cast<unsigned long long>(key) << 32) |
                  static_cast<uint32_t>(s0 + tx + 16 * i);
            n += __popc(half);
            acc[p][i] = 0.f;
          }
          if ((lane & 15) == 0) scount[pp] = n;
          const unsigned has = __ballot_sync(0xffffffffu, n > 0);
          flags |= ((has & 1u) << p) | (((has >> 16) & 1u) << (4 + p));
        }
        __syncwarp();
        if (flags) {
          merge_pairs(flags, 8 * warp, cval, cid, k, skey, scount);
#pragma unroll
          for (int p = 0; p < 4; ++p)
            thr[p] = cval[(4 * ty + p) * k + k - 1];
        }
      }
    }
    __syncthreads();
  }
  // the run's top-k of the warp's pairs: values, and the slots' list ids
  if constexpr (REG) {
    const int l = lane & 15;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int pp = 4 * ty + p;
      if (pp < np && l < k) {
        const long long o =
            (static_cast<long long>(pid[pp]) * a.runs + run) * k + l;
        const auto slot = static_cast<int32_t>(entry[p] & 0xffffffffu);
        a.part_v[o] = rtt::key_float(static_cast<uint32_t>(entry[p] >> 32));
        a.part_i[o] = slot < 0 ? -1 : lids[slot];
      }
    }
    return;
  }
  for (int r = 8 * warp; r < 8 * warp + 8 && r < np; ++r) {
    const long long o = (static_cast<long long>(pid[r]) * a.runs + run) * k;
    for (int j = lane; j < k; j += 32) {
      const int32_t slot = cid[r * k + j];
      a.part_v[o + j] = rtt::key_float(cval[r * k + j]);
      a.part_i[o + j] = slot < 0 ? -1 : lids[slot];
    }
  }
}

template <typename T>
cudaError_t launch_grouped(const GroupArgs& a, long long n_pairs,
                           cudaStream_t s) {
  // the widest copies the rows allow: four elements (16 bytes of f32, 8 of
  // bf16 or fp16, 4 of int8 or uint8) and float4 query loads when every
  // row starts on such a boundary
  const bool vec =
      a.rot % 4 == 0 && reinterpret_cast<uintptr_t>(a.qres) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(a.list_data) % (4 * sizeof(T)) == 0;
  const size_t smem = grouped_smem_bytes<T>(a.k);
  const bool reg = a.k <= kRegMaxK;
  auto kernel = vec ? (reg ? grouped_topk_kernel<T, 4, 4, true>
                           : grouped_topk_kernel<T, 4, 4, false>)
                    : (reg ? grouped_topk_kernel<T, 1, 1, true>
                           : grouped_topk_kernel<T, 1, 1, false>);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(
      static_cast<unsigned>((n_pairs + kG - 1) / kG + a.n_lists + 1),
      static_cast<unsigned>(a.runs));
  kernel<<<grid, kGroupedThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_grouped(const int32_t* probes, GroupArgs a, int nq,
                        int n_probes, int32_t* groups, float* out_v,
                        int32_t* out_i, cudaStream_t s) {
  const long long n_pairs = static_cast<long long>(nq) * n_probes;
  cudaError_t err =
      ivfg::launch_group(probes, n_pairs, a.n_lists, groups, s);
  if (err != cudaSuccess) return err;
  a.order = groups;
  a.list_start = groups + n_pairs;
  a.list_count = a.list_start + a.n_lists + 1;
  a.group_end = a.list_count + a.n_lists + 1;
  err = launch_grouped<T>(a, n_pairs, s);
  if (err != cudaSuccess) return err;
  return rtt::launch_select_rows(a.part_v, a.part_i, nq,
                                 static_cast<long long>(n_probes) * a.runs *
                                     a.k,
                                 a.k, 0, out_v, out_i, s);
}

}  // namespace

// probes [nq, P] int32, qres [nq, P, rot] f32, qn [nq, P] f32, list_data
// [n_lists, pad, rot] of the row type `row_type` (ivfg::RowType: f32, bf16,
// fp16, int8, uint8), row_norms [n_lists, pad] f32, list_ids [n_lists, pad] int32 → out_v [nq, k] f32, out_i [nq, k]
// int32. route 0: the grouped route, in runs of chunks_per_run 64-slot
// chunks, with int32 scratch `groups` of ivfg::group_scratch(nq·P,
// n_lists) and the partials part_v/part_i [nq, P, runs, k]; route 1: the
// per-query route (no scratch).
extern "C" int fused_ivf_topk(const void* probes, const void* qres,
                              const void* qn, const void* list_data,
                              int row_type, const void* row_norms,
                              const void* list_ids, int nq, int n_probes,
                              int n_lists, int pad, int rot, int k, int clamp,
                              int route, int chunks_per_run, void* groups,
                              void* part_v, void* part_i, void* out_v,
                              void* out_i, void* stream) {
  const auto* p = static_cast<const int32_t*>(probes);
  const auto* qr = static_cast<const float*>(qres);
  const auto* qnf = static_cast<const float*>(qn);
  const auto* rn = static_cast<const float*>(row_norms);
  const auto* li = static_cast<const int32_t*>(list_ids);
  auto* ov = static_cast<float*>(out_v);
  auto* oi = static_cast<int32_t*>(out_i);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq < 1 || n_probes < 1 || n_lists < 1 || pad < 1 || rot < 1 || k < 1 ||
      route < 0 || route > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (route == 0) {
    const long long n_pairs = static_cast<long long>(nq) * n_probes;
    const long long n_chunks = (pad + kS - 1) / kS;
    if (chunks_per_run < 1 ||
        (n_chunks + chunks_per_run - 1) / chunks_per_run > 65535 ||
        n_pairs > 0x7fffffffLL ||
        (n_pairs + kG - 1) / kG + n_lists + 1 > 0x7fffffffLL ||
        groups == nullptr || part_v == nullptr || part_i == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    GroupArgs a;
    a.qres = qr;
    a.qn = qnf;
    a.list_data = list_data;
    a.row_norms = rn;
    a.list_ids = li;
    a.n_lists = n_lists;
    a.pad = pad;
    a.rot = rot;
    a.k = k;
    a.clamp = clamp;
    a.chunks_per_run = chunks_per_run;
    a.runs = static_cast<int>((n_chunks + chunks_per_run - 1) / chunks_per_run);
    a.part_v = static_cast<float*>(part_v);
    a.part_i = static_cast<int32_t*>(part_i);
    auto* g = static_cast<int32_t*>(groups);
    err = ivfg::with_row_type(row_type, [&](auto tag) {
      return run_grouped<decltype(tag)>(p, a, nq, n_probes, g, ov, oi, s);
    });
  } else {
    err = ivfg::with_row_type(row_type, [&](auto tag) {
      return launch_per_query<decltype(tag)>(p, qr, qnf, list_data, rn, li,
                                             nq, n_probes, n_lists, pad, rot,
                                             k, clamp, ov, oi, s);
    });
  }
  return static_cast<int>(err);
}
