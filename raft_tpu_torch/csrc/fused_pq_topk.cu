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
// A LUT entry is the residual q − c first, then fmaf over pq_len from 0,
// then cbn − 2·dot; the per-subspace terms are summed in subspace order,
// then ‖res‖² is added, with no clamp. Slots whose id is < 0 and probes
// outside [0, n_lists) are +inf (never selected). Neither the [nq, P,
// pq_dim, 256] LUTs nor the [nq, P, list_pad] candidate slab ever exist in
// device memory. Ties resolve in (probe, slot) order, the TPU kernel's.
//
// The TPU kernel did the LUT lookup as a one-hot compare/select per subspace
// because Mosaic has no gather. Here the LUT lives in shared memory and each
// row's codes index it directly.
//
// Bound on the H100: the lookups, one shared-memory read a (row, pair,
// subspace): 19 G at the main path's shape, 2.3 ms at 32 reads a clock on
// each of 132 SMs, against 0.75 ms for the operations at the fp32 peak.
//
// Design (k <= gpu_kernels.PQ_GROUPED_MAX_K, the grouped route; the plan is
// gpu_kernels.plan_fused_pq):
//   1. the (query, probe) pairs are ordered by list on the device
//      (ivf_group.cuh, the grouping of the IVF scans), in groups of 32;
//   2. a block is one work item, a group of one list's pairs (one pair a
//      lane) and a run of 64·warps slots (the registers of a lane hold 64
//      rows' sums). The pairs' residuals (whole, or a chunk at a time for a
//      wide rotation) and the run's codes, as words of four subspaces, are
//      staged into shared memory once. The subspaces then go by in chunks
//      of four: the block builds the chunk's LUT of all 32 pairs (each
//      codebook entry and its norm read once for the 32, prefetched into
//      registers during the previous chunk's lookups; a warp builds 64
//      codes of one subspace, reading eight pairs' residuals before it
//      stores their entries), and each warp adds the chunk's four entries
//      to the sums of its 64 rows. A row's code word is the same for the 32
//      lanes and each lane looks up its own pair's LUT, whose stride
//      (4·256 + 1 floats) puts the 32 reads in 32 banks; a lookup is a
//      byte-permute, a shift-add, the load and the add. After the last
//      chunk the rows' distance keys go to shared memory ([pair, row]) and
//      one warp a pair keeps its top k of the run by (value, slot) in
//      registers, entry l in lane l (k <= 32), written to the partials
//      [nq, P, runs, k] with the slots' list ids;
//   3. a select_rows pass (topk_carry.cuh, the select_k kernel) takes each
//      query's top k of its P·runs·k partials, streamed in (probe, run,
//      rank) order with ties to the earlier: for equal values that is
//      (probe, slot) order, since a pair's ranks and runs follow its slots.
//   No atomic decides an order, so two runs are bitwise equal.
// Above that k the per-query route (route 1, fused_pq_topk_kernel): one
// block of 256 threads per query walks its probes in order, builds each
// probe's [pq_dim, 256] LUT in shared memory and scans the list one row a
// thread, merging each 256-row chunk's survivors into the query's carry.
#include <cstdint>

#include "ivf_group.cuh"
#include "smem_budget.h"
#include "topk_carry.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;  // list rows per merge step: one per thread
constexpr int kBook = 256;   // codebook entries per subspace (pq_bits 8)
constexpr int kWarps = kThreads / 32;

// the layout rtt_smem::pq_topk_smem_bytes counts
static_assert(kChunk == rtt_smem::kPqChunk && kBook == rtt_smem::kBook &&
                  kWarps == rtt_smem::kPqWarps,
              "smem_budget.h describes another layout");

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

// ---------------------------------------------------------- grouped route

constexpr int kG = ivfg::kGroupPairs;    // pairs a work item, one a lane
constexpr int kSub = 4;                  // subspaces a LUT chunk: a code word
constexpr int kLutStride = kSub * kBook + 1;  // ≡ 1 mod 32: (pair + code) banks
constexpr int kRowsPerWarp = 64;         // rows whose sums a lane holds
constexpr int kMaxWarps = 16;
constexpr unsigned kFull = 0xffffffffu;

// an empty entry of a register carry: (+inf, slot -1), after every real one
constexpr unsigned long long kEmpty =
    (static_cast<unsigned long long>(rtt::kInfKey) << 32) | 0xffffffffu;

struct GroupArgs {
  const float* q_rot;        // [nq, rot]
  const float* centers_rot;  // [n_lists, rot]
  const float* codebooks;    // [pq_dim, 256, pq_len]
  const float* cb_norms;     // [pq_dim, 256]
  const uint8_t* codes;      // [n_lists, pad, pq_dim]
  const int32_t* list_ids;   // [n_lists, pad]
  const int32_t* order;      // the grouping (ivfg::launch_group)
  const int32_t* list_start;
  const int32_t* list_count;
  const int32_t* group_end;
  int n_probes, n_lists, pad, pq_dim, pq_len, k, runs;
  int res_chunked;           // residuals staged a LUT chunk at a time
  float* part_v;             // [pairs, runs, k]
  int32_t* part_i;
};

// the layout rtt_smem::pq_grouped_smem_bytes counts (its static arrays
// apart): the LUT chunk of the 32 pairs (after the last chunk the run's
// distance keys [kG][rows + 1]), the pairs' residuals [kG][res_floats],
// the run's code words [words][rows + 1]
static_assert(kG == rtt_smem::kGroupPairs && kSub == rtt_smem::kPqSub &&
                  kLutStride == rtt_smem::kPqLutStride &&
                  kRowsPerWarp == rtt_smem::kPqRowsPerWarp,
              "smem_budget.h describes another layout");
using rtt_smem::pq_res_floats;

// Insert each lane's candidate into the warp's register carry: entry l
// (ascending 64-bit (value key, slot) keys) in lane l, `thr` its entry
// k - 1 (k <= 32). A lane's candidate `key` (when `ok`) goes in only while
// below `thr`, one at a time in lane order; the result is the k smallest
// keys whatever the order. Called by all 32 lanes.
__device__ __forceinline__ void warp_reg_insert(unsigned long long& entry,
                                                unsigned long long& thr,
                                                unsigned long long key,
                                                bool ok, int k) {
  const int lane = threadIdx.x & 31;
  bool pending = ok && key < thr;
  for (;;) {
    const unsigned m = __ballot_sync(kFull, pending);
    if (m == 0u) break;
    const int src = __ffs(m) - 1;
    const unsigned long long cand = __shfl_sync(kFull, key, src);
    if (lane == src) pending = false;
    const int pos = __popc(__ballot_sync(kFull, entry < cand));
    const unsigned long long prev = __shfl_up_sync(kFull, entry, 1);
    entry = lane == pos ? cand : lane > pos ? prev : entry;
    thr = __shfl_sync(kFull, entry, k - 1);
    pending = pending && key < thr;
  }
}

// One codebook entry (s, c) of a LUT chunk: its PL floats and its norm
// (PL = 0: pq_len known at run time, the floats read when used; the
// grouped kernel is built for PL = 2, the main path's pq_len, and 0)
template <int PL>
struct CbEntry {
  float c[PL > 0 ? PL : 1];
  float n;
};

// Entry e (subspace 4w + e / 256, code e % 256) of chunk w; zeros past
// the last subspace
template <int PL>
__device__ __forceinline__ CbEntry<PL> load_entry(const GroupArgs& a, int w,
                                                  int e) {
  CbEntry<PL> ce;
  const int sub = w * kSub + e / kBook;
#pragma unroll
  for (int l = 0; l < (PL > 0 ? PL : 1); ++l) ce.c[l] = 0.f;
  ce.n = 0.f;
  if (sub < a.pq_dim) {
    const long long i = static_cast<long long>(sub) * kBook + e % kBook;
#pragma unroll
    for (int l = 0; l < PL; ++l) ce.c[l] = __ldg(a.codebooks + i * PL + l);
    ce.n = __ldg(a.cb_norms + i);
  }
  return ce;
}

// The entry of subspace S (of a LUT chunk) for the code in byte S of the
// word cw, from this lane's LUT at shared address lsa: the byte's offset
// by one byte-permute and one shift-add, the subspace's by the load's
// immediate (C++ indexing took two integer multiply-adds a lookup).
template <int S>
__device__ __forceinline__ float lut_at(uint32_t lsa, uint32_t cw) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1+%2];"
               : "=f"(v)
               : "r"(lsa + (__byte_perm(cw, 0u, 0x4440u + S) << 2)),
                 "n"(S * kBook * 4));
  return v;
}

// A pair's residual sub-vector (PL floats; PL = 0: pq_len floats read
// where used)
template <int PL>
struct Res {
  float v[PL > 0 ? PL : 1];
  const float* p;
};

template <int PL>
__device__ __forceinline__ Res<PL> load_res(const float* r) {
  Res<PL> x;
  x.p = r;
  if constexpr (PL == 2) {
    const float2 v = *reinterpret_cast<const float2*>(r);
    x.v[0] = v.x;
    x.v[1] = v.y;
  } else {
    x.v[0] = 0.f;
  }
  return x;
}

// cbn − 2·⟨res, cb⟩ of a codebook entry: fmaf over pq_len from 0, in order
template <int PL>
__device__ __forceinline__ float lut_entry(const Res<PL>& r,
                                           const CbEntry<PL>& ce,
                                           const float* cb, int pq_len) {
  float dot = 0.f;
  if constexpr (PL > 0) {
#pragma unroll
    for (int l = 0; l < PL; ++l) dot = fmaf(r.v[l], ce.c[l], dot);
  } else {
    for (int l = 0; l < pq_len; ++l) dot = fmaf(r.p[l], __ldg(cb + l), dot);
  }
  return __fsub_rn(ce.n, __fmul_rn(2.f, dot));
}

constexpr int kResBatch = 8;  // pairs whose residuals are read before stores

// A warp's unit u of chunk w: the 64 codes [64·(u % 4), +64) of the
// chunk's subspace u / 4, two entries a lane (e and e + 32), for the 32
// pairs: lut[g][e] = cbn − 2·dot, 0 past the last subspace. Each pair's
// residual is read once for both, eight pairs' before their stores (a
// store between would order the next read after it). res: [kG][rf] floats
// from subspace s0.
template <int PL>
__device__ __forceinline__ void build_unit(const GroupArgs& a, float* lut,
                                           const float* res, int rf, int s0,
                                           int w, int u, const CbEntry<PL>& ca,
                                           const CbEntry<PL>& cb2) {
  const int e = (u / 4) * kBook + (u % 4) * 64 + (threadIdx.x & 31);
  const int sub = w * kSub + u / 4;
  if (sub >= a.pq_dim) {
#pragma unroll 8
    for (int g = 0; g < kG; ++g) {
      lut[g * kLutStride + e] = 0.f;
      lut[g * kLutStride + e + 32] = 0.f;
    }
    return;
  }
  const int pq_len = PL > 0 ? PL : a.pq_len;
  const float* cba = a.codebooks +
                     (static_cast<long long>(sub) * kBook + e % kBook) * pq_len;
  const float* cbb = cba + 32 * pq_len;
  const float* r0 = res + (sub - s0) * pq_len;
#pragma unroll
  for (int g0 = 0; g0 < kG; g0 += kResBatch) {
    Res<PL> r[kResBatch];
#pragma unroll
    for (int i = 0; i < kResBatch; ++i) r[i] = load_res<PL>(r0 + (g0 + i) * rf);
#pragma unroll
    for (int i = 0; i < kResBatch; ++i) {
      float* out = lut + (g0 + i) * kLutStride + e;
      out[0] = lut_entry<PL>(r[i], ca, cba, pq_len);
      out[32] = lut_entry<PL>(r[i], cb2, cbb, pq_len);
    }
  }
}

// the two codebook entries of unit u of chunk w that this lane builds
template <int PL>
__device__ __forceinline__ void load_unit(const GroupArgs& a, int w, int u,
                                          CbEntry<PL>& ca, CbEntry<PL>& cb2) {
  const int e = (u / 4) * kBook + (u % 4) * 64 + (threadIdx.x & 31);
  ca = load_entry<PL>(a, w, e);
  cb2 = load_entry<PL>(a, w, e + 32);
}

constexpr int kUnits = kSub * kBook / 64;  // units of a LUT chunk

// Step 2 of the grouped route, blockDim.x = 32·warps threads. PL: pq_len
// when it is 2 (else 0). WORDS: every code row starts on a 4-byte
// boundary and pq_dim % 4 == 0, so a row's words are read whole.
template <int PL, bool WORDS>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
grouped_pq_kernel(const GroupArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nt = blockDim.x, nw = nt >> 5;
  const int rows = kRowsPerWarp * nw;  // slots a run
  const int rs = rows + 1;             // stride of a staged row of words
  const int words = (a.pq_dim + kSub - 1) / kSub;
  const int pq_dim = a.pq_dim, rot = pq_dim * a.pq_len;
  float* lut = reinterpret_cast<float*>(smem_raw);        // [kG][kLutStride]
  uint32_t* dkey = reinterpret_cast<uint32_t*>(smem_raw);  // [kG][rs], last
  const int rf = pq_res_floats(pq_dim, a.pq_len, a.res_chunked);
  float* res = lut + kG * kLutStride;                      // [kG][rf]
  uint32_t* cw_s = reinterpret_cast<uint32_t*>(res + kG * rf);  // [words][rs]
  __shared__ int pid[kG];
  __shared__ float base[kG];
  __shared__ int item[3];  // list, first pair, pairs
  __shared__ int s_end;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
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
  const int s_lo = run * rows;
  const int s_hi = s_lo + rows < a.pad ? s_lo + rows : a.pad;
  const int32_t* lids = a.list_ids + static_cast<long long>(list) * a.pad;
  int last = 0;  // one past the run's last filled slot
  if (list < a.n_lists)
    for (int s = s_lo + tid; s < s_hi; s += nt)
      if (lids[s] >= 0) last = s + 1;
  last = __reduce_max_sync(kFull, last);
  if (lane == 0 && last > 0) atomicMax(&s_end, last);
  __syncthreads();  // pid and s_end
  const int n_run = s_end > s_lo ? s_end - s_lo : 0;  // uniform
  const int row0 = warp * kRowsPerWarp;               // within the run
  const int n_w = n_run - row0 < 0 ? 0
                : n_run - row0 < kRowsPerWarp ? n_run - row0 : kRowsPerWarp;
  float acc[kRowsPerWarp];
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) acc[j] = 0.f;

  if (n_run > 0) {
    // the pairs' residuals q − c (zeros past np) of subspaces from s0, rf
    // floats a pair
    const float* cv = a.centers_rot + static_cast<long long>(list) * rot;
    auto stage_res = [&](int s0) {
      const int e0 = s0 * a.pq_len;
      for (int e = tid; e < kG * rf; e += nt) {
        const int g = e / rf, el = e0 + e - g * rf;
        res[e] = g < np && el < rot
                     ? __fsub_rn(a.q_rot[static_cast<long long>(
                                     pid[g] / a.n_probes) * rot + el],
                                 cv[el])
                     : 0.f;
      }
    };
    // all of them once, unless they are staged a chunk at a time; and the
    // run's codes, four subspaces a word (zero bytes past pq_dim)
    if (!a.res_chunked) stage_res(0);
    const uint8_t* lcodes =
        a.codes + (static_cast<long long>(list) * a.pad + s_lo) * pq_dim;
    for (int e = tid; e < n_run * words; e += nt) {
      const int r = e / words, w = e - r * words;
      const uint8_t* row = lcodes + static_cast<long long>(r) * pq_dim;
      uint32_t word;
      if constexpr (WORDS) {
        word = *reinterpret_cast<const uint32_t*>(row + kSub * w);
      } else {
        word = 0u;
        for (int b = 0; b < kSub && kSub * w + b < pq_dim; ++b)
          word |= static_cast<uint32_t>(row[kSub * w + b]) << (8 * b);
      }
      cw_s[w * rs + r] = word;
    }
    CbEntry<PL> pre0, pre1;  // the entries of chunk 0's first unit
    load_unit<PL>(a, 0, warp < kUnits ? warp : 0, pre0, pre1);
    __syncthreads();  // res
    // ‖res‖² of each pair, one warp a pair
    for (int g = warp; g < np; g += nw) {
      const float* qv =
          a.q_rot + static_cast<long long>(pid[g] / a.n_probes) * rot;
      float part = 0.f;
      for (int e = lane; e < rot; e += 32) {
        const float r =
            a.res_chunked ? __fsub_rn(qv[e], cv[e]) : res[g * rot + e];
        part = __fadd_rn(part, __fmul_rn(r, r));
      }
      part = warp_sum(part);
      if (lane == 0) base[g] = part;
    }
    // this lane's LUT: a shared-window address, each lookup one LEA away
    const auto lsa = static_cast<uint32_t>(
        __cvta_generic_to_shared(lut + lane * kLutStride));
    for (int w = 0; w < words; ++w) {
      __syncthreads();  // the previous chunk's lookups are done
      const int s0 = a.res_chunked ? w * kSub : 0;
      if (a.res_chunked) {
        stage_res(s0);
        __syncthreads();
      }
      // this chunk's LUT: entry (g, s, c) of every pair, each codebook entry
      // and its norm read once for the 32 pairs, a unit of 64 codes a warp
      if (warp < kUnits)
        build_unit<PL>(a, lut, res, rf, s0, w, warp, pre0, pre1);
      for (int u = warp + nw; u < kUnits; u += nw) {
        CbEntry<PL> ca, cb2;
        load_unit<PL>(a, w, u, ca, cb2);
        build_unit<PL>(a, lut, res, rf, s0, w, u, ca, cb2);
      }
      __syncthreads();
      if (w + 1 < words)  // the next chunk's entries, in flight meanwhile
        load_unit<PL>(a, w + 1, warp < kUnits ? warp : 0, pre0, pre1);
      // the chunk's four entries added to the sums of the warp's rows, in
      // subspace order; a row's word is the same for the 32 lanes
      if (n_w > 0) {
        const uint32_t c0 = cw_s[w * rs + row0 + lane];
        const uint32_t c1 = cw_s[w * rs + row0 + 32 + lane];
#pragma unroll
        for (int j = 0; j < kRowsPerWarp; ++j) {  // rows past n_w: unused
          const uint32_t cw = __shfl_sync(kFull, j < 32 ? c0 : c1, j & 31);
          acc[j] = __fadd_rn(acc[j], lut_at<0>(lsa, cw));
          acc[j] = __fadd_rn(acc[j], lut_at<1>(lsa, cw));
          acc[j] = __fadd_rn(acc[j], lut_at<2>(lsa, cw));
          acc[j] = __fadd_rn(acc[j], lut_at<3>(lsa, cw));
        }
      }
    }
    __syncthreads();  // the LUT becomes the distance keys
    // each lane (pair) writes the keys of the warp's rows: +inf for slots
    // whose id is < 0 and past the run's last filled slot
    if (n_w > 0) {
      const int r0 = s_lo + row0;
      const unsigned v0 = __ballot_sync(
          kFull, lane < n_w && lids[r0 + lane] >= 0);
      const unsigned v1 = __ballot_sync(
          kFull, 32 + lane < n_w && lids[r0 + 32 + lane] >= 0);
      const float bs = lane < np ? base[lane] : 0.f;
      uint32_t* dk = dkey + lane * rs + row0;
#pragma unroll
      for (int jb = 0; jb < kRowsPerWarp; jb += 8) {
        if (jb < n_w) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = jb + jj;
            const bool ok = ((j < 32 ? v0 : v1) >> (j & 31)) & 1u;
            dk[j] = ok ? rtt::float_key(__fadd_rn(acc[j], bs)) : rtt::kInfKey;
          }
        }
      }
    }
    __syncthreads();
  }
  // each pair's top k of the run, one warp a pair, then its partials
  for (int g = warp; g < np; g += nw) {
    unsigned long long entry = kEmpty, thr = kEmpty;
    const uint32_t* dk = dkey + g * rs;
    for (int c0 = 0; c0 < n_run; c0 += 32) {
      const int r = c0 + lane;
      const uint32_t key = r < n_run ? dk[r] : rtt::kInfKey;
      warp_reg_insert(entry, thr,
                      (static_cast<unsigned long long>(key) << 32) |
                          static_cast<uint32_t>(s_lo + r),
                      key < rtt::kInfKey, a.k);
    }
    if (lane < a.k) {
      const long long o =
          (static_cast<long long>(pid[g]) * a.runs + run) * a.k + lane;
      const auto slot = static_cast<int32_t>(entry & 0xffffffffu);
      a.part_v[o] = rtt::key_float(static_cast<uint32_t>(entry >> 32));
      a.part_i[o] = slot < 0 ? -1 : lids[slot];
    }
  }
}

template <int PL>
cudaError_t launch_grouped_pq(const GroupArgs& a, long long n_pairs,
                              int warps, int words_ok, cudaStream_t s) {
  const size_t smem = rtt_smem::pq_grouped_smem_bytes(a.pq_dim, a.pq_len,
                                                      warps, a.res_chunked) -
                      rtt_smem::kPqGroupedStatic;
  auto kernel =
      words_ok ? grouped_pq_kernel<PL, true> : grouped_pq_kernel<PL, false>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(
      static_cast<unsigned>((n_pairs + kG - 1) / kG + a.n_lists + 1),
      static_cast<unsigned>(a.runs));
  kernel<<<grid, warps * 32, smem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t run_grouped(const int32_t* probes, GroupArgs a, int nq,
                        int warps, int words_ok, int32_t* groups,
                        float* out_v, int32_t* out_i, cudaStream_t s) {
  const long long n_pairs = static_cast<long long>(nq) * a.n_probes;
  cudaError_t err = ivfg::launch_group(probes, n_pairs, a.n_lists, groups, s);
  if (err != cudaSuccess) return err;
  a.order = groups;
  a.list_start = groups + n_pairs;
  a.list_count = a.list_start + a.n_lists + 1;
  a.group_end = a.list_count + a.n_lists + 1;
  err = a.pq_len == 2 ? launch_grouped_pq<2>(a, n_pairs, warps, words_ok, s)
                      : launch_grouped_pq<0>(a, n_pairs, warps, words_ok, s);
  if (err != cudaSuccess) return err;
  return rtt::launch_select_rows(
      a.part_v, a.part_i, nq,
      static_cast<long long>(a.n_probes) * a.runs * a.k, a.k, 0, out_v, out_i,
      s);
}

}  // namespace

// probes [nq, P] int32, q_rot [nq, rot] f32, centers_rot [n_lists, rot] f32,
// codebooks [pq_dim, 256, pq_len] f32, cb_norms [pq_dim, 256] f32, codes
// [n_lists, pad, pq_dim] uint8, list_ids [n_lists, pad] int32 → out_v [nq,
// k] f32, out_i [nq, k] int32. route 0: the grouped route (k <= 32), runs
// of 64·warps slots, the pairs' residuals staged whole or (res_chunked) a
// LUT chunk at a time, with int32 scratch `groups` of
// ivfg::group_scratch(nq·P, n_lists) and the partials part_v/part_i [nq, P,
// runs, k]; `vec`: every
// code row starts on a 4-byte boundary (pq_dim % 4 == 0). route 1: the
// per-query route (no scratch); `vec`: 16-byte code rows.
extern "C" int fused_pq_topk(const void* probes, const void* q_rot,
                             const void* centers_rot, const void* codebooks,
                             const void* cb_norms, const void* codes,
                             const void* list_ids, int nq, int n_probes,
                             int n_lists, int pad, int pq_dim, int pq_len,
                             int k, int vec, int route, int warps,
                             int res_chunked, void* groups, void* part_v,
                             void* part_i,
                             void* out_v, void* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq < 1 || n_probes < 1 || n_lists < 1 || pad < 1 || pq_dim < 1 ||
      pq_len < 1 || k < 1 || route < 0 || route > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 0) {
    const long long n_pairs = static_cast<long long>(nq) * n_probes;
    const int rows = kRowsPerWarp * warps;
    const long long runs = (pad + static_cast<long long>(rows) - 1) / rows;
    if (k > 32 || warps < 1 || warps > kMaxWarps || runs > 65535 ||
        n_pairs > 0x7fffffffLL ||
        (n_pairs + kG - 1) / kG + n_lists + 1 > 0x7fffffffLL ||
        groups == nullptr || part_v == nullptr || part_i == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    GroupArgs a;
    a.q_rot = static_cast<const float*>(q_rot);
    a.centers_rot = static_cast<const float*>(centers_rot);
    a.codebooks = static_cast<const float*>(codebooks);
    a.cb_norms = static_cast<const float*>(cb_norms);
    a.codes = static_cast<const uint8_t*>(codes);
    a.list_ids = static_cast<const int32_t*>(list_ids);
    a.n_probes = n_probes;
    a.n_lists = n_lists;
    a.pad = pad;
    a.pq_dim = pq_dim;
    a.pq_len = pq_len;
    a.k = k;
    a.runs = static_cast<int>(runs);
    a.res_chunked = res_chunked;
    a.part_v = static_cast<float*>(part_v);
    a.part_i = static_cast<int32_t*>(part_i);
    return static_cast<int>(run_grouped(
        static_cast<const int32_t*>(probes), a, nq, warps, vec,
        static_cast<int32_t*>(groups), static_cast<float*>(out_v),
        static_cast<int32_t*>(out_i), s));
  }
  const size_t smem = rtt_smem::pq_topk_smem_bytes(pq_dim, pq_len, k);
  cudaError_t err = cudaFuncSetAttribute(
      fused_pq_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_pq_topk_kernel<<<nq, kThreads, smem, s>>>(
      static_cast<const int32_t*>(probes), static_cast<const float*>(q_rot),
      static_cast<const float*>(centers_rot),
      static_cast<const float*>(codebooks), static_cast<const float*>(cb_norms),
      static_cast<const uint8_t*>(codes), static_cast<const int32_t*>(list_ids),
      n_probes, n_lists, pad, pq_dim, pq_len, k, vec,
      static_cast<float*>(out_v), static_cast<int32_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}
