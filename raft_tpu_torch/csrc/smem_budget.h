// The kernels' shared-memory accountants, in one host-and-device header.
//
// Every kernel launch of raft_tpu_torch/csrc takes its dynamic shared
// memory from a function of this header, and each function has a twin of
// the same name in raft_tpu_torch/ops/gpu_kernels.py, which the planners
// solve against. The header needs no CUDA: a C++ compiler builds it alone
// (tests/test_torch_analysis_kernels.py builds it with g++ and holds every
// twin to it exactly), and each kernel library exports the same functions
// as `rtt_<name>` (below), which chip_smoke.py phase 6k reads on the card.
//
// Where a Python twin counts a kernel's static __shared__ arrays too (the
// plans compare the total with the opt-in limit), the launch subtracts the
// static part named here.
#pragma once

#include <cstddef>

#if defined(__CUDACC__)
#define RTT_SMEM_HD __host__ __device__
#else
#define RTT_SMEM_HD
#endif

namespace rtt_smem {

// fused_l2_topk and fused_l2_argmin (tc_tile.cuh): query rows a consumer
// warpgroup, database rows a tile, floats a k-slice, survivors a row
constexpr int kTcBM = 64, kTcBN = 128, kTcBK = 32, kTcSurv = 16;
// fused_l2_topk's large-k FMA route: query rows a block, database rows a
// tile, features a staged slice
constexpr int kFmaTM = 16, kFmaTN = 128, kFmaDK = 32;
// the IVF scans (ivf_group.cuh): pairs a work item, slots a chunk, the
// elements a staged slab or query row takes
constexpr int kGroupPairs = 32, kScanSlots = 64, kStageRow = 132;
// fused_ivf_topk: rows a merge step of the per-query route; the largest k
// whose grouped carries live in registers; the grouped kernel's static
// arrays (its pairs' ids and norms, and a counter)
constexpr int kIvfChunk = 256, kIvfRegMaxK = 16;
constexpr size_t kIvfTopkStatic = 4 * kGroupPairs + 16;
// fused_pq_topk: rows a merge step and codebook entries (per-query route,
// 8 warps); subspaces a LUT chunk, floats a pair's chunk takes, rows a
// warp scans (grouped route), and the grouped kernel's static arrays
constexpr int kPqChunk = 256, kBook = 256, kPqWarps = 8;
constexpr int kPqSub = 4, kPqLutStride = kPqSub * kBook + 1;
constexpr int kPqRowsPerWarp = 64;
constexpr size_t kPqGroupedStatic = 512;
// select_k's shared-memory route (topk_carry.cuh): rows a block, values a
// warp streams a merge step
constexpr int kSelectWarps = 8, kSelectChunk = 128;

RTT_SMEM_HD constexpr size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// fused_l2_topk's tensor-core route with `wgs` consumer warpgroups:
// alignment slack, the ring (each stage the hi/lo planes of a 64·wgs × 32
// query slice and a 128 × 32 database slice), its barriers, the carry, the
// survivor buffers and their counts
RTT_SMEM_HD constexpr size_t l2_topk_tc_smem_bytes(int k, int stages,
                                                  int wgs) {
  return 1024 +
         static_cast<size_t>(stages) *
             (2 * static_cast<size_t>(kTcBM) * wgs * kTcBK * 4 +
              2 * static_cast<size_t>(kTcBN) * kTcBK * 4) +
         static_cast<size_t>(stages) * 16 +
         static_cast<size_t>(kTcBM) * wgs * k * 8 +
         static_cast<size_t>(kTcBM) * wgs * kTcSurv * 8 +
         static_cast<size_t>(kTcBM) * wgs * 4;
}

// fused_l2_topk's large-k route: the x and y slices (a column of padding
// each), 8-byte alignment, the survivors, the carry and their counts
RTT_SMEM_HD constexpr size_t l2_topk_fma_smem_bytes(int k) {
  return static_cast<size_t>(kFmaDK) * (kFmaTM + 1) * 4 +
         static_cast<size_t>(kFmaDK) * (kFmaTN + 1) * 4 + 8 +
         static_cast<size_t>(kFmaTM) * kFmaTN * 8 +
         static_cast<size_t>(kFmaTM) * k * 8 + static_cast<size_t>(kFmaTM) * 4;
}

// fused_ivf_topk's grouped route over rows of `elem_bytes`: two slab
// buffers, the group's query vectors, the static arrays, and above
// kIvfRegMaxK a chunk's survivors of each pair, their counts and the
// pairs' carries
RTT_SMEM_HD constexpr size_t ivf_topk_smem_bytes(int k, int elem_bytes) {
  return 2 * static_cast<size_t>(kScanSlots) * kStageRow * elem_bytes +
         static_cast<size_t>(kGroupPairs) * kStageRow * 4 + kIvfTopkStatic +
         (k <= kIvfRegMaxK
              ? 0
              : static_cast<size_t>(kGroupPairs) * kScanSlots * 8 +
                    static_cast<size_t>(kGroupPairs) * 4 +
                    static_cast<size_t>(kGroupPairs) * k * 8);
}

// fused_ivf_topk's per-query route: a chunk's survivors, the carry, the
// survivor count and the probe's query vector
RTT_SMEM_HD constexpr size_t ivf_topk_per_query_smem_bytes(int rot, int k) {
  return static_cast<size_t>(kIvfChunk) * 8 + static_cast<size_t>(k) * 8 +
         16 + static_cast<size_t>(rot) * 4;
}

// ivf_scan: two slab buffers and the group's query vectors
RTT_SMEM_HD constexpr size_t ivf_scan_smem_bytes(int elem_bytes) {
  return 2 * static_cast<size_t>(kScanSlots) * kStageRow * elem_bytes +
         static_cast<size_t>(kGroupPairs) * kStageRow * 4;
}

// the grouping passes of the IVF scans (ivf_group.cuh): a counter or a
// cursor for each list and one for the invalid probes
RTT_SMEM_HD constexpr size_t ivf_group_smem_bytes(int n_lists) {
  return static_cast<size_t>(n_lists + 1) * 4;
}

// select_k's shared-memory route: each warp's chunk of survivors, its
// carry and its count
RTT_SMEM_HD constexpr size_t select_k_smem_bytes(int k) {
  return static_cast<size_t>(kSelectWarps) *
         (static_cast<size_t>(kSelectChunk) * 8 + static_cast<size_t>(k) * 8 +
          16);
}

// fused_pq_topk's per-query route: survivors, the probe's LUT, the carry,
// the count, the residual and the partial sums of its norm
RTT_SMEM_HD constexpr size_t pq_topk_smem_bytes(int pq_dim, int pq_len,
                                               int k) {
  return static_cast<size_t>(kPqChunk) * 8 +
         static_cast<size_t>(pq_dim) * kBook * 4 + static_cast<size_t>(k) * 8 +
         16 + static_cast<size_t>(pq_dim) * pq_len * 4 + (kPqWarps + 1) * 4;
}

// the floats of a pair's staged residual in fused_pq_topk's grouped route:
// all of it, or one LUT chunk's
RTT_SMEM_HD constexpr int pq_res_floats(int pq_dim, int pq_len, int chunked) {
  return chunked ? kPqSub * pq_len : pq_dim * pq_len;
}

// fused_pq_topk's grouped route with `warps` warps: the 32 pairs' LUT chunk
// (later the run's distance keys), their residuals, the run's code words,
// and the static arrays
RTT_SMEM_HD constexpr size_t pq_grouped_smem_bytes(int pq_dim, int pq_len,
                                                  int warps,
                                                  int res_chunked) {
  return 4 * (static_cast<size_t>(kGroupPairs) * kPqLutStride +
              static_cast<size_t>(kGroupPairs) *
                  pq_res_floats(pq_dim, pq_len, res_chunked) +
              static_cast<size_t>((pq_dim + kPqSub - 1) / kPqSub) *
                  (static_cast<size_t>(kPqRowsPerWarp) * warps + 1)) +
         kPqGroupedStatic;
}

// fused_cagra_topk's block route: its candidate slots, a hop's width·degree
// targets rounded up to a power of two >= 32
RTT_SMEM_HD constexpr int cagra_cand_cap(int width, int degree) {
  int p = 32;
  while (p < width * degree) p <<= 1;
  return p;
}

// fused_cagra_topk's block route: two beam buffers (keys, ids, flags), the
// query row, the candidates' ids, keys and sort slots, the parents and two
// counters
RTT_SMEM_HD constexpr size_t cagra_topk_smem_bytes(int itopk, int dim,
                                                  int width, int degree) {
  return 2 * (2 * align16(static_cast<size_t>(itopk) * 4) +
              align16(static_cast<size_t>(itopk))) +
         align16(static_cast<size_t>(dim) * 4) +
         static_cast<size_t>(cagra_cand_cap(width, degree)) * 16 +
         align16(static_cast<size_t>(width) * 4) + 16;
}

// one warp's slice of fused_cagra_topk's warp route with `cands` sorted
// candidate keys (32 or 64): two beam buffers, the query row, the keys and
// the parents
RTT_SMEM_HD constexpr size_t cagra_warp_slice_bytes(int itopk, int dim,
                                                   int cands, int width) {
  return 2 * (2 * align16(static_cast<size_t>(itopk) * 4) +
              align16(static_cast<size_t>(itopk))) +
         align16(static_cast<size_t>(dim) * 4) +
         static_cast<size_t>(cands) * 8 +
         align16(static_cast<size_t>(width) * 4);
}

// one warp's slice of the warp route for hops of width·degree candidates
RTT_SMEM_HD constexpr size_t cagra_warp_smem_bytes(int itopk, int dim,
                                                  int width, int degree) {
  return cagra_warp_slice_bytes(itopk, dim, width * degree <= 32 ? 32 : 64,
                                width);
}

// fused_l2_argmin: alignment slack, the ring (each stage the hi/lo planes
// of a 128 × 32 slice of y, and of x in the scratch route), the block's x
// rows as hi/lo planes of d_pad features in the resident route, the
// barriers
RTT_SMEM_HD constexpr size_t l2_argmin_smem_bytes(int resident, int d_pad,
                                                 int stages) {
  return 1024 +
         static_cast<size_t>(stages) * (resident ? 1 : 2) * 2 * 128 * kTcBK *
             4 +
         (resident ? static_cast<size_t>(d_pad / kTcBK) * 2 * 128 * kTcBK * 4
                   : 0) +
         static_cast<size_t>(stages) * 16;
}

}  // namespace rtt_smem

// The accountants as a plain C interface: each library built from this
// directory exports them, so the bytes a launch asks for can be read from
// the built code itself.
extern "C" {
long long rtt_l2_topk_tc_smem_bytes(int k, int stages, int wgs) {
  return static_cast<long long>(rtt_smem::l2_topk_tc_smem_bytes(k, stages,
                                                                wgs));
}
long long rtt_l2_topk_fma_smem_bytes(int k) {
  return static_cast<long long>(rtt_smem::l2_topk_fma_smem_bytes(k));
}
long long rtt_ivf_topk_smem_bytes(int k, int elem_bytes) {
  return static_cast<long long>(rtt_smem::ivf_topk_smem_bytes(k, elem_bytes));
}
long long rtt_ivf_topk_per_query_smem_bytes(int rot, int k) {
  return static_cast<long long>(
      rtt_smem::ivf_topk_per_query_smem_bytes(rot, k));
}
long long rtt_ivf_scan_smem_bytes(int elem_bytes) {
  return static_cast<long long>(rtt_smem::ivf_scan_smem_bytes(elem_bytes));
}
long long rtt_ivf_group_smem_bytes(int n_lists) {
  return static_cast<long long>(rtt_smem::ivf_group_smem_bytes(n_lists));
}
long long rtt_select_k_smem_bytes(int k) {
  return static_cast<long long>(rtt_smem::select_k_smem_bytes(k));
}
long long rtt_pq_topk_smem_bytes(int pq_dim, int pq_len, int k) {
  return static_cast<long long>(
      rtt_smem::pq_topk_smem_bytes(pq_dim, pq_len, k));
}
long long rtt_pq_grouped_smem_bytes(int pq_dim, int pq_len, int warps,
                                    int res_chunked) {
  return static_cast<long long>(
      rtt_smem::pq_grouped_smem_bytes(pq_dim, pq_len, warps, res_chunked));
}
long long rtt_cagra_topk_smem_bytes(int itopk, int dim, int width,
                                    int degree) {
  return static_cast<long long>(
      rtt_smem::cagra_topk_smem_bytes(itopk, dim, width, degree));
}
long long rtt_cagra_warp_smem_bytes(int itopk, int dim, int width,
                                    int degree) {
  return static_cast<long long>(
      rtt_smem::cagra_warp_smem_bytes(itopk, dim, width, degree));
}
long long rtt_l2_argmin_smem_bytes(int resident, int d_pad, int stages) {
  return static_cast<long long>(
      rtt_smem::l2_argmin_smem_bytes(resident, d_pad, stages));
}
}
