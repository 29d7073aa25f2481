// Unfused IVF probe scan: partial distances of every probed list slot.
//
// Replaces raft_tpu/ops/pallas_kernels.py:ivf_scan (_ivf_scan_kernel): for
// each (query, probe) pair and every slot of the probed list,
//   out[q, p, slot] = row_norms[list, slot] − 2·list_data[list, slot]·qres[q, p]
// with list = probes[q, p], in fp32 over f32, bf16, fp16, int8 or uint8
// list rows (ivfg::RowType); a probe
// outside [0, n_lists) writes +inf. The [nq, P, pad, rot] gather never exists
// in device memory; the [nq, P, pad] partials go to a separate select_k, and
// the caller adds the query's norm and masks the unfilled slots (all pad
// slots are written). It serves the IVF requests the fused kernels decline:
// filtered, inner-product and cosine search, and k > 1024.
//
// Bound on the H100: bytes. Each probed slab and its norms read once and the
// partials written once; the 2·rot operations a slot sit below them (a tile
// of 440 queries × 32 probes is about 5 GFLOP, 0.08 ms at the fp32 peak), so
// tensor cores would buy nothing.
//
// Design: the grouping and the slab tile of ivf_group.cuh (shared with
// fused_ivf_topk): the pairs ordered by list on the device, a block one work
// item (list, a run of slot chunks, a group of up to kG of the list's
// pairs), its chunks streamed through two shared-memory buffers by
// cp.async while the previous one is multiplied, and each chunk's kG × kS
// partials written out once their last feature step is summed. A slab is
// read once per group of the queries that probe its list, instead of once
// per (query, probe), and two runs are bitwise equal.
#include "ivf_group.cuh"
#include "smem_budget.h"

namespace {

using ivfg::kR;
using ivfg::kRS;
using ivfg::kS;

constexpr int kG = ivfg::kGroupPairs;
constexpr int kThreads = 128;

// the layout rtt_smem::ivf_scan_smem_bytes counts: two slab buffers of
// [kS][kRS] rows and the group's query vectors
static_assert(kG == rtt_smem::kGroupPairs && kS == rtt_smem::kScanSlots &&
                  kRS == rtt_smem::kStageRow,
              "smem_budget.h describes another layout");

// V: elements of T a slab copy; VQ: floats a query load
template <typename T, int V, int VQ>
__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const float* __restrict__ qres, const T* __restrict__ list_data,
                const float* __restrict__ row_norms,
                const int32_t* __restrict__ order,
                const int32_t* __restrict__ list_start,
                const int32_t* __restrict__ list_count,
                const int32_t* __restrict__ group_end, int n_lists, int pad,
                int rot, int chunks_per_block, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufs = reinterpret_cast<T*>(smem_raw);  // 2 × [kS][kRS] slab rows
  float* qs = reinterpret_cast<float*>(smem_raw + 2 * kS * kRS * sizeof(T));
  __shared__ int pid[kG];
  __shared__ int item[3];  // list, first pair, pairs

  const int tid = threadIdx.x;
  if (tid < 32)
    ivfg::find_item(group_end, list_start, list_count, n_lists, blockIdx.x,
                    item);
  __syncthreads();
  const int list = item[0];
  if (list > n_lists) return;  // past the last group: uniform over the block
  const int np = item[2];
  if (tid < np) pid[tid] = order[item[1] + tid];
  __syncthreads();
  const int n_chunks = (pad + kS - 1) / kS;
  const int c_lo = blockIdx.y * chunks_per_block;
  const int c_hi = c_lo + chunks_per_block < n_chunks ? c_lo + chunks_per_block
                                                      : n_chunks;

  if (list == n_lists) {  // probes outside [0, n_lists)
    const int s_lo = c_lo * kS, s_hi = c_hi * kS < pad ? c_hi * kS : pad;
    for (int e = tid; e < np * (s_hi - s_lo); e += kThreads) {
      const int p = e / (s_hi - s_lo), s = s_lo + e % (s_hi - s_lo);
      out[static_cast<long long>(pid[p]) * pad + s] =
          __int_as_float(0x7f800000);
    }
    return;
  }

  // slots tx + 16i, pairs 4·ty + p: warp w holds pairs 8w..8w+7, and a warp
  // whose pairs are all past the group's skips the products
  const int tx = tid & 15, ty = tid >> 4;
  const bool busy = 8 * (tid >> 5) < np;
  const T* lslab = list_data + static_cast<long long>(list) * pad * rot;
  const int n_r = (rot + kR - 1) / kR;  // feature steps a chunk
  const int steps = (c_hi - c_lo) * n_r;
  auto issue = [&](int st) {
    const int c = c_lo + st / n_r, r0 = (st % n_r) * kR;
    const int rows = pad - c * kS < kS ? pad - c * kS : kS;
    ivfg::copy_slab<T, V, kThreads>(
        bufs + (st & 1) * kS * kRS,
        lslab + static_cast<long long>(c) * kS * rot, rot, rows, r0,
        rot - r0 < kR ? rot - r0 : kR);
    ivfg::cp_async_commit();
  };
  if (n_r == 1)
    ivfg::stage_queries<VQ, kG, kThreads>(qs, qres, pid, np, rot, 0, rot);
  float acc[4][4] = {};
  issue(0);
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
      ivfg::stage_queries<VQ, kG, kThreads>(qs, qres, pid, np, rot, r0, rc);
    __syncthreads();
    const T* xs = bufs + (st & 1) * kS * kRS;
    if (busy) ivfg::tile_product(acc, xs, qs, tx, ty, rc);
    if (r0 + rc == rot) {  // the chunk's last feature step: write it out
      const int s0 = c * kS;
      const int rows = pad - s0 < kS ? pad - s0 : kS;
      const float* norms = row_norms + static_cast<long long>(list) * pad + s0;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int pp = 4 * ty + p;
        if (pp < np) {
          float* o = out + static_cast<long long>(pid[pp]) * pad + s0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int s = tx + 16 * i;
            if (s < rows)
              o[s] = __fsub_rn(norms[s], __fmul_rn(2.f, acc[p][i]));
            acc[p][i] = 0.f;
          }
        }
      }
    }
    __syncthreads();
  }
}

template <typename T, int V, int VQ>
cudaError_t launch(const float* qres, const void* list_data,
                   const float* row_norms, const int32_t* order,
                   const int32_t* list_start, const int32_t* list_count,
                   const int32_t* group_end, long long n_pairs, int n_lists,
                   int pad, int rot, int chunks_per_block, float* out,
                   cudaStream_t stream) {
  constexpr size_t smem = rtt_smem::ivf_scan_smem_bytes(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      ivf_scan_kernel<T, V, VQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_chunks = (pad + kS - 1) / kS;
  const dim3 grid(
      static_cast<unsigned>((n_pairs + kG - 1) / kG + n_lists + 1),
      static_cast<unsigned>((n_chunks + chunks_per_block - 1) /
                            chunks_per_block));
  ivf_scan_kernel<T, V, VQ><<<grid, kThreads, smem, stream>>>(
      qres, static_cast<const T*>(list_data), row_norms, order, list_start,
      list_count, group_end, n_lists, pad, rot, chunks_per_block, out);
  return cudaGetLastError();
}

// the widest copies the rows allow: four elements (16 bytes of f32, 8 of
// bf16 or fp16, 4 of int8 or uint8) when every row starts on such a
// boundary, else one element
template <typename T>
cudaError_t dispatch(const float* q, const void* data, const float* rn,
                     const int32_t* ord, const int32_t* ls, const int32_t* lc,
                     const int32_t* ge, long long n_pairs, int n_lists, int pad,
                     int rot, int cpb, float* o, cudaStream_t s) {
  const bool q4 = rot % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const bool v4 = rot % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(data) % (4 * sizeof(T)) == 0;
  if (v4)
    return q4 ? launch<T, 4, 4>(q, data, rn, ord, ls, lc, ge, n_pairs, n_lists,
                                pad, rot, cpb, o, s)
              : launch<T, 4, 1>(q, data, rn, ord, ls, lc, ge, n_pairs, n_lists,
                                pad, rot, cpb, o, s);
  return q4 ? launch<T, 1, 4>(q, data, rn, ord, ls, lc, ge, n_pairs, n_lists,
                              pad, rot, cpb, o, s)
            : launch<T, 1, 1>(q, data, rn, ord, ls, lc, ge, n_pairs, n_lists,
                              pad, rot, cpb, o, s);
}

}  // namespace

// probes [n_pairs] int32 → the grouping of ivf_group.cuh's launch_group,
// in int32 `scratch` of ivfg::group_scratch(n_pairs, n_lists): order
// [n_pairs], list_start, list_count, group_end [n_lists + 1] each, then
// its counts.
extern "C" int ivf_scan_group(const void* probes, long long n_pairs,
                              int n_lists, void* scratch, void* stream) {
  return static_cast<int>(ivfg::launch_group(
      static_cast<const int32_t*>(probes), n_pairs, n_lists,
      static_cast<int32_t*>(scratch), static_cast<cudaStream_t>(stream)));
}

// probes [n_pairs] int32, qres [n_pairs, rot] f32 (the (query, probe) pairs
// in row-major order), list_data [n_lists, pad, rot] of the row type
// `row_type` (ivfg::RowType: f32, bf16, fp16, int8, uint8), row_norms
// [n_lists, pad] f32 → out [n_pairs, pad] f32. `groups`
// is int32 scratch of ivfg::group_scratch(n_pairs, n_lists) for the
// grouping. A block scans chunks_per_block chunks of 64 slots.
extern "C" int ivf_scan(const void* probes, const void* qres,
                        const void* list_data, int row_type,
                        const void* row_norms, void* groups,
                        long long n_pairs, int n_lists, int pad, int rot,
                        int chunks_per_block, void* out, void* stream) {
  const auto* q = static_cast<const float*>(qres);
  const auto* rn = static_cast<const float*>(row_norms);
  auto* ord = static_cast<int32_t*>(groups);
  int32_t* ls = ord + n_pairs;
  int32_t* lc = ls + n_lists + 1;
  int32_t* ge = lc + n_lists + 1;
  auto* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_chunks = (pad + kS - 1) / kS;
  if (n_pairs < 1 || n_pairs > 0x7fffffffLL || rot < 1 || pad < 1 ||
      chunks_per_block < 1 ||
      (n_chunks + chunks_per_block - 1) / chunks_per_block > 65535 ||
      (n_pairs + kG - 1) / kG + n_lists + 1 > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t gerr = ivfg::launch_group(
      static_cast<const int32_t*>(probes), n_pairs, n_lists, ord, s);
  if (gerr != cudaSuccess) return static_cast<int>(gerr);
  const cudaError_t err = ivfg::with_row_type(row_type, [&](auto tag) {
    return dispatch<decltype(tag)>(q, list_data, rn, ord, ls, lc, ge, n_pairs,
                                   n_lists, pad, rot, chunks_per_block, o, s);
  });
  return static_cast<int>(err);
}

extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
