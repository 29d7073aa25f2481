// Streaming top-k selection over the rows of a [b, n] float32 matrix.
//
// Replaces raft_tpu/ops/pallas_kernels.py:pallas_select_k (_topk_kernel):
// per tile, k rounds of min/argmin merged into a VMEM carry; ascending,
// negated for the largest values; +inf yields id -1.
//
// Bound on the H100: reading the input. Each value is read once and compared
// once with the row's current k-th value; the work per value is a handful of
// instructions, far below the ~20 operations per byte at which the card's
// arithmetic would become the limit.
//
// Design: one warp per row, eight rows per block. A warp reads its row in
// coalesced chunks of 128 values, keeps only the values that beat the k-th
// entry of its carry, and merges those through the shared carry of
// topk_carry.cuh. There is no [b, n] sort and nothing but the [b, k] result
// is written to device memory.
#include "topk_carry.cuh"

extern "C" int select_k_rows(const void* vals, const void* in_ids, long long b,
                             long long n, int k, int negate, void* out_v,
                             void* out_i, void* stream) {
  return static_cast<int>(rtt::launch_select_rows(
      static_cast<const float*>(vals), static_cast<const int32_t*>(in_ids), b,
      n, k, negate, static_cast<float*>(out_v), static_cast<int32_t*>(out_i),
      static_cast<cudaStream_t>(stream)));
}
