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
// Design: one warp per row; a warp reads its row once, in coalesced chunks,
// and keeps only the values that beat the k-th entry of its carry. Up to
// k = 32 the carry lives in the warp's registers (one entry a lane; chunks
// of 32·V values with the next chunk's loads in flight; a few survivors
// inserted by ballot and shuffle, more sorted by a bitonic network and
// merged), above it in shared memory (chunks of 128, warp_merge), both in
// topk_carry.cuh. There is no [b, n] sort and nothing but the [b, k] result
// is written to device memory.
#include "topk_carry.cuh"

// `v`: 0 takes the launcher's own choice (select_reg_v), 1/2/4/8 the
// register route with that many values a lane a chunk, -1 the shared-memory
// route; `passes`: 0 the launcher's choice (select_reg_two_pass), 1 or 2
// passes over the row on the register route (gpu_kernels.plan_select_k names
// the choices; other values are for timing the alternatives).
extern "C" int select_k_rows(const void* vals, const void* in_ids, long long b,
                             long long n, int k, int negate, int v,
                             int passes, void* out_v, void* out_i,
                             void* stream) {
  return static_cast<int>(rtt::launch_select_rows(
      static_cast<const float*>(vals), static_cast<const int32_t*>(in_ids), b,
      n, k, negate, static_cast<float*>(out_v), static_cast<int32_t*>(out_i),
      static_cast<cudaStream_t>(stream), v, passes));
}

// The plan launch_select_rows picks for a row of n at this k: the values a
// lane loads a chunk times 4, plus the passes over the row; 0 where it takes
// the shared-memory route.
extern "C" int select_k_route(long long n, int k) {
  if (!rtt::select_reg_route(n, k)) return 0;
  return 4 * rtt::select_reg_v(n) + (rtt::select_reg_two_pass(n) ? 2 : 1);
}
