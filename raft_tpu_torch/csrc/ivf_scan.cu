// Unfused IVF probe scan: partial distances of every probed list slot.
//
// Replaces raft_tpu/ops/pallas_kernels.py:ivf_scan (_ivf_scan_kernel): for
// each (query, probe) pair and every slot of the probed list,
//   out[q, p, slot] = row_norms[list, slot] − 2·list_data[list, slot]·qres[q, p]
// with list = probes[q, p], in fp32 over f32 or bf16 list rows; a probe
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
// Design: a first one-block pass orders the (query, probe) pairs by list on
// the device (a stable counting sort, so a list's pairs stay in (query,
// probe) order; invalid probes last, as list n_lists) and gives, per list,
// the start and count of its pairs and the running count of its groups of
// kG pairs. A block of the scan is one work item (list, a run of slot
// chunks, a group of up to kG of the list's pairs): it finds its list by a
// 32-way search over the group counts (the grid is the bound ⌈pairs/kG⌉ +
// n_lists + 1 the host knows, so nothing is read back; blocks past the last
// group exit), stages the group's query vectors, and streams its chunks of
// kS slab rows through two shared-memory buffers by cp.async (16 or 8 bytes
// a copy where the rows allow), the next chunk in flight while the current
// one is multiplied: a register-tiled fp32 FMA product of the kG × kS block
// (4 pairs × 4 slots a thread, four features a shared-memory read, features
// in increasing order: one writer and one order of summation per output, so
// two runs are bitwise equal). A slab is read once per group of the queries
// that probe its list, instead of once per (query, probe).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kG = 32;   // pairs per work item
constexpr int kS = 64;   // slots per chunk
constexpr int kR = 128;  // features staged per step
constexpr int kRS = kR + 4;  // elements a staged row takes: 16-byte (f32) or
                             // 8-byte (bf16) aligned, and conflict-free reads
constexpr int kThreads = 128;

template <typename T>
constexpr size_t scan_smem_bytes() {
  return 2 * static_cast<size_t>(kS) * kRS * sizeof(T) +  // slab buffers
         static_cast<size_t>(kG) * kRS * 4;                // query vectors
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// four consecutive features of a staged row
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(d), "l"(src),
                 "n"(BYTES)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copy features [r0, r0 + rc) of slab rows [0, rows) into buf [kS][kRS],
// V elements a copy: asynchronously when a copy is 4, 8 or 16 bytes, else
// (single bf16 elements) by plain loads. Rows past `rows` are left as they
// are: their products are never written.
template <typename T, int V>
__device__ __forceinline__ void copy_slab(T* buf, const T* slab, int rot,
                                          int rows, int r0, int rc) {
  const int per_row = rc / V;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int i = e / per_row, j = e - i * per_row;
    T* d = buf + i * kRS + j * V;
    const T* src = slab + static_cast<long long>(i) * rot + r0 + j * V;
    if constexpr (V * sizeof(T) >= 4)
      cp_async<static_cast<int>(V * sizeof(T))>(d, src);
    else
      *d = *src;
  }
}

// Stage the query vectors of pairs [0, kG) (zeros past np), features
// [r0, r0 + rc), into qs [kG][kRS] floats, VQ floats a load.
template <int VQ>
__device__ __forceinline__ void stage_queries(float* qs, const float* qres,
                                              const int* pid, int np, int rot,
                                              int r0, int rc) {
  const int per_row = rc / VQ;
  for (int e = threadIdx.x; e < kG * per_row; e += kThreads) {
    const int p = e / per_row, j = e - p * per_row;
    float* d = qs + p * kRS + j * VQ;
    if constexpr (VQ == 4) {
      *reinterpret_cast<float4*>(d) =
          p < np ? *reinterpret_cast<const float4*>(
                       qres + static_cast<long long>(pid[p]) * rot + r0 + j * 4)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      *d = p < np ? qres[static_cast<long long>(pid[p]) * rot + r0 + j] : 0.f;
    }
  }
}

constexpr int kGroupThreads = 1024;
constexpr size_t kGroupSmemCursor = 96 * 1024;  // lists up to 24,575

__device__ __forceinline__ int list_key(int32_t probe, int n_lists) {
  return probe >= 0 && probe < n_lists ? probe : n_lists;
}

// The grouping, in one block: each list's count (integer atomics, exact in
// any order; in shared memory when SMEM_CURSOR, else in device memory),
// their running sums, then the stable placement of the pairs, 1024 at a time: a warp ranks its
// lanes of one list by __match_any_sync, and the 32 warps take their places
// in warp order, so a list's pairs keep their (query, probe) order.
template <bool SMEM_CURSOR>
__global__ void __launch_bounds__(kGroupThreads)
group_kernel(const int32_t* __restrict__ probes, int n_pairs, int n_lists,
             int32_t* __restrict__ order, int32_t* __restrict__ list_start,
             int32_t* __restrict__ list_count, int32_t* __restrict__ group_end,
             int32_t* __restrict__ cursor_mem) {
  __shared__ int part[2][kGroupThreads];
  extern __shared__ int32_t cursor_smem[];  // [n_lists + 1] when SMEM_CURSOR
  int32_t* cursor = SMEM_CURSOR ? cursor_smem : cursor_mem;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nl = n_lists + 1;
  for (int i = tid; i < nl; i += kGroupThreads) cursor[i] = 0;
  __syncthreads();
  for (int i = tid; i < n_pairs; i += kGroupThreads)
    atomicAdd(cursor + list_key(probes[i], n_lists), 1);
  __syncthreads();
  for (int i = tid; i < nl; i += kGroupThreads) list_count[i] = cursor[i];
  __syncthreads();
  // running sums of the counts and of the groups: a thread's run of lists,
  // then an inclusive scan over the threads
  const int per = (nl + kGroupThreads - 1) / kGroupThreads;
  const int lo = tid * per, hi = lo + per < nl ? lo + per : nl;
  int s_pairs = 0, s_groups = 0;
  for (int i = lo; i < hi; ++i) {
    s_pairs += list_count[i];
    s_groups += (list_count[i] + kG - 1) / kG;
  }
  part[0][tid] = s_pairs;
  part[1][tid] = s_groups;
  __syncthreads();
  for (int off = 1; off < kGroupThreads; off <<= 1) {
    const int a = tid >= off ? part[0][tid - off] : 0;
    const int b = tid >= off ? part[1][tid - off] : 0;
    __syncthreads();
    part[0][tid] += a;
    part[1][tid] += b;
    __syncthreads();
  }
  int run_pairs = part[0][tid] - s_pairs, run_groups = part[1][tid] - s_groups;
  for (int i = lo; i < hi; ++i) {
    list_start[i] = cursor[i] = run_pairs;
    run_pairs += list_count[i];
    run_groups += (list_count[i] + kG - 1) / kG;
    group_end[i] = run_groups;
  }
  __syncthreads();
  for (int base = 0; base < n_pairs; base += kGroupThreads) {
    const int i = base + tid;
    const bool valid = i < n_pairs;
    const unsigned active = __ballot_sync(0xffffffffu, valid);
    int key = 0, pos = 0;
    unsigned same = 0;
    if (valid) {
      key = list_key(probes[i], n_lists);
      same = __match_any_sync(active, key);
    }
    for (int w = 0; w < kGroupThreads / 32; ++w) {
      if (warp == w && valid)
        pos = cursor[key] + __popc(same & ((1u << lane) - 1u));
      __syncwarp();
      if (warp == w && valid && lane == __ffs(same) - 1)
        cursor[key] += __popc(same);
      __syncthreads();
    }
    if (valid) order[pos] = i;
  }
}

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

  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {
    // the first list whose running group count passes this block, by a
    // 32-way search over the nondecreasing group_end: the lanes test 32
    // points of [lo, hi) at a time (three rounds for a thousand lists)
    const int b = blockIdx.x;
    int lo = 0, hi = n_lists + 1;
    while (lo < hi) {
      const int step = (hi - lo + 31) / 32;
      const int pt = lo + lane * step;
      const unsigned hit = __ballot_sync(0xffffffffu,
                                         pt < hi && group_end[pt] > b);
      if (hit) {
        const int f = __ffs(hit) - 1;
        hi = lo + f * step;
        lo = f == 0 ? lo : lo + (f - 1) * step + 1;
      } else {
        const unsigned tested = __ballot_sync(0xffffffffu, pt < hi);
        lo += (31 - __clz(tested)) * step + 1;
      }
    }
    if (lane == 0) item[0] = lo;
    if (lane == 0 && lo <= n_lists) {
      const int g = b - (lo > 0 ? group_end[lo - 1] : 0);
      const int left = list_count[lo] - g * kG;
      item[1] = list_start[lo] + g * kG;
      item[2] = left < kG ? left : kG;
    }
  }
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
    copy_slab<T, V>(bufs + (st & 1) * kS * kRS,
                    lslab + static_cast<long long>(c) * kS * rot, rot, rows,
                    r0, rot - r0 < kR ? rot - r0 : kR);
    cp_async_commit();
  };
  if (n_r == 1) stage_queries<VQ>(qs, qres, pid, np, rot, 0, rot);
  float acc[4][4] = {};
  issue(0);
  for (int st = 0; st < steps; ++st) {
    const int c = c_lo + st / n_r, r0 = (st % n_r) * kR;
    const int rc = rot - r0 < kR ? rot - r0 : kR;
    if (st + 1 < steps) {
      issue(st + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (n_r > 1) stage_queries<VQ>(qs, qres, pid, np, rot, r0, rc);
    __syncthreads();
    const T* xs = bufs + (st & 1) * kS * kRS;
    int j = 0;
    for (; busy && j + 4 <= rc; j += 4) {  // four features a read
      float4 a[4], q[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(xs + (tx + 16 * i) * kRS + j);
#pragma unroll
      for (int p = 0; p < 4; ++p)
        q[p] = *reinterpret_cast<const float4*>(qs + (4 * ty + p) * kRS + j);
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[p][i] = fmaf(a[i].x, q[p].x, acc[p][i]);
          acc[p][i] = fmaf(a[i].y, q[p].y, acc[p][i]);
          acc[p][i] = fmaf(a[i].z, q[p].z, acc[p][i]);
          acc[p][i] = fmaf(a[i].w, q[p].w, acc[p][i]);
        }
    }
    for (; busy && j < rc; ++j) {
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[p][i] = fmaf(to_f32(xs[(tx + 16 * i) * kRS + j]),
                           qs[(4 * ty + p) * kRS + j], acc[p][i]);
    }
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
  constexpr size_t smem = scan_smem_bytes<T>();
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
// bf16) when every row starts on such a boundary, else one element
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

// probes [n_pairs] int32 → the grouping, all int32: order [n_pairs] the
// pairs sorted by list, stable (probes outside [0, n_lists) as list
// n_lists); list_start, list_count [n_lists + 1] each list's pairs in
// order; group_end [n_lists + 1] the running count of ⌈list_count / 32⌉;
// cursor [n_lists + 1] scratch.
extern "C" int ivf_scan_group(const void* probes, long long n_pairs,
                              int n_lists, void* order, void* list_start,
                              void* list_count, void* group_end, void* cursor,
                              void* stream) {
  if (n_pairs < 1 || n_pairs > 0x7fffffffLL || n_lists < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const int32_t*>(probes);
  auto* o = static_cast<int32_t*>(order);
  auto* ls = static_cast<int32_t*>(list_start);
  auto* lc = static_cast<int32_t*>(list_count);
  auto* ge = static_cast<int32_t*>(group_end);
  auto* cur = static_cast<int32_t*>(cursor);
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = (static_cast<size_t>(n_lists) + 1) * 4;
  if (smem <= kGroupSmemCursor) {
    const cudaError_t err = cudaFuncSetAttribute(
        group_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kGroupSmemCursor));
    if (err != cudaSuccess) return static_cast<int>(err);
    group_kernel<true><<<1, kGroupThreads, smem, s>>>(
        p, static_cast<int>(n_pairs), n_lists, o, ls, lc, ge, cur);
  } else {
    group_kernel<false><<<1, kGroupThreads, 0, s>>>(
        p, static_cast<int>(n_pairs), n_lists, o, ls, lc, ge, cur);
  }
  return static_cast<int>(cudaGetLastError());
}

// probes [n_pairs] int32, qres [n_pairs, rot] f32 (the (query, probe) pairs
// in row-major order), list_data [n_lists, pad, rot] f32 (data_is_bf16 = 0)
// or bf16, row_norms [n_lists, pad] f32 → out [n_pairs, pad] f32. `groups`
// is int32 scratch of n_pairs + 4·(n_lists + 1) for ivf_scan_group's
// outputs. A block scans chunks_per_block chunks of 64 slots.
extern "C" int ivf_scan(const void* probes, const void* qres,
                        const void* list_data, int data_is_bf16,
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
  const int rc = ivf_scan_group(probes, n_pairs, n_lists, ord, ls, lc, ge,
                                ge + n_lists + 1, stream);
  if (rc != 0) return rc;
  const cudaError_t err =
      data_is_bf16
          ? dispatch<__nv_bfloat16>(q, list_data, rn, ord, ls, lc, ge,
                                    n_pairs, n_lists, pad, rot,
                                    chunks_per_block, o, s)
          : dispatch<float>(q, list_data, rn, ord, ls, lc, ge, n_pairs,
                            n_lists, pad, rot, chunks_per_block, o, s);
  return static_cast<int>(err);
}

extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
