// The IVF scans' grouping of (query, probe) pairs by list, and their slab
// tile, shared by ivf_scan and fused_ivf_topk.
//
// Both kernels compute, for (query, probe) pairs and the slots of the
// probed lists, row_norms − 2·list_data[list, slot]·qres[pair] in fp32 over
// rows of f32, bf16, fp16, int8 or uint8 (RowType; every value of the
// three narrow types is exact in f32, so a narrow list gives bitwise the
// distances of the same list cast to f32). Reading each probed slab once per (query, probe) makes
// the slab reads the whole cost, so both first order the pairs by list on
// the device (launch_group: a stable counting sort in three passes, with no
// read back to the host) and give a block one work item: a list, a group of
// up to kGroupPairs of its pairs and a run of 64-slot chunks. A block finds
// its item by a 32-way search over the running group counts (find_item; the
// grid is the host's bound ⌈pairs/kGroupPairs⌉ + n_lists + 1, and blocks
// past the last group exit). It stages the group's
// query vectors and streams its chunks of kS slab rows through two
// shared-memory buffers by cp.async (copy_slab; four elements a copy, 16,
// 8 or 4 bytes, where the rows allow), the next chunk in flight while the current one is
// multiplied (tile_product: 4 pairs × 4 slots a thread, four features a
// shared-memory read, features in increasing order, so that every output
// has one writer and one order of summation).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace ivfg {

constexpr int kGroupPairs = 32;  // pairs a work item
constexpr int kS = 64;   // slots per chunk
constexpr int kR = 128;  // features staged per step
constexpr int kRS = kR + 4;  // elements a staged row takes: 16-byte (f32),
                             // 8-byte (bf16, fp16) or 4-byte (int8, uint8)
                             // aligned, and conflict-free reads

// the list rows' element type, as the wrappers pass it
// (gpu_kernels.ROW_TYPES)
enum RowType : int { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3, kU8 = 4 };

// f(T{}) for the row type `code`; an unknown code is refused
template <typename F>
cudaError_t with_row_type(int code, F&& f) {
  switch (code) {
    case kF32: return f(float{});
    case kBF16: return f(__nv_bfloat16{});
    case kF16: return f(__half{});
    case kI8: return f(int8_t{});
    case kU8: return f(uint8_t{});
    default: return cudaErrorInvalidValue;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f32(uint8_t v) {
  return static_cast<float>(v);
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
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
}
__device__ __forceinline__ float4 load4(const uint8_t* p) {
  const uchar4 c = *reinterpret_cast<const uchar4*>(p);
  return make_float4(c.x, c.y, c.z, c.w);
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
// V elements a copy, NT threads: asynchronously when a copy is 4, 8 or 16
// bytes (4 is cp.async's smallest), else (single elements of 1 or 2 bytes:
// a row width that is not a multiple of 4) by plain loads. Rows past
// `rows` are left as they are: their products are never used.
template <typename T, int V, int NT>
__device__ __forceinline__ void copy_slab(T* buf, const T* slab, int rot,
                                          int rows, int r0, int rc) {
  const int per_row = rc / V;
  for (int e = threadIdx.x; e < rows * per_row; e += NT) {
    const int i = e / per_row, j = e - i * per_row;
    T* d = buf + i * kRS + j * V;
    const T* src = slab + static_cast<long long>(i) * rot + r0 + j * V;
    if constexpr (V * sizeof(T) >= 4)
      cp_async<static_cast<int>(V * sizeof(T))>(d, src);
    else
      *d = *src;
  }
}

// Stage the query vectors of pairs [0, G) (zeros past np), features
// [r0, r0 + rc), into qs [G][kRS] floats, VQ floats a load, NT threads.
template <int VQ, int G, int NT>
__device__ __forceinline__ void stage_queries(float* qs, const float* qres,
                                              const int* pid, int np, int rot,
                                              int r0, int rc) {
  const int per_row = rc / VQ;
  for (int e = threadIdx.x; e < G * per_row; e += NT) {
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

// acc[p][i] += Σ_j xs[tx + 16i][j]·qs[4·ty + p][j] over the rc staged
// features, in increasing order of j
template <typename T>
__device__ __forceinline__ void tile_product(float (&acc)[4][4], const T* xs,
                                             const float* qs, int tx, int ty,
                                             int rc) {
  int j = 0;
  for (; j + 4 <= rc; j += 4) {  // four features a read
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
  for (; j < rc; ++j) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[p][i] = fmaf(to_f32(xs[(tx + 16 * i) * kRS + j]),
                         qs[(4 * ty + p) * kRS + j], acc[p][i]);
  }
}

// ------------------------------------------------------------ grouping

constexpr int kGroupThreads = 1024;
constexpr int kGroupSegment = 4096;  // pairs a block counts and places
constexpr size_t kGroupSmemCursor = 96 * 1024;  // lists up to 24,575

__device__ __forceinline__ int list_key(int32_t probe, int n_lists) {
  return probe >= 0 && probe < n_lists ? probe : n_lists;
}

// The grouping is a stable counting sort of the pairs by list in three
// passes over segments of kGroupSegment pairs, one block a segment:
//   1. count_kernel: each segment's count of every list (integer atomics,
//      exact in any order; in shared memory where the lists fit, else in the
//      segment's row of `counts`);
//   2. offsets_kernel (one block): each list's count and start, the running
//      count of its groups of kGroupPairs pairs, and each segment's first
//      position in each list (the list's start plus the earlier segments'
//      counts), written over `counts`;
//   3. place_kernel: each segment's pairs placed from those positions, 1024
//      at a time: a warp ranks its lanes of one list by __match_any_sync,
//      and the 32 warps take their places in warp order.
// So a list's pairs keep their (query, probe) order, and the segments run
// on as many SMs as there are segments.
template <bool SMEM>
__global__ void __launch_bounds__(kGroupThreads)
count_kernel(const int32_t* __restrict__ probes, int n_pairs, int n_lists,
             int32_t* __restrict__ counts) {
  extern __shared__ int32_t hist_smem[];  // [n_lists + 1] when SMEM
  const int nl = n_lists + 1;
  int32_t* hist =
      SMEM ? hist_smem : counts + static_cast<long long>(blockIdx.x) * nl;
  for (int i = threadIdx.x; i < nl; i += kGroupThreads) hist[i] = 0;
  __syncthreads();
  const int lo = blockIdx.x * kGroupSegment;
  const int hi = lo + kGroupSegment < n_pairs ? lo + kGroupSegment : n_pairs;
  for (int i = lo + threadIdx.x; i < hi; i += kGroupThreads)
    atomicAdd(hist + list_key(probes[i], n_lists), 1);
  if (SMEM) {
    __syncthreads();
    int32_t* row = counts + static_cast<long long>(blockIdx.x) * nl;
    for (int i = threadIdx.x; i < nl; i += kGroupThreads) row[i] = hist[i];
  }
}

__global__ void __launch_bounds__(kGroupThreads)
offsets_kernel(int n_lists, int segments,
               int32_t* __restrict__ counts, int32_t* __restrict__ list_start,
               int32_t* __restrict__ list_count,
               int32_t* __restrict__ group_end) {
  __shared__ int part[2][kGroupThreads];
  const int tid = threadIdx.x;
  const int nl = n_lists + 1;
  // each list's count, and its segments' offsets within the list
  for (int l = tid; l < nl; l += kGroupThreads) {
    int run = 0;
    for (int b = 0; b < segments; ++b) {
      int32_t* c = counts + static_cast<long long>(b) * nl + l;
      const int here = *c;
      *c = run;
      run += here;
    }
    list_count[l] = run;
  }
  __syncthreads();
  // running sums of the counts and of the groups: a thread's run of lists,
  // then an inclusive scan over the threads
  const int per = (nl + kGroupThreads - 1) / kGroupThreads;
  const int lo = tid * per, hi = lo + per < nl ? lo + per : nl;
  int s_pairs = 0, s_groups = 0;
  for (int i = lo; i < hi; ++i) {
    s_pairs += list_count[i];
    s_groups += (list_count[i] + kGroupPairs - 1) / kGroupPairs;
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
    list_start[i] = run_pairs;
    run_pairs += list_count[i];
    run_groups += (list_count[i] + kGroupPairs - 1) / kGroupPairs;
    group_end[i] = run_groups;
  }
  __syncthreads();
  for (int l = tid; l < nl; l += kGroupThreads) {
    const int start = list_start[l];
    for (int b = 0; b < segments; ++b)
      counts[static_cast<long long>(b) * nl + l] += start;
  }
}

template <bool SMEM>
__global__ void __launch_bounds__(kGroupThreads)
place_kernel(const int32_t* __restrict__ probes, int n_pairs, int n_lists,
             int32_t* __restrict__ counts, int32_t* __restrict__ order) {
  extern __shared__ int32_t cursor_smem[];  // [n_lists + 1] when SMEM
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nl = n_lists + 1;
  int32_t* row = counts + static_cast<long long>(blockIdx.x) * nl;
  int32_t* cursor = SMEM ? cursor_smem : row;
  if (SMEM)
    for (int i = tid; i < nl; i += kGroupThreads) cursor[i] = row[i];
  __syncthreads();
  const int lo = blockIdx.x * kGroupSegment;
  const int hi = lo + kGroupSegment < n_pairs ? lo + kGroupSegment : n_pairs;
  for (int base = lo; base < hi; base += kGroupThreads) {
    const int i = base + tid;
    const bool valid = i < hi;
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

// int32 scratch of the grouping: order [n_pairs], list_start, list_count,
// group_end [n_lists + 1] each, then counts [segments, n_lists + 1]
// (gpu_kernels.ivf_group_scratch)
inline long long group_scratch(long long n_pairs, int n_lists) {
  const long long segments = (n_pairs + kGroupSegment - 1) / kGroupSegment;
  return n_pairs + (3 + segments) * (static_cast<long long>(n_lists) + 1);
}

// probes [n_pairs] int32 → in `scratch` (group_scratch(n_pairs, n_lists)
// int32): order (the pairs sorted by list, stable; probes outside
// [0, n_lists) as list n_lists), list_start and list_count (each list's
// pairs in order), group_end (the running count of
// ⌈list_count / kGroupPairs⌉)
inline cudaError_t launch_group(const int32_t* probes, long long n_pairs,
                                int n_lists, int32_t* scratch,
                                cudaStream_t s) {
  if (n_pairs < 1 || n_pairs > 0x7fffffffLL || n_lists < 1)
    return cudaErrorInvalidValue;
  const int nl = n_lists + 1;
  const int segments =
      static_cast<int>((n_pairs + kGroupSegment - 1) / kGroupSegment);
  int32_t* order = scratch;
  int32_t* list_start = order + n_pairs;
  int32_t* list_count = list_start + nl;
  int32_t* group_end = list_count + nl;
  int32_t* counts = group_end + nl;
  const size_t smem = static_cast<size_t>(nl) * 4;
  const bool in_smem = smem <= kGroupSmemCursor;
  cudaError_t err;
  if (in_smem) {
    err = cudaFuncSetAttribute(count_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kGroupSmemCursor));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(place_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kGroupSmemCursor));
    if (err != cudaSuccess) return err;
    count_kernel<true><<<segments, kGroupThreads, smem, s>>>(
        probes, static_cast<int>(n_pairs), n_lists, counts);
  } else {
    count_kernel<false><<<segments, kGroupThreads, 0, s>>>(
        probes, static_cast<int>(n_pairs), n_lists, counts);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  offsets_kernel<<<1, kGroupThreads, 0, s>>>(n_lists, segments, counts,
                                             list_start, list_count,
                                             group_end);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (in_smem)
    place_kernel<true><<<segments, kGroupThreads, smem, s>>>(
        probes, static_cast<int>(n_pairs), n_lists, counts, order);
  else
    place_kernel<false><<<segments, kGroupThreads, 0, s>>>(
        probes, static_cast<int>(n_pairs), n_lists, counts, order);
  return cudaGetLastError();
}

// Called by the 32 lanes of warp 0: this block's work item, item[0] = its
// list (n_lists for the invalid probes, > n_lists past the last group),
// item[1] its first pair in `order` and item[2] its pairs. The first list
// whose running group count passes the block, by a 32-way search over the
// nondecreasing group_end: the lanes test 32 points of [lo, hi) at a time
// (three rounds for a thousand lists).
__device__ __forceinline__ void find_item(const int32_t* __restrict__ group_end,
                                          const int32_t* __restrict__ list_start,
                                          const int32_t* __restrict__ list_count,
                                          int n_lists, int b,
                                          int* item) {
  const int lane = threadIdx.x & 31;
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
    const int left = list_count[lo] - g * kGroupPairs;
    item[1] = list_start[lo] + g * kGroupPairs;
    item[2] = left < kGroupPairs ? left : kGroupPairs;
  }
}

}  // namespace ivfg
