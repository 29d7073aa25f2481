// Fused squared-L2 distance + 1-NN (min and argmin over y) for every x row.
//
// Replaces raft_tpu/ops/pallas_kernels.py:fused_l2_argmin
// (_fused_l2_argmin_kernel): an fp32-accurate (Precision.HIGHEST) x·yᵀ tile,
// d = ‖x‖² + ‖y‖² − 2·x·y, reduced at once into a running (min, argmin) per
// x row, so the [m, n] distance matrix never exists in device memory. It is
// the E-step of Lloyd k-means (the reference's minClusterAndDistanceCompute)
// and the body of fused_l2_nn_argmin. With `clamp`, d is max(d, 0) before the
// comparison, as the E-step's l2_expanded clamps: rows at distance ~0 from
// several centres then tie at 0 and take the lowest index, instead of letting
// the sign of the rounding noise decide.
//
// Bound on the H100: the product, 2·m·n·d operations, here as three TF32
// passes on the tensor cores (tc_tile.cuh's 3×TF32 split, shared with
// fused_l2_topk: fp32-accurate, as HIGHEST is): 3·2·m·n·d / 495e12 s, 1.63 ms
// for the k-means E-step of 1M rows against 1024 centres at d = 128, against
// 3.91 ms for the same products as fp32 FMA outside the tensor cores.
//
// Design: y, the small side (the centres), is split once into hi/lo planes
// in the wrapper's scratch; one producer warp streams its 128-row × 32-float
// slices by TMA through a ring of shared-memory stages; a block owns 128 x
// rows, two consumer warpgroups of 64, each issuing three wgmma.m64n128k8
// per k-step and holding its 64 × 128 distance tile in registers.
//   - Route "resident" (d zero-padded to d_pad <= 160, where the block's x
//     planes fit beside a two-stage ring: gpu_kernels.plan_fused_argmin): the
//     consumers read their rows once from device memory, split them in
//     registers and write both planes into shared memory in the swizzled
//     layout wgmma reads. They stay there while every y tile streams past, so
//     x is read once and no x plane is written to device memory (the planes
//     of 1M × 128 rows would be 1 GB written and read again on every E-step).
//   - Route "scratch" (larger d): x is split into scratch planes too, in row
//     chunks within the scratch budget, and its slices stream with y's
//     through the ring, as fused_l2_topk does.
// Epilogue in registers: the tile's y norms loaded before its products,
// then the norms, the clamp, and a running (min, argmin) per row. A
// thread's columns ascend (column 8c + 2·(lane%4) + e of tile t): a tree
// over its 32 columns that keeps the left of equals gives the tile's first
// minimum, and a strict < against the running one keeps the first over the
// tiles; the four lanes that share a row then reduce by (value, index), so
// ties go to the lowest y index whatever lane saw them. Rows past n are
// zeros from TMA and never candidates.
#include "smem_budget.h"
#include "tc_tile.cuh"

namespace {

using tct::kBK;
using tct::kBN;
using tct::kSliceB;
using tct::smem_u32;

constexpr int kWGS = 2;                 // consumer warpgroups
constexpr int kBM = 64 * kWGS;          // x rows per block
constexpr int kSliceA = kBM * kBK * 4;  // bytes of one A plane slice
constexpr int kThreads = 128 * kWGS + 32;

// a ring stage: y's hi and lo slices, and x's before them in the scratch
// route
__host__ __device__ constexpr int stage_bytes(bool resident) {
  return (resident ? 0 : 2 * kSliceA) + 2 * kSliceB;
}

// the layout rtt_smem::l2_argmin_smem_bytes counts
static_assert(kBK == rtt_smem::kTcBK && kBM == 128 && kBN == 128 &&
                  stage_bytes(true) == 2 * 128 * rtt_smem::kTcBK * 4 &&
                  stage_bytes(false) == 4 * 128 * rtt_smem::kTcBK * 4,
              "smem_budget.h describes another tile");

// (v, i) precedes (bv, bi): smaller value, or the same value at a lower
// index; entries with index < 0 hold no candidate
__device__ __forceinline__ bool precedes(float v, int32_t i, float bv,
                                         int32_t bi) {
  if (i < 0) return false;
  if (bi < 0) return true;
  return v < bv || (v == bv && i < bi);
}

struct ArgminArgs {
  const float* x;  // [m, d]: the resident route reads it
  const float* xn;  // [m]
  const float* yn;  // [n]
  int m;
  long long n;
  int d;
  int k_slices;  // d_pad / kBK
  int stages;
  int clamp;
  int vec4;  // x rows start on 16-byte boundaries (d % 4 == 0)
  float* out_v;  // [m]
  int32_t* out_i;
};

// Write the warpgroup's 64 rows of x (rows of the launch from row0),
// zero-padded to k_slices·32 features, as hi/lo planes into the resident
// area: slice kc of plane h at xres + (2·kc + h)·kSliceA, warpgroup g's rows
// 8 KB into it, each row in the 128-byte-swizzled layout.
__device__ __forceinline__ void stage_x(unsigned char* xres, const ArgminArgs& a,
                                        int row0, int g) {
  const int t = threadIdx.x & 127;
  const int dp = a.k_slices * kBK;
  unsigned char* wg = xres + g * (64 * kBK * 4);
  if (a.vec4) {
    const int per_row = dp / 4;
    for (int e = t; e < 64 * per_row; e += 128) {
      const int r = e / per_row, c = (e - r * per_row) * 4;
      const int row = row0 + 64 * g + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < a.m && c < a.d)
        v = *reinterpret_cast<const float4*>(
            a.x + static_cast<long long>(row) * a.d + c);
      float4 h, l;
      h.x = tct::tf32_rna(v.x);
      h.y = tct::tf32_rna(v.y);
      h.z = tct::tf32_rna(v.z);
      h.w = tct::tf32_rna(v.w);
      l.x = tct::tf32_rna(v.x - h.x);
      l.y = tct::tf32_rna(v.y - h.y);
      l.z = tct::tf32_rna(v.z - h.z);
      l.w = tct::tf32_rna(v.w - h.w);
      unsigned char* p = wg + (c / kBK) * 2 * kSliceA +
                         tct::swizzled_offset(r, c % kBK);
      *reinterpret_cast<float4*>(p) = h;
      *reinterpret_cast<float4*>(p + kSliceA) = l;
    }
  } else {
    for (int e = t; e < 64 * dp; e += 128) {
      const int r = e / dp, c = e - r * dp;
      const int row = row0 + 64 * g + r;
      const float v = row < a.m && c < a.d
                          ? a.x[static_cast<long long>(row) * a.d + c]
                          : 0.f;
      const float h = tct::tf32_rna(v);
      unsigned char* p = wg + (c / kBK) * 2 * kSliceA +
                         tct::swizzled_offset(r, c % kBK);
      *reinterpret_cast<float*>(p) = h;
      *reinterpret_cast<float*>(p + kSliceA) = tct::tf32_rna(v - h);
    }
  }
  // the planes were written by this warpgroup's threads and are read by
  // its wgmma (the async proxy): fence, then the warpgroup's barrier
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");
}

// The first minimum (v, j) over the thread's 32 columns j of one row of
// the distances (xn + ynr[j]) − 2·acc[4·(j/2) + off + j%2] (off 0: the
// lane's first row, 2: its second), clamped at 0 if asked; columns not in
// `valid` hold +inf. Column j lies left of column j + 1, and a tree that
// keeps the left of two equal values gives the first minimum in five steps
// instead of a chain of 32 comparisons.
__device__ __forceinline__ void first_min(const float* acc, const float* ynr,
                                          uint32_t valid, float xn, int off,
                                          int clamp, float& v_out,
                                          int& j_out) {
  float v[kBN / 4];
  int ix[kBN / 4];
#pragma unroll
  for (int j = 0; j < kBN / 4; ++j) {
    // (xn + yn) − 2·dot rounded once, as fl(fl(xn + yn) − 2·dot): 2·dot is
    // exact
    float d = __fmaf_rn(-2.f, acc[4 * (j >> 1) + off + (j & 1)],
                        __fadd_rn(xn, ynr[j]));
    if (clamp) d = fmaxf(d, 0.f);
    v[j] = (valid >> j) & 1u ? d : __int_as_float(0x7f800000);
    ix[j] = j;
  }
#pragma unroll
  for (int w = 1; w < kBN / 4; w <<= 1)
#pragma unroll
    for (int j = 0; j < kBN / 4; j += 2 * w)
      if (v[j + w] < v[j]) {
        v[j] = v[j + w];
        ix[j] = ix[j + w];
      }
  v_out = v[0];
  j_out = ix[0];
}

template <bool RESIDENT>
__global__ void __launch_bounds__(kThreads)
tc_argmin_kernel(const __grid_constant__ CUtensorMap map_xh,
                 const __grid_constant__ CUtensorMap map_xl,
                 const __grid_constant__ CUtensorMap map_yh,
                 const __grid_constant__ CUtensorMap map_yl,
                 const ArgminArgs a) {
  constexpr int kStage = stage_bytes(RESIDENT);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stages = a.stages;
  unsigned char* xres = smem + stages * kStage;  // the resident x planes
  uint64_t* full = reinterpret_cast<uint64_t*>(
      xres + (RESIDENT ? a.k_slices * 2 * kSliceA : 0));
  uint64_t* empty = full + stages;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kBM;
  const int n_tiles = static_cast<int>((a.n + kBN - 1) / kBN);
  const int iters = n_tiles * a.k_slices;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      tct::mbar_init(smem_u32(full + s), 1);
      tct::mbar_init(smem_u32(empty + s), 128 * kWGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kWGS) {  // ---- producer: one thread keeps the ring filled
    if (lane == 0) {
      for (int it = 0; it < iters; ++it) {
        const int s = it % stages;
        tct::mbar_wait(smem_u32(empty + s), ((it / stages) & 1) ^ 1);
        const uint32_t bar = smem_u32(full + s);
        tct::mbar_expect_tx(bar, kStage);
        const uint32_t st = smem_u32(smem + s * kStage);
        const int kc = (it % a.k_slices) * kBK;
        const int col = (it / a.k_slices) * kBN;
        uint32_t b = st;
        if (!RESIDENT) {
          tct::tma_load(st, &map_xh, kc, row0, bar);
          tct::tma_load(st + kSliceA, &map_xl, kc, row0, bar);
          b += 2 * kSliceA;
        }
        tct::tma_load(b, &map_yh, kc, col, bar);
        tct::tma_load(b + kSliceB, &map_yl, kc, col, bar);
      }
    }
    return;
  }

  // ---- consumers: warpgroup g multiplies local rows 64g..64g+63; a lane
  // holds rows ra = 16·warp + lane/4 and ra + 8, columns 8c + 2·(lane%4) +
  // {0, 1} of each tile
  const int g = warp >> 2;
  if (RESIDENT) stage_x(xres, a, row0, g);
  const int ra = 16 * warp + (lane >> 2), rb = ra + 8;
  const int q = lane & 3;
  const bool va = row0 + ra < a.m, vb = row0 + rb < a.m;
  const float xna = va ? a.xn[row0 + ra] : 0.f;
  const float xnb = vb ? a.xn[row0 + rb] : 0.f;
  float best_a = __int_as_float(0x7f800000), best_b = best_a;  // +inf
  int32_t ia = -1, ib = -1;
  const uint32_t xres_u = smem_u32(xres) + g * (64 * kBK * 4);

  float acc[64];
  for (int t = 0; t < n_tiles; ++t) {
    // the tile's column norms, loaded before its products so that the loads
    // overlap them; column j of the thread is 8·(j/2) + 2·(lane%4) + j%2
    const long long col0 = static_cast<long long>(t) * kBN;
    float ynr[kBN / 4];
    uint32_t valid = 0;
#pragma unroll
    for (int j = 0; j < kBN / 4; ++j) {
      const long long col = col0 + 8 * (j >> 1) + 2 * q + (j & 1);
      ynr[j] = col < a.n ? __ldg(a.yn + col) : 0.f;
      valid |= (col < a.n ? 1u : 0u) << j;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    tct::fence_operands(acc);
    tct::ring_tile(acc, t * a.k_slices, a.k_slices, stages, smem, kStage,
                   RESIDENT ? 0 : 2 * kSliceA, kSliceA, full, empty,
                   [&](uint32_t st, int kc) {
                     return RESIDENT ? xres_u + kc * 2 * kSliceA
                                     : st + g * (64 * kBK * 4);
                   });
    // each row's first minimum over the thread's 32 columns, then against
    // the running one, whose columns all lie to the left
    float v;
    int j;
    first_min(acc, ynr, valid, xna, 0, a.clamp, v, j);
    long long col = col0 + 8 * (j >> 1) + 2 * q + (j & 1);
    if (((valid >> j) & 1u) && (ia < 0 || v < best_a)) {
      best_a = v;
      ia = static_cast<int32_t>(col);
    }
    first_min(acc, ynr, valid, xnb, 2, a.clamp, v, j);
    col = col0 + 8 * (j >> 1) + 2 * q + (j & 1);
    if (((valid >> j) & 1u) && (ib < 0 || v < best_b)) {
      best_b = v;
      ib = static_cast<int32_t>(col);
    }
  }

  // the four lanes of a row are lanes 4·(lane/4) .. + 3
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    const float ova = __shfl_xor_sync(0xffffffffu, best_a, o);
    const int32_t oia = __shfl_xor_sync(0xffffffffu, ia, o);
    const float ovb = __shfl_xor_sync(0xffffffffu, best_b, o);
    const int32_t oib = __shfl_xor_sync(0xffffffffu, ib, o);
    if (precedes(ova, oia, best_a, ia)) {
      best_a = ova;
      ia = oia;
    }
    if (precedes(ovb, oib, best_b, ib)) {
      best_b = ovb;
      ib = oib;
    }
  }
  if (q == 0 && va) {
    a.out_v[row0 + ra] = best_a;
    a.out_i[row0 + ra] = ia;
  }
  if (q == 0 && vb) {
    a.out_v[row0 + rb] = best_b;
    a.out_i[row0 + rb] = ib;
  }
}

template <bool RESIDENT>
cudaError_t run(const float* x, const float* y, const float* xn,
                const float* yn, int m, long long n, int d, int d_pad,
                int stages, int x_chunk, int clamp, float* scratch,
                float* out_v, int32_t* out_i, cudaStream_t s) {
  ArgminArgs a;
  a.x = x;
  a.yn = yn;
  a.n = n;
  a.d = d;
  a.k_slices = d_pad / kBK;
  a.stages = stages;
  a.clamp = clamp;
  a.vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const size_t smem =
      rtt_smem::l2_argmin_smem_bytes(RESIDENT, a.k_slices * kBK, stages);
  cudaError_t err = cudaFuncSetAttribute(
      tc_argmin_kernel<RESIDENT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  float* yh = scratch;
  float* yl = yh + n * d_pad;
  err = tct::launch_split(y, n, d, d_pad, yh, yl, s);
  if (err != cudaSuccess) return err;
  CUtensorMap myh, myl, mxh, mxl;
  if (!tct::make_map(&myh, yh, n, d_pad, kBN) ||
      !tct::make_map(&myl, yl, n, d_pad, kBN))
    return cudaErrorInvalidValue;
  // the resident route reads no x plane: y's maps stand in for them
  mxh = myh;
  mxl = myl;
  float* xh = yl + n * d_pad;
  float* xl = xh + static_cast<long long>(x_chunk) * d_pad;
  for (int r0 = 0; r0 < m; r0 += x_chunk) {
    const int rows = m - r0 < x_chunk ? m - r0 : x_chunk;
    if (!RESIDENT) {
      err = tct::launch_split(x + static_cast<long long>(r0) * d, rows, d,
                              d_pad, xh, xl, s);
      if (err != cudaSuccess) return err;
      if (!tct::make_map(&mxh, xh, rows, d_pad, kBM) ||
          !tct::make_map(&mxl, xl, rows, d_pad, kBM))
        return cudaErrorInvalidValue;
    }
    a.x = x + static_cast<long long>(r0) * d;
    a.xn = xn + r0;
    a.m = rows;
    a.out_v = out_v + r0;
    a.out_i = out_i + r0;
    tc_argmin_kernel<RESIDENT><<<(rows + kBM - 1) / kBM, kThreads, smem, s>>>(
        mxh, mxl, myh, myl, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// x [m, d], y [n, d], xn [m], yn [n] float32, n >= 1 → out_v/out_i [m].
// resident = 1: x read into shared memory (d_pad <= 160), `scratch` the
// hi/lo planes of y, [2·n, d_pad] floats; resident = 0: x split in chunks
// of x_chunk rows, `scratch` [2·n + 2·x_chunk, d_pad] floats. d_pad is d
// rounded up to a multiple of 32; `stages` of the ring.
extern "C" int fused_l2_argmin(const void* x, const void* y, const void* xn,
                               const void* yn, int m, long long n, int d,
                               int clamp, int resident, int d_pad, int stages,
                               int x_chunk, void* scratch, void* out_v,
                               void* out_i, void* stream) {
  if (m < 1 || n < 1 || d < 1 || d_pad < d || d_pad % kBK != 0 ||
      stages < 2 || x_chunk < 1 || scratch == nullptr ||
      n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  const auto* xnf = static_cast<const float*>(xn);
  const auto* ynf = static_cast<const float*>(yn);
  auto* sc = static_cast<float*>(scratch);
  auto* ov = static_cast<float*>(out_v);
  auto* oi = static_cast<int32_t*>(out_i);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      resident ? run<true>(xf, yf, xnf, ynf, m, n, d, d_pad, stages, m, clamp,
                           sc, ov, oi, s)
               : run<false>(xf, yf, xnf, ynf, m, n, d, d_pad, stages, x_chunk,
                            clamp, sc, ov, oi, s);
  return static_cast<int>(err);
}

extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
