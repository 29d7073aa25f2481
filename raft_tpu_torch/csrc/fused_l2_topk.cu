// Fused squared-L2 distance + top-k for exact (brute-force) search.
//
// Replaces raft_tpu/ops/pallas_kernels.py:fused_l2_topk (_fused_topk_kernel):
// an fp32-accurate (Precision.HIGHEST) x·yᵀ tile, d = max(‖x‖² + ‖y‖² −
// 2·x·y, 0), merged into a running top-k carry, so the [m, n] distance matrix
// never exists in device memory. Rows past n are never candidates; ids are
// global row ids, -1 where fewer than k rows exist; ties resolve by row id.
//
// Bound on the H100: the product, 2·m·n·d operations. HIGHEST is
// fp32-accurate; on the TPU it is made of bf16 passes, here of three TF32
// passes on the tensor cores (the 3×TF32 split): a = a_hi + a_lo with
// a_hi = rna_tf32(a), a_lo = rna_tf32(a − a_hi), and x·y ≈ x_hi·y_hi +
// x_hi·y_lo + x_lo·y_hi accumulated in fp32 (error about 2⁻²¹ of Σ|x_i·y_i|,
// the order of fp32's own; one TF32 pass would be 2⁻¹¹). Three passes at
// 495 TFLOP/s bound it at 3·2·m·n·d / 495e12 s, against 2·m·n·d / 67e12 s
// for fp32 FMA outside the tensor cores.
//
// Design (k <= gpu_kernels.TC_MAX_K, the tensor-core route; the split, the
// tensor maps, the ring and the three passes are tc_tile.cuh's, shared with
// fused_l2_argmin):
//   - a split pass writes x and y as hi/lo planes into the wrapper's scratch,
//     d zero-padded to a multiple of 32 (zeros change no dot product), so
//     that each 32-float slice is one 128-byte TMA row and four wgmma k-steps;
//     the database is split in chunks that fit the scratch budget;
//   - a block owns 128 query rows (64 where k is too large for their carry)
//     and a range of database rows: one producer warp streams 128 × 32 query
//     and 128 × 32 database slices (hi and lo) by TMA into a ring of
//     shared-memory stages (128-byte swizzle, mbarriers); each of two
//     consumer warpgroups issues three wgmma m64n128k8 per k-step for its 64
//     rows and holds its 64 × 128 distance tile in registers, so a database
//     slice read from L2 serves 128 query rows;
//   - epilogue in registers: norms, clamp, and a comparison with the row's
//     k-th value before anything touches shared memory; one vote of the warp
//     skips a tile without candidates. The few survivors are compacted by
//     warp ballot into a 16-entry buffer per row, merged into the row's
//     sorted carry when more than 8 are pending and at the end of every tile,
//     so the next tile's thresholds are exact (topk_carry.cuh: warp_insert
//     for up to 4, warp_merge for more). A survivor is ordered by (value,
//     row), so the arrival order never changes the result;
//   - the planner (gpu_kernels.plan_fused_topk) cuts the database into ranges
//     so that the (query tile, range) blocks fill whole waves of the card; a
//     select_rows pass merges the ranges in database order, so ties still
//     resolve by global row id.
// Above gpu_kernels.TC_MAX_K (243) even a 64-row carry no longer fits shared
// memory beside the ring, and a 16-row fp32 FMA tile takes over (the large-k
// route, fma_topk_kernel).
#include "tc_tile.cuh"
#include "topk_carry.cuh"

namespace {

// ------------------------------------------------------------ common

struct TileIds {
  long long base;
  __device__ int32_t operator()(uint32_t pos) const {
    return static_cast<int32_t>(base + pos);
  }
};

__device__ __forceinline__ float l2_dist(float xn, float yn, float dot) {
  return fmaxf(__fsub_rn(__fadd_rn(xn, yn), __fmul_rn(2.f, dot)), 0.f);
}

// ------------------------------------------------- tensor-core route

using tct::kBK;
using tct::kBN;
using tct::kSliceB;
using tct::smem_u32;

// WGS consumer warpgroups of 64 query rows each share a block's database
// tiles: 2 where the 128 rows' carry fits beside the ring, else 1
constexpr int kSurv = 16;  // survivor slots per row
__host__ __device__ constexpr int slice_a(int wgs) {
  return 64 * wgs * kBK * 4;
}
__host__ __device__ constexpr int stage_bytes(int wgs) {
  return 2 * slice_a(wgs) + 2 * kSliceB;
}

// the formula of gpu_kernels.l2_topk_tc_smem_bytes
size_t tc_smem_bytes(int k, int stages, int wgs) {
  const size_t bm = 64 * wgs;
  return 1024 +                                              // alignment
         static_cast<size_t>(stages) * stage_bytes(wgs) +    // the ring
         static_cast<size_t>(stages) * 16 +                  // barriers
         bm * k * 8 +                                        // carry
         bm * kSurv * 8 +                                    // survivors
         bm * 4;                                             // their counts
}

struct TcArgs {
  const float* xn;   // [m]
  const float* yn;   // this chunk's norms, [chunk_rows]
  int m;
  long long chunk_rows;
  long long id_base;    // global id of the chunk's first row
  long long split_len;  // database rows per block (a multiple of kBN)
  int q_tiles;
  int k_slices;         // d_pad / kBK
  int k;
  int stages;
  int parts;            // ranges over the whole database
  int part_base;        // this chunk's first range
  float* out_v;         // [m, parts, k]
  int32_t* out_i;
};

// Merge the pending survivors of the warp's rows r0 + g (bit 4g of f) and
// r0 + g + 8 (bit 4g + 1) into their carries. Out of line: the epilogue
// calls it from every column pair, and a copy in each would crowd the
// instruction cache.
__device__ __noinline__ void merge_rows(unsigned f, int r0, uint32_t* cval,
                                        int32_t* cid, int k,
                                        unsigned long long* skey, int* scount,
                                        TileIds ids) {
  const int lane = threadIdx.x & 31;
  for (; f; f &= f - 1) {
    const int bit = __ffs(f) - 1;
    const int r = r0 + (bit >> 2) + 8 * (bit & 1);
    const int n = scount[r];
    if (n <= 4) {  // the common case: a few inserts beat a sort and a merge
      for (int i = 0; i < n; ++i) {
        const unsigned long long sk = skey[r * kSurv + i];
        rtt::warp_insert(cval + r * k, cid + r * k, k,
                         static_cast<uint32_t>(sk >> 32),
                         ids(static_cast<uint32_t>(sk)));
      }
    } else {
      rtt::warp_merge(cval + r * k, cid + r * k, k, skey + r * kSurv, n, ids);
    }
    __syncwarp();
    if (lane == 0) scount[r] = 0;
    __syncwarp();
  }
}

template <int WGS>
__global__ void __launch_bounds__(128 * WGS + 32)
tc_topk_kernel(const __grid_constant__ CUtensorMap map_xh,
               const __grid_constant__ CUtensorMap map_xl,
               const __grid_constant__ CUtensorMap map_yh,
               const __grid_constant__ CUtensorMap map_yl, const TcArgs a) {
  constexpr int kBM = 64 * WGS, kSliceA = slice_a(WGS);
  constexpr int kStageBytes = stage_bytes(WGS);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stages = a.stages, k = a.k;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * kStageBytes);
  uint64_t* empty = full + stages;
  uint32_t* cval = reinterpret_cast<uint32_t*>(empty + stages);  // [kBM][k]
  int32_t* cid = reinterpret_cast<int32_t*>(cval + kBM * k);     // [kBM][k]
  unsigned long long* skey =
      reinterpret_cast<unsigned long long*>(cid + kBM * k);      // [kBM][kSurv]
  int* scount = reinterpret_cast<int*>(skey + kBM * kSurv);      // [kBM]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x / a.q_tiles;
  const int row0 = (blockIdx.x % a.q_tiles) * kBM;
  const long long lo = split * a.split_len;
  const long long hi =
      lo + a.split_len < a.chunk_rows ? lo + a.split_len : a.chunk_rows;
  const int n_tiles = hi > lo ? static_cast<int>((hi - lo + kBN - 1) / kBN) : 0;
  const int iters = n_tiles * a.k_slices;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      tct::mbar_init(smem_u32(full + s), 1);
      tct::mbar_init(smem_u32(empty + s), 128 * WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WGS) {  // ---- producer: one thread keeps the ring filled
    if (lane == 0) {
      for (int it = 0; it < iters; ++it) {
        const int s = it % stages;
        tct::mbar_wait(smem_u32(empty + s), ((it / stages) & 1) ^ 1);
        const uint32_t bar = smem_u32(full + s);
        tct::mbar_expect_tx(bar, kStageBytes);
        const uint32_t st = smem_u32(smem + s * kStageBytes);
        const int kc = (it % a.k_slices) * kBK;
        const int col = static_cast<int>(lo + (it / a.k_slices) * kBN);
        tct::tma_load(st, &map_xh, kc, row0, bar);
        tct::tma_load(st + kSliceA, &map_xl, kc, row0, bar);
        tct::tma_load(st + 2 * kSliceA, &map_yh, kc, col, bar);
        tct::tma_load(st + 2 * kSliceA + kSliceB, &map_yl, kc, col, bar);
      }
    }
    return;
  }

  // ---- consumers: warpgroup g multiplies local rows 64g..64g+63; warp w
  // owns local rows 16w..16w+15; a lane holds rows ra = 16w + lane/4 and
  // ra + 8, columns 8c + 2·(lane%4) + {0, 1}
  const int ra = 16 * warp + (lane >> 2), rb = ra + 8;
  for (int i = lane; i < 16 * k; i += 32) {
    cval[16 * warp * k + i] = rtt::kInfKey;
    cid[16 * warp * k + i] = -1;
  }
  if (lane < 16) scount[16 * warp + lane] = 0;
  __syncwarp();
  const bool va = row0 + ra < a.m, vb = row0 + rb < a.m;
  const float xna = va ? a.xn[row0 + ra] : 0.f;
  const float xnb = vb ? a.xn[row0 + rb] : 0.f;
  const int g4 = lane & ~3, q = lane & 3;
  const unsigned below = (1u << q) - 1u;
  const TileIds ids{a.id_base};
  uint32_t thra = 0, thrb = 0;
  // merge into their carries the rows of this warp with more than `pending`
  // survivors waiting, then read the lanes' thresholds again
  auto flush = [&](int pending) {
    const unsigned fa =
        __ballot_sync(0xffffffffu, q == 0 && scount[ra] > pending);
    const unsigned fb =
        __ballot_sync(0xffffffffu, q == 0 && scount[rb] > pending);
    if (fa | fb) {
      merge_rows(fa | (fb << 1), 16 * warp, cval, cid, k, skey, scount, ids);
      thra = cval[ra * k + k - 1];
      thrb = cval[rb * k + k - 1];
    }
  };

  float acc[64];
  for (int t = 0; t < n_tiles; ++t) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    tct::fence_operands(acc);
    tct::ring_tile(acc, t * a.k_slices, a.k_slices, stages, smem, kStageBytes,
                   2 * kSliceA, kSliceA, full, empty,
                   [warp](uint32_t st, int) {
                     return st + (warp >> 2) * (64 * kBK * 4);
                   });

    // epilogue: 16 column pairs, two rows each; survivors of a pair go to
    // the rows' buffers, a row with more than 8 pending is merged, and every
    // pending survivor is merged at the end of the tile
    const long long col0 = lo + static_cast<long long>(t) * kBN;
    thra = cval[ra * k + k - 1];
    thrb = cval[rb * k + k - 1];
    float ynr[kBN / 4];  // the tile's norms, all loads in flight at once
#pragma unroll
    for (int c = 0; c < kBN / 8; ++c)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const long long col = col0 + 8 * c + 2 * q + e;
        ynr[2 * c + e] = col < hi ? __ldg(a.yn + col) : 0.f;
      }
    // the column pairs c where some lane of the warp has a survivor: a
    // distance below its row's k-th value, compared as floats (they are
    // clamped at 0 and never NaN, so this is the key comparison); once the
    // carries are warm this is no pair, and one vote skips the rest
    unsigned cmask = 0;
    {
      const float tfa = rtt::key_float(thra), tfb = rtt::key_float(thrb);
#pragma unroll
      for (int c = 0; c < kBN / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = col0 + 8 * c + 2 * q + e < hi;
          if ((ok && va &&
               l2_dist(xna, ynr[2 * c + e], acc[4 * c + e]) < tfa) ||
              (ok && vb &&
               l2_dist(xnb, ynr[2 * c + e], acc[4 * c + 2 + e]) < tfb))
            cmask |= 1u << c;
        }
    }
    cmask = __reduce_or_sync(0xffffffffu, cmask);
    // those pairs, in a loop that is not unrolled (a copy of its body per
    // pair would crowd the instruction cache): the pair's four products are
    // picked out of the accumulator by compile-time selects
    for (; cmask; cmask &= cmask - 1) {
      const int c = __ffs(cmask) - 1;
      float d4[4];
#pragma unroll
      for (int cc = 0; cc < kBN / 8; ++cc)
        if (cc == c)
#pragma unroll
          for (int i = 0; i < 4; ++i) d4[i] = acc[4 * cc + i];
      const long long col = col0 + 8 * c + 2 * q;
      bool fa[2], fb[2];
      uint32_t ka[2], kb[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = col + e < hi;
        const float ynv = ok ? __ldg(a.yn + col + e) : 0.f;
        ka[e] = rtt::float_key(l2_dist(xna, ynv, d4[e]));
        kb[e] = rtt::float_key(l2_dist(xnb, ynv, d4[2 + e]));
        fa[e] = ok && va && ka[e] < thra;
        fb[e] = ok && vb && kb[e] < thrb;
      }
      const unsigned ma0 = __ballot_sync(0xffffffffu, fa[0]);
      const unsigned ma1 = __ballot_sync(0xffffffffu, fa[1]);
      const unsigned mb0 = __ballot_sync(0xffffffffu, fb[0]);
      const unsigned mb1 = __ballot_sync(0xffffffffu, fb[1]);
      // each row's 4 lanes: slots in (lane, column) order after the pending
      const unsigned ga0 = (ma0 >> g4) & 15u, ga1 = (ma1 >> g4) & 15u;
      const unsigned gb0 = (mb0 >> g4) & 15u, gb1 = (mb1 >> g4) & 15u;
      const int na = scount[ra], nb = scount[rb];
      int pa = na + __popc(ga0 & below) + __popc(ga1 & below);
      int pb = nb + __popc(gb0 & below) + __popc(gb1 & below);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t pos = static_cast<uint32_t>(col + e);
        if (fa[e]) skey[ra * kSurv + pa++] =
            (static_cast<unsigned long long>(ka[e]) << 32) | pos;
        if (fb[e]) skey[rb * kSurv + pb++] =
            (static_cast<unsigned long long>(kb[e]) << 32) | pos;
      }
      __syncwarp();
      if (q == 0) {
        scount[ra] = na + __popc(ga0) + __popc(ga1);
        scount[rb] = nb + __popc(gb0) + __popc(gb1);
      }
      __syncwarp();
      flush(8);  // room for the next pair of columns
    }
    flush(0);  // the next tile starts from exact thresholds
  }

  const int part = a.part_base + split;
  for (int i = 0; i < 16; ++i) {
    const int r = 16 * warp + i, row = row0 + r;
    if (row >= a.m) break;
    const long long o = (static_cast<long long>(row) * a.parts + part) * k;
    for (int j = lane; j < k; j += 32) {
      a.out_v[o + j] = rtt::key_float(cval[r * k + j]);
      a.out_i[o + j] = cid[r * k + j];
    }
  }
}

// ------------------------------------------------------- large-k route

constexpr int kFmaTM = 16;   // query rows per block
constexpr int kFmaTN = 128;  // database rows per tile
constexpr int kFmaDK = 32;   // feature slice staged per step
constexpr int kFmaThreads = 256;

// the formula of gpu_kernels.l2_topk_fma_smem_bytes
size_t fma_smem_bytes(int k) {
  return static_cast<size_t>(kFmaDK) * (kFmaTM + 1) * 4 +   // x slice
         static_cast<size_t>(kFmaDK) * (kFmaTN + 1) * 4 +   // y slice
         8 +                                                // 8-align
         static_cast<size_t>(kFmaTM) * kFmaTN * 8 +         // survivors
         static_cast<size_t>(kFmaTM) * k * 8 +              // carry
         static_cast<size_t>(kFmaTM) * 4;                   // counts
}

// 16 query rows a block, a thread one row × 8 columns of the 16 × 128 tile,
// an fp32 FMA product staged through shared memory in 32-wide slices; every
// candidate below its row's k-th value is appended to the row's survivor
// list and the lists are merged into the carry after each tile.
__global__ void __launch_bounds__(kFmaThreads)
fma_topk_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ xn, const float* __restrict__ yn,
                int m, long long n, int d, int k, long long split_len,
                int splits, float* __restrict__ out_v,
                int32_t* __restrict__ out_i) {
  constexpr int TM = kFmaTM, TN = kFmaTN, DK = kFmaDK;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [DK][TM + 1]
  float* ys = xs + DK * (TM + 1);              // [DK][TN + 1]
  size_t off = (static_cast<size_t>(DK) * (TM + 1 + TN + 1) * 4 + 7) & ~size_t(7);
  unsigned long long* skey = reinterpret_cast<unsigned long long*>(smem + off);
  uint32_t* cval = reinterpret_cast<uint32_t*>(skey + TM * TN);  // [TM][k]
  int32_t* cid = reinterpret_cast<int32_t*>(cval + TM * k);      // [TM][k]
  int* scount = reinterpret_cast<int*>(cid + TM * k);            // [TM]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * TM;
  const long long lo = static_cast<long long>(blockIdx.y) * split_len;
  const long long hi = lo + split_len < n ? lo + split_len : n;

  for (int i = tid; i < TM * k; i += kFmaThreads) {
    cval[i] = rtt::kInfKey;
    cid[i] = -1;
  }
  for (int i = tid; i < TM; i += kFmaThreads) scount[i] = 0;
  const int row = row0 + ty;
  const float xnr = row < m ? xn[row] : 0.f;
  __syncthreads();

  for (long long col0 = lo; col0 < hi; col0 += TN) {
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
    for (int k0 = 0; k0 < d; k0 += DK) {
      for (int e = tid; e < TM * DK; e += kFmaThreads) {
        const int r = e / DK, c = e % DK;
        const int xr = row0 + r, dim = k0 + c;
        xs[c * (TM + 1) + r] =
            (xr < m && dim < d) ? x[static_cast<long long>(xr) * d + dim] : 0.f;
      }
      for (int e = tid; e < TN * DK; e += kFmaThreads) {
        const int r = e / DK, c = e % DK;
        const long long col = col0 + r;
        const int dim = k0 + c;
        ys[c * (TN + 1) + r] = (col < hi && dim < d) ? y[col * d + dim] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < DK; ++kk) {
        const float av = xs[kk * (TM + 1) + ty];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          acc[c] = fmaf(av, ys[kk * (TN + 1) + tx + 16 * c], acc[c]);
      }
      __syncthreads();
    }
    if (row < m) {
      const uint32_t thr = cval[ty * k + k - 1];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const long long col = col0 + tx + 16 * c;
        if (col < hi)
          rtt::offer(rtt::float_key(l2_dist(xnr, yn[col], acc[c])),
                     tx + 16 * c, thr, skey + ty * TN, scount + ty);
      }
    }
    __syncthreads();
    for (int rl = warp; rl < TM; rl += kFmaThreads / 32) {
      const int cnt = scount[rl];
      if (cnt > 0) {
        rtt::warp_merge(cval + rl * k, cid + rl * k, k, skey + rl * TN, cnt,
                        TileIds{col0});
        if (lane == 0) scount[rl] = 0;
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < TM * k; e += kFmaThreads) {
    const int rl = e / k, j = e % k;
    const int r = row0 + rl;
    if (r < m) {
      const long long o = (static_cast<long long>(r) * splits + blockIdx.y) * k + j;
      out_v[o] = rtt::key_float(cval[e]);
      out_i[o] = cid[e];
    }
  }
}

cudaError_t run_fma(const float* x, const float* y, const float* xn,
                    const float* yn, int m, long long n, int d, int k,
                    long long split_len, int splits, float* pv, int32_t* pi,
                    cudaStream_t s) {
  const size_t smem = fma_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(
      fma_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((m + kFmaTM - 1) / kFmaTM, splits);
  fma_topk_kernel<<<grid, kFmaThreads, smem, s>>>(x, y, xn, yn, m, n, d, k,
                                                  split_len, splits, pv, pi);
  return cudaGetLastError();
}

template <int WGS>
cudaError_t run_tc(const float* x, const float* y, const float* xn,
                   const float* yn, int m, long long n, int d, int d_pad,
                   int k, int stages, long long split_len, int splits,
                   int chunk_splits, float* scratch, float* pv, int32_t* pi,
                   cudaStream_t s) {
  constexpr int kBM = 64 * WGS;
  const size_t smem = tc_smem_bytes(k, stages, WGS);
  cudaError_t err = cudaFuncSetAttribute(
      tc_topk_kernel<WGS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  float* xh = scratch;
  float* xl = xh + static_cast<long long>(m) * d_pad;
  const long long chunk_len = split_len * chunk_splits;
  float* yh = xl + static_cast<long long>(m) * d_pad;
  float* yl = yh + (chunk_len < n ? chunk_len : n) * d_pad;
  err = tct::launch_split(x, m, d, d_pad, xh, xl, s);
  if (err != cudaSuccess) return err;
  CUtensorMap mxh, mxl, myh, myl;
  if (!tct::make_map(&mxh, xh, m, d_pad, kBM) ||
      !tct::make_map(&mxl, xl, m, d_pad, kBM))
    return cudaErrorInvalidValue;
  TcArgs a;
  a.xn = xn;
  a.m = m;
  a.split_len = split_len;
  a.q_tiles = (m + kBM - 1) / kBM;
  a.k_slices = d_pad / kBK;
  a.k = k;
  a.stages = stages;
  a.parts = splits;
  a.out_v = pv;
  a.out_i = pi;
  for (int p0 = 0; p0 < splits; p0 += chunk_splits) {
    const long long c0 = static_cast<long long>(p0) * split_len;
    const long long rows = n - c0 < chunk_len ? n - c0 : chunk_len;
    const int parts_here =
        static_cast<int>((rows + split_len - 1) / split_len);
    err = tct::launch_split(y + c0 * d, rows, d, d_pad, yh, yl, s);
    if (err != cudaSuccess) return err;
    if (!tct::make_map(&myh, yh, rows, d_pad, kBN) ||
        !tct::make_map(&myl, yl, rows, d_pad, kBN))
      return cudaErrorInvalidValue;
    a.yn = yn + c0;
    a.chunk_rows = rows;
    a.id_base = c0;
    a.part_base = p0;
    const long long blocks = static_cast<long long>(a.q_tiles) * parts_here;
    tc_topk_kernel<WGS><<<static_cast<unsigned>(blocks), 128 * WGS + 32, smem,
                          s>>>(mxh, mxl, myh, myl, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// route 0: the tensor-core route with `wgs` consumer warpgroups, with `scratch` [2·m + 2·min(split_len·
// chunk_splits, n), d_pad] floats (the hi/lo planes of x and of one database
// chunk) and `stages` ring stages; route 1: the large-k FMA route (no
// scratch). The database is cut into `splits` ranges of split_len rows (a
// multiple of 128); with splits > 1 the per-range results go to
// part_v/part_i [m, splits, k] and are merged into out_v/out_i [m, k].
extern "C" int fused_l2_topk(const void* x, const void* y, const void* xn,
                             const void* yn, int m, long long n, int d, int k,
                             int route, int wgs, int d_pad, int stages,
                             long long split_len, int splits, int chunk_splits,
                             void* scratch, void* part_v, void* part_i,
                             void* out_v, void* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m < 1 || k < 1 || splits < 1 || split_len < 1 || split_len % 128 != 0 ||
      (splits - 1) * split_len >= (n > 0 ? n : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  float* pv = static_cast<float*>(splits > 1 ? part_v : out_v);
  int32_t* pi = static_cast<int32_t*>(splits > 1 ? part_i : out_i);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* xnf = static_cast<const float*>(xn);
  const float* ynf = static_cast<const float*>(yn);
  cudaError_t err;
  if (route == 0) {
    if (n < 1 || d_pad < d || d_pad % kBK != 0 || stages < 2 ||
        chunk_splits < 1 || scratch == nullptr || (wgs != 1 && wgs != 2))
      return static_cast<int>(cudaErrorInvalidValue);
    float* sc = static_cast<float*>(scratch);
    err = wgs == 2 ? run_tc<2>(xf, yf, xnf, ynf, m, n, d, d_pad, k, stages,
                               split_len, splits, chunk_splits, sc, pv, pi, s)
                   : run_tc<1>(xf, yf, xnf, ynf, m, n, d, d_pad, k, stages,
                               split_len, splits, chunk_splits, sc, pv, pi, s);
  } else {
    err = run_fma(xf, yf, xnf, ynf, m, n, d, k, split_len, splits, pv, pi, s);
  }
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(rtt::launch_select_rows(
      pv, pi, m, static_cast<long long>(splits) * k, k, 0,
      static_cast<float*>(out_v), static_cast<int32_t*>(out_i), s));
}
