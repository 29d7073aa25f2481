// Fused squared-L2 distance + top-k for exact (brute-force) search.
//
// Replaces raft_tpu/ops/pallas_kernels.py:fused_l2_topk (_fused_topk_kernel):
// an fp32 (Precision.HIGHEST) x·yᵀ tile, d = max(‖x‖² + ‖y‖² − 2·x·y, 0),
// merged into a running top-k carry, so the [m, n] distance matrix never
// exists in device memory. Rows past n are never candidates; ids are global
// row ids, -1 where fewer than k rows exist.
//
// Bound on the H100: fp32 arithmetic. The products run as fp32 FMA (not
// TF32, to match Precision.HIGHEST): m·n·d FMAs against the card's fp32 rate
// outside the tensor cores, while the inputs are read once per query tile.
//
// Design: a block owns TM query rows and loops over 128-row database tiles
// (the loop takes the place of the TPU's sequential inner grid axis). Each
// tile is a register-blocked fp32 product staged through shared memory in
// 32-wide slices of the feature dimension; its epilogue applies the norms and
// the clamp and offers each distance to its row's carry (topk_carry.cuh),
// which only candidates below the row's current k-th value reach. When the
// query tiles alone cannot fill the card, the database is cut into `splits`
// ranges scanned by separate blocks, and one select_rows pass merges the
// per-range results; ties then still resolve by global row id, because the
// ranges are merged in database order.
#include "topk_carry.cuh"

namespace {

constexpr int kTN = 128;  // database rows per tile
constexpr int kDK = 32;   // feature slice staged per step
constexpr int kThreads = 256;

size_t l2_smem_bytes(int tm, int k) {
  return static_cast<size_t>(kDK) * (tm + 1) * 4 +   // x slice
         static_cast<size_t>(kDK) * (kTN + 1) * 4 +  // y slice
         8 +                                         // keep survivors 8-aligned
         static_cast<size_t>(tm) * kTN * 8 +         // survivors
         static_cast<size_t>(tm) * k * 8 +           // carry
         static_cast<size_t>(tm) * 4;                // survivor counts
}

struct TileIds {
  long long base;
  __device__ int32_t operator()(uint32_t pos) const {
    return static_cast<int32_t>(base + pos);
  }
};

// RM query rows per thread: TM = 16·RM rows per block; each thread owns an
// RM × 8 register tile of the TM × 128 distance tile.
template <int RM>
__global__ void __launch_bounds__(kThreads)
fused_l2_topk_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ xn, const float* __restrict__ yn,
                     int m, long long n, int d, int k, long long split_len,
                     int splits, float* __restrict__ out_v,
                     int32_t* __restrict__ out_i) {
  constexpr int TM = 16 * RM;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [kDK][TM + 1]
  float* ys = xs + kDK * (TM + 1);             // [kDK][kTN + 1]
  size_t off = (static_cast<size_t>(kDK) * (TM + 1 + kTN + 1) * 4 + 7) & ~size_t(7);
  unsigned long long* skey = reinterpret_cast<unsigned long long*>(smem + off);
  uint32_t* cval = reinterpret_cast<uint32_t*>(skey + TM * kTN);  // [TM][k]
  int32_t* cid = reinterpret_cast<int32_t*>(cval + TM * k);       // [TM][k]
  int* scount = reinterpret_cast<int*>(cid + TM * k);             // [TM]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * TM;
  const long long lo = static_cast<long long>(blockIdx.y) * split_len;
  const long long hi = lo + split_len < n ? lo + split_len : n;

  for (int i = tid; i < TM * k; i += kThreads) {
    cval[i] = rtt::kInfKey;
    cid[i] = -1;
  }
  for (int i = tid; i < TM; i += kThreads) scount[i] = 0;
  float xnr[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = row0 + ty * RM + r;
    xnr[r] = row < m ? xn[row] : 0.f;
  }
  __syncthreads();

  for (long long col0 = lo; col0 < hi; col0 += kTN) {
    float acc[RM][8];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kDK) {
      for (int e = tid; e < TM * kDK; e += kThreads) {
        const int r = e / kDK, c = e % kDK;
        const int row = row0 + r, dim = k0 + c;
        xs[c * (TM + 1) + r] =
            (row < m && dim < d) ? x[static_cast<long long>(row) * d + dim] : 0.f;
      }
      for (int e = tid; e < kTN * kDK; e += kThreads) {
        const int r = e / kDK, c = e % kDK;
        const long long col = col0 + r;
        const int dim = k0 + c;
        ys[c * (kTN + 1) + r] = (col < hi && dim < d) ? y[col * d + dim] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kDK; ++kk) {
        float a[RM], b[8];
#pragma unroll
        for (int r = 0; r < RM; ++r) a[r] = xs[kk * (TM + 1) + ty * RM + r];
#pragma unroll
        for (int c = 0; c < 8; ++c) b[c] = ys[kk * (kTN + 1) + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < RM; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
      __syncthreads();
    }

    // epilogue: (‖x‖² + ‖y‖²) − 2·x·y, clamped at 0, offered to the carry
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int rl = ty * RM + r;
      if (row0 + rl < m) {
        const uint32_t thr = cval[rl * k + k - 1];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const long long col = col0 + tx + 16 * c;
          if (col < hi) {
            const float dist = fmaxf(
                __fsub_rn(__fadd_rn(xnr[r], yn[col]), __fmul_rn(2.f, acc[r][c])),
                0.f);
            rtt::offer(rtt::float_key(dist), tx + 16 * c, thr, skey + rl * kTN,
                       scount + rl);
          }
        }
      }
    }
    __syncthreads();
    for (int rl = warp; rl < TM; rl += kThreads / 32) {
      const int cnt = scount[rl];
      if (cnt > 0) {
        rtt::warp_merge(cval + rl * k, cid + rl * k, k, skey + rl * kTN, cnt,
                        TileIds{col0});
        if (lane == 0) scount[rl] = 0;
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < TM * k; e += kThreads) {
    const int rl = e / k, j = e % k;
    const int row = row0 + rl;
    if (row < m) {
      const long long o = (static_cast<long long>(row) * splits + blockIdx.y) * k + j;
      out_v[o] = rtt::key_float(cval[e]);
      out_i[o] = cid[e];
    }
  }
}

template <int RM>
cudaError_t launch(const float* x, const float* y, const float* xn,
                   const float* yn, int m, long long n, int d, int k,
                   long long split_len, int splits, float* out_v,
                   int32_t* out_i, cudaStream_t stream) {
  const size_t smem = l2_smem_bytes(16 * RM, k);
  cudaError_t err = cudaFuncSetAttribute(
      fused_l2_topk_kernel<RM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((m + 16 * RM - 1) / (16 * RM), splits);
  fused_l2_topk_kernel<RM><<<grid, kThreads, smem, stream>>>(
      x, y, xn, yn, m, n, d, k, split_len, splits, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace

// tm is 64 or 16 query rows per block. With splits > 1 the per-range results
// go to part_v/part_i [m, splits, k] and are merged into out_v/out_i [m, k].
extern "C" int fused_l2_topk(const void* x, const void* y, const void* xn,
                             const void* yn, int m, long long n, int d, int k,
                             int tm, int splits, void* part_v, void* part_i,
                             void* out_v, void* out_i, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tm != 64 && tm != 16) return static_cast<int>(cudaErrorInvalidValue);
  long long split_len = (n + splits - 1) / splits;
  split_len = (split_len + kTN - 1) / kTN * kTN;
  float* pv = static_cast<float*>(splits > 1 ? part_v : out_v);
  int32_t* pi = static_cast<int32_t*>(splits > 1 ? part_i : out_i);
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* xnf = static_cast<const float*>(xn);
  const float* ynf = static_cast<const float*>(yn);
  cudaError_t err = tm == 64
      ? launch<4>(xf, yf, xnf, ynf, m, n, d, k, split_len, splits, pv, pi, s)
      : launch<1>(xf, yf, xnf, ynf, m, n, d, k, split_len, splits, pv, pi, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  return static_cast<int>(rtt::launch_select_rows(
      pv, pi, m, static_cast<long long>(splits) * k, k, 0,
      static_cast<float*>(out_v), static_cast<int32_t*>(out_i), s));
}
