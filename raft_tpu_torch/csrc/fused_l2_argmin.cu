// Fused squared-L2 distance + 1-NN (min and argmin over y) for every x row.
//
// Replaces raft_tpu/ops/pallas_kernels.py:fused_l2_argmin
// (_fused_l2_argmin_kernel): an fp32 (Precision.HIGHEST) x·yᵀ tile,
// d = ‖x‖² + ‖y‖² − 2·x·y, reduced at once into a running (min, argmin) per
// x row, so the [m, n] distance matrix never exists in device memory. It is
// the E-step of Lloyd k-means (the reference's minClusterAndDistanceCompute)
// and the body of fused_l2_nn_argmin. With `clamp`, d is max(d, 0) before the
// comparison, as the E-step's l2_expanded clamps: rows at distance ~0 from
// several centres then tie at 0 and take the lowest index, instead of letting
// the sign of the rounding noise decide.
//
// Bound on the H100: fp32 arithmetic. The products run as fp32 FMA (not
// TF32, to match Precision.HIGHEST): m·n·d FMAs against the card's fp32 rate
// outside the tensor cores; the inputs are read once per block and the
// output is 8 bytes a row.
//
// Design: a block owns 64 x rows and loops over 128-row y tiles (the loop
// takes the place of the TPU's sequential inner grid axis). Each tile is a
// register-blocked fp32 product staged through shared memory in 32-wide
// slices of the feature dimension (any d; the ragged slice is zero-filled);
// its epilogue applies the norms (and the clamp) and keeps, per thread and
// row, the first minimum over the thread's columns, which it visits in
// increasing order. The 16 threads of a row then reduce by (value, index),
// so ties go to the lowest y index. Rows past n are never read: the tile
// loop is bounded by n, with no padding of y.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRM = 4;            // x rows per thread
constexpr int kTM = 16 * kRM;     // x rows per block
constexpr int kTN = 128;          // y rows per tile
constexpr int kDK = 32;           // feature slice staged per step
constexpr int kThreads = 256;

// (v, i) precedes (bv, bi): smaller value, or the same value at a lower
// index; entries with index < 0 hold no candidate
__device__ __forceinline__ bool precedes(float v, int32_t i, float bv,
                                         int32_t bi) {
  if (i < 0) return false;
  if (bi < 0) return true;
  return v < bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
fused_l2_argmin_kernel(const float* __restrict__ x, const float* __restrict__ y,
                       const float* __restrict__ xn,
                       const float* __restrict__ yn, int m, long long n, int d,
                       int clamp, float* __restrict__ out_v,
                       int32_t* __restrict__ out_i) {
  __shared__ float xs[kDK][kTM + 1];
  __shared__ float ys[kDK][kTN + 1];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * kTM;

  float xnr[kRM], best[kRM];
  int32_t bidx[kRM];
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
    const int row = row0 + ty * kRM + r;
    xnr[r] = row < m ? xn[row] : 0.f;
    best[r] = __int_as_float(0x7f800000);  // +inf
    bidx[r] = -1;
  }

  for (long long col0 = 0; col0 < n; col0 += kTN) {
    float acc[kRM][8];
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kDK) {
      for (int e = tid; e < kTM * kDK; e += kThreads) {
        const int r = e / kDK, c = e % kDK;
        const int row = row0 + r, dim = k0 + c;
        xs[c][r] = (row < m && dim < d)
                       ? x[static_cast<long long>(row) * d + dim] : 0.f;
      }
      for (int e = tid; e < kTN * kDK; e += kThreads) {
        const int r = e / kDK, c = e % kDK;
        const long long col = col0 + r;
        const int dim = k0 + c;
        ys[c][r] = (col < n && dim < d) ? y[col * d + dim] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kDK; ++kk) {
        float a[kRM], b[8];
#pragma unroll
        for (int r = 0; r < kRM; ++r) a[r] = xs[kk][ty * kRM + r];
#pragma unroll
        for (int c = 0; c < 8; ++c) b[c] = ys[kk][tx + 16 * c];
#pragma unroll
        for (int r = 0; r < kRM; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
      }
      __syncthreads();
    }

    // epilogue: (‖x‖² + ‖y‖²) − 2·x·y (clamped if asked); this thread's
    // columns ascend with c and with the tile, so a strict < keeps the first
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const long long col = col0 + tx + 16 * c;
      if (col < n) {
        const float ynv = yn[col];
#pragma unroll
        for (int r = 0; r < kRM; ++r) {
          float dist = __fsub_rn(__fadd_rn(xnr[r], ynv),
                                 __fmul_rn(2.f, acc[r][c]));
          if (clamp) dist = fmaxf(dist, 0.f);
          if (bidx[r] < 0 || dist < best[r]) {
            best[r] = dist;
            bidx[r] = static_cast<int32_t>(col);
          }
        }
      }
    }
  }

  // the 16 threads of a row are 16 neighbouring lanes of one warp
#pragma unroll
  for (int r = 0; r < kRM; ++r) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best[r], o, 16);
      const int32_t oi = __shfl_xor_sync(0xffffffffu, bidx[r], o, 16);
      if (precedes(ov, oi, best[r], bidx[r])) {
        best[r] = ov;
        bidx[r] = oi;
      }
    }
    const int row = row0 + ty * kRM + r;
    if (tx == 0 && row < m) {
      out_v[row] = best[r];
      out_i[row] = bidx[r];
    }
  }
}

}  // namespace

// x [m, d], y [n, d], xn [m], yn [n] float32, n >= 1; out_v/out_i [m]
extern "C" int fused_l2_argmin(const void* x, const void* y, const void* xn,
                               const void* yn, int m, long long n, int d,
                               int clamp, void* out_v, void* out_i,
                               void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  fused_l2_argmin_kernel<<<(m + kTM - 1) / kTM, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(xn), static_cast<const float*>(yn), m, n, d,
      clamp, static_cast<float*>(out_v), static_cast<int32_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
