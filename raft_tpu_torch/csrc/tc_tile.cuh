// The 3×TF32 tensor-core tile shared by fused_l2_topk and fused_l2_argmin.
//
// Both kernels compute an fp32-accurate (Precision.HIGHEST) x·yᵀ tile on
// Hopper's tensor cores from three TF32 passes: a = a_hi + a_lo with
// a_hi = rna_tf32(a), a_lo = rna_tf32(a − a_hi), and x·y ≈ x_hi·y_hi +
// x_hi·y_lo + x_lo·y_hi accumulated in fp32 (error about 2⁻²¹ of
// Σ|x_i·y_i|, the order of fp32's own; one TF32 pass would be 2⁻¹¹).
//
// What is shared:
//   - the split pass (split_tf32_kernel): hi/lo planes with the feature
//     width zero-padded to a multiple of kBK (zeros change no dot product),
//     so that a 32-float slice is one 128-byte TMA row and four k-steps;
//   - TMA tensor maps of such planes (make_map: boxes of rows × 32 floats,
//     128-byte swizzle, rows past the end read as zeros), encoded through
//     the runtime's driver entry point, so that nothing links -lcuda;
//   - the mbarrier ring between one producer thread and the consumer
//     warpgroups (mbar_*, tma_load), and the consumer's side of it for one
//     output tile (ring_tile): per 32-float slice, four k-steps of three
//     wgmma.m64n128k8 each, a stage released once the next slice's
//     products are issued;
//   - swizzled_offset: where an element lands in a 128-byte-swizzled tile,
//     for a kernel that writes a split operand into shared memory itself
//     (fused_l2_argmin's x rows).
#pragma once

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace tct {

constexpr int kBN = 128;  // y rows per tile (the wgmma N)
constexpr int kBK = 32;   // floats per k-slice: one 128-byte swizzled row
constexpr int kSliceB = kBN * kBK * 4;  // bytes of one B plane slice

// ------------------------------------------------------------ split pass

__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// src [rows, d] → hi, lo [rows, d_pad], zeros past d
__global__ void split_tf32_kernel(const float* __restrict__ src, long long rows,
                                  int d, int d_pad, float* __restrict__ hi,
                                  float* __restrict__ lo) {
  const long long total = rows * d_pad;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = e / d_pad;
    const int c = static_cast<int>(e - r * d_pad);
    const float v = c < d ? src[r * d + c] : 0.f;
    const float h = tf32_rna(v);
    hi[e] = h;
    lo[e] = tf32_rna(v - h);
  }
}

inline cudaError_t launch_split(const float* src, long long rows, int d,
                                int d_pad, float* hi, float* lo,
                                cudaStream_t s) {
  const long long total = rows * d_pad;
  long long blocks = (total + 255) / 256;
  if (blocks > 8192) blocks = 8192;
  if (blocks < 1) blocks = 1;
  split_tf32_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      src, rows, d, d_pad, hi, lo);
  return cudaGetLastError();
}

// -------------------------------------------------- barriers, TMA, wgmma

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with the 128-byte swizzle:
// 8-row groups 1024 bytes apart (the tiles are 1024-byte aligned)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// Byte offset of element (row, col) of a 128-byte-swizzled tile of rows ×
// 32 floats based at a 1024-byte boundary: the 16-byte chunk col/4 of a row
// sits at chunk (col/4) ^ (row % 8), the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B and sw128_desc reads.
__device__ __forceinline__ uint32_t swizzled_offset(int row, int col) {
  return static_cast<uint32_t>(row * 128 +
                               ((((col >> 2) ^ row) & 7) << 4) +
                               (col & 3) * 4);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accesses of d across the asynchronous mma
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64] += A·Bᵀ over one k8 step: A [64 × 8] and B [128 × 8] tf32, both
// K-major in 128-byte-swizzled shared memory, given by their descriptors.
// d[i] holds row 16·warp + lane/4 + 8·((i/2)%2), column 8·(i/4) + 2·(lane%4)
// + i%2 of the warpgroup's 64 × 128 tile.
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

// The consumer's side of the ring for one output tile: acc += A·Bᵀ over
// k_slices 32-float slices, ring iterations it0 .. it0 + k_slices − 1.
// a_of(stage address, slice) gives the slice's A hi plane (its lo plane
// a_lo bytes above it); the stage's B hi plane is b_off bytes into the
// stage and its lo plane kSliceB above that. A slice's stage is released
// once the next slice's products are issued, so the tensor cores never wait
// for the release.
template <class AOf>
__device__ __forceinline__ void ring_tile(float* acc, int it0, int k_slices,
                                          int stages, unsigned char* ring,
                                          int stage_bytes, uint32_t b_off,
                                          uint32_t a_lo, uint64_t* full,
                                          uint64_t* empty, AOf a_of) {
  int prev = -1;
  for (int kc = 0; kc < k_slices; ++kc) {
    const int it = it0 + kc;
    const int s = it % stages;
    mbar_wait(smem_u32(full + s), (it / stages) & 1);
    const uint32_t st = smem_u32(ring + s * stage_bytes);
    const uint32_t a0 = a_of(st, kc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) {  // 8 tf32 = 32 bytes a k-step
      const uint64_t ah = sw128_desc(a0 + 32 * kk);
      const uint64_t al = sw128_desc(a0 + a_lo + 32 * kk);
      const uint64_t bh = sw128_desc(st + b_off + 32 * kk);
      const uint64_t bl = sw128_desc(st + b_off + kSliceB + 32 * kk);
      wgmma_tf32(acc, ah, bh);
      wgmma_tf32(acc, ah, bl);
      wgmma_tf32(acc, al, bh);
    }
    wgmma_commit();
    if (prev >= 0) {
      wgmma_wait<1>();
      mbar_arrive(smem_u32(empty + prev));
    }
    prev = s;
  }
  wgmma_wait<0>();
  fence_operands(acc);
  if (prev >= 0) mbar_arrive(smem_u32(empty + prev));
}

// ------------------------------------------------------------ TMA maps

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so that the library links without -lcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a [rows, d_pad] float plane read in boxes of box_rows × 32 floats, rows
// past the end read as zeros
inline bool make_map(CUtensorMap* map, const float* base, long long rows,
                     int d_pad, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d_pad),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d_pad) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBK),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
            const_cast<float*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tct
