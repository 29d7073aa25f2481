// One hop of a ring: copy one rank's block into the buffer of the next rank.
//
// Replaces raft_tpu/ops/pallas_kernels.py:pallas_ring_shift
// (_ring_shift_kernel): the +1 ring rotation of one block per device, the
// leg of the sharded ring top-k merge (Comms.ring_topk_merge) that moves a
// packed [3, nq, kk] float32 candidate block (values, positions, ids) to the
// next rank each step. The TPU kernel pushes the block by remote DMA after a
// barrier with both neighbours. Here one launch per source rank copies its
// bytes into the destination buffer, which the wrapper allocated on the
// destination rank's device: the same card when ranks share one, else a
// peer card whose memory the source device writes over NVLink after
// cudaDeviceEnablePeerAccess. The barrier becomes stream order: the wrapper
// makes the source stream wait for the destination stream before the launch
// and the destination stream wait for the launch after it. Nothing spins
// inside the kernel, as two ranks' kernels on one card need not be resident
// together.
//
// Bound on the H100: bytes. Each byte is read once and written once, so a
// block of B bytes needs 2·B / 3.35 TB/s of device memory traffic (about
// 0.72 µs at the merge's 1.2 MB); at that size a launch costs more than the
// copy, so the kernel is launch-bound.
//
// Design: a grid-stride loop over 16-byte vectors (one load and one store
// per thread per step, neighbouring threads on neighbouring addresses), the
// grid sized to the work and capped at four blocks per SM, then a byte tail
// for counts that are not a multiple of 16. Pointers that are not both
// 16-byte aligned take the byte loop for the whole block.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ring_shift_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                  long long n_vec, const unsigned char* __restrict__ src_b,
                  unsigned char* __restrict__ dst_b, long long tail_start,
                  long long n_bytes) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (long long v = tid; v < n_vec; v += stride) dst[v] = __ldg(src + v);
  for (long long b = tail_start + tid; b < n_bytes; b += stride)
    dst_b[b] = src_b[b];
}

}  // namespace

// Copies n_bytes from src to dst on `stream` (the source device's stream;
// the caller makes the source device current). dst may lie on another device
// that the source device can access as a peer.
extern "C" int ring_shift_copy(const void* src, void* dst, long long n_bytes,
                               int n_sm, void* stream) {
  if (n_bytes < 0 || n_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_bytes == 0) return 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const long long n_vec = aligned ? n_bytes / 16 : 0;
  const long long tail_start = n_vec * 16;
  const long long units = n_vec > 0 ? n_vec : n_bytes - tail_start;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 4LL * n_sm) blocks = 4LL * n_sm;
  ring_shift_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst), n_vec,
      static_cast<const unsigned char*>(src), static_cast<unsigned char*>(dst),
      tail_start, n_bytes);
  return static_cast<int>(cudaGetLastError());
}

// Lets src_dev write the memory of dst_dev: 0 on success (also when already
// enabled), cudaErrorPeerAccessUnsupported when the pair has no peer path.
// The current device is restored.
extern "C" int ring_shift_enable_peer(int src_dev, int dst_dev) {
  if (src_dev == dst_dev) return 0;
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, src_dev, dst_dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  int prev = 0;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(src_dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceEnablePeerAccess(dst_dev, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error this call recorded
    err = cudaSuccess;
  }
  const cudaError_t restore = cudaSetDevice(prev);
  return static_cast<int>(err != cudaSuccess ? err : restore);
}

extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
