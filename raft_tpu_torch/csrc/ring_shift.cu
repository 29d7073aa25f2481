// One hop of a ring: copy each rank's block into the buffer of the next rank.
//
// Replaces raft_tpu/ops/pallas_kernels.py:pallas_ring_shift
// (_ring_shift_kernel): the +1 ring rotation of one block per device, the
// leg of the sharded ring top-k merge (Comms.ring_topk_merge) that moves a
// packed [3, nq, kk] float32 candidate block (values, positions, ids) to the
// next rank each step. The TPU kernel pushes the block by remote DMA after a
// barrier with both neighbours. Here one launch per source device moves every
// block whose rank lies on that device into its destination buffer, which
// the wrapper allocated on the next rank's device: the same card when ranks
// share one, else a peer card whose memory the source device writes over
// NVLink after cudaDeviceEnablePeerAccess. The barrier becomes stream order:
// the wrapper makes the source stream wait for the destination streams
// before the launch and the destination streams wait for the launch after
// it. Nothing spins inside the kernel, as two devices' launches need not be
// resident together.
//
// Bound on the H100: bytes. Each byte is read once and written once, so a
// hop of R blocks of B bytes needs 2·R·B / 3.35 TB/s of device memory
// traffic (about 2.9 µs for four ranks' 1.2 MB blocks on one card). A launch
// costs about as much as one such block's copy, so the design launches once
// per source device and hop instead of once per rank.
//
// Design: the (source, destination) pairs of one launch travel by value in
// the kernel's parameters (up to kMaxPairs; a longer list takes more
// launches). blockIdx.y picks the pair; the x blocks run a grid-stride loop
// over its 16-byte vectors (one load and one store per thread per step,
// neighbouring threads on neighbouring addresses), the grid sized to the
// work and capped at four blocks per SM over all pairs, then a byte tail for
// counts that are not a multiple of 16. A pair whose pointers are not both
// 16-byte aligned takes the byte loop for its whole block.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPairs = 32;  // gpu_kernels.RING_SHIFT_MAX_PAIRS

struct Pairs {
  const unsigned char* src[kMaxPairs];
  unsigned char* dst[kMaxPairs];
};

__global__ void __launch_bounds__(kThreads)
ring_shift_kernel(const Pairs pairs, long long n_bytes) {
  const unsigned char* src = pairs.src[blockIdx.y];
  unsigned char* dst = pairs.dst[blockIdx.y];
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const long long n_vec = aligned ? n_bytes / 16 : 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint4* src_v = reinterpret_cast<const uint4*>(src);
  uint4* dst_v = reinterpret_cast<uint4*>(dst);
  for (long long v = tid; v < n_vec; v += stride) dst_v[v] = __ldg(src_v + v);
  for (long long b = n_vec * 16 + tid; b < n_bytes; b += stride)
    dst[b] = src[b];
}

}  // namespace

// Copies n_bytes from srcs[i] to dsts[i] for the n_pairs pairs (at most
// kMaxPairs, all sources on the current device) in one launch on `stream`
// (the source device's stream; the caller makes the source device current).
// A destination may lie on another device that the source device can access
// as a peer.
extern "C" int ring_shift_copy(const void* const* srcs, void* const* dsts,
                               int n_pairs, long long n_bytes, int n_sm,
                               void* stream) {
  if (n_bytes < 0 || n_sm < 1 || n_pairs < 0 || n_pairs > kMaxPairs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_bytes == 0 || n_pairs == 0) return 0;
  Pairs pairs{};
  bool all_aligned = true;
  for (int i = 0; i < n_pairs; ++i) {
    pairs.src[i] = static_cast<const unsigned char*>(srcs[i]);
    pairs.dst[i] = static_cast<unsigned char*>(dsts[i]);
    all_aligned = all_aligned && ((reinterpret_cast<uintptr_t>(srcs[i]) |
                                   reinterpret_cast<uintptr_t>(dsts[i])) &
                                  15) == 0;
  }
  const long long units = all_aligned ? n_bytes / 16 : n_bytes;
  long long blocks = (units + kThreads - 1) / kThreads;
  const long long cap = (4LL * n_sm + n_pairs - 1) / n_pairs;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  ring_shift_kernel<<<dim3(static_cast<unsigned>(blocks),
                           static_cast<unsigned>(n_pairs)),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pairs, n_bytes);
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
