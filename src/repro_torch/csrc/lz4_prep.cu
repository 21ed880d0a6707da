// LZ4 match prep for Hopper (sm_90a): per byte position of a slab, the
// 4-byte little-endian word, its multiplicative hash and a run-boundary
// flag.
//
// Replaces the TPU kernel src/repro/kernels/lz4.py::_prep_kernel
// (launched through _prep_pallas inside _device_match_impl, the tier's
// write-path LZ4 match pipeline).  For position i, with bytes past the
// slab end read as 0:
//   w[i]    = b[i] | b[i+1] << 8 | b[i+2] << 16 | b[i+3] << 24
//   h[i]    = (w[i] * 2654435761 mod 2^32) >> (32 - HASH_LOG)
//   runb[i] = b[i] != b[i+1]
//
// Bound on this card: memory.  One byte in and 12 bytes out per position,
// a few integer operations each, so the least time is 13 B/position over
// 3.35 TB/s.
//
// Design: elementwise, one thread per position; the four shifted byte
// views the TPU kernel received as separate operands are four reads of
// neighbouring bytes here, which the L1 cache serves to a warp from one
// 32-byte sector.  Stores are 4-byte and contiguous across a warp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kHashLog = 13;

__global__ void __launch_bounds__(kThreads)
lz4_prep_kernel(const uint8_t* __restrict__ b, int32_t* __restrict__ w,
                int32_t* __restrict__ h, int32_t* __restrict__ runb,
                long long n) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t b0 = b[i];
  const uint32_t b1 = i + 1 < n ? b[i + 1] : 0u;
  const uint32_t b2 = i + 2 < n ? b[i + 2] : 0u;
  const uint32_t b3 = i + 3 < n ? b[i + 3] : 0u;
  const uint32_t word = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
  w[i] = static_cast<int32_t>(word);
  h[i] = static_cast<int32_t>((word * 2654435761u) >> (32 - kHashLog));
  runb[i] = b0 != b1 ? 1 : 0;
}

}  // namespace

// b: n bytes; w, h, runb: n int32 each.  Returns the launch's cudaError_t.
extern "C" int lz4_prep(const void* b, void* w, void* h, void* runb,
                        long long n, int device, void* stream) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  lz4_prep_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(b), static_cast<int32_t*>(w),
      static_cast<int32_t*>(h), static_cast<int32_t*>(runb), n);
  return static_cast<int>(cudaGetLastError());
}
