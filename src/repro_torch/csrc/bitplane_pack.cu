// Bit-plane pack for Hopper (sm_90a): flat uint16 slab -> (16, n/8) uint8.
//
// Replaces the TPU kernel src/repro/kernels/bitplane.py::_pack_kernel
// (launched through pack_planes_pallas / pack_planes_slab on the tier's
// write path).  Plane p of the output holds bit p of every element; each
// byte packs 8 consecutive elements, the first element in the MSB.
//
// Bound on this card: memory.  The pack reads 2 B and writes 2 B per
// element (16 planes x 1 bit) and does a handful of integer operations
// per bit, far below the H100's operation rate, so its least time is
// 4 B/element over 3.35 TB/s.
//
// Design: one thread owns 8 consecutive elements, read as one 16-byte
// load, and transposes them in registers into one byte per plane.  The
// bit matrix never touches memory (the TPU kernel's VMEM-resident
// transpose, here held in registers).  Neighbouring threads own
// neighbouring bytes of every plane row, so each of the 16 stores of a
// warp is one contiguous 32-byte run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pack_planes_kernel(const uint4* __restrict__ x, uint8_t* __restrict__ out,
                   long long n8) {
  const long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (i >= n8) return;
  const uint4 v = x[i];
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t e[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {        // little-endian: element 2k is low
    e[2 * k] = w[k] & 0xFFFFu;
    e[2 * k + 1] = w[k] >> 16;
  }
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    uint32_t byte = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) byte |= ((e[j] >> p) & 1u) << (7 - j);
    out[p * n8 + i] = static_cast<uint8_t>(byte);
  }
}

}  // namespace

// x: n uint16 (16-byte aligned, n % 8 == 0); out: 16 * (n / 8) bytes.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int pack_planes_u16(const void* x, void* out, long long n,
                               int device, void* stream) {
  if (n % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n8 = n / 8;
  if (n8 == 0) return 0;
  const long long blocks = (n8 + kThreads - 1) / kThreads;
  pack_planes_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint8_t*>(out), n8);
  return static_cast<int>(cudaGetLastError());
}
