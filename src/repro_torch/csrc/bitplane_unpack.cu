// Bit-plane unpack for Hopper (sm_90a): the fetched plane rows of a slab
// -> flat uint16 words, optionally rounded to a precision view.
//
// Replaces the TPU kernel src/repro/kernels/bitplane.py::_unpack_kernel
// (unpack_planes_pallas / ops.elastic_unpack).  Input: P_f rows of
// `nbytes` bytes, row i the packed stream of plane plane_id[i] (plane ids
// packed four bits each into `plane_code`); planes not fetched read as
// zero, as core/bitplane.py::unpack_planes_subset computes.  Byte j of a
// row holds bit p of elements 8j..8j+7, the first element in the MSB.
// The tier's KV read path calls it without rounding (the exponent-delta
// inverse must run first, csrc/kv_delta.cu rounds after it); every other
// bit-plane block takes unpack and round in this one launch.
//
// Bound on this card: memory.  Each element costs P_f / 8 bytes read and
// 2 bytes written, and a few integer operations per fetched bit, far
// below the card's operation rate.
//
// Design: one thread owns one byte column, i.e. 8 elements: it reads one
// byte of each fetched plane (neighbouring threads read neighbouring
// bytes of a row, so each load of a warp is one 32-byte run), assembles
// the 8 words in registers, rounds them and writes them as one 16-byte
// store.  The bit matrix never touches memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "view_round.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint8_t* __restrict__ rows, uint4* __restrict__ out,
              long long nbytes, int nplanes, unsigned long long plane_code,
              uint32_t keep, int cut, bool do_round) {
  const long long j = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (j >= nbytes) return;
  uint32_t e[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int i = 0; i < nplanes; ++i) {
    const int p = static_cast<int>((plane_code >> (4 * i)) & 15ull);
    const uint32_t byte = rows[i * nbytes + j];
#pragma unroll
    for (int k = 0; k < 8; ++k) e[k] |= ((byte >> (7 - k)) & 1u) << p;
  }
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)            // little-endian: element 2k is low
    w[k] = view_round(e[2 * k], keep, cut, do_round) |
           (view_round(e[2 * k + 1], keep, cut, do_round) << 16);
  out[j] = make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace

// rows: nplanes x nbytes uint8 (row-major); out: 8 * nbytes uint16,
// 16-byte aligned.  Returns the cudaError_t of the launch (0 on success).
extern "C" int unpack_planes_u16(const void* rows, void* out, long long nbytes,
                                 int nplanes, unsigned long long plane_code,
                                 int keep, int cut, int do_round, int device,
                                 void* stream) {
  if (nplanes < 0 || nplanes > 16 || (do_round && (cut < 1 || cut > 7)))
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nbytes == 0) return 0;
  const long long blocks = (nbytes + kThreads - 1) / kThreads;
  unpack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), static_cast<uint4*>(out), nbytes,
      nplanes, plane_code, static_cast<uint32_t>(keep), cut, do_round != 0);
  return static_cast<int>(cudaGetLastError());
}
