// Bit-plane pack for Hopper (sm_90a): flat uint16 slab -> (16, n/8) uint8.
//
// Replaces the TPU kernel src/repro/kernels/bitplane.py::_pack_kernel
// (launched through pack_planes_pallas / pack_planes_slab on the tier's
// write path).  Plane p of the output holds bit p of every element; each
// byte packs 8 consecutive elements, the first element in the MSB.
//
// Bound on this card: memory.  The pack reads 2 B and writes 2 B per
// element (16 planes x 1 bit) and does a few integer operations per
// element, so its least time is 4 B/element over 3.35 TB/s: 0.157 us at
// the tier's flush slab of 131072 elements, below the device time of any
// launch, and 5.20 us at 4,358,144 (a 896 x 4864 weight).  At the slab
// the time is latency: one load round trip, the transpose and the drain
// of the stores, on however many SMs the grid reaches.
//
// Design:
// - A thread owns kGroups runs of 8 consecutive elements and issues their
//   16-byte loads before it uses any.  Blocks are kThreads threads, so
//   the slab's 131072 / (8 kGroups) threads spread over every SM.
// - A run's low and high bytes are two 8 x 8 bit matrices (row j: element
//   j), each transposed by three delta swaps (transpose8, the transpose
//   csrc/elastic_matmul.cu rebuilds weights with, run the other way) into
//   one byte per plane, in registers.
// - A 4 x 4 byte transpose (__byte_perm) gathers each plane's kGroups
//   bytes into one word, so a thread writes kGroups bytes of a plane row
//   per store and a warp's store covers 32 kGroups contiguous bytes of
//   one row: a full 128-byte line at kGroups 4.
// - Ragged tail: a thread past n / 8 runs loads only the runs inside the
//   slab and writes bytes.  Where n / 8 is not a multiple of kGroups the
//   plane rows do not start on a word, and every thread writes bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;   // threads a block
constexpr int kGroups = 4;     // runs of 8 elements a thread: 2, 4 or 8

// 8 x 8 bit-matrix transpose of the 64-bit word (x, y) by delta swaps
// (Hacker's Delight, transpose8rS32): byte i of the input (x's MSB first,
// then y's) is row i, bit 7 - j its column j; byte j of the output holds
// column j, row i in its bit 7 - i.
__device__ __forceinline__ void transpose8(uint32_t& x, uint32_t& y) {
  uint32_t t;
  t = (x ^ (x >> 7)) & 0x00AA00AAu;
  x = x ^ t ^ (t << 7);
  t = (y ^ (y >> 7)) & 0x00AA00AAu;
  y = y ^ t ^ (t << 7);
  t = (x ^ (x >> 14)) & 0x0000CCCCu;
  x = x ^ t ^ (t << 14);
  t = (y ^ (y >> 14)) & 0x0000CCCCu;
  y = y ^ t ^ (t << 14);
  t = (x & 0xF0F0F0F0u) | ((y >> 4) & 0x0F0F0F0Fu);
  y = ((x << 4) & 0xF0F0F0F0u) | (y & 0x0F0F0F0Fu);
  x = t;
}

// One run of 8 elements (one 16-byte load, element 2k in the low half of
// word k) -> its byte of every plane: byte c of q[k] is plane 4k + c.
__device__ __forceinline__ void run_planes(uint4 v, uint32_t (&q)[4]) {
  // rows: element j's low (high) byte in byte 3 - j of x (7 - j of y)
  uint32_t xl = __byte_perm(v.x, v.y, 0x0246);
  uint32_t yl = __byte_perm(v.z, v.w, 0x0246);
  uint32_t xh = __byte_perm(v.x, v.y, 0x1357);
  uint32_t yh = __byte_perm(v.z, v.w, 0x1357);
  transpose8(xl, yl);   // column j is plane 7 - j: y holds planes 0..3
  transpose8(xh, yh);
  q[0] = yl;
  q[1] = xl;
  q[2] = yh;
  q[3] = xh;
}

// 4 x 4 byte transpose: byte g of o[c] is byte c of a[g].
__device__ __forceinline__ void gather4(uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t (&o)[4]) {
  const uint32_t p = __byte_perm(a0, a1, 0x5140);   // a0.0 a1.0 a0.1 a1.1
  const uint32_t q = __byte_perm(a0, a1, 0x7362);   // a0.2 a1.2 a0.3 a1.3
  const uint32_t r = __byte_perm(a2, a3, 0x5140);
  const uint32_t s = __byte_perm(a2, a3, 0x7362);
  o[0] = __byte_perm(p, r, 0x5410);
  o[1] = __byte_perm(p, r, 0x7632);
  o[2] = __byte_perm(q, s, 0x5410);
  o[3] = __byte_perm(q, s, 0x7632);
}

// Plane 4k + c's G bytes (byte g from run g) stored at dst, G-byte aligned.
template <int G>
__device__ __forceinline__ void store_quad(const uint32_t (&q)[G][4], int k,
                                           uint8_t* __restrict__ out,
                                           long long n8, long long col) {
  if constexpr (G == 2) {
    const uint32_t lo = __byte_perm(q[0][k], q[1][k], 0x5140);   // planes c 0, 1
    const uint32_t hi = __byte_perm(q[0][k], q[1][k], 0x7362);   // planes c 2, 3
    const uint32_t v[4] = {lo & 0xFFFFu, lo >> 16, hi & 0xFFFFu, hi >> 16};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint16_t*>(out + (4 * k + c) * n8 + col) =
          static_cast<uint16_t>(v[c]);
  } else {
    uint32_t o[G / 4][4];
#pragma unroll
    for (int h = 0; h < G / 4; ++h)
      gather4(q[4 * h][k], q[4 * h + 1][k], q[4 * h + 2][k], q[4 * h + 3][k],
              o[h]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint8_t* dst = out + (4 * k + c) * n8 + col;
      if constexpr (G == 4)
        *reinterpret_cast<uint32_t*>(dst) = o[0][c];
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(o[0][c], o[1][c]);
    }
  }
}

// VEC: n8 % G == 0, so every full tile stores whole G-byte words.
template <int G, bool VEC>
__global__ void __launch_bounds__(kThreads)
pack_planes_kernel(const uint4* __restrict__ x, uint8_t* __restrict__ out,
                   long long n8) {
  static_assert(G == 2 || G == 4 || G == 8, "kGroups is 2, 4 or 8");
  const long long col = (blockIdx.x * (long long)kThreads + threadIdx.x) * G;
  if (col >= n8) return;
  const long long left = n8 - col;
  uint4 v[G];
#pragma unroll
  for (int g = 0; g < G; ++g)     // every load in flight before any use
    v[g] = g < left ? x[col + g] : make_uint4(0u, 0u, 0u, 0u);
  uint32_t q[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) run_planes(v[g], q[g]);
  if (VEC && left >= G) {
#pragma unroll
    for (int k = 0; k < 4; ++k) store_quad<G>(q, k, out, n8, col);
    return;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= left) break;
#pragma unroll
    for (int p = 0; p < 16; ++p)
      out[p * n8 + col + g] = static_cast<uint8_t>(q[g][p / 4] >> (8 * (p % 4)));
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
  const long long threads = (n8 + kGroups - 1) / kGroups;
  const unsigned blocks =
      static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const auto* src = static_cast<const uint4*>(x);
  auto* dst = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (n8 % kGroups == 0)
    pack_planes_kernel<kGroups, true><<<blocks, kThreads, 0, s>>>(src, dst, n8);
  else
    pack_planes_kernel<kGroups, false><<<blocks, kThreads, 0, s>>>(src, dst, n8);
  return static_cast<int>(cudaGetLastError());
}
