// Elastic-precision dequant matmul for Hopper (sm_90a):
//   out (M, N) f32 = x (M, K) bf16 @ W (K, N), W rebuilt from its fetched
//   K-packed bit-planes at a precision view.
//
// Replaces the TPU kernel src/repro/kernels/elastic_matmul.py::_kernel
// (elastic_matmul_pallas).  Input planes: the top P of the 16 (P = 9 +
// r_m + d_m for r_e = 8: sign, exponent, then mantissa from the top),
// each (K/8, N) uint8; byte (r, n) of the plane of bit b holds bit b of
// W[8r..8r+7, n], the first row in the MSB.  Fetched slot i is bit 15 - i
// and lies at planes + i * plane_stride (the stride may be negative, so
// the caller can hand the stack's own planes 16 - P..15 in place, without
// a copy).  Only the fetched planes are read, so the bytes moved scale
// with the view.  The plane combine, the guard round to nearest even
// (view_round.cuh) and the bitcast to bf16 run in registers, fused ahead
// of the product, as in the TPU kernel.
//
// Bound on this card: at decode sizes (M of 1 to 16) memory: the fetched
// planes, P / 8 bytes per weight, dominate and the product needs only
// 2 M operations per weight.  Rebuilding the weights bit by bit costs
// ~4 P instructions a weight, more than the bytes' time, so:
//
// Design:
// - Loads: a thread owns 4 neighbouring columns and loads one uint32 of
//   a plane row per plane (8 threads cover a 32-byte run of a row, a
//   warp 4 rows).  Its rows' words go out two rows ahead of the math, so
//   at the MLP's K every load of the kernel is in flight at once.
// - Combine by transpose: for each column the 16 plane bytes are a 16 x 8
//   bit matrix (planes x rows).  __byte_perm gathers a column's bytes of
//   8 planes into a 64-bit word (two uint32 halves), three delta swaps
//   transpose it 8 x 8, and the high-plane and low-plane results pair
//   into bf16 words with one __byte_perm per two weights.  P is a
//   template parameter: absent planes are zero bytes the compiler folds.
// - Parallelism: a block of 4 warps covers 32 columns and 16 byte rows
//   at a time; a thread block cluster of 3 blocks splits K, so the grid
//   has ~450 blocks at N = 4864, all resident at once.  The cluster's
//   partial sums meet in its first block through distributed shared
//   memory, in a fixed order, with no atomics.
// - M = 1: f32 FMA on CUDA cores, x staged in shared memory as f32 (64
//   byte rows at a time) and read as broadcasts; the 4 row slices of a
//   warp are summed by shuffles, the warps through shared memory.
// - M > 1: the product on the tensor cores, mma.sync m16n8k16 (bf16 in,
//   f32 sums) on 16 rows of x at a time: the rebuilt weights go to
//   shared memory as bf16, 16 byte rows x 32 columns a round, and both
//   operands reach the tensor cores through ldmatrix.  (At 16 rows the
//   CUDA-core version spent 16 FMAs a weight and ran at twice the time
//   of M = 1; wgmma's 64-row tiles would be 75 % padding.  At M = 1 this
//   kernel takes 10.5 us against the CUDA-core kernel's 7.5 on an H100,
//   chip_variants.py, so both are kept.)
// The guard round is a template parameter: as a runtime branch it cost
// the unrounded views 17 % (chip_variants.py).
// bf16 x bf16 products are exact in f32; only the order (and, in the
// tensor cores, the width) of the f32 sums differs from a cuBLAS product.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "view_round.cuh"

namespace {

constexpr int kGroupCols = 4;                  // columns per thread
constexpr int kLaneGroups = 8;                 // column groups per warp
constexpr int kCols = kGroupCols * kLaneGroups;   // columns per block
constexpr int kLaneRows = 4;                   // byte rows per warp at once
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSlices = kLaneRows * kWarps;    // byte rows a block takes
                                               // at once
constexpr int kChunkRows = 64;                 // byte rows of x staged

constexpr int kSplit = 3;                      // blocks of a cluster on K

// Bytes n0..n0+3 of a plane row, byte c in bits 8c..8c+7 (zero past N).
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ p,
                                          int rem, bool vec) {
  if (vec) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t w = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (c < rem) w |= static_cast<uint32_t>(p[c]) << (8 * c);
  return w;
}

template <int P>
__device__ __forceinline__ void load_words(
    const uint8_t* __restrict__ planes, long long plane_stride, long long r,
    int N, int n0, bool vec, uint32_t (&w)[P]) {
  const uint8_t* p = planes + r * N + n0;
#pragma unroll
  for (int i = 0; i < P; ++i) w[i] = load4(p + i * plane_stride, N - n0, vec);
}

// 4 x 4 byte transpose: o[c] = a0.c << 24 | a1.c << 16 | a2.c << 8 | a3.c,
// where a.c is byte c of a.
__device__ __forceinline__ void gather4(uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t (&o)[4]) {
  const uint32_t p = __byte_perm(a3, a2, 0x5140);   // a3.0 a2.0 a3.1 a2.1
  const uint32_t q = __byte_perm(a3, a2, 0x7362);   // a3.2 a2.2 a3.3 a2.3
  const uint32_t r = __byte_perm(a1, a0, 0x5140);
  const uint32_t s = __byte_perm(a1, a0, 0x7362);
  o[0] = __byte_perm(p, r, 0x5410);
  o[1] = __byte_perm(p, r, 0x7632);
  o[2] = __byte_perm(q, s, 0x5410);
  o[3] = __byte_perm(q, s, 0x7632);
}

// 8 x 8 bit-matrix transpose of the 64-bit word (x, y) by delta swaps
// (Hacker's Delight, transpose8rS32): byte i of the input (x's MSB first,
// then y's) is row i, bit 7 - j its column j; byte j of the output holds
// column j.
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

// A pair of bf16 patterns (weights of rows 2i, 2i + 1 in the low and high
// half) at the view: guard-rounded, then only the kept planes.
template <bool ROUND>
__device__ __forceinline__ uint32_t at_view(uint32_t u, uint32_t keep,
                                            int cut) {
  if (ROUND)
    return view_round(u & 0xFFFFu, keep, cut, true) |
           (view_round(u >> 16, keep, cut, true) << 16);
  return u & (keep | (keep << 16));
}

// The 8 x 4 weights of one byte row and this thread's 4 columns as bf16
// pairs: wp[c][i] holds W[8r + 2i, n0 + c] (low half) and W[8r + 2i + 1,
// n0 + c].  w[i] holds the plane of bit 15 - i.
template <int P, bool ROUND>
__device__ __forceinline__ void rebuild(const uint32_t (&w)[P], uint32_t keep,
                                        int cut,
                                        uint32_t (&wp)[kGroupCols][4]) {
  auto slot = [&](int i) -> uint32_t { return i < P ? w[i < P ? i : 0] : 0u; };
  uint32_t xh[4], yh[4], xl[4], yl[4];
  gather4(slot(0), slot(1), slot(2), slot(3), xh);      // bits 15..12
  gather4(slot(4), slot(5), slot(6), slot(7), yh);      // bits 11..8
  gather4(slot(8), slot(9), slot(10), slot(11), xl);    // bits 7..4
  gather4(slot(12), slot(13), slot(14), slot(15), yl);  // bits 3..0
#pragma unroll
  for (int c = 0; c < kGroupCols; ++c) {
    transpose8(xh[c], yh[c]);    // byte 3 - j of x (7 - j of y): row j
    transpose8(xl[c], yl[c]);
    // pair row j's high and low byte: rows 0, 1 | 2, 3 | 4, 5 | 6, 7
    wp[c][0] = at_view<ROUND>(__byte_perm(xl[c], xh[c], 0x6273), keep, cut);
    wp[c][1] = at_view<ROUND>(__byte_perm(xl[c], xh[c], 0x4051), keep, cut);
    wp[c][2] = at_view<ROUND>(__byte_perm(yl[c], yh[c], 0x6273), keep, cut);
    wp[c][3] = at_view<ROUND>(__byte_perm(yl[c], yh[c], 0x4051), keep, cut);
  }
}

// M = 1: acc[c] += x[8r..8r+7] . W[8r..8r+7, n0 + c] on CUDA cores.
template <int P, bool ROUND>
__device__ __forceinline__ void row_product(const uint32_t (&w)[P],
                                            const float* __restrict__ xk,
                                            uint32_t keep, int cut,
                                            float (&acc)[kGroupCols]) {
  uint32_t wp[kGroupCols][4];
  rebuild<P, ROUND>(w, keep, cut, wp);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x0 = xk[2 * i], x1 = xk[2 * i + 1];
#pragma unroll
    for (int c = 0; c < kGroupCols; ++c) {
      acc[c] = fmaf(x0, __uint_as_float(wp[c][i] << 16), acc[c]);
      acc[c] = fmaf(x1, __uint_as_float(wp[c][i] & 0xFFFF0000u), acc[c]);
    }
  }
}

template <int P, bool ROUND>
__global__ void __launch_bounds__(kThreads, 4)
elastic_matmul_m1(const uint16_t* __restrict__ x,
                  const uint8_t* __restrict__ planes, long long plane_stride,
                  float* __restrict__ out, int K, int N, uint32_t keep,
                  int cut, bool vec) {
  namespace cg = cooperative_groups;
  __shared__ __align__(16) float xs[kChunkRows * 8];
  __shared__ float part[kWarps][kCols];
  __shared__ float red[kCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg_ = lane % kLaneGroups, lr = lane / kLaneGroups;
  const int slice = warp * kLaneRows + lr;
  const int n0 = blockIdx.x * kCols + cg_ * kGroupCols;
  const int K8 = K / 8;
  const bool cols = n0 < N;
  // this block's byte rows: its part of K among the cluster's kSplit
  const int per = (K8 + kSplit - 1) / kSplit;
  const int r_begin = min(K8, static_cast<int>(blockIdx.y) * per);
  const int r_end = min(K8, r_begin + per);

  float acc[kGroupCols] = {0.f, 0.f, 0.f, 0.f};
  for (int c0 = r_begin; c0 < r_end; c0 += kChunkRows) {
    const int ce = min(r_end, c0 + kChunkRows);
    // this thread's rows c0 + slice + kSlices * i: the first two in flight
    // before x is staged, the rest two ahead of the math
    uint32_t wa[P], wb[P];
    int r = c0 + slice;
    if (cols && r < ce)
      load_words<P>(planes, plane_stride, r, N, n0, vec, wa);
    if (cols && r + kSlices < ce)
      load_words<P>(planes, plane_stride, r + kSlices, N, n0, vec, wb);
    __syncthreads();                      // the last chunk's x reads are done
    // x: one 16-byte load (8 values) a byte row, several in flight
#pragma unroll 4
    for (int kg = threadIdx.x; kg < ce - c0; kg += kThreads) {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(x + (long long)(c0 + kg) * 8);
      const uint32_t h[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xs[kg * 8 + 2 * e] = __uint_as_float(h[e] << 16);
        xs[kg * 8 + 2 * e + 1] = __uint_as_float(h[e] & 0xFFFF0000u);
      }
    }
    __syncthreads();
    if (!cols) continue;
    for (; r < ce; r += 2 * kSlices) {
      row_product<P, ROUND>(wa, xs + (r - c0) * 8, keep, cut, acc);
      if (r + 2 * kSlices < ce)
        load_words<P>(planes, plane_stride, r + 2 * kSlices, N, n0, vec, wa);
      if (r + kSlices < ce) {
        row_product<P, ROUND>(wb, xs + (r + kSlices - c0) * 8, keep, cut,
                              acc);
        if (r + 3 * kSlices < ce)
          load_words<P>(planes, plane_stride, r + 3 * kSlices, N, n0, vec,
                        wb);
      }
    }
  }

  // the 4 row slices of a warp's column group (lanes 8 and 16 apart), then
  // the warps, then the cluster's blocks: each in a fixed order
#pragma unroll
  for (int c = 0; c < kGroupCols; ++c) {
    float v = acc[c];
    v += __shfl_xor_sync(0xffffffffu, v, 8);
    v += __shfl_xor_sync(0xffffffffu, v, 16);
    if (lr == 0) part[warp][cg_ * kGroupCols + c] = v;
  }
  __syncthreads();
  for (int col = threadIdx.x; col < kCols; col += kThreads) {
    float s = part[0][col];
#pragma unroll
    for (int v = 1; v < kWarps; ++v) s += part[v][col];
    red[col] = s;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                         // every block's sums are in place
  if (cluster.block_rank() == 0) {
    for (int col = threadIdx.x; col < kCols; col += kThreads) {
      const int n = blockIdx.x * kCols + col;
      float s = red[col];
#pragma unroll
      for (int b = 1; b < kSplit; ++b)
        s += cluster.map_shared_rank(red, b)[col];
      if (n < N) out[n] = s;
    }
  }
  cluster.sync();                         // keep red alive until it is read
}

// M > 1: the product on the tensor cores.  Each thread rebuilds its byte
// row's 8 x 4 weights as bf16 (as above, without the f32 step) into a
// shared tile Ws[n][k] of 16 byte rows (128 k) x 32 columns; then warp w
// multiplies x (16 rows of this block's tile, bf16 in shared memory) by
// columns 8w..8w+7 with mma.sync m16n8k16 (bf16 in, f32 sums), fragments
// read with ldmatrix.  The bf16 products are exact, the sums are f32.
constexpr int kRound = kSlices;                // byte rows a round
constexpr int kWsPitch = kRound * 16 + 16;     // bytes per Ws row (n)
constexpr int kXsPitch = kChunkRows * 16 + 16; // bytes per x row (m)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int P, bool ROUND>
__global__ void __launch_bounds__(kThreads)
elastic_matmul_mma(const uint16_t* __restrict__ x,
                   const uint8_t* __restrict__ planes, long long plane_stride,
                   float* __restrict__ out, int M, int K, int N,
                   uint32_t keep, int cut, bool vec) {
  namespace cg = cooperative_groups;
  __shared__ __align__(16) uint8_t xs[16 * kXsPitch];        // bf16 [m][k]
  __shared__ __align__(16) uint8_t ws[kCols * kWsPitch];     // bf16 [n][k]
  __shared__ float red[16][kCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cg_ = lane % kLaneGroups, lr = lane / kLaneGroups;
  const int slice = warp * kLaneRows + lr;
  const int n0 = blockIdx.x * kCols + cg_ * kGroupCols;
  const int m0 = blockIdx.z * 16;
  const int K8 = K / 8;
  const bool cols = n0 < N;
  const int per = (K8 + kSplit - 1) / kSplit;
  const int r_begin = min(K8, static_cast<int>(blockIdx.y) * per);
  const int r_end = min(K8, r_begin + per);
  float c[4] = {0.f, 0.f, 0.f, 0.f};            // m g, g + 8; n 2t, 2t + 1

  for (int c0 = r_begin; c0 < r_end; c0 += kChunkRows) {
    const int ce = min(r_end, c0 + kChunkRows);
    uint32_t wa[P], wb[P];
    const int r = c0 + slice;
    if (cols && r < ce)
      load_words<P>(planes, plane_stride, r, N, n0, vec, wa);
    if (cols && r + kRound < ce)
      load_words<P>(planes, plane_stride, r + kRound, N, n0, vec, wb);
    __syncthreads();                      // the last chunk's x reads are done
    // x rows m0..m0 + 15 of byte rows c0..ce as stored (zero past M, and
    // past ce up to whole rounds)
    const int rows = (ce - c0 + kRound - 1) / kRound * kRound;
#pragma unroll 4
    for (int i = threadIdx.x; i < 16 * rows; i += kThreads) {
      const int m = i / rows, kg = i % rows;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + m < M && c0 + kg < ce)
        raw = *reinterpret_cast<const uint4*>(
            x + (long long)(m0 + m) * K + (c0 + kg) * 8);
      *reinterpret_cast<uint4*>(xs + m * kXsPitch + kg * 16) = raw;
    }
    // rounds of 16 byte rows; this thread's rows two rounds ahead in flight
#pragma unroll
    for (int rd = 0; rd < kChunkRows / kRound; ++rd) {
      const int rb = c0 + rd * kRound;
      if (rb >= ce) break;
      uint32_t (&w)[P] = rd & 1 ? wb : wa;
      // this thread's byte row of the round into Ws (zero past ce / N)
      uint32_t wp[kGroupCols][4] = {};
      if (cols && rb + slice < ce) rebuild<P, ROUND>(w, keep, cut, wp);
#pragma unroll
      for (int q = 0; q < kGroupCols; ++q)
        *reinterpret_cast<uint4*>(ws + (cg_ * kGroupCols + q) * kWsPitch +
                                  slice * 16) =
            make_uint4(wp[q][0], wp[q][1], wp[q][2], wp[q][3]);
      if (cols && rb + 2 * kRound + slice < ce)
        load_words<P>(planes, plane_stride, rb + 2 * kRound + slice, N, n0,
                      vec, w);
      __syncthreads();
      // warp w: columns 8w..8w+7, the round's 8 k-steps of 16
#pragma unroll
      for (int ks = 0; ks < kRound / 2; ++ks) {
        uint32_t a[4], b[2];
        const int kb = (rb - c0) * 16 + ks * 32;          // byte offset
        const uint32_t xa = smem_u32(
            xs + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kXsPitch + kb +
            16 * (lane >> 4));
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(xa));
        const uint32_t wsa = smem_u32(
            ws + (warp * 8 + (lane & 7)) * kWsPitch + ks * 32 +
            16 * ((lane >> 3) & 1));
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
            : "=r"(b[0]), "=r"(b[1]) : "r"(wsa));
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      }
      __syncthreads();                    // Ws is rewritten next round
    }
  }

  // each warp owns its 8 columns; the cluster's 2 blocks are summed by
  // the first through distributed shared memory
  const int g = lane >> 2, t = lane & 3;
  red[g][warp * 8 + 2 * t] = c[0];
  red[g][warp * 8 + 2 * t + 1] = c[1];
  red[g + 8][warp * 8 + 2 * t] = c[2];
  red[g + 8][warp * 8 + 2 * t + 1] = c[3];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int i = threadIdx.x; i < 16 * kCols; i += kThreads) {
      const int m = i / kCols, col = i % kCols;
      const int n = blockIdx.x * kCols + col;
      float s = red[m][col];
#pragma unroll
      for (int bk = 1; bk < kSplit; ++bk)
        s += cluster.map_shared_rank(&red[0][0], bk)[i];
      if (m0 + m < M && n < N) out[(long long)(m0 + m) * N + n] = s;
    }
  }
  cluster.sync();
}

struct Args {
  const uint16_t* x;
  const uint8_t* planes;
  long long plane_stride;
  float* out;
  int M, K, N;
  uint32_t keep;
  int cut;
  bool vec;
  cudaStream_t stream;
};

// One launch: a cluster of kSplit blocks along y splits K.
template <int P, bool ROUND>
cudaError_t launch(const Args& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.N + kCols - 1) / kCols, kSplit, (a.M + 15) / 16);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = kSplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (a.M == 1)
    return cudaLaunchKernelEx(&cfg, elastic_matmul_m1<P, ROUND>, a.x,
                              a.planes, a.plane_stride, a.out, a.K, a.N,
                              a.keep, a.cut, a.vec);
  return cudaLaunchKernelEx(&cfg, elastic_matmul_mma<P, ROUND>, a.x,
                            a.planes, a.plane_stride, a.out, a.M, a.K, a.N,
                            a.keep, a.cut, a.vec);
}

template <int P>
cudaError_t launch_p(const Args& a, bool do_round) {
  return do_round ? launch<P, true>(a) : launch<P, false>(a);
}

}  // namespace

// x: M x K bf16 (row-major, 16-byte aligned); planes: slot i (the plane of
// bit 15 - i, i < nplanes) a (K / 8) x N uint8 array at planes + i *
// plane_stride bytes; out: M x N f32.  9 <= nplanes <= 16.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int elastic_matmul(const void* x, const void* planes,
                              long long plane_stride, void* out, int M, int K,
                              int N, int nplanes, int keep, int cut,
                              int do_round, int device, void* stream) {
  if (M < 0 || K < 0 || N < 0 || K % 8 != 0 || nplanes < 9 || nplanes > 16 ||
      (do_round && (cut < 1 || cut > 7)) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M == 0 || N == 0) return 0;
  const bool vec = N % 4 == 0 && plane_stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(planes) % 4 == 0;
  const Args a{static_cast<const uint16_t*>(x),
               static_cast<const uint8_t*>(planes), plane_stride,
               static_cast<float*>(out), M, K, N,
               static_cast<uint32_t>(keep), cut, vec,
               static_cast<cudaStream_t>(stream)};
  const bool r = do_round != 0;
  switch (nplanes) {
    case 9: return static_cast<int>(launch_p<9>(a, r));
    case 10: return static_cast<int>(launch_p<10>(a, r));
    case 11: return static_cast<int>(launch_p<11>(a, r));
    case 12: return static_cast<int>(launch_p<12>(a, r));
    case 13: return static_cast<int>(launch_p<13>(a, r));
    case 14: return static_cast<int>(launch_p<14>(a, r));
    case 15: return static_cast<int>(launch_p<15>(a, r));
    default: return static_cast<int>(launch_p<16>(a, r));
  }
}
