// Elastic-precision dequant matmul for Hopper (sm_90a):
//   out (M, N) f32 = x (M, K) bf16 @ W (K, N), W rebuilt from its fetched
//   K-packed bit-planes at a precision view.
//
// Replaces the TPU kernel src/repro/kernels/elastic_matmul.py::_kernel
// (elastic_matmul_pallas).  Input planes: (P_f, K/8, N) uint8, only the
// planes the view fetches (the wrapper slices them before the launch, so
// the bytes read scale with the view); byte (r, n) of plane p holds bit p
// of W[8r..8r+7, n], the first row in the MSB.  The plane combine, the
// guard round to nearest even (view_round.cuh) and the bitcast to bf16
// run in registers, fused ahead of the product, as in the TPU kernel.
//
// Bound on this card: at decode sizes (M of 1 to 16) memory: the fetched
// planes, P_f / 8 bytes per weight, dominate and the product needs only
// 2 M operations per weight.  (The tensor cores would be the limit only
// near M = 300.)
//
// Design (simple first: CUDA cores, f32 FMA): a block covers 32 columns
// and BM rows of x; its 8 warps split K, each warp walking a quarter of
// every 256-deep chunk, one lane per column.  A lane reads one byte of
// each fetched plane for its column (a warp reads one 32-byte run per
// plane row), rebuilds 8 weights in registers and multiplies them into
// BM f32 sums against the x chunk held in shared memory (a broadcast
// read).  The 8 partial sums of a column are added in a fixed order at
// the end, so the result does not depend on scheduling.  bf16 x bf16
// products are exact in f32, so FMA and multiply-then-add agree; only the
// order of the sum differs from a cuBLAS product.
#include <cuda_runtime.h>
#include <stdint.h>

#include "view_round.cuh"

namespace {

constexpr int kCols = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kCols * kWarps;
constexpr int kChunk = 256;                  // K rows per shared x chunk
constexpr int kChunkBytes = kChunk / 8;      // byte rows per chunk
constexpr int kSliceBytes = kChunkBytes / kWarps;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t u) {
  return __uint_as_float(u << 16);
}

template <int BM>
__global__ void __launch_bounds__(kThreads)
elastic_matmul_kernel(const uint16_t* __restrict__ x,
                      const uint8_t* __restrict__ planes,
                      float* __restrict__ out, int M, int K, int N,
                      int nplanes, unsigned long long plane_code,
                      uint32_t keep, int cut, bool do_round) {
  __shared__ float xs[BM][kChunk];
  __shared__ float part[kWarps][BM][kCols];
  const int lane = threadIdx.x % kCols, warp = threadIdx.x / kCols;
  const int n = blockIdx.x * kCols + lane;
  const int m0 = blockIdx.y * BM;
  const long long K8 = K / 8;
  float acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kChunk) {
    for (int i = threadIdx.x; i < BM * kChunk; i += kThreads) {
      const int m = i / kChunk, k = k0 + i % kChunk;
      xs[m][i % kChunk] = (m0 + m < M && k < K)
          ? bf16_bits_to_float(x[(long long)(m0 + m) * K + k]) : 0.f;
    }
    __syncthreads();
    if (n < N) {
      for (int s = 0; s < kSliceBytes; ++s) {
        const int kb = warp * kSliceBytes + s;       // byte row in chunk
        const long long r = k0 / 8 + kb;
        if (r >= K8) break;
        uint32_t e[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        for (int i = 0; i < nplanes; ++i) {
          const int p = static_cast<int>((plane_code >> (4 * i)) & 15ull);
          const uint32_t byte = planes[(i * K8 + r) * N + n];
#pragma unroll
          for (int j = 0; j < 8; ++j) e[j] |= ((byte >> (7 - j)) & 1u) << p;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float w = bf16_bits_to_float(view_round(e[j], keep, cut,
                                                        do_round));
#pragma unroll
          for (int m = 0; m < BM; ++m)
            acc[m] = fmaf(xs[m][kb * 8 + j], w, acc[m]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < BM; ++m) part[warp][m][lane] = acc[m];
  __syncthreads();
  for (int i = threadIdx.x; i < BM * kCols; i += kThreads) {
    const int m = i / kCols, col = i % kCols;
    const int nn = blockIdx.x * kCols + col;
    if (m0 + m < M && nn < N) {
      float s = part[0][m][col];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += part[w][m][col];
      out[(long long)(m0 + m) * N + nn] = s;
    }
  }
}

}  // namespace

// x: M x K bf16 (row-major); planes: nplanes x (K / 8) x N uint8; out:
// M x N f32.  Returns the cudaError_t of the launch (0 on success).
extern "C" int elastic_matmul(const void* x, const void* planes, void* out,
                              int M, int K, int N, int nplanes,
                              unsigned long long plane_code, int keep, int cut,
                              int do_round, int device, void* stream) {
  if (M < 0 || K < 0 || N < 0 || K % 8 != 0 || nplanes < 0 || nplanes > 16 ||
      (do_round && (cut < 1 || cut > 7)))
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const uint16_t*>(x);
  const auto* pp = static_cast<const uint8_t*>(planes);
  auto* op = static_cast<float*>(out);
  const unsigned gx = (N + kCols - 1) / kCols;
  if (M == 1) {
    elastic_matmul_kernel<1><<<dim3(gx, 1), kThreads, 0, s>>>(
        xp, pp, op, M, K, N, nplanes, plane_code,
        static_cast<uint32_t>(keep), cut, do_round != 0);
  } else {
    elastic_matmul_kernel<16><<<dim3(gx, (M + 15) / 16), kThreads, 0, s>>>(
        xp, pp, op, M, K, N, nplanes, plane_code,
        static_cast<uint32_t>(keep), cut, do_round != 0);
  }
  return static_cast<int>(cudaGetLastError());
}
