// PNM page scoring for Hopper (sm_90a): for each candidate page p,
//   score[p] = max over rows t < valid[p] of <row[p, t], digest>   (f32)
//   score[p] = -inf when valid[p] == 0
// over (P, T, C) bf16 bit patterns (uint16), a (P,) int32 valid count and
// a (C,) f32 digest.
//
// Replaces the TPU kernel src/repro/kernels/pnm_score.py::_score_kernel
// (page_scores_pallas), which the tier's PNM gather calls once per
// GatherReq to rank every spilled candidate page.
//
// Bound on this card: memory.  The kernel reads each valid row once
// (2 B per element, the bf16 patterns as stored; the TPU kernel took a
// padded f32 copy, twice the bytes) and does 2 flops per element, far
// below the ~20 flops per byte at which the H100's f32 rate would become
// the limit.
//
// Design: one block per page, the digest in shared memory, one warp per
// row (rows t = warp, warp + 8, ...), and a per-page max over the warps.
// What the design holds to:
// * a page's score is bitwise the same in any batch: each row's dot is
//   summed in one fixed order that depends on C alone (products rounded
//   once, then a halving tree over C padded with zeros to a power of two
//   of at least 32: within a lane first, then across the warp's lanes),
//   rows past valid[p] are never read, and no atomics are used.  The
//   plain version in kernels/pnm_score.py sums in exactly this order, so
//   the two agree bit for bit.  __fmul_rn / __fadd_rn keep the compiler
//   from contracting a product and a sum into one FMA;
// * NaN propagates through the max, as np.max and jnp.max propagate it
//   (fmaxf would drop it): inf * 0 in a dot gives NaN, and topk_select
//   then ranks the page last;
// * -inf for a page with no valid row.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChannels = 1024;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// M: values per lane, the padded channel count over 32 (a power of two).
template <int M>
__global__ void __launch_bounds__(kThreads)
pnm_score_kernel(const uint16_t* __restrict__ pages,
                 const int* __restrict__ valid,
                 const float* __restrict__ digest,
                 float* __restrict__ out, int T, int C) {
  __shared__ float dig[32 * M];
  __shared__ float wmax[kWarps];
  const int p = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int c = threadIdx.x; c < 32 * M; c += kThreads)
    dig[c] = c < C ? digest[c] : 0.f;
  __syncthreads();

  const int n = min(max(valid[p], 0), T);
  const uint16_t* page = pages + (long long)p * T * C;
  float run = -__int_as_float(0x7f800000);      // -inf
  for (int t = warp; t < n; t += kWarps) {
    const uint16_t* row = page + (long long)t * C;
    float v[M];
#pragma unroll
    for (int j = 0; j < M; ++j) {
      const int c = lane + 32 * j;
      v[j] = c < C ? __fmul_rn(__uint_as_float((uint32_t)row[c] << 16),
                               dig[c])
                   : 0.f;
    }
#pragma unroll
    for (int h = M / 2; h >= 1; h /= 2) {
#pragma unroll
      for (int j = 0; j < h; ++j) v[j] = __fadd_rn(v[j], v[j + h]);
    }
    float s = v[0];
#pragma unroll
    for (int off = 16; off >= 1; off /= 2)
      s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    run = nan_max(run, s);                       // lane 0's s is the dot
  }
  if (lane == 0) wmax[warp] = run;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = wmax[0];
    for (int w = 1; w < kWarps; ++w) m = nan_max(m, wmax[w]);
    out[p] = m;
  }
}

}  // namespace

// pages: P*T*C uint16 (bf16 patterns); valid: P int32; digest: C f32;
// out: P f32.  Returns the cudaError_t of the launch (0 on success).
extern "C" int pnm_score(const void* pages, const void* valid,
                         const void* digest, void* out, int P, int T, int C,
                         int device, void* stream) {
  if (P < 0 || T < 1 || C < 1 || C > kMaxChannels)
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (P == 0) return 0;
  int cp = 32;
  while (cp < C) cp *= 2;
  const auto* x = static_cast<const uint16_t*>(pages);
  const auto* vl = static_cast<const int*>(valid);
  const auto* dg = static_cast<const float*>(digest);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (cp / 32) {
    case 1: pnm_score_kernel<1><<<P, kThreads, 0, s>>>(x, vl, dg, o, T, C); break;
    case 2: pnm_score_kernel<2><<<P, kThreads, 0, s>>>(x, vl, dg, o, T, C); break;
    case 4: pnm_score_kernel<4><<<P, kThreads, 0, s>>>(x, vl, dg, o, T, C); break;
    case 8: pnm_score_kernel<8><<<P, kThreads, 0, s>>>(x, vl, dg, o, T, C); break;
    case 16: pnm_score_kernel<16><<<P, kThreads, 0, s>>>(x, vl, dg, o, T, C); break;
    case 32: pnm_score_kernel<32><<<P, kThreads, 0, s>>>(x, vl, dg, o, T, C); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
