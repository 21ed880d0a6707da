// Bit-plane unpack for Hopper (sm_90a), standalone and fused with the KV
// exponent-delta inverse.
//
// Replaces the TPU kernel src/repro/kernels/bitplane.py::_unpack_kernel
// (unpack_planes_pallas / ops.elastic_unpack) and, on the tier's KV read
// path, the chain _unpack_kernel -> kv_delta.py::_inv_kernel -> round
// that core/tier.py ran as two launches with the slab's words between
// them in device memory.  Input: P_f rows of `nbytes` bytes, row i the
// packed stream of plane plane_id[i] (plane ids packed four bits each
// into `plane_code`); planes not fetched read as zero, as
// core/bitplane.py::unpack_planes_subset computes.  Byte j of a row holds
// bit p of elements 8j..8j+7, the first element in the MSB.
//
// - unpack_planes_u16: rows -> flat uint16 words, optionally rounded to a
//   precision view (view_round.cuh); the tier's non-KV blocks and the
//   kernel API.
// - unpack_kv_windows: the member windows of one (n, C) group of a
//   readback slab -> (B, n, C) token-major words, each window unpacked
//   from its first element starts[b] in the rows (no gather of members),
//   its exponent deltas inverted with beta (B, C) and rounded to the view
//   after the inverse (kv_read.cuh, shared with kv_delta.cu's inverse).
//   The starts travel in the launch's parameters (up to kMaxWindows a
//   launch), so no thread waits on a load before its plane loads.
//
// Bound on this card: memory, P_f / 8 bytes read and 2 bytes written per
// element, and far fewer operations than the card's rate.  At the tier's
// sizes (64 Ki elements a slab) both kernels take little more than a
// launch: what the design attacks is latency.  P_f is a template
// parameter (1..16, every plane count a view fetches), so a thread issues
// all its P_f byte loads before the first is used; one launch per group
// replaces two launches and the round trip of the slab through device
// memory; and the work is spread thin (many small blocks, few words a
// thread), because a thread's chain of dependent operations, not the
// bytes, sets the time.
//
// Design: standalone, a thread owns one byte column, i.e. 8 elements: it
// reads one byte of each fetched plane (neighbouring threads read
// neighbouring bytes of a row), assembles the 8 words in registers,
// rounds them and writes them as one 16-byte store.  Fused: a block owns
// one window x kTileChannels channels x kTileTokens tokens, thread
// (ci, g) channel c0 + ci and kTokensPerThread tokens from K g, the
// channel's bits of a plane at bit address starts[b] + c * n + t.  When
// n is a multiple of 8 they lie in one byte per plane (two threads share
// it); otherwise channel boundaries fall inside a byte and a thread may
// read the two bytes its bits straddle.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "kv_read.cuh"
#include "view_round.cuh"

namespace {

// Block sizes from chip_variants.py's sweep (PERF.md §6).
constexpr int kUnpackThreads = 128;
constexpr int kTileChannels = 8;
constexpr int kTokensPerThread = 2;
constexpr int kKvThreads = kTileChannels * (kTileTokens / kTokensPerThread);
constexpr int kMaxWindows = 256;         // windows a fused launch takes

struct WindowStarts {
  uint32_t s[kMaxWindows];
};

// K (<= 8) words of one byte column: for each of the P fetched rows (row
// i at col + i * stride, plane (plane_code >> 4i) & 15) the K bits at bit
// offset `sh` of the column's byte (and of the next byte when `two`).
template <int P, int K>
__device__ __forceinline__ void column_words(const uint8_t* __restrict__ col,
                                             long long stride,
                                             unsigned long long plane_code,
                                             int sh, bool two,
                                             uint32_t (&e)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) e[k] = 0u;
#pragma unroll  // every plane's load in flight at once
  for (int i = 0; i < P; ++i) {
    uint32_t w = static_cast<uint32_t>(col[i * stride]) << 8;
    if (two) w |= col[i * stride + 1];
    const uint32_t byte = (w >> (8 - sh)) & 0xFFu;
    const uint32_t p = static_cast<uint32_t>((plane_code >> (4 * i)) & 15ull);
#pragma unroll
    for (int k = 0; k < K; ++k) e[k] |= ((byte >> (7 - k)) & 1u) << p;
  }
}

template <int P>
__global__ void __launch_bounds__(kUnpackThreads)
unpack_kernel(const uint8_t* __restrict__ rows, uint4* __restrict__ out,
              long long nbytes, unsigned long long plane_code, uint32_t keep,
              int cut, bool do_round) {
  const long long j = blockIdx.x * (long long)kUnpackThreads + threadIdx.x;
  if (j >= nbytes) return;
  uint32_t e[8];
  column_words<P, 8>(rows + j, nbytes, plane_code, 0, false, e);
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)            // little-endian: element 2k is low
    w[k] = view_round(e[2 * k], keep, cut, do_round) |
           (view_round(e[2 * k + 1], keep, cut, do_round) << 16);
  out[j] = make_uint4(w[0], w[1], w[2], w[3]);
}

template <int P>
__global__ void __launch_bounds__(kKvThreads)
kv_read_kernel(const uint8_t* __restrict__ rows, long long nbytes,
               unsigned long long plane_code,
               const __grid_constant__ WindowStarts starts,
               const uint8_t* __restrict__ beta, uint16_t* __restrict__ out,
               int n, int C, uint32_t keep, int cut, bool do_round,
               bool pairs) {
  constexpr int TC = kTileChannels, K = kTokensPerThread;
  constexpr int G = kTileTokens / K;       // token groups of a channel
  __shared__ KvTile<TC> tile;
  const int g = threadIdx.x % G, ci = threadIdx.x / G;
  const int c0 = blockIdx.x * TC, t0 = blockIdx.y * kTileTokens;
  const int b = blockIdx.z, c = c0 + ci;
  const int tt = min(kTileTokens, n - t0), tc = min(TC, C - c0);
  const int cnt = min(K, tt - K * g);
  if (c < C && cnt > 0) {
    const long long bit = starts.s[b] + (long long)c * n + t0 + K * g;
    const int sh = static_cast<int>(bit & 7);
    uint32_t e[K];
    column_words<P, K>(rows + (bit >> 3), nbytes, plane_code, sh,
                       sh + cnt > 8, e);
    kv_tile_put<TC, K>(tile, ci, g, e, cnt, beta[(long long)b * C + c], keep,
                       cut, do_round);
  }
  __syncthreads();
  kv_tile_write<TC, kKvThreads>(tile, out + ((long long)b * n + t0) * C + c0,
                                tt, tc, C, pairs);
}

// f(std::integral_constant<int, P>) for P == nplanes, 1 <= P <= 16.
template <int P, class F>
cudaError_t with_planes(int nplanes, const F& f) {
  if (nplanes == P) return f(std::integral_constant<int, P>{});
  if constexpr (P < 16) return with_planes<P + 1>(nplanes, f);
  else return cudaErrorInvalidValue;
}

cudaError_t set_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// rows: nplanes x nbytes uint8 (row-major), 1 <= nplanes <= 16; out:
// 8 * nbytes uint16, 16-byte aligned.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int unpack_planes_u16(const void* rows, void* out, long long nbytes,
                                 int nplanes, unsigned long long plane_code,
                                 int keep, int cut, int do_round, int device,
                                 void* stream) {
  if (nplanes < 1 || nplanes > 16 || nbytes < 0 ||
      (do_round && (cut < 1 || cut > 7)) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nbytes == 0) return 0;
  const auto* r = static_cast<const uint8_t*>(rows);
  const unsigned blocks =
      static_cast<unsigned>((nbytes + kUnpackThreads - 1) / kUnpackThreads);
  return static_cast<int>(with_planes<1>(nplanes, [&](auto p) {
    unpack_kernel<decltype(p)::value>
        <<<blocks, kUnpackThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            r, static_cast<uint4*>(out), nbytes, plane_code,
            static_cast<uint32_t>(keep), cut, do_round != 0);
    return cudaGetLastError();
  }));
}

// rows: nplanes x nbytes uint8, 1 <= nplanes <= 16; starts: B int64 in
// host memory, B <= kMaxWindows, the first element of each window in the
// rows, a multiple of 8 below 2^32, with starts[b] + n * C <= 8 * nbytes;
// beta: B x C uint8; out: B x n x C uint16, token-major, rounded to the
// view (keep, cut, do_round).  Returns the cudaError_t of the launch (0
// on success).
extern "C" int unpack_kv_windows(const void* rows, long long nbytes,
                                 int nplanes, unsigned long long plane_code,
                                 const void* starts, const void* beta,
                                 void* out, int B, int n, int C, int keep,
                                 int cut, int do_round, int device,
                                 void* stream) {
  if (nplanes < 1 || nplanes > 16 || nbytes < 0 || B < 0 || n < 0 || C < 0 ||
      B > kMaxWindows || (n + kTileTokens - 1) / kTileTokens > 65535 ||
      (do_round && (cut < 1 || cut > 7)))
    return static_cast<int>(cudaErrorInvalidValue);
  WindowStarts ws{};
  for (int b = 0; b < B; ++b) {
    const long long s = static_cast<const long long*>(starts)[b];
    if (s < 0 || s % 8 != 0 || s > 0xFFFFFFFFll ||
        s + static_cast<long long>(n) * C > 8 * nbytes)
      return static_cast<int>(cudaErrorInvalidValue);
    ws.s[b] = static_cast<uint32_t>(s);
  }
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || n == 0 || C == 0) return 0;
  const bool pairs = C % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const dim3 grid((C + kTileChannels - 1) / kTileChannels,
                  (n + kTileTokens - 1) / kTileTokens, B);
  return static_cast<int>(with_planes<1>(nplanes, [&](auto p) {
    kv_read_kernel<decltype(p)::value>
        <<<grid, kKvThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(rows), nbytes, plane_code, ws,
            static_cast<const uint8_t*>(beta), static_cast<uint16_t*>(out), n,
            C, static_cast<uint32_t>(keep), cut, do_round != 0, pairs);
    return cudaGetLastError();
  }));
}
