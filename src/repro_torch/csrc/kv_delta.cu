// Cross-token KV exponent-delta transform for Hopper (sm_90a): forward and
// inverse over a batch of same-shape windows.
//
// Replaces the TPU kernels src/repro/kernels/kv_delta.py::_fwd_kernel and
// ::_inv_kernel (kv_delta_pallas / kv_delta_inv_pallas).
//
// Forward: x (B, n, C) uint16 token-major -> out (B, C, n) channel-major,
// each element's exponent replaced by zigzag((exp - beta[b, c]) mod 256),
// sign and mantissa kept.  With find_beta the kernel also computes beta,
// the modal exponent of each (window, channel) with ties to the smallest
// exponent, as np.bincount(...).argmax() does in core/kv_transform.py;
// otherwise it reads the given beta.  The TPU kernel took beta from a
// host pass; here the histogram lives in shared memory beside the tile.
//
// Inverse: cm (B, C, n) + beta -> out (B, n, C) token-major, exact for
// any beta, then rounded to a precision view (view_round.cuh).  The round
// runs after the inverse because its carry may move into the exponent,
// and Inf/NaN are recognisable only in the real-exponent domain.  The
// tier's KV read path does not come here: it unpacks, inverts and rounds
// in one launch (bitplane_unpack.cu); this is the kernel API's inverse
// (ops.kv_transform_inv), and both share the inverse + transpose + round
// stage of kv_read.cuh.
//
// Bound on this card: memory.  2 bytes read and 2 written per element
// (plus one beta byte per channel) and a few integer operations each.
//
// Design: the forward takes one block per (window, 32-channel tile) and
// walks all n tokens of its tile (the histogram needs every token of a
// channel); a 32 x 33 tile in shared memory turns its transpose into
// coalesced reads along one axis and coalesced writes along the other.
// Histogram bins are padded to 257 per channel, so the 32 channels of a
// warp, which usually share the modal exponent, fall into 32 different
// banks.  The inverse takes one block per (window, kTileChannels
// channels, kTileTokens tokens): thread (ci, g) reads kTokensPerThread
// tokens of one channel (one vector load when n is a multiple of it),
// and kv_read.cuh's stage inverts, rounds and writes the tile
// token-major.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_read.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;                 // thread rows of a 32 x 8 block
constexpr int kThreads = kTile * kRows;
constexpr int kBins = 257;               // 256 exponents + 1 bank pad
// The inverse's tile and a thread's tokens, from chip_variants.py's sweep
// (PERF.md §6): one word a thread keeps its dependent chain short.
constexpr int kTileChannels = 8;
constexpr int kTokensPerThread = 1;
constexpr int kInvThreads = kTileChannels * (kTileTokens / kTokensPerThread);

__device__ __forceinline__ uint32_t zigzag(uint32_t v, uint32_t beta) {
  const uint32_t d = (((v >> 7) & 0xFFu) - beta) & 0xFFu;   // mod 256
  const uint32_t z = d < 128u ? 2u * d : 511u - 2u * d;      // s<0: -2s-1
  return (v & 0x807Fu) | (z << 7);
}

__global__ void __launch_bounds__(kThreads)
kv_fwd_kernel(const uint16_t* __restrict__ x, uint16_t* __restrict__ out,
              uint8_t* __restrict__ beta, int n, int C, bool find_beta) {
  __shared__ int hist[kTile * kBins];
  __shared__ uint32_t sbeta[kTile];
  __shared__ uint32_t tile[kTile][kTile + 1];
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  const int c0 = blockIdx.x * kTile, b = blockIdx.y;
  const int c = c0 + tx;
  const uint16_t* xb = x + (long long)b * n * C;
  uint16_t* ob = out + (long long)b * C * n;

  if (find_beta) {
    for (int i = threadIdx.x; i < kTile * kBins; i += kThreads) hist[i] = 0;
    __syncthreads();
    if (c < C)
      for (int t = ty; t < n; t += kRows)
        atomicAdd(&hist[tx * kBins + ((xb[(long long)t * C + c] >> 7) & 0xFF)],
                  1);
    __syncthreads();
    // warp w finds the mode of channels w, w + 8, ...: lane l scans bins
    // 8l..8l+7, then the warp keeps the larger count, the smaller bin on
    // a tie
    const int lane = tx;
    for (int j = ty; j < kTile; j += kRows) {
      int best = -1, arg = 0;
      for (int e = lane * 8; e < lane * 8 + 8; ++e) {
        const int h = hist[j * kBins + e];
        if (h > best) { best = h; arg = e; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const int ob2 = __shfl_xor_sync(0xFFFFFFFFu, best, off);
        const int oa = __shfl_xor_sync(0xFFFFFFFFu, arg, off);
        if (ob2 > best || (ob2 == best && oa < arg)) { best = ob2; arg = oa; }
      }
      if (lane == 0) {
        sbeta[j] = static_cast<uint32_t>(arg);
        if (c0 + j < C) beta[(long long)b * C + c0 + j] = static_cast<uint8_t>(arg);
      }
    }
  } else if (ty == 0) {
    sbeta[tx] = c < C ? beta[(long long)b * C + c] : 0u;
  }
  __syncthreads();

  for (int t0 = 0; t0 < n; t0 += kTile) {
    for (int r = ty; r < kTile; r += kRows) {      // read along channels
      const int t = t0 + r;
      if (t < n && c < C)
        tile[r][tx] = zigzag(xb[(long long)t * C + c], sbeta[tx]);
    }
    __syncthreads();
    for (int r = ty; r < kTile; r += kRows) {      // write along tokens
      const int cc = c0 + r, t = t0 + tx;
      if (cc < C && t < n)
        ob[(long long)cc * n + t] = static_cast<uint16_t>(tile[tx][r]);
    }
    __syncthreads();
  }
}

// K consecutive words from one aligned load (K halfwords, K <= 8).
template <int K>
__device__ __forceinline__ void load_words(const uint16_t* src,
                                           uint32_t (&e)[K]) {
  static_assert(K == 1 || K == 2 || K == 4 || K == 8, "1, 2, 4 or 8 words");
  if constexpr (K == 1) {
    e[0] = src[0];
  } else {
    uint32_t h[K / 2];
    if constexpr (K == 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(src);
      h[0] = q.x, h[1] = q.y, h[2] = q.z, h[3] = q.w;
    } else if constexpr (K == 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(src);
      h[0] = q.x, h[1] = q.y;
    } else {
      h[0] = *reinterpret_cast<const uint32_t*>(src);
    }
#pragma unroll
    for (int k = 0; k < K / 2; ++k) {    // little-endian: word 2k is low
      e[2 * k] = h[k] & 0xFFFFu;
      e[2 * k + 1] = h[k] >> 16;
    }
  }
}

__global__ void __launch_bounds__(kInvThreads)
kv_inv_kernel(const uint16_t* __restrict__ cm, const uint8_t* __restrict__ beta,
              uint16_t* __restrict__ out, int n, int C, uint32_t keep, int cut,
              bool do_round, bool vec, bool pairs) {
  constexpr int TC = kTileChannels, K = kTokensPerThread;
  constexpr int G = kTileTokens / K;       // token groups of a channel
  __shared__ KvTile<TC> tile;
  const int g = threadIdx.x % G, ci = threadIdx.x / G;
  const int c0 = blockIdx.x * TC, t0 = blockIdx.y * kTileTokens;
  const int b = blockIdx.z, c = c0 + ci;
  const int tt = min(kTileTokens, n - t0), tc = min(TC, C - c0);
  const int cnt = min(K, tt - K * g);
  if (c < C && cnt > 0) {
    const uint16_t* src = cm + ((long long)b * C + c) * n + t0 + K * g;
    uint32_t e[K];
    if (vec)                             // n % K == 0: cnt == K, aligned
      load_words<K>(src, e);
    else {
#pragma unroll
      for (int k = 0; k < K; ++k) e[k] = k < cnt ? src[k] : 0u;
    }
    kv_tile_put<TC, K>(tile, ci, g, e, cnt, beta[(long long)b * C + c], keep,
                       cut, do_round);
  }
  __syncthreads();
  kv_tile_write<TC, kInvThreads>(tile, out + ((long long)b * n + t0) * C + c0,
                                 tt, tc, C, pairs);
}

cudaError_t set_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// x: B x n x C uint16; out: B x C x n uint16; beta: B x C uint8, written
// when find_beta, read otherwise.  Returns the cudaError_t of the launch.
extern "C" int kv_delta_fwd(const void* x, void* out, void* beta, int B, int n,
                            int C, int find_beta, int device, void* stream) {
  if (B < 0 || n < 0 || C < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || n == 0 || C == 0) return 0;
  const dim3 grid((C + kTile - 1) / kTile, B);
  kv_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out),
      static_cast<uint8_t*>(beta), n, C, find_beta != 0);
  return static_cast<int>(cudaGetLastError());
}

// cm: B x C x n uint16; beta: B x C uint8; out: B x n x C uint16 rounded
// to the view (keep, cut, do_round).  Returns the cudaError_t of the launch.
extern "C" int kv_delta_inv(const void* cm, const void* beta, void* out, int B,
                            int n, int C, int keep, int cut, int do_round,
                            int device, void* stream) {
  if (B < 0 || n < 0 || C < 0 || B > 65535 ||
      (n + kTileTokens - 1) / kTileTokens > 65535 ||
      (do_round && (cut < 1 || cut > 7)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || n == 0 || C == 0) return 0;
  const bool vec = n % kTokensPerThread == 0 &&
                   reinterpret_cast<uintptr_t>(cm) % (2 * kTokensPerThread) == 0;
  const bool pairs = C % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 4 == 0;
  const dim3 grid((C + kTileChannels - 1) / kTileChannels,
                  (n + kTileTokens - 1) / kTileTokens, B);
  kv_inv_kernel<<<grid, kInvThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(cm), static_cast<const uint8_t*>(beta),
      static_cast<uint16_t*>(out), n, C, static_cast<uint32_t>(keep), cut,
      do_round != 0, vec, pairs);
  return static_cast<int>(cudaGetLastError());
}
