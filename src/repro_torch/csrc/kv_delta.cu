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
// Forward design: one block per (window, kFwdChannels-channel tile), a
// 1-D grid, so a flush of 128 windows is 512 blocks and B may run to
// 2^31 / tiles.  What held the earlier design was latency (each thread's
// 2-byte loads of a token column, one at a time between shared atomics,
// then a second read of the window) and fixed work per window (zeroing
// and scanning 256 bins per channel).  Now:
// * the block reads its tile once, as 16-byte loads, into a token-major
//   tile in shared memory (2-byte loads
//   where C % 8 != 0 or x is not 16-byte aligned); thread (ci, g) then
//   keeps tokens 8g .. 8g + 7 of channel ci in registers for the rest (a
//   window of more than 8 * kFwdGroups tokens: more groups a thread);
// * the mode needs no bin scan: bins are [exponent][channel] words, so a
//   warp's 32 channels always fall into 32 banks.  Each thread zeroes the
//   bins of the tokens it will count (and only those), then counts its
//   tokens with shared atomicAdd; the count each add returns gives the
//   key (count << 8) | (255 - exp), and the largest key a channel sees,
//   kept with one atomicMax per thread, is its mode with ties to the
//   smallest exponent;
// * the thread zigzags its words into a channel-major tile in shared
//   memory (in the bins' place), and the block writes it out as 16-byte
//   stores, neighbouring threads on neighbouring addresses (one 16-byte
//   store a thread straight to its channel row put 32 rows under a
//   warp's store, and took three times as long).
// A window longer than kFwdChunk tokens streams through the tile twice
// (counting, then writing), its bins zeroed whole, as then they cost
// less than a token each.  On the served shape the kernel is held by its
// chain of phases (load, zero, count, write), each behind a barrier, so
// registers are capped for kFwdMinBlocks blocks an SM to overlap more of
// them (chip_variants.py; a persistent grid that fetched the next tile
// during this one was slower).
// The inverse takes one block per (window, kTileChannels channels,
// kTileTokens tokens): thread (ci, g) reads kTokensPerThread tokens of
// one channel (one vector load when n is a multiple of it), and
// kv_read.cuh's stage inverts, rounds and writes the tile token-major.
#include <cuda_runtime.h>
#include <stdint.h>

#include "kv_read.cuh"

namespace {

// The forward's tile, token groups, chunk and residency, from
// chip_variants.py's sweep (PERF.md §6).
constexpr int kFwdChannels = 32;         // a multiple of 32
constexpr int kFwdGroups = 8;
constexpr int kFwdThreads = kFwdChannels * kFwdGroups;
constexpr int kFwdChunk = 256;           // tokens in the tile at once
constexpr int kFwdMinBlocks = 4;         // resident blocks an SM (S = 1)
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

__device__ __forceinline__ int exponent(uint32_t w) { return (w >> 7) & 0xFF; }

// Tokens [t0, t0 + rows) of the block's channels into the tile
// [token][kFwdChannels]; tc channels are real.
__device__ __forceinline__ void load_tile(const uint16_t* __restrict__ xb,
                                          uint16_t* tile, int t0, int rows,
                                          int tc, int C, bool vec) {
  const int tid = threadIdx.x;
  if (vec) {                             // tc % 8 == 0, rows 16-B aligned
    const int q = tc / 8;
    for (int i = tid; i < rows * q; i += kFwdThreads)
      *reinterpret_cast<uint4*>(tile + (i / q) * kFwdChannels + 8 * (i % q)) =
          __ldg(reinterpret_cast<const uint4*>(
              xb + (long long)(t0 + i / q) * C + 8 * (i % q)));
  } else {
    for (int i = tid; i < rows * tc; i += kFwdThreads)
      tile[(i / tc) * kFwdChannels + i % tc] =
          xb[(long long)(t0 + i / tc) * C + i % tc];
  }
}

template <typename Key>
__device__ __forceinline__ Key mode_key(int count, int e) {
  return (static_cast<Key>(count) << 8) | static_cast<Key>(255 - e);
}

// Thread (ci, g) holds tokens 8j .. 8j + 7 of channel ci of the tile's
// rows, j = g, g + kFwdGroups, ..: S groups of 8 words (zero past the
// rows or the channels); S = 1 while a window has at most 8 * kFwdGroups
// tokens, so few registers hold them.
constexpr int kFwdSlots = kFwdChunk / (8 * kFwdGroups);
template <int S>
using Words = uint32_t[S][8];

template <int S>
__device__ __forceinline__ void take_words(const uint16_t* tile, Words<S>& w,
                                           int rows, int ci, int g, int tc) {
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int t = 8 * (g + kFwdGroups * j) + k;
      w[j][k] = ci < tc && t < rows ? tile[t * kFwdChannels + ci] : 0u;
    }
}

// Count the thread's words of the first `rows` tokens in its channel's
// bins, keeping the largest key its adds return.
template <typename Key, int S>
__device__ __forceinline__ void count_words(const Words<S>& w, int* bins,
                                            int rows, int ci, int g,
                                            Key& mine) {
#pragma unroll
  for (int j = 0; j < S; ++j)
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (8 * (g + kFwdGroups * j) + k < rows) {
        const int e = exponent(w[j][k]);
        const int old = atomicAdd(&bins[e * kFwdChannels + ci], 1);
        const Key key = mode_key<Key>(old + 1, e);
        mine = key > mine ? key : mine;
      }
}

// The mode of each of the block's tc channels over the n tokens of a
// window that the tile holds whole, as the largest key, into best[]
// (zeroed).  Only the bins of the words counted are zeroed, first.
template <typename Key, int S>
__device__ __forceinline__ void window_modes(const Words<S>& w, int* bins,
                                             Key* best, int n, int tc, int ci,
                                             int g) {
  if (ci < tc) {
#pragma unroll
    for (int j = 0; j < S; ++j)
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (8 * (g + kFwdGroups * j) + k < n)
          bins[exponent(w[j][k]) * kFwdChannels + ci] = 0;
  }
  __syncthreads();
  Key mine = 0;
  if (ci < tc) {
    count_words(w, bins, n, ci, g, mine);
    atomicMax(&best[ci], mine);
  }
}

// Key: 32 bits while a count fits 24 of them, else 64.  S: groups of 8
// tokens a thread holds (1, or kFwdSlots for a longer tile).
template <typename Key, int S>
__global__ void __launch_bounds__(kFwdThreads, S == 1 ? kFwdMinBlocks : 1)
kv_fwd_kernel(const uint16_t* __restrict__ x, uint16_t* __restrict__ out,
              uint8_t* __restrict__ beta, int n, int C, int tiles,
              bool find_beta, bool vec_in, bool vec_out) {
  constexpr int TC = kFwdChannels;
  extern __shared__ __align__(16) uint8_t fsmem[];
  __shared__ Key best[TC];
  __shared__ uint32_t sbeta[TC];
  const int chunk = min(n, kFwdChunk);
  const bool one = n <= kFwdChunk;       // the tile holds the whole window
  uint16_t* tile = reinterpret_cast<uint16_t*>(fsmem);     // [chunk][TC]
  int* bins = reinterpret_cast<int*>(fsmem + chunk * TC * 2);  // [256][TC]
  // channel-major output tile, in the bins' place once beta is known;
  // rows of `pitch` halfwords, so a quarter warp's 16-byte stores fall
  // into 8 bank groups
  uint16_t* ctile = reinterpret_cast<uint16_t*>(bins);
  const int pitch = chunk + 8 + (chunk & 8);
  const long long b = blockIdx.x / tiles;
  const int c0 = static_cast<int>(blockIdx.x % tiles) * TC;
  const int tc = min(TC, C - c0);
  const int ci = threadIdx.x % TC, g = threadIdx.x / TC;
  const uint16_t* xb = x + b * n * C + c0;
  uint16_t* ob = out + (b * C + c0) * n;
  Words<S> w;

  if (find_beta) {
    if (!one)                            // longer windows: all bins, once
      for (int i = threadIdx.x; i < 256 * TC; i += kFwdThreads) bins[i] = 0;
    if (g == 0) best[ci] = 0;
    Key mine = 0;
    for (int t0 = 0; t0 < n; t0 += chunk) {
      const int rows = min(chunk, n - t0);
      if (t0 > 0) __syncthreads();
      load_tile(xb, tile, t0, rows, tc, C, vec_in);
      __syncthreads();
      take_words(tile, w, rows, ci, g, tc);
      if (one)
        window_modes(w, bins, best, n, tc, ci, g);
      else if (ci < tc)
        count_words(w, bins, rows, ci, g, mine);
    }
    if (!one && ci < tc) atomicMax(&best[ci], mine);
    __syncthreads();
    if (g == 0) {
      const uint32_t e = 255u - static_cast<uint32_t>(best[ci] & 0xFFu);
      sbeta[ci] = e;
      if (ci < tc) beta[b * C + c0 + ci] = static_cast<uint8_t>(e);
    }
  } else if (g == 0) {
    sbeta[ci] = ci < tc ? beta[b * C + c0 + ci] : 0u;
  }
  __syncthreads();

  // zigzag the thread's words into the channel-major tile (or straight
  // out where rows are not whole 16 bytes), then neighbouring threads copy
  // neighbouring 16 bytes of a channel row out
  for (int t0 = 0; t0 < n; t0 += chunk) {
    const int rows = min(chunk, n - t0);
    if (!(one && find_beta)) {           // else w holds the window already
      if (t0 > 0) __syncthreads();
      load_tile(xb, tile, t0, rows, tc, C, vec_in);
      __syncthreads();
      take_words(tile, w, rows, ci, g, tc);
    }
    if (ci < tc) {
      const uint32_t bt = sbeta[ci];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const int t = 8 * (g + kFwdGroups * j);
        if (t >= rows) break;
        uint32_t z[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) z[k] = zigzag(w[j][k], bt);
        if (vec_out) {                   // rows % 8 == 0
          *reinterpret_cast<uint4*>(ctile + ci * pitch + t) =
              make_uint4(z[0] | z[1] << 16, z[2] | z[3] << 16,
                         z[4] | z[5] << 16, z[6] | z[7] << 16);
        } else {
          uint16_t* dst = ob + (long long)ci * n + t0 + t;
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (t + k < rows) dst[k] = static_cast<uint16_t>(z[k]);
        }
      }
    }
    if (vec_out) {
      __syncthreads();
      const int q = rows / 8;
      for (int i = threadIdx.x; i < tc * q; i += kFwdThreads) {
        const int c = i / q, j = 8 * (i % q);
        *reinterpret_cast<uint4*>(ob + (long long)c * n + t0 + j) =
            *reinterpret_cast<const uint4*>(ctile + c * pitch + j);
      }
    }
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

template <typename Key, int S>
cudaError_t launch_fwd(const uint16_t* x, uint16_t* out, uint8_t* beta, int n,
                       int C, int tiles, bool find_beta, bool vec_in,
                       bool vec_out, unsigned grid, int smem,
                       cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kv_fwd_kernel<Key, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  kv_fwd_kernel<Key, S><<<grid, kFwdThreads, smem, stream>>>(
      x, out, beta, n, C, tiles, find_beta, vec_in, vec_out);
  return cudaSuccess;
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
  const long long tiles = (C + kFwdChannels - 1) / kFwdChannels;
  if (B < 0 || n < 0 || C < 0 || tiles * B > 0x7FFFFFFFLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0 || n == 0 || C == 0) return 0;
  const int chunk = n < kFwdChunk ? n : kFwdChunk;
  // the tile, then the bins, which the channel-major tile reuses
  const int ctile = kFwdChannels * (chunk + 16) * 2;
  const int bins = find_beta ? 256 * kFwdChannels * 4 : 0;
  const int smem = chunk * kFwdChannels * 2 + (bins > ctile ? bins : ctile);
  const bool vec_in = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out =
      n % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const uint16_t*>(x);
  auto* op = static_cast<uint16_t*>(out);
  auto* bp = static_cast<uint8_t*>(beta);
  const unsigned grid = static_cast<unsigned>(tiles * B);
  const bool fb = find_beta != 0;
  const int nt = static_cast<int>(tiles);
  if (n >= (1 << 24))                    // a count needs the 64-bit key
    err = launch_fwd<unsigned long long, kFwdSlots>(xp, op, bp, n, C, nt, fb,
                                                    vec_in, vec_out, grid,
                                                    smem, s);
  else if (n > 8 * kFwdGroups)
    err = launch_fwd<uint32_t, kFwdSlots>(xp, op, bp, n, C, nt, fb, vec_in,
                                          vec_out, grid, smem, s);
  else
    err = launch_fwd<uint32_t, 1>(xp, op, bp, n, C, nt, fb, vec_in, vec_out,
                                  grid, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
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
