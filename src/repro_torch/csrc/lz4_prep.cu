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
// runb is optional: a null pointer skips it (the match kernel reads only
// w and h).
//
// Bound on this card: memory.  One byte in and 12 bytes out per position
// (8 without runb), a few integer operations each: 13 (9) B/position over
// 3.35 TB/s, 1.017 (0.704) us at a flush slab's 262144 plane bytes.
//
// Design: the work is stores, so every store is a 16-byte vector and a
// warp's store covers 512 contiguous bytes of one output.
// - A warp owns a tile of 128 kRounds positions; in round r, lane l owns
//   the 4 positions from 128 r + 4 l.  Its bytes are one aligned 4-byte
//   word, which a warp loads as one 128-byte line (all rounds' loads
//   issued first); the next word, for the 3 bytes past a lane's last
//   position, comes from lane l + 1 by __shfl_down_sync (lane 31's from
//   lane 0's word of the next round), and __funnelshift_r forms the four
//   positions' words from the two.
// - Any start: the kernel reads the aligned words that hold the slab
//   (the first may begin, the last end, up to 3 bytes outside it).  With
//   the slab at s bytes past a word boundary, each position's 7 bytes
//   span three aligned words, the third from lane l + 2, and a funnel
//   shift by s bytes realigns them; a word-aligned slab (the tier's)
//   takes the two-word path.
// - Any length: words at or past the slab's end read as 0 (the last one
//   masked to the bytes inside), and a lane with positions past the end
//   stores those inside one at a time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // threads a block
constexpr int kRounds = 1;      // rounds of 4 positions a lane
constexpr int kHashLog = 13;
constexpr unsigned kFull = 0xFFFFFFFFu;

// Aligned word k of the slab's words, bytes at or past ``end`` (counted
// from the first word) read as 0.
__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ a,
                                            long long k, long long end) {
  const long long left = end - 4 * k;
  if (left <= 0) return 0u;
  const uint32_t v = a[k];
  return left >= 4 ? v : v & ((1u << (8 * left)) - 1u);
}

__device__ __forceinline__ int32_t hash(uint32_t w) {
  return static_cast<int32_t>((w * 2654435761u) >> (32 - kHashLog));
}

// ALIGNED: the slab starts on a word (s == 0).  RUNB: write runb.
template <bool ALIGNED, bool RUNB>
__global__ void __launch_bounds__(kThreads)
lz4_prep_kernel(const uint32_t* __restrict__ a, int s,
                int32_t* __restrict__ w, int32_t* __restrict__ h,
                int32_t* __restrict__ runb, long long n) {
  const int lane = threadIdx.x & 31;
  const long long tile =
      ((blockIdx.x * (long long)kThreads + threadIdx.x) >> 5) * 128 * kRounds;
  if (tile >= n) return;                 // the whole warp
  const long long end = s + n;
  const long long k0 = tile / 4 + lane;
  uint32_t v[kRounds + 1];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) v[r] = word_at(a, k0 + 32 * r, end);
  v[kRounds] = lane < 2 ? word_at(a, k0 + 32 * kRounds, end) : 0u;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const uint32_t down = __shfl_down_sync(kFull, v[r], 1);
    const uint32_t wrap = __shfl_sync(kFull, v[r + 1], 0);
    uint32_t lo = v[r], hi = lane == 31 ? wrap : down;
    if (!ALIGNED) {
      const uint32_t down2 = __shfl_down_sync(kFull, v[r], 2);
      const uint32_t wrap2 = __shfl_sync(kFull, v[r + 1], (lane + 2) & 31);
      const uint32_t hi2 = lane >= 30 ? wrap2 : down2;
      lo = __funnelshift_r(lo, hi, 8 * s);
      hi = __funnelshift_r(hi, hi2, 8 * s);
    }
    uint32_t word[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) word[j] = __funnelshift_r(lo, hi, 8 * j);
    const long long q = tile + 128 * r + 4 * lane;
    if (q + 4 <= n) {
      *reinterpret_cast<int4*>(w + q) =
          make_int4(static_cast<int>(word[0]), static_cast<int>(word[1]),
                    static_cast<int>(word[2]), static_cast<int>(word[3]));
      *reinterpret_cast<int4*>(h + q) = make_int4(
          hash(word[0]), hash(word[1]), hash(word[2]), hash(word[3]));
      if (RUNB)
        *reinterpret_cast<int4*>(runb + q) = make_int4(
            (word[0] ^ (word[0] >> 8)) & 0xFFu ? 1 : 0,
            (word[1] ^ (word[1] >> 8)) & 0xFFu ? 1 : 0,
            (word[2] ^ (word[2] >> 8)) & 0xFFu ? 1 : 0,
            (word[3] ^ (word[3] >> 8)) & 0xFFu ? 1 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (q + j >= n) break;
        w[q + j] = static_cast<int32_t>(word[j]);
        h[q + j] = hash(word[j]);
        if (RUNB) runb[q + j] = (word[j] ^ (word[j] >> 8)) & 0xFFu ? 1 : 0;
      }
    }
  }
}

template <bool ALIGNED>
void launch(unsigned blocks, cudaStream_t stream, const uint32_t* a, int s,
            int32_t* w, int32_t* h, int32_t* runb, long long n) {
  if (runb != nullptr)
    lz4_prep_kernel<ALIGNED, true><<<blocks, kThreads, 0, stream>>>(
        a, s, w, h, runb, n);
  else
    lz4_prep_kernel<ALIGNED, false><<<blocks, kThreads, 0, stream>>>(
        a, s, w, h, runb, n);
}

}  // namespace

// b: n bytes, any alignment; w, h: n int32 each, 16-byte aligned; runb: n
// int32, 16-byte aligned, or null to skip it.  Returns the launch's
// cudaError_t.
extern "C" int lz4_prep(const void* b, void* w, void* h, void* runb,
                        long long n, int device, void* stream) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(b) & 3u);
  const auto* a = reinterpret_cast<const uint32_t*>(
      static_cast<const uint8_t*>(b) - s);
  const long long warps = (n + 128LL * kRounds - 1) / (128LL * kRounds);
  const unsigned blocks =
      static_cast<unsigned>((32 * warps + kThreads - 1) / kThreads);
  auto* wp = static_cast<int32_t*>(w);
  auto* hp = static_cast<int32_t*>(h);
  auto* rp = static_cast<int32_t*>(runb);
  auto st = static_cast<cudaStream_t>(stream);
  if (s == 0)
    launch<true>(blocks, st, a, s, wp, hp, rp, n);
  else
    launch<false>(blocks, st, a, s, wp, hp, rp, n);
  return static_cast<int>(cudaGetLastError());
}
