// The tail of the KV read on Hopper (sm_90a), shared by the fused KV read
// kernel (bitplane_unpack.cu) and the standalone exponent-delta inverse
// (kv_delta.cu), so the two cannot drift apart.
//
// A block owns one tile of one window: kTileTokens tokens x TC channels.
// Thread (ci, g) holds the words of channel c0 + ci, tokens Kg .. Kg +
// K - 1 of the tile, in channel-major order as the window was stored.
// kv_tile_put inverts each word's exponent delta with the channel's beta
// (unzigzag, + beta mod 256), rounds it to the view (view_round.cuh: the
// round runs after the inverse because its carry may move into the
// exponent, and Inf/NaN are recognisable only in the real-exponent
// domain) and stores it in a shared tile [token][channel].  After one
// barrier kv_tile_write copies the tile to the token-major output, as
// 32-bit channel pairs where the width allows, so neighbouring threads
// write neighbouring words of a token row.
#pragma once
#include <stdint.h>

#include "view_round.cuh"

constexpr int kTileTokens = 64;

__device__ __forceinline__ uint32_t unzigzag(uint32_t v, uint32_t beta) {
  const uint32_t z = (v >> 7) & 0xFFu;
  const uint32_t s = (z & 1u) ? 0u - ((z + 1u) >> 1) : z >> 1;
  return (v & 0x807Fu) | (((s + beta) & 0xFFu) << 7);
}

// Rows padded by two halfwords: rows stay 4-byte aligned for the pair
// copy, and their odd stride in words (TC a multiple of 4) spreads a
// warp's stores to neighbouring token rows over the banks.
template <int TC>
struct KvTile {
  static constexpr int kStride = TC + 2;
  uint16_t w[kTileTokens * kStride];
};

// Thread (ci, g): its first `cnt` words (tokens Kg .. Kg + cnt - 1),
// inverted with `beta`, rounded, into the tile.
template <int TC, int K>
__device__ __forceinline__ void kv_tile_put(KvTile<TC>& tile, int ci, int g,
                                            const uint32_t (&e)[K], int cnt,
                                            uint32_t beta, uint32_t keep,
                                            int cut, bool do_round) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (k < cnt)
      tile.w[(K * g + k) * KvTile<TC>::kStride + ci] = static_cast<uint16_t>(
          view_round(unzigzag(e[k], beta), keep, cut, do_round));
}

// After a barrier: the tile's tt tokens x tc channels to `out`, which
// points at (token t0, channel c0) of a token-major window of C channels.
// `pairs`: C even and `out` 4-byte aligned, so every token row of the
// tile is whole 32-bit words.
template <int TC, int NT>
__device__ __forceinline__ void kv_tile_write(const KvTile<TC>& tile,
                                              uint16_t* __restrict__ out,
                                              int tt, int tc, int C,
                                              bool pairs) {
  constexpr int S = KvTile<TC>::kStride;
  if (pairs) {
    constexpr int H = TC / 2;
    for (int i = threadIdx.x; i < tt * H; i += NT) {
      const int t = i / H, p = i % H;
      if (2 * p < tc)
        reinterpret_cast<uint32_t*>(out + (long long)t * C)[p] =
            *reinterpret_cast<const uint32_t*>(&tile.w[t * S + 2 * p]);
    }
  } else {
    for (int i = threadIdx.x; i < tt * TC; i += NT) {
      const int t = i / TC, c = i % TC;
      if (c < tc) out[(long long)t * C + c] = tile.w[t * S + c];
    }
  }
}
