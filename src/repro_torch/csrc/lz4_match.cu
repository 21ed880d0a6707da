// LZ4 greedy match for Hopper (sm_90a): every stream of an encode slab in
// one launch, from the prep's words and hashes to (pos, dist, mlen) events.
//
// Replaces the device program around the TPU kernel of lz4_prep.cu:
// src/repro/kernels/lz4.py::_device_match_impl after its prep (the
// hash-table sort, the candidate filter, the next-candidate and run-end
// tables and the greedy lax.while_loop rounds with a gallop while_loop
// inside).  It is not a pallas_call; the reference compiles it whole, and
// the port ran it as host-driven rounds of PyTorch ops (match_plain).
//
// For stream s, with bytes [start, end), L = end - start and local
// position q = global - start (w and h are the prep's per-position word
// and hash; the bytes and the run flags are the words' low bytes):
// - valid q: q + 4 <= L; prev(q): the latest valid q' < q with
//   h[q'] == h[q] (the stable-sort neighbour of the reference's key), or
//   none;
// - q is a candidate when q < L - MFLIMIT, prev(q) exists, d = q - prev(q)
//   <= 0xFFFF, w[q] == w[prev(q)], and not (d == 1, q >= 2, q % 4 != 0 and
//   b[q-2] == b[q-1]) (the run-stride rule);
// - the cursor starts at the first candidate and, after a match of length
//   m at p, moves to the first candidate >= p + m; the match length is
//   min(LCP(p, p - d), L - LAST_LITERALS - p), which is what the
//   reference's run table (d == 1) and word gallop + byte tail measure.
// Events go to rows row_start[s] + i; count[s] holds their number.
//
// Bound on this card: neither bytes nor operations.  A slab of the main
// path is 256 KiB, with 1 MiB each of words and hashes (0.6 us at 3.35
// TB/s); what sets the time is the chain of dependent steps inside a
// stream: the position-ordered hash tables, and the greedy walk, where
// each match starts where the last one ended.
//
// Design: a team (kWarpsPerStream warps) owns a stream and up to
// kStreamsPerBlock teams share a block.  A stream up to the shared-memory
// tile is staged there (words, hashes); a longer one uses a global scratch
// region with the same arrays (32-bit entries there) and the same code,
// through generic pointers.  Phases, the team synchronised between them:
// 1. prev() by position-ordered passes over HASH_SIZE tables, one per
//    segment of the stream (kSegments warps side by side), 32 positions
//    a step, the same-hash lanes of a step resolved by __match_any_sync;
//    a position with no prev in its segment then takes the nearest
//    earlier segment's last occurrence from that segment's table;
// 2. the candidate test per position (all warps): a distance, one bit per
//    position in a candidate mask and in a run-end mask (b[q] != b[q+1]);
// 3. per candidate (a lane each) its match length, measured up to
//    kLcpWords words (a run's end from the run mask within kScanWords
//    mask words), and the next candidate after the match (within
//    kScanWords words), packed into one record; what does not resolve
//    there is marked for the walk; then each candidate's next four chain
//    positions from the records;
// 4. the greedy walk (warp 0): one load per four matches while the jumps
//    are known; a marked length is measured by the warp (a ballot over 32
//    mask words for a run's end, else a gallop over 32 words, 128 bytes,
//    a step), a marked next candidate by a ballot over 32 mask words
//    (1024 positions a step); the selected positions go to a list;
// 5. the events of the list (the team, coalesced stores).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kHashLog = 13;
constexpr int kHashSize = 1 << kHashLog;
constexpr int kMinMatch = 4;
constexpr int kMfLimit = 12;
constexpr int kLastLiterals = 5;
constexpr int kMaxDist = 0xFFFF;
constexpr int kNone = 1 << 30;
constexpr unsigned kFull = 0xFFFFFFFFu;
// Design choices, from chip_variants.py's sweep (PERF.md §6).
constexpr int kWarpsPerStream = 16;
constexpr int kStreamsPerBlock = 1;
constexpr int kSegments = 4;      // table passes run side by side
constexpr int kLcpWords = 8;      // words a lane compares per candidate
constexpr int kScanWords = 2;     // mask words a lane searches
constexpr int kTeam = 32 * kWarpsPerStream;
constexpr int kThreads = kTeam * kStreamsPerBlock;
constexpr int kSmemBudget = 227 * 1024;
static_assert(kWarpsPerStream == 1 || kStreamsPerBlock <= 15,
              "a named barrier per team");

// Shared memory of one team for streams up to `tile` bytes (a multiple of
// 128): prev structure, later the walk's selected positions | words |
// hashes | dist | (length, next) records | 4-successor jumps | candidate
// bits | run bits.
constexpr int kTableEntries = kHashSize + 32;   // 32 spare entries

// Bytes of the prev() structure (the segments' hash tables) at a tile.
__host__ __device__ constexpr int prev_bytes(int) {
  return kSegments * 2 * kTableEntries;
}
__host__ __device__ constexpr int region_bytes(int tile) {
  return prev_bytes(tile) + 20 * tile + tile / 4;
}

int tile_max() {
  int t = 0;
  while (t + 128 < 65536 && region_bytes(t + 128) <= kSmemBudget) t += 128;
  return t;
}

// Teams a block holds at this tile.
int teams_per_block(int tile) {
  if (tile == 0) return kStreamsPerBlock;
  const int fit = kSmemBudget / region_bytes(tile);
  return fit < kStreamsPerBlock ? fit : kStreamsPerBlock;
}

__device__ __forceinline__ void team_sync(int team) {
  if constexpr (kWarpsPerStream == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(kTeam) : "memory");
  }
}

// A candidate's match length (0: measure it in the walk) and next
// candidate after the match (>= L - MFLIMIT: none; 0: search in the walk),
// packed for one load: 16 bits each in shared memory, 32 in the scratch.
template <typename IdxT>
using Rec = typename std::conditional<sizeof(IdxT) == 2, uint32_t, int2>::type;
// The next four candidates of the greedy chain from a candidate (each as
// a record's next: a position, >= L - MFLIMIT for none, 0 for unknown).
template <typename IdxT>
using Jump = typename std::conditional<sizeof(IdxT) == 2, ushort4, int4>::type;

__device__ __forceinline__ uint32_t make_rec(int m, int nx, uint32_t*) {
  return static_cast<uint32_t>(m) | (static_cast<uint32_t>(nx) << 16);
}
__device__ __forceinline__ int2 make_rec(int m, int nx, int2*) {
  return make_int2(m, nx);
}
__device__ __forceinline__ int rec_len(uint32_t r) { return r & 0xFFFFu; }
__device__ __forceinline__ int rec_len(int2 r) { return r.x; }
__device__ __forceinline__ int rec_next(uint32_t r) { return r >> 16; }
__device__ __forceinline__ int rec_next(int2 r) { return r.y; }

// One stream's arrays, in shared memory (16-bit entries) or in the global
// scratch (32-bit).
template <typename HashT, typename IdxT>
struct Stream {
  const int32_t* W;   // words of local positions 0..nval-1
  const HashT* H;     // their hashes
  IdxT* table;        // kSegments tables of kTableEntries: last position
                      // + 1, 0 = none
  IdxT* dist;         // prev + 1 after phase 1; a candidate's distance
  Rec<IdxT>* rec;     // a candidate's (length, next candidate)
  Jump<IdxT>* jump;   // a candidate's next four chain positions
  IdxT* sel;          // the walk's selected positions, in order
  uint32_t* cand;     // one bit per position: a candidate
  uint32_t* run;      // one bit per position: b[q] != b[q+1]
  int L, nval, nwords;
};

// Phase 1: prev() by position-ordered passes over hash tables, one per
// segment of mask words [k0, k1), 32 positions a step (a warp): within a
// step the latest lower lane of the same hash, else the segment's table;
// then the step's last lane of each hash updates it.  Lanes past the
// stream's end take the table's 32 spare entries, one each, and write
// dist entries the later phases never read.
template <typename H, typename I>
__device__ void table_pass(const Stream<H, I>& st, I* table, int k0, int k1,
                           int lane) {
  const unsigned below = (1u << lane) - 1u;
  const uint32_t spare = kHashSize + lane;
  uint32_t hn = 32 * k0 + lane < st.nval
                    ? static_cast<uint32_t>(st.H[32 * k0 + lane]) : spare;
  for (int k = k0; k < k1; ++k) {
    const int q = 32 * k + lane;
    const uint32_t hq = hn;
    hn = q + 32 < st.nval ? static_cast<uint32_t>(st.H[q + 32]) : spare;
    const unsigned peers = __match_any_sync(kFull, hq);
    const unsigned lower = peers & below;
    const int prev1 = lower ? 32 * k + 32 - __clz(lower)
                            : static_cast<int>(table[hq]);
    __syncwarp();
    if (lane == 31 - __clz(peers)) table[hq] = static_cast<I>(q + 1);
    st.dist[q] = static_cast<I>(prev1);
    __syncwarp();
  }
}

// Phase 1, the segments joined (the team): a position with no prev in its
// own segment takes the last occurrence of its hash in the nearest earlier
// segment that has one, from that segment's final table.
template <typename H, typename I>
__device__ void link_segments(const Stream<H, I>& st, int segw, int tid) {
  for (int q = 32 * segw + tid; q < st.nval; q += kTeam) {
    if (st.dist[q] != 0) continue;
    const uint32_t h = static_cast<uint32_t>(st.H[q]);
    int prev1 = 0;
    for (int g = q / (32 * segw) - 1; g >= 0 && prev1 == 0; --g)
      prev1 = static_cast<int>(st.table[g * kTableEntries + h]);
    st.dist[q] = static_cast<I>(prev1);
  }
}

// Phase 2: the candidate test of every position and the two masks (the
// team's warps, a mask word each).
template <typename H, typename I>
__device__ void mask_pass(const Stream<H, I>& st, int tid) {
  const int lane = tid & 31;
  for (int k = tid / 32; k < st.nwords; k += kWarpsPerStream) {
    const int q = 32 * k + lane;
    const bool act = q < st.nval;
    bool c = false, r = false;
    if (act) {
      const uint32_t wq = static_cast<uint32_t>(st.W[q]);
      r = ((wq ^ (wq >> 8)) & 0xFFu) != 0u;
      const int prevq = static_cast<int>(st.dist[q]) - 1;
      const int d = q - prevq;
      c = prevq >= 0 && q < st.L - kMfLimit && d <= kMaxDist &&
          static_cast<uint32_t>(st.W[prevq]) == wq;
      if (c && d == 1 && q >= 2 && (q & 3) != 0) {   // the run-stride rule
        const uint32_t v = static_cast<uint32_t>(st.W[q - 2]);
        c = (v & 0xFFu) != ((v >> 8) & 0xFFu);
      }
      if (c) st.dist[q] = static_cast<I>(d);
    }
    const unsigned cw = __ballot_sync(kFull, c);
    const unsigned rw = __ballot_sync(kFull, r);
    if (lane == 0) {
      st.cand[k] = cw;
      st.run[k] = rw;
    }
  }
}

// First set bit at or after position x within kScanWords mask words of
// one lane: the position, kNone when the mask ends first, -1 when not
// found in that range.
__device__ __forceinline__ int scan_lane(const uint32_t* bits, int nwords,
                                         int x) {
  const int first = x >> 5;
#pragma unroll
  for (int i = 0; i < kScanWords; ++i) {
    const int wi = first + i;
    if (wi >= nwords) return kNone;
    uint32_t v = bits[wi];
    if (i == 0) v &= kFull << (x & 31);
    if (v) return wi * 32 + __ffs(v) - 1;
  }
  return -1;
}

// Phase 3: per candidate (a lane each) its match length and next
// candidate, or the marks that leave them to the walk.
template <typename H, typename I>
__device__ void length_pass(const Stream<H, I>& st, int tid) {
  const int lane = tid & 31;
  const int limit = st.L - kMfLimit;
  for (int k = tid / 32; k < st.nwords; k += kWarpsPerStream) {
    if (!((st.cand[k] >> lane) & 1u)) continue;
    const int p = 32 * k + lane;
    const int d = static_cast<int>(st.dist[p]);
    const int cap = st.L - kLastLiterals - p;
    int m = 0;
    if (d == 1) {
      const int r = scan_lane(st.run, st.nwords, p);
      if (r >= 0)
        m = min(r - p + 1, cap);
      else if (32 * ((p >> 5) + kScanWords) >= p + cap)
        m = cap;   // every run end from here on lies at or past the cap
    } else {
      const int c = p - d;
      int e = 4;
      m = kMinMatch;
#pragma unroll
      for (int i = 0; i < kLcpWords && e == 4 && m < cap; ++i) {
        const uint32_t x = static_cast<uint32_t>(st.W[p + m] ^ st.W[c + m]);
        e = x ? (__ffs(x) - 1) >> 3 : 4;
        m += min(e, cap - m);
      }
      if (e == 4 && m < cap) m = 0;   // longer than kLcpWords words
    }
    int nx = 0;
    if (m > 0) {
      const int f = scan_lane(st.cand, st.nwords, p + m);
      nx = f >= 0 ? min(f, limit) : 0;
    }
    st.rec[p] = make_rec(m, nx, st.rec);
  }
}

// Phase 3b: each candidate's next four chain positions (a lane each).
template <typename H, typename I>
__device__ void jump_pass(const Stream<H, I>& st, int tid) {
  const int lane = tid & 31;
  const int limit = st.L - kMfLimit;
  for (int k = tid / 32; k < st.nwords; k += kWarpsPerStream) {
    if (!((st.cand[k] >> lane) & 1u)) continue;
    const int p = 32 * k + lane;
    int c[4];
    int q = p;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (q != 0 && q < limit) q = rec_next(st.rec[q]);
      c[i] = q;
    }
    Jump<I> j;
    j.x = static_cast<decltype(j.x)>(c[0]);
    j.y = static_cast<decltype(j.y)>(c[1]);
    j.z = static_cast<decltype(j.z)>(c[2]);
    j.w = static_cast<decltype(j.w)>(c[3]);
    st.jump[p] = j;
  }
}

// First set bit at or after position x (kNone if none): a ballot over 32
// mask words a step.
__device__ __forceinline__ int find_first(const uint32_t* bits, int nwords,
                                          int x, int lane) {
  const int first = x >> 5;
  for (int base = first; base < nwords; base += 32) {
    const int wi = base + lane;
    uint32_t v = wi < nwords ? bits[wi] : 0u;
    if (wi == first) v &= kFull << (x & 31);
    const unsigned any = __ballot_sync(kFull, v != 0u);
    if (any) {
      const int j = __ffs(any) - 1;
      const uint32_t vj = __shfl_sync(kFull, v, j);
      return (base + j) * 32 + __ffs(vj) - 1;
    }
  }
  return kNone;
}

// min(LCP(p, c), cap), LCP >= 4 known: 32 words a step while they agree
// and fit, then the first unequal word's equal low bytes (at most 3).
__device__ __forceinline__ int gallop(const int32_t* W, int p, int c,
                                      int cap, int lane) {
  int m = kMinMatch;
  for (;;) {
    const int k = m + 4 * lane;
    const bool ok = k + 4 <= cap && W[p + k] == W[c + k];
    const unsigned bad = __ballot_sync(kFull, !ok);
    if (bad == 0u) {
      m += 128;
      continue;
    }
    m += 4 * (__ffs(bad) - 1);
    break;
  }
  if (m < cap) {
    const uint32_t x = static_cast<uint32_t>(W[p + m] ^ W[c + m]);
    const int e = x ? (__ffs(x) - 1) >> 3 : 4;
    m += min(min(e, 3), cap - m);
  }
  return m;
}

// Phase 4: the greedy chain of one stream (one warp, uniform control
// flow, every lane storing the same values): the selected positions in
// sel, a length measured here back into the candidate's record; returns
// their number.  Four positions a load while the jumps are known.
template <typename H, typename I>
__device__ int walk(const Stream<H, I>& st, int lane) {
  const int limit = st.L - kMfLimit;
  int n = 0;
  int p = find_first(st.cand, st.nwords, 0, lane);
  while (p < limit) {
    const auto j = st.jump[p];
    if (j.x != 0 && j.y != 0 && j.z != 0 && j.w != 0) {
      st.sel[n++] = static_cast<I>(p);
      const int c[3] = {static_cast<int>(j.x), static_cast<int>(j.y),
                        static_cast<int>(j.z)};
      p = static_cast<int>(j.w);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (c[i] >= limit) {
          p = c[i];
          break;
        }
        st.sel[n++] = static_cast<I>(c[i]);
      }
      continue;
    }
    const auto r = st.rec[p];
    int nx = rec_next(r);
    st.sel[n++] = static_cast<I>(p);
    if (nx == 0) {   // a marked length or next candidate
      int m = rec_len(r);
      if (m == 0) {
        const int d = static_cast<int>(st.dist[p]);
        const int cap = st.L - kLastLiterals - p;
        m = d == 1 ? min(find_first(st.run, st.nwords, p, lane) - p + 1, cap)
                   : gallop(st.W, p, p - d, cap, lane);
        st.rec[p] = make_rec(m, 0, st.rec);
      }
      nx = find_first(st.cand, st.nwords, p + m, lane);
    }
    p = nx;
  }
  return n;
}

// Phase 5: the events of the selected positions (the team, coalesced).
template <typename H, typename I>
__device__ void emit(const Stream<H, I>& st, int n, long long start,
                     int32_t* pos, int32_t* dist, int32_t* mlen, int tid) {
  for (int i = tid; i < n; i += kTeam) {
    const int p = static_cast<int>(st.sel[i]);
    pos[i] = static_cast<int32_t>(start + p);
    dist[i] = static_cast<int32_t>(st.dist[p]);
    mlen[i] = rec_len(st.rec[p]);
  }
}

template <typename H, typename I>
__device__ int match_stream(const Stream<H, I>& st, long long start,
                            int32_t* pos, int32_t* dst, int32_t* len,
                            int team, int tid) {
  __shared__ int events[kStreamsPerBlock];
  const int segw = (st.nwords + kSegments - 1) / kSegments;
  for (int g = tid / 32; g < kSegments; g += kWarpsPerStream)
    table_pass(st, st.table + g * kTableEntries, g * segw,
               min((g + 1) * segw, st.nwords), tid & 31);
  team_sync(team);
  if (kSegments > 1) link_segments(st, segw, tid);
  team_sync(team);
  mask_pass(st, tid);
  team_sync(team);
  length_pass(st, tid);
  team_sync(team);
  jump_pass(st, tid);
  team_sync(team);
  if (tid < 32) {
    const int n = walk(st, tid);
    if (tid == 0) events[team] = n;
  }
  team_sync(team);
  const int n = events[team];
  emit(st, n, start, pos, dst, len, tid);
  return n;
}

// meta: (4, S) int64 — starts, ends, row_start, scratch offset (-1: the
// stream is staged in shared memory).  out: count (S) | pos | dist | mlen
// (E each), int32.
__global__ void __launch_bounds__(kThreads)
lz4_match_kernel(const int32_t* __restrict__ w, const int32_t* __restrict__ h,
                 const long long* __restrict__ meta, int S, int tile,
                 unsigned char* __restrict__ scratch,
                 int32_t* __restrict__ out, long long E) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int teams = blockDim.x / kTeam;
  const int team = threadIdx.x / kTeam;
  const int tid = threadIdx.x % kTeam;
  const int s = blockIdx.x * teams + team;
  if (s >= S) return;
  const long long start = meta[s];
  const int L = static_cast<int>(meta[S + s] - start);
  const long long row = meta[2 * S + s];
  const long long soff = meta[3 * S + s];
  if (L <= kMfLimit + 1) {   // no position has both a prev and room
    if (tid == 0) out[s] = 0;
    return;
  }
  const int nval = L - 3;
  const int nwords = (nval + 31) / 32;
  int32_t* pos = out + S + row;
  int32_t* dst = out + S + E + row;
  int32_t* len = out + S + 2 * E + row;
  const int32_t* gw = w + start;
  const int32_t* gh = h + start;
  int n;
  if (soff < 0) {
    unsigned char* base =
        smem + static_cast<size_t>(team) * region_bytes(tile);
    unsigned char* after = base + prev_bytes(tile);
    int32_t* sw = reinterpret_cast<int32_t*>(after);
    uint16_t* sh = reinterpret_cast<uint16_t*>(after + 4 * tile);
    uint16_t* sd = reinterpret_cast<uint16_t*>(after + 6 * tile);
    uint32_t* sr = reinterpret_cast<uint32_t*>(after + 8 * tile);
    ushort4* sj = reinterpret_cast<ushort4*>(after + 12 * tile);
    uint32_t* sc = reinterpret_cast<uint32_t*>(after + 20 * tile);
    uint16_t* prev = reinterpret_cast<uint16_t*>(base);   // dead after phase 1
    Stream<uint16_t, uint16_t> st{sw, sh, prev, sd, sr, sj, prev, sc,
                                  sc + tile / 32, L, nval, nwords};
    int4* t4 = reinterpret_cast<int4*>(base);
    for (int i = tid; i < prev_bytes(tile) / 16; i += kTeam)
      t4[i] = make_int4(0, 0, 0, 0);
    int i0 = 0;
    if ((start & 3) == 0) {   // 16-byte loads: 4 words, 4 hashes
      const int nv = nval >> 2;
#pragma unroll 4
      for (int i = tid; i < nv; i += kTeam) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(gw) + i);
        const int4 b = __ldg(reinterpret_cast<const int4*>(gh) + i);
        reinterpret_cast<int4*>(sw)[i] = a;
        reinterpret_cast<uint2*>(sh)[i] = make_uint2(
            static_cast<uint32_t>(b.x) | (static_cast<uint32_t>(b.y) << 16),
            static_cast<uint32_t>(b.z) | (static_cast<uint32_t>(b.w) << 16));
      }
      i0 = 4 * nv;
    }
    for (int i = i0 + tid; i < nval; i += kTeam) {
      sw[i] = __ldg(gw + i);
      sh[i] = static_cast<uint16_t>(__ldg(gh + i));
    }
    team_sync(team);
    n = match_stream(st, start, pos, dst, len, team, tid);
  } else {
    // global scratch: table | dist (int32) | records (int2) | jumps (int4)
    // | cand | run bits; the walk's selected positions go to the pos row
    const int lp = (L + 127) / 128 * 128;
    int32_t* table = reinterpret_cast<int32_t*>(scratch + soff);
    int32_t* gd = table + kSegments * kTableEntries;
    int2* gr = reinterpret_cast<int2*>(gd + lp);
    int4* gj = reinterpret_cast<int4*>(gr + lp);
    uint32_t* gc = reinterpret_cast<uint32_t*>(gj + lp);
    Stream<int32_t, int32_t> st{gw, gh, table, gd, gr, gj, pos, gc,
                                gc + lp / 32, L, nval, nwords};
    for (int i = tid; i < kSegments * kTableEntries; i += kTeam) table[i] = 0;
    team_sync(team);
    n = match_stream(st, start, pos, dst, len, team, tid);
  }
  if (tid == 0) out[s] = n;
}

}  // namespace

// Largest stream (bytes, a multiple of 128) staged in shared memory; the
// wrapper gives longer streams global scratch.
extern "C" int lz4_match_tile_max() { return tile_max(); }

// Bytes of a long stream's int32 hash tables in the global scratch.
extern "C" int lz4_match_table_bytes() {
  return kSegments * kTableEntries * 4;
}

// w, h: the prep's int32 words and hashes of the slab (16-byte aligned);
// meta: (4, S) int64 (see the kernel); tile: the shared-memory tile in
// bytes (a multiple of 128, at least every staged stream's length, at
// most lz4_match_tile_max); scratch: global scratch of the long streams,
// lz4_match_table_bytes() + 28 * Lp + Lp / 4 bytes each at its offset (Lp:
// L rounded up to 128, offsets 16-byte aligned); out: S + 3 * E int32.
// Returns the launch's cudaError_t.
extern "C" int lz4_match(const void* w, const void* h, const void* meta,
                         int S, int tile, void* scratch, void* out,
                         long long E, int device, void* stream) {
  if (S < 0 || tile < 0 || tile % 128 != 0 || tile > tile_max() || E < 0 ||
      ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(h)) &
       15u))
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S == 0) return 0;
  const int teams = teams_per_block(tile);
  const int smem = tile > 0 ? teams * region_bytes(tile) : 0;
  static int smem_set[64] = {};   // per device, the largest set so far
  if (smem > 48 * 1024 && (device < 0 || device >= 64 ||
                           smem > smem_set[device])) {
    err = cudaFuncSetAttribute(lz4_match_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 0 && device < 64) smem_set[device] = smem;
  }
  lz4_match_kernel<<<(S + teams - 1) / teams, teams * kTeam, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(w), static_cast<const int32_t*>(h),
      static_cast<const long long*>(meta), S, tile,
      static_cast<unsigned char*>(scratch), static_cast<int32_t*>(out), E);
  return static_cast<int>(cudaGetLastError());
}
