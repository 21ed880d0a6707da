// LZ4 greedy match for Hopper (sm_90a): every stream of an encode slab in
// one launch, from the slab's bytes to (pos, dist, mlen) events.
//
// Replaces the reference's whole match program,
// src/repro/kernels/lz4.py::_device_match_impl, its prep included (the
// TPU kernel _prep_kernel, reached through _prep_pallas: the word and hash
// of each position are computed here, in shared memory, and the match path
// launches no lz4_prep.cu).  The rest of that program is not a
// pallas_call: the hash-table sort, the candidate filter, the
// next-candidate and run-end tables and the greedy lax.while_loop rounds
// with a gallop while_loop inside.
//
// For stream s, with bytes [start, end), L = end - start and local
// position q = global - start (w: the 4-byte little-endian word at q, h
// its hash):
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
// Bound on this card: neither bytes nor operations.  The flush slab of the
// main path moves about 0.1 MB (0.03 us at 3.35 TB/s); what sets the time
// is latency inside a stream of 256-4096 bytes: chains of dependent
// shared-memory steps with a block or two an SM, and the barriers between
// phases.  So the design keeps the phases few (nine barriers) and their
// dependent steps short.
//
// Design: a block takes a group of streams (streams of up to kPackBytes
// bytes packed while their regions start within one kPackBytes window,
// each longer stream a block of its own).  Its positions are block-local:
// stream s's region starts on a 32-position word and its first byte lies
// at the same offset mod 16 as in the slab, so that a word of 32 positions
// belongs to one stream.  A group up to the shared-memory tile is staged
// there; a longer stream uses a global scratch region with the same arrays
// (32-bit entries there) and the same code.  In the per-word phases a warp
// takes a contiguous range of words, a lane a position.  Phases, the block
// synchronised after each:
// 1. the bytes, 1 B a position: one bulk asynchronous copy (TMA,
//    cp.async.bulk) a stream for its 16-byte aligned middle, completing on
//    an mbarrier, its head and tail bytes by the threads;
// 2. per word: each position's word (kept: a word read later is one
//    load) and hash (as _prep_kernel), the run bit b[q] != b[q+1], and by
//    __match_any_sync the latest lower lane of the same hash and whether a
//    lane is its hash's last in the word;
// 3. prev() across words by position-ordered passes over hash tables, one
//    per segment of the words (kSegments warps side by side), one step a
//    word: the lanes without a lower peer read the table, the last lane of
//    each hash writes it.  The tables are never cleared: an entry counts
//    only if it points into the part of its segment already passed, inside
//    the stream, at a position of the same hash; garbage that would pass
//    that test has already been overwritten.  Beside them one warp builds
//    the next-word table of the run bits (a reverse min-scan);
// 4. per word: a position without a prev in its segment takes its hash's
//    valid entry in the nearest earlier segment (those lookups at once); the
//    candidate test (a ballot), the same-distance chain bit (q and q + 1
//    candidates at the same distance d > 1), the warp's running count;
// 5. ranks (the warps' counts added), positions by rank, and the match
//    length of each run match (d == 1: from the next run bit) and chain
//    end (up to kLcpWords words in its thread, a longer one queued);
// 6. the queued lengths, a warp each (32 words a step); one warp builds
//    the next-word table of chain ends;
// 7. per chunk of 32 ranks (a warp): inside a chain LCP(p) = (e - p) +
//    LCP(e), e its chain end; the next candidate after the match (a rank:
//    the candidates before p + m, none past the stream); and by pointer
//    doubling in registers (5 rounds of shuffles) each candidate's exit
//    from the chunk and the chain nodes up to it;
// 8. the greedy chain of each stream over the chunks (a lane a stream):
//    from its first candidate, exit to exit, at most one step a chunk,
//    storing at each chunk entry its events before (other ranks: none);
// 9. per chunk: the nodes on the chain from its entries by pointer
//    doubling in registers (a warp-wide OR of each marked node's 2^k-th
//    successor, 5 rounds), each written to its stream's row from its
//    entry's events before and the nodes between.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHashLog = 13;
constexpr int kHashSize = 1 << kHashLog;
constexpr int kMinMatch = 4;
constexpr int kMfLimit = 12;
constexpr int kLastLiterals = 5;
constexpr int kMaxDist = 0xFFFF;
constexpr int kFar = 1 << 30;        // past every position
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint16_t kNoHash = 0xFFFF; // hash of a position without a word
// Design choices, from chip_variants.py's sweep (PERF.md §6).
constexpr int kWarps = 16;           // a block
constexpr int kSegments = 4;         // table passes side by side
constexpr int kLcpWords = 4;         // words a thread compares per chain end
constexpr int kPackBytes = 512;      // streams packed into a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxStreams = kPackBytes / 32;   // region starts 32 apart
constexpr int kSmemBudget = 225 * 1024;        // dynamic, beside the static
static_assert(kSegments >= 1 && kSegments <= kWarps && kWarps <= 32,
              "a warp a segment, one warp scans the warps' totals");
static_assert(kPackBytes % 32 == 0 && kMaxStreams >= 1, "pack in words");

__host__ __device__ constexpr long long up16(long long x) {
  return (x + 15) & ~15LL;
}

// The arrays of a block of P positions (P a multiple of 32, nw = P / 32
// words), in shared memory (I = uint16_t) or in the global scratch
// (I = int32_t).  "By rank": indexed by a candidate's rank in the block.
template <typename I>
struct Arrays {
  I* table;          // kSegments tables of kHashSize: a position
  uint8_t* b;        // the bytes (P + 16)
  uint32_t* w;       // the word of a valid position
  uint16_t* h;       // hash of a valid position, else kNoHash
  I* prev;           // prev + 1 (0: none); then a candidate's distance
  I* raw;            // the table pass's reads; then by rank: its exit
  I* cpos;           // by rank: the candidate's position
  I* clen;           // by rank: its match length
  I* jmp;            // the gallop queue; then by rank: the next candidate
  I* cnt;            // by rank: chain nodes from it to its chunk's exit
  I* base;           // by rank: a chunk entry's events before it in its
                     // stream, else kNone
  uint32_t* cand;    // a bit per position: a candidate
  uint32_t* run;     // a bit per position: b[q] != b[q+1] (or no word)
  uint32_t* chain;   // the table writers; then the same-distance chain bit
  I* wpre;           // candidates before word k (nw + 1)
  I* nrun;           // first word >= k with a run bit (nw + 1)
  I* nend;           // first word >= k with a chain end (nw + 1)
  uint8_t* wsid;     // the block's stream of word k
};

// Bytes of the arrays of P positions; with `a`, their addresses at base.
template <typename I>
__host__ __device__ long long carve(unsigned char* base, long long P,
                                    Arrays<I>* a) {
  const long long nw = P / 32;
  const long long per = up16(static_cast<long long>(sizeof(I)) * P);
  const long long words = up16(4 * nw);
  const long long idx = up16(static_cast<long long>(sizeof(I)) * (nw + 1));
  long long o = up16(static_cast<long long>(sizeof(I)) * kSegments *
                     kHashSize);
  const long long ob = o;
  o += up16(P + 16);
  const long long ow4 = o;
  o += 4 * P;
  const long long oh = o;
  o += up16(2 * P);
  const long long op = o;
  o += 7 * per;
  const long long oc = o;
  o += 3 * words;
  const long long ow = o;
  o += 3 * idx;
  const long long ows = o;
  o += up16(nw);
  if (a != nullptr) {
    I* arr[7];
    for (int i = 0; i < 7; ++i)
      arr[i] = reinterpret_cast<I*>(base + op + i * per);
    uint32_t* wd[3];
    for (int i = 0; i < 3; ++i)
      wd[i] = reinterpret_cast<uint32_t*>(base + oc + i * words);
    I* ix[3];
    for (int i = 0; i < 3; ++i) ix[i] = reinterpret_cast<I*>(base + ow + i * idx);
    a->table = reinterpret_cast<I*>(base);
    a->b = base + ob;
    a->w = reinterpret_cast<uint32_t*>(base + ow4);
    a->h = reinterpret_cast<uint16_t*>(base + oh);
    a->prev = arr[0];
    a->raw = arr[1];
    a->cpos = arr[2];
    a->clen = arr[3];
    a->jmp = arr[4];
    a->cnt = arr[5];
    a->base = arr[6];
    a->cand = wd[0];
    a->run = wd[1];
    a->chain = wd[2];
    a->wpre = ix[0];
    a->nrun = ix[1];
    a->nend = ix[2];
    a->wsid = base + ows;
  }
  return o;
}

int tile_max() {
  static int t = -1;   // a constant of the build, found once
  if (t < 0) {
    int m = 0;
    while (m + 128 < 65535 - 32 &&
           carve<uint16_t>(nullptr, m + 128, nullptr) <= kSmemBudget)
      m += 128;
    t = m;
  }
  return t;
}

// No rank / no jump: above every rank of a block.
template <typename I>
__host__ __device__ constexpr int none() {
  return sizeof(I) == 2 ? 0xFFFF : 0x7FFFFFFF;
}

// The block's streams (static shared memory).
struct Streams {
  uint64_t bar;                     // the bulk copies' mbarrier
  long long start[kMaxStreams];     // in the slab
  long long row[kMaxStreams];       // first event row
  int cst[kMaxStreams];             // block-local first position
  int len[kMaxStreams];
  int warp_tot[kWarps];             // each warp's candidates
  int count[kMaxStreams];           // each stream's events
  int nq;                           // gallop queue length
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)),
        "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The little-endian word of the 4 bytes at x (b 4-byte aligned, 8 bytes
// readable from x & ~3).
__device__ __forceinline__ uint32_t word_at(const uint8_t* b, int x) {
  const uint32_t* a = reinterpret_cast<const uint32_t*>(b) + (x >> 2);
  return __funnelshift_r(a[0], a[1], 8 * (x & 3));
}

__device__ __forceinline__ unsigned below(int bit) {
  return (1u << bit) - 1u;
}

// out[k] = the first word k' >= k with nonzero(k'), else n (out[n] = n):
// one warp, a lane a contiguous range of words, joined by a suffix min.
template <typename I, typename F>
__device__ void next_words(int n, F nonzero, I* out, int lane) {
  const int per = (n + 31) / 32;
  const int k0 = min(lane * per, n), k1 = min(k0 + per, n);
  int first = n;
  #pragma unroll 1
  for (int k = k1 - 1; k >= k0; --k)
    if (nonzero(k)) first = k;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(kFull, first, o);
    if (lane + o < 32) first = min(first, y);
  }
  int carry = __shfl_down_sync(kFull, first, 1);
  if (lane == 31) carry = n;
  #pragma unroll 1
  for (int k = k1 - 1; k >= k0; --k) {
    if (nonzero(k)) carry = k;
    out[k] = static_cast<I>(carry);
  }
  if (lane == 0) out[n] = static_cast<I>(n);
}

// First position >= x whose bit is set (INV: clear) in bits (n words),
// with nxt the next word holding one; kFar if none.
template <bool INV, typename I>
__device__ __forceinline__ int next_bit(const uint32_t* bits, const I* nxt,
                                        int n, int x) {
  const int k = x >> 5;
  if (k >= n) return kFar;
  const uint32_t v = (INV ? ~bits[k] : bits[k]) & (kFull << (x & 31));
  if (v) return 32 * k + __ffs(v) - 1;
  const int k2 = static_cast<int>(nxt[k + 1]);
  if (k2 >= n) return kFar;
  return 32 * k2 + __ffs(INV ? ~bits[k2] : bits[k2]) - 1;
}

// Candidates before position x (x < 32 n): the rank of the first
// candidate at or after x.
template <typename I>
__device__ __forceinline__ int rank_at(const Arrays<I>& a, int x) {
  return static_cast<int>(a.wpre[x >> 5]) +
         __popc(a.cand[x >> 5] & below(x & 31));
}

// min(LCP(p, c), cap) from m, the first m bytes known equal (the warp,
// 32 words a step while they agree and fit, then at most 3 bytes).
__device__ int gallop(const uint32_t* w, int p, int c, int cap, int m,
                      int lane) {
  for (;;) {
    const int x = m + 4 * lane;
    const bool ok = x + 4 <= cap && w[p + x] == w[c + x];
    const unsigned bad = __ballot_sync(kFull, !ok);
    if (bad == 0u) {
      m += 128;
      continue;
    }
    m += 4 * (__ffs(bad) - 1);
    break;
  }
  if (m < cap) {
    const uint32_t x = w[p + m] ^ w[c + m];
    const int e = x ? (__ffs(x) - 1) >> 3 : 4;
    m += min(min(e, 3), cap - m);
  }
  return m;
}

// Phase markers (empty; chip_variants.py's clocks fill them in).
#define PHASE_MARK(i)

// Phases 2-8 of the block's ns streams over nw words; the bytes staged.
// A warp takes a contiguous range of words in the per-word phases.
template <typename I>
__device__ void match_block(const Arrays<I>& a, Streams& st, int ns, int nw,
                            int S, long long E, int s0,
                            int32_t* __restrict__ out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int kNone = none<I>();
  if (nw == 0) {   // no byte in the block's streams
    for (int j = tid; j < ns; j += kThreads) out[s0 + j] = 0;
    return;
  }
  const int wpw = (nw + kWarps - 1) / kWarps;
  const int kw0 = min(warp * wpw, nw), kw1 = min(kw0 + wpw, nw);

  // -- 2. words, hashes, run bits, peers within a word --------------------
  #pragma unroll 1
  for (int k = kw0; k < kw1; ++k) {
    const int q = 32 * k + lane;
    const int j = a.wsid[k];
    const int lq = q - st.cst[j];
    const bool valid = lq >= 0 && lq + 4 <= st.len[j];
    const uint32_t wq = valid ? word_at(a.b, q) : 0u;
    const uint32_t hq = valid ? (wq * 2654435761u) >> (32 - kHashLog)
                              : static_cast<uint32_t>(kHashSize + lane);
    const unsigned peers = __match_any_sync(kFull, hq);
    const unsigned lower = peers & below(lane);
    a.w[q] = wq;
    a.h[q] = valid ? static_cast<uint16_t>(hq) : kNoHash;
    a.prev[q] = static_cast<I>(valid && lower ? 32 * k + 32 - __clz(lower)
                                              : 0);
    const unsigned wr = __ballot_sync(kFull, valid &&
                                                 lane == 31 - __clz(peers));
    const unsigned rb = __ballot_sync(
        kFull, !valid || ((wq ^ (wq >> 8)) & 0xFFu) != 0u);
    if (lane == 0) {
      a.chain[k] = wr;
      a.run[k] = rb;
    }
  }
  __syncthreads();
  PHASE_MARK(2);

  // -- 3. the segments' table passes; the last warp: next run words -------
  const int nseg = min(kSegments, nw);
  const int segw = (nw + nseg - 1) / nseg;
  if (warp < nseg) {
    I* table = a.table + warp * kHashSize;
    const int k0 = warp * segw, k1 = min(k0 + segw, nw);
    if (k0 < k1) {
      int q = 32 * k0 + lane;
      uint32_t hq = a.h[q];
      bool need = hq != kNoHash && a.prev[q] == 0;
      bool wr = (a.chain[k0] >> lane) & 1u;
      #pragma unroll 1
      for (int k = k0; k < k1; ++k) {
        uint32_t hn = kNoHash;
        bool nn = false, wn = false;
        if (k + 1 < k1) {
          hn = a.h[q + 32];
          nn = hn != kNoHash && a.prev[q + 32] == 0;
          wn = (a.chain[k + 1] >> lane) & 1u;
        }
        if (need) a.raw[q] = table[hq];
        __syncwarp();
        if (wr) table[hq] = static_cast<I>(q);
        __syncwarp();
        q += 32;
        hq = hn;
        need = nn;
        wr = wn;
      }
    }
  }
  if (warp == kWarps - 1)
    next_words(nw, [&](int k) { return a.run[k] != 0u; }, a.nrun, lane);
  __syncthreads();
  PHASE_MARK(3);

  // -- 4. prev across segments, the candidate test, chain bits, ranks in
  //       the warp's words --------------------------------------------------
  int running = 0;
  #pragma unroll 1
  for (int k = kw0; k < kw1; ++k) {
    const int q = 32 * k + lane;
    const int j = a.wsid[k];
    const int c0 = st.cst[j];
    const int lq = q - c0;
    const uint32_t hq = a.h[q];
    int p1 = static_cast<int>(a.prev[q]);
    if (hq != kNoHash && p1 == 0) {
      // this segment's table read, else the nearest earlier segment's
      // valid entry (those lookups issued at once)
      int g = 0;
#pragma unroll
      for (int t = 1; t < kSegments; ++t) g += k >= t * segw;
      const int e = static_cast<int>(a.raw[q]);
      if (e >= max(32 * g * segw, c0) && e < 32 * k && a.h[e] == hq) {
        p1 = e + 1;
      } else {
        int ev[kSegments];
#pragma unroll
        for (int t = 0; t + 1 < kSegments; ++t) {
          const int g2 = g - 1 - t;
          ev[t] = g2 >= 0 && 32 * (g2 + 1) * segw > c0
                      ? static_cast<int>(a.table[g2 * kHashSize + hq]) : -1;
        }
#pragma unroll
        for (int t = kSegments - 2; t >= 0; --t) {
          const int g2 = g - 1 - t;
          const int et = ev[t];
          if (et >= 0 && et >= max(32 * g2 * segw, c0) &&
              et < 32 * (g2 + 1) * segw && a.h[et] == hq)
            p1 = et + 1;
        }
      }
    }
    bool c = p1 != 0 && lq < st.len[j] - kMfLimit;
    int d = 0;
    if (c) {
      d = q - (p1 - 1);
      c = d <= kMaxDist && a.w[q] == a.w[p1 - 1];
      if (c && d == 1 && lq >= 2 && (lq & 3) != 0) {   // the run-stride rule
        const uint32_t v = a.w[q - 2];
        c = (v & 0xFFu) != ((v >> 8) & 0xFFu);
      }
    }
    if (!c) d = 0;
    a.prev[q] = static_cast<I>(d);
    const unsigned cw = __ballot_sync(kFull, c);
    const int dn = __shfl_down_sync(kFull, d, 1);
    const unsigned lw = __ballot_sync(
        kFull, c && lane < 31 && ((cw >> (lane + 1)) & 1u) && dn == d && d > 1);
    if (lane == 0) {
      a.cand[k] = cw;
      a.chain[k] = lw;   // bit 31 (the next word's first position) below
      a.wpre[k] = static_cast<I>(running);
    }
    running += __popc(cw);
  }
  if (lane == 0) st.warp_tot[warp] = running;
  __syncthreads();
  PHASE_MARK(4);

  // -- 5. block ranks, positions by rank, lengths of run matches and chain
  //       ends (longer than kLcpWords words: queued) -----------------------
  int before = 0, C = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int n = st.warp_tot[w];
    before += w < warp ? n : 0;
    C += n;
  }
  #pragma unroll 1
  for (int k = kw0; k < kw1; ++k) {
    const int q = 32 * k + lane;
    const uint32_t cw = a.cand[k];
    const bool c = (cw >> lane) & 1u;
    const int d = static_cast<int>(a.prev[q]);
    const int r0 = static_cast<int>(a.wpre[k]) + before;
    bool l31 = false;
    if (lane == 31 && c && k + 1 < nw)
      l31 = d > 1 && (a.cand[k + 1] & 1u) && static_cast<int>(a.prev[q + 1]) == d;
    const uint32_t lw = a.chain[k] | __ballot_sync(kFull, l31);
    if (lane == 0) {
      a.chain[k] = lw;
      a.wpre[k] = static_cast<I>(r0);
    }
    if (c) {
      const int r = r0 + __popc(cw & below(lane));
      a.cpos[r] = static_cast<I>(q);
      const int j = a.wsid[k];
      const int cap = st.cst[j] + st.len[j] - kLastLiterals - q;
      int m = 0;
      if (d == 1) {
        m = min(next_bit<false>(a.run, a.nrun, nw, q) - q + 1, cap);
      } else if (!((lw >> lane) & 1u)) {   // a chain end: measure
        int e = 4;
        m = kMinMatch;
#pragma unroll
        for (int t = 0; t < kLcpWords && e == 4 && m < cap; ++t) {
          const uint32_t x = a.w[q + m] ^ a.w[q - d + m];
          e = x ? (__ffs(x) - 1) >> 3 : 4;
          m += min(e, cap - m);
        }
        if (e == 4 && m < cap) {   // longer than kLcpWords words: the warps
          a.jmp[atomicAdd(&st.nq, 1)] = static_cast<I>(r);
          m = 0;
        }
      }
      a.clen[r] = static_cast<I>(m);
    }
  }
  if (tid == 0) a.wpre[nw] = static_cast<I>(C);
  __syncthreads();
  PHASE_MARK(5);

  // -- 6. the queued lengths, a warp each; the last warp: next chain ends --
  const int nq = st.nq;
  #pragma unroll 1
  for (int t = warp; t < nq; t += kWarps) {
    const int r = static_cast<int>(a.jmp[t]);
    const int p = static_cast<int>(a.cpos[r]);
    const int j = a.wsid[p >> 5];
    const int cap = st.cst[j] + st.len[j] - kLastLiterals - p;
    const int m = gallop(a.w, p, p - static_cast<int>(a.prev[p]), cap,
                         kMinMatch + 4 * kLcpWords, lane);
    if (lane == 0) a.clen[r] = static_cast<I>(m);
  }
  if (warp == kWarps - 1)
    next_words(nw, [&](int k) { return ~a.chain[k] != 0u; }, a.nend, lane);
  __syncthreads();
  PHASE_MARK(6);

  // -- 7. per chunk of 32 ranks (a warp): lengths inside chains, the next
  //       candidate, and by pointer doubling in registers each candidate's
  //       exit from the chunk and the chain nodes up to it ---------------
  const int nch = (C + 31) >> 5;
  #pragma unroll 1
  for (int ch = warp; ch < nch; ch += kWarps) {
    const int r = 32 * ch + lane;
    const bool act = r < C;
    int J = kNone;
    if (act) {
      const int p = static_cast<int>(a.cpos[r]);
      int m = static_cast<int>(a.clen[r]);
      if (m == 0) {   // inside a same-distance chain: LCP(e) + (e - p)
        const int e = next_bit<true>(a.chain, a.nend, nw, p);
        m = e - p + static_cast<int>(a.clen[rank_at(a, e)]);
        a.clen[r] = static_cast<I>(m);
      }
      const int j = a.wsid[p >> 5];
      const int re =
          static_cast<int>(a.wpre[(st.cst[j] + st.len[j] + 31) >> 5]);
      const int t = rank_at(a, p + m);
      J = t < re ? t : kNone;
      a.jmp[r] = static_cast<I>(J);
    }
    int nx = J != kNone && J < 32 * ch + 32 ? J - 32 * ch : -1;
    int ex = J, cn = act ? 1 : 0;
#pragma unroll
    for (int round = 0; round < 5; ++round) {
      const int src = nx >= 0 ? nx : lane;
      const int n2 = __shfl_sync(kFull, nx, src);
      const int e2 = __shfl_sync(kFull, ex, src);
      const int c2 = __shfl_sync(kFull, cn, src);
      if (nx >= 0) {
        cn += c2;
        ex = e2;
        nx = n2;
      }
    }
    if (act) {
      a.raw[r] = static_cast<I>(ex);
      a.cnt[r] = static_cast<I>(cn);
      a.base[r] = static_cast<I>(kNone);
    }
  }
  __syncthreads();
  PHASE_MARK(7);

  // -- 8. each stream's chain over the chunks (a lane a stream): where it
  //       enters each chunk, its events before, its count ------------------
  if (warp == 0) {
    #pragma unroll 1
    for (int j = lane; j < ns; j += 32) {
      const int rb = static_cast<int>(a.wpre[st.cst[j] >> 5]);
      const int re =
          static_cast<int>(a.wpre[(st.cst[j] + st.len[j] + 31) >> 5]);
      int total = 0;
      for (int e = rb < re ? rb : kNone; e != kNone;
           e = static_cast<int>(a.raw[e])) {
        a.base[e] = static_cast<I>(total);
        total += static_cast<int>(a.cnt[e]);
      }
      st.count[j] = total;
    }
  }
  __syncthreads();
  PHASE_MARK(8);

  // -- 9. the events: per chunk, the nodes on the chain from its entries
  //       (pointer doubling in registers), each at its entry's base -------
  for (int j = tid; j < ns; j += kThreads) out[s0 + j] = st.count[j];
  int32_t* pos = out + S;
  int32_t* dst = out + S + E;
  int32_t* len = out + S + 2 * E;
  #pragma unroll 1
  for (int ch = warp; ch < nch; ch += kWarps) {
    const int r = 32 * ch + lane;
    const bool act = r < C;
    const int eb = act ? static_cast<int>(a.base[r]) : kNone;
    const uint32_t ent = __ballot_sync(kFull, eb != kNone);
    if (ent == 0u) continue;
    const int J = act ? static_cast<int>(a.jmp[r]) : kNone;
    int s = J != kNone && J < 32 * ch + 32 ? J - 32 * ch : -1;
    const int cn = act ? static_cast<int>(a.cnt[r]) : 0;
    bool on = (ent >> lane) & 1u;
#pragma unroll
    for (int round = 0; round < 5; ++round) {
      const unsigned hit = __reduce_or_sync(kFull, on && s >= 0 ? 1u << s : 0u);
      on = on || ((hit >> lane) & 1u);
      const int s2 = __shfl_sync(kFull, s, s >= 0 ? s : lane);
      s = s >= 0 ? s2 : -1;
    }
    // the entry of a node's path: the last entry at or before it (streams
    // hold disjoint rank ranges)
    const int el = (31 - __clz(ent & (kFull >> (31 - lane)))) & 31;
    const int cne = __shfl_sync(kFull, cn, el);
    const int ebe = __shfl_sync(kFull, eb, el);
    if (on) {
      const int p = static_cast<int>(a.cpos[r]);
      const int j = a.wsid[p >> 5];
      const long long row = st.row[j] + ebe + cne - cn;
      pos[row] = static_cast<int32_t>(st.start[j] + (p - st.cst[j]));
      dst[row] = static_cast<int32_t>(a.prev[p]);
      len[row] = static_cast<int32_t>(a.clen[r]);
    }
  }
  PHASE_MARK(9);
}

// meta (int64): starts (S) | ends (S) | row_start (S) | scratch offset (S;
// -1: staged in shared memory) | block-local first position (S) | each
// block's first stream (B + 1).  out: count (S) | pos | dist | mlen (E
// each), int32.
__global__ void __launch_bounds__(kThreads)
lz4_match_kernel(const uint8_t* __restrict__ buf,
                 const long long* __restrict__ meta, int S, int tile,
                 unsigned char* __restrict__ scratch,
                 int32_t* __restrict__ out, long long E) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Streams st;
  const int tid = threadIdx.x;
  const int s0 = static_cast<int>(meta[5 * S + blockIdx.x]);
  const int ns = static_cast<int>(meta[5 * S + blockIdx.x + 1]) - s0;
  const long long soff = meta[3 * S + s0];
  for (int j = tid; j < ns; j += kThreads) {
    st.start[j] = meta[s0 + j];
    st.len[j] = static_cast<int>(meta[S + s0 + j] - meta[s0 + j]);
    st.row[j] = meta[2 * S + s0 + j];
    st.cst[j] = static_cast<int>(meta[4 * S + s0 + j]);
  }
  if (tid == 0) {
    st.nq = 0;
    mbar_init(&st.bar, 1);
    // the barrier's init visible to the copy engine (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  PHASE_MARK(0);
  const int nw = (st.cst[ns - 1] + st.len[ns - 1] + 31) >> 5;
  if (soff < 0) {
    Arrays<uint16_t> a;
    carve<uint16_t>(smem, tile, &a);
    // -- 1. the bytes: a bulk copy a stream, head and tail bytes by hand --
    if (tid < 32) {
      uint32_t total = 0;
      for (int j = tid; j < ns; j += 32) {
        const uintptr_t g = reinterpret_cast<uintptr_t>(buf + st.start[j]);
        const uintptr_t lo = (g + 15) & ~uintptr_t(15);
        const uintptr_t hi = (g + st.len[j]) & ~uintptr_t(15);
        if (hi > lo) total += static_cast<uint32_t>(hi - lo);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        total += __shfl_xor_sync(kFull, total, o);
      if (tid == 0) mbar_expect_tx(&st.bar, total);
      __syncwarp();
      for (int j = tid; j < ns; j += 32) {
        const uint8_t* g = buf + st.start[j];
        const uintptr_t lo = (reinterpret_cast<uintptr_t>(g) + 15) &
                             ~uintptr_t(15);
        const uintptr_t hi = (reinterpret_cast<uintptr_t>(g) + st.len[j]) &
                             ~uintptr_t(15);
        if (hi > lo)
          bulk_copy(a.b + st.cst[j] + (lo - reinterpret_cast<uintptr_t>(g)),
                    reinterpret_cast<const void*>(lo),
                    static_cast<uint32_t>(hi - lo), &st.bar);
      }
    }
    #pragma unroll 1
    for (int i = tid; i < 32 * ns; i += kThreads) {
      const int j = i >> 5, t = i & 31;
      const uint8_t* g = buf + st.start[j];
      const int L = st.len[j];
      const int head = static_cast<int>(
          ((reinterpret_cast<uintptr_t>(g) + 15) & ~uintptr_t(15)) -
          reinterpret_cast<uintptr_t>(g));
      const int tail = static_cast<int>(
          ((reinterpret_cast<uintptr_t>(g) + L) & ~uintptr_t(15)) -
          reinterpret_cast<uintptr_t>(g));
      int x;
      if (tail <= head)   // no aligned middle: the whole stream (< 32 B)
        x = t;
      else if (t < 16)
        x = t < head ? t : L;
      else
        x = tail + t - 16;
      if (x < L) a.b[st.cst[j] + x] = g[x];
    }
    #pragma unroll 1
    for (int k = tid; k < nw; k += kThreads) {
      int lo = 0, hi = ns - 1;   // the last stream whose region starts <= k
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if ((st.cst[mid] >> 5) <= k)
          lo = mid;
        else
          hi = mid - 1;
      }
      a.wsid[k] = static_cast<uint8_t>(lo);
    }
    mbar_wait(&st.bar, 0);
    __syncthreads();
    PHASE_MARK(1);
    match_block(a, st, ns, nw, S, E, s0, out);
  } else {
    // one stream past the tile: the same arrays in its global scratch
    Arrays<int32_t> a;
    carve<int32_t>(scratch + soff, (32LL * nw + 511) / 512 * 512, &a);
    const uint8_t* g = buf + st.start[0];
    for (int x = tid; x < st.len[0]; x += kThreads) a.b[st.cst[0] + x] = g[x];
    for (int k = tid; k < nw; k += kThreads) a.wsid[k] = 0;
    __syncthreads();
    PHASE_MARK(1);
    match_block(a, st, ns, nw, S, E, s0, out);
  }
}

}  // namespace

// Largest block of positions (a multiple of 128) staged in shared memory;
// the wrapper gives a stream whose region is longer global scratch.
extern "C" int lz4_match_tile_max() { return tile_max(); }

// Streams of up to this many region bytes are packed several to a block.
extern "C" int lz4_match_pack_bytes() { return kPackBytes; }

// Bytes of a long stream's global scratch for P positions (P a multiple of
// 512: then affine in P).
extern "C" int lz4_match_scratch_bytes(int P) {
  return static_cast<int>(carve<int32_t>(nullptr, P, nullptr));
}

// buf: the slab's bytes; meta: int64 (see the kernel), each block's
// streams' regions (32-byte granules from their block-local first
// position, which lies at the stream's address mod 16) within `tile`
// positions, at most lz4_match_pack_bytes() / 32 streams a block; tile: a
// multiple of 128, at most lz4_match_tile_max(); scratch: each long
// stream's lz4_match_scratch_bytes() at its 16-byte aligned offset; out:
// S + 3 * E int32.  B blocks.  Returns the launch's cudaError_t.
extern "C" int lz4_match(const void* buf, const void* meta, int S, int B,
                         int tile, void* scratch, void* out, long long E,
                         int device, void* stream) {
  if (S < 0 || B < 0 || tile < 0 || tile % 128 != 0 || tile > tile_max() ||
      E < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (S == 0 || B == 0) return 0;
  const int smem =
      tile > 0 ? static_cast<int>(carve<uint16_t>(nullptr, tile, nullptr))
               : 0;
  static int smem_set[64] = {};   // per device, the largest set so far
  if (smem > 48 * 1024 && (device < 0 || device >= 64 ||
                           smem > smem_set[device])) {
    err = cudaFuncSetAttribute(lz4_match_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device >= 0 && device < 64) smem_set[device] = smem;
  }
  lz4_match_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), static_cast<const long long*>(meta),
      S, tile, static_cast<unsigned char*>(scratch),
      static_cast<int32_t*>(out), E);
  return static_cast<int>(cudaGetLastError());
}
