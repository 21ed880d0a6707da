// One-token GQA decode attention for Hopper (sm_90a) over a bf16 or
// fp8-e4m3 KV cache, split over the sequence (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/decode_attn.py::_kernel
// (decode_attention_pallas).  For each batch row b and query head h:
//   s[t]   = scale * <q[b, h], k[b, t, h / G]>      (f32, G = H / KV)
//   s[t]   = -1e30 for t >= valid_len
//   out    = softmax(s) . v[b, :, h / G]             (f32)
// The port's decode step hands it q already scaled (scale = 1), which is
// exactly what the reference decode step's attention computes.
//
// Bound on this card: memory.  A decode step reads every valid K and V
// row once (2 * valid_len * KV * hd * elem bytes per batch row) and does
// 4 flops per cached element, a few per byte: far below the ~300 flops
// per byte at which the H100's arithmetic would become the limit.  At
// short lengths the bytes are few, so what counts is how many SMs share
// them and how few dependent steps (round trips to memory, barriers,
// shuffle trees) each block takes; at long ones, how many bytes each SM
// keeps in flight.
//
// The split.  A grid of (B * KV, n_split) blocks; block (bg, s) takes the
// positions [s * chunk, min((s + 1) * chunk, valid_len)) of its (batch
// row, KV head), `chunk` a multiple of 32 positions (a tile).  `active` =
// ceil(valid_len / chunk) blocks hold positions.  Two entries share the
// body:
// - decode_attn takes valid_len and chunk by value, and the grid is
//   exactly the active blocks;
// - decode_attn_devlen reads valid_len from device memory (the decode
//   step's position, as the reference's jitted step traces it), so one
//   launch serves every position and a CUDA graph replays it.  Every
//   block computes the split from the length it reads: split_tiles()
//   below is the wrapper's split_size() rule, its constants passed in
//   (kernels/decode_attn.py::split_rule: a context of up to 2048
//   positions spreads over 16 blocks, or over 8 where a block carries
//   hd x heads of 1024 or more).  So a short context in a long cache is
//   spread over as many blocks as the host entry would give it, not over
//   the capacity's blocks.  The grid is fixed by the capacity S: the most
//   blocks the rule gives any length in [1, S] (rule_grid()).  Blocks at
//   or past `active` do no loads and push nothing.
// The block carries the online-softmax state (m, l, acc) of the G query
// heads that share its KV head, so each K/V row is read once for all G
// heads.
// - Steps of 64 positions through a ring of 3 stages in shared memory
//   (measured faster than 4 at hd 64): TMA (cp.async.bulk.tensor over
//   the cache's (B * S, KV * hd) view) copies a step's K and V rows as
//   stored (bf16 or fp8), one box of 32 rows per tile the step holds,
//   and completes on the stage's mbarrier.  Thread 0 refills a stage
//   once every thread has passed the step that read it, so up to 2 steps
//   are in flight while one is computed.  K lands in the 32/64/128-byte
//   swizzle of its row width, so the mma fragments' reads of 8
//   neighbouring rows hit distinct banks; V lands dense.  Registers are
//   capped so that three blocks share an SM at hd 64 (the decode_32k
//   cell's 272 blocks in one wave).
// - Scores on the tensor cores: warp w takes the step's positions 8w ..
//   8w + 7, an m16n8k16 bf16 mma a 16 dims with the G heads as the
//   mma's rows (those past G zero; q held as fragments in registers) and
//   f32 accumulation.  Products of bf16 q and bf16 K are exact, and an
//   fp8 K widens to bf16 exactly, so only the order of the sum differs
//   from the plain version.
// - Softmax: each warp takes its positions' max per head, one block
//   barrier a step shares the 8 warps' maxima (double-buffered by step
//   parity), and every warp computes the same running max; each warp
//   keeps its own share of the denominators.
// - P.V in f32 on CUDA cores (a bf16 mma would round p, which the
//   tolerance against the f32 plain version does not allow): each warp
//   over its own 8 positions, a lane kD = hd / 32 dims of every head, p
//   read 4 heads at a time from the warp's table; positions past the
//   range are skipped.  At the end the warps' shares are summed in warp
//   order.
// Merging the active blocks' (m, l, acc) partials, in split order
// against their joint max:
// - one active block writes the output itself; no block of the launch
//   meets a barrier or touches another's memory;
// - a grid of up to 16 blocks a row is one thread block cluster a row.
//   Each active block pushes its partials into the active block that
//   owns each output (distributed shared memory) and after one cluster
//   barrier merges its own share locally — no trip through device memory
//   (a merge through it costs a store, a fence, an atomic and loads,
//   each a dependent round trip).  Blocks past `active` own nothing and
//   receive nothing, but still arrive at and wait on both cluster
//   barriers (the one before the first push and the one after the last),
//   so every barrier completes with every thread of the cluster, and no
//   block leaves while a peer can still reach its shared memory;
// - a larger grid: each active block writes its partials to the
//   caller's scratch; the last of the active blocks to finish (an integer
//   counter, after __threadfence) merges them and sets the counter back
//   to 0, so a zeroed counter buffer stays zeroed across calls and
//   replays at any length.
// No float atomics, so two calls on the same inputs give bit-equal
// outputs; one launch in all.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStep = 64;               // positions per step
constexpr int kWarpPos = kStep / kWarps;  // a warp's positions in a step
constexpr int kTile = 32;               // rows per TMA box: the split's tile
constexpr int kMaxG = 16;               // query heads per KV head
constexpr int kMaxSplits = 64;          // blocks per (batch row, KV head)
constexpr int kClusterSplits = 16;      // up to this many: merged on chip
constexpr int kMaxStages = 3;
// dynamic shared memory a block takes at most, so that two fit an SM
constexpr int kSmemBudget = 110 * 1024;
constexpr float kMasked = -1e30f;

// The sequence split's rule, kernels/decode_attn.py::split_size, in
// tiles; the wrapper passes its constants.
struct SplitRule {
  int tile, cluster_splits, cluster_tiles, merge_splits, merge_tiles,
      max_splits, blocks_per_sm, rows, sms;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Tiles a block for `tiles` tiles of a row, by the rule.  The divisions
// are independent of each other, so that a block computes them side by
// side rather than one after another.
__host__ __device__ __forceinline__ int split_tiles(int tiles,
                                                    const SplitRule& r) {
  const long long slots = (long long)r.blocks_per_sm * r.sms;
  const int cluster = cdiv(tiles, r.cluster_splits);
  const int merge = cdiv(tiles, r.merge_splits);
  const int most = cdiv(tiles, r.max_splits);
  const int spread =
      static_cast<int>(((long long)tiles * r.rows + slots - 1) / slots);
  int per = merge > r.merge_tiles ? most : merge;
  per = per > spread ? per : spread;
  if (tiles <= r.cluster_splits * r.cluster_tiles) per = cluster;
  return per;
}

// Blocks a row that the rule's split takes at most over a cache of S
// slots: the least grid that holds every length's split.  The last
// capacity and rule asked are kept, as a launch asks for them again.
int rule_grid(int S, const SplitRule& r) {
  static thread_local int last_s = 0;
  static thread_local SplitRule last_r = {};
  static thread_local int last_n = 0;
  if (S == last_s && r.tile == last_r.tile &&
      r.cluster_splits == last_r.cluster_splits &&
      r.cluster_tiles == last_r.cluster_tiles &&
      r.merge_splits == last_r.merge_splits &&
      r.merge_tiles == last_r.merge_tiles &&
      r.max_splits == last_r.max_splits &&
      r.blocks_per_sm == last_r.blocks_per_sm && r.rows == last_r.rows &&
      r.sms == last_r.sms)
    return last_n;
  int most = 1;
  for (int t = 1; t <= cdiv(S, r.tile); ++t) {
    const int n = cdiv(t, split_tiles(t, r));
    most = n > most ? n : most;
  }
  last_s = S;
  last_r = r;
  last_n = most;
  return most;
}

// V: kD neighbouring cache elements -> f32.
template <int kD>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p, float* v) {
  if constexpr (kD == 1) {
    v[0] = __uint_as_float(
        static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
  } else if constexpr (kD == 2) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xFFFF0000u);
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(w.x << 16);
    v[1] = __uint_as_float(w.x & 0xFFFF0000u);
    v[2] = __uint_as_float(w.y << 16);
    v[3] = __uint_as_float(w.y & 0xFFFF0000u);
  }
}
template <int kD>
__device__ __forceinline__ void load_v(const __nv_fp8_e4m3* p, float* v) {
  if constexpr (kD == 1) {
    v[0] = static_cast<float>(*p);
  } else {
#pragma unroll
    for (int i = 0; i < kD; i += 2) {
      __nv_fp8x2_e4m3 x;
      x.__x = *reinterpret_cast<const __nv_fp8x2_storage_t*>(p + i);
      const float2 f = static_cast<float2>(x);
      v[i] = f.x;
      v[i + 1] = f.y;
    }
  }
}
// K: two neighbouring elements at `addr` as the bf16 pair an mma takes
// (an fp8 value widens to bf16 exactly).
__device__ __forceinline__ uint32_t k_pair(const uint8_t* addr,
                                           __nv_bfloat16) {
  return *reinterpret_cast<const uint32_t*>(addr);
}
__device__ __forceinline__ uint32_t k_pair(const uint8_t* addr,
                                           __nv_fp8_e4m3) {
  __nv_fp8x2_e4m3 x;
  x.__x = *reinterpret_cast<const __nv_fp8x2_storage_t*>(addr);
  const float2 f = static_cast<float2>(x);
  const __nv_bfloat162 h = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// d += a . b: one m16n8k16 bf16 product, f32 accumulation
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// HPW = 1: groups of up to 8 query heads, 2: up to 16 (the mma's rows).
template <int HD, typename T, int HPW>
struct Geo {
  static constexpr int kRowBytes = HD * sizeof(T);
  // K: boxes of up to 128 bytes a row, each in the swizzle of its width
  static constexpr int kBoxBytes = kRowBytes < 128 ? kRowBytes : 128;
  static constexpr int kBoxes = kRowBytes / kBoxBytes;   // per row
  static constexpr int kSwizzle = kBoxBytes / 16 - 1;    // 1, 3 or 7
  static constexpr int kTileBytes = kTile * kRowBytes;   // K or V of a tile
  static constexpr int kHalf = kStep * kRowBytes;        // K or V of a step
  static constexpr int kStage = 2 * kHalf;
  static constexpr int kG = 8 * HPW;                     // heads, most
  static constexpr int kRows = kG / 8;                   // per lane group
  static constexpr int kDims = HD / 32;                  // P.V: per lane
  static constexpr int kKSteps = HD / 16;                // mma k-steps
  static constexpr int kAcc = (kG * HD + kThreads - 1) / kThreads;
  // after the stages: each warp's p table [kWarpPos][kG], the cluster
  // merge's inbox (a share of the outputs from each block: G * HD
  // floats, rounded up per block)
  static constexpr int kRest =
      kWarps * kWarpPos * kG * 4 + (kG * HD + kClusterSplits) * 4;
  // stages: what the budget leaves room for, 2 to kMaxStages, and at
  // least what the warps' partials take once the loop is done
  static constexpr int kFit = (kSmemBudget - 1024 - kRest) / kStage;
  static constexpr int kDeep =
      kFit < 2 ? 2 : (kFit > kMaxStages ? kMaxStages : kFit);
  static constexpr int kRed = (kWarps * kG * HD * 4 + kStage - 1) / kStage;
  static constexpr int kStages = kDeep > kRed ? kDeep : kRed;
  // 1024: slack to align the stages for the 128-byte swizzle
  static constexpr int kSmem = 1024 + kStages * kStage + kRest;
  // blocks an SM the registers are capped for (three at hd 64, so that
  // the decode_32k cell's 272 blocks run in one wave)
  static constexpr int kMinBlocks =
      HD * kG <= 512 ? 3 : (HD * kG <= 1024 ? 2 : 1);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
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
// a box of the tensor map at element (x, y) into shared memory, counted
// on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
        "r"(smem_addr(bar)), "r"(x), "r"(y)
      : "memory");
}

// K row p (0..63 of a step), byte eb: box (p / 32, eb / box width),
// then the swizzle: 16-byte chunk bits 4.. xor row-line bits 7..
template <class L>
__device__ __forceinline__ const uint8_t* k_addr(const uint8_t* ksm, int p,
                                                 int eb) {
  const int o = (p % kTile) * L::kBoxBytes + eb % L::kBoxBytes;
  const int box = (p / kTile) * L::kBoxes + eb / L::kBoxBytes;
  return ksm + box * (kTile * L::kBoxBytes) +
         (o ^ (((o >> 7) & L::kSwizzle) << 4));
}

// Copy the K and V rows of the n positions from cache row `row` into a
// stage: a box per tile of K (per 128 bytes of a row) and of V.
template <class L, typename T>
__device__ __forceinline__ void fetch_step(uint8_t* stage, uint64_t* bar,
                                           const CUtensorMap* kmap,
                                           const CUtensorMap* vmap, int col,
                                           int row, int n) {
  const int tiles = (n + kTile - 1) / kTile;
  mbar_expect_tx(bar, 2 * tiles * L::kTileBytes);
  for (int t = 0; t < tiles; ++t) {
#pragma unroll
    for (int x = 0; x < L::kBoxes; ++x)
      tma_load(stage + (t * L::kBoxes + x) * (kTile * L::kBoxBytes), kmap,
               col + x * (L::kBoxBytes / static_cast<int>(sizeof(T))),
               row + t * kTile, bar);
    tma_load(stage + L::kHalf + t * L::kTileBytes, vmap, col,
             row + t * kTile, bar);
  }
}

template <int HD, typename T, int HPW>
__global__ void __launch_bounds__(kThreads, Geo<HD, T, HPW>::kMinBlocks)
decode_attn_split(const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  const __nv_bfloat16* __restrict__ q,
                  float* __restrict__ out, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_acc,
                  int* __restrict__ counters, int H, int KV, int S,
                  int valid_arg, const int* __restrict__ valid_dev,
                  int chunk_arg, SplitRule rule, float scale, bool on_chip) {
  using L = Geo<HD, T, HPW>;
  constexpr int kG = L::kG, kR = L::kRows, kD = L::kDims, kAcc = L::kAcc;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* stages =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  float* pt = reinterpret_cast<float*>(stages + L::kStages * L::kStage);
  float* inbox = pt + kWarps * kWarpPos * kG;  // cluster merge: pushed here
  __shared__ float m_part[2][kWarps][kMaxG];   // per step parity
  __shared__ float l_part[kWarps][kMaxG];
  __shared__ float m_s[kMaxG], l_s[kMaxG];
  __shared__ float mbox[kClusterSplits * kMaxG], lbox[kClusterSplits * kMaxG];
  __shared__ __align__(8) uint64_t full[L::kStages];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;   // mma fragments: group, thread
  const int n_split = gridDim.y;
  const int split = blockIdx.y;
  const int G = H / KV;
  const int b = blockIdx.x / KV;
  const int g = blockIdx.x % KV;
  const int col = g * HD;                 // element column of the KV head
  // the device length, read first: the split, and whether this block
  // holds positions at all, depend on it
  const int raw_len = valid_dev == nullptr ? valid_arg : __ldg(valid_dev);
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&kmap)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&vmap)) : "memory");
#pragma unroll
    for (int s = 0; s < L::kStages; ++s) mbar_init(&full[s], 1);
    // the barriers' init visible to the copy engine (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  // q as the mma's A fragments: rows heads (past G zero), k dims.  Block
  // 0 (always active) loads them while the length is read; the others
  // once they know they hold positions.
  const long long head0 = (long long)b * H + (long long)g * G;
  const __nv_bfloat16* qb = q + head0 * HD;
  uint32_t qa[L::kKSteps][4];
  auto load_q = [&]() {
#pragma unroll
    for (int kk = 0; kk < L::kKSteps; ++kk) {
      const int c = kk * 16 + 2 * tq;
      const uint32_t* lo =
          reinterpret_cast<const uint32_t*>(qb + gq * HD + c);
      const uint32_t* hi =
          reinterpret_cast<const uint32_t*>(qb + (gq + 8) * HD + c);
      qa[kk][0] = gq < G ? lo[0] : 0u;
      qa[kk][1] = gq + 8 < G ? hi[0] : 0u;
      qa[kk][2] = gq < G ? lo[4] : 0u;
      qa[kk][3] = gq + 8 < G ? hi[4] : 0u;
    }
  };
  if (split == 0) load_q();

  int valid_len, chunk, active;
  if (valid_dev == nullptr) {
    valid_len = valid_arg;
    chunk = chunk_arg;
    active = n_split;
  } else {
    // clamped to the cache (the engine raises before a position past it;
    // a kernel cannot), and the split it takes
    valid_len = min(max(raw_len, 1), S);
    const int tiles = cdiv(valid_len, kTile);
    const int per = split_tiles(tiles, rule);
    chunk = per * kTile;
    active = cdiv(tiles, per);
  }
  // one active block: it writes the output, the others leave at once
  // (no barrier and no shared memory is shared in this launch)
  if (active == 1 && split > 0) return;
  const bool merge_on_chip = on_chip && active > 1;
  if (split >= active) {
    // past the length: no loads, no pushes; in the cluster, the two
    // barriers that the active blocks meet
    if (merge_on_chip) {
      cluster_arrive();
      cluster_wait();
      cluster_sync();
    }
    return;
  }
  // cluster merge: peers may write to this block's shared memory only
  // once it runs; arrive now, wait before the first push
  if (merge_on_chip) cluster_arrive();
  if (split > 0) load_q();

  const int t_begin = split * chunk;
  const int t_end = min(t_begin + chunk, valid_len);
  const int n_steps = cdiv(t_end - t_begin, kStep);
  const int row0 = b * S + t_begin;       // cache row of the first position
  if (tid == 0)
    for (int s = 0; s < L::kStages && s < n_steps; ++s)
      fetch_step<L, T>(stages + s * L::kStage, &full[s], &kmap, &vmap, col,
                       row0 + s * kStep,
                       min(kStep, t_end - t_begin - s * kStep));
  __syncthreads();              // the barriers are set before any waits

  // Per lane: the running max of heads gq and gq + 8 (the same in every
  // warp), this warp's share of their denominators, and its share of the
  // accumulator (its positions only) of every head, dims lane * kD...
  float m_run[kR], l_run[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m_run[r] = kMasked;
    l_run[r] = 0.f;
  }
  float acc[kG][kD];
#pragma unroll
  for (int h = 0; h < kG; ++h)
#pragma unroll
    for (int d = 0; d < kD; ++d) acc[h][d] = 0.f;
  const int p0 = warp * kWarpPos;         // this warp's positions in a step
  float* ptw = pt + warp * kWarpPos * kG; // its p table [position][head]

  for (int step = 0; step < n_steps; ++step) {
    const int st = step % L::kStages;
    const int t0 = t_begin + step * kStep;
    const int n = min(kStep, t_end - t0);
    const uint8_t* ksm = stages + st * L::kStage;
    const T* vsm = reinterpret_cast<const T*>(ksm + L::kHalf);
    mbar_wait(&full[st], (step / L::kStages) & 1);

    // scores of the warp's 8 positions on the tensor cores: rows heads,
    // columns positions; products of bf16 are exact, the sum f32
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < L::kKSteps; ++kk) {
      const int eb = (kk * 16 + 2 * tq) * static_cast<int>(sizeof(T));
      const uint32_t b0 = k_pair(k_addr<L>(ksm, p0 + gq, eb), T());
      const uint32_t b1 = k_pair(
          k_addr<L>(ksm, p0 + gq, eb + 8 * static_cast<int>(sizeof(T))), T());
      mma_bf16(c, qa[kk], b0, b1);
    }
    // c[2r + i]: head gq + 8 r at position p0 + 2 tq + i; past the range
    // (rows not loaded, or loaded past t_end) the finite mask
    float s[kR][2], mw[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        s[r][i] = p0 + 2 * tq + i < n ? c[2 * r + i] * scale : kMasked;
      mw[r] = fmaxf(s[r][0], s[r][1]);
      mw[r] = fmaxf(mw[r], __shfl_xor_sync(0xffffffffu, mw[r], 1));
      mw[r] = fmaxf(mw[r], __shfl_xor_sync(0xffffffffu, mw[r], 2));
    }
    float* mp = &m_part[step & 1][0][0];
    if (tq == 0)
#pragma unroll
      for (int r = 0; r < kR; ++r) mp[warp * kMaxG + gq + 8 * r] = mw[r];
    __syncthreads();
    // every thread is done with the step before: its stage's next copies
    if (tid == 0 && step > 0 && step - 1 + L::kStages < n_steps) {
      const int prev = step - 1, next = prev + L::kStages;
      fetch_step<L, T>(stages + (prev % L::kStages) * L::kStage,
                       &full[prev % L::kStages], &kmap, &vmap, col,
                       row0 + next * kStep,
                       min(kStep, t_end - t_begin - next * kStep));
    }
    // the joint max over every warp, p, and this warp's row sums
    float corr[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        mx = fmaxf(mx, mp[w * kMaxG + gq + 8 * r]);
      corr[r] = expf(m_run[r] - mx);
      m_run[r] = mx;
      s[r][0] = expf(s[r][0] - mx);
      s[r][1] = expf(s[r][1] - mx);
      float sum = s[r][0] + s[r][1];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[r] = l_run[r] * corr[r] + sum;
#pragma unroll
      for (int i = 0; i < 2; ++i) ptw[(2 * tq + i) * kG + gq + 8 * r] = s[r][i];
    }
    __syncwarp();
    // P.V over the warp's positions, f32: acc[h] = acc[h] * corr[h] +
    // sum_j p[h][j] v[j]; positions past the range are skipped
#pragma unroll
    for (int h = 0; h < kG; ++h) {
      const float ch = __shfl_sync(0xffffffffu, corr[h / 8], (h % 8) * 4);
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[h][d] *= ch;
    }
#pragma unroll
    for (int j = 0; j < kWarpPos; ++j) {
      if (p0 + j < n) {
        float v[kD];
        load_v<kD>(vsm + (p0 + j) * HD + lane * kD, v);
        const float4* pr = reinterpret_cast<const float4*>(ptw + j * kG);
#pragma unroll
        for (int h4 = 0; h4 < kG / 4; ++h4) {
          const float4 p4 = pr[h4];
#pragma unroll
          for (int d = 0; d < kD; ++d) {
            acc[4 * h4][d] = fmaf(p4.x, v[d], acc[4 * h4][d]);
            acc[4 * h4 + 1][d] = fmaf(p4.y, v[d], acc[4 * h4 + 1][d]);
            acc[4 * h4 + 2][d] = fmaf(p4.z, v[d], acc[4 * h4 + 2][d]);
            acc[4 * h4 + 3][d] = fmaf(p4.w, v[d], acc[4 * h4 + 3][d]);
          }
        }
      }
    }
    __syncwarp();
  }

  // The block's partial: the warps' shares summed in warp order, in the
  // stages once every warp is done reading them (every copy has landed).
  __syncthreads();
  float* red = reinterpret_cast<float*>(stages);     // [warp][kG * HD]
#pragma unroll
  for (int h = 0; h < kG; ++h)
#pragma unroll
    for (int d = 0; d < kD; ++d)
      red[warp * kG * HD + h * HD + lane * kD + d] = acc[h][d];
  if (tq == 0)
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      l_part[warp][gq + 8 * r] = l_run[r];
      if (warp == 0) m_s[gq + 8 * r] = m_run[r];
    }
  __syncthreads();
  // outputs idx = tid + a * kThreads: head idx / HD, dim idx % HD
  float accs[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int idx = tid + a * kThreads;
    float sum = 0.f;
    if (idx < kG * HD)
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w * kG * HD + idx];
    accs[a] = sum;
  }
  if (tid < kG) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += l_part[w][tid];
    l_s[tid] = sum;
  }
  __syncthreads();

  if (active == 1) {
    float* ob = out + head0 * HD;
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int idx = tid + a * kThreads;
      if (idx < G * HD) ob[idx] = accs[a] / l_s[idx / HD];
    }
    return;
  }
  if (merge_on_chip) {
    // The row's blocks form one thread block cluster.  Output idx belongs
    // to active block idx / share; every active block pushes its partials
    // of those outputs, and its m and l, into the owner's inbox
    // (distributed shared memory), so after one cluster barrier each
    // merges its share from its own shared memory, in split order.
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const int share = (G * HD + active - 1) / active;
    cluster_wait();                   // every block of the cluster runs
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int idx = tid + a * kThreads;
      if (idx < G * HD) {
        const int owner = idx / share;
        cluster.map_shared_rank(inbox, owner)[split * share +
                                              idx - owner * share] = accs[a];
      }
    }
    if (tid < G)
      for (int t = 0; t < active; ++t) {
        cluster.map_shared_rank(mbox, t)[split * kMaxG + tid] = m_s[tid];
        cluster.map_shared_rank(lbox, t)[split * kMaxG + tid] = l_s[tid];
      }
    cluster_sync();                   // every push has landed
    if (tid < G) {
      float mx = kMasked;
      for (int t = 0; t < active; ++t) mx = fmaxf(mx, mbox[t * kMaxG + tid]);
      float dsum = 0.f;
      for (int t = 0; t < active; ++t) {
        const float w = expf(mbox[t * kMaxG + tid] - mx);
        mbox[t * kMaxG + tid] = w;
        dsum += lbox[t * kMaxG + tid] * w;
      }
      l_s[tid] = dsum;
    }
    __syncthreads();
    for (int li = tid; li < share && split * share + li < G * HD;
         li += kThreads) {
      const int idx = split * share + li, r = idx / HD;
      float num = 0.f;
      for (int t = 0; t < active; ++t)
        num += inbox[t * share + li] * mbox[t * kMaxG + r];
      out[head0 * HD + idx] = num / l_s[r];
    }
    return;
  }
  float* mine = reinterpret_cast<float*>(stages);   // free again

  // partials: acc as [(batch row, KV head)][split][G * HD], m and l as
  // [head][split], strided by the grid's splits
  float* part = part_acc + ((long long)blockIdx.x * n_split + split) * G * HD;
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int idx = tid + a * kThreads;
    if (idx < G * HD) part[idx] = accs[a];
  }
  if (tid < G) {
    part_m[(head0 + tid) * n_split + split] = m_s[tid];
    part_l[(head0 + tid) * n_split + split] = l_s[tid];
  }
  // The last active block of this (batch row, KV head) to finish merges
  // the active partials in split order: no float atomics, so the output
  // does not depend on which block that is.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[blockIdx.x], 1) == active - 1;
  __syncthreads();
  if (!last) return;
  if (tid == 0) counters[blockIdx.x] = 0;   // every active block has counted
  __threadfence();
  // per head: the joint max, each split's weight exp(m - max) and the
  // denominator (lanes over splits, then a fixed shuffle tree)
  float* wgt = mine;                                 // [G][active]
  for (int r = warp; r < G; r += kWarps) {
    const float* pm = part_m + (head0 + r) * n_split;
    const float* pl = part_l + (head0 + r) * n_split;
    const float m0 = lane < active ? __ldcg(pm + lane) : kMasked;
    const float m1 = lane + 32 < active ? __ldcg(pm + lane + 32) : kMasked;
    const float l0 = lane < active ? __ldcg(pl + lane) : 0.f;
    const float l1 = lane + 32 < active ? __ldcg(pl + lane + 32) : 0.f;
    float mx = fmaxf(m0, m1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float c0 = expf(m0 - mx), c1 = expf(m1 - mx);
    if (lane < active) wgt[r * active + lane] = c0;
    if (lane + 32 < active) wgt[r * active + lane + 32] = c1;
    float dsum = l0 * c0 + l1 * c1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    if (lane == 0) l_s[r] = dsum;
  }
  __syncthreads();
  // out = sum over splits of weight * acc / den; kU splits' loads of every
  // output of this thread in flight at once
  constexpr int kU = kAcc >= 16 ? 3 : 48 / kAcc;
  const float* pall = part_acc + (long long)blockIdx.x * n_split * G * HD;
  float num[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) num[a] = 0.f;
#pragma unroll 2
  for (int s0 = 0; s0 < active; s0 += kU) {
    float pv[kU][kAcc];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int a = 0; a < kAcc; ++a) {
        const int idx = tid + a * kThreads;
        pv[u][a] = idx < G * HD && s0 + u < active
            ? __ldcg(pall + (long long)(s0 + u) * G * HD + idx) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int a = 0; a < kAcc; ++a) {
        const int idx = tid + a * kThreads;
        if (idx < G * HD && s0 + u < active)
          num[a] = fmaf(pv[u][a], wgt[(idx / HD) * active + s0 + u], num[a]);
      }
  }
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int idx = tid + a * kThreads;
    if (idx < G * HD) out[head0 * HD + idx] = num[a] / l_s[idx / HD];
  }
}

// cuTensorMapEncodeTiled, from the driver the runtime has loaded (no link
// against libcuda).
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The cache (rows = B * S positions of `width` = KV * hd elements) as a
// 2-d tensor map whose boxes are kTile rows of `box` elements, in the
// swizzle of `swizzle` bytes (0: none).  Rows past the cache read as 0.
template <typename T>
cudaError_t cache_map(CUtensorMap* map, const void* base, long long rows,
                      int width, int box, int swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(width) * sizeof(T)};
  const cuuint32_t boxes[2] = {static_cast<cuuint32_t>(box), kTile};
  const cuuint32_t unit[2] = {1, 1};
  const CUtensorMapSwizzle swz =
      swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : swizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
      : swizzle == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                      : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = encode(
      map, sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      2, const_cast<void*>(base), dims, strides, boxes, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  void* partials;
  int* counters;
  const int* valid_dev;   // null: valid_len is the length
  int B, H, KV, S;
  int valid_len;          // host entry: the length
  int chunk;              // host entry: positions a block
  int n_split;            // blocks a (batch row, KV head)
  SplitRule rule;         // device entry: the split's rule
  float scale;
};

// A launch of this kernel: 256 threads, its shared memory, a cluster of
// (1, cluster, 1) blocks.
template <int HD, typename T, int HPW>
struct Launch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  Launch(int cluster, cudaStream_t stream) {
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = Geo<HD, T, HPW>::kSmem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = cluster;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Once per kernel: shared memory above 48 KB and clusters past 8 blocks
// allowed, and a check that the card schedules a 16-block cluster of it
// (an H100 does; where one is refused, every launch fails).
template <int HD, typename T, int HPW>
cudaError_t prepare() {
  static bool checked = false;
  static cudaError_t ready = cudaSuccess;
  if (!checked) {
    checked = true;
    auto* kern = decode_attn_split<HD, T, HPW>;
    ready = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 Geo<HD, T, HPW>::kSmem);
    if (ready == cudaSuccess)
      ready = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (ready == cudaSuccess) {
      Launch<HD, T, HPW> l(kClusterSplits, nullptr);
      l.cfg.gridDim = dim3(1, kClusterSplits);
      int clusters = 0;
      ready = cudaOccupancyMaxActiveClusters(&clusters, kern, &l.cfg);
      if (ready == cudaSuccess && clusters < 1) ready = cudaErrorNotSupported;
      cudaGetLastError();                // reported by every launch instead
    }
  }
  return ready;
}

template <int HD, typename T, int HPW>
cudaError_t launch_t(const Args& a, cudaStream_t stream) {
  using L = Geo<HD, T, HPW>;
  static_assert(L::kStage >= 4 * kMaxG * kMaxSplits,
                "merge weights must fit in a stage");
  static_assert(L::kSmem <= 227 * 1024, "shared memory of a block");
  auto* kern = decode_attn_split<HD, T, HPW>;
  const cudaError_t ready = prepare<HD, T, HPW>();
  if (ready != cudaSuccess) return ready;
  const long long rows = (long long)a.B * a.S;
  CUtensorMap kmap, vmap;
  cudaError_t err = cache_map<T>(&kmap, a.k, rows, a.KV * HD,
                                 L::kBoxBytes / sizeof(T), L::kBoxBytes);
  if (err == cudaSuccess)
    err = cache_map<T>(&vmap, a.v, rows, a.KV * HD, HD, 0);
  if (err != cudaSuccess) return err;
  const int n_split = a.n_split;
  const bool on_chip = n_split > 1 && n_split <= kClusterSplits;
  const long long heads = (long long)a.B * a.H;
  float* pm = static_cast<float*>(a.partials);
  float* pl = pm == nullptr ? nullptr : pm + heads * n_split;
  float* pa = pm == nullptr ? nullptr : pl + heads * n_split;
  Launch<HD, T, HPW> l(on_chip ? n_split : 1, stream);  // a row: a cluster
  l.cfg.gridDim = dim3(a.B * a.KV, n_split);
  return cudaLaunchKernelEx(
      &l.cfg, kern, kmap, vmap, static_cast<const __nv_bfloat16*>(a.q),
      static_cast<float*>(a.out), pm, pl, pa, a.counters, a.H, a.KV, a.S,
      a.valid_len, a.valid_dev, a.chunk, a.rule, a.scale, on_chip);
}

// heads per warp: the fewest that cover the group
template <int HD, typename T>
cudaError_t launch_g(const Args& a, cudaStream_t stream) {
  static_assert(2 * kWarps >= kMaxG, "two heads a warp cover a group");
  if (a.H / a.KV <= kWarps) return launch_t<HD, T, 1>(a, stream);
  return launch_t<HD, T, 2>(a, stream);
}

template <int HD>
cudaError_t launch(const Args& a, int kv_fp8, cudaStream_t stream) {
  if (kv_fp8) return launch_g<HD, __nv_fp8_e4m3>(a, stream);
  return launch_g<HD, __nv_bfloat16>(a, stream);
}

// Both C entries: check the arguments, select the device, dispatch on hd.
int run(const Args& a, int hd, int kv_fp8, int device, void* stream) {
  const SplitRule& r = a.rule;
  if (a.B < 1 || a.KV < 1 || a.H % a.KV != 0 || a.H / a.KV > kMaxG ||
      a.S < 1 || (long long)a.B * a.S > 0x7fffffffLL ||
      a.n_split < 1 || a.n_split > kMaxSplits ||
      (reinterpret_cast<uintptr_t>(a.q) & 15u) ||
      (reinterpret_cast<uintptr_t>(a.valid_dev) & 3u) ||
      (a.n_split > kClusterSplits &&
       (a.partials == nullptr || a.counters == nullptr)) ||
      ((reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v))
       & 15u))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.valid_dev == nullptr
      ? (a.valid_len < 1 || a.valid_len > a.S || a.chunk < 1 ||
         cdiv(a.valid_len, a.chunk) != a.n_split)
      : (r.tile != kTile || r.cluster_splits < 1 || r.cluster_tiles < 1 ||
         r.merge_splits < 1 || r.merge_tiles < 1 || r.max_splits < 1 ||
         r.blocks_per_sm < 1 || r.rows < 1 || r.sms < 1 ||
         a.n_split < rule_grid(a.S, r)))
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return static_cast<int>(launch<32>(a, kv_fp8, s));
    case 64:
      return static_cast<int>(launch<64>(a, kv_fp8, s));
    case 128:
      return static_cast<int>(launch<128>(a, kv_fp8, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q: (B, H, hd) bf16; k, v: (B, S, KV, hd) bf16 or fp8-e4m3 (kv_fp8);
// all three 16-byte aligned; out: (B, H, hd) f32.  All contiguous.  `chunk`:
// positions per block.  With n_split = ceil(valid_len / chunk) > 16 the
// blocks merge through device memory: `partials` holds B * H * n_split *
// (hd + 2) floats of scratch and `counters` B * KV ints that are 0 on
// entry (and are 0 again on return); else both may be null.  Returns the
// launch's cudaError_t.
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           void* out, void* partials, void* counters, int B,
                           int H, int KV, int S, int hd, int valid_len,
                           int chunk, float scale, int kv_fp8, int device,
                           void* stream) {
  Args a = {q, k, v, out, partials, static_cast<int*>(counters), nullptr,
            B, H, KV, S, valid_len, chunk,
            chunk < 1 ? 0 : (valid_len + chunk - 1) / chunk, {}, scale};
  return run(a, hd, kv_fp8, device, stream);
}

// The same with the length in device memory: `valid_len` points to one
// int32, read by every block when it runs and clamped to [1, S].  The grid
// is the capacity's: `n_split` blocks a (batch row, KV head), at least the
// most that the rule's split takes at any length in [1, S]
// (kernels/decode_attn.py::grid_splits; fewer is refused); `partials` /
// `counters` are needed as above when it exceeds 16.
// `rule` holds the split's constants (tile, which must be 32, cluster
// splits, cluster tiles, merge splits, merge tiles, max splits, blocks
// per SM, the card's SMs); each block computes its range from the length
// it reads.  Nothing here reads the length on
// the host, so a CUDA graph replays the launch at any position.
extern "C" int decode_attn_devlen(const void* q, const void* k, const void* v,
                                  void* out, void* partials, void* counters,
                                  const void* valid_len, int B, int H, int KV,
                                  int S, int hd, int n_split, const int* rule,
                                  float scale, int kv_fp8, int device,
                                  void* stream) {
  if (valid_len == nullptr || rule == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const SplitRule r = {rule[0], rule[1], rule[2], rule[3], rule[4],
                       rule[5], rule[6], B * KV, rule[7]};
  Args a = {q, k, v, out, partials, static_cast<int*>(counters),
            static_cast<const int*>(valid_len), B, H, KV, S, S, 0, n_split,
            r, scale};
  return run(a, hd, kv_fp8, device, stream);
}
