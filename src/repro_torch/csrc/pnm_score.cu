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
// Bound on this card: memory.  The kernel reads each row once
// (2 B per element, the bf16 patterns as stored; the TPU kernel took a
// padded f32 copy, twice the bytes) and does 2 flops per element, far
// below the ~20 flops per byte at which the H100's f32 rate would become
// the limit.  What held the earlier design (one block per page, each warp
// loading a row, summing it, then loading the next) was latency: a warp's
// rows were serial round trips to memory, and 64 pages filled 64 SMs.
//
// Design:
// * a block takes a page at a time, in chunks of R rows (the page, at
//   most one 16 KiB stage); the grid is persistent when P is large: block
//   b walks pages b, b + blocks, .., and keeps each page's maximum in
//   shared memory until it writes them all at the end;
// * a chunk is one bulk asynchronous copy (cp.async.bulk, completion on
//   an mbarrier) into a ring of kStages stages; thread 0 keeps kStages
//   chunks in flight, so the next page's rows arrive while this one's are
//   summed.  The chunks follow from T alone, so the first copies leave
//   before the valid counts arrive; rows past valid[p] are copied (the
//   tier's pages are nearly all full) but never summed, so a NaN there
//   cannot leak in;
// * a warp sums kRowValues / M rows at once from shared memory, every
//   load issued first; their levels across lanes share shuffles
//   (across_lanes), about one a row instead of five; the digest sits in
//   registers;
// * where a bulk copy cannot be used (C % 8 != 0 or pages not 16-byte
//   aligned, e.g. an offset view), the block copies the chunk with 2-byte
//   loads instead, and the rest is the same.
// Splitting a page over a cluster of blocks, their maxima merged through
// distributed shared memory, filled more SMs at 64 pages but lost at
// both the served and the long-context shape (chip_variants.py,
// pages_by_cluster).
// What the design holds to:
// * a page's score is bitwise the same in any batch: each row's dot is
//   summed in one fixed order that depends on C alone (products rounded
//   once, then a halving tree over C padded with zeros to a power of two
//   of at least 32: within a lane first, then across the warp's lanes),
//   and no atomics are used.  The plain version in
//   kernels/pnm_score.py sums in exactly this order, so the two agree bit
//   for bit.  __fmul_rn / __fadd_rn keep the compiler from contracting a
//   product and a sum into one FMA;
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
// Design constants (chip_variants.py sweeps them; PERF.md §6):
constexpr int kStages = 2;           // chunks in flight per block
constexpr int kStageBytes = 16384;   // a stage holds at most this
constexpr int kRowValues = 32;       // values a lane holds: rows at once
constexpr int kCtasPerSm = 4;        // persistent grid: blocks per SM
constexpr int kMaxSlots = 1024;      // pages a block takes, at most

__device__ __forceinline__ float nan_max(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrive once and expect `bytes` from the copy, then issue the copy.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// The halving tree within a lane, from half H down: v[j] += v[j + h] for
// h = H, H/2, .., 1; the sum lands in v[0].
template <int H, int M>
__device__ __forceinline__ float halving_tree(float (&v)[M]) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int j = 0; j < H; ++j) v[j] = __fadd_rn(v[j], v[j + H]);
    return halving_tree<H / 2>(v);
  } else {
    return v[0];
  }
}

// The tree's levels across the warp's lanes (halves 16 .. 1) for U rows
// at once, V of them still in each lane.  While V > 1 a level pairs lane l
// with l ^ O: the lower lane keeps the first half of its rows, the upper
// the second, and each adds the partner's value of the same row at the
// other position (x[p] + x[p + O], in either order: the same sum), so a
// level costs V / 2 shuffles instead of V.  Row k's dot ends in lane
// k * 32 / U.
template <int U, int V, int O>
__device__ __forceinline__ float across_lanes(float (&x)[U], int lane) {
  if constexpr (O == 0) {
    return x[0];
  } else if constexpr (V > 1) {
    const bool upper = (lane & O) != 0;
#pragma unroll
    for (int k = 0; k < V / 2; ++k) {
      const float send = upper ? x[k] : x[V / 2 + k];
      const float keep = upper ? x[V / 2 + k] : x[k];
      x[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, O));
    }
    return across_lanes<U, V / 2, O / 2>(x, lane);
  } else {
    x[0] = __fadd_rn(x[0], __shfl_down_sync(0xffffffffu, x[0], O));
    return across_lanes<U, 1, O / 2>(x, lane);
  }
}

// M: values per lane of a row, the padded channel count over 32 (a power
// of two).
template <int M>
__global__ void __launch_bounds__(kThreads)
pnm_score_kernel(const uint16_t* __restrict__ pages,
                 const int* __restrict__ valid,
                 const float* __restrict__ digest, float* __restrict__ out,
                 int P, int T, int C, int R, bool bulk) {
  constexpr int U = M >= kRowValues ? 1 : kRowValues / M;   // rows at once
  extern __shared__ __align__(128) uint8_t smem[];          // the stages
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ float pm[kMaxSlots];           // each slot's page maximum
  __shared__ int vl[kMaxSlots];             // each slot's valid rows
  __shared__ float wpart[2][kWarps];        // a chunk's warp maxima
  // the block takes pages blk, blk + blocks, .. (its slots)
  const int blocks = gridDim.x;
  const int blk = blockIdx.x;
  const int slots = blk < P ? (P - 1 - blk) / blocks + 1 : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int stage_elems = (R * C + 7) & ~7;     // 16-byte aligned stages
  uint16_t* stages = reinterpret_cast<uint16_t*>(smem);

  // the block's chunks: R rows of each of its pages in turn (the last
  // one shorter), whatever valid says
  const int per_page = (T + R - 1) / R;
  const int chunks = slots * per_page;
  auto chunk_page = [&](int i) { return i / per_page; };
  auto chunk_row = [&](int i) { return (i % per_page) * R; };
  auto fetch = [&](int i) {
    const int t0 = chunk_row(i);
    bulk_load(stages + (i % kStages) * stage_elems,
              pages + ((blk + (long long)chunk_page(i) * blocks) *
                           T + t0) * C,
              2u * min(R, T - t0) * C, &full[i % kStages]);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (bulk)                           // copies first: they need no valid
      for (int i = 0; i < kStages && i < chunks; ++i) fetch(i);
  }
  for (int i = tid; i < slots; i += kThreads) {
    vl[i] = min(max(valid[blk + (long long)i * blocks], 0), T);
    pm[i] = -__int_as_float(0x7f800000);          // -inf
  }
  float dig[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const int c = lane + 32 * j;
    dig[j] = c < C ? digest[c] : 0.f;
  }
  __syncthreads();

  for (int i = 0; i < chunks; ++i) {
    const int stage = i % kStages, slot = chunk_page(i), t0 = chunk_row(i);
    const uint16_t* st = stages + stage * stage_elems;
    const int rows = min(R, vl[slot] - t0);      // valid rows of the chunk
    if (bulk) {
      mbar_wait(&full[stage], (i / kStages) & 1);
    } else {
      const uint16_t* src =
          pages + ((blk + (long long)slot * blocks) * T + t0) * C;
      uint16_t* dst = stages + stage * stage_elems;
      for (int e = tid; e < rows * C; e += kThreads) dst[e] = src[e];
      __syncthreads();
    }
    // warp w sums rows w * U .. w * U + U - 1, then the next kWarps * U;
    // lanes k * 32 / U keep the maxima of their rows
    float run = -__int_as_float(0x7f800000);
    for (int r0 = warp * U; r0 < rows; r0 += kWarps * U) {
      uint32_t raw[U][M];                // every load in flight first
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < M; ++j) {
          const int c = lane + 32 * j;
          raw[u][j] = r0 + u < rows && c < C ? st[(r0 + u) * C + c] : 0u;
        }
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float v[M];
#pragma unroll
        for (int j = 0; j < M; ++j)      // 0 past C: the tree's padding
          v[j] = __fmul_rn(__uint_as_float(raw[u][j] << 16), dig[j]);
        s[u] = halving_tree<M / 2>(v);
      }
      const float dot = across_lanes<U, U, 16>(s, lane);
      if (lane % (32 / U) == 0 && r0 + lane / (32 / U) < rows)
        run = nan_max(run, dot);
    }
#pragma unroll
    for (int o = 16; o >= 32 / U; o /= 2)
      run = nan_max(run, __shfl_down_sync(0xffffffffu, run, o));
    if (lane == 0) wpart[i & 1][warp] = run;
    __syncthreads();                    // the stage is free, wpart is set
    if (tid == 0) {
      float m = pm[slot];
      for (int w = 0; w < kWarps; ++w) m = nan_max(m, wpart[i & 1][w]);
      pm[slot] = m;
      if (bulk && i + kStages < chunks) {
        // the stage was read through the generic proxy; order those reads
        // before the async proxy's write
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        fetch(i + kStages);
      }
    }
  }

  __syncthreads();                      // thread 0's last fold is in pm
  for (int i = tid; i < slots; i += kThreads)
    out[blk + (long long)i * blocks] = pm[i];
}

template <int M>
cudaError_t launch(const uint16_t* x, const int* vl, const float* dg,
                   float* o, int P, int T, int C, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // rows of a chunk: the page, at most one stage
  const int R = max(1, min(kStageBytes / (2 * C), T));
  const int smem = kStages * ((R * C + 7) & ~7) * 2;
  const int blocks = max(min(P, kCtasPerSm * sms), (P + kMaxSlots - 1) /
                                                       kMaxSlots);
  auto* kern = pnm_score_kernel<M>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const bool bulk = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kern<<<blocks, kThreads, smem, stream>>>(x, vl, dg, o, P, T, C, R, bulk);
  return cudaSuccess;
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
    case 1: err = launch<1>(x, vl, dg, o, P, T, C, s); break;
    case 2: err = launch<2>(x, vl, dg, o, P, T, C, s); break;
    case 4: err = launch<4>(x, vl, dg, o, P, T, C, s); break;
    case 8: err = launch<8>(x, vl, dg, o, P, T, C, s); break;
    case 16: err = launch<16>(x, vl, dg, o, P, T, C, s); break;
    case 32: err = launch<32>(x, vl, dg, o, P, T, C, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
