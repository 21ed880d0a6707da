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
// decode sizes the bytes are few, so what counts is how many SMs share
// them and how few dependent steps (round trips to memory, barriers,
// shuffle trees) each block takes.
//
// Design: a grid of (B * KV, n_split) blocks.  Block (bg, s) takes the
// positions [s * chunk, min((s + 1) * chunk, valid_len)) of its (batch
// row, KV head); the wrapper picks `chunk` (a multiple of 32 positions,
// kernels/decode_attn.py::split_size) so that no block lies past
// valid_len.  The block carries the online-softmax state (m, l, acc) of
// the G query heads that share its KV head, so each K/V row is read once
// for all G heads.
// - Steps of 64 positions: cp.async copies a step's K and V rows into
//   shared memory as stored (bf16 or fp8; 16 bytes a copy, neighbouring
//   threads on neighbouring bytes, rows past the range zero-filled), the
//   next step's copies in flight while the current one is computed.
// - Scores: a warp takes HPW heads, a lane 2 positions, so a lane keeps
//   2 * HPW independent dot products going; K rows are read 16 bytes at a
//   time (a padded pitch keeps the reads conflict-free) and upcast to f32
//   there.  One max and one sum tree per head and step.
// - P.V: a thread takes a pair of dims of up to 4 heads; each V pair
//   read is upcast once and used for all of them, p is read 4 positions
//   at a time.
// The math is f32 on CUDA cores: the tolerance is against an f32 plain
// version, and a bf16 mma on P.V would round p to bf16.
// Merging the blocks' (m, l, acc) partials, in split order against their
// joint max:
// - up to 16 splits a row (the main path): the row's blocks are one
//   thread block cluster; each pushes its partials into the block that
//   owns each output (distributed shared memory) and after one cluster
//   barrier merges its own share locally — no trip through device
//   memory (a merge through it costs a store, a fence, an atomic and
//   loads, each a dependent round trip);
// - more splits: each block writes its partials to the caller's scratch;
//   the last block of the row to finish (an integer counter, after
//   __threadfence) merges them and sets the counter back to 0, so a
//   zeroed counter buffer stays zeroed across calls.
// No float atomics, so two calls on the same inputs give bit-equal
// outputs; one launch in all.  With one split the block writes the output
// itself.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPos = 2;                 // positions per lane in a step
constexpr int kStep = 32 * kPos;        // positions per step
constexpr int kMaxG = 16;               // query heads per KV head
constexpr int kMaxSplits = 64;          // blocks per (batch row, KV head)
constexpr int kClusterSplits = 16;      // up to this many: merged on chip
constexpr float kMasked = -1e30f;

// 16 bytes of a cache row -> f32, in element order.
__device__ __forceinline__ void upcast(const uint4& raw, float* dst,
                                       __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}
__device__ __forceinline__ void upcast(const uint4& raw, float* dst,
                                       __nv_fp8_e4m3) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    __nv_fp8_e4m3 e;
    e.__x = static_cast<__nv_fp8_storage_t>((w[i / 4] >> (8 * (i % 4)))
                                            & 0xFFu);
    dst[i] = static_cast<float>(e);
  }
}
// Two neighbouring cache elements -> f32.
__device__ __forceinline__ void upcast2(const __nv_bfloat16* p, float& a,
                                        float& b) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xFFFF0000u);
}
__device__ __forceinline__ void upcast2(const __nv_fp8_e4m3* p, float& a,
                                        float& b) {
  a = static_cast<float>(p[0]);
  b = static_cast<float>(p[1]);
}

template <int HD, typename T, int HPW>
struct Geo {
  static constexpr int kElems = 16 / sizeof(T);          // per 16 bytes
  static constexpr int kRowBytes = HD * sizeof(T);
  static constexpr int kCopies = kRowBytes / 16;         // per row
  static constexpr int kKPitch = kRowBytes + 16;         // conflict-free
  static constexpr int kStage = kStep * (kKPitch + kRowBytes);
  static constexpr int kG = kWarps * HPW;                // heads, most
  // P.V: a thread takes a pair of dims of kHP heads, kHS apart
  static constexpr int kHS = kThreads / (HD / 2);
  static constexpr int kHP = (kG + kHS - 1) / kHS;
  static constexpr int kAcc = 2 * kHP;
  // two stages, q and p in f32, the cluster merge's inbox (a share of the
  // outputs from each block: G * HD floats, rounded up per block)
  static constexpr int kSmem = 2 * kStage + kG * HD * 4 + kG * kStep * 4 +
                               (kG * HD + kClusterSplits) * 4;
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t dst =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// Copy the K and V rows of positions [t0, t0 + kStep) (zeros at or past
// t_end) into a stage, as one cp.async group.
template <int HD, typename T, int HPW>
__device__ __forceinline__ void fetch_step(uint8_t* stage,
                                           const T* __restrict__ kb,
                                           const T* __restrict__ vb,
                                           long long row, int t0, int t_end) {
  using L = Geo<HD, T, HPW>;
  for (int c = threadIdx.x; c < kStep * L::kCopies; c += kThreads) {
    const int j = c / L::kCopies, e = (c % L::kCopies) * L::kElems;
    const bool valid = t0 + j < t_end;
    const long long off = valid ? (t0 + j) * row + e : 0;
    cp_async16(stage + j * L::kKPitch + e * sizeof(T), kb + off, valid);
    cp_async16(stage + kStep * L::kKPitch + j * L::kRowBytes + e * sizeof(T),
               vb + off, valid);
  }
  asm volatile("cp.async.commit_group;\n");
}

template <int HD, typename T, int HPW>
__global__ void __launch_bounds__(kThreads)
decode_attn_split(const __nv_bfloat16* __restrict__ q,
                  const T* __restrict__ k, const T* __restrict__ v,
                  float* __restrict__ out, float* __restrict__ part_m,
                  float* __restrict__ part_l, float* __restrict__ part_acc,
                  int* __restrict__ counters, int H, int KV, int S,
                  int valid_len, int chunk, float scale, bool on_chip) {
  using L = Geo<HD, T, HPW>;
  constexpr int kAcc = L::kAcc;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* stages = smem;                                     // 2 stages
  float* qs = reinterpret_cast<float*>(smem + 2 * L::kStage); // [kG][HD]
  float* ps = qs + L::kG * HD;                                // [kG][kStep]
  float* inbox = ps + L::kG * kStep;      // cluster merge: partials pushed
  __shared__ float m_s[kMaxG], l_s[kMaxG], c_s[kMaxG];
  __shared__ float mbox[kClusterSplits * kMaxG], lbox[kClusterSplits * kMaxG];
  __shared__ int last;

  const int G = H / KV;
  const int b = blockIdx.x / KV;
  const int g = blockIdx.x % KV;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int t_begin = split * chunk;
  const int t_end = min(t_begin + chunk, valid_len);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dp = tid % (HD / 2), h0 = tid / (HD / 2);    // P.V's outputs
  // cluster merge: peers may write to this block's shared memory only
  // once it runs; arrive now, wait before the first push
  if (on_chip) cluster_arrive();

  const long long row = (long long)KV * HD;   // elements per position
  const T* kb = k + (long long)b * S * row + (long long)g * HD;
  const T* vb = v + (long long)b * S * row + (long long)g * HD;
  fetch_step<HD, T, HPW>(stages, kb, vb, row, t_begin, t_end);

  // q: 16-byte loads, all in flight at once; heads past G read as zero
  const long long head0 = (long long)b * H + (long long)g * G;
  const uint4* qb = reinterpret_cast<const uint4*>(q + head0 * HD);
  constexpr int kQLoads = (L::kG * HD / 8 + kThreads - 1) / kThreads;
  uint4 qr[kQLoads];
#pragma unroll
  for (int i = 0; i < kQLoads; ++i) {
    const int c = tid + i * kThreads;
    qr[i] = make_uint4(0u, 0u, 0u, 0u);
    if (c < G * HD / 8) qr[i] = qb[c];
  }
#pragma unroll
  for (int i = 0; i < kQLoads; ++i) {
    const int c = tid + i * kThreads;
    if (c < L::kG * HD / 8) {
      __align__(16) float tmp[8];
      upcast(qr[i], tmp, __nv_bfloat16());
      *reinterpret_cast<float4*>(qs + c * 8) =
          *reinterpret_cast<float4*>(tmp);
      *reinterpret_cast<float4*>(qs + c * 8 + 4) =
          *reinterpret_cast<float4*>(tmp + 4);
    }
  }
  if (tid < kMaxG) {
    m_s[tid] = kMasked;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;

  int cur = 0;
  for (int t0 = t_begin; t0 < t_end; t0 += kStep, cur ^= 1) {
    // the next step's copies go out now (an empty group past the end)
    if (t0 + kStep < t_end)
      fetch_step<HD, T, HPW>(stages + (cur ^ 1) * L::kStage, kb, vb, row,
                             t0 + kStep, t_end);
    else
      asm volatile("cp.async.commit_group;\n");
    asm volatile("cp.async.wait_group 1;\n");
    __syncthreads();
    const uint8_t* ksm = stages + cur * L::kStage;
    const T* vsm = reinterpret_cast<const T*>(ksm + kStep * L::kKPitch);

    // scores: heads warp + kWarps * hh, positions lane + 32 * i
    float s[HPW][kPos];
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh)
#pragma unroll
      for (int i = 0; i < kPos; ++i) s[hh][i] = 0.f;
#pragma unroll 2
    for (int e = 0; e < HD; e += L::kElems) {
      float kf[kPos][L::kElems];
#pragma unroll
      for (int i = 0; i < kPos; ++i) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            ksm + (lane + 32 * i) * L::kKPitch + e * sizeof(T));
        upcast(raw, kf[i], T());
      }
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) {
        const float* qh = qs + (warp + kWarps * hh) * HD + e;
#pragma unroll
        for (int x = 0; x < L::kElems; x += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(qh + x);
#pragma unroll
          for (int i = 0; i < kPos; ++i) {
            s[hh][i] = fmaf(q4.x, kf[i][x], s[hh][i]);
            s[hh][i] = fmaf(q4.y, kf[i][x + 1], s[hh][i]);
            s[hh][i] = fmaf(q4.z, kf[i][x + 2], s[hh][i]);
            s[hh][i] = fmaf(q4.w, kf[i][x + 3], s[hh][i]);
          }
        }
      }
    }
    // online softmax, the warp's heads side by side
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int r = warp + kWarps * hh;
      float mx = kMasked;
#pragma unroll
      for (int i = 0; i < kPos; ++i) {
        s[hh][i] = t0 + lane + 32 * i < t_end ? s[hh][i] * scale : kMasked;
        mx = fmaxf(mx, s[hh][i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kPos; ++i) {
        const float p = expf(s[hh][i] - m_new);
        ps[r * kStep + lane + 32 * i] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // P.V: a thread takes dims 2 dp, 2 dp + 1 of heads h0 + kHS * k; per
    // 4 positions, 4 V pairs and one float4 of p per head.  Positions past
    // the range have p = 0 and zero V rows.
    const int jend = (min(kStep, t_end - t0) + 3) & ~3;
    float pa[L::kHP][2], pb[L::kHP][2];
#pragma unroll
    for (int h = 0; h < L::kHP; ++h)
      pa[h][0] = pa[h][1] = pb[h][0] = pb[h][1] = 0.f;
#pragma unroll 2
    for (int j = 0; j < jend; j += 4) {
      float vv[4][2];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        upcast2(vsm + (j + u) * HD + 2 * dp, vv[u][0], vv[u][1]);
#pragma unroll
      for (int h = 0; h < L::kHP; ++h) {
        const int r = h0 + L::kHS * h;
        if (L::kHP * L::kHS > L::kG && r >= L::kG) continue;
        const float4 p4 = *reinterpret_cast<const float4*>(ps + r * kStep + j);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          pa[h][c] = fmaf(p4.x, vv[0][c], pa[h][c]);
          pb[h][c] = fmaf(p4.y, vv[1][c], pb[h][c]);
          pa[h][c] = fmaf(p4.z, vv[2][c], pa[h][c]);
          pb[h][c] = fmaf(p4.w, vv[3][c], pb[h][c]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < L::kHP; ++h) {
      const int r = h0 + L::kHS * h;
      if (L::kHP * L::kHS > L::kG && r >= L::kG) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        acc[2 * h + c] = acc[2 * h + c] * c_s[r] + (pa[h][c] + pb[h][c]);
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_all;\n");

  // acc[a] is output idx = (h0 + kHS * (a / 2)) * HD + 2 dp + a % 2
  auto out_idx = [&](int a) { return (h0 + L::kHS * (a >> 1)) * HD + 2 * dp
                                     + (a & 1); };
  if (n_split == 1) {
    float* ob = out + head0 * HD;
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int idx = out_idx(a);
      if (idx < G * HD) ob[idx] = acc[a] / l_s[idx / HD];
    }
    return;
  }
  if (on_chip) {
    // The row's blocks form one thread block cluster.  Output idx belongs
    // to block idx / share; every block pushes its partials of those
    // outputs, and its m and l, into the owner's inbox (distributed
    // shared memory), so after one cluster barrier each block merges its
    // share from its own shared memory, in split order.
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const int share = (G * HD + n_split - 1) / n_split;
    cluster_wait();                   // every block of the cluster runs
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int idx = out_idx(a);
      if (idx < G * HD) {
        const int owner = idx / share;
        cluster.map_shared_rank(inbox, owner)[split * share +
                                              idx - owner * share] = acc[a];
      }
    }
    if (tid < G)
      for (int t = 0; t < n_split; ++t) {
        cluster.map_shared_rank(mbox, t)[split * kMaxG + tid] = m_s[tid];
        cluster.map_shared_rank(lbox, t)[split * kMaxG + tid] = l_s[tid];
      }
    cluster.sync();                   // every push has landed
    if (tid < G) {
      float mx = kMasked;
      for (int t = 0; t < n_split; ++t) mx = fmaxf(mx, mbox[t * kMaxG + tid]);
      float dsum = 0.f;
      for (int t = 0; t < n_split; ++t) {
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
      for (int t = 0; t < n_split; ++t)
        num += inbox[t * share + li] * mbox[t * kMaxG + r];
      out[head0 * HD + idx] = num / l_s[r];
    }
    return;
  }
  float* mine = reinterpret_cast<float*>(stages);   // free after the loop

  // partials: acc as [(batch row, KV head)][split][G * HD], m and l as
  // [head][split]
  float* part = part_acc + ((long long)blockIdx.x * n_split + split) * G * HD;
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int idx = out_idx(a);
    if (idx < G * HD) part[idx] = acc[a];
  }
  if (tid < G) {
    part_m[(head0 + tid) * n_split + split] = m_s[tid];
    part_l[(head0 + tid) * n_split + split] = l_s[tid];
  }
  // The last block of this (batch row, KV head) to finish merges the
  // n_split partials in split order: no float atomics, so the output does
  // not depend on which block that is.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[blockIdx.x], 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  if (tid == 0) counters[blockIdx.x] = 0;   // every block has counted
  __threadfence();
  // per head: the joint max, each split's weight exp(m - max) and the
  // denominator (lanes over splits, then a fixed shuffle tree)
  float* wgt = mine;                                 // [G][n_split]
  for (int r = warp; r < G; r += kWarps) {
    const float* pm = part_m + (head0 + r) * n_split;
    const float* pl = part_l + (head0 + r) * n_split;
    const float m0 = lane < n_split ? __ldcg(pm + lane) : kMasked;
    const float m1 = lane + 32 < n_split ? __ldcg(pm + lane + 32) : kMasked;
    const float l0 = lane < n_split ? __ldcg(pl + lane) : 0.f;
    const float l1 = lane + 32 < n_split ? __ldcg(pl + lane + 32) : 0.f;
    float mx = fmaxf(m0, m1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float c0 = expf(m0 - mx), c1 = expf(m1 - mx);
    if (lane < n_split) wgt[r * n_split + lane] = c0;
    if (lane + 32 < n_split) wgt[r * n_split + lane + 32] = c1;
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
  for (int s0 = 0; s0 < n_split; s0 += kU) {
    float pv[kU][kAcc];
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int a = 0; a < kAcc; ++a) {
        const int idx = tid + a * kThreads;
        pv[u][a] = idx < G * HD && s0 + u < n_split
            ? __ldcg(pall + (long long)(s0 + u) * G * HD + idx) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int a = 0; a < kAcc; ++a) {
        const int idx = tid + a * kThreads;
        if (idx < G * HD && s0 + u < n_split)
          num[a] = fmaf(pv[u][a], wgt[(idx / HD) * n_split + s0 + u], num[a]);
      }
  }
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int idx = tid + a * kThreads;
    if (idx < G * HD) out[head0 * HD + idx] = num[a] / l_s[idx / HD];
  }
}

template <int HD, typename T, int HPW>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* out,
                     void* partials, int* counters, int B, int H, int KV,
                     int S, int valid_len, int chunk, float scale,
                     cudaStream_t stream) {
  using L = Geo<HD, T, HPW>;
  static_assert(L::kStage >= 4 * kMaxG * kMaxSplits,
                "merge weights must fit in a stage");
  auto* kern = decode_attn_split<HD, T, HPW>;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Once: shared memory above 48 KB, and a check that the card schedules
  // a 16-block cluster of this kernel (an H100 does; where one is
  // refused, every launch fails).
  static bool checked = false;
  static cudaError_t ready = cudaSuccess;
  if (!checked) {
    checked = true;
    ready = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (ready == cudaSuccess)
      ready = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (ready == cudaSuccess) {
      cfg.gridDim = dim3(1, kClusterSplits);
      attr[0].val.clusterDim.y = kClusterSplits;
      int clusters = 0;
      ready = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
      if (ready == cudaSuccess && clusters < 1) ready = cudaErrorNotSupported;
      cudaGetLastError();                // reported by every launch instead
    }
  }
  if (ready != cudaSuccess) return ready;
  const int n_split = (valid_len + chunk - 1) / chunk;
  const bool on_chip = n_split > 1 && n_split <= kClusterSplits;
  const long long heads = (long long)B * H;
  float* pm = static_cast<float*>(partials);
  float* pl = pm == nullptr ? nullptr : pm + heads * n_split;
  float* pa = pm == nullptr ? nullptr : pl + heads * n_split;
  cfg.gridDim = dim3(B * KV, n_split);
  attr[0].val.clusterDim.y = on_chip ? n_split : 1;   // a row: one cluster
  return cudaLaunchKernelEx(
      &cfg, kern, static_cast<const __nv_bfloat16*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<float*>(out), pm, pl, pa, counters, H, KV, S, valid_len,
      chunk, scale, on_chip);
}

// heads per warp: the fewest that cover the group
template <int HD, typename T>
cudaError_t launch_g(const void* q, const void* k, const void* v, void* out,
                     void* partials, int* counters, int B, int H, int KV,
                     int S, int valid_len, int chunk, float scale,
                     cudaStream_t stream) {
  static_assert(2 * kWarps >= kMaxG, "two heads a warp cover a group");
  if (H / KV <= kWarps)
    return launch_t<HD, T, 1>(q, k, v, out, partials, counters, B, H, KV, S,
                              valid_len, chunk, scale, stream);
  return launch_t<HD, T, 2>(q, k, v, out, partials, counters, B, H, KV, S,
                            valid_len, chunk, scale, stream);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   void* partials, int* counters, int B, int H, int KV,
                   int S, int valid_len, int chunk, float scale, int kv_fp8,
                   cudaStream_t stream) {
  if (kv_fp8)
    return launch_g<HD, __nv_fp8_e4m3>(q, k, v, out, partials, counters, B,
                                       H, KV, S, valid_len, chunk, scale,
                                       stream);
  return launch_g<HD, __nv_bfloat16>(q, k, v, out, partials, counters, B, H,
                                     KV, S, valid_len, chunk, scale, stream);
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
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > kMaxG || valid_len < 1 ||
      valid_len > S || chunk < 1 ||
      (valid_len + chunk - 1) / chunk > kMaxSplits ||
      (reinterpret_cast<uintptr_t>(q) & 15u) ||
      (valid_len > kClusterSplits * chunk &&
       (partials == nullptr || counters == nullptr)) ||
      ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v))
       & 15u))
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* c = static_cast<int*>(counters);
  switch (hd) {
    case 32:
      return static_cast<int>(launch<32>(q, k, v, out, partials, c, B, H, KV,
                                         S, valid_len, chunk, scale, kv_fp8,
                                         s));
    case 64:
      return static_cast<int>(launch<64>(q, k, v, out, partials, c, B, H, KV,
                                         S, valid_len, chunk, scale, kv_fp8,
                                         s));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, out, partials, c, B, H,
                                          KV, S, valid_len, chunk, scale,
                                          kv_fp8, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
