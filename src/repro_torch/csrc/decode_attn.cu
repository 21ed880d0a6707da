// One-token GQA decode attention for Hopper (sm_90a) over a bf16 or
// fp8-e4m3 KV cache.
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
// per byte at which the H100's arithmetic would become the limit.
//
// Design: one block per (batch row, KV head) carries the online-softmax
// state (m, l, acc) of the G query heads that share that KV head, so each
// K/V row is read once for all G heads.  A loop over tiles of kTile
// positions takes the place of the TPU's sequential grid axis and stops
// at valid_len, so slots past it are never read; the ragged last tile is
// masked in the kernel.  Tiles are upcast to f32 on their way into shared
// memory (bf16 and fp8 alike).  Every block runs a short serial chain, so
// at batch 1 the card is mostly idle: splitting the S loop over blocks
// (flash-decoding) is the next step for speed.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;     // positions per tile == warp width
constexpr int kMaxG = 16;     // query heads per KV head

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,
                   const T* __restrict__ k, const T* __restrict__ v,
                   float* __restrict__ out, int H, int KV, int S,
                   int valid_len, float scale) {
  constexpr int kAcc = (kMaxG * HD + kThreads - 1) / kThreads;
  __shared__ float qs[kMaxG][HD];
  __shared__ float ks[kTile][HD + 1];   // +1: conflict-free row reads
  __shared__ float vs[kTile][HD];
  __shared__ float ps[kMaxG][kTile];
  __shared__ float m_s[kMaxG], l_s[kMaxG], c_s[kMaxG];

  const int G = H / KV;
  const int b = blockIdx.x / KV;
  const int g = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const __nv_bfloat16* qb = q + ((long long)b * H + (long long)g * G) * HD;
  for (int i = tid; i < G * HD; i += kThreads)
    qs[i / HD][i % HD] = __bfloat162float(qb[i]);
  if (tid < G) {
    m_s[tid] = -1e30f;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int a = 0; a < kAcc; ++a) acc[a] = 0.f;
  __syncthreads();

  const long long row = (long long)KV * HD;   // elements per position
  const T* kb = k + (long long)b * S * row + (long long)g * HD;
  const T* vb = v + (long long)b * S * row + (long long)g * HD;

  for (int t0 = 0; t0 < valid_len; t0 += kTile) {
    for (int i = tid; i < kTile * HD; i += kThreads) {
      const int j = i / HD, d = i % HD, t = t0 + j;
      float kx = 0.f, vx = 0.f;
      if (t < valid_len) {
        kx = to_f32(kb[t * row + d]);
        vx = to_f32(vb[t * row + d]);
      }
      ks[j][d] = kx;
      vs[j][d] = vx;
    }
    __syncthreads();
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int r = i / kTile, j = i % kTile;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s += qs[r][d] * ks[j][d];
      ps[r][j] = (t0 + j < valid_len) ? s * scale : -1e30f;
    }
    __syncthreads();
    // one warp per head; its lanes are the tile's kTile positions
    for (int r = warp; r < G; r += kThreads / 32) {
      const float s = ps[r][lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(s - m_new);
      ps[r][lane] = p;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      const int idx = tid + a * kThreads;
      if (idx < G * HD) {
        const int r = idx / HD, d = idx % HD;
        float pv = 0.f;
#pragma unroll 8
        for (int j = 0; j < kTile; ++j) pv += ps[r][j] * vs[j][d];
        acc[a] = acc[a] * c_s[r] + pv;
      }
    }
    __syncthreads();
  }

  float* ob = out + ((long long)b * H + (long long)g * G) * HD;
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int idx = tid + a * kThreads;
    if (idx < G * HD) ob[idx] = acc[a] / l_s[idx / HD];
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int KV, int S, int valid_len, float scale,
                   int kv_fp8, cudaStream_t stream) {
  const dim3 grid(B * KV);
  if (kv_fp8) {
    decode_attn_kernel<HD, __nv_fp8_e4m3><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_fp8_e4m3*>(k),
        static_cast<const __nv_fp8_e4m3*>(v), static_cast<float*>(out), H,
        KV, S, valid_len, scale);
  } else {
    decode_attn_kernel<HD, __nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<float*>(out), H,
        KV, S, valid_len, scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q: (B, H, hd) bf16; k, v: (B, S, KV, hd) bf16 or fp8-e4m3 (kv_fp8);
// out: (B, H, hd) f32.  All contiguous.  Returns the launch's cudaError_t.
extern "C" int decode_attn(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int KV, int S, int hd,
                           int valid_len, float scale, int kv_fp8,
                           int device, void* stream) {
  if (B < 1 || KV < 1 || H % KV != 0 || H / KV > kMaxG || valid_len < 1 ||
      valid_len > S)
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return static_cast<int>(
          launch<32>(q, k, v, out, B, H, KV, S, valid_len, scale, kv_fp8, s));
    case 64:
      return static_cast<int>(
          launch<64>(q, k, v, out, B, H, KV, S, valid_len, scale, kv_fp8, s));
    case 128:
      return static_cast<int>(
          launch<128>(q, k, v, out, B, H, KV, S, valid_len, scale, kv_fp8, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
