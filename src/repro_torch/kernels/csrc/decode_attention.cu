// Single-query (decode) attention over a position-tagged KV cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, kernel body _decode_kernel). For one new token per
// row, q (B, 1, H, D), a cache k, v (B, T, KH, D) whose slot t holds global
// position tags[b, t] (-1: empty), and the current position index[b]:
//
//   o[b, 0, h] = softmax_t(scale * q_h . k_t  masked) . v_t
//
// with the mask 0 <= tag <= index[b] and, for window > 0, tag >
// index[b] - window. The current position is taken per row, as the
// reference's q_offset is (not the batch-wide max tag of the Pallas route).
// Masked scores are -1e30 and the sum is clipped at 1e-30, as in the JAX
// package. Inputs are float32 or bfloat16; accumulation is float32.
//
// What bounds it on an H100: every cache element is read once and used in
// two multiply-adds, so it is bound by reading 2 * B * T * KH * D elements
// (86.5 MB at the serve path's B=4, T=1056, KH=32, D=80 in float32, about
// 0.026 ms at 3.35 TB/s; 17.3 MB, 0.00516 ms, at qwen3-moe-235b-a22b's
// B=4, T=1056, KH=4, D=128, where the split reads the cache twice).
//
// Design. The TPU kernel streams cache blocks through VMEM along a
// sequential grid axis, one query head per grid row, and so reads the
// cache once per query head. Here one block owns one (b, kv head) and
// serves up to kHeadsPerBlock = 8 of its g = H / KH query heads, keeping
// their q and accumulators in registers; a group of more than 8 heads is
// split over ceil(g / 8) blocks, each reading its kv head's cache, so
// the cache is read once up to g = 8 and ceil(g / 8) times above (twice
// at g = 16: qwen3-moe-235b-a22b's 64 heads over 4, chatglm3-6b's 32 over
// 2). The grid is (KH * ceil(g / 8), B).
// Its eight warps split the slots: each warp walks every eighth group of
// four slots, loading the four keys and values (lane c owns columns
// c + 32 j of D, so a row is read in full coalesced lines) before any
// arithmetic, so several loads are in flight. A score is a warp-shuffle
// sum; each warp keeps its own online-softmax state per head, and at the
// end the warps' states are merged through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

#include "smem_limit.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;                // slots per warp step
constexpr int kHeadsPerBlock = 8;         // query heads a block serves
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// G >= the query heads a block serves: min(g, G), fewer in a split
// group's last block; DCH 32-wide column chunks (D <= 32 DCH).
template <typename T, int G, int DCH>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ tags,
                  const int* __restrict__ index, T* __restrict__ o,
                  int t_len, int heads, int kv_heads, int d, int window,
                  float scale) {
  extern __shared__ float smem[];
  float* m_s = smem;                          // [kWarps][G]
  float* l_s = m_s + kWarps * G;              // [kWarps][G]
  float* a_s = l_s + kWarps * G;              // [kWarps][G][d]

  const int g = heads / kv_heads;
  const int splits = (g + G - 1) / G;         // blocks a group spans
  const int kh = blockIdx.x / splits;
  const int h0 = (blockIdx.x - kh * splits) * G;   // first head in group
  const int gb = min(G, g - h0);              // heads this block serves
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int idx = index[b];

  const size_t k_stride = static_cast<size_t>(kv_heads) * d;
  const T* kb = k + static_cast<size_t>(b) * t_len * k_stride +
                static_cast<size_t>(kh) * d;
  const T* vb = v + static_cast<size_t>(b) * t_len * k_stride +
                static_cast<size_t>(kh) * d;
  const int* tb = tags + static_cast<size_t>(b) * t_len;
  const size_t q_off =
      (static_cast<size_t>(b) * heads + kh * g + h0) * d;

  float qv[G][DCH], acc[G][DCH], m[G], l[G];
#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
    m[hh] = kNegInf;
    l[hh] = 0.f;
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int col = lane + 32 * c;
      qv[hh][c] = hh < gb && col < d
                      ? to_f32(q[q_off + hh * d + col]) * scale
                      : 0.f;
      acc[hh][c] = 0.f;
    }
  }

  for (int t0 = warp * kUnroll; t0 < t_len; t0 += kWarps * kUnroll) {
    float kr[kUnroll][DCH], vr[kUnroll][DCH];
    bool ok[kUnroll], live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      live[u] = t < t_len;
      const int tag = live[u] ? tb[t] : -1;
      ok[u] = tag >= 0 && tag <= idx && (window <= 0 || tag > idx - window);
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        const int col = lane + 32 * c;
        const bool in = live[u] && col < d;
        kr[u][c] = in ? to_f32(kb[t * k_stride + col]) : 0.f;
        vr[u][c] = in ? to_f32(vb[t * k_stride + col]) : 0.f;
      }
    }
#pragma unroll
    for (int hh = 0; hh < G; ++hh) {
      if (hh >= gb) break;
      float s[kUnroll];
      float mx = m[hh];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
#pragma unroll
        for (int c = 0; c < DCH; ++c) part = fmaf(qv[hh][c], kr[u][c], part);
        part = warp_sum(part);
        s[u] = ok[u] ? part : kNegInf;
        if (live[u]) mx = fmaxf(mx, s[u]);
      }
      const float alpha = expf(m[hh] - mx);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < DCH; ++c) acc[hh][c] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        // slots past T are no slot at all; masked slots keep the -1e30
        // convention (a row with no valid slot averages all of them)
        const float p = live[u] ? expf(s[u] - mx) : 0.f;
        psum += p;
#pragma unroll
        for (int c = 0; c < DCH; ++c) acc[hh][c] = fmaf(p, vr[u][c], acc[hh][c]);
      }
      l[hh] = alpha * l[hh] + psum;
      m[hh] = mx;
    }
  }

  // merge the warps' states
#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
    if (hh >= gb) break;
    if (lane == 0) {
      m_s[warp * G + hh] = m[hh];
      l_s[warp * G + hh] = l[hh];
    }
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int col = lane + 32 * c;
      if (col < d) a_s[(warp * G + hh) * d + col] = acc[hh][c];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gb * d; i += kThreads) {
    const int hh = i / d;
    const int col = i - hh * d;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w * G + hh]);
    float den = 0.f, num = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_s[w * G + hh] - mx);
      den += l_s[w * G + hh] * f;
      num += a_s[(w * G + hh) * d + col] * f;
    }
    store(o + q_off + hh * d + col, num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int G, int DCH>
int launch(const void* q, const void* k, const void* v, const void* tags,
           const void* index, void* o, int b, int t, int h, int kh, int d,
           int window, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kWarps * G + static_cast<size_t>(kWarps) * G * d);
  auto kernel = decode_kernel<T, G, DCH>;
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t err = allow_smem_once(kernel, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(kh * ((h / kh + G - 1) / G), b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tags),
      static_cast<const int*>(index), static_cast<T*>(o), t, h, kh, d,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G>
int by_width(const void* q, const void* k, const void* v, const void* tags,
             const void* index, void* o, int b, int t, int h, int kh, int d,
             int window, float scale, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, G, 1>(q, k, v, tags, index, o, b, t, h, kh, d, window,
                           scale, stream);
  if (d <= 64)
    return launch<T, G, 2>(q, k, v, tags, index, o, b, t, h, kh, d, window,
                           scale, stream);
  if (d <= 96)
    return launch<T, G, 3>(q, k, v, tags, index, o, b, t, h, kh, d, window,
                           scale, stream);
  if (d <= 128)
    return launch<T, G, 4>(q, k, v, tags, index, o, b, t, h, kh, d, window,
                           scale, stream);
  if (d <= 256)
    return launch<T, G, 8>(q, k, v, tags, index, o, b, t, h, kh, d, window,
                           scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* tags,
             const void* index, void* o, int b, int t, int h, int kh, int d,
             int window, float scale, cudaStream_t stream) {
  const int g = h / kh;
  if (g <= 1)
    return by_width<T, 1>(q, k, v, tags, index, o, b, t, h, kh, d, window,
                          scale, stream);
  if (g <= 2)
    return by_width<T, 2>(q, k, v, tags, index, o, b, t, h, kh, d, window,
                          scale, stream);
  if (g <= 4)
    return by_width<T, 4>(q, k, v, tags, index, o, b, t, h, kh, d, window,
                          scale, stream);
  // eight heads a block; a larger group is split over several blocks
  return by_width<T, kHeadsPerBlock>(q, k, v, tags, index, o, b, t, h, kh,
                                     d, window, scale, stream);
}

}  // namespace

// q: (b, 1, h, d); k, v: (b, t, kh, d); tags: (b, t) int32; index: (b,)
// int32; o: (b, 1, h, d). Returns a CUDA error code (0 on success).
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const void* tags,
                                    const void* index, void* o, int b, int t,
                                    int h, int kh, int d, int window,
                                    float scale, void* stream) {
  return dispatch<float>(q, k, v, tags, index, o, b, t, h, kh, d, window,
                         scale, static_cast<cudaStream_t>(stream));
}

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* tags,
                                     const void* index, void* o, int b,
                                     int t, int h, int kh, int d, int window,
                                     float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, tags, index, o, b, t, h, kh, d,
                                 window, scale,
                                 static_cast<cudaStream_t>(stream));
}
