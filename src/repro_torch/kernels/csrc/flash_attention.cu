// Blockwise (flash) attention: the prefill attention of the LM path.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, kernel body _flash_kernel, grid from _call). For
// q (B, S, H, D) and k, v (B, T, KH, D), query head h reads kv head
// h / (H / KH) (GQA), and
//
//   o[b, i, h] = softmax_j(scale * q_i . k_j  masked) . v_j
//
// with the causal mask j <= i and the sliding-window mask j > i - window
// (window 0: none). A masked score is -1e30 and the row sum is clipped at
// 1e-30, the JAX package's conventions. Inputs are float32 or bfloat16;
// scores, the online-softmax state and the accumulator are float32.
//
// What bounds it on an H100: 4 * B * H * S * T * D operations (halved by
// the causal mask) against (2 * B * S * H + 2 * B * T * KH) * D elements
// moved. At the serve path's (4, 1024, 32, 80), causal, that is about
// 21.5 GFLOP against 84 MB: bound by operations, 0.32 ms at the float32
// rate outside the tensor cores. This first version does not use the
// tensor cores.
//
// Design. The TPU kernel runs a (batch, head, q-block, k-block) grid whose
// innermost k axis runs in order on one core, so its running max, sum and
// accumulator live in VMEM scratch across grid steps. Hopper blocks run in
// no order, so here one block owns one (b, h, 64-row q tile) and walks the
// k tiles itself, in order, with the online-softmax state in registers.
// Eight warps each own eight query rows; a k tile of 64 keys and its
// values are staged in shared memory (keys with an odd row stride, so the
// 32 lanes reading 32 keys hit 32 banks); lane j scores keys j and j + 32
// for the warp's rows, the row max and sum are warp shuffles, and the
// probabilities go through shared memory to the P.V product, where each
// lane owns the columns lane + 32 c of D (any D <= 256; Zamba2's D = 80 is
// not a power of two). K tiles that the causal or window mask removes for
// every row of the q tile are skipped.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;                  // query rows per warp
constexpr int kBQ = kWarps * kRows;       // query rows per block
constexpr int kBK = 64;                   // keys per tile (two per lane)
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// DCH = number of 32-wide column chunks of D a lane owns (D <= 32 * DCH).
template <typename T, int DCH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int s_len,
                     int t_len, int heads, int kv_heads, int d, int causal,
                     int window, float scale) {
  extern __shared__ float smem[];
  const int dk = d + 1;                       // padded key row stride
  float* q_s = smem;                          // [kBQ][d]
  float* k_s = q_s + kBQ * d;                 // [kBK][d + 1]
  float* v_s = k_s + kBK * dk;                // [kBK][d]
  float* p_s = v_s + kBK * d;                 // [kBQ][kBK]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (heads / kv_heads);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * kRows;

  const size_t q_stride = static_cast<size_t>(heads) * d;    // per position
  const size_t k_stride = static_cast<size_t>(kv_heads) * d;
  const T* qb = q + static_cast<size_t>(b) * s_len * q_stride +
                static_cast<size_t>(h) * d;
  const T* kb = k + static_cast<size_t>(b) * t_len * k_stride +
                static_cast<size_t>(kh) * d;
  const T* vb = v + static_cast<size_t>(b) * t_len * k_stride +
                static_cast<size_t>(kh) * d;
  T* ob = o + static_cast<size_t>(b) * s_len * q_stride +
          static_cast<size_t>(h) * d;

  for (int i = threadIdx.x; i < kBQ * d; i += kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    const int qp = q0 + r;
    q_s[i] = qp < s_len ? to_f32(qb[qp * q_stride + c]) * scale : 0.f;
  }

  // k tiles that hold a key some row of this q tile can see
  int k_begin = 0;
  int k_end = t_len;
  if (causal) k_end = min(k_end, min(q0 + kBQ, s_len));
  if (window > 0) k_begin = max(0, q0 - window + 1) / kBK * kBK;

  float m[kRows], l[kRows], acc[kRows][DCH];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DCH; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();      // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kBK * d; i += kThreads) {
      const int j = i / d;
      const int c = i - j * d;
      const int kp = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kp < t_len) {
        kv = to_f32(kb[kp * k_stride + c]);
        vv = to_f32(vb[kp * k_stride + c]);
      }
      k_s[j * dk + c] = kv;
      v_s[i] = vv;
    }
    __syncthreads();

    float s0[kRows], s1[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s0[r] = s1[r] = 0.f;
    const float* ka = k_s + lane * dk;
    const float* kc = k_s + (lane + 32) * dk;
    const float* qr = q_s + r0 * d;
    for (int c = 0; c < d; ++c) {
      const float x0 = ka[c];
      const float x1 = kc[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = qr[r * d + c];
        s0[r] = fmaf(qv, x0, s0[r]);
        s1[r] = fmaf(qv, x1, s1[r]);
      }
    }

    const int kp0 = k0 + lane;
    const int kp1 = kp0 + 32;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qp = q0 + r0 + r;
      bool ok0 = kp0 < t_len;
      bool ok1 = kp1 < t_len;
      if (causal) {
        ok0 = ok0 && kp0 <= qp;
        ok1 = ok1 && kp1 <= qp;
      }
      if (window > 0) {
        ok0 = ok0 && kp0 > qp - window;
        ok1 = ok1 && kp1 > qp - window;
      }
      const float a0 = ok0 ? s0[r] : kNegInf;
      const float a1 = ok1 ? s1[r] : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(fmaxf(a0, a1)));
      // keys past T are no slot at all (the TPU kernel's padded tail):
      // they take no share, unlike a masked slot
      const float p0 = kp0 < t_len ? expf(a0 - m_new) : 0.f;
      const float p1 = kp1 < t_len ? expf(a1 - m_new) : 0.f;
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DCH; ++c) acc[r][c] *= alpha;
      p_s[(r0 + r) * kBK + lane] = p0;
      p_s[(r0 + r) * kBK + lane + 32] = p1;
    }
    __syncwarp();

    const int kn = min(kBK, t_len - k0);
    for (int j = 0; j < kn; ++j) {
      float vv[DCH];
#pragma unroll
      for (int c = 0; c < DCH; ++c) {
        const int col = lane + 32 * c;
        vv[c] = col < d ? v_s[j * d + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = p_s[(r0 + r) * kBK + j];
#pragma unroll
        for (int c = 0; c < DCH; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qp = q0 + r0 + r;
    if (qp >= s_len) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DCH; ++c) {
      const int col = lane + 32 * c;
      if (col < d) store(ob + qp * q_stride + col, acc[r][c] / den);
    }
  }
}

template <typename T, int DCH>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int s, int t, int h, int kh, int d, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kBQ) * d + kBK * (d + 1) +
                       static_cast<size_t>(kBK) * d + kBQ * kBK);
  auto kernel = flash_fwd_kernel<T, DCH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, t, h, kh, d, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int s, int t, int h, int kh, int d, int causal, int window,
             float scale, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 1>(q, k, v, o, b, s, t, h, kh, d, causal, window, scale,
                        stream);
  if (d <= 64)
    return launch<T, 2>(q, k, v, o, b, s, t, h, kh, d, causal, window, scale,
                        stream);
  if (d <= 96)
    return launch<T, 3>(q, k, v, o, b, s, t, h, kh, d, causal, window, scale,
                        stream);
  if (d <= 128)
    return launch<T, 4>(q, k, v, o, b, s, t, h, kh, d, causal, window, scale,
                        stream);
  if (d <= 256)
    return launch<T, 8>(q, k, v, o, b, s, t, h, kh, d, causal, window, scale,
                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: (b, s, h, d); k, v: (b, t, kh, d); o: (b, s, h, d); all contiguous,
// of one type. Returns a CUDA error code (0 on success).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int b, int s,
                                   int t, int h, int kh, int d, int causal,
                                   int window, float scale, void* stream) {
  return dispatch<float>(q, k, v, o, b, s, t, h, kh, d, causal, window,
                         scale, static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int b, int s,
                                    int t, int h, int kh, int d, int causal,
                                    int window, float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, b, s, t, h, kh, d, causal,
                                 window, scale,
                                 static_cast<cudaStream_t>(stream));
}
