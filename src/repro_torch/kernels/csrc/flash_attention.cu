// Blockwise (flash) attention: the prefill attention of the LM path (K3).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:75
// (_flash_kernel; its grid comes from _call, :121). For q (B, S, H, D)
// and k, v (B, T, KH, D), query head h reads kv head h / (H / KH) (GQA),
// and
//
//   o[b, i, h] = softmax_j(scale * q_i . k_j  masked) . v_j
//
// with the causal mask j <= i and the sliding-window mask j > i - window
// (window 0: none). A masked score is -1e30 and the row sum is clipped at
// 1e-30, the JAX package's conventions; keys past T take no weight.
// Inputs are float32 or bfloat16, any D <= 256; scores, the online-softmax
// state and the accumulator are float32.
//
// What bounds it on an H100: 4 * B * H * S * T * D operations (halved by
// the causal mask) against (2 * B * S * H + 2 * B * T * KH) * D elements
// moved. At the serve path's (4, 1024, 32, 80), causal, float32, that is
// 21.5 GFLOP against 168 MB, so operations bound it twice over:
//   - on the CUDA cores (67 TFLOP/s float32): 0.32 ms;
//   - on the tensor cores in 3xTF32 (three TF32 passes at 495 TFLOP/s):
//     0.13 ms.
// The memory bound is 0.050 ms. The kernel therefore runs both products
// on the tensor cores, at float32 accuracy, and keeps the tensor pipe fed
// from shared memory that a copy engine fills behind it.
//
// Design.
// - 3xTF32. S = (scale log2(e) Q) K^T and O = P V run on
//   mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32. Each operand x is split
//   into hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest with
//   ties away (the rounding of cvt.rna.tf32.f32, done here as two integer
//   ops: add 0x1000 to the bits and clear the low 13), and a product is
//   lo*hi + hi*lo + hi*hi, small terms first, as CUTLASS's
//   OpMultiplyAddFastF32 does on the float32 path of PyTorch's
//   memory-efficient attention. It drops only lo*lo, about 2^-22 of the
//   product; one TF32 pass keeps about 2^-11 and misses the float32
//   tolerance (tests/test_torch_lm_kernels.py emulates both). bfloat16
//   values are exact in TF32, so K and V have lo = 0 there and that pass
//   is skipped. The split, the mma and the cp.async helpers live in
//   tf32_mma.cuh, shared with the SSD chunk scan (K5). mma.sync and not
//   wgmma: TF32 wgmma reads B only K-major
//   from shared memory, and V stored [key][d] is MN-major in P V, while
//   mma.sync takes both operands from registers, where the split happens.
// - No P hand-off. In the m16n8k8 TF32 fragments (PTX ISA, "Matrix
//   Fragments for mma.m16n8k8", .tf32), lane (g = lane / 4, t = lane % 4)
//   holds A at rows g, g + 8 and columns t, t + 4, B at rows t, t + 4 and
//   column g, and C at rows g, g + 8 and columns 2t, 2t + 1. The C
//   fragment of S is thus not the A fragment P V needs. But the k index
//   of a product is summed over, so the kernel permutes it within every
//   step of 8: k slot t stands for element 2t and slot t + 4 for element
//   2t + 1. Then the S fragment (c0, c2, c1, c3) is P's A fragment as it
//   stands, with no shuffle and no shared tile, and V's B fragment reads
//   keys 2t and 2t + 1. In Q K^T the same permutation of d puts a lane's
//   two K values side by side: one 8-byte load.
// - Async K/V ring. A block owns one (b, h, 64-row q tile); four warps own
//   16 rows each and walk the k tiles in order with the online-softmax
//   state in registers (FlashAttention-2). K and V tiles go through a
//   two-stage shared-memory ring filled by cp.async (16 bytes when D is a
//   multiple of 4 and the rows are 16-byte aligned, else 4 bytes), so the
//   copy of tile j + 1 runs under the products on tile j; rows past T are
//   zero-filled by the copy and the columns D..Dp - 1 (Dp: D rounded up
//   to 8) are zeroed once. bfloat16 tiles are converted on the way in by
//   plain loads. Row strides are padded so every fragment load is free of
//   bank conflicts: K's stride is 8 or 24 modulo 32 words (a half warp's
//   8-byte loads, 4 rows by 4 lanes, cover all 32 banks), V's is 4 modulo
//   8 (8 columns by 4 even rows).
// - Registers. Q is scaled by scale * log2(e) (the softmax then uses
//   exp2f) and split once. Up to D = 80 its hi and lo fragments stay in
//   registers (80 at D = 80, beside 40 of accumulator and 32 of scores);
//   above that Q stays in shared memory and is split per k step.
// - Shared memory: 2 stages x 64 keys x (88 + 84) floats = 88 KB at
//   D = 80, two blocks per SM. D > 80 takes 32-key tiles, which keeps two
//   blocks per SM up to D = 128 and the scores' registers in bounds.
// - Heaviest tiles first: the grid is 1-D with the q tile slowest and
//   reversed, so the causal diagonal's long rows start in the first wave.
// - K tiles that the causal or window mask removes for every row of the
//   q tile are skipped; the masks are applied only on tiles that cross
//   the diagonal, the window's edge or T.
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "smem_limit.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBQ = kWarps * 16;         // query rows per block
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// The tiling of one head width: NDK steps of 8 over Dp = 8 * NDK.
template <int NDK>
struct Tile {
  static constexpr int kDp = 8 * NDK;
  static constexpr int kBK = NDK > 10 ? 32 : 64;           // keys per tile
  static constexpr bool kQInRegs = NDK <= 10;
  static constexpr int kLdK = kDp + (kDp % 16 == 0 ? 8 : 0);  // 8|24 mod 32
  static constexpr int kLdV = kDp + 4;                        // 4 mod 8
  static constexpr int kStage = kBK * (kLdK + kLdV);          // floats
  static constexpr size_t kSmem =
      sizeof(float) * (kStages * kStage + (kQInRegs ? 0 : kBQ * kLdK));
};

// Stages keys k0 .. k0 + BK - 1 of one kv head into ks [BK][kLdK] and
// vs [BK][kLdV]; rows past T become zeros. float32 goes by cp.async,
// bfloat16 by plain loads converted to float32.
template <typename T, int NDK>
__device__ __forceinline__ void load_kv(float* ks, float* vs, const T* kb,
                                        const T* vb, size_t stride, int k0,
                                        int t_len, int d, bool vec,
                                        int warp, int lane) {
  using S = Tile<NDK>;
  for (int r = warp; r < S::kBK; r += kWarps) {
    const int kp = k0 + r;
    const bool ok = kp < t_len;
    const size_t off = static_cast<size_t>(ok ? kp : 0) * stride;
    float* kr = ks + r * S::kLdK;
    float* vr = vs + r * S::kLdV;
    if constexpr (std::is_same<T, float>::value) {
      if (vec) {
        for (int c = 4 * lane; c < d; c += 128) {
          cp_async16(kr + c, kb + off + c, ok);
          cp_async16(vr + c, vb + off + c, ok);
        }
      } else {
        for (int c = lane; c < d; c += 32) {
          cp_async4(kr + c, kb + off + c, ok);
          cp_async4(vr + c, vb + off + c, ok);
        }
      }
    } else {
      for (int c = lane; c < d; c += 32) {
        kr[c] = ok ? to_f32(kb[off + c]) : 0.f;
        vr[c] = ok ? to_f32(vb[off + c]) : 0.f;
      }
    }
  }
}

template <typename T, int NDK>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int batch,
                     int s_len, int t_len, int heads, int kv_heads, int d,
                     int causal, int window, float qscale, int nq,
                     int vec) {
  using S = Tile<NDK>;
  constexpr int kBK = S::kBK;
  constexpr int kNT = kBK / 8;              // 8-key column tiles of S
  constexpr int kLdK = S::kLdK;
  constexpr int kLdV = S::kLdV;
  constexpr bool kExact = !std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem + kStages * S::kStage;  // [kBQ][kLdK] when not in regs

  // heaviest q tiles first: the q tile is the slowest index, reversed
  const int h = blockIdx.x % heads;
  const int rest = blockIdx.x / heads;
  const int b = rest % batch;
  const int q0 = (nq - 1 - rest / batch) * kBQ;
  const int kh = h / (heads / kv_heads);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16;                 // the warp's first row
  const int wq0 = q0 + r0;

  const size_t q_stride = static_cast<size_t>(heads) * d;   // per position
  const size_t k_stride = static_cast<size_t>(kv_heads) * d;
  const T* qb = q + static_cast<size_t>(b) * s_len * q_stride +
                static_cast<size_t>(h) * d;
  const T* kb = k + static_cast<size_t>(b) * t_len * k_stride +
                static_cast<size_t>(kh) * d;
  const T* vb = v + static_cast<size_t>(b) * t_len * k_stride +
                static_cast<size_t>(kh) * d;
  T* ob = o + static_cast<size_t>(b) * s_len * q_stride +
          static_cast<size_t>(h) * d;

  // k tiles that hold a key some row of this q tile can see
  int k_begin = 0;
  int k_end = t_len;
  if (causal) k_end = min(k_end, min(q0 + kBQ, s_len));
  if (window > 0) k_begin = max(0, q0 - window + 1) / kBK * kBK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK
                                      : 0;
  if (n_tiles > 0) {
    load_kv<T, NDK>(smem, smem + kBK * kLdK, kb, vb, k_stride, k_begin,
                    t_len, d, vec, warp, lane);
  }
  cp_async_commit();

  // columns d .. Dp - 1 of every stage are zeros, written once
  if (d < S::kDp) {
    const int pad = S::kDp - d;
    for (int i = threadIdx.x; i < kStages * kBK * pad; i += kThreads) {
      const int r = i / pad;
      const int c = d + (i - r * pad);
      float* st = smem + (r / kBK) * S::kStage;
      st[(r % kBK) * kLdK + c] = 0.f;
      st[kBK * kLdK + (r % kBK) * kLdV + c] = 0.f;
    }
  }

  // Q in A-fragment order: slot i of step kk is row g + 8 (i & 1), column
  // 8 kk + 2t + (i >> 1), scaled by scale * log2(e)
  uint32_t qh[S::kQInRegs ? NDK : 1][4], ql[S::kQInRegs ? NDK : 1][4];
  if constexpr (S::kQInRegs) {
#pragma unroll
    for (int kk = 0; kk < NDK; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = wq0 + g + 8 * (i & 1);
        const int c = 8 * kk + 2 * t + (i >> 1);
        const float x = qp < s_len && c < d
                            ? to_f32(qb[qp * q_stride + c]) * qscale
                            : 0.f;
        split(x, qh[kk][i], ql[kk][i]);
      }
    }
  } else {
    for (int i = threadIdx.x; i < kBQ * S::kDp; i += kThreads) {
      const int r = i / S::kDp;
      const int c = i - r * S::kDp;
      const int qp = q0 + r;
      q_s[r * kLdK + c] = qp < s_len && c < d
                              ? to_f32(qb[qp * q_stride + c]) * qscale
                              : 0.f;
    }
  }

  float m[2] = {kNegInf, kNegInf};   // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};           // this lane's share of the row sums
  float acc[NDK][4];
#pragma unroll
  for (int n = 0; n < NDK; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_begin + it * kBK;
    if (it + 1 < n_tiles) {
      float* nxt = smem + ((it + 1) % kStages) * S::kStage;
      load_kv<T, NDK>(nxt, nxt + kBK * kLdK, kb, vb, k_stride, k0 + kBK,
                      t_len, d, vec, warp, lane);
    }
    cp_async_commit();
    cp_async_wait<1>();              // tile it has landed
    __syncthreads();
    const float* ks = smem + (it % kStages) * S::kStage;
    const float* vs = ks + kBK * kLdK;

    // S = Q K^T for the warp's 16 rows and kBK keys
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < NDK; ++kk) {
      uint32_t ah[4], al[4];
      if constexpr (S::kQInRegs) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ah[i] = qh[kk][i];
          al[i] = ql[kk][i];
        }
      } else {
        const float2 x0 = *reinterpret_cast<const float2*>(
            q_s + (r0 + g) * kLdK + 8 * kk + 2 * t);
        const float2 x1 = *reinterpret_cast<const float2*>(
            q_s + (r0 + g + 8) * kLdK + 8 * kk + 2 * t);
        split(x0.x, ah[0], al[0]);
        split(x1.x, ah[1], al[1]);
        split(x0.y, ah[2], al[2]);
        split(x1.y, ah[3], al[3]);
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        // B slot t: K[8n + g][8kk + 2t]; slot t + 4: the next element
        const float2 kv = *reinterpret_cast<const float2*>(
            ks + (8 * n + g) * kLdK + 8 * kk + 2 * t);
        mma_3xtf32<kExact>(s[n], ah, al, kv.x, kv.y);
      }
    }

    // masks, only where the tile crosses the diagonal, the window or T
    const bool tail = k0 + kBK > t_len;
    if (tail || (causal && k0 + kBK - 1 > wq0) ||
        (window > 0 && k0 <= wq0 + 15 - window)) {
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * n + 2 * t + (e & 1);
          const int qp = wq0 + g + 8 * (e >> 1);
          bool ok = kp < t_len;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          if (!ok) s[n][e] = kNegInf;
        }
      }
    }

    // online softmax; a lane's four lanes of a quad share rows g, g + 8
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float alpha[2] = {exp2f(m[0] - mx[0]), exp2f(m[1] - mx[1])};
    m[0] = mx[0];
    m[1] = mx[1];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[n][e] - mx[e >> 1]);
        // keys past T are no slot at all (the TPU kernel's padded tail):
        // they take no share, unlike a masked slot
        if (tail && k0 + 8 * n + 2 * t + (e & 1) >= t_len) p = 0.f;
        s[n][e] = p;
        sum[e >> 1] += p;
      }
    }
    l[0] = alpha[0] * l[0] + sum[0];
    l[1] = alpha[1] * l[1] + sum[1];
#pragma unroll
    for (int n = 0; n < NDK; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: S's C fragment (c0, c2, c1, c3) is P's A fragment under
    // the permuted k slots; B slot t is V[8j + 2t], slot t + 4 the next key
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      uint32_t ph[4], pl[4];
      split(s[j][0], ph[0], pl[0]);
      split(s[j][2], ph[1], pl[1]);
      split(s[j][1], ph[2], pl[2]);
      split(s[j][3], ph[3], pl[3]);
      const float* vr = vs + (8 * j + 2 * t) * kLdV + g;
#pragma unroll
      for (int n = 0; n < NDK; ++n) {
        mma_3xtf32<kExact>(acc[n], ph, pl, vr[8 * n], vr[kLdV + 8 * n]);
      }
    }
    __syncthreads();                 // every warp is done with this stage
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = wq0 + g + 8 * i;
    if (qp >= s_len) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = ob + qp * q_stride;
#pragma unroll
    for (int n = 0; n < NDK; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < d) store(orow + c, acc[n][2 * i] / den);
      if (c + 1 < d) store(orow + c + 1, acc[n][2 * i + 1] / den);
    }
  }
}

template <typename T, int NDK>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int s, int t, int h, int kh, int d, int causal, int window,
           float scale, cudaStream_t stream) {
  using S = Tile<NDK>;
  auto kernel = flash_fwd_kernel<T, NDK>;
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t err = allow_smem_once(kernel, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (s + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(nq) * b * h;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  kernel<<<static_cast<unsigned>(blocks), kThreads, S::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), b, s, t, h, kh, d,
      causal, window, scale * kLog2e, nq, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int s, int t, int h, int kh, int d, int causal, int window,
             float scale, cudaStream_t stream) {
  if (d <= 16)
    return launch<T, 2>(q, k, v, o, b, s, t, h, kh, d, causal, window, scale,
                        stream);
  if (d <= 32)
    return launch<T, 4>(q, k, v, o, b, s, t, h, kh, d, causal, window, scale,
                        stream);
  if (d <= 64)
    return launch<T, 8>(q, k, v, o, b, s, t, h, kh, d, causal, window, scale,
                        stream);
  if (d <= 80)
    return launch<T, 10>(q, k, v, o, b, s, t, h, kh, d, causal, window,
                         scale, stream);
  if (d <= 128)
    return launch<T, 16>(q, k, v, o, b, s, t, h, kh, d, causal, window,
                         scale, stream);
  if (d <= 256)
    return launch<T, 32>(q, k, v, o, b, s, t, h, kh, d, causal, window,
                         scale, stream);
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
