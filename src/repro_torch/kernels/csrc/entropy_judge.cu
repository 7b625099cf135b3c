// Maximum-entropy judgment sweep: one greedy step of the paper's Alg. 1.
//
// Replaces the Pallas TPU kernel src/repro/kernels/entropy_judge.py
// (entropy_judge_sweep, kernel body _judge_kernel). Given soft labels
// P (M, C), weights w = sizes * mask (M,), tot = sum(w) and
// den = max(tot - w, eps) (M,), it computes
//
//   out[0]     = -sum_c plogp(s_c / max(tot, eps))            group entropy
//   out[1 + k] = -sum_c plogp((s_c - w_k p_kc) / den_k)       leave-one-out
//
// with s_c = sum_k w_k p_kc. The wrapper (kernels/entropy_judge.py) applies
// the -1.0 (emptying removal) and ln C (empty set) conventions.
//
// What bounds it on an H100: it reads P once, M*C elements, and does
// about 2*M*C multiply-adds and (M+1)*C logarithms, far below the card's
// arithmetic rate for those bytes, so a large C is bound by the read of P
// at 3.35 TB/s. At the main path's (10, 10) the whole input is 400 bytes
// and the two launches cost more than any data movement: it is
// launch-bound.
//
// Design. The TPU kernel walks the class axis in order on one core and
// carries the M+1 sums in VMEM scratch from one grid step to the next.
// Blocks on Hopper run in no order, so here each block owns one tile of
// block_c classes: it builds its columns' weighted sums s_c in shared
// memory, then reduces the group term and the M leave-one-out terms of
// its tile, and writes M+1 partial sums to its own row of `partial`. A
// second one-block kernel adds the rows in block order. No atomics: the
// order of every sum is fixed, so the result is the same on every run --
// a verdict turns on a 1e-6 margin. The second read of P's rows in the
// leave-one-out pass comes from L1/L2, not device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float plogp(float q) {
  return q > 0.f ? q * logf(fmaxf(q, kEps)) : 0.f;
}

// Sum over the block in a fixed order: warp shuffles, then thread 0 adds
// the warps' sums in warp order. The result is valid in thread 0 only.
__device__ float block_sum(float v, float* scratch) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kThreads / 32; ++i) total += scratch[i];
  }
  __syncthreads();  // scratch is reused by the next call
  return total;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
judge_partial(const T* __restrict__ p, const float* __restrict__ w,
              const float* __restrict__ tot, const float* __restrict__ den,
              float* __restrict__ partial, int m, int c, int block_c) {
  extern __shared__ float s_tile[];  // block_c weighted column sums
  __shared__ float scratch[kThreads / 32];
  const int c0 = blockIdx.x * block_c;
  const int width = min(block_c, c - c0);
  const float tot_c = fmaxf(*tot, kEps);
  float* row = partial + static_cast<size_t>(blockIdx.x) * (m + 1);

  float g = 0.f;
  for (int j = threadIdx.x; j < width; j += kThreads) {
    float s = 0.f;
    for (int k = 0; k < m; ++k) {
      s += to_f32(p[static_cast<size_t>(k) * c + c0 + j]) * w[k];
    }
    s_tile[j] = s;
    g += plogp(s / tot_c);
  }
  // block_sum's first barrier also publishes s_tile to the whole block
  g = block_sum(g, scratch);
  if (threadIdx.x == 0) row[0] = g;

  for (int k = 0; k < m; ++k) {
    const float wk = w[k];
    const float dk = den[k];
    const T* pk = p + static_cast<size_t>(k) * c + c0;
    float acc = 0.f;
    for (int j = threadIdx.x; j < width; j += kThreads) {
      acc += plogp((s_tile[j] - to_f32(pk[j]) * wk) / dk);
    }
    acc = block_sum(acc, scratch);
    if (threadIdx.x == 0) row[1 + k] = acc;
  }
}

// out[j] = -sum_b partial[b, j], blocks added in index order.
__global__ void judge_finalize(const float* __restrict__ partial,
                               float* __restrict__ out, int m, int nblocks) {
  for (int j = threadIdx.x; j <= m; j += blockDim.x) {
    float acc = 0.f;
    for (int b = 0; b < nblocks; ++b) {
      acc += partial[static_cast<size_t>(b) * (m + 1) + j];
    }
    out[j] = -acc;
  }
}

template <typename T>
int launch(const void* p, const void* w, const void* tot, const void* den,
           void* partial, void* out, int m, int c, int block_c,
           void* stream) {
  const int nblocks = (c + block_c - 1) / block_c;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  judge_partial<T><<<nblocks, kThreads, block_c * sizeof(float), s>>>(
      static_cast<const T*>(p), static_cast<const float*>(w),
      static_cast<const float*>(tot), static_cast<const float*>(den),
      static_cast<float*>(partial), m, c, block_c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  judge_finalize<<<1, kThreads, 0, s>>>(static_cast<const float*>(partial),
                                        static_cast<float*>(out), m,
                                        nblocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// partial: (ceil(c / block_c), m + 1) float32 scratch; out: (m + 1,) float32.
extern "C" int entropy_judge_sweep_f32(const void* p, const void* w,
                                       const void* tot, const void* den,
                                       void* partial, void* out, int m,
                                       int c, int block_c, void* stream) {
  return launch<float>(p, w, tot, den, partial, out, m, c, block_c, stream);
}

extern "C" int entropy_judge_sweep_bf16(const void* p, const void* w,
                                        const void* tot, const void* den,
                                        void* partial, void* out, int m,
                                        int c, int block_c, void* stream) {
  return launch<__nv_bfloat16>(p, w, tot, den, partial, out, m, c, block_c,
                               stream);
}
