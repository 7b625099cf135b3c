// Fused masked weighted aggregation: out[p] = sum_i w[i] * flat[i, p].
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_aggregate.py
// (masked_weighted_sum, kernel body _fused_kernel, tiles from
// _plan_tiles). The weights already fold sizes * mask, so a masked-out
// client has weight 0; the caller divides by the total weight.
//
// What bounds it on an H100: every element of the (M, P) float32 buffer
// is read once and used in one multiply-add, so it is bound by moving
// (M + 1) * P * 4 bytes at 3.35 TB/s. At the main path's (10, 62006) that
// is 2.7 MB, a little under a microsecond of memory time, so one launch
// costs about as much as the data.
//
// Design. The TPU kernel tiles both axes under a VMEM budget and revisits
// each output tile across the client tiles. Here each thread owns one
// column, or four adjacent columns read as one float4 when P is a
// multiple of 4 and the buffers are 16-byte aligned, and loops over all
// M rows; neighbouring threads read neighbouring addresses, so every row
// is read in full coalesced lines. The weights are staged through shared
// memory in chunks, so any M fits. The sum is kept in float32 registers
// and written once: no atomics, no revisits, and the same order on every
// run. The rows are added in index order and each product is rounded
// before its add (no FMA contraction): exactly the arithmetic of the
// plain version (kernels/ref.py), so the two routes agree bit for bit.
// That matters beyond this call: the aggregate is the next round's
// starting point, and local training amplifies a last-bit difference in
// it (1e-7 relative after one aggregation grew to 6e-4 after two more
// rounds of training on an H100). The VMEM-budget knob has no meaning on
// this card; the block size (threads per block) takes its place.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kChunk = 256;  // weights staged per pass through shared memory

template <bool kVec4>
__global__ void masked_weighted_sum_kernel(const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           float* __restrict__ out, int m,
                                           long long p) {
  __shared__ float w_sh[kChunk];
  constexpr int kCols = kVec4 ? 4 : 1;
  const long long col =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kCols;
  const bool live = col < p;
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int i0 = 0; i0 < m; i0 += kChunk) {
    const int n = min(kChunk, m - i0);
    __syncthreads();  // the previous chunk is no longer read
    for (int t = threadIdx.x; t < n; t += blockDim.x) w_sh[t] = w[i0 + t];
    __syncthreads();
    if (!live) continue;
    const float* xi = x + static_cast<size_t>(i0) * p + col;
    for (int i = 0; i < n; ++i, xi += p) {
      const float wi = w_sh[i];
      if constexpr (kVec4) {
        const float4 v = *reinterpret_cast<const float4*>(xi);
        a0 = __fadd_rn(a0, __fmul_rn(wi, v.x));
        a1 = __fadd_rn(a1, __fmul_rn(wi, v.y));
        a2 = __fadd_rn(a2, __fmul_rn(wi, v.z));
        a3 = __fadd_rn(a3, __fmul_rn(wi, v.w));
      } else {
        a0 = __fadd_rn(a0, __fmul_rn(wi, *xi));
      }
    }
  }
  if (!live) return;
  if constexpr (kVec4) {
    *reinterpret_cast<float4*>(out + col) = make_float4(a0, a1, a2, a3);
  } else {
    out[col] = a0;
  }
}

}  // namespace

// flat: (m, p) float32 row-major; w: (m,) float32; out: (p,) float32.
extern "C" int masked_weighted_sum_f32(const void* flat, const void* w,
                                       void* out, int m, long long p,
                                       int block, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = p % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(flat) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long threads = vec4 ? p / 4 : p;
  const unsigned grid = static_cast<unsigned>((threads + block - 1) / block);
  const float* x = static_cast<const float*>(flat);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (vec4) {
    masked_weighted_sum_kernel<true><<<grid, block, 0, s>>>(x, wf, o, m, p);
  } else {
    masked_weighted_sum_kernel<false><<<grid, block, 0, s>>>(x, wf, o, m, p);
  }
  return static_cast<int>(cudaGetLastError());
}
