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
// is 2.7 MB, 0.81 us of memory time, so one launch costs about as much as
// the data and the kernel has to reach full memory speed at once.
//
// Design. The TPU kernel tiles both axes under a VMEM budget and revisits
// each output tile across the client tiles. Here each thread owns V
// adjacent columns, read as one vector (float4 when P is a multiple of 4
// and the buffers are 16-byte aligned, float2 when P is even, else one
// float), and loops over all M rows; neighbouring threads read
// neighbouring addresses, so every row is read in full coalesced lines.
// The wrapper's default of 128 threads per block gives 243 blocks at the
// main path's P (float2), nearly two per SM, so every SM has loads in
// flight from the start (chip_smoke.py times 64 to 512 threads beside it).
// A call this short is one memory latency or a few, so a thread issues
// the loads of 16 rows, and of their weights,
// before it adds any of them (the row loop unrolled by 16, with a
// predicated tail): at M <= 16 the whole sum waits on one round trip. The
// weights are read straight from global memory (every lane of a warp
// reads the same word, one cached transaction), not staged through shared
// memory first, which cost a round trip and a barrier before the first
// row load. The sum is kept in float32 registers and written once: no
// atomics, no revisits, and the same order on every run. The rows are
// added in index order and each product is rounded before its add (no FMA
// contraction): exactly the arithmetic of the plain version
// (kernels/ref.py), so the two routes agree bit for bit. That matters
// beyond this call: the aggregate is the next round's starting point, and
// local training amplifies a last-bit difference in it (1e-7 relative
// after one aggregation grew to 6e-4 after two more rounds of training on
// an H100). The VMEM-budget knob has no meaning on this card; the block
// size (threads per block) takes its place.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kUnroll = 16;  // rows whose loads are issued together

template <int V>
__device__ __forceinline__ void load_cols(float (&v)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else if constexpr (V == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

template <int V>
__global__ void masked_weighted_sum_kernel(const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           float* __restrict__ out, int m,
                                           long long p) {
  const long long col =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  if (col >= p) return;
  float acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = 0.f;
  const float* xc = x + col;
  for (int i = 0; i < m; i += kUnroll) {
    // the loads of up to kUnroll rows and their weights, then the adds in
    // row order
    float v[kUnroll][V], wv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u < m) {
        wv[u] = __ldg(w + i + u);
        load_cols<V>(v[u], xc + static_cast<size_t>(i + u) * p);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u < m) {
#pragma unroll
        for (int c = 0; c < V; ++c) {
          acc[c] = __fadd_rn(acc[c], __fmul_rn(wv[u], v[u][c]));
        }
      }
    }
  }
  store_cols<V>(out + col, acc);
}

template <int V>
int launch(const float* x, const float* w, float* o, int m, long long p,
           int block, cudaStream_t s) {
  const long long threads = (p + V - 1) / V;
  const unsigned grid = static_cast<unsigned>((threads + block - 1) / block);
  masked_weighted_sum_kernel<V><<<grid, block, 0, s>>>(x, w, o, m, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// flat: (m, p) float32 row-major; w: (m,) float32; out: (p,) float32.
extern "C" int masked_weighted_sum_f32(const void* flat, const void* w,
                                       void* out, int m, long long p,
                                       int block, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(flat);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  const uintptr_t align = reinterpret_cast<uintptr_t>(flat) |
                          reinterpret_cast<uintptr_t>(out);
  if (p % 4 == 0 && align % 16 == 0) {
    return launch<4>(x, wf, o, m, p, block, s);
  }
  if (p % 2 == 0 && align % 8 == 0) {
    return launch<2>(x, wf, o, m, p, block, s);
  }
  return launch<1>(x, wf, o, m, p, block, s);
}
