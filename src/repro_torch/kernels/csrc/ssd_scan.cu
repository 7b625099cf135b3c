// Mamba2 SSD chunk scan: the state-space layers of the LM prefill.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py
// (ssd_chunked, kernel body _ssd_kernel). For x (B, L, H, P), dt (B, L, H)
// (post-softplus, float32), a (H,) (float32, negative) and B, C (B, L, G,
// N), with head h reading group h / (H / G), the recurrence
//
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t (outer) B_t,   y_t = h_t . C_t
//
// from a zero state is evaluated chunk by chunk (Mamba2 Sec. 6). Per chunk
// of Q steps, with cums = cumsum(dt a) over the chunk:
//
//   y_i  = sum_{j<=i} (C_i . B_j) exp(cums_i - cums_j) dt_j x_j      intra
//        + exp(cums_i) C_i . h                                      carried
//   h'   = exp(cums_Q) h + sum_j exp(cums_Q - cums_j) dt_j x_j (outer) B_j
//
// A ragged tail runs with dt = 0 (decay 1, no update), which is exact.
// Returns y (x's type) and the final state (B, H, P, N) in float32. x, B, C
// are float32 or bfloat16; everything is computed in float32.
//
// What bounds it on an H100: per (b, h) and chunk about Q^2 N + Q^2 P
// (halved by the causal mask) plus 2 Q P N multiply-adds, against moving
// x and y (B L H P each) and B, C once. At the serve path's B=4, L=1024,
// H=80, P=N=64, Q=256 that is about 27 GFLOP as the TPU kernel counts it
// (full Q x Q products) against about 176 MB: bound by operations, 0.40 ms
// at the float32 rate outside the tensor cores.
//
// Design. The TPU kernel makes the chunk axis the innermost grid axis,
// which runs in order on one core, and carries the (P, N) state in VMEM
// scratch from one grid step to the next. Hopper blocks run in no order,
// so here one block owns one (b, h) and walks the chunks itself, with the
// float32 state in shared memory (16 KB at P = N = 64). A whole chunk of
// x, B and C would take about 196 KB of float32 at Q = 256, so the chunk
// is cut into 64-row tiles: for each row tile i, the C rows stay in shared
// memory while the B rows and dt x rows of each column tile j <= i pass
// through; every product is a 64 x 64 output tile computed by 256 threads,
// 4 x 4 outputs each, from shared memory (rows with an odd stride, so a
// warp's 16 columns fall in 16 banks). The chunk's cumulative decays come
// from a warp-shuffle scan. About 85 KB of shared memory at P = N = 64.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

#include "smem_limit.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// acc[r][c] += sum_k A(row_r, k) B(col_c, k) for the thread's rows
// ty + 16 r and columns tx + 16 c of a 64 x 64 tile, where
// A(row, k) = a[row * a_rs + k * a_ks] and B(col, k) = b[col * b_rs + k * b_ks].
__device__ __forceinline__ void tile_mma(float acc[4][4], const float* a,
                                         int a_rs, int a_ks, const float* b,
                                         int b_rs, int b_ks, int kdim, int ty,
                                         int tx) {
  for (int kk = 0; kk < kdim; ++kk) {
    float av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) av[r] = a[(ty + 16 * r) * a_rs + kk * a_ks];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b[(tx + 16 * c) * b_rs + kk * b_ks];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const T* __restrict__ bm,
               const T* __restrict__ cm, T* __restrict__ y,
               float* __restrict__ state, int l_len, int heads, int p_dim,
               int groups, int n_dim, int chunk) {
  extern __shared__ float smem[];
  const int pp = (p_dim + kTile - 1) / kTile * kTile;   // P padded to tiles
  const int np = (n_dim + kTile - 1) / kTile * kTile;   // N padded to tiles
  const int qp = (chunk + kTile - 1) / kTile * kTile;   // Q padded to tiles
  const int ldn = np + 1;
  constexpr int lds = kTile + 1;
  float* h_s = smem;                       // [pp][ldn]   carried state
  float* c_s = h_s + pp * ldn;             // [64][ldn]   C rows, tile i
  float* b_s = c_s + kTile * ldn;          // [64][ldn]   B rows, tile j
  float* x_s = b_s + kTile * ldn;          // [64][pp]    dt x rows, tile j
  float* s_s = x_s + kTile * pp;           // [64][65]    masked C B^T
  float* cums = s_s + kTile * lds;         // [qp]
  float* dts = cums + qp;                  // [qp]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int grp = h / (heads / groups);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float a_h = a[h];
  const size_t x_row = static_cast<size_t>(heads) * p_dim;
  const size_t bc_row = static_cast<size_t>(groups) * n_dim;
  const T* xb = x + static_cast<size_t>(b) * l_len * x_row +
                static_cast<size_t>(h) * p_dim;
  T* yb = y + static_cast<size_t>(b) * l_len * x_row +
          static_cast<size_t>(h) * p_dim;
  const T* bb = bm + static_cast<size_t>(b) * l_len * bc_row +
                static_cast<size_t>(grp) * n_dim;
  const T* cb = cm + static_cast<size_t>(b) * l_len * bc_row +
                static_cast<size_t>(grp) * n_dim;
  const float* dtb = dt + static_cast<size_t>(b) * l_len * heads + h;

  for (int i = tid; i < pp * ldn; i += kThreads) h_s[i] = 0.f;

  const int n_chunks = (l_len + chunk - 1) / chunk;
  const int n_tiles = qp / kTile;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int base = ci * chunk;
    __syncthreads();    // the previous chunk's state update is complete
    if (warp == 0) {    // dt (0 past the chunk or the sequence) and cums
      float carry = 0.f;
      for (int q0 = 0; q0 < qp; q0 += 32) {
        const int q = q0 + lane;
        const float dv =
            q < chunk && base + q < l_len ? dtb[(base + q) * heads] : 0.f;
        float v = dv * a_h;
        for (int off = 1; off < 32; off <<= 1) {
          const float up = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += up;
        }
        v += carry;
        cums[q] = v;
        dts[q] = dv;
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    __syncthreads();
    const float c_last = cums[chunk - 1];

    // ---- y: the carried-state term and the intra-chunk term, per row tile
    for (int it = 0; it < n_tiles; ++it) {
      __syncthreads();                     // c_s is no longer read
      for (int e = tid; e < kTile * np; e += kThreads) {
        const int r = e / np;
        const int n = e - r * np;
        const int q = it * kTile + r;
        c_s[r * ldn + n] = q < chunk && base + q < l_len && n < n_dim
                               ? to_f32(cb[(base + q) * bc_row + n])
                               : 0.f;
      }
      for (int pt = 0; pt < pp / kTile; ++pt) {
        float acc[4][4] = {};
        __syncthreads();
        tile_mma(acc, c_s, ldn, 1, h_s + pt * kTile * ldn, ldn, 1, n_dim, ty,
                 tx);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float e = expf(cums[it * kTile + ty + 16 * r]);
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] *= e;
        }
        for (int jt = 0; jt <= it; ++jt) {
          __syncthreads();                 // b_s, x_s, s_s are no longer read
          for (int e = tid; e < kTile * np; e += kThreads) {
            const int r = e / np;
            const int n = e - r * np;
            const int q = jt * kTile + r;
            b_s[r * ldn + n] = q < chunk && base + q < l_len && n < n_dim
                                   ? to_f32(bb[(base + q) * bc_row + n])
                                   : 0.f;
          }
          for (int e = tid; e < kTile * pp; e += kThreads) {
            const int r = e / pp;
            const int p = e - r * pp;
            const int q = jt * kTile + r;
            x_s[e] = q < chunk && base + q < l_len && p < p_dim
                         ? dts[q] * to_f32(xb[(base + q) * x_row + p])
                         : 0.f;
          }
          __syncthreads();
          float sc[4][4] = {};
          tile_mma(sc, c_s, ldn, 1, b_s, ldn, 1, n_dim, ty, tx);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int qi = it * kTile + ty + 16 * r;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int qj = jt * kTile + tx + 16 * c;
              s_s[(ty + 16 * r) * lds + tx + 16 * c] =
                  qj <= qi ? sc[r][c] * expf(cums[qi] - cums[qj]) : 0.f;
            }
          }
          __syncthreads();
          tile_mma(acc, s_s, lds, 1, x_s + pt * kTile, 1, pp, kTile, ty, tx);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int q = it * kTile + ty + 16 * r;
          if (q >= chunk || base + q >= l_len) continue;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int p = pt * kTile + tx + 16 * c;
            if (p < p_dim) store(yb + (base + q) * x_row + p, acc[r][c]);
          }
        }
      }
    }

    // ---- state update over the whole chunk
    const float e_last = expf(c_last);
    for (int pt = 0; pt < pp / kTile; ++pt) {
      for (int nt = 0; nt < np / kTile; ++nt) {
        float acc[4][4];
        __syncthreads();                   // the y pass no longer reads h_s
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = e_last * h_s[(pt * kTile + ty + 16 * r) * ldn +
                                     nt * kTile + tx + 16 * c];
          }
        }
        for (int jt = 0; jt < n_tiles; ++jt) {
          __syncthreads();
          for (int e = tid; e < kTile * np; e += kThreads) {
            const int r = e / np;
            const int n = e - r * np;
            const int q = jt * kTile + r;
            b_s[r * ldn + n] = q < chunk && base + q < l_len && n < n_dim
                                   ? to_f32(bb[(base + q) * bc_row + n])
                                   : 0.f;
          }
          for (int e = tid; e < kTile * pp; e += kThreads) {
            const int r = e / pp;
            const int p = e - r * pp;
            const int q = jt * kTile + r;
            x_s[e] = q < chunk && base + q < l_len && p < p_dim
                         ? expf(c_last - cums[q]) *
                               (dts[q] * to_f32(xb[(base + q) * x_row + p]))
                         : 0.f;
          }
          __syncthreads();
          tile_mma(acc, x_s + pt * kTile, 1, pp, b_s + nt * kTile, 1, ldn,
                   kTile, ty, tx);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            h_s[(pt * kTile + ty + 16 * r) * ldn + nt * kTile + tx + 16 * c] =
                acc[r][c];
          }
        }
      }
    }
  }

  __syncthreads();
  float* sb = state + (static_cast<size_t>(b) * heads + h) * p_dim * n_dim;
  for (int e = tid; e < p_dim * n_dim; e += kThreads) {
    const int p = e / n_dim;
    const int n = e - p * n_dim;
    sb[e] = h_s[p * ldn + n];
  }
}

size_t smem_bytes(int p, int n, int chunk) {
  const size_t pp = (p + kTile - 1) / kTile * kTile;
  const size_t np = (n + kTile - 1) / kTile * kTile;
  const size_t qp = (chunk + kTile - 1) / kTile * kTile;
  const size_t ldn = np + 1;
  return sizeof(float) * (pp * ldn + 2 * kTile * ldn + kTile * pp +
                          kTile * (kTile + 1) + 2 * qp);
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, void* state, int b, int l, int h, int p,
           int g, int n, int chunk, cudaStream_t stream) {
  const size_t smem = smem_bytes(p, n, chunk);
  auto kernel = ssd_kernel<T>;
  static std::atomic<unsigned long long> ready{0};
  const cudaError_t err = allow_smem_once(kernel, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm),
      static_cast<const T*>(cm), static_cast<T*>(y),
      static_cast<float*>(state), l, h, p, g, n, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory the kernel needs for these widths, in bytes.
extern "C" long long ssd_chunk_scan_smem_bytes(int p, int n, int chunk) {
  return static_cast<long long>(smem_bytes(p, n, chunk));
}

// x: (b, l, h, p); dt: (b, l, h) float32; a: (h,) float32; bm, cm:
// (b, l, g, n); y: (b, l, h, p); state: (b, h, p, n) float32. All
// contiguous; x, bm, cm and y of one type. Returns a CUDA error code.
extern "C" int ssd_chunk_scan_f32(const void* x, const void* dt,
                                  const void* a, const void* bm,
                                  const void* cm, void* y, void* state,
                                  int b, int l, int h, int p, int g, int n,
                                  int chunk, void* stream) {
  return launch<float>(x, dt, a, bm, cm, y, state, b, l, h, p, g, n, chunk,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int ssd_chunk_scan_bf16(const void* x, const void* dt,
                                   const void* a, const void* bm,
                                   const void* cm, void* y, void* state,
                                   int b, int l, int h, int p, int g, int n,
                                   int chunk, void* stream) {
  return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, state, b, l, h, p, g, n,
                               chunk, static_cast<cudaStream_t>(stream));
}
