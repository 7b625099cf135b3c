// Maximum-entropy judgment (the paper's Alg. 1) on an H100: one greedy
// sweep, and the whole greedy loop in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/entropy_judge.py
// (entropy_judge_sweep, kernel body _judge_kernel) and, for the loop, the
// lax.while_loop around it in src/repro/core/judgment.py::judge.
//
// Given soft labels P (M, C), sizes (M,) and a mask (M,), with
// w_k = sizes_k * mask_k, tot = sum_k w_k, den_k = max(tot - w_k, eps) and
// s_c = sum_k w_k p_kc, one sweep is
//
//   group entropy  -sum_c plogp(s_c / max(tot, eps))      (ln C if tot = 0)
//   leave-one-out  -sum_c plogp((s_c - w_k p_kc) / den_k)
//                                          (-1 if tot - w_k <= eps: a removal
//                                           that empties the set)
//
// Part A, entropy_judge_sweep: one sweep. Every block forms w, tot and den
// itself from sizes and mask, in a fixed order, so every block gets the
// same bits. One block owns one tile of block_c classes. When C fits in
// one tile (the paper's (10, 10)) that block writes the final values,
// conventions included, in one launch; above that each block writes its
// M + 1 partial sums and a one-block finalize adds them in block order.
//
// Part B, entropy_judge_loop: Alg. 1 in one launch, as the reference's
// jitted while_loop runs it.
//
// At the paper's shape (C and M at most 32) one warp runs the whole loop
// (judge_loop_warp): lanes hold classes and rows, every sum is a shuffle
// butterfly, and an iteration has no barrier at all.
//
// Above it the launch is one thread-block cluster of G CTAs
// (judge_loop_kernel; G = 1 up to 1024 classes, 16 at 151,936). Each CTA
// owns a contiguous slice of the class axis and, every iteration,
// recomputes s_c over its slice from the current mask and forms its
// partial group term and the candidates' partial leave-one-out terms in
// its own shared memory. After cluster.sync() every CTA reads all the
// CTAs' partials through distributed shared memory in rank order, adds
// them, and takes the argmax and the stop decision itself: all CTAs agree
// bit for bit without exchanging the decision. The partials are
// double-buffered by iteration parity, so the next iteration never
// overwrites what a neighbour still reads. No atomics, no tickets, no
// spinning on global memory: the cluster is scheduled together or refused
// at launch. The device code for a block's partial sums (add_terms) is
// shared with the sweep. The sweep's blocks have 256 threads; the loop's
// CTAs enough that every row has a warp of its own or a lane of a full
// tile's row takes about eight classes (1024 threads at (100, 10) and at
// 151,936 classes). An iteration takes two barriers and one
// cluster.sync() beside the three of each tile; warp 0 of every CTA makes
// the decision.
//
// What bounds it on an H100: one sweep reads P once, M*C elements, and
// does about 2*M*C multiply-adds and (M+1)*C logarithms; a large C is
// bound by that read at 3.35 TB/s (1.81 us at (10, 151936) in float32).
// A cluster holds at most 16 of the card's 132 SMs, so the loop is bound
// there by the instructions of its accurate logarithms and the latency of
// its reads of P from L2 on those 16 SMs, not by the card's memory rate.
// At the main path's (10, 10) the input is 400 bytes: the floor is one
// launch, and the loop's latency chain of shuffles per iteration.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstddef>

#include "smem_limit.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSweepThreads = 256;
constexpr int kMaxCluster = 16;  // H100's largest (non-portable) cluster
constexpr int kTile = 2048;      // classes a block holds s_c for at once
constexpr float kEps = 1e-12f;
constexpr float kTol = 1e-6f;    // strict-improvement margin of Alg. 1

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// q log q, 0 for q <= 0. The logarithm is taken of max(q, eps) whatever
// q is and the result selected after, so the code has no branch and the
// compiler interleaves the logarithms of an unrolled loop.
__device__ __forceinline__ float plogp(float q) {
  const float t = q * logf(fmaxf(q, kEps));
  return q > 0.f ? t : 0.f;
}

// Every thread forms tot = sum_k w_k itself, w_k = sizes_k * mask_k
// rounded, k in order: the same bits in every thread of every block.
// Threads k < m write w_k and inv_k = 1 / max(tot - w_k, eps); the caller
// syncs before reading them. A term divides by multiplying with inv_k,
// within an ulp of the quotient.
__device__ float form_weights(const float* sizes, const float* mask, int m,
                              float* w, float* inv) {
  float tot = 0.f;
#pragma unroll 4
  for (int k = 0; k < m; ++k) tot += __fmul_rn(sizes[k], mask[k]);
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    const float wk = __fmul_rn(sizes[k], mask[k]);
    w[k] = wk;
    inv[k] = 1.f / fmaxf(tot - wk, kEps);
  }
  return tot;
}

// Row r of a sweep: r = 0 is the group term, r = 1 + k the leave-one-out
// term of row k.
__device__ __forceinline__ bool row_wanted(int r, bool group,
                                           const unsigned char* row_on) {
  return r == 0 ? group : (row_on == nullptr || row_on[r - 1] != 0);
}

// Adds the terms of classes lo .. hi - 1 to acc (m + 1 floats):
// acc[0] += sum_c plogp(s_c / max(tot, eps)) when `group`, and
// acc[1 + k] += sum_c plogp((s_c - w_k p_kc) / den_k) for every row k
// that row_on marks (every row when row_on is null), tile by tile: s_c of
// kTile classes into s_tile, then each row to a group of warps sized so
// that a lane takes about eight classes (one warp per row at (10, 10) and
// (100, 10), every warp of the block on each row of a full tile), the
// group's lanes and warps added into acc. part (warps * (m + 1)) is shared
// scratch. Every sum has a fixed order, so a call repeats its bits: s_c
// over k in order, a lane's classes in order, lanes in a fixed shuffle
// tree, a row's warps in order, tiles in order. The loops are unrolled so
// that a thread keeps several loads and logarithms in flight.
template <typename T>
__device__ void add_terms(const T* __restrict__ p, int m, int c, int lo,
                          int hi, const float* w, const float* inv,
                          float tot, const unsigned char* row_on, bool group,
                          float* s_tile, float* part, float* acc) {
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float inv_tot = 1.f / fmaxf(tot, kEps);
  for (int c0 = lo; c0 < hi; c0 += kTile) {
    const int width = min(kTile, hi - c0);
    for (int j = threadIdx.x; j < width; j += blockDim.x) {
      const T* col = p + c0 + j;
      float s = 0.f;
#pragma unroll 4
      for (int k = 0; k < m; ++k) {
        s += to_f32(col[static_cast<size_t>(k) * c]) * w[k];
      }
      s_tile[j] = s;
    }
    __syncthreads();

    int wpr = 1;                 // warps per row: ~8 classes a lane
    while (wpr < warps && wpr * 256 < width) wpr <<= 1;
    const int groups = warps / wpr;
    const int sub = warp % wpr;
    for (int r = warp / wpr; r <= m; r += groups) {
      if (!row_wanted(r, group, row_on)) continue;   // uniform in the warp
      float v = 0.f;
      if (r == 0) {
#pragma unroll 4
        for (int j = sub * 32 + lane; j < width; j += wpr * 32) {
          v += plogp(s_tile[j] * inv_tot);
        }
      } else {
        const int k = r - 1;
        const float wk = w[k];
        const float ik = inv[k];
        const T* pk = p + static_cast<size_t>(k) * c + c0;
#pragma unroll 4
        for (int j = sub * 32 + lane; j < width; j += wpr * 32) {
          v += plogp((s_tile[j] - to_f32(pk[j]) * wk) * ik);
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_down_sync(0xffffffffu, v, off);
      }
      if (lane == 0) part[r * warps + sub] = v;
    }
    __syncthreads();
    for (int r = threadIdx.x; r <= m; r += blockDim.x) {
      if (!row_wanted(r, group, row_on)) continue;
      float t = 0.f;
      for (int i = 0; i < wpr; ++i) t += part[r * warps + i];
      acc[r] += t;
    }
    __syncthreads();  // s_tile and part are reused by the next tile
  }
}

// out[0] = the group entropy, out[1 + k] = row k's leave-one-out entropy,
// from the summed terms `sum`, with the emptying conventions.
__device__ void write_sweep(const float* sum, const float* w, float tot,
                            int m, int c, float* out) {
  for (int r = threadIdx.x; r <= m; r += blockDim.x) {
    if (r == 0) {
      out[0] = tot > 0.f ? -sum[0] : logf(static_cast<float>(c));
    } else {
      out[r] = tot - w[r - 1] > kEps ? -sum[r] : -1.f;
    }
  }
}

// ---------------------------------------------------------------- Part A

// Shared memory: s_tile[block_c] | part[warps (m+1)] | acc[m+1] | w[m] |
// inv[m].
template <typename T>
__global__ void __launch_bounds__(kSweepThreads)
judge_sweep_kernel(const T* __restrict__ p, const float* __restrict__ sizes,
                   const float* __restrict__ mask, float* __restrict__ partial,
                   float* __restrict__ out, int m, int c, int block_c) {
  extern __shared__ float smem[];
  float* s_tile = smem;
  float* part = s_tile + block_c;
  float* acc = part + (blockDim.x >> 5) * (m + 1);
  float* w = acc + (m + 1);
  float* inv = w + m;
  const float tot = form_weights(sizes, mask, m, w, inv);
  for (int r = threadIdx.x; r <= m; r += blockDim.x) acc[r] = 0.f;
  __syncthreads();
  const int c0 = blockIdx.x * block_c;
  add_terms(p, m, c, c0, min(c, c0 + block_c), w, inv, tot, nullptr, true,
            s_tile, part, acc);
  if (gridDim.x == 1) {
    write_sweep(acc, w, tot, m, c, out);
  } else {
    float* row = partial + static_cast<size_t>(blockIdx.x) * (m + 1);
    for (int r = threadIdx.x; r <= m; r += blockDim.x) row[r] = acc[r];
  }
}

// Adds the blocks' partial rows in block order. Shared memory: sum[m+1] |
// w[m] | inv[m].
__global__ void __launch_bounds__(kSweepThreads)
judge_sweep_finalize(const float* __restrict__ sizes,
                     const float* __restrict__ mask,
                     const float* __restrict__ partial,
                     float* __restrict__ out, int m, int c, int nblocks) {
  extern __shared__ float smem[];
  float* sum = smem;
  float* w = sum + (m + 1);
  float* inv = w + m;
  const float tot = form_weights(sizes, mask, m, w, inv);
  for (int r = threadIdx.x; r <= m; r += blockDim.x) {
    float acc = 0.f;
    for (int b = 0; b < nblocks; ++b) {
      acc += partial[static_cast<size_t>(b) * (m + 1) + r];
    }
    sum[r] = acc;
  }
  __syncthreads();
  write_sweep(sum, w, tot, m, c, out);
}

template <typename T>
int launch_sweep(const void* p, const void* sizes, const void* mask,
                 void* partial, void* out, int m, int c, int block_c,
                 void* stream) {
  if (m < 1 || c < 1 || block_c < 1 || block_c > kTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nblocks = (c + block_c - 1) / block_c;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sz = static_cast<const float*>(sizes);
  const float* mk = static_cast<const float*>(mask);
  float* part = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  const size_t smem =
      (block_c + (kSweepThreads / 32 + 1) * (m + 1) + 2 * m) * sizeof(float);
  static std::atomic<unsigned long long> ready_sweep{0};
  cudaError_t err = allow_smem_once(judge_sweep_kernel<T>, ready_sweep);
  if (err != cudaSuccess) return static_cast<int>(err);
  judge_sweep_kernel<T><<<nblocks, kSweepThreads, smem, s>>>(
      static_cast<const T*>(p), sz, mk, part, o, m, c, block_c);
  err = cudaGetLastError();
  if (err != cudaSuccess || nblocks == 1) return static_cast<int>(err);
  static std::atomic<unsigned long long> ready{0};
  err = allow_smem_once(judge_sweep_finalize, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  judge_sweep_finalize<<<1, kSweepThreads, (3 * m + 1) * sizeof(float),
                         s>>>(sz, mk, part, o, m, c, nblocks);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- Part B

// The packed output: mask (m floats) | removal order (m int32, -1 padded) |
// number removed (int32) | entropy | initial entropy.
//
// Shared memory, all of it dynamic (allow_smem_once raises the dynamic
// limit to the whole opt-in size, which leaves no room for static shared
// variables): kScalars words (entropy, initial entropy, removed, go) |
// s_tile[kTile] | part[warps (m+1)] |
// partials[2 (m+1)] | sizes[m] | mask[m] | w[m] | inv[m] | order[m]
// int32 | row_on[m] bytes | keep[m] bytes. The loop writes nothing to
// device memory until it ends, so the release at each cluster.sync()
// orders shared-memory writes only.
constexpr int kScalars = 4;

// The barrier between the CTAs' partial sums and their readers: a block
// barrier for a cluster of one, else cluster.sync() (release and acquire
// at cluster scope, for the distributed shared-memory reads).
__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cluster,
                                                unsigned nranks) {
  if (nranks == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }
}

// sum_q partials_q[r] over the cluster's CTAs in rank order, with every
// CTA's value loaded before the first add (the distributed shared-memory
// reads are in flight together).
__device__ __forceinline__ float rank_sum(cg::cluster_group& cluster,
                                         float* mine, int r, unsigned rank,
                                         unsigned nranks) {
  float v[kMaxCluster];
#pragma unroll
  for (unsigned q = 0; q < kMaxCluster; ++q) {
    if (q < nranks) {
      v[q] = (q == rank ? mine : cluster.map_shared_rank(mine, q))[r];
    }
  }
  float t = 0.f;
#pragma unroll
  for (unsigned q = 0; q < kMaxCluster; ++q) {
    if (q < nranks) t += v[q];
  }
  return t;
}

__global__ void __launch_bounds__(1024)
judge_loop_kernel(const float* __restrict__ p,
                  const float* __restrict__ sizes,
                  const float* __restrict__ active,
                  const float* __restrict__ prot, float* __restrict__ out,
                  int m, int c, int cap, int slice) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned nranks = cluster.num_blocks();
  extern __shared__ float smem[];
  float& s_ent = smem[0];
  float& s_init = smem[1];
  int& s_removed = reinterpret_cast<int*>(smem)[2];
  int& s_go = reinterpret_cast<int*>(smem)[3];
  float* s_tile = smem + kScalars;
  float* part = s_tile + kTile;
  float* partials = part + (blockDim.x >> 5) * (m + 1);
  float* size = partials + 2 * (m + 1);
  float* mask = size + m;
  float* w = mask + m;
  float* inv = w + m;
  int* order = reinterpret_cast<int*>(inv + m);
  unsigned char* row_on = reinterpret_cast<unsigned char*>(order + m);
  unsigned char* keep = row_on + m;

  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    size[k] = sizes[k];
    mask[k] = active ? active[k] : 1.f;
    keep[k] = prot ? prot[k] == 0.f : 1;
    order[k] = -1;
  }
  if (threadIdx.x == 0) {
    s_ent = 0.f;
    s_removed = 0;
  }
  __syncthreads();

  const int lo = min(c, static_cast<int>(rank) * slice);
  const int hi = min(c, lo + slice);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int it = 0;; ++it) {
    const bool group = it == 0;          // the initial entropy, once
    const bool sweep = s_removed < cap;  // cap = 0: no candidate at all
    const float tot = form_weights(size, mask, m, w, inv);
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      row_on[k] = sweep && mask[k] > 0.f && keep[k];
    }
    // partials[it & 1] was last read by the other CTAs before the
    // previous iteration's cluster.sync(): it is free to overwrite.
    float* mine = partials + (it & 1) * (m + 1);
    for (int r = threadIdx.x; r <= m; r += blockDim.x) mine[r] = 0.f;
    __syncthreads();
    add_terms(p, m, c, lo, hi, w, inv, tot, row_on, group, s_tile, part,
              mine);
    cluster_barrier(cluster, nranks);   // every CTA's partials are written

    // Warp 0 of every CTA adds the CTAs' partials in rank order and takes
    // the argmax (the first index among ties) and the stop decision.
    if (warp == 0) {
      float best = -INFINITY;
      int arg = m;
      for (int k = lane; k < m; k += 32) {
        if (!row_on[k]) continue;
        const float t = rank_sum(cluster, mine, 1 + k, rank, nranks);
        const float v = tot - w[k] > kEps ? -t : -1.f;
        if (v > best) {
          best = v;
          arg = k;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_down_sync(0xffffffffu, best, off);
        const int oa = __shfl_down_sync(0xffffffffu, arg, off);
        if (ob > best || (ob == best && oa < arg)) {
          best = ob;
          arg = oa;
        }
      }
      if (lane == 0) {
        if (group) {
          const float t = rank_sum(cluster, mine, 0, rank, nranks);
          s_init = tot > 0.f ? -t : logf(static_cast<float>(c));
          s_ent = s_init;
        }
        const bool improves = sweep && best > s_ent + kTol;
        if (improves) {
          mask[arg] = 0.f;
          s_ent = best;
          order[s_removed] = arg;
          ++s_removed;
        }
        s_go = improves && s_removed < cap;
      }
    }
    __syncthreads();
    if (!s_go) break;
  }
  if (rank == 0) {
    int* out_order = reinterpret_cast<int*>(out + m);
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      out[k] = mask[k];
      out_order[k] = order[k];
    }
    if (threadIdx.x == 0) {
      out_order[m] = s_removed;
      out[2 * m + 1] = s_ent;
      out[2 * m + 2] = s_init;
    }
  }
  if (nranks > 1) cluster.sync();   // no CTA leaves while another reads it
}

// Part B at the paper's shape (C <= 32, M <= 32, one CTA): the whole loop
// in one warp, with no shared memory and no barrier. Lane k holds row k's
// size, mask and candidacy, lane j class j's s_j; w_k and 1 / den_k reach
// the other lanes by shuffles. A lane forms the terms of its class for
// every candidate row at once (independent logarithms), and one
// reduce-scatter over the lanes (31 shuffles) leaves row k's sum in lane
// k. Every sum is a butterfly over the same halvings of the warp, so it
// takes the same association for every row and in every lane (IEEE
// addition commutes): equal rows get equal sums, and every lane takes the
// same decision. The argmax is a butterfly on (value, index) that keeps
// the larger value and, on a tie, the smaller index: the first index among
// ties, as the reference's argmax.
__device__ __forceinline__ float warp_total(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

constexpr int kWarpRows = 4;   // rows whose reduction trees run together

__global__ void __launch_bounds__(32)
judge_loop_warp(const float* __restrict__ p, const float* __restrict__ sizes,
                const float* __restrict__ active,
                const float* __restrict__ prot, float* __restrict__ out,
                int m, int c, int cap) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x;
  const bool row = lane < m;
  const float size = row ? sizes[lane] : 0.f;
  float mask = row ? (active ? active[lane] : 1.f) : 0.f;
  const bool keep = row && (prot == nullptr || prot[lane] == 0.f);
  int order = -1;      // lane r: the r-th removal
  int removed = 0;
  float ent = 0.f;
  float init = 0.f;
  for (int it = 0;; ++it) {
    const bool sweep = removed < cap;
    const float w = __fmul_rn(size, mask);
    const float tot = warp_total(w);
    const float inv = 1.f / fmaxf(tot - w, kEps);
    const unsigned cand = __ballot_sync(kFull, sweep && mask > 0.f && keep);
    float s = 0.f;
    for (int k = 0; k < m; ++k) {
      const float wk = __shfl_sync(kFull, w, k);
      if (lane < c) s += p[k * c + lane] * wk;
    }
    if (it == 0) {
      const float g = warp_total(
          lane < c ? plogp(s * (1.f / fmaxf(tot, kEps))) : 0.f);
      init = tot > 0.f ? -g : logf(static_cast<float>(c));
      ent = init;
    }
    float total = 0.f;   // lane k: row k's summed term
    for (int k0 = 0; k0 < m; k0 += kWarpRows) {
      float t[kWarpRows];
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
        const int k = k0 + i;
        t[i] = 0.f;
        if (k < m && ((cand >> k) & 1u)) {
          const float wk = __shfl_sync(kFull, w, k);
          const float ik = __shfl_sync(kFull, inv, k);
          if (lane < c) t[i] = plogp((s - p[k * c + lane] * wk) * ik);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < kWarpRows; ++i) {
          t[i] += __shfl_xor_sync(kFull, t[i], off);
        }
      }
#pragma unroll
      for (int i = 0; i < kWarpRows; ++i) {
        if (lane == k0 + i) total = t[i];
      }
    }
    float best = (cand >> lane) & 1u ? (tot - w > kEps ? -total : -1.f)
                                     : -INFINITY;
    int arg = lane;
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, off);
      const int oa = __shfl_xor_sync(kFull, arg, off);
      if (ob > best || (ob == best && oa < arg)) {
        best = ob;
        arg = oa;
      }
    }
    const bool improves = sweep && best > ent + kTol;
    if (improves) {
      if (lane == arg) mask = 0.f;
      if (lane == removed) order = arg;
      ent = best;
      ++removed;
    }
    if (!(improves && removed < cap)) break;
  }
  int* out_order = reinterpret_cast<int*>(out + m);
  if (row) {
    out[lane] = mask;
    out_order[lane] = order;
  }
  if (lane == 0) {
    out_order[m] = removed;
    out[2 * m + 1] = ent;
    out[2 * m + 2] = init;
  }
}

// Threads per CTA: enough warps that a lane of a full tile's row takes
// about eight classes, or that every row has a warp of its own; a power
// of two from 32 to 1024.
int loop_threads(int m, int slice) {
  const int want = 32 * max((slice + 255) / 256, m + 1);
  int threads = 32;
  while (threads < 1024 && threads < want) threads <<= 1;
  return threads;
}

int launch_loop(const void* p, const void* sizes, const void* active,
                const void* prot, void* out, int m, int c, int cap,
                int cluster, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || m < 1 || c < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = allow_smem_once(judge_loop_kernel, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cluster > 8) {  // 16 CTAs: H100's non-portable cluster size
    err = cudaFuncSetAttribute(judge_loop_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int slice = (c + cluster - 1) / cluster;
  const int threads = loop_threads(m, slice);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes =
      (kScalars + kTile + (threads / 32 + 2) * (m + 1) + 5 * m) *
          sizeof(float) + 2 * m;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, judge_loop_kernel,
                           static_cast<const float*>(p),
                           static_cast<const float*>(sizes),
                           static_cast<const float*>(active),
                           static_cast<const float*>(prot),
                           static_cast<float*>(out), m, c, cap, slice);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

}  // namespace

// partial: (ceil(c / block_c), m + 1) float32 scratch, unused (may be
// null) when c <= block_c; block_c <= 2048; out: (m + 1,) float32.
extern "C" int entropy_judge_sweep_f32(const void* p, const void* sizes,
                                       const void* mask, void* partial,
                                       void* out, int m, int c, int block_c,
                                       void* stream) {
  return launch_sweep<float>(p, sizes, mask, partial, out, m, c, block_c,
                             stream);
}

extern "C" int entropy_judge_sweep_bf16(const void* p, const void* sizes,
                                        const void* mask, void* partial,
                                        void* out, int m, int c, int block_c,
                                        void* stream) {
  return launch_sweep<__nv_bfloat16>(p, sizes, mask, partial, out, m, c,
                                     block_c, stream);
}

// p: (m, c) float32; sizes, active, prot: (m,) float32 (active null: all
// active; prot null: none protected); out: (2m + 3,) packed as above. One
// launch of `cluster` CTAs (1-16); the wrapper picks this or the warp.
extern "C" int entropy_judge_loop_f32(const void* p, const void* sizes,
                                      const void* active, const void* prot,
                                      void* out, int m, int c, int cap,
                                      int cluster, void* stream) {
  return launch_loop(p, sizes, active, prot, out, m, c, cap, cluster,
                     stream);
}

// The same loop in one warp (judge_loop_warp): c and m at most 32.
extern "C" int entropy_judge_loop_warp_f32(const void* p, const void* sizes,
                                           const void* active,
                                           const void* prot, void* out,
                                           int m, int c, int cap,
                                           void* stream) {
  if (m < 1 || c < 1 || m > 32 || c > 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  judge_loop_warp<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(sizes),
      static_cast<const float*>(active), static_cast<const float*>(prot),
      static_cast<float*>(out), m, c, cap);
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel, launched as the others are: the launch floor.
extern "C" int entropy_judge_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
