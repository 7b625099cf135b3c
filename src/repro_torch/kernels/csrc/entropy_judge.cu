// Maximum-entropy judgment (the paper's Alg. 1) on an H100: the whole
// greedy loop in one launch, and one greedy sweep.
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
// judge_loop_warp runs the loop at the paper's shape (C and M at most 32)
// in one CTA of four warps, each holding P's columns in registers (lane j
// column j), loaded once.
//
// judge_loop_grid runs the loop above that shape, and every sweep, in one
// cooperative launch over the class axis: one CTA a slice, by the wrapper's
// plan, a function of (M, C) alone (1,152 classes a CTA up to 132 CTAs, one
// an SM; wider slices past 152,064 classes). A CTA whose (M, slice) block
// of P fits in shared memory ("resident") loads it once and never reads P
// from device memory again; else it streams the block in tiles every
// iteration. An iteration forms s_c and the partial sums of the CTA's
// slice, writes them to a global exchange buffer double-buffered by
// iteration parity and meets the other CTAs at one grid barrier; then
// every CTA adds all the partials in the same fixed order and takes the
// argmax (the first index among ties) and the stop decision itself, so all
// agree bit for bit with no second barrier and no atomics. A sweep is the
// first iteration with every row swept and no decision.
//
// What bounds it on an H100: one sweep reads P once, M*C elements, and
// does about 2*M*C multiply-adds and (M+1)*C accurate logarithms (about 40
// instructions a term); at (10, 151936) the read takes 1.81 us at 3.35
// TB/s. Resident, an iteration is bound by its logarithms on 132 SMs, the
// grid barrier (about 1 us) and the read of the partials from L2. At the
// main path's (10, 10) the input is 400 bytes: the floor is one launch and
// the chain of shuffles an iteration. Every sum has a fixed order, so a
// call repeats its bits.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "smem_limit.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;        // C and M up to this: the warp kernel
constexpr int kTeams = 4;        // its warps, each a quarter of the rows
constexpr int kThreads = 1024;   // threads a CTA of the grid kernel
constexpr int kTile = 2048;      // classes a streamed CTA holds s_c for
constexpr float kEps = 1e-12f;
constexpr float kTol = 1e-6f;    // strict-improvement margin of Alg. 1

// q log q, 0 for q <= 0. The logarithm is taken of max(q, eps) whatever
// q is and the result selected after, so the code has no branch and the
// compiler interleaves the logarithms of an unrolled loop.
__device__ __forceinline__ float plogp(float q) {
  const float t = q * logf(fmaxf(q, kEps));
  return q > 0.f ? t : 0.f;
}

__device__ __forceinline__ float warp_total(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// ------------------------------------------------------- the warp kernel

// Four warps run the same loop. In each, lane k holds row k's size, mask
// and candidacy and lane j column j of P and class j's s_j; w_k and
// 1 / den_k reach the other lanes by shuffles. Warp q forms the terms of
// rows q, q + 4, ... (of kRows, M rounded up to 8, 12, 16 or 32; a row
// that is no candidate adds zeros), and their butterflies run in one
// batch; the totals meet in shared memory (double-buffered by iteration
// parity: one barrier an iteration), and every warp takes the decision
// from them. Every sum is a butterfly over the same halvings of a warp, so
// it takes the same association for every row, in every lane and warp
// (IEEE addition commutes): equal rows get equal sums, and every warp takes
// the same decision. The argmax is a butterfly on (value, index) that
// keeps the larger value and, on a tie, the smaller index: the first index
// among ties, as the reference's argmax.
template <int kRows>
__global__ void __launch_bounds__(32 * kTeams)
judge_loop_warp(const float* __restrict__ p, const float* __restrict__ sizes,
                const float* __restrict__ active,
                const float* __restrict__ prot, float* __restrict__ out,
                int m, int c, int cap) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int kMine = kRows / kTeams;
  __shared__ float totals[2][kRows];
  const int lane = threadIdx.x & 31;
  const int team = threadIdx.x >> 5;
  const bool row = lane < m;
  const bool col = lane < c;
  float pc[kRows];     // pc[k] = p[k][lane], 0 past M or C
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    pc[k] = k < m && col ? p[k * c + lane] : 0.f;
  }
  float pm[kMine];     // this warp's rows: pm[i] = pc[team + 4 i]
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    const int k = team + kTeams * i;
    pm[i] = k < m && col ? p[k * c + lane] : 0.f;
  }
  const float size = row ? sizes[lane] : 0.f;
  float mask = row ? (active ? active[lane] : 1.f) : 0.f;
  const bool keep = row && (prot == nullptr || prot[lane] == 0.f);
  int order = -1;      // lane r: the r-th removal
  int removed = 0;
  float ent = 0.f;
  float init = 0.f;
  for (int it = 0;; ++it) {
    const bool sweep = removed < cap;
    const float w = __fmul_rn(size, mask);   // 0 past M
    const float tot = warp_total(w);
    const float inv = 1.f / fmaxf(tot - w, kEps);
    const unsigned cand = __ballot_sync(kFull, sweep && mask > 0.f && keep);
    float s = 0.f;     // rows past M add 0 * 0: s keeps its bits
#pragma unroll
    for (int k = 0; k < kRows; ++k) s += pc[k] * __shfl_sync(kFull, w, k);
    if (it == 0) {
      const float g = warp_total(col ? plogp(s * (1.f / fmaxf(tot, kEps)))
                                     : 0.f);
      init = tot > 0.f ? -g : logf(static_cast<float>(c));
      ent = init;
    }
    float t[kMine];
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int k = team + kTeams * i;
      const float wk = __shfl_sync(kFull, w, k);
      const float ik = __shfl_sync(kFull, inv, k);
      t[i] = ((cand >> k) & 1u) && col ? plogp((s - pm[i] * wk) * ik) : 0.f;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        t[i] += __shfl_xor_sync(kFull, t[i], off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        totals[it & 1][team + kTeams * i] = t[i];
      }
    }
    __syncthreads();
    const float total = lane < kRows ? totals[it & 1][lane] : 0.f;
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
  if (team != 0) return;
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

// ------------------------------------------------------- the grid kernel

constexpr int kMaxCtas = 132;    // the plan's most CTAs: one an SM
constexpr int kPerLane = (kMaxCtas + 31) / 32;

// A grid CTA's shared memory, all of it dynamic (allow_smem_once raises
// the dynamic limit to the whole opt-in size, which leaves no room for
// static shared variables): Head in the first 48 bytes | P's block, M rows
// of `slice` floats, when resident | s[tile] | part[warps (M+1)] |
// acc[M+1] | sum[M+1], the rows' totals over every CTA | list[M+1] int32,
// the rows swept | size, mask, w, inv [M] | order[M] int32 | row_on, keep
// [M] bytes. The wrapper's plan adds the same sizes (entropy_judge._smem).
struct Head {
  unsigned long long bar;    // the mbarrier of the block's copy
  float ent, init, tot;      // entropy, initial entropy, sum_k w_k
  int removed, go, on, wpr;  // removals, another iteration, rows, warps a row
};
constexpr size_t kHead = 48;
static_assert(sizeof(Head) <= kHead, "Head outgrew its bytes");

struct Shared {
  Head* h;
  float *p, *s, *part, *acc, *sum;
  int* list;
  float *size, *mask, *w, *inv;
  int* order;
  unsigned char *row_on, *keep;
  size_t end;  // bytes in all
};

// The next n T's of the region at `base`, from byte offset `at`.
template <typename T>
__host__ __device__ inline T* take(unsigned char* base, size_t& at,
                                   size_t n) {
  at += n * sizeof(T);
  return reinterpret_cast<T*>(base + at - n * sizeof(T));
}

__host__ __device__ inline Shared carve(unsigned char* base, int m,
                                        int slice, int tile, int warps,
                                        bool resident) {
  Shared sh;
  const size_t rows = static_cast<size_t>(m) + 1;
  size_t at = kHead;
  sh.h = reinterpret_cast<Head*>(base);
  sh.p = take<float>(base, at, resident ? static_cast<size_t>(m) * slice : 0);
  sh.s = take<float>(base, at, tile);
  sh.part = take<float>(base, at, warps * rows);
  sh.acc = take<float>(base, at, rows);
  sh.sum = take<float>(base, at, rows);
  sh.list = take<int>(base, at, rows);
  sh.size = take<float>(base, at, m);
  sh.mask = take<float>(base, at, m);
  sh.w = take<float>(base, at, m);
  sh.inv = take<float>(base, at, m);
  sh.order = take<int>(base, at, m);
  sh.row_on = take<unsigned char>(base, at, m);
  sh.keep = take<unsigned char>(base, at, m);
  sh.end = at;
  return sh;
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// Starts the copy of rows 0..m-1, classes lo..lo+width-1 of P into sh.p
// (row pitch `slice` floats): when every row's start and length are
// 16-byte multiples (`bulk`), warp 0 issues one cp.async.bulk a row on the
// mbarrier; else every thread issues cp.async of 4 bytes a class.
// finish_block waits for it; a __syncthreads() between the two publishes
// the mbarrier's initialisation.
__device__ void start_block(const float* p, const Shared& sh, int m, int c,
                            int lo, int width, int slice, bool bulk) {
  if (bulk) {
    if (threadIdx.x >= 32) return;
    const unsigned b = smem_addr(&sh.h->bar);
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
          "r"(4 * m * width)
          : "memory");
    }
    __syncwarp();
    for (int k = threadIdx.x; k < m; k += 32) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
          "bytes [%0], [%1], %2, [%3];" ::"r"(smem_addr(sh.p + k * slice)),
          "l"(p + static_cast<size_t>(k) * c + lo), "r"(4 * width), "r"(b)
          : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < m * width; i += blockDim.x) {
      const int k = i / width;
      const int j = i - k * width;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                       smem_addr(sh.p + k * slice + j)),
                   "l"(p + static_cast<size_t>(k) * c + lo + j)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
}

__device__ void finish_block(const Shared& sh, bool bulk) {
  for (unsigned done = !bulk; !done;) {
    asm volatile(
        "{ .reg .pred q; mbarrier.try_wait.parity.shared::cta.b64 q, [%1], 0;"
        " selp.u32 %0, 1, 0, q; }"
        : "=r"(done)
        : "r"(smem_addr(&sh.h->bar))
        : "memory");
  }
  if (!bulk) asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// P[k][lo + j]: from the resident block, or from device memory.
template <typename T, bool kResident>
__device__ __forceinline__ float elem(const T* __restrict__ p,
                                      const float* p_sh, int k, int j, int c,
                                      int lo, int slice) {
  if constexpr (kResident) {
    return p_sh[k * slice + j];
  } else {
    return static_cast<float>(p[static_cast<size_t>(k) * c + lo + j]);
  }
}

// Warp 0 sets up an iteration over the current mask: tot (lane 0 adds the
// rows in order), w_k, 1 / den_k, the rows it sweeps (row 0, the group
// term, when `group`; row 1 + k when row_on[k]) in order in list, acc
// zeroed, and the warps a row takes: as many as give every row its own
// warps in one round. The caller's __syncthreads() publishes them.
__device__ void prepare(const Shared& sh, int m, bool group, bool any,
                        bool sweep) {
  constexpr unsigned kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float tot = 0.f;
  if (lane == 0) {
#pragma unroll 8
    for (int k = 0; k < m; ++k) tot += __fmul_rn(sh.size[k], sh.mask[k]);
    sh.h->tot = tot;
  }
  tot = __shfl_sync(kFull, tot, 0);
  for (int k = lane; k < m; k += 32) {
    const float wk = __fmul_rn(sh.size[k], sh.mask[k]);
    sh.w[k] = wk;
    sh.inv[k] = 1.f / fmaxf(tot - wk, kEps);
    sh.row_on[k] = sweep || (any && sh.mask[k] > 0.f && sh.keep[k]);
  }
  for (int r = lane; r <= m; r += 32) sh.acc[r] = 0.f;
  __syncwarp();
  int on = 0;
  for (int r0 = 0; r0 <= m; r0 += 32) {
    const int r = r0 + lane;
    const bool want = r <= m && (r == 0 ? group : sh.row_on[r - 1] != 0);
    const unsigned ballot = __ballot_sync(kFull, want);
    if (want) sh.list[on + __popc(ballot & ((1u << lane) - 1))] = r;
    on += __popc(ballot);
  }
  if (lane == 0) {
    sh.h->on = on;
    sh.h->wpr = max(1, static_cast<int>(blockDim.x >> 5) / max(on, 1));
  }
}

// The packed output of a loop: mask (m floats) | removal order (m int32, -1
// padded) | number removed (int32) | entropy | initial entropy. A sweep's:
// the group entropy | m leave-one-out entropies. xchg: 2 * ctas * (m + 1)
// floats of scratch.
//
// Over a tile of n classes, s_c comes first (k in order), then each row of
// the list goes to a group of warps; a lane adds its classes in order, the
// warp in a fixed shuffle tree, the row's warps in order, the tiles in
// order. Across the CTAs, warp i adds row list[i]: lane l the CTAs l,
// l + 32, ... in order, then the lanes in a fixed butterfly, so every CTA
// forms every total in the same order.
template <typename T, bool kResident>
__global__ void __launch_bounds__(kThreads)
judge_loop_grid(const T* __restrict__ p, const float* __restrict__ sizes,
                const float* __restrict__ active,
                const float* __restrict__ prot, float* __restrict__ out,
                float* __restrict__ xchg, int m, int c, int cap, int slice,
                int sweep) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int ctas = gridDim.x;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lo = blockIdx.x * slice;
  const int width = min(slice, c - lo);
  const int tile = kResident ? slice : min(kTile, slice);
  const Shared sh = carve(smem, m, slice, tile, warps, kResident);
  const bool bulk = (reinterpret_cast<uintptr_t>(p) & 15) == 0 &&
                    (c & 3) == 0 && (lo & 3) == 0 && (width & 3) == 0;

  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    sh.size[k] = sizes[k];
    sh.mask[k] = active ? active[k] : 1.f;
    sh.keep[k] = prot ? prot[k] == 0.f : 1;
    sh.order[k] = -1;
  }
  if (threadIdx.x == 0) {
    sh.h->ent = 0.f;
    sh.h->removed = 0;
  }
  if constexpr (kResident) {
    start_block(reinterpret_cast<const float*>(p), sh, m, c, lo, width,
                slice, bulk);
  }
  __syncthreads();
  if (warp == 0) {
    prepare(sh, m, true, sweep || cap > 0, sweep);
  }
  if constexpr (kResident) finish_block(sh, bulk);
  __syncthreads();

  const int rows = m + 1;
  for (int it = 0;; ++it) {
    const float tot = sh.h->tot;
    const int on = sh.h->on;
    const int wpr = sh.h->wpr;
    const int groups = warps / wpr;
    const int sub = warp % wpr;
    // xchg[it & 1] holds row r's partial of CTA b at r * ctas + b. It was
    // last read before the previous iteration's barrier, so one barrier an
    // iteration suffices.
    float* half = xchg + static_cast<size_t>(it & 1) * ctas * rows;
    for (int c0 = 0; c0 < width; c0 += tile) {
      const int n = min(tile, width - c0);
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        float s = 0.f;
#pragma unroll 4
        for (int k = 0; k < m; ++k) {
          s += elem<T, kResident>(p, sh.p, k, c0 + j, c, lo, slice) *
               sh.w[k];
        }
        sh.s[j] = s;
      }
      __syncthreads();
      for (int i = warp / wpr; warp < groups * wpr && i < on; i += groups) {
        const int r = sh.list[i];
        float v = 0.f;
        if (r == 0) {
          const float inv_tot = 1.f / fmaxf(tot, kEps);
#pragma unroll 4
          for (int j = sub * 32 + lane; j < n; j += wpr * 32) {
            v += plogp(sh.s[j] * inv_tot);
          }
        } else {
          const float wk = sh.w[r - 1];
          const float ik = sh.inv[r - 1];
#pragma unroll 4
          for (int j = sub * 32 + lane; j < n; j += wpr * 32) {
            const float pk = elem<T, kResident>(p, sh.p, r - 1, c0 + j, c,
                                                lo, slice);
            v += plogp((sh.s[j] - pk * wk) * ik);
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_down_sync(0xffffffffu, v, off);
        }
        if (lane == 0) sh.part[i * wpr + sub] = v;
      }
      __syncthreads();
      // Thread i owns row list[i]'s sum; after the last tile it publishes
      // this CTA's partial.
      const bool last = c0 + tile >= width;
      for (int i = threadIdx.x; i < on; i += blockDim.x) {
        const int r = sh.list[i];
        float t = sh.acc[r];
        for (int q = 0; q < wpr; ++q) t += sh.part[i * wpr + q];
        sh.acc[r] = t;
        if (last) __stcg(half + r * static_cast<size_t>(ctas) + blockIdx.x, t);
      }
      if (!last) __syncthreads();   // s and part reused
    }

    grid.sync();
    if (sweep && blockIdx.x != 0) return;
    for (int i = warp; i < on; i += warps) {
      const int r = sh.list[i];
      const float* row = half + static_cast<size_t>(r) * ctas;
      float v[kPerLane];
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int b = lane + 32 * q;
        v[q] = b < ctas ? __ldcg(row + b) : 0.f;
      }
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) t += v[q];
      t = warp_total(t);
      if (lane == 0) sh.sum[r] = t;
    }
    __syncthreads();

    if (sweep) {
      for (int r = threadIdx.x; r < rows; r += blockDim.x) {
        out[r] = r == 0 ? (tot > 0.f ? -sh.sum[0]
                                     : logf(static_cast<float>(c)))
                        : (tot - sh.w[r - 1] > kEps ? -sh.sum[r] : -1.f);
      }
      return;
    }
    // Warp 0 takes the argmax (the first index among ties) and the stop
    // decision, then sets up the next iteration.
    if (warp == 0) {
      float best = -INFINITY;
      int arg = m;
      for (int k = lane; k < m; k += 32) {
        const float v = tot - sh.w[k] > kEps ? -sh.sum[1 + k] : -1.f;
        if (sh.row_on[k] && v > best) {
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
        if (it == 0) {
          sh.h->init = tot > 0.f ? -sh.sum[0] : logf(static_cast<float>(c));
          sh.h->ent = sh.h->init;
        }
        const bool improves = sh.h->removed < cap && best > sh.h->ent + kTol;
        if (improves) {
          sh.mask[arg] = 0.f;
          sh.h->ent = best;
          sh.order[sh.h->removed] = arg;
          ++sh.h->removed;
        }
        sh.h->go = improves && sh.h->removed < cap;
      }
      __syncwarp();
      if (sh.h->go) prepare(sh, m, false, true, false);
    }
    __syncthreads();
    if (!sh.h->go) break;
  }
  if (blockIdx.x == 0) {
    int* out_order = reinterpret_cast<int*>(out + m);
    for (int k = threadIdx.x; k < m; k += blockDim.x) {
      out[k] = sh.mask[k];
      out_order[k] = sh.order[k];
    }
    if (threadIdx.x == 0) {
      out_order[m] = sh.h->removed;
      out[2 * m + 1] = sh.h->ent;
      out[2 * m + 2] = sh.h->init;
    }
  }
}

// One cooperative launch of `ctas` CTAs: all resident together or the
// launch is refused (cudaErrorCooperativeLaunchTooLarge), never run on
// fewer. The plan must cover C exactly and fit `smem`.
template <typename T, bool kResident>
int launch_grid(const void* p, const void* sizes, const void* active,
                const void* prot, void* out, void* xchg, int m, int c,
                int cap, int ctas, int slice, int smem, int sweep,
                void* stream) {
  const int tile = kResident ? slice : min(kTile, slice);
  if (m < 1 || c < 1 || ctas < 1 || ctas > kMaxCtas || slice < 1 ||
      (slice & 3) != 0 || static_cast<long long>(ctas - 1) * slice >= c ||
      static_cast<long long>(ctas) * slice < c ||
      carve(nullptr, m, slice, tile, kThreads / 32, kResident).end >
          static_cast<size_t>(smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static std::atomic<unsigned long long> ready{0};
  cudaError_t err = allow_smem_once(judge_loop_grid<T, kResident>, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, judge_loop_grid<T, kResident>,
                           static_cast<const T*>(p),
                           static_cast<const float*>(sizes),
                           static_cast<const float*>(active),
                           static_cast<const float*>(prot),
                           static_cast<float*>(out),
                           static_cast<float*>(xchg), m, c, cap, slice,
                           sweep);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

__global__ void empty_kernel() {}

}  // namespace

// p: (m, c) float32, or bfloat16 (`bf16`, a sweep only, streamed); sizes,
// active, prot: (m,) float32 (active null: all active; prot null: none
// protected); out: the packed loop (2m + 3,) or, with `sweep`, the (m + 1,)
// sweep (active is then the mask and every row is swept); xchg:
// 2 * ctas * (m + 1) float32 scratch. ctas, slice, smem and resident are
// the wrapper's plan (entropy_judge.plan).
extern "C" int entropy_judge_grid(const void* p, const void* sizes,
                                  const void* active, const void* prot,
                                  void* out, void* xchg, int m, int c, int cap,
                                  int ctas, int slice, int smem, int resident,
                                  int sweep, int bf16, void* stream) {
  if (bf16) {
    if (resident || !sweep) return static_cast<int>(cudaErrorInvalidValue);
    return launch_grid<__nv_bfloat16, false>(p, sizes, active, prot, out,
                                             xchg, m, c, cap, ctas, slice,
                                             smem, sweep, stream);
  }
  return resident ? launch_grid<float, true>(p, sizes, active, prot, out,
                                             xchg, m, c, cap, ctas, slice,
                                             smem, sweep, stream)
                  : launch_grid<float, false>(p, sizes, active, prot, out,
                                              xchg, m, c, cap, ctas, slice,
                                              smem, sweep, stream);
}

// The loop in one CTA of four warps (judge_loop_warp): c and m at most 32.
extern "C" int entropy_judge_loop_warp_f32(const void* p, const void* sizes,
                                           const void* active,
                                           const void* prot, void* out,
                                           int m, int c, int cap,
                                           void* stream) {
  if (m < 1 || c < 1 || m > kWarp || c > kWarp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = m <= 8    ? judge_loop_warp<8>
                      : m <= 12 ? judge_loop_warp<12>
                      : m <= 16 ? judge_loop_warp<16>
                                : judge_loop_warp<kWarp>;
  kernel<<<1, 32 * kTeams, 0, static_cast<cudaStream_t>(stream)>>>(
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
