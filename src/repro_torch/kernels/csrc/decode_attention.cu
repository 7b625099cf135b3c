// Single-query (decode) attention over a position-tagged KV cache (K4).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py:60
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
// package, so a row with no valid slot averages all T slots. Inputs are
// float32 or bfloat16, any D <= 256 and any g = H / KH; accumulation is
// float32.
//
// What bounds it on an H100: every cache element is read once and used in
// 2g multiply-adds, so it is bound by reading 2 * B * T * KH * D elements:
// 86.5 MB, 0.026 ms at 3.35 TB/s, at Zamba2-2.7B's B=4, T=1056, KH=32,
// D=80 in float32; 17.3 MB, 0.0052 ms, at qwen3-moe-235b-a22b's B=4,
// T=1056, KH=4, D=128 (g = 16). To come near that rate the card needs
// tens of kilobytes of loads in flight on every SM, nothing read twice,
// and a tile's arithmetic done in less time than its copy: no block
// barrier and no warp-wide reduction in the inner loop. Measured on an
// H100 (PERF.md, K4): at Zamba2's shape the kernel streams the cache a
// little below the rate of a plain copy of the same bytes; at qwen3-moe's
// the 17 MB cache stays in L2 between calls, and the per-block work that
// does not scale with the slots (q's split, the teams' merge, the states'
// writes) and the merge kernel bound it, not the bytes.
//
// Design.
// - Split the cache axis over the SMs (flash decoding). A block owns one
//   (split, kv head, b), the grid's x, y and z, and walks only its split's
//   split_len slots. The wrapper computes the whole launch from the shapes
//   and the SM count alone (decode_attention.py, plan): the number of
//   splits S, the tile, the route, the heads a block serves and the
//   shared-memory layout below, which this file reads as it is (struct
//   Plan) and computes nothing of. Two calls on the same shapes run the
//   same grid: the most splits whose blocks all fit on the card at once
//   (up to four an SM on the tensor cores, three on the CUDA cores, by
//   shared memory): 33 x 4 x 4 = 528 blocks of 32 slots at qwen3-moe's
//   shape, 3 x 32 x 4 = 384 blocks of 352 at Zamba2's.
// - A block serves all g query heads of its KV head wherever their q and
//   states fit its shared memory (every group up to 64 heads at any D <=
//   256, and every model's); a larger group takes ceil(g / heads) blocks
//   a KV head (grid y = KH x that), each reading the cache.
// - Teams. A block is up to four teams (as many as fit, at most 16 warps
//   in all); team i takes the split's tiles of `tile` slots i, i + teams,
//   ... and stages them through its own ring of one or two stages (two
//   when it has more than one tile: the next tile's copy is in flight
//   while one is used) in shared memory, with 16-byte cp.async copies
//   (element copies where D * sizeof(T) is not a multiple of 16 or a
//   pointer is not 16-byte aligned; slots past the split are zero-filled).
//   Tiles stay in the input's dtype. A team syncs only itself
//   (__syncwarp, or a named barrier for a team of several warps) and keeps
//   its online-softmax state in registers; the teams' states are merged
//   once, at the end of the split, through shared memory in team order.
//   Every query head of the block reads the staged tile.
// - At g >= 8 (the wrapper's choice) both products run on the tensor cores
//   in 3xTF32 (tf32_mma.cuh, as in K3 and K5). A team is one warp a 16-head
//   m-tile (a smaller group pads the A tile with zero rows), and a tile is
//   8 slots. q is split into its TF32 hi and lo parts once a block. S = Q
//   K^T is 16 x 8 (two accumulators over alternate d steps, so two mma
//   chains run side by side); the row max is the 4 lanes of a quad (two
//   shuffles for all 16 heads); P goes to P V as it stands: with the k
//   index of P V permuted within the step (k slot t stands for slot 2t
//   and t + 4 for 2t + 1, K3's trick) the C fragment of S is P's A
//   fragment, and V's B fragment reads slots 2t and 2t + 1. O (16 x D)
//   stays in the warp's registers, rescaled only when the warp's running
//   max moved. bfloat16 K and V are exact in TF32 and skip their lo pass.
// - Below g = 8 the CUDA cores serve. A team is one warp, a tile 8, 16 or
//   32 slots (the most whose rings let three blocks share an SM: 8 at
//   Zamba2's D = 80), 32 / tile lanes a slot. A lane sums its part of each
//   head's dot product from 16-byte reads and the slot's lanes combine (0
//   to 2 shuffles); the tile max is log2(tile) shuffles a head; p goes
//   through shared memory, and P V runs with the lanes over D's columns.
// - Row strides of the staged tiles are padded so the fragment loads or
//   the 16-byte row reads are free of bank conflicts; K's columns
//   D..round_up(D, 8) are zeroed once.
// - Merge. With S = 1 the split kernel writes o. Otherwise each split
//   writes its per-head state (m, l, acc[D]) in float32 to scratch laid
//   out as S x B x H x (D + 2) floats, 4.4 MB at qwen3-moe's shape (it
//   stays in the 50 MB L2), and decode_merge_kernel, launched from the same
//   C entry point on the same stream, combines the S states of each (b, h)
//   in split order with no atomics: the same inputs give the same bits.
//   A split with no valid slot has m = -1e30 and weighs exp(-1e30 - m) = 0
//   beside one that has; a row with no valid slot keeps weight 1 in every
//   split and averages all T slots. Slots past T are no slot (p = 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "smem_limit.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxStages = 2;       // tiles in a team's ring
constexpr int kMaxTeams = 4;        // teams a block
constexpr int kTcTile = 8;          // slots a tensor-core tile
constexpr int kMergeThreads = 128;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The plan and the shared-memory layout of a call, as the wrapper computes
// them from the shapes (decode_attention.py, plan, whose Plan has these
// fields in this order): int32. Offsets and sizes are bytes into the
// dynamic shared memory; strides are elements.
struct Plan {
  int b, t, h, kh, d;
  int splits, split_len, tile, stages, tensor_cores;
  int heads;                    // query heads a block serves
  int hgroups;                  // blocks a kv head's group spans
  int rows;                     // q rows a block holds (16 an m-tile)
  int teams, team_warps;        // teams a block, warps a team
  int rs;                       // a row of the teams' states (floats)
  int ks, vs, qs;               // K, V and q rows (elements of T)
  int v_off, tag_off, stage_bytes, team_bytes, q_off, p_off, smem;
};

// Everything a split block needs, by value.
struct Args : Plan {
  const void* q;
  const void* k;
  const void* v;
  const int* tags;
  const int* index;
  void* o;
  float* part;                  // S x B x H x (D + 2), or null when S = 1
  int g, window, vec;
  float scale;
};

__device__ __forceinline__ bool seen(int tag, int idx, int window) {
  return tag >= 0 && tag <= idx && (window <= 0 || tag > idx - window);
}

__device__ __forceinline__ void zero(float& x) { x = 0.f; }
__device__ __forceinline__ void zero(__nv_bfloat16& x) {
  x = __float2bfloat16(0.f);
}

// 16 bytes of shared memory as floats
__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&x)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(v[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

// Waits until at most n (0 to 2) of the thread's cp.async groups are
// still in flight.
__device__ __forceinline__ void wait_pending(int n) {
  if (n <= 0) {
    cp_async_wait<0>();
  } else if (n == 1) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<2>();
  }
}

// A team's barrier: one warp syncs itself; a team of several warps takes
// named barrier 1 + team
__device__ __forceinline__ void team_sync(int team, int threads) {
  if (threads == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "r"(threads)
                 : "memory");
  }
}

// The team's copy of slots [t0, t0 + w) of its block's K, V and tags into
// the stage at `st`; slots at or past t_end are zero-filled. `tt` is the
// thread's rank in the team of `nt` threads.
template <typename T>
__device__ void stage_tile(const Args& a, unsigned char* st, const T* kg,
                           const T* vg, const int* tg, int t0, int t_end,
                           int w, int tt, int nt) {
  T* kd = reinterpret_cast<T*>(st);
  T* vd = reinterpret_cast<T*>(st + a.v_off);
  int* td = reinterpret_cast<int*>(st + a.tag_off);
  const size_t row = static_cast<size_t>(a.kh) * a.d;   // between slots
  constexpr int cw = 16 / sizeof(T);                    // a 16-byte copy
  const int per = a.vec ? a.d / cw : a.d;               // copies a row
  int r = tt / per, c = tt - r * per;
  const int dr = nt / per, dc = nt - dr * per;
  while (r < w) {
    const bool ok = t0 + r < t_end;
    const size_t off = ok ? (t0 + r) * row : 0;
    if (a.vec) {
      cp_async16(reinterpret_cast<float*>(kd + r * a.ks + c * cw),
                 reinterpret_cast<const float*>(kg + off + c * cw), ok);
      cp_async16(reinterpret_cast<float*>(vd + r * a.vs + c * cw),
                 reinterpret_cast<const float*>(vg + off + c * cw), ok);
    } else if constexpr (sizeof(T) == 4) {
      cp_async4(kd + r * a.ks + c, kg + off + c, ok);
      cp_async4(vd + r * a.vs + c, vg + off + c, ok);
    } else {
      if (ok) {
        kd[r * a.ks + c] = kg[off + c];
        vd[r * a.vs + c] = vg[off + c];
      } else {
        zero(kd[r * a.ks + c]);
        zero(vd[r * a.vs + c]);
      }
    }
    c += dc;
    r += dr;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
  for (int i = tt; i < w; i += nt) {
    const bool ok = t0 + i < t_end;
    cp_async4(reinterpret_cast<float*>(td + i),
              reinterpret_cast<const float*>(tg + (ok ? t0 + i : 0)), ok);
  }
}

// What every split block shares: its place in the grid and its cache
// rows. It starts the copy of its q rows (as they are; the scale goes on
// the scores, as in the reference) to `q_s` as one cp.async group, and
// zeroes q past the block's heads and q's and K's pad columns D..kpad;
// the caller waits for the group and syncs the block.
template <typename T>
struct Block {
  int sp, heads, t_begin, t_end, idx;
  size_t head0;                 // the block's first query head, b * H + ..
  const T* kg;
  const T* vg;
  const int* tg;

  __device__ Block(const Args& a, unsigned char* smem, int kpad, T* q_s) {
    sp = blockIdx.x;
    const int b = blockIdx.z, kh = blockIdx.y / a.hgroups;
    const int hg = blockIdx.y - kh * a.hgroups;
    heads = min(a.heads, a.g - hg * a.heads);
    t_begin = sp * a.split_len;
    t_end = min(a.t, t_begin + a.split_len);
    idx = a.index[b];
    head0 = static_cast<size_t>(b) * a.h + static_cast<size_t>(kh) * a.g +
            hg * a.heads;
    const size_t slot0 = static_cast<size_t>(b) * a.t * a.kh + kh;
    kg = static_cast<const T*>(a.k) + slot0 * a.d;
    vg = static_cast<const T*>(a.v) + slot0 * a.d;
    tg = a.tags + static_cast<size_t>(b) * a.t;

    const T* qg = static_cast<const T*>(a.q) + head0 * a.d;
    constexpr int cw = 16 / sizeof(T);
    const int per = a.vec ? a.d / cw : a.d;          // copies a q row
    for (int i = threadIdx.x; i < heads * per; i += blockDim.x) {
      const int r = i / per, c = i - r * per;
      if (a.vec) {
        cp_async16(reinterpret_cast<float*>(q_s + r * a.qs + c * cw),
                   reinterpret_cast<const float*>(qg + r * a.d + c * cw),
                   true);
      } else if constexpr (sizeof(T) == 4) {
        cp_async4(q_s + r * a.qs + c, qg + r * a.d + c, true);
      } else {
        q_s[r * a.qs + c] = qg[r * a.d + c];
      }
    }
    cp_async_commit();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nw = blockDim.x >> 5;
    for (int r = warp; r < a.rows; r += nw) {
      const bool real = r < heads;
      for (int c = (real ? a.d : 0) + lane; c < (real ? kpad : a.qs); c += 32)
        zero(q_s[r * a.qs + c]);
    }
    if (kpad > a.d) {
      for (int r = warp; r < a.teams * a.stages * a.tile; r += nw) {
        T* row = reinterpret_cast<T*>(smem + (r / a.tile) * a.stage_bytes) +
                 (r % a.tile) * a.ks;
        for (int c = a.d + lane; c < kpad; c += 32) zero(row[c]);
      }
    }
  }
};

// The teams' states (m, l, acc by row, rows x a.rs floats a team,
// team-major) are in `red`: merge them in team order and write o (one
// split) or this split's state, a warp a row: lane t takes team t's
// weight exp(m_t - max m), the warp shares the weights by shuffles, and
// each lane sums two columns.
template <typename T>
__device__ void finish(const Args& a, const Block<T>& blk,
                       const float* red) {
  const int d = a.d, rec = d + 2;
  const size_t ts = static_cast<size_t>(a.rows) * a.rs;   // a team
  const int n = min(a.rows, blk.heads);
  const int lane = threadIdx.x & 31;
  const bool pairs = d % 2 == 0;                  // 8-byte columns
  float* part = a.part + (static_cast<size_t>(blk.sp) * a.b * a.h +
                          blk.head0) * rec;
  T* o = static_cast<T*>(a.o) + blk.head0 * d;
  for (int r = threadIdx.x >> 5; r < n; r += blockDim.x >> 5) {
    const float* x = red + r * a.rs;
    const bool mine = lane < a.teams;
    const float mt = mine ? x[lane * ts] : kNegInf;
    float mx = mt;
    for (int off = 2; off > 0; off >>= 1)          // teams <= 4
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float wl = mine ? expf(mt - mx) : 0.f;
    float den = mine ? x[lane * ts + 1] * wl : 0.f;
    for (int off = 2; off > 0; off >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, off);
    den = __shfl_sync(0xffffffffu, den, 0);
    mx = __shfl_sync(0xffffffffu, mx, 0);
    float w[kMaxTeams];
#pragma unroll
    for (int tm = 0; tm < kMaxTeams; ++tm)
      w[tm] = __shfl_sync(0xffffffffu, wl, tm);
    for (int c = 2 * lane; c < d; c += 64) {
      float n0 = 0.f, n1 = 0.f;
#pragma unroll
      for (int tm = 0; tm < kMaxTeams; ++tm) {
        if (tm >= a.teams) break;
        const float* y = x + tm * ts + 2 + c;
        if (pairs) {
          const float2 v = *reinterpret_cast<const float2*>(y);
          n0 = fmaf(v.x, w[tm], n0);
          n1 = fmaf(v.y, w[tm], n1);
        } else {
          n0 = fmaf(y[0], w[tm], n0);
          if (c + 1 < d) n1 = fmaf(y[1], w[tm], n1);
        }
      }
      if (a.splits == 1) {
        const float l = fmaxf(den, 1e-30f);
        store(o + r * d + c, n0 / l);
        if (c + 1 < d) store(o + r * d + c + 1, n1 / l);
      } else if (pairs) {
        *reinterpret_cast<float2*>(part + r * rec + 2 + c) =
            make_float2(n0, n1);
      } else {
        part[r * rec + 2 + c] = n0;
        if (c + 1 < d) part[r * rec + 3 + c] = n1;
      }
    }
    if (a.splits > 1 && lane == 0) {
      part[r * rec] = mx;
      part[r * rec + 1] = den;
    }
  }
}

// The team's share of the split's tiles: i, i + teams, ...
__device__ __forceinline__ int team_tiles(int n_tiles, int team,
                                          int teams) {
  return team < n_tiles ? (n_tiles - team + teams - 1) / teams : 0;
}

// The split pass on the tensor cores. A team is one warp a 16-head m-tile;
// kD8 >= D / 8 output column tiles a warp holds.
template <typename T, int kD8>
__global__ void __launch_bounds__(512)
    decode_split_tc(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kExact = sizeof(T) == 2;       // bfloat16: exact in TF32
  // q comes in raw where its hi parts go (float32) or where its lo parts
  // go (bfloat16), and is split in place
  uint32_t* qh = reinterpret_cast<uint32_t*>(smem + a.q_off);
  uint32_t* ql = qh + a.rows * a.qs;
  const Block<T> blk(a, smem, round_up(a.d, 8),
                     reinterpret_cast<T*>(sizeof(T) == 4 ? qh : ql));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int team = warp / a.team_warps, mt = warp - team * a.team_warps;
  const int nt = 32 * a.team_warps, tt = tid - team * nt;
  const int gq = lane >> 2, tq = lane & 3;
  const int d = a.d, d8 = (d + 7) / 8;
  const int mine = team_tiles(
      (blk.t_end - blk.t_begin + kTcTile - 1) / kTcTile, team, a.teams);
  unsigned char* ring = smem + team * a.team_bytes;

  auto start = [&](int i) {     // the team's i-th tile into its stage
    stage_tile<T>(a, ring + (i % a.stages) * a.stage_bytes, blk.kg, blk.vg,
                  blk.tg, blk.t_begin + (team + i * a.teams) * kTcTile,
                  blk.t_end, kTcTile, tt, nt);
    cp_async_commit();
  };
  const int ahead = min(a.stages, mine);
  for (int i = 0; i < ahead; ++i) start(i);
  wait_pending(ahead);                      // q has landed
  __syncthreads();
  // q's hi and lo TF32 parts, once a block
  if constexpr (sizeof(T) == 4) {
    for (int i = tid; i < a.rows * a.qs; i += blockDim.x)
      split(__uint_as_float(qh[i]), qh[i], ql[i]);
  } else {
    const T* raw = reinterpret_cast<const T*>(ql);
    for (int i = tid; i < a.rows * a.qs; i += blockDim.x)
      qh[i] = __float_as_uint(to_f32(raw[i]));   // exact in TF32
    __syncthreads();
    for (int i = tid; i < a.rows * a.qs; i += blockDim.x) ql[i] = 0u;
  }
  __syncthreads();

  float acc[kD8][4];
#pragma unroll
  for (int j = 0; j < kD8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows gq, gq + 8
  const int qa = (mt * 16 + gq) * a.qs + tq;  // q's A fragment

  int issued = ahead;
  for (int i = 0; i < mine; ++i) {
    wait_pending(issued - 1 - i);           // tile i has landed
    team_sync(team, nt);
    const unsigned char* st = ring + (i % a.stages) * a.stage_bytes;
    const T* kt = reinterpret_cast<const T*>(st);
    const T* vt = reinterpret_cast<const T*>(st + a.v_off);
    const int* tags = reinterpret_cast<const int*>(st + a.tag_off);
    const int live = min(kTcTile, blk.t_end - blk.t_begin -
                                      (team + i * a.teams) * kTcTile);

    // S = Q K^T, 16 heads x 8 slots
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
    const T* kb = kt + gq * a.ks + tq;
    auto qk = [&](float (&c)[4], int k0) {      // c += Q[:, k0:k0+8] K^T
      const int i0 = qa + k0, i1 = i0 + 8 * a.qs;
      const uint32_t ahi[4] = {qh[i0], qh[i1], qh[i0 + 4], qh[i1 + 4]};
      const uint32_t alo[4] = {ql[i0], ql[i1], ql[i0 + 4], ql[i1 + 4]};
      mma_3xtf32<kExact>(c, ahi, alo, to_f32(kb[k0]), to_f32(kb[k0 + 4]));
    };
#pragma unroll
    for (int k8 = 0; k8 < kD8; k8 += 2) {
      if (k8 >= d8) break;
      qk(c0, 8 * k8);
      if (k8 + 1 < d8) qk(c1, 8 * k8 + 8);
    }
    // masked scores; slots past the split are no slot (p = 0)
    float s[4];
    bool here[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 2 * tq + (e & 1);
      here[e] = j < live;
      s[e] = !here[e] ? -INFINITY
             : seen(tags[j], blk.idx, a.window) ? (c0[e] + c1[e]) * a.scale
                                                : kNegInf;
    }
    float x0 = fmaxf(s[0], s[1]), x1 = fmaxf(s[2], s[3]);
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
    const float n0 = fmaxf(m0, x0), n1 = fmaxf(m1, x1);
    const float al0 = expf(m0 - n0), al1 = expf(m1 - n1);
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = here[e] ? expf(s[e] - (e < 2 ? n0 : n1)) : 0.f;
    l0 = fmaf(al0, l0, p[0] + p[1]);
    l1 = fmaf(al1, l1, p[2] + p[3]);
    m0 = n0;
    m1 = n1;

    // O = alpha O + P V; P's A fragment is S's C fragment (c0, c2, c1, c3)
    uint32_t phi[4], plo[4];
    split(p[0], phi[0], plo[0]);
    split(p[2], phi[1], plo[1]);
    split(p[1], phi[2], plo[2]);
    split(p[3], phi[3], plo[3]);
    const T* vb = vt + 2 * tq * a.vs + gq;
    if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
      for (int n8 = 0; n8 < kD8; ++n8) {
        acc[n8][0] *= al0;
        acc[n8][1] *= al0;
        acc[n8][2] *= al1;
        acc[n8][3] *= al1;
      }
    }
#pragma unroll
    for (int n8 = 0; n8 < kD8; ++n8) {
      if (n8 >= d8) break;
      mma_3xtf32<kExact>(acc[n8], phi, plo, to_f32(vb[8 * n8]),
                         to_f32(vb[8 * n8 + a.vs]));
    }
    if (issued < mine) {                    // refill the stage just used
      team_sync(team, nt);
      start(issued++);
    }
  }
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  // the teams' states, through the idle rings
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  float* out = red + (static_cast<size_t>(team) * a.rows + mt * 16) * a.rs;
  if (tq == 0) {
    out[gq * a.rs] = m0;
    out[gq * a.rs + 1] = l0;
    out[(gq + 8) * a.rs] = m1;
    out[(gq + 8) * a.rs + 1] = l1;
  }
#pragma unroll
  for (int n8 = 0; n8 < kD8; ++n8) {
    if (n8 >= d8) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = gq + (e >> 1) * 8, c = 8 * n8 + 2 * tq + (e & 1);
      if (c < d) out[r * a.rs + 2 + c] = acc[n8][e];
    }
  }
  __syncthreads();
  finish<T>(a, blk, red);
}

// The split pass on the CUDA cores, for a group of at most kG heads
// (g < 8). A team is one warp; a tile is a.tile slots, 32 / a.tile lanes
// a slot.
template <typename T, int kG>
__global__ void __launch_bounds__(32 * kMaxTeams)
    decode_split_core(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int cw = 16 / sizeof(T);
  constexpr int kCols = 8;                      // columns a lane: D <= 256
  const T* q_s = reinterpret_cast<const T*>(smem + a.q_off);
  const Block<T> blk(a, smem, round_up(a.d, cw),
                     reinterpret_cast<T*>(smem + a.q_off));
  const int team = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blk.heads, d = a.d, w = a.tile;
  const int lps = 32 / w, slot = lane / lps, part = lane - slot * lps;
  const int kc = (d + cw - 1) / cw;
  const int mine = team_tiles((blk.t_end - blk.t_begin + w - 1) / w, team,
                              a.teams);
  unsigned char* ring = smem + team * a.team_bytes;
  float* p_s = reinterpret_cast<float*>(smem + a.p_off) + team * kG * 32;

  auto start = [&](int i) {
    stage_tile<T>(a, ring + (i % a.stages) * a.stage_bytes, blk.kg, blk.vg,
                  blk.tg, blk.t_begin + (team + i * a.teams) * w, blk.t_end,
                  w, lane, 32);
    cp_async_commit();
  };
  const int ahead = min(a.stages, mine);
  for (int i = 0; i < ahead; ++i) start(i);
  wait_pending(ahead);                      // q has landed
  __syncthreads();

  float acc[kG][kCols], m[kG], l[kG];
#pragma unroll
  for (int h = 0; h < kG; ++h) {
    m[h] = kNegInf;
    l[h] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[h][j] = 0.f;
  }

  int issued = ahead;
  for (int i = 0; i < mine; ++i) {
    wait_pending(issued - 1 - i);           // tile i has landed
    __syncwarp();
    const unsigned char* st = ring + (i % a.stages) * a.stage_bytes;
    const T* kt = reinterpret_cast<const T*>(st);
    const T* vt = reinterpret_cast<const T*>(st + a.v_off);
    const int* tags = reinterpret_cast<const int*>(st + a.tag_off);
    const int live = min(w, blk.t_end - blk.t_begin -
                                (team + i * a.teams) * w);
    const bool here = slot < live;
    const bool ok = here && seen(tags[slot], blk.idx, a.window);

    // this lane's part of each head's score of its slot
    float s[kG];
#pragma unroll
    for (int h = 0; h < kG; ++h) s[h] = 0.f;
    for (int c = part; c < kc; c += lps) {
      float kv[cw];
      load16(kt + slot * a.ks + c * cw, kv);
#pragma unroll
      for (int h = 0; h < kG; ++h) {
        if (h >= g) break;
        float qv[cw];
        load16(q_s + h * a.qs + c * cw, qv);
#pragma unroll
        for (int e = 0; e < cw; ++e) s[h] = fmaf(kv[e], qv[e], s[h]);
      }
    }
#pragma unroll
    for (int h = 0; h < kG; ++h) {
      if (h >= g) break;
      for (int off = 1; off < lps; off <<= 1)
        s[h] += __shfl_xor_sync(0xffffffffu, s[h], off);
      s[h] = !here ? -INFINITY : ok ? s[h] * a.scale : kNegInf;
      float x = s[h];
      for (int off = lps; off < 32; off <<= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
      const float mn = fmaxf(m[h], x);
      const float al = expf(m[h] - mn);
      const float p = here ? expf(s[h] - mn) : 0.f;
      l[h] = fmaf(al, l[h], part == 0 ? p : 0.f);
      m[h] = mn;
      if (part == 0) p_s[h * 32 + slot] = p;
      if (al != 1.f) {                        // the same on every lane
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[h][j] *= al;
      }
    }
    __syncwarp();
    // O += P V, the lanes over D's columns
    for (int sl = 0; sl < live; ++sl) {
      const T* vr = vt + sl * a.vs;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = lane + 32 * j;
        if (col >= d) break;
        const float x = to_f32(vr[col]);
#pragma unroll
        for (int h = 0; h < kG; ++h) {
          if (h >= g) break;
          acc[h][j] = fmaf(p_s[h * 32 + sl], x, acc[h][j]);
        }
      }
    }
    if (issued < mine) {                    // refill the stage just used
      __syncwarp();
      start(issued++);
    }
  }

  // the teams' states, through the idle rings
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  float* out = red + static_cast<size_t>(team) * a.rows * a.rs;
#pragma unroll
  for (int h = 0; h < kG; ++h) {
    if (h >= g) break;
    float lh = l[h];
    for (int off = 16; off > 0; off >>= 1)
      lh += __shfl_xor_sync(0xffffffffu, lh, off);
    if (lane == 0) {
      out[h * a.rs] = m[h];
      out[h * a.rs + 1] = lh;
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = lane + 32 * j;
      if (col < d) out[h * a.rs + 2 + col] = acc[h][j];
    }
  }
  __syncthreads();
  finish<T>(a, blk, red);
}

// o[b, h] from the S split states of (b, h), in split order: the splits'
// m and l are read side by side into shared memory; one warp takes their
// max, the weights exp(m_s - max m) and the weighted sum of l (shuffles in
// a fixed order); each column then sums its S accumulators, sixteen loads
// in flight.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
    decode_merge_kernel(const float* __restrict__ part, T* __restrict__ o,
                        int splits, int b, int h, int d) {
  extern __shared__ float w_s[];                // m, then weights; l
  float* l_s = w_s + splits;
  __shared__ float den;
  const int hh = blockIdx.x, bb = blockIdx.y, lane = threadIdx.x & 31;
  const int rec = d + 2;
  const size_t stride = static_cast<size_t>(b) * h * rec;   // a split
  const float* p0 = part + (static_cast<size_t>(bb) * h + hh) * rec;
  for (int s = threadIdx.x; s < splits; s += blockDim.x) {
    w_s[s] = p0[s * stride];
    l_s[s] = p0[s * stride + 1];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    float mx = kNegInf;
    for (int s = lane; s < splits; s += 32) mx = fmaxf(mx, w_s[s]);
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float x = 0.f;
    for (int s = lane; s < splits; s += 32) {
      const float f = expf(w_s[s] - mx);
      w_s[s] = f;
      x = fmaf(l_s[s], f, x);
    }
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) den = fmaxf(x, 1e-30f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float num = 0.f;
#pragma unroll 16
    for (int s = 0; s < splits; ++s)
      num = fmaf(p0[s * stride + 2 + c], w_s[s], num);
    store(o + (static_cast<size_t>(bb) * h + hh) * d + c, num / den);
  }
}

template <typename Kernel>
cudaError_t launch_split(Kernel kernel, std::atomic<unsigned long long>& ok,
                         const Args& a, cudaStream_t stream) {
  const cudaError_t err = allow_smem_once(kernel, ok);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.splits, a.kh * a.hgroups, a.b),
           32 * a.teams * a.team_warps, a.smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int kD8>
cudaError_t tc_split(const Args& a, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  return launch_split(decode_split_tc<T, kD8>, ready, a, stream);
}

template <typename T, int kG>
cudaError_t core(const Args& a, cudaStream_t stream) {
  static std::atomic<unsigned long long> ready{0};
  return launch_split(decode_split_core<T, kG>, ready, a, stream);
}

// Checks what the kernels' templates and launch bounds take of the plan
// (its layout is the wrapper's), then launches the split pass and, with
// more than one split, the merge.
template <typename T>
int run(Args a, cudaStream_t stream) {
  const int d = a.d;
  const bool tc = a.tensor_cores != 0;
  if (a.kh < 1 || a.h % a.kh || d < 1 || d > 256 || a.t < 1 || a.b < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  a.g = a.h / a.kh;
  if (a.splits < 1 || a.split_len < 1 ||
      static_cast<long long>(a.splits) * a.split_len < a.t ||
      static_cast<long long>(a.splits - 1) * a.split_len >= a.t ||
      (a.splits > 1 && a.part == nullptr) || a.stages < 1 ||
      a.stages > kMaxStages || a.heads < 1 || a.heads > a.rows ||
      static_cast<long long>(a.hgroups) * a.heads < a.g ||
      static_cast<long long>(a.hgroups - 1) * a.heads >= a.g ||
      a.teams < 1 || a.teams > kMaxTeams || a.team_warps < 1 ||
      a.teams * a.team_warps > 16 ||
      (tc ? a.tile != kTcTile || a.rows != 16 * a.team_warps
          : (a.tile != 8 && a.tile != 16 && a.tile != 32) || a.g >= 8 ||
                a.team_warps != 1 || a.rows != a.g))
    return static_cast<int>(cudaErrorInvalidValue);
  a.vec = (d * static_cast<int>(sizeof(T))) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.q) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.k) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(a.v) % 16 == 0;

  cudaError_t err;
  if (tc) {
    const int d8 = (d + 7) / 8;
    err = d8 <= 4    ? tc_split<T, 4>(a, stream)
          : d8 <= 8  ? tc_split<T, 8>(a, stream)
          : d8 <= 16 ? tc_split<T, 16>(a, stream)
                     : tc_split<T, 32>(a, stream);
  } else {
    err = a.g <= 1   ? core<T, 1>(a, stream)
          : a.g <= 2 ? core<T, 2>(a, stream)
          : a.g <= 4 ? core<T, 4>(a, stream)
                     : core<T, 8>(a, stream);
  }
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  decode_merge_kernel<T><<<dim3(a.h, a.b), kMergeThreads,
                           2 * a.splits * sizeof(float), stream>>>(
      a.part, static_cast<T*>(a.o), a.splits, a.b, a.h, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int entry(const void* q, const void* k, const void* v, const void* tags,
          const void* index, void* o, void* part, const void* plan,
          int window, float scale, void* stream) {
  Args a{};
  static_cast<Plan&>(a) = *static_cast<const Plan*>(plan);
  a.q = q;
  a.k = k;
  a.v = v;
  a.tags = static_cast<const int*>(tags);
  a.index = static_cast<const int*>(index);
  a.o = o;
  a.part = static_cast<float*>(part);
  a.window = window;
  a.scale = scale;
  return run<T>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// q: (b, 1, h, d); k, v: (b, t, kh, d); tags: (b, t) int32; index: (b,)
// int32; o: (b, 1, h, d); part: (splits, b, h, d + 2) float32 scratch, or
// null when splits = 1; plan: the wrapper's struct Plan for these shapes.
// Runs one kernel, two when splits > 1; returns a CUDA error code (0 on
// success).
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const void* tags,
                                    const void* index, void* o, void* part,
                                    const void* plan, int window,
                                    float scale, void* stream) {
  return entry<float>(q, k, v, tags, index, o, part, plan, window, scale,
                      stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* tags,
                                     const void* index, void* o, void* part,
                                     const void* plan, int window,
                                     float scale, void* stream) {
  return entry<__nv_bfloat16>(q, k, v, tags, index, o, part, plan, window,
                              scale, stream);
}
