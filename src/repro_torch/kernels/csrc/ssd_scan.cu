// Mamba2 SSD chunk scan: the state-space layers of the LM prefill (K5).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py:73
// (ssd_chunked, kernel body _ssd_kernel). For x (B, L, H, P), dt (B, L, H)
// (post-softplus, float32), a (H,) (float32, negative) and B, C (B, L, G,
// N), with head h reading group h / (H / G), the recurrence
//
//   h_t = exp(dt_t a) h_{t-1} + dt_t x_t (outer) B_t,   y_t = h_t . C_t
//
// from a zero state is evaluated chunk by chunk (Mamba2, arXiv:2405.21060,
// Sec. 6). Per chunk c of Q steps, with cums = cumsum(dt a) over the chunk
// and h_c the state entering it:
//
//   S_c   = sum_j exp(cums_Q - cums_j) dt_j x_j (outer) B_j     chunk state
//   h_c+1 = exp(cums_Q) h_c + S_c                               state pass
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cums_i - cums_j) dt_j x_j
//         + exp(cums_i) C_i . h_c                               output
//
// A ragged tail runs with dt = 0 (decay 1, no update), which is exact.
// Returns y (x's type) and the final state (B, H, P, N) in float32. x, B, C
// are float32 or bfloat16; everything is computed in float32.
//
// What bounds it on an H100: per chunk, Q^2 P / 2 multiply-adds for the
// causal half of (C B^T o L)(dt x) and Q P N for the chunk state, for
// each head, and Q P N for C h^T in every chunk but the first (h_0 = 0);
// and Q^2 N / 2 for the causal half of the scores C B^T, which the heads
// of a group share. At the serve path's B = 4, L = 1024, H = 80, G = 1,
// P = N = 64, Q = 256 that is 10.15 GFLOP against about 176 MB moved (x
// and y, B and C, dt once):
//   - on the CUDA cores (67 TFLOP/s float32): 0.152 ms;
//   - on the tensor cores in 3xTF32 (three TF32 passes at 495 TFLOP/s):
//     0.062 ms.
// The memory bound is 0.053 ms. (Counting C B^T once per head, as the
// kernel this replaces computed it, gives 15.48 GFLOP: 0.231 and
// 0.094 ms.) So the products run on the tensor cores at float32
// accuracy, C B^T once per group, and enough blocks run at once to fill
// the card.
//
// Design. The TPU kernel walks the chunks in order on one core, carrying
// the state in VMEM. Here the chunks run in parallel, in three launches
// that need nothing from each other but stream order: no atomics, and no
// block waits for another, so two calls give the same bits. At the serve
// shape that is 1280, 5120 and 5120 blocks, against the one block per
// (b, h) (320) of the kernel this replaces.
// 1. ssd_chunk_state_kernel, one block per (b, h, c, 64-row P tile,
//    64-column N tile), four warps of 32 x 32: the chunk's cums by a warp
//    scan, then S_c as a (P x Q)(Q x N) product over 32-token tiles of x
//    and B that a two-stage cp.async ring brings in; the weights
//    exp(cums_Q - cums_j) dt_j scale x on its way into the A fragment. It
//    writes S_c to the scratch and exp(cums_Q) to `decay`. The blocks of
//    a group's heads also share out the causal 64 x 64 tiles of the
//    chunk's scores C B^T and write them to `scores`.
// 2. ssd_state_pass_kernel, one thread per (b, h, p, n): walks the chunks
//    in order and overwrites each S_c with the state entering chunk c;
//    writes the final state. Memory-bound and small.
// 3. ssd_chunk_out_kernel, one block per (b, h, c, 64-row token tile,
//    64-column P tile), four warps of 16 rows, heaviest row tiles first:
//    exp(cums_i) C h_c^T, then for each 32-token column tile j <= i (the
//    causal half only: a warp skips the 8-token column tiles above its
//    rows, in halves) the scores, scaled by exp(cums_i - cums_j) dt_j (a
//    difference, never a product of exp(cums_i) and exp(-cums_j), which
//    overflows at cums near -500) and masked, times x. The scores and x
//    tiles come through a two-stage cp.async ring.
// Every product runs on mma.sync m16n8k8 in 3xTF32 (tf32_mma.cuh, shared
// with K3); bfloat16 x, B and C are exact in TF32, so their lo passes are
// skipped (C B^T takes one pass there). The scores are read in the C-
// fragment order of an mma and handed to the product with x as its A
// fragment through K3's k-slot permutation, with no shuffle. C, which
// only the carried state needs, goes split into registers for N <= 64 and
// through shared memory above. The loops have no branch per column tile:
// padding columns are zeros in shared memory, and the causal skip has two
// unrolled forms. Every copy is a run of 16-byte cp.async with all
// threads busy. mma.sync and not wgmma: TF32 wgmma reads B only K-major,
// and x stored [token][p] is MN-major in the product with the scores.
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
constexpr int kTile = 64;            // rows and columns of an output tile
constexpr int kLdV = kTile + 4;      // 4 mod 8: rows read at tokens 2t, 2t+1
constexpr int kBT = 32;              // tokens a ring tile, chunk states
constexpr int kBJ = 32;              // tokens a column tile, outputs
constexpr int kLdC = kTile + 8;      // 8 mod 32: C and B rows of the scores
constexpr int kLdS = kBJ + 8;        // 8 mod 32: a tile of the scores
constexpr int kStages = 2;
constexpr int kPassThreads = 256;    // the state pass
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (ex2.approx.ftz.f32: within 2 ulp, 0
// below 2^-126)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Row stride of a tile read as float2 at [row][8 kk + 2t]: 8 or 24 mod 32,
// so a half warp's 8-byte loads (4 rows by 4 lanes) cover all 32 banks
__host__ __device__ constexpr int ld_k(int np) {
  return np + (np % 16 == 0 ? 8 : 0);
}

// N steps of 8 that the output kernel keeps in registers: 8 up to N = 64
// (columns past N are zeros), else 0 (C in shared memory); and N padded
// to what its tiles hold
int ndk_for(int n) { return n <= 64 ? 8 : 0; }
int np_for(int n) {
  const int ndk = ndk_for(n);
  return ndk ? 8 * ndk : (n + 7) / 8 * 8;
}

// Stages rows j0 .. j0 + R - 1 of a [token][column] array (columns 0 ..
// w - 1, `stride` elements apart) into dst [R][ld]; rows at or past q_len
// become zeros. float32 goes by cp.async (16 bytes when vec: 16 threads
// to a row, a float4 each, all threads busy at the full width of 64),
// bfloat16 by plain loads converted to float32.
template <typename T, int R>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          size_t stride, int j0, int q_len,
                                          int w, bool vec, int tid) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec && w == kTile) {               // 16 copies a row
      for (int e = tid; e < R * 16; e += kThreads) {
        const int r = e >> 4;
        const int c = 4 * (e & 15);
        const bool ok = j0 + r < q_len;
        cp_async16(dst + r * ld + c,
                   src + static_cast<size_t>(ok ? j0 + r : 0) * stride + c,
                   ok);
      }
      return;
    }
    if (vec) {
      for (int r = tid / 16; r < R; r += kThreads / 16) {
        const bool ok = j0 + r < q_len;
        const float* row =
            src + static_cast<size_t>(ok ? j0 + r : 0) * stride;
        for (int c = 4 * (tid % 16); c < w; c += 64) {
          cp_async16(dst + r * ld + c, row + c, ok);
        }
      }
      return;
    }
    for (int r = tid / 32; r < R; r += kThreads / 32) {
      const bool ok = j0 + r < q_len;
      const float* row = src + static_cast<size_t>(ok ? j0 + r : 0) * stride;
      for (int c = tid % 32; c < w; c += 32) {
        cp_async4(dst + r * ld + c, row + c, ok);
      }
    }
  } else {
    for (int r = tid / 32; r < R; r += kThreads / 32) {
      const bool ok = j0 + r < q_len;
      const T* row = src + static_cast<size_t>(ok ? j0 + r : 0) * stride;
      for (int c = tid % 32; c < w; c += 32) {
        dst[r * ld + c] = ok ? to_f32(row[c]) : 0.f;
      }
    }
  }
}

// Zeros columns c0 .. c1 - 1 of a [rows][ld] tile
__device__ __forceinline__ void zero_cols(float* tile, int rows, int ld,
                                          int c0, int c1, int tid) {
  const int w = c1 - c0;
  if (w <= 0) return;
  for (int e = tid; e < rows * w; e += kThreads) {
    const int r = e / w;
    tile[r * ld + c0 + (e - r * w)] = 0.f;
  }
}

// cums[q] = sum_{q' <= q} dt_q' a and dts[q] = dt_q for the chunk's steps
// 0 .. len - 1 (len a multiple of 32), with dt = 0 at or past q_len. The
// block loads dt; warp 0 scans. Ends with the block in step.
__device__ __forceinline__ void chunk_cums(float* cums, float* dts,
                                           const float* dtb, int heads,
                                           int q_len, int len, float a_h,
                                           int tid) {
  for (int q = tid; q < len; q += kThreads) {
    dts[q] = q < q_len ? dtb[static_cast<size_t>(q) * heads] : 0.f;
  }
  __syncthreads();
  if (tid < 32) {
    float carry = 0.f;
    for (int q0 = 0; q0 < len; q0 += 32) {
      float v = dts[q0 + tid] * a_h;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, v, off);
        if (tid >= off) v += up;
      }
      v += carry;
      cums[q0 + tid] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
}

// ---- pass 1: the chunk states S_c = (w x)^T B, w_j = exp(cums_Q - cums_j)
// dt_j, for one (b, h, c) and a 64 x 64 (P, N) tile; then this head's share
// of the chunk's scores C B^T
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_state_kernel(const T* __restrict__ x,
                           const float* __restrict__ dt,
                           const float* __restrict__ a,
                           const T* __restrict__ bm,
                           const T* __restrict__ cm,
                           float* __restrict__ states,
                           float* __restrict__ decay,
                           float* __restrict__ scores, int l_len, int heads,
                           int p_dim, int groups, int n_dim, int chunk,
                           int n_chunks, int pt_n, int nt_n, int vec_x,
                           int vec_b) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  constexpr int kStage = 2 * kBT * kLdV;     // x tile, then B tile
  extern __shared__ __align__(16) float smem[];
  const int nt = blockIdx.x % nt_n;
  const int rest = blockIdx.x / nt_n;
  const int pt = rest % pt_n;
  const int c = rest / pt_n;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int base = c * chunk;
  const int q_len = min(chunk, l_len - base);
  const int n_tiles = (q_len + kBT - 1) / kBT;
  const int len = n_tiles * kBT;
  float* cums = smem + kStages * kStage;     // [len]
  float* w_s = cums + len;                   // [len]: dt, then the weights

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int p0 = pt * kTile;
  const int pw = min(kTile, p_dim - p0);
  const int n0 = nt * kTile;
  const int nw = min(kTile, n_dim - n0);
  const int grp = h / (heads / groups);
  const size_t x_row = static_cast<size_t>(heads) * p_dim;
  const size_t b_row = static_cast<size_t>(groups) * n_dim;
  const T* xb = x + (static_cast<size_t>(b) * l_len + base) * x_row +
                static_cast<size_t>(h) * p_dim + p0;
  const T* bb = bm + (static_cast<size_t>(b) * l_len + base) * b_row +
                static_cast<size_t>(grp) * n_dim + n0;
  const float* dtb = dt + (static_cast<size_t>(b) * l_len + base) * heads + h;

  load_rows<T, kBT>(smem, kLdV, xb, x_row, 0, q_len, pw, vec_x, tid);
  load_rows<T, kBT>(smem + kBT * kLdV, kLdV, bb, b_row, 0, q_len, nw, vec_b,
                    tid);
  cp_async_commit();
  for (int s = 0; s < kStages; ++s) {
    zero_cols(smem + s * kStage, kBT, kLdV, pw, kTile, tid);
    zero_cols(smem + s * kStage + kBT * kLdV, kBT, kLdV, nw, kTile, tid);
  }
  chunk_cums(cums, w_s, dtb, heads, q_len, len, a[h], tid);
  const float c_last = cums[q_len - 1];
  for (int q = tid; q < len; q += kThreads) {
    w_s[q] *= exp2_approx((c_last - cums[q]) * kLog2e);
  }
  if (tid == 0 && pt == 0 && nt == 0) {
    decay[(static_cast<size_t>(b) * heads + h) * n_chunks + c] =
        exp2_approx(c_last * kLog2e);
  }

  // warp w owns P rows r0 .. r0 + 31 and N columns c0 .. c0 + 31 of the
  // tile: each B fragment it splits serves two 16-row tiles
  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    }
  }
  const int r0 = (warp >> 1) * 32;
  const int c0 = (warp & 1) * 32;
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      float* nxt = smem + ((it + 1) % kStages) * kStage;
      const int j0 = (it + 1) * kBT;
      load_rows<T, kBT>(nxt, kLdV, xb, x_row, j0, q_len, pw, vec_x, tid);
      load_rows<T, kBT>(nxt + kBT * kLdV, kLdV, bb, b_row, j0, q_len, nw,
                        vec_b, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();                      // tile it has landed
    __syncthreads();
    const float* xs = smem + (it % kStages) * kStage;
    const float* bs = xs + kBT * kLdV;
    const float* wj = w_s + it * kBT;
    if (r0 < pw && c0 < nw) {
#pragma unroll 2
      for (int kk = 0; kk < kBT / 8; ++kk) {
        // A (P x tokens): slot t is token 2t, slot t + 4 token 2t + 1
        const int j = 8 * kk + 2 * t;
        const float w0 = wj[j], w1 = wj[j + 1];
        const float* x0 = xs + j * kLdV + r0 + g;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          split(x0[16 * m] * w0, ah[m][0], al[m][0]);
          split(x0[16 * m + 8] * w0, ah[m][1], al[m][1]);
          split(x0[kLdV + 16 * m] * w1, ah[m][2], al[m][2]);
          split(x0[kLdV + 16 * m + 8] * w1, ah[m][3], al[m][3]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {   // columns past N are zeros
          const float* b0 = bs + j * kLdV + c0 + 8 * n + g;
          uint32_t h0, l0, h1, l1;
          split_b<kExact>(b0[0], h0, l0);
          split_b<kExact>(b0[kLdV], h1, l1);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_3xtf32_b<kExact>(acc[m][n], ah[m], al[m], h0, l0, h1, l1);
          }
        }
      }
    }
    __syncthreads();                         // every warp is done with it
  }

  float* sb = states + ((static_cast<size_t>(b) * heads + h) * n_chunks + c) *
                           p_dim * n_dim;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < 4; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = r0 + 16 * m + g + 8 * (e >> 1);
        const int col = c0 + 8 * n + 2 * t + (e & 1);
        if (p < pw && col < nw) {
          sb[static_cast<size_t>(p0 + p) * n_dim + n0 + col] = acc[m][n][e];
        }
      }
    }
  }

  // The scores C B^T of the chunk, the same for every head of a group: the
  // group's heads share out its causal 64 x 64 tiles (tile k: row tile ri,
  // column tile ci <= ri), each a product over N in 64-wide pieces, warp
  // w on rows 16w .. 16w + 15. Tiles whose rows all lie past the sequence
  // are never read and not computed.
  if (pt != 0 || nt != 0) return;
  const int rep = heads / groups;
  const int n_rt = (chunk + kTile - 1) / kTile;
  const int qp = n_rt * kTile;
  const T* cg = cm + (static_cast<size_t>(b) * l_len + base) * b_row +
                static_cast<size_t>(grp) * n_dim;
  const T* bg = bm + (static_cast<size_t>(b) * l_len + base) * b_row +
                static_cast<size_t>(grp) * n_dim;
  float* so = scores + ((static_cast<size_t>(b) * n_chunks + c) * groups +
                        grp) * qp * qp;
  float* ct = smem;                          // [64][kLdC] C rows
  float* bt = smem + kTile * kLdC;           // [64][kLdC] B rows
  const int rw = warp * 16;
  for (int k = h % rep; k < n_rt * (n_rt + 1) / 2; k += rep) {
    int ri = 0;
    while ((ri + 1) * (ri + 2) / 2 <= k) ++ri;
    const int ci = k - ri * (ri + 1) / 2;
    if (ri * kTile >= q_len) continue;
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
    }
    for (int n0c = 0; n0c < n_dim; n0c += kTile) {
      const int wc = min(kTile, n_dim - n0c);
      __syncthreads();                       // ct, bt are no longer read
      load_rows<T, kTile>(ct, kLdC, cg + n0c, b_row, ri * kTile, q_len, wc,
                          vec_b, tid);
      load_rows<T, kTile>(bt, kLdC, bg + n0c, b_row, ci * kTile, q_len, wc,
                          vec_b, tid);
      cp_async_commit();
      zero_cols(ct, kTile, kLdC, wc, kTile, tid);
      zero_cols(bt, kTile, kLdC, wc, kTile, tid);
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 2
      for (int kk = 0; kk < kTile / 8; ++kk) {
        // A: C rows, slot t column 2t; B slot t: B[8n + g][2t]
        const float2 v0 = *reinterpret_cast<const float2*>(
            ct + (rw + g) * kLdC + 8 * kk + 2 * t);
        const float2 v1 = *reinterpret_cast<const float2*>(
            ct + (rw + g + 8) * kLdC + 8 * kk + 2 * t);
        uint32_t ah[4], al[4];
        split(v0.x, ah[0], al[0]);
        split(v1.x, ah[1], al[1]);
        split(v0.y, ah[2], al[2]);
        split(v1.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 bv = *reinterpret_cast<const float2*>(
              bt + (8 * n + g) * kLdC + 8 * kk + 2 * t);
          if constexpr (kExact) {
            mma_exact_a<true>(sc[n], ah, bv.x, bv.y);
          } else {
            mma_3xtf32<false>(sc[n], ah, al, bv.x, bv.y);
          }
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = ri * kTile + rw + g + 8 * (e >> 1);
        const int j = ci * kTile + 8 * n + 2 * t + (e & 1);
        so[static_cast<size_t>(i) * qp + j] = sc[n][e];
      }
    }
  }
}

// ---- pass 2: for each (b, h) and element (p, n), in chunk order,
// states[c] <- the state entering chunk c; state <- the final state
__global__ void __launch_bounds__(kPassThreads)
    ssd_state_pass_kernel(float* __restrict__ states,
                          const float* __restrict__ decay,
                          float* __restrict__ state, int pn, int n_chunks) {
  const int e = blockIdx.y * kPassThreads + threadIdx.x;
  if (e >= pn) return;
  const size_t bh = blockIdx.x;
  float* s = states + bh * n_chunks * pn + e;
  const float* d = decay + bh * n_chunks;
  float hc = 0.f;
  float next = s[0];
  for (int c = 0; c < n_chunks; ++c) {
    const float sc = next;
    if (c + 1 < n_chunks) next = s[static_cast<size_t>(c + 1) * pn];
    s[static_cast<size_t>(c) * pn] = hc;
    hc = d[c] * hc + sc;
  }
  state[bh * pn + e] = hc;
}

// ---- pass 3: y for one (b, h, c), 64 tokens of the chunk and 64 of P
template <typename T, int NDK>
__global__ void __launch_bounds__(kThreads, 3)
    ssd_chunk_out_kernel(const T* __restrict__ x,
                         const float* __restrict__ dt,
                         const float* __restrict__ a,
                         const T* __restrict__ cm,
                         const float* __restrict__ states,
                         const float* __restrict__ scores,
                         T* __restrict__ y, int batch, int l_len, int heads,
                         int p_dim, int groups, int n_dim, int chunk,
                         int n_chunks, int n_rt, int pt_n, int vec_x,
                         int vec_h) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  constexpr bool kCRegs = NDK > 0;
  constexpr int kNJ = kBJ / 8;               // 8-token column tiles
  constexpr int kStage = kTile * kLdS + kBJ * kLdV;   // scores, then x
  using Full = std::integral_constant<int, kNJ>;
  using Half = std::integral_constant<int, kNJ / 2>;
  extern __shared__ __align__(16) float smem[];

  // heaviest row tiles first: the row tile is the slowest index, reversed
  int rest = blockIdx.x;
  const int h = rest % heads;
  rest /= heads;
  const int pt = rest % pt_n;
  rest /= pt_n;
  const int c = rest % n_chunks;
  rest /= n_chunks;
  const int b = rest % batch;
  const int rt = n_rt - 1 - rest / batch;
  const int base = c * chunk;
  const int q_len = min(chunk, l_len - base);
  const int row0 = rt * kTile;               // first token of the row tile
  if (row0 >= q_len) return;

  const int np = kCRegs ? 8 * NDK : (n_dim + 7) / 8 * 8;
  const int nk = np / 8;
  const int ldk = ld_k(np);
  const int qp = n_rt * kTile;
  // C [64][ldk] when not in regs; h_c [64][ldk], in ring stage 1 when C
  // is in regs (N <= 64), which the ring takes back after the carried
  // state is added
  float* c_s = smem + kStages * kStage;
  float* h_s = kCRegs ? smem + kStage : c_s + kTile * ldk;
  float* cums = c_s + (kCRegs ? 0 : 2 * kTile * ldk);   // [row0 + 64]
  float* dts = cums + row0 + kTile;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = warp * 16;                  // the warp's rows in the tile
  const int p0 = pt * kTile;
  const int pw = min(kTile, p_dim - p0);
  const int grp = h / (heads / groups);
  const size_t x_row = static_cast<size_t>(heads) * p_dim;
  const size_t c_row = static_cast<size_t>(groups) * n_dim;
  const size_t tok = static_cast<size_t>(b) * l_len + base;
  const T* xb = x + tok * x_row + static_cast<size_t>(h) * p_dim + p0;
  const T* cb = cm + tok * c_row + static_cast<size_t>(grp) * n_dim;
  T* yb = y + tok * x_row + static_cast<size_t>(h) * p_dim + p0;
  const float* dtb = dt + tok * heads + h;
  // the chunk's scores, rows row0 .. row0 + 63 (all inside qp)
  const float* sg = scores + ((static_cast<size_t>(b) * n_chunks + c) *
                                  groups + grp) * qp * qp;
  const int rows_end = min(q_len, row0 + kTile);
  const int n_jt = (rows_end + kBJ - 1) / kBJ;

  // the scores of tokens j0 .. j0 + kBJ - 1 for the tile's rows, and x
  auto copy_tile = [&](float* st, int j0) {
    constexpr int kPerRow = kBJ / 4;         // 16-byte copies a row
    for (int e = tid; e < kTile * kPerRow; e += kThreads) {
      const int r = e / kPerRow;
      const int c4 = 4 * (e % kPerRow);
      cp_async16(st + r * kLdS + c4,
                 sg + static_cast<size_t>(row0 + r) * qp + j0 + c4, true);
    }
    load_rows<T, kBJ>(st + kTile * kLdS, kLdV, xb, x_row, j0, q_len, pw,
                      vec_x, tid);
  };
  copy_tile(smem, 0);
  cp_async_commit();
  if (c > 0) {       // rows p of h_c; rows past P become zeros
    const float* hs = states +
                      ((static_cast<size_t>(b) * heads + h) * n_chunks + c) *
                          p_dim * n_dim +
                      static_cast<size_t>(p0) * n_dim;
    load_rows<float, kTile>(h_s, ldk, hs, n_dim, 0, pw, n_dim, vec_h, tid);
  }
  cp_async_commit();
  // padding columns: N .. Np - 1 of h_c (summed over) and pw .. 63 of x
  // (stage 1's once h_c has left it)
  auto zero_x_pad = [&](int s) {
    zero_cols(smem + s * kStage + kTile * kLdS, kBJ, kLdV, pw, kTile, tid);
  };
  zero_x_pad(0);
  if (c > 0) {
    zero_cols(h_s, kTile, ldk, n_dim, np, tid);
  }
  if (!kCRegs || c == 0) zero_x_pad(1);
  chunk_cums(cums, dts, dtb, heads, q_len, row0 + kTile, a[h], tid);

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  const int i0 = row0 + r0 + g;              // this lane's rows i0, i0 + 8
  const float ci0 = cums[i0];
  const float ci1 = cums[i0 + 8];

  // carried state: exp(cums_i) C_i . h_c (h_0 = 0: nothing to add). C in
  // A-fragment order: slot i of step kk is row g + 8 (i & 1), state column
  // 8 kk + 2t + (i >> 1); h_c's B slot t is h_c[8n + g][8kk + 2t], slot
  // t + 4 the next column
  if (c > 0) {
    auto c_frag = [&](int kk, uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = i0 + 8 * (i & 1);
        const int col = 8 * kk + 2 * t + (i >> 1);
        float v;
        if constexpr (kCRegs) {
          v = q < q_len && col < n_dim
                  ? to_f32(cb[static_cast<size_t>(q) * c_row + col])
                  : 0.f;
        } else {
          v = c_s[(q - row0) * ldk + col];
        }
        split(v, ah[i], al[i]);
      }
    };
    auto carried = [&](int kk, const uint32_t (&ah)[4],
                       const uint32_t (&al)[4]) {
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 v = *reinterpret_cast<const float2*>(
            h_s + (8 * n + g) * ldk + 8 * kk + 2 * t);
        if constexpr (kExact) {
          mma_exact_a<false>(acc[n], ah, v.x, v.y);
        } else {
          mma_3xtf32<false>(acc[n], ah, al, v.x, v.y);
        }
      }
    };
    if constexpr (kCRegs) {
      uint32_t ch[NDK][4], cl[NDK][4];
#pragma unroll
      for (int kk = 0; kk < NDK; ++kk) c_frag(kk, ch[kk], cl[kk]);
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < NDK; ++kk) carried(kk, ch[kk], cl[kk]);
    } else {
      for (int e = tid; e < kTile * np; e += kThreads) {
        const int r = e / np;
        const int col = e - r * np;
        const int q = row0 + r;
        c_s[r * ldk + col] =
            q < q_len && col < n_dim
                ? to_f32(cb[static_cast<size_t>(q) * c_row + col])
                : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll 1
      for (int kk = 0; kk < nk; ++kk) {
        uint32_t ah[4], al[4];
        c_frag(kk, ah, al);
        carried(kk, ah, al);
      }
    }
    if constexpr (kCRegs) {
      __syncthreads();                       // h_c has left ring stage 1
      zero_x_pad(1);
    }
    const float e0 = exp2_approx(ci0 * kLog2e);
    const float e1 = exp2_approx(ci1 * kLog2e);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      acc[n][0] *= e0;
      acc[n][1] *= e0;
      acc[n][2] *= e1;
      acc[n][3] *= e1;
    }
  }

  // the column tile at token j0 for this warp's rows, its first NSUB
  // 8-token column tiles (the rest lie above the warp's rows): the scores
  // S, S <- S exp(cums_i - cums_j) dt_j where j <= i (else 0), then
  // y += S x, S's C-fragment order (c0, c2, c1, c3) being the A fragment
  // under the permuted k slots (B slot t: x[8jj + 2t], t + 4: the next)
  auto column_tile = [&](auto nsub, const float* ss, const float* xs,
                         int j0) {
    constexpr int NSUB = decltype(nsub)::value;
#pragma unroll
    for (int jj = 0; jj < NSUB; ++jj) {
      const int j = j0 + 8 * jj + 2 * t;     // this lane's tokens j, j + 1
      const float2 cj = *reinterpret_cast<const float2*>(cums + j);
      const float2 dj = *reinterpret_cast<const float2*>(dts + j);
      const float2 s0 = *reinterpret_cast<const float2*>(
          ss + (r0 + g) * kLdS + 8 * jj + 2 * t);
      const float2 s1 = *reinterpret_cast<const float2*>(
          ss + (r0 + g + 8) * kLdS + 8 * jj + 2 * t);
      float sv[4] = {s0.x, s0.y, s1.x, s1.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * (e >> 1);
        const float ci = e >> 1 ? ci1 : ci0;
        const float c_j = e & 1 ? cj.y : cj.x;
        const float d_j = e & 1 ? dj.y : dj.x;
        sv[e] = j + (e & 1) <= i
                    ? sv[e] * (exp2_approx((ci - c_j) * kLog2e) * d_j)
                    : 0.f;
      }
      uint32_t sh[4], sl[4];
      split(sv[0], sh[0], sl[0]);
      split(sv[2], sh[1], sl[1]);
      split(sv[1], sh[2], sl[2]);
      split(sv[3], sh[3], sl[3]);
      const float* xr = xs + (8 * jj + 2 * t) * kLdV + g;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mma_3xtf32<kExact>(acc[n], sh, sl, xr[8 * n], xr[kLdV + 8 * n]);
      }
    }
  };

  for (int jt = 0; jt < n_jt; ++jt) {
    if (jt + 1 < n_jt) copy_tile(smem + ((jt + 1) % kStages) * kStage,
                                 (jt + 1) * kBJ);
    cp_async_commit();
    cp_async_wait<1>();                      // tile jt has landed
    __syncthreads();
    const float* ss = smem + (jt % kStages) * kStage;
    const float* xs = ss + kTile * kLdS;
    const int j0 = jt * kBJ;
    // 8-token column tile n holds a token j <= some row of the warp iff
    // 8 n <= lim: all of them, the first half, or none
    const int lim = row0 + r0 + 15 - j0;
    if (lim >= 8 * (kNJ / 2)) {
      column_tile(Full{}, ss, xs, j0);
    } else if (lim >= 0) {
      column_tile(Half{}, ss, xs, j0);
    }
    __syncthreads();                         // every warp is done with it
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = i0 + 8 * i;
    if (q >= q_len) continue;
    T* yr = yb + static_cast<size_t>(q) * x_row;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < pw) store(yr + col, acc[n][2 * i]);
      if (col + 1 < pw) store(yr + col + 1, acc[n][2 * i + 1]);
    }
  }
}

// Shared memory, in bytes, of the chunk-state and the output kernels
size_t state_smem_bytes(int chunk) {
  const size_t len = (chunk + kTile - 1) / kTile * kTile;
  const size_t ring = kStages * 2 * kBT * kLdV;
  const size_t tiles = 2 * kTile * kLdC;     // C and B rows of the scores
  return sizeof(float) * ((ring > tiles ? ring : tiles) + 2 * len);
}
size_t out_smem_bytes(int n, int chunk) {
  const bool regs = ndk_for(n) > 0;
  const size_t ldk = ld_k(np_for(n));
  const size_t len = (chunk + kTile - 1) / kTile * kTile;
  const size_t stage = kTile * kLdS + kBJ * kLdV;
  return sizeof(float) *
         (kStages * stage + (regs ? 0 : 2 * kTile * ldk) + 2 * len);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The pointers of one call, as the C entry points take them
struct Args {
  const void *x, *dt, *a, *bm, *cm;
  void *y, *state, *states, *decay, *scores;
};

template <typename T, int NDK>
int launch(const Args& v, int b, int l, int h, int p, int g, int n,
           int chunk, cudaStream_t stream) {
  auto k_state = ssd_chunk_state_kernel<T>;
  auto k_out = ssd_chunk_out_kernel<T, NDK>;
  static std::atomic<unsigned long long> ready_state{0}, ready_out{0};
  cudaError_t err = allow_smem_once(k_state, ready_state);
  if (err == cudaSuccess) err = allow_smem_once(k_out, ready_out);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = (l + chunk - 1) / chunk;
  const int pt_n = (p + kTile - 1) / kTile;
  const int nt_n = (n + kTile - 1) / kTile;
  const int n_rt = (chunk + kTile - 1) / kTile;
  const int pn = p * n;
  const long long state_blocks =
      static_cast<long long>(n_chunks) * pt_n * nt_n;
  const long long out_blocks =
      static_cast<long long>(n_rt) * b * n_chunks * pt_n * h;
  const int pass_blocks = (pn + kPassThreads - 1) / kPassThreads;
  if (state_blocks > INT_MAX || out_blocks > INT_MAX || h > 65535 ||
      b > 65535 || pass_blocks > 65535 ||
      static_cast<long long>(b) * h > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int vec_x = p % 4 == 0 && aligned16(v.x);
  const int vec_b = n % 4 == 0 && aligned16(v.bm) && aligned16(v.cm);
  const int vec_h = n % 4 == 0 && aligned16(v.states);

  k_state<<<dim3(static_cast<unsigned>(state_blocks), h, b), kThreads,
            state_smem_bytes(chunk), stream>>>(
      static_cast<const T*>(v.x), static_cast<const float*>(v.dt),
      static_cast<const float*>(v.a), static_cast<const T*>(v.bm),
      static_cast<const T*>(v.cm), static_cast<float*>(v.states),
      static_cast<float*>(v.decay), static_cast<float*>(v.scores), l, h, p,
      g, n, chunk, n_chunks, pt_n, nt_n, vec_x, vec_b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  ssd_state_pass_kernel<<<dim3(b * h, pass_blocks), kPassThreads, 0,
                          stream>>>(
      static_cast<float*>(v.states), static_cast<const float*>(v.decay),
      static_cast<float*>(v.state), pn, n_chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  k_out<<<static_cast<unsigned>(out_blocks), kThreads,
          out_smem_bytes(n, chunk), stream>>>(
      static_cast<const T*>(v.x), static_cast<const float*>(v.dt),
      static_cast<const float*>(v.a), static_cast<const T*>(v.cm),
      static_cast<const float*>(v.states), static_cast<const float*>(v.scores),
      static_cast<T*>(v.y), b, l, h, p, g, n, chunk, n_chunks, n_rt, pt_n,
      vec_x, vec_h);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Args& v, int b, int l, int h, int p, int g, int n,
             int chunk, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return ndk_for(n) ? launch<T, 8>(v, b, l, h, p, g, n, chunk, st)
                    : launch<T, 0>(v, b, l, h, p, g, n, chunk, st);
}

}  // namespace

// Shared memory the kernels need for these widths, in bytes (the larger
// of the chunk-state and the output kernel).
extern "C" long long ssd_chunk_scan_smem_bytes(int p, int n, int chunk) {
  (void)p;
  const size_t s = state_smem_bytes(chunk);
  const size_t o = out_smem_bytes(n, chunk);
  return static_cast<long long>(s > o ? s : o);
}

// x: (b, l, h, p); dt: (b, l, h) float32; a: (h,) float32; bm, cm:
// (b, l, g, n); y: (b, l, h, p); state: (b, h, p, n) float32; float32
// scratch, with nc = ceil(l / chunk) and qp = chunk rounded up to 64:
// states (b, h, nc, p, n), decay (b, h, nc) and scores (b, nc, g, qp, qp).
// All contiguous; x, bm, cm and y of one type; chunk <= l.
// Launches three kernels on `stream`; returns the first CUDA error code
// (0 on success).
extern "C" int ssd_chunk_scan_f32(const void* x, const void* dt,
                                  const void* a, const void* bm,
                                  const void* cm, void* y, void* state,
                                  void* states, void* decay, void* scores,
                                  int b, int l, int h, int p, int g, int n,
                                  int chunk, void* stream) {
  return dispatch<float>({x, dt, a, bm, cm, y, state, states, decay, scores},
                         b, l, h, p, g, n, chunk, stream);
}

extern "C" int ssd_chunk_scan_bf16(const void* x, const void* dt,
                                   const void* a, const void* bm,
                                   const void* cm, void* y, void* state,
                                   void* states, void* decay, void* scores,
                                   int b, int l, int h, int p, int g, int n,
                                   int chunk, void* stream) {
  return dispatch<__nv_bfloat16>(
      {x, dt, a, bm, cm, y, state, states, decay, scores}, b, l, h, p, g, n,
      chunk, stream);
}
