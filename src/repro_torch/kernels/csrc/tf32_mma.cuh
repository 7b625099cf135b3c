// Float32 products on Hopper's TF32 tensor cores, and asynchronous copies.
//
// Shared by the flash-attention (K3) and SSD chunk-scan (K5) kernels.
//
// 3xTF32. A product runs on mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32.
// Each operand x is split into hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest with ties away (the rounding of cvt.rna.tf32.f32,
// done here as two integer ops: add 0x1000 to the bits and clear the low
// 13), and a product is lo*hi + hi*lo + hi*hi, small terms first, as
// CUTLASS's OpMultiplyAddFastF32 does. It drops only lo*lo, about 2^-22
// of the product; one TF32 pass keeps about 2^-11, which misses a float32
// tolerance. A bfloat16 value is exact in TF32 (lo = 0), so its lo pass
// is skipped.
//
// Fragments (PTX ISA, "Matrix Fragments for mma.m16n8k8", .tf32): lane
// (g = lane / 4, t = lane % 4) holds A at rows g, g + 8 and k slots t,
// t + 4, B at k slots t, t + 4 and column g, and C at rows g, g + 8 and
// columns 2t, 2t + 1. The k index of a product is summed over, so a
// kernel may let k slot t stand for element 2t and slot t + 4 for element
// 2t + 1 of every step of 8; then a C fragment (c0, c2, c1, c3) is the A
// fragment of the next product as it stands.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 2^-22 of x, both TF32 values
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a b on the tensor cores: A 16x8, B 8x8, TF32 in, float32 out
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B's hi and lo (lo = 0 when B is exact in TF32: bfloat16 inputs)
template <bool kExactB>
__device__ __forceinline__ void split_b(float b, uint32_t& hi,
                                        uint32_t& lo) {
  if constexpr (kExactB) {
    hi = __float_as_uint(b);
    lo = 0u;
  } else {
    split(b, hi, lo);
  }
}

// c += a b in 3xTF32 (lo*hi + hi*lo + hi*hi) with B split already, as
// (h0, l0) and (h1, l1); B's lo pass is skipped when B is exact in TF32
template <bool kExactB>
__device__ __forceinline__ void mma_3xtf32_b(float (&c)[4],
                                             const uint32_t (&a_hi)[4],
                                             const uint32_t (&a_lo)[4],
                                             uint32_t h0, uint32_t l0,
                                             uint32_t h1, uint32_t l1) {
  mma_tf32(c, a_lo, h0, h1);
  if constexpr (!kExactB) mma_tf32(c, a_hi, l0, l1);
  mma_tf32(c, a_hi, h0, h1);
}

// c += a b in 3xTF32, B given as floats
template <bool kExactB>
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split_b<kExactB>(b0, h0, l0);
  split_b<kExactB>(b1, h1, l1);
  mma_3xtf32_b<kExactB>(c, a_hi, a_lo, h0, l0, h1, l1);
}

// c += a b where A is exact in TF32 (its lo is zero): hi*lo + hi*hi, or
// hi*hi alone when B is exact too
template <bool kExactB>
__device__ __forceinline__ void mma_exact_a(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            float b0, float b1) {
  if constexpr (kExactB) {
    mma_tf32(c, a, __float_as_uint(b0), __float_as_uint(b1));
  } else {
    uint32_t h0, l0, h1, l1;
    split(b0, h0, l0);
    split(b1, h1, l1);
    mma_tf32(c, a, l0, l1);
    mma_tf32(c, a, h0, h1);
  }
}

// Asynchronous copies global -> shared; src_size 0 zero-fills the slot
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
