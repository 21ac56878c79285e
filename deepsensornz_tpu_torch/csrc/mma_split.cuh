// Split-precision tensor-core products shared by the SetConv kernels (sm_90a).
//
// Both SetConv kernels must agree with their plain f32 versions to
// 1e-4 relative, over sums of hundreds of RBF-weighted terms. One pass of
// TF32 (10 stored mantissa bits) or bf16 (7) does not, so every product
// runs as a sum of exact partial products with f32 accumulation:
//   - 3xTF32: x = hi + lo with hi = tf32(x), lo = tf32(x - hi);
//     a*b ~ hi(a)hi(b) + hi(a)lo(b) + lo(a)hi(b), dropping the 2^-22 term.
//   - bf16x3: x = hi + mid + lo, each a bf16 of the remainder (24 bits in
//     all); against a bf16-exact operand every partial product is exact.
// The small terms are issued first so they are not lost against a large
// partial sum. The mma asm is not volatile: it only reads and writes
// registers, so the compiler may interleave independent products.
//
// Fragment layouts are those of mma.sync (PTX ISA, "Matrix fragments for
// mma.m16n8k16 / m16n8k8"); with g = lane / 4 and q = lane % 4:
//   C (16x8 f32):       c0 (g, 2q)  c1 (g, 2q+1)  c2 (g+8, 2q)  c3 (g+8, 2q+1)
//   A tf32 (16x8):      a0 (g, q)   a1 (g+8, q)   a2 (g, q+4)   a3 (g+8, q+4)
//   B tf32 (8x8):       b0 (q, g)   b1 (q+4, g)
//   A bf16 (16x16):     a0 (g, 2q..2q+1)  a1 (g+8, 2q..)  a2 (g, 2q+8..)  a3 (g+8, 2q+8..)
//   B bf16 (16x8):      b0 (2q..2q+1, g)  b1 (2q+8..2q+9, g)
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace setconv {

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (+ a remainder below 2^-22 |x|), both TF32-exact.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// x = hi + mid + lo (+ a remainder below 2^-24 |x|), each a bf16.
__device__ __forceinline__ void split_bf16x3(float x, __nv_bfloat16& hi, __nv_bfloat16& mid,
                                             __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  float r = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  r -= __bfloat162float(mid);
  lo = __float2bfloat16_rn(r);
}

// Two bf16 in one register, the first in the low half (the lower k index).
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 first, __nv_bfloat16 second) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(first)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(second)) << 16);
}

// d += a * b, m16n8k16, bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b, m16n8k8, TF32 operands, f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b at f32 accuracy from TF32 halves: lo*hi, hi*lo, then hi*hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], uint32_t b0_hi,
                                           uint32_t b1_hi, uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32(d, a_lo, b0_hi, b1_hi);
  mma_tf32(d, a_hi, b0_lo, b1_lo);
  mma_tf32(d, a_hi, b0_hi, b1_hi);
}

// Four 8x8 b16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

}  // namespace setconv
