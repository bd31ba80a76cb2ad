// Tensor-core pieces shared by flash_attention.cu and matmul.cu (bf16),
// conv1d.cu, fused_stream.cu, ssd_scan.cu and flash_attention.cu (TF32)
// and fused_stream.cu and matmul.cu (int8), with the operand loads of
// matmul.cu's decode and int8 routes (ldmatrix, the byte transpose, the
// streaming 16-byte load).
//
// One warp-wide mma.sync.m16n8k16 (bf16 x bf16 -> f32): D[16x8] += A[16x16]
// B[16x8].  With g = lane / 4 and t = lane % 4, each thread holds
//
//   A (row-major)  a0: (g,   2t..2t+1)   a1: (g+8, 2t..2t+1)
//                  a2: (g,   2t+8..+9)   a3: (g+8, 2t+8..+9)
//   B (k x n)      b0: (k = 2t..2t+1, n = g)   b1: (k = 2t+8..+9, n = g)
//   C/D (f32)      d0, d1: (g, 2t..2t+1)       d2, d3: (g+8, 2t..2t+1)
//
// each 32-bit A/B register packing two bf16, the lower k index in the low
// half (PTX ISA, "Matrix Fragments for mma.m16n8k16").
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even) in one register, lo in the low
// half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two bf16 values from anywhere, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16_bits(__nv_bfloat16 lo,
                                                   __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Two consecutive bf16 (4-byte aligned) as one register.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// One warp-wide mma.sync.m16n8k8 (tf32 x tf32 -> f32): D[16x8] += A[16x8]
// B[8x8].  With g = lane / 4 and t = lane % 4, each thread holds
//
//   A (row-major)  a0: (g, t)   a1: (g+8, t)   a2: (g, t+4)   a3: (g+8, t+4)
//   B (k x n)      b0: (k = t, n = g)          b1: (k = t+4, n = g)
//   C/D (f32)      as in m16n8k16: d0, d1 (g, 2t..2t+1), d2, d3 (g+8, ...)
//
// each register one tf32 value in fp32 bits with the 13 low mantissa bits
// zero (PTX ISA, "Matrix Fragments for mma.m16n8k8", .tf32).
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v rounded to tf32 (10 explicit mantissa bits), to nearest with ties away
// from zero: kernels/ref.py split_tf32 emulates it.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// The 3xTF32 split v = hi + lo: hi = tf32(v), lo = tf32(v - hi).  v - hi is
// exact in fp32, so hi + lo is v to within 2^-22 of |v|.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// The same split by integer adds and masks, bit for bit (cvt.rna rounds the
// magnitude half up at bit 13: add 0x1000, clear the 13 low bits; finite
// values cannot carry into the sign).  A conversion runs at a quarter of
// the integer rate on this card.
__device__ __forceinline__ void split_tf32_int(float v, uint32_t& hi,
                                               uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = (__float_as_uint(v - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

// An operand value as TF32: split hi + lo when it may not be exact in TF32,
// else its own bits (a widened bf16 or f16 value) and no lo term.  Shared
// by ssd_scan.cu and flash_attention.cu's 3xTF32 kernels.
template <bool SPLIT>
__device__ __forceinline__ void tf32_parts(float v, uint32_t& hi,
                                           uint32_t& lo) {
  if constexpr (SPLIT) {
    split_tf32_int(v, hi, lo);
  } else {
    hi = __float_as_uint(v);
    lo = 0u;
  }
}

// The A fragment (16 x 8, row-major, leading dimension ld) whose thread
// element (g, t4) is at p.
template <bool SPLIT>
__device__ __forceinline__ void load_a(const float* p, int ld,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  tf32_parts<SPLIT>(p[0], hi[0], lo[0]);            // (g,     t4)
  tf32_parts<SPLIT>(p[8 * ld], hi[1], lo[1]);       // (g + 8, t4)
  tf32_parts<SPLIT>(p[4], hi[2], lo[2]);            // (g,     t4 + 4)
  tf32_parts<SPLIT>(p[8 * ld + 4], hi[3], lo[3]);   // (g + 8, t4 + 4)
}

// d += A B in the terms the split operands need, small ones first:
// lo_a hi_b, hi_a lo_b, hi_a hi_b (an exact operand has no lo term).
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], uint32_t bh0,
                                          uint32_t bh1, uint32_t bl0,
                                          uint32_t bl1) {
  if constexpr (!A_EXACT) mma_tf32_1688(d, al, bh0, bh1);
  if constexpr (!B_EXACT) mma_tf32_1688(d, ah, bl0, bl1);
  mma_tf32_1688(d, ah, bh0, bh1);
}

// One warp-wide mma.sync.m16n8k32 (s8 x s8 -> s32, exact): D[16x8] +=
// A[16x32] B[32x8].  With g = lane / 4 and t = lane % 4, each thread holds
//
//   A (row-major)  a0: (g, 4t..4t+3)        a1: (g+8, 4t..4t+3)
//                  a2: (g, 4t+16..4t+19)    a3: (g+8, 4t+16..4t+19)
//   B (k x n)      b0: (k = 4t..4t+3, n = g)   b1: (k = 4t+16..4t+19, n = g)
//   C/D (s32)      as the f32 layouts above: d0, d1 (g, 2t..2t+1), d2, d3
//                  (g+8, ...)
//
// each A/B register packing four int8, the lowest k in the low byte (PTX
// ISA, "Matrix Fragments for mma.m16n8k32").
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix.x4: four 8 x 8 matrices of 16-bit elements from shared memory;
// lanes 8i .. 8i + 7 give the row addresses of matrix i (16 bytes each),
// and register i of each thread holds its (row lane / 4, elements 2 (lane %
// 4) .. + 1) of matrix i: the A fragment of mma.m16n8k16 (bf16) and, read
// as bytes, of mma.m16n8k32 (s8).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// The 4 x 4 byte transpose: r[i] holds row i's four bytes (column j in
// byte j); afterwards c[j] holds column j's four bytes (row i in byte i).
// An int8 (K, N) row-major operand read as words along N becomes words
// along K, the s8 fragments' order.
__device__ __forceinline__ void transpose4x4_bytes(uint32_t r0, uint32_t r1,
                                                   uint32_t r2, uint32_t r3,
                                                   uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// 16 bytes of a stream read once (weights): read-only, not kept in L1.
__device__ __forceinline__ uint4 ld_stream16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Asks L2 for the line holding p (no register, no wait): the decode
// kernels' rows a few steps ahead of their loads.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}
