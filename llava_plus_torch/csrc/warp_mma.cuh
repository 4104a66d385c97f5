// Warp-level building blocks shared by the decode, paged and int8 matmul
// kernels (sm_80 instructions, built for sm_90a): cp.async copies into
// shared memory, mma.sync m16n8k16 with bf16 operands and f32 sums, bf16
// rounding and packing with integer instructions, and the exact conversion
// of int8 to bf16 without the quarter-rate converter (sm_90: bf16x2 adds).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace warp_mma {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, zero-filled when !pred (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// C[16 x 8] += A[16 x 16] B[16 x 8], bf16 operands, f32 sums. A: a0 = (row g,
// k 2t..2t+1), a1 = (row g + 8, k 2t..), a2 = (row g, k 2t + 8..), a3 = (row
// g + 8, k 2t + 8..); B: b0 = (k 2t..2t+1, col g), b1 = (k 2t + 8.., col g);
// C: (row g, cols 2t, 2t + 1), then row g + 8 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 8 x 8 b16 matrices from shared memory: lane l gives the (16-byte aligned)
// address of row l % 8 of matrix l / 8, and each thread gets (row g, elements
// 2t, 2t + 1) of each matrix: an mma B fragment of a row-major [n][k] tile.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// The same, transposed: each thread gets (rows 2t and 2t + 1, element g) of
// each matrix, row 2t in the low half.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

// bf16(x) rounded to nearest even, as the high half of a word whose low
// half is 0 (so also the f32 bf16(x)); finite x. Integer work only: the
// kernels' conversions would otherwise queue on the quarter-rate converter.
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  uint32_t u = __float_as_uint(x);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return u & 0xFFFF0000u;
}

// Two such words as a bf16 pair (the low half from `lo`).
__device__ __forceinline__ uint32_t pack_hi(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}

// A signed byte (the low byte of `b`, the rest 0) as f32, exactly: the bits
// (b ^ 0x80) | 0x4B000000 are 2^23 + 128 + b. Its bf16 is the high half.
// (The decode kernels' chains run shorter with this than with i8pair_bf16.)
__device__ __forceinline__ uint32_t i8_f32_bits(uint32_t b) {
  return __float_as_uint(__uint_as_float(b ^ 0x4B000080u) - 8388736.f);
}

// Two signed bytes, in bits 0-7 and 16-23 of `r` (its other bits are not
// read), as a bf16 pair, exactly: a byte b is (128 + (b & 127)) + (-128 -
// (b & 128)), two bf16 values made by masking their exponents in (0x4300 |
// b & 127, and 0xC300 | b & 128, which is -128 or -256), whose sum, an
// integer in [-128, 127], the add gives exactly. Three instructions a pair,
// none on the quarter-rate converter.
__device__ __forceinline__ uint32_t i8pair_bf16(uint32_t r) {
  const uint32_t lo = (r & 0x007F007Fu) | 0x43004300u;
  const uint32_t hi = (r & 0x00800080u) | 0xC300C300u;
  uint32_t out;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(out) : "r"(lo), "r"(hi));
  return out;
}

// Byte e (0..3, a constant after unrolling) of two words (rows k and k + 1
// of one column) as the bf16 pair of an mma operand register, the low half
// from row k.
__device__ __forceinline__ uint32_t i8x_pair(uint32_t lo_row, uint32_t hi_row, int e) {
  return i8pair_bf16(__byte_perm(lo_row, hi_row, e | (e << 4) | ((4 + e) << 8) | ((4 + e) << 12)));
}

// Cache rows of 128 elements (a head dim of 128): bytes of a row, the padded
// shared-memory row stride (272 / 144 bytes: the fragment loads below hit
// distinct banks), two consecutive elements of a row as a bf16 pair, four
// consecutive elements of a row as two bf16 pairs (one load), and two
// elements of one column from rows r and r + 1 as a bf16 pair (the low half
// from row r). int8 converts to bf16 exactly, with integer and add
// instructions only.
template <typename CacheT>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int ROW = 128 * 2;
  static constexpr int LDS = ROW + 16;
  __device__ static uint32_t pair(const unsigned char* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ static uint32_t column(const unsigned char* p) {
    const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
    const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + LDS);
    return __byte_perm(lo, hi, 0x5410);
  }
  __device__ static void quad(const unsigned char* p, uint32_t& lo, uint32_t& hi) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    lo = v.x;
    hi = v.y;
  }
};

template <>
struct Elem<int8_t> {
  static constexpr int ROW = 128;
  static constexpr int LDS = ROW + 16;
  __device__ static uint32_t pair(const unsigned char* p) {
    const uint32_t raw = *reinterpret_cast<const uint16_t*>(p);
    return pack_hi(i8_f32_bits(raw & 0xffu), i8_f32_bits(raw >> 8));
  }
  __device__ static uint32_t column(const unsigned char* p) {
    return pack_hi(i8_f32_bits(p[0]), i8_f32_bits(p[LDS]));
  }
  __device__ static void quad(const unsigned char* p, uint32_t& lo, uint32_t& hi) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    lo = i8pair_bf16(__byte_perm(w, 0, 0x4140));   // bytes 0, 1 into bits 0-7, 16-23
    hi = i8pair_bf16(__byte_perm(w, 0, 0x4342));   // bytes 2, 3
  }
};

}  // namespace warp_mma
