// Tensor-core helpers of fk_kernels.cu: one warp-wide
// mma.sync.aligned.m16n8k16 with f32 accumulation on bf16 or fp16
// operands and one m16n8k32 with s32 accumulation on s8 operands, the
// 32-bit shared-memory load of a fragment register (two 2-byte values),
// ldmatrix (four 8 x 16-byte matrices), the widening of an input value to
// f32, and the split of an f32 into three 2-byte parts.
//
// Fragment layout of m16n8k16 (PTX ISA, "mma.m16n8k16"), lane = 4 g + t:
//   A (16 x 16, row-major)    a[0]: row g,     k 2t, 2t+1    a[1]: row g + 8
//                             a[2]: row g,     k 2t+8, 2t+9  a[3]: row g + 8
//   B (16 x 8, column-major)  b0:   col g,     k 2t, 2t+1    b1:   k 2t+8, 2t+9
//   C (16 x 8, f32)           c[0], c[1]: row g, cols 2t, 2t+1
//                             c[2], c[3]: row g + 8, the same cols
// Products of two bf16 or two fp16 values are exact in f32; the sum of a
// k-step runs in the tensor core's own order, the same on every launch.
//
// Fragment layout of m16n8k32 on s8 (PTX ISA, "mma.m16n8k32"), four
// values a register, the lowest k in the lowest byte:
//   A (16 x 32, row-major)    a[0]: row g,     k 4t .. 4t+3
//                             a[1]: row g + 8, k 4t .. 4t+3
//                             a[2]: row g,     k 4t+16 .. 4t+19
//                             a[3]: row g + 8, k 4t+16 .. 4t+19
//   B (32 x 8, column-major)  b0:   col g,     k 4t .. 4t+3
//                             b1:   col g,     k 4t+16 .. 4t+19
//   C (16 x 8, s32)           as m16n8k16's
// Every product and sum is an exact integer while it stays below 2^31, so
// the order of the sums does not matter. A row-major tile whose rows hold
// the k values in order (K-major, as X's and C's rows) gives each register
// as one 32-bit word: ldmatrix's lane 4 g + t receives word t of row g of
// each 8 x 16-byte matrix it loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cstdint>

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_f16(float* c, const uint32_t* a,
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A B on s8 operands, s32 accumulation (exact)
__device__ __forceinline__ void mma_s8_16832(int* c, const uint32_t* a,
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 16-byte matrices from shared memory: lanes 8 i .. 8 i + 7 give
// the row addresses (16-byte aligned) of matrix i, r[i] its fragment
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// c += A B for the operand type T (__nv_bfloat16 or __half)
template <typename T>
__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a,
                                          uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(
    float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  mma_bf16(c, a, b0, b1);
}
template <>
__device__ __forceinline__ void mma_16816<__half>(
    float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  mma_f16(c, a, b0, b1);
}

// two consecutive 2-byte values (4-byte aligned) as one fragment register
template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// round to nearest into the operand type T (__nv_bfloat16 or __half)
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32(float v) {
  return __float2half_rn(v);
}

// v = hi + mid + lo in three T values, each rounded to nearest from what
// the earlier ones leave (fk_abft_gemm.cu's split of E_Y)
template <typename T>
__device__ __forceinline__ void split3(float v, T& hi, T& mid, T& lo) {
  hi = from_f32<T>(v);
  const float r = v - to_f32(hi);
  mid = from_f32<T>(r);
  lo = from_f32<T>(r - to_f32(mid));
}
