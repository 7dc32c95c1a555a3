// Helpers shared by the flash attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_bwd_kv.cu): the masking and base-2 constants, bf16 <-> fp32 bit
// conversions, bf16 packing, and for the mma.sync kernels the m16n8k16
// tensor-core product and the two ways of reading a pair of bf16 values out
// of a row-major tile in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace moka_flash {

constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ uint32_t float_to_bf16_bits(float f) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
}

// two fp32 -> one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return float_to_bf16_bits(lo) | (float_to_bf16_bits(hi) << 16);
}

// two packed bf16 values, each multiplied by s and rounded to bf16
__device__ __forceinline__ uint32_t scale_pair(uint32_t raw, float s) {
  return pack_bf16(bf16_bits_to_float(raw & 0xffffu) * s,
                   bf16_bits_to_float(raw >> 16) * s);
}

// D += A * B, m16n8k16, A row-major bf16, B col-major bf16, fp32 accumulate.
// Fragments (lane = 4 g + t): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
// a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; b0 = B[2t..2t+1][g],
// b1 = B[2t+8..2t+9][g]; d0 = D[g][2t], d1 = D[g][2t+1], d2 = D[g+8][2t],
// d3 = D[g+8][2t+1].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// t[r][c], t[r][c+1] of a row-major tile with row length ld (one 32-bit load)
__device__ __forceinline__ uint32_t pair_in_row(const uint16_t* t, int r, int c,
                                                int ld) {
  return *reinterpret_cast<const uint32_t*>(t + r * ld + c);
}

// t[r][c], t[r+1][c] of a row-major tile with row length ld (two loads)
__device__ __forceinline__ uint32_t pair_in_col(const uint16_t* t, int r, int c,
                                                int ld) {
  return static_cast<uint32_t>(t[r * ld + c]) |
         (static_cast<uint32_t>(t[(r + 1) * ld + c]) << 16);
}

}  // namespace moka_flash
