// Int8 codes widened to bf16 on the ordinary ALUs, exactly, for the fused CE
// kernels (fused_ce.cu, fused_ce_bwd.cu): wgmma has no int8 x bf16 form and
// the head stays int8 in device memory, so each kernel widens its int8 head
// tiles into bf16 tiles in shared memory.  The conversion pipe (I2F, F2F)
// runs 16 results a clock an SM; this takes two LOP3s and one bf16x2 FMA a
// pair of codes instead, and pairs columns (0, 2) and (1, 3) of each word:
// the kernels work in that column order ("positions", swap_low_bits).

#pragma once

#include <stdint.h>

namespace moka_int8 {

// widen's masks and biases, read from the kernel's parameters so that each
// mask-and-or is one LOP3 (SASS takes one immediate an instruction)
struct Widen {
  uint32_t low7, sign, plus128, minus128;
};

// the vocab column (within a group of 4) of position q, and back
__device__ __forceinline__ int swap_low_bits(int q) {
  return (q & ~3) | ((q & 1) << 1) | ((q >> 1) & 1);
}

// a + b on bf16 pairs (one HFMA2.BF16: a * 1 + b, exact here)
__device__ __forceinline__ uint32_t bf16x2_add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(0x3f803f80u), "r"(b));
  return d;
}

// (a & m) | c, one LOP3
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t m,
                                           uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;\n" : "=r"(d) : "r"(a), "r"(m), "r"(c));
  return d;
}

// four int8 codes (columns 0..3 of a word) -> bf16 pairs (0, 2) and (1, 3):
// 128 + the low 7 bits, plus -128 - 128 * the sign bit, all exact in bf16
// (two LOP3s and one HFMA2 a pair, a shift for the second)
__device__ __forceinline__ void widen(uint32_t a, const Widen& k,
                                      uint32_t& lo, uint32_t& hi) {
  lo = bf16x2_add(and_or(a, k.low7, k.plus128), and_or(a, k.sign, k.minus128));
  const uint32_t s = a >> 8;
  hi = bf16x2_add(and_or(s, k.low7, k.plus128), and_or(s, k.sign, k.minus128));
}

}  // namespace moka_int8
