// Helpers shared by the flash attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_bwd_kv.cu) and the fused CE kernels (fused_ce.cu, fused_ce_bwd.cu):
// the masking and base-2 constants, bf16 <-> fp32 bit conversions and
// packing, the SFU's exp2 and the order in which CTAs take (head, tile)
// pairs.

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

// two fp32 -> one register of two bf16, each rounded to nearest even (lo in
// the low half): one cvt.rn.bf16x2.f32
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two packed bf16 values, each multiplied by s and rounded to bf16
__device__ __forceinline__ uint32_t scale_pair(uint32_t raw, float s) {
  return pack_bf16(bf16_bits_to_float(raw & 0xffffu) * s,
                   bf16_bits_to_float(raw >> 16) * s);
}

// 2^x by the SFU (ex2.approx, denormal results flushed to zero); -inf and
// -1e30 give +0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The (batch*head, tile) of work item idx out of n_bh * n_tiles, in the
// order items start (a CTA's blockIdx.x, or a persistent CTA's sequence):
// in groups of `group` heads (about one wave of the card: every tile of
// those heads), tile by tile within a group.  So the items that read one
// head's operands run together (once from memory, then from L2), and
// tile 0 of every head in a group starts first (callers put their
// heaviest tile there).
__device__ __forceinline__ void head_group_tile(int idx, int n_bh,
                                                int n_tiles, int group,
                                                int& bh, int& tile) {
  const int per_group = group * n_tiles;
  const int g = idx / per_group, r = idx % per_group;
  const int heads = min(group, n_bh - g * group);  // the last group: fewer
  tile = r / heads;
  bh = g * group + r % heads;
}

}  // namespace moka_flash
