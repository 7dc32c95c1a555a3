// Flash attention forward for Hopper (sm_90a): causal + key-padding masks,
// GQA, a query offset into the key axis, base-2 online softmax.
//
// Replaces the TPU kernel moka_tpu/ops/flash_attention.py::_fwd_kernel
// (launched by _flash_fwd_res).  Same contract:
//   * q arrives unscaled; the kernel multiplies it by qscale = scale*log2(e)
//     rounded to bf16, and rounds the product to bf16, exactly as the JAX
//     wrapper's `q * jnp.asarray(scale * LOG2E, q.dtype)` does, so scores
//     are in base-2 units and the softmax uses exp2;
//   * key k is visible to query row i when mask[b, k] > 0, k < S and, when
//     causal, q_offset + i >= k.  Masked scores take the finite -1e30, so a
//     fully-masked row stays NaN-free; its output is unspecified (it is an
//     average of V over the key tiles that ran) and callers use valid rows
//     only;
//   * outputs: out (bf16, same layout as q) and lse (fp32, natural log,
//     (B, H, L)), which the backward kernels (flash_bwd.cu) read.
//
// Layout: q/out (B, L, H, hd), k/v (B, S, KH, hd), mask (B, S) int32, all
// contiguous; the kernel computes its own offsets, so no transposes and no
// padding in the wrapper (ragged L and S are masked here).
//
// Design: one CTA of 4 warps per (64-row query tile, batch*head).  Each warp
// owns 16 query rows; Q stays in registers as mma.sync A fragments.  The CTA
// walks 64-key K/V tiles staged in shared memory (rows padded by 8 elements
// so fragment reads hit distinct banks), skipping tiles wholly above the
// causal diagonal.  S = Q K^T and O += P V run on the tensor cores with
// mma.sync m16n8k16 (bf16 in, fp32 accumulate); P is rounded to bf16 for the
// second product, the row sums use the fp32 P (as the TPU kernel does).
//
// Bound at the serving slice's shape (b 8, H 32, L 896, S 1024, hd 128), from
// the data sheet, not measured: q/k/v/out are about 59-67 MB each, ~0.25 GB
// in all, ~0.08 ms at 3.35 TB/s; ~53 GFLOP of causal work, ~0.05 ms at
// 989 TFLOP/s bf16.  So the bound is the bytes.  This first cut uses
// mma.sync without TMA/wgmma or double buffering; its measured time is in
// PERF.md.
//
// Head dim 64 (the CLIP tower: b*t frames of 257 tokens, 16 heads,
// non-causal, every key valid) is the same kernel instantiated at HD = 64:
// its padded row of 72 elements (36 words) puts the 32 lanes of a fragment
// read on 32 distinct banks, as 136 does at 128; the last 64-key tile holds
// one valid key (257 = 4 * 64 + 1) and the `k < S` test masks the rest.
// Bound at (80, 257, 16, 64): q/k/v/out about 42 MB each, ~0.05 ms at
// 3.35 TB/s; 21.6 GFLOP, ~0.022 ms at 989 TFLOP/s: the bytes again.

#include "flash_common.cuh"

namespace {

using namespace moka_flash;

constexpr int BQ = 64;  // query rows per CTA (4 warps x 16)
constexpr int BK = 64;  // keys per tile
constexpr int NTHREADS = 128;

// two adjacent q elements of one row, scaled by qscale and rounded to bf16
__device__ __forceinline__ uint32_t load_q_pair(const uint16_t* qb, int row,
                                                int col, int L, long row_stride,
                                                float qscale) {
  if (row >= L) return 0u;
  return scale_pair(
      *reinterpret_cast<const uint32_t*>(qb + row * row_stride + col), qscale);
}

template <int HD>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const uint16_t* __restrict__ q,
                     const uint16_t* __restrict__ k,
                     const uint16_t* __restrict__ v,
                     const int* __restrict__ mask, uint16_t* __restrict__ out,
                     float* __restrict__ lse, int H, int KH, int L, int S,
                     int q_offset, int causal, float qscale) {
  constexpr int LDS = HD + 8;  // padded shared-memory row, in elements
  constexpr int KSTEPS = HD / 16;
  constexpr int DTILES = HD / 8;
  constexpr int NTILES = BK / 8;
  __shared__ __align__(16) uint16_t ks[BK * LDS];
  __shared__ __align__(16) uint16_t vs[BK * LDS];
  __shared__ int ms[BK];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int r0 = q0 + warp * 16 + g;  // this thread's two query rows
  const int r1 = r0 + 8;

  const long q_stride = static_cast<long>(H) * HD;
  const long kv_stride = static_cast<long>(KH) * HD;
  const uint16_t* qb = q + (static_cast<long>(b) * L * H + h) * HD;
  const uint16_t* kb = k + (static_cast<long>(b) * S * KH + kh) * HD;
  const uint16_t* vb = v + (static_cast<long>(b) * S * KH + kh) * HD;

  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int s = 0; s < KSTEPS; ++s) {
    const int c = s * 16 + 2 * t;
    qf[s][0] = load_q_pair(qb, r0, c, L, q_stride, qscale);
    qf[s][1] = load_q_pair(qb, r1, c, L, q_stride, qscale);
    qf[s][2] = load_q_pair(qb, r0, c + 8, L, q_stride, qscale);
    qf[s][3] = load_q_pair(qb, r1, c + 8, L, q_stride, qscale);
  }

  float acc[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};  // per-thread partial row sums

  int n_tiles = (S + BK - 1) / BK;
  if (causal) {
    const int last_q = min(q0 + BQ - 1, L - 1) + q_offset;
    n_tiles = min(n_tiles, last_q / BK + 1);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is consumed
    constexpr int CHUNKS = HD / 8;  // 16-byte pieces per row
    for (int i = threadIdx.x; i < BK * CHUNKS; i += NTHREADS) {
      const int row = i / CHUNKS, ch = i % CHUNKS;
      const int key = k0 + row;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (key < S) {
        kv4 = *reinterpret_cast<const uint4*>(kb + key * kv_stride + ch * 8);
        vv4 = *reinterpret_cast<const uint4*>(vb + key * kv_stride + ch * 8);
      }
      *reinterpret_cast<uint4*>(&ks[row * LDS + ch * 8]) = kv4;
      *reinterpret_cast<uint4*>(&vs[row * LDS + ch * 8]) = vv4;
    }
    if (threadIdx.x < BK) {
      const int key = k0 + threadIdx.x;
      ms[threadIdx.x] = key < S ? mask[static_cast<long>(b) * S + key] : 0;
    }
    __syncthreads();

    // S = (q * qscale) K^T, in base-2 units
    float sc[NTILES][4];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) {
        const uint16_t* kr = &ks[(nt * 8 + g) * LDS + s * 16 + 2 * t];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_bf16(sc[nt], qf[s], b0, b1);
      }
    }

    // mask, then the online softmax update
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = nt * 8 + 2 * t + (e & 1);
        const int key = k0 + kl;
        const int qpos = (e < 2 ? r0 : r1) + q_offset;
        const bool ok = key < S && ms[kl] > 0 && (!causal || qpos >= key);
        if (!ok) sc[nt][e] = NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    const float alpha0 = exp2f(m_run[0] - mx[0]);
    const float alpha1 = exp2f(m_run[1] - mx[1]);
    m_run[0] = mx[0];
    m_run[1] = mx[1];
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      sc[nt][0] = exp2f(sc[nt][0] - mx[0]);
      sc[nt][1] = exp2f(sc[nt][1] - mx[0]);
      sc[nt][2] = exp2f(sc[nt][2] - mx[1]);
      sc[nt][3] = exp2f(sc[nt][3] - mx[1]);
      ls0 += sc[nt][0] + sc[nt][1];
      ls1 += sc[nt][2] + sc[nt][3];
    }
    l_run[0] = l_run[0] * alpha0 + ls0;
    l_run[1] = l_run[1] * alpha1 + ls1;
#pragma unroll
    for (int dn = 0; dn < DTILES; ++dn) {
      acc[dn][0] *= alpha0;
      acc[dn][1] *= alpha0;
      acc[dn][2] *= alpha1;
      acc[dn][3] *= alpha1;
    }

    // O += P V: the S accumulators are reused as A fragments (rounded to bf16)
#pragma unroll
    for (int s = 0; s < BK / 16; ++s) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * s][0], sc[2 * s][1]);
      pa[1] = pack_bf16(sc[2 * s][2], sc[2 * s][3]);
      pa[2] = pack_bf16(sc[2 * s + 1][0], sc[2 * s + 1][1]);
      pa[3] = pack_bf16(sc[2 * s + 1][2], sc[2 * s + 1][3]);
      const int kr = s * 16 + 2 * t;
#pragma unroll
      for (int dn = 0; dn < DTILES; ++dn) {
        const int n = dn * 8 + g;
        const uint32_t b0 = static_cast<uint32_t>(vs[kr * LDS + n]) |
                            (static_cast<uint32_t>(vs[(kr + 1) * LDS + n]) << 16);
        const uint32_t b1 = static_cast<uint32_t>(vs[(kr + 8) * LDS + n]) |
                            (static_cast<uint32_t>(vs[(kr + 9) * LDS + n]) << 16);
        mma_bf16(acc[dn], pa, b0, b1);
      }
    }
  }

  // full row sums across the 4 threads that share a row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  const float safe0 = l_run[0] == 0.f ? 1.f : l_run[0];
  const float safe1 = l_run[1] == 0.f ? 1.f : l_run[1];
  uint16_t* ob = out + (static_cast<long>(b) * L * H + h) * HD;
#pragma unroll
  for (int dn = 0; dn < DTILES; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_stride + c) =
          pack_bf16(acc[dn][0] / safe0, acc[dn][1] / safe0);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_stride + c) =
          pack_bf16(acc[dn][2] / safe1, acc[dn][3] / safe1);
  }
  if (t == 0) {
    float* lb = lse + static_cast<long>(bh) * L;
    if (r0 < L) lb[r0] = (m_run[0] + log2f(safe0)) * LN2;
    if (r1 < L) lb[r1] = (m_run[1] + log2f(safe1)) * LN2;
  }
}

}  // namespace

// q/out (B, L, H, hd) bf16, k/v (B, S, KH, hd) bf16 with hd 128 (LLaMA-2) or
// 64 (the CLIP ViT-L/14 tower), mask (B, S) int32, lse (B, H, L) fp32; all
// contiguous.  Returns cudaGetLastError().
extern "C" int moka_flash_fwd(const void* q, const void* k, const void* v,
                              const void* mask, void* out, void* lse, int B,
                              int H, int KH, int L, int S, int hd,
                              int q_offset, int causal, float qscale,
                              void* stream) {
  if (B <= 0 || L <= 0 || S <= 0 || KH <= 0 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  const auto* mp = static_cast<const int*>(mask);
  auto* op = static_cast<uint16_t*>(out);
  auto* lp = static_cast<float*>(lse);
  if (hd == 128) {
    flash_fwd_kernel<128><<<grid, NTHREADS, 0, st>>>(
        qp, kp, vp, mp, op, lp, H, KH, L, S, q_offset, causal, qscale);
  } else if (hd == 64) {
    flash_fwd_kernel<64><<<grid, NTHREADS, 0, st>>>(
        qp, kp, vp, mp, op, lp, H, KH, L, S, q_offset, causal, qscale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
