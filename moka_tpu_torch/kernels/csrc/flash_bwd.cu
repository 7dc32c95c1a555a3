// Flash attention backward for Hopper (sm_90a): the dq kernel, query-major,
// on wgmma and TMA, with the contract of the TPU kernel in
// moka_tpu/ops/flash_attention.py:
//
//   dq     replaces _bwd_dq_kernel (:136, launched by _flash_bwd_dq :428):
//          dq alone, given the global-row lse and delta (ring attention
//          calls it per key shard).
//
// The key-major kernels (fused dq/dk/dv and dk/dv alone) are in
// flash_bwd_kv.cu.
//
// Numerics, as the TPU kernel:
//   * q is pre-scaled by qscale = scale*log2(e) (the scalar and the product
//     rounded to bf16, as flash_fwd.cu does), so scores are base 2; the row's
//     natural-log lse from the forward enters as lse*log2(e);
//   * p = exp2(s - lse_row), and p = 0 where the key is masked (padding,
//     causality, or past S) or where lse_row <= NEG_INF/2 (a query row
//     whose keys are all masked gets zero gradients);
//   * delta = rowsum(dO * O) in fp32 comes from the wrapper;
//     ds = p * (dp - delta) with p and dp in fp32;
//   * ds is rounded to bf16 before dS K; dq carries the softmax scale and is
//     rounded to bf16 once, at the end;
//   * key tile kb runs for a query tile exactly when JAX's would:
//     kb * BK <= q_offset + the tile's last row (floor division); ragged L
//     and S are masked here, the wrapper does not pad.
//
// Layouts: q/dout (B, L, H, hd) bf16, k/v (B, S, KH, hd) bf16, mask (B, S)
// int32, lse/delta (B, H, L) fp32, all contiguous.  Output: dq (B, L, H, hd)
// bf16.
//
// What bounds it (data sheet: 989 TFLOP/s bf16, 3.35 TB/s): at b 1, H 32,
// L = S = 4096, causal, 268 M visible pairs x 3 products x 2*128 flop =
// 206 GFLOP, 0.21 ms, against ~0.14 GB, 0.04 ms: the tensor cores.  So
// every product is a wgmma, kept fed; the design is the query-major twin
// of flash_bwd_kv.cu's:
//   * one CTA per (128-row query tile, batch*head): two consumer
//     warpgroups of 64 rows each (setmaxnreg 240) and a producer warpgroup
//     (setmaxnreg 24) whose first warp issues TMA.  Q and dO (2 x 32 KB)
//     arrive once; K/V tiles of 64 keys stream through a 4-stage
//     full/empty mbarrier ring, each stage with its key-mask slice and an
//     all-valid flag staged by the producer warp;
//   * TMA cannot scale in flight: each consumer warpgroup multiplies its Q
//     tile in shared memory (scale_pair, elementwise, so the swizzle does
//     not matter) and fences it to the async proxy before the first wgmma;
//   * S = Q K^T and dP = dO V^T are ss-wgmmas (m64n64, both operands
//     K-major in 128-byte-swizzled boxes of 64 columns); p and dS are
//     formed on the fp32 accumulators and dS rounded to bf16 in registers
//     in the A-fragment order, so dQ += dS K is a register-A wgmma with K
//     MN-major (the transpose flag), one m64n64 per 64 head columns.  dq
//     stays in registers (64 fp32 a thread) for the whole key loop: no
//     atomics, so dq is deterministic;
//   * each warpgroup counts its own key tiles (its 64 rows' diagonal), and
//     only waits out and releases the tiles past its count; a tile whose
//     keys are all valid and below every row's diagonal skips the
//     per-element mask;
//   * dq * scale is written as bf16 into the warpgroup's own (consumed) Q
//     box in the swizzled layout, then stored by TMA (rows past L clipped);
//   * CTAs start in head groups of about one wave, the last query tiles
//     (the most keys under a causal mask) first (head_group_tile).
// Shared memory ~194 KB: one CTA an SM.  chip_smoke.py prints ptxas's lines
// and the SASS counts; measured times are in PERF.md.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace moka_flash;
using namespace moka_hopper;

constexpr int HD = 128;         // head dim (LLaMA-2); others are refused
constexpr int HALVES = HD / 64;  // 64-column boxes a row
constexpr int NC = 2;           // consumer warpgroups, 64 query rows each
constexpr int BQ = 64 * NC;     // query rows a CTA
constexpr int BK = 64;          // keys a tile
constexpr int STAGES = 4;       // key-side ring
constexpr int NTHREADS = 128 * (NC + 1);
constexpr int BOX = 64 * 128;   // bytes of a 64-row x 64-column bf16 box
constexpr int MASK_INTS = BK + 4;  // key valid flags, all-valid

// shared memory, byte offsets from a 1024-aligned base
constexpr int OFF_Q = 0;  // NC x HALVES boxes; dq on the way back
constexpr int OFF_DO = OFF_Q + NC * HALVES * BOX;
constexpr int OFF_K = OFF_DO + NC * HALVES * BOX;  // STAGES x HALVES boxes
constexpr int OFF_V = OFF_K + STAGES * HALVES * BOX;
constexpr int OFF_MASK = OFF_V + STAGES * HALVES * BOX;
constexpr int OFF_BAR = OFF_MASK + STAGES * MASK_INTS * 4;  // qdo, full, empty
constexpr int SMEM_BYTES = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;

struct Args {
  const int* mask;
  const float* lse;
  const float* delta;
  int H, KH, L, S, q_offset, causal;
  int group;  // heads a group of CTAs (head_group_tile)
  float qscale, scale;
};

// keys [0, kv_end) that rows up to `last` may see (before padding)
__device__ __forceinline__ int kv_end(const Args& a, int last) {
  return a.causal ? min(a.S, max(0, a.q_offset + last + 1)) : a.S;
}

// One key tile of one consumer warpgroup: S = Q K^T and dP = dO V^T over 64
// keys, p (the mask where MASK), dS = p (dP - delta) and dQ += dS K.
// Accumulator element i of a thread holds row row0 + 8 u (u = (i >> 1) & 1)
// and key column c = 8 (i >> 2) + 2 t + (i & 1) of the tile; A-fragment
// register r of 16-key step kk holds elements 8 kk + 2 r, + 1.  lr is the
// row's lse * log2 e (+inf on a dead row: p = 0), dl its delta.
template <bool MASK>
__device__ __forceinline__ void dq_tile(float (&dq)[HALVES][32], uint32_t qs,
                                        uint32_t dos, uint32_t ks,
                                        uint32_t vs, const int* ms, int k0,
                                        int pos0, int causal,
                                        const float (&lr)[2],
                                        const float (&dl)[2], int t) {
  float st[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dp[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
    wgmma_m64n64_ss<0, 0>(st, desc_sw128(qs + off), desc_sw128(ks + off), kk);
    wgmma_m64n64_ss<0, 0>(dp, desc_sw128(dos + off), desc_sw128(vs + off),
                          kk);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(st);
  fence_operand(dp);

  uint32_t da[BK / 16][4];
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int u = (i >> 1) & 1;
    float ds2[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float p = exp2_approx(st[i + e] - lr[u]);
      if (MASK) {
        const int c = 8 * (i >> 2) + 2 * t + e;
        if (!ms[c] || (causal && pos0 + 8 * u < k0 + c)) p = 0.f;
      }
      ds2[e] = p * (dp[i + e] - dl[u]);
    }
    da[i / 8][(i % 8) / 2] = pack_bf16(ds2[0], ds2[1]);
  }

#pragma unroll
  for (int n = 0; n < HALVES; ++n) fence_operand(dq[n]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int n = 0; n < HALVES; ++n)
      wgmma_m64n64_rs<1>(dq[n], da[kk],
                         desc_sw128(ks + n * BOX + kk * 2048), 1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < HALVES; ++n) fence_operand(dq[n]);
}

__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_dq,
                        const Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // 1024-aligned, by arithmetic on the shared array itself so the compiler
  // keeps shared-memory loads and stores (not generic ones) on it
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(sm);
  const uint32_t bar_qdo = base + OFF_BAR;
  const uint32_t bar_full = bar_qdo + 8;             // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;  // + 8 * stage
  int* masks = reinterpret_cast<int*>(sm + OFF_MASK);

  const int tid = threadIdx.x;
  const int L = a.L, S = a.S;
  const int n_qt = (L + BQ - 1) / BQ;
  int bh, qt;
  head_group_tile(blockIdx.x, gridDim.x / n_qt, n_qt, a.group, bh, qt);
  qt = n_qt - 1 - qt;  // the last query tiles (the most keys) first
  const int b = bh / a.H, h = bh % a.H;
  const int kh = h / (a.H / a.KH);
  const int q0 = qt * BQ;
  const int n_tiles = (kv_end(a, min(q0 + BQ, L) - 1) + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(bar_qdo, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 32);
      mbar_init(bar_empty + 8 * s, 128 * NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128 * NC) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<24>();
    if (tid < 128 * NC + 32) {
      const int lane = tid & 31;
      if (lane == 0) {
        // the boxes of warpgroups with rows (a box wholly past L is skipped)
        const int live = min(NC, (L - q0 + 63) / 64);
        mbar_arrive_expect_tx(bar_qdo, 2 * live * HALVES * BOX);
        for (int w = 0; w < live; ++w)
          for (int half = 0; half < HALVES; ++half) {
            const int off = (w * HALVES + half) * BOX;
            tma_load_4d(base + OFF_Q + off, &tm_q, bar_qdo, 64 * half, h,
                        q0 + 64 * w, b);
            tma_load_4d(base + OFF_DO + off, &tm_do, bar_qdo, 64 * half, h,
                        q0 + 64 * w, b);
          }
      }
      const int* mb = a.mask + static_cast<long>(b) * S;
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        const int k0 = it * BK;
        int* ms = masks + s * MASK_INTS;
        bool all = true;
        for (int r = lane; r < BK; r += 32) {
          const int key = k0 + r;
          const int ok = key < S && mb[key] > 0;
          ms[r] = ok;
          all = all && ok;
        }
        all = __all_sync(0xffffffffu, all);
        const uint32_t full = bar_full + 8 * s;
        if (lane == 0) {
          ms[BK] = all;
          mbar_arrive_expect_tx(full, 2 * HALVES * BOX);
          for (int half = 0; half < HALVES; ++half) {
            tma_load_4d(base + OFF_K + (s * HALVES + half) * BOX, &tm_k, full,
                        64 * half, kh, k0, b);
            tma_load_4d(base + OFF_V + (s * HALVES + half) * BOX, &tm_v, full,
                        64 * half, kh, k0, b);
          }
        } else {
          mbar_arrive(full);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    // this warpgroup's 64 rows; the shuffle tells the compiler the value is
    // warp-uniform, so the descriptors built from it stay in uniform
    // registers
    const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
    const int warp = (tid % 128) / 32, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int q0w = q0 + 64 * wg;
    const int row0 = 16 * warp + g;  // this thread's rows: row0, row0 + 8
    const int pos0 = a.q_offset + q0w + row0;  // row0's key-axis position
    const int kv_w = q0w < L ? kv_end(a, min(q0w + 64, L) - 1) : 0;
    const int n_w = (kv_w + BK - 1) / BK;  // key tiles this warpgroup runs
    const uint32_t qs = base + OFF_Q + wg * HALVES * BOX;
    const uint32_t dos = base + OFF_DO + wg * HALVES * BOX;

    // this thread's rows: lse * log2 e, +inf where the row is past L or
    // has every key masked (lse * log2 e <= NEG_INF / 2, the plain
    // version's test), so that exp2(s - lse) = 0 there; delta
    float lr[2], dl[2];
    const float* lseb = a.lse + static_cast<long>(bh) * L;
    const float* deltab = a.delta + static_cast<long>(bh) * L;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = q0w + row0 + 8 * u;
      const float l2 = (r < L ? lseb[r] : NEG_INF) * LOG2E;
      lr[u] = l2 > NEG_INF * 0.5f ? l2 : INFINITY;
      dl[u] = r < L ? deltab[r] : 0.f;
    }

    // q * qscale, rounded to bf16, in place
    mbar_wait(bar_qdo, 0);
    if (q0w < L) {
      uint4* qp = reinterpret_cast<uint4*>(sm + OFF_Q + wg * HALVES * BOX);
      for (int i = tid % 128; i < HALVES * BOX / 16; i += 128) {
        uint4 v = qp[i];
        v.x = scale_pair(v.x, a.qscale);
        v.y = scale_pair(v.y, a.qscale);
        v.z = scale_pair(v.z, a.qscale);
        v.w = scale_pair(v.w, a.qscale);
        qp[i] = v;
      }
    }
    fence_proxy_async_smem();
    named_bar_sync(1 + wg, 128);

    float dq[HALVES][32];
#pragma unroll
    for (int n = 0; n < HALVES; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[n][i] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
      if (it < n_w) {
        const int k0 = it * BK;
        const int* ms = masks + s * MASK_INTS;
        const uint32_t ks = base + OFF_K + s * HALVES * BOX;
        const uint32_t vs = base + OFF_V + s * HALVES * BOX;
        if (!ms[BK] || (a.causal && a.q_offset + q0w < k0 + BK - 1)) {
          dq_tile<true>(dq, qs, dos, ks, vs, ms, k0, pos0, a.causal, lr, dl,
                        t);
        } else {
          dq_tile<false>(dq, qs, dos, ks, vs, ms, k0, pos0, a.causal, lr, dl,
                         t);
        }
      }
      mbar_arrive(bar_empty + 8 * s);  // K, V and the mask slice consumed
    }

    if (q0w < L) {
      // dq * scale as bf16 into the (consumed) Q box: row r's 16-byte chunk
      // j at j ^ (r % 8), as the tensor map's 128-byte swizzle reads it
      uint8_t* ob = sm + OFF_Q + wg * HALVES * BOX;
#pragma unroll
      for (int n = 0; n < HALVES; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int row = row0 + 8 * u;
            *reinterpret_cast<uint32_t*>(ob + n * BOX + row * 128 +
                                         ((j ^ (row & 7)) << 4) + 4 * t) =
                pack_bf16(dq[n][4 * j + 2 * u] * a.scale,
                          dq[n][4 * j + 2 * u + 1] * a.scale);
          }
      fence_proxy_async_smem();
      named_bar_sync(1 + wg, 128);
      if (tid % 128 == 0) {
        for (int n = 0; n < HALVES; ++n)
          tma_store_4d(&tm_dq, qs + n * BOX, 64 * n, h, q0w, b,
                       l2_evict_first());
        bulk_commit();
        bulk_wait_read<0>();  // the box is read: the CTA may exit
      }
    }
  }
}

}  // namespace

// The entry point takes q (unscaled: the kernel scales it by qscale), k, v,
// mask, dout, lse, delta, then its output dq (bf16 (B, L, H, hd)), then
// (B, H, KH, L, S, hd, q_offset, causal, qscale, scale, stream); hd must be
// 128 and every tensor 16-byte aligned.  Returns cudaGetLastError() after
// the launch, or the error of the shared-memory attribute, or
// cudaErrorInvalidValue for bad dimensions or a tensor map the driver
// refuses.
extern "C" int moka_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* mask, const void* dout,
                                 const void* lse, const void* delta, void* dq,
                                 int B, int H, int KH, int L, int S, int hd,
                                 int q_offset, int causal, float qscale,
                                 float scale, void* stream) {
  if (B <= 0 || L <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || hd != HD)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  Args a{};
  a.mask = static_cast<const int*>(mask);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.H = H;
  a.KH = KH;
  a.L = L;
  a.S = S;
  a.q_offset = q_offset;
  a.causal = causal;
  a.qscale = qscale;
  a.scale = scale;
  // q/dO/dq over (hd, H, L, B) and k/v over (hd, KH, S, B), boxes of 64
  // head columns x 64 rows: a ragged L or S is zero-filled (loads) or
  // clipped (the store) within each batch row
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t q_dims[4] = {HD, uint64_t(H), uint64_t(L), uint64_t(B)};
  const uint64_t k_dims[4] = {HD, uint64_t(KH), uint64_t(S), uint64_t(B)};
  const uint32_t box[4] = {64, 1, 64, 1};
  if (!swizzled_map(&tm_q, bf16, 2, 4, q, q_dims, box) ||
      !swizzled_map(&tm_do, bf16, 2, 4, dout, q_dims, box) ||
      !swizzled_map(&tm_dq, bf16, 2, 4, dq, q_dims, box) ||
      !swizzled_map(&tm_k, bf16, 2, 4, k, k_dims, box) ||
      !swizzled_map(&tm_v, bf16, 2, 4, v, k_dims, box))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (L + BQ - 1) / BQ;
  a.group = max(1, sm_count() / n_qt);
  flash_bwd_dq_kernel<<<n_qt * B * H, NTHREADS, SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dq, a);
  return static_cast<int>(cudaGetLastError());
}
