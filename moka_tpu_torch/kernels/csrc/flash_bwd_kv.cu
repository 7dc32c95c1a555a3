// Key-major flash attention backward for Hopper (sm_90a): wgmma, TMA and a
// TMA-reduced dq.  Two kernels with the contract of the TPU kernels in
// moka_tpu/ops/flash_attention.py:
//
//   fused  replaces _bwd_fused_kernel (:230, launched by _flash_bwd_fused
//          :292): dq, dk and dv in one pass, every score, probability and dp
//          computed once for all three gradients;
//   dkv    replaces _bwd_dkv_kernel (:180, launched by _flash_bwd_dkv :473):
//          dk and dv alone, given the global-row lse and delta (ring
//          attention calls it per key shard).
// The dq kernel (_bwd_dq_kernel) stays in flash_bwd.cu.
//
// Numerics, as the TPU kernels and flash_bwd_plain:
//   * q comes pre-scaled by scale*log2(e) (the wrapper's _prescaled: the
//     scalar and the product rounded to bf16), so scores are base 2; the
//     row's natural-log lse enters as lse*log2(e);
//   * p = exp2(s - lse_row), and p = 0 where the key is masked (padding,
//     causality, or past S) or where lse_row <= NEG_INF/2;
//   * delta = rowsum(dO * O) in fp32 comes from the wrapper;
//     ds = p * (dp - delta) in fp32;
//   * p is rounded to bf16 before P^T dO, ds before dS K and dS^T q;
//   * dq carries the softmax scale; dk carries ln 2 at write-out, because it
//     contracts against the pre-scaled q.
//
// Layouts: q/dout (B, L, H, hd) bf16, k/v (B, S, KH, hd) bf16, mask (B, S)
// int32, lse/delta (B, H, L) fp32, all contiguous; hd 128.  Outputs: dk/dv
// (B, S, H, hd) fp32 per query head (the wrapper sums each GQA group); the
// fused kernel adds dq into a zeroed fp32 workspace (B, L, H, hd) (the
// wrapper casts it).
//
// What bounds it (data sheet: 989 TFLOP/s bf16, 3.35 TB/s):
//   * fused at b 4, H 32, L = S = 1024, causal: 67.2 M visible (q, k) pairs
//     x 5 products x 2*128 flop = 86 GFLOP, 0.087 ms; ~302 MB of inputs and
//     outputs, 0.090 ms: bound by bytes, with the flops just below;
//   * dkv at b 1, H 32, L = S = 4096: 268 M pairs x 4 products, 275 GFLOP,
//     0.28 ms: bound by the tensor cores.
// The kernels this replaced (mma.sync, one shared-memory stage, transposed
// operands read two bf16 at a time, dq by scalar atomics) reached 7% and
// 13% of the tensor-core peak.  This design is about that rate, which only
// wgmma reaches, and about keeping it fed:
//   * one CTA per (128-key tile, batch*head): a producer warpgroup (one warp
//     issues TMA and stages the rows' lse and delta; setmaxnreg 24) and two
//     consumer warpgroups (setmaxnreg 240), each owning 64 keys, so every
//     product is a 64-row wgmma.  K and V (2 x 32 KB) arrive by TMA once;
//     the CTA walks 64-row query tiles from the first that sees a key of
//     the tile (causal: max(0, k0 - q_offset) / 64).  CTAs start in head
//     groups, heaviest key tiles first (tile_of);
//   * the query side is a ring of 3 stages (Q and dO tiles, 16 KB each,
//     128-byte swizzle, plus the tile's lse and delta) with a full/empty
//     mbarrier pair per stage, so later tiles load while one computes;
//   * S^T = K Q^T and dP^T = V dO^T are wgmmas with both operands K-major in
//     shared memory.  P^T and dS^T stay in registers: an fp32 accumulator
//     of m64n16 has the layout of a bf16 A fragment, so dV += P^T dO and
//     dK += dS^T Q run as register-A wgmmas (B = dO, Q: MN-major, the
//     transpose flag) without a trip through shared memory.  Every product
//     is m64n64, so each operand spans one 128-byte swizzle row in its
//     contiguous direction (hopper.cuh); dK and dV are two 64-column halves
//     each, 128 fp32 accumulator registers a thread beside 64 for S^T and
//     dP^T;
//   * fused only: dS^T (128 x 64 bf16) goes to shared memory; each consumer
//     warpgroup forms dQ = dS K for the 64 query rows and its 64 of the 128
//     head columns (A = dS read from dS^T, B = K, both MN-major), writes it
//     into a swizzled fp32 staging tile, and one thread adds the tile to
//     the workspace with four TMA reductions
//     (cp.reduce.async.bulk.tensor .add, 64 rows x 32 columns each; rows
//     past L are skipped by the tensor map) in place of 8192 scalar
//     atomics.  The workspace keeps q's layout, so the wrapper's cast is one
//     contiguous pass (a (B, H, L, hd) workspace, reduced a tile at a time
//     by one non-tensor bulk copy, needed an unswizzled staging tile, with
//     8-way bank conflicts on its stores, and a transposing cast).  The
//     reduction order over key tiles still varies from run to run;
//   * masks: key validity is read once a CTA; the causal test runs per
//     element only on tiles that straddle the diagonal.  A CTA whose keys no
//     query sees (every CTA at q_offset <= -L) writes zeros.
// Shared memory ~211 KB: one CTA an SM.  chip_smoke.py prints the ptxas
// lines (a bounded mbarrier wait with __trap() had made ptxas serialize
// every wgmma and spill: hopper.cuh).  Measured times are in PERF.md.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace moka_flash;
using namespace moka_hopper;

constexpr int HD = 128;     // head dim (LLaMA-2); others are refused
constexpr int BK = 128;     // keys a CTA
constexpr int BQ = 64;      // query rows a step
constexpr int STAGES = 3;   // query-side ring
constexpr int NCONSUMER = 256;  // two consumer warpgroups
constexpr int NTHREADS = NCONSUMER + 128;  // + the producer warpgroup
constexpr int KV_BOX = BK * 128;  // bytes of a 128-row x 64-column tile
constexpr int Q_BOX = BQ * 128;   // bytes of a 64-row x 64-column tile

// shared memory, byte offsets from a 1024-aligned base
constexpr int OFF_K = 0;                               // 2 boxes (hd halves)
constexpr int OFF_V = OFF_K + 2 * KV_BOX;
constexpr int OFF_Q = OFF_V + 2 * KV_BOX;              // STAGES x 2 boxes
constexpr int OFF_DO = OFF_Q + STAGES * 2 * Q_BOX;
constexpr int OFF_DST = OFF_DO + STAGES * 2 * Q_BOX;   // dS^T, 128 x 64 bf16
constexpr int OFF_DQ = OFF_DST + BK * BQ * 2;          // 4 x 64 x 32 fp32
constexpr int DQ_BOX = BQ * 128;  // bytes of a 64-row x 32-column fp32 tile
constexpr int OFF_ROWS = OFF_DQ + BQ * HD * 4;         // STAGES x lse, delta
constexpr int OFF_BAR = OFF_ROWS + STAGES * 2 * BQ * 4;  // kv, full, empty
constexpr int SMEM_BYTES = OFF_BAR + 8 * (1 + 2 * STAGES) + 1024;

struct Args {
  const int* mask;
  const float* lse;
  const float* delta;
  float* dq_acc;  // fused: fp32 (B, L, H, hd), zeroed by the wrapper
  float* dk;      // fp32 (B, S, H, hd)
  float* dv;
  int H, KH, L, S, q_offset, causal;
  int group;  // heads a group of CTAs (see tile_of)
  float scale;
};

// p = exp2(s + key_bias - lse) and ds = p (dp - delta) for one thread's 32
// elements of the S^T and dP^T accumulators, rounded to bf16 pairs in the
// A-fragment order of the two register-A products; CAUSAL adds the
// per-element test against lim (see the caller)
template <bool CAUSAL>
__device__ __forceinline__ void softmax_grad(const float (&st)[32],
                                             const float (&dpt)[32],
                                             const float* lse_s,
                                             const float (&key_bias)[2],
                                             int lim, uint32_t (&pa)[4][4],
                                             uint32_t (&da)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float p2[2], ds2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * kk + 2 * r + e;
        const int u = (i >> 1) & 1;
        const int c = 8 * (i >> 2) + e;  // the query less 2 t
        float p = exp2f(st[i] + key_bias[u] - lse_s[c]);
        if (CAUSAL && c < lim + 8 * u) p = 0.f;
        p2[e] = p;
        ds2[e] = p * (dpt[i] - lse_s[BQ + c]);
      }
      pa[kk][r] = pack_bf16(p2[0], p2[1]);
      da[kk][r] = pack_bf16(ds2[0], ds2[1]);
    }
  }
}

// The (batch*head, key tile) of this CTA.  CTAs start in the order of the
// linear block index; they go in groups of a.group heads (about one wave of
// the card: every key tile of those heads), key tile by key tile within a
// group.  So the CTAs that read one head's Q and dO run together (once from
// memory, then from L2), and under a causal mask the heaviest tiles (the
// first keys, which every later query sees) start first.
__device__ __forceinline__ void tile_of(const Args& a, int& bh, int& kt) {
  const int n_kt = (a.S + BK - 1) / BK;
  const int per_group = a.group * n_kt;
  const int g = blockIdx.x / per_group, r = blockIdx.x % per_group;
  const int heads = min(a.group, static_cast<int>(gridDim.x) / n_kt -
                                     g * a.group);  // the last group: fewer
  kt = r / heads;
  bh = g * a.group + r % heads;
}

template <bool WITH_DQ>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_kv_kernel(const __grid_constant__ CUtensorMap tm_q,
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
  const uint32_t bar_kv = base + OFF_BAR;
  const uint32_t bar_full = bar_kv + 8;                 // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * STAGES;     // + 8 * stage
  float* rows = reinterpret_cast<float*>(sm + OFF_ROWS);  // stage s: lse at
                                          // rows[128 s], delta at [128 s + 64]

  const int tid = threadIdx.x;
  const int H = a.H, L = a.L, S = a.S, q_offset = a.q_offset;
  int bh, kt;
  tile_of(a, bh, kt);
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / a.KH);
  const int k0 = kt * BK;
  const int first = a.causal ? max(0, k0 - q_offset) / BQ : 0;
  const int n_qt = (L + BQ - 1) / BQ;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 32);
      mbar_init(bar_empty + 8 * s, NCONSUMER);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NCONSUMER) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<24>();
    if (tid < NCONSUMER + 32) {
      const int lane = tid & 31;
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_kv, 4 * KV_BOX);
        for (int half = 0; half < 2; ++half) {
          tma_load_4d(base + OFF_K + half * KV_BOX, &tm_k, bar_kv, 64 * half,
                      kh, k0, b);
          tma_load_4d(base + OFF_V + half * KV_BOX, &tm_v, bar_kv, 64 * half,
                      kh, k0, b);
        }
      }
      const float* lseb = a.lse + static_cast<long>(bh) * L;
      const float* deltab = a.delta + static_cast<long>(bh) * L;
      for (int it = 0, qt = first; qt < n_qt; ++it, ++qt) {
        const int s = it % STAGES;
        mbar_wait(bar_empty + 8 * s, ((it / STAGES) & 1) ^ 1);
        const int q0 = qt * BQ;
        float* lse_s = rows + s * 2 * BQ;
        for (int r = lane; r < BQ; r += 32) {
          const int i = q0 + r;
          // a row past L or with every key masked (lse * log2 e <=
          // NEG_INF / 2, the plain version's test) gets +inf, so that
          // exp2(s - lse) = 0 there
          const float lr = (i < L ? lseb[i] : NEG_INF) * LOG2E;
          lse_s[r] = lr > NEG_INF * 0.5f ? lr : INFINITY;
          lse_s[BQ + r] = i < L ? deltab[i] : 0.f;
        }
        const uint32_t full = bar_full + 8 * s;
        if (lane == 0) {
          mbar_arrive_expect_tx(full, 4 * Q_BOX);
          const uint32_t qs = base + OFF_Q + s * 2 * Q_BOX;
          const uint32_t dos = base + OFF_DO + s * 2 * Q_BOX;
          for (int half = 0; half < 2; ++half) {
            tma_load_4d(qs + half * Q_BOX, &tm_q, full, 64 * half, h, q0, b);
            tma_load_4d(dos + half * Q_BOX, &tm_do, full, 64 * half, h, q0,
                        b);
          }
        } else {
          mbar_arrive(full);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<240>();
    // this warpgroup's 64 keys; the shuffle tells the compiler the value is
    // warp-uniform, so the wgmma descriptors built from it can live in
    // uniform registers
    const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
    const int warp = (tid % 128) / 32;  // 16 of them
    const int lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kw = k0 + 64 * wg;        // the warpgroup's first key
    const int kr = 16 * warp + g;       // this thread's keys: kr, kr + 8
    // -inf on this thread's key rows that are padding or past S, added to
    // their scores so that exp2 gives p = 0 there
    float key_bias[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = kw + kr + 8 * i;
      key_bias[i] = key < S && a.mask[static_cast<long>(b) * S + key] > 0
                        ? 0.f
                        : -INFINITY;
    }

    // dK, dV: 64 keys x 2 halves of 64 head columns, fp32
    float dk[2][32], dv[2][32];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[n][i] = dv[n][i] = 0.f;

    const uint32_t ks = base + OFF_K + wg * 64 * 128;  // this group's rows
    const uint32_t vs = base + OFF_V + wg * 64 * 128;
    const uint32_t dst = base + OFF_DST;
    mbar_wait(bar_kv, 0);

    for (int it = 0, qt = first; qt < n_qt; ++it, ++qt) {
      const int s = it % STAGES;
      const int q0 = qt * BQ;
      mbar_wait(bar_full + 8 * s, (it / STAGES) & 1);
      const uint32_t qs = base + OFF_Q + s * 2 * Q_BOX;
      const uint32_t dos = base + OFF_DO + s * 2 * Q_BOX;

      // S^T = K Q^T, dP^T = V dO^T (64 keys x 64 queries, over hd)
      float st[32], dpt[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t kv_off = (kk / 4) * KV_BOX + (kk % 4) * 32;
        const uint32_t q_off = (kk / 4) * Q_BOX + (kk % 4) * 32;
        wgmma_m64n64_ss<0, 0>(st, desc_sw128(ks + kv_off),
                              desc_sw128(qs + q_off), kk);
        wgmma_m64n64_ss<0, 0>(dpt, desc_sw128(vs + kv_off),
                              desc_sw128(dos + q_off), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(st);
      fence_operand(dpt);

      // P^T, then dS^T = P^T (dP^T - delta) in fp32, each pair rounded to
      // bf16 into the A fragments of P^T and dS^T (one per 16 queries) as
      // it is formed.  Element i of an m64n64 accumulator is key row
      // kr + 8 u (u = (i >> 1) & 1), query c = 8 (i >> 2) + 2 t + (i & 1);
      // fragment register r of 16-query step kk holds elements 8 kk + 2 r,
      // + 1.  Padding and dead rows are zeroed through key_bias and the
      // staged lse; causality by a test only on tiles that straddle the
      // diagonal: query c sees key row kr + 8 u iff
      // c - 2 t >= kw + kr - q0 - q_offset - 2 t + 8 u.
      const float* lse_s = rows + s * 2 * BQ + 2 * t;  // + c - 2 t
      uint32_t pa[4][4], da[4][4];
      const int lim = kw + kr - q0 - q_offset - 2 * t;
      if (a.causal && q0 + q_offset < kw + 63) {
        softmax_grad<true>(st, dpt, lse_s, key_bias, lim, pa, da);
      } else {
        softmax_grad<false>(st, dpt, lse_s, key_bias, lim, pa, da);
      }

      // dV += P^T dO, dK += dS^T Q (over the 64 queries), per head half
      fence_operand(dk[0]);
      fence_operand(dk[1]);
      fence_operand(dv[0]);
      fence_operand(dv[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          wgmma_m64n64_rs<1>(dv[n], pa[kk],
                             desc_sw128(dos + n * Q_BOX + kk * 2048), 1);
          wgmma_m64n64_rs<1>(dk[n], da[kk],
                             desc_sw128(qs + n * Q_BOX + kk * 2048), 1);
        }
      }
      wgmma_commit();

      if (WITH_DQ) {
        // dS^T to shared memory: row = key (64 wg + kr (+8)), 64 queries a
        // 128-byte row, 16-byte chunk j at j ^ (row % 8)
        uint8_t* dsp = sm + OFF_DST;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int row = 64 * wg + kr + 8 * (r & 1);
            const int chunk = 2 * kk + (r >> 1);
            *reinterpret_cast<uint32_t*>(dsp + row * 128 +
                                         ((chunk ^ (row & 7)) << 4) + 4 * t) =
                da[kk][r];
          }
        fence_proxy_async_smem();
        // the previous tile's dq reduce has read the staging tile
        if (tid == 0) bulk_wait_read<0>();
        named_bar_sync(1, NCONSUMER);
        wgmma_wait<0>();  // dV, dK done: pa, da may be reused
        fence_operand(pa[0]); fence_operand(pa[1]);
        fence_operand(pa[2]); fence_operand(pa[3]);
        fence_operand(da[0]); fence_operand(da[1]);
        fence_operand(da[2]); fence_operand(da[3]);

        // dQ = dS K: 64 queries x head columns [64 wg, 64 wg + 64), over
        // the 128 keys; A = dS (dS^T tile, MN-major), B = K (MN-major)
        float dq[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_m64n64_ss<1, 1>(
              dq, desc_sw128(dst + kk * 2048),
              desc_sw128(base + OFF_K + wg * KV_BOX + kk * 2048), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(dq);
        mbar_arrive(bar_empty + 8 * s);  // Q, dO, lse, delta consumed

        // dq * scale into the staging tile: four boxes of 64 rows x 32
        // head columns, 128-byte rows, 16-byte chunk j at j ^ (row % 8), as
        // the tensor map's 128-byte swizzle reads them (the swizzle spreads
        // a warp's eight rows over the banks; unswizzled 512-byte rows put
        // them all on the same eight)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int up = 0; up < 2; ++up) {
            const int row = kr + 8 * up;
            const int col = 64 * wg + 8 * j + 2 * t;
            const int chunk = (col & 31) >> 2;
            *reinterpret_cast<float2*>(
                sm + OFF_DQ + (col >> 5) * DQ_BOX + row * 128 +
                ((chunk ^ (row & 7)) << 4) + 4 * (col & 3)) =
                make_float2(dq[4 * j + 2 * up] * a.scale,
                            dq[4 * j + 2 * up + 1] * a.scale);
          }
        fence_proxy_async_smem();
        named_bar_sync(2, NCONSUMER);  // staging full; dS^T consumed
        if (tid == 0) {  // rows past L are skipped by the tensor map
#pragma unroll
          for (int box = 0; box < HD / 32; ++box)
            tma_reduce_add_4d(&tm_dq, base + OFF_DQ + box * DQ_BOX, 32 * box,
                              h, q0, b);
          bulk_commit();
        }
      } else {
        wgmma_wait<0>();
        fence_operand(pa[0]); fence_operand(pa[1]);
        fence_operand(pa[2]); fence_operand(pa[3]);
        fence_operand(da[0]); fence_operand(da[1]);
        fence_operand(da[2]); fence_operand(da[3]);
        mbar_arrive(bar_empty + 8 * s);  // Q, dO, lse, delta consumed
      }
      fence_operand(dk[0]);
      fence_operand(dk[1]);
      fence_operand(dv[0]);
      fence_operand(dv[1]);
    }
    if (WITH_DQ && tid == 0) bulk_wait<0>();

    // write-out: dk * ln2 (undoes the log2 e folded into q), dv
    const long q_stride = static_cast<long>(H) * HD;
#pragma unroll
    for (int up = 0; up < 2; ++up) {
      const int key = kw + kr + 8 * up;
      if (key >= S) continue;
      const long row = (static_cast<long>(b) * S + key) * q_stride +
                       static_cast<long>(h) * HD;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = 4 * j + 2 * up;
          const long off = row + 64 * n + 8 * j + 2 * t;
          *reinterpret_cast<float2*>(a.dk + off) =
              make_float2(dk[n][i] * LN2, dk[n][i + 1] * LN2);
          *reinterpret_cast<float2*>(a.dv + off) =
              make_float2(dv[n][i], dv[n][i + 1]);
        }
    }
  }
}

template <bool WITH_DQ>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const Args& a, int B, int hd, void* stream) {
  if (B <= 0 || a.L <= 0 || a.S <= 0 || a.KH <= 0 || a.H % a.KH != 0 ||
      hd != HD)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_bwd_kv_kernel<WITH_DQ>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // q/dO over (hd, H, L, B) and k/v over (hd, KH, S, B): a ragged L or S
  // is zero-filled within each batch row; boxes of 64 head columns (two a
  // row).  dq's fp32 workspace over (hd, H, L, B) too, boxes of 32
  // columns.
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq{};
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t q_dims[4] = {HD, uint64_t(a.H), uint64_t(a.L), uint64_t(B)};
  const uint64_t k_dims[4] = {HD, uint64_t(a.KH), uint64_t(a.S), uint64_t(B)};
  const uint32_t q_box[4] = {64, 1, BQ, 1}, k_box[4] = {64, 1, BK, 1};
  if (!swizzled_map(&tm_q, bf16, 2, 4, q, q_dims, q_box) ||
      !swizzled_map(&tm_do, bf16, 2, 4, dout, q_dims, q_box) ||
      !swizzled_map(&tm_k, bf16, 2, 4, k, k_dims, k_box) ||
      !swizzled_map(&tm_v, bf16, 2, 4, v, k_dims, k_box))
    return static_cast<int>(cudaErrorInvalidValue);
  if (WITH_DQ) {
    const uint32_t dq_box[4] = {32, 1, BQ, 1};
    if (!swizzled_map(&tm_dq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 4,
                      a.dq_acc, q_dims, dq_box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_kt = (a.S + BK - 1) / BK;
  static const int sms = [] {
    int dev = 0, n = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  Args g = a;
  g.group = max(1, sms / n_kt);
  const dim3 grid(n_kt * B * a.H);
  kernel<<<grid, NTHREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dq, g);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* mask, const void* lse, const void* delta, int H,
               int KH, int L, int S, int q_offset, int causal, float scale) {
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
  a.scale = scale;
  return a;
}

}  // namespace

// Both entry points take q (already pre-scaled by the bf16-rounded
// scale*log2 e; qscale is not read, the argument list is flash_bwd.cu's),
// k, v, mask, dout, lse, delta, then their outputs, then (B, H, KH, L, S,
// hd, q_offset, causal, qscale, scale, stream); hd must be 128 and every
// tensor 16-byte aligned.  They return cudaGetLastError() after the launch,
// or the error of the shared-memory attribute, or cudaErrorInvalidValue for
// bad dimensions or a tensor map the driver refuses.

// dq_acc: fp32 (B, L, H, hd), zeroed by the caller; dk/dv fp32 (B, S, H, hd)
extern "C" int moka_flash_bwd_fused(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dq_acc, void* dk,
                                    void* dv, int B, int H, int KH, int L,
                                    int S, int hd, int q_offset, int causal,
                                    float qscale, float scale, void* stream) {
  (void)qscale;
  Args a = make_args(mask, lse, delta, H, KH, L, S, q_offset, causal, scale);
  a.dq_acc = static_cast<float*>(dq_acc);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  return launch<true>(q, k, v, dout, a, B, hd, stream);
}

// dk/dv: fp32 (B, S, H, hd)
extern "C" int moka_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* mask, const void* dout,
                                  const void* lse, const void* delta, void* dk,
                                  void* dv, int B, int H, int KH, int L, int S,
                                  int hd, int q_offset, int causal,
                                  float qscale, float scale, void* stream) {
  (void)qscale;
  Args a = make_args(mask, lse, delta, H, KH, L, S, q_offset, causal, scale);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  return launch<false>(q, k, v, dout, a, B, hd, stream);
}
