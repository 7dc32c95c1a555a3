// Flash attention forward for Hopper (sm_90a): causal + key-padding masks,
// GQA, a query offset into the key axis, base-2 online softmax, on wgmma
// and TMA.
//
// Replaces the TPU kernel moka_tpu/ops/flash_attention.py::_fwd_kernel
// (:56, launched by _flash_fwd_res :360).  Same contract:
//   * q arrives unscaled; the kernel multiplies it by qscale = scale*log2(e)
//     rounded to bf16, and rounds the product to bf16, exactly as the JAX
//     wrapper's `q * jnp.asarray(scale * LOG2E, q.dtype)` does, so scores
//     are in base-2 units and the softmax uses exp2;
//   * key k is visible to query row i when mask[b, k] > 0, k < S and, when
//     causal, q_offset + i >= k.  Masked scores take the finite -1e30;
//   * key tile kb runs for a query tile exactly when JAX's would:
//     kb * BK <= q_offset + the tile's last row (floor division, so a tile
//     whose rows all lie before key 0 runs none);
//   * P is rounded to bf16 for P V, the row sums use the fp32 P;
//   * outputs: out (bf16, same layout as q) and lse (fp32, natural log,
//     (B, H, L)), which the backward kernels read.  A row that sees no key
//     reads out 0 and lse -1e30 ln 2: JAX's result for a row whose whole
//     block sees no key, here whatever the tiling (JAX's other such rows,
//     and the plain version's, average V: callers read valid rows only).
//
// Layout: q/out (B, L, H, hd), k/v (B, S, KH, hd), mask (B, S) int32, all
// contiguous; the kernel computes its own offsets, so no transposes and no
// padding in the wrapper (ragged L and S are masked here, and TMA
// zero-fills and clips the ragged tiles).
//
// What bounds it (data sheet: 3.35 TB/s, 989 TFLOP/s bf16): at the serving
// prefill (b 8, H 32, L 896, S 928, causal) q, out and the visible k/v rows
// are ~0.24 GB, 0.070 ms, against ~53 GFLOP of visible pairs, 0.053 ms; at
// the CLIP tower's (80 frames, 257 tokens, 16 heads, hd 64, non-causal)
// ~0.17 GB, 0.051 ms, against 21.6 GFLOP, 0.022 ms, and one exp2 a pair on
// the SFU (16 a clock an SM), 0.020 ms.  Bytes, then.  But every query
// tile reads its head's K/V again up to its diagonal: ~0.46 GB at the
// prefill from L2, which is what holds this kernel back on the card (with
// its products and softmax taken out it still takes about three quarters
// of its time; PERF.md).  So the K/V loads carry an evict_last L2 hint and
// Q and out evict_first, and the rest of the design keeps that stream
// flowing and the math under it:
//   * persistent CTAs (one an SM at hd 128, two at hd 64), each walking
//     work items (query tile, batch*head): NC consumer warpgroups of 64
//     query rows each (NC = 2 at hd 128, 1 at hd 64) and a producer
//     warpgroup whose first warp issues TMA.  An item's Q arrives once,
//     into one of two slots, so the next item's Q and first K/V tiles load
//     while this one computes and stores (a CTA a tile spent ~half its
//     time on that prologue and the store's tail at the CLIP shape, three
//     key tiles an item); K/V tiles of 128 keys stream through a 2-stage
//     full/empty mbarrier ring that runs on across items, each stage with
//     its key-mask slice and an all-valid flag staged by the producer warp
//     (the flags read before the stage drains, the TMA issued before they
//     are written).  setmaxnreg moves the registers to the consumers
//     (240 / 232, producer 24);
//   * TMA cannot scale in flight, so each consumer warpgroup reads its Q
//     tile out of the swizzled box once an item into registers, as the A
//     fragments of S = Q K^T, multiplied by qscale and rounded on the way
//     (scale_pair); the wrapper makes no pass over q;
//   * S = Q K^T is then a register-A wgmma (m64n64, K K-major in 128-byte
//     swizzled boxes of 64 columns: hd 128 spans two), two per 128 keys,
//     reading only K from shared memory.  The online softmax runs on
//     the fp32 accumulators (a row's 4 threads reduce by quad shuffles); P
//     is rounded to bf16 in registers in the A-fragment order, so O += P V
//     is a register-A wgmma with V MN-major (the transpose flag), one
//     m64n64 per 64 head columns;
//   * a tile whose computed keys are all valid and below every row's
//     diagonal skips the per-element mask.  A tile of which the warpgroup
//     may see at most 16 keys (the CLIP shape's 257th key, or a causal
//     diagonal just past a tile boundary) runs as m64n16 and one 16-key
//     step of P V, a quarter or less of a full tile's products;
//   * each warpgroup counts its own key tiles (its 64 rows' diagonal), and
//     only waits out and releases the tiles past its count;
//   * O / l is written as bf16 into the warpgroup's own Q box (read into
//     registers at the item's start; each thread writes only what it read)
//     in the swizzled layout, then stored by TMA (rows past L are
//     clipped); the slot is released once the store has read it;
//   * items go in head groups of about one wave, the last query tiles (the
//     most keys under a causal mask) first (head_group_tile), dealt to the
//     CTAs in a serpentine (item_at).
// chip_smoke.py prints ptxas's lines and the SASS counts; measured times
// are in PERF.md.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace moka_flash;
using namespace moka_hopper;

constexpr int BK = 128;        // keys a tile
constexpr int NARROW = 16;     // keys of a narrow tile
constexpr int BOX = 64 * 128;  // bytes of a 64-row x 64-column bf16 box

template <int HD>
struct Cfg {
  static constexpr int NC = HD == 128 ? 2 : 1;  // consumer warpgroups
  static constexpr int MIN_CTAS = 3 - NC;       // CTAs an SM
  static constexpr int BQ = 64 * NC;            // query rows an item
  static constexpr int HALVES = HD / 64;        // 64-column boxes a row
  static constexpr int STAGES = 2;              // key-side ring
  static constexpr int QSLOTS = 2;              // items' Q tiles in flight
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int REGS = NC == 2 ? 240 : 232;  // a consumer thread
  static constexpr int Q_TILE = NC * HALVES * BOX;  // an item's Q
  static constexpr int KV_TILE = HALVES * 2 * BOX;  // K or V: 128 rows
  static constexpr int MASK_INTS = BK + 4;  // key valid flags, all-valid
  // shared memory, byte offsets from a 1024-aligned base
  static constexpr int OFF_Q = 0;  // QSLOTS tiles; out on the way back
  static constexpr int OFF_K = OFF_Q + QSLOTS * Q_TILE;  // STAGES tiles
  static constexpr int OFF_V = OFF_K + STAGES * KV_TILE;
  static constexpr int OFF_MASK = OFF_V + STAGES * KV_TILE;
  // q full, q empty (QSLOTS each), kv full, kv empty (STAGES each)
  static constexpr int OFF_BAR = OFF_MASK + STAGES * MASK_INTS * 4;
  static constexpr int SMEM = OFF_BAR + 16 * (QSLOTS + STAGES) + 1024;
};

struct Args {
  const int* mask;
  float* lse;
  int H, KH, L, S, q_offset, causal;
  int n_bh, n_qt;  // batch*heads, query tiles a head
  int group;       // heads a group of items (head_group_tile)
  float qscale;
};

// keys [0, kv_end) that rows up to `last` may see (before padding)
__device__ __forceinline__ int kv_end(const Args& a, int last) {
  return a.causal ? min(a.S, max(0, a.q_offset + last + 1)) : a.S;
}

// One key tile of one consumer warpgroup: S = Q K^T over N keys (128: two
// m64n64 products a 16-column step of Q, or 16: one m64n16; Q from the A
// fragments qf), the mask where MASK, the online softmax update and
// O += P V.  Accumulator element i of a thread holds row row0 + 8 u
// (u = (i >> 1) & 1) and key column c = 8 (i >> 2) + 2 t + (i & 1) of the
// tile; A-fragment register r of 16-key step kk holds elements 8 kk + 2 r,
// + 1.
template <int HD, int N, bool MASK>
__device__ __forceinline__ void fwd_tile(float (&o)[HD / 64][32],
                                         float (&m_run)[2], float (&l_run)[2],
                                         const uint32_t (&qf)[HD / 16][4],
                                         uint32_t ks, uint32_t vs,
                                         const int* ms, int k0, int pos0,
                                         int causal, int t) {
  constexpr int NS = N / 2;  // accumulator floats a thread
  float sc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t kd = ks + (kk / 4) * 2 * BOX + (kk % 4) * 32;
    if constexpr (N == BK) {
      wgmma_m64n64_rs<0>(*reinterpret_cast<float(*)[32]>(sc), qf[kk],
                         desc_sw128(kd), kk);
      wgmma_m64n64_rs<0>(*reinterpret_cast<float(*)[32]>(sc + 32), qf[kk],
                         desc_sw128(kd + 64 * 128), kk);
    } else {
      wgmma_m64n16_rs<0>(sc, qf[kk], desc_sw128(kd), kk);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_operand(sc);

  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int u = (i >> 1) & 1;
    if (MASK) {
      const int c = 8 * (i >> 2) + 2 * t + (i & 1);
      if (!ms[c] || (causal && pos0 + 8 * u < k0 + c)) sc[i] = NEG_INF;
    }
    mx[u] = fmaxf(mx[u], sc[i]);
  }
  float alpha[2], ls[2] = {0.f, 0.f};
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 1));
    mx[u] = fmaxf(mx[u], __shfl_xor_sync(0xffffffffu, mx[u], 2));
    alpha[u] = exp2_approx(m_run[u] - mx[u]);
    m_run[u] = mx[u];
  }
  uint32_t pa[N / 16][4];
#pragma unroll
  for (int i = 0; i < NS; i += 2) {
    const int u = (i >> 1) & 1;
    const float p0 = exp2_approx(sc[i] - mx[u]);
    const float p1 = exp2_approx(sc[i + 1] - mx[u]);
    ls[u] += p0 + p1;
    pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) l_run[u] = l_run[u] * alpha[u] + ls[u];

#pragma unroll
  for (int n = 0; n < HD / 64; ++n) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] *= alpha[(i >> 1) & 1];
    fence_operand(o[n]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int n = 0; n < HD / 64; ++n)
      wgmma_m64n64_rs<1>(o[n], pa[kk],
                         desc_sw128(vs + n * 2 * BOX + kk * 2048), 1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < HD / 64; ++n) fence_operand(o[n]);
}

// The work item a persistent CTA takes j-th: the linear item order
// (head_group_tile) dealt to the CTAs in a serpentine, so that heavy and
// light items tend to alternate on a CTA.  -1 past the last item.
__device__ __forceinline__ int item_at(const Args& a, int j, int& bh,
                                       int& qt) {
  const int c = blockIdx.x, n = gridDim.x;
  const int idx = j * n + ((j & 1) ? n - 1 - c : c);
  if (idx >= a.n_bh * a.n_qt) return -1;
  head_group_tile(idx, a.n_bh, a.n_qt, a.group, bh, qt);
  qt = a.n_qt - 1 - qt;  // the last query tiles (the most keys) first
  return idx;
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS, Cfg<HD>::MIN_CTAS)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_o, const Args a) {
  using C = Cfg<HD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // 1024-aligned, by arithmetic on the shared array itself so the compiler
  // keeps shared-memory loads and stores (not generic ones) on it
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(sm);
  const uint32_t bar_qfull = base + C::OFF_BAR;             // + 8 * slot
  const uint32_t bar_qempty = bar_qfull + 8 * C::QSLOTS;    // + 8 * slot
  const uint32_t bar_full = bar_qempty + 8 * C::QSLOTS;     // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;      // + 8 * stage
  int* masks = reinterpret_cast<int*>(sm + C::OFF_MASK);

  const int tid = threadIdx.x;
  const int L = a.L, S = a.S;

  if (tid == 0) {
    for (int s = 0; s < C::QSLOTS; ++s) {
      mbar_init(bar_qfull + 8 * s, 1);
      mbar_init(bar_qempty + 8 * s, C::NC);
    }
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 33);  // the TMA bytes' and 32 lanes'
      mbar_init(bar_empty + 8 * s, 128 * C::NC);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Both roles walk the same items and key tiles: item j's Q in slot
  // j % QSLOTS, the CTA's c-th key tile in stage c % STAGES.
  if (tid >= 128 * C::NC) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<24>();
    if (tid < 128 * C::NC + 32) {
      const int lane = tid & 31;
      int bh, qt;
      for (int j = 0, c = 0; item_at(a, j, bh, qt) >= 0; ++j) {
        const int b = bh / a.H, h = bh % a.H;
        const int kh = h / (a.H / a.KH);
        const int q0 = qt * C::BQ;
        const int n_tiles = (kv_end(a, min(q0 + C::BQ, L) - 1) + BK - 1) / BK;
        const int slot = j % C::QSLOTS;
        if (lane == 0) {
          // the boxes of warpgroups with rows (a box wholly past L is
          // skipped), once the slot's last item has stored its output
          mbar_wait(bar_qempty + 8 * slot, ((j / C::QSLOTS) & 1) ^ 1);
          const int live = min(C::NC, (L - q0 + 63) / 64);
          const uint32_t full = bar_qfull + 8 * slot;
          mbar_arrive_expect_tx(full, live * C::HALVES * BOX);
          for (int w = 0; w < live; ++w)
            for (int half = 0; half < C::HALVES; ++half)
              tma_load_4d(base + C::OFF_Q + slot * C::Q_TILE +
                              (w * C::HALVES + half) * BOX,
                          &tm_q, full, 64 * half, h, q0 + 64 * w, b,
                          l2_evict_first());
        }
        const int* mb = a.mask + static_cast<long>(b) * S;
        for (int it = 0; it < n_tiles; ++it, ++c) {
          const int s = c % C::STAGES;
          const int k0 = it * BK;
          // the tile's key flags, read while the stage drains
          int ok[BK / 32];
#pragma unroll
          for (int i = 0; i < BK / 32; ++i) {
            const int key = k0 + lane + 32 * i;
            ok[i] = key < S && mb[key] > 0;
          }
          mbar_wait(bar_empty + 8 * s, ((c / C::STAGES) & 1) ^ 1);
          const uint32_t full = bar_full + 8 * s;
          if (lane == 0) {  // one arrival with the bytes, then the loads
            mbar_arrive_expect_tx(full, 2 * C::KV_TILE);
            for (int half = 0; half < C::HALVES; ++half) {
              tma_load_4d(base + C::OFF_K + s * C::KV_TILE + half * 2 * BOX,
                          &tm_k, full, 64 * half, kh, k0, b, l2_evict_last());
              tma_load_4d(base + C::OFF_V + s * C::KV_TILE + half * 2 * BOX,
                          &tm_v, full, 64 * half, kh, k0, b, l2_evict_last());
            }
          }
          int* ms = masks + s * C::MASK_INTS;
          bool all = true;
#pragma unroll
          for (int i = 0; i < BK / 32; ++i) {
            ms[lane + 32 * i] = ok[i];
            all = all && ok[i];
          }
          all = __all_sync(0xffffffffu, all);
          if (lane == 0) ms[BK] = all;
          mbar_arrive(full);  // and one from each lane once its flags are in
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<C::REGS>();
    // this warpgroup's 64 rows of an item; the shuffle tells the compiler
    // the value is warp-uniform, so the descriptors built from it stay in
    // uniform registers
    const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
    const int warp = (tid % 128) / 32, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = 16 * warp + g;  // this thread's rows: row0, row0 + 8
    int bh, qt;
    for (int j = 0, c = 0; item_at(a, j, bh, qt) >= 0; ++j) {
      const int b = bh / a.H, h = bh % a.H;
      const int q0 = qt * C::BQ;
      const int n_tiles = (kv_end(a, min(q0 + C::BQ, L) - 1) + BK - 1) / BK;
      const int q0w = q0 + 64 * wg;
      const int pos0 = a.q_offset + q0w + row0;  // row0's key-axis position
      const int kv_w = q0w < L ? kv_end(a, min(q0w + 64, L) - 1) : 0;
      const int n_w = (kv_w + BK - 1) / BK;  // key tiles this warpgroup runs
      const int slot = j % C::QSLOTS;
      const uint32_t qs =
          base + C::OFF_Q + slot * C::Q_TILE + wg * C::HALVES * BOX;
      uint8_t* qb = sm + (qs - base);

      // Q * qscale, rounded to bf16, as the A fragments of S = Q K^T: in
      // step kk (head columns 16 kk ..) register r holds rows row0 (r even)
      // or row0 + 8, columns 2 t, 2 t + 1 (+ 8 for r >= 2); row r's 16-byte
      // chunk ch sits at ch ^ (r % 8) = ch ^ g in the swizzled box
      mbar_wait(bar_qfull + 8 * slot, (j / C::QSLOTS) & 1);
      uint32_t qf[HD / 16][4];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int ch = 2 * (kk % 4) + (r >> 1);
          qf[kk][r] = scale_pair(
              *reinterpret_cast<const uint32_t*>(
                  qb + (kk / 4) * BOX + (row0 + 8 * (r & 1)) * 128 +
                  ((ch ^ g) << 4) + 4 * t),
              a.qscale);
        }

      float o[C::HALVES][32];
#pragma unroll
      for (int n = 0; n < C::HALVES; ++n)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
      float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
      for (int it = 0; it < n_tiles; ++it) {
        const int s = (c + it) % C::STAGES;
        mbar_wait(bar_full + 8 * s, ((c + it) / C::STAGES) & 1);
        const int k0 = it * BK;
        const int* ms = masks + s * C::MASK_INTS;
        const uint32_t ks = base + C::OFF_K + s * C::KV_TILE;
        const uint32_t vs = base + C::OFF_V + s * C::KV_TILE;
        if (it >= n_w) {  // past these rows' diagonal
        } else if (kv_w - k0 <= NARROW) {
          fwd_tile<HD, NARROW, true>(o, m_run, l_run, qf, ks, vs, ms,
                                            k0, pos0, a.causal, t);
        } else if (!ms[BK] ||
                   (a.causal && a.q_offset + q0w < k0 + BK - 1)) {
          fwd_tile<HD, BK, true>(o, m_run, l_run, qf, ks, vs, ms, k0,
                                        pos0, a.causal, t);
        } else {
          fwd_tile<HD, BK, false>(o, m_run, l_run, qf, ks, vs, ms, k0,
                                         pos0, a.causal, t);
        }
        mbar_arrive(bar_empty + 8 * s);  // K, V and the mask slice consumed
      }
      c += n_tiles;

      // full row sums over the 4 threads of a row; a row that saw no key
      // (its max still the masked score) reads 0
      float inv[2], lse_row[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        l_run[u] += __shfl_xor_sync(0xffffffffu, l_run[u], 1);
        l_run[u] += __shfl_xor_sync(0xffffffffu, l_run[u], 2);
        const bool dead = m_run[u] == NEG_INF || l_run[u] == 0.f;
        inv[u] = dead ? 0.f : 1.f / l_run[u];
        lse_row[u] =
            dead ? NEG_INF * LN2 : (m_run[u] + log2f(l_run[u])) * LN2;
      }
      if (q0w < L) {
        // out as bf16 into the Q box (each thread writes what it read):
        // row r's 16-byte chunk j at j ^ (r % 8), as the tensor map's
        // 128-byte swizzle reads it
#pragma unroll
        for (int n = 0; n < C::HALVES; ++n)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const int row = row0 + 8 * u;
              *reinterpret_cast<uint32_t*>(qb + n * BOX + row * 128 +
                                           ((jj ^ (row & 7)) << 4) + 4 * t) =
                  pack_bf16(o[n][4 * jj + 2 * u] * inv[u],
                            o[n][4 * jj + 2 * u + 1] * inv[u]);
            }
        fence_proxy_async_smem();
        named_bar_sync(1 + wg, 128);
        if (t == 0) {
          float* lb = a.lse + static_cast<long>(bh) * L + q0w;
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (q0w + row0 + 8 * u < L) lb[row0 + 8 * u] = lse_row[u];
        }
      }
      if (tid % 128 == 0) {
        if (q0w < L) {
          for (int n = 0; n < C::HALVES; ++n)
            tma_store_4d(&tm_o, qs + n * BOX, 64 * n, h, q0w, b,
                         l2_evict_first());
          bulk_commit();
          bulk_wait_read<0>();
        }
        mbar_arrive(bar_qempty + 8 * slot);  // the slot may take a new Q
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           const Args& a, int B, void* stream) {
  using C = Cfg<HD>;
  auto kernel = flash_fwd_kernel<HD>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // q/out over (hd, H, L, B) and k/v over (hd, KH, S, B), boxes of 64 head
  // columns: a ragged L or S is zero-filled (loads) or clipped (stores)
  // within each batch row
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t q_dims[4] = {HD, uint64_t(a.H), uint64_t(a.L), uint64_t(B)};
  const uint64_t k_dims[4] = {HD, uint64_t(a.KH), uint64_t(a.S), uint64_t(B)};
  const uint32_t q_box[4] = {64, 1, 64, 1}, k_box[4] = {64, 1, BK, 1};
  if (!swizzled_map(&tm_q, bf16, 2, 4, q, q_dims, q_box) ||
      !swizzled_map(&tm_o, bf16, 2, 4, out, q_dims, q_box) ||
      !swizzled_map(&tm_k, bf16, 2, 4, k, k_dims, k_box) ||
      !swizzled_map(&tm_v, bf16, 2, 4, v, k_dims, k_box))
    return static_cast<int>(cudaErrorInvalidValue);
  // persistent: at most MIN_CTAS CTAs an SM, each walking items
  Args g = a;
  g.n_bh = B * a.H;
  g.n_qt = (a.L + C::BQ - 1) / C::BQ;
  const int ctas = sm_count() * C::MIN_CTAS;
  g.group = max(1, ctas / g.n_qt);
  kernel<<<min(ctas, g.n_bh * g.n_qt), C::THREADS, C::SMEM,
           static_cast<cudaStream_t>(stream)>>>(tm_q, tm_k, tm_v, tm_o, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/out (B, L, H, hd) bf16, k/v (B, S, KH, hd) bf16 with hd 128 (LLaMA-2) or
// 64 (the CLIP ViT-L/14 tower), mask (B, S) int32, lse (B, H, L) fp32; all
// contiguous and 16-byte aligned.  Returns cudaGetLastError() after the
// launch, or the error of the shared-memory attribute, or
// cudaErrorInvalidValue for bad dimensions or a tensor map the driver
// refuses.
extern "C" int moka_flash_fwd(const void* q, const void* k, const void* v,
                              const void* mask, void* out, void* lse, int B,
                              int H, int KH, int L, int S, int hd,
                              int q_offset, int causal, float qscale,
                              void* stream) {
  if (B <= 0 || L <= 0 || S <= 0 || KH <= 0 || H % KH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.mask = static_cast<const int*>(mask);
  a.lse = static_cast<float*>(lse);
  a.H = H;
  a.KH = KH;
  a.L = L;
  a.S = S;
  a.q_offset = q_offset;
  a.causal = causal;
  a.qscale = qscale;
  if (hd == 128) return launch<128>(q, k, v, out, a, B, stream);
  if (hd == 64) return launch<64>(q, k, v, out, a, B, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
