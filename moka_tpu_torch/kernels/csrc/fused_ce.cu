// Fused lm_head + cross-entropy forward on an int8 head for Hopper
// (sm_90a): TPU kernel 8 of moka_tpu/ops/fused_ce.py (_fwd_kernel :41,
// launched by _call_fwd :122).  The (N, V) logits never reach device
// memory: each CTA computes its logits tiles in registers and keeps only an
// online (max, sum, target) partial a row.  The backward (kernel 9) is
// fused_ce_bwd.cu.
//
// Contract (as the JAX kernel and fused_ce_fwd_plain): logits = (x @
// bf16(w_i8)) * scale[v] with bf16 x, exact bf16 products summed in fp32;
// phantom vocab columns (v >= V, the zero padding up to a multiple of 512)
// are -1e30.  Per row lse = m + log(l) (natural log) and nll = lse - target
// logit, the target picked by comparison (an ignored target matches no
// column).
//
// What bounds it (data sheet: 989 TFLOP/s bf16): 2 N d V operations, 1.085
// ms at route B's shape (N 4092, d 4096, V 32011; the head padded to Vp
// 32,256); its bytes (x 33.5 MB, the int8 head 132 MB) take 0.05 ms.  So
// the products should set the pace, but every operand passes through
// shared memory (128 B a clock an SM): a CTA's 16-deep step reads ≈ 12 KB
// of wgmma operands a warpgroup and lands or moves ≈ 20 KB of x, int8 and
// bf16 head tiles in the 246 clocks its products take at the data-sheet
// rate, ≈ 1.4x what the port delivers.  That, not L2, is what this kernel
// meets (PERF.md: halving the L2 bytes again, by x multicast, did not make
// it faster).  Bytes from L2 at route B's shape, by tiling:
//   tiling                                        head    x       widened
//   mma.sync, 64 rows, x again every 128 cols     8.4 GB  8.4 GB  8.5 G
//   128 rows x 256-column stages (kernel 9)       4.2     4.2     4.2
//   + clusters of 2 along the rows (this)         2.1     4.2     4.2
// The kernel this replaced (mma.sync, 7.70 ms) had three faults; what this
// one does about each:
//   1. small tiles: x re-read from L2 for every 128 vocab columns and the
//      head for every 64 rows (16.9 GB).  A CTA covers 128 rows x 512
//      columns in two 256-column stages, and the two CTAs of a cluster that
//      share columns (the row pair) receive each int8 head tile by TMA
//      multicast (each issues half of it to both), so L2 serves each head
//      byte once per 256 rows.  Clusters start in groups of ROW_GROUP row
//      pairs, column span by column span within a group, so the clusters
//      running together share their head tiles in L2 and x (33.5 MB) stays
//      there.  VOCAB_PAIR 2 also multicasts x along the vocab (2 x 2
//      clusters), which was slower, as was each CTA widening half of the
//      tile and storing the partner's half into its ring (PERF.md);
//   2. the widening on the conversion pipe (an I2F a code and an F2F a
//      pair, 16 a clock an SM): kernel 9's exact ALU routine (two LOP3s and
//      one bf16x2 FMA a pair, int8_bf16.cuh), which pairs columns (0, 2) and
//      (1, 3), so the kernel works in that order ("positions") and maps
//      positions to vocab columns only where it reads scale, masks the
//      phantom columns and compares the target;
//   3. nothing overlapped (the same warps loaded, widened and multiplied,
//      a one-stage ring): warp specialisation.  Two threads of a load
//      warpgroup (setmaxnreg 24) each keep one TMA stream as far ahead as
//      its ring allows (x 4 stages, int8 head 3); a converter warpgroup
//      (setmaxnreg 40) widens into a 3-stage bf16 ring; two consumer
//      warpgroups (setmaxnreg 224) only wait on barriers and issue wgmma:
//      each takes its 64 rows x a 256-column stage as two m64n128k16
//      products over bf16 x (K-major) and the bf16 head (MN-major), both
//      in 128-byte-swizzled shared memory (m64n256 does not fit the 128
//      registers a thread of a 512-thread CTA starts with).  After a
//      tile's products complete, each thread scales its columns by scale
//      log2 e, masks the phantom ones, picks the target and updates its
//      rows' running (max, sum) in base 2; the four threads of a row merge
//      theirs by shuffles once, at the end.
// A ring slot that the cluster fills by multicast goes back to every CTA
// that fills it: each converter warp (int8 ring; with VOCAB_PAIR 2 each
// consumer warp, x ring) arrives on its own and its partner's empty
// barrier.  Those arrivals release at CTA scope (the
// slot's reads have completed); a release at cluster scope cost 2.4x the
// kernel's time (PERF.md).  Every CTA of a cluster runs the same stages:
// one past the rows or the padded head receives TMA's zero fill, takes
// part in every multicast and barrier and writes no partial, and no CTA
// leaves before the cluster's last barrier.  A second small launch merges
// the spans' partials of each row.  Shared memory 216,224 bytes: one CTA an
// SM.  chip_smoke.py prints ptxas's lines and the SASS counts; measured
// times, and the ablation that says what bounds this design
// (profile_port.py fused_ce_fwd_ablation), are in PERF.md.

#include "flash_common.cuh"
#include "hopper.cuh"
#include "int8_bf16.cuh"

namespace {

using namespace moka_flash;
using namespace moka_hopper;
using namespace moka_int8;

constexpr int BR = 128;         // rows a CTA: two consumer warpgroups of 64
constexpr int SPAN = 512;       // vocab columns a CTA (fused_ce_bwd.cu's)
constexpr int TV = 256;         // vocab columns a stage and a logits tile
constexpr int NSUB = SPAN / TV;
constexpr int BK = 64;          // d rows a stage
constexpr int ROW_PAIR = 2;     // CTAs along the rows sharing each head tile
constexpr int VOCAB_PAIR = 1;   // CTAs along the vocab sharing each x tile
constexpr int CLUSTER = ROW_PAIR * VOCAB_PAIR;
constexpr int X_STAGES = 4;     // x ring (TMA -> consumers)
constexpr int W8_STAGES = 3;    // int8 head ring (TMA -> converters)
constexpr int W16_STAGES = 3;   // bf16 head ring (converters -> consumers)
constexpr int ROW_GROUP = 8;    // row pairs whose clusters start together
constexpr int LOGITS_N = 128;   // width of a logits wgmma
constexpr int CONVERT_UNROLL = 2;  // units a converter loads before storing
constexpr int NCONSUMER = 256;  // two consumer warpgroups
constexpr int NCONVERT = 128;   // converter warpgroups' threads (128, 256)
constexpr int CPT = NCONVERT / 64;  // converters a head row of a stage
constexpr int LOAD_REGS = 24, CONVERT_REGS = 40;  // setmaxnreg, and
constexpr int CONSUMER_REGS = NCONVERT > 128 ? 184 : 224;  // the consumers'
constexpr int NLOAD = 128;      // a load warpgroup: two warps issue TMA loads
constexpr int NTHREADS = NCONSUMER + NCONVERT + NLOAD;
constexpr int BOX = 64 * 128;   // bytes of a 64-row x 128-byte box
// setmaxnreg.inc draws only on what other warps released by .dec, never on
// the rest of the register file: the consumers' rise must fit in the loads'
// and converters' fall from the entry count (65,536 / threads, in 8s), or
// it waits for ever
constexpr int ENTRY_REGS = 65536 / NTHREADS / 8 * 8;
static_assert(NLOAD * (ENTRY_REGS - LOAD_REGS) +
                      NCONVERT * (ENTRY_REGS - CONVERT_REGS) >=
                  NCONSUMER * (CONSUMER_REGS - ENTRY_REGS),
              "the consumers' registers must come from the other warps");

constexpr int X_BYTES = BR * BK * 2;      // 128 rows x 64 d bf16, two boxes
constexpr int W8_BYTES = BK * TV;         // 64 d x 256 int8, two boxes
constexpr int W16_BYTES = BK * TV * 2;    // 64 d x 256 bf16, four boxes
constexpr int UNITS_EACH = BK * TV / 16 / NCONVERT;  // 16-code units
static_assert(UNITS_EACH % CONVERT_UNROLL == 0,
              "a converter's units: whole unrolled groups");
static_assert(CPT == 2 || CPT == 4, "2 or 4 converters a head row");
static_assert(ROW_PAIR <= 2 && VOCAB_PAIR <= 2,
              "x and the head come as two halves");

// shared memory, byte offsets from a 1024-aligned base
constexpr int OFF_X = 0;
constexpr int OFF_W8 = OFF_X + X_STAGES * X_BYTES;
constexpr int OFF_W16 = OFF_W8 + W8_STAGES * W8_BYTES;
constexpr int OFF_COEF = OFF_W16 + W16_STAGES * W16_BYTES;  // scale log2 e
constexpr int OFF_BAR = OFF_COEF + SPAN * 4;
constexpr int N_BARS = 2 * (X_STAGES + W8_STAGES + W16_STAGES);
constexpr int SMEM_BYTES = OFF_BAR + 8 * N_BARS + 1024;
static_assert(SMEM_BYTES <= 232448, "one CTA an SM: 227 KB");

struct Args {
  const float* scale;  // (ldw,) fp32
  const int* targets;  // (N,) int32, an ignored one matches no column
  float* part;         // (3, ldw / SPAN, N): max (natural log), sum, target
  int n_rows, d, ldw, v_real;
  Widen k;
};

// the CTA's place: rows [row0, row0 + BR), vocab columns [v_span, v_span +
// SPAN), its rank's coordinates in the cluster (rr along the rows, vs along
// the vocab: rank = vs * ROW_PAIR + rr), and whether it writes partials
struct Tile {
  int row0, v_span, span, rr, vs;
  bool real;
};

// Clusters in groups of ROW_GROUP row pairs, column pair by column pair
// within a group, the row pair fastest; the grid is rounded up to whole
// clusters, so a CTA may lie past the rows or the padded head (not real)
__device__ __forceinline__ Tile tile_of(const Args& a, uint32_t rank) {
  Tile t;
  t.rr = rank % ROW_PAIR;
  t.vs = rank / ROW_PAIR;
  const int n_rb = (a.n_rows + BR - 1) / BR, n_span = a.ldw / SPAN;
  const int n_rp = (n_rb + ROW_PAIR - 1) / ROW_PAIR;
  const int n_sp = (n_span + VOCAB_PAIR - 1) / VOCAB_PAIR;
  const int c = blockIdx.x / CLUSTER;
  const int group = min(ROW_GROUP, n_rp);
  const int gi = c / (group * n_sp), rest = c % (group * n_sp);
  const int here = min(group, n_rp - gi * group);
  const int rb = (gi * group + rest % here) * ROW_PAIR + t.rr;
  t.span = (rest / here) * VOCAB_PAIR + t.vs;
  t.row0 = rb * BR;
  t.v_span = t.span * SPAN;
  t.real = rb < n_rb && t.span < n_span;
  return t;
}

// the TMA of x for stage i (128 rows x 64 d from d0) into ring slot i %
// X_STAGES of every CTA of the vocab pair: this CTA issues the 64-row
// halves h = vs (mod VOCAB_PAIR), each multicast to the pair, and expects
// the whole tile on its own barrier, once the slot is free in both CTAs
__device__ __forceinline__ void load_x(uint32_t base, const CUtensorMap* tm,
                                       uint32_t full, uint32_t empty, int i,
                                       int d0, const Tile& t, uint16_t mask) {
  const int s = i % X_STAGES;
  mbar_wait_cluster(empty + 8 * s, ((i / X_STAGES) & 1) ^ 1);
  mbar_arrive_expect_tx(full + 8 * s, X_BYTES);
  const uint32_t dst = base + OFF_X + s * X_BYTES;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h % VOCAB_PAIR != t.vs) continue;
    if constexpr (VOCAB_PAIR > 1)
      tma_load_4d_multicast(dst + h * BOX, tm, full + 8 * s, mask, d0,
                            t.row0 + 64 * h, 0, 0);
    else
      tma_load_4d(dst + h * BOX, tm, full + 8 * s, d0, t.row0 + 64 * h, 0,
                  0);
  }
}

// the TMA of the head for stage i (64 d rows from d0, 256 columns from v0,
// one int8 box a 128 columns) into ring slot i % W8_STAGES of every CTA of
// the row pair: this CTA issues the boxes b = rr (mod ROW_PAIR), each
// multicast to the pair, and expects the whole tile on its own barrier,
// once the slot is free in both CTAs
__device__ __forceinline__ void load_w8(uint32_t base, const CUtensorMap* tm,
                                        uint32_t full, uint32_t empty, int i,
                                        int d0, int v0, const Tile& t,
                                        uint16_t mask) {
  const int s = i % W8_STAGES;
  mbar_wait_cluster(empty + 8 * s, ((i / W8_STAGES) & 1) ^ 1);
  mbar_arrive_expect_tx(full + 8 * s, W8_BYTES);
  const uint32_t dst = base + OFF_W8 + s * W8_BYTES;
#pragma unroll
  for (int b = 0; b < TV / 128; ++b) {
    if (b % ROW_PAIR != t.rr) continue;
    if constexpr (ROW_PAIR > 1)
      tma_load_4d_multicast(dst + b * BOX, tm, full + 8 * s, mask,
                            v0 + 128 * b, d0, 0, 0);
    else
      tma_load_4d(dst + b * BOX, tm, full + 8 * s, v0 + 128 * b, d0, 0, 0);
  }
}

// A converter's unit u of a stage: 16 codes of head row r at columns 16 cc
// .., cc = CPT u + c0 (c0: the thread's column share), widened into the
// same positions of the bf16 stage; eight neighbouring threads take eight
// rows, so with the swizzle their 16-byte loads and stores fall on
// distinct banks.  src_row / dst_row: row r of the int8 and bf16 stages;
// q8 = (c0 ^ r % 8) << 4, q16 = (2 c0 ^ r % 8) << 4.
__device__ __forceinline__ uint4 load_unit(const uint8_t* src_row, int q8,
                                           int u) {
  // chunk cc % 8 ^ r % 8 of int8 box cc / 8
  return *reinterpret_cast<const uint4*>(
      src_row + (u / (8 / CPT)) * BOX + (q8 ^ (((u % (8 / CPT)) * CPT) << 4)));
}

// the widened unit into the bf16 stage
__device__ __forceinline__ void store_unit(uint8_t* dst_row, int q16, int u,
                                           const uint4& raw, const Widen& k) {
  uint4 lo, hi;  // positions 16 cc + 0..7 and + 8..15
  widen(raw.x, k, lo.x, lo.y);
  widen(raw.y, k, lo.z, lo.w);
  widen(raw.z, k, hi.x, hi.y);
  widen(raw.w, k, hi.z, hi.w);
  // chunks 2 (cc % 4) and + 1, each ^ r % 8, of bf16 box cc / 4
  const int c =
      (u / (4 / CPT)) * BOX + (q16 ^ (((u % (4 / CPT)) * CPT * 2) << 4));
  *reinterpret_cast<uint4*>(dst_row + c) = lo;
  *reinterpret_cast<uint4*>(dst_row + (c ^ 16)) = hi;
}

// a converter's units of one stage, CONVERT_UNROLL loads at a time
__device__ __forceinline__ void convert_stage(const uint8_t* src_row,
                                              uint8_t* dst_row, int q8,
                                              int q16,
                                              const Widen& k) {
#pragma unroll
  for (int u0 = 0; u0 < UNITS_EACH; u0 += CONVERT_UNROLL) {
    uint4 raw[CONVERT_UNROLL];
#pragma unroll
    for (int j = 0; j < CONVERT_UNROLL; ++j)
      raw[j] = load_unit(src_row, q8, u0 + j);
#pragma unroll
    for (int j = 0; j < CONVERT_UNROLL; ++j)
      store_unit(dst_row, q16, u0 + j, raw[j], k);
  }
}

// S += X W over one 16-deep step of d: TV / LOGITS_N wgmmas of 64 rows x
// LOGITS_N positions, A = x (K-major) and B = the bf16 head stage at wb
// (MN-major: four boxes of 64 positions, BOX apart)
__device__ __forceinline__ void logits_step(
    float (&acc)[TV / LOGITS_N][LOGITS_N / 2], uint64_t da, uint32_t wb) {
#pragma unroll
  for (int nb = 0; nb < TV / LOGITS_N; ++nb)
    wgmma_m64n128_ss<1>(acc[nb], da, desc_sw128_mn(wb + 2 * nb * BOX, BOX),
                        1);
}

// One 256-column tile's online-softmax update of this thread's two rows
// (max m and sum l of exp2(logit - m), base 2) from the raw products acc:
// element 4 q + 2 h + k of acc[nb] is row half h, position 128 nb + 8 q +
// 2 t + k, and its base-2 logit is acc times clj[128 nb + 8 q + k] (scale
// log2 e from position 2 t), -1e30 on a phantom column where TAIL (v_sub:
// the tile's first column).  The accumulators are only read: the logits
// are computed again in the second pass.
template <bool TAIL>
__device__ __forceinline__ void tile_softmax(
    const float (&acc)[TV / LOGITS_N][LOGITS_N / 2], const float* clj, int t,
    int v_sub, int v_real, float (&m)[2], float (&l)[2]) {
  constexpr int NB = TV / LOGITS_N, NQ = LOGITS_N / 8;
  auto logits = [&](int nb, int q, int h, float& z0, float& z1) {
    const float2 c2 =
        *reinterpret_cast<const float2*>(clj + 128 * nb + 8 * q);
    z0 = acc[nb][4 * q + 2 * h] * c2.x;
    z1 = acc[nb][4 * q + 2 * h + 1] * c2.y;
    if constexpr (TAIL) {
      const int p = 128 * nb + 8 * q + 2 * t;
      if (v_sub + swap_low_bits(p) >= v_real) z0 = NEG_INF;
      if (v_sub + swap_low_bits(p + 1) >= v_real) z1 = NEG_INF;
    }
  };
  float mx[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float z0, z1;
        logits(nb, q, h, z0, z1);
        mx[h] = fmaxf(mx[h], fmaxf(z0, z1));
      }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float z0, z1;
        logits(nb, q, h, z0, z1);
        sum[h] += exp2_approx(z0 - mx[h]) + exp2_approx(z1 - mx[h]);
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = l[h] * exp2_approx(m[h] - mx[h]) + sum[h];
    m[h] = mx[h];
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __cluster_dims__(CLUSTER, 1, 1)
    __launch_bounds__(NTHREADS, 1)
    fused_ce_fwd_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w,
                        const Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(sm);
  const uint32_t full_x = base + OFF_BAR;              // + 8 * stage
  const uint32_t empty_x = full_x + 8 * X_STAGES;
  const uint32_t full_w8 = empty_x + 8 * X_STAGES;
  const uint32_t empty_w8 = full_w8 + 8 * W8_STAGES;
  const uint32_t full_w16 = empty_w8 + 8 * W8_STAGES;
  const uint32_t empty_w16 = full_w16 + 8 * W16_STAGES;

  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();
  const Tile tl = tile_of(a, rank);
  // the partners: the vocab pair's rank sharing x (rank ^ ROW_PAIR) and the
  // row pair's sharing the head (rank ^ 1)
  const uint32_t x_partner = VOCAB_PAIR > 1 ? rank ^ ROW_PAIR : rank;
  const uint32_t w_partner = ROW_PAIR > 1 ? rank ^ 1 : rank;
  const int nk = a.d / BK, n_stages = NSUB * nk;

  if (tid == 0) {
    for (int s = 0; s < X_STAGES; ++s) {
      mbar_init(full_x + 8 * s, 1);
      mbar_init(empty_x + 8 * s, (NCONSUMER / 32) * VOCAB_PAIR);
    }
    for (int s = 0; s < W8_STAGES; ++s) {
      mbar_init(full_w8 + 8 * s, 1);
      mbar_init(empty_w8 + 8 * s, (NCONVERT / 32) * ROW_PAIR);
    }
    for (int s = 0; s < W16_STAGES; ++s) {
      mbar_init(full_w16 + 8 * s, NCONVERT / 32);
      mbar_init(empty_w16 + 8 * s, NCONSUMER / 32);
    }
    mbar_fence_init();
  }
  // every CTA's barriers are initialised before any partner arrives on them
  // or multicasts into them
  cluster_sync();

  // stage i: 256-column tile i / nk of the span, d step i % nk
  auto stage_d0 = [nk](int i) { return (i % nk) * BK; };
  auto stage_v0 = [nk, &tl](int i) { return tl.v_span + (i / nk) * TV; };

  if (tid >= NCONSUMER + NCONVERT) {
    // ------------------------------------------------------------- loads
    // two threads, each a stream of TMA loads as far ahead as its ring
    // allows (its slots released by every CTA it fills): x to the vocab
    // pair, the int8 head to the row pair
    setmaxnreg_dec<LOAD_REGS>();
    const int ltid = tid - NCONSUMER - NCONVERT;
    if (ltid == 0) {
      uint16_t x_mask = 0;  // the vocab pair: ranks vs * ROW_PAIR + rr
      for (int v = 0; v < VOCAB_PAIR; ++v)
        x_mask |= 1u << (v * ROW_PAIR + tl.rr);
      for (int i = 0; i < n_stages; ++i)
        load_x(base, &tm_x, full_x, empty_x, i, stage_d0(i), tl, x_mask);
    } else if (ltid == 32) {
      uint16_t w_mask = 0;  // the row pair: ranks vs * ROW_PAIR + r
      for (int r = 0; r < ROW_PAIR; ++r)
        w_mask |= 1u << (tl.vs * ROW_PAIR + r);
      for (int i = 0; i < n_stages; ++i)
        load_w8(base, &tm_w, full_w8, empty_w8, i, stage_d0(i), stage_v0(i),
                tl, w_mask);
    }
  } else if (tid >= NCONSUMER) {
    // ---------------------------------------------------------- converters
    setmaxnreg_dec<CONVERT_REGS>();
    const int ctid = tid - NCONSUMER, lane = tid & 31;
    // this thread's head row r and column share c0 (units CPT u + c0)
    const int r = ctid & (BK - 1), c0 = ctid / BK, sw = r & 7;
    const int q8 = (c0 ^ sw) << 4, q16 = ((2 * c0) ^ sw) << 4;
    const Widen k = a.k;
    uint8_t* dst0 = sm + OFF_W16 + r * 128;
    const uint32_t fw_own = cluster_map(full_w16, rank);
    const uint32_t e8_own = cluster_map(empty_w8, rank);
    const uint32_t e8_partner = cluster_map(empty_w8, w_partner);
    for (int i = 0; i < n_stages; ++i) {
      const int s8 = i % W8_STAGES, s16 = i % W16_STAGES;
      mbar_wait_cluster(full_w8 + 8 * s8, (i / W8_STAGES) & 1);
      // the bf16 slot is free
      mbar_wait_cluster(empty_w16 + 8 * s16, ((i / W16_STAGES) & 1) ^ 1);
      convert_stage(sm + OFF_W8 + s8 * W8_BYTES + r * 128,
                    dst0 + s16 * W16_BYTES, q8, q16, k);
      // the warp's widened rows are visible to the wgmma (async proxy) once
      // the barrier completes, and its int8 rows are read before the slot
      // is refilled
      fence_proxy_async_smem();
      __syncwarp();
      mbar_arrive_remote(fw_own + 8 * s16, lane == 0);
      mbar_arrive_remote(e8_own + 8 * s8, lane == 0);
      if constexpr (ROW_PAIR > 1)
        mbar_arrive_remote(e8_partner + 8 * s8, lane == 0);
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<CONSUMER_REGS>();
    // warp-uniform, so the descriptors built from it live in uniform
    // registers
    const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
    const int warp = (tid % 128) / 32, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;

    // the span's scale * log2 e in position order (0 past V)
    float* cl = reinterpret_cast<float*>(sm + OFF_COEF);
    for (int p = tid; p < SPAN; p += NCONSUMER) {
      const int v = tl.v_span + swap_low_bits(p);
      cl[p] = v < a.v_real ? a.scale[v] * LOG2E : 0.f;
    }
    // this thread's rows and their targets' columns in the span (-1: none)
    int rows[2], tc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rows[h] = tl.row0 + 64 * wg + 16 * warp + g + 8 * h;
      const int tv =
          (rows[h] < a.n_rows ? a.targets[rows[h]] : -1) - tl.v_span;
      tc[h] = tv >= 0 && tv < SPAN ? tv : -1;
    }
    named_bar_sync(1, NCONSUMER);

    // a stage's slots go back to every CTA that fills them: x to the vocab
    // pair, the bf16 head to this CTA's converters; one arrival a warp
    const uint32_t ex_own = cluster_map(empty_x, rank);
    const uint32_t ex_partner = cluster_map(empty_x, x_partner);
    const uint32_t ew_own = cluster_map(empty_w16, rank);
    auto release = [&](int i) {
      const int sx = 8 * (i % X_STAGES), sw = 8 * (i % W16_STAGES);
      mbar_arrive_remote(ex_own + sx, lane == 0);
      if constexpr (VOCAB_PAIR > 1)
        mbar_arrive_remote(ex_partner + sx, lane == 0);
      mbar_arrive_remote(ew_own + sw, lane == 0);
    };

    // each row's running max (base 2: logits times log2 e), sum of
    // exp2(logit - max) and the target's unscaled product, over this
    // thread's positions
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, hit[2] = {0.f, 0.f};
    int i = 0;
#pragma unroll 1
    for (int j = 0; j < NSUB; ++j) {
      // S = X W over d: 64 rows x positions [256 j, 256 j + 256); element
      // e of acc[nb] is row 16 warp + g + 8 ((e >> 1) & 1), position 128 nb
      // + 8 (e >> 2) + 2 t + (e & 1)
      constexpr int NA = LOGITS_N / 2;
      float acc[TV / LOGITS_N][NA];
#pragma unroll
      for (int e = 0; e < 128; ++e) acc[e / NA][e % NA] = 0.f;
      for (int ks = 0; ks < nk; ++ks, ++i) {
        const int sx = i % X_STAGES, sw = i % W16_STAGES;
        mbar_wait_cluster(full_x + 8 * sx, (i / X_STAGES) & 1);
        mbar_wait_cluster(full_w16 + 8 * sw, (i / W16_STAGES) & 1);
        const uint32_t xa = base + OFF_X + sx * X_BYTES + wg * BOX;
        const uint32_t wb = base + OFF_W16 + sw * W16_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          logits_step(acc, desc_sw128(xa + kk * 32), wb + kk * 2048);
        wgmma_commit();
        if (ks > 0) {  // the previous stage's products are done
          wgmma_wait<1>();
          release(i - 1);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < TV / LOGITS_N; ++nb) fence_operand(acc[nb]);
      release(i - 1);

      // the target's unscaled product, where it lies in this tile and in
      // this thread's positions (p - 2 t matches no element otherwise)
      const int v_sub = tl.v_span + TV * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int tp = tc[h] - TV * j;
        if (tp >= 0 && tp < TV) {
          const int want = swap_low_bits(tp) - 2 * t;
#pragma unroll
          for (int e = 0; e < 128; ++e)
            if (((e >> 1) & 1) == h &&
                128 * (e / NA) + 8 * ((e % NA) >> 2) + (e & 1) == want)
              hit[h] = acc[e / NA][e % NA];
        }
      }
      // phantom columns lie only in the head's last span
      const float* clj = cl + TV * j + 2 * t;
      if (v_sub + TV > a.v_real)
        tile_softmax<true>(acc, clj, t, v_sub, a.v_real, m, l);
      else
        tile_softmax<false>(acc, clj, t, v_sub, a.v_real, m, l);
    }

    // the row's four threads merge their (max, sum, target); partials in
    // natural-log units for the merge
    const size_t plane = static_cast<size_t>(a.ldw / SPAN) * a.n_rows;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mr = quad_max(m[h]);
      const float lr = quad_sum(l[h] * exp2_approx(m[h] - mr));
      const float hr = quad_sum(hit[h]);
      if (t == 0 && tl.real && rows[h] < a.n_rows) {
        const size_t at = static_cast<size_t>(tl.span) * a.n_rows + rows[h];
        a.part[at] = mr * LN2;
        a.part[plane + at] = lr;
        a.part[2 * plane + at] =
            tc[h] >= 0 ? hr * a.scale[tl.v_span + tc[h]] : 0.f;
      }
    }
  }
  // no CTA leaves while a partner may still write into its shared memory
  // or arrive on its barriers
  cluster_sync();
}

// Kernel 8's second launch: merge the spans' partials of each row.
__global__ void fused_ce_merge_kernel(const float* __restrict__ part,
                                      float* nll, float* lse, int n_rows,
                                      int n_spans) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const size_t plane = static_cast<size_t>(n_spans) * n_rows;
  float m = NEG_INF;
  for (int c = 0; c < n_spans; ++c)
    m = fmaxf(m, part[static_cast<size_t>(c) * n_rows + r]);
  float l = 0.f, tg = 0.f;
  for (int c = 0; c < n_spans; ++c) {
    const size_t at = static_cast<size_t>(c) * n_rows + r;
    l += part[plane + at] * expf(part[at] - m);
    tg += part[2 * plane + at];
  }
  const float out = m + logf(l);
  lse[r] = out;
  nll[r] = out - tg;
}

}  // namespace

extern "C" {

// x (n_rows, d) bf16; w (d, ldw) int8 with ldw % 512 == 0 and columns past
// v_real zero; scale (ldw,) fp32; targets (n_rows,) int32; part (3,
// ldw/512, n_rows) fp32 scratch; nll, lse (n_rows,) fp32.  d % 64 == 0,
// every tensor 16-byte aligned.  Returns cudaGetLastError() after the
// launches, the shared-memory attribute's error, or cudaErrorInvalidValue
// for bad dimensions or a tensor map cuTensorMapEncodeTiled refuses.
int moka_fused_ce_fwd(const void* x, const void* w, const void* scale,
                      const void* targets, void* part, void* nll, void* lse,
                      int n_rows, int d, int ldw, int v_real, void* stream) {
  if (n_rows <= 0 || d <= 0 || d % BK || ldw <= 0 || ldw % SPAN ||
      v_real > ldw)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // x over (d, N) in 64-row halves, the head over (ldw, d), each padded to
  // four dimensions; rows past N and columns past ldw load as zero
  CUtensorMap tm_x, tm_w;
  const uint64_t x_dims[4] = {uint64_t(d), uint64_t(n_rows), 1, 1};
  const uint64_t w_dims[4] = {uint64_t(ldw), uint64_t(d), 1, 1};
  const uint32_t x_box[4] = {64, 64, 1, 1}, w_box[4] = {128, BK, 1, 1};
  if (!swizzled_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 4, x, x_dims,
                    x_box) ||
      !swizzled_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 4, w, w_dims,
                    w_box))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.scale = static_cast<const float*>(scale);
  a.targets = static_cast<const int*>(targets);
  a.part = static_cast<float*>(part);
  a.n_rows = n_rows;
  a.d = d;
  a.ldw = ldw;
  a.v_real = v_real;
  a.k = {0x007f007fu, 0x00800080u, 0x43004300u, 0xc300c300u};  // 128.0,
                                                               // -128.0
  const int n_rb = (n_rows + BR - 1) / BR, n_span = ldw / SPAN;
  const int clusters = ((n_rb + ROW_PAIR - 1) / ROW_PAIR) *
                       ((n_span + VOCAB_PAIR - 1) / VOCAB_PAIR);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_ce_fwd_kernel<<<clusters * CLUSTER, NTHREADS, SMEM_BYTES, s>>>(
      tm_x, tm_w, a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ce_merge_kernel<<<(n_rows + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(nll),
      static_cast<float*>(lse), n_rows, n_span);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
