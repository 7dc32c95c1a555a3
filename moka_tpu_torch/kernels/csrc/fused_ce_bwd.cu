// Fused lm_head + cross-entropy backward on an int8 head for Hopper
// (sm_90a): TPU kernel 9 of moka_tpu/ops/fused_ce.py (_bwd_kernel :77,
// launched by _nll_rows_bwd :173).  The forward (kernel 8) is fused_ce.cu.
//
// Contract (as the JAX kernel and fused_ce_bwd_plain): logits = (x @
// bf16(w_i8)) * scale[v] with bf16 x, exact bf16 products summed in fp32;
// phantom vocab columns (v >= V, the zero padding up to a multiple of 512)
// are -1e30, so their p is 0; p = exp(logit - lse), minus 1 at the target,
// times the row cotangent g and scale[v], rounded to bf16; dx = p @
// bf16(w)^T summed in fp32 into a zeroed (N, d) fp32 workspace (the wrapper
// casts it to x's dtype).  A row whose cotangent is 0 gets dx exactly 0.
//
// What bounds it (data sheet: 989 TFLOP/s bf16, 3.35 TB/s): 4 N d V
// operations, the logits and the dx products.  At route B's shape (N 4092,
// d 4096, V 32011) that is 2.146e12, 2.170 ms; the bytes (x 33.5 MB, the
// int8 head 132 MB, dx 33.5 MB) take 0.06 ms.  So the design is about the
// tensor-core rate, which only wgmma reaches.  The kernel this replaced
// (mma.sync, 15.9 ms) had four faults; what this one does about each:
//   1. no Hopper tensor-core path: both products are wgmmas.  The logits
//      S = X W: a warpgroup's 64 rows x 256 vocab columns as two m64n128k16
//      with both operands in shared memory (W MN-major; m64n256 left
//      ptxas short of registers, and it serialized every wgmma).  dx +=
//      P W^T: 64 rows x 64 d columns, m64n64k16 with P in registers as A
//      fragments (an fp32 accumulator has the layout of a bf16 A fragment,
//      so P never goes through shared memory);
//   2. synchronous single-stage staging by the computing warps: two
//      consumer warpgroups (setmaxnreg 232) only wait on mbarriers and
//      issue wgmma.  A converter warpgroup (setmaxnreg 40) turns the head
//      into bf16: wgmma has no int8 x bf16 form, and the head stays int8 in
//      device memory (a cached bf16 copy would cost 264 MB).  Its thread 0
//      also issues every TMA load ahead of the conversions: x tiles (128
//      rows x 64 d) through a 4-stage ring, int8 head tiles (64 d x 256
//      columns) through a 3-stage ring.  Each converter takes one head row
//      and eight fixed 16-column units a stage (addresses known at compile
//      time but for the row), and writes 128-byte-swizzled bf16 tiles into
//      a 3-stage ring, fenced to the async proxy.  A word of four codes
//      becomes two bf16 pairs with two LOP3s and one bf16x2 FMA each, and
//      one shift (128 + the low 7 bits, less 128 or 256 by the sign bit:
//      exact); that pairs columns (0, 2) and (1, 3), so the kernel works in
//      that column order ("positions", an involution within each group of
//      4) and maps positions to vocab columns only where it reads scale and
//      compares the target;
//   3. the head read and converted twice per 64 rows: a CTA covers 128
//      rows x 512 vocab columns (P of the span in registers: 128 of a
//      consumer's registers, which is what limits the span), so the head
//      is read twice per 128 rows: 8.1 GB of head tiles and 4.2 GB of x
//      tiles from L2 at route B's shape.  CTAs start in groups of ROW_GROUP
//      row blocks, vocab chunk by chunk within a group, so the CTAs running
//      together share their head tiles and their rows of x and of the dx
//      workspace in L2;
//   4. dx by 5.28e8 float2 atomics: each warpgroup sums its 64 rows x 64 d
//      columns of dx over the CTA's 512 columns in registers, writes them
//      to a swizzled fp32 staging tile (an idle x slot) and adds it to the
//      workspace with two TMA tensor reductions (cp.reduce.async.bulk
//      .tensor .add; rows past N are skipped by the tensor map), N d 4
//      bytes of reductions per 512-column chunk: 4.2 GB at route B's shape.
//      Their order over chunks varies from run to run, as the atomics' did.
// Shared memory 218,272 bytes: one CTA an SM.  chip_smoke.py prints
// ptxas's lines and the SASS counts; measured times, and the ablation that
// says what bounds this design (profile_port.py fused_ce_ablation), are in
// PERF.md.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace moka_flash;
using namespace moka_hopper;

constexpr int BR = 128;         // rows a CTA: two consumer warpgroups of 64
constexpr int SPAN = 512;       // vocab columns a CTA (fused_ce.cu's CHUNK)
constexpr int TV = 256;         // vocab columns a stage and a logits tile
constexpr int NSUB = SPAN / TV;
constexpr int BK = 64;          // d rows a stage
constexpr int X_STAGES = 4;     // x ring (logits; dx staging after them)
constexpr int W8_STAGES = 3;    // int8 head ring (TMA -> converters)
constexpr int W16_STAGES = 3;   // bf16 head ring (converters -> consumers)
constexpr int X_AHEAD = X_STAGES - W16_STAGES;  // x loads ahead of conversion
constexpr int ROW_GROUP = 8;    // row blocks whose CTAs start together (0: all)
constexpr int LOGITS_N = 128;   // width of a logits wgmma (64, 128 or 256)
constexpr int CONVERT_UNROLL = 2;  // units a converter loads before storing
constexpr int NCONSUMER = 256;  // two consumer warpgroups
constexpr int NCONVERT = 128;   // the producer warpgroup, all converting
constexpr int NTHREADS = NCONSUMER + NCONVERT;
constexpr int BOX = 64 * 128;   // bytes of a 64-row x 128-byte box

constexpr int X_BYTES = BR * BK * 2;   // 128 rows x 64 d bf16, one box
constexpr int W8_BYTES = BK * TV;      // 64 d x 256 int8, two boxes
constexpr int W16_BYTES = BK * TV * 2; // 64 d x 256 bf16, four boxes
constexpr int DX_BYTES = 2 * BOX;      // a warpgroup's 64 rows x 64 fp32
constexpr int UNITS = BK * TV / 16;    // 16-code units of a head stage
constexpr int UNITS_EACH = UNITS / NCONVERT;
static_assert(UNITS_EACH == 8, "a converter's units: 2 k + its half");
static_assert(X_AHEAD >= 1 && W8_STAGES >= 2, "loads ahead of conversion");
static_assert(DX_BYTES <= X_BYTES, "a dx staging tile is an x slot");

// shared memory, byte offsets from a 1024-aligned base
constexpr int OFF_X = 0;
constexpr int OFF_W8 = OFF_X + X_STAGES * X_BYTES;
constexpr int OFF_W16 = OFF_W8 + W8_STAGES * W8_BYTES;
constexpr int OFF_COEF = OFF_W16 + W16_STAGES * W16_BYTES;  // scale log2 e,
                                                            // scale
constexpr int OFF_BAR = OFF_COEF + 2 * SPAN * 4;
constexpr int N_BARS = 2 * (X_STAGES + W8_STAGES + W16_STAGES);
constexpr int SMEM_BYTES = OFF_BAR + 8 * N_BARS + 1024;

// widen's masks and biases, read from the kernel's parameters so that each
// mask-and-or is one LOP3 (SASS takes one immediate an instruction)
struct Widen {
  uint32_t low7, sign, plus128, minus128;
};

struct Args {
  const float* scale;  // (ldw,) fp32
  const int* targets;  // (N,) int32, an ignored one matches no column
  const float* lse;    // (N,) fp32, natural log
  const float* g;      // (N,) fp32 row cotangents
  int n_rows, d, ldw, v_real;
  Widen k;
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

// A converter's unit u (0..7) of a head stage: 16 codes of head row r at
// columns 16 cc .., cc = 2 u + c0 (the thread's half); eight neighbouring
// threads take eight rows, so with the swizzle their 16-byte loads and
// stores fall on distinct banks.  src_row / dst_row: row r of the int8 and
// bf16 stages; q8 = (c0 ^ r % 8) << 4, q16 = (2 c0 ^ r % 8) << 4.
template <int U>
__device__ __forceinline__ uint4 load_unit(const uint8_t* src_row, int q8) {
  // chunk (2 U + c0) % 8 ^ r % 8 of int8 box U / 4
  return *reinterpret_cast<const uint4*>(src_row + (U >> 2) * BOX +
                                         (q8 ^ ((U & 3) << 5)));
}

template <int U>
__device__ __forceinline__ void store_unit(uint8_t* dst_row, int q16,
                                           const uint4& raw, const Widen& k) {
  uint4 lo, hi;  // positions 16 cc + 0..7 and + 8..15
  widen(raw.x, k, lo.x, lo.y);
  widen(raw.y, k, lo.z, lo.w);
  widen(raw.z, k, hi.x, hi.y);
  widen(raw.w, k, hi.z, hi.w);
  // chunks 2 (cc % 4) and + 1, each ^ r % 8, of bf16 box cc / 4 = U / 2
  uint8_t* row = dst_row + (U >> 1) * BOX;
  const int c = q16 ^ ((U & 1) << 6);
  *reinterpret_cast<uint4*>(row + c) = lo;
  *reinterpret_cast<uint4*>(row + (c ^ 16)) = hi;
}

// units U .. U + N - 1: their loads first, then their conversions
template <int U, int N>
struct Units {
  static __device__ __forceinline__ void run(const uint8_t* src_row,
                                             uint8_t* dst_row, int q8,
                                             int q16, const Widen& k) {
    const uint4 raw = load_unit<U>(src_row, q8);
    Units<U + 1, N - 1>::run(src_row, dst_row, q8, q16, k);
    store_unit<U>(dst_row, q16, raw, k);
  }
};

template <int U>
struct Units<U, 0> {
  static __device__ __forceinline__ void run(const uint8_t*, uint8_t*, int,
                                             int, const Widen&) {}
};

// a converter's eight units of one stage, CONVERT_UNROLL loads at a time
template <int U = 0>
__device__ __forceinline__ void convert_stage(const uint8_t* src_row,
                                              uint8_t* dst_row, int q8,
                                              int q16, const Widen& k) {
  if constexpr (U < UNITS_EACH) {
    Units<U, CONVERT_UNROLL>::run(src_row, dst_row, q8, q16, k);
    convert_stage<U + CONVERT_UNROLL>(src_row, dst_row, q8, q16, k);
  }
}

// S += X W over one 16-deep step of d: TV / LOGITS_N wgmmas of 64 rows x
// LOGITS_N positions, A = x (K-major) and B = the bf16 head stage at wb
// (MN-major: four boxes of 64 positions, BOX apart)
template <int N>
__device__ __forceinline__ void logits_step(float (&acc)[TV / N][N / 2],
                                            uint64_t da, uint32_t wb) {
#pragma unroll
  for (int nb = 0; nb < TV / N; ++nb) {
    if constexpr (N == 64)
      wgmma_m64n64_ss<0, 1>(acc[nb], da, desc_sw128(wb + nb * BOX), 1);
    else if constexpr (N == 128)
      wgmma_m64n128_ss<1>(acc[nb], da, desc_sw128_mn(wb + 2 * nb * BOX, BOX),
                          1);
    else
      wgmma_m64n256_ss<1>(acc[nb], da, desc_sw128_mn(wb, BOX), 1);
  }
}

// the TMA of head stage i: 64 d rows from d0 x 256 columns from v0, two
// int8 boxes, into ring slot i % W8_STAGES
__device__ __forceinline__ void load_w8(uint32_t base, const CUtensorMap* tm,
                                        uint32_t full, uint32_t empty, int i,
                                        int d0, int v0) {
  const int s = i % W8_STAGES;
  mbar_wait(empty + 8 * s, ((i / W8_STAGES) & 1) ^ 1);
  mbar_arrive_expect_tx(full + 8 * s, W8_BYTES);
  const uint32_t dst = base + OFF_W8 + s * W8_BYTES;
  tma_load_4d(dst, tm, full + 8 * s, v0, d0, 0, 0);
  tma_load_4d(dst + BOX, tm, full + 8 * s, v0 + 128, d0, 0, 0);
}

// what a consumer warpgroup's dx chunks share
struct DxCtx {
  uint8_t* stg;             // the warpgroup's staging tile
  const CUtensorMap* tm_dx;
  int row0;                 // the warpgroup's first row
  int bar;                  // the warpgroup's named barrier
  int wtid, row, t;         // thread in the warpgroup, its first row, t
};

// dacc (64 rows x d columns 64 dc ..) -> the staging tile (two boxes of 64
// rows x 32 columns, 128-byte rows, 16-byte chunk j at j ^ (row % 8), as
// the tensor map's swizzle reads them) -> two TMA reductions into the
// workspace (rows past N are skipped by the tensor map)
__device__ __forceinline__ void write_dx(float (&dacc)[32], int dc,
                                         const DxCtx& c) {
  fence_operand(dacc);
  // the previous chunk's reductions have read the staging tile
  if (c.wtid == 0) bulk_wait_read<0>();
  named_bar_sync(c.bar, 128);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int up = 0; up < 2; ++up) {
      const int row = c.row + 8 * up;
      const int col = 8 * jj + 2 * c.t;
      const int chunk = (col & 31) >> 2;
      *reinterpret_cast<float2*>(c.stg + (col >> 5) * BOX + row * 128 +
                                 ((chunk ^ (row & 7)) << 4) + 4 * (col & 3)) =
          make_float2(dacc[4 * jj + 2 * up], dacc[4 * jj + 2 * up + 1]);
    }
  fence_proxy_async_smem();
  named_bar_sync(c.bar, 128);
  if (c.wtid == 0) {
    const uint32_t src = smem_addr(c.stg);
    tma_reduce_add_4d(c.tm_dx, src, dc * BK, c.row0, 0, 0);
    tma_reduce_add_4d(c.tm_dx, src + BOX, dc * BK + 32, c.row0, 0, 0);
    bulk_commit();
  }
}

// the TMA of x for logits stage i (128 rows x 64 d from d0) into ring slot
// i % X_STAGES
__device__ __forceinline__ void load_x(uint32_t base, const CUtensorMap* tm,
                                       uint32_t full, uint32_t empty, int i,
                                       int d0, int row0) {
  const int s = i % X_STAGES;
  mbar_wait(empty + 8 * s, ((i / X_STAGES) & 1) ^ 1);
  mbar_arrive_expect_tx(full + 8 * s, X_BYTES);
  tma_load_4d(base + OFF_X + s * X_BYTES, tm, full + 8 * s, d0, row0, 0, 0);
}

__global__ void __launch_bounds__(NTHREADS, 1)
    fused_ce_bwd_kernel(const __grid_constant__ CUtensorMap tm_x,
                        const __grid_constant__ CUtensorMap tm_w,
                        const __grid_constant__ CUtensorMap tm_dx,
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
  const int nk = a.d / BK;
  // CTAs in groups of ROW_GROUP row blocks, vocab chunk by chunk within a
  // group, the row block fastest
  const int n_rb = (a.n_rows + BR - 1) / BR, n_span = a.ldw / SPAN;
  const int group = ROW_GROUP > 0 ? min(ROW_GROUP, n_rb) : n_rb;
  const int gi = blockIdx.x / (group * n_span);
  const int rest = blockIdx.x % (group * n_span);
  const int here = min(group, n_rb - gi * group);
  const int row0 = (gi * group + rest % here) * BR;
  const int v_span = (rest / here) * SPAN;

  if (tid == 0) {
    for (int s = 0; s < X_STAGES; ++s) {
      mbar_init(full_x + 8 * s, 1);
      mbar_init(empty_x + 8 * s, NCONSUMER);
    }
    for (int s = 0; s < W8_STAGES; ++s) {
      mbar_init(full_w8 + 8 * s, 1);
      mbar_init(empty_w8 + 8 * s, NCONVERT);
    }
    for (int s = 0; s < W16_STAGES; ++s) {
      mbar_init(full_w16 + 8 * s, NCONVERT);
      mbar_init(empty_w16 + 8 * s, NCONSUMER);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // stage i, in the consumers' order: the logits (i < n_logits: tile j =
  // i / nk over d step ks = i % nk), then dx (64 d columns dc at a time,
  // the span's 256-column halves q in turn)
  const int n_logits = NSUB * nk, n_stages = 2 * n_logits;
  auto stage_d0 = [nk, n_logits](int i) {
    return (i < n_logits ? i % nk : (i - n_logits) / NSUB) * BK;
  };
  auto stage_v0 = [nk, n_logits, v_span](int i) {
    return v_span + (i < n_logits ? i / nk : (i - n_logits) % NSUB) * TV;
  };

  if (tid >= NCONSUMER) {
    // ---------------------------------------------------------- converters
    setmaxnreg_dec<40>();
    const int ctid = tid - NCONSUMER;
    // thread 0 also issues every TMA load, each ahead of the conversion
    // that frees its slot: x stage i + X_AHEAD (its slot last held stage
    // i - W16_STAGES, released with the bf16 stage this thread has just
    // acquired, so that wait never blocks) and head stage i + W8_STAGES - 1
    // (its slot last held stage i - 1: the converters' previous stage)
    const bool issuer = ctid == 0;
    if (issuer) {
      for (int i = 0; i < X_AHEAD && i < n_logits; ++i)
        load_x(base, &tm_x, full_x, empty_x, i, stage_d0(i), row0);
      for (int i = 0; i < W8_STAGES - 1; ++i)
        load_w8(base, &tm_w, full_w8, empty_w8, i, stage_d0(i), stage_v0(i));
    }
    // this thread's head row r and column half c0 (units 2 u + c0)
    const int r = ctid & (BK - 1), c0 = ctid / BK, sw = r & 7;
    const int q8 = (c0 ^ sw) << 4, q16 = ((2 * c0) ^ sw) << 4;
    const Widen k = a.k;
    for (int i = 0; i < n_stages; ++i) {
      const int s8 = i % W8_STAGES, s16 = i % W16_STAGES;
      mbar_wait(full_w8 + 8 * s8, (i / W8_STAGES) & 1);
      mbar_wait(empty_w16 + 8 * s16, ((i / W16_STAGES) & 1) ^ 1);
      if (issuer) {
        const int ix = i + X_AHEAD, i8 = i + W8_STAGES - 1;
        if (ix < n_logits)
          load_x(base, &tm_x, full_x, empty_x, ix, stage_d0(ix), row0);
        if (i8 < n_stages)
          load_w8(base, &tm_w, full_w8, empty_w8, i8, stage_d0(i8),
                  stage_v0(i8));
      }
      convert_stage(sm + OFF_W8 + s8 * W8_BYTES + r * 128,
                    sm + OFF_W16 + s16 * W16_BYTES + r * 128, q8, q16, k);
      fence_proxy_async_smem();
      mbar_arrive(full_w16 + 8 * s16);
      mbar_arrive(empty_w8 + 8 * s8);
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  setmaxnreg_inc<232>();
  // warp-uniform, so the descriptors built from it live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int wtid = tid % 128, warp = wtid / 32, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // the span's scale * log2 e and scale in position order (0 past V)
  float* cl = reinterpret_cast<float*>(sm + OFF_COEF);
  float* cs = cl + SPAN;
  for (int p = tid; p < SPAN; p += NCONSUMER) {
    const int v = v_span + swap_low_bits(p);
    const float sc = v < a.v_real ? a.scale[v] : 0.f;
    cl[p] = sc * LOG2E;
    cs[p] = sc;
  }
  // this thread's rows: lse * log2 e, g (0 past N: p * 0) and the target's
  // position in the span (-1: none)
  float lse2[2], gr[2];
  int tp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 64 * wg + 16 * warp + g + 8 * h;
    const bool in = r < a.n_rows;
    const int tv = (in ? a.targets[r] : -1) - v_span;
    lse2[h] = in ? a.lse[r] * LOG2E : 0.f;
    gr[h] = in ? a.g[r] : 0.f;
    tp[h] = tv >= 0 && tv < SPAN ? swap_low_bits(tv) : -1;
  }
  named_bar_sync(1, NCONSUMER);

  // P of the span, 64 rows x 512 positions bf16, as 32 A fragments of 16
  // positions: register r of fragment f holds accumulator elements 8 f' +
  // 2 r, + 1 of logits tile f / 16 (f' = f % 16)
  uint32_t pa[SPAN / 16][4];
  int ix = 0, iw = 0;
#pragma unroll
  for (int j = 0; j < NSUB; ++j) {
    // S = X W over d: 64 rows x positions [256 j, 256 j + 256); element i
    // (acc[i / (LOGITS_N / 2)][i % (LOGITS_N / 2)]) is row 16 warp + g + 8
    // ((i >> 1) & 1), position 8 (i >> 2) + 2 t + (i & 1)
    constexpr int NA = LOGITS_N / 2;
    float acc[TV / LOGITS_N][NA];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i / NA][i % NA] = 0.f;
    for (int ks = 0; ks < nk; ++ks, ++ix, ++iw) {
      const int sx = ix % X_STAGES, sw = iw % W16_STAGES;
      mbar_wait(full_x + 8 * sx, (ix / X_STAGES) & 1);
      mbar_wait(full_w16 + 8 * sw, (iw / W16_STAGES) & 1);
      const uint32_t xa = base + OFF_X + sx * X_BYTES + wg * BOX;
      const uint32_t wb = base + OFF_W16 + sw * W16_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        logits_step<LOGITS_N>(acc, desc_sw128(xa + kk * 32),
                              wb + kk * 2048);
      wgmma_commit();
      if (ks > 0) {  // the previous stage's products are done
        wgmma_wait<1>();
        mbar_arrive(empty_x + 8 * ((ix - 1) % X_STAGES));
        mbar_arrive(empty_w16 + 8 * ((iw - 1) % W16_STAGES));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < TV / LOGITS_N; ++nb) fence_operand(acc[nb]);
    mbar_arrive(empty_x + 8 * ((ix - 1) % X_STAGES));
    mbar_arrive(empty_w16 + 8 * ((iw - 1) % W16_STAGES));

    // p = exp2(S scale log2 e - lse log2 e), minus 1 at the target, times
    // g scale, rounded to bf16 pairs in A-fragment order
    const float* clj = cl + TV * j + 2 * t;
    const float* csj = cs + TV * j + 2 * t;
    const int hit[2] = {tp[0] - TV * j - 2 * t, tp[1] - TV * j - 2 * t};
#pragma unroll
    for (int kk = 0; kk < TV / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r, h = r & 1, c = 8 * (i >> 2);
        const float2 l2 = *reinterpret_cast<const float2*>(clj + c);
        const float2 s2 = *reinterpret_cast<const float2*>(csj + c);
        float p0 = exp2_approx(fmaf(acc[i / NA][i % NA], l2.x, -lse2[h]));
        float p1 =
            exp2_approx(fmaf(acc[i / NA][i % NA + 1], l2.y, -lse2[h]));
        if (hit[h] == c) p0 -= 1.f;
        if (hit[h] == c + 1) p1 -= 1.f;
        pa[16 * j + kk][r] = pack_bf16(p0 * (gr[h] * s2.x),
                                       p1 * (gr[h] * s2.y));
      }
    }
  }

  // dx[rows, 64 dc ..] = P W[64 dc .., span]^T over the span's positions
  // (two stages, the span's halves), then written out and added to the
  // workspace.  The staging tile is the x slot that logits stage n_logits
  // + wg would take: its last stage, n_logits + wg - X_STAGES, is released
  // by both warpgroups before the first write-out (which follows dx stage
  // n_logits + 1, converted once stage n_logits + 1 - W16_STAGES was
  // released), while the last logits stages' slots may still be read
  const DxCtx c{sm + OFF_X + (n_logits + wg) % X_STAGES * X_BYTES, &tm_dx,
                row0 + 64 * wg, 2 + wg, wtid, 16 * warp + g, t};
  for (int dc = 0; dc < nk; ++dc) {
    float dacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dacc[i] = 0.f;
#pragma unroll
    for (int q = 0; q < NSUB; ++q, ++iw) {
      const int sw = iw % W16_STAGES;
      mbar_wait(full_w16 + 8 * sw, (iw / W16_STAGES) & 1);
      const uint32_t wb = base + OFF_W16 + sw * W16_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TV / 16; ++kk)
        wgmma_m64n64_rs<0>(dacc, pa[16 * q + kk],
                           desc_sw128(wb + (kk >> 2) * BOX + (kk & 3) * 32),
                           1);
      wgmma_commit();
      if (q > 0) {
        wgmma_wait<1>();
        mbar_arrive(empty_w16 + 8 * ((iw - 1) % W16_STAGES));
      }
    }
    wgmma_wait<0>();
    mbar_arrive(empty_w16 + 8 * ((iw - 1) % W16_STAGES));
    write_dx(dacc, dc, c);
  }
  if (wtid == 0) bulk_wait<0>();
}

}  // namespace

extern "C" {

// x (n_rows, d) bf16; w (d, ldw) int8 with ldw % 512 == 0 and columns past
// v_real zero; scale (ldw,) fp32; targets (n_rows,) int32; lse and g
// (n_rows,) fp32; work (n_rows, d) fp32, zeroed by the caller, receives dx.
// d % 64 == 0, every tensor 16-byte aligned.  Returns cudaGetLastError()
// after the launch, the shared-memory attribute's error, or
// cudaErrorInvalidValue for bad dimensions or a tensor map the driver
// refuses.
int moka_fused_ce_bwd(const void* x, const void* w, const void* scale,
                      const void* targets, const void* lse, const void* g,
                      void* work, int n_rows, int d, int ldw, int v_real,
                      void* stream) {
  if (n_rows <= 0 || d <= 0 || d % BK || ldw <= 0 || ldw % SPAN ||
      v_real > ldw)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_ce_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // x and the workspace over (d, N), the head over (ldw, d), each padded
  // to four dimensions; rows past N load as zero and are skipped by the
  // reductions
  CUtensorMap tm_x, tm_w, tm_dx;
  const uint64_t x_dims[4] = {uint64_t(d), uint64_t(n_rows), 1, 1};
  const uint64_t w_dims[4] = {uint64_t(ldw), uint64_t(d), 1, 1};
  const uint32_t x_box[4] = {64, BR, 1, 1}, w_box[4] = {128, BK, 1, 1};
  const uint32_t dx_box[4] = {32, 64, 1, 1};
  if (!swizzled_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 4, x, x_dims,
                    x_box) ||
      !swizzled_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 4, w, w_dims,
                    w_box) ||
      !swizzled_map(&tm_dx, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 4, work,
                    x_dims, dx_box))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.scale = static_cast<const float*>(scale);
  a.targets = static_cast<const int*>(targets);
  a.lse = static_cast<const float*>(lse);
  a.g = static_cast<const float*>(g);
  a.n_rows = n_rows;
  a.d = d;
  a.ldw = ldw;
  a.v_real = v_real;
  a.k = {0x007f007fu, 0x00800080u, 0x43004300u, 0xc300c300u};  // 128.0,
                                                               // -128.0
  const dim3 grid(((n_rows + BR - 1) / BR) * (ldw / SPAN));
  fused_ce_bwd_kernel<<<grid, NTHREADS, SMEM_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(tm_x, tm_w,
                                                             tm_dx, a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
