// LoRA dropout fused into the adapter's A projection, forward and backward,
// for Hopper (sm_90a), at every M * r (any rank with any number of
// modalities: no width is built in; past 64 the kernels loop over 64-row
// tiles of M * r and dx over chunks of A's rows at run time).
//
// Replaces the TPU kernels moka_tpu/ops/fused_dropout.py::_fwd_kernel (:55,
// launched by _run_fwd :127) and ::_bwd_kernel (:70, launched by _run_bwd
// :157).  For x (N, d) in bf16 or fp32, A (d, MR) in fp32 or bf16 (MR = M *
// r, the modalities' rank columns side by side) and keep = bits < thresh:
//   forward   out = where(keep, x * s_x, 0) @ A          (N, MR) fp32
//             s_x = 1/keep rounded to x's type, x_d rounded to x's type
//   backward  m   = where(keep, 1/keep, 0)                fp32
//             dx  = ((g @ A^T) * m)                       (N, d) in x's type
//             dA  = (x * m)^T @ g                         (d, MR) in A's type
// The bits are never stored: element (n, c) takes word c % 4 of
// Philox4x32-10 at counter (n, c / 4, 0, 0) under the 64-bit key (k0, k1),
// the layout core/rng.py::DropoutKey.bits32 computes in plain torch, so both
// kernels, and the plain version, draw the same mask whatever the tiling.
// Where the array is one rank's rows of a larger one (a batch or sequence
// split over ranks), n is the larger array's row (RoundKeys' row map), so
// the ranks drop what one process drops.  With a bits pointer (tests) the
// words are read from it instead.
//
// What bounds them (bf16 x, the training path): per element one read of x
// (backward: and one write of dx) and a quarter of a Philox call (ten
// rounds of two 32-bit multiplies high and low and their xors;
// chip_smoke.py's PHILOX_INSTR counts its lane instructions).  At N 4096
// over a layer's seven projections the forward's generator (~0.1 ms of
// issue on 132 SMs) outweighs its x bytes (0.087 ms); the backward's x and
// dx bytes (0.175 ms) outweigh the generator.  The products have rank MR:
// a few percent of the tensor cores' time.  So x streams once, the
// forward's product and the backward's dA run on the tensor cores, and the
// ordinary cores keep the generator and, backward, dx's FMA chain.  M * r
// up to 64 is one tile of A^T's rows (wgmma's 64); above 64 the forward's
// grid has a CTA for each 64-row tile (each draws its rows' words again)
// and the backward's a CTA pair for each 64-row tile of dA^T, with dx from
// a third kernel (dropout_dx_kernel: the same FMA chain over all of M * r,
// A's rows staged in shared memory DX_JC at a time, g from L2).  Where M *
// r is not a multiple of
// 4 the wrapper pads g with zero columns to one (g_width: TMA's 16-byte
// rows) and the chains stop at M * r:
//   * forward (dropout_fwd_kernel): out^T = A^T x_d^T, with the M * r rows
//     on wgmma's 64-row side (rows past MR are computed and never read) and
//     a CTA's 32 rows of x as N, so N 4096 gives 128 CTAs.  A first, small
//     pass (transpose_a_kernel) writes A^T in bf16 parts to a scratch of
//     the wrapper's; fp32 A is split into three parts (split3: hi =
//     bf16(A), mid = bf16(A - hi), lo = bf16(A - hi - mid), within 2^-24
//     |A| of A), three products into one accumulator: fp32 in effect.  A
//     producer warp streams x by TMA in boxes of 32 rows x 64 columns
//     (128-byte swizzle) into a ring of up to 16 mbarrier stages, each with
//     A^T's matching boxes (MR rows padded to 8; A read once a CTA from
//     L2).  The three consumer warpgroups take the stages in turn: a thread
//     draws the words of eight adjacent columns of a row (two Philox
//     calls), masks and scales them in place (a bf16x2 multiply: one
//     rounding, x * s_x in x's type), fences the async proxy and issues
//     wgmma m64n32k16, the accumulators held across all of d; the
//     warpgroups' sums are added at the end.  (Transposing A's chunk in
//     every CTA instead costs as much as the generator: PERF.md);
//   * backward (dropout_bwd_kernel): a CTA owns 64 columns of d and half of
//     the rows, the other half going to the second CTA of its cluster, so d
//     4096 gives 128 CTAs; the pair adds its two dA sums through distributed
//     shared memory in a fixed order: no workspace, no second launch, no
//     atomics, two calls bit-identical.  A producer warp loads each 64-row
//     tile's x box and g rows (fp32) by TMA into a ring; the two consumer
//     warpgroups take the tiles in turn, each with its own barriers.  A
//     thread draws the words of eight columns of four rows once, masks x
//     in place (x * keep: exact in bf16) and, with those bits in its
//     registers, forms dx for the same 64 bytes: g A^T as an fp32 FMA chain
//     over j = 0 .. MR-1 (the order of the plain version's fp32 chain,
//     so dx matches it to the bit where a tensor-core sum would move the
//     bf16 rounding of values that cancel; A's fp32 rows of the CTA's
//     columns stay in shared memory), times m, rounded to x's type into a
//     staging tile that one TMA store writes.  g's rows are split into
//     three bf16 parts (split3, within 2^-24 of g) and the warpgroup adds
//     dA^T += g^T x_m on wgmma (g^T MN-major), its products in flight
//     while it starts its next tile.  dA is scaled by 1/keep once at the
//     end: the terms of (x * m)^T g a rounding apart.  The FMA chain makes
//     dx's work grow with MR (MR FMAs an element beside a quarter of a
//     Philox call);
//   * fp32 x (no training path feeds it: bf16 dots feed bf16 x) keeps
//     fp32 FMAs on the ordinary cores (dropout_fwd_f32, dropout_bwd_f32)
//     with the same words and no workspace: a backward CTA owns 32 columns
//     and walks every row.
// chip_smoke.py prints ptxas's lines and the SASS counts; measured times
// are in PERF.md.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using namespace moka_hopper;
namespace cg = cooperative_groups;

constexpr int SMEM_LIMIT = 232448;   // a CTA's shared memory on sm_90
constexpr int BOX = 64 * 128;        // 64 rows of 128 bytes (64 bf16)

// ------------------------------------------------------------ the words

// Philox4x32-10's round keys: round r takes (k0 + r W0, k1 + r W1).  The
// host computes them once; the kernels read them from their parameters, so
// a call spends no instruction on the key schedule.  With them the rows'
// counters: row n of the (N, d) array a kernel sees draws at the counter
// row of the whole array it is part of (one rank's rows of a batch or a
// sequence split over ranks), base + n when seg is 0 (a contiguous run:
// the batch split), else (n / seg) * stride + base + n % seg (seg rows of
// each sample: the sequence split); 0, 0, 0 is the array itself.  Column
// c draws at column counter col + c / 4: col is c0 / 4 for an array that
// holds columns [c0, ...) of the whole one (the input of a row-parallel
// projection split over the model axis; c0 a multiple of 4), else 0
struct RoundKeys {
  uint32_t k0[10], k1[10];
  uint32_t seg, stride, base, col;
};

RoundKeys round_keys(uint32_t k0, uint32_t k1, uint32_t seg,
                     uint32_t stride, uint32_t base, uint32_t col) {
  RoundKeys rk;
  for (int r = 0; r < 10; ++r) {
    rk.k0[r] = k0 + static_cast<uint32_t>(r) * 0x9E3779B9u;
    rk.k1[r] = k1 + static_cast<uint32_t>(r) * 0xBB67AE85u;
  }
  rk.seg = seg;
  rk.stride = stride;
  rk.base = base;
  rk.col = col;
  return rk;
}

// the counter row of row n (core/rng.py::DropoutKey.row_map's rule)
__device__ __forceinline__ uint32_t counter_row(const RoundKeys& rk, int n) {
  const uint32_t u = static_cast<uint32_t>(n);
  return rk.seg == 0u ? rk.base + u
                      : u / rk.seg * rk.stride + rk.base + u % rk.seg;
}

// Philox4x32-10: counter (c0, c1, 0, 0), key rk -> four words
__device__ __forceinline__ void philox(uint32_t c0, uint32_t c1,
                                       const RoundKeys& rk, uint32_t* w) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ rk.k0[r];
    c1 = lo1;
    c2 = hi0 ^ c3 ^ rk.k1[r];
    c3 = lo0;
  }
  w[0] = c0;
  w[1] = c1;
  w[2] = c2;
  w[3] = c3;
}

// the words of columns c .. c + 7 of row n (c % 8 == 0): two Philox calls,
// or (FORCED) the words of bits (zero outside the (n_rows, d) array).  A
// template flag, so the Philox path is straight-line code whose calls the
// compiler can interleave
template <bool FORCED>
__device__ __forceinline__ void words8(const uint32_t* bits, int n, int c,
                                       int n_rows, int d, const RoundKeys& rk,
                                       uint32_t (&w)[8]) {
  if (FORCED) {
    uint4 u = make_uint4(0u, 0u, 0u, 0u), v = u;
    if (n < n_rows && c < d) {
      const uint4* p = reinterpret_cast<const uint4*>(
          bits + static_cast<size_t>(n) * d + c);
      u = p[0];
      v = p[1];
    }
    w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
    w[4] = v.x; w[5] = v.y; w[6] = v.z; w[7] = v.w;
  } else {
    const uint32_t g = (static_cast<uint32_t>(c) >> 2) + rk.col;
    const uint32_t row = counter_row(rk, n);
    philox(row, g, rk, w);
    philox(row, g + 1u, rk, w + 4);
  }
}

// the keep masks of eight words as four bf16-pair masks: half e % 2 of
// m[e / 2] is 0xffff where word e is kept, 0 where it is dropped
__device__ __forceinline__ void keep_masks(const uint32_t (&w)[8],
                                           uint32_t thresh, uint32_t (&m)[4]) {
#pragma unroll
  for (int p = 0; p < 4; ++p)
    m[p] = (w[2 * p] < thresh ? 0x0000ffffu : 0u) |
           (w[2 * p + 1] < thresh ? 0xffff0000u : 0u);
}

// a bf16 pair times s (a bf16 pair), rounded once to bf16
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t v, uint32_t s) {
  const __nv_bfloat162 p =
      __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&v),
              *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<const uint32_t*>(&p);
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ void from_float(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void from_float(float v, float* p) { *p = v; }

__device__ __forceinline__ float bf16_hi(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a pair of fp32 values as three bf16 pairs: p[0] = bf16(v), p[1] =
// bf16(v - p[0]), p[2] = bf16(v - p[0] - p[1]); their sum is within 2^-24
// |v| of v (each difference is exact in fp32)
__device__ __forceinline__ void split3(float v0, float v1, uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float h0 = bf16_hi(v0), h1 = bf16_hi(v1);
    p[i] = pack_bf16(h0, h1);
    v0 -= h0;
    v1 -= h1;
  }
}

// byte offset of the bf16 pair at (row, column c, c even) in a tile of
// 128-byte rows with the 128-byte swizzle (16-byte chunk q at q ^ row % 8)
__device__ __forceinline__ int swz(int row, int c) {
  return row * 128 + ((((c >> 3) ^ row) & 7) << 4) + 2 * (c & 7);
}

// ------------------------------------------------ kernel 6, bf16 x

constexpr int FWD_ROWS = 32;                 // rows of x a CTA: wgmma's N
constexpr int FWD_XBYTES = FWD_ROWS * 128;   // one x box
constexpr int FWD_MAX_STAGES = 16;
constexpr int FWD_WG = 3;                    // consumer warpgroups (2: 5%
                                             // slower, 1: 20%; PERF.md)
constexpr int FWD_NT = 128 * FWD_WG + 32;    // and one producer warp
// after the ring: the other warpgroups' sums, at least 8 KB (the last
// stage's wgmma rows past its parts read into it)
constexpr int FWD_RED = FWD_WG > 2 ? (FWD_WG - 1) * 16 * 128 * 4 : 8192;

// A's bf16 parts: bf16 A is one, fp32 A three (split3)
template <typename TA>
__host__ __device__ constexpr int a_parts() {
  return sizeof(TA) == 4 ? 3 : 1;
}

// A's rows padded to a multiple of 8: the rows of a transposed part
inline int a_rows(int mr) { return (mr + 7) / 8 * 8; }

struct FwdShape {
  int n_rows, d, mr;
  int kb;                     // 64-column chunks of d
  int stages, stage_bytes;    // the ring: A^T's parts' boxes, then x's box
  int at_bytes;               // one part's box: a_rows(mr) rows of 128 bytes
                              // (64 where M*r > 64: a CTA's tile of them)
  uint32_t thresh, scale2;    // keep threshold; s_x as a bf16 pair
  RoundKeys key;
};

// The transpose pass: A (d, mr) in TA -> its bf16 parts A^T (H, rows, d),
// part h row j < mr = split3(A[:, j])[h], rows mr .. rows - 1 zero.  A
// thread a column pair of every gridDim.y-th row.
template <typename TA>
__global__ void __launch_bounds__(256)
    transpose_a_kernel(const TA* __restrict__ a, __nv_bfloat16* __restrict__ at,
                       int d, int mr, int rows) {
  const int c = 2 * (blockIdx.x * 256 + threadIdx.x);
  if (c >= d) return;
  for (int j = blockIdx.y; j < rows; j += gridDim.y) {
    float v0 = 0.f, v1 = 0.f;
    if (j < mr) {
      v0 = to_float(a[static_cast<size_t>(c) * mr + j]);
      v1 = to_float(a[static_cast<size_t>(c + 1) * mr + j]);
    }
    uint32_t p[3];
    split3(v0, v1, p);
#pragma unroll
    for (int h = 0; h < a_parts<TA>(); ++h)
      *reinterpret_cast<uint32_t*>(
          at + (static_cast<size_t>(h) * rows + j) * d + c) = p[h];
  }
}

// Grid: one CTA per 32 rows and 64 of the M*r columns (one tile below 64:
// blockIdx.y is the tile; above 64 each tile draws its rows' words
// again).  Warpgroup wg takes the chunks it = wg, wg + FWD_WG, ... of d; thread t of a warpgroup masks the units (row, 16-byte chunk)
// t and t + 128 of each of its stages.  A stage holds A^T's parts for the
// chunk (a_rows(mr) rows each, by TMA from the transpose pass's output) and
// x's box; wgmma reads 64 rows of each part, and the rows past a_rows(mr)
// (the next part, x, the next stage) give accumulator rows that are never
// read.
template <typename TA, bool FORCED>
__global__ void __launch_bounds__(FWD_NT, 1)
    dropout_fwd_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_at,
                       const uint32_t* __restrict__ bits,
                       float* __restrict__ out,
                       const __grid_constant__ FwdShape sh) {
  constexpr int H = a_parts<TA>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(sm);
  float* red = reinterpret_cast<float*>(sm + sh.stages * sh.stage_bytes);
  const uint32_t full = smem_addr(red) + FWD_RED;
  const uint32_t empty = full + 8 * FWD_MAX_STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * FWD_ROWS;
  if (tid == 0) {
    for (int s = 0; s < sh.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);  // the consuming warpgroup's warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4 * FWD_WG) {  // the producer
    if (lane == 0) {
      const uint64_t first = l2_evict_first(), last = l2_evict_last();
      for (int it = 0; it < sh.kb; ++it) {
        const int s = it % sh.stages;
        if (it >= sh.stages)
          mbar_wait(empty + 8 * s, ((it / sh.stages) - 1) & 1);
        const uint32_t st = ring + s * sh.stage_bytes;
        mbar_arrive_expect_tx(full + 8 * s, H * sh.at_bytes + FWD_XBYTES);
        for (int h = 0; h < H; ++h)
          tma_load_4d(st + h * sh.at_bytes, &tm_at, full + 8 * s, 64 * it,
                      64 * blockIdx.y, h, 0, last);
        tma_load_4d(st + H * sh.at_bytes, &tm_x, full + 8 * s, 64 * it, row0,
                    0, 0, first);
      }
    }
    return;
  }

  const int wg = warp / 4, t = tid % 128;
  float acc[FWD_ROWS / 2];
#pragma unroll
  for (int i = 0; i < FWD_ROWS / 2; ++i) acc[i] = 0.f;
  fence_operand(acc);
  int held = -1;  // the stage whose products may still be in flight
  for (int it = wg; it < sh.kb; it += FWD_WG) {
    const int s = it % sh.stages;
    mbar_wait(full + 8 * s, (it / sh.stages) & 1);
    uint8_t* xst = sm + s * sh.stage_bytes + H * sh.at_bytes;
    const int c0 = 64 * it;
    // x_d = where(keep, x * s_x, 0) in place
#pragma unroll
    for (int k = 0; k < FWD_ROWS * 8 / 128; ++k) {
      const int u = t + 128 * k, r = u >> 3, q = u & 7;
      uint32_t w[8];
      words8<FORCED>(bits, row0 + r, c0 + 8 * q, sh.n_rows, sh.d, sh.key, w);
      uint32_t fk[4];
      keep_masks(w, sh.thresh, fk);
      uint4* p = reinterpret_cast<uint4*>(xst + r * 128 + ((q ^ (r & 7)) << 4));
      uint4 v = *p;
      v.x = mul_bf16x2(v.x, sh.scale2) & fk[0];
      v.y = mul_bf16x2(v.y, sh.scale2) & fk[1];
      v.z = mul_bf16x2(v.z, sh.scale2) & fk[2];
      v.w = mul_bf16x2(v.w, sh.scale2) & fk[3];
      *p = v;
    }
    fence_proxy_async_smem();
    named_bar_sync(1 + wg, 128);
    const uint32_t as = ring + s * sh.stage_bytes, xs = as + H * sh.at_bytes;
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < H; ++h)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64nN_ss<FWD_ROWS>(acc, desc_sw128(as + h * sh.at_bytes + 32 * kk),
                                 desc_sw128(xs + 32 * kk), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done
    if (held >= 0 && lane == 0) mbar_arrive(empty + 8 * held);
    held = s;
  }
  wgmma_wait<0>();
  fence_operand(acc);
  // the warpgroups' sums: the others' through shared memory
  if (wg > 0) {
#pragma unroll
    for (int i = 0; i < FWD_ROWS / 2; ++i)
      red[((wg - 1) * 16 + i) * 128 + t] = acc[i];
  }
  named_bar_sync(15, 128 * FWD_WG);
  if (wg > 0) return;
  // thread t holds rows j = r0, r0 + 8 of out^T, columns 2 qd (+1) of each
  // group of 8 rows of x
  const int r0 = 16 * warp + lane / 4, qd = lane % 4;
#pragma unroll
  for (int jj = 0; jj < FWD_ROWS / 8; ++jj)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 4 * jj + 2 * u + e;
        const int j = 64 * blockIdx.y + r0 + 8 * u;
        const int n = row0 + 8 * jj + 2 * qd + e;
        if (j < sh.mr && n < sh.n_rows) {
          float v = acc[k];
#pragma unroll
          for (int w = 1; w < FWD_WG; ++w) v += red[((w - 1) * 16 + k) * 128 + t];
          out[static_cast<size_t>(n) * sh.mr + j] = v;
        }
      }
}

// ------------------------------------------------ kernel 7, bf16 x

constexpr int BWD_COLS = 64;     // columns of d a CTA: one box
constexpr int CONSUMERS = 256;   // two consumer warpgroups
constexpr int BWD_NT = CONSUMERS + 32;  // and one producer warp
constexpr int BWD_MAX_STAGES = 4;  // the ring: a tile's x box and g rows
constexpr int FLUSH = 4;         // a warpgroup's tiles whose dA products one
                                 // accumulator sums before it is added to
                                 // the running sum (256 rows: small partial
                                 // sums, so fp32 rounds them finely)

struct BwdShape {
  int n_rows, d, mr;
  int gw;           // the width of a tile's g rows in the ring: g's padded
                    // width (M*r up to a multiple of 4) where the kernel
                    // forms dx, 64 where it takes a 64-column tile of dA
  int with_dx;      // M*r <= 64: dx and all of dA; else dA's tile only
  int tiles;        // 64-row tiles of each CTA of a pair (the first takes
                    // tiles [0, tiles), the second the rest)
  int stages;       // the ring's depth
  int stage_bytes;  // x's box (BOX), then g's 64 rows (256 gw bytes)
  int off_gp;       // each warpgroup's g parts: 3 bf16 tiles [row][j]
  int off_dx;       // each warpgroup's two dx staging tiles
  int off_af;       // A fp32 for the CTA's columns (conflict-free layout)
  int off_bars;
  uint32_t thresh;
  float inv_keep;
  RoundKeys key;
};

// Grid (d / 64, 2, tiles), clusters of the two CTAs of a column chunk; at
// M*r > 64 blockIdx.z is the CTA's 64-row tile of dA^T (g's columns 64 z
// ..) and dx comes from dropout_dx_kernel instead.  Warpgroup
// wg takes the CTA's tiles wg, wg + 2, ...; thread t of it the units (row,
// 16-byte chunk) of chunk q = t % 8 in rows t / 8 + 16 u, u < 4.  The two
// warpgroups run their tiles apart, each with its own barriers, g parts
// and staging tiles.
template <typename TA, bool FORCED>
__global__ void __cluster_dims__(1, 2, 1) __launch_bounds__(BWD_NT, 1)
    dropout_bwd_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_g,
                       const __grid_constant__ CUtensorMap tm_dx,
                       const TA* __restrict__ a,
                       const uint32_t* __restrict__ bits, TA* __restrict__ da,
                       const __grid_constant__ BwdShape sh) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(sm);
  const uint32_t full = base + sh.off_bars, empty = full + 8 * BWD_MAX_STAGES;
  float* af = reinterpret_cast<float*>(sm + sh.off_af);
  float* red = reinterpret_cast<float*>(sm);  // after the tiles: the ring
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wg = warp / 4, t = tid % 128;
  const int c0 = blockIdx.x * BWD_COLS;
  const int tile0 = rank * sh.tiles;
  const int ntiles = max(0, min(sh.tiles, (sh.n_rows + 63) / 64 - tile0));
  if (tid == 0) {
    for (int s = 0; s < sh.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);  // the owning warpgroup's warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  float dacc[32];  // dA^T, rows j, the CTA's 64 columns: a warpgroup's tiles
  float dsum[32];  // dacc's sums every FLUSH of the warpgroup's tiles
#pragma unroll
  for (int i = 0; i < 32; ++i) dacc[i] = dsum[i] = 0.f;
  fence_operand(dacc);

  if (warp == CONSUMERS / 32) {  // the producer
    if (lane == 0) {
      const uint64_t first = l2_evict_first(), last = l2_evict_last();
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % sh.stages;
        if (i >= sh.stages)
          mbar_wait(empty + 8 * s, ((i / sh.stages) - 1) & 1);
        const uint32_t st = base + s * sh.stage_bytes;
        const int n0 = 64 * (tile0 + i);
        mbar_arrive_expect_tx(full + 8 * s, BOX + 256 * sh.gw);
        tma_load_4d(st, &tm_x, full + 8 * s, c0, n0, 0, 0, first);
        tma_load_4d(st + BOX, &tm_g, full + 8 * s, 64 * blockIdx.z, n0, 0, 0,
                    last);
      }
    }
  } else {
    // this warpgroup's g parts zeroed once (their columns past MR are never
    // written), and A's rows of the CTA's columns as fp32: column 8 q + e
    // of row j at j * 64 + (e / 4) * 32 + 4 q + e % 4, so a warp's eight
    // chunks q read 128 contiguous bytes
    for (int i = t; i < 3 * BOX / 16; i += 128)
      reinterpret_cast<uint4*>(sm + sh.off_gp + wg * 3 * BOX)[i] =
          make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < (sh.with_dx ? sh.mr * 64 : 0); i += CONSUMERS) {
      const int c = i / sh.mr, j = i % sh.mr;
      af[j * 64 + (c & 4) * 8 + (c >> 3) * 4 + (c & 3)] =
          c0 + c < sh.d ? to_float(a[static_cast<size_t>(c0 + c) * sh.mr + j])
                        : 0.f;
    }
    named_bar_sync(1, CONSUMERS);  // A's rows written
    const int q = t & 7, rr = t >> 3;
    const int half = sh.gw / 2;  // g's column pairs a row
    // thread t's g items of a tile: (row, column pair) (i / half, i % half)
    // for i = t + 128 k, i < 64 half, stepped without a division
    const int ir = t / half, ij = t % half;
    const int sr = 128 / half, sj = 128 % half;
    uint8_t* gp = sm + sh.off_gp + wg * 3 * BOX;
    const uint32_t gpa = base + sh.off_gp + wg * 3 * BOX;
    int k = 0;  // the warpgroup's tiles done
    for (int i = wg; i < ntiles; i += 2, ++k) {
      const int s = i % sh.stages;
      const int n0 = 64 * (tile0 + i);
      uint8_t* xs = sm + s * sh.stage_bytes;
      const float* gs = reinterpret_cast<const float*>(xs + BOX);
      uint8_t* dxs = sm + sh.off_dx + (2 * wg + (k & 1)) * BOX;
      mbar_wait(full + 8 * s, (i / sh.stages) & 1);
      // the words of chunk q of the thread's four rows: x_m = x * keep in
      // place (dA's operand), the bits kept for dx
      uint32_t bk[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = rr + 16 * u;
        uint32_t w[8];
        words8<FORCED>(bits, n0 + r, c0 + 8 * q, sh.n_rows, sh.d, sh.key, w);
        keep_masks(w, sh.thresh, bk[u]);
        uint4* p = reinterpret_cast<uint4*>(xs + r * 128 +
                                            ((q ^ (r & 7)) << 4));
        uint4 v = *p;
        v.x &= bk[u][0];
        v.y &= bk[u][1];
        v.z &= bk[u][2];
        v.w &= bk[u][3];
        *p = v;
      }
      // dx = (g A^T) * m for the four rows: an fp32 FMA chain over j from
      // 0 to M*r - 1, the order of the plain version's product, into the
      // staging tile as bf16 (four j a step, then the M*r % 4 left)
      float acc[4][8];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[u][e] = 0.f;
      int j = 0;
      for (; j + 4 <= (sh.with_dx ? sh.mr : 0); j += 4) {
        float gj[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 v = *reinterpret_cast<const float4*>(
              gs + (rr + 16 * u) * sh.gw + j);
          gj[u][0] = v.x;
          gj[u][1] = v.y;
          gj[u][2] = v.z;
          gj[u][3] = v.w;
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* ar = af + (j + jj) * 64 + 4 * q;
          const float4 a0 = *reinterpret_cast<const float4*>(ar);
          const float4 a1 = *reinterpret_cast<const float4*>(ar + 32);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 8; ++e)
              acc[u][e] = fmaf(gj[u][jj], av[e], acc[u][e]);
        }
      }
      for (; j < (sh.with_dx ? sh.mr : 0); ++j) {
        const float* ar = af + j * 64 + 4 * q;
        const float4 a0 = *reinterpret_cast<const float4*>(ar);
        const float4 a1 = *reinterpret_cast<const float4*>(ar + 32);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float gu = gs[(rr + 16 * u) * sh.gw + j];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[u][e] = fmaf(gu, av[e], acc[u][e]);
        }
      }
      // dx = sum * (1/keep) where kept, +0 where dropped (the plain
      // version's sum * 0 may be -0: equal as a value)
      const float ik = sh.inv_keep;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = rr + 16 * u;
        *reinterpret_cast<uint4*>(dxs + r * 128 + ((q ^ (r & 7)) << 4)) =
            make_uint4(
                pack_bf16(acc[u][0] * ik, acc[u][1] * ik) & bk[u][0],
                pack_bf16(acc[u][2] * ik, acc[u][3] * ik) & bk[u][1],
                pack_bf16(acc[u][4] * ik, acc[u][5] * ik) & bk[u][2],
                pack_bf16(acc[u][6] * ik, acc[u][7] * ik) & bk[u][3]);
      }
      if (k > 0) {  // the last tile's dA products are done: its stage is
                    // free, and the g parts may be written again
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + 8 * ((i - 2) % sh.stages));
        if (k % FLUSH == 0) {
          fence_operand(dacc);
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            dsum[e] += dacc[e];
            dacc[e] = 0.f;
          }
          fence_operand(dacc);
        }
      }
      // g's rows as three bf16 parts (split3) into [row][j]
      {
        int r = ir, jp = ij;
        for (int it = t; it < 64 * half; it += 128) {
          const float2 v =
              *reinterpret_cast<const float2*>(gs + r * sh.gw + 2 * jp);
          uint32_t p[3];
          split3(v.x, v.y, p);
#pragma unroll
          for (int h = 0; h < 3; ++h)
            *reinterpret_cast<uint32_t*>(gp + h * BOX + swz(r, 2 * jp)) =
                p[h];
          r += sr;
          jp += sj;
          if (jp >= half) {
            jp -= half;
            ++r;
          }
        }
      }
      if (t == 0) bulk_wait_read<0>();  // the last dx store read its tile
      fence_proxy_async_smem();
      named_bar_sync(2 + wg, 128);  // x_m, dx and g's parts written
      // dA^T += g^T x_m: A = g^T (MN-major, K = the tile's rows), B = x_m
      // (MN-major), g's three parts
      const uint32_t xa = base + s * sh.stage_bytes;
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 3; ++h)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64_ss<1, 1>(dacc, desc_sw128(gpa + h * BOX + kk * 2048),
                                desc_sw128(xa + kk * 2048), 1);
      wgmma_commit();
      if (t == 0 && sh.with_dx) {
        tma_store_4d(&tm_dx, smem_addr(dxs), c0, n0, 0, 0, l2_evict_first());
        bulk_commit();
      }
    }
    wgmma_wait<0>();
    fence_operand(dacc);
#pragma unroll
    for (int e = 0; e < 32; ++e) dacc[e] += dsum[e];
    if (t == 0) bulk_wait_read<0>();  // the staging tiles are read
  }
  __syncthreads();  // every tile consumed: the ring holds the sums now
  // the warpgroups' sums: warpgroup 1's through shared memory
  if (wg == 1) {
#pragma unroll
    for (int e = 0; e < 32; ++e) red[e * 128 + t] = dacc[e];
  }
  __syncthreads();
  if (wg == 0) {
#pragma unroll
    for (int e = 0; e < 32; ++e) dacc[e] += red[e * 128 + t];
  }

  // dA: the pair's second CTA hands its sum to the first through
  // distributed shared memory; the first adds it (a fixed order), scales by
  // 1/keep and writes dA in A's type
  float* mine = red + 32 * 128;
  if (wg == 0 && rank == 1) {
#pragma unroll
    for (int e = 0; e < 32; ++e) mine[e * 128 + t] = dacc[e];
  }
  cluster.sync();
  if (wg == 0 && rank == 0) {
    const float* other = cluster.map_shared_rank(mine, 1);
    const int r0 = 16 * warp + lane / 4, qd = lane % 4;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 4 * jj + 2 * u + e;
          const int j = 64 * blockIdx.z + r0 + 8 * u;
          const int c = c0 + 8 * jj + 2 * qd + e;
          if (j < sh.mr && c < sh.d)
            from_float((dacc[k] + other[k * 128 + t]) * sh.inv_keep,
                       da + static_cast<size_t>(c) * sh.mr + j);
        }
  }
  cluster.sync();  // the second CTA's shared memory is read: both may exit
}

// ------------------------------------------------ fp32 x (SIMT)

constexpr int F32_FWD_WARPS = 8;   // rows a forward CTA, one a warp
constexpr int F32_BWD_WARPS = 4;   // a backward CTA: 32 columns, rows
                                   // split over the warps

// A warp a row, a lane eight columns at a time; the sums of the CTA's
// MRMAX columns of out (blockIdx.y's tile of M*r) reduced over the warp by
// shuffles
template <typename TA, int MRMAX>
__global__ void __launch_bounds__(F32_FWD_WARPS * 32)
    dropout_fwd_f32(const float* __restrict__ x, const TA* __restrict__ a,
                    const uint32_t* __restrict__ bits, float* __restrict__ out,
                    int n_rows, int d, int mr, uint32_t thresh, float x_scale,
                    const __grid_constant__ RoundKeys rk) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.x * F32_FWD_WARPS + warp;
  const int j0 = blockIdx.y * MRMAX, jw = min(MRMAX, mr - j0);
  if (n >= n_rows) return;
  float acc[MRMAX];
#pragma unroll
  for (int j = 0; j < MRMAX; ++j) acc[j] = 0.f;
  for (int c = 8 * lane; c < d; c += 256) {
    uint32_t w[8];
    if (bits != nullptr)
      words8<true>(bits, n, c, n_rows, d, rk, w);
    else
      words8<false>(bits, n, c, n_rows, d, rk, w);
    const float4* xp =
        reinterpret_cast<const float4*>(x + static_cast<size_t>(n) * d + c);
    const float4 lo = xp[0], hi = xp[1];
    const float xv[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float xd = w[e] < thresh ? xv[e] * x_scale : 0.f;
      const TA* ar = a + static_cast<size_t>(c + e) * mr + j0;
#pragma unroll
      for (int j = 0; j < MRMAX; ++j)
        if (j < jw) acc[j] = fmaf(xd, to_float(ar[j]), acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < MRMAX; ++j) {
    float v = acc[j];
#pragma unroll
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    acc[j] = v;
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < MRMAX; ++j)
      if (j < jw) out[static_cast<size_t>(n) * mr + j0 + j] = acc[j];
  }
}

// A lane a column (its values of A in the CTA's MRMAX columns of M*r,
// blockIdx.y's tile, in registers), the warps taking every
// F32_BWD_WARPS-th row; dA's partial sums added over the warps in order.
// With with_dx (M*r <= MRMAX: one tile) it also forms dx; above, dx comes
// from dropout_dx_kernel
template <typename TA, int MRMAX>
__global__ void __launch_bounds__(F32_BWD_WARPS * 32)
    dropout_bwd_f32(const float* __restrict__ x, const TA* __restrict__ a,
                    const uint32_t* __restrict__ bits,
                    const float* __restrict__ g, float* __restrict__ dx,
                    TA* __restrict__ da, int n_rows, int d, int mr, int gw,
                    int with_dx, uint32_t thresh, float inv_keep,
                    const __grid_constant__ RoundKeys rk) {
  __shared__ float red[F32_BWD_WARPS][MRMAX][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * 32 + lane;
  const int j0 = blockIdx.y * MRMAX, jw = min(MRMAX, mr - j0);
  const bool live = c < d;
  float av[MRMAX], acc[MRMAX];
#pragma unroll
  for (int j = 0; j < MRMAX; ++j) {
    av[j] = live && j < jw
        ? to_float(a[static_cast<size_t>(c) * mr + j0 + j]) : 0.f;
    acc[j] = 0.f;
  }
  for (int n = warp; n < n_rows; n += F32_BWD_WARPS) {
    uint32_t wd = 0u;
    if (bits != nullptr) {
      if (live) wd = bits[static_cast<size_t>(n) * d + c];
    } else {
      uint32_t w4[4];
      philox(counter_row(rk, n), (static_cast<uint32_t>(c) >> 2) + rk.col,
             rk, w4);
      const int e = c & 3;
      wd = e == 0 ? w4[0] : e == 1 ? w4[1] : e == 2 ? w4[2] : w4[3];
    }
    const float m = wd < thresh ? inv_keep : 0.f;
    const float xm = live ? x[static_cast<size_t>(n) * d + c] * m : 0.f;
    const float* gr = g + static_cast<size_t>(n) * gw + j0;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < MRMAX; ++j)
      if (j < jw) {
        const float gj = gr[j];
        s = fmaf(gj, av[j], s);
        acc[j] = fmaf(xm, gj, acc[j]);
      }
    if (live && with_dx) dx[static_cast<size_t>(n) * d + c] = s * m;
  }
#pragma unroll
  for (int j = 0; j < MRMAX; ++j) red[warp][j][lane] = acc[j];
  __syncthreads();
  if (warp == 0 && live) {
#pragma unroll
    for (int j = 0; j < MRMAX; ++j)
      if (j < jw) {
        float s = red[0][j][lane];
#pragma unroll
        for (int w = 1; w < F32_BWD_WARPS; ++w) s += red[w][j][lane];
        from_float(s, da + static_cast<size_t>(c) * mr + j0 + j);
      }
  }
}

// ------------------------------------------------ dx at M*r > 64

constexpr int DX_NT = 256;     // 32 row slots x 8 column groups of 8
constexpr int DX_ROWS = 4;     // rows a thread: 128 rows a block, 32 apart
constexpr int DX_JC = 256;     // rows j of A^T staged at once (64 KB)

// dx = ((g A^T) * m) in x's type where M*r > 64 and the backward's tiles
// take dA alone (their stage holds 64 of g's columns, not all M*r).  A CTA
// owns 64 columns of d and walks every gridDim.y-th block of 128 rows; a
// thread takes 8 adjacent columns of DX_ROWS rows.  A's fp32 rows of the
// CTA's columns sit in shared memory in the backward kernel's layout, DX_JC
// rows j at a time (64 * DX_JC * 4 bytes, whatever M*r): where M*r fits
// one chunk they are staged once, else each row block stages the chunks in
// order, its rows' accumulators held in registers across them.  g's rows
// come from L2, and the chain is the backward kernel's: fp32 FMAs over j
// from 0 to M*r - 1 in the plain version's order, so dx matches it to the
// bit at every M*r.  Bound: M*r FMAs an element, 2 * N * d * M*r flops of
// the ordinary cores.
template <typename T, typename TA, bool FORCED>
__global__ void __launch_bounds__(DX_NT)
    dropout_dx_kernel(const TA* __restrict__ a,
                      const uint32_t* __restrict__ bits,
                      const float* __restrict__ g, T* __restrict__ dx,
                      int n_rows, int d, int mr, int gw, uint32_t thresh,
                      float inv_keep, const __grid_constant__ RoundKeys rk) {
  extern __shared__ __align__(16) float afs[];  // [DX_JC][64]
  const int c0 = blockIdx.x * 64, t = threadIdx.x, q = t & 7, rr = t >> 3;
  const int chunks = (mr + DX_JC - 1) / DX_JC;
  const bool live = c0 + 8 * q < d;
  for (int n0 = blockIdx.y * 32 * DX_ROWS; n0 < n_rows;
       n0 += gridDim.y * 32 * DX_ROWS) {
    float acc[DX_ROWS][8];
#pragma unroll
    for (int u = 0; u < DX_ROWS; ++u)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[u][e] = 0.f;
    // the rows' g (a row past the array reads the last one, never stored)
    const float* gr[DX_ROWS];
#pragma unroll
    for (int u = 0; u < DX_ROWS; ++u)
      gr[u] = g + static_cast<size_t>(min(n0 + rr + 32 * u, n_rows - 1)) * gw;
    for (int ch = 0; ch < chunks; ++ch) {
      const int j0 = ch * DX_JC, jn = min(DX_JC, mr - j0);
      if (chunks > 1 || n0 == static_cast<int>(blockIdx.y) * 32 * DX_ROWS) {
        __syncthreads();  // the last chunk's readers are done
        for (int i = t; i < jn * 64; i += DX_NT) {
          const int c = i / jn, j = i % jn;
          afs[j * 64 + (c & 4) * 8 + (c >> 3) * 4 + (c & 3)] =
              c0 + c < d
                  ? to_float(a[static_cast<size_t>(c0 + c) * mr + j0 + j])
                  : 0.f;
        }
        __syncthreads();
      }
      if (!live) continue;
      int j = 0;
      for (; j + 4 <= jn; j += 4) {
        float gj[DX_ROWS][4];
#pragma unroll
        for (int u = 0; u < DX_ROWS; ++u) {
          const float4 gv =
              *reinterpret_cast<const float4*>(gr[u] + j0 + j);
          gj[u][0] = gv.x;
          gj[u][1] = gv.y;
          gj[u][2] = gv.z;
          gj[u][3] = gv.w;
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* ar = afs + (j + jj) * 64 + 4 * q;
          const float4 a0 = *reinterpret_cast<const float4*>(ar);
          const float4 a1 = *reinterpret_cast<const float4*>(ar + 32);
          const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int u = 0; u < DX_ROWS; ++u)
#pragma unroll
            for (int e = 0; e < 8; ++e)
              acc[u][e] = fmaf(gj[u][jj], av[e], acc[u][e]);
        }
      }
      for (; j < jn; ++j) {
        const float* ar = afs + j * 64 + 4 * q;
        const float4 a0 = *reinterpret_cast<const float4*>(ar);
        const float4 a1 = *reinterpret_cast<const float4*>(ar + 32);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int u = 0; u < DX_ROWS; ++u) {
          const float gu = gr[u][j0 + j];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[u][e] = fmaf(gu, av[e], acc[u][e]);
        }
      }
    }
    if (!live) continue;
    // sum * (1/keep) where kept, +0 where dropped
#pragma unroll
    for (int u = 0; u < DX_ROWS; ++u) {
      const int n = n0 + rr + 32 * u;
      if (n >= n_rows) continue;
      uint32_t w[8];
      words8<FORCED>(bits, n, c0 + 8 * q, n_rows, d, rk, w);
      T* o = dx + static_cast<size_t>(n) * d + c0 + 8 * q;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        from_float(w[e] < thresh ? acc[u][e] * inv_keep : 0.f, o + e);
    }
  }
}

// ------------------------------------------------------------ launches

// what the kernels take: every M * r (any rank, any number of
// modalities); d % 8 == 0 (TMA rows of 16-byte multiples; eight columns a
// thread)
bool takes(int n, int d, int mr) {
  return n > 0 && d > 0 && d % 8 == 0 && mr >= 1;
}

// g's row width in memory: M*r up to a multiple of 4 (the wrapper pads g
// with zero columns), so its TMA rows are 16-byte multiples
int g_width(int mr) { return (mr + 3) / 4 * 4; }

// the dx kernel's launch for M*r > 64: a CTA 64 columns, row blocks for
// about three CTAs an SM (64 KB of A's rows each at M*r >= DX_JC)
template <typename T, typename TA, bool FORCED>
int launch_dx(const void* a, const void* bits, const void* g, void* dx,
              int n, int d, int mr, uint32_t thresh, float inv_keep,
              const RoundKeys& rk, cudaStream_t st) {
  const int smem = 4 * 64 * (mr < DX_JC ? mr : DX_JC);
  static const cudaError_t attr = cudaFuncSetAttribute(
      dropout_dx_kernel<T, TA, FORCED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, 4 * 64 * DX_JC);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int cols = (d + 63) / 64, groups = (n + 32 * DX_ROWS - 1) /
                                           (32 * DX_ROWS);
  int gy = 3 * sm_count() / cols;
  gy = gy < 1 ? 1 : gy > groups ? groups : gy;
  dropout_dx_kernel<T, TA, FORCED><<<dim3(cols, gy), DX_NT, smem, st>>>(
      static_cast<const TA*>(a), static_cast<const uint32_t*>(bits),
      static_cast<const float*>(g), static_cast<T*>(dx), n, d, mr,
      g_width(mr), thresh, inv_keep, rk);
  return static_cast<int>(cudaGetLastError());
}

uint32_t bf16_pair(float v) {  // v is a bf16 value: its high 16 bits, twice
  uint32_t b;
  memcpy(&b, &v, 4);
  return (b >> 16) | (b & 0xffff0000u);
}

bool bf16_map(CUtensorMap* map, const void* p, int n, int d, int rows) {
  const uint64_t dims[4] = {uint64_t(d), uint64_t(n), 1, 1};
  const uint32_t box[4] = {64, uint32_t(rows), 1, 1};
  return swizzled_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 4, p, dims,
                      box);
}

long fwd_workspace(int d, int mr, int a_bf16) {
  return 2L * (a_bf16 ? 1 : 3) * a_rows(mr) * d;
}

template <typename TA, bool FORCED>
int launch_fwd(const void* x, const void* a, const void* bits, void* out,
               void* work, int n, int d, int mr, uint32_t thresh,
               float x_scale, const RoundKeys& rk, cudaStream_t st) {
  constexpr int H = a_parts<TA>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      dropout_fwd_kernel<TA, FORCED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int rows = a_rows(mr);
  const int box_rows = rows < 64 ? rows : 64;  // a CTA's tile of A^T's rows
  __nv_bfloat16* at = static_cast<__nv_bfloat16*>(work);
  transpose_a_kernel<TA><<<dim3((d / 2 + 255) / 256, rows < 65535 ? rows
                                                                   : 65535),
                           256, 0, st>>>(
      static_cast<const TA*>(a), at, d, mr, rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  FwdShape sh;
  sh.n_rows = n;
  sh.d = d;
  sh.mr = mr;
  sh.kb = (d + 63) / 64;
  sh.at_bytes = box_rows * 128;
  sh.stage_bytes = H * sh.at_bytes + FWD_XBYTES;
  const int tail = FWD_RED + 16 * FWD_MAX_STAGES;
  sh.stages = (SMEM_LIMIT - 1024 - tail) / sh.stage_bytes;
  sh.stages = sh.stages < FWD_MAX_STAGES ? sh.stages : FWD_MAX_STAGES;
  // a warpgroup releases a stage one of its own stages late: the ring must
  // hold two stages of each warpgroup and the next one
  if (sh.stages < 2 * FWD_WG + 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + sh.stages * sh.stage_bytes + tail;
  sh.thresh = thresh;
  sh.scale2 = bf16_pair(x_scale);
  sh.key = rk;
  CUtensorMap tm_x, tm_at;
  const uint64_t at_dims[4] = {uint64_t(d), uint64_t(rows), uint64_t(H), 1};
  const uint32_t at_box[4] = {64, uint32_t(box_rows), 1, 1};
  if (!bf16_map(&tm_x, x, n, d, FWD_ROWS) ||
      !swizzled_map(&tm_at, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 4, at,
                    at_dims, at_box))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + FWD_ROWS - 1) / FWD_ROWS, (mr + 63) / 64);
  dropout_fwd_kernel<TA, FORCED><<<grid, FWD_NT, smem, st>>>(
      tm_x, tm_at, static_cast<const uint32_t*>(bits),
      static_cast<float*>(out), sh);
  return static_cast<int>(cudaGetLastError());
}

// a 4-D tensor map over a row-major (rows, cols) fp32 array, in unswizzled
// boxes of box_rows rows of box_cols; what lies past the array loads as
// zero
bool f32_rows_map(CUtensorMap* map, const void* p, int rows, int cols,
                  int box_cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row = 4ull * cols;
  const cuuint64_t dims[4] = {cuuint64_t(cols), cuuint64_t(rows), 1, 1};
  const cuuint64_t strides[3] = {row, row * rows, row * rows};
  const cuuint32_t box[4] = {cuuint32_t(box_cols), cuuint32_t(box_rows), 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(p),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TA, bool FORCED>
int launch_bwd(const void* x, const void* a, const void* bits, const void* g,
               void* dx, void* da, int n, int d, int mr, uint32_t thresh,
               float inv_keep, const RoundKeys& rk, cudaStream_t st) {
  BwdShape sh;
  sh.n_rows = n;
  sh.d = d;
  sh.mr = mr;
  sh.with_dx = mr <= 64;
  sh.gw = sh.with_dx ? g_width(mr) : 64;
  sh.tiles = ((n + 63) / 64 + 1) / 2;
  sh.stage_bytes = BOX + 256 * sh.gw;
  // after the ring: the g parts and staging tiles of the two warpgroups, A
  const int af_bytes = sh.with_dx ? 4 * 64 * mr : 0;
  const int rest = 2 * 3 * BOX + 2 * 2 * BOX + af_bytes;
  sh.stages = (SMEM_LIMIT - 1024 - 16 * BWD_MAX_STAGES - rest) /
              sh.stage_bytes;
  sh.stages = sh.stages < BWD_MAX_STAGES ? sh.stages : BWD_MAX_STAGES;
  // a warpgroup releases its tile's stage during its next tile, two tiles
  // on: the ring must hold three
  if (sh.stages < 3) return static_cast<int>(cudaErrorInvalidValue);
  sh.off_gp = sh.stages * sh.stage_bytes;
  sh.off_dx = sh.off_gp + 2 * 3 * BOX;
  sh.off_af = sh.off_dx + 2 * 2 * BOX;
  sh.off_bars = sh.off_af + af_bytes;
  sh.thresh = thresh;
  sh.inv_keep = inv_keep;
  sh.key = rk;
  // the ring holds the warpgroups' and the pair's sums at the end
  if (sh.stages * sh.stage_bytes < 2 * 32 * 128 * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + sh.off_bars + 16 * BWD_MAX_STAGES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      dropout_bwd_kernel<TA, FORCED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  CUtensorMap tm_x, tm_g, tm_dx;
  if (!bf16_map(&tm_x, x, n, d, 64) ||
      !f32_rows_map(&tm_g, g, n, g_width(mr), sh.gw, 64) ||
      !bf16_map(&tm_dx, dx, n, d, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((d + BWD_COLS - 1) / BWD_COLS, 2, (mr + 63) / 64);
  dropout_bwd_kernel<TA, FORCED><<<grid, BWD_NT, smem, st>>>(
      tm_x, tm_g, tm_dx, static_cast<const TA*>(a),
      static_cast<const uint32_t*>(bits), static_cast<TA*>(da), sh);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sh.with_dx) return static_cast<int>(err);
  return launch_dx<__nv_bfloat16, TA, FORCED>(a, bits, g, dx, n, d, mr,
                                              thresh, inv_keep, rk, st);
}

// bf16 x: the kernels' instance for forced words or the generator
template <typename TA>
int fwd_bf16(const void* x, const void* a, const void* bits, void* out,
             void* work, int n, int d, int mr, uint32_t thresh, float x_scale,
             const RoundKeys& rk, cudaStream_t st) {
  return bits ? launch_fwd<TA, true>(x, a, bits, out, work, n, d, mr, thresh,
                                     x_scale, rk, st)
              : launch_fwd<TA, false>(x, a, bits, out, work, n, d, mr,
                                      thresh, x_scale, rk, st);
}

template <typename TA>
int bwd_bf16(const void* x, const void* a, const void* bits, const void* g,
             void* dx, void* da, int n, int d, int mr, uint32_t thresh,
             float inv_keep, const RoundKeys& rk, cudaStream_t st) {
  return bits ? launch_bwd<TA, true>(x, a, bits, g, dx, da, n, d, mr, thresh,
                                     inv_keep, rk, st)
              : launch_bwd<TA, false>(x, a, bits, g, dx, da, n, d, mr, thresh,
                                      inv_keep, rk, st);
}

template <typename TA>
int launch_fwd_f32(const void* x, const void* a, const void* bits, void* out,
                   int n, int d, int mr, uint32_t thresh, float x_scale,
                   const RoundKeys& rk, cudaStream_t st) {
  const int rows = (n + F32_FWD_WARPS - 1) / F32_FWD_WARPS;
  const float* xp = static_cast<const float*>(x);
  const TA* ap = static_cast<const TA*>(a);
  const uint32_t* bp = static_cast<const uint32_t*>(bits);
  float* op = static_cast<float*>(out);
  if (mr <= 16)
    dropout_fwd_f32<TA, 16><<<rows, F32_FWD_WARPS * 32, 0, st>>>(
        xp, ap, bp, op, n, d, mr, thresh, x_scale, rk);
  else
    dropout_fwd_f32<TA, 64><<<dim3(rows, (mr + 63) / 64),
                              F32_FWD_WARPS * 32, 0, st>>>(
        xp, ap, bp, op, n, d, mr, thresh, x_scale, rk);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA>
int launch_bwd_f32(const void* x, const void* a, const void* bits,
                   const void* g, void* dx, void* da, int n, int d, int mr,
                   uint32_t thresh, float inv_keep, const RoundKeys& rk,
                   cudaStream_t st) {
  const int cols = (d + 31) / 32;
  const float* xp = static_cast<const float*>(x);
  const TA* ap = static_cast<const TA*>(a);
  const uint32_t* bp = static_cast<const uint32_t*>(bits);
  const float* gp = static_cast<const float*>(g);
  float* dxp = static_cast<float*>(dx);
  TA* dap = static_cast<TA*>(da);
  const int gw = g_width(mr), with_dx = mr <= 64;
  if (mr <= 16)
    dropout_bwd_f32<TA, 16><<<cols, F32_BWD_WARPS * 32, 0, st>>>(
        xp, ap, bp, gp, dxp, dap, n, d, mr, gw, with_dx, thresh, inv_keep,
        rk);
  else
    dropout_bwd_f32<TA, 64><<<dim3(cols, (mr + 63) / 64),
                              F32_BWD_WARPS * 32, 0, st>>>(
        xp, ap, bp, gp, dxp, dap, n, d, mr, gw, with_dx, thresh, inv_keep,
        rk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || with_dx) return static_cast<int>(err);
  return bits ? launch_dx<float, TA, true>(a, bits, g, dx, n, d, mr, thresh,
                                          inv_keep, rk, st)
              : launch_dx<float, TA, false>(a, bits, g, dx, n, d, mr, thresh,
                                           inv_keep, rk, st);
}

}  // namespace

// Bytes of scratch kernel 6 needs for bf16 x: A's transposed bf16 parts
// (0 for a shape the kernels do not take; fp32 x needs none).
extern "C" long moka_dropout_fwd_workspace(int d, int mr, int a_bf16) {
  return takes(1, d, mr) ? fwd_workspace(d, mr, a_bf16) : 0;
}

// Kernel 6.  x (n, d) bf16 (x_bf16 = 1) or fp32, A (d, mr) bf16 (a_bf16 =
// 1) or fp32, bits (n, d) 32-bit words or null (Philox under (k0, k1), row
// n at counter row (row_seg, row_stride, row_base)'s row of it and column
// c at column counter col_group + c / 4: RoundKeys),
// out (n, mr) fp32, work moka_dropout_fwd_workspace's bytes (bf16 x); all
// contiguous and 16-byte aligned; x_scale is s_x (a bf16 value for bf16
// x).  bf16 x launches the transpose pass, then the kernel.  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for a
// shape the kernels do not take.
extern "C" int moka_dropout_a_fwd(const void* x, int x_bf16, const void* a,
                                  int a_bf16, const void* bits, void* out,
                                  void* work, int n, int d, int mr,
                                  uint32_t thresh, float x_scale, uint32_t k0,
                                  uint32_t k1, uint32_t row_seg,
                                  uint32_t row_stride, uint32_t row_base,
                                  uint32_t col_group, void* stream) {
  if (!takes(n, d, mr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RoundKeys rk =
      round_keys(k0, k1, row_seg, row_stride, row_base, col_group);
  if (x_bf16)
    return a_bf16 ? fwd_bf16<__nv_bfloat16>(x, a, bits, out, work, n, d, mr,
                                            thresh, x_scale, rk, s)
                  : fwd_bf16<float>(x, a, bits, out, work, n, d, mr, thresh,
                                    x_scale, rk, s);
  return a_bf16 ? launch_fwd_f32<__nv_bfloat16>(x, a, bits, out, n, d, mr,
                                                thresh, x_scale, rk, s)
                : launch_fwd_f32<float>(x, a, bits, out, n, d, mr, thresh,
                                        x_scale, rk, s);
}

// Kernel 7.  g (n, g_width(mr)) fp32, its columns past mr zero; dx (n, d)
// in x's type; da (d, mr) in A's type; the rest as moka_dropout_a_fwd.  One
// launch at mr <= 64; above, the dA tiles' launch and the dx kernel's.
extern "C" int moka_dropout_a_bwd(const void* x, int x_bf16, const void* a,
                                  int a_bf16, const void* bits, const void* g,
                                  void* dx, void* da, int n, int d, int mr,
                                  uint32_t thresh, float inv_keep, uint32_t k0,
                                  uint32_t k1, uint32_t row_seg,
                                  uint32_t row_stride, uint32_t row_base,
                                  uint32_t col_group, void* stream) {
  if (!takes(n, d, mr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RoundKeys rk =
      round_keys(k0, k1, row_seg, row_stride, row_base, col_group);
  if (x_bf16)
    return a_bf16 ? bwd_bf16<__nv_bfloat16>(x, a, bits, g, dx, da, n, d, mr,
                                            thresh, inv_keep, rk, s)
                  : bwd_bf16<float>(x, a, bits, g, dx, da, n, d, mr, thresh,
                                    inv_keep, rk, s);
  return a_bf16 ? launch_bwd_f32<__nv_bfloat16>(x, a, bits, g, dx, da, n, d,
                                                mr, thresh, inv_keep, rk, s)
                : launch_bwd_f32<float>(x, a, bits, g, dx, da, n, d, mr,
                                        thresh, inv_keep, rk, s);
}
