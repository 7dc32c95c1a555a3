// Flash attention backward for Hopper (sm_90a): three kernels with the
// contract of the TPU kernels in moka_tpu/ops/flash_attention.py.
//
//   fused  replaces _bwd_fused_kernel (launched by _flash_bwd_fused): dq, dk
//          and dv in one pass, every score, probability and dp computed once
//          for all three gradients;
//   dq     replaces _bwd_dq_kernel (_flash_bwd_dq): dq alone, given the
//          global-row lse and delta (ring attention calls it per key shard);
//   dkv    replaces _bwd_dkv_kernel (_flash_bwd_dkv): dk and dv alone.
//
// Numerics, as the TPU kernels:
//   * q is pre-scaled by qscale = scale*log2(e) (the scalar and the product
//     rounded to bf16, as flash_fwd.cu does), so scores are base 2; the row's
//     natural-log lse from the forward enters as lse*log2(e);
//   * p = exp2(s - lse_row), and p = 0 where the key is masked or where
//     lse_row <= NEG_INF/2 (a query row whose keys are all masked gets zero
//     gradients);
//   * delta = rowsum(dO * O) in fp32 comes from the wrapper;
//     ds = p * (dp - delta) with p and dp in fp32;
//   * p is rounded to bf16 before P^T dO, ds before dS K and dS^T q;
//   * dq carries the softmax scale; dk carries ln 2 at write-out, because it
//     contracts against the pre-scaled q (scale*log2 e);
//   * causal, padding and q_offset masks are computed inline; tiles wholly
//     above the diagonal are skipped; ragged L and S are masked here, the
//     wrapper does not pad.
//
// Layouts: q/dout (B, L, H, hd) bf16, k/v (B, S, KH, hd) bf16, mask (B, S)
// int32, lse/delta (B, H, L) fp32, all contiguous.  Outputs: dq (B, L, H, hd)
// bf16 (dq kernel) or fp32 accumulated by atomicAdd into a zeroed workspace
// (fused kernel; the wrapper casts it); dk/dv (B, S, H, hd) fp32 per query
// head (the wrapper sums each GQA group).
//
// Design.  The TPU kernels hold a whole 1024 x 1024 score block in VMEM; an
// SM's 227 KB of shared memory cannot, so the work is cut in 64-key tiles:
//   * fused / dkv: one CTA of 4 warps per (64-key tile, batch*head).  K and V
//     stay in shared memory; the CTA loops over 32-row query tiles from the
//     diagonal on.  Each warp owns 16 keys and computes S^T = K q^T and
//     dP^T = V dO^T for them (so P^T and dS^T are A fragments of the next
//     products without a transpose), and accumulates its rows of dk and dv
//     in registers across the loop.  The fused kernel also writes dS^T to
//     shared memory as bf16 and each warp forms a 16 x 64 block of
//     dS K, added into the fp32 dq workspace with atomicAdd: dq's summation
//     order over key tiles therefore varies from run to run (the tolerance
//     in chip_smoke.py allows for it).
//   * dq: one CTA of 4 warps per (64-row query tile, batch*head), looping
//     over 64-key tiles up to the diagonal; each warp owns 16 query rows and
//     accumulates dq in registers.  No atomics.
// All products run on mma.sync m16n8k16 (bf16 in, fp32 accumulate).  The
// tiles need more than the 48 KB of static shared memory ptxas accepts, so
// they are dynamic shared memory (57 KB and 68 KB), raised per kernel with
// cudaFuncSetAttribute.  No TMA, wgmma or double buffering in this first cut.
//
// Bounds, from the data sheet (989 TFLOP/s bf16, 3.35 TB/s), not measured:
//   * fused at b 4, H 32, L = S = 1024, hd 128, causal: 67.2 M visible
//     (q, k) pairs x 5 products x 2*128 flop = 86 GFLOP, 0.087 ms; bytes:
//     q, k, v, dO read (4 x 33.5 MB), lse and delta (1 MB), dq bf16 (33.5 MB)
//     and dk/dv fp32 (2 x 67 MB) written, ~302 MB, 0.090 ms: bound by bytes;
//   * at b 1, H 32, L = S = 4096: 268 M pairs; dq 3 products, 206 GFLOP,
//     0.21 ms; dkv 4 products, 275 GFLOP, 0.28 ms: both bound by flops.
// Measured times are in PERF.md.

#include "flash_common.cuh"

namespace {

using namespace moka_flash;

constexpr int HD = 128;         // head dim (LLaMA-2); others are refused
constexpr int LDS = HD + 8;     // padded shared-memory row, in elements
constexpr int NTHREADS = 128;   // 4 warps
constexpr int BK = 64;          // keys per tile
constexpr int BQ_KV = 32;       // query rows a step of the fused/dkv loop
constexpr int BQ_DQ = 64;       // query rows a CTA of the dq kernel
constexpr int LDT = BQ_KV + 8;  // padded row of the dS^T tile
constexpr int KSTEPS = HD / 16;
constexpr int DTILES = HD / 8;

struct Args {
  const uint16_t* q;
  const uint16_t* k;
  const uint16_t* v;
  const int* mask;
  const uint16_t* dout;
  const float* lse;
  const float* delta;
  float* dq_acc;  // fused: fp32 (B, L, H, hd), zeroed by the wrapper
  uint16_t* dq;   // dq kernel: bf16 (B, L, H, hd)
  float* dk;      // fused/dkv: fp32 (B, S, H, hd)
  float* dv;
  int H, KH, L, S, q_offset, causal;
  float qscale, scale;
};

constexpr size_t KV_SMEM =
    (2 * BK * LDS + 2 * BQ_KV * LDS + BK * LDT) * sizeof(uint16_t) +
    2 * BQ_KV * sizeof(float) + BK * sizeof(int);
constexpr size_t DQ_SMEM =
    (2 * BQ_DQ * LDS + 2 * BK * LDS) * sizeof(uint16_t) + BK * sizeof(int);

// rows [r0, r0 + ROWS) of a bf16 tensor whose row r starts at src + r*stride
// into a [ROWS][LDS] shared tile; rows >= n are zero.  With qscale != 0 each
// value is multiplied by it and rounded to bf16 (the pre-scaled q).
template <int ROWS>
__device__ __forceinline__ void load_rows(uint16_t* dst, const uint16_t* src,
                                          long stride, int r0, int n,
                                          float qscale) {
  constexpr int CHUNKS = HD / 8;  // 16-byte pieces per row
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NTHREADS) {
    const int row = i / CHUNKS, ch = i % CHUNKS;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < n) {
      val = *reinterpret_cast<const uint4*>(src + (r0 + row) * stride + ch * 8);
      if (qscale != 0.f) {
        val.x = scale_pair(val.x, qscale);
        val.y = scale_pair(val.y, qscale);
        val.z = scale_pair(val.z, qscale);
        val.w = scale_pair(val.w, qscale);
      }
    }
    *reinterpret_cast<uint4*>(dst + row * LDS + ch * 8) = val;
  }
}

// key validity of keys [k0, k0 + BK) of batch row b
__device__ __forceinline__ void load_key_mask(int* ms, const int* mask, int b,
                                              int k0, int S) {
  if (threadIdx.x < BK) {
    const int key = k0 + threadIdx.x;
    ms[threadIdx.x] = key < S && mask[static_cast<long>(b) * S + key] > 0;
  }
}

// A fragment (16 rows x 16) at rows [r, r + 16), columns [c, c + 16) of a
// row-major shared tile
__device__ __forceinline__ void a_frag(uint32_t (&af)[4], const uint16_t* t,
                                       int r, int c, int ld) {
  const int g = (threadIdx.x % 32) >> 2, tq = threadIdx.x & 3;
  af[0] = pair_in_row(t, r + g, c + 2 * tq, ld);
  af[1] = pair_in_row(t, r + g + 8, c + 2 * tq, ld);
  af[2] = pair_in_row(t, r + g, c + 2 * tq + 8, ld);
  af[3] = pair_in_row(t, r + g + 8, c + 2 * tq + 8, ld);
}

// A fragments of 16 rows x 16 k from fp32 accumulators acc[2j], acc[2j+1]
// (columns 16j .. 16j+15 of a 16-row block), rounded to bf16
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&af)[4],
                                         const float (&acc)[N][4], int j) {
  af[0] = pack_bf16(acc[2 * j][0], acc[2 * j][1]);
  af[1] = pack_bf16(acc[2 * j][2], acc[2 * j][3]);
  af[2] = pack_bf16(acc[2 * j + 1][0], acc[2 * j + 1][1]);
  af[3] = pack_bf16(acc[2 * j + 1][2], acc[2 * j + 1][3]);
}

// fused (WITH_DQ) and dkv: one CTA per (64-key tile, batch*head)
template <bool WITH_DQ>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_kv_kernel(Args a) {
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* ks = smem;                    // [BK][LDS]
  uint16_t* vs = ks + BK * LDS;           // [BK][LDS]
  uint16_t* qs = vs + BK * LDS;           // [BQ_KV][LDS], pre-scaled q
  uint16_t* dos = qs + BQ_KV * LDS;       // [BQ_KV][LDS]
  uint16_t* dst = dos + BQ_KV * LDS;      // [BK][LDT], dS^T in bf16
  float* lse_s = reinterpret_cast<float*>(dst + BK * LDT);  // lse * log2 e
  float* delta_s = lse_s + BQ_KV;
  int* ms = reinterpret_cast<int*>(delta_s + BQ_KV);

  const int H = a.H, L = a.L, S = a.S, q_offset = a.q_offset;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / a.KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int kr = warp * 16;  // this warp's 16 keys within the tile

  const long q_stride = static_cast<long>(H) * HD;
  const long kv_stride = static_cast<long>(a.KH) * HD;
  const uint16_t* qb = a.q + (static_cast<long>(b) * L * H + h) * HD;
  const uint16_t* dob = a.dout + (static_cast<long>(b) * L * H + h) * HD;
  const uint16_t* kb = a.k + (static_cast<long>(b) * S * a.KH + kh) * HD;
  const uint16_t* vb = a.v + (static_cast<long>(b) * S * a.KH + kh) * HD;
  const float* lseb = a.lse + static_cast<long>(bh) * L;
  const float* deltab = a.delta + static_cast<long>(bh) * L;

  load_rows<BK>(ks, kb, kv_stride, k0, S, 0.f);
  load_rows<BK>(vs, vb, kv_stride, k0, S, 0.f);
  load_key_mask(ms, a.mask, b, k0, S);

  float dk_acc[DTILES][4], dv_acc[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  // the first query tile with a row that can see a key of this tile
  const int first = a.causal ? max(0, k0 - q_offset) / BQ_KV : 0;
  const int n_qt = (L + BQ_KV - 1) / BQ_KV;
  constexpr int NT = BQ_KV / 8;  // n-tiles of the 16 x BQ_KV score block

  for (int qt = first; qt < n_qt; ++qt) {
    const int q0 = qt * BQ_KV;
    __syncthreads();  // the previous query tile (and dS^T) is consumed
    load_rows<BQ_KV>(qs, qb, q_stride, q0, L, a.qscale);
    load_rows<BQ_KV>(dos, dob, q_stride, q0, L, 0.f);
    if (threadIdx.x < BQ_KV) {
      const int i = q0 + threadIdx.x;
      lse_s[threadIdx.x] = i < L ? lseb[i] * LOG2E : NEG_INF;
      delta_s[threadIdx.x] = i < L ? deltab[i] : 0.f;
    }
    __syncthreads();

    // S^T = K q^T and dP^T = V dO^T for this warp's 16 keys
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      uint32_t kf[4], vf[4];
      a_frag(kf, ks, kr, s * 16, LDS);
      a_frag(vf, vs, kr, s * 16, LDS);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = nt * 8 + g, c = s * 16 + 2 * t;
        mma_bf16(st[nt], kf, pair_in_row(qs, r, c, LDS),
                 pair_in_row(qs, r, c + 8, LDS));
        mma_bf16(dpt[nt], vf, pair_in_row(dos, r, c, LDS),
                 pair_in_row(dos, r, c + 8, LDS));
      }
    }

    // P^T, then dS^T = P^T (dP^T - delta), both fp32
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = kr + g + 8 * (e >> 1);
        const int qi = nt * 8 + 2 * t + (e & 1);
        const float lr = lse_s[qi];
        const bool ok = ms[kl] && lr > NEG_INF * 0.5f &&
                        (!a.causal || q0 + qi + q_offset >= k0 + kl);
        const float p = ok ? exp2f(st[nt][e] - lr) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - delta_s[qi]);
      }
    }

    // dV += P^T dO and dK += dS^T q (contraction over the query rows)
#pragma unroll
    for (int j = 0; j < BQ_KV / 16; ++j) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, st, j);
      acc_to_a(da, dpt, j);
      const int qr = j * 16 + 2 * t;
#pragma unroll
      for (int dn = 0; dn < DTILES; ++dn) {
        const int n = dn * 8 + g;
        mma_bf16(dv_acc[dn], pa, pair_in_col(dos, qr, n, LDS),
                 pair_in_col(dos, qr + 8, n, LDS));
        mma_bf16(dk_acc[dn], da, pair_in_col(qs, qr, n, LDS),
                 pair_in_col(qs, qr + 8, n, LDS));
      }
    }

    if (WITH_DQ) {
      // dS^T to shared memory as bf16, rows = keys
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dst + (kr + g) * LDT + c) =
            pack_bf16(dpt[nt][0], dpt[nt][1]);
        *reinterpret_cast<uint32_t*>(dst + (kr + g + 8) * LDT + c) =
            pack_bf16(dpt[nt][2], dpt[nt][3]);
      }
      __syncthreads();
      // dq (BQ_KV x HD) += dS K: warp -> 16 query rows x 64 columns
      const int qr0 = (warp & 1) * 16, c0 = (warp >> 1) * 64;
      float dqa[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[i][e] = 0.f;
#pragma unroll
      for (int s = 0; s < BK / 16; ++s) {
        const int kk = s * 16 + 2 * t;
        uint32_t af[4];  // A[q][key] = dS^T[key][q]
        af[0] = pair_in_col(dst, kk, qr0 + g, LDT);
        af[1] = pair_in_col(dst, kk, qr0 + g + 8, LDT);
        af[2] = pair_in_col(dst, kk + 8, qr0 + g, LDT);
        af[3] = pair_in_col(dst, kk + 8, qr0 + g + 8, LDT);
#pragma unroll
        for (int dn = 0; dn < 8; ++dn) {
          const int n = c0 + dn * 8 + g;
          mma_bf16(dqa[dn], af, pair_in_col(ks, kk, n, LDS),
                   pair_in_col(ks, kk + 8, n, LDS));
        }
      }
#pragma unroll
      for (int dn = 0; dn < 8; ++dn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = q0 + qr0 + g + 8 * (e >> 1);
          const int col = c0 + dn * 8 + 2 * t + (e & 1);
          if (row < L)
            atomicAdd(a.dq_acc + (static_cast<long>(b) * L + row) * q_stride +
                          static_cast<long>(h) * HD + col,
                      dqa[dn][e] * a.scale);
        }
      }
    }
  }

  // write-out: dk * ln2 (undoes the log2 e folded into q), dv
#pragma unroll
  for (int dn = 0; dn < DTILES; ++dn) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = k0 + kr + g + 8 * half;
      if (key >= S) continue;
      const long off = (static_cast<long>(b) * S + key) * q_stride +
                       static_cast<long>(h) * HD + dn * 8 + 2 * t;
      *reinterpret_cast<float2*>(a.dk + off) =
          make_float2(dk_acc[dn][2 * half] * LN2, dk_acc[dn][2 * half + 1] * LN2);
      *reinterpret_cast<float2*>(a.dv + off) =
          make_float2(dv_acc[dn][2 * half], dv_acc[dn][2 * half + 1]);
    }
  }
}

// dq: one CTA per (64-row query tile, batch*head)
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(Args a) {
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;                 // [BQ_DQ][LDS], pre-scaled q
  uint16_t* dos = qs + BQ_DQ * LDS;    // [BQ_DQ][LDS]
  uint16_t* ks = dos + BQ_DQ * LDS;    // [BK][LDS]
  uint16_t* vs = ks + BK * LDS;        // [BK][LDS]
  int* ms = reinterpret_cast<int*>(vs + BK * LDS);

  const int H = a.H, L = a.L, S = a.S, q_offset = a.q_offset;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kh = h / (H / a.KH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ_DQ;
  const int rl = warp * 16;                      // the warp's first row
  const int r0 = q0 + rl + g, r1 = r0 + 8;      // this thread's two rows

  const long q_stride = static_cast<long>(H) * HD;
  const long kv_stride = static_cast<long>(a.KH) * HD;
  const uint16_t* qb = a.q + (static_cast<long>(b) * L * H + h) * HD;
  const uint16_t* dob = a.dout + (static_cast<long>(b) * L * H + h) * HD;
  const uint16_t* kb = a.k + (static_cast<long>(b) * S * a.KH + kh) * HD;
  const uint16_t* vb = a.v + (static_cast<long>(b) * S * a.KH + kh) * HD;

  load_rows<BQ_DQ>(qs, qb, q_stride, q0, L, a.qscale);
  load_rows<BQ_DQ>(dos, dob, q_stride, q0, L, 0.f);
  const float* lseb = a.lse + static_cast<long>(bh) * L;
  const float* deltab = a.delta + static_cast<long>(bh) * L;
  const float lr[2] = {r0 < L ? lseb[r0] * LOG2E : NEG_INF,
                       r1 < L ? lseb[r1] * LOG2E : NEG_INF};
  const float dl[2] = {r0 < L ? deltab[r0] : 0.f, r1 < L ? deltab[r1] : 0.f};

  float acc[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int n_tiles = (S + BK - 1) / BK;
  if (a.causal) {
    const int last_q = min(q0 + BQ_DQ - 1, L - 1) + q_offset;
    n_tiles = min(n_tiles, max(last_q, 0) / BK + 1);
  }
  constexpr int NT = BK / 8;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous key tile is consumed
    load_rows<BK>(ks, kb, kv_stride, k0, S, 0.f);
    load_rows<BK>(vs, vb, kv_stride, k0, S, 0.f);
    load_key_mask(ms, a.mask, b, k0, S);
    __syncthreads();

    // S = q K^T and dP = dO V^T for this warp's 16 rows
    float sc[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      uint32_t qf[4], df[4];
      a_frag(qf, qs, rl, s * 16, LDS);
      a_frag(df, dos, rl, s * 16, LDS);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = nt * 8 + g, c = s * 16 + 2 * t;
        mma_bf16(sc[nt], qf, pair_in_row(ks, r, c, LDS),
                 pair_in_row(ks, r, c + 8, LDS));
        mma_bf16(dp[nt], df, pair_in_row(vs, r, c, LDS),
                 pair_in_row(vs, r, c + 8, LDS));
      }
    }

    // P, then dS = P (dP - delta), fp32
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = nt * 8 + 2 * t + (e & 1);
        const int qpos = (e < 2 ? r0 : r1) + q_offset;
        const float l = lr[e >> 1];
        const bool ok = ms[kl] && l > NEG_INF * 0.5f &&
                        (!a.causal || qpos >= k0 + kl);
        const float p = ok ? exp2f(sc[nt][e] - l) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - dl[e >> 1]);
      }
    }

    // dq += dS K (dS rounded to bf16)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t da[4];
      acc_to_a(da, dp, j);
      const int kk = j * 16 + 2 * t;
#pragma unroll
      for (int dn = 0; dn < DTILES; ++dn) {
        const int n = dn * 8 + g;
        mma_bf16(acc[dn], da, pair_in_col(ks, kk, n, LDS),
                 pair_in_col(ks, kk + 8, n, LDS));
      }
    }
  }

  uint16_t* out = a.dq + (static_cast<long>(b) * L * H + h) * HD;
#pragma unroll
  for (int dn = 0; dn < DTILES; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(out + r0 * q_stride + c) =
          pack_bf16(acc[dn][0] * a.scale, acc[dn][1] * a.scale);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(out + r1 * q_stride + c) =
          pack_bf16(acc[dn][2] * a.scale, acc[dn][3] * a.scale);
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* mask,
               const void* dout, const void* lse, const void* delta, int H,
               int KH, int L, int S, int q_offset, int causal, float qscale,
               float scale) {
  Args a{};
  a.q = static_cast<const uint16_t*>(q);
  a.k = static_cast<const uint16_t*>(k);
  a.v = static_cast<const uint16_t*>(v);
  a.mask = static_cast<const int*>(mask);
  a.dout = static_cast<const uint16_t*>(dout);
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
  return a;
}

bool bad_dims(int B, int H, int KH, int L, int S, int hd) {
  return B <= 0 || L <= 0 || S <= 0 || KH <= 0 || H % KH != 0 || hd != HD;
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, void* stream, const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each entry point takes q, k, v, mask, dout, lse, delta, then its outputs,
// then (B, H, KH, L, S, hd, q_offset, causal, qscale, scale, stream); hd must
// be 128.  Returns cudaGetLastError() after the launch (or the error of the
// shared-memory attribute, or cudaErrorInvalidValue for bad dimensions).

// dq_acc: fp32 (B, L, H, hd), zeroed by the caller; dk/dv fp32 (B, S, H, hd)
extern "C" int moka_flash_bwd_fused(const void* q, const void* k,
                                    const void* v, const void* mask,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dq_acc, void* dk,
                                    void* dv, int B, int H, int KH, int L,
                                    int S, int hd, int q_offset, int causal,
                                    float qscale, float scale, void* stream) {
  if (bad_dims(B, H, KH, L, S, hd)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, mask, dout, lse, delta, H, KH, L, S, q_offset,
                     causal, qscale, scale);
  a.dq_acc = static_cast<float*>(dq_acc);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  return launch(flash_bwd_kv_kernel<true>, dim3((S + BK - 1) / BK, B * H),
                KV_SMEM, stream, a);
}

// dq: bf16 (B, L, H, hd)
extern "C" int moka_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* mask, const void* dout,
                                 const void* lse, const void* delta, void* dq,
                                 int B, int H, int KH, int L, int S, int hd,
                                 int q_offset, int causal, float qscale,
                                 float scale, void* stream) {
  if (bad_dims(B, H, KH, L, S, hd)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, mask, dout, lse, delta, H, KH, L, S, q_offset,
                     causal, qscale, scale);
  a.dq = static_cast<uint16_t*>(dq);
  return launch(flash_bwd_dq_kernel, dim3((L + BQ_DQ - 1) / BQ_DQ, B * H),
                DQ_SMEM, stream, a);
}

// dk/dv: fp32 (B, S, H, hd)
extern "C" int moka_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* mask, const void* dout,
                                  const void* lse, const void* delta, void* dk,
                                  void* dv, int B, int H, int KH, int L, int S,
                                  int hd, int q_offset, int causal,
                                  float qscale, float scale, void* stream) {
  if (bad_dims(B, H, KH, L, S, hd)) return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(q, k, v, mask, dout, lse, delta, H, KH, L, S, q_offset,
                     causal, qscale, scale);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  return launch(flash_bwd_kv_kernel<false>, dim3((S + BK - 1) / BK, B * H),
                KV_SMEM, stream, a);
}
