// Flash attention backward for Hopper (sm_90a): the dq kernel, with the
// contract of the TPU kernel in moka_tpu/ops/flash_attention.py:
//
//   dq     replaces _bwd_dq_kernel (_flash_bwd_dq): dq alone, given the
//          global-row lse and delta (ring attention calls it per key shard).
//
// The key-major kernels (fused dq/dk/dv and dk/dv alone) are in
// flash_bwd_kv.cu.
//
// Numerics, as the TPU kernel:
//   * q is pre-scaled by qscale = scale*log2(e) (the scalar and the product
//     rounded to bf16, as flash_fwd.cu does), so scores are base 2; the row's
//     natural-log lse from the forward enters as lse*log2(e);
//   * p = exp2(s - lse_row), and p = 0 where the key is masked or where
//     lse_row <= NEG_INF/2 (a query row whose keys are all masked gets zero
//     gradients);
//   * delta = rowsum(dO * O) in fp32 comes from the wrapper;
//     ds = p * (dp - delta) with p and dp in fp32;
//   * ds is rounded to bf16 before dS K; dq carries the softmax scale;
//   * causal, padding and q_offset masks are computed inline; tiles wholly
//     above the diagonal are skipped; ragged L and S are masked here, the
//     wrapper does not pad.
//
// Layouts: q/dout (B, L, H, hd) bf16, k/v (B, S, KH, hd) bf16, mask (B, S)
// int32, lse/delta (B, H, L) fp32, all contiguous.  Output: dq (B, L, H, hd)
// bf16.
//
// Design.  The TPU kernel holds a whole 1024 x 1024 score block in VMEM; an
// SM's 227 KB of shared memory cannot, so the work is cut in tiles: one CTA
// of 4 warps per (64-row query tile, batch*head), looping over 64-key tiles
// up to the diagonal; each warp owns 16 query rows and accumulates dq in
// registers.  No atomics.  All products run on mma.sync m16n8k16 (bf16 in,
// fp32 accumulate).  The tiles need more than the 48 KB of static shared
// memory ptxas accepts, so they are dynamic shared memory (68 KB), raised
// with cudaFuncSetAttribute.  No TMA, wgmma or double buffering in this
// first cut.
//
// Bound, from the data sheet (989 TFLOP/s bf16, 3.35 TB/s), not measured:
// at b 1, H 32, L = S = 4096: 268 M pairs x 3 products, 206 GFLOP, 0.21 ms:
// bound by flops.  Measured times are in PERF.md.

#include "flash_common.cuh"

namespace {

using namespace moka_flash;

constexpr int HD = 128;         // head dim (LLaMA-2); others are refused
constexpr int LDS = HD + 8;     // padded shared-memory row, in elements
constexpr int NTHREADS = 128;   // 4 warps
constexpr int BK = 64;          // keys per tile
constexpr int BQ_DQ = 64;       // query rows a CTA of the dq kernel
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
  uint16_t* dq;   // bf16 (B, L, H, hd)
  int H, KH, L, S, q_offset, causal;
  float qscale, scale;
};

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

// The entry point takes q, k, v, mask, dout, lse, delta, then its output,
// then (B, H, KH, L, S, hd, q_offset, causal, qscale, scale, stream); hd must
// be 128.  Returns cudaGetLastError() after the launch (or the error of the
// shared-memory attribute, or cudaErrorInvalidValue for bad dimensions).

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
