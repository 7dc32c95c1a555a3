// Fused lm_head + cross-entropy on an int8 head for Hopper (sm_90a): TPU
// kernels 8 and 9 of moka_tpu/ops/fused_ce.py (_fwd_kernel -> _call_fwd,
// _bwd_kernel -> _nll_rows_bwd).  The (N, V) logits never reach device
// memory: each CTA recomputes its logits tiles in registers.
//
// Contract (as the JAX kernels): logits = (x @ bf16(w_i8)) * scale[v] with
// bf16 x, exact bf16 products summed in fp32; phantom vocab columns (v >=
// V, the zero padding up to a multiple of 512) are -1e30.  Forward: per row
// lse = m + log(l) (natural log) and nll = lse - target logit, the target
// picked by comparison (an ignored target matches no column).  Backward:
// p = exp(logit - lse), minus 1 at the target, times the row cotangent g
// and the column scale, rounded to bf16; dx = p @ bf16(w)^T in fp32.
//
// Tiling: a CTA of 4 warps covers 64 rows x 512 vocab columns (4 tiles of
// 128); the grid is (row blocks, vocab chunks) with the row block fastest,
// so the CTAs running together share a vocab chunk and the int8 head is
// read from device memory about once while x (re-read per chunk) comes
// from L2.  Each warp owns 16 rows, so row reductions are quad shuffles.
// Per 128-column tile the logits come from mma.sync m16n8k16 over d in
// steps of 64: x and the head tile (int8 converted to bf16 exactly, stored
// transposed so fragments are single 32-bit loads) are staged in shared
// memory, the next step's global loads in flight during this step's
// products.
//
// Forward (kernel 8): per chunk an online (max, sum, target) partial per
// row; a second small launch merges the chunks.  Backward (kernel 9): the
// chunk's p tile (64 x 512) is formed in shared memory as bf16, then dx
// slices of 64 columns are formed with mma and added to an fp32 (N, d)
// workspace by float2 atomicAdd, so dx's summation order varies from run
// to run.  Atomics: N * d * ceil(V / 512) / 2 float2 adds (at N 4092, d
// 4096, V 32011: 5.28e8).  The wrapper zeroes the workspace and casts it
// to bf16.
//
// Bound on this card: operations, 2 N d V (forward) and 4 N d V (backward)
// at the bf16 tensor-core rate; this first version (mma.sync, no TMA or
// wgmma, a synchronous shared-memory ring of one stage) is not expected to
// reach it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace moka_flash;

constexpr int BR = 64;              // rows per CTA (4 warps x 16)
constexpr int BV = 128;             // vocab columns per tile
constexpr int SUB = 4;              // tiles per CTA: 512 vocab columns
constexpr int CHUNK = SUB * BV;     // the vocab padding unit
constexpr int BK = 64;              // contraction step
constexpr int LDK = BK + 8;         // staged row length (bf16): no conflicts
constexpr int LDP = CHUNK + 8;      // p tile row length (bf16)
constexpr int DC = 64;              // dx columns per backward slice
constexpr int LDW = BV + 8;         // backward head slice row length (bf16)
constexpr int THREADS = 128;

constexpr int STAGE_ELEMS = (BR + BV) * LDK;  // x tile + transposed head
constexpr int BWD_SMEM = (STAGE_ELEMS + BR * LDP) * 2;

static_assert(DC * LDW <= STAGE_ELEMS, "backward slice fits the staging");

struct Stage {  // one contraction step's global data, held in registers
  uint4 x[4];   // 64 rows x 64 bf16 of x: 512 16-byte pieces, 4 a thread
  uint4 w[4];   // 64 rows x 128 int8 of the head: 2 row pairs a thread
};

// Issue the global loads of step k0 (rows past n_rows read as zero).
__device__ __forceinline__ void load_stage(Stage& st, const uint16_t* x,
                                           const int8_t* w, int n_rows, int d,
                                           int ldw, int row0, int v0, int k0,
                                           int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int idx = tid + i * THREADS;
    int r = idx >> 3, c = (idx & 7) * 8;
    st.x[i] = row0 + r < n_rows
                  ? *reinterpret_cast<const uint4*>(
                        x + static_cast<size_t>(row0 + r) * d + k0 + c)
                  : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int task = tid + i * THREADS;
    int kp = task & 31, ng = task >> 5;  // row pair, group of 16 columns
    const int8_t* src =
        w + static_cast<size_t>(k0 + 2 * kp) * ldw + v0 + 16 * ng;
    st.w[2 * i] = *reinterpret_cast<const uint4*>(src);
    st.w[2 * i + 1] = *reinterpret_cast<const uint4*>(src + ldw);
  }
}

__device__ __forceinline__ float s8(uint32_t word, int byte) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * byte)) & 0xff));
}

// Store a stage: x row-major [r][k]; the head transposed [v][k] as bf16
// pairs along k (pack of rows 2kp and 2kp+1 of one column).
__device__ __forceinline__ void store_stage(const Stage& st, uint16_t* xs,
                                            uint16_t* wts, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int idx = tid + i * THREADS;
    int r = idx >> 3, c = (idx & 7) * 8;
    *reinterpret_cast<uint4*>(xs + r * LDK + c) = st.x[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int task = tid + i * THREADS;
    int kp = task & 31, ng = task >> 5;
    const uint32_t* a = reinterpret_cast<const uint32_t*>(&st.w[2 * i]);
    const uint32_t* b = reinterpret_cast<const uint32_t*>(&st.w[2 * i + 1]);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint32_t pair = pack_bf16(s8(a[j >> 2], j & 3), s8(b[j >> 2], j & 3));
      *reinterpret_cast<uint32_t*>(wts + (16 * ng + j) * LDK + 2 * kp) = pair;
    }
  }
}

// acc[j] = this warp's 16 rows x columns [v0 + 8j, v0 + 8j + 8) of x @ w
// (unscaled fp32 sums over all d).
__device__ __forceinline__ void tile_products(const uint16_t* x,
                                              const int8_t* w, int n_rows,
                                              int d, int ldw, int row0,
                                              int v0, uint16_t* xs,
                                              uint16_t* wts,
                                              float (&acc)[16][4]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  Stage st;
  load_stage(st, x, w, n_rows, d, ldw, row0, v0, 0, tid);
  for (int k0 = 0; k0 < d; k0 += BK) {
    __syncthreads();  // the previous step's fragments are read
    store_stage(st, xs, wts, tid);
    __syncthreads();
    if (k0 + BK < d) load_stage(st, x, w, n_rows, d, ldw, row0, v0, k0 + BK,
                                tid);
    const int r = warp * 16 + g;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4] = {pair_in_row(xs, r, kk + 2 * t, LDK),
                       pair_in_row(xs, r + 8, kk + 2 * t, LDK),
                       pair_in_row(xs, r, kk + 2 * t + 8, LDK),
                       pair_in_row(xs, r + 8, kk + 2 * t + 8, LDK)};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int n = j * 8 + g;
        mma_bf16(acc[j], a, pair_in_row(wts, n, kk + 2 * t, LDK),
                 pair_in_row(wts, n, kk + 2 * t + 8, LDK));
      }
    }
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

// Kernel 8, per (row block, vocab chunk): the chunk's online-softmax
// partial of each row: part[0] max, part[1] sum of exp(logit - max),
// part[2] the target logit (0 if the target is outside the chunk).
__global__ void __launch_bounds__(THREADS)
    fused_ce_fwd_kernel(const uint16_t* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ scale,
                        const int* __restrict__ targets, float* part,
                        int n_rows, int d, int ldw, int v_real) {
  __shared__ __align__(16) uint16_t xs[BR * LDK];
  __shared__ __align__(16) uint16_t wts[BV * LDK];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BR, chunk = blockIdx.y;
  const int rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  int tgt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) tgt[h] = rows[h] < n_rows ? targets[rows[h]] : -1;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, hit[2] = {0.f, 0.f};
  float acc[16][4];
  for (int s = 0; s < SUB; ++s) {
    const int v0 = chunk * CHUNK + s * BV;
    tile_products(x, w, n_rows, d, ldw, row0, v0, xs, wts, acc);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = v0 + j * 8 + 2 * t + (e & 1), h = e >> 1;
        const float z = c < v_real ? acc[j][e] * scale[c] : NEG_INF;
        acc[j][e] = z;
        mx[h] = fmaxf(mx[h], z);
        if (c == tgt[h]) hit[h] += z;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m[h], quad_max(mx[h]));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        sum += expf(acc[j][2 * h] - m_new) + expf(acc[j][2 * h + 1] - m_new);
      l[h] = l[h] * expf(m[h] - m_new) + quad_sum(sum);
      m[h] = m_new;
    }
  }
  const int n_chunks = gridDim.y;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float tg = quad_sum(hit[h]);
    if (t == 0 && rows[h] < n_rows) {
      const size_t at = static_cast<size_t>(chunk) * n_rows + rows[h];
      part[at] = m[h];
      part[static_cast<size_t>(n_chunks) * n_rows + at] = l[h];
      part[2 * static_cast<size_t>(n_chunks) * n_rows + at] = tg;
    }
  }
}

// Kernel 8's second launch: merge the chunks' partials of each row.
__global__ void fused_ce_merge_kernel(const float* __restrict__ part,
                                      float* nll, float* lse, int n_rows,
                                      int n_chunks) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rows) return;
  const size_t plane = static_cast<size_t>(n_chunks) * n_rows;
  float m = NEG_INF;
  for (int c = 0; c < n_chunks; ++c)
    m = fmaxf(m, part[static_cast<size_t>(c) * n_rows + r]);
  float l = 0.f, tg = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const size_t at = static_cast<size_t>(c) * n_rows + r;
    l += part[plane + at] * expf(part[at] - m);
    tg += part[2 * plane + at];
  }
  const float out = m + logf(l);
  lse[r] = out;
  nll[r] = out - tg;
}

// Kernel 9, per (row block, vocab chunk): the chunk's p tile in shared
// memory, then its dx contribution added to the fp32 workspace.
__global__ void __launch_bounds__(THREADS)
    fused_ce_bwd_kernel(const uint16_t* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ scale,
                        const int* __restrict__ targets,
                        const float* __restrict__ lse_in,
                        const float* __restrict__ g_in, float* work,
                        int n_rows, int d, int ldw, int v_real) {
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* xs = smem;
  uint16_t* wts = smem + BR * LDK;
  uint16_t* ps = smem + STAGE_ELEMS;  // [64][LDP] bf16 p of the chunk
  uint16_t* wb = smem;                // [DC][LDW] head slice, [d][v]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BR, chunk = blockIdx.y;
  const int lr[2] = {warp * 16 + g, warp * 16 + g + 8};  // rows in the CTA
  int tgt[2];
  float lse[2], gr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + lr[h];
    const bool in = r < n_rows;
    tgt[h] = in ? targets[r] : -1;
    lse[h] = in ? lse_in[r] : 0.f;
    gr[h] = in ? g_in[r] : 0.f;  // rows past N: p * 0
  }
  float acc[16][4];
  for (int s = 0; s < SUB; ++s) {
    const int v0 = chunk * CHUNK + s * BV;
    tile_products(x, w, n_rows, d, ldw, row0, v0, xs, wts, acc);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c0 = v0 + j * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float pv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + e;
          float p = 0.f;
          if (c < v_real) {
            p = expf(acc[j][2 * h + e] * scale[c] - lse[h]);
            if (c == tgt[h]) p -= 1.f;
            p = p * gr[h] * scale[c];
          }
          pv[e] = p;
        }
        *reinterpret_cast<uint32_t*>(ps + lr[h] * LDP + s * BV + j * 8 +
                                     2 * t) = pack_bf16(pv[0], pv[1]);
      }
    }
  }
  // dx[rows, dc:dc+64] += p (64 x 512) @ w[dc:dc+64, chunk]^T
  const int vbase = chunk * CHUNK;
  for (int dc = 0; dc < d; dc += DC) {
    float dacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dacc[j][0] = dacc[j][1] = dacc[j][2] = dacc[j][3] = 0.f;
    for (int vs = 0; vs < CHUNK; vs += BV) {
      __syncthreads();  // staging / the previous slice's readers are done
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // 64 x 128 int8: 512 pieces of 16
        const int idx = tid + i * THREADS;
        const int n = idx >> 3, c = (idx & 7) * 16;
        const uint4 raw = *reinterpret_cast<const uint4*>(
            w + static_cast<size_t>(dc + n) * ldw + vbase + vs + c);
        const uint32_t* b = reinterpret_cast<const uint32_t*>(&raw);
        uint32_t out[8];
#pragma unroll
        for (int q = 0; q < 8; ++q)
          out[q] = pack_bf16(s8(b[q >> 1], 2 * (q & 1)),
                             s8(b[q >> 1], 2 * (q & 1) + 1));
        uint4* dst = reinterpret_cast<uint4*>(wb + n * LDW + c);
        dst[0] = make_uint4(out[0], out[1], out[2], out[3]);
        dst[1] = make_uint4(out[4], out[5], out[6], out[7]);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BV; kk += 16) {
        const int pc = vs + kk + 2 * t;
        uint32_t a[4] = {pair_in_row(ps, lr[0], pc, LDP),
                         pair_in_row(ps, lr[1], pc, LDP),
                         pair_in_row(ps, lr[0], pc + 8, LDP),
                         pair_in_row(ps, lr[1], pc + 8, LDP)};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = j * 8 + g;
          mma_bf16(dacc[j], a, pair_in_row(wb, n, kk + 2 * t, LDW),
                   pair_in_row(wb, n, kk + 2 * t + 8, LDW));
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + lr[h];
      if (r >= n_rows) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float2* dst = reinterpret_cast<float2*>(
            work + static_cast<size_t>(r) * d + dc + j * 8 + 2 * t);
        atomicAdd(dst, make_float2(dacc[j][2 * h], dacc[j][2 * h + 1]));
      }
    }
  }
}

}  // namespace

extern "C" {

// x (n_rows, d) bf16; w (d, ldw) int8 with ldw % 512 == 0 and columns past
// v_real zero; scale (ldw,) fp32; targets (n_rows,) int32; part (3,
// ldw/512, n_rows) fp32 scratch; nll, lse (n_rows,) fp32.  d % 64 == 0.
int moka_fused_ce_fwd(const void* x, const void* w, const void* scale,
                      const void* targets, void* part, void* nll, void* lse,
                      int n_rows, int d, int ldw, int v_real, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_rows + BR - 1) / BR, ldw / CHUNK);
  fused_ce_fwd_kernel<<<grid, THREADS, 0, s>>>(
      static_cast<const uint16_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const int*>(targets),
      static_cast<float*>(part), n_rows, d, ldw, v_real);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_ce_merge_kernel<<<(n_rows + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(nll),
      static_cast<float*>(lse), n_rows, ldw / CHUNK);
  return static_cast<int>(cudaGetLastError());
}

// As the forward, plus lse and g (n_rows,) fp32; work (n_rows, d) fp32,
// zeroed by the caller, receives dx.
int moka_fused_ce_bwd(const void* x, const void* w, const void* scale,
                      const void* targets, const void* lse, const void* g,
                      void* work, int n_rows, int d, int ldw, int v_real,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      fused_ce_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BWD_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_rows + BR - 1) / BR, ldw / CHUNK);
  fused_ce_bwd_kernel<<<grid, THREADS, BWD_SMEM, s>>>(
      static_cast<const uint16_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const int*>(targets),
      static_cast<const float*>(lse), static_cast<const float*>(g),
      static_cast<float*>(work), n_rows, d, ldw, v_real);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
