// Flash attention at MokA's rank-space shape for Hopper (sm_90a): one head,
// head_dim r (4, 8 or 16), fp32 throughout.  Forward, dq and dk/dv.
//
// Replaces the TPU kernels moka_tpu/ops/flash_attention.py::_fwd_kernel,
// _bwd_fused_kernel, _bwd_dq_kernel and _bwd_dkv_kernel where
// moka_tpu/ops/moka.py::flash_rank_space_cross_attention runs them: q, k, v
// (B, L or S, 1, r) fp32, non-causal, the question mask as the key mask.
// The contract is that of the bf16 kernels (flash_fwd.cu, flash_bwd.cu):
//   * q is pre-scaled by qscale = log2(e)/sqrt(r) in fp32, so scores are in
//     base-2 units and the softmax uses exp2f;
//   * key k is visible to query i when mask[b, k] > 0 and, when causal,
//     q_offset + i >= k; masked scores take the finite -1e30;
//   * lse is (B, 1, L) fp32 in natural-log units; the backward reads it and
//     delta = rowsum(dO * O), and p = exp2(s - lse * log2 e), zero on rows
//     whose lse marks them fully masked; dq carries 1/sqrt(r), dk the ln 2
//     that undoes the log2 e folded into q.
// Every key is visited for every query (no tile is skipped), so a fully
// masked row's output is the mean of V over all S keys, exactly as the plain
// version's (flash_fwd_plain): the rank-space use relies on it, since a
// sample with no question token has all-zero keys and must output zero.
//
// Bound: at r 4 there is nothing for tensor cores to do.  Per (query, key)
// pair the forward does 2 * 2 * r flops (q.k and p*v) and one exp2; at
// b 4 x L 1024 all 4.2e6 pairs are 67 MFLOP (1.0 us at 67 TFLOP/s fp32) and
// 4.2e6 exp2 (1.0 us at 16 a clock on each of 132 SMs), while the bytes
// (q, k, v, out, lse: 0.3 MB) take 0.1 us.  The softmax needs only the
// pairs of visible keys (MokA's 126 question keys a sample: 0.12 us), so
// the bound is far below a launch (~3-5 us); this kernel computes every
// pair, masked ones included.
//
// Design: fp32 SIMT.  A CTA of 128 threads serves 16 rows (queries in the
// forward and dq, keys in dk/dv), SPLIT = 8 threads a row, each taking every
// 8th key (or query) of a 256-entry tile staged in shared memory, so the 8
// threads of a row read 8 neighbouring entries and the 4 rows of a warp read
// the same ones.  Within a tile a thread takes the max of its scores first
// and then accumulates exp2 (one exp2 per pair, one rescale per tile); the 8
// partial (max, sum, accumulator) triples, or the 8 partial gradients, meet
// by warp shuffles.  No atomics: the gradients are the same from run to run.
// The backward is a dq kernel (a loop over keys) and a dk/dv kernel (a loop
// over queries) whatever L and S are: the fused kernel that the bf16 route
// takes at L, S <= 1024 computes the same function, and at r 4 the second
// pass over the (L, S) pairs costs as little as the first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NT = 128;
constexpr int SPLIT = 8;
constexpr int ROWS = NT / SPLIT;
constexpr int TILE = 256;

template <int HD>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = SPLIT / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = SPLIT / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// stage entries [e0, e0 + TILE) of a (B, n, 1, HD) tensor of batch b
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* src, int b,
                                      int n, int e0, float scale) {
  const float* p = src + (static_cast<long>(b) * n + e0) * HD;
  const int count = min(TILE, n - e0) * HD;
  for (int i = threadIdx.x; i < TILE * HD; i += NT)
    dst[i] = i < count ? p[i] * scale : 0.f;
}

template <int HD>
__global__ void __launch_bounds__(NT)
    flash_rank_fwd_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ mask, float* __restrict__ out,
                          float* __restrict__ lse, int L, int S, int q_offset,
                          int causal, float qscale) {
  __shared__ __align__(16) float ks[TILE * HD];
  __shared__ __align__(16) float vs[TILE * HD];
  __shared__ int ms[TILE];
  const int b = blockIdx.y;
  const int row = blockIdx.x * ROWS + threadIdx.x / SPLIT;
  const int part = threadIdx.x % SPLIT;
  const bool live = row < L;
  float qs[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qs[d] = live ? q[(static_cast<long>(b) * L + row) * HD + d] * qscale : 0.f;
    acc[d] = 0.f;
  }
  const int qpos = row + q_offset;
  float m = NEG_INF, l = 0.f;
  for (int k0 = 0; k0 < S; k0 += TILE) {
    __syncthreads();  // the previous tile is consumed
    stage<HD>(ks, k, b, S, k0, 1.f);
    stage<HD>(vs, v, b, S, k0, 1.f);
    for (int i = threadIdx.x; i < TILE; i += NT)
      ms[i] = k0 + i < S ? mask[static_cast<long>(b) * S + k0 + i] : 0;
    __syncthreads();
    const int n = min(TILE, S - k0);
    float mt = m;
    for (int j = part; j < n; j += SPLIT) {
      const bool ok = ms[j] > 0 && (!causal || qpos >= k0 + j);
      mt = fmaxf(mt, ok ? dot<HD>(qs, ks + j * HD) : NEG_INF);
    }
    const float alpha = exp2f(m - mt);
    m = mt;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < HD; ++d) acc[d] *= alpha;
    for (int j = part; j < n; j += SPLIT) {
      const bool ok = ms[j] > 0 && (!causal || qpos >= k0 + j);
      const float p = exp2f((ok ? dot<HD>(qs, ks + j * HD) : NEG_INF) - m);
      l += p;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vs[j * HD + d], acc[d]);
    }
  }
  // merge the SPLIT partial softmaxes of the row
  const float mm = group_max(m);
  const float sc = exp2f(m - mm);
  l = group_sum(l * sc);
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = group_sum(acc[d] * sc);
  if (live && part == 0) {
    const float safe = l == 0.f ? 1.f : l;
    float* o = out + (static_cast<long>(b) * L + row) * HD;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = acc[d] / safe;
    lse[static_cast<long>(b) * L + row] = (mm + log2f(safe)) * LN2;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
    flash_rank_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ mask,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dq,
                         int L, int S, int q_offset, int causal, float qscale,
                         float scale) {
  __shared__ __align__(16) float ks[TILE * HD];
  __shared__ __align__(16) float vs[TILE * HD];
  __shared__ int ms[TILE];
  const int b = blockIdx.y;
  const int row = blockIdx.x * ROWS + threadIdx.x / SPLIT;
  const int part = threadIdx.x % SPLIT;
  const bool live = row < L;
  const long r = static_cast<long>(b) * L + row;
  float qs[HD], dov[HD], acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qs[d] = live ? q[r * HD + d] * qscale : 0.f;
    dov[d] = live ? dout[r * HD + d] : 0.f;
    acc[d] = 0.f;
  }
  const float lse2 = live ? lse[r] * LOG2E : NEG_INF;
  const float dlt = live ? delta[r] : 0.f;
  const bool rows_live = lse2 > NEG_INF * 0.5f;  // not a fully masked row
  const int qpos = row + q_offset;
  for (int k0 = 0; k0 < S; k0 += TILE) {
    __syncthreads();
    stage<HD>(ks, k, b, S, k0, 1.f);
    stage<HD>(vs, v, b, S, k0, 1.f);
    for (int i = threadIdx.x; i < TILE; i += NT)
      ms[i] = k0 + i < S ? mask[static_cast<long>(b) * S + k0 + i] : 0;
    __syncthreads();
    if (!rows_live) continue;
    const int n = min(TILE, S - k0);
    for (int j = part; j < n; j += SPLIT) {
      const bool ok = ms[j] > 0 && (!causal || qpos >= k0 + j);
      const float s = ok ? dot<HD>(qs, ks + j * HD) : NEG_INF;
      const float p = exp2f(s - lse2);
      const float ds = p * (dot<HD>(dov, vs + j * HD) - dlt);
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(ds, ks[j * HD + d], acc[d]);
    }
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = group_sum(acc[d]);
  if (live && part == 0) {
#pragma unroll
    for (int d = 0; d < HD; ++d) dq[r * HD + d] = acc[d] * scale;
  }
}

template <int HD>
__global__ void __launch_bounds__(NT)
    flash_rank_dkv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ mask,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int L,
                          int S, int q_offset, int causal, float qscale) {
  __shared__ __align__(16) float qss[TILE * HD];
  __shared__ __align__(16) float dos[TILE * HD];
  __shared__ float lse2s[TILE];
  __shared__ float dls[TILE];
  const int b = blockIdx.y;
  const int key = blockIdx.x * ROWS + threadIdx.x / SPLIT;
  const int part = threadIdx.x % SPLIT;
  const bool live = key < S;
  const long r = static_cast<long>(b) * S + key;
  float kv[HD], vv[HD], dka[HD], dva[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    kv[d] = live ? k[r * HD + d] : 0.f;
    vv[d] = live ? v[r * HD + d] : 0.f;
    dka[d] = 0.f;
    dva[d] = 0.f;
  }
  const bool key_on = live && mask[live ? r : 0] > 0;
  for (int i0 = 0; i0 < L; i0 += TILE) {
    __syncthreads();
    stage<HD>(qss, q, b, L, i0, qscale);
    stage<HD>(dos, dout, b, L, i0, 1.f);
    for (int i = threadIdx.x; i < TILE; i += NT) {
      const bool in = i0 + i < L;
      const long qr = static_cast<long>(b) * L + i0 + i;
      lse2s[i] = in ? lse[qr] * LOG2E : NEG_INF;
      dls[i] = in ? delta[qr] : 0.f;
    }
    __syncthreads();
    const int n = min(TILE, L - i0);
    for (int i = part; i < n; i += SPLIT) {
      const float lse2 = lse2s[i];
      if (!(lse2 > NEG_INF * 0.5f)) continue;  // fully masked row: p = 0
      const bool ok = key_on && (!causal || i0 + i + q_offset >= key);
      const float s = ok ? dot<HD>(qss + i * HD, kv) : NEG_INF;
      const float p = exp2f(s - lse2);
      const float* dor = dos + i * HD;
      const float ds = p * (dot<HD>(dor, vv) - dls[i]);
#pragma unroll
      for (int d = 0; d < HD; ++d) {
        dva[d] = fmaf(p, dor[d], dva[d]);
        dka[d] = fmaf(ds, qss[i * HD + d], dka[d]);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    dka[d] = group_sum(dka[d]);
    dva[d] = group_sum(dva[d]);
  }
  if (live && part == 0) {
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      dk[r * HD + d] = dka[d] * LN2;
      dv[r * HD + d] = dva[d];
    }
  }
}

bool bad_dims(int B, int L, int S, int hd) {
  return B <= 0 || L <= 0 || S <= 0 || B > 65535 ||
         !(hd == 4 || hd == 8 || hd == 16);
}

template <int HD>
void fwd(dim3 grid, cudaStream_t st, const void* q, const void* k,
         const void* v, const void* mask, void* out, void* lse, int L, int S,
         int q_offset, int causal, float qscale) {
  flash_rank_fwd_kernel<HD><<<grid, NT, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(mask),
      static_cast<float*>(out), static_cast<float*>(lse), L, S, q_offset,
      causal, qscale);
}

template <int HD>
void dq(dim3 grid, cudaStream_t st, const void* q, const void* k,
        const void* v, const void* mask, const void* dout, const void* lse,
        const void* delta, void* dqp, int L, int S, int q_offset, int causal,
        float qscale, float scale) {
  flash_rank_dq_kernel<HD><<<grid, NT, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(mask),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dqp), L, S,
      q_offset, causal, qscale, scale);
}

template <int HD>
void dkv(dim3 grid, cudaStream_t st, const void* q, const void* k,
         const void* v, const void* mask, const void* dout, const void* lse,
         const void* delta, void* dkp, void* dvp, int L, int S, int q_offset,
         int causal, float qscale) {
  flash_rank_dkv_kernel<HD><<<grid, NT, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int*>(mask),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dkp),
      static_cast<float*>(dvp), L, S, q_offset, causal, qscale);
}

}  // namespace

// q/out (B, L, 1, hd), k/v (B, S, 1, hd) fp32 with hd 4, 8 or 16, mask (B, S)
// int32, lse (B, 1, L) fp32; all contiguous.  Returns cudaGetLastError().
extern "C" int moka_flash_rank_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* lse,
                                   int B, int L, int S, int hd, int q_offset,
                                   int causal, float qscale, void* stream) {
  if (bad_dims(B, L, S, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((L + ROWS - 1) / ROWS, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = hd == 4 ? fwd<4> : hd == 8 ? fwd<8> : fwd<16>;
  f(grid, st, q, k, v, mask, out, lse, L, S, q_offset, causal, qscale);
  return static_cast<int>(cudaGetLastError());
}

// dq (B, L, 1, hd) fp32 given the forward's lse and delta (B, 1, L).
extern "C" int moka_flash_rank_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dqp, int B,
                                      int L, int S, int hd, int q_offset,
                                      int causal, float qscale, float scale,
                                      void* stream) {
  if (bad_dims(B, L, S, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((L + ROWS - 1) / ROWS, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = hd == 4 ? dq<4> : hd == 8 ? dq<8> : dq<16>;
  f(grid, st, q, k, v, mask, dout, lse, delta, dqp, L, S, q_offset, causal,
    qscale, scale);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv (B, S, 1, hd) fp32 given the forward's lse and delta (B, 1, L).
extern "C" int moka_flash_rank_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* mask,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dkp, void* dvp,
                                       int B, int L, int S, int hd,
                                       int q_offset, int causal, float qscale,
                                       void* stream) {
  if (bad_dims(B, L, S, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + ROWS - 1) / ROWS, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = hd == 4 ? dkv<4> : hd == 8 ? dkv<8> : dkv<16>;
  f(grid, st, q, k, v, mask, dout, lse, delta, dkp, dvp, L, S, q_offset,
    causal, qscale);
  return static_cast<int>(cudaGetLastError());
}
