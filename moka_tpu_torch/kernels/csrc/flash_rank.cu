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
//     whose lse marks them fully masked (lse * log2 e <= -5e29); dq carries
//     1/sqrt(r), dk the ln 2 that undoes the log2 e folded into q.
// A row that sees no key gives the mean of V over all S keys and lse
// (-1e30 + log2 S) ln 2, as the plain version (flash_fwd_plain) and JAX's
// kernel, which visits every key block, give: every score is -1e30, so
// every key weighs 1.  MokA's rank-space use relies on it, since a sample
// with no question token has all-zero keys and must output zero.
//
// Bound: at r 4 there is nothing for tensor cores to do.  Per (query, key)
// pair the forward does 2 * 2 * r flops (q.k and p*v) and one exp2.  The
// softmax needs only the pairs of visible keys: at b 4 x L 1024 with MokA's
// 126 question keys a sample, 5.2e5 pairs, 0.12 us of exp2 at 4.18e12 a
// second, while the bytes (q, out, lse and the visible k, v: 0.1 MB) take
// 0.03 us.  Either is far below a launch (~2-4 us), so the forward is bound
// by latency: its design keeps the chain of dependent memory round trips
// short and the card full of warps.
//
// Forward design (flash_rank_fwd_kernel): fp32 SIMT, a CTA of 8 warps
// serves 8 query rows of one sample, a warp a row.
//   * The visible span.  The CTA reads its sample's (S,) int32 mask once
//     (coalesced, 4 KB at S 1024; each warp's q row is already on its way,
//     so the two trips overlap) and finds the first and last visible key
//     by warp reductions and one __syncthreads.  A row walks only the keys
//     from the first visible one to the last it may see (the last visible
//     key, or its causal limit): keys inside keep their mask test, so a
//     mask with holes stays exact, and a masked key outside adds exactly 0
//     to a row whose running max is finite (its weight exp2(-1e30 - m)).
//   * A row that sees no key (no visible key in the sample, or a causal
//     limit before the first one) takes the mean of V over all S keys;
//     the CTA sums V only when its first row is such a row.
//   * One pass a key: the 32 lanes of the row's warp take every 32nd key
//     of the span, each keeping an online (max, sum, accumulator) with one
//     exp2 a key (a second only when the max moves), loading the key's k
//     and v rows with 16-byte loads straight from global memory (L1 and L2
//     serve the 8 warps of the CTA and the CTAs of the sample; nothing is
//     staged in shared memory), 16 / r keys at a time; the 32 partial
//     triples meet by warp shuffles.
//   * Enough warps: at b 4 x L 1024 the grid is 128 x 4 CTAs of 8 warps,
//     4,096 warps, 31 for each of the 132 SMs, so the loads of the mask,
//     of q and of the span's keys overlap across warps.
//
// Backward design (dq, dk/dv, unchanged since their port): a CTA of 128
// threads serves 16 rows (queries in dq, keys in dk/dv), SPLIT = 8 threads
// a row, each taking every 8th key (or query) of a 256-entry tile staged in
// shared memory, so the 8 threads of a row read 8 neighbouring entries and
// the 4 rows of a warp read the same ones; the 8 partial gradients meet by
// warp shuffles.  Every tile is visited.  No atomics: the gradients are the
// same from run to run.  The backward is a dq kernel (a loop over keys) and
// a dk/dv kernel (a loop over queries) whatever L and S are: the fused
// kernel that the bf16 route takes at L, S <= 1024 computes the same
// function, and at r 4 the second pass over the (L, S) pairs costs as
// little as the first.

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

constexpr int FWD_WARPS = 8;  // forward: a CTA of 8 warps, a warp a row
constexpr int FWD_NT = 32 * FWD_WARPS;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// a row of HD floats (16-byte aligned) by 16-byte loads
template <int HD>
__device__ __forceinline__ void load_row(const float* p, float (&r)[HD]) {
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + d));
    r[d] = a.x;
    r[d + 1] = a.y;
    r[d + 2] = a.z;
    r[d + 3] = a.w;
  }
}

template <int HD>
__global__ void __launch_bounds__(FWD_NT)
    flash_rank_fwd_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ mask, float* __restrict__ out,
                          float* __restrict__ lse, int L, int S, int q_offset,
                          int causal, float qscale) {
  constexpr int U = 16 / HD;  // keys a lane loads before it computes
  __shared__ int span_lo[FWD_WARPS], span_hi[FWD_WARPS];
  __shared__ float vsum_part[FWD_WARPS][HD];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = blockIdx.x * FWD_WARPS;
  const int* mrow = mask + static_cast<long>(b) * S;
  const int row = row0 + warp;
  const long r = static_cast<long>(b) * L + row;
  // the row's q, loaded before the mask scan so that the two trips to
  // memory overlap
  float qs[HD];
  if (row < L) {
    load_row<HD>(q + r * HD, qs);
  } else {
#pragma unroll
    for (int d = 0; d < HD; ++d) qs[d] = 0.f;
  }

  // the sample's visible span [lo, hi]: first and last key with mask > 0
  int lo = S, hi = -1;
#pragma unroll 4
  for (int j = threadIdx.x; j < S; j += FWD_NT) {
    if (__ldg(mrow + j) > 0) {
      lo = min(lo, j);
      hi = j;
    }
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if (lane == 0) {
    span_lo[warp] = lo;
    span_hi[warp] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < FWD_WARPS; ++w) {
    lo = min(lo, span_lo[w]);
    hi = max(hi, span_hi[w]);
  }

  // the sum of V over all S keys, for the rows that see no key; the CTA's
  // first row has the earliest causal limit, so it is such a row if any is
  float vsum[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) vsum[d] = 0.f;
  if (hi < 0 || (causal && row0 + q_offset < lo)) {
    for (int j = threadIdx.x; j < S; j += FWD_NT) {
      float vr[HD];
      load_row<HD>(v + (static_cast<long>(b) * S + j) * HD, vr);
#pragma unroll
      for (int d = 0; d < HD; ++d) vsum[d] += vr[d];
    }
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      vsum[d] = warp_sum(vsum[d]);
      if (lane == 0) vsum_part[warp][d] = vsum[d];
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < HD; ++d) {
      vsum[d] = 0.f;
#pragma unroll
      for (int w = 0; w < FWD_WARPS; ++w) vsum[d] += vsum_part[w][d];
    }
  }

  if (row >= L) return;
  float* o = out + r * HD;
  const int end = causal ? min(hi, row + q_offset) : hi;  // last key it may see
  if (end < lo) {  // the row sees no key: every score is -1e30
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < HD; ++d) o[d] = vsum[d] / static_cast<float>(S);
      lse[r] = (NEG_INF + log2f(static_cast<float>(S))) * LN2;
    }
    return;
  }
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) {
    qs[d] *= qscale;
    acc[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  for (int j0 = lo + lane; j0 <= end; j0 += 32 * U) {
    float kr[U][HD], vr[U][HD];
    int mk[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + 32 * u;
      mk[u] = 0;
      if (j <= end) {
        const long kk = static_cast<long>(b) * S + j;
        load_row<HD>(k + kk * HD, kr[u]);
        load_row<HD>(v + kk * HD, vr[u]);
        mk[u] = __ldg(mrow + j) > 0 ? 1 : -1;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (mk[u] == 0) continue;  // past the end of the span
      const float s = mk[u] > 0 ? dot<HD>(qs, kr[u]) : NEG_INF;
      if (s > m) {  // the running max moves: rescale what was summed
        const float alpha = exp2f(m - s);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc[d] *= alpha;
        m = s;
      }
      const float p = exp2f(s - m);
      l += p;
#pragma unroll
      for (int d = 0; d < HD; ++d) acc[d] = fmaf(p, vr[u][d], acc[d]);
    }
  }
  // merge the 32 lanes' partial softmaxes; lane 0 took the first visible
  // key, so the row's max is finite and a lane that saw only masked keys
  // weighs exp2(-1e30 - mm) = 0
  const float mm = warp_max(m);
  const float sc = exp2f(m - mm);
  l = warp_sum(l * sc);
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = warp_sum(acc[d] * sc);
  if (lane == 0) {
    const float safe = l == 0.f ? 1.f : l;
#pragma unroll
    for (int d = 0; d < HD; d += 4)
      *reinterpret_cast<float4*>(o + d) =
          make_float4(acc[d] / safe, acc[d + 1] / safe, acc[d + 2] / safe,
                      acc[d + 3] / safe);
    lse[r] = (mm + log2f(safe)) * LN2;
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
  flash_rank_fwd_kernel<HD><<<grid, FWD_NT, 0, st>>>(
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
// int32, lse (B, 1, L) fp32; all contiguous, q, k, v and out 16-byte
// aligned.  Returns cudaGetLastError().
extern "C" int moka_flash_rank_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* lse,
                                   int B, int L, int S, int hd, int q_offset,
                                   int causal, float qscale, void* stream) {
  if (bad_dims(B, L, S, hd)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((L + FWD_WARPS - 1) / FWD_WARPS, B);
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
