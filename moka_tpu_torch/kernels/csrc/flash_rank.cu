// Flash attention at MokA's rank-space shape for Hopper (sm_90a): one head,
// head_dim r, fp32 throughout.  Forward, dq and dk/dv, at any head dim.
// Built for head dims 4, 8, 16, 32 and 64; ops/flash_attention.py pads any
// other r <= 64 with zero columns up to the next of them, and any r past 64
// up to a multiple of 64 (exact: a zero column adds nothing to a score, its
// output and gradient columns are zero and dropped), and passes the scales
// of the true r.  At 4-16 a lane holds a whole row of q, k, v or dO; at 32
// and 64 two or four adjacent lanes share a row, 16 values each, their
// partial dot products summed by shuffles within the group (Split,
// group_sum), so a lane's registers are those of r 16.  Past 64 the
// forward (flash_rank_fwd_wide, R1 in kernel 5's wide path) computes each
// visible score once: a CTA of QT query rows stages q's rows and each
// 128-key tile of the visible span in shared memory 64 columns at a time
// (cp.async, two stages), sums register-tiled fp32 scores over the whole
// head dim, takes an online softmax in exp2 a tile, and accumulates p v
// in registers that do not grow with the head dim (QT shrinks as it
// grows).  dq and dk/dv past 64 (the *_wide backward kernels) take a grid
// axis over the 64-column chunks of their output: each chunk's CTA
// computes the dot products over the whole head dim again, four lanes a
// row as at 64, reading q, k, v and dO from L1 and L2 chunk by chunk, the
// same instructions on the same values, so each chunk sees the same p; no
// register or shared array grows with the head dim.
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
// Backward (dq: R2, dk/dv: R3).  They replace
// moka_tpu/ops/flash_attention.py::_bwd_dq_kernel (:136) and
// _bwd_dkv_kernel (:180), and at L, S <= 1024 also _bwd_fused_kernel
// (:230), which computes the same function: the rank route's backward is
// always this pair, and at r 4 a second pass over the visible pairs costs
// as little as the first.  Per visible (query, key) pair dq does 6 r flops
// and an exp2, dk/dv 8 r and an exp2: at the training shape above 5.2e5
// pairs, 0.12 us of exp2, and about 0.1 MB of bytes, so both are bound by
// latency, as the forward is, and the design keeps the work to the pairs
// the softmax needs (a masked key adds exactly 0: its weight is
// exp2(-1e30 - lse)) and the chain of memory round trips short.
//   * dq (flash_rank_dq_kernel) takes the forward's shape: a CTA of 8
//     warps serves 8 query rows of one sample, a warp a row.  The row's q,
//     dO, lse and delta are loaded before the CTA's one coalesced scan of
//     the mask for the sample's visible span (warp reductions, one
//     __syncthreads); the row walks the keys from the first visible one to
//     the last it may see, the 32 lanes taking every 32nd key with 16 / r
//     keys' k and v rows in flight by 16-byte loads from global memory
//     (L1 and L2 serve the CTA's warps; nothing is staged), keys inside
//     the span keeping their mask test.  The partial dq rows meet by warp
//     shuffles and lane 0 stores the row.  A row that sees no key (its lse
//     marks it fully masked, no visible key, or a causal limit before the
//     first one) stores dq = 0 at once, as JAX's kernel and the plain
//     version give.
//   * dk/dv (flash_rank_dkv_kernel): a visible key sums over all L
//     queries, so its parallelism comes from splitting the queries, and a
//     key no query sees must only store zeros.  A sample's CTAs are of two
//     kinds.  Zero CTAs, a thread a key, store dk = dv = 0 for every key
//     with mask 0 and do nothing else.  Work CTAs, S / 32 of them (enough
//     for a span of S / 8 keys, MokA's L / 8 question span, one block
//     each; a wider span loops), find the span as dq does and take its
//     blocks of 4 keys, every work-th block each; a visible key past the
//     causal reach of the last query stores zeros, and a work CTA with no
//     block returns.  A work CTA stages the sample's (q * qscale, dO,
//     lse * log2 e, delta), 40 bytes a query at r 4, into shared memory
//     once, in chunks of 4096 / r queries (41 KB; a fully masked row's lse
//     staged as +inf, so its p is 0).  Lane l of warp w takes key l % 4 of
//     the block and the queries congruent to 8 w + l / 4 modulo 64, 16 / r
//     queries in flight: one shared-memory load serves 4 lanes (8 distinct
//     queries a warp instruction, no bank conflict at r 4) and a lane
//     walks 16 queries at L 1024.  The 8 query phases of a key in a warp
//     meet by shuffles, then the 8 warps' partial sums are added in warp
//     order in shared memory.  The sample is the grid's fastest index, so
//     the work CTAs come first in dispatch order and spread over the SMs:
//     at the training shape 128 work CTAs (504 keys) and 16 zero CTAs.
//     Each work CTA reads all L queries, so more keys a block would cut the
//     bytes staged from L2 but halve the CTAs that work, and fewer would
//     double those bytes (profile_port.py rank_bwd_ablation times both).
// Neither kernel uses atomics or a workspace: the summation order is fixed
// by lane, warp and key or query index, so repeats are bit-identical.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < HD; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

constexpr int FWD_WARPS = 8;  // forward: a CTA of 8 warps, a warp a row
constexpr int FWD_NT = 32 * FWD_WARPS;
constexpr unsigned FULL = 0xffffffffu;

// A row of HD values split over G adjacent lanes of W each: at HD <= 16 a
// lane holds the whole row (G 1), at 32 and 64 two and four lanes share a
// key or a query, so a lane's registers hold 16 values of each row it
// touches whatever the head dim
template <int HD>
struct Split {
  static constexpr int W = HD < 16 ? HD : 16;  // values a lane
  static constexpr int G = HD / W;             // lanes a row
};

// the lanes of this lane's group of G (adjacent, aligned)
template <int G>
__device__ __forceinline__ unsigned group_mask(int lane) {
  return G == 1 ? 1u << lane : ((1u << G) - 1u) << (lane & ~(G - 1));
}

// the sum of x over the G lanes of a group, which all get it (a butterfly:
// each lane adds the same pairs in the same order); the group's lanes may
// run apart from the rest of the warp
template <int G>
__device__ __forceinline__ float group_sum(float x, unsigned gmask) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1) x += __shfl_xor_sync(gmask, x, off);
  return x;
}

// the sum of x over the lanes that hold the same slice (lane % G) of
// their rows: the whole warp at G 1
template <int G>
__device__ __forceinline__ float slice_sum(float x) {
#pragma unroll
  for (int off = 16; off >= G; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
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

// W floats of r to p (16-byte aligned), each times s
template <int W>
__device__ __forceinline__ void store_row(float* p, const float (&r)[W],
                                          float s) {
#pragma unroll
  for (int d = 0; d < W; d += 4)
    *reinterpret_cast<float4*>(p + d) =
        make_float4(r[d] * s, r[d + 1] * s, r[d + 2] * s, r[d + 3] * s);
}

// The backward's visible span of a sample: the first and last key whose
// (S,) mask entry is > 0 (S and -1 if none), by one coalesced scan of the
// mask by the CTA's NT threads, warp reductions and one __syncthreads.
template <int NT>
__device__ __forceinline__ int2 visible_span(const int* mrow_of, int S) {
  __shared__ int lo_of[NT / 32], hi_of[NT / 32];
  const int warp = threadIdx.x / 32;
  int lo = S, hi = -1;
#pragma unroll 4
  for (int j = threadIdx.x; j < S; j += NT) {
    if (__ldg(mrow_of + j) > 0) {
      lo = min(lo, j);
      hi = j;
    }
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if (threadIdx.x % 32 == 0) {
    lo_of[warp] = lo;
    hi_of[warp] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    lo = min(lo, lo_of[w]);
    hi = max(hi, hi_of[w]);
  }
  return make_int2(lo, hi);
}

template <int HD>
__global__ void __launch_bounds__(FWD_NT)
    flash_rank_fwd_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ mask, float* __restrict__ out,
                          float* __restrict__ lse, int L, int S, int q_offset,
                          int causal, float qscale) {
  constexpr int W = Split<HD>::W, G = Split<HD>::G;
  constexpr int U = 16 / W;       // keys a lane loads before it computes
  constexpr int SLOTS = 32 / G;   // keys a warp takes at once, each u
  __shared__ int span_lo[FWD_WARPS], span_hi[FWD_WARPS];
  __shared__ float vsum_part[FWD_WARPS][HD];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane % G, slot = lane / G;  // the row's slice, the key slot
  const unsigned gmask = group_mask<G>(lane);
  const int row0 = blockIdx.x * FWD_WARPS;
  const int* mrow = mask + static_cast<long>(b) * S;
  const int row = row0 + warp;
  const long r = static_cast<long>(b) * L + row;
  // the lane's slice of the row's q, loaded before the mask scan so that
  // the two trips to memory overlap
  float qs[W];
  if (row < L) {
    load_row<W>(q + r * HD + g * W, qs);
  } else {
#pragma unroll
    for (int d = 0; d < W; ++d) qs[d] = 0.f;
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
  float vsum[W];
#pragma unroll
  for (int d = 0; d < W; ++d) vsum[d] = 0.f;
  if (hi < 0 || (causal && row0 + q_offset < lo)) {
    for (int j = threadIdx.x / G; j < S; j += FWD_NT / G) {
      float vr[W];
      load_row<W>(v + (static_cast<long>(b) * S + j) * HD + g * W, vr);
#pragma unroll
      for (int d = 0; d < W; ++d) vsum[d] += vr[d];
    }
#pragma unroll
    for (int d = 0; d < W; ++d) {
      vsum[d] = slice_sum<G>(vsum[d]);
      if (lane < G) vsum_part[warp][g * W + d] = vsum[d];
    }
    __syncthreads();
#pragma unroll
    for (int d = 0; d < W; ++d) {
      vsum[d] = 0.f;
#pragma unroll
      for (int w = 0; w < FWD_WARPS; ++w) vsum[d] += vsum_part[w][g * W + d];
    }
  }

  if (row >= L) return;
  float* o = out + r * HD;
  const int end = causal ? min(hi, row + q_offset) : hi;  // last key it may see
  if (end < lo) {  // the row sees no key: every score is -1e30
    if (lane < G) {
#pragma unroll
      for (int d = 0; d < W; ++d)
        o[g * W + d] = vsum[d] / static_cast<float>(S);
    }
    if (lane == 0) lse[r] = (NEG_INF + log2f(static_cast<float>(S))) * LN2;
    return;
  }
  float acc[W];
#pragma unroll
  for (int d = 0; d < W; ++d) {
    qs[d] *= qscale;
    acc[d] = 0.f;
  }
  float m = NEG_INF, l = 0.f;
  for (int j0 = lo + slot; j0 <= end; j0 += SLOTS * U) {
    float kr[U][W], vr[U][W];
    int mk[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + SLOTS * u;
      mk[u] = 0;
      if (j <= end) {
        const long kk = static_cast<long>(b) * S + j;
        load_row<W>(k + kk * HD + g * W, kr[u]);
        load_row<W>(v + kk * HD + g * W, vr[u]);
        mk[u] = __ldg(mrow + j) > 0 ? 1 : -1;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (mk[u] == 0) continue;  // past the end of the span (a whole group)
      const float dqk = group_sum<G>(dot<W>(qs, kr[u]), gmask);
      const float s = mk[u] > 0 ? dqk : NEG_INF;
      if (s > m) {  // the running max moves: rescale what was summed
        const float alpha = exp2f(m - s);
        l *= alpha;
#pragma unroll
        for (int d = 0; d < W; ++d) acc[d] *= alpha;
        m = s;
      }
      const float p = exp2f(s - m);
      l += p;
#pragma unroll
      for (int d = 0; d < W; ++d) acc[d] = fmaf(p, vr[u][d], acc[d]);
    }
  }
  // merge the key slots' partial softmaxes (a group's lanes hold the same
  // m and l); lane 0 took the first visible key, so the row's max is
  // finite and a slot that saw only masked keys weighs exp2(-1e30 - mm) = 0
  const float mm = warp_max(m);
  const float sc = exp2f(m - mm);
  l = slice_sum<G>(l * sc);
#pragma unroll
  for (int d = 0; d < W; ++d) acc[d] = slice_sum<G>(acc[d] * sc);
  const float safe = l == 0.f ? 1.f : l;
  if (lane < G) {
    float res[W];
#pragma unroll
    for (int d = 0; d < W; ++d) res[d] = acc[d] / safe;
    store_row<W>(o + g * W, res, 1.f);
  }
  if (lane == 0) lse[r] = (mm + log2f(safe)) * LN2;
}

template <int HD>
__global__ void __launch_bounds__(FWD_NT)
    flash_rank_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const int* __restrict__ mask,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, float* __restrict__ dq,
                         int L, int S, int q_offset, int causal, float qscale,
                         float scale) {
  constexpr int W = Split<HD>::W, G = Split<HD>::G;
  constexpr int KIF = 16 / W;     // keys in flight a lane
  constexpr int SLOTS = 32 / G;   // keys a warp takes at once, each u
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane % G, slot = lane / G;
  const unsigned gmask = group_mask<G>(lane);
  const int row = blockIdx.x * FWD_WARPS + warp;
  const long qr = static_cast<long>(b) * L + row;
  const int* keys_on = mask + static_cast<long>(b) * S;
  // the lane's slices of the row's q and dO, its lse and delta, on their
  // way before the mask scan
  float qs[W], dov[W];
  float lse2 = NEG_INF, dlt = 0.f;
  if (row < L) {
    load_row<W>(q + qr * HD + g * W, qs);
    load_row<W>(dout + qr * HD + g * W, dov);
    lse2 = __ldg(lse + qr) * LOG2E;
    dlt = __ldg(delta + qr);
  }

  // the sample's visible span [first, last]
  const int2 span = visible_span<FWD_NT>(keys_on, S);
  const int first = span.x, last = span.y;

  if (row >= L) return;
  const int stop = causal ? min(last, row + q_offset) : last;
  float gq[W];
#pragma unroll
  for (int d = 0; d < W; ++d) gq[d] = 0.f;
  // a row that sees no key (fully masked lse, or stop < first) keeps dq = 0
  if (lse2 > NEG_INF * 0.5f && stop >= first) {
#pragma unroll
    for (int d = 0; d < W; ++d) qs[d] *= qscale;
    for (int j0 = first + slot; j0 <= stop; j0 += SLOTS * KIF) {
      float kr[KIF][W], vr[KIF][W];
      bool on[KIF];
#pragma unroll
      for (int u = 0; u < KIF; ++u) {
        const int j = j0 + SLOTS * u;
        on[u] = false;
        if (j <= stop) {
          const long kk = static_cast<long>(b) * S + j;
          load_row<W>(k + kk * HD + g * W, kr[u]);
          load_row<W>(v + kk * HD + g * W, vr[u]);
          on[u] = __ldg(keys_on + j) > 0;
        }
      }
#pragma unroll
      for (int u = 0; u < KIF; ++u) {
        if (!on[u]) continue;  // past the span's end, or masked inside it
        const float p =
            exp2f(group_sum<G>(dot<W>(qs, kr[u]), gmask) - lse2);
        const float ds =
            p * (group_sum<G>(dot<W>(dov, vr[u]), gmask) - dlt);
#pragma unroll
        for (int d = 0; d < W; ++d) gq[d] = fmaf(ds, kr[u][d], gq[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < W; ++d) gq[d] = slice_sum<G>(gq[d]);
  }
  if (lane < G) store_row<W>(dq + qr * HD + g * W, gq, scale);
}

constexpr int BWD_KEYS = 4;  // dk/dv: keys a work CTA takes at a time
constexpr int BWD_NT = 256;  // 8 warps
constexpr int SPAN_SHARE = 8;  // work CTAs for a span of S / 8 keys

template <int HD>
__global__ void __launch_bounds__(BWD_NT)
    flash_rank_dkv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const int* __restrict__ mask,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, int L,
                          int S, int q_offset, int causal, float qscale,
                          int work) {
  constexpr int W = Split<HD>::W, G = Split<HD>::G;
  constexpr int CHUNK = (HD >= 32 ? 2048 : 4096) / HD;  // queries staged
  constexpr int QIF = 16 / W;      // queries in flight a lane
  constexpr int WARPS = BWD_NT / 32;
  constexpr int PHASES = BWD_NT / (BWD_KEYS * G);  // query phases a key
  __shared__ __align__(16) float q_sm[CHUNK * HD];
  __shared__ __align__(16) float do_sm[CHUNK * HD];
  __shared__ float2 row_sm[CHUNK];  // (lse * log2 e, delta) a query
  __shared__ float part[WARPS][BWD_KEYS][2 * HD];
  const int b = blockIdx.x;
  const long k_base = static_cast<long>(b) * S;
  const int* m = mask + k_base;
  const int y = blockIdx.y;
  if (y >= work) {
    // a zero CTA, a thread a key: a key with mask 0 gets dk = dv = 0 and
    // nothing else (the keys with mask > 0 are the work CTAs')
    const int j = (y - work) * BWD_NT + threadIdx.x;
    if (j < S && __ldg(m + j) <= 0) {
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        *reinterpret_cast<float4*>(dk + (k_base + j) * HD + d) =
            make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dv + (k_base + j) * HD + d) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }

  // a work CTA: the sample's visible span [lo, hi]
  const int2 span = visible_span<BWD_NT>(m, S);
  const int lo = span.x, hi = span.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the last key some query may see
  const int reach = causal ? min(hi, L - 1 + q_offset) : hi;
  // lane: slice g of key t of the block, in query phase `phase`
  const int g = lane % G, t = lane / G % BWD_KEYS;
  const int phase = warp * (32 / (BWD_KEYS * G)) + lane / (BWD_KEYS * G);
  const unsigned gmask = group_mask<G>(lane);
  const long q_base = static_cast<long>(b) * L;
  int staged = -1;  // the first query of the chunk in shared memory
  // the span's blocks of BWD_KEYS keys, every work-th one from this CTA's
  for (int key0 = lo + y * BWD_KEYS; key0 <= hi;
       key0 += work * BWD_KEYS) {
    unsigned live = 0, unreached = 0;  // keys to walk; visible, past reach
#pragma unroll
    for (int u = 0; u < BWD_KEYS; ++u) {
      const int j = key0 + u;
      if (j <= hi && __ldg(m + j) > 0) {
        if (j <= reach)
          live |= 1u << u;
        else
          unreached |= 1u << u;
      }
    }
    // a visible key no query may reach (causal): exact zeros
    if (threadIdx.x < BWD_KEYS * HD / 4) {
      const int u = threadIdx.x / (HD / 4);
      if (unreached >> u & 1u) {
        const long o = (k_base + key0 + u) * HD + threadIdx.x % (HD / 4) * 4;
        *reinterpret_cast<float4*>(dk + o) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dv + o) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    if (live == 0u) continue;

    const int key = key0 + t;
    const bool mine = live >> t & 1u;
    float kr[W], vr[W], dka[W], dva[W];
    if (mine) {
      load_row<W>(k + (k_base + key) * HD + g * W, kr);
      load_row<W>(v + (k_base + key) * HD + g * W, vr);
    }
#pragma unroll
    for (int d = 0; d < W; ++d) dka[d] = dva[d] = 0.f;
    // causal: no query before the first live key's reach sees a key here
    const int q_from =
        causal ? max(0, key0 + __ffs(static_cast<int>(live)) - 1 - q_offset)
               : 0;
    for (int i0 = q_from / CHUNK * CHUNK; i0 < L; i0 += CHUNK) {
      const int n = min(CHUNK, L - i0);
      if (i0 != staged) {
        __syncthreads();  // the previous chunk's readers are done
        const float4* qsrc =
            reinterpret_cast<const float4*>(q + (q_base + i0) * HD);
        const float4* dsrc =
            reinterpret_cast<const float4*>(dout + (q_base + i0) * HD);
#pragma unroll 4
        for (int e = threadIdx.x; e < n * HD / 4; e += BWD_NT) {
          float4 a = __ldg(qsrc + e);
          a.x *= qscale;
          a.y *= qscale;
          a.z *= qscale;
          a.w *= qscale;
          reinterpret_cast<float4*>(q_sm)[e] = a;
          reinterpret_cast<float4*>(do_sm)[e] = __ldg(dsrc + e);
        }
#pragma unroll 4
        for (int e = threadIdx.x; e < n; e += BWD_NT) {
          const float l2 = __ldg(lse + q_base + i0 + e) * LOG2E;
          // a fully masked row: p = exp2(s - inf) = 0
          row_sm[e] = make_float2(l2 > NEG_INF * 0.5f ? l2 : INFINITY,
                                  __ldg(delta + q_base + i0 + e));
        }
        __syncthreads();
        staged = i0;
      }
      if (!mine) continue;
      // this lane's first query of the chunk that may see its key
      int c = phase;
      if (causal && key - q_offset - i0 > c)
        c += (key - q_offset - i0 - c + PHASES - 1) / PHASES * PHASES;
      for (; c < n; c += PHASES * QIF) {
        float qv[QIF][W], dov[QIF][W];
        float2 rw[QIF];
#pragma unroll
        for (int u = 0; u < QIF; ++u) {
          const int cc = min(c + PHASES * u, n - 1);
#pragma unroll
          for (int d = 0; d < W; d += 4) {
            const float4 a =
                *reinterpret_cast<const float4*>(q_sm + cc * HD + g * W + d);
            const float4 o =
                *reinterpret_cast<const float4*>(do_sm + cc * HD + g * W + d);
            qv[u][d] = a.x;
            qv[u][d + 1] = a.y;
            qv[u][d + 2] = a.z;
            qv[u][d + 3] = a.w;
            dov[u][d] = o.x;
            dov[u][d + 1] = o.y;
            dov[u][d + 2] = o.z;
            dov[u][d + 3] = o.w;
          }
          rw[u] = row_sm[cc];
        }
#pragma unroll
        for (int u = 0; u < QIF; ++u) {
          if (c + PHASES * u < n) {  // the same for a group's lanes
            const float p =
                exp2f(group_sum<G>(dot<W>(qv[u], kr), gmask) - rw[u].x);
            const float ds =
                p * (group_sum<G>(dot<W>(dov[u], vr), gmask) - rw[u].y);
#pragma unroll
            for (int d = 0; d < W; ++d) {
              dva[d] = fmaf(p, dov[u][d], dva[d]);
              dka[d] = fmaf(ds, qv[u][d], dka[d]);
            }
          }
        }
      }
    }
    // the query phases of a key meet: first within the warp (lanes with
    // the same slice of the same key), then the warps' sums in warp order
#pragma unroll
    for (int d = 0; d < W; ++d) {
#pragma unroll
      for (int off = BWD_KEYS * G; off < 32; off <<= 1) {
        dka[d] += __shfl_xor_sync(FULL, dka[d], off);
        dva[d] += __shfl_xor_sync(FULL, dva[d], off);
      }
    }
    if (lane < BWD_KEYS * G) {
#pragma unroll
      for (int d = 0; d < W; ++d) {
        part[warp][t][g * W + d] = dka[d];
        part[warp][t][HD + g * W + d] = dva[d];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BWD_KEYS * 2 * HD; i += BWD_NT) {
      const int kt = i / (2 * HD), e = i % (2 * HD);
      if (live >> kt & 1u) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) sum += part[w][kt][e];
        const long o = (k_base + key0 + kt) * HD;
        if (e < HD)
          dk[o + e] = sum * LN2;
        else
          dv[o + e - HD] = sum;
      }
    }
    __syncthreads();  // part is read before the next block writes it
  }
}

// ------------------------------------------------- head dims past 64

constexpr int WCH = 64;   // the output columns of a chunk (a grid axis)
constexpr int WW = 16;    // values of a row a lane holds: four lanes a row
constexpr int WG = WCH / WW;

// this lane's part of the dot product of two rows of ld floats (ld a
// multiple of 64): its 16-value slice of every 64-wide chunk, chunk by
// chunk, one FMA chain
__device__ __forceinline__ float wide_dot(const float* a, const float* b,
                                          int ld, float s) {
  for (int c = 0; c < ld; c += WCH) {
    float av[WW], bv[WW];
    load_row<WW>(a + c, av);
    load_row<WW>(b + c, bv);
#pragma unroll
    for (int d = 0; d < WW; ++d) s = fmaf(av[d], bv[d], s);
  }
  return s;
}

// The forward past head dim 64 (flash_rank_fwd_wide): a CTA of 256
// threads serves QT query rows of one sample and computes each visible
// (query, key) score once.  The CTA walks its sample's visible span in
// tiles of WKT keys; for a tile it
//   1. stages q's rows and the tile's keys 64 columns at a time (cp.async
//      into a ring of two stages, each row padded by 16 bytes so that the
//      rows of a warp's loads fall in distinct banks) and sums each
//      thread's TQ x 4 scores over the whole head dim, one FMA chain
//      each (register tiles: q rows qg + 8 i, keys kg + 32 j);
//   2. writes the masked scores to shared memory; WNT / QT threads a row
//      take its max, rescale its running sum and turn the scores into p
//      (online softmax in exp2, the row's max and sum kept in shared
//      memory);
//   3. stages the tile's values 64 columns at a time and adds p v into
//      the output, which stays in registers: a warp owns QT / 8 rows and
//      a lane two columns of every 64, so a thread holds WO = 64 outputs
//      whatever the head dim (QT x CW = WNT x WO).
// QT is 32 up to head dim 512, 16 up to 1024 and 8 past it; a pass
// covers CW = 16384 / QT output columns, so up to head dim 2048 one pass
// holds every column and no score is computed twice.  Past 2048 a grid
// axis takes the passes, each computing the scores again (a rank past
// half of LLaMA-2-7B's width).  q's rows are read from device memory once
// a CTA: a span of at most WKT keys (MokA's question spans) is one tile,
// and each further tile reads them again from L2.
// Bound: operations, 4 hd fp32 flops (q.k and p v) and an exp2 a visible
// pair; at kernel 5's serving prefill (hd 512, 128 question keys, b 8 x L
// 896) 1.9 GFLOP, 28 us at 67 TFLOP/s, against ~30 MB of q, out and the
// visible keys (9 us).  The score tiles take 8 shared-memory loads for 16
// TQ FMAs, the p v tiles 4 + TQ for 8 TQ; no atomics, a fixed order of
// every sum, so repeats are bit-identical.
constexpr int WKT = 128;            // keys a tile
constexpr int WPAD = WCH + 4;       // floats of a staged row
constexpr int WNT = 256;            // threads of a CTA
constexpr int WO = 64;              // output values a thread holds
constexpr int PSTR = WKT + 4;       // floats of a row of p

// 16 bytes from global to shared memory, asynchronously; zeros where `ok`
// is false (nothing is read then)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// at most N of this thread's cp.async groups still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the shared memory of flash_rank_fwd_wide<QT>: two stages of QT + WKT
// rows, p, the rows' running max, sum and rescale, V's column sums
template <int QT>
constexpr int fwd_wide_smem() {
  return 4 * (2 * (QT + WKT) * WPAD + QT * PSTR + 3 * QT + WO * WNT / QT);
}

template <int QT>
__global__ void __launch_bounds__(WNT, 1)
    flash_rank_fwd_wide(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ mask, float* __restrict__ out,
                        float* __restrict__ lse, int L, int S, int ld,
                        int q_offset, int causal, float qscale) {
  constexpr int TQ = QT / 8;             // query rows a thread
  constexpr int CW = WO * WNT / QT;      // output columns a pass
  constexpr int NCH = CW / WCH;          // 64-column chunks a pass
  constexpr int STAGE = (QT + WKT) * WPAD;
  constexpr int RT = WNT / QT;           // threads a row in the softmax
  extern __shared__ __align__(16) float wsm[];
  float* ps = wsm + 2 * STAGE;
  float* row_m = ps + QT * PSTR;  // running max (base 2), sum, rescale
  float* row_l = row_m + QT;
  float* row_a = row_l + QT;
  float* vsum = row_a + QT;       // [CW]
  const int b = blockIdx.y, row0 = blockIdx.x * QT, c0 = blockIdx.z * CW;
  const int nch = min(CW, ld - c0) / WCH;  // this pass's chunks
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // scores: keys kg + 32 j, rows qg + 8 i; p v: rows warp + 8 i
  const int kg = (warp & 3) * 8 + (lane & 7), qg = (warp >> 2) * 4 + (lane >> 3);
  const int* mrow = mask + b * static_cast<long>(S);
  const long qb = static_cast<long>(b) * L, kb = static_cast<long>(b) * S;
  const int2 span = visible_span<WNT>(mrow, S);
  const int lo = span.x;
  const int hi = span.y;
  // the last key a row of the CTA may see
  const int kend = causal ? min(hi, min(row0 + QT, L) - 1 + q_offset) : hi;
  const int tiles = kend < lo ? 0 : (kend - lo) / WKT + 1;
  const int nqk = ld / WCH;  // the scores' chunks: the whole head dim

  if (tid < QT) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
  }
  // the sum of V's columns over all S keys, for the rows that see no key;
  // the CTA's first row has the earliest causal limit, so it is such a
  // row if any is
  if (hi < 0 || (causal && row0 + q_offset < lo)) {
    for (int c = tid; c < nch * WCH; c += WNT) {
      float s = 0.f;
#pragma unroll 8
      for (int j = 0; j < S; ++j) s += __ldg(v + (kb + j) * ld + c0 + c);
      vsum[c] = s;
    }
  }

  // a stage: q's rows and the keys of the tile at k0, columns 64 c.. (the
  // scores), or the values of the tile, columns c0 + 64 c.. (p v)
  auto stage = [&](int n) { return wsm + (n & 1) * STAGE; };
  auto load_qk = [&](int n, int k0, int c) {
    float* dst = stage(n);
    for (int e = tid; e < (QT + WKT) * (WCH / 4); e += WNT) {
      const int r = e / (WCH / 4), f = (e % (WCH / 4)) * 4;
      const bool is_q = r < QT;
      const int idx = is_q ? row0 + r : k0 + r - QT;
      const bool ok = idx < (is_q ? L : S);
      const float* src = (is_q ? q + (qb + (ok ? idx : 0)) * ld
                               : k + (kb + (ok ? idx : 0)) * ld) + WCH * c + f;
      cp_async16(dst + r * WPAD + f, src, ok);
    }
    cp_async_commit();
  };
  auto load_v = [&](int n, int k0, int c) {
    float* dst = stage(n);
    for (int e = tid; e < WKT * (WCH / 4); e += WNT) {
      const int r = e / (WCH / 4), f = (e % (WCH / 4)) * 4;
      const bool ok = k0 + r < S;
      cp_async16(dst + r * WPAD + f,
                 v + (kb + (ok ? k0 + r : 0)) * ld + c0 + WCH * c + f, ok);
    }
    cp_async_commit();
  };

  float o[NCH][TQ][2];
#pragma unroll
  for (int cc = 0; cc < NCH; ++cc)
#pragma unroll
    for (int i = 0; i < TQ; ++i) o[cc][i][0] = o[cc][i][1] = 0.f;
  int n = 0;  // stages consumed
  if (tiles > 0) load_qk(0, lo, 0);
  for (int t = 0; t < tiles; ++t) {
    const int k0 = lo + t * WKT;
    // ---- 1. the scores over the whole head dim
    float s[TQ][4];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < nqk; ++c, ++n) {
      if (c + 1 < nqk)
        load_qk(n + 1, k0, c + 1);
      else
        load_v(n + 1, k0, 0);
      cp_async_wait<1>();
      __syncthreads();
      const float* qs = stage(n);
      const float* ks = qs + QT * WPAD;
#pragma unroll 2
      for (int d = 0; d < WCH; d += 4) {
        float4 qv[TQ], kv[4];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
          qv[i] = *reinterpret_cast<const float4*>(qs + (qg + 8 * i) * WPAD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(ks + (kg + 32 * j) * WPAD + d);
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
            s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
            s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
            s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
          }
      }
      __syncthreads();  // the stage is read before it is loaded again
    }
    // ---- 2. masked scores, then p and the rows' running max and sum
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + kg + 32 * j;
      const bool on = key <= kend && __ldg(mrow + key) > 0;
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int r = qg + 8 * i;
        const bool vis = on && (!causal || key <= row0 + r + q_offset);
        ps[r * PSTR + kg + 32 * j] = vis ? s[i][j] * qscale : NEG_INF;
      }
    }
    __syncthreads();
    {
      const int r = tid / RT, part = tid % RT;
      float* pr = ps + r * PSTR;
      const float m_old = row_m[r];
      float mx = NEG_INF;
      for (int kk = part; kk < WKT; kk += RT) mx = fmaxf(mx, pr[kk]);
#pragma unroll
      for (int off = 1; off < RT; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int kk = part; kk < WKT; kk += RT) {
        const float p = exp2f(pr[kk] - m_new);
        pr[kk] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < RT; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) {
        const float a = exp2f(m_old - m_new);
        row_a[r] = a;
        row_l[r] = row_l[r] * a + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();
    // ---- 3. out = out * rescale + p v, 64 columns at a time
    const int nkv = (min(WKT, kend - k0 + 1) + 3) & ~3;  // p is 0 past kend
    float alpha[TQ];
#pragma unroll
    for (int i = 0; i < TQ; ++i) alpha[i] = row_a[warp + 8 * i];
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) {
      if (cc < nch) {
        if (cc + 1 < nch)
          load_v(n + 1, k0, cc + 1);
        else if (t + 1 < tiles)
          load_qk(n + 1, k0 + WKT, 0);
        else
          cp_async_commit();  // an empty group keeps the count
        cp_async_wait<1>();
        __syncthreads();
        const float* vs = stage(n);
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
          o[cc][i][0] *= alpha[i];
          o[cc][i][1] *= alpha[i];
        }
        for (int kk = 0; kk < nkv; kk += 4) {
          float4 p[TQ];
          float2 vv[4];
#pragma unroll
          for (int i = 0; i < TQ; ++i)
            p[i] = *reinterpret_cast<const float4*>(ps + (warp + 8 * i) * PSTR + kk);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            vv[u] = *reinterpret_cast<const float2*>(vs + (kk + u) * WPAD + 2 * lane);
#pragma unroll
          for (int i = 0; i < TQ; ++i) {
            const float pw[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              o[cc][i][0] = fmaf(pw[u], vv[u].x, o[cc][i][0]);
              o[cc][i][1] = fmaf(pw[u], vv[u].y, o[cc][i][1]);
            }
          }
        }
        __syncthreads();  // the stage is read before it is loaded again
        ++n;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // vsum and the rows' sums are written

  // a row that sees no key (every score -1e30) takes the mean of V
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int r = warp + 8 * i, row = row0 + r;
    if (row >= L) continue;
    const bool dead = (causal ? min(hi, row + q_offset) : hi) < lo;
    const float l = row_l[r];
    const float inv = dead ? 1.f / static_cast<float>(S) : 1.f / (l == 0.f ? 1.f : l);
    float* orow = out + (qb + row) * ld + c0 + 2 * lane;
#pragma unroll
    for (int cc = 0; cc < NCH; ++cc) {
      if (cc < nch) {
        const float2 val =
            dead ? make_float2(vsum[WCH * cc + 2 * lane] * inv,
                               vsum[WCH * cc + 2 * lane + 1] * inv)
                 : make_float2(o[cc][i][0] * inv, o[cc][i][1] * inv);
        *reinterpret_cast<float2*>(orow + WCH * cc) = val;
      }
    }
  }
  if (blockIdx.z == 0 && tid < QT && row0 + tid < L) {
    const int row = row0 + tid;
    const bool dead = (causal ? min(hi, row + q_offset) : hi) < lo;
    lse[qb + row] = dead ? (NEG_INF + log2f(static_cast<float>(S))) * LN2
                         : (row_m[tid] + log2f(row_l[tid])) * LN2;
  }
}

// R1 past head dim 64: flash_rank_fwd_wide at the rows a CTA of its head
// dim takes (QT), a grid axis over its passes
template <int QT>
int launch_fwd_wide(const float* q, const float* k, const float* v,
                    const int* mask, float* out, float* lse, int B, int L,
                    int S, int hd, int q_offset, int causal, float qscale,
                    cudaStream_t st) {
  constexpr int smem = fwd_wide_smem<QT>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_rank_fwd_wide<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  constexpr int CW = WO * WNT / QT;
  const dim3 grid((L + QT - 1) / QT, B, (hd + CW - 1) / CW);
  flash_rank_fwd_wide<QT><<<grid, WNT, smem, st>>>(q, k, v, mask, out, lse,
                                                   L, S, hd, q_offset, causal,
                                                   qscale);
  return static_cast<int>(cudaGetLastError());
}

// dq past head dim 64: flash_rank_dq_kernel<64>'s shape with the output
// chunk as blockIdx.z; p and dp over the whole head dim, dq's chunk from
// the keys' chunk.
__global__ void __launch_bounds__(FWD_NT)
    flash_rank_dq_wide(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ mask,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dq,
                       int L, int S, int ld, int q_offset, int causal,
                       float qscale, float scale) {
  constexpr int SLOTS = 32 / WG;
  const int b = blockIdx.y, oc = blockIdx.z * WCH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane % WG, slot = lane / WG;
  const unsigned gmask = group_mask<WG>(lane);
  const int row = blockIdx.x * FWD_WARPS + warp;
  const long qr = static_cast<long>(b) * L + row;
  const int* keys_on = mask + b * static_cast<long>(S);
  float lse2 = NEG_INF, dlt = 0.f;
  if (row < L) {
    lse2 = __ldg(lse + qr) * LOG2E;
    dlt = __ldg(delta + qr);
  }
  const int2 span = visible_span<FWD_NT>(keys_on, S);
  const int first = span.x;
  const int last = span.y;
  if (row >= L) return;
  const int stop = causal ? min(row + q_offset, last) : last;
  float gq[WW];
#pragma unroll
  for (int d = 0; d < WW; ++d) gq[d] = 0.f;
  // a row that sees no key (fully masked lse, or stop < first) keeps dq = 0
  if (lse2 > NEG_INF * 0.5f && stop >= first) {
    const float* qrow = q + qr * ld + g * WW;
    const float* drow = dout + qr * ld + g * WW;
    for (int j = first + slot; j <= stop; j += SLOTS) {
      if (__ldg(keys_on + j) <= 0) continue;  // masked inside the span
      const long kk = static_cast<long>(b) * S + j;
      const float sqk =
          group_sum<WG>(wide_dot(qrow, k + kk * ld + g * WW, ld, 0.f), gmask);
      const float sdv =
          group_sum<WG>(wide_dot(drow, v + kk * ld + g * WW, ld, 0.f), gmask);
      const float p = exp2f(sqk * qscale - lse2);
      const float ds = p * (sdv - dlt);
      float kr[WW];
      load_row<WW>(k + kk * ld + oc + g * WW, kr);
#pragma unroll
      for (int d = 0; d < WW; ++d) gq[d] = fmaf(ds, kr[d], gq[d]);
    }
#pragma unroll
    for (int d = 0; d < WW; ++d) gq[d] = slice_sum<WG>(gq[d]);
  }
  if (lane < WG) store_row<WW>(dq + qr * ld + oc + g * WW, gq, scale);
}

// dk/dv past head dim 64: flash_rank_dkv_kernel<64>'s grid with the output
// chunk as blockIdx.z (zero CTAs zero their chunk of the masked keys; work
// CTAs take the span's blocks of 4 keys, lanes and warps over the
// queries).  Nothing is staged: a pair's p and dp are dot products over
// the whole head dim read from L1 and L2, and the chunk's columns of dk
// and dv are summed over the queries, then the 8 warps' sums in warp
// order, as the narrow kernel's.
__global__ void __launch_bounds__(BWD_NT)
    flash_rank_dkv_wide(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ mask,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, int L,
                        int S, int ld, int q_offset, int causal, float qscale,
                        int work) {
  constexpr int WARPS = BWD_NT / 32;
  constexpr int PHASES = BWD_NT / (BWD_KEYS * WG);  // query phases a key
  __shared__ float part[WARPS][BWD_KEYS][2 * WCH];
  const int b = blockIdx.x, oc = blockIdx.z * WCH;
  const long k_base = b * static_cast<long>(S);
  const int* m = mask + k_base;
  const int y = blockIdx.y;
  if (y >= work) {  // a zero CTA: its chunk of every key with mask 0
    const int j = (y - work) * BWD_NT + threadIdx.x;
    if (j < S && __ldg(m + j) <= 0) {
#pragma unroll
      for (int d = 0; d < WCH; d += 4) {
        *reinterpret_cast<float4*>(dk + (k_base + j) * ld + oc + d) =
            make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dv + (k_base + j) * ld + oc + d) =
            make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    return;
  }
  const int2 span = visible_span<BWD_NT>(m, S);
  const int lo = span.x;
  const int hi = span.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int reach = causal ? min(hi, L - 1 + q_offset) : hi;
  const int g = lane % WG, t = lane / WG % BWD_KEYS;
  const int phase = warp * (32 / (BWD_KEYS * WG)) + lane / (BWD_KEYS * WG);
  const unsigned gmask = group_mask<WG>(lane);
  const long q_base = static_cast<long>(b) * L;
  for (int key0 = lo + y * BWD_KEYS; key0 <= hi; key0 += work * BWD_KEYS) {
    unsigned live = 0, unreached = 0;  // keys to walk; visible, past reach
#pragma unroll
    for (int u = 0; u < BWD_KEYS; ++u) {
      const int j = key0 + u;
      if (j <= hi && __ldg(m + j) > 0)
        (j <= reach ? live : unreached) |= 1u << u;
    }
    // a visible key no query may reach (causal): exact zeros
    if (threadIdx.x < BWD_KEYS * WCH / 4) {
      const int u = threadIdx.x / (WCH / 4);
      if (unreached >> u & 1u) {
        const long o = (k_base + key0 + u) * ld + oc + threadIdx.x % (WCH / 4) * 4;
        *reinterpret_cast<float4*>(dk + o) = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(dv + o) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    if (live == 0u) continue;
    const int key = key0 + t;
    float dka[WW], dva[WW];
#pragma unroll
    for (int d = 0; d < WW; ++d) dka[d] = dva[d] = 0.f;
    if (live >> t & 1u) {
      const float* krow = k + (k_base + key) * ld + g * WW;
      const float* vrow = v + (k_base + key) * ld + g * WW;
      // this lane's first query that may see its key
      int i = phase;
      if (causal && key - q_offset > i)
        i += (key - q_offset - i + PHASES - 1) / PHASES * PHASES;
      for (; i < L; i += PHASES) {
        const float l2 = __ldg(lse + q_base + i) * LOG2E;
        if (l2 <= NEG_INF * 0.5f) continue;  // a fully masked row: p = 0
        const float* qrow = q + (q_base + i) * ld + g * WW;
        const float* drow = dout + (q_base + i) * ld + g * WW;
        const float p = exp2f(
            group_sum<WG>(wide_dot(qrow, krow, ld, 0.f), gmask) * qscale - l2);
        const float ds =
            p * (group_sum<WG>(wide_dot(drow, vrow, ld, 0.f), gmask) -
                 __ldg(delta + q_base + i));
        float qv[WW], dov[WW];
        load_row<WW>(qrow + oc, qv);
        load_row<WW>(drow + oc, dov);
#pragma unroll
        for (int d = 0; d < WW; ++d) {
          dva[d] = fmaf(p, dov[d], dva[d]);
          dka[d] = fmaf(ds, qv[d] * qscale, dka[d]);
        }
      }
    }
    // the query phases of a key meet: within the warp, then the warps'
    // sums in warp order
#pragma unroll
    for (int d = 0; d < WW; ++d) {
#pragma unroll
      for (int off = BWD_KEYS * WG; off < 32; off <<= 1) {
        dka[d] += __shfl_xor_sync(FULL, dka[d], off);
        dva[d] += __shfl_xor_sync(FULL, dva[d], off);
      }
    }
    if (lane < BWD_KEYS * WG) {
#pragma unroll
      for (int d = 0; d < WW; ++d) {
        part[warp][t][g * WW + d] = dka[d];
        part[warp][t][WCH + g * WW + d] = dva[d];
      }
    }
    __syncthreads();
    for (int e2 = threadIdx.x; e2 < BWD_KEYS * 2 * WCH; e2 += BWD_NT) {
      const int kt = e2 / (2 * WCH), e = e2 % (2 * WCH);
      if (live >> kt & 1u) {
        float sum = 0.f;
#pragma unroll
        for (int wi = 0; wi < WARPS; ++wi) sum += part[wi][kt][e];  // in order
        const long o = (k_base + key0 + kt) * ld + oc;
        if (e < WCH)
          dk[o + e] = sum * LN2;
        else
          dv[o + e - WCH] = sum;
      }
    }
    __syncthreads();  // part is read before the next block writes it
  }
}

// the head dims the kernels take: the built ones (4, 8, 16, 32, 64) and
// any multiple of 64 past them (the wide kernels); the wrapper pads any
// other head dim up to the next of these with zero columns
bool bad_dims(int B, int L, int S, int hd) {
  return B <= 0 || L <= 0 || S <= 0 || B > 65535 ||
         !(hd == 4 || hd == 8 || hd == 16 || hd == 32 || hd == 64 ||
           (hd > 64 && hd % WCH == 0 && hd / WCH <= 65535));
}

// the instance of `kernel` for head dim hd <= 64 (one bad_dims takes)
#define RANK_INSTANCE(kernel, hd)                                   \
  ((hd) == 4 ? kernel<4> : (hd) == 8 ? kernel<8> : (hd) == 16 ? kernel<16> \
   : (hd) == 32 ? kernel<32> : kernel<64>)

}  // namespace

// q/out (B, L, 1, hd), k/v (B, S, 1, hd) fp32 with hd 4, 8, 16, 32, 64 or
// a multiple of 64, mask (B, S) int32, lse (B, 1, L) fp32; all contiguous,
// q, k, v and out 16-byte aligned; qscale log2(e)/sqrt(r) of the true head
// dim r <= hd (the columns past r zero).  Returns cudaGetLastError().
extern "C" int moka_flash_rank_fwd(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, void* lse,
                                   int B, int L, int S, int hd, int q_offset,
                                   int causal, float qscale, void* stream) {
  if (bad_dims(B, L, S, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* mp = static_cast<const int*>(mask);
  auto* op = static_cast<float*>(out);
  auto* lp = static_cast<float*>(lse);
  if (hd > 64) {
    const auto launch = hd <= 512 ? launch_fwd_wide<32>
                        : hd <= 1024 ? launch_fwd_wide<16> : launch_fwd_wide<8>;
    return launch(qp, kp, vp, mp, op, lp, B, L, S, hd, q_offset, causal,
                  qscale, st);
  }
  const dim3 grid((L + FWD_WARPS - 1) / FWD_WARPS, B);
  const auto kernel = RANK_INSTANCE(flash_rank_fwd_kernel, hd);
  kernel<<<grid, FWD_NT, 0, st>>>(qp, kp, vp, mp, op, lp, L, S, q_offset,
                                  causal, qscale);
  return static_cast<int>(cudaGetLastError());
}

// dq (B, L, 1, hd) fp32 given the forward's lse and delta (B, 1, L); scale
// 1/sqrt(r) of the true head dim.
extern "C" int moka_flash_rank_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dqp, int B,
                                      int L, int S, int hd, int q_offset,
                                      int causal, float qscale, float scale,
                                      void* stream) {
  if (bad_dims(B, L, S, hd)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((L + FWD_WARPS - 1) / FWD_WARPS, B, hd > 64 ? hd / WCH : 1);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* mp = static_cast<const int*>(mask);
  const auto* dp = static_cast<const float*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* ep = static_cast<const float*>(delta);
  if (hd > 64)
    flash_rank_dq_wide<<<grid, FWD_NT, 0, st>>>(
        qp, kp, vp, mp, dp, lp, ep, static_cast<float*>(dqp), L, S, hd,
        q_offset, causal, qscale, scale);
  else {
    const auto kernel = RANK_INSTANCE(flash_rank_dq_kernel, hd);
    kernel<<<grid, FWD_NT, 0, st>>>(qp, kp, vp, mp, dp, lp, ep,
                                    static_cast<float*>(dqp), L, S, q_offset,
                                    causal, qscale, scale);
  }
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
  // work CTAs (the span's key blocks, every work-th one each) and zero
  // CTAs (BWD_NT keys each) a sample; the sample is the grid's fastest
  // index, so the work CTAs come first in dispatch order and spread over
  // the SMs
  const int work = (S + SPAN_SHARE * BWD_KEYS - 1) / (SPAN_SHARE * BWD_KEYS);
  const int blocks = work + (S + BWD_NT - 1) / BWD_NT;
  if (bad_dims(B, L, S, hd) || blocks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, blocks, hd > 64 ? hd / WCH : 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const float*>(q);
  const auto* kp = static_cast<const float*>(k);
  const auto* vp = static_cast<const float*>(v);
  const auto* mp = static_cast<const int*>(mask);
  const auto* dp = static_cast<const float*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* ep = static_cast<const float*>(delta);
  if (hd > 64)
    flash_rank_dkv_wide<<<grid, BWD_NT, 0, st>>>(
        qp, kp, vp, mp, dp, lp, ep, static_cast<float*>(dkp),
        static_cast<float*>(dvp), L, S, hd, q_offset, causal, qscale, work);
  else {
    const auto kernel = RANK_INSTANCE(flash_rank_dkv_kernel, hd);
    kernel<<<grid, BWD_NT, 0, st>>>(qp, kp, vp, mp, dp, lp, ep,
                                    static_cast<float*>(dkp),
                                    static_cast<float*>(dvp), L, S, q_offset,
                                    causal, qscale, work);
  }
  return static_cast<int>(cudaGetLastError());
}
