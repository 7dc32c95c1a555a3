// Fused MokA adapter delta, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel moka_tpu/ops/moka_pallas.py::_kernel (launched by
// _fused_fwd).  For a tile of tokens of one batch row it computes
//   a_i   = (x @ A_i) * mask_i * pre_scale                 for every modality i
//   buf   = sum_i a_i + sum_{i in attn} mask_i * attn_weight *
//           softmax(a_i keys^T / sqrt(r), masked to the question) @ keys
//   delta = (buf @ B) * sum_i mask_i * post_i    (post scaling optional)
// with one read of x and one write of delta: the (M, b, L, r) rank tensor
// and the rank-space scores never reach device memory.  The question keys
//   keys  = (x @ A_0) * mask_0 * qmask * pre_scale          (b, L, r) fp32
// come from a first, small kernel (question_keys_kernel) that reads x only
// on question tokens and writes zero keys elsewhere; the JAX code computes
// them as a plain product over every token.  A row with no question token
// gets zero attention (the has_q guard).
//
// All arithmetic is fp32 from x in its storage type (bf16 or fp32); unlike
// the TPU kernel, A is not rounded to bf16.
//
// What bounds it: bytes.  r = 4, so per token it reads d_in values of x and
// writes d_out values with ~2*M*r flops per input and 2*r per output; at the
// serving shapes (b 8, L 896, d 4096/11008) x and delta are 59-158 MB and
// the fp32 work is well under the time the bytes take.  What the design
// does about it:
//   * A (M, d_in, r) fp32 is up to 528 KB for the down projection, more
//     than shared memory, so it is streamed through shared memory in
//     256-wide chunks of d_in (from L2, where all of it fits) and reused by
//     the 32 tokens of the tile; the shared copy is padded so the 8 threads
//     of a token read distinct banks;
//   * each token's d_in reduction is split over 8 threads; per staged chunk
//     of A (256 of d_in) each thread has four 16-byte x loads in flight and
//     loads the next chunk's x while it computes; the 8 partial sums
//     combine with warp shuffles;
//   * the rank-space attention splits each (token, modality) pair over 4
//     threads with an online softmax, merged by shuffles; keys and the
//     question mask are staged in shared memory 256 positions at a time
//     and only question positions are scored;
//   * B (r, d_out) is read per output column pair from L2 and each thread
//     writes two adjacent outputs for every token of the tile.
// Not done yet: TMA/cp.async staging, more CTAs in flight per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;         // threads per CTA
constexpr int TOK = 32;         // tokens per CTA
constexpr int J = NT / TOK;     // threads per token in the d_in reduction
constexpr int VEC = 8;          // x elements per thread per chunk
constexpr int DC = J * VEC;     // d_in covered by one slice of every thread
constexpr int UNROLL = 4;       // slices per thread per staged chunk
constexpr int DCE = UNROLL * DC;  // d_in per staged chunk of A
constexpr int KC = 256;         // key positions staged per step
constexpr int MAXM = 4;         // modalities
constexpr int SPLIT = 4;        // threads per (token, modality) attention pair

// one thread's 8-element slice of an x row, as loaded (16 or 32 bytes)
template <typename T>
struct Slice;
template <>
struct Slice<__nv_bfloat16> {
  uint4 v;
};
template <>
struct Slice<float> {
  float4 a, b;
};

__device__ __forceinline__ void load_slice(const __nv_bfloat16* p,
                                           Slice<__nv_bfloat16>& s) {
  s.v = *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void load_slice(const float* p, Slice<float>& s) {
  s.a = reinterpret_cast<const float4*>(p)[0];
  s.b = reinterpret_cast<const float4*>(p)[1];
}

__device__ __forceinline__ void zero_slice(Slice<__nv_bfloat16>& s) {
  s.v = make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void zero_slice(Slice<float>& s) {
  s.a = s.b = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void unpack(const Slice<__nv_bfloat16>& s,
                                       float (&v)[VEC]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&s.v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const Slice<float>& s, float (&v)[VEC]) {
  v[0] = s.a.x; v[1] = s.a.y; v[2] = s.a.z; v[3] = s.a.w;
  v[4] = s.b.x; v[5] = s.b.y; v[6] = s.b.z; v[7] = s.b.w;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// One CTA per token.  A token outside the question (mask_0 * qmask == 0)
// skips its x row and writes zero keys; a question token's CTA splits d_in
// into 8-element slices, NT threads apart (2-6 per thread at d_in 4096 to
// 11008, so many loads are in flight), and combines by shuffles and
// shared memory.
template <typename T>
__global__ void __launch_bounds__(NT)
    question_keys_kernel(const T* __restrict__ x,
                         const float* __restrict__ masks,
                         const float* __restrict__ qmask,
                         const float* __restrict__ A, float* __restrict__ keys,
                         int L, int d_in, float pre_scale) {
  constexpr int R = 4;  // one float4 of A per input element
  __shared__ float part[NT / 32][R];
  const int tid = threadIdx.x, lane = tid % 32;
  const long row = static_cast<long>(blockIdx.y) * L + blockIdx.x;
  const float w = masks[row] * qmask[row];  // masks[0] is the text stream
  if (w == 0.f) {
    if (tid < R) keys[row * R + tid] = 0.f;
    return;
  }
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  const T* xrow = x + row * d_in;
  for (int d = tid * VEC; d < d_in; d += NT * VEC) {
    Slice<T> s;
    load_slice(xrow + d, s);
    float v[VEC];
    unpack(s, v);
    const float4* ap = reinterpret_cast<const float4*>(A + static_cast<long>(d) * R);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float4 a = ap[e];
      acc[0] += v[e] * a.x;
      acc[1] += v[e] * a.y;
      acc[2] += v[e] * a.z;
      acc[3] += v[e] * a.w;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) part[tid / 32][r] = acc[r];
  }
  __syncthreads();
  if (tid < R) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NT / 32; ++i) s += part[i][tid];
    keys[row * R + tid] = s * w * pre_scale;
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(NT)
    moka_delta_kernel(const T* __restrict__ x, const float* __restrict__ masks,
                      const float* __restrict__ qmask,
                      const float* __restrict__ keys,
                      const float* __restrict__ A, const float* __restrict__ Bm,
                      T* __restrict__ out, int nb, int L, int d_in, int d_out,
                      int M, float pre_scale, float attn_weight, int attn_bits,
                      float p0, float p1, float p2, float p3, int has_post) {
  constexpr int AS = VEC * R + 4;  // padded floats per (modality, thread) slice
  __shared__ __align__(16) float as[MAXM * UNROLL * J * AS];
  __shared__ float mk[MAXM][TOK];
  __shared__ float abuf[TOK][MAXM][R];
  __shared__ float att[TOK][MAXM][R];
  __shared__ float buf[TOK][R];
  __shared__ float tscale[TOK];
  __shared__ float kbuf[KC][R];
  __shared__ float qm[KC];

  const int bi = blockIdx.y;
  const int t0 = blockIdx.x * TOK;
  const int tid = threadIdx.x;
  const int tt = tid / J, jj = tid % J;
  const int l = t0 + tt;
  const bool live = l < L;
  const float post[MAXM] = {p0, p1, p2, p3};

  for (int i = tid; i < M * TOK; i += NT) {
    const int m = i / TOK, t = i % TOK;
    mk[m][t] = t0 + t < L ? masks[(static_cast<long>(m) * nb + bi) * L + t0 + t] : 0.f;
  }

  // ---- a_i = x @ A_i over d_in, streamed in DC-wide chunks
  float acc[MAXM][R];
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r) acc[m][r] = 0.f;
  const T* xrow = x + (static_cast<long>(bi) * L + (live ? l : 0)) * d_in;
  // x slices of the current chunk; the next chunk's are loaded while this
  // one computes
  Slice<T> xs[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int dx = u * DC + jj * VEC;
    if (live && dx < d_in) load_slice(xrow + dx, xs[u]); else zero_slice(xs[u]);
  }
  constexpr int F4 = DCE * R / 4;  // float4s of A per modality and chunk
  for (int d0 = 0; d0 < d_in; d0 += DCE) {
    __syncthreads();  // previous chunk consumed
    for (int f = tid; f < M * F4; f += NT) {
      const int m = f / F4, rem = f % F4;
      const int d = rem * 4 / R, r0 = (rem * 4) % R;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (d0 + d < d_in)
        val = *reinterpret_cast<const float4*>(
            A + (static_cast<long>(m) * d_in + d0 + d) * R + r0);
      const int u = d / DC, jg = (d % DC) / VEC, e = d % VEC;
      *reinterpret_cast<float4*>(&as[((m * UNROLL + u) * J + jg) * AS + e * R + r0]) = val;
    }
    __syncthreads();
    float xv[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) unpack(xs[u], xv[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int dx = d0 + DCE + u * DC + jj * VEC;
      if (live && dx < d_in) load_slice(xrow + dx, xs[u]); else zero_slice(xs[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int m = 0; m < MAXM; ++m) {
        if (m < M) {
          const float* ap = &as[((m * UNROLL + u) * J + jj) * AS];
#pragma unroll
          for (int e = 0; e < VEC; ++e)
#pragma unroll
            for (int r = 0; r < R; ++r) acc[m][r] += xv[u][e] * ap[e * R + r];
        }
      }
  }
  // the J threads of a token are adjacent lanes: combine their partial sums
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int off = 1; off < J; off <<= 1)
        acc[m][r] += __shfl_xor_sync(0xffffffffu, acc[m][r], off);
  if (jj == 0) {
#pragma unroll
    for (int m = 0; m < MAXM; ++m)
      if (m < M)
#pragma unroll
        for (int r = 0; r < R; ++r) abuf[tt][m][r] = acc[m][r] * mk[m][tt] * pre_scale;
  }
  __syncthreads();

  // ---- rank-space attention of the attn modalities against the question
  int amods[MAXM];
  int na = 0;
  for (int m = 0; m < M; ++m)
    if ((attn_bits >> m) & 1) amods[na++] = m;
  const float inv_sqrt_r = 1.0f / sqrtf(static_cast<float>(R));
  const int npairs = TOK * na;
  for (int pb = 0; pb < npairs; pb += NT / SPLIT) {
    const int pair = pb + tid / SPLIT, sub = tid % SPLIT;
    const bool worker = pair < npairs;
    const int pt = worker ? pair % TOK : 0;
    const int pj = worker ? pair / TOK : 0;
    float qv[R], ra[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      qv[r] = worker ? abuf[pt][amods[pj]][r] : 0.f;
      ra[r] = 0.f;
    }
    float rm = -INFINITY, rl = 0.f;
    for (int k0 = 0; k0 < L; k0 += KC) {
      __syncthreads();
      for (int i = tid; i < KC * R; i += NT) {
        const int kk = i / R, r = i % R;
        kbuf[kk][r] = k0 + kk < L ? keys[(static_cast<long>(bi) * L + k0 + kk) * R + r] : 0.f;
      }
      for (int i = tid; i < KC; i += NT)
        qm[i] = k0 + i < L ? qmask[static_cast<long>(bi) * L + k0 + i] : 0.f;
      __syncthreads();
      if (worker) {
        const int kend = min(KC, L - k0);
        for (int kk = sub; kk < kend; kk += SPLIT) {
          if (qm[kk] > 0.f) {
            float s = 0.f;
#pragma unroll
            for (int r = 0; r < R; ++r) s += qv[r] * kbuf[kk][r];
            s *= inv_sqrt_r;
            const float mn = fmaxf(rm, s);
            const float corr = expf(rm - mn);
            const float p = expf(s - mn);
            rl = rl * corr + p;
#pragma unroll
            for (int r = 0; r < R; ++r) ra[r] = ra[r] * corr + p * kbuf[kk][r];
            rm = mn;
          }
        }
      }
    }
    // merge the SPLIT partial softmaxes (adjacent lanes)
#pragma unroll
    for (int off = 1; off < SPLIT; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, rm, off);
      const float ol = __shfl_xor_sync(0xffffffffu, rl, off);
      const float nm = fmaxf(rm, om);
      const float s1 = rm == -INFINITY ? 0.f : expf(rm - nm);
      const float s2 = om == -INFINITY ? 0.f : expf(om - nm);
      rl = rl * s1 + ol * s2;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float oa = __shfl_xor_sync(0xffffffffu, ra[r], off);
        ra[r] = ra[r] * s1 + oa * s2;
      }
      rm = nm;
    }
    if (worker && sub == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) att[pt][pj][r] = rl > 0.f ? ra[r] / rl : 0.f;
    }
  }
  __syncthreads();

  // ---- rank-space buffer and per-token post scale
  if (jj < R) {
    float bv = 0.f;
    int ai = 0;
    for (int m = 0; m < M; ++m) {
      bv += abuf[tt][m][jj];
      if ((attn_bits >> m) & 1) {
        bv += mk[m][tt] * (attn_weight * att[tt][ai][jj]);
        ++ai;
      }
    }
    buf[tt][jj] = bv;
  }
  if (jj == 0) {
    float ps = 1.f;
    if (has_post) {
      ps = 0.f;
      for (int m = 0; m < M; ++m) ps += mk[m][tt] * post[m];
    }
    tscale[tt] = ps;
  }
  __syncthreads();

  // ---- delta = buf @ B, two adjacent output columns per thread
  const int ntok = min(TOK, L - t0);
  for (int o = 2 * tid; o < d_out; o += 2 * NT) {
    float b0[R], b1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 bb = *reinterpret_cast<const float2*>(Bm + static_cast<long>(r) * d_out + o);
      b0[r] = bb.x;
      b1[r] = bb.y;
    }
    for (int t = 0; t < ntok; ++t) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s0 += buf[t][r] * b0[r];
        s1 += buf[t][r] * b1[r];
      }
      if (has_post) {
        s0 *= tscale[t];
        s1 *= tscale[t];
      }
      store2(out + (static_cast<long>(bi) * L + t0 + t) * d_out + o, s0, s1);
    }
  }
}

template <typename T>
int launch(const void* x, const void* masks, const void* qmask, void* keys,
           const void* A, const void* Bm, void* out, int nb, int L, int d_in,
           int d_out, int M, int R, float pre_scale, float attn_weight,
           int attn_bits, float p0, float p1, float p2, float p3, int has_post,
           cudaStream_t st) {
  if (R != 4) return static_cast<int>(cudaErrorInvalidValue);
  question_keys_kernel<T><<<dim3(L, nb), NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(masks),
      static_cast<const float*>(qmask), static_cast<const float*>(A),
      static_cast<float*>(keys), L, d_in, pre_scale);
  const dim3 grid((L + TOK - 1) / TOK, nb);
  moka_delta_kernel<T, 4><<<grid, NT, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(masks),
      static_cast<const float*>(qmask), static_cast<const float*>(keys),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<T*>(out), nb, L, d_in, d_out, M, pre_scale, attn_weight,
      attn_bits, p0, p1, p2, p3, has_post);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (nb, L, d_in) bf16 (x_bf16 = 1) or fp32; masks (M, nb, L), qmask (nb, L),
// A (M, d_in, R), B (R, d_out) fp32; keys (nb, L, R) fp32 scratch that the
// first kernel writes; out (nb, L, d_out) in x's type; all contiguous,
// R == 4, d_in % 8 == 0, d_out % 2 == 0, M <= 4.  Returns cudaGetLastError().
extern "C" int moka_delta_fwd(const void* x, int x_bf16, const void* masks,
                              const void* qmask, void* keys,
                              const void* A, const void* Bm, void* out, int nb,
                              int L, int d_in, int d_out, int M, int R,
                              float pre_scale, float attn_weight, int attn_bits,
                              float p0, float p1, float p2, float p3,
                              int has_post, void* stream) {
  if (nb <= 0 || L <= 0 || M <= 0 || M > MAXM || d_in % VEC != 0 ||
      d_out % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch<__nv_bfloat16>(x, masks, qmask, keys, A, Bm, out, nb, L,
                                 d_in, d_out, M, R, pre_scale, attn_weight,
                                 attn_bits, p0, p1, p2, p3, has_post, st);
  return launch<float>(x, masks, qmask, keys, A, Bm, out, nb, L, d_in, d_out,
                       M, R, pre_scale, attn_weight, attn_bits, p0, p1, p2, p3,
                       has_post, st);
}
