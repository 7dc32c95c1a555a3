// Length-aware decode attention for Hopper (sm_90a): one new token's GQA
// attention over the valid prefix of one layer of the KV cache, on a bf16
// cache or an int8 cache with fp32 per-(token, head) scales.
//
// Replaces no Pallas kernel.  Its reference is the XLA block loop
// moka_tpu/ops/paged_decode.py::paged_decode_attention (a lax.fori_loop over
// cdiv(length, 256) key blocks with an fp32 online softmax); in eager PyTorch
// that loop would issue about ten launches a block a layer on a decode step
// that is already bound by the host, and the eager int8 path dequantizes a
// layer's whole cache every step.  This kernel is one launch a layer.
//
// Contract (ops/paged_decode.py::paged_decode_attention_plain, JAX's loop):
// q (B, 1, H, 128) bf16; the layer's k and v, (B, S, K, 128) slices of the
// layer-stacked (N, B, S, K, 128) cache, bf16 or int8 with scales (B, S, K)
// fp32; mask (B, S) int32 or fp32; `length` keys valid from the start of the
// cache.  Key j of row b is visible when j < length and mask[b, j] > 0.
//   s = (q . k_j) / sqrt(128)     int8: (q . codes_j) / sqrt(128) * ks_j
//   out = sum_j softmax(s)_j v_j   int8: sum_j (p_j * vs_j) codes_j / l
// in fp32 (softmax in base 2 inside), the result rounded once to bf16.  The
// scales fold in as JAX folds them: ks into the score, vs into p, l summed
// from p alone.  A row that sees no key gives 0.  (JAX's loop gives it the
// mean of the values of the blocks it walked: its m stays at -1e30 and p is 1
// on every key.  Callers read only rows that see a key, as for kernel 1.)
//
// Bound: the bytes.  Each visible key's k and v row is read once (256 B each
// in bf16, 128 B in int8, plus 8 B of scales), q and out are 256 B a head;
// 4 flops per key and head element, far below the card's rate.  At the 7B
// serving shape (B 8, K 32, 928 keys) that is 121.6 MB a layer in bf16, 36 us
// at 3.35 TB/s, and half of it in int8.
//
// Design, simple first: a CTA per (sample, kv head, 256-key chunk) below
// cdiv(length, 256), 256 threads; keys at or past `length` are never read.
//   * The chunk's v rows go to shared memory by cp.async (16 bytes a copy)
//     at the start, in flight while the scores are made.
//   * Scores: a key row is read by 16-byte loads (8 bf16 or 16 int8 a lane,
//     16 or 8 lanes a key, 2 or 4 keys a warp step, four steps' loads in
//     flight before their products), widened to fp32, dotted
//     with the G query heads of the kv head (q prescaled by log2(e)/sqrt(128),
//     in shared memory) and reduced across the key's lanes by shuffles.
//   * Softmax: warp g takes query head g over the chunk: max, exp2, sum; the
//     weights (times vs for int8) overwrite the scores in shared memory.
//   * p.v: thread t owns dimension t % 128 for half the chunk's keys, reads
//     v from shared memory and sums in fp32; the two halves add.
//   * Chunks combine in the same launch: each CTA writes its (m, l, unscaled
//     out) to a workspace and takes a ticket; the last CTA of a (sample, kv
//     head) merges the chunks in chunk order (so the result does not depend
//     on which CTA is last), writes out and resets the ticket to 0.

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int HD = 128;       // head_dim
constexpr int CHUNK = 256;    // keys a CTA
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_G = 8;      // query heads a kv head (GQA 64:8)
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const __nv_bfloat16* q;     // (B, H, HD)
  const void* k;              // the layer's (B, S, K, HD)
  const void* v;
  const float* ks;            // the layer's (B, S, K) scales (int8 only)
  const float* vs;
  const int32_t* mask;        // (B, S), int32 or fp32 bits
  int mask_is_float;
  __nv_bfloat16* out;         // (B, H, HD)
  float* ws_o;                // (B * K, n_split, G, HD) unscaled outputs
  float* ws_ml;               // (B * K, n_split, G, 2) running max, sum
  int* tickets;               // (B * K), zero between launches
  int B, H, K, S, length, G, n_split;
  float q_scale;              // log2(e) / sqrt(HD)
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// 16 bytes of a key row, widened to fp32.
__device__ __forceinline__ void widen(const uint4 raw, float (&f)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void widen(const uint4 raw, float (&f)[16]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * j)));
  }
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <bool INT8>
__global__ void __launch_bounds__(THREADS)
    paged_decode_kernel(const Args a) {
  using T = typename std::conditional<INT8, int8_t, __nv_bfloat16>::type;
  constexpr int EPL = 16 / sizeof(T);   // elements a lane loads
  constexpr int LPK = HD / EPL;         // lanes a key row
  constexpr int KPW = 32 / LPK;         // keys a warp step

  extern __shared__ __align__(16) unsigned char smem[];
  T* v_sh = reinterpret_cast<T*>(smem);                         // CHUNK x HD
  float* q_sh = reinterpret_cast<float*>(smem + CHUNK * HD * sizeof(T));
  float* w_sh = q_sh + a.G * HD;                                // G x CHUNK
  float* half_sh = w_sh + a.G * CHUNK;                          // G x HD
  __shared__ float m_sh[MAX_G], l_sh[MAX_G];
  __shared__ int is_last;

  const int pair = blockIdx.x, split = blockIdx.y;
  const int b = pair / a.K, kh = pair % a.K, G = a.G;
  const int key0 = split * CHUNK;
  const int n_keys = min(CHUNK, a.length - key0);
  const size_t row = static_cast<size_t>(a.K) * HD;  // elements a token
  const size_t first = (static_cast<size_t>(b) * a.S + key0) * row +
                       static_cast<size_t>(kh) * HD;
  const T* kp = static_cast<const T*>(a.k) + first;
  const T* vp = static_cast<const T*>(a.v) + first;
  const size_t srow = (static_cast<size_t>(b) * a.S + key0) * a.K + kh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // v rows of the chunk into shared memory, in flight from here on
  constexpr int VEC = HD / EPL;  // 16-byte copies a row
  for (int i = tid; i < n_keys * VEC; i += THREADS) {
    const int key = i / VEC, c = i % VEC;
    cp_async16(v_sh + key * HD + c * EPL, vp + key * row + c * EPL);
  }
  const __nv_bfloat16* qp =
      a.q + (static_cast<size_t>(b) * a.H + static_cast<size_t>(kh) * G) * HD;
  for (int i = tid; i < G * HD; i += THREADS)
    q_sh[i] = __bfloat162float(qp[i]) * a.q_scale;
  __syncthreads();

  // scores (log2 domain), -inf where the key is masked
  const int sub = lane / LPK, part = lane % LPK;
  const int32_t* mrow = a.mask + static_cast<size_t>(b) * a.S + key0;
  constexpr int STEP = WARPS * KPW;  // keys a CTA step
  constexpr int UNROLL = 4;          // steps whose loads are in flight
  for (int base = warp * KPW; base < n_keys; base += UNROLL * STEP) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int key = base + u * STEP + sub;
      raw[u] = key < n_keys ? __ldg(reinterpret_cast<const uint4*>(
                                  kp + key * row + part * EPL))
                            : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int key = base + u * STEP + sub;
      float kf[EPL];
      widen(raw[u], kf);
      float acc[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        acc[g] = 0.f;
        if (g < G) {
          const float* qg = q_sh + g * HD + part * EPL;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g] = fmaf(qg[e], kf[e], acc[g]);
#pragma unroll
          for (int off = LPK / 2; off > 0; off /= 2)
            acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], off);
        }
      }
      if (part == 0 && key < n_keys) {
        const int32_t mv = mrow[key];
        const bool ok = a.mask_is_float ? __int_as_float(mv) > 0.f : mv > 0;
        const float ks = INT8 ? __ldg(a.ks + srow + key * a.K) : 1.f;
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) w_sh[g * CHUNK + key] = ok ? acc[g] * ks : -INFINITY;
      }
    }
  }
  __syncthreads();

  // softmax over the chunk: warp g, query head g
  if (warp < G) {
    float* wg = w_sh + warp * CHUNK;
    float m = -INFINITY;
    for (int j = lane; j < n_keys; j += 32) m = fmaxf(m, wg[j]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int j = lane; j < n_keys; j += 32) {
      const float s = wg[j];
      const float p = s == -INFINITY ? 0.f : exp2f(s - m);
      l += p;
      const float vs = INT8 ? __ldg(a.vs + srow + j * a.K) : 1.f;
      wg[j] = p * vs;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      m_sh[warp] = m;
      l_sh[warp] = l;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // p . v: dimension d over one half of the chunk's keys
  const int d = tid % HD, half = tid / HD;
  float o[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) o[g] = 0.f;
  const int j_end = min(n_keys, (half + 1) * (CHUNK / 2));
  for (int j = half * (CHUNK / 2); j < j_end; ++j) {
    const float vv = to_float(v_sh[j * HD + d]);
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) o[g] = fmaf(w_sh[g * CHUNK + j], vv, o[g]);
  }
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
    if (g < G && half == 1) half_sh[g * HD + d] = o[g];
  __syncthreads();
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
    if (g < G && half == 0) o[g] += half_sh[g * HD + d];

  __nv_bfloat16* op = a.out +
      (static_cast<size_t>(b) * a.H + static_cast<size_t>(kh) * G) * HD;
  if (a.n_split == 1) {
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G && half == 0) {
        const float l = l_sh[g];
        op[g * HD + d] = __float2bfloat16(l > 0.f ? o[g] / l : 0.f);
      }
    return;
  }

  // several chunks: leave this one's part, the last CTA merges them all
  const size_t slot = (static_cast<size_t>(pair) * a.n_split + split) * G;
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
    if (g < G && half == 0) a.ws_o[(slot + g) * HD + d] = o[g];
  if (tid < G) {
    a.ws_ml[(slot + tid) * 2] = m_sh[tid];
    a.ws_ml[(slot + tid) * 2 + 1] = l_sh[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0)
    is_last = atomicAdd(a.tickets + pair, 1) == a.n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  if (half == 0) {
    const size_t base = static_cast<size_t>(pair) * a.n_split * G;
    for (int g = 0; g < G; ++g) {
      float m = -INFINITY;
      for (int s = 0; s < a.n_split; ++s)
        m = fmaxf(m, __ldcg(a.ws_ml + (base + s * G + g) * 2));
      float l = 0.f, acc = 0.f;
      for (int s = 0; s < a.n_split; ++s) {
        const size_t at = base + s * G + g;
        const float ms = __ldcg(a.ws_ml + at * 2);
        const float wgt = ms == -INFINITY ? 0.f : exp2f(ms - m);
        l = fmaf(__ldcg(a.ws_ml + at * 2 + 1), wgt, l);
        acc = fmaf(__ldcg(a.ws_o + at * HD + d), wgt, acc);
      }
      op[g * HD + d] = __float2bfloat16(l > 0.f ? acc / l : 0.f);
    }
  }
  if (tid == 0) a.tickets[pair] = 0;
}

template <bool INT8>
int launch(const Args& a, size_t smem, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_kernel<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(CHUNK * HD * (INT8 ? 1 : 2) +
                       MAX_G * (2 * HD + CHUNK) * sizeof(float)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  paged_decode_kernel<INT8>
      <<<dim3(a.B * a.K, a.n_split), THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k, v (and ks, vs) point at the layer's slice of the cache; ws_o, ws_ml
// are needed (and read) only when length > 256; tickets hold B * K zeros.
extern "C" int moka_paged_decode(const void* q, const void* k, const void* v,
                                 const void* ks, const void* vs,
                                 const void* mask, int mask_is_float,
                                 void* out, void* ws_o, void* ws_ml,
                                 void* tickets, int B, int H, int K, int S,
                                 int length, int kv_int8, void* stream) {
  if (B <= 0 || K <= 0 || H % K != 0 || H / K > MAX_G || length <= 0 ||
      length > S)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = k;
  a.v = v;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.mask = static_cast<const int32_t*>(mask);
  a.mask_is_float = mask_is_float;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ws_o = static_cast<float*>(ws_o);
  a.ws_ml = static_cast<float*>(ws_ml);
  a.tickets = static_cast<int*>(tickets);
  a.B = B;
  a.H = H;
  a.K = K;
  a.S = S;
  a.length = length;
  a.G = H / K;
  a.n_split = (length + CHUNK - 1) / CHUNK;
  a.q_scale = LOG2E / sqrtf(static_cast<float>(HD));
  const size_t smem = CHUNK * HD * (kv_int8 ? 1 : 2) +
                      a.G * (2 * HD + CHUNK) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_int8 ? launch<true>(a, smem, st) : launch<false>(a, smem, st);
}
