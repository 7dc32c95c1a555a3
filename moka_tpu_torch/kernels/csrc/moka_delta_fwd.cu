// Fused MokA adapter delta, forward, for Hopper (sm_90a), at every rank
// with up to four modalities.  Ranks 1-64: the persistent kernel below,
// built for ranks R = 4, 8, 16, 32 and 64; a true rank r <= R runs in the
// rank-R instance with A's columns and B's rows past r zero
// (ops/moka_pallas.py pads them; exact: see takes()) and the attention
// scale 1/sqrt(r) of the true rank.  Past 64 (the wide path, at the end of
// this file) a chain of launches: a down product on the tensor cores
// writes the modalities' a_i and the question keys, R1 (flash_rank.cu at
// head_dim r) attends for each attention stream, and an up product on the
// tensor cores forms the buffer and buf @ B (each product a TMA ring into
// wgmma after a short pass that splits its operands into bf16 halves); no
// array of the persistent kernel's grows with r there.  Under context
// parallelism the keys come from outside: each rank's key pass writes its
// own rows' keys (moka_delta_keys), the caller gathers them over the
// sequence group, and the key pass compacts the gathered rows for the
// main kernel (Args::ext).
//
// Replaces the TPU kernel moka_tpu/ops/moka_pallas.py::_kernel (:35,
// launched by _fused_fwd :112).  For a tile of tokens of one batch row it
// computes
//   a_i   = (x @ A_i) * mask_i * pre_scale                 for every modality i
//   buf   = sum_i a_i + sum_{i in attn} mask_i * attn_weight *
//           softmax(a_i keys^T / sqrt(r), masked to the question) @ keys
//   delta = (buf @ B) * sum_i mask_i * post_i    (post scaling optional)
// with one read of x and one write of delta: the (M, b, L, r) rank tensor
// and the rank-space scores never reach device memory.  The question keys
//   keys  = (x @ A_0) * mask_0 * qmask * pre_scale           (fp32)
// at the positions where qmask > 0 come from a first, small kernel, the key
// pass (question_keys_kernel), which reads x only at those positions and
// writes each batch row's keys contiguously with their count n_q; the JAX
// code computes them as a plain product over every token.  A row with no
// question token gets zero attention (the has_q guard: n_q == 0).
//
// What bounds it: bytes.  At the serving shapes (b 8, L 896, d 4096 and
// 11008, bf16) x and delta are 59-158 MB a launch, 0.335 ms a layer of seven
// projections at 3.35 TB/s; the products are 2*(2*M*r) flops a byte of x
// on the tensor cores and the rank-space attention is n_q keys a token, far
// under that.  The bf16 path (moka_delta_kernel) streams the bytes:
//   * persistent CTAs (one an SM) each walk a contiguous run of work items
//     (batch row, 64-token tile); a producer warp loads x by TMA in boxes
//     of 64 tokens x 64 d_in (128-byte swizzle, evict_first) into a ring
//     of up to 8 mbarrier stages, each stage also carrying A's matching 64
//     rows, and runs on into the next item's x while the consumers do this
//     item's attention and stores;
//   * the down product runs on the tensor cores: one consumer warpgroup
//     issues wgmma m64nNk16 (bf16 in, fp32 accumulate) with N = 2*M*r
//     columns, every modality's r columns side by side.  Where N passes
//     wgmma's 256 or its ring would not fit (r 64 with 3 or 4 modalities)
//     the item takes 2 or 4 passes over x (down_passes), NP = N / passes
//     columns each: x is read again from L2 for each further pass.  A
//     thread holds the same ranks of its two rows in every pass, so it
//     sums the modalities' a_i into the rank-space buffer itself; the
//     attention streams' a_i are also kept as their queries.  A stays fp32 in
//     effect: the key pass splits it into bf16 halves hi = bf16(A) and
//     lo = bf16(A - hi), interleaved column by column, and the two
//     accumulators of a column pair are summed (|A - hi - lo| <= 2^-16 |A|;
//     x is bf16 and exact).  The TPU kernel rounds A to bf16 instead;
//   * the attention stages the row's n_q keys in shared memory once per
//     row (in chunks of KCAP keys where n_q is larger) and walks only them:
//     two threads a token, each every other key, an online softmax in exp2
//     for each attention stream the token belongs to, merged by a shuffle
//     and added into the token's buffer row;
//   * the up product buf @ B also runs on the tensor cores, because at
//     rank 16 its fp32 FMAs (64 tokens x d_out x 16 an item) would take as
//     long as the item's bytes: wgmma m64n64k16 with buf as the register
//     operand, split as [hi(buf), hi(buf), lo(buf)] against the rows
//     [hi(B); lo(B); hi(B)] that the key pass writes (K = 3r padded to 16),
//     which keeps the product within 2^-16 of fp32; B streams through a
//     ring of 2-8 stages (36-48 KB) in chunks of 128 outputs (64 at r 32
//     and 64, where the rows of a box of 64 outputs are 12 and 24 KB) by
//     TMA.  Each
//     warp scales its 16 rows of a chunk, rounds them to bf16 into its own
//     128-byte-swizzled staging tile (4 a warp) and stores them by TMA
//     (rows past L are clipped), with no barrier across the warpgroup, so
//     the writes overlap the next chunks' products and the next item's
//     loads;
//   * the key pass is short: one prefix sum numbers a row's question
//     tokens, and units of 16 of them x 2048 of d_in (A read once a unit,
//     a thread's loads of a pass all in flight) spread over one wave of
//     CTAs; each unit writes partial keys, which the main kernel sums as
//     it stages them.
// The fp32 path (moka_delta_kernel_f32, not on any main path) keeps exact
// fp32 FMAs on the ordinary cores: 32 tokens a CTA, A streamed through
// shared memory, the same compacted keys.
// chip_smoke.py prints ptxas's lines and the SASS counts; measured times
// are in PERF.md.

#include <cuda_bf16.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace moka_hopper;

constexpr int MAXM = 4;              // modalities
constexpr int SMEM_LIMIT = 232448;   // a CTA's shared memory on sm_90
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* x;        // (nb, L, d_in) bf16 or fp32
  const float* masks;   // (M, nb, L)
  const float* qmask;   // (nb, L)
  const float* A;       // (M, d_in, R)
  const float* Bm;      // (R, d_out)
  void* out;            // (nb, L, d_out) in x's type
  float* keys;          // (nb, ds, kl, R): a row's n_q keys first, as ds
                        // partial sums over dch-wide chunks of d_in
  int* nq;              // (nb,)
  __nv_bfloat16* at;    // (2*M*R, d_in): A's bf16 halves (bf16 path)
  __nv_bfloat16* bs;    // (KPAD, d_out): [hi(B); lo(B); hi(B); 0] (bf16 path)
  int nb, L, d_in, d_out, M;
  int rank;             // the true rank (<= R: the ranks past it are zero)
  int ds;               // the keys' partial sums: ceil(d_in / KEY_DCH)
  float pre_scale, attn_weight;
  int attn_bits, has_post;
  float post[MAXM];
  int kl;               // key positions a row: L, or the whole sequence's
                        // under a ring (ext)
  const float* kmask;   // (nb, kl): where the keys sit (qmask, or the whole
                        // sequence's question mask under a ring)
  const float* ext;     // (nb, kl, R): keys from outside (a ring's gathered
                        // keys; ds is 1), or null
  float* dense;         // (nb, L, R): the key pass alone writes each
                        // question row's keys here (moka_delta_keys), or null
  int dch;              // d_in a key-pass unit sums over
};

__device__ __forceinline__ float bf16_hi(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 2^x by the SFU (ex2.approx, denormal results flushed to zero); -inf
// gives +0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------------- key pass

constexpr int KP_NT = 256;   // threads of a key-pass CTA
constexpr int KP_CTAS = 32;  // key-pass CTAs a batch row, at most
constexpr int KP_RUN = 8;    // question-mask positions a thread counts at once
constexpr int KP_G = 16;     // question tokens a group
constexpr int KEY_DCH = 2048;  // d_in a key-pass unit sums over

// the 16 bytes of x at p (8 bf16 or 4 fp32), kept packed
__device__ __forceinline__ uint4 load16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// element e of a packed 16-byte x slice, as fp32
__device__ __forceinline__ float element(const uint4& v, int e, __nv_bfloat16) {
  const uint32_t w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
  return __uint_as_float(e & 1 ? w & 0xffff0000u : w << 16);
}

__device__ __forceinline__ float element(const uint4& v, int e, float) {
  return __uint_as_float(e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w);
}

// one step of a reduce-scatter over the first C values: lanes O apart
// each keep one half of them (the upper lane the upper half), summed with
// the partner's
template <int C, int O>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[64], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < C / 2; ++i) {
    const float send = up ? v[i] : v[i + C / 2];
    const float keep = up ? v[i + C / 2] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// the sums of 64 values over the lanes of a warp that share lane % Q (Q =
// 1, 2, 4, 8 or 16), scattered: the lane with (lane / Q) = l ends with the
// sums of v[2 Q l .. 2 Q l + 2 Q) in v[0 .. 2 Q)
template <int Q>
__device__ __forceinline__ void warp_reduce_scatter64(float (&v)[64],
                                                      int lane) {
  reduce_scatter_step<64, 16>(v, lane);
  if constexpr (Q < 16) reduce_scatter_step<32, 8>(v, lane);
  if constexpr (Q < 8) reduce_scatter_step<16, 4>(v, lane);
  if constexpr (Q < 4) reduce_scatter_step<8, 2>(v, lane);
  if constexpr (Q < 2) reduce_scatter_step<4, 1>(v, lane);
}

// A's and B's bf16 halves for the bf16 path's two products, spread over
// every CTA of the key pass (a grid-stride loop, two elements a step)
template <int R>
__device__ void split_operands(const Args& a, int kpad) {
  const long nt = static_cast<long>(gridDim.x) * gridDim.y * KP_NT;
  const long first = (static_cast<long>(blockIdx.y) * gridDim.x +
                      blockIdx.x) * KP_NT + threadIdx.x;
  const int hd = a.d_in / 2, ho = a.d_out / 2;
  const long at_pairs = 2L * a.M * R * hd;
  for (long i = first; i < at_pairs; i += nt) {
    const int n = static_cast<int>(i / hd), d = static_cast<int>(i % hd) * 2;
    const int q = n / 2, m = q / R, r = q % R;
    const float* src = a.A + (static_cast<long>(m) * a.d_in + d) * R + r;
    float v0 = src[0], v1 = src[R];
    if (n & 1) {  // lo: what bf16 left of A
      v0 -= bf16_hi(v0);
      v1 -= bf16_hi(v1);
    }
    *reinterpret_cast<__nv_bfloat162*>(a.at + static_cast<long>(n) * a.d_in +
                                       d) = __floats2bfloat162_rn(v0, v1);
  }
  const long bs_pairs = static_cast<long>(kpad) * ho;
  for (long i = first; i < bs_pairs; i += nt) {
    const int k = static_cast<int>(i / ho), o = static_cast<int>(i % ho) * 2;
    float v0 = 0.f, v1 = 0.f;
    if (k < 3 * R) {
      const float* src = a.Bm + static_cast<long>(k % R) * a.d_out + o;
      v0 = src[0];
      v1 = src[1];
      if (k >= R && k < 2 * R) {  // lo(B)
        v0 -= bf16_hi(v0);
        v1 -= bf16_hi(v1);
      }
    }
    *reinterpret_cast<__nv_bfloat162*>(a.bs + static_cast<long>(k) * a.d_out +
                                       o) = __floats2bfloat162_rn(v0, v1);
  }
}

// Grid (CTAs a row, nb).  Each CTA numbers its row's question positions
// j = 0..n_q-1 (each thread counts KP_RUN adjacent positions of the mask,
// one block-wide prefix sum per KP_NT * KP_RUN positions), then takes the
// work units (group of KP_G question tokens, dch-wide chunk of d_in)
// whose index is its own modulo the CTAs a row: no CTA a token, and the
// units spread evenly whatever the span's layout.  A thread owns 16 bytes
// of x a pass (8 bf16 or 4 fp32 of d_in) and four of the r ranks (Q = r / 4
// threads share a slice), so A is read once a unit and a thread keeps
// 16 tokens x 4 fp32 sums; the sums are reduced over the warp by a
// reduce-scatter and over the CTA in shared memory, and a unit writes its
// chunk's partial keys: the main kernel sums the ds chunks as it stages
// them.  With keys from outside (a.ext) the CTAs only copy the question
// rows of them, compacted; with a.dense (the keys alone, one chunk of all
// of d_in) a unit writes its tokens' keys at their positions.
template <typename T, int R>
__global__ void __launch_bounds__(KP_NT)
    question_keys_kernel(const Args a, int kpad) {
  constexpr int Q = R / 4;                 // threads a slice (rank quarters)
  constexpr int VEC = 16 / sizeof(T);      // x elements a slice
  constexpr int DP = KP_NT / Q * VEC;      // d_in a pass
  constexpr int WARPS = KP_NT / 32;
  static_assert(KEY_DCH % DP == 0, "a unit is whole passes");
  extern __shared__ int pos_list[];
  __shared__ int wsum[WARPS];
  __shared__ float red[WARPS][Q][64];
  if (a.at != nullptr) split_operands<R>(a, kpad);
  const int k = blockIdx.x, ctas = gridDim.x, bi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q = tid % Q, sl = tid / Q;  // rank quarter, d slice
  const float* qrow = a.kmask + static_cast<long>(bi) * a.kl;
  int n_q = 0;
  for (int p0 = 0; p0 < a.kl; p0 += KP_NT * KP_RUN) {
    const int pb = p0 + tid * KP_RUN;
    unsigned bits = 0;
#pragma unroll
    for (int e = 0; e < KP_RUN; ++e)
      if (pb + e < a.kl && qrow[pb + e] > 0.f) bits |= 1u << e;
    const int cnt = __popc(bits);
    int inc = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += v;
    }
    if (lane == 31) wsum[warp] = inc;
    __syncthreads();
    int j = n_q + inc - cnt, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      j += w < warp ? wsum[w] : 0;
      total += wsum[w];
    }
#pragma unroll
    for (int e = 0; e < KP_RUN; ++e) {
      if ((bits >> e) & 1) pos_list[j++] = pb + e;  // the row's positions
    }
    n_q += total;
    __syncthreads();
  }
  if (k == 0 && tid == 0 && a.nq != nullptr) a.nq[bi] = n_q;
  if (a.ext != nullptr) {  // keys from outside: their question rows, in order
    for (long e = static_cast<long>(k) * KP_NT + tid;
         e < static_cast<long>(n_q) * R; e += static_cast<long>(ctas) * KP_NT) {
      const int j = static_cast<int>(e / R), r = static_cast<int>(e % R);
      a.keys[(static_cast<long>(bi) * a.kl + j) * R + r] =
          a.ext[(static_cast<long>(bi) * a.kl + pos_list[j]) * R + r];
    }
    return;
  }
  const T* xb = static_cast<const T*>(a.x) + static_cast<long>(bi) * a.L * a.d_in;
  const int units = (n_q + KP_G - 1) / KP_G * a.ds;
  for (int un = k; un < units; un += ctas) {
    const int j0 = un / a.ds * KP_G, c = un % a.ds;
    int xo[KP_G];  // the tokens' x rows, as offsets in the row (-1: none)
#pragma unroll
    for (int u = 0; u < KP_G; ++u)
      xo[u] = j0 + u < n_q ? pos_list[j0 + u] * a.d_in : -1;
    float acc[64];  // token u, rank 4 q + rr at 4 u + rr
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int d = c * a.dch + sl * VEC; d < min(a.d_in, (c + 1) * a.dch);
         d += DP) {
      uint4 xv[KP_G];
#pragma unroll
      for (int u = 0; u < KP_G; ++u)
        xv[u] = xo[u] >= 0 ? load16(xb + xo[u] + d) : make_uint4(0u, 0u, 0u, 0u);
      float4 ar[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        ar[e] = __ldg(reinterpret_cast<const float4*>(
            a.A + static_cast<long>(d + e) * R + 4 * q));
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int u = 0; u < KP_G; ++u) {
          const float xe = element(xv[u], e, T());
          acc[4 * u] = fmaf(xe, ar[e].x, acc[4 * u]);
          acc[4 * u + 1] = fmaf(xe, ar[e].y, acc[4 * u + 1]);
          acc[4 * u + 2] = fmaf(xe, ar[e].z, acc[4 * u + 2]);
          acc[4 * u + 3] = fmaf(xe, ar[e].w, acc[4 * u + 3]);
        }
    }
    warp_reduce_scatter64<Q>(acc, lane);
#pragma unroll
    for (int i = 0; i < 2 * Q; ++i) red[warp][q][2 * Q * (lane / Q) + i] = acc[i];
    __syncthreads();
    for (int e = tid; e < KP_G * R; e += KP_NT) {
      const int u = e / R, r = e % R;
      if (j0 + u >= n_q) break;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += red[w][r / 4][4 * u + r % 4];
      const long row = static_cast<long>(bi) * a.L + pos_list[j0 + u];
      const float wgt = a.masks[row] * a.qmask[row];  // masks[0]: the text stream
      if (a.dense != nullptr)
        a.dense[row * R + r] = s * wgt * a.pre_scale;
      else
        a.keys[((static_cast<long>(bi) * a.ds + c) * a.kl + j0 + u) * R + r] =
            s * wgt * a.pre_scale;
    }
    __syncthreads();
  }
}

// -------------------------------------------------- main kernel, bf16 x

constexpr int TOK = 64;                // tokens an item (one wgmma M)
constexpr int CONSUMERS = 128;         // one consumer warpgroup
constexpr int NT = CONSUMERS + 32;     // and one producer warp
constexpr int BOX = 64 * 128;          // a 64-row box of 128-byte rows
constexpr int MAX_STAGES = 8;
constexpr int B_RING = 36 * 1024;      // the up product's B ring (two
                                       // stages at least)
constexpr int WROWS = 16;              // a consumer warp's rows of a tile
constexpr int WBOX = WROWS * 128;      // its 64 outputs of them, one box

// the down product's passes over an item's x: the fewest (1, 2 or 4) whose
// NP = N / passes columns wgmma takes (<= 256: NP / 2 accumulators a
// thread) and whose ring of two stages fits beside the tail
constexpr int down_passes(int n, int tail) {
  return n <= 256 && 1024 + tail + 2 * (BOX + n * 128) <= SMEM_LIMIT ? 1
         : n <= 512 && n % 16 == 0 &&
                 1024 + tail + 2 * (BOX + n / 2 * 128) <= SMEM_LIMIT ? 2
                                                                      : 4;
}

template <int R, int M>
struct Cfg {
  static constexpr int MR = M * R;
  static constexpr int N = 2 * MR;                    // down-product columns
  static constexpr int KPAD = 16 * ((3 * R + 15) / 16);  // up-product depth
  static constexpr int BOXES = R <= 16 ? 2 : 1;       // 64-output boxes a chunk
  static constexpr int CHUNK = 64 * BOXES;            // outputs a chunk
  static constexpr int B_BYTES = BOXES * KPAD * 128;  // a chunk of B's rows
  static constexpr int B_STAGES =                     // 8 at r 4, 4 at 8, 3
      B_RING / B_BYTES < 2 ? 2                        // at 16 and 32, 2 at 64
      : B_RING / B_BYTES < 8 ? B_RING / B_BYTES : 8;
  static constexpr int OUT_BUFS = R <= 32 ? 4 : 2;    // staging tiles a warp
  static constexpr int OUT_BYTES = BOXES * WBOX;      // a warp's 16 x CHUNK outputs
  static constexpr int KCAP = (R <= 32 ? 4096 : 2048) / R;  // keys staged at once
  // shared memory after the ring: B ring, staging, then fp32 arrays
  static constexpr int OFF_B = 0;
  static constexpr int OFF_OUT = OFF_B + B_STAGES * B_BYTES;
  static constexpr int OFF_QRY =                  // [M][TOK][R]: the attention
      OFF_OUT + CONSUMERS / 32 * OUT_BUFS * OUT_BYTES;  // streams' queries
  static constexpr int OFF_BUF = OFF_QRY + M * TOK * R * 4;     // [TOK][R]
  static constexpr int OFF_MK = OFF_BUF + TOK * R * 4;      // [MAXM][TOK]
  static constexpr int OFF_TS = OFF_MK + MAXM * TOK * 4;    // [TOK]
  static constexpr int OFF_KEYS = OFF_TS + TOK * 4;         // [KCAP][R]
  static constexpr int OFF_BARS = OFF_KEYS + KCAP * R * 4;
  static constexpr int TAIL = OFF_BARS + 8 * (2 * MAX_STAGES + 2 * B_STAGES);
  static constexpr int PASSES = down_passes(N, TAIL);
  static constexpr int NP = N / PASSES;               // columns a pass
  static constexpr int STAGE = BOX + NP * 128;        // x box + A's 64 rows
  static_assert(NP <= 256 && NP % 8 == 0, "a pass is one wgmma wide");
  static_assert(1024 + TAIL + 2 * STAGE <= SMEM_LIMIT, "two stages fit");
};

struct Shape {
  int stages;   // x ring depth
  int tiles;    // token tiles a row
  int items;    // nb * tiles
  int kb;       // 64-wide blocks of d_in
  int chunks;   // CHUNK-wide blocks of d_out
};

template <int R, int M>
__global__ void __launch_bounds__(NT, 1)
    moka_delta_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_at,
                      const __grid_constant__ CUtensorMap tm_b,
                      const __grid_constant__ CUtensorMap tm_out,
                      const Args a, const Shape sh) {
  using C = Cfg<R, M>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(sm);
  uint8_t* tail = sm + sh.stages * C::STAGE;
  const uint32_t tbase = smem_addr(tail);
  float* qry = reinterpret_cast<float*>(tail + C::OFF_QRY);
  float* buf = reinterpret_cast<float*>(tail + C::OFF_BUF);
  float* mk = reinterpret_cast<float*>(tail + C::OFF_MK);
  float* ts = reinterpret_cast<float*>(tail + C::OFF_TS);
  float* ks = reinterpret_cast<float*>(tail + C::OFF_KEYS);
  const uint32_t full = tbase + C::OFF_BARS, empty = full + 8 * MAX_STAGES;
  const uint32_t bfull = empty + 8 * MAX_STAGES, bempty = bfull + 8 * C::B_STAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    for (int s = 0; s < MAX_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    for (int s = 0; s < C::B_STAGES; ++s) {
      mbar_init(bfull + 8 * s, 1);
      mbar_init(bempty + 8 * s, CONSUMERS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int i0 = static_cast<int>(static_cast<long>(blockIdx.x) * sh.items / gridDim.x);
  const int i1 = static_cast<int>(static_cast<long>(blockIdx.x + 1) * sh.items / gridDim.x);

  if (warp == CONSUMERS / 32) {  // the producer
    if (lane == 0) {
      const uint64_t first = l2_evict_first(), last = l2_evict_last();
      int it = 0, jt = 0;
      for (int item = i0; item < i1; ++item) {
        const int bi = item / sh.tiles, t0 = (item % sh.tiles) * TOK;
        for (int pass = 0; pass < C::PASSES; ++pass) {
          for (int kb = 0; kb < sh.kb; ++kb, ++it) {
            const int s = it % sh.stages;
            if (it >= sh.stages)
              mbar_wait(empty + 8 * s, ((it / sh.stages) - 1) & 1);
            mbar_arrive_expect_tx(full + 8 * s, C::STAGE);
            tma_load_4d(ring + s * C::STAGE, &tm_x, full + 8 * s, 64 * kb, t0,
                        bi, 0, first);
            tma_load_4d(ring + s * C::STAGE + BOX, &tm_at, full + 8 * s,
                        64 * kb, pass * C::NP, 0, 0, last);
          }
        }
        for (int ch = 0; ch < sh.chunks; ++ch, ++jt) {
          const int s = jt % C::B_STAGES;
          if (jt >= C::B_STAGES)
            mbar_wait(bempty + 8 * s, ((jt / C::B_STAGES) - 1) & 1);
          // a box wholly past d_out is not loaded (its products are
          // clipped by the store)
          const int boxes =
              C::BOXES == 2 && C::CHUNK * ch + 64 < a.d_out ? 2 : 1;
          mbar_arrive_expect_tx(bfull + 8 * s, boxes * C::KPAD * 128);
          for (int q = 0; q < boxes; ++q)
            tma_load_4d(tbase + C::OFF_B + s * C::B_BYTES + q * C::KPAD * 128,
                        &tm_b, bfull + 8 * s, C::CHUNK * ch + 64 * q, 0, 0, 0,
                        last);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: thread tid holds rows r0 and r0 + 8 of every
  // wgmma fragment, columns 2 * qd (+1) of each group of 8
  const int r0 = 16 * warp + lane / 4, qd = lane % 4;
  // the true rank's scale (the ranks past it are zero columns)
  const float qk_scale = LOG2E / sqrtf(static_cast<float>(a.rank));
  int amods[MAXM], stream_of[MAXM], na = 0;
  for (int m = 0; m < MAXM; ++m) stream_of[m] = -1;
  for (int m = 0; m < M; ++m)
    if ((a.attn_bits >> m) & 1) {
      stream_of[m] = na;
      amods[na++] = m;
    }
  int it = 0, jt = 0, key_row = -1;
  for (int item = i0; item < i1; ++item) {
    const int bi = item / sh.tiles, t0 = (item % sh.tiles) * TOK;
    named_bar_sync(1, CONSUMERS);  // the last item's arrays are read
    for (int i = tid; i < M * TOK; i += CONSUMERS) {
      const int m = i / TOK, t = i % TOK;
      mk[m * TOK + t] = t0 + t < a.L
          ? a.masks[(static_cast<long>(m) * a.nb + bi) * a.L + t0 + t] : 0.f;
    }

    // ---- a_i = x @ A_i on the tensor cores, hi and lo columns side by
    // side, NP of the N columns a pass over x
#pragma unroll
    for (int pass = 0; pass < C::PASSES; ++pass) {
      float acc[C::NP / 2];
#pragma unroll
      for (int i = 0; i < C::NP / 2; ++i) acc[i] = 0.f;
      fence_operand(acc);
      for (int kb = 0; kb < sh.kb; ++kb, ++it) {
        const int s = it % sh.stages;
        mbar_wait(full + 8 * s, (it / sh.stages) & 1);
        const uint32_t xs = ring + s * C::STAGE;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64nN_ss<C::NP>(acc, desc_sw128(xs + 32 * kk),
                                desc_sw128(xs + BOX + 32 * kk), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the last stage's products are done
        if (kb > 0 && lane == 0)
          mbar_arrive(empty + 8 * ((it - 1) % sh.stages));
      }
      wgmma_wait<0>();
      fence_operand(acc);
      if (lane == 0) mbar_arrive(empty + 8 * ((it - 1) % sh.stages));
      if (pass == 0) named_bar_sync(1, CONSUMERS);  // mk written
      // the pass's ranks q (modality q / R, rank q % R): a thread holds
      // ranks q = qd mod 4 of its rows in every pass, so it sums the
      // modalities into buf alone; an attention stream's a_i is also its
      // query
#pragma unroll
      for (int j = 0; j < C::NP / 8; ++j) {
        const int q4 = pass * (C::NP / 2) + 4 * j;  // known when unrolled
        const int m = q4 / R, r = q4 % R + qd;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = r0 + 8 * u;
          const float v = (acc[4 * j + 2 * u] + acc[4 * j + 2 * u + 1]) *
                          mk[m * TOK + t] * a.pre_scale;
          buf[t * R + r] = m == 0 ? v : buf[t * R + r] + v;
          if (stream_of[m] >= 0) qry[(stream_of[m] * TOK + t) * R + r] = v;
        }
      }
    }
    if (tid < TOK) {
      float p = 1.f;
      if (a.has_post) {
        p = 0.f;
        for (int m = 0; m < M; ++m) p += mk[m * TOK + tid] * a.post[m];
      }
      ts[tid] = p;
    }
    named_bar_sync(1, CONSUMERS);  // buf and the queries written

    // ---- rank-space attention over the row's n_q question keys: two
    // threads a token, each walking every other key with an online softmax
    // in exp2 for each attention stream the token belongs to (mostly one),
    // merged by a shuffle and added into the token's buf row
    const int n_q = na > 0 ? a.nq[bi] : 0;
    const float* krow = a.keys + static_cast<long>(bi) * a.ds * a.kl * R;
    const int at = tid >> 1, half = tid & 1;
    for (int jm = 0; jm < na; ++jm) {
      const float w = mk[amods[jm] * TOK + at];
      const bool live = w != 0.f;
      float qv[R], oa[R], om = -INFINITY, ol = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        qv[r] = live ? qry[(jm * TOK + at) * R + r] * qk_scale : 0.f;
        oa[r] = 0.f;
      }
      for (int c0 = 0; c0 < n_q; c0 += C::KCAP) {
        const int cn = min(C::KCAP, n_q - c0);
        if (key_row != bi || n_q > C::KCAP) {
          named_bar_sync(1, CONSUMERS);  // the staged keys are read
          // the keys are the sums of the key pass's ds partial sums
          for (int i = tid; i < cn * R / 4; i += CONSUMERS) {
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int c = 0; c < a.ds; ++c) {
              const float4 p = reinterpret_cast<const float4*>(
                  krow + (static_cast<long>(c) * a.kl + c0) * R)[i];
              v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
            }
            reinterpret_cast<float4*>(ks)[i] = v;
          }
          named_bar_sync(1, CONSUMERS);
          key_row = n_q > C::KCAP ? -1 : bi;
        }
        if (live) {
          for (int kq = half; kq < cn; kq += 2) {
            float kv[R];
#pragma unroll
            for (int r4 = 0; r4 < R / 4; ++r4) {
              const float4 v = reinterpret_cast<const float4*>(ks + kq * R)[r4];
              kv[4 * r4] = v.x; kv[4 * r4 + 1] = v.y; kv[4 * r4 + 2] = v.z; kv[4 * r4 + 3] = v.w;
            }
            float sc = 0.f;
#pragma unroll
            for (int r = 0; r < R; ++r) sc = fmaf(qv[r], kv[r], sc);
            const float mn = fmaxf(om, sc);
            const float corr = exp2_approx(om - mn), pe = exp2_approx(sc - mn);
            ol = fmaf(ol, corr, pe);
#pragma unroll
            for (int r = 0; r < R; ++r) oa[r] = fmaf(pe, kv[r], oa[r] * corr);
            om = mn;
          }
        }
      }
      // merge the two halves (adjacent lanes)
      const float om2 = __shfl_xor_sync(0xffffffffu, om, 1);
      const float ol2 = __shfl_xor_sync(0xffffffffu, ol, 1);
      const float mx = fmaxf(om, om2);
      const float s1 = om == -INFINITY ? 0.f : exp2_approx(om - mx);
      const float s2 = om2 == -INFINITY ? 0.f : exp2_approx(om2 - mx);
      const float l = ol * s1 + ol2 * s2;
      const bool add = half == 0 && live && l > 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float o = oa[r] * s1 + __shfl_xor_sync(0xffffffffu, oa[r], 1) * s2;
        if (add) buf[at * R + r] += w * (a.attn_weight * (o / l));
      }
    }
    named_bar_sync(1, CONSUMERS);  // buf complete

    // ---- delta = buf @ B: A fragments [hi(buf), hi(buf), lo(buf)] (K-major
    // columns 2qd, 2qd + 1, +8, +9 of each 16), rows r0 and r0 + 8
    uint32_t af[C::KPAD / 16][4];
#pragma unroll
    for (int kk = 0; kk < C::KPAD / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + 8 * (e & 1);
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kc = 16 * kk + 2 * qd + 8 * (e >> 1) + h;
          const float b = kc < 3 * R ? buf[t * R + kc % R] : 0.f;
          v[h] = kc < 2 * R ? b : b - bf16_hi(b);
        }
        af[kk][e] = pack_bf16(v[0], v[1]);
      }
    const float tsr[2] = {ts[r0], ts[r0 + 8]};
    float dacc[C::BOXES][32];  // each chunk's first products overwrite it
    for (int ch = 0; ch < sh.chunks; ++ch, ++jt) {
      const int s = jt % C::B_STAGES;
      mbar_wait(bfull + 8 * s, (jt / C::B_STAGES) & 1);
      const uint32_t bb = tbase + C::OFF_B + s * C::B_BYTES;
#pragma unroll
      for (int n = 0; n < C::BOXES; ++n) fence_operand(dacc[n]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::KPAD / 16; ++kk)
#pragma unroll
        for (int n = 0; n < C::BOXES; ++n)
          wgmma_m64n64_rs<1>(dacc[n], af[kk],
                             desc_sw128(bb + n * C::KPAD * 128 + kk * 2048),
                             kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int n = 0; n < C::BOXES; ++n) fence_operand(dacc[n]);
      if (lane == 0) mbar_arrive(bempty + 8 * s);
      // each warp stages its 16 rows of the chunk as bf16 in the
      // 128-byte-swizzled layout its output boxes read (row t's 16-byte
      // chunk j at j ^ (t % 8)) and stores them by TMA itself: no barrier
      // across the warpgroup, OUT_BUFS chunks in flight a warp
      uint8_t* stage = tail + C::OFF_OUT +
                       (warp * C::OUT_BUFS + jt % C::OUT_BUFS) * C::OUT_BYTES;
      if (lane == 0) bulk_wait_read<C::OUT_BUFS - 1>();  // this tile's last store
      __syncwarp();
#pragma unroll
      for (int n = 0; n < C::BOXES; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int t = lane / 4 + 8 * u;  // the row within the warp's 16
            *reinterpret_cast<uint32_t*>(stage + n * WBOX + t * 128 +
                                         ((j ^ (t & 7)) << 4) + 4 * qd) =
                pack_bf16(dacc[n][4 * j + 2 * u] * tsr[u],
                          dacc[n][4 * j + 2 * u + 1] * tsr[u]);
          }
      fence_proxy_async_smem();
      __syncwarp();
      if (lane == 0) {
        const uint64_t first = l2_evict_first();
        const uint32_t src = smem_addr(stage);
        const int row = t0 + WROWS * warp;
        tma_store_4d(&tm_out, src, C::CHUNK * ch, row, bi, 0, first);
        if (C::BOXES == 2 && C::CHUNK * ch + 64 < a.d_out)
          tma_store_4d(&tm_out, src + WBOX, C::CHUNK * ch + 64, row, bi, 0,
                       first);
        bulk_commit();
      }
    }
  }
  if (lane == 0) bulk_wait_read<0>();  // the staging tiles are read: exit
}

// ---------------------------------------------------- main kernel, fp32 x

namespace f32 {

constexpr int NT = 256;         // threads per CTA
constexpr int TOK = 32;         // tokens per CTA
constexpr int J = NT / TOK;     // threads per token in the d_in reduction
constexpr int VEC = 8;          // x elements per thread per slice
constexpr int DC = J * VEC;     // d_in covered by one slice of every thread

// the shared-memory layout of the rank-R instance, in floats
template <int R>
struct Lay {
  static constexpr int RS = R < 16 ? R : 16;  // ranks of a down-product slice
  static constexpr int UNROLL = 16 / RS;      // slices per thread per chunk
  static constexpr int AS = VEC * RS + 4;     // padded floats a (modality, lane)
  static constexpr int KC = 512 / R;          // keys staged at once
  static constexpr int OFF_MK = MAXM * UNROLL * J * AS;  // after A's chunk
  static constexpr int OFF_ABUF = OFF_MK + MAXM * TOK;   // [TOK][MAXM][R]
  static constexpr int OFF_ATT = OFF_ABUF + TOK * MAXM * R;
  static constexpr int OFF_BUF = OFF_ATT + TOK * MAXM * R;   // [TOK][R]
  static constexpr int OFF_TS = OFF_BUF + TOK * R;
  static constexpr int OFF_KBUF = OFF_TS + TOK;              // [KC][R]
  static constexpr int BYTES = 4 * (OFF_KBUF + KC * R);
};

// 32 tokens of one batch row a CTA: each token's d_in reduction split over
// 8 adjacent lanes, A streamed through shared memory in chunks of
// UNROLL * DC rows of d_in (padded so the 8 lanes read distinct banks) and
// slices of 16 ranks (one at r <= 16; x is read again for each further
// slice), then the attention over the row's compacted keys (KC at a time,
// 4 lanes a (token, modality) pair) and B read per output column pair
// from L2
template <int R>
__global__ void __launch_bounds__(NT)
    moka_delta_kernel_f32(const Args a) {
  using Y = Lay<R>;
  constexpr int RS = Y::RS, UNROLL = Y::UNROLL, AS = Y::AS, KC = Y::KC;
  constexpr int DCE = UNROLL * DC;      // d_in per staged chunk of A
  constexpr int SPLIT = 4;              // lanes a (token, modality) pair
  extern __shared__ __align__(16) float fsm[];
  float* as = fsm;
  float (*mk)[TOK] = reinterpret_cast<float (*)[TOK]>(fsm + Y::OFF_MK);
  float (*abuf)[MAXM][R] =
      reinterpret_cast<float (*)[MAXM][R]>(fsm + Y::OFF_ABUF);
  float (*att)[MAXM][R] =
      reinterpret_cast<float (*)[MAXM][R]>(fsm + Y::OFF_ATT);
  float (*buf)[R] = reinterpret_cast<float (*)[R]>(fsm + Y::OFF_BUF);
  float* tscale = fsm + Y::OFF_TS;
  float (*kbuf)[R] = reinterpret_cast<float (*)[R]>(fsm + Y::OFF_KBUF);

  const float* x = static_cast<const float*>(a.x);
  const int bi = blockIdx.y, t0 = blockIdx.x * TOK, tid = threadIdx.x;
  const int tt = tid / J, jj = tid % J, l = t0 + tt, L = a.L, M = a.M;
  const bool live = l < L;

  for (int i = tid; i < M * TOK; i += NT) {
    const int m = i / TOK, t = i % TOK;
    mk[m][t] = t0 + t < L ? a.masks[(static_cast<long>(m) * a.nb + bi) * L + t0 + t] : 0.f;
  }

  const float* xrow = x + (static_cast<long>(bi) * L + (live ? l : 0)) * a.d_in;
  constexpr int F4 = DCE * RS / 4;  // float4s of A per modality and chunk
  for (int rs = 0; rs < R; rs += RS) {
    float acc[MAXM][RS];
#pragma unroll
    for (int m = 0; m < MAXM; ++m)
#pragma unroll
      for (int r = 0; r < RS; ++r) acc[m][r] = 0.f;
    for (int d0 = 0; d0 < a.d_in; d0 += DCE) {
      __syncthreads();  // previous chunk consumed
      for (int f = tid; f < M * F4; f += NT) {
        const int m = f / F4, rem = f % F4;
        const int d = rem * 4 / RS, rr = (rem * 4) % RS;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (d0 + d < a.d_in)
          val = *reinterpret_cast<const float4*>(
              a.A + (static_cast<long>(m) * a.d_in + d0 + d) * R + rs + rr);
        const int u = d / DC, jg = (d % DC) / VEC, e = d % VEC;
        *reinterpret_cast<float4*>(&as[((m * UNROLL + u) * J + jg) * AS + e * RS + rr]) = val;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int dx = d0 + u * DC + jj * VEC;
        float xv[VEC];
        if (live && dx < a.d_in) {
          const float4 p = reinterpret_cast<const float4*>(xrow + dx)[0];
          const float4 q = reinterpret_cast<const float4*>(xrow + dx)[1];
          xv[0] = p.x; xv[1] = p.y; xv[2] = p.z; xv[3] = p.w;
          xv[4] = q.x; xv[5] = q.y; xv[6] = q.z; xv[7] = q.w;
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) xv[e] = 0.f;
        }
#pragma unroll
        for (int m = 0; m < MAXM; ++m) {
          if (m < M) {
            const float* ap = &as[((m * UNROLL + u) * J + jj) * AS];
#pragma unroll
            for (int e = 0; e < VEC; ++e)
#pragma unroll
              for (int r = 0; r < RS; ++r) acc[m][r] += xv[e] * ap[e * RS + r];
          }
        }
      }
    }
    // the J lanes of a token are adjacent: combine their partial sums
#pragma unroll
    for (int m = 0; m < MAXM; ++m)
#pragma unroll
      for (int r = 0; r < RS; ++r)
#pragma unroll
        for (int off = 1; off < J; off <<= 1)
          acc[m][r] += __shfl_xor_sync(0xffffffffu, acc[m][r], off);
    if (jj == 0) {
#pragma unroll
      for (int m = 0; m < MAXM; ++m)
        if (m < M)
#pragma unroll
          for (int r = 0; r < RS; ++r)
            abuf[tt][m][rs + r] = acc[m][r] * mk[m][tt] * a.pre_scale;
    }
  }
  __syncthreads();

  // ---- rank-space attention over the row's compacted question keys
  int amods[MAXM];
  int na = 0;
  for (int m = 0; m < M; ++m)
    if ((a.attn_bits >> m) & 1) amods[na++] = m;
  // the true rank's scale (the ranks past it are zero columns)
  const float inv_sqrt_r = 1.0f / sqrtf(static_cast<float>(a.rank));
  const int n_q = a.nq[bi];
  const float* krow = a.keys + static_cast<long>(bi) * a.ds * a.kl * R;
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
    for (int k0 = 0; k0 < n_q; k0 += KC) {
      const int kend = min(KC, n_q - k0);
      __syncthreads();
      for (int i = tid; i < kend * R; i += NT) {  // the ds partial sums
        float v = 0.f;
        for (int c = 0; c < a.ds; ++c)
          v += krow[(static_cast<long>(c) * a.kl + k0) * R + i];
        kbuf[i / R][i % R] = v;
      }
      __syncthreads();
      if (worker) {
        for (int kk = sub; kk < kend; kk += SPLIT) {
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
  for (int i = tid; i < TOK * R; i += NT) {
    const int t = i / R, r = i % R;
    float bv = 0.f;
    int ai = 0;
    for (int m = 0; m < M; ++m) {
      bv += abuf[t][m][r];
      if ((a.attn_bits >> m) & 1) {
        bv += mk[m][t] * (a.attn_weight * att[t][ai][r]);
        ++ai;
      }
    }
    buf[t][r] = bv;
  }
  if (tid < TOK) {
    float ps = 1.f;
    if (a.has_post) {
      ps = 0.f;
      for (int m = 0; m < M; ++m) ps += mk[m][tid] * a.post[m];
    }
    tscale[tid] = ps;
  }
  __syncthreads();

  // ---- delta = buf @ B, two adjacent output columns per thread
  float* out = static_cast<float*>(a.out);
  const int ntok = min(TOK, L - t0);
  for (int o = 2 * tid; o < a.d_out; o += 2 * NT) {
    float b0[R], b1[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 bb = *reinterpret_cast<const float2*>(a.Bm + static_cast<long>(r) * a.d_out + o);
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
      *reinterpret_cast<float2*>(out + (static_cast<long>(bi) * L + t0 + t) * a.d_out + o) =
          make_float2(s0 * tscale[t], s1 * tscale[t]);
    }
  }
}

}  // namespace f32

template <typename T, int R>
int launch_keys(const Args& a, int kpad, cudaStream_t st) {
  // int row offsets; the row's question positions in shared memory, beside
  // the static arrays of the reduction (8 KB at r 16, 32 KB at 64)
  constexpr int STATIC_BYTES = (KP_NT / 32) * (R / 4) * 64 * 4 + 4 * (KP_NT / 32);
  constexpr int LIST_LIMIT = SMEM_LIMIT - STATIC_BYTES - 8192;
  const long list = 4L * a.kl;
  if (static_cast<long>(a.L) * a.d_in >= (1L << 31) || list > LIST_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  // CTAs an SM, asked once (a launch inside a CUDA graph capture makes no
  // other CUDA call): the grid is one wave, at most KP_CTAS a row
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t attr = cudaFuncSetAttribute(
        question_keys_kernel<T, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, LIST_LIMIT);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, question_keys_kernel<T, R>, KP_NT, 0);
    if (occ != cudaSuccess) return static_cast<int>(occ);
    per_sm = per_sm > 0 ? per_sm : 1;
  }
  const int units = (a.kl + KP_G - 1) / KP_G * a.ds;  // at most
  int ctas = sm_count() * per_sm / a.nb;
  ctas = ctas < KP_CTAS ? ctas : KP_CTAS;
  ctas = ctas < units ? ctas : units;
  ctas = ctas > 0 ? ctas : 1;
  question_keys_kernel<T, R><<<dim3(ctas, a.nb), KP_NT, list, st>>>(a, kpad);
  return static_cast<int>(cudaGetLastError());
}

template <int R, int M>
int launch_bf16(const Args& a, cudaStream_t st) {
  using C = Cfg<R, M>;
  const int err = launch_keys<__nv_bfloat16, R>(a, C::KPAD, st);
  if (err != 0) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      moka_delta_kernel<R, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_LIMIT);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  Shape sh;
  sh.stages = (SMEM_LIMIT - 1024 - C::TAIL) / C::STAGE;
  sh.stages = sh.stages < MAX_STAGES ? sh.stages : MAX_STAGES;
  if (sh.stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 1024 + sh.stages * C::STAGE + C::TAIL;
  sh.tiles = (a.L + TOK - 1) / TOK;
  const long items = static_cast<long>(a.nb) * sh.tiles;
  if (items >= (1L << 31) / 2) return static_cast<int>(cudaErrorInvalidValue);
  sh.items = static_cast<int>(items);
  sh.kb = (a.d_in + 63) / 64;
  sh.chunks = (a.d_out + C::CHUNK - 1) / C::CHUNK;
  // x and delta over (d, L, nb), in boxes of 64 columns x 64 tokens (x)
  // and x 16 tokens (delta, a warp's rows; a ragged L is zero-filled by the
  // loads and clipped by the stores); A's halves over (d_in, N), NP rows a
  // box (a pass's), and B's over (d_out, KPAD), one box a chunk's 64
  // outputs
  CUtensorMap tm_x, tm_at, tm_b, tm_out;
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t x_dims[4] = {uint64_t(a.d_in), uint64_t(a.L), uint64_t(a.nb), 1};
  const uint64_t o_dims[4] = {uint64_t(a.d_out), uint64_t(a.L), uint64_t(a.nb), 1};
  const uint64_t at_dims[4] = {uint64_t(a.d_in), uint64_t(C::N), 1, 1};
  const uint64_t b_dims[4] = {uint64_t(a.d_out), uint64_t(C::KPAD), 1, 1};
  const uint32_t tok_box[4] = {64, TOK, 1, 1};
  const uint32_t out_box[4] = {64, WROWS, 1, 1};
  const uint32_t at_box[4] = {64, uint32_t(C::NP), 1, 1};
  const uint32_t b_box[4] = {64, uint32_t(C::KPAD), 1, 1};
  if (!swizzled_map(&tm_x, bf16, 2, 4, a.x, x_dims, tok_box) ||
      !swizzled_map(&tm_out, bf16, 2, 4, a.out, o_dims, out_box) ||
      !swizzled_map(&tm_at, bf16, 2, 4, a.at, at_dims, at_box) ||
      !swizzled_map(&tm_b, bf16, 2, 4, a.bs, b_dims, b_box))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = sh.items < sm_count() ? sh.items : sm_count();
  moka_delta_kernel<R, M><<<grid, NT, smem, st>>>(tm_x, tm_at, tm_b, tm_out,
                                                   a, sh);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch_f32(const Args& a, cudaStream_t st) {
  const int err = launch_keys<float, R>(a, 0, st);
  if (err != 0) return err;
  constexpr int smem = f32::Lay<R>::BYTES;
  static const cudaError_t attr = cudaFuncSetAttribute(
      f32::moka_delta_kernel_f32<R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.L + f32::TOK - 1) / f32::TOK, a.nb);
  f32::moka_delta_kernel_f32<R><<<grid, f32::NT, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int launch(const Args& a, int x_bf16, cudaStream_t st) {
  if (!x_bf16) return launch_f32<R>(a, st);
  switch (a.M) {
    case 1: return launch_bf16<R, 1>(a, st);
    case 2: return launch_bf16<R, 2>(a, st);
    case 3: return launch_bf16<R, 3>(a, st);
    default: return launch_bf16<R, 4>(a, st);
  }
}

long align256(long n) { return (n + 255) / 256 * 256; }

// the workspace's parts: keys (nb, ds, kl, R) fp32 (ds 1 for keys from
// outside), n_q (nb) int32 and, for bf16 x, A's halves (2*M*R, d_in) and
// B's rows (KPAD, d_out) bf16
long workspace(int nb, int kl, int d_in, int d_out, int M, int R, int x_bf16,
               int ext, long* off) {
  const int ds = ext ? 1 : (d_in + KEY_DCH - 1) / KEY_DCH;
  off[0] = 0;
  off[1] = off[0] + align256(4L * nb * ds * kl * R);
  off[2] = off[1] + align256(4L * nb);
  if (!x_bf16) return off[2];
  off[3] = off[2] + align256(2L * 2 * M * R * d_in);
  return off[3] + align256(2L * 16 * ((3 * R + 15) / 16) * d_out);
}

// the built ranks R: 4, 8, 16, 32 and 64; a true rank r <= R runs in the
// rank-R instance with A's columns and B's rows past r zero (the wrapper
// pads them), which changes nothing: a zero column of A gives zero ranks
// of a_i and of the keys, so zero terms in every score, zero attention
// output ranks, and zero rows of B meet them
bool takes(int nb, int L, int d_in, int d_out, int M, int R) {
  return nb > 0 && L > 0 && M > 0 && M <= MAXM && d_in % 8 == 0 &&
         d_out % 8 == 0 &&
         (R == 4 || R == 8 || R == 16 || R == 32 || R == 64);
}

// ------------------------------------------------------- the wide path

// Past rank 64 kernel 5 is a chain of launches, with rp = r padded to a
// multiple of 64 (A's columns and B's rows past r zero, the wrapper's):
//   1. the down product: a_i = (x @ A_i) * mask_i * pre_scale for every
//      modality, (M, T, rp) fp32 over the T = nb * L tokens, and the
//      question keys a_0 * qmask, (T, rp);
//   2. R1 (flash_rank.cu, head_dim rp, the scale of the true rank) for
//      each attention stream: its a_i against the keys under the question
//      mask (the whole sequence's under a ring), (na, T, rp);
//   3. the up product: buf = sum_i a_i + sum_j mask_j * attn_weight *
//      attn_j, then delta = (buf @ B) * post, in x's type.
// What bounds it: the products' operations, 2 T (d_in M r + r d_out) at
// the tensor cores' bf16 rate (at rank 512, b 8 x L 896, 1.1 TFLOP a
// layer of seven projections); the bytes of x, A, B and the delta, and
// R1's fp32 attention, are far under that.  For bf16 x both products run
// on the tensor cores (gemm_kernel), each a two-launch entry:
//   * down (moka_delta_wide_down): a small pass (split_kernel) writes A's
//     bf16 halves hi = bf16(A), lo = bf16(A - hi) interleaved column by
//     column, as the persistent kernel's key pass does (2 M rp, d_in);
//     then x (T, d_in) times them: CTAs of 128 tokens x 256 of the 2 M rp
//     columns, a producer warp's TMA ring of four 48 KB stages (x's 128 x
//     64 and the halves' 256 x 64, 128-byte swizzle) and two consumer
//     warpgroups issuing wgmma m64n256k16 (bf16 in, fp32 accumulate); the
//     epilogue sums each column pair's accumulators (|A - hi - lo| <=
//     2^-16 |A|: A stays fp32 in effect), scales by the modality's mask and
//     writes a_i and the keys.  The grid's fastest index walks a token
//     tile's columns, so its x stays in L2 while they are walked;
//   * up (moka_delta_wide_up): a short pass (prep_kernel) forms buf as it
//     reads a_i and R1's outputs and writes its bf16 halves [hi(buf) |
//     lo(buf)] (T, 2 rp) and B's [hi(B); lo(B)] (2 rp, d_out); then the
//     same TMA -> shared memory -> wgmma product over K = 3 rp, the
//     persistent kernel's three-way split [hi(buf), hi(buf), lo(buf)] x
//     [hi(B); lo(B); hi(B)] (the product within 2^-16 of fp32): the
//     producer walks the halves' 64-wide blocks in that order, B taken
//     MN-major (four 64-column boxes a stage).  buf goes through device
//     memory, not registers: past rank 64 its three copies of rp columns
//     would not fit a thread's registers.  Each consumer warpgroup scales
//     its 64 x 256 tile by the token's post scale, rounds it to x's bf16
//     in 128-byte-swizzled staging tiles (the drained ring) and stores
//     them by TMA.
// fp32 x (no main path) keeps exact fp32 FMAs on the ordinary cores
// (moka_wide_kernel: a CTA 64 tokens x 64 columns of the output, a thread
// 4 x 4 of them, the depth walked 16 at a time through shared memory, one
// FMA chain an output, A and B read as given).
namespace wide {

constexpr int NT = 256;
constexpr int TT = 64;  // tokens a CTA
constexpr int TN = 64;  // output columns a CTA
constexpr int TK = 16;  // depth a step

struct Args {
  const float* x;         // (T, d_in) fp32 (down, fp32 x)
  const float* A;         // (M, d_in, rp) (down)
  const float* masks;     // (M, T)
  const float* qmask;     // (T) (down)
  float* a_all;           // (M, T, rp): written (down), read (up)
  float* keys;            // (T, rp) (down)
  const float* attn;      // (na, T, rp) (up)
  const float* Bm;        // (rp, d_out) (up)
  void* out;              // (T, d_out) in x's type (up)
  int T, d_in, d_out, M, rp;
  float pre_scale, attn_weight;
  int attn_bits, has_post;
  float post[MAXM];
};

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// the modalities attending (attn_bits), in order
__device__ __forceinline__ int attending(const Args& w, int (&amods)[MAXM]) {
  int na = 0;
  for (int m = 0; m < w.M; ++m)
    if ((w.attn_bits >> m) & 1) amods[na++] = m;
  return na;
}

// fp32 x.  Grid (output columns / 64, T / 64).  UP false: X = x, W = A_m
// with m the modality of the CTA's 64 columns (rp is a multiple of 64); UP
// true: X = buf (formed from a_all, attn and the masks as it is loaded),
// W = B.
template <bool UP>
__global__ void __launch_bounds__(NT) moka_wide_kernel(const Args w) {
  __shared__ __align__(16) float xs[TK][TT + 4];  // X's tile, k-major
  __shared__ __align__(16) float ws[TK][TN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int t0 = blockIdx.y * TT, n0 = blockIdx.x * TN;
  const int K = UP ? w.rp : w.d_in;
  // the loads: X's token lt, depth quad lk; W's depth row wk, column quad wn
  const int lt = tid >> 2, lk = (tid & 3) * 4, wk = tid >> 4, wn = (tid & 15) * 4;
  const int xt = t0 + lt;
  const int mw = UP ? 0 : n0 / w.rp, rw = UP ? 0 : n0 - mw * w.rp;
  int amods[MAXM];
  const int na = attending(w, amods);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += TK) {
    float xv[4] = {0.f, 0.f, 0.f, 0.f};
    if (xt < w.T && k0 + lk < K) {
      if (UP) {
        const long at = static_cast<long>(xt) * w.rp + k0 + lk;
        load4(w.a_all + at, xv);
        for (int m = 1; m < w.M; ++m) {
          float v[4];
          load4(w.a_all + static_cast<long>(m) * w.T * w.rp + at, v);
#pragma unroll
          for (int e = 0; e < 4; ++e) xv[e] += v[e];
        }
        for (int j = 0; j < na; ++j) {
          const float mk = w.masks[static_cast<long>(amods[j]) * w.T + xt];
          float v[4];
          load4(w.attn + static_cast<long>(j) * w.T * w.rp + at, v);
#pragma unroll
          for (int e = 0; e < 4; ++e) xv[e] += mk * (w.attn_weight * v[e]);
        }
      } else {
        load4(w.x + static_cast<long>(xt) * w.d_in + k0 + lk, xv);
      }
    }
    float wv[4] = {0.f, 0.f, 0.f, 0.f};
    if (k0 + wk < K) {
      if (UP) {
        if (n0 + wn < w.d_out)
          load4(w.Bm + static_cast<long>(k0 + wk) * w.d_out + n0 + wn, wv);
      } else {
        load4(w.A + (static_cast<long>(mw) * w.d_in + k0 + wk) * w.rp + rw + wn,
              wv);
      }
    }
    __syncthreads();  // the last step's tiles are read
#pragma unroll
    for (int e = 0; e < 4; ++e) xs[lk + e][lt] = xv[e];
    store4(&ws[wk][wn], wv);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
      load4(&xs[kk][4 * ty], a);
      load4(&ws[kk][4 * tx], b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + 4 * ty + i;
    if (t >= w.T) continue;
    float v[4];
    if (UP) {
      const int o = n0 + 4 * tx;
      if (o >= w.d_out) continue;
      float ts = 1.f;
      if (w.has_post) {
        ts = 0.f;
        for (int m = 0; m < w.M; ++m)
          ts += w.masks[static_cast<long>(m) * w.T + t] * w.post[m];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = acc[i][j] * ts;
      store4(static_cast<float*>(w.out) + static_cast<long>(t) * w.d_out + o, v);
    } else {
      const float mk = w.masks[static_cast<long>(mw) * w.T + t];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = acc[i][j] * mk * w.pre_scale;
      const int r = rw + 4 * tx;
      store4(w.a_all + (static_cast<long>(mw) * w.T + t) * w.rp + r, v);
      if (mw == 0) {
        const float qm = w.qmask[t];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] *= qm;
        store4(w.keys + static_cast<long>(t) * w.rp + r, v);
      }
    }
  }
}

template <bool UP>
int launch(const Args& w, cudaStream_t st) {
  const int cols = UP ? (w.d_out + TN - 1) / TN : w.M * w.rp / TN;
  const int rows = (w.T + TT - 1) / TT;
  if (rows > 65535) return static_cast<int>(cudaErrorInvalidValue);
  moka_wide_kernel<UP><<<dim3(cols, rows), NT, 0, st>>>(w);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 x: the products on the tensor cores

constexpr int GM = 128;                 // tokens a CTA: two warpgroups of 64
constexpr int GN = 256;                 // output columns a CTA
constexpr int GCONS = 256;              // consumer threads
constexpr int GNT = GCONS + 32;         // and a producer warp
constexpr int GA = GM * 128;            // a stage's A tile: 128 x 64 bf16
constexpr int GSTAGE = GA + GN * 128;   // and its B tile: 256 x 64
constexpr int GSTAGES = 4;
constexpr int GSMEM = 1024 + GSTAGES * GSTAGE + 16 * GSTAGES;

// A (M, d_in, rp) fp32 -> at (2 M rp, d_in) bf16, row 2 (m rp + r) + h the
// half h (0: hi = bf16(A), 1: lo = bf16(A - hi)) of A's column (m, r); a
// CTA turns a 32 x 32 tile of (d, r) through shared memory, so both the
// reads (along r) and the writes (along d) are coalesced.  Grid (rp / 32,
// d_in / 32, M).
__global__ void __launch_bounds__(256)
    split_kernel(const float* __restrict__ A, __nv_bfloat16* __restrict__ at,
                 int d_in, int rp) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.x * 32, d0 = blockIdx.y * 32, m = blockIdx.z;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int d = d0 + i;
    tile[i][tx] = d < d_in ? A[(static_cast<long>(m) * d_in + d) * rp + r0 + tx]
                           : 0.f;
  }
  __syncthreads();
  const int d = d0 + tx;
  if (d >= d_in) return;
  for (int i = ty; i < 32; i += 8) {
    const float v = tile[tx][i];
    const float hi = bf16_hi(v);
    const long n = 2L * (static_cast<long>(m) * rp + r0 + i);
    at[n * d_in + d] = __float2bfloat16_rn(hi);
    at[(n + 1) * d_in + d] = __float2bfloat16_rn(v - hi);
  }
}

// the up product's operands: bufs (T, 2 rp) = [hi(buf) | lo(buf)] with buf
// = sum_i a_i + sum_j mask_j * attn_weight * attn_j, and bs (2 rp, d_out)
// = [hi(B); lo(B)]; a grid-stride loop, two elements a step
__global__ void __launch_bounds__(256)
    prep_kernel(const Args w, __nv_bfloat16* __restrict__ bufs,
                __nv_bfloat16* __restrict__ bs) {
  const long nt = static_cast<long>(gridDim.x) * 256;
  const long first = static_cast<long>(blockIdx.x) * 256 + threadIdx.x;
  int amods[MAXM];
  const int na = attending(w, amods);
  const int hr = w.rp / 2;
  const long plane = static_cast<long>(w.T) * w.rp;
  for (long i = first; i < static_cast<long>(w.T) * hr; i += nt) {
    const int t = static_cast<int>(i / hr), r = static_cast<int>(i % hr) * 2;
    const long at = static_cast<long>(t) * w.rp + r;
    float2 v = *reinterpret_cast<const float2*>(w.a_all + at);
    for (int m = 1; m < w.M; ++m) {
      const float2 u = *reinterpret_cast<const float2*>(w.a_all + m * plane + at);
      v = make_float2(v.x + u.x, v.y + u.y);
    }
    for (int j = 0; j < na; ++j) {
      const float mk = w.masks[static_cast<long>(amods[j]) * w.T + t];
      const float2 u = *reinterpret_cast<const float2*>(w.attn + j * plane + at);
      v = make_float2(v.x + mk * (w.attn_weight * u.x),
                      v.y + mk * (w.attn_weight * u.y));
    }
    const float hx = bf16_hi(v.x), hy = bf16_hi(v.y);
    __nv_bfloat16* row = bufs + static_cast<long>(t) * 2 * w.rp + r;
    *reinterpret_cast<uint32_t*>(row) = pack_bf16(hx, hy);
    *reinterpret_cast<uint32_t*>(row + w.rp) = pack_bf16(v.x - hx, v.y - hy);
  }
  const int ho = w.d_out / 2;
  for (long i = first; i < static_cast<long>(w.rp) * ho; i += nt) {
    const int k = static_cast<int>(i / ho), o = static_cast<int>(i % ho) * 2;
    const float2 v =
        *reinterpret_cast<const float2*>(w.Bm + static_cast<long>(k) * w.d_out + o);
    const float hx = bf16_hi(v.x), hy = bf16_hi(v.y);
    *reinterpret_cast<uint32_t*>(bs + static_cast<long>(k) * w.d_out + o) =
        pack_bf16(hx, hy);
    *reinterpret_cast<uint32_t*>(bs + static_cast<long>(w.rp + k) * w.d_out + o) =
        pack_bf16(v.x - hx, v.y - hy);
  }
}

// C = A B^T over nkb 64-deep blocks, a CTA 128 tokens x 256 columns.  UP
// false: A = x (T, d_in), B = at (2 M rp, d_in), both K-major; the
// epilogue writes a_i and the keys.  UP true: A = bufs (T, 2 rp), B = bs
// (2 rp, d_out), MN-major, over the K = 3 rp blocks of [hi(buf), hi(buf),
// lo(buf)] x [hi(B); lo(B); hi(B)]; the epilogue stores the delta by TMA.
// Grid (columns / 256, T / 128).
template <bool UP>
__global__ void __launch_bounds__(GNT, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                const __grid_constant__ CUtensorMap tm_b,
                const __grid_constant__ CUtensorMap tm_out, const Args w,
                int nkb) {
  extern __shared__ __align__(1024) uint8_t gsm_raw[];
  uint8_t* sm = gsm_raw + ((1024 - (smem_addr(gsm_raw) & 1023)) & 1023);
  const uint32_t ring = smem_addr(sm);
  const uint32_t full = ring + GSTAGES * GSTAGE, empty = full + 8 * GSTAGES;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int t0 = blockIdx.y * GM, n0 = blockIdx.x * GN;
  if (tid == 0) {
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, GCONS / 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == GCONS / 32) {  // the producer
    if (lane == 0) {
      const int nr = w.rp / 64;
      // UP: B's 64-column boxes that hold outputs (one wholly past d_out
      // is not loaded: its products are clipped by the store)
      const int boxes = UP ? min(GN / 64, (w.d_out - n0 + 63) / 64) : 0;
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % GSTAGES;
        if (kb >= GSTAGES) mbar_wait(empty + 8 * s, ((kb / GSTAGES) - 1) & 1);
        const uint32_t dst = ring + s * GSTAGE;
        if constexpr (UP) {
          // the K block's halves: buf's hi, hi, lo against B's hi, lo, hi
          const int ka = kb < 2 * nr ? kb % nr : kb - nr;
          const int kbb = kb < 2 * nr ? kb : kb - 2 * nr;
          mbar_arrive_expect_tx(full + 8 * s, GA + boxes * BOX);
          tma_load_4d(dst, &tm_a, full + 8 * s, 64 * ka, t0, 0, 0);
          for (int q = 0; q < boxes; ++q)
            tma_load_4d(dst + GA + q * BOX, &tm_b, full + 8 * s, n0 + 64 * q,
                        64 * kbb, 0, 0);
        } else {
          mbar_arrive_expect_tx(full + 8 * s, GSTAGE);
          tma_load_4d(dst, &tm_a, full + 8 * s, 64 * kb, t0, 0, 0);
          tma_load_4d(dst + GA, &tm_b, full + 8 * s, 64 * kb, n0, 0, 0);
        }
      }
    }
    return;
  }

  // the consumer warpgroups: warpgroup wg takes the tile's rows 64 wg..;
  // thread tid holds rows r0 and r0 + 8 of its 64, columns 2 qd (+1) of
  // each group of 8
  const int wg = warp / 4, r0 = 16 * (warp % 4) + lane / 4, qd = lane % 4;
  float acc[GN / 2];
#pragma unroll
  for (int i = 0; i < GN / 2; ++i) acc[i] = 0.f;
  fence_operand(acc);
  for (int kb = 0; kb < nkb; ++kb) {
    const int s = kb % GSTAGES;
    mbar_wait(full + 8 * s, (kb / GSTAGES) & 1);
    const uint32_t as = ring + s * GSTAGE + wg * BOX, bs = ring + s * GSTAGE + GA;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if constexpr (UP)
        wgmma_m64n256_ss<1>(acc, desc_sw128(as + 32 * kk),
                            desc_sw128_mn(bs + 2048 * kk, BOX), 1);
      else
        wgmma_m64nN_ss<GN>(acc, desc_sw128(as + 32 * kk),
                           desc_sw128(bs + 32 * kk), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the last block's products are done: free its stage
    if (kb > 0 && lane == 0) mbar_arrive(empty + 8 * ((kb - 1) % GSTAGES));
  }
  wgmma_wait<0>();
  fence_operand(acc);

  const int row = t0 + 64 * wg + r0;  // this thread's rows: row, row + 8
  if constexpr (!UP) {
    // column pair (2 q, 2 q + 1) is A's column q (modality q / rp, rank
    // q % rp), its hi and lo halves; the tile's 128 columns of A meet at
    // most two modalities (rp >= 128)
    const int q0 = n0 / 2, m0 = q0 / w.rp;
    float mk[2][2], qm[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = row + 8 * u;
      const bool in = t < w.T;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        mk[u][e] = in && m0 + e < w.M
            ? w.masks[static_cast<long>(m0 + e) * w.T + t] * w.pre_scale : 0.f;
      qm[u] = in ? w.qmask[t] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < GN / 8; ++j) {
      const int q = q0 + 4 * j + qd, m = q / w.rp, r = q - m * w.rp;
      if (m >= w.M) continue;  // past the last column of a ragged tile
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = row + 8 * u;
        if (t >= w.T) continue;
        const float v = (acc[4 * j + 2 * u] + acc[4 * j + 2 * u + 1]) *
                        (m == m0 ? mk[u][0] : mk[u][1]);
        w.a_all[(static_cast<long>(m) * w.T + t) * w.rp + r] = v;
        if (m == 0) w.keys[static_cast<long>(t) * w.rp + r] = v * qm[u];
      }
    }
  } else {
    float ts[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = row + 8 * u;
      ts[u] = 1.f;
      if (w.has_post) {
        ts[u] = 0.f;
        for (int m = 0; m < w.M && t < w.T; ++m)
          ts[u] += w.masks[static_cast<long>(m) * w.T + t] * w.post[m];
      }
    }
    named_bar_sync(1, GCONS);  // both warpgroups' products are done: the
                               // ring is free for the staging tiles
    // the warpgroup's 64 x 256 outputs as four 64-column boxes, bf16 in
    // the 128-byte-swizzled layout the stores read (row t's 16-byte chunk
    // c at c ^ (t % 8))
    uint8_t* stg = sm + wg * (GN / 64) * BOX;
#pragma unroll
    for (int j = 0; j < GN / 8; ++j)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int t = r0 + 8 * u, c = j % 8;
        *reinterpret_cast<uint32_t*>(stg + (j / 8) * BOX + t * 128 +
                                     ((c ^ (t & 7)) << 4) + 4 * qd) =
            pack_bf16(acc[4 * j + 2 * u] * ts[u], acc[4 * j + 2 * u + 1] * ts[u]);
      }
    fence_proxy_async_smem();
    named_bar_sync(2 + wg, 128);
    if (warp % 4 == 0 && lane == 0) {
      const uint64_t first = l2_evict_first();
      for (int n = 0; n < GN / 64; ++n)
        if (n0 + 64 * n < w.d_out)
          tma_store_4d(&tm_out, smem_addr(stg + n * BOX), n0 + 64 * n,
                       t0 + 64 * wg, 0, 0, first);
      bulk_commit();
      bulk_wait_read<0>();  // the staging tiles are read: exit
    }
  }
}

// the product (gemm_kernel) on its operands: UP false a = x, b = at; UP
// true a = bufs, b = bs
template <bool UP>
int launch_gemm(const Args& w, const void* a, const void* b, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<UP>, cudaFuncAttributeMaxDynamicSharedMemorySize, GSMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int n_cols = UP ? w.d_out : 2 * w.M * w.rp;
  // the 64-deep blocks: d_in's (down), the three halves' (up)
  const int nkb = UP ? 3 * (w.rp / 64) : (w.d_in + 63) / 64;
  const dim3 grid((n_cols + GN - 1) / GN, (w.T + GM - 1) / GM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // A over (K, T) in boxes of 64 x 128 tokens; B over (d_in, 2 M rp) in
  // boxes of 64 x 256 (down) or over (d_out, 2 rp) in boxes of 64 x 64
  // (up); the delta over (d_out, T) in boxes of 64 x 64
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t a_dims[4] = {uint64_t(UP ? 2 * w.rp : w.d_in), uint64_t(w.T),
                              1, 1};
  const uint64_t b_dims[4] = {uint64_t(UP ? w.d_out : w.d_in),
                              uint64_t(UP ? 2 * w.rp : n_cols), 1, 1};
  const uint64_t o_dims[4] = {uint64_t(w.d_out), uint64_t(w.T), 1, 1};
  const uint32_t a_box[4] = {64, GM, 1, 1};
  const uint32_t b_box[4] = {64, UP ? 64u : uint32_t(GN), 1, 1};
  const uint32_t o_box[4] = {64, 64, 1, 1};
  CUtensorMap tm_a, tm_b, tm_out;
  if (!swizzled_map(&tm_a, bf16, 2, 4, a, a_dims, a_box) ||
      !swizzled_map(&tm_b, bf16, 2, 4, b, b_dims, b_box) ||
      (UP && !swizzled_map(&tm_out, bf16, 2, 4, w.out, o_dims, o_box)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!UP) tm_out = tm_a;  // not read
  gemm_kernel<UP><<<grid, GNT, GSMEM, st>>>(tm_a, tm_b, tm_out, w, nkb);
  return static_cast<int>(cudaGetLastError());
}

bool takes(int T, int d_in, int d_out, int M, int rp) {
  return T > 0 && M > 0 && M <= MAXM && d_in % 8 == 0 && d_out % 8 == 0 &&
         rp > 64 && rp % TN == 0;
}

}  // namespace wide

}  // namespace

// Bytes of scratch moka_delta_fwd needs (0 for a shape it does not take);
// kl the key positions a row (L, or the gathered sequence's with ext 1).
extern "C" long moka_delta_workspace(int nb, int L, int kl, int d_in,
                                     int d_out, int M, int R, int x_bf16,
                                     int ext) {
  long off[4];
  return takes(nb, L, d_in, d_out, M, R)
             ? workspace(nb, kl, d_in, d_out, M, R, x_bf16, ext, off) : 0;
}

namespace {

Args make_args(const void* x, const void* masks, const void* qmask,
               const void* A, int nb, int L, int d_in, int M, int R,
               float pre_scale) {
  Args a = {};
  a.x = x;
  a.masks = static_cast<const float*>(masks);
  a.qmask = static_cast<const float*>(qmask);
  a.A = static_cast<const float*>(A);
  a.nb = nb;
  a.L = L;
  a.d_in = d_in;
  a.M = M;
  a.pre_scale = pre_scale;
  a.kl = L;
  a.kmask = a.qmask;
  a.ds = (d_in + KEY_DCH - 1) / KEY_DCH;
  a.dch = KEY_DCH;
  return a;
}

}  // namespace

// x (nb, L, d_in) bf16 (x_bf16 = 1) or fp32; masks (M, nb, L), qmask (nb,
// L), A (M, d_in, R), B (R, d_out) fp32; out (nb, L, d_out) in x's type;
// work: moka_delta_workspace's bytes; all contiguous and 16-byte aligned
// (work 256-byte), R in {4, 8, 16, 32, 64}, the true rank 1 <= rank <= R
// (A's columns and B's rows past it zero; the attention scale is
// 1/sqrt(rank)), M <= 4, d_in % 8 == 0, d_out % 8 == 0.  ext: null, or
// keys from outside (nb, kl, R) fp32 at the positions where kmask (nb, kl)
// is > 0 (a ring's gathered keys and the whole sequence's question mask),
// which the attention takes instead of the keys of x's rows.  Launches the
// key pass, then the main kernel.  Returns cudaGetLastError() (or the
// error of setting up a launch).
extern "C" int moka_delta_fwd(const void* x, int x_bf16, const void* masks,
                              const void* qmask, const void* A, const void* Bm,
                              void* out, void* work, int nb, int L, int d_in,
                              int d_out, int M, int R, int rank,
                              float pre_scale, float attn_weight,
                              int attn_bits, float p0, float p1, float p2,
                              float p3, int has_post, const void* ext,
                              const void* kmask, int kl, void* stream) {
  if (!takes(nb, L, d_in, d_out, M, R) || rank < 1 || rank > R ||
      (ext != nullptr && (kmask == nullptr || kl < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, masks, qmask, A, nb, L, d_in, M, R, pre_scale);
  if (ext != nullptr) {
    a.ext = static_cast<const float*>(ext);
    a.kmask = static_cast<const float*>(kmask);
    a.kl = kl;
    a.ds = 1;
  }
  long off[4];
  workspace(nb, a.kl, d_in, d_out, M, R, x_bf16, ext != nullptr, off);
  uint8_t* w = static_cast<uint8_t*>(work);
  a.Bm = static_cast<const float*>(Bm);
  a.out = out;
  a.keys = reinterpret_cast<float*>(w + off[0]);
  a.nq = reinterpret_cast<int*>(w + off[1]);
  a.at = x_bf16 ? reinterpret_cast<__nv_bfloat16*>(w + off[2]) : nullptr;
  a.bs = x_bf16 ? reinterpret_cast<__nv_bfloat16*>(w + off[3]) : nullptr;
  a.d_out = d_out;
  a.rank = rank;
  a.attn_weight = attn_weight;
  a.attn_bits = attn_bits;
  a.has_post = has_post;
  a.post[0] = p0;
  a.post[1] = p1;
  a.post[2] = p2;
  a.post[3] = p3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 4: return launch<4>(a, x_bf16, st);
    case 8: return launch<8>(a, x_bf16, st);
    case 16: return launch<16>(a, x_bf16, st);
    case 32: return launch<32>(a, x_bf16, st);
    default: return launch<64>(a, x_bf16, st);
  }
}

// The key pass alone, for a ring: dense (nb, L, R) fp32 gets the question
// keys (x @ A_0) * mask_0 * qmask * pre_scale of x's rows at the positions
// where qmask > 0 (the caller zeroes the rest), each a sum over all of d_in
// (one chunk).  The rest as moka_delta_fwd.
extern "C" int moka_delta_keys(const void* x, int x_bf16, const void* masks,
                               const void* qmask, const void* A, void* dense,
                               int nb, int L, int d_in, int M, int R,
                               float pre_scale, void* stream) {
  if (!takes(nb, L, d_in, 8, M, R))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, masks, qmask, A, nb, L, d_in, M, R, pre_scale);
  a.dense = static_cast<float*>(dense);
  a.ds = 1;
  a.dch = (d_in + KEY_DCH - 1) / KEY_DCH * KEY_DCH;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf = x_bf16 != 0;
  switch (R) {
    case 4: return bf ? launch_keys<__nv_bfloat16, 4>(a, 0, st) : launch_keys<float, 4>(a, 0, st);
    case 8: return bf ? launch_keys<__nv_bfloat16, 8>(a, 0, st) : launch_keys<float, 8>(a, 0, st);
    case 16: return bf ? launch_keys<__nv_bfloat16, 16>(a, 0, st) : launch_keys<float, 16>(a, 0, st);
    case 32: return bf ? launch_keys<__nv_bfloat16, 32>(a, 0, st) : launch_keys<float, 32>(a, 0, st);
    default: return bf ? launch_keys<__nv_bfloat16, 64>(a, 0, st) : launch_keys<float, 64>(a, 0, st);
  }
}

// The wide path's down product: x (T, d_in) bf16 or fp32, A (M, d_in, rp)
// fp32 (rp a multiple of 64 past 64, columns past the true rank zero),
// masks (M, T), qmask (T) fp32 -> a_all (M, T, rp) and keys (T, rp) fp32;
// at: (2 M rp, d_in) bf16 scratch for A's halves (bf16 x; unused for fp32
// x); all contiguous and 16-byte aligned.  For bf16 x two launches: the
// split of A, then the product.
extern "C" int moka_delta_wide_down(const void* x, int x_bf16, const void* A,
                                    const void* masks, const void* qmask,
                                    void* a_all, void* keys, void* at, int T,
                                    int d_in, int M, int rp, float pre_scale,
                                    void* stream) {
  if (!wide::takes(T, d_in, 8, M, rp) || (x_bf16 && at == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  wide::Args w = {};
  w.x = static_cast<const float*>(x);
  w.A = static_cast<const float*>(A);
  w.masks = static_cast<const float*>(masks);
  w.qmask = static_cast<const float*>(qmask);
  w.a_all = static_cast<float*>(a_all);
  w.keys = static_cast<float*>(keys);
  w.T = T;
  w.d_in = d_in;
  w.M = M;
  w.rp = rp;
  w.pre_scale = pre_scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!x_bf16) return wide::launch<false>(w, st);
  auto* halves = static_cast<__nv_bfloat16*>(at);
  wide::split_kernel<<<dim3(rp / 32, (d_in + 31) / 32, M), 256, 0, st>>>(
      w.A, halves, d_in, rp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return wide::launch_gemm<false>(w, x, halves, st);
}

// The wide path's up product: a_all (M, T, rp), attn (na, T, rp) (the
// attention streams' R1 outputs, in the order of attn_bits), masks (M, T),
// B (rp, d_out) fp32 -> out (T, d_out) in x's type (x_bf16); bufs (T, 2
// rp) and bs (2 rp, d_out) bf16 scratch for buf's and B's halves (bf16 x;
// unused for fp32 x).  For bf16 x two launches: the halves, then the
// product.
extern "C" int moka_delta_wide_up(const void* a_all, const void* attn,
                                  const void* masks, const void* Bm, void* out,
                                  int x_bf16, void* bufs, void* bs, int T,
                                  int d_out, int M, int rp, float attn_weight,
                                  int attn_bits, float p0, float p1, float p2,
                                  float p3, int has_post, void* stream) {
  if (!wide::takes(T, 8, d_out, M, rp) ||
      (x_bf16 && (bufs == nullptr || bs == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  wide::Args w = {};
  w.a_all = static_cast<float*>(const_cast<void*>(a_all));
  w.attn = static_cast<const float*>(attn);
  w.masks = static_cast<const float*>(masks);
  w.Bm = static_cast<const float*>(Bm);
  w.out = out;
  w.T = T;
  w.d_out = d_out;
  w.M = M;
  w.rp = rp;
  w.attn_weight = attn_weight;
  w.attn_bits = attn_bits;
  w.has_post = has_post;
  w.post[0] = p0;
  w.post[1] = p1;
  w.post[2] = p2;
  w.post[3] = p3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!x_bf16) return wide::launch<true>(w, st);
  const long work = static_cast<long>(T) * rp > static_cast<long>(rp) * d_out
                        ? static_cast<long>(T) * rp / 2
                        : static_cast<long>(rp) * d_out / 2;
  const long ctas = (work + 255) / 256;
  const int grid = static_cast<int>(ctas < 8L * sm_count() ? ctas : 8L * sm_count());
  wide::prep_kernel<<<grid, 256, 0, st>>>(
      w, static_cast<__nv_bfloat16*>(bufs), static_cast<__nv_bfloat16*>(bs));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return wide::launch_gemm<true>(w, bufs, bs, st);
}
