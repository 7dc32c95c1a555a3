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
// with fp32 sums (softmax in base 2 inside), the result rounded once to
// bf16.  The scales fold in as JAX folds them: ks into the score, vs into
// p, l summed from p alone.  A row that sees no key gives 0.  (JAX's loop
// gives it the mean of the values of the blocks it walked: its m stays at
// -1e30 and p is 1 on every key.  Callers read only rows that see a key, as
// for kernel 1.)  Repeated launches on one input are bit-identical.
//
// Bound: the bytes.  Each visible key's k and v row is read once (256 B each
// in bf16, 128 B in int8, plus 8 B of scales), q and out are 256 B a head;
// 4 flops per key and head element, far below the card's rate.  At the 7B
// serving shape (B 8, K 32, 928 keys) that is 106 MB a layer in bf16, 32 us
// at 3.35 TB/s, and about half of it in int8.
//
// Design.  The first kernel (a CTA per 256-key chunk) reached 36%
// (bf16) and 20% (int8) of that bound; what this one does about each of its
// four faults:
//   1. Memory idle for most of a CTA's life (a chunk's loads, then three
//      phases that load nothing).  Now a producer warp streams 64-key tiles
//      of k and v by TMA (a 4-D tensor map over the layer's (B, length, K,
//      128) slice: the sample and the key are coordinates, and keys at or
//      past `length` lie outside the map, so they are never read) into a
//      ring of 3 (bf16, 32 KB a stage) or 2 (int8, 16 KB) stages with
//      full/empty mbarriers, and the int8 scales by 4-byte cp.async whose
//      completion arrives on the same barrier.  It runs up to the ring's
//      depth ahead of the four consumer warps for the CTA's whole span.  A
//      tile whose 64 keys are all masked (left padding, a row without keys)
//      is never loaded: the producer reads the mask first, 32 tiles at a
//      time, and hands each stage its tile and its 64 visibility bits.
//   2. A grid cut by a fixed 256-key chunk.  Now each CTA owns one (sample,
//      kv head) and one span of whole tiles below `length`; the wrapper
//      (plan_spans) picks the span from B * K, `length` and the SM count so
//      that the grid is about one wave of two CTAs an SM.  At the 7B
//      serving shape (256 pairs on 132 SMs) that is one span a pair and no
//      merge; one sample (32 pairs) gets eight.  The span holding `length`
//      ends there, and a short tail is the end of a span, not a CTA.
//   3. int8 widened by I2F (16 results a clock an SM: the whole int8 bound
//      at the serving shape).  Now codes become bf16 pairs exactly by two
//      LOP3s and one HFMA2 (int8_bf16.cuh's widen), after a byte permute
//      (PRMT) for v; no conversion instruction.  Codes in +-127 are exact
//      in bf16.
//   4. A shuffle tree a key and a serial p.v loop.  Now both products are
//      mma.sync m16n8k16 (bf16 in, fp32 sums), the kv head's G <= 8 query
//      heads on the M side (rows G..15 zero), so G = 1 (7B, 13B) and G = 8
//      (70B) cost the same.  Each consumer warp takes 16 keys of every
//      tile: S = q k^T is two n8 blocks of 8 k16 steps; its fp32
//      accumulator is the bf16 A fragment of P (as in kernel 1: p, times vs
//      on int8, rounded to bf16 once, as the eager path rounds its
//      probabilities), and O += P v is 16 n8 blocks of one k16 step.  k and
//      v sit in shared memory as TMA writes them with a 128-byte swizzle:
//      bf16 rows are read by ldmatrix (v transposed), int8 rows by 16-byte
//      (k) and 4-byte (v) loads, all free of bank conflicts; the int8 path
//      pairs the reduction dimension's elements in the order its widening
//      yields them, and q's fragment follows that order.  The online
//      softmax (base 2, m and l a query head) is in registers; its only
//      shuffles are two a tile for the row max.
// The four warps' (m, l, O) merge in warp order through shared memory (the
// ring, once it is drained).  Several spans merge in the same launch: each
// CTA writes its (m, l, unscaled O) to a workspace and takes a ticket; the
// last CTA of a (sample, kv head) merges the spans in span order (so the
// result does not depend on which CTA is last), writes out and resets the
// ticket to 0.  Workspace and tickets are kept per device by the wrapper.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "hopper.cuh"
#include "int8_bf16.cuh"

namespace {

using namespace moka_hopper;
using moka_flash::exp2_approx;
using moka_flash::pack_bf16;

constexpr int HD = 128;        // head_dim
constexpr int TILE = 64;       // keys a ring stage
constexpr int CONSUMERS = 4;   // warps; each takes 16 keys of every tile
constexpr int THREADS = 32 * (CONSUMERS + 1);  // and one producer warp
constexpr int MAX_G = 8;       // query heads a kv head (GQA 64:8)
constexpr int BOX = TILE * 128;  // bytes of a 128-byte-swizzled TMA box
constexpr float LOG2E = 1.4426950408889634f;

template <bool INT8>
struct Cfg {
  static constexpr int STAGES = INT8 ? 2 : 3;  // measured: PERF.md
  static constexpr int SIDE = TILE * HD * (INT8 ? 1 : 2);  // k (or v) bytes
  static constexpr int STAGE = 2 * SIDE;
  static constexpr int RING = STAGES * STAGE;
};

// what the producer hands a stage besides its k and v tiles
struct Meta {
  int tile;           // tile index in the cache; -1: the span has ended
  uint32_t lo, hi;    // visibility of the tile's keys 0-31, 32-63
  int pad;
  float ks[TILE];     // int8: the keys' scales
  float vs[TILE];
};

constexpr int merge_floats() {  // the four warps' partials, in the ring
  return CONSUMERS * MAX_G * (HD + 2);
}
static_assert(merge_floats() * 4 <= Cfg<true>::RING, "merge area");

template <bool INT8>
constexpr size_t smem_bytes() {
  return 1024 + Cfg<INT8>::RING + Cfg<INT8>::STAGES * sizeof(Meta) +
         2 * Cfg<INT8>::STAGES * sizeof(uint64_t);
}

struct Args {
  const __nv_bfloat16* q;     // (B, H, HD)
  const float* ks;            // the layer's (B, S, K) scales (int8 only)
  const float* vs;
  const int32_t* mask;        // (B, S), int32 or fp32 bits
  int mask_is_float;
  int mask_vec;               // rows 16-byte aligned: read by 16 bytes
  __nv_bfloat16* out;         // (B, H, HD)
  float* ws;                  // (B * K, n_span, G, HD + 2): O, then m, l
  int* tickets;               // (B * K), zero between launches
  int B, H, K, S, length, G, n_span, span_tiles;
  float q_scale;              // log2(e) / sqrt(HD)
  moka_int8::Widen wd;
};

// --------------------------------------------------- shared memory, mma.sync

// the 16-byte chunk `chunk` of row `row` of a 128-byte-swizzled box
__device__ __forceinline__ uint32_t swz(uint32_t box, int row, int chunk) {
  return box + row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// d += A B on a 16 x 8 x 16 tile: A's rows 0-7 (a0: k 0-7, a2: k 8-15; rows
// 8-15 are zero), B (b0: k 0-7, b1: k 8-15), bf16 in, fp32 sums
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a2,
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %5}, {%7, %8}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// one arrival on `bar` once this thread's earlier cp.asyncs have landed
// (counted among the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// ------------------------------------------------------------------ kernel

__device__ __forceinline__ uint32_t visible(const Args& a, int32_t mv) {
  return a.mask_is_float ? __int_as_float(mv) > 0.f : mv > 0;
}

template <bool INT8>
__device__ __forceinline__ void produce(const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v,
                                        const Args& a, Meta* meta,
                                        uint32_t ring, uint32_t full0,
                                        uint32_t empty0, int b, int kh,
                                        int t_lo, int t_hi) {
  using C = Cfg<INT8>;
  const int lane = threadIdx.x % 32;
  const int32_t* mrow = a.mask + static_cast<size_t>(b) * a.S;
  const size_t srow = static_cast<size_t>(b) * a.S * a.K + kh;
  int it = 0;
  for (int t0 = t_lo; t0 < t_hi; t0 += 32) {
    // lane i reads the mask of tile t0 + i: which of its keys are visible
    const int t = t0 + lane;
    uint32_t lo = 0, hi = 0;
    if (t < t_hi) {
      const int key0 = t * TILE, n = min(TILE, a.length - key0);
      if (n == TILE && a.mask_vec) {  // sixteen 16-byte loads in flight
        int4 mv[TILE / 4];
        const int4* src = reinterpret_cast<const int4*>(mrow + key0);
#pragma unroll
        for (int c = 0; c < TILE / 4; ++c) mv[c] = __ldg(src + c);
#pragma unroll
        for (int c = 0; c < TILE / 4; ++c) {
          const uint32_t bits = visible(a, mv[c].x) |
                                visible(a, mv[c].y) << 1 |
                                visible(a, mv[c].z) << 2 |
                                visible(a, mv[c].w) << 3;
          if (c < 8)
            lo |= bits << (4 * c);
          else
            hi |= bits << (4 * c - 32);
        }
      } else {
        for (int j = 0; j < n; ++j) {
          const uint32_t ok = visible(a, __ldg(mrow + key0 + j));
          if (j < 32)
            lo |= ok << j;
          else
            hi |= ok << (j - 32);
        }
      }
    }
    for (uint32_t live = __ballot_sync(~0u, (lo | hi) != 0); live;
         live &= live - 1) {
      const int i = __ffs(live) - 1, tile = t0 + i, s = it % C::STAGES;
      const uint32_t blo = __shfl_sync(~0u, lo, i);
      const uint32_t bhi = __shfl_sync(~0u, hi, i);
      const uint32_t full = full0 + 8 * s;
      if (it >= C::STAGES) mbar_wait(empty0 + 8 * s, (it / C::STAGES - 1) & 1);
      if (lane == 0) {
        meta[s].tile = tile;
        meta[s].lo = blo;
        meta[s].hi = bhi;
        mbar_arrive_expect_tx(full, C::STAGE);
        const uint32_t dst = ring + s * C::STAGE;
#pragma unroll
        for (int h = 0; h < C::SIDE / BOX; ++h) {  // 128-byte column boxes
          tma_load_4d(dst + h * BOX, tm_k, full, 64 * h, kh, tile * TILE, b);
          tma_load_4d(dst + C::SIDE + h * BOX, tm_v, full, 64 * h, kh,
                      tile * TILE, b);
        }
      }
      if (INT8) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = lane + 32 * e, key = tile * TILE + j;
          if (key < a.length) {
            cp_async4(smem_addr(&meta[s].ks[j]),
                      a.ks + srow + static_cast<size_t>(key) * a.K);
            cp_async4(smem_addr(&meta[s].vs[j]),
                      a.vs + srow + static_cast<size_t>(key) * a.K);
          }
        }
        cp_async_arrive(full);
      }
      ++it;
    }
  }
  // the end of the span: a stage with tile -1 and no bytes
  const int s = it % C::STAGES;
  if (it >= C::STAGES) mbar_wait(empty0 + 8 * s, (it / C::STAGES - 1) & 1);
  if (lane == 0) {
    meta[s].tile = -1;
    mbar_arrive(full0 + 8 * s);
  }
  if (INT8) mbar_arrive(full0 + 8 * s);  // in place of the scales' arrivals
}

template <bool INT8>
__global__ void __launch_bounds__(THREADS, 2)
    paged_decode_kernel(const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const Args a) {
  using C = Cfg<INT8>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Meta* meta = reinterpret_cast<Meta*>(smem + C::RING);
  uint64_t* bars = reinterpret_cast<uint64_t*>(meta + C::STAGES);
  __shared__ int is_last;

  const int pair = blockIdx.x / a.n_span, span = blockIdx.x % a.n_span;
  const int b = pair / a.K, kh = pair % a.K, G = a.G;
  const int n_tiles = (a.length + TILE - 1) / TILE;
  const int t_lo = span * a.span_tiles;
  const int t_hi = min(n_tiles, t_lo + a.span_tiles);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t ring = smem_addr(smem);
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + 8 * C::STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, INT8 ? 33 : 1);  // int8: + 32 scale copiers
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS) {
    if (lane == 0) {  // the descriptors, fetched while the mask is read
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tm_k) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tm_v) : "memory");
    }
    produce<INT8>(&tm_k, &tm_v, a, meta, ring, full0, empty0, b, kh, t_lo,
                  t_hi);
    return;
  }

  // ---- consumers: warp w takes keys 16w .. 16w + 15 of every tile
  const int w = warp, g = lane / 4, t = lane % 4;
  // q as A fragments (rows: query heads g < G), in the order in which each
  // path's B fragments hold the head dimension
  uint32_t qa[8][2];
  {
    const __nv_bfloat16* qp =
        a.q + (static_cast<size_t>(b) * a.H + static_cast<size_t>(kh) * G +
               min(g, G - 1)) * HD;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      if (INT8) {  // step s = 4e + u: d = 32t + 16e + 4u + (0, 2 | 1, 3)
        const uint2 raw = *reinterpret_cast<const uint2*>(
            qp + 32 * t + 16 * (s / 4) + 4 * (s % 4));
        qa[s][0] = __byte_perm(raw.x, raw.y, 0x5410);
        qa[s][1] = __byte_perm(raw.x, raw.y, 0x7632);
      } else {     // step s: d = 16s + 2t (+1 | +8, +9)
        qa[s][0] = *reinterpret_cast<const uint32_t*>(qp + 16 * s + 2 * t);
        qa[s][1] =
            *reinterpret_cast<const uint32_t*>(qp + 16 * s + 8 + 2 * t);
      }
      if (g >= G) qa[s][0] = qa[s][1] = 0u;
    }
  }

  float m = -INFINITY, l = 0.f;   // query head g's running max and sum
  float o[16][4];                 // O: 16 n8 blocks of the head dimension
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int it = 0;; ++it) {
    const int s = it % C::STAGES;
    mbar_wait(full0 + 8 * s, (it / C::STAGES) & 1);
    const Meta* st = meta + s;
    if (st->tile < 0) break;
    const uint32_t kb = ring + s * C::STAGE, vb = kb + C::SIDE;

    // S = q k^T over this warp's 16 keys: n8 block nb holds keys 8nb + n,
    // in two accumulators a block (chains of four products), summed after
    float sc[2][2][4];
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sc[nb][h][0] = sc[nb][h][1] = sc[nb][h][2] = sc[nb][h][3] = 0.f;
      if (INT8) {  // row key 16w + 8nb + g, chunks 2t and 2t + 1
        const int row = 16 * w + 8 * nb + g;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const uint4 raw = lds128(swz(kb, row, 2 * t + e));
          const uint32_t word[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            uint32_t b0, b1;
            moka_int8::widen(word[u], a.wd, b0, b1);
            mma(sc[nb][e], qa[4 * e + u][0], qa[4 * e + u][1], b0, b1);
          }
        }
      } else {     // ldmatrix: rows key 16w + 8nb + lane % 8, chunk 2s + mi
        const int row = 16 * w + 8 * nb + lane % 8;
#pragma unroll
        for (int s2 = 0; s2 < 8; s2 += 2) {
          const int c = 2 * s2 + lane / 8;  // 8-element column chunk 0-15
          uint32_t r[4];
          ldsm_x4(swz(kb + (c / 8) * BOX, row, c % 8), r);
          mma(sc[nb][0], qa[s2][0], qa[s2][1], r[0], r[1]);
          mma(sc[nb][1], qa[s2 + 1][0], qa[s2 + 1][1], r[2], r[3]);
        }
      }
    }

    // v's fragments, loaded before the softmax: int8, words d = 4(8G4 + g)
    // .. + 3 of rows 16w + 2t (+1, 8, 9); bf16, ldmatrix.trans of rows
    // key 16w + 8(mi % 2) + lane % 8, chunk 2jp + mi / 2 (block j = chunk j)
    uint32_t vr[8][4];  // int8: the first four
    if (INT8) {
      const int row = 16 * w + 2 * t;
#pragma unroll
      for (int G4 = 0; G4 < 4; ++G4) {
        const int c = 2 * G4 + g / 4, off = 4 * (g % 4);
        vr[G4][0] = lds32(swz(vb, row, c) + off);
        vr[G4][1] = lds32(swz(vb, row + 1, c) + off);
        vr[G4][2] = lds32(swz(vb, row + 8, c) + off);
        vr[G4][3] = lds32(swz(vb, row + 9, c) + off);
      }
    } else {
      const int row = 16 * w + 8 * ((lane / 8) % 2) + lane % 8;
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        const int c = 2 * jp + lane / 16;
        ldsm_x4_t(swz(vb + (c / 8) * BOX, row, c % 8), vr[jp]);
      }
    }

    // online softmax (base 2) over keys 16w + 8nb + 2t + e
    float x[4], p[4];
    bool vis[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = 16 * w + 8 * (i / 2) + 2 * t + i % 2;
      vis[i] = ((key < 32 ? st->lo >> key : st->hi >> (key - 32)) & 1u) != 0;
      float sv = (sc[i / 2][0][i % 2] + sc[i / 2][1][i % 2]) * a.q_scale;
      if (INT8) sv *= st->ks[key];
      x[i] = vis[i] ? sv : -INFINITY;
    }
    float mx = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
    mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float base = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2_approx(m - base);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = exp2_approx(x[i] - base);
      l += p[i];
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[j][0] *= alpha;
      o[j][1] *= alpha;
    }
    if (INT8) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = 16 * w + 8 * (i / 2) + 2 * t + i % 2;
        p[i] = vis[i] ? p[i] * st->vs[key] : 0.f;
      }
    }
    // P as the A fragment: k 0-7 <- keys 2t, 2t + 1; k 8-15 <- 8 + 2t, 9 + 2t
    const uint32_t pa0 = pack_bf16(p[0], p[1]), pa2 = pack_bf16(p[2], p[3]);

    // O += P v; int8 block 4G4 + i holds d = 32G4 + 4n + i
    if (INT8) {
#pragma unroll
      for (int G4 = 0; G4 < 4; ++G4) {
        uint32_t b0[4], b1[4];
        moka_int8::widen(__byte_perm(vr[G4][0], vr[G4][1], 0x5410), a.wd,
                         b0[0], b0[1]);
        moka_int8::widen(__byte_perm(vr[G4][0], vr[G4][1], 0x7632), a.wd,
                         b0[2], b0[3]);
        moka_int8::widen(__byte_perm(vr[G4][2], vr[G4][3], 0x5410), a.wd,
                         b1[0], b1[1]);
        moka_int8::widen(__byte_perm(vr[G4][2], vr[G4][3], 0x7632), a.wd,
                         b1[2], b1[3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) mma(o[4 * G4 + i], pa0, pa2, b0[i], b1[i]);
      }
    } else {
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        mma(o[2 * jp], pa0, pa2, vr[jp][0], vr[jp][1]);
        mma(o[2 * jp + 1], pa0, pa2, vr[jp][2], vr[jp][3]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // ---- the four warps' partials merge in warp order (the ring is drained)
  l += __shfl_xor_sync(~0u, l, 1);
  l += __shfl_xor_sync(~0u, l, 2);
  float* po = reinterpret_cast<float*>(smem);   // [w][g][HD]
  float* pm = po + CONSUMERS * MAX_G * HD;      // [w][g]
  float* pl = pm + CONSUMERS * MAX_G;
  named_bar_sync(1, 32 * CONSUMERS);
  if (g < G) {
    float* og = po + (w * MAX_G + g) * HD;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = INT8 ? 32 * (j / 4) + 8 * t + 4 * e + j % 4
                           : 8 * j + 2 * t + e;
        og[d] = o[j][e];
      }
    }
    if (t == 0) {
      pm[w * MAX_G + g] = m;
      pl[w * MAX_G + g] = l;
    }
  }
  named_bar_sync(1, 32 * CONSUMERS);

  const int d = threadIdx.x;  // 0 .. 127
  __nv_bfloat16* op = a.out +
      (static_cast<size_t>(b) * a.H + static_cast<size_t>(kh) * G) * HD;
  const size_t slot = (static_cast<size_t>(pair) * a.n_span + span) * G;
  for (int gg = 0; gg < G; ++gg) {
    float mm = -INFINITY;
#pragma unroll
    for (int v = 0; v < CONSUMERS; ++v) mm = fmaxf(mm, pm[v * MAX_G + gg]);
    const float base = mm == -INFINITY ? 0.f : mm;
    float acc = 0.f, ll = 0.f;
#pragma unroll
    for (int v = 0; v < CONSUMERS; ++v) {
      const float wgt = exp2_approx(pm[v * MAX_G + gg] - base);
      acc = fmaf(po[(v * MAX_G + gg) * HD + d], wgt, acc);
      ll = fmaf(pl[v * MAX_G + gg], wgt, ll);
    }
    if (a.n_span == 1) {
      op[gg * HD + d] = __float2bfloat16(ll > 0.f ? acc / ll : 0.f);
    } else {
      float* part = a.ws + (slot + gg) * (HD + 2);
      part[d] = acc;
      if (d == 0) {
        part[HD] = mm;
        part[HD + 1] = ll;
      }
    }
  }
  if (a.n_span == 1) return;

  // several spans: the last CTA of the pair merges them all, in span order
  __threadfence();
  named_bar_sync(1, 32 * CONSUMERS);
  if (d == 0) is_last = atomicAdd(a.tickets + pair, 1) == a.n_span - 1;
  named_bar_sync(1, 32 * CONSUMERS);
  if (!is_last) return;
  __threadfence();
  const float* parts = a.ws + static_cast<size_t>(pair) * a.n_span * G *
                                  (HD + 2);
  for (int gg = 0; gg < G; ++gg) {
    float mm = -INFINITY;
    for (int sp = 0; sp < a.n_span; ++sp)
      mm = fmaxf(mm, __ldcg(parts + (sp * G + gg) * (HD + 2) + HD));
    const float base = mm == -INFINITY ? 0.f : mm;
    float acc = 0.f, ll = 0.f;
    for (int s = 0; s < a.n_span; ++s) {
      const float* part = parts + (s * G + gg) * (HD + 2);
      const float wgt = exp2_approx(__ldcg(part + HD) - base);
      ll = fmaf(__ldcg(part + HD + 1), wgt, ll);
      acc = fmaf(__ldcg(part + d), wgt, acc);
    }
    op[gg * HD + d] = __float2bfloat16(ll > 0.f ? acc / ll : 0.f);
  }
  if (d == 0) a.tickets[pair] = 0;
}

// a tensor map over the layer's (B, S, K, HD) slice whose key extent is
// `length` (keys past it read as zeros, never from memory), in 64-key boxes
// of one sample, one kv head and 128 bytes of the head dimension, swizzled
bool decode_map(CUtensorMap* map, const void* base, bool int8, int B, int S,
                int K, int length) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t elem = int8 ? 1 : 2;
  const cuuint64_t dims[4] = {HD, static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(length),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {HD * elem, K * HD * elem,
                                 static_cast<cuuint64_t>(S) * K * HD * elem};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / elem), 1, TILE, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map,
            int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool INT8>
int launch(const CUtensorMap& tm_k, const CUtensorMap& tm_v, const Args& a,
           cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_kernel<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<INT8>()));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  paged_decode_kernel<INT8>
      <<<a.B * a.K * a.n_span, THREADS, smem_bytes<INT8>(), st>>>(tm_k, tm_v,
                                                                  a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// k, v (and ks, vs) point at the layer's slice of the cache; the pair's
// keys split into n_span spans of span_tiles 64-key tiles (the last ends at
// `length`); ws (B * K * n_span * G * 130 floats) and tickets (B * K zeros)
// are needed only when n_span > 1.  cudaErrorInvalidValue for a shape the
// kernel does not take, a plan that does not cover the keys, or a tensor map
// cuTensorMapEncodeTiled refuses.
extern "C" int moka_paged_decode(const void* q, const void* k, const void* v,
                                 const void* ks, const void* vs,
                                 const void* mask, int mask_is_float,
                                 void* out, void* ws, void* tickets, int B,
                                 int H, int K, int S, int length, int kv_int8,
                                 int span_tiles, int n_span, void* stream) {
  const int n_tiles = (length + TILE - 1) / TILE;
  if (B <= 0 || K <= 0 || H % K != 0 || H / K > MAX_G || length <= 0 ||
      length > S || span_tiles <= 0 ||
      n_span != (n_tiles + span_tiles - 1) / span_tiles ||
      (n_span > 1 && (ws == nullptr || tickets == nullptr)) ||
      (kv_int8 && (ks == nullptr || vs == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_k, tm_v;
  if (!decode_map(&tm_k, k, kv_int8, B, S, K, length) ||
      !decode_map(&tm_v, v, kv_int8, B, S, K, length))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.mask = static_cast<const int32_t*>(mask);
  a.mask_is_float = mask_is_float;
  a.mask_vec = S % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  a.out = static_cast<__nv_bfloat16*>(out);
  a.ws = static_cast<float*>(ws);
  a.tickets = static_cast<int*>(tickets);
  a.B = B;
  a.H = H;
  a.K = K;
  a.S = S;
  a.length = length;
  a.G = H / K;
  a.n_span = n_span;
  a.span_tiles = span_tiles;
  a.q_scale = LOG2E / sqrtf(static_cast<float>(HD));
  a.wd = {0x007f007fu, 0x00800080u, 0x43004300u, 0xc300c300u};  // 128.0,
                                                                 // -128.0
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return kv_int8 ? launch<true>(tm_k, tm_v, a, st)
                 : launch<false>(tm_k, tm_v, a, st);
}
