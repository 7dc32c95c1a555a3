// LoRA dropout fused into the adapter's A projection, forward and backward,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels moka_tpu/ops/fused_dropout.py::_fwd_kernel
// (launched by _run_fwd) and ::_bwd_kernel (launched by _run_bwd).  For x
// (N, d) in bf16 or fp32, A (d, MR) in fp32 or bf16 (MR = M * r, the
// modalities' rank columns side by side) and keep = bits < thresh:
//   forward   out = where(keep, x * s_x, 0) @ A          (N, MR) fp32
//             s_x = 1/keep rounded to x's type, x_d rounded to x's type
//   backward  m   = where(keep, 1/keep, 0)                fp32
//             dx  = ((g @ A^T) * m)                       (N, d) in x's type
//             dA  = (x * m)^T @ g                         (d, MR) fp32
// The bits are never stored: element (n, c) takes word c % 4 of
// Philox4x32-10 at counter (n, c / 4, 0, 0) under the 64-bit key (k0, k1),
// the layout core/rng.py::DropoutKey.bits32 computes in plain torch, so both
// kernels, and the plain version, draw the same mask whatever the tiling.
// With a bits pointer (tests) the words are read from it instead.
//
// What bounds it: the generator in the forward, the bytes in the backward.
// Per element: one read of x (2 bytes in bf16) and a quarter of a Philox
// call (10 rounds of two 32x32 multiplies high and low, four xors, and nine
// key bumps: ~100 integer instructions per four words).  At N 4096, d 4096
// that is ~0.41 G lane instructions, ~12 us at the card's 33.5 T lane
// instructions a second (132 SMs x 128 lanes x 1.98 GHz), against ~10 us
// for the 33.5 MB of x; the backward adds the 33.5 MB of dx (~20 us).  The
// rank-MR products would take well under a microsecond on the tensor
// cores; here they run as fp32 multiply-adds on the ordinary cores (MR per
// element forward, 2 MR backward), which is work above the bound.  What
// the design does about it:
//   * each lane owns four consecutive columns, so one Philox call gives the
//     four words it needs; x is read with one 8- or 16-byte load per row;
//   * forward: a CTA of 8 warps takes 16 rows and streams A through shared
//     memory in 512-column chunks, transposed to [j][column] so each lane
//     reads its four columns of one j with one conflict-free 16-byte load;
//     a lane keeps the MR sums of its rows in registers across all of d and
//     the warp adds them up by shuffles at the end;
//   * backward: a CTA of 4 warps takes 512 columns (a lane's four columns of
//     A stay in registers) and 128 rows (their g rows staged in shared
//     memory and read as broadcasts); dx is written per row, and the lane's
//     (4, MR) part of dA is summed over the tile's rows in registers.  The
//     dA reduction across row tiles is a second pass, not atomics: each tile
//     writes its partial to a workspace (tiles, d, MR) and a second kernel
//     sums the tiles in order, so dA is the same from run to run.
// Not done yet: overlapping the loads with cp.async or TMA, and fewer
// integer instructions per word (Philox4x32-7, or 16-bit words as the
// unfused JAX dropout uses).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FWD_NT = 256;                       // threads per CTA
constexpr int FWD_RPW = 2;                        // rows per warp
constexpr int FWD_ROWS = FWD_NT / 32 * FWD_RPW;   // rows per CTA
constexpr int FWD_CH = 512;                       // columns of A per stage
constexpr int FWD_PAD = 4;                        // shared row padding
constexpr int BWD_NT = 128;                       // threads per CTA
constexpr int BWD_COLS = BWD_NT * 4;              // columns per CTA
constexpr int BWD_ROWS = 128;                     // rows per CTA (one tile)
constexpr int SUM_NT = 256;

// Philox4x32-10: counter (c0, c1, 0, 0), key (k0, k1) -> four words
__device__ __forceinline__ void philox(uint32_t c0, uint32_t c1, uint32_t k0,
                                       uint32_t k1, uint32_t (&w)[4]) {
  uint32_t c2 = 0u, c3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  w[0] = c0;
  w[1] = c1;
  w[2] = c2;
  w[3] = c3;
}

template <bool FORCED>
__device__ __forceinline__ void words(const uint32_t* bits, size_t off, int n,
                                      int c, uint32_t k0, uint32_t k1,
                                      uint32_t (&w)[4]) {
  if (FORCED) {
    const uint4 u = *reinterpret_cast<const uint4*>(bits + off);
    w[0] = u.x;
    w[1] = u.y;
    w[2] = u.z;
    w[3] = u.w;
  } else {
    philox(static_cast<uint32_t>(n), static_cast<uint32_t>(c >> 2), k0, k1,
           w);
  }
}

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }

// v rounded to the storage type of the pointer's elements
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_as(float v, const float*) { return v; }

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Kernel 6.  Warp w of CTA b owns rows b * FWD_ROWS + w * FWD_RPW + [0,
// FWD_RPW); lane l owns columns 4l + 128k of every staged chunk.
template <typename T, typename TA, int MR, bool FORCED>
__global__ void __launch_bounds__(FWD_NT, 2)
    dropout_a_fwd_kernel(const T* __restrict__ x, const TA* __restrict__ a,
                         const uint32_t* __restrict__ bits,
                         float* __restrict__ out, int n_rows, int d,
                         uint32_t thresh, float x_scale, uint32_t k0,
                         uint32_t k1) {
  __shared__ __align__(16) float sa[MR][FWD_CH + FWD_PAD];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * FWD_ROWS + warp * FWD_RPW;
  float acc[FWD_RPW][MR];
#pragma unroll
  for (int r = 0; r < FWD_RPW; ++r)
#pragma unroll
    for (int j = 0; j < MR; ++j) acc[r][j] = 0.f;

  for (int c0 = 0; c0 < d; c0 += FWD_CH) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < FWD_CH * MR; i += FWD_NT) {
      const int c = i / MR, j = i - c * MR;
      sa[j][c] = c0 + c < d ? to_float(a[static_cast<size_t>(c0 + c) * MR + j])
                            : 0.f;
    }
    __syncthreads();
    for (int cc = 4 * lane; cc < FWD_CH && c0 + cc < d; cc += 128) {
      const int c = c0 + cc;
      float av[4][MR];
#pragma unroll
      for (int j = 0; j < MR; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(&sa[j][cc]);
        av[0][j] = v.x;
        av[1][j] = v.y;
        av[2][j] = v.z;
        av[3][j] = v.w;
      }
#pragma unroll
      for (int r = 0; r < FWD_RPW; ++r) {
        const int n = row0 + r;
        if (n >= n_rows) break;
        const size_t off = static_cast<size_t>(n) * d + c;
        uint32_t w[4];
        words<FORCED>(bits, off, n, c, k0, k1, w);
        float xv[4];
        load4(x + off, xv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float xd = w[e] < thresh ? round_as(xv[e] * x_scale, x) : 0.f;
#pragma unroll
          for (int j = 0; j < MR; ++j) acc[r][j] = fmaf(xd, av[e][j], acc[r][j]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < FWD_RPW; ++r)
#pragma unroll
    for (int j = 0; j < MR; ++j) {
      float v = acc[r][j];
#pragma unroll
      for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      acc[r][j] = v;
    }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < FWD_RPW; ++r) {
      const int n = row0 + r;
      if (n >= n_rows) break;
#pragma unroll
      for (int j = 0; j < MR; ++j) out[static_cast<size_t>(n) * MR + j] = acc[r][j];
    }
  }
}

// Kernel 7, first pass.  CTA (bx, by) owns columns bx * BWD_COLS + [0,
// BWD_COLS) (lane-owned in fours) and rows by * BWD_ROWS + [0, BWD_ROWS);
// it writes dx for its block and its dA partial to work[by].
template <typename T, typename TA, int MR, bool FORCED>
__global__ void __launch_bounds__(BWD_NT)
    dropout_a_bwd_kernel(const T* __restrict__ x, const TA* __restrict__ a,
                         const uint32_t* __restrict__ bits,
                         const float* __restrict__ g, T* __restrict__ dx,
                         float* __restrict__ work, int n_rows, int d,
                         uint32_t thresh, float inv_keep, uint32_t k0,
                         uint32_t k1) {
  __shared__ float sg[BWD_ROWS * MR];
  const int row0 = blockIdx.y * BWD_ROWS;
  const int rows = min(BWD_ROWS, n_rows - row0);
  for (int i = threadIdx.x; i < BWD_ROWS * MR; i += BWD_NT)
    sg[i] = i < rows * MR ? g[static_cast<size_t>(row0) * MR + i] : 0.f;
  __syncthreads();
  const int c = blockIdx.x * BWD_COLS + 4 * threadIdx.x;
  if (c >= d) return;  // no barrier follows

  float av[4][MR], acc[4][MR];
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int j = 0; j < MR; ++j) {
      av[e][j] = to_float(a[static_cast<size_t>(c + e) * MR + j]);
      acc[e][j] = 0.f;
    }
  for (int r = 0; r < rows; ++r) {
    const int n = row0 + r;
    const size_t off = static_cast<size_t>(n) * d + c;
    uint32_t w[4];
    words<FORCED>(bits, off, n, c, k0, k1, w);
    float xv[4], dv[4], gj[MR];
    load4(x + off, xv);
#pragma unroll
    for (int j = 0; j < MR; ++j) gj[j] = sg[r * MR + j];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float t = 0.f;
#pragma unroll
      for (int j = 0; j < MR; ++j) t = fmaf(gj[j], av[e][j], t);
      const float m = w[e] < thresh ? inv_keep : 0.f;
      dv[e] = t * m;
      const float xm = xv[e] * m;
#pragma unroll
      for (int j = 0; j < MR; ++j) acc[e][j] = fmaf(xm, gj[j], acc[e][j]);
    }
    store4(dx + off, dv);
  }
  float* wp = work + (static_cast<size_t>(blockIdx.y) * d + c) * MR;
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int j = 0; j < MR; ++j) wp[e * MR + j] = acc[e][j];
}

// Kernel 7, second pass: dA = the row tiles' partials summed in order.
__global__ void __launch_bounds__(SUM_NT)
    sum_tiles_kernel(const float* __restrict__ work, float* __restrict__ da,
                     int tiles, int dm) {
  const int i = blockIdx.x * SUM_NT + threadIdx.x;
  if (i >= dm) return;
  float s = 0.f;
  for (int t = 0; t < tiles; ++t) s += work[static_cast<size_t>(t) * dm + i];
  da[i] = s;
}

template <typename T, typename TA, int MR>
void fwd(const void* x, const void* a, const void* bits, void* out, int n,
         int d, uint32_t thresh, float x_scale, uint32_t k0, uint32_t k1,
         cudaStream_t stream) {
  const dim3 grid((n + FWD_ROWS - 1) / FWD_ROWS);
  const T* xp = static_cast<const T*>(x);
  const TA* ap = static_cast<const TA*>(a);
  const uint32_t* bp = static_cast<const uint32_t*>(bits);
  float* op = static_cast<float*>(out);
  if (bits)
    dropout_a_fwd_kernel<T, TA, MR, true><<<grid, FWD_NT, 0, stream>>>(
        xp, ap, bp, op, n, d, thresh, x_scale, k0, k1);
  else
    dropout_a_fwd_kernel<T, TA, MR, false><<<grid, FWD_NT, 0, stream>>>(
        xp, ap, bp, op, n, d, thresh, x_scale, k0, k1);
}

template <typename T, typename TA, int MR>
void bwd(const void* x, const void* a, const void* bits, const void* g,
         void* dx, void* work, int n, int d, uint32_t thresh, float inv_keep,
         uint32_t k0, uint32_t k1, cudaStream_t stream) {
  const dim3 grid((d + BWD_COLS - 1) / BWD_COLS,
                  (n + BWD_ROWS - 1) / BWD_ROWS);
  const T* xp = static_cast<const T*>(x);
  const TA* ap = static_cast<const TA*>(a);
  const uint32_t* bp = static_cast<const uint32_t*>(bits);
  const float* gp = static_cast<const float*>(g);
  T* dxp = static_cast<T*>(dx);
  float* wp = static_cast<float*>(work);
  if (bits)
    dropout_a_bwd_kernel<T, TA, MR, true><<<grid, BWD_NT, 0, stream>>>(
        xp, ap, bp, gp, dxp, wp, n, d, thresh, inv_keep, k0, k1);
  else
    dropout_a_bwd_kernel<T, TA, MR, false><<<grid, BWD_NT, 0, stream>>>(
        xp, ap, bp, gp, dxp, wp, n, d, thresh, inv_keep, k0, k1);
}

// The one M * r built: MokA AVT at rank 4 (3 modalities x 4).  Another value
// needs its own instance and its own check on the card.
constexpr int KERNEL_MR = 12;

template <typename T, typename TA>
bool fwd_mr(int mr, const void* x, const void* a, const void* bits, void* out,
            int n, int d, uint32_t thresh, float x_scale, uint32_t k0,
            uint32_t k1, cudaStream_t stream) {
  if (mr != KERNEL_MR) return false;
  fwd<T, TA, KERNEL_MR>(x, a, bits, out, n, d, thresh, x_scale, k0, k1,
                        stream);
  return true;
}

template <typename T, typename TA>
bool bwd_mr(int mr, const void* x, const void* a, const void* bits,
            const void* g, void* dx, void* work, int n, int d, uint32_t thresh,
            float inv_keep, uint32_t k0, uint32_t k1, cudaStream_t stream) {
  if (mr != KERNEL_MR) return false;
  bwd<T, TA, KERNEL_MR>(x, a, bits, g, dx, work, n, d, thresh, inv_keep, k0,
                        k1, stream);
  return true;
}

}  // namespace

// out (n, mr) fp32; bits null = Philox under (k0, k1).  Returns
// cudaGetLastError() after the launch.
extern "C" int moka_dropout_a_fwd(const void* x, int x_bf16, const void* a,
                                  int a_bf16, const void* bits, void* out,
                                  int n, int d, int mr, uint32_t thresh,
                                  float x_scale, uint32_t k0, uint32_t k1,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok;
  if (x_bf16)
    ok = a_bf16 ? fwd_mr<__nv_bfloat16, __nv_bfloat16>(
                      mr, x, a, bits, out, n, d, thresh, x_scale, k0, k1, s)
                : fwd_mr<__nv_bfloat16, float>(mr, x, a, bits, out, n, d,
                                               thresh, x_scale, k0, k1, s);
  else
    ok = a_bf16 ? fwd_mr<float, __nv_bfloat16>(mr, x, a, bits, out, n, d,
                                               thresh, x_scale, k0, k1, s)
                : fwd_mr<float, float>(mr, x, a, bits, out, n, d, thresh,
                                       x_scale, k0, k1, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// dx (n, d) in x's type; work (ceil(n / 128), d, mr) fp32 scratch; da
// (d, mr) fp32.  Two launches; returns the first error.
extern "C" int moka_dropout_a_bwd(const void* x, int x_bf16, const void* a,
                                  int a_bf16, const void* bits, const void* g,
                                  void* dx, void* work, void* da, int n, int d,
                                  int mr, uint32_t thresh, float inv_keep,
                                  uint32_t k0, uint32_t k1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok;
  if (x_bf16)
    ok = a_bf16 ? bwd_mr<__nv_bfloat16, __nv_bfloat16>(
                      mr, x, a, bits, g, dx, work, n, d, thresh, inv_keep, k0,
                      k1, s)
                : bwd_mr<__nv_bfloat16, float>(mr, x, a, bits, g, dx, work, n,
                                               d, thresh, inv_keep, k0, k1, s);
  else
    ok = a_bf16 ? bwd_mr<float, __nv_bfloat16>(mr, x, a, bits, g, dx, work, n,
                                               d, thresh, inv_keep, k0, k1, s)
                : bwd_mr<float, float>(mr, x, a, bits, g, dx, work, n, d,
                                       thresh, inv_keep, k0, k1, s);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int dm = d * mr;
  const int tiles = (n + BWD_ROWS - 1) / BWD_ROWS;
  sum_tiles_kernel<<<(dm + SUM_NT - 1) / SUM_NT, SUM_NT, 0, s>>>(
      static_cast<const float*>(work), static_cast<float*>(da), tiles, dm);
  return static_cast<int>(cudaGetLastError());
}
