// Block-diagonal product for Hopper (sm_90a): y[z] = blockdiag(blocks[z]) @ x[z]
// without forming the dense matrix.
//
// Replaces the TPU kernel moka_tpu/ops/fbd.py::_bd_kernel (launched by
// block_diag_matmul).  Same contract: blocks (z, N, b, b) fp32 (Cayley's
// output), x and y (z, N*b, m) in bf16 or fp32, all contiguous;
// y[z, n*b + i, c] = sum_j blocks[z, n, i, j] * x[z, n*b + j, c], the products
// and the sum in fp32 and the result rounded once to y's type (JAX's
// dot_general(..., preferred_element_type=f32).astype(y.dtype); bf16 x
// promotes to fp32 exactly).  JAX's gate holds: b % 8 == 0, m % 128 == 0.
//
// Bound: every element of x is read once and every element of y written
// once, with 2*b flops per output (16 at b 8): at BOFT's block size 8 that
// is 8 flops per byte of bf16, far below the ~20 flop/byte at which fp32
// FMA (67 TFLOP/s) would overtake 3.35 TB/s.  So the bound is the bytes:
// 2 * 4096 * 4096 * 2 B = 67 MB, 20.0 us, for a 4096 x 4096 bf16 weight.
//
// Design: one CTA of 128 threads per (column tile of TC = 256, block n,
// z).  The CTA stages its b x b block and the b x TC tile of x in shared
// memory as fp32 (16-byte loads along m, neighbouring threads on
// neighbouring addresses), then each thread produces 16 bytes of one output
// row (8 bf16 or 4 fp32 columns) as a fp32 FMA chain over j = 0..b-1 and
// stores them with one 16-byte store.  Any b % 8 works: shared memory is
// b * (b + TC) * 4 bytes (10 KB at b 8), dynamic above 48 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per CTA
constexpr int TC = 256;  // columns per CTA

__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]))) << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__global__ void __launch_bounds__(NT)
    block_diag_kernel(const float* __restrict__ blocks, const T* __restrict__ x,
                      T* __restrict__ y, int N, int b, int m) {
  constexpr int VEC = 16 / sizeof(T);  // elements per 16 bytes
  constexpr int CPR = TC / VEC;        // 16-byte chunks per tile row
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // b x TC
  float* bs = smem + b * TC;      // b x b
  const int n = blockIdx.y, zz = blockIdx.z;
  const int col0 = blockIdx.x * TC;
  const long blk = static_cast<long>(zz) * N + n;
  const long row0 = blk * b;  // first row of this block in x and y

  const float* bp = blocks + blk * b * b;
  for (int i = threadIdx.x; i < b * b; i += NT) bs[i] = bp[i];
  for (int i = threadIdx.x; i < b * CPR; i += NT) {
    const int r = i / CPR, ch = i % CPR;
    const int c = col0 + ch * VEC;
    float v[VEC];
    if (c < m) {
      load16(x + (row0 + r) * m + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; e += 4) store16(xs + r * TC + ch * VEC + e, v + e);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < b * CPR; i += NT) {
    const int r = i / CPR, ch = i % CPR;
    const int c = col0 + ch * VEC;
    if (c >= m) continue;  // m % 128 == 0: a chunk is wholly in or out
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int j = 0; j < b; ++j) {
      const float w = bs[r * b + j];
      float xv[VEC];
#pragma unroll
      for (int e = 0; e < VEC; e += 4) load16(xs + j * TC + ch * VEC + e, xv + e);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = fmaf(w, xv[e], acc[e]);
    }
    store16(y + (row0 + r) * m + c, acc);
  }
}

template <typename T>
int launch(const float* blocks, const void* x, void* y, int Z, int N, int b,
           int m, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(b) * (TC + b) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        block_diag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((m + TC - 1) / TC, N, Z);
  block_diag_kernel<T><<<grid, NT, smem, st>>>(
      blocks, static_cast<const T*>(x), static_cast<T*>(y), N, b, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks (Z, N, b, b) fp32; x, y (Z, N*b, m) bf16 (is_bf16 = 1) or fp32; all
// contiguous and 16-byte aligned; b % 8 == 0, m % 128 == 0.  Returns
// cudaGetLastError() (or the error of raising the shared-memory limit).
extern "C" int moka_block_diag(const void* blocks, const void* x, void* y,
                               int Z, int N, int b, int m, int is_bf16,
                               void* stream) {
  if (Z <= 0 || N <= 0 || b <= 0 || m <= 0 || b % 8 != 0 || m % 128 != 0 ||
      N > 65535 || Z > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* bp = static_cast<const float*>(blocks);
  if (is_bf16) return launch<__nv_bfloat16>(bp, x, y, Z, N, b, m, st);
  return launch<float>(bp, x, y, Z, N, b, m, st);
}
