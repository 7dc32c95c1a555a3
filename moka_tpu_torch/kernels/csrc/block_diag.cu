// Block-diagonal product for Hopper (sm_90a): y[z] = blockdiag(blocks[z]) @ x[z]
// without forming the dense matrix.
//
// Replaces the TPU kernel moka_tpu/ops/fbd.py::_bd_kernel (launched by
// block_diag_matmul).  Same contract: blocks (z, N, b, b) fp32 (Cayley's
// output), x and y (z, N*b, m) in bf16 or fp32, all contiguous;
// y[z, n*b + i, c] = sum_j blocks[z, n, i, j] * x[z, n*b + j, c], the products
// and the sum in fp32 and the result rounded once to y's type (JAX's
// dot_general(..., preferred_element_type=f32).astype(y.dtype); bf16 x
// promotes to fp32 exactly).  JAX's gate holds: b % 8 == 0, m % 128 == 0
// (and here b <= 144, what shared memory holds).
//
// Bound: every element of x is read once and every element of y written
// once, with 2*b flops per output (16 at b 8): at BOFT's block size 8 that
// is 8 flops per byte of bf16, far below the ~20 flop/byte at which fp32
// FMA (67 TFLOP/s) would overtake 3.35 TB/s.  So the bound is the bytes:
// 2 * 4096 * 4096 * 2 B = 67 MB, 20.0 us, for a 4096 x 4096 bf16 weight,
// and the only lever is keeping HBM busy.
//
// Design: stream the bytes.
//   * A tile is TR rows (whole blocks: TR = b * ceil(32 / b), 32 at b 8-32)
//     by 512 bytes of columns (256 bf16 or 128 fp32).  Tiles are numbered
//     (z, row band, column chunk), chunk fastest, and a grid of persistent
//     CTAs (as many as fit: two an SM at b 8) each walks a contiguous run,
//     so consecutive tiles of a CTA share their blocks.
//   * One producer thread (a fifth warp) feeds a ring of up to 4 stages by
//     TMA: each stage is four 2-D boxes of TR rows x 128 bytes with the
//     128-byte swizzle (hopper.cuh's swizzled_map), completed on an
//     mbarrier, with an L2 evict_first hint (x is read once).  At b 8: 16 KB
//     a stage, 128 KB of loads in flight on an SM.
//   * Four consumer warps read x from shared memory as it arrived (bf16
//     stays bf16 there) and widen it in registers: a lane takes 16 bytes of
//     each row (8 bf16 or 4 fp32 columns), a warp 512 contiguous bytes, so
//     a row costs the four shared-memory wavefronts its bytes need.  A warp
//     makes 8 output rows: at b 8 one block, whose 64 weights it holds in
//     registers (reloaded only when the band changes); above b 8 eight rows
//     of a block, whose weights sit transposed in shared memory (copied by
//     the consumers when the band changes), two 16-byte broadcasts a j.
//     The sum over j runs as an fp32 FMA chain in j order.  A warp releases
//     its stage to the producer as soon as its reads are done, then leaves
//     y by 16-byte stores, a warp's 512 contiguous bytes a row.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace {

using namespace moka_hopper;

constexpr int CONSUMERS = 4;              // consumer warps
constexpr int NT = 32 * (CONSUMERS + 1);  // and one producer warp
constexpr int ROW_BYTES = 512;            // a tile row: 32 lanes x 16 bytes
constexpr int BOX_BYTES = 128;            // a TMA box row (128-byte swizzle)
constexpr int MIN_ROWS = 32;              // tile rows, at least
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;        // a CTA's shared memory on sm_90

struct Shape {
  int N, b, m;
  int tr;      // rows a tile
  int stages;  // ring depth
  int bands;   // row bands a z
  int chunks;  // column chunks a row band
  int tiles;   // Z * bands * chunks
};

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

// lane's 16 bytes of tile row `row` in a stage of `tr` rows: box lane / 8,
// 16-byte chunk lane % 8 swizzled by the row (chunk c of row r sits at
// c ^ (r % 8))
template <typename T>
__device__ __forceinline__ const T* x_at(const uint8_t* xs, int tr, int row,
                                         int lane) {
  return reinterpret_cast<const T*>(
      xs + (lane >> 3) * tr * BOX_BYTES + row * BOX_BYTES +
      (((lane & 7) ^ (row & 7)) << 4));
}

__device__ __forceinline__ void decode(const Shape& sh, int t, int& z,
                                       int& band, int& chunk) {
  const int per_z = sh.bands * sh.chunks;
  z = t / per_z;
  band = (t % per_z) / sh.chunks;
  chunk = t % sh.chunks;
}

// BF = 8: b is 8, a warp's block in registers; BF = 0: any b % 8 == 0, the
// band's blocks transposed in shared memory
template <typename T, int BF>
__global__ void __launch_bounds__(NT, 2)
    block_diag_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const float* __restrict__ blocks, T* __restrict__ y,
                      Shape sh) {
  constexpr int VEC = 16 / sizeof(T);             // columns a lane
  constexpr int BOX_COLS = BOX_BYTES / sizeof(T);  // columns a box
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(sm);
  const int stage_bytes = sh.tr * ROW_BYTES;
  float* bt = reinterpret_cast<float*>(sm + sh.stages * stage_bytes);
  const uint32_t bars =
      base + sh.stages * stage_bytes + (BF ? 0 : sh.tr * sh.b * 4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < sh.stages; ++s) {
      mbar_init(bars + 8 * s, 1);                         // full
      mbar_init(bars + 8 * (MAX_STAGES + s), CONSUMERS);  // empty
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int t0 = static_cast<int>(static_cast<long>(blockIdx.x) * sh.tiles /
                                  gridDim.x);
  const int t1 = static_cast<int>(static_cast<long>(blockIdx.x + 1) *
                                  sh.tiles / gridDim.x);
  const int rows = sh.N * sh.b;  // rows of x a z

  if (warp == CONSUMERS) {  // the producer
    if (lane == 0) {
      const uint64_t policy = l2_evict_first();
      for (int t = t0, i = 0; t < t1; ++t, ++i) {
        const int s = i % sh.stages;
        if (i >= sh.stages)
          mbar_wait(bars + 8 * (MAX_STAGES + s), ((i / sh.stages) - 1) & 1);
        int z, band, chunk;
        decode(sh, t, z, band, chunk);
        const int c0 = chunk * (ROW_BYTES / static_cast<int>(sizeof(T)));
        // boxes wholly past m are not loaded (m % 128 == 0: a box is
        // wholly in or out); rows past N * b load as zero
        const int boxes = min(ROW_BYTES / BOX_BYTES, (sh.m - c0) / BOX_COLS);
        mbar_arrive_expect_tx(bars + 8 * s, boxes * sh.tr * BOX_BYTES);
        for (int q = 0; q < boxes; ++q)
          tma_load_4d(base + s * stage_bytes + q * sh.tr * BOX_BYTES, &tm_x,
                      bars + 8 * s, c0 + q * BOX_COLS, band * sh.tr, z, 0,
                      policy);
      }
    }
    return;
  }

  float w[BF ? 8 : 1][BF ? 8 : 1];  // b 8: the warp's block
  int cur = -1;                       // the band whose blocks are held
  for (int t = t0, i = 0; t < t1; ++t, ++i) {
    const int s = i % sh.stages;
    int z, band, chunk;
    decode(sh, t, z, band, chunk);
    const int nb = sh.tr / sh.b;  // blocks a band
    if (z * sh.bands + band != cur) {
      cur = z * sh.bands + band;
      if (BF) {
        const int n = band * nb + warp;
        if (n < sh.N) {
          const float* bp = blocks + (static_cast<long>(z) * sh.N + n) * 64;
#pragma unroll
          for (int i8 = 0; i8 < 8; ++i8)
#pragma unroll
            for (int j = 0; j < 8; ++j) w[i8][j] = __ldg(bp + i8 * 8 + j);
        }
      } else {
        named_bar_sync(1, 32 * CONSUMERS);  // the last band's blocks are read
        const int bb = sh.b * sh.b;
        for (int e = threadIdx.x; e < nb * bb; e += 32 * CONSUMERS) {
          const int kb = e / bb, i8 = (e % bb) / sh.b, j = e % sh.b;
          const int n = band * nb + kb;
          bt[(kb * sh.b + j) * sh.b + i8] =
              n < sh.N ? __ldg(blocks + ((static_cast<long>(z) * sh.N + n) *
                                             sh.b + i8) * sh.b + j)
                       : 0.f;
        }
        named_bar_sync(1, 32 * CONSUMERS);
      }
    }
    mbar_wait(bars + 8 * s, (i / sh.stages) & 1);
    const uint8_t* xs = sm + s * stage_bytes;
    const int c = chunk * (ROW_BYTES / static_cast<int>(sizeof(T))) +
                  lane * VEC;
    T* yz = y + static_cast<long>(z) * rows * sh.m;
    if (BF) {
      float acc[8][VEC];
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i8][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float xv[VEC];
        load16(x_at<T>(xs, sh.tr, warp * 8 + j, lane), xv);
#pragma unroll
        for (int i8 = 0; i8 < 8; ++i8)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[i8][e] = fmaf(w[i8][j], xv[e], acc[i8][e]);
      }
      // the warp's reads of the stage are performed before the producer's
      // next TMA (async-proxy) write into it: without the proxy fence the
      // fp32 path at b 8 read a box already overwritten in about one
      // launch in twenty
      fence_proxy_async_smem();
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (MAX_STAGES + s));
      const int row = band * sh.tr + warp * 8;
      if (row < rows && c < sh.m) {
#pragma unroll
        for (int i8 = 0; i8 < 8; ++i8)
          store16(yz + static_cast<long>(row + i8) * sh.m + c, acc[i8]);
      }
    } else {
      for (int g = warp; g < sh.tr / 8; g += CONSUMERS) {
        const int kb = g * 8 / sh.b, i0 = g * 8 % sh.b;
        float acc[8][VEC];
#pragma unroll
        for (int i8 = 0; i8 < 8; ++i8)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[i8][e] = 0.f;
        for (int j = 0; j < sh.b; ++j) {
          float xv[VEC], wj[8];
          load16(x_at<T>(xs, sh.tr, kb * sh.b + j, lane), xv);
          const float* wp = bt + (kb * sh.b + j) * sh.b + i0;
          load16(wp, wj);
          load16(wp + 4, wj + 4);
#pragma unroll
          for (int i8 = 0; i8 < 8; ++i8)
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[i8][e] = fmaf(wj[i8], xv[e], acc[i8][e]);
        }
        const int row = band * sh.tr + g * 8;
        if (row < rows && c < sh.m) {
#pragma unroll
          for (int i8 = 0; i8 < 8; ++i8)
            store16(yz + static_cast<long>(row + i8) * sh.m + c, acc[i8]);
        }
      }
      fence_proxy_async_smem();  // as above
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (MAX_STAGES + s));
    }
  }
}

template <typename T, int BF>
int launch(const float* blocks, const void* x, void* y, int Z, int N, int b,
           int m, cudaStream_t st) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      block_diag_kernel<T, BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_LIMIT);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  Shape sh;
  sh.N = N;
  sh.b = b;
  sh.m = m;
  sh.tr = b * ((MIN_ROWS + b - 1) / b);
  const int fixed = 1024 + (BF ? 0 : sh.tr * b * 4) + 16 * MAX_STAGES;
  sh.stages = min(MAX_STAGES, (SMEM_LIMIT - fixed) / (sh.tr * ROW_BYTES));
  if (sh.tr > 256 || sh.stages < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = fixed + sh.stages * sh.tr * ROW_BYTES;
  const long rows = static_cast<long>(N) * b;
  sh.bands = static_cast<int>((rows + sh.tr - 1) / sh.tr);
  sh.chunks = (m * static_cast<int>(sizeof(T)) + ROW_BYTES - 1) / ROW_BYTES;
  const long tiles = static_cast<long>(Z) * sh.bands * sh.chunks;
  if (tiles >= (1L << 31) / 2) return static_cast<int>(cudaErrorInvalidValue);
  sh.tiles = static_cast<int>(tiles);
  // x over (m, N * b, Z), padded to four dimensions, in boxes of 128 bytes
  // of columns by tr rows
  CUtensorMap tm;
  const uint64_t dims[4] = {uint64_t(m), uint64_t(rows), uint64_t(Z), 1};
  const uint32_t box[4] = {uint32_t(BOX_BYTES / sizeof(T)),
                           uint32_t(sh.tr), 1, 1};
  if (!swizzled_map(&tm,
                    sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                    sizeof(T), 4, x, dims, box))
    return static_cast<int>(cudaErrorInvalidValue);
  // CTAs an SM at this shared memory (fixed for an instance and b), asked
  // once: a launch inside a CUDA graph capture makes no other CUDA call
  static int per_sm_by_b[144 / 8 + 1] = {};
  int& per_sm = per_sm_by_b[b / 8];
  if (per_sm == 0) {
    const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, block_diag_kernel<T, BF>, NT, smem);
    if (occ != cudaSuccess) return static_cast<int>(occ);
    per_sm = per_sm > 0 ? per_sm : 1;
  }
  const long ctas = static_cast<long>(sm_count()) * per_sm;
  const int grid = static_cast<int>(tiles < ctas ? tiles : ctas);
  block_diag_kernel<T, BF><<<grid, NT, smem, st>>>(
      tm, blocks, static_cast<T*>(y), sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks (Z, N, b, b) fp32; x, y (Z, N*b, m) bf16 (is_bf16 = 1) or fp32; all
// contiguous and 16-byte aligned; b % 8 == 0 (b <= 144), m % 128 == 0.
// Returns cudaGetLastError() (or the error of setting up the launch).
extern "C" int moka_block_diag(const void* blocks, const void* x, void* y,
                               int Z, int N, int b, int m, int is_bf16,
                               void* stream) {
  if (Z <= 0 || N <= 0 || b <= 0 || m <= 0 || b % 8 != 0 || m % 128 != 0 ||
      static_cast<long>(N) * b > (1L << 31) / 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* bp = static_cast<const float*>(blocks);
  if (is_bf16)
    return b == 8 ? launch<__nv_bfloat16, 8>(bp, x, y, Z, N, b, m, st)
                  : launch<__nv_bfloat16, 0>(bp, x, y, Z, N, b, m, st);
  return b == 8 ? launch<float, 8>(bp, x, y, Z, N, b, m, st)
                : launch<float, 0>(bp, x, y, Z, N, b, m, st);
}
