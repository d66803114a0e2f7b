// Tiled dense matmul on Hopper (sm_90a): C = A @ B with f32 sums.
//
// Replaces the Pallas kernel _kernel of dense_mm (src/repro/kernels/
// dense_mm.py:21/:35), the paper's "conventional MM" baseline and the
// kernel of every `dense` plan.
//
// Inputs: A (M, K) and B (K, N), both row-major, f32 or bf16 (the wrapper
// promotes the pair to one type); output C (M, N) in that type, the f32
// accumulator cast once. The Pallas kernel needs every dimension a
// multiple of its (128, 128, 128) tiles, so its caller pads A and B and
// trims C. Here the ragged edges are masked inside the kernels, so the
// caller pads nothing: at the granite-34b MLP operand A alone is 604 MB.
//
// Four instances, chosen by the wrapper (dense_mm.gemm_geometry) from the
// type, the shape and the operands' 16-byte alignment, never after a
// failure:
// - F32_FMA: the shared core of gemm_sm90.cuh, f32 FMA behind a cp.async
//   ring, split-K where the tiles under-fill the card (K and N multiples of
//   4). What bounds it: operations. At granite's W_up^T (24576 x 6144) and
//   N = 512 it does 154.6 GFLOP against 667 MB: 2.31 ms at the f32 rate
//   outside the tensor cores (67 TFLOP/s), 0.20 ms of bytes.
// - BF16_WGMMA: the core's wgmma instance (K and N multiples of 8; tiles
//   128 x 256 where N > 128): 0.156 ms of bf16 tensor-core operations (989
//   TFLOP/s) at granite, 0.10 ms of bytes.
// - GENERAL_F32 / GENERAL_BF16: any shape. A CTA of 256 threads owns a
//   128 x 128 tile and walks K in steps of 8, staging A's slice transposed
//   and B's in shared memory (converted to f32 on load), and each thread
//   sums an 8 x 8 register tile with __fmaf_rn, k ascending, from 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

// The instance ids of the wrapper's dense_mm.INSTANCES.
enum Instance : int { F32_FMA = 0, BF16_WGMMA = 1, GENERAL_F32 = 2,
                      GENERAL_BF16 = 3 };

constexpr int kThreads = 256;
constexpr int kBk = 8;

// One k step of a thread's 8 x 8 register tile.
__device__ __forceinline__ void fma_step(const float (*As)[kTileM],
                                         const float (*Bs)[kTileN], int kk,
                                         int tx, int ty, float (&acc)[8][8]) {
  const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
  const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][64 + ty * 4]);
  const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
  const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][64 + tx * 4]);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dense_kernel(const T* __restrict__ a, const T* __restrict__ b,
             T* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) float As[kBk][kTileM];  // transposed: As[k][row]
  __shared__ __align__(16) float Bs[kBk][kTileN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kTileM, col0 = blockIdx.x * kTileN;
  // staging: A as 128 rows x 2 groups of 4 k, B as 8 k x 32 groups of 4
  const int a_row = tid / 2, a_k = (tid % 2) * 4;
  const int b_k = tid / 32, b_col = (tid % 32) * 4;
  const int ga = row0 + a_row;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += kBk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gk = k0 + a_k + i;
      As[a_k + i][a_row] =
          (ga < m && gk < k) ? to_f(a[(size_t)ga * k + gk]) : 0.0f;
    }
    const int gkb = k0 + b_k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gc = col0 + b_col + i;
      Bs[b_k][b_col + i] =
          (gkb < k && gc < n) ? to_f(b[(size_t)gkb * n + gc]) : 0.0f;
    }
    __syncthreads();
    const int kc = min(kBk, k - k0);
    if (kc == kBk) {
#pragma unroll
      for (int kk = 0; kk < kBk; ++kk) fma_step(As, Bs, kk, tx, ty, acc);
    } else {
      for (int kk = 0; kk < kc; ++kk) fma_step(As, Bs, kk, tx, ty, acc);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= m) continue;
    T* cr = c + (size_t)row * n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < n) from_f(&cr[col], acc[i][j]);
    }
  }
}

template <typename T>
int launch_general(const void* a, const void* b, void* c, int m, int n,
                   int k, cudaStream_t s) {
  dim3 grid((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM);
  dense_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes. Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launch (0 = ok), or 100000 +
// the CUresult when a TMA tensor map cannot be encoded. The wrapper sizes
// the launch (dense_mm.gemm_geometry): the instance, its tile's columns
// (128; 128 or 256 for BF16_WGMMA), the K splits (the grid's y), the ring's
// stages and the dynamic shared memory; `ws` (splits x tiles x 128 x tile_n
// f32) and `tickets` (tiles int32, zeroed) only when splits > 1.
extern "C" {

const char* dense_mm_error_string(int err) { return hopper_error_string(err); }

// CTAs of one instance that one SM holds at the wrapper's geometry (its
// tile columns, K splits and dynamic shared memory), from the occupancy
// calculator.
int dense_mm_ctas_per_sm(int instance, int tile_n, int splits, int smem,
                         int* ctas) {
  switch (instance) {
    case F32_FMA:
      return gemm_f32_ctas_per_sm<DenseSrc<float, kF32Bk>>(splits, smem,
                                                           ctas);
    case BF16_WGMMA:
      if (tile_n == 256)
        return gemm_bf16_ctas_per_sm<DenseSrc<__nv_bfloat16, kBf16Bk, 256>>(
            splits, smem, ctas);
      return gemm_bf16_ctas_per_sm<DenseSrc<__nv_bfloat16, kBf16Bk, 128>>(
          splits, smem, ctas);
    case GENERAL_F32:
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas, dense_kernel<float>, kThreads, 0);
    case GENERAL_BF16:
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          ctas, dense_kernel<__nv_bfloat16>, kThreads, 0);
  }
  return (int)cudaErrorInvalidValue;
}

int dense_mm(const void* a, const void* b, void* c, int m, int n, int k,
             int instance, int tile_n, int splits, int stages, int smem,
             float* ws, int* tickets, int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int col_tiles = (n + tile_n - 1) / tile_n;
  const int tiles = ((m + kTileM - 1) / kTileM) * col_tiles;
  const Split sp{ws, tickets, tiles};
  if ((instance == F32_FMA && tile_n != kTileN) ||
      (instance == BF16_WGMMA && tile_n != 128 && tile_n != 256))
    return (int)cudaErrorInvalidValue;
  switch (instance) {
    case F32_FMA: {
      const DenseSrc<float, kF32Bk> src{
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(c), m, n, k, col_tiles, 0, 0};
      return launch_gemm_f32(src, tiles, splits, stages, smem, sp, s);
    }
    case BF16_WGMMA: {
      CUtensorMap ta, tb;
      const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
      const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
      const cuuint32_t box[2] = {kBf16Bk, kTileM};
      err = encode_bf16(&ta, a, 2, dims, strides, box);
      if (!err) err = encode_b_bf16(&tb, b, k, n);
      if (err) return err;
      const auto* a16 = static_cast<const __nv_bfloat16*>(a);
      const auto* b16 = static_cast<const __nv_bfloat16*>(b);
      auto* c16 = static_cast<__nv_bfloat16*>(c);
      if (tile_n == 256)
        return launch_gemm_bf16(
            ta, tb, DenseSrc<__nv_bfloat16, kBf16Bk, 256>{
                        a16, b16, c16, m, n, k, col_tiles, 0, 0},
            tiles, splits, stages, smem, sp, s);
      return launch_gemm_bf16(
          ta, tb, DenseSrc<__nv_bfloat16, kBf16Bk, 128>{
                      a16, b16, c16, m, n, k, col_tiles, 0, 0},
          tiles, splits, stages, smem, sp, s);
    }
    case GENERAL_F32: return launch_general<float>(a, b, c, m, n, k, s);
    case GENERAL_BF16:
      return launch_general<__nv_bfloat16>(a, b, c, m, n, k, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
