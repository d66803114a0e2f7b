// Block-sparse (BSR) x dense SpMM on Hopper (sm_90a): C = BSR(A) @ B.
//
// Replaces the Pallas kernel _kernel of bsr_spmm (src/repro/kernels/
// bsr_spmm.py:37/:63), the forward of the BSR sparse linear layer and of
// every `bsr` plan.
//
// Inputs: the stored blocks `values` (nnz, bm, bk), each block's
// block-column `col_of` int32 (nnz,), sorted by block-row, and the start of
// each block-row's run `row_start` int32 (n_block_rows + 1,), derived once
// from the kernel's `row_of` list at prep; B (K, N) row-major. values and
// B are f32 or bf16 (the wrapper promotes the pair to one type). Output: C
// (n_block_rows * bm, N) in that type, the f32 accumulator cast once.
// Block sides are arbitrary and may differ (bm != bk); N is masked, so it
// need not be a multiple of any tile.
//
// The Pallas grid walks the stored blocks in order, resets its VMEM
// accumulator when row_of changes and flushes at a row's last block: it
// relies on consecutive grid steps revisiting one output tile. CUDA has no
// such order between blocks, so here one CTA owns one (block-row, rows,
// column tile) of C and loops over that row's run of stored blocks itself:
// the contraction of a block-row is the sequence of (block t, k) pairs, t
// ascending then k ascending, and every output element is summed in
// exactly that order. An empty run writes zeros; ops.bsr_kernel_meta also
// puts one zero tile in every empty block-row, as the Pallas contract
// needs, so both ways every output row is written.
//
// Four instances, chosen by the wrapper (bsr_spmm.gemm_geometry) from the
// type, the block shape, N and the operands' 16-byte alignment, never
// after a failure:
// - F32_FMA and BF16_WGMMA: the shared core of gemm_sm90.cuh with the BSR
//   K-tile source (bm a multiple of 64; bk a multiple of 16 for f32, of 64
//   for bf16; N a multiple of 4, of 8 for bf16). A 128 x 128 tile of C per
//   CTA (128 x 256 in bf16 where N > 128; rows past bm are zeros), split-K
//   over a row's run where the tiles under-fill the card.
// - GENERAL_F32 / GENERAL_BF16 (bsr_kernel<TM, T>): any block shape. The
//   CTA stages its (t, k) pairs in chunks of 16, which may span several
//   blocks when bk is small (10 at belcastro), so a small block does not
//   cost one barrier per block: the (rows, 16) slice of A's values,
//   transposed, and the matching 16 rows of B over the column tile, in
//   shared memory as f32; each thread holds a (TM, 4) register tile.
//   Shared memory 16 x (rows + 1) + 16 x bn floats, at most 16.7 KB.
//
// What bounds it on the H100: operations. At the granite-34b MLP operand
// (W_up^T, 24576 x 6144, block 128, 2,304 of 9,216 blocks live) and N = 512
// it does 38.65 GFLOP against 214 MB (values, B, C) in f32: 0.58 ms at the
// f32 rate outside the tensor cores, 0.064 ms of bytes; in bf16 0.039 ms of
// tensor-core operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

// The instance ids of the wrapper's bsr_spmm.INSTANCES.
enum Instance : int { F32_FMA = 0, BF16_WGMMA = 1, GENERAL_F32 = 2,
                      GENERAL_BF16 = 3 };

constexpr int kThreads = 256;
constexpr int kRowsMax = 128;  // rows of one block a CTA covers
constexpr int kKc = 16;        // (block, k) pairs staged per chunk
constexpr int kTn = 4;         // columns per thread (one float4)

// The general instance's layout, computed by the wrapper
// (bsr_spmm.general_layout).
struct Layout {
  int tm;           // rows per thread
  int row_threads;  // threads along the rows
  int col_threads;  // threads along the columns
  int rows_alloc;   // row_threads * tm >= rows covered
  int bn;           // column tile: col_threads * 4
  int n_sub;        // CTAs along one block's rows
};

template <int TM, typename T>
__global__ void __launch_bounds__(kThreads)
bsr_kernel(const int* __restrict__ row_start, const int* __restrict__ col_of,
           const T* __restrict__ values, const T* __restrict__ b,
           T* __restrict__ c, int n, int bm, int bk, Layout l) {
  extern __shared__ float smem[];
  const int as_stride = l.rows_alloc + 1;   // odd: the transposed store
  float* As = smem;                         // [kKc][as_stride]
  float* Bs = smem + kKc * as_stride;       // [kKc][bn]
  __shared__ size_t s_aoff[kKc];            // value offset of (t, k)
  __shared__ size_t s_boff[kKc];            // B row offset of (t, k)

  const int r = blockIdx.x / l.n_sub;       // block-row
  const int r0 = (blockIdx.x % l.n_sub) * kRowsMax;  // first row in block
  const int rows = min(kRowsMax, bm - r0);
  const int col0 = blockIdx.y * l.bn;
  const int tid = threadIdx.x;
  const int rt = tid / l.col_threads, ct = tid % l.col_threads;
  const bool active = rt < l.row_threads;

  float acc[TM][kTn];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kTn; ++j) acc[i][j] = 0.0f;

  const int t0 = row_start[r];
  const int q_total = (row_start[r + 1] - t0) * bk;
  for (int q0 = 0; q0 < q_total; q0 += kKc) {
    const int kc = min(kKc, q_total - q0);
    if (tid < kc) {
      const int q = q0 + tid;
      const int t = t0 + q / bk, k = q % bk;
      s_aoff[tid] = (size_t)t * bm * bk + (size_t)r0 * bk + k;
      s_boff[tid] = ((size_t)col_of[t] * bk + k) * n;
    }
    __syncthreads();
    for (int e = tid; e < l.rows_alloc * kc; e += kThreads) {
      const int row = e / kc, j = e % kc;
      As[j * as_stride + row] =
          row < rows ? to_f(values[s_aoff[j] + (size_t)row * bk]) : 0.0f;
    }
    for (int e = tid; e < kc * l.bn; e += kThreads) {
      const int j = e / l.bn, cc = e % l.bn;
      const int col = col0 + cc;
      Bs[j * l.bn + cc] = col < n ? to_f(b[s_boff[j] + col]) : 0.0f;
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < kc; ++j) {
        const float4 bv =
            *reinterpret_cast<const float4*>(Bs + j * l.bn + ct * kTn);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = As[j * as_stride + rt * TM + i];
          acc[i][0] = __fmaf_rn(a, bv.x, acc[i][0]);
          acc[i][1] = __fmaf_rn(a, bv.y, acc[i][1]);
          acc[i][2] = __fmaf_rn(a, bv.z, acc[i][2]);
          acc[i][3] = __fmaf_rn(a, bv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = rt * TM + i;
    if (row >= rows) break;
    T* cr = c + ((size_t)r * bm + r0 + row) * n;
#pragma unroll
    for (int j = 0; j < kTn; ++j) {
      const int col = col0 + ct * kTn + j;
      if (col < n) from_f(&cr[col], acc[i][j]);
    }
  }
}

template <typename T>
int launch_general(const int* row_start, const int* col_of,
                   const void* values, const void* b, void* c,
                   int n_block_rows, int bm, int bk, int n, const Layout& l,
                   int smem, cudaStream_t s) {
  dim3 grid((unsigned)n_block_rows * l.n_sub, (n + l.bn - 1) / l.bn);
  const T* v = static_cast<const T*>(values);
  const T* bb = static_cast<const T*>(b);
  T* cc = static_cast<T*>(c);
  switch (l.tm) {
    case 1:
      bsr_kernel<1, T><<<grid, kThreads, smem, s>>>(row_start, col_of, v, bb,
                                                    cc, n, bm, bk, l);
      break;
    case 2:
      bsr_kernel<2, T><<<grid, kThreads, smem, s>>>(row_start, col_of, v, bb,
                                                    cc, n, bm, bk, l);
      break;
    case 4:
      bsr_kernel<4, T><<<grid, kThreads, smem, s>>>(row_start, col_of, v, bb,
                                                    cc, n, bm, bk, l);
      break;
    case 8:
      bsr_kernel<8, T><<<grid, kThreads, smem, s>>>(row_start, col_of, v, bb,
                                                    cc, n, bm, bk, l);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// CTAs of the general instance of `tm` rows a thread that one SM holds.
template <typename T>
int general_ctas(int tm, int smem, int* ctas) {
  const void* fn = tm == 1   ? (const void*)bsr_kernel<1, T>
                   : tm == 2 ? (const void*)bsr_kernel<2, T>
                   : tm == 4 ? (const void*)bsr_kernel<4, T>
                   : tm == 8 ? (const void*)bsr_kernel<8, T>
                             : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn,
                                                            kThreads, smem);
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes. Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launch (0 = ok), or 100000 +
// the CUresult when a TMA tensor map cannot be encoded. The wrapper sizes
// the launch (bsr_spmm.gemm_geometry): B is (k, n); the instance, its
// tile's columns (128; 128 or 256 for BF16_WGMMA), the K splits (the grid's
// y), the ring's stages, the dynamic shared memory and, for the general
// instance, its layout (tm, row_threads, col_threads, rows_alloc, bn,
// n_sub); `ws` (splits x tiles x 128 x tile_n f32) and `tickets` (tiles
// int32, zeroed) only when splits > 1.
extern "C" {

const char* bsr_spmm_error_string(int err) { return hopper_error_string(err); }

// CTAs of one instance that one SM holds at the wrapper's geometry (tile
// columns, K splits, dynamic shared memory; the general instance's rows a
// thread `tm`), from the occupancy calculator.
int bsr_spmm_ctas_per_sm(int instance, int tile_n, int splits, int smem,
                         int tm, int* ctas) {
  switch (instance) {
    case F32_FMA:
      return gemm_f32_ctas_per_sm<BsrSrc<float, kF32Bk>>(splits, smem, ctas);
    case BF16_WGMMA:
      if (tile_n == 256)
        return gemm_bf16_ctas_per_sm<BsrSrc<__nv_bfloat16, kBf16Bk, 256>>(
            splits, smem, ctas);
      return gemm_bf16_ctas_per_sm<BsrSrc<__nv_bfloat16, kBf16Bk, 128>>(
          splits, smem, ctas);
    case GENERAL_F32: return general_ctas<float>(tm, smem, ctas);
    case GENERAL_BF16: return general_ctas<__nv_bfloat16>(tm, smem, ctas);
  }
  return (int)cudaErrorInvalidValue;
}

int bsr_spmm(const int* row_start, const int* col_of, const void* values,
             const void* b, void* c, int n_block_rows, int bm, int bk, int k,
             int n, int nnz, int instance, int tile_n, int splits, int stages,
             int smem, const int* layout, float* ws, int* tickets, int device,
             void* stream) {
  if (bm <= 0 || bk <= 0 || k <= 0 || n <= 0 || n_block_rows <= 0 ||
      nnz < 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  const int n_sub = (bm + kTileM - 1) / kTileM;
  const int col_tiles = (n + tile_n - 1) / tile_n;
  const int tiles = n_block_rows * n_sub * col_tiles;
  const Split sp{ws, tickets, tiles};
  if ((instance == F32_FMA && tile_n != kTileN) ||
      (instance == BF16_WGMMA && tile_n != 128 && tile_n != 256))
    return (int)cudaErrorInvalidValue;
  switch (instance) {
    case F32_FMA: {
      const BsrSrc<float, kF32Bk> src{
          row_start, col_of, static_cast<const float*>(values),
          static_cast<const float*>(b), static_cast<float*>(c), n, bm, bk,
          n_sub, col_tiles, 0, 0, 0, 0, 0};
      return launch_gemm_f32(src, tiles, splits, stages, smem, sp, s);
    }
    case BF16_WGMMA: {
      // values (nnz, bm, bk) as (bk, bm, nnz), innermost first; a map
      // needs a non-empty extent, and no tile loads a block of an empty
      // list.
      CUtensorMap ta, tb;
      const cuuint64_t dims[3] = {(cuuint64_t)bk, (cuuint64_t)bm,
                                  (cuuint64_t)(nnz > 0 ? nnz : 1)};
      const cuuint64_t strides[2] = {(cuuint64_t)bk * 2,
                                     (cuuint64_t)bm * bk * 2};
      const cuuint32_t box[3] = {kBf16Bk, kTileM, 1};
      err = encode_bf16(&ta, values, 3, dims, strides, box);
      if (!err) err = encode_b_bf16(&tb, b, k, n);
      if (err) return err;
      const auto* v16 = static_cast<const __nv_bfloat16*>(values);
      const auto* b16 = static_cast<const __nv_bfloat16*>(b);
      auto* c16 = static_cast<__nv_bfloat16*>(c);
      if (tile_n == 256)
        return launch_gemm_bf16(
            ta, tb, BsrSrc<__nv_bfloat16, kBf16Bk, 256>{
                        row_start, col_of, v16, b16, c16, n, bm, bk, n_sub,
                        col_tiles, 0, 0, 0, 0, 0},
            tiles, splits, stages, smem, sp, s);
      return launch_gemm_bf16(
          ta, tb, BsrSrc<__nv_bfloat16, kBf16Bk, 128>{
                      row_start, col_of, v16, b16, c16, n, bm, bk, n_sub,
                      col_tiles, 0, 0, 0, 0, 0},
          tiles, splits, stages, smem, sp, s);
    }
    case GENERAL_F32:
    case GENERAL_BF16: {
      const Layout l{layout[0], layout[1], layout[2], layout[3], layout[4],
                     layout[5]};
      if (instance == GENERAL_F32)
        return launch_general<float>(row_start, col_of, values, b, c,
                                     n_block_rows, bm, bk, n, l, smem, s);
      return launch_general<__nv_bfloat16>(row_start, col_of, values, b, c,
                                           n_block_rows, bm, bk, n, l, smem,
                                           s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
