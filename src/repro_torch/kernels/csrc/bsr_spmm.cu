// Block-sparse (BSR) x dense SpMM on Hopper (sm_90a): C = BSR(A) @ B.
//
// Replaces the Pallas kernel _kernel of bsr_spmm (src/repro/kernels/
// bsr_spmm.py:37/:63), the forward of the BSR sparse linear layer and of
// every `bsr` plan.
//
// Inputs: the stored blocks `values` f32 (nnz, bm, bk), each block's
// block-column `col_of` int32 (nnz,), sorted by block-row, and the start of
// each block-row's run `row_start` int32 (n_block_rows + 1,), derived once
// from the kernel's `row_of` list at prep; B f32 (K, N) row-major. Output:
// C f32 (n_block_rows * bm, N). Block sides are arbitrary and may differ
// (bm != bk); N is masked, so it need not be a multiple of any tile.
//
// The Pallas grid walks the stored blocks in order, resets its VMEM
// accumulator when row_of changes and flushes at a row's last block: it
// relies on consecutive grid steps revisiting one output tile. CUDA has no
// such order between blocks, so here one CTA owns one (block-row, column
// tile) of C, up to 128 rows of it, and loops over that row's run of
// stored blocks itself. The contraction of a block-row is the sequence of
// (block t, k) pairs, t ascending then k ascending; the CTA stages it in
// chunks of 16 pairs, which may span several blocks when bk is small
// (10 at belcastro), so a small block does not cost one barrier per block.
// Each chunk stages the (rows, 16) slice of A's values, transposed, and the
// matching 16 rows of B (block-row col_of[t], row k) over the column tile
// in shared memory. Each thread holds a (TM, 4) register tile and sums
// with __fmaf_rn in exactly that (t, k) order, from 0, so every output
// element has one fixed summation order. The tile is written once.
//
// An empty run writes zeros; ops.bsr_kernel_meta also puts one zero tile
// in every empty block-row, as the Pallas contract needs, so both ways
// every output row is written.
//
// Shared memory: 16 x (rows + 1) + 16 x bn floats, at most 16.7 KB for any
// block shape, under the 48 KB a block gets without opting in; the wrapper
// still checks it against the card's 227 KB.
//
// What bounds it on the H100: operations. At the granite-34b MLP operand
// (W_up^T, 24576 x 6144, block 128, 2,304 of 9,216 blocks live) and N = 512
// it does 38.65 GFLOP against 214 MB (values, B, C): 0.58 ms at the f32 rate
// outside the tensor cores, 0.064 ms of bytes. This first version uses f32
// FMA from a register tile; wgmma (which would need TF32 or bf16) and TMA
// are later work. No TF32: the sums are IEEE f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsMax = 128;  // rows of one block a CTA covers
constexpr int kKc = 16;        // (block, k) pairs staged per chunk
constexpr int kTn = 4;         // columns per thread (one float4)
constexpr int kColThreadsMax = 64;  // column tile at most 256 wide

struct Layout {
  int tm;           // rows per thread
  int row_threads;  // threads along the rows
  int col_threads;  // threads along the columns
  int rows_alloc;   // row_threads * tm >= rows covered
  int bn;           // column tile: col_threads * 4
  int n_sub;        // CTAs along one block's rows
};

Layout layout_for(int bm) {
  Layout l;
  const int rows = bm < kRowsMax ? bm : kRowsMax;
  const int need = (rows + 15) / 16;  // rows per thread for <= 16 row threads
  l.tm = need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : 8;
  l.row_threads = (rows + l.tm - 1) / l.tm;
  l.col_threads = kThreads / l.row_threads;
  if (l.col_threads > kColThreadsMax) l.col_threads = kColThreadsMax;
  l.rows_alloc = l.row_threads * l.tm;
  l.bn = l.col_threads * kTn;
  l.n_sub = (bm + kRowsMax - 1) / kRowsMax;
  return l;
}

size_t smem_for(const Layout& l) {
  return (size_t)kKc * (l.rows_alloc + 1 + l.bn) * sizeof(float);
}

template <int TM>
__global__ void __launch_bounds__(kThreads)
bsr_kernel(const int* __restrict__ row_start, const int* __restrict__ col_of,
           const float* __restrict__ values, const float* __restrict__ b,
           float* __restrict__ c, int n, int bm, int bk, Layout l) {
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
          row < rows ? values[s_aoff[j] + (size_t)row * bk] : 0.0f;
    }
    for (int e = tid; e < kc * l.bn; e += kThreads) {
      const int j = e / l.bn, cc = e % l.bn;
      const int col = col0 + cc;
      Bs[j * l.bn + cc] = col < n ? b[s_boff[j] + col] : 0.0f;
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
    float* cr = c + ((size_t)r * bm + r0 + row) * n;
#pragma unroll
    for (int j = 0; j < kTn; ++j) {
      const int col = col0 + ct * kTn + j;
      if (col < n) cr[col] = acc[i][j];
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes. Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launch (0 = ok).
extern "C" {

size_t bsr_spmm_smem_bytes(int bm) { return smem_for(layout_for(bm)); }

const char* bsr_spmm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int bsr_spmm(const int* row_start, const int* col_of, const float* values,
             const float* b, float* c, int n_block_rows, int bm, int bk,
             int n, int device, void* stream) {
  if (bm <= 0 || bk <= 0 || n <= 0 || n_block_rows <= 0)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const Layout l = layout_for(bm);
  const size_t smem = smem_for(l);
  dim3 grid((unsigned)n_block_rows * l.n_sub, (n + l.bn - 1) / l.bn);
  cudaStream_t s = (cudaStream_t)stream;
  switch (l.tm) {
    case 1:
      bsr_kernel<1><<<grid, kThreads, smem, s>>>(row_start, col_of, values,
                                                 b, c, n, bm, bk, l);
      break;
    case 2:
      bsr_kernel<2><<<grid, kThreads, smem, s>>>(row_start, col_of, values,
                                                 b, c, n, bm, bk, l);
      break;
    case 4:
      bsr_kernel<4><<<grid, kThreads, smem, s>>>(row_start, col_of, values,
                                                 b, c, n, bm, bk, l);
      break;
    default:
      bsr_kernel<8><<<grid, kThreads, smem, s>>>(row_start, col_of, values,
                                                 b, c, n, bm, bk, l);
      break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
