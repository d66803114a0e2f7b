// Tiled dense matmul on Hopper (sm_90a): C = A @ B in f32.
//
// Replaces the Pallas kernel _kernel of dense_mm (src/repro/kernels/
// dense_mm.py:21/:35), the paper's "conventional MM" baseline and the
// kernel of every `dense` plan.
//
// Inputs: A f32 (M, K) and B f32 (K, N), both row-major; output C f32
// (M, N). The Pallas kernel needs every dimension a multiple of its
// (128, 128, 128) tiles, so its caller pads A and B and trims C. Here the
// ragged edges are masked inside the kernel (out-of-range loads read 0,
// out-of-range stores are skipped), so the caller pads nothing: at the
// granite-34b MLP operand A alone is 604 MB.
//
// Design: the classic shared-memory SGEMM. A CTA of 256 threads owns a
// 128 x 128 tile of C and walks K in steps of 8: it stages A's (128, 8)
// slice transposed and B's (8, 128) slice in shared memory, then each
// thread accumulates an 8 x 8 register tile (rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, the same for columns, so the float4 reads of a
// quarter warp fall on distinct banks) with __fmaf_rn, k ascending, from 0,
// and writes it once. Like the Pallas kernel's, the accumulator is f32.
//
// What bounds it on the H100: operations. At granite's W_up^T (24576 x
// 6144) and N = 512 it does 154.6 GFLOP against 667 MB: 2.31 ms at the f32
// rate outside the tensor cores, 0.20 ms of bytes. This first version is
// f32 FMA only: no TF32, no tensor cores (wgmma needs TF32 or bf16, later
// modes), no TMA or cp.async double buffering (later work).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBm = 128, kBn = 128, kBk = 8;

// One k step of a thread's 8 x 8 register tile.
__device__ __forceinline__ void fma_step(const float (*As)[kBm],
                                         const float (*Bs)[kBn], int kk,
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

__global__ void __launch_bounds__(kThreads)
dense_kernel(const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) float As[kBk][kBm];  // transposed: As[k][row]
  __shared__ __align__(16) float Bs[kBk][kBn];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * kBm, col0 = blockIdx.x * kBn;
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
          (ga < m && gk < k) ? a[(size_t)ga * k + gk] : 0.0f;
    }
    const int gkb = k0 + b_k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gc = col0 + b_col + i;
      Bs[b_k][b_col + i] =
          (gkb < k && gc < n) ? b[(size_t)gkb * n + gc] : 0.0f;
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
    float* cr = c + (size_t)row * n;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < n) cr[col] = acc[i][j];
    }
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes. Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launch (0 = ok).
extern "C" {

const char* dense_mm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int dense_mm(const float* a, const float* b, float* c, int m, int n, int k,
             int device, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  dim3 grid((n + kBn - 1) / kBn, (m + kBm - 1) / kBm);
  dense_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a, b, c, m, n,
                                                            k);
  return (int)cudaGetLastError();
}

}  // extern "C"
