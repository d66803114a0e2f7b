// Round-synchronized index matching on Hopper (sm_90a): C = A @ B^T for two
// sparse operands in the per-round padded form of ops.prep_rounds.
//
// Replaces three Pallas kernels:
//   match_kernel<false> <- _kernel         (index_match_spmm, src/repro/
//                          kernels/index_match_spmm.py:48/:68)
//   match_kernel<true>  <- _condense_kernel (spgemm_condense,  src/repro/
//                          spgemm/kernels.py:48/:59)
//   merge_kernel        <- _merge_kernel    (spgemm_merge,     src/repro/
//                          spgemm/kernels.py:97/:111)
//
// Inputs: idx int32 / val f32 of shape (rows, n_rounds, rmax), each slot the
// LOCAL index of a non-zero inside its round window [t*R, (t+1)*R), -1 =
// pad; A is (M, ...), B is (N, ...). Outputs f32: C (M, N), or the stripes
// S (n_rounds, M, N), indexed with 64-bit offsets (S holds 3.4e9 elements
// at the largest Table IV operand). Every shape is masked.
//
// The TPU kernels one-hot expand both round windows into dense (rows, R)
// tiles only because the MXU needs dense tiles. Here Alg. 2 runs as it is
// written: two non-zeros meet iff they carry the same index in the same
// round. A block stages its B rows' round-t windows dense in shared memory
// (the comparator array: B's value at each index, 0 elsewhere), and each
// warp streams an A row's live slots, 32 per load, looking every slot's
// index up in the B rows of its lanes. So the partial
//   p(i, j, t) = sum over A's live slots of round t, ascending, of
//                a_val * B_window[j][a_idx],
// which is the sum of a_val * b_val over equal indices in ascending index
// order: an unmatched slot adds an exact zero, which changes nothing.
//
// Bitwise contract: round_partials() is the one definition of p, used by
// both match_kernel instances, with explicit __fmaf_rn from 0. The fused
// kernel adds p into its accumulator with __fadd_rn, rounds ascending from
// 0; merge_kernel adds S[t] the same way. So condense + merge equals the
// fused kernel bit for bit, the JAX contract (spgemm/kernels.py:16-19),
// and nvcc cannot contract the sums differently in the two.
//
// What bounds them on the H100: at the Table IV shapes the fused kernel
// must move both idx arrays in full (pads are read to be skipped), the live
// values and C, and do 2 flops per matched pair: bytes, about 0.02 ms at
// mesh-docword4. It is far from that bound: every column block re-reads
// A's slots and every row block re-reads B's (L2 traffic of (N/128 + 2M/64)
// times the idx arrays), and it issues one shared-memory lookup and one FMA
// per live A slot per output column, matched or not. Condense adds the
// stripe array's write (0.89 GB at mesh-docword4, R = 128), merge reads it
// back: both are streams of bytes, so the stripe writes are coalesced along
// N and merge reads float4 along N, 4 consecutive columns per thread, with
// 4 rounds' loads in flight. No tensor cores and no TF32: the sums are
// IEEE f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4;              // B rows (output columns) per lane
constexpr int kTn = 32 * kCols;       // output columns per block
constexpr int kRows = 8;              // A rows per warp
constexpr int kTm = kWarps * kRows;   // output rows per block

// Row stride of a dense B window in shared memory. Odd, so the 32 lanes
// of a warp (32 B rows, one index) hit 32 banks, and so do the lanes of a
// staging warp (one B row, 32 indices).
__host__ __device__ inline int window_stride(int rounds) {
  return rounds | 1;
}

// Add (kClear = false) or clear (kClear = true) the round-t windows of the
// block's B rows in the dense shared-memory tile `win`. The block's
// threads walk the (row, slot) pairs flat, so each thread has several
// independent loads in flight; atomicAdd sums a duplicated index as the
// one-hot form does. Clears and adds of one round are separated by a
// __syncthreads in the caller.
template <bool kClear>
__device__ __forceinline__ void stage_b(float* win, int stride,
                                        const int* __restrict__ bi,
                                        const float* __restrict__ bv,
                                        int j0, int n, int n_rounds,
                                        int rmax_b, int rounds, int t) {
  const int rows = min(kTn, n - j0);
  const int total = rows * rmax_b;
#pragma unroll 4
  for (int q = threadIdx.x; q < total; q += kThreads) {
    const int jj = q / rmax_b;
    const size_t off = ((size_t)(j0 + jj) * n_rounds + t) * rmax_b +
                       (q - jj * rmax_b);
    const int k = bi[off];
    const float v = kClear ? 0.0f : bv[off];
    if (k >= 0 && k < rounds) {
      if (kClear) {
        win[jj * stride + k] = 0.0f;
      } else {
        atomicAdd(&win[jj * stride + k], v);
      }
    }
  }
}

// p[r][c] = p(i0 + r, j0 + 32 c + lane, t) for the warp's A rows i0 ..
// i0 + rows - 1, whose round-t slots start at ai/av + a_off + r * a_step.
// Each 32-slot chunk of all the rows is loaded at once; then, row by row,
// the live slots are broadcast from the lanes that loaded them in
// ascending slot order and looked up in the B rows of the lanes. This is
// the one definition of the partial: the fused and the condense kernel
// both call it.
__device__ __forceinline__ void round_partials(
    const int* __restrict__ ai, const float* __restrict__ av, size_t a_off,
    size_t a_step, int rows, int rmax_a, int rounds, const float* win,
    int stride, int lane, float p[kRows][kCols]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) p[r][c] = 0.0f;
  }
  for (int s0 = 0; s0 < rmax_a; s0 += 32) {
    int my_k[kRows];
    float my_v[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      my_k[r] = -1;
      my_v[r] = 0.0f;
      if (r < rows && s0 + lane < rmax_a) {
        const size_t off = a_off + r * a_step + s0 + lane;
        my_k[r] = ai[off];
        my_v[r] = av[off];
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      unsigned live = __ballot_sync(kFull, my_k[r] >= 0 && my_k[r] < rounds);
      while (live) {
        const int src = __ffs(live) - 1;
        live &= live - 1;
        const int k = __shfl_sync(kFull, my_k[r], src);
        const float v = __shfl_sync(kFull, my_v[r], src);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          p[r][c] = __fmaf_rn(v, win[(c * 32 + lane) * stride + k], p[r][c]);
        }
      }
    }
  }
}

// Grid (column blocks of kTn, row blocks of kTm); rounds are the loop
// inside. kStripes = false: the fused index_match kernel, C[i, j] = sum of
// p(i, j, t) over t ascending. kStripes = true: condense, S[t, i, j] = p.
template <bool kStripes>
__global__ void __launch_bounds__(kThreads)
match_kernel(const int* __restrict__ ai, const float* __restrict__ av,
             const int* __restrict__ bi, const float* __restrict__ bv,
             float* __restrict__ out, int m, int n, int n_rounds,
             int rmax_a, int rmax_b, int rounds) {
  extern __shared__ float win[];                 // [kTn][stride]
  const int stride = window_stride(rounds);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * kTn;
  const int i0 = blockIdx.y * kTm + warp * kRows;
  const int rows = max(0, min(kRows, m - i0));   // warp-uniform
  const size_t a_step = (size_t)n_rounds * rmax_a;
  for (int e = threadIdx.x; e < kTn * stride; e += kThreads) win[e] = 0.0f;
  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }
  for (int t = 0; t < n_rounds; ++t) {
    __syncthreads();               // round t-1 read; the zeroing is visible
    if (t > 0) {
      stage_b<true>(win, stride, bi, bv, j0, n, n_rounds, rmax_b, rounds,
                    t - 1);
      __syncthreads();             // every clear lands before any add
    }
    stage_b<false>(win, stride, bi, bv, j0, n, n_rounds, rmax_b, rounds, t);
    __syncthreads();
    if (rows == 0) continue;
    float p[kRows][kCols];
    round_partials(ai, av, (size_t)i0 * a_step + (size_t)t * rmax_a, a_step,
                   rows, rmax_a, rounds, win, stride, lane, p);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows) break;
      if (kStripes) {
        float* srow = out + ((size_t)t * m + i0 + r) * n;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int j = j0 + c * 32 + lane;
          if (j < n) srow[j] = p[r][c];
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc[r][c] = __fadd_rn(acc[r][c], p[r][c]);
        }
      }
    }
  }
  if (!kStripes) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows) break;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = j0 + c * 32 + lane;
        if (j < n) out[(size_t)(i0 + r) * n + j] = acc[r][c];
      }
    }
  }
}

// C = sum over t ascending of S[t], from 0, with __fadd_rn. A thread owns
// 4 consecutive elements of the (M, N) plane, so a warp reads 512
// contiguous bytes of a stripe per round; `vec` (plane % 4 == 0) takes
// them as one float4.
constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(const float* __restrict__ s, float* __restrict__ c,
             long long plane, int n_rounds, int vec) {
  const long long step = (long long)gridDim.x * kMergeThreads * 4;
  for (long long e = ((long long)blockIdx.x * kMergeThreads + threadIdx.x) * 4;
       e < plane; e += step) {
    if (vec) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int t = 0; t < n_rounds; ++t) {
        const float4 v = __ldcs(
            reinterpret_cast<const float4*>(s + (size_t)t * plane + e));
        acc.x = __fadd_rn(acc.x, v.x);
        acc.y = __fadd_rn(acc.y, v.y);
        acc.z = __fadd_rn(acc.z, v.z);
        acc.w = __fadd_rn(acc.w, v.w);
      }
      *reinterpret_cast<float4*>(c + e) = acc;
    } else {
      const int cnt = plane - e < 4 ? (int)(plane - e) : 4;
      for (int q = 0; q < cnt; ++q) {
        float acc = 0.0f;
        for (int t = 0; t < n_rounds; ++t) {
          acc = __fadd_rn(acc, __ldcs(s + (size_t)t * plane + e + q));
        }
        c[e + q] = acc;
      }
    }
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <bool kStripes>
int launch_match(const int* ai, const float* av, const int* bi,
                 const float* bv, float* out, int m, int n, int n_rounds,
                 int rmax_a, int rmax_b, int rounds, int device,
                 void* stream) {
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const size_t smem = (size_t)kTn * window_stride(rounds) * sizeof(float);
  err = set_smem((const void*)match_kernel<kStripes>, smem);
  if (err) return err;
  dim3 grid((n + kTn - 1) / kTn, (m + kTm - 1) / kTm);
  match_kernel<kStripes><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      ai, av, bi, bv, out, m, n, n_rounds, rmax_a, rmax_b, rounds);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes. Each function launches on `stream`,
// does not synchronise, and returns the cudaError_t of the launch (0 = ok).
extern "C" {

size_t index_match_smem_bytes(int rounds) {
  return (size_t)kTn * window_stride(rounds) * sizeof(float);
}

const char* index_match_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int index_match_spmm(const int* ai, const float* av, const int* bi,
                     const float* bv, float* c, int m, int n, int n_rounds,
                     int rmax_a, int rmax_b, int rounds, int device,
                     void* stream) {
  return launch_match<false>(ai, av, bi, bv, c, m, n, n_rounds, rmax_a,
                             rmax_b, rounds, device, stream);
}

int spgemm_condense(const int* ai, const float* av, const int* bi,
                    const float* bv, float* s, int m, int n, int n_rounds,
                    int rmax_a, int rmax_b, int rounds, int device,
                    void* stream) {
  return launch_match<true>(ai, av, bi, bv, s, m, n, n_rounds, rmax_a,
                            rmax_b, rounds, device, stream);
}

int spgemm_merge(const float* s, float* c, long long plane, int n_rounds,
                 int device, void* stream) {
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const long long groups = (plane + 3) / 4;
  long long blocks = (groups + kMergeThreads - 1) / kMergeThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond
  if (blocks < 1) blocks = 1;
  const int vec = (plane % 4 == 0 && ((uintptr_t)s & 15) == 0 &&
                   ((uintptr_t)c & 15) == 0);
  merge_kernel<<<(unsigned)blocks, kMergeThreads, 0, (cudaStream_t)stream>>>(
      s, c, plane, n_rounds, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
