// Fused InCRS SpMM on Hopper (sm_90a): C[M, N] = decompress(idx, val) @ B.
//
// Replaces the three Pallas grid orders of src/repro/kernels/incrs_spmm.py:
//   expand_kernel    <- _kernel           (incrs_spmm,           :111/:128)
//   reuse_kernel     <- _kernel_reuse     (incrs_spmm_reuse,     :178/:206)
//   pipelined_kernel <- _kernel_pipelined (incrs_spmm_pipelined, :252/:303)
//
// Inputs: idx int32 / val f32 section stripes (M, n_sec, smax), the local
// column of each non-zero inside its section, -1 = pad slot; B f32
// (n_sec * section, N) row-major; C f32 (M, N). Every shape is masked, so
// no dimension has to be a multiple of a tile.
//
// The TPU kernels one-hot expand each stripe into a dense (bm, section)
// slab only because the MXU consumes dense tiles. Here each live slot is
// consumed directly: C[r, cols] += val * B[s * section + idx, cols]. The
// skipped slab entries are exact zeros, so the same terms are summed.
//
// Bitwise contract: every output element is summed by one thread, with f32
// fused multiply-adds (__fmaf_rn), sections ascending and slots ascending,
// starting from 0. The three kernels therefore agree bit for bit at any
// tiling, which is stronger than the "equal (bm, bn)" of the Pallas ones.
//
// What bounds them on the H100: bytes. At the Table II shapes a SpMM does
// about 2 * nnz * N flops against idx/val + B + C bytes, well under the
// f32 ridge of the card, and B is read once per live slot, a gather
// served mostly from the 50 MB L2 (every Table II B at N <= 512 fits).
// What each design does about it:
//   expand:    one warp per row, 32 lanes on adjacent columns, so each B
//              row segment is one coalesced 128-byte load per 32 columns;
//              32 slots are fetched per warp load and broadcast by shuffle.
//   reuse:     a block stages its rows' stripe for one section in shared
//              memory once and reuses it over every column tile, holding
//              the partial sums in a shared-memory row panel.
//   pipelined: a block of 64 rows streams the (section, 32) block of B
//              through a 3-stage cp.async ring in shared memory, so 64 rows
//              share each B read from L2 and the next section's block is
//              in flight while the current one is consumed.
// No tensor cores and no TF32: the sums are IEEE f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// expand: grid (row tiles, column tiles); each block loops over sections.
constexpr int kExpWarps = 4;   // rows per block, one warp per row
constexpr int kExpCpl = 4;     // columns per lane: a 128-column tile

__global__ void __launch_bounds__(kExpWarps * 32)
expand_kernel(const int* __restrict__ idx, const float* __restrict__ val,
              const float* __restrict__ b, float* __restrict__ c,
              int m, int n, int n_sec, int smax, int section) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kExpWarps + (threadIdx.x >> 5);
  if (row >= m) return;  // warp-uniform
  const int col0 = blockIdx.y * (32 * kExpCpl) + lane;
  float acc[kExpCpl];
#pragma unroll
  for (int k = 0; k < kExpCpl; ++k) acc[k] = 0.0f;
  for (int s = 0; s < n_sec; ++s) {
    const size_t st = ((size_t)row * n_sec + s) * smax;
    const float* bs = b + (size_t)s * section * n;
    for (int j0 = 0; j0 < smax; j0 += 32) {
      int my_i = -1;
      float my_v = 0.0f;
      if (j0 + lane < smax) {
        my_i = idx[st + j0 + lane];
        my_v = val[st + j0 + lane];
      }
      // Live slots of this chunk, visited in ascending slot order.
      unsigned live = __ballot_sync(kFull, my_i >= 0 && my_i < section);
      while (live) {
        const int src = __ffs(live) - 1;
        live &= live - 1;
        const int i = __shfl_sync(kFull, my_i, src);
        const float v = __shfl_sync(kFull, my_v, src);
        const float* br = bs + (size_t)i * n;
#pragma unroll
        for (int k = 0; k < kExpCpl; ++k) {
          const int col = col0 + 32 * k;
          if (col < n) acc[k] = __fmaf_rn(v, __ldg(br + col), acc[k]);
        }
      }
    }
  }
  float* cr = c + (size_t)row * n;
#pragma unroll
  for (int k = 0; k < kExpCpl; ++k) {
    const int col = col0 + 32 * k;
    if (col < n) cr[col] = acc[k];
  }
}

// ---------------------------------------------------------------------------
// reuse: grid (row tiles,); per section the block stages its rows' stripe
// in shared memory once, then sweeps every column tile against it. The
// (rows, N) row panel in shared memory is the output-stationary
// accumulator: section 0 initialises it, the last section flushes to C.
constexpr int kReuseWarps = 4;  // rows per block, one warp per row
constexpr int kReuseCpl = 4;    // columns per lane per sweep step

__global__ void __launch_bounds__(kReuseWarps * 32)
reuse_kernel(const int* __restrict__ idx, const float* __restrict__ val,
             const float* __restrict__ b, float* __restrict__ c,
             int m, int n, int n_sec, int smax, int section) {
  extern __shared__ float smem[];
  float* panel = smem;                                   // [warps][n]
  int* sidx = reinterpret_cast<int*>(panel + (size_t)kReuseWarps * n);
  float* sval = reinterpret_cast<float*>(sidx + kReuseWarps * smax);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kReuseWarps;
  const int row = row0 + warp;
  const int stripe = kReuseWarps * smax;
  for (int s = 0; s < n_sec; ++s) {
    for (int t = threadIdx.x; t < stripe; t += blockDim.x) {
      const int r = row0 + t / smax;
      int i = -1;
      float v = 0.0f;
      if (r < m) {
        const size_t o = ((size_t)r * n_sec + s) * smax + t % smax;
        i = idx[o];
        v = val[o];
      }
      sidx[t] = i;
      sval[t] = v;
    }
    __syncthreads();
    if (row < m) {
      const int* is = sidx + warp * smax;
      const float* vs = sval + warp * smax;
      const float* bs = b + (size_t)s * section * n;
      float* pr = panel + (size_t)warp * n;
      const bool last = s == n_sec - 1;
      for (int cb = 0; cb < n; cb += 32 * kReuseCpl) {
        float acc[kReuseCpl];
#pragma unroll
        for (int k = 0; k < kReuseCpl; ++k) {
          const int col = cb + lane + 32 * k;
          acc[k] = (s == 0 || col >= n) ? 0.0f : pr[col];
        }
        for (int j = 0; j < smax; ++j) {
          const int i = is[j];
          if (i < 0 || i >= section) continue;  // warp-uniform
          const float v = vs[j];
          const float* br = bs + (size_t)i * n;
#pragma unroll
          for (int k = 0; k < kReuseCpl; ++k) {
            const int col = cb + lane + 32 * k;
            if (col < n) acc[k] = __fmaf_rn(v, __ldg(br + col), acc[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < kReuseCpl; ++k) {
          const int col = cb + lane + 32 * k;
          if (col < n) {
            if (last) c[(size_t)row * n + col] = acc[k];
            else pr[col] = acc[k];
          }
        }
      }
    }
    __syncthreads();  // the stripe buffer is restaged for the next section
  }
}

// ---------------------------------------------------------------------------
// pipelined: grid (row tiles, 32-column tiles). The (section, 32) blocks of
// B stream through a kStages-deep cp.async ring in shared memory; block s
// is consumed while blocks s+1 .. s+kStages-1 are in flight. The 64-row by
// 32-column output tile stays in registers over all sections.
constexpr int kPipeWarps = 8;
constexpr int kPipeRowsPerWarp = 8;  // 64-row tile
constexpr int kPipeCols = 32;        // one column per lane
constexpr int kStages = 3;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// Copy B[s*section : (s+1)*section, col0 : col0+32] into ring slot `dst`.
// 16-byte copies: N % 4 == 0 and B 16-byte aligned (the launcher checks).
// Columns past N are zero-filled (src-size 0), never read from memory.
__device__ __forceinline__ void load_block(float* dst, const float* b, int s,
                                           int col0, int n, int section) {
  const float* src = b + (size_t)s * section * n + col0;
  constexpr int kChunks = kPipeCols / 4;
  for (int t = threadIdx.x; t < section * kChunks; t += blockDim.x) {
    const int r = t / kChunks, q = (t % kChunks) * 4;
    const bool ok = col0 + q < n;
    cp_async16(dst + r * kPipeCols + q, ok ? src + (size_t)r * n + q : b, ok);
  }
}

__global__ void __launch_bounds__(kPipeWarps * 32)
pipelined_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                 const float* __restrict__ b, float* __restrict__ c,
                 int m, int n, int n_sec, int smax, int section) {
  extern __shared__ float ring[];  // [kStages][section][kPipeCols]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * (kPipeWarps * kPipeRowsPerWarp);
  const int col0 = blockIdx.y * kPipeCols;
  const size_t tile = (size_t)section * kPipeCols;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_sec) load_block(ring + st * tile, b, st, col0, n, section);
    cp_async_commit();  // empty groups keep the group count uniform
  }
  float acc[kPipeRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kPipeRowsPerWarp; ++rr) acc[rr] = 0.0f;

  for (int s = 0; s < n_sec; ++s) {
    cp_async_wait<kStages - 2>();  // block s has landed (this thread's part)
    __syncthreads();               // ... and every thread's; slot s-1 is free
    const int nxt = s + kStages - 1;
    if (nxt < n_sec) load_block(ring + (nxt % kStages) * tile, b, nxt, col0,
                                n, section);
    cp_async_commit();
    const float* bt = ring + (s % kStages) * tile;
#pragma unroll
    for (int rr = 0; rr < kPipeRowsPerWarp; ++rr) {
      const int row = row0 + warp + kPipeWarps * rr;
      if (row < m) {  // warp-uniform
        const size_t st = ((size_t)row * n_sec + s) * smax;
        for (int j0 = 0; j0 < smax; j0 += 32) {
          int my_i = -1;
          float my_v = 0.0f;
          if (j0 + lane < smax) {
            my_i = idx[st + j0 + lane];
            my_v = val[st + j0 + lane];
          }
          unsigned live = __ballot_sync(kFull, my_i >= 0 && my_i < section);
          while (live) {
            const int src = __ffs(live) - 1;
            live &= live - 1;
            const int i = __shfl_sync(kFull, my_i, src);
            const float v = __shfl_sync(kFull, my_v, src);
            acc[rr] = __fmaf_rn(v, bt[i * kPipeCols + lane], acc[rr]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  const int col = col0 + lane;
#pragma unroll
  for (int rr = 0; rr < kPipeRowsPerWarp; ++rr) {
    const int row = row0 + warp + kPipeWarps * rr;
    if (row < m && col < n) c[(size_t)row * n + col] = acc[rr];
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes. Each function launches on `stream`,
// does not synchronise, and returns the cudaError_t of the launch (0 = ok).
extern "C" {

size_t incrs_reuse_smem_bytes(int n, int smax) {
  return (size_t)kReuseWarps * n * sizeof(float) +
         (size_t)kReuseWarps * smax * (sizeof(int) + sizeof(float));
}

size_t incrs_pipelined_smem_bytes(int section) {
  return (size_t)kStages * section * kPipeCols * sizeof(float);
}

const char* incrs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int incrs_spmm_expand(const int* idx, const float* val, const float* b,
                      float* c, int m, int n, int n_sec, int smax,
                      int section, int device, void* stream) {
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  dim3 grid((m + kExpWarps - 1) / kExpWarps,
            (n + 32 * kExpCpl - 1) / (32 * kExpCpl));
  expand_kernel<<<grid, kExpWarps * 32, 0, (cudaStream_t)stream>>>(
      idx, val, b, c, m, n, n_sec, smax, section);
  return (int)cudaGetLastError();
}

int incrs_spmm_reuse(const int* idx, const float* val, const float* b,
                     float* c, int m, int n, int n_sec, int smax, int section,
                     int device, void* stream) {
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const size_t smem = incrs_reuse_smem_bytes(n, smax);
  err = set_smem((const void*)reuse_kernel, smem);
  if (err) return err;
  dim3 grid((m + kReuseWarps - 1) / kReuseWarps);
  reuse_kernel<<<grid, kReuseWarps * 32, smem, (cudaStream_t)stream>>>(
      idx, val, b, c, m, n, n_sec, smax, section);
  return (int)cudaGetLastError();
}

int incrs_spmm_pipelined(const int* idx, const float* val, const float* b,
                         float* c, int m, int n, int n_sec, int smax,
                         int section, int device, void* stream) {
  if (n % 4 != 0 || ((uintptr_t)b & 15) != 0) return cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const size_t smem = incrs_pipelined_smem_bytes(section);
  err = set_smem((const void*)pipelined_kernel, smem);
  if (err) return err;
  dim3 grid((m + kPipeWarps * kPipeRowsPerWarp - 1) /
                (kPipeWarps * kPipeRowsPerWarp),
            (n + kPipeCols - 1) / kPipeCols);
  pipelined_kernel<<<grid, kPipeWarps * 32, smem, (cudaStream_t)stream>>>(
      idx, val, b, c, m, n, n_sec, smax, section);
  return (int)cudaGetLastError();
}

}  // extern "C"
