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
//   reuse:     a block of R rows x a panel of up to 512 columns stages
//              its rows' stripe for one section in shared memory once,
//              compacted to the live slots, and reuses it over every column
//              of the panel; the sums stay in registers over all sections;
//              the next stripes arrive by cp.async while one is consumed.
//              R = 2 at N >= 512, so incrs-docword (M = 768 padded, N =
//              512) runs 384 blocks of 8 warps, about 23 warps an SM, to
//              hide the L2 latency of the B gathers.
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

// cp.async helpers, shared by the reuse and pipelined orders.
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

// ---------------------------------------------------------------------------
// reuse: grid (row tiles of R rows, panels of 4 * TPR columns). The block
// stages its rows' stripe for one section once and reuses it over every
// column of its panel; TPR threads share a row, each keeping its 4 output
// columns (TPR apart, so a warp's loads of a B row are coalesced) in
// registers over all sections: the output is stationary and no panel
// lives in shared memory. Per section, three things overlap between two
// barriers: section s+2's raw stripe lands by cp.async in one raw buffer,
// section s+1's raw stripe is compacted to its live slots (ascending) in
// one compact buffer, and section s is consumed from the other, so the
// slot loop never visits a pad. One barrier per section.
constexpr int kReuseThreads = 256;
constexpr int kReuseCpt = 4;    // columns per thread, TPR apart

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}

template <int TPR>
__global__ void __launch_bounds__(kReuseThreads)
reuse_kernel(const int* __restrict__ idx, const float* __restrict__ val,
             const float* __restrict__ b, float* __restrict__ c,
             int m, int n, int n_sec, int smax, int section) {
  constexpr int R = kReuseThreads / TPR;
  extern __shared__ __align__(16) int sbuf[];
  const int stripe = R * smax;
  int* raw_i = sbuf;                                      // [2][R][smax]
  float* raw_v = reinterpret_cast<float*>(raw_i + 2 * stripe);
  int* cmp_i = reinterpret_cast<int*>(raw_v + 2 * stripe);
  float* cmp_v = reinterpret_cast<float*>(cmp_i + 2 * stripe);
  int* cnt = reinterpret_cast<int*>(cmp_v + 2 * stripe);  // [2][R]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rr = tid / TPR;
  const int row0 = blockIdx.x * R, row = row0 + rr;
  const int col0 = blockIdx.y * (kReuseCpt * TPR) + tid % TPR;

  // Section s's raw stripe of the block's rows into raw buffer s % 2.
  auto stage = [&](int s) {
    int* di = raw_i + (s & 1) * stripe;
    float* dv = raw_v + (s & 1) * stripe;
    for (int t = tid; t < stripe; t += kReuseThreads) {
      const int r = row0 + t / smax;
      const bool ok = r < m;
      const size_t o = ok ? ((size_t)r * n_sec + s) * smax + t % smax : 0;
      cp_async4(di + t, idx + o, ok);
      cp_async4(dv + t, val + o, ok);
    }
    cp_async_commit();
  };
  // Raw buffer s % 2 -> its live slots, in slot order, and their count.
  auto compact = [&](int s) {
    const int bs = s & 1;
    for (int r = warp; r < R; r += kReuseThreads / 32) {
      const int* ri = raw_i + bs * stripe + r * smax;
      const float* rv = raw_v + bs * stripe + r * smax;
      int* ci = cmp_i + bs * stripe + r * smax;
      float* cv = cmp_v + bs * stripe + r * smax;
      const bool row_ok = row0 + r < m;
      int base = 0;
      for (int j0 = 0; j0 < smax; j0 += 32) {
        const int j = j0 + lane;
        const int i = j < smax ? ri[j] : -1;
        const bool live = row_ok && i >= 0 && i < section;
        const unsigned mask = __ballot_sync(kFull, live);
        if (live) {
          const int pos = base + __popc(mask & ((1u << lane) - 1u));
          ci[pos] = i;
          cv[pos] = rv[j];
        }
        base += __popc(mask);
      }
      if (lane == 0) cnt[bs * R + r] = base;
    }
  };

  float acc[kReuseCpt];
#pragma unroll
  for (int k = 0; k < kReuseCpt; ++k) acc[k] = 0.0f;

  stage(0);
  cp_async_wait<0>();
  __syncthreads();
  if (n_sec > 1) stage(1);
  compact(0);
  cp_async_wait<0>();
  __syncthreads();
  for (int s = 0; s < n_sec; ++s) {
    // Raw buffer s % 2 was compacted before the last barrier; compact
    // buffer (s + 1) % 2 was consumed before it.
    if (s + 2 < n_sec) stage(s + 2);
    if (s + 1 < n_sec) compact(s + 1);
    if (row < m) {  // warp-uniform: TPR is a multiple of 32
      const int bs = s & 1;
      const int live = cnt[bs * R + rr];
      const int* ci = cmp_i + bs * stripe + rr * smax;
      const float* cv = cmp_v + bs * stripe + rr * smax;
      const float* bsec = b + (size_t)s * section * n + col0;
#pragma unroll 4
      for (int j = 0; j < live; ++j) {
        const float v = cv[j];
        const float* br = bsec + (size_t)ci[j] * n;
#pragma unroll
        for (int k = 0; k < kReuseCpt; ++k)
          if (col0 + TPR * k < n)
            acc[k] = __fmaf_rn(v, __ldg(br + TPR * k), acc[k]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
  }
  if (row < m) {
#pragma unroll
    for (int k = 0; k < kReuseCpt; ++k)
      if (col0 + TPR * k < n) c[(size_t)row * n + col0 + TPR * k] = acc[k];
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

// The caller chooses the threads per row, tpr = 32, 64 or 128 (a 128, 256
// or 512-column panel; the block covers kReuseThreads / tpr rows), and
// sizes `smem`: two raw and two compact stripes (idx and val) of those
// rows and two counts (incrs_spmm.launch_geometry).
int incrs_spmm_reuse(const int* idx, const float* val, const float* b,
                     float* c, int m, int n, int n_sec, int smax, int section,
                     int tpr, size_t smem, int device, void* stream) {
  if (tpr != 32 && tpr != 64 && tpr != 128) return cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const void* fn = tpr == 32 ? (const void*)reuse_kernel<32>
                 : tpr == 64 ? (const void*)reuse_kernel<64>
                             : (const void*)reuse_kernel<128>;
  err = set_smem(fn, smem);
  if (err) return err;
  const int rows = kReuseThreads / tpr, panel = kReuseCpt * tpr;
  dim3 grid((m + rows - 1) / rows, (n + panel - 1) / panel);
  cudaStream_t st = (cudaStream_t)stream;
  if (tpr == 32)
    reuse_kernel<32><<<grid, kReuseThreads, smem, st>>>(
        idx, val, b, c, m, n, n_sec, smax, section);
  else if (tpr == 64)
    reuse_kernel<64><<<grid, kReuseThreads, smem, st>>>(
        idx, val, b, c, m, n, n_sec, smax, section);
  else
    reuse_kernel<128><<<grid, kReuseThreads, smem, st>>>(
        idx, val, b, c, m, n, n_sec, smax, section);
  return (int)cudaGetLastError();
}

// `smem`: the ring, kStages blocks of (section, kPipeCols) f32, sized by
// the caller (incrs_spmm.launch_geometry).
int incrs_spmm_pipelined(const int* idx, const float* val, const float* b,
                         float* c, int m, int n, int n_sec, int smax,
                         int section, size_t smem, int device, void* stream) {
  if (n % 4 != 0 || ((uintptr_t)b & 15) != 0) return cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
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
