// One GEMM core for Hopper (sm_90a), shared by dense_mm.cu and bsr_spmm.cu:
// a CTA owns a 128 x 128 tile of C and sums, over its K steps, the product
// of an A tile and a B tile into an f32 accumulator that is flushed once,
// cast to the output type. It replaces the mainloops of the Pallas kernels
// _kernel of dense_mm (src/repro/kernels/dense_mm.py:21) and of bsr_spmm
// (src/repro/kernels/bsr_spmm.py:37): zero the accumulator at a tile's
// first K step, add each step's product, write C at the last.
//
// A K-tile source (template parameter Src) says where the tiles of K step
// q come from; the mainloop never knows the format:
// - DenseSrc: A at (row0, q * BK), B at (q * BK, col0).
// - BsrSrc: the CTA reads its block-row's run start from row_start and,
//   per step, the block-column col_of[t] itself (the Hopper side of the
//   Pallas scalar prefetch of row_of / col_of); with kb = bk / BK,
//   t = row_start[r] + q / kb and k0 = (q mod kb) * BK, A is values[t] at
//   (r0, k0) and B at (col_of[t] * bk + k0, col0).
//
// Two instances of the core:
// - f32 (gemm_f32_kernel): IEEE f32 FMA (__fmaf_rn), the port's f32
//   contract, so no tensor cores: 67 TFLOP/s at most. 128 threads as 2 x 2
//   warps of 64 x 64, an 8 x 16 register tile a lane (128 FMAs for 6
//   shared-memory loads a k), BK = 16, two CTAs an SM. B comes through a
//   ring of `stages` (16, 128) tiles by 16-byte cp.async (zero fill past
//   the ragged K and N edges); A, row-major and so strided along K, by
//   16-byte global loads into registers (a thread's row) issued one step
//   ahead, so their latency hides under the step's FMAs, then stored
//   transposed (a warp stores 32 consecutive rows: no bank conflicts). One
//   barrier a K step.
// - bf16 (gemm_bf16_kernel): wgmma m64n128k16 on the tensor cores, f32
//   accumulators in registers. Two consumer warpgroups (64 rows each) and
//   one producer warp; a ring of `stages` (BK = 64) stages filled by TMA in
//   the 128-byte swizzle, with full and empty mbarriers. A (rows, K) is
//   K-major for wgmma; B (K, N) row-major is MN-major, the transposed-B
//   form that 16-bit types allow. TMA's zero fill masks every ragged edge.
//
// Summation order: each output element sums its K steps in ascending
// order, k ascending within a step. When the tile grid under-fills the
// card, the wrapper splits K into S contiguous ranges (gridDim.y = S); each
// CTA writes its f32 partial tile to a workspace the wrapper allocates, and
// the last CTA of a tile to arrive (a per-tile ticket) sums the S partials
// in split order 0..S-1 and writes C, then resets the ticket. No float
// atomics: two launches on the same inputs give the same bits.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"   // mbarriers, TMA, wgmma helpers, kTensorMapError

namespace {

constexpr int kTileM = 128, kTileN = 128;

// ---------------------------------------------------------------------------
// Element types: sums are f32; inputs convert on load, outputs at the flush.
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// ---------------------------------------------------------------------------
// K-tile sources.

// Where the f32 instance reads K step q: A's tile row 0 at the step's
// first k (rows `lda` apart, `a_k` valid k from there) and B's row at that
// k and the tile's column 0 (rows `ldb` apart, `b_rows` valid).
template <typename T>
struct Step {
  const T* a;
  long long lda;
  int a_k;
  const T* b;
  long long ldb;
  int b_rows;
};

constexpr int kBRegion = 64 * 64 * 2;   // bf16 B box: 64 columns x 64 k

template <typename T, int BK, int TN = kTileN>
struct DenseSrc {
  static constexpr int kTn = TN;   // the tile's columns
  const T* a;
  const T* b;
  T* c;
  int m, n, k, col_tiles;
  int row0, col0;   // set by at()

  __device__ void at(int tile) {
    row0 = (tile / col_tiles) * kTileM;
    col0 = (tile % col_tiles) * TN;
  }
  __device__ int steps() const { return (k + BK - 1) / BK; }
  __device__ int rows() const { return min(kTileM, m - row0); }
  __device__ int cols() const { return min(TN, n - col0); }
  __device__ T* c_tile() const { return c + (size_t)row0 * n + col0; }
  __device__ int ldc() const { return n; }
  __device__ Step<T> step(int q) const {
    const int k0 = q * BK;
    return {a + (size_t)row0 * k + k0, k, k - k0, b + (size_t)k0 * n + col0,
            n, k - k0};
  }
  // bf16: A box (64 k, 128 rows) of a map over (K, M); TN / 64 B boxes
  // (64 columns, 64 k) of a map over (N, K).
  __device__ void load(const CUtensorMap* ta, const CUtensorMap* tb, int q,
                       uint32_t sa, uint32_t sb, uint32_t bar) const {
    tma_load_2d(sa, ta, q * BK, row0, bar);
#pragma unroll
    for (int j = 0; j < TN / 64; ++j)
      tma_load_2d(sb + j * kBRegion, tb, col0 + 64 * j, q * BK, bar);
  }
};

template <typename T, int BK, int TN = kTileN>
struct BsrSrc {
  static constexpr int kTn = TN;   // the tile's columns
  const int* row_start;
  const int* col_of;
  const T* values;
  const T* b;
  T* c;
  int n, bm, bk, n_sub, col_tiles;
  int r, r0, col0, t0, n_steps;   // set by at()

  __device__ void at(int tile) {
    const int rt = tile / col_tiles;
    r = rt / n_sub;
    r0 = (rt % n_sub) * kTileM;
    col0 = (tile % col_tiles) * TN;
    t0 = row_start[r];
    n_steps = (row_start[r + 1] - t0) * (bk / BK);
  }
  __device__ int steps() const { return n_steps; }
  __device__ int rows() const { return min(kTileM, bm - r0); }
  __device__ int cols() const { return min(TN, n - col0); }
  __device__ T* c_tile() const {
    return c + ((size_t)r * bm + r0) * n + col0;
  }
  __device__ int ldc() const { return n; }
  __device__ void block_of(int q, int& t, int& k0) const {
    const int kb = bk / BK;
    const int j = q / kb;
    t = t0 + j;
    k0 = (q - j * kb) * BK;
  }
  __device__ Step<T> step(int q) const {
    int t, k0;
    block_of(q, t, k0);
    return {values + ((size_t)t * bm + r0) * bk + k0, bk, BK,
            b + ((size_t)col_of[t] * bk + k0) * n + col0, n, BK};
  }
  // bf16: A box (64 k, 128 rows, 1 block) of a map over (bk, bm, nnz) (rows
  // past bm are zeros of the fill); B boxes as DenseSrc's.
  __device__ void load(const CUtensorMap* ta, const CUtensorMap* tb, int q,
                       uint32_t sa, uint32_t sb, uint32_t bar) const {
    int t, k0;
    block_of(q, t, k0);
    tma_load_3d(sa, ta, k0, r0, t, bar);
    const int kr = col_of[t] * bk + k0;
#pragma unroll
    for (int j = 0; j < TN / 64; ++j)
      tma_load_2d(sb + j * kBRegion, tb, col0 + 64 * j, kr, bar);
  }
};

// ---------------------------------------------------------------------------
// Split-K: partial tiles in `ws` ([S][tiles][128 * TN] f32) and one ticket
// per tile (zero between launches). gridDim.y = S.
struct Split {
  float* ws;
  int* tickets;
  int tiles;
};

// The K steps [lo, hi) of this CTA's split.
__device__ __forceinline__ void split_range(int n_steps, int& lo, int& hi) {
  lo = (int)((long long)n_steps * blockIdx.y / gridDim.y);
  hi = (int)((long long)n_steps * (blockIdx.y + 1) / gridDim.y);
}

template <int TN>
__device__ __forceinline__ float* partial_tile(const Split& sp, int tile) {
  return sp.ws + ((size_t)blockIdx.y * sp.tiles + tile) * (kTileM * TN);
}

// After every thread of `sync` stored its partial: true in the last CTA of
// the tile to arrive, which then sees every partial.
template <class Sync>
__device__ bool last_split(const Split& sp, int tile, int tid, Sync sync) {
  __shared__ int s_last;
  __threadfence();
  sync();
  if (tid == 0) {
    const int arrived = atomicAdd(&sp.tickets[tile], 1) + 1;
    s_last = arrived == (int)gridDim.y;
    if (s_last) sp.tickets[tile] = 0;   // ready for the next launch
  }
  sync();
  if (!s_last) return false;
  __threadfence();
  return true;
}

// C[rows, cols] of the tile = sum of the S partials, in split order.
// cols is a multiple of 4 (the fast instances' N).
template <int TN, typename O>
__device__ void reduce_splits(const Split& sp, int tile, O* c, int ldc,
                              int rows, int cols, int tid, int nthreads) {
  const int s_count = (int)gridDim.y;
  const size_t plane = (size_t)sp.tiles * kTileM * TN;
  const float* p = sp.ws + (size_t)tile * kTileM * TN;
  for (int e = tid; e < kTileM * TN / 4; e += nthreads) {
    const int row = e / (TN / 4), col = (e % (TN / 4)) * 4;
    if (row >= rows || col >= cols) continue;
    const size_t off = (size_t)row * TN + col;
    float4 s = __ldcg(reinterpret_cast<const float4*>(p + off));
    for (int i = 1; i < s_count; ++i) {
      const float4 v =
          __ldcg(reinterpret_cast<const float4*>(p + i * plane + off));
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    store4(c + (size_t)row * ldc + col, s);
  }
}

// ===========================================================================
// f32: FMA behind a cp.async ring.
constexpr int kF32Bk = 16;
constexpr int kF32Threads = 128;
constexpr int kF32MinBlocks = 2;   // CTAs an SM (the wrapper counts on it)

__host__ __device__ constexpr int f32_smem_bytes(int stages) {
  return (2 * kF32Bk * kTileM + stages * kF32Bk * kTileN) * 4;
}

__device__ __forceinline__ void cp_async16z(float* dst, const float* src,
                                            bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most `pending` (0..3) of this thread's groups are in
// flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four warps as 2 x 2 warp tiles of 64 x 64; a lane holds 8 x 16 of its
// warp's tile: rows ar + {0..3} and ar + 32 + {0..3}, columns bc + 16 j +
// {0..3}, j < 4, where ar = 64 (warp / 2) + 4 (lane / 4) and bc = 64 (warp
// % 2) + 4 (lane % 4). Per k a warp reads 8 distinct float4 of A and 4 of
// B (broadcast to the rest): one shared-memory wavefront a load.
__device__ __forceinline__ int frag_row(int tid) {
  return (tid / 32 / 2) * 64 + (tid % 32 / 4) * 4;
}
__device__ __forceinline__ int frag_col(int tid) {
  return (tid / 32 % 2) * 64 + (tid % 4) * 4;
}

// cols is a multiple of 4.
template <typename O>
__device__ void store_f32_frag(const float (&acc)[8][16], O* out, int ld,
                               int rows, int cols, int tid) {
  const int ar = frag_row(tid), bc = frag_col(tid);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = ar + (i < 4 ? i : 32 + i - 4);
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = bc + 16 * j;
      if (col < cols)
        store4(out + (size_t)row * ld + col,
               make_float4(acc[i][4 * j], acc[i][4 * j + 1],
                           acc[i][4 * j + 2], acc[i][4 * j + 3]));
    }
  }
}

// kSplit: gridDim.y > 1 (the split-K epilogue); without it the kernel
// carries no code past the flush.
template <class Src, bool kSplit>
__global__ void __launch_bounds__(kF32Threads, kF32MinBlocks)
gemm_f32_kernel(Src src, const Split sp, int stages) {
  extern __shared__ __align__(16) float smem_f[];
  float* as_base = smem_f;                        // [2][kF32Bk][kTileM]: A^T
  float* bs_base = smem_f + 2 * kF32Bk * kTileM;  // [stages][kF32Bk][kTileN]
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  src.at(tile);
  int q_lo, q_hi;
  split_range(src.steps(), q_lo, q_hi);
  const int nq = q_hi - q_lo;
  const int rows = src.rows(), cols = src.cols();
  // A: one row's kF32Bk k a thread, as 16-byte loads; B: 16-byte chunks
  // of rows b_row + 4 h.
  constexpr int kAv = kF32Bk / 4;
  const int a_row = tid;
  const int b_row = tid / 32, b_col = (tid % 32) * 4;
  float4 ra[kAv];

  auto load_a = [&](int q) {
    const Step<float> st = src.step(q);
    const float* p = st.a + (size_t)a_row * st.lda;
#pragma unroll
    for (int v = 0; v < kAv; ++v)
      ra[v] = a_row < rows && 4 * v < st.a_k
                  ? __ldg(reinterpret_cast<const float4*>(p + 4 * v))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto store_a = [&](int buf) {   // a warp stores 32 consecutive rows
    float* d = as_base + buf * kF32Bk * kTileM + a_row;
#pragma unroll
    for (int v = 0; v < kAv; ++v) {
      d[(4 * v + 0) * kTileM] = ra[v].x;
      d[(4 * v + 1) * kTileM] = ra[v].y;
      d[(4 * v + 2) * kTileM] = ra[v].z;
      d[(4 * v + 3) * kTileM] = ra[v].w;
    }
  };
  auto load_b = [&](int q, int slot) {
    const Step<float> st = src.step(q);
    float* d = bs_base + slot * kF32Bk * kTileN;
#pragma unroll
    for (int h = 0; h < kF32Bk / 4; ++h) {
      const int kk = b_row + 4 * h;
      const bool ok = kk < st.b_rows && b_col < cols;
      cp_async16z(d + kk * kTileN + b_col,
                  ok ? st.b + (size_t)kk * st.ldb + b_col : st.b, ok);
    }
  };

  float acc[8][16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.0f;
  const int ar = frag_row(tid), bc = frag_col(tid);

  auto compute = [&](const float* as, const float* bs) {
#pragma unroll
    for (int kk = 0; kk < kF32Bk; ++kk) {
      const float4 a0 = lds4(as + kk * kTileM + ar);
      const float4 a1 = lds4(as + kk * kTileM + ar + 32);
      float bv[16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 b = lds4(bs + kk * kTileN + bc + 16 * j);
        bv[4 * j] = b.x;
        bv[4 * j + 1] = b.y;
        bv[4 * j + 2] = b.z;
        bv[4 * j + 3] = b.w;
      }
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
  };

  if (nq > 0) {
    for (int i = 0; i < stages - 1; ++i) {   // B of the first stages - 1
      if (i < nq) load_b(q_lo + i, i);
      cp_async_commit_group();
    }
    load_a(q_lo);
    store_a(0);
    cp_async_wait_pending(stages - 2);
    __syncthreads();
    for (int i = 0; i < nq; ++i) {
      const bool more = i + 1 < nq;
      if (more) load_a(q_lo + i + 1);        // lands while step i computes
      const int j = i + stages - 1;          // its slot was read at i - 1
      if (j < nq) load_b(q_lo + j, j % stages);
      cp_async_commit_group();
      compute(as_base + (i & 1) * kF32Bk * kTileM,
              bs_base + (i % stages) * kF32Bk * kTileN);
      if (more) store_a((i + 1) & 1);
      cp_async_wait_pending(stages - 2);     // B of step i + 1 has landed
      __syncthreads();
    }
  }

  if constexpr (!kSplit) {
    store_f32_frag(acc, src.c_tile(), src.ldc(), rows, cols, tid);
  } else {
    store_f32_frag(acc, partial_tile<kTileN>(sp, tile), kTileN, kTileM,
                   kTileN, tid);
    if (!last_split(sp, tile, tid, [] { __syncthreads(); })) return;
    reduce_splits<kTileN>(sp, tile, src.c_tile(), src.ldc(), rows, cols, tid,
                          kF32Threads);
  }
}

template <class Src, bool kSplit>
int launch_f32(const Src& src, int tiles, int splits, int stages, int smem,
               const Split& sp, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_f32_kernel<Src, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return (int)err;
  gemm_f32_kernel<Src, kSplit><<<dim3((unsigned)tiles, (unsigned)splits),
                                 kF32Threads, smem, stream>>>(src, sp,
                                                              stages);
  return (int)cudaGetLastError();
}

template <class Src>
int launch_gemm_f32(const Src& src, int tiles, int splits, int stages,
                    int smem, const Split& sp, cudaStream_t stream) {
  return splits > 1
             ? launch_f32<Src, true>(src, tiles, splits, stages, smem, sp,
                                     stream)
             : launch_f32<Src, false>(src, tiles, splits, stages, smem, sp,
                                      stream);
}

// CTAs of the f32 instance over Src (split or not) that one SM holds at
// `smem` bytes, from the occupancy calculator.
template <class Src, bool kSplit>
int f32_ctas(int smem, int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_f32_kernel<Src, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, gemm_f32_kernel<Src, kSplit>, kF32Threads, (size_t)smem);
}

template <class Src>
int gemm_f32_ctas_per_sm(int splits, int smem, int* ctas) {
  return splits > 1 ? f32_ctas<Src, true>(smem, ctas)
                    : f32_ctas<Src, false>(smem, ctas);
}

// ===========================================================================
// bf16: wgmma behind a TMA ring.
constexpr int kBf16Bk = 64;
constexpr int kBf16Consumers = 2;   // warpgroups of 64 rows
constexpr int kBf16Threads = 128 * kBf16Consumers + 32;   // + the producer
constexpr int kBf16ATile = kTileM * kBf16Bk * 2;          // 16 KB

// A ring stage: A, then B's TN / 64 regions of 64 columns x 64 k.
__host__ __device__ constexpr int bf16_stage_bytes(int tn) {
  return kBf16ATile + (tn / 64) * kBRegion;
}
__host__ __device__ constexpr int bf16_smem_bytes(int stages, int tn) {
  return 1024 + stages * bf16_stage_bytes(tn) + 16 * stages;   // align,
}                                                      // ring, barriers

// D[64 x 128] += A[64 x 16] . B[16 x 128], bf16 in, f32 accumulators: A
// K-major and B MN-major (transposed), both from shared memory.
__device__ __forceinline__ void wgmma_m64n128_tb(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] . B[16 x 256], the same operands.
__device__ __forceinline__ void wgmma_m64n256_tb(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// The product of one K step of 16 for an N-wide warpgroup tile.
template <int TN>
__device__ __forceinline__ void wgmma_tb(float (&d)[TN / 2], uint64_t da,
                                         uint64_t db) {
  if constexpr (TN == 128) wgmma_m64n128_tb(d, da, db);
  else wgmma_m64n256_tb(d, da, db);
}

// The wgmma m64nN accumulator layout (f32): thread t of warpgroup wg holds
// rows wg*64 + 16*(t/32 % 4) + (t%32)/4 + {0, 8}; element 4*i + 2*h + e is
// (row + 8h, column 8i + 2(t%4) + e). cols is a multiple of 8.
template <int TN, typename O>
__device__ void store_wgmma_frag(const float (&acc)[TN / 2], O* out, int ld,
                                 int rows, int cols, int tid) {
  const int lane = tid % 32;
  const int row0 = (tid / 128) * 64 + 16 * (tid / 32 % 4) + lane / 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= rows) continue;
    O* orow = out + (size_t)row * ld;
#pragma unroll
    for (int i = 0; i < TN / 8; ++i) {
      const int col = 8 * i + 2 * (lane % 4);
      if (col < cols) store2(orow + col, acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
}

__device__ __forceinline__ void consumer_sync() {   // the two warpgroups
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kBf16Consumers) : "memory");
}

template <class Src, bool kSplit>
__global__ void __launch_bounds__(kBf16Threads, 1)
gemm_bf16_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb, Src src,
                 const Split sp, int stages) {
  constexpr int TN = Src::kTn;
  constexpr int kStage = bf16_stage_bytes(TN);
  extern __shared__ uint8_t smem_raw[];
  // Stage s: A (128 rows x 64 k) at base + s * kStage, then B's TN / 64
  // regions of 64 columns; full[s] at bars + 8 s, empty[s] at bars + 8
  // (stages + s). The swizzle atom needs 1,024-byte alignment.
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t bars = base + stages * kStage;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  src.at(tile);
  int q_lo, q_hi;
  split_range(src.steps(), q_lo, q_hi);
  const int nq = q_hi - q_lo;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (stages + s), 4 * kBf16Consumers);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (tid >= 128 * kBf16Consumers) {   // the producer warp: one thread
    if (tid == 128 * kBf16Consumers) {
      for (int i = 0; i < nq; ++i) {
        const int s = i % stages;
        if (i >= stages)   // every consumer warp released step i - stages
          mbar_wait(bars + 8 * (stages + s), (i / stages - 1) & 1);
        const uint32_t st = base + s * kStage;
        mbar_expect_tx(bars + 8 * s, kStage);
        src.load(&ta, &tb, q_lo + i, st, st + kBf16ATile, bars + 8 * s);
      }
    }
    return;
  }

  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.0f;
  const uint32_t a_rows = (tid / 128) * 64 * 128;   // this warpgroup's rows
  for (int i = 0; i < nq; ++i) {
    const int s = i % stages;
    const uint32_t st = base + s * kStage;
    mbar_wait(bars + 8 * s, (i / stages) & 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < kBf16Bk / 16; ++t)   // A: +32 bytes a k16 step;
      wgmma_tb<TN>(acc,                       // B: +16 k rows of 128 bytes
                       make_desc(st + a_rows + 32 * t, 16, 1024),
                       make_desc(st + kBf16ATile + 2048 * t, kBRegion, 1024));
    wgmma_commit();
    wgmma_wait<1>();                          // step i - 1's products done
    fence_regs(acc);
    if (i > 0 && tid % 32 == 0)
      mbar_arrive(bars + 8 * (stages + (i - 1) % stages));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  const int rows = src.rows(), cols = src.cols();
  if constexpr (!kSplit) {
    store_wgmma_frag<TN>(acc, src.c_tile(), src.ldc(), rows, cols, tid);
  } else {
    store_wgmma_frag<TN>(acc, partial_tile<TN>(sp, tile), TN, kTileM, TN,
                         tid);
    if (!last_split(sp, tile, tid, [] { consumer_sync(); })) return;
    reduce_splits<TN>(sp, tile, src.c_tile(), src.ldc(), rows, cols, tid,
                      128 * kBf16Consumers);
  }
}

// A tensor map over a bf16 operand in the 128-byte swizzle, zeros past its
// edges: dims and box innermost first, strides in bytes (rank - 1 of them).
inline int encode_bf16(CUtensorMap* map, const void* base, int rank,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box) {
  cuuint32_t estride[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

// B (K, N) row-major: boxes of 64 columns x 64 k.
inline int encode_b_bf16(CUtensorMap* map, const void* b, int k, int n) {
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)k};
  const cuuint64_t strides[1] = {(cuuint64_t)n * 2};
  const cuuint32_t box[2] = {64, kBf16Bk};
  return encode_bf16(map, b, 2, dims, strides, box);
}

template <class Src, bool kSplit>
int launch_bf16(const CUtensorMap& ta, const CUtensorMap& tb, const Src& src,
                int tiles, int splits, int stages, int smem, const Split& sp,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_bf16_kernel<Src, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return (int)err;
  gemm_bf16_kernel<Src, kSplit><<<dim3((unsigned)tiles, (unsigned)splits),
                                  kBf16Threads, smem, stream>>>(
      ta, tb, src, sp, stages);
  return (int)cudaGetLastError();
}

// CTAs of the bf16 instance over Src (split or not) that one SM holds at
// `smem` bytes, from the occupancy calculator.
template <class Src, bool kSplit>
int bf16_ctas(int smem, int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_bf16_kernel<Src, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, gemm_bf16_kernel<Src, kSplit>, kBf16Threads, (size_t)smem);
}

template <class Src>
int gemm_bf16_ctas_per_sm(int splits, int smem, int* ctas) {
  return splits > 1 ? bf16_ctas<Src, true>(smem, ctas)
                    : bf16_ctas<Src, false>(smem, ctas);
}

template <class Src>
int launch_gemm_bf16(const CUtensorMap& ta, const CUtensorMap& tb,
                     const Src& src, int tiles, int splits, int stages,
                     int smem, const Split& sp, cudaStream_t stream) {
  return splits > 1 ? launch_bf16<Src, true>(ta, tb, src, tiles, splits,
                                             stages, smem, sp, stream)
                    : launch_bf16<Src, false>(ta, tb, src, tiles, splits,
                                              stages, smem, sp, stream);
}

}  // namespace
