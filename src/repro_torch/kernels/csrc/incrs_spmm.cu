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
// What bounds them on the H100: bytes moved into the SMs, and the
// shared-memory loads of the slot loops. At the Table II shapes a SpMM does
// about 2 * nnz * N flops against idx/val + B + C bytes, well under the
// f32 ridge of the card. Every order stages its rows' stripes the same way
// (Stripes below): a later section's raw stripe lands by cp.async while
// the next is compacted to its live slots, ascending, as interleaved
// (idx, val) pairs, and the current one is consumed, so no slot loop loads
// idx/val from device memory or visits a pad. What each order does with B:
//   expand:    a CTA of 8 warps, one row each, per 128-column tile; each
//              warp stages its own row's stripes four sections ahead by
//              16-byte copies, so warps never wait on each other; each
//              lane reads 4 adjacent columns of a B row as one float4, so
//              a warp's segment is one 512-byte request, and the loads of
//              8 slots are in registers before their FMAs run. Every live
//              slot gathers its B row from L2.
//   reuse:     a CTA of R rows x a panel of up to 512 columns; the sums stay
//              in registers over all sections; R = 2 at N >= 512, about 23
//              warps an SM at incrs-docword, to hide the L2 latency of the
//              B gathers.
//   pipelined: (section, 64) blocks of B stream by TMA through a ring of
//              mbarrier stages in shared memory, shared by the rows of the
//              CTA (24 at incrs-docword, one a warp), and by the CTAs of a
//              cluster on adjacent row tiles: each CTA copies 1/C of each
//              block's rows with .multicast::cluster, so L2 serves each
//              block once per cluster. The slot loop reads shared memory
//              only.
// No tensor cores and no TF32: the sums are IEEE f32.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"   // mbarriers, TMA, clusters, kTensorMapError

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// ---------------------------------------------------------------------------
// The stripes of `rows` rows in shared memory, two sections in flight: raw
// idx and val ([2][rows][ld] each; ld = smax rounded up to 4, plus 4,
// since a stripe starts anywhere mod 16 bytes and lands at the same offset
// mod 16, so its middle moves by 16-byte copies), compacted (idx, val)
// pairs ([2][rows][lc]; lc = smax rounded up to 2, so two slots are one
// 16-byte load) and live counts ([2][rows], 16 bytes a row): 16 * rows *
// (ld + lc + 1) bytes, a multiple of 16 (incrs_spmm.stripe_bytes). Local
// row r is row first + r * stride of the operand. A CTA's threads share
// one (reuse), or each warp keeps its own (expand, pipelined: no barrier,
// __syncwarp between sections).
struct Stripes {
  int* raw_i;
  float* raw_v;
  int2* cmp;
  int* cnt;
  int rows, smax, ld, lc, first, stride;

  __host__ __device__ static int bytes(int rows, int smax) {
    return 16 * rows * ((smax + 3) / 4 * 4 + 4 + (smax + 1) / 2 * 2 + 1);
  }
  __device__ Stripes(void* base, int rows_, int smax_, int first_,
                     int stride_)
      : rows(rows_), smax(smax_), ld((smax_ + 3) / 4 * 4 + 4),
        lc((smax_ + 1) / 2 * 2), first(first_), stride(stride_) {
    raw_i = reinterpret_cast<int*>(base);
    raw_v = reinterpret_cast<float*>(raw_i + 2 * rows * ld);
    cmp = reinterpret_cast<int2*>(raw_v + 2 * rows * ld);
    cnt = reinterpret_cast<int*>(cmp + 2 * rows * lc);
  }
  // Local row r's live slots of section s, in slot order, and their
  // count. Each row's list starts 16-byte aligned.
  __device__ const int2* live(int s, int r) const {
    return cmp + ((s & 1) * rows + r) * lc;
  }
  __device__ int count(int s, int r) const { return cnt[(s & 1) * rows + r]; }
  // Where row r's raw stripe of section s starts in its raw buffer.
  __device__ int shift(int s, int r, int n_sec) const {
    return (int)((((size_t)(first + r * stride) * n_sec + s) * smax) & 3);
  }

  // Section s's raw stripe into raw buffer s % 2 by cp.async, a warp per
  // row (one commit group per thread); rows past m copy nothing and are
  // never read. idx and val are 16-byte aligned (the wrapper sees to it).
  __device__ void stage(const int* __restrict__ idx,
                        const float* __restrict__ val, int m, int n_sec,
                        int s, int warp, int nwarps, int lane) const {
    for (int r = warp; r < rows; r += nwarps) {
      const int row = first + r * stride;
      if (row >= m) continue;
      const size_t o = ((size_t)row * n_sec + s) * smax;
      const int sh = (int)(o & 3), h = min(smax, (4 - sh) & 3);
      int* di = raw_i + ((s & 1) * rows + r) * ld + sh;
      float* dv = raw_v + ((s & 1) * rows + r) * ld + sh;
      // Elements [0, h) and [h + 4 * q, smax) by 4-byte copies, the q
      // aligned groups of 4 between them by 16-byte copies.
      const int q = (smax - h) / 4, t0 = h + 4 * q;
      for (int k = lane; k < q; k += 32) {
        cp_async16(di + h + 4 * k, idx + o + h + 4 * k);
        cp_async16(dv + h + 4 * k, val + o + h + 4 * k);
      }
      const int rest = h + smax - t0;   // head and tail, at most 6
      if (lane < rest) {
        const int j = lane < h ? lane : t0 + lane - h;
        cp_async4(di + j, idx + o + j);
        cp_async4(dv + j, val + o + j);
      }
    }
    cp_async_commit();
  }

  // Raw buffer s % 2 -> its live slots, in slot order, and their count.
  // One warp per row: ballot and popcount give each live slot its place.
  __device__ void compact(int m, int n_sec, int section, int s, int warp,
                          int nwarps, int lane) const {
    const int bs = s & 1;
    for (int r = warp; r < rows; r += nwarps) {
      const int* ri = raw_i + (bs * rows + r) * ld + shift(s, r, n_sec);
      const float* rv = raw_v + (bs * rows + r) * ld + shift(s, r, n_sec);
      int2* cp = cmp + (bs * rows + r) * lc;
      const bool row_ok = first + r * stride < m;
      int base = 0;
      for (int j0 = 0; j0 < smax; j0 += 32) {
        const int j = j0 + lane;
        const int i = j < smax ? ri[j] : -1;
        const bool live = row_ok && i >= 0 && i < section;
        const unsigned mask = __ballot_sync(kFull, live);
        if (live)
          cp[base + __popc(mask & ((1u << lane) - 1u))] =
              make_int2(i, __float_as_int(rv[j]));
        base += __popc(mask);
      }
      if (lane == 0) cnt[bs * rows + r] = base;
    }
  }

  // A warp's own stripes: each section's raw stripe is staged two
  // sections ahead and waited for only when it is compacted, one section
  // ahead of consume(s); __syncwarp orders the buffers (no CTA barrier).
  // One commit group a section (empty past the last), so waiting for all
  // but the newest group lands the section to compact.
  template <typename Consume>
  __device__ void warp_pipeline(const int* __restrict__ idx,
                                const float* __restrict__ val, int m,
                                int n_sec, int section, int lane,
                                Consume consume) const {
    stage(idx, val, m, n_sec, 0, 0, 1, lane);
    if (n_sec > 1) stage(idx, val, m, n_sec, 1, 0, 1, lane);
    else cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();
    compact(m, n_sec, section, 0, 0, 1, lane);
    __syncwarp();
    for (int s = 0; s < n_sec; ++s) {
      // Raw buffer s % 2 was compacted and compact buffer (s + 1) % 2
      // consumed before the last __syncwarp.
      if (s + 2 < n_sec) stage(idx, val, m, n_sec, s + 2, 0, 1, lane);
      else cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();
      if (s + 1 < n_sec) compact(m, n_sec, section, s + 1, 0, 1, lane);
      consume(s);
      __syncwarp();
    }
  }
};

// ---------------------------------------------------------------------------
// expand: grid (row tiles of blockDim / 32 rows, 128-column tiles); one
// warp per row, each with its own stripe pipeline (no CTA barrier), lane l
// on columns 4l .. 4l+3 of the tile. Vec: N % 4 == 0 and B 16-byte
// aligned, so a lane's columns are one float4 (ld.global.nc.v4); else four
// scalar loads.
constexpr int kExpCols = 128;
constexpr int kExpBatch = 8;    // slots whose B loads precede their FMAs

template <bool Vec>
__device__ __forceinline__ float4 load_cols(const float* p, int col, int n) {
  if (Vec) return __ldg(reinterpret_cast<const float4*>(p));
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < n) x.x = __ldg(p);
  if (col + 1 < n) x.y = __ldg(p + 1);
  if (col + 2 < n) x.z = __ldg(p + 2);
  if (col + 3 < n) x.w = __ldg(p + 3);
  return x;
}

template <bool Vec>
__global__ void __launch_bounds__(256)
expand_kernel(const int* __restrict__ idx, const float* __restrict__ val,
              const float* __restrict__ b, float* __restrict__ c,
              int m, int n, int n_sec, int smax, int section) {
  extern __shared__ __align__(16) unsigned char sraw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  const Stripes sb(sraw + (size_t)warp * Stripes::bytes(1, smax), 1, smax,
                   row, 1);
  const int col = blockIdx.y * kExpCols + 4 * lane;
  const bool col_ok = col < n;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);

  sb.warp_pipeline(idx, val, m, n_sec, section, lane, [&](int s) {
    const int live = sb.count(s, 0);   // warp-uniform; 0 past m
    const int2* cp = sb.live(s, 0);
    const float* bsec = b + (size_t)s * section * n + col;
    for (int j0 = 0; j0 < live; j0 += kExpBatch) {
      const int nb = min(kExpBatch, live - j0);
      int2 p[kExpBatch];
      float4 x[kExpBatch];
#pragma unroll
      for (int u = 0; u < kExpBatch; ++u)
        p[u] = u < nb ? cp[j0 + u] : make_int2(0, 0);
#pragma unroll
      for (int u = 0; u < kExpBatch; ++u)
        x[u] = u < nb && col_ok
                   ? load_cols<Vec>(bsec + (size_t)p[u].x * n, col, n)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int u = 0; u < kExpBatch; ++u) {
        if (u < nb) {   // slot order: the FMAs run as the slots stand
          const float v = __int_as_float(p[u].y);
          acc.x = __fmaf_rn(v, x[u].x, acc.x);
          acc.y = __fmaf_rn(v, x[u].y, acc.y);
          acc.z = __fmaf_rn(v, x[u].z, acc.z);
          acc.w = __fmaf_rn(v, x[u].w, acc.w);
        }
      }
    }
  });
  if (row < m && col_ok) {
    float* cr = c + (size_t)row * n + col;
    if (Vec) {
      *reinterpret_cast<float4*>(cr) = acc;
    } else {
      cr[0] = acc.x;
      if (col + 1 < n) cr[1] = acc.y;
      if (col + 2 < n) cr[2] = acc.z;
      if (col + 3 < n) cr[3] = acc.w;
    }
  }
}

// ---------------------------------------------------------------------------
// reuse: grid (row tiles of R rows, panels of 4 * TPR columns). The block
// stages its rows' stripe for one section once and reuses it over every
// column of its panel; TPR threads share a row, each keeping its 4 output
// columns (TPR apart, so a warp's loads of a B row are coalesced) in
// registers over all sections: the output is stationary and no panel
// lives in shared memory. One barrier per section.
constexpr int kReuseThreads = 256;
constexpr int kReuseCpt = 4;    // columns per thread, TPR apart

template <int TPR>
__global__ void __launch_bounds__(kReuseThreads)
reuse_kernel(const int* __restrict__ idx, const float* __restrict__ val,
             const float* __restrict__ b, float* __restrict__ c,
             int m, int n, int n_sec, int smax, int section) {
  constexpr int R = kReuseThreads / TPR;
  constexpr int kWarps = kReuseThreads / 32;
  extern __shared__ __align__(16) unsigned char sraw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rr = tid / TPR;
  const int row0 = blockIdx.x * R, row = row0 + rr;
  const int col0 = blockIdx.y * (kReuseCpt * TPR) + tid % TPR;
  const Stripes sb(sraw, R, smax, row0, 1);

  float acc[kReuseCpt];
#pragma unroll
  for (int k = 0; k < kReuseCpt; ++k) acc[k] = 0.0f;

  sb.stage(idx, val, m, n_sec, 0, warp, kWarps, lane);
  cp_async_wait_all();
  __syncthreads();
  if (n_sec > 1) sb.stage(idx, val, m, n_sec, 1, warp, kWarps, lane);
  sb.compact(m, n_sec, section, 0, warp, kWarps, lane);
  cp_async_wait_all();
  __syncthreads();
  for (int s = 0; s < n_sec; ++s) {
    if (s + 2 < n_sec) sb.stage(idx, val, m, n_sec, s + 2, warp, kWarps,
                                lane);
    if (s + 1 < n_sec) sb.compact(m, n_sec, section, s + 1, warp, kWarps,
                                  lane);
    if (row < m) {  // warp-uniform: TPR is a multiple of 32
      const int live = sb.count(s, rr);
      const int2* cp = sb.live(s, rr);
      const float* bsec = b + (size_t)s * section * n + col0;
#pragma unroll 4
      for (int j = 0; j < live; ++j) {
        const int2 p = cp[j];
        const float v = __int_as_float(p.y);
        const float* br = bsec + (size_t)p.x * n;
#pragma unroll
        for (int k = 0; k < kReuseCpt; ++k)
          if (col0 + TPR * k < n)
            acc[k] = __fmaf_rn(v, __ldg(br + TPR * k), acc[k]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }
  if (row < m) {
#pragma unroll
    for (int k = 0; k < kReuseCpt; ++k)
      if (col0 + TPR * k < n) c[(size_t)row * n + col0 + TPR * k] = acc[k];
  }
}

// ---------------------------------------------------------------------------
// pipelined: grid (row tiles of W rows, a multiple of the cluster size C;
// tiles of kPipeBlocks = 2 blocks of 32 * CPL columns), clusters of C CTAs along
// the rows, W consumer warps and a producer warp per CTA.
// - B: a 2-D tensor map over (n_sec * section, N) f32, box (32 * CPL
//   columns, box_rows rows). The (section, 32 * CPL) block of (section s,
//   column block j) is one ring stage: CTA rank q of the cluster copies
//   rows [q * boxes * box_rows, (q + 1) * boxes * box_rows) of it,
//   multicast to every CTA of the cluster (C * boxes * box_rows >=
//   section; rows past the section are never read). Each stage has a full
//   mbarrier (one arrival, the local producer's expect_tx of the whole
//   stage) and an empty one (one arrival from every consumer warp of every
//   CTA of the cluster): a stage is refilled only once all C CTAs are done
//   with it.
// - The producer warp (one elected lane) walks the (s, j) blocks `stages`
//   ahead of the consumers. Consumer warp w owns row w of the tile, lane l
//   columns CPL * l .. CPL * l + CPL - 1 of each block, and keeps the 2 x
//   CPL sums in registers over all sections. Each warp runs its own stripe
//   pipeline; its compacted stripe serves both blocks of the section.
//   Warps meet only at the ring's barriers.
// - The slot loop reads shared memory only: two slots' (idx, val) pairs
//   in one broadcast 16-byte load, and CPL adjacent floats of the slot's
//   B row per lane, for CPL FMAs per lane.
// - Every CTA walks every stage and every barrier of the cluster, rows or
//   not; no CTA leaves before the others are done arriving on its barriers.
// What bounds it: a fixed cost per ring stage (the ring holds 3 of the
// CTA's 2 * n_sec blocks) plus the slot loop of each of its W rows, which
// is bound by shared-memory loads (hence two columns a lane, and two
// slots' pairs per load). The wrapper takes the fewest warps that launch
// the grid in the fewest waves (incrs_spmm.pipelined_geometry).
constexpr int kPipeThreads = 1024;      // at most: 31 consumer warps + 1
constexpr int kPipeBatch = 8;     // slots whose B loads precede their FMAs
constexpr int kPipeBlocks = 2;    // column blocks per CTA

template <int CPL>
struct Cols;
template <>
struct Cols<1> {
  using T = float;
  __device__ static float get(const T& x, int) { return x; }
};
template <>
struct Cols<2> {
  using T = float2;
  __device__ static float get(const T& x, int e) { return e ? x.y : x.x; }
};

template <int CPL>
__global__ void __launch_bounds__(kPipeThreads, 1)
pipelined_kernel(const __grid_constant__ CUtensorMap tb,
                 const int* __restrict__ idx, const float* __restrict__ val,
                 float* __restrict__ c, int m, int n, int n_sec, int smax,
                 int section, int warps, int cluster, int stages,
                 int box_rows, int boxes) {
  using V = typename Cols<CPL>::T;
  constexpr int BW = 32 * CPL;                       // columns of a block
  extern __shared__ __align__(16) unsigned char sraw[];
  // The ring at a 128-byte boundary, the same offset in every CTA.
  unsigned char* base = sraw + ((128 - (smem_u32(sraw) & 127)) & 127);
  const int piece_rows = boxes * box_rows;           // one CTA's copy
  const int stage_floats = cluster * piece_rows * BW;
  float* ring = reinterpret_cast<float*>(base);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + stages * stage_floats);
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t rank = cluster_rank();
  const int row0 = blockIdx.x * warps;
  const int col0 = blockIdx.y * (kPipeBlocks * BW);
  // Column blocks of this tile that hold columns < N: the same in every
  // CTA of the cluster (one blockIdx.y).
  const int jn = min(kPipeBlocks, (n - col0 + BW - 1) / BW);

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, cluster * warps);
    }
    fence_mbar_init();
  }
  cluster_sync();   // the barriers exist before any CTA copies or arrives

  if (warp == warps) {                                // producer
    if (lane == 0) {
      const uint16_t mask = (uint16_t)((1u << cluster) - 1u);
      const int total = n_sec * jn;
      for (int k = 0, st = 0, ph = 0; k < total; ++k) {
        if (k >= stages) mbar_wait(empty0 + 8 * st, ph ^ 1);
        const uint32_t full = full0 + 8 * st;
        mbar_expect_tx(full, stage_floats * 4);
        const int s = k / jn, x = col0 + (k - s * jn) * BW;
        int y = s * section + (int)rank * piece_rows;
        uint32_t dst = smem_u32(ring + st * stage_floats +
                                rank * piece_rows * BW);
        for (int q = 0; q < boxes; ++q) {
          if (cluster > 1) tma_load_2d_multicast(dst, &tb, x, y, full, mask);
          else tma_load_2d(dst, &tb, x, y, full);
          y += box_rows;
          dst += box_rows * BW * 4;
        }
        if (++st == stages) { st = 0; ph ^= 1; }
      }
    }
    __syncwarp();
  } else {                                            // consumers
    const Stripes sb(reinterpret_cast<unsigned char*>(bars + 2 * stages) +
                         (size_t)warp * Stripes::bytes(1, smax),
                     1, smax, row0 + warp, 1);
    float acc[kPipeBlocks][CPL];
#pragma unroll
    for (int j = 0; j < kPipeBlocks; ++j)
#pragma unroll
      for (int e = 0; e < CPL; ++e) acc[j][e] = 0.0f;
    int st = 0, ph = 0;
    sb.warp_pipeline(idx, val, m, n_sec, section, lane, [&](int s) {
#pragma unroll
      for (int j = 0; j < kPipeBlocks; ++j) {
        if (j < jn) {
          mbar_wait(full0 + 8 * st, ph);
          const V* bt = reinterpret_cast<const V*>(ring + st * stage_floats) +
                        lane;
          const int live = sb.count(s, 0);   // warp-uniform; 0 past m
          const int4* cp = reinterpret_cast<const int4*>(sb.live(s, 0));
          for (int t0 = 0; t0 < live; t0 += kPipeBatch) {
            // The shared loads of a batch of slots are in flight
            // together; the FMAs then run in slot order.
            const int nb = min(kPipeBatch, live - t0);
            int4 p[kPipeBatch / 2];
            V x[kPipeBatch];
#pragma unroll
            for (int u = 0; u < kPipeBatch / 2; ++u)
              p[u] = 2 * u < nb ? cp[t0 / 2 + u] : make_int4(0, 0, 0, 0);
#pragma unroll
            for (int u = 0; u < kPipeBatch; ++u) {
              const int i = u & 1 ? p[u / 2].z : p[u / 2].x;
              x[u] = u < nb ? bt[i * 32] : V();
            }
#pragma unroll
            for (int u = 0; u < kPipeBatch; ++u) {
              if (u < nb) {
                const float v = __int_as_float(u & 1 ? p[u / 2].w
                                                     : p[u / 2].y);
#pragma unroll
                for (int e = 0; e < CPL; ++e)
                  acc[j][e] = __fmaf_rn(v, Cols<CPL>::get(x[u], e),
                                        acc[j][e]);
              }
            }
          }
          __syncwarp();
          if (lane < cluster) mbar_arrive_cluster(empty0 + 8 * st, lane);
          if (++st == stages) { st = 0; ph ^= 1; }
        }
      }
    });
    const int row = row0 + warp;
#pragma unroll
    for (int j = 0; j < kPipeBlocks; ++j)
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        const int col = col0 + j * BW + CPL * lane + e;
        if (row < m && col < n) c[(size_t)row * n + col] = acc[j][e];
      }
  }
  cluster_sync();   // no CTA leaves while another may arrive on its barriers
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The tensor map of B (kp x N f32, row-major) with boxes of box_cols
// columns x box_rows rows, no swizzle: a box lands as box_rows rows of
// box_cols floats.
int encode_b(CUtensorMap* map, const float* b, int kp, int n, int box_cols,
             int box_rows) {
  cuuint64_t gdim[2] = {(cuuint64_t)n, (cuuint64_t)kp};
  cuuint64_t gstride[1] = {(cuuint64_t)n * sizeof(float)};
  cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  cuuint32_t estride[2] = {1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(b), gdim,
      gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

template <int CPL>
int launch_pipelined(const CUtensorMap& tb, const int* idx, const float* val,
                     float* c, int m, int n, int n_sec, int smax, int section,
                     int warps, int cluster, int stages, int box_rows,
                     int boxes, int row_tiles, int col_tiles, size_t smem,
                     cudaStream_t stream) {
  const void* fn = (const void*)pipelined_kernel<CPL>;
  int err = (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_tiles, col_tiles);
  cfg.blockDim = dim3((warps + 1) * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // A cluster the card cannot place is refused here, before any launch:
  // the kernel never runs without its cluster.
  int clusters = 0;
  err = (int)cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err) return err;
  if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
  return (int)cudaLaunchKernelEx(&cfg, pipelined_kernel<CPL>, tb, idx, val,
                                 c, m, n, n_sec, smax, section, warps,
                                 cluster, stages, box_rows, boxes);
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes. Each function launches on `stream`,
// does not synchronise, and returns the cudaError_t of the launch (0 = ok),
// or kTensorMapError + the CUresult when B's tensor map cannot be encoded.
// The caller computes every launch geometry (incrs_spmm.launch_geometry).
extern "C" {

const char* incrs_error_string(int err) { return hopper_error_string(err); }

// CTAs of one instance that one SM holds at `threads` threads and `smem`
// bytes of dynamic shared memory, from the occupancy calculator. kernel
// 0: expand_kernel (instance 1 its float4 form, 0 its scalar one); 1:
// reuse_kernel<instance> (threads a row); 2: pipelined_kernel<instance>
// (columns a lane).
int incrs_ctas_per_sm(int kernel, int instance, int threads, size_t smem,
                      int* ctas) {
  const void* fn = nullptr;
  if (kernel == 0)
    fn = instance ? (const void*)expand_kernel<true>
                  : (const void*)expand_kernel<false>;
  else if (kernel == 1 && instance == 32) fn = (const void*)reuse_kernel<32>;
  else if (kernel == 1 && instance == 64) fn = (const void*)reuse_kernel<64>;
  else if (kernel == 1 && instance == 128)
    fn = (const void*)reuse_kernel<128>;
  else if (kernel == 2 && instance == 1)
    fn = (const void*)pipelined_kernel<1>;
  else if (kernel == 2 && instance == 2)
    fn = (const void*)pipelined_kernel<2>;
  if (fn == nullptr || threads < 1) return (int)cudaErrorInvalidValue;
  int err = set_smem(fn, smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn,
                                                            threads, smem);
}

// `rows`: warps (one row each) per CTA, 1 to 8; `smem`: their stripes,
// each warp's own.
int incrs_spmm_expand(const int* idx, const float* val, const float* b,
                      float* c, int m, int n, int n_sec, int smax,
                      int section, int rows, size_t smem, int device,
                      void* stream) {
  if (rows < 1 || rows > 8) return cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const bool vec = n % 4 == 0 && ((uintptr_t)b & 15) == 0;
  const void* fn = vec ? (const void*)expand_kernel<true>
                       : (const void*)expand_kernel<false>;
  err = set_smem(fn, smem);
  if (err) return err;
  dim3 grid((m + rows - 1) / rows, (n + kExpCols - 1) / kExpCols);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    expand_kernel<true><<<grid, rows * 32, smem, st>>>(idx, val, b, c, m, n,
                                                       n_sec, smax, section);
  else
    expand_kernel<false><<<grid, rows * 32, smem, st>>>(idx, val, b, c, m, n,
                                                        n_sec, smax, section);
  return (int)cudaGetLastError();
}

// The caller chooses the threads per row, tpr = 32, 64 or 128 (a 128, 256
// or 512-column panel; the block covers kReuseThreads / tpr rows), and
// sizes `smem`: the stripes of those rows.
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

// cpl columns per lane (1 or 2: blocks of 32 or 64 columns) picks the
// instance; `warps` consumer warps (1 to 31), one row each; a cluster of
// `cluster` CTAs along the rows (dividing row_tiles); a ring of `stages`
// stages of cluster * boxes * box_rows rows; `smem` the ring, its
// barriers and the stripes.
int incrs_spmm_pipelined(const int* idx, const float* val, const float* b,
                         float* c, int m, int n, int n_sec, int smax,
                         int section, int cpl, int warps, int cluster,
                         int stages, int box_rows, int boxes, int row_tiles,
                         int col_tiles, size_t smem, int device,
                         void* stream) {
  if (n % 4 != 0 || ((uintptr_t)b & 15) != 0 || warps < 1 || warps > 31 ||
      cluster < 1 || row_tiles % cluster != 0 || stages < 2 ||
      box_rows < 1 || box_rows > 256 || boxes < 1 ||
      cluster * boxes * box_rows < section || (cpl != 1 && cpl != 2))
    return cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  CUtensorMap tb;
  err = encode_b(&tb, b, n_sec * section, n, 32 * cpl, box_rows);
  if (err) return err;
  auto launch = cpl == 1 ? launch_pipelined<1> : launch_pipelined<2>;
  return launch(tb, idx, val, c, m, n, n_sec, smax, section, warps, cluster,
                stages, box_rows, boxes, row_tiles, col_tiles, smem,
                (cudaStream_t)stream);
}

}  // extern "C"
