// Round-synchronized index matching on Hopper (sm_90a): C = A @ B^T for two
// sparse operands in the per-round padded form of ops.prep_rounds.
//
// Replaces three Pallas kernels:
//   ring_kernel<false>, match_kernel<false> <- _kernel (index_match_spmm,
//       src/repro/kernels/index_match_spmm.py:48/:68)
//   ring_kernel<true>, match_kernel<true> <- _condense_kernel
//       (spgemm_condense, src/repro/spgemm/kernels.py:48/:59)
//   merge_ring_kernel, merge_kernel <- _merge_kernel (spgemm_merge,
//       src/repro/spgemm/kernels.py:97/:111)
//
// Inputs: idx int32 / val f32 of shape (rows, n_rounds, rmax), each slot the
// LOCAL index of a non-zero inside its round window [t*R, (t+1)*R), -1 (or
// any index outside [0, R)) = pad, in any slot; A is (M, ...), B is
// (N, ...). Outputs f32: C (M, N), or the stripes S (n_rounds, M, N),
// indexed with 64-bit offsets (S holds 3.4e9 elements at the largest Table
// IV operand). Every shape is masked.
//
// The TPU kernels one-hot expand both round windows into dense (rows, R)
// tiles only because the MXU needs dense tiles. Here Alg. 2 runs as it is
// written: two non-zeros meet iff they carry the same index in the same
// round. A block holds its B rows' round-t windows dense in shared memory
// (the comparator array: B's value at each index, 0 elsewhere), and each
// A row's live slots are looked up in it. So the partial
//   p(i, j, t) = sum over A's live slots of round t, ascending, of
//                a_val * B_window[j][a_idx],
// which is the sum of a_val * b_val over equal indices in ascending index
// order: an unmatched slot adds an exact zero, which changes nothing.
//
// Two designs, chosen by the wrapper (index_match_spmm.match_geometry):
//
// ring (ring_kernel): a pre-pass (count_kernel, scan_kernel,
//   write_kernel) first packs each operand's live slots, in slot order,
//   round-major: for round t, the entries (row << 8 | index, value) of
//   rows 0, 1, ... one after another, and each row's first entry
//   (off[t][row], rows + 1 of them). A tile's rows of one
//   round are then one contiguous range, 9x smaller than their padded
//   slots at mesh-docword4 (5.1 live of rmax 45); it also flags a B row
//   that repeats an index in a round. A persistent grid of one 512-thread
//   CTA an SM walks (tile, round) items; a tile is 14 * rpw A rows x 128
//   B rows. Three roles, ordered by mbarriers (no CTA barrier an item):
//   a producer warp keeps `stages` items in flight by 1-D bulk copies
//   (offsets, then the entry ranges they name: B's whole, then as much of
//   A's as fits; the rest is read in place from global memory) into a
//   ring of shared-memory stages; a window warp turns the two B windows
//   (2 x R x 128 f32, index-major, so a lane reads its 4 columns as one
//   float4) in turn, clearing the entries of item u - 2 and storing those
//   of item u, 32 lanes over the entries; 14 consumer warps look their A
//   rows up, two rows at a time. So the window of item u + 1 is built
//   while item u is looked up, and no global memory is read twice.
//   Fused: all rounds of a tile run in one CTA, ascending, sums in
//   registers (16 rows x 4 columns a lane at most); a round whose B tile
//   holds no live slot is skipped. Condense: each CTA takes a contiguous
//   chunk of the (tile, round) items, so the rounds of a tile spread over
//   CTAs, and streams each partial out as float4 __stcs; an item with no
//   live B slot writes zeros without looking anything up.
// general (match_kernel): the first design, for what the ring does not
//   take (R > 256, windows and ring beyond 227 KB, rows past an entry's
//   row bits): grid (column blocks of 128, row blocks of 64), the rounds
//   a loop with three barriers, B's round window staged from global
//   memory each round.
//
// Bitwise contract: each design has one definition of p (ring_partial,
// round_partials), used by its fused and its condense instance, with
// explicit __fmaf_rn from 0 in ascending slot order; the two definitions
// run the same FMAs in the same order, so the designs agree too. The fused
// kernels add p into their accumulators with __fadd_rn, rounds ascending
// from 0; both merge designs add S[t] the same way. So condense + merge
// equals the fused kernel bit for bit, the JAX contract
// (spgemm/kernels.py:16-19),
// nvcc cannot contract the sums differently in the two, and no float
// atomics touch an output. The windows take them only where a B row
// repeats an index in a round (ops.prep_rounds never does; exact for one
// repeat), so a call equals its repeat bit for bit unless an index comes
// three times in one window, in both designs alike.
//
// What bounds them on the H100: the fused kernel must move both idx arrays
// in full (pads are read to be skipped), the live values and C, and do 2
// flops per matched pair: bytes, about 0.02 ms at mesh-docword4. What it
// executes is one shared-memory lookup and one FMA per live A slot per
// output column, matched or not (1.1 G at mesh-docword4, R = 128: about
// 0.15 ms of the SMs' shared-memory bandwidth). Condense adds the stripe
// array's write (0.89 GB there), merge reads it back: both are streams of
// bytes, so the stripe writes are coalesced along N. Merge, two designs
// (spgemm.kernels.merge_geometry): ring (merge_ring_kernel), a persistent
// grid of two CTAs an SM; each CTA owns contiguous chunks of the (M, N)
// plane, and a producer thread streams the chunk of round t, t ascending,
// into a ring of shared-memory stages by 1-D bulk copies, so each round's
// read is one contiguous burst of the chunk; 8 consumer warps add each
// stage into registers and write the chunk of C once, float4 __stcs.
// general (merge_kernel), the first design, for a plane that is not a
// multiple of 4 or stripes off 16 bytes: a thread owns 4 consecutive
// elements and reads them round after round, a plane apart. No tensor
// cores and no TF32: the sums are IEEE f32.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"   // mbarriers, 1-D bulk copies, the proxy fence

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

// The ring design of merge. Item i is the chunk [i * chunk, (i + 1) *
// chunk) of the plane (the last one shorter); CTA b takes items b, b +
// gridDim.x, ... Stage q of the ring holds `chunk` floats; full[q] (one
// arrival and the copy's bytes) and empty[q] (one arrival a consumer warp)
// order it. The producer's copies run across item boundaries, so the next
// chunk's rounds land while this chunk's last ones are added. Needs plane,
// chunk and both pointers on 16 bytes (the wrapper's geometry says so).
constexpr int kMergeWarps = 8;                       // consumer warps
constexpr int kMergeRingThreads = (kMergeWarps + 1) * 32;
constexpr int kMergeVec = 8;                         // float4 a consumer
constexpr int kMergeMaxChunk = kMergeVec * 4 * kMergeWarps * 32;  // 8192

__global__ void __launch_bounds__(kMergeRingThreads, 1)
merge_ring_kernel(const float* __restrict__ s, float* __restrict__ c,
                  long long plane, int n_rounds, int chunk, int stages,
                  long long items) {
  extern __shared__ __align__(16) unsigned char sraw[];
  float* ring = reinterpret_cast<float*>(sraw);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(sraw + (size_t)stages * chunk * 4);
  uint64_t* empty = full + stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int q = 0; q < stages; ++q) {
      mbar_init(smem_u32(full + q), 1);
      mbar_init(smem_u32(empty + q), kMergeWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == kMergeWarps) {                         // the producer
    if (lane == 0) {
      int q = 0, phase = 0;
      bool reuse = false;          // stage q held an earlier copy
      for (long long it = blockIdx.x; it < items; it += gridDim.x) {
        const long long e0 = it * chunk;
        const uint32_t bytes =
            (uint32_t)(min((long long)chunk, plane - e0) * 4);
        for (int t = 0; t < n_rounds; ++t) {
          if (reuse) mbar_wait(smem_u32(empty + q), phase ^ 1);
          mbar_expect_tx(smem_u32(full + q), bytes);
          bulk_load(smem_u32(ring + (size_t)q * chunk),
                    s + (size_t)t * plane + e0, bytes, smem_u32(full + q));
          if (++q == stages) {
            q = 0;
            phase ^= 1;
            reuse = true;
          }
        }
      }
    }
    return;
  }

  int q = 0, phase = 0;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long e0 = it * chunk;
    const int len = (int)min((long long)chunk, plane - e0);
    float4 acc[kMergeVec];
#pragma unroll
    for (int j = 0; j < kMergeVec; ++j)
      acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int t = 0; t < n_rounds; ++t) {
      mbar_wait(smem_u32(full + q), phase);
      const float4* st = reinterpret_cast<const float4*>(ring) +
                         (size_t)q * (chunk / 4);
#pragma unroll
      for (int j = 0; j < kMergeVec; ++j) {
        const int e = j * kMergeWarps * 32 + tid;    // float4 of the chunk
        if (4 * e < len) {
          const float4 v = st[e];
          acc[j].x = __fadd_rn(acc[j].x, v.x);
          acc[j].y = __fadd_rn(acc[j].y, v.y);
          acc[j].z = __fadd_rn(acc[j].z, v.z);
          acc[j].w = __fadd_rn(acc[j].w, v.w);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(empty + q));
      if (++q == stages) {
        q = 0;
        phase ^= 1;
      }
    }
    float4* c4 = reinterpret_cast<float4*>(c + e0);
#pragma unroll
    for (int j = 0; j < kMergeVec; ++j) {
      const int e = j * kMergeWarps * 32 + tid;
      if (4 * e < len) __stcs(c4 + e, acc[j]);
    }
  }
}

// ---------------------------------------------------------------------------
// The ring design. Its inputs first pass through the packing pre-pass.
__device__ __forceinline__ bool live_slot(int k, int rounds) {
  return k >= 0 && k < rounds;
}

// One operand: its padded slots and their packed round-major copy. ent
// has room for rows * rmax entries a round (round t's start at t * rows *
// rmax) and off for rows + 1 offsets a round; both hold 16 bytes more, so
// a bulk copy rounded up to 16 bytes stays inside them.
struct Side {
  const int* idx;
  const float* val;
  int2* ent;
  int* off;
  int* dups;       // B: set where a row repeats an index in a round
  int rows, rmax;
};

constexpr int kPackWarps = 8;       // count and write: 32 rows a warp
constexpr int kPackRows = kPackWarps * 32;
constexpr int kScanThreads = 1024;
constexpr int kPackBatch = 8;       // rows whose slot loads are in flight
constexpr int kRowShift = 8;        // an entry's index bits (R <= 256)
constexpr int kRingMaxRounds = 1 << kRowShift;

// The packing pre-pass, three kernels over grid (row blocks, n_rounds, 2)
// (z: A, then B), (n_rounds, 2) and the first grid again:
//   count_kernel  each warp counts the live slots of 32 rows of a round
//                 into off[t][row]; for B it also marks each row's
//                 indices in a bit set and raises *dups if one repeats,
//                 so the window warp knows whether plain stores build the
//                 window;
//   scan_kernel   a round's counts become each row's first entry, in
//                 place, and off[t][rows] the round's total;
//   write_kernel  each warp writes its rows' live slots from their first
//                 entries, in slot order, a ballot and a popcount giving
//                 each slot its place. An entry is (row << 8 | index,
//                 value bits): the window warp reads its column off it.
// Row blocks run side by side, so the pass is bound by bytes, not by one
// block's walk over a round.
__global__ void __launch_bounds__(kPackWarps * 32)
count_kernel(Side a, Side b, int n_rounds, int rounds) {
  __shared__ unsigned seen[kPackWarps][32][kRingMaxRounds / 32];
  const Side s = blockIdx.z ? b : a;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kPackRows + warp * 32;  // lane q: row0 + q
  if (row0 >= s.rows) return;                           // warp-uniform
  const int t = blockIdx.y;
  const bool check = s.dups != nullptr;
  const size_t row_step = (size_t)n_rounds * s.rmax;
  const int* idx = s.idx + (size_t)t * s.rmax;
  if (check) {
#pragma unroll
    for (int w = 0; w < kRingMaxRounds / 32; ++w) seen[warp][lane][w] = 0u;
    __syncwarp();
  }
  int mine = 0;
  bool dup = false;
  for (int j0 = 0; j0 < s.rmax; j0 += 32) {
    const int j = j0 + lane;
    for (int q0 = 0; q0 < 32; q0 += kPackBatch) {
      int k[kPackBatch];
#pragma unroll
      for (int u = 0; u < kPackBatch; ++u) {
        const int row = row0 + q0 + u;
        k[u] = row < s.rows && j < s.rmax ? idx[row * row_step + j] : -1;
      }
#pragma unroll
      for (int u = 0; u < kPackBatch; ++u) {
        const bool live = live_slot(k[u], rounds);
        const int c = __popc(__ballot_sync(kFull, live));
        if (lane == q0 + u) mine += c;
        if (check && live) {
          const unsigned bit = 1u << (k[u] & 31);
          dup |= (atomicOr(&seen[warp][q0 + u][k[u] >> 5], bit) & bit) != 0;
        }
      }
    }
  }
  if (__any_sync(kFull, dup) && lane == 0) atomicOr(s.dups, 1);
  if (row0 + lane < s.rows)
    s.off[(size_t)t * (s.rows + 1) + row0 + lane] = mine;
}

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(Side a, Side b) {
  __shared__ int warp_first[32];
  __shared__ int chunk_total;
  const Side s = blockIdx.y ? b : a;
  int* off = s.off + (size_t)blockIdx.x * (s.rows + 1);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int carry = 0;
  for (int base = 0; base < s.rows; base += kScanThreads) {
    const int row = base + tid;
    const int mine = row < s.rows ? off[row] : 0;
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) warp_first[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = warp_first[lane];
      int wi = w;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, wi, d);
        if (lane >= d) wi += y;
      }
      warp_first[lane] = wi - w;
      if (lane == 31) chunk_total = wi;
    }
    __syncthreads();
    if (row < s.rows) off[row] = carry + warp_first[warp] + incl - mine;
    carry += chunk_total;
    __syncthreads();   // warp_first and chunk_total serve the next chunk
  }
  if (tid == 0) off[s.rows] = carry;
}

__global__ void __launch_bounds__(kPackWarps * 32)
write_kernel(Side a, Side b, int n_rounds, int rounds) {
  const Side s = blockIdx.z ? b : a;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kPackRows + warp * 32;  // lane q: row0 + q
  if (row0 >= s.rows) return;
  const int t = blockIdx.y;
  const unsigned below = (1u << lane) - 1u;
  const size_t row_step = (size_t)n_rounds * s.rmax;
  const int* idx = s.idx + (size_t)t * s.rmax;
  const float* val = s.val + (size_t)t * s.rmax;
  int2* ent = s.ent + (size_t)t * s.rows * s.rmax;
  int pos = row0 + lane < s.rows
      ? s.off[(size_t)t * (s.rows + 1) + row0 + lane] : 0;
  for (int j0 = 0; j0 < s.rmax; j0 += 32) {
    const int j = j0 + lane;
    for (int q0 = 0; q0 < 32; q0 += kPackBatch) {
      int k[kPackBatch];
      float v[kPackBatch];
#pragma unroll
      for (int u = 0; u < kPackBatch; ++u) {
        const int row = row0 + q0 + u;
        k[u] = row < s.rows && j < s.rmax ? idx[row * row_step + j] : -1;
      }
#pragma unroll
      for (int u = 0; u < kPackBatch; ++u) {
        const int row = row0 + q0 + u;
        v[u] = live_slot(k[u], rounds) ? val[row * row_step + j] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kPackBatch; ++u) {
        const bool live = live_slot(k[u], rounds);
        const unsigned mask = __ballot_sync(kFull, live);
        const int first = __shfl_sync(kFull, pos, q0 + u);
        if (live)
          ent[first + __popc(mask & below)] = make_int2(
              (row0 + q0 + u) << kRowShift | k[u], __float_as_int(v[u]));
        if (lane == q0 + u) pos += __popc(mask);
      }
    }
  }
}

// The pre-pass on `stream`: B's repeat flag cleared, then the three
// kernels. Returns the first launch error.
int launch_pack(const Side& a, const Side& b, int n_rounds, int rounds,
                cudaStream_t stream) {
  int err = (int)cudaMemsetAsync(b.dups, 0, sizeof(int), stream);
  if (err) return err;
  const dim3 grid((max(a.rows, b.rows) + kPackRows - 1) / kPackRows,
                  n_rounds, 2);
  count_kernel<<<grid, kPackWarps * 32, 0, stream>>>(a, b, n_rounds, rounds);
  scan_kernel<<<dim3(n_rounds, 2), kScanThreads, 0, stream>>>(a, b);
  write_kernel<<<grid, kPackWarps * 32, 0, stream>>>(a, b, n_rounds, rounds);
  return (int)cudaGetLastError();
}

constexpr int kRingWarps = 14;                  // consumer warps
constexpr int kWindowWarp = kRingWarps;        // B's windows
constexpr int kProducerWarp = kRingWarps + 1;   // the bulk copies
constexpr int kRingThreads = (kRingWarps + 2) * 32;
constexpr int kRingCols = 128;                  // B rows a tile: 4 a lane
constexpr int kMaxRowsPerWarp = 16;
constexpr int kIndexMask = (1 << kRowShift) - 1;
constexpr int kOffB = (kRingCols + 1 + 3 + 3) / 4 * 4;

// Ints of a stage's A offsets: tile_m + 1 of them behind a head of up to 3
// (a bulk copy starts on 16 bytes), in whole 16-byte units.
__host__ __device__ inline int ring_off_a(int tile_m) {
  return (tile_m + 1 + 3 + 3) / 4 * 4;
}
__host__ __device__ inline size_t ring_stage_bytes(int tile_m, int cap) {
  return (size_t)(ring_off_a(tile_m) + kOffB) * 4 + cap;
}
// Windows, stages, then three mbarriers a stage and two a window.
__host__ __device__ inline size_t ring_smem_bytes(int rounds, int tile_m,
                                                  int stages, int cap) {
  return (size_t)2 * rounds * kRingCols * 4 +
         stages * ring_stage_bytes(tile_m, cap) + (size_t)24 * stages + 32;
}

struct Ring {
  Side a, b;                 // idx and val are not read
  float* out;
  int m, n, n_rounds, rounds;
  int rows_per_warp, stages, cap;   // cap: entry bytes a stage
  int col_tiles, tiles;
  long long chunk;           // condense: items a CTA
  int vec;                   // N % 4 == 0 and out on 16 bytes
};

__device__ __forceinline__ int head16(const void* p) {
  return (int)((uintptr_t)p & 15);
}
__device__ __forceinline__ const void* down16(const void* p) {
  return (const void*)((uintptr_t)p & ~(uintptr_t)15);
}
__device__ __forceinline__ int up16(int x) { return (x + 15) & ~15; }

// What one (tile, round) item reads, and where its stage holds it. The
// stage's entry space takes B's range first, if it fits whole, then as
// much of A's as is left: A rows whose entries all landed are read from
// the stage, the others (and B if it did not fit) from global memory.
struct View {
  int t, i0, j0, rows_a, rows_b;
  const int* off_a;          // rows_a + 1 offsets, in the stage
  const int* off_b;
  const int2* ga;            // entry of offset off_a[0] in global memory
  const int2* gb;
  const int2* sa;            // the same in the stage (first sa_n of them)
  const int2* eb;            // B's entries: stage or global
  int sa_n;
  int copy_a, copy_b;        // bytes copied (multiples of 16)
};

template <bool kStripes>
struct RingCta {
  const Ring& g;
  unsigned char* stages;
  uint64_t* bars;            // [stages] each: offsets, entries, empty;
                             // then [2] each: window full, window empty
  int tile_m, off_a_ints;
  size_t stage_bytes;
  int n_items;

  __device__ RingCta(const Ring& g_, unsigned char* base)
      : g(g_), tile_m(kRingWarps * g_.rows_per_warp) {
    off_a_ints = ring_off_a(tile_m);
    stage_bytes = ring_stage_bytes(tile_m, g.cap);
    stages = base + (size_t)2 * g.rounds * kRingCols * 4;
    bars = reinterpret_cast<uint64_t*>(stages + g.stages * stage_bytes);
    if (kStripes) {
      const long long total = (long long)g.tiles * g.n_rounds;
      const long long first = (long long)blockIdx.x * g.chunk;
      n_items = (int)max(0LL, min(g.chunk, total - first));
    } else {
      const int mine = (int)blockIdx.x < g.tiles
          ? (g.tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x
          : 0;
      n_items = mine * g.n_rounds;
    }
  }

  // Item u of this CTA: fused, the rounds of tiles blockIdx.x, + gridDim.x,
  // ... in turn; condense, items blockIdx.x * chunk + u of all (tile,
  // round) pairs, tile-major.
  __device__ __forceinline__ void locate(int u, View& v) const {
    int tile;
    if (kStripes) {
      const long long q = (long long)blockIdx.x * g.chunk + u;
      tile = (int)(q / g.n_rounds);
      v.t = (int)(q - (long long)tile * g.n_rounds);
    } else {
      tile = (int)blockIdx.x + (u / g.n_rounds) * (int)gridDim.x;
      v.t = u % g.n_rounds;
    }
    const int rt = tile / g.col_tiles;
    v.i0 = rt * tile_m;
    v.j0 = (tile - rt * g.col_tiles) * kRingCols;
    v.rows_a = min(tile_m, g.m - v.i0);
    v.rows_b = min(kRingCols, g.n - v.j0);
  }
  __device__ const int* off_src_a(const View& v) const {
    return g.a.off + (size_t)v.t * (g.m + 1) + v.i0;
  }
  __device__ const int* off_src_b(const View& v) const {
    return g.b.off + (size_t)v.t * (g.n + 1) + v.j0;
  }
  __device__ unsigned char* stage(int u) const {
    return stages + (size_t)(u % g.stages) * stage_bytes;
  }
  __device__ unsigned char* entries(int u) const {
    return stage(u) + (size_t)(off_a_ints + kOffB) * 4;
  }
  __device__ uint32_t off_bar(int u) const {
    return smem_u32(bars + u % g.stages);
  }
  __device__ uint32_t ent_bar(int u) const {
    return smem_u32(bars + g.stages + u % g.stages);
  }
  __device__ uint32_t empty_bar(int u) const {
    return smem_u32(bars + 2 * g.stages + u % g.stages);
  }
  __device__ uint32_t win_full(int u) const {
    return smem_u32(bars + 3 * g.stages + (u & 1));
  }
  __device__ uint32_t win_empty(int u) const {
    return smem_u32(bars + 3 * g.stages + 2 + (u & 1));
  }
  __device__ int parity(int u) const { return (u / g.stages) & 1; }

  // The item's view once its offsets have landed: producer and consumers
  // compute the same plan from the same offsets.
  __device__ __forceinline__ void view(int u, View& v) const {
    locate(u, v);
    const int* so = reinterpret_cast<const int*>(stage(u));
    v.off_a = so + head16(off_src_a(v)) / 4;
    v.off_b = so + off_a_ints + head16(off_src_b(v)) / 4;
    const int a0 = v.off_a[0], b0 = v.off_b[0];
    const int la = v.off_a[v.rows_a] - a0, lb = v.off_b[v.rows_b] - b0;
    v.ga = g.a.ent + (size_t)v.t * g.m * g.a.rmax + a0;
    v.gb = g.b.ent + (size_t)v.t * g.n * g.b.rmax + b0;
    const int bytes_b = lb ? up16(lb * 8 + head16(v.gb)) : 0;
    v.copy_b = bytes_b <= g.cap ? bytes_b : 0;
    const int bytes_a = la ? up16(la * 8 + head16(v.ga)) : 0;
    v.copy_a = min(bytes_a, g.cap - v.copy_b);
    v.sa_n = max(0, (v.copy_a - head16(v.ga)) / 8);
    if (v.sa_n == 0) v.copy_a = 0;
    unsigned char* se = entries(u);
    v.eb = v.copy_b ? reinterpret_cast<const int2*>(se + head16(v.gb))
                    : v.gb;
    v.sa = reinterpret_cast<const int2*>(se + v.copy_b + head16(v.ga));
  }

  // Producer: item x's offsets into its stage.
  __device__ void load_offsets(int x) const {
    if (x >= n_items) return;
    View v;
    locate(x, v);
    const int* ga = off_src_a(v);
    const int* gb = off_src_b(v);
    const int ba = up16((v.rows_a + 1) * 4 + head16(ga));
    const int bb = up16((v.rows_b + 1) * 4 + head16(gb));
    const uint32_t bar = off_bar(x);
    mbar_expect_tx(bar, ba + bb);
    unsigned char* st = stage(x);
    bulk_load(smem_u32(st), down16(ga), ba, bar);
    bulk_load(smem_u32(st + off_a_ints * 4), down16(gb), bb, bar);
  }

  // Producer: item x's entry ranges, once its offsets have landed.
  __device__ void load_entries(int x) const {
    if (x >= n_items) return;
    mbar_wait(off_bar(x), parity(x));
    View v;
    view(x, v);
    const uint32_t bar = ent_bar(x);
    mbar_expect_tx(bar, v.copy_a + v.copy_b);
    unsigned char* se = entries(x);
    if (v.copy_b) bulk_load(smem_u32(se), down16(v.gb), v.copy_b, bar);
    if (v.copy_a)
      bulk_load(smem_u32(se + v.copy_b), down16(v.ga), v.copy_a, bar);
  }
};

// Item v's B entries into (kClear = false) or out of (kClear = true)
// window w, the window warp's lanes taking every 32nd entry, kBuild of
// them loaded before any is stored: an entry names its column (row - j0)
// and index. Where a row repeats an index in a round (kAtomic), the
// repeats add up, as in the one-hot form, by shared-memory atomics (as the
// general kernel's staging: exact for two, in any order); else each cell
// has one entry and a plain store builds it.
constexpr int kBuild = 8;

template <bool kClear, bool kAtomic>
__device__ __forceinline__ void build_window(float* w, int lane,
                                             const View& v) {
  const int lb = v.off_b[v.rows_b] - v.off_b[0];
  for (int e0 = lane; e0 < lb; e0 += 32 * kBuild) {
    int2 s[kBuild];
#pragma unroll
    for (int u = 0; u < kBuild; ++u) {
      const int e = e0 + 32 * u;
      s[u] = e < lb ? v.eb[e] : make_int2(-1, 0);
    }
#pragma unroll
    for (int u = 0; u < kBuild; ++u) {
      if (s[u].x < 0) continue;
      float* dst = w + (s[u].x & kIndexMask) * kRingCols +
                   ((s[u].x >> kRowShift) - v.j0);
      if (kClear) *dst = 0.0f;
      else if (kAtomic) atomicAdd(dst, __int_as_float(s[u].y));
      else *dst = __int_as_float(s[u].y);
    }
  }
}

__device__ __forceinline__ void fma_slot(float4& p, int2 s,
                                         const float4* wc) {
  const float v = __int_as_float(s.y);
  const float4 w = wc[(s.x & kIndexMask) * (kRingCols / 4)];
  p.x = __fmaf_rn(v, w.x, p.x);
  p.y = __fmaf_rn(v, w.y, p.y);
  p.z = __fmaf_rn(v, w.z, p.z);
  p.w = __fmaf_rn(v, w.w, p.w);
}

// The one definition of the ring instances' partial: a lane's 4 columns
// (wc, a float4 of the window's index-major rows) over the live slots of
// an A row, in slot order, f32 FMA from 0. Two rows at a time (c1 = 0:
// one), their chains interleaved so that twice the lookups are in flight;
// each row's FMAs still run in its own slot order.
__device__ __forceinline__ void ring_partial(const int2* e0, int c0,
                                             const int2* e1, int c1,
                                             const float4* wc, float4& p0,
                                             float4& p1) {
  p0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  p1 = p0;
  const int n = max(c0, c1);
#pragma unroll 2
  for (int j = 0; j < n; ++j) {
    if (j < c0) fma_slot(p0, e0[j], wc);
    if (j < c1) fma_slot(p1, e1[j], wc);
  }
}

// A lane's 4 columns of one output row: float4 where N % 4 == 0 (then a
// lane's first column in range means all four are), else one by one.
__device__ __forceinline__ void store_cols(float* row, int j, int n,
                                           float4 p, int vec, bool stream) {
  if (j >= n) return;
  if (vec) {
    float4* d = reinterpret_cast<float4*>(row + j);
    if (stream) __stcs(d, p);
    else *d = p;
    return;
  }
  const float q[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (j + e < n) {
      if (stream) __stcs(row + j + e, q[e]);
      else row[j + e] = q[e];
    }
}

// Three roles, ordered by mbarriers only (no CTA barrier an item):
// - the producer warp copies item x's offsets into stage x % stages once
//   the consumers have released the item that held it, and its entries
//   once the offsets have landed (it alone waits for them);
// - the window warp turns window u % 2 to item u's B entries once its
//   entries have landed and the consumers have released item u - 2, then
//   marks it full;
// - each consumer warp waits for window u % 2, runs item u's rows, and
//   releases the window and the stage.
// So the window warp works on item u + 1 while the consumers run item u, and
// the consumer warps drift apart by up to an item.
__device__ __forceinline__ void add4(float4& a, float4 p) {
  a.x = __fadd_rn(a.x, p.x);
  a.y = __fadd_rn(a.y, p.y);
  a.z = __fadd_rn(a.z, p.z);
  a.w = __fadd_rn(a.w, p.w);
}

template <bool kStripes>
__global__ void __launch_bounds__(kRingThreads, 1)
ring_kernel(const __grid_constant__ Ring g) {
  extern __shared__ __align__(16) unsigned char sraw[];
  float* win = reinterpret_cast<float*>(sraw);     // [2][rounds][128]
  const RingCta<kStripes> cta(g, sraw);
  const int n_items = cta.n_items;
  if (n_items == 0) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int win_floats = g.rounds * kRingCols;
  for (int e = tid; e < 2 * win_floats / 4; e += kRingThreads)
    reinterpret_cast<float4*>(win)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid == 0) {
    for (int st = 0; st < 3 * g.stages; ++st)
      mbar_init(smem_u32(cta.bars + st),
                st < 2 * g.stages ? 1 : kRingWarps + 1);
    for (int b = 0; b < 2; ++b) {
      mbar_init(cta.win_full(b), 1);
      mbar_init(cta.win_empty(b), kRingWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      for (int x = 0; x < n_items; ++x) {
        if (x >= g.stages) mbar_wait(cta.empty_bar(x), cta.parity(x) ^ 1);
        cta.load_offsets(x);
        if (x >= 1) cta.load_entries(x - 1);
      }
      cta.load_entries(n_items - 1);
    }
    return;
  }

  if (warp == kWindowWarp) {
    const bool dups = *g.b.dups != 0;
    for (int u = 0; u < n_items; ++u) {
      float* w = win + (u & 1) * win_floats;
      if (u >= 2) {   // window u % 2 still holds item u - 2's B entries
        mbar_wait(cta.win_empty(u), ((u - 2) >> 1) & 1);
        View old;
        cta.view(u - 2, old);
        build_window<true, false>(w, lane, old);
        __syncwarp();
        if (lane == 0) mbar_arrive(cta.empty_bar(u - 2));
      }
      mbar_wait(cta.ent_bar(u), cta.parity(u));
      View v;
      cta.view(u, v);
      if (dups) build_window<false, true>(w, lane, v);
      else build_window<false, false>(w, lane, v);
      __syncwarp();
      if (lane == 0) mbar_arrive(cta.win_full(u));
    }
    return;
  }

  float4 acc[kMaxRowsPerWarp];
#pragma unroll
  for (int q = 0; q < kMaxRowsPerWarp; ++q)
    acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int u = 0; u < n_items; ++u) {
    mbar_wait(cta.win_full(u), (u >> 1) & 1);
    View v;
    cta.view(u, v);
    const float4* wc =
        reinterpret_cast<const float4*>(win + (u & 1) * win_floats) + lane;
    const int j = v.j0 + 4 * lane;
    const bool any_b = v.off_b[v.rows_b] > v.off_b[0];
    if (kStripes || any_b) {   // the fused kernel skips an empty B tile
      const int a0 = v.off_a[0];
#pragma unroll
      for (int q = 0; q < kMaxRowsPerWarp; q += 2) {
        if (q >= g.rows_per_warp) break;
        const int r0 = q * kRingWarps + warp, r1 = r0 + kRingWarps;
        const bool has0 = r0 < v.rows_a;
        const bool has1 = q + 1 < g.rows_per_warp && r1 < v.rows_a;
        float4 p0 = make_float4(0.f, 0.f, 0.f, 0.f), p1 = p0;
        if (has0 && any_b) {
          const int b0 = v.off_a[r0] - a0, e0 = v.off_a[r0 + 1] - a0;
          const int b1 = has1 ? v.off_a[r1] - a0 : 0;
          const int e1 = has1 ? v.off_a[r1 + 1] - a0 : 0;
          ring_partial(e0 <= v.sa_n ? v.sa + b0 : v.ga + b0, e0 - b0,
                       e1 <= v.sa_n ? v.sa + b1 : v.ga + b1, e1 - b1, wc, p0,
                       p1);
        }
        if (kStripes) {
          float* s0 = g.out + ((size_t)v.t * g.m + v.i0 + r0) * g.n;
          if (has0) store_cols(s0, j, g.n, p0, g.vec, true);
          if (has1)
            store_cols(s0 + (size_t)kRingWarps * g.n, j, g.n, p1, g.vec,
                       true);
        } else {
          add4(acc[q], p0);
          add4(acc[q + 1], p1);
        }
      }
    }
    __syncwarp();
    if (lane == 0) {                 // window u % 2 and stage u are free
      mbar_arrive(cta.win_empty(u));
      mbar_arrive(cta.empty_bar(u));
    }
    if (!kStripes && v.t == g.n_rounds - 1) {     // the tile's last round
#pragma unroll
      for (int q = 0; q < kMaxRowsPerWarp; ++q) {
        if (q >= g.rows_per_warp) break;
        const int r = q * kRingWarps + warp;
        if (r < v.rows_a)
          store_cols(g.out + (size_t)(v.i0 + r) * g.n, j, g.n, acc[q], g.vec,
                     false);
        acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
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

// The instances of match_geometry (index_match_spmm.INSTANCES).
enum Instance { GENERAL = 0, RING = 1 };

const void* kernel_of(int stripes, int instance) {
  if (instance == RING)
    return stripes ? (const void*)ring_kernel<true>
                   : (const void*)ring_kernel<false>;
  return stripes ? (const void*)match_kernel<true>
                 : (const void*)match_kernel<false>;
}

template <bool kStripes>
int launch_ring(const Ring& g, int grid, size_t smem, cudaStream_t stream) {
  int err = launch_pack(g.a, g.b, g.n_rounds, g.rounds, stream);
  if (err) return err;
  err = set_smem((const void*)ring_kernel<kStripes>, smem);
  if (err) return err;
  ring_kernel<kStripes><<<grid, kRingThreads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes. Each function launches on `stream`,
// does not synchronise, and returns the cudaError_t of the launch (0 = ok).
// The caller computes the launch (index_match_spmm.match_geometry).
extern "C" {

const char* index_match_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// CTAs of one instance that one SM holds at `smem` bytes of dynamic
// shared memory, from the occupancy calculator.
int index_match_ctas_per_sm(int stripes, int instance, size_t smem,
                            int* ctas) {
  const void* fn = kernel_of(stripes, instance);
  int err = set_smem(fn, smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, fn, instance == RING ? kRingThreads : kThreads, smem);
}

// C (stripes = 0) or S (stripes = 1) from A (ai, av) and B (bi, bv).
// GENERAL: match_kernel; the ring arguments are not read. RING:
// the pre-pass packs A into (ent_a, off_a) and B into (ent_b, off_b)
// (n_rounds * rows * rmax int2 and n_rounds * (rows + 1) ints, each 16
// bytes more, on 16 bytes), then ring_kernel runs on `grid` CTAs with
// rows_per_warp * 16 rows a tile, `stages` stages of `cap` entry bytes,
// `smem` bytes of shared memory and, for condense, `chunk` items a CTA.
int index_match_launch(int stripes, int instance, const int* ai,
                       const float* av, const int* bi, const float* bv,
                       float* out, int m, int n, int n_rounds, int rmax_a,
                       int rmax_b, int rounds, void* ent_a, int* off_a,
                       void* ent_b, int* off_b, int rows_per_warp,
                       int stages, int cap, int grid, long long chunk,
                       size_t smem, int device, void* stream) {
  if (instance == GENERAL)
    return stripes ? launch_match<true>(ai, av, bi, bv, out, m, n, n_rounds,
                                        rmax_a, rmax_b, rounds, device,
                                        stream)
                   : launch_match<false>(ai, av, bi, bv, out, m, n, n_rounds,
                                         rmax_a, rmax_b, rounds, device,
                                         stream);
  if (instance != RING) return cudaErrorInvalidValue;
  const int tile_m = kRingWarps * rows_per_warp;
  const long long row_tiles = (m + tile_m - 1) / tile_m;
  const long long col_tiles = (n + kRingCols - 1) / kRingCols;
  const long long items = row_tiles * col_tiles * n_rounds;
  if (rows_per_warp < 1 || rows_per_warp > kMaxRowsPerWarp || stages < 4 ||
      cap < 16 || cap % 16 || m < 1 || n < 1 || n_rounds < 1 ||
      rounds > kRingMaxRounds || m >= (1 << 23) || n >= (1 << 23) ||
      n_rounds > 65535 ||
      (long long)m * rmax_a >= (1LL << 31) ||
      (long long)n * rmax_b >= (1LL << 31) || grid < 1 ||
      row_tiles * col_tiles >= (1LL << 31) ||
      smem < ring_smem_bytes(rounds, tile_m, stages, cap) ||
      (stripes ? chunk < 1 || chunk >= (1LL << 31) || chunk * grid < items
               : grid > row_tiles * col_tiles ||
                     (row_tiles * col_tiles + grid - 1) / grid * n_rounds >=
                         (1LL << 31)) ||
      ((uintptr_t)ent_a | (uintptr_t)off_a | (uintptr_t)ent_b |
       (uintptr_t)off_b) & 15)
    return cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  Ring g;
  // B's repeat flag: the last of the 4 ints past its offsets, beyond what
  // a rounded-up copy of them reads.
  int* dups = off_b + (size_t)n_rounds * (n + 1) + 3;
  g.a = Side{ai, av, reinterpret_cast<int2*>(ent_a), off_a, nullptr, m,
             rmax_a};
  g.b = Side{bi, bv, reinterpret_cast<int2*>(ent_b), off_b, dups, n, rmax_b};
  g.out = out;
  g.m = m;
  g.n = n;
  g.n_rounds = n_rounds;
  g.rounds = rounds;
  g.rows_per_warp = rows_per_warp;
  g.stages = stages;
  g.cap = cap;
  g.col_tiles = (int)col_tiles;
  g.tiles = (int)(row_tiles * col_tiles);
  g.chunk = stripes ? chunk : 0;
  g.vec = n % 4 == 0 && ((uintptr_t)out & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return stripes ? launch_ring<true>(g, grid, smem, st)
                 : launch_ring<false>(g, grid, smem, st);
}

// The packing pre-pass alone: the ring instance's packed copies of A and
// B (index_match_launch's layout), for timing and checking it.
int index_match_pack(const int* ai, const float* av, const int* bi,
                     const float* bv, int m, int n, int n_rounds, int rmax_a,
                     int rmax_b, int rounds, void* ent_a, int* off_a,
                     void* ent_b, int* off_b, int device, void* stream) {
  if (m < 1 || n < 1 || n_rounds < 1 || n_rounds > 65535 ||
      rounds > kRingMaxRounds || m >= (1 << 23) || n >= (1 << 23))
    return cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  int* dups = off_b + (size_t)n_rounds * (n + 1) + 3;
  return launch_pack(
      Side{ai, av, reinterpret_cast<int2*>(ent_a), off_a, nullptr, m, rmax_a},
      Side{bi, bv, reinterpret_cast<int2*>(ent_b), off_b, dups, n, rmax_b},
      n_rounds, rounds, (cudaStream_t)stream);
}

// CTAs of a merge instance that one SM holds at `smem` bytes of dynamic
// shared memory, from the occupancy calculator.
int spgemm_merge_ctas_per_sm(int instance, size_t smem, int* ctas) {
  const void* fn = instance == RING ? (const void*)merge_ring_kernel
                                    : (const void*)merge_kernel;
  int err = set_smem(fn, smem);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, fn, instance == RING ? kMergeRingThreads : kMergeThreads, smem);
}

// C (the plane, `plane` floats) = the sum over t ascending of S[t].
// GENERAL: merge_kernel (chunk, stages, grid and smem are not read). RING:
// merge_ring_kernel on `grid` CTAs, items of `chunk` floats through
// `stages` stages, `smem` bytes of shared memory.
int spgemm_merge(int instance, const float* s, float* c, long long plane,
                 int n_rounds, int chunk, int stages, int grid, size_t smem,
                 int device, void* stream) {
  if (plane < 1 || n_rounds < 0) return cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  cudaStream_t st = (cudaStream_t)stream;
  if (instance == GENERAL) {
    const long long groups = (plane + 3) / 4;
    long long blocks = (groups + kMergeThreads - 1) / kMergeThreads;
    if (blocks > 132LL * 64) blocks = 132LL * 64;   // grid-stride beyond
    const int vec = (plane % 4 == 0 && ((uintptr_t)s & 15) == 0 &&
                     ((uintptr_t)c & 15) == 0);
    merge_kernel<<<(unsigned)blocks, kMergeThreads, 0, st>>>(
        s, c, plane, n_rounds, vec);
    return (int)cudaGetLastError();
  }
  if (instance != RING || n_rounds < 1 || plane % 4 || chunk < 4 ||
      chunk % 4 || chunk > kMergeMaxChunk || stages < 1 ||
      ((uintptr_t)s & 15) || ((uintptr_t)c & 15) ||
      smem < (size_t)stages * (chunk * 4 + 16))
    return cudaErrorInvalidValue;
  const long long items = (plane + chunk - 1) / chunk;
  if (grid < 1 || grid > items) return cudaErrorInvalidValue;
  err = set_smem((const void*)merge_ring_kernel, smem);
  if (err) return err;
  merge_ring_kernel<<<grid, kMergeRingThreads, smem, st>>>(
      s, c, plane, n_rounds, chunk, stages, items);
  return (int)cudaGetLastError();
}

}  // extern "C"
