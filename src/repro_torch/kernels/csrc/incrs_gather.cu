// InCRS section stripes -> dense rows on Hopper (sm_90a).
//
// Replaces the Pallas kernel _kernel of incrs_gather (src/repro/kernels/
// incrs_gather.py:28/:40), the densify step of the two-pass baseline and of
// the `densify` SpGEMM engine.
//
// Inputs: idx int32 / val f32 section stripes (M, n_sec, smax), the local
// column of each non-zero inside its section, -1 (or any index outside
// [0, section)) = pad, in any slot. Output: f32 (M, n_sec * section),
// out[r, s * section + idx] = the sum of the values of the live slots of
// stripe (r, s) that carry idx, from 0, in slot order; 0 elsewhere.
//
// The TPU kernel one-hot expands each (rows, smax) stripe into a dense
// (rows, section) slab, because the VPU/MXU want dense tiles. Here each
// live slot is one shared-memory add. Two designs, chosen by the wrapper
// (incrs_gather.gather_geometry):
//
// tile (tile_kernel): a persistent grid of at most one wave walks items;
//   an item is `sections` consecutive sections of one row, and each warp
//   owns one item at a time (items it, it + all warps, ...: at any moment
//   the warps of the card work on one contiguous stretch of the stripes
//   and of the output). The warp reads the item's slots coalesced, up to
//   512 in flight (16 a lane, then the values of the live ones),
//   builds the item's (1, sections * section) tile in its own shared
//   memory (zeroed while the slots are in flight), and writes it to
//   global memory once, float4 __stcs (scalar where the width or the
//   output is not 16-byte aligned). No global atomics, no read-back of the
//   output, no CTA barrier. The tile is not double buffered: it leaves
//   through registers, so it is free again as soon as its shared-memory
//   reads return, and the next item's loads overlap its stores anyway.
//   Repeated indices: the lanes of a 32-slot chunk that hit one output
//   element find each other (__match_any_sync) and add in lane order, one
//   rank a step; chunks run in order. So every element is the sum of its
//   values in slot order from 0, the CPU scatter-add's order, bit for bit.
// general (gather_kernel): the first design. A block owns one output row:
//   it zeroes the row (float4 stores where the width allows), then adds
//   its live slots onto the zeros with global atomics, in no fixed order
//   (bitwise equal to the plain version where no index repeats in a
//   stripe, which ops.prep_sections guarantees).
//
// Adding onto 0 gives the value itself (a -0 becomes +0, as in the one-hot
// sum).
//
// What bounds it on the H100: bytes. It reads the idx stripes in full (pads
// are read to be skipped), the live values, and writes the dense matrix
// once: at mesh-docword4 (1504, 47, 77) 97 MB, about 0.029 ms. The tile
// design moves just that; the first design wrote its rows twice through L2
// (zeros, then atomics) in 1.42 waves of one block a row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;          // general: one block a row

constexpr int kTileWarps = 8;          // tile: one item a warp
constexpr int kTileThreads = kTileWarps * 32;
constexpr int kTileMinCtas = 4;        // CTAs an SM (64 registers a thread)
constexpr int kBatchChunks = 16;       // 32-slot chunks whose loads are
constexpr int kBatch = kBatchChunks * 32;   // in flight at once

__global__ void __launch_bounds__(kThreads)
gather_kernel(const int* __restrict__ idx, const float* __restrict__ val,
              float* __restrict__ out, int n_sec, int smax, int section,
              int vec) {
  const size_t row = blockIdx.x;
  const long long width = (long long)n_sec * section;
  float* orow = out + row * width;
  if (vec) {
    float4* o4 = reinterpret_cast<float4*>(orow);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (long long e = threadIdx.x; e < width / 4; e += kThreads) o4[e] = zero;
  } else {
    for (long long e = threadIdx.x; e < width; e += kThreads) orow[e] = 0.0f;
  }
  __syncthreads();                       // the zeros land before the adds
  const int slots = n_sec * smax;
  const size_t base = row * slots;
  for (int q = threadIdx.x; q < slots; q += kThreads) {
    const int k = idx[base + q];
    if (k >= 0 && k < section) {
      atomicAdd(orow + (size_t)(q / smax) * section + k, val[base + q]);
    }
  }
}

// j / d for 0 <= j < 2**31 by one multiply-high (Granlund-Montgomery):
// shift = ceil(log2 d), magic = floor(2**32 * (2**shift - d) / d) + 1.
struct FastDiv {
  unsigned magic;
  int shift;
};

FastDiv fast_div(int d) {
  int shift = 0;
  while ((1ll << shift) < d) ++shift;
  const unsigned long long m =
      ((1ull << 32) * ((1ull << shift) - (unsigned long long)d)) / d + 1;
  return FastDiv{(unsigned)m, shift};
}

__device__ __forceinline__ int div_by(int j, FastDiv f) {
  return (int)((__umulhi((unsigned)j, f.magic) + (unsigned)j) >> f.shift);
}

// Adds the 32 slots of one chunk (value v at tile position pos, live or
// not) into the warp's tile, lanes that share a position in lane order.
__device__ __forceinline__ void add_chunk(float* tile, bool live, int pos,
                                          float v, int lane) {
  const int key = live ? pos : -1 - lane;   // a dead lane matches no one
  const unsigned peers = __match_any_sync(kFull, key);
  const int rank = __popc(peers & ((1u << lane) - 1));
  const int top = __reduce_max_sync(kFull, (unsigned)rank);
  for (int r = 0; r <= top; ++r) {
    if (live && rank == r) tile[pos] = __fadd_rn(tile[pos], v);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kTileThreads, kTileMinCtas)
tile_kernel(const int* __restrict__ idx, const float* __restrict__ val,
            float* __restrict__ out, int m, int n_sec, int smax, int section,
            int sections, FastDiv by_smax, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile_floats = (sections * section + 3) & ~3;
  float* tile = smem + (size_t)warp * tile_floats;
  const int groups = (n_sec + sections - 1) / sections;
  const long long items = (long long)m * groups;
  const long long width = (long long)n_sec * section;
  const long long step = (long long)gridDim.x * kTileWarps;
  for (long long it = (long long)blockIdx.x * kTileWarps + warp; it < items;
       it += step) {
    const long long row = it / groups;
    const int s0 = (int)(it - row * groups) * sections;
    const int ns = min(sections, n_sec - s0);
    const int slots = ns * smax;
    const int len = ns * section;
    const size_t base = ((size_t)row * n_sec + s0) * smax;
    for (int b0 = 0; b0 < slots; b0 += kBatch) {
      int k[kBatchChunks];
#pragma unroll
      for (int c = 0; c < kBatchChunks; ++c) {
        const int j = b0 + c * 32 + lane;
        k[c] = j < slots ? __ldcs(idx + base + j) : -1;
      }
      if (b0 == 0) {                 // zeros while the slots are in flight
        float4* t4 = reinterpret_cast<float4*>(tile);
        for (int e = lane; e < (len + 3) / 4; e += 32)
          t4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      float v[kBatchChunks];
#pragma unroll
      for (int c = 0; c < kBatchChunks; ++c) {
        const bool live = k[c] >= 0 && k[c] < section;
        v[c] = live ? __ldcs(val + base + b0 + c * 32 + lane) : 0.f;
      }
      __syncwarp();                  // the zeros land before the adds
#pragma unroll
      for (int c = 0; c < kBatchChunks; ++c) {
        if (b0 + c * 32 >= slots) break;
        const int j = b0 + c * 32 + lane;
        const bool live = k[c] >= 0 && k[c] < section;
        if (__ballot_sync(kFull, live) == 0) continue;
        add_chunk(tile, live, div_by(j, by_smax) * section + k[c], v[c],
                  lane);
      }
    }
    __syncwarp();                    // every add lands before the reads
    float* o = out + row * width + (long long)s0 * section;
    if (vec) {
      const float4* t4 = reinterpret_cast<const float4*>(tile);
      float4* o4 = reinterpret_cast<float4*>(o);
      for (int e = lane; e < len / 4; e += 32) __stcs(o4 + e, t4[e]);
    } else {
      for (int e = lane; e < len; e += 32) __stcs(o + e, tile[e]);
    }
    __syncwarp();                    // the reads return before new zeros
  }
}

// The instances of gather_geometry (incrs_gather.INSTANCES).
enum Instance { GENERAL = 0, TILE = 1 };

// All of an SM's shared memory for the kernel's CTAs: gather_geometry
// counts the CTAs an SM holds from it (incrs_gather.tile_ctas).
int set_smem(const void* fn, size_t bytes) {
  int err = (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err || bytes <= 48 * 1024) return err;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes. Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launch (0 = ok). The caller
// computes the launch (incrs_gather.gather_geometry).
extern "C" {

const char* incrs_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// CTAs of tile_kernel that one SM holds at `smem` bytes of dynamic shared
// memory, from the occupancy calculator (GENERAL: gather_kernel, none).
int incrs_gather_ctas_per_sm(int instance, size_t smem, int* ctas) {
  const void* fn = instance == TILE ? (const void*)tile_kernel
                                    : (const void*)gather_kernel;
  int err = instance == TILE ? set_smem(fn, smem) : 0;
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, fn, instance == TILE ? kTileThreads : kThreads, smem);
}

// GENERAL: gather_kernel, one block a row (sections, grid and smem are not
// read). TILE: tile_kernel on `grid` CTAs of 8 warps, an item `sections`
// sections of one row, `smem` bytes of shared memory (8 tiles of
// sections * section floats, each rounded up to 4).
int incrs_gather_launch(int instance, const int* idx, const float* val,
                        float* out, int m, int n_sec, int smax, int section,
                        int sections, int grid, size_t smem, int device,
                        void* stream) {
  if (m < 1 || n_sec < 1 || smax < 0 || section < 1 ||
      (long long)n_sec * smax >= (1ll << 31))
    return cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const long long width = (long long)n_sec * section;
  const bool aligned = width % 4 == 0 && ((uintptr_t)out & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (instance == GENERAL) {
    gather_kernel<<<m, kThreads, 0, st>>>(idx, val, out, n_sec, smax,
                                          section, aligned);
    return (int)cudaGetLastError();
  }
  if (instance != TILE || smax < 1 || sections < 1 || sections > n_sec ||
      grid < 1 ||
      (long long)sections * section >= (1ll << 28) ||
      smem < (size_t)kTileWarps * (((size_t)sections * section + 3) & ~3ull) *
                 sizeof(float))
    return cudaErrorInvalidValue;
  err = set_smem((const void*)tile_kernel, smem);
  if (err) return err;
  const int vec = aligned && (sections * section) % 4 == 0;
  tile_kernel<<<grid, kTileThreads, smem, st>>>(
      idx, val, out, m, n_sec, smax, section, sections, fast_div(smax), vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
