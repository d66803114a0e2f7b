// Causal grouped-query flash attention on Hopper (sm_90a): a bf16 kernel
// on the tensor cores and an f32 kernel in f32 FMA, chosen by the type.
//
// Replaces the Pallas kernel _kernel of flash_attention (src/repro/kernels/
// flash_attention.py:38/:94), which ops.flash_mha (src/repro/kernels/
// ops.py:806) reaches, and the jnp _flash_attention that the LM's prefill
// runs for prompts of FLASH_THRESHOLD tokens or more (src/repro/models/
// layers.py:143/:287).
//
// What both compute, for each query lane (b, kv head, group member g),
// query row r < Sq at position i = r + q_off and head dim d: logit[i, j] =
// q[r] . k[j] / sqrt(hd); with a soft cap, cap * tanh(logit / cap); only
// keys j <= i, j < Sk and, with a window, j > i - window count; an online
// softmax in f32 (running max m, denominator l, accumulator acc); out = acc
// / max(l, 1e-30), cast to the input type. The G query heads of one KV head
// read the same K and V rows (GQA, MQA at KV = 1); nothing is repeated in
// memory.
//
// Inputs in the JAX layout, read through strides: q and out
// (B, Sq, KV, G, hd), k and v (B, Sk, KV, hd), each with the head dim
// contiguous. The Pallas wrapper transposes q, k and v into lanes and pads
// Sq and Sk to its tiles; here the ragged tiles are masked, so the caller
// copies nothing. Both kernels run one CTA per (query lane, query tile),
// the tiles of the heaviest (last) queries first, since causal work grows
// with the position and short tiles then fill the tail; each walks the
// 64-key tiles from the first one its window reaches to the diagonal, and
// key tiles wholly masked are never loaded. The query offset q_off (a span
// of a longer sequence: sequence-parallel attention over a mesh, whose
// coordinate c holds rows [c S / m, (c + 1) S / m) and keys from 0) adds
// q_off keys to every row, so a later tile still holds at least as many
// keys as an earlier one and the order stays the heaviest first.
//
// What bounds it on the H100: operations. At granite-34b's prefill wave
// (B = 2, S = 8192, KV = 1, G = 48, hd = 128) the causal pairs need 1.649
// TFLOP against 411 MB: 1.668 ms at the bf16 tensor-core rate (989
// TFLOP/s), 0.12 ms of bytes. Only the tensor cores come near that.
//
// bf16 (flash_kernel_bf16<HDP>, HDP = hd rounded up to 64): a CTA of two
// warpgroups owns 128 query rows, 64 each, and both share every K/V tile.
// - Tiles stay bf16 in shared memory, each as HDP/64 regions of 64 rows x
//   64 columns (8 KB) in the 128-byte swizzle that TMA writes and wgmma
//   reads without bank conflicts. Columns past hd and rows past Sq or Sk
//   are zeros of TMA's out-of-bounds fill: nothing is padded in memory.
// - TMA brings the tiles. The host encodes one tensor map per operand over
//   its strided layout (q 5-D, k and v 4-D), so a tile is one request per
//   region, and GQA is a coordinate. Q arrives once; K and V go through a
//   ring of two stages, each with its mbarrier: tile j+1 is in flight while
//   tile j is computed, and the stage of tile j is refilled with tile j+2
//   once both warpgroups are done with it (one barrier per key tile).
// - S = Q.K^T is wgmma m64n64k16 with both operands from shared memory by
//   descriptor (K-major), f32 accumulators in registers.
// - Softmax in registers, in log2 units: scale * log2(e) folds into the
//   FMA that feeds ex2 (ex2.approx); masks only on the tiles that cross the
//   diagonal, the window edge or Sk (-inf, which the max ignores); the row
//   max reduced over the four threads of a row, the row sum only at the
//   end; acc rescaled only when the max of a row of the warp moved, which
//   after the first tiles it seldom does.
// - O += P.V is wgmma m64n64k16 per 64 output columns with A = P from
//   registers: the S accumulator's layout is the A fragment's, so P is
//   rounded to bf16 and packed in place and never goes back to shared
//   memory; V is read MN-major (transposed B) from its tile as TMA wrote
//   it. acc (HDP / 2 floats a thread: 128 at hd 256), m and l stay in f32
//   registers; one cast at the store.
// - Shared memory (the wrapper sizes it: flash_attention.smem_bytes):
//   (2 + 2 * 2) * HDP * 128 bytes + 1,024 for alignment + 24 for the
//   barriers: 50,200 at hd 64, 99,352 at hd 128 (two CTAs, four
//   warpgroups an SM, at most 128 registers a thread), 197,656 at hd 256.
// Not yet done: a producer warp with setmaxnreg, ping-pong between the
// warpgroups, and overlapping the softmax of one tile with the products of
// the next (FlashAttention-3's schedule).
//
// f32 (flash_kernel_f32<NJ>, NJ = ceil(hd / 64)): the port holds f32 to
// IEEE f32, so no TF32. A CTA of 256 threads owns 64 query rows and stages
// Q, K (transposed) and V in shared memory as f32; each thread computes a
// 4 x 4 block of scores by f32 FMA; P goes back to shared memory (over the
// K tile) for P . V. Shared memory ((hd + max(hd, 64)) * 68 + 64 * NJ * 64)
// * 4 bytes: 102,400 at hd 128, 204,800 at hd 256. f32 FMA outside the
// tensor cores: 67 TFLOP/s at most, 24.6 ms at the granite wave.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"   // mbarriers, TMA, wgmma helpers, kTensorMapError

namespace {

constexpr int kBk = 64;             // key tile of both kernels
constexpr float kNegInf = -1e30f;   // the Pallas kernel's NEG_INF

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sk, q_sg;  // strides in elements; hd stride is 1
  long long k_sb, k_ss, k_sk;
  long long v_sb, v_ss, v_sk;
  long long o_sb, o_ss, o_sk, o_sg;
  int kv, g, sq, sk, hd, lanes, n_qt;
  int q_off;  // the position of query row 0
  int has_window, window;
  float scale, soft_cap;  // soft_cap 0: no cap
};

// The CTA's query lane and tile (heaviest first) and its key-tile range.
struct Work {
  int b, kvh, gi, q0, kt_lo, kt_hi;
};

template <int BQ>  // the query tile
__device__ __forceinline__ Work work_of(const Params& p) {
  Work w;
  const int qt = p.n_qt - 1 - (int)(blockIdx.x / p.lanes);
  const int lane = (int)(blockIdx.x % p.lanes);
  w.b = lane / (p.kv * p.g);
  w.kvh = (lane / p.g) % p.kv;
  w.gi = lane % p.g;
  w.q0 = qt * BQ;
  // Key tiles holding at least one valid key for some row of this tile.
  const long long q_last = (long long)min(w.q0 + BQ - 1, p.sq - 1) + p.q_off;
  const int key_hi = (int)min(q_last, (long long)p.sk - 1);
  long long key_lo = 0;
  if (p.has_window)
    key_lo = max(0LL, (long long)w.q0 + p.q_off - p.window + 1);
  w.kt_lo = (int)(key_lo / kBk);
  w.kt_hi = key_hi < 0 ? -1 : key_hi / kBk;
  return w;
}

// ===========================================================================
// f32: f32 FMA from shared memory.
constexpr int kF32Threads = 256;
constexpr int kBq = 64;             // query tile
constexpr int kLd = kBq + 4;        // row stride of the transposed tiles

template <int NJ>
__global__ void __launch_bounds__(kF32Threads)
flash_kernel_f32(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kVs = NJ * 64;       // row stride of the V tile
  const int hd = p.hd;
  float* qs = smem;                  // [hd][kLd]: Q tile, transposed
  float* ks = qs + hd * kLd;         // [hd][kLd]: K tile, transposed
  float* ps = ks;                    // [kBk][kLd]: P tile, over K's
  float* vs = ks + max(hd, kBk) * kLd;  // [kBk][kVs]: V tile

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const Work w = work_of<kBq>(p);
  const int q0 = w.q0;
  const float* q = static_cast<const float*>(p.q) + w.b * p.q_sb +
                   w.kvh * p.q_sk + w.gi * p.q_sg;
  const float* kp = static_cast<const float*>(p.k) + w.b * p.k_sb +
                    w.kvh * p.k_sk;
  const float* vp = static_cast<const float*>(p.v) + w.b * p.v_sb +
                    w.kvh * p.v_sk;
  float* o = static_cast<float*>(p.o) + w.b * p.o_sb + w.kvh * p.o_sk +
             w.gi * p.o_sg;

  for (int idx = tid; idx < kBq * hd; idx += kF32Threads) {
    const int r = idx / hd, d = idx - r * hd;
    const int i = q0 + r;
    qs[d * kLd + r] = i < p.sq ? q[(long long)i * p.q_ss + d] : 0.0f;
  }

  float m_i[4], l_i[4], acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.0f;
#pragma unroll
    for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][jn][e] = 0.0f;
  }

  for (int kt = w.kt_lo; kt <= w.kt_hi; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();  // the previous tile's P . V is done with ps and vs
    for (int idx = tid; idx < kBk * hd; idx += kF32Threads) {
      const int r = idx / hd, d = idx - r * hd;
      const int j = k0 + r;
      const bool in = j < p.sk;
      ks[d * kLd + r] = in ? kp[(long long)j * p.k_ss + d] : 0.0f;
      vs[r * kVs + d] = in ? vp[(long long)j * p.v_ss + d] : 0.0f;
    }
    __syncthreads();

    // Scores of rows ty*4 + i, keys tx*4 + c.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[d * kLd + ty * 4]);
      const float4 bk =
          *reinterpret_cast<const float4*>(&ks[d * kLd + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = __fmaf_rn(av[i], bv[c], s[i][c]);
    }

    // Cap, mask, online softmax; rows are shared by the 16 threads tx.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long pos = (long long)(q0 + ty * 4 + i) + p.q_off;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx * 4 + c;
        float x = s[i][c] * p.scale;
        if (p.soft_cap != 0.0f) x = p.soft_cap * tanhf(x / p.soft_cap);
        valid[c] = col <= pos && col < p.sk &&
                   (!p.has_window || (long long)col > pos - p.window);
        s[i][c] = valid[c] ? x : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = valid[c] ? expf(s[i][c] - m_new) : 0.0f;
        sum += s[i][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_i[i] = l_i[i] * corr + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jn][e] *= corr;
    }

    __syncthreads();  // every thread is done reading ks
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&ps[(tx * 4 + c) * kLd + ty * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // acc[rows ty*4 + i][cols tx*4 + 64*jn + e] += P . V
    const int kc = min(kBk, p.sk - k0);
    for (int kk = 0; kk < kc; ++kk) {
      const float4 pp = *reinterpret_cast<const float4*>(&ps[kk * kLd + ty * 4]);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn) {
        const int c = tx * 4 + 64 * jn;
        if (c < hd) {
          const float4 vv = *reinterpret_cast<const float4*>(&vs[kk * kVs + c]);
          const float vv4[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][jn][e] = __fmaf_rn(pv[i], vv4[e], acc[i][jn][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.sq) continue;
    const float den = fmaxf(l_i[i], 1e-30f);
    float* orow = o + (long long)row * p.o_ss;
#pragma unroll
    for (int jn = 0; jn < NJ; ++jn) {
      const int c = tx * 4 + 64 * jn;
      if (c < hd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) orow[c + e] = acc[i][jn][e] / den;
      }
    }
  }
}

// ===========================================================================
// bf16: wgmma on the tensor cores, K/V through a TMA ring.
constexpr int kWgs = 2;                    // consumer warpgroups
constexpr int kBf16Threads = 128 * kWgs;
constexpr int kBqWg = 64;                  // query rows of one warpgroup
constexpr int kBqBf16 = kBqWg * kWgs;      // query tile
constexpr int kStages = 2;                 // K/V ring
constexpr int kRegion = 64 * 64 * 2;       // 64 rows x 64 bf16, 128B swizzle
constexpr int kAlign = 1024;               // the swizzle atom

__host__ __device__ constexpr int tile_bytes(int hdp) { return hdp * 128; }

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B from shared memory,
// both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A from registers, B from shared
// memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator layout of wgmma m64nN (f32): thread t of the warpgroup
// holds rows r0 = 16 * (t / 32) + (t % 32) / 4 and r0 + 8; element
// 4 * i + 2 * h + e is (row r0 + 8 h, column 8 i + 2 (t % 4) + e).
template <int HDP>
__global__ void __launch_bounds__(kBf16Threads, HDP <= 128 ? 2 : 1)
flash_kernel_bf16(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
  constexpr int kTile = tile_bytes(HDP);
  constexpr int kR = HDP / 64;             // 64-column regions of a tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  // Q of warpgroup w at base + kTile * w; stage s: K at kv0 + 2 s kTile,
  // V at kv0 + (2 s + 1) kTile.
  const uint32_t kv0 = base + kWgs * kTile;
  const uint32_t bar_q = kv0 + 2 * kStages * kTile;
  const uint32_t bar_kv = bar_q + 8;       // + 8 s

  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32 % 4;
  const int lane = tid % 32;
  const Work w = work_of<kBqBf16>(p);
  const int n_kt = w.kt_hi - w.kt_lo + 1;
  const int wq0 = w.q0 + kBqWg * wg;       // this warpgroup's first row
  const long long wp0 = (long long)wq0 + p.q_off;  // and its position
  const uint32_t sq_ = base + kTile * wg;  // and its Q tile

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(bar_kv + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto load_kv = [&](int j) {  // key tile kt_lo + j into stage j % 2
    const int st = j % kStages;
    const uint32_t bar = bar_kv + 8 * st;
    const uint32_t dk = kv0 + 2 * st * kTile;
    mbar_expect_tx(bar, 2 * kTile);
    const int k0 = (w.kt_lo + j) * kBk;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      tma_load_4d(dk + r * kRegion, &tk, 64 * r, k0, w.kvh, w.b, bar);
      tma_load_4d(dk + kTile + r * kRegion, &tv, 64 * r, k0, w.kvh, w.b, bar);
    }
  };
  if (tid == 0 && n_kt > 0) {
    mbar_expect_tx(bar_q, kWgs * kTile);
#pragma unroll
    for (int h = 0; h < kWgs; ++h)
#pragma unroll
      for (int r = 0; r < kR; ++r)
        tma_load_5d(base + h * kTile + r * kRegion, &tq, 64 * r,
                    w.q0 + kBqWg * h, w.gi, w.kvh, w.b, bar_q);
    for (int j = 0; j < kStages && j < n_kt; ++j) load_kv(j);
  }

  const int quad = lane % 4;
  const int r0 = wq0 + 16 * warp + lane / 4;   // rows r0 and r0 + 8
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.0f, 0.0f};
  float o[kR][32];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[r][i] = 0.0f;
  const float log2e = 1.4426950408889634f;
  const float scale_log2 = p.scale * log2e;

  if (n_kt > 0) mbar_wait(bar_q, 0);
  for (int j = 0; j < n_kt; ++j) {
    const int st = j % kStages;
    const uint32_t dk = kv0 + 2 * st * kTile;
    const uint32_t dv = dk + kTile;
    const int k0 = (w.kt_lo + j) * kBk;
    mbar_wait(bar_kv + 8 * st, (j / kStages) & 1);
    // A key tile that no row of this warpgroup sees (past its diagonal,
    // before its window, or rows all past Sq) changes nothing: skip it.
    const bool seen = k0 <= wp0 + kBqWg - 1 && wq0 < p.sq &&
                      (!p.has_window ||
                       (long long)k0 + kBk - 1 > wp0 - p.window);
    if (seen) {
      // S = Q . K^T over HDP / 16 steps (columns past hd are zeros).
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < HDP / 16; ++t) {
        const uint32_t off = (t / 4) * kRegion + (t % 4) * 32;
        wgmma_ss(s, make_desc(sq_ + off, 16, 1024),
                 make_desc(dk + off, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // Online softmax in log2 units: with a cap, the capped logit times
      // log2(e) first; else the scale folds into the exponent's FMA. Masked
      // scores (only on the tiles that cross the diagonal, the window edge or
      // Sk) become -inf, which the max ignores and ex2 sends to 0.
      float c = scale_log2;
      if (p.soft_cap != 0.0f) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          s[i] = p.soft_cap * tanhf(s[i] * p.scale / p.soft_cap) * log2e;
        c = 1.0f;
      }
      const bool edge =
          k0 + kBk - 1 > wp0 || k0 + kBk > p.sk ||
          (p.has_window && (long long)k0 <= wp0 + kBqWg - 1 - p.window);
      if (edge) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const long long pos = (long long)(r0 + 8 * h) + p.q_off;
              const int col = k0 + 8 * i + 2 * quad + e;
              const bool valid = col <= pos && col < p.sk &&
                                 (!p.has_window ||
                                  (long long)col > pos - p.window);
              if (!valid) s[4 * i + 2 * h + e] = -INFINITY;
            }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mx[h] = fmaxf(mx[h],
                        fmaxf(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]));
      float corr[2], neg_m[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_i[h], mx[h] * c);
        corr[h] = ex2(m_i[h] - m_new);
        m_i[h] = m_new;
        neg_m[h] = -m_new;
      }
      float rsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = ex2(fmaf(s[4 * i + 2 * h + e], c, neg_m[h]));
            s[4 * i + 2 * h + e] = pe;
            rsum[h] += pe;
          }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_i[h] = l_i[h] * corr[h] + rsum[h];
      // The max of most rows stops moving after the first tiles: rescale acc
      // only where some row of the warp moved.
      if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f)) {
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              o[r][4 * i + 2 * h] *= corr[h];
              o[r][4 * i + 2 * h + 1] *= corr[h];
            }
      }

      // P as the A fragments of the four 16-key steps, bf16, in registers.
      uint32_t a[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        a[t][0] = pack_bf16(s[8 * t + 0], s[8 * t + 1]);
        a[t][1] = pack_bf16(s[8 * t + 2], s[8 * t + 3]);
        a[t][2] = pack_bf16(s[8 * t + 4], s[8 * t + 5]);
        a[t][3] = pack_bf16(s[8 * t + 6], s[8 * t + 7]);
      }

      // O += P . V: per 64 output columns, four 16-key steps; V's tile read
      // MN-major (LBO: the next 64 columns, SBO: the next 8 keys).
#pragma unroll
      for (int r = 0; r < kR; ++r) fence_regs(o[r]);
      wgmma_fence();
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          wgmma_rs(o[r], a[t], make_desc(dv + r * kRegion + t * 2048, kRegion,
                                         1024));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int r = 0; r < kR; ++r) fence_regs(o[r]);
    }
    // Every warp is done with this stage: refill it with tile j + 2.
    __syncthreads();
    if (tid == 0 && j + kStages < n_kt) load_kv(j + kStages);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + w.b * p.o_sb +
                       w.kvh * p.o_sk + w.gi * p.o_sg;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_i[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    const int row = r0 + 8 * h;
    if (row >= p.sq) continue;
    __nv_bfloat16* orow = out + (long long)row * p.o_ss;
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 64 * r + 8 * i + 2 * quad;
        if (c < p.hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
              o[r][4 * i + 2 * h] * inv, o[r][4 * i + 2 * h + 1] * inv);
      }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// A tiled tensor map over a bf16 operand whose dims (innermost first) are
// hd and then the strided ones; boxes of 64 (hd) x 64 (rows) x 1 ...
int encode(CUtensorMap* map, const void* base, int rank,
           const unsigned long long* dims, const long long* strides_el) {
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t box[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    box[i] = i < 2 ? 64 : 1;
    estride[i] = 1;
  }
  for (int i = 0; i < rank - 1; ++i)
    gstride[i] = (cuuint64_t)strides_el[i] * sizeof(__nv_bfloat16);
  const CUresult r = cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + (int)r;
}

template <int NJ>
int launch_f32(const Params& p, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel_f32<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return (int)err;
  const unsigned grid = (unsigned)p.lanes * (unsigned)p.n_qt;
  flash_kernel_f32<NJ><<<grid, kF32Threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HDP>
int launch_bf16(const Params& p, int batch, size_t smem,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  // q: (hd, Sq, G, KV, B); k, v: (hd, Sk, KV, B). A map needs a non-empty
  // extent: Sk = 0 maps one row that no tile ever loads.
  const unsigned long long sk = p.sk > 0 ? p.sk : 1;
  const unsigned long long qd[5] = {(unsigned long long)p.hd,
                                    (unsigned long long)p.sq,
                                    (unsigned long long)p.g,
                                    (unsigned long long)p.kv,
                                    (unsigned long long)batch};
  const long long qs[4] = {p.q_ss, p.q_sg, p.q_sk, p.q_sb};
  const unsigned long long kd[4] = {(unsigned long long)p.hd, sk,
                                    (unsigned long long)p.kv,
                                    (unsigned long long)batch};
  const long long ks[3] = {p.k_ss, p.k_sk, p.k_sb};
  const long long vs[3] = {p.v_ss, p.v_sk, p.v_sb};
  int err = encode(&tq, p.q, 5, qd, qs);
  if (!err) err = encode(&tk, p.k, 4, kd, ks);
  if (!err) err = encode(&tv, p.v, 4, kd, vs);
  if (err) return err;
  err = (int)cudaFuncSetAttribute(flash_kernel_bf16<HDP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem);
  if (err) return err;
  const unsigned grid = (unsigned)p.lanes * (unsigned)p.n_qt;
  flash_kernel_bf16<HDP><<<grid, kBf16Threads, smem, stream>>>(tq, tk, tv,
                                                               p);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes. Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launch (0 = ok), or
// 100000 + the CUresult when a TMA tensor map cannot be encoded.
extern "C" {

const char* flash_attention_error_string(int err) {
  return hopper_error_string(err);
}

// CTAs of one kernel that one SM holds at `smem` bytes (dtype 0 = f32,
// 1 = bf16; the head dim picks the instance), from the occupancy
// calculator.
int flash_attention_ctas_per_sm(int dtype, int hd, size_t smem, int* ctas) {
  const int nj = (hd + 63) / 64;
  const void* fn = nullptr;
  int threads = 0;
  if (dtype == 0) {
    threads = kF32Threads;
    fn = nj == 1   ? (const void*)flash_kernel_f32<1>
         : nj == 2 ? (const void*)flash_kernel_f32<2>
         : nj == 3 ? (const void*)flash_kernel_f32<3>
         : nj == 4 ? (const void*)flash_kernel_f32<4>
                   : nullptr;
  } else if (dtype == 1) {
    threads = kBf16Threads;
    fn = nj == 1   ? (const void*)flash_kernel_bf16<64>
         : nj == 2 ? (const void*)flash_kernel_bf16<128>
         : nj == 3 ? (const void*)flash_kernel_bf16<192>
         : nj == 4 ? (const void*)flash_kernel_bf16<256>
                   : nullptr;
  }
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, fn,
                                                            threads, smem);
}

// strides: q (b, s, kv, g), k (b, s, kv), v (b, s, kv), o (b, s, kv, g),
// in elements. Query row r is at position r + q_off (q_off >= 0). dtype 0
// = f32 (flash_kernel_f32), 1 = bf16
// (flash_kernel_bf16; every stride but the head dim's a multiple of 8 and
// q, k, v 16-byte aligned, as TMA requires). The caller sizes the launch:
// n_qt query tiles of the kernel's own (64 rows f32, 128 bf16) and `smem`
// bytes of shared memory per block (flash_attention.smem_bytes).
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    const long long* strides, int batch, int kv, int g,
                    int sq, int sk, int hd, int q_off, int has_window,
                    int window, float scale, float soft_cap, int dtype,
                    int n_qt, size_t smem, int device, void* stream) {
  if (batch <= 0 || kv <= 0 || g <= 0 || sq <= 0 || sk < 0 || hd <= 0 ||
      hd % 8 || hd > 256 || n_qt <= 0 || q_off < 0)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sk = strides[2];
  p.q_sg = strides[3];
  p.k_sb = strides[4]; p.k_ss = strides[5]; p.k_sk = strides[6];
  p.v_sb = strides[7]; p.v_ss = strides[8]; p.v_sk = strides[9];
  p.o_sb = strides[10]; p.o_ss = strides[11]; p.o_sk = strides[12];
  p.o_sg = strides[13];
  p.kv = kv; p.g = g; p.sq = sq; p.sk = sk; p.hd = hd; p.q_off = q_off;
  p.lanes = batch * kv * g;
  p.n_qt = n_qt;
  p.has_window = has_window; p.window = window;
  p.scale = scale; p.soft_cap = soft_cap;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    switch ((hd + 63) / 64) {
      case 1: return launch_f32<1>(p, smem, s);
      case 2: return launch_f32<2>(p, smem, s);
      case 3: return launch_f32<3>(p, smem, s);
      case 4: return launch_f32<4>(p, smem, s);
    }
  } else if (dtype == 1) {
    switch ((hd + 63) / 64) {
      case 1: return launch_bf16<64>(p, batch, smem, s);
      case 2: return launch_bf16<128>(p, batch, smem, s);
      case 3: return launch_bf16<192>(p, batch, smem, s);
      case 4: return launch_bf16<256>(p, batch, smem, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
