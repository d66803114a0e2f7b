// Causal grouped-query flash attention on Hopper (sm_90a), f32 math.
//
// Replaces the Pallas kernel _kernel of flash_attention (src/repro/kernels/
// flash_attention.py:38/:94), which ops.flash_mha (src/repro/kernels/
// ops.py:806) reaches, and the jnp _flash_attention that the LM's prefill
// runs for prompts of FLASH_THRESHOLD tokens or more (src/repro/models/
// layers.py:143/:287).
//
// What it computes, for each query lane (b, kv head, group member g), query
// position i < Sq and head dim d: logit[i, j] = q[i] . k[j] / sqrt(hd);
// with a soft cap, cap * tanh(logit / cap); only keys j <= i, j < Sk and,
// with a window, j > i - window count; an online softmax in f32 (running
// max m, denominator l, accumulator acc); out = acc / max(l, 1e-30), cast
// to the input type. The G query heads of one KV head read the same K and
// V rows (GQA, MQA at KV = 1); nothing is repeated in memory.
//
// Inputs in the JAX layout, read through strides: q and out
// (B, Sq, KV, G, hd), k and v (B, Sk, KV, hd), each with the head dim
// contiguous. The Pallas wrapper transposes q, k and v into lanes and pads
// Sq and Sk to its tiles; here the ragged tiles are masked (rows past Sq
// load zeros and are not stored, keys past Sk are invalid), so the caller
// copies nothing. Types: f32 or bf16 in and out; all sums are f32.
//
// Design (a first version: right first, fast later): one CTA of 256 per
// (query lane, 64-query tile), the tiles of the heaviest (last) queries
// scheduled first, since causal work grows with the position. The CTA
// stages its Q tile once, transposed in shared memory, then walks the
// 64-key tiles from the first one the window reaches to the diagonal; key
// tiles wholly masked are never loaded (the Pallas "skip fully masked K
// blocks" rule). Per key tile: K (transposed) and V are staged in shared
// memory as f32; each thread computes a 4 x 4 block of scores by f32 FMA
// from float4 reads; row max and row sum are reduced across the 16 threads
// of a row by shuffles; m, l and the thread's 4 rows x (4 * NJ) columns of
// acc stay in registers; P goes back to shared memory (over the K tile,
// which the scores no longer need) for the P . V product. Shared memory is
// ((hd + max(hd, 64)) * 68 + 64 * NJ * 64) * 4 bytes, NJ = ceil(hd / 64):
// 102,400 at hd 128 (two CTAs per SM), 204,800 at hd 256.
//
// What bounds it on the H100: operations. At granite-34b's prefill wave
// (B = 2, S = 8192, KV = 1, G = 48, hd = 128) the causal pairs need 1.649
// TFLOP against 411 MB: 1.67 ms at the bf16 tensor-core rate, 0.12 ms of
// bytes. This version runs its products as f32 FMA outside the tensor
// cores (67 TFLOP/s at most, 24.6 ms for that work), with no wgmma, TMA or
// warp specialisation: those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBq = 64, kBk = 64;   // query and key tile
constexpr int kLd = kBq + 4;        // row stride of the transposed tiles
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
  int has_window, window;
  float scale, soft_cap;  // soft_cap 0: no cap
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kVs = NJ * 64;       // row stride of the V tile
  const int hd = p.hd;
  float* qs = smem;                  // [hd][kLd]: Q tile, transposed
  float* ks = qs + hd * kLd;         // [hd][kLd]: K tile, transposed
  float* ps = ks;                    // [kBk][kLd]: P tile, over K's
  float* vs = ks + max(hd, kBk) * kLd;  // [kBk][kVs]: V tile

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qt = p.n_qt - 1 - (int)(blockIdx.x / p.lanes);
  const int lane = (int)(blockIdx.x % p.lanes);
  const int b = lane / (p.kv * p.g);
  const int kvh = (lane / p.g) % p.kv;
  const int gi = lane % p.g;
  const int q0 = qt * kBq;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + kvh * p.q_sk +
               gi * p.q_sg;
  const T* kp = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sk;
  const T* vp = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sk;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + kvh * p.o_sk + gi * p.o_sg;

  for (int idx = tid; idx < kBq * hd; idx += kThreads) {
    const int r = idx / hd, d = idx - r * hd;
    const int i = q0 + r;
    qs[d * kLd + r] = i < p.sq ? to_f32(q[(long long)i * p.q_ss + d]) : 0.0f;
  }

  // Key tiles holding at least one valid key for some row of this tile.
  const int q_last = min(q0 + kBq - 1, p.sq - 1);
  const int key_hi = min(q_last, p.sk - 1);
  long long key_lo = 0;
  if (p.has_window) key_lo = max(0LL, (long long)q0 - p.window + 1);
  const int kt_lo = (int)(key_lo / kBk);
  const int kt_hi = key_hi < 0 ? -1 : key_hi / kBk;

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

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();  // the previous tile's P . V is done with ps and vs
    for (int idx = tid; idx < kBk * hd; idx += kThreads) {
      const int r = idx / hd, d = idx - r * hd;
      const int j = k0 + r;
      const bool in = j < p.sk;
      ks[d * kLd + r] = in ? to_f32(kp[(long long)j * p.k_ss + d]) : 0.0f;
      vs[r * kVs + d] = in ? to_f32(vp[(long long)j * p.v_ss + d]) : 0.0f;
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
      const int row = q0 + ty * 4 + i;
      bool valid[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx * 4 + c;
        float x = s[i][c] * p.scale;
        if (p.soft_cap != 0.0f) x = p.soft_cap * tanhf(x / p.soft_cap);
        valid[c] = col <= row && col < p.sk &&
                   (!p.has_window || (long long)col > (long long)row -
                                                          p.window);
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
    T* orow = o + (long long)row * p.o_ss;
#pragma unroll
    for (int jn = 0; jn < NJ; ++jn) {
      const int c = tx * 4 + 64 * jn;
      if (c < hd) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store(orow + c + e, acc[i][jn][e] / den);
      }
    }
  }
}

size_t smem_bytes(int hd) {
  const int nj = (hd + 63) / 64;
  return (size_t)((hd + max(hd, kBk)) * kLd + kBk * nj * 64) *
         sizeof(float);
}

template <typename T, int NJ>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.hd);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err) return (int)err;
  const unsigned grid = (unsigned)p.lanes * (unsigned)p.n_qt;
  flash_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_nj(const Params& p, cudaStream_t stream) {
  switch ((p.hd + 63) / 64) {
    case 1: return launch<T, 1>(p, stream);
    case 2: return launch<T, 2>(p, stream);
    case 3: return launch<T, 3>(p, stream);
    case 4: return launch<T, 4>(p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes. Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launch (0 = ok).
extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

size_t flash_attention_smem_bytes(int hd) { return smem_bytes(hd); }

// strides: q (b, s, kv, g), k (b, s, kv), v (b, s, kv), o (b, s, kv, g),
// in elements. dtype 0 = f32, 1 = bf16.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    const long long* strides, int batch, int kv, int g,
                    int sq, int sk, int hd, int has_window, int window,
                    float scale, float soft_cap, int dtype, int device,
                    void* stream) {
  if (batch <= 0 || kv <= 0 || g <= 0 || sq <= 0 || sk < 0 || hd <= 0 ||
      hd % 8 || hd > 256)
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
  p.kv = kv; p.g = g; p.sq = sq; p.sk = sk; p.hd = hd;
  p.lanes = batch * kv * g;
  p.n_qt = (sq + kBq - 1) / kBq;
  p.has_window = has_window; p.window = window;
  p.scale = scale; p.soft_cap = soft_cap;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_nj<float>(p, s);
  if (dtype == 1) return launch_nj<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
