// InCRS section stripes -> dense rows on Hopper (sm_90a).
//
// Replaces the Pallas kernel _kernel of incrs_gather (src/repro/kernels/
// incrs_gather.py:28/:40), the densify step of the two-pass baseline and of
// the `densify` SpGEMM engine.
//
// Inputs: idx int32 / val f32 section stripes (M, n_sec, smax), the local
// column of each non-zero inside its section, -1 = pad slot. Output: f32
// (M, n_sec * section), out[r, s * section + idx] = val for every live
// slot, 0 elsewhere.
//
// The TPU kernel one-hot expands each (rows, smax) stripe into a dense
// (rows, section) slab, because the VPU/MXU want dense tiles. Here each
// live slot is one store. A block owns one output row: it zeroes the row
// (float4 stores where the width allows), then adds its live slots onto
// the zeros. Adding onto 0 gives the value itself (a -0 becomes +0, as in
// the one-hot sum), and a duplicated index sums, as it does there, so the
// result equals the plain torch scatter_add bit for bit.
//
// What bounds it on the H100: bytes. It reads the stripes once and writes
// the dense matrix once: at mesh-docword4 (bm = 8) about 72 MB of output
// and the stripes, about 0.03 ms. The zeroing is a coalesced stream; the
// scatter touches lines that the same block has just written, mostly
// still in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

}  // namespace

// ---------------------------------------------------------------------------
// Plain C interface, bound with ctypes. Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launch (0 = ok).
extern "C" {

const char* incrs_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int incrs_gather(const int* idx, const float* val, float* out, int m,
                 int n_sec, int smax, int section, int device, void* stream) {
  int err = (int)cudaSetDevice(device);
  if (err) return err;
  const long long width = (long long)n_sec * section;
  const int vec = (width % 4 == 0 && ((uintptr_t)out & 15) == 0);
  gather_kernel<<<m, kThreads, 0, (cudaStream_t)stream>>>(
      idx, val, out, n_sec, smax, section, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
