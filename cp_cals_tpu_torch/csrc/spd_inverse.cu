// Batched inverse of small SPD matrices for Hopper (sm_90a).
//
// spd_inverse_kernel replaces cp_cals_tpu/ops/pallas_solve.py:_gj_kernel:
//   H^-1 per model of a [B, R, R] float32 batch by unpivoted Gauss-Jordan
//   elimination, one reciprocal of the pivot per step and then multiplies
//   (the TPU kernel's arithmetic, ops/spd_inverse.py:spd_inverse_plain).
//   No pivoting: SPD pivots are positive Schur-complement diagonals. The
//   engine's padded slots already carry identity rows and columns
//   (ops/update.py:padded_hadamard), so nothing is padded here.
//
// What bounds it: neither bytes nor arithmetic. At the engine's shapes
// (B = 320, R = 5 or 8) a call reads and writes well under 1 MB and does
// under 1 MFLOP, so it sits at the card's launch latency. The TPU kernel put
// 128 models on the vector lanes; here each model gets one block, with its
// matrix and its inverse in shared memory, read from device memory once and
// written once. Each elimination step first copies the scaled pivot row
// and the pivot column into shared memory, so every element is then updated
// in place by the one thread that owns it.
//
// nvcc contracts a - c * p into an FMA; that changes only the last bit of
// each update, and no compensated arithmetic here depends on it.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_R = 64;
constexpr int MAX_THREADS = 256;

__global__ void __launch_bounds__(MAX_THREADS)
spd_inverse_kernel(const float* __restrict__ h, float* __restrict__ out,
                   int R) {
  extern __shared__ float sm[];
  const int RR = R * R;
  float* a = sm;             // [R, R]  the matrix being eliminated
  float* inv = a + RR;       // [R, R]  the inverse being built
  float* prow_a = inv + RR;  // [R]     pivot row of a, scaled
  float* prow_i = prow_a + R;  // [R]   pivot row of inv, scaled
  float* pcol = prow_i + R;  // [R]     pivot column of a
  const size_t base = (size_t)blockIdx.x * RR;

  for (int e = threadIdx.x; e < RR; e += blockDim.x) {
    a[e] = h[base + e];
    inv[e] = (e / R == e % R) ? 1.f : 0.f;
  }
  __syncthreads();

  for (int j = 0; j < R; ++j) {
    const float rd = 1.f / a[j * R + j];
    for (int c = threadIdx.x; c < R; c += blockDim.x) {
      prow_a[c] = a[j * R + c] * rd;
      prow_i[c] = inv[j * R + c] * rd;
      pcol[c] = a[c * R + j];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < RR; e += blockDim.x) {
      const int r = e / R, c = e % R;
      if (r == j) {
        a[e] = prow_a[c];
        inv[e] = prow_i[c];
      } else {
        a[e] = a[e] - pcol[r] * prow_a[c];
        inv[e] = inv[e] - pcol[r] * prow_i[c];
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < RR; e += blockDim.x) out[base + e] = inv[e];
}

}  // namespace

// h [B, R, R] float32 -> out [B, R, R]; one block of up to 256 threads per
// model.
extern "C" int spd_inverse_launch(const float* h, float* out, int B, int R,
                                  void* stream) {
  if (R < 1 || R > MAX_R || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int rr = R * R;
  int threads = ((rr + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  // 2 R^2 + 3 R floats: at R = 64, 33.5 KB, under the 48 KB default.
  const size_t smem = (2 * (size_t)rr + 3 * (size_t)R) * sizeof(float);
  spd_inverse_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      h, out, R);
  return (int)cudaGetLastError();
}
