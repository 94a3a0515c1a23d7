// The split-j reduction shared by the two fused MTTKRP kernels
// (fused_mttkrp.cu on the CUDA cores, fused_mttkrp_tc.cu on the tensor cores).
#pragma once

#include <cuda_runtime.h>

namespace {

// Sums the S partial results work [S, I, C] in split order and writes
// G[b, i, r] (c = b*R + r), so the result does not depend on scheduling.
// With a predicate (a device int) of 0 every block returns at once.
__global__ void reduce_splits(const float* __restrict__ work, float* __restrict__ out,
                              int S, int I, int R, int C, const int* __restrict__ pred) {
  if (pred != nullptr && *pred == 0) return;
  const size_t ic = (size_t)I * C;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < ic;
       e += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < S; ++z) s += work[z * ic + e];
    const int i = (int)(e / C), c = (int)(e % C);
    out[(size_t)(c / R) * I * R + (size_t)i * R + (c % R)] = s;
  }
}

inline void launch_reduce_splits(const float* work, float* out, int S, int I, int R, int C,
                                 const int* pred, cudaStream_t s) {
  const size_t ic = (size_t)I * C;
  const int blocks = (int)((ic + 255) / 256 < 1024 ? (ic + 255) / 256 : 1024);
  reduce_splits<<<blocks, 256, 0, s>>>(work, out, S, I, R, C, pred);
}

}  // namespace
