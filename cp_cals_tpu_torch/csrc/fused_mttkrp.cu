// Fused 3-D MTTKRP for Hopper (sm_90a) at the "highest" tier, CUDA C++ on
// the CUDA cores.
//
// Replaces the TPU kernel cp_cals_tpu/ops/pallas_mttkrp.py:_mttkrp_kernel at
// precision "highest" (strict fp32: the tensor cores have no strict-fp32
// path). The bf16 tiers run on the tensor cores, csrc/fused_mttkrp_tc.cu.
//
// Computes, for every model b and rank column r (packed column c = b*R + r):
//
//     G[b, n, r] = sum_j U1[b, j, r] * (sum_k X[j, n, k] * U2[b, k, r])
//
// X is the mode layout [J, I, K] (J = small other mode, I = target mode,
// K = big other mode), prepared once per solve. U1 [B, J, R] and U2
// [B, K, R] are the factors in the engine's own layout, and G is written
// straight into [B, I, R]: no packed copies of the factors or the result.
//
// What bounds it: arithmetic. 2*J*I*K*B*R operations against J*I*K*4 bytes
// of X (about B*R/2 operations per byte), so at the engine's B*R of
// 384-768 it is far above the card's operations-per-byte balance. This
// version runs plain fp32 FMA on the CUDA cores (no wgmma, no TMA): a
// 64 x 128 output tile per block, 8 x 4 outputs per thread held in
// registers, X and U2 tiles staged through shared memory 16 deep in k and
// read back with 128-bit loads (3 loads per 32 FMAs, so the FMA pipes and
// not the shared-memory port set the pace); the staged X rows are padded so
// the staging stores do not pile onto one bank.
// The partial product w = X_j U2 accumulates in registers over k and is
// folded into the output with the U1 row before the next j, so the
// [I, J, B*R] intermediate of the unfused twostep never exists. When the
// output tiles alone cannot fill the card's SMs (132 on an H100; the target
// mode of 41 rows gives 3-6 tiles), the j range is split across blocks
// (grid z, sized by the wrapper from the SM count) into a
// workspace [S, I, B*R] that a second kernel sums in a fixed order, so the
// result does not depend on scheduling.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mttkrp_common.cuh"

namespace {

constexpr int TM = 64;       // rows of the target mode per block
constexpr int TN = 128;      // packed (model, rank) columns per block
constexpr int TK = 16;       // depth of one shared-memory stage in k
constexpr int NT = 256;      // threads: 8 row groups x 32 column groups
constexpr int RM = 8;        // rows per thread (contiguous)
constexpr int RN = 4;        // columns per thread (contiguous)
constexpr int XP = TM + 4;   // padded row of the staged X tile

__device__ __forceinline__ void load4(float* dst, const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__global__ void __launch_bounds__(NT, 2)
mttkrp_kernel(const float* __restrict__ x, const float* __restrict__ u1,
              const float* __restrict__ u2, float* __restrict__ dst,
              int J, int I, int K, int R, int C, int jchunk, int to_bir) {
  __shared__ __align__(16) float xs[TK][XP];
  __shared__ __align__(16) float us[TK][TN];

  const int tid = threadIdx.x;
  const int tx = tid % 32;   // columns tx*4 .. tx*4+3
  const int ty = tid / 32;   // rows ty*8 .. ty*8+7 (one row group per warp)
  const int c0 = blockIdx.x * TN;
  const int i0 = blockIdx.y * TM;
  const int j_begin = blockIdx.z * jchunk;
  const int j_end = min(J, j_begin + jchunk);

  // U2 staging: thread tid always loads column tid % TN.
  const int ld_n = tid % TN;
  const int ld_c = c0 + ld_n;
  const bool ld_c_ok = ld_c < C;
  const size_t u2_col = ld_c_ok ? (size_t)(ld_c / R) * K * R + (ld_c % R) : 0;
  size_t u1_col[RN];
  bool c_ok[RN];
#pragma unroll
  for (int n = 0; n < RN; ++n) {
    const int c = c0 + tx * RN + n;
    c_ok[n] = c < C;
    u1_col[n] = c_ok[n] ? (size_t)(c / R) * J * R + (c % R) : 0;
  }

  float acc[RM][RN];
#pragma unroll
  for (int m = 0; m < RM; ++m)
#pragma unroll
    for (int n = 0; n < RN; ++n) acc[m][n] = 0.f;

  for (int j = j_begin; j < j_end; ++j) {
    const float* xj = x + (size_t)j * I * K;
    float w[RM][RN];
#pragma unroll
    for (int m = 0; m < RM; ++m)
#pragma unroll
      for (int n = 0; n < RN; ++n) w[m][n] = 0.f;

    for (int k0 = 0; k0 < K; k0 += TK) {
#pragma unroll
      for (int q = 0; q < (TM * TK) / NT; ++q) {
        const int l = tid + q * NT;
        const int m = l / TK, kk = l % TK;
        const int i = i0 + m, k = k0 + kk;
        const float v = (i < I && k < K) ? xj[(size_t)i * K + k] : 0.f;
        xs[kk][m] = v;
      }
#pragma unroll
      for (int q = 0; q < (TK * TN) / NT; ++q) {
        const int kk = tid / TN + q * (NT / TN);
        const int k = k0 + kk;
        const float v = (ld_c_ok && k < K) ? u2[u2_col + (size_t)k * R] : 0.f;
        us[kk][ld_n] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) {
        float a[RM], b[RN];
        load4(a, &xs[kk][ty * RM]);
        load4(a + 4, &xs[kk][ty * RM + 4]);
        load4(b, &us[kk][tx * RN]);
#pragma unroll
        for (int m = 0; m < RM; ++m)
#pragma unroll
          for (int n = 0; n < RN; ++n) w[m][n] = fmaf(a[m], b[n], w[m][n]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      const float wt = c_ok[n] ? u1[u1_col[n] + (size_t)j * R] : 0.f;
#pragma unroll
      for (int m = 0; m < RM; ++m) acc[m][n] = fmaf(w[m][n], wt, acc[m][n]);
    }
  }

  // to_bir: write G[b, i, r] directly; else the workspace [S, I, C].
  float* out = to_bir ? dst : dst + (size_t)blockIdx.z * I * C;
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int i = i0 + ty * RM + m;
    if (i >= I) continue;
#pragma unroll
    for (int n = 0; n < RN; ++n) {
      const int c = c0 + tx * RN + n;
      if (!c_ok[n]) continue;
      const size_t o = to_bir
          ? (size_t)(c / R) * I * R + (size_t)i * R + (c % R)
          : (size_t)i * C + c;
      out[o] = acc[m][n];
    }
  }
}

}  // namespace

// x [J, I, K], u1 [B, J, R], u2 [B, K, R] -> out [B, I, R], all fp32 and
// contiguous. splits > 1 needs work [splits, I, B*R]; jchunk is the number
// of j per split. Returns cudaGetLastError() after the launches.
extern "C" int fused_mttkrp_launch(const float* x, const float* u1,
                                   const float* u2, float* out, float* work,
                                   int J, int I, int K, int B, int R,
                                   int splits, int jchunk, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C = B * R;
  dim3 grid((C + TN - 1) / TN, (I + TM - 1) / TM, splits);
  const int to_bir = splits == 1;
  mttkrp_kernel<<<grid, NT, 0, s>>>(x, u1, u2, to_bir ? out : work, J, I, K, R,
                                    C, jchunk, to_bir);
  if (!to_bir) launch_reduce_splits(work, out, splits, I, R, C, s);
  return (int)cudaGetLastError();
}
