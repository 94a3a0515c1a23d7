// Fused per-mode ALS epilogue for Hopper (sm_90a): two CUDA C++ kernels.
//
// hinv_kernel replaces cp_cals_tpu/ops/pallas_epilogue.py:_hinv_kernel:
//   H^-1 of padded_hadamard(grams[a] * grams[b], rank_mask) per model, a and
//   b the two other modes of a 3-D tensor.
// apply_kernel replaces cp_cals_tpu/ops/pallas_epilogue.py:_apply_kernel:
//   U = G H^-1, jackknife row zero, raw gramian U^T U, lam (L2 from the
//   gramian diagonal at iteration 1, signed max after), F = U / safe(lam),
//   and on the last mode the error-term column sums sum_i F[i,j] G[i,j] as
//   double-float (hi, lo) pairs.
//
// What bounds them: neither bytes nor arithmetic. Each call moves well under
// 1 MB and does under 0.2 GFLOP at the engine's shapes, so both sit at the
// launch latency of the card. The design therefore spends one launch per
// call and one block per model, with everything between G and F kept in
// shared memory: the R x R matrices of hinv, and H^-1 plus the whole I x R
// factor U of apply. G is read once (twice on the error mode) and F written
// once. Rows and columns are walked by plain threads; no wgmma or TMA.
//
// The elimination is the same unpivoted Gauss-Jordan as ops/update.py:
// gj_inverse (SPD pivots are positive Schur-complement diagonals), so its
// rounding stays in that class.
//
// The double-float error columns use the exact FMA TwoProd
// (p = a*b; e = fma(a, b, -p)) and the _rn intrinsics for every add in the
// TwoSum chains: nvcc contracts a*b - p into an FMA by default, which would
// break a Dekker split, and the intrinsics are never contracted.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int EPI_THREADS = 256;
constexpr int MAX_R = 64;
constexpr int MAX_PER_THREAD = (MAX_R * MAX_R + EPI_THREADS - 1) / EPI_THREADS;

__global__ void __launch_bounds__(EPI_THREADS)
hinv_kernel(const float* __restrict__ g0, const float* __restrict__ g1,
            const uint8_t* __restrict__ mask, float* __restrict__ out, int R) {
  extern __shared__ float sm[];
  const int RR = R * R;
  float* a = sm;
  float* inv = sm + RR;
  const int b = blockIdx.x;
  const size_t base = (size_t)b * RR;

  for (int e = threadIdx.x; e < RR; e += blockDim.x) {
    const int r = e / R, c = e % R;
    const float h = g0[base + e] * g1[base + e];
    const float mr = mask[(size_t)b * R + r] ? 1.f : 0.f;
    const float mc = mask[(size_t)b * R + c] ? 1.f : 0.f;
    const float eye = r == c ? 1.f : 0.f;
    a[e] = h * (mr * mc) + eye * (1.f - mc);
    inv[e] = eye;
  }
  __syncthreads();

  for (int j = 0; j < R; ++j) {
    float na[MAX_PER_THREAD], ni[MAX_PER_THREAD];
    const float d = a[j * R + j];
    int t = 0;
    for (int e = threadIdx.x; e < RR; e += blockDim.x, ++t) {
      const int r = e / R, c = e % R;
      const float arow = a[j * R + c] / d;
      const float irow = inv[j * R + c] / d;
      if (r == j) {
        na[t] = arow;
        ni[t] = irow;
      } else {
        const float colj = a[r * R + j];
        na[t] = a[e] - colj * arow;
        ni[t] = inv[e] - colj * irow;
      }
    }
    __syncthreads();
    t = 0;
    for (int e = threadIdx.x; e < RR; e += blockDim.x, ++t) {
      a[e] = na[t];
      inv[e] = ni[t];
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < RR; e += blockDim.x) out[base + e] = inv[e];
}

// Knuth TwoSum and the double-float add of ops/error.py, contraction-free.
__device__ __forceinline__ void two_sum(float a, float b, float& s, float& e) {
  s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb));
}

__device__ __forceinline__ void df_add(float& xh, float& xl, float yh,
                                       float yl) {
  float s, e;
  two_sum(xh, yh, s, e);
  const float lo = __fadd_rn(__fadd_rn(e, xl), yl);
  const float hi = __fadd_rn(s, lo);
  xh = hi;
  xl = __fsub_rn(lo, __fsub_rn(hi, s));
}

__global__ void __launch_bounds__(EPI_THREADS)
apply_kernel(const float* __restrict__ g, const float* __restrict__ hinv,
             const int32_t* __restrict__ iters, const int32_t* __restrict__ jk,
             float* __restrict__ f, float* __restrict__ lam,
             float* __restrict__ gm, float* __restrict__ t3hi,
             float* __restrict__ t3lo, int I, int R, int zero_jk,
             int with_err) {
  extern __shared__ float sm[];
  const int RR = R * R;
  const int IR = I * R;
  float* hs = sm;             // [R, R]   H^-1
  float* us = hs + RR;        // [I, R]   U
  float* diag = us + IR;      // [R]      diag(U^T U)
  float* mxs = diag + R;      // [R]      column max
  float* mns = mxs + R;       // [R]      column min
  float* safe = mns + R;      // [R]      lam with 0 -> 1
  const int b = blockIdx.x;
  const float* gb = g + (size_t)b * IR;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, nwarps = blockDim.x / 32;

  for (int e = tid; e < RR; e += blockDim.x) hs[e] = hinv[(size_t)b * RR + e];
  __syncthreads();

  // U = G H^-1, then the jackknife row zero.
  const int fiber = zero_jk ? jk[b] : -1;
  for (int e = tid; e < IR; e += blockDim.x) {
    const int i = e / R, c = e % R;
    const float* grow = gb + (size_t)i * R;
    float u = 0.f;
    for (int k = 0; k < R; ++k) u = fmaf(grow[k], hs[k * R + c], u);
    us[e] = (fiber >= 0 && i == fiber) ? 0.f : u;
  }
  __syncthreads();

  // Raw gramian U^T U.
  for (int e = tid; e < RR; e += blockDim.x) {
    const int r = e / R, s = e % R;
    float acc = 0.f;
    for (int i = 0; i < I; ++i) acc = fmaf(us[i * R + r], us[i * R + s], acc);
    gm[(size_t)b * RR + e] = acc;
    if (r == s) diag[r] = acc;
  }
  // Column max and min, one warp per column.
  for (int c = warp; c < R; c += nwarps) {
    float mx = -INFINITY, mn = INFINITY;
    for (int i = lane; i < I; i += 32) {
      const float v = us[i * R + c];
      mx = fmaxf(mx, v);
      mn = fminf(mn, v);
    }
    for (int off = 16; off > 0; off /= 2) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    }
    if (lane == 0) {
      mxs[c] = mx;
      mns[c] = mn;
    }
  }
  __syncthreads();

  const bool first = iters[b] == 1;
  for (int c = tid; c < R; c += blockDim.x) {
    const float mx = mxs[c], mn = mns[c];
    const float maxval = mx >= -mn ? mx : mn;  // signed max, tie -> max
    const float l = first ? sqrtf(fabsf(diag[c])) : maxval;
    lam[(size_t)b * R + c] = l;
    safe[c] = l != 0.f ? l : 1.f;
  }
  __syncthreads();

  float* fb = f + (size_t)b * IR;
  for (int e = tid; e < IR; e += blockDim.x) fb[e] = us[e] / safe[e % R];

  if (with_err) {
    // sum_i F[i,c] G[i,c] in double-float: each lane folds its rows in
    // order, then the warp folds the lanes pairwise.
    for (int c = warp; c < R; c += nwarps) {
      float hi = 0.f, lo = 0.f;
      for (int i = lane; i < I; i += 32) {
        const float fv = us[i * R + c] / safe[c];
        const float gv = gb[(size_t)i * R + c];
        const float p = __fmul_rn(fv, gv);
        const float e = __fmaf_rn(fv, gv, -p);
        df_add(hi, lo, p, e);
      }
      for (int off = 16; off > 0; off /= 2) {
        const float oh = __shfl_xor_sync(0xffffffffu, hi, off);
        const float ol = __shfl_xor_sync(0xffffffffu, lo, off);
        df_add(hi, lo, oh, ol);
      }
      if (lane == 0) {
        t3hi[(size_t)b * R + c] = hi;
        t3lo[(size_t)b * R + c] = lo;
      }
    }
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// The two other modes' grams g0, g1 [B, R, R], mask [B, R] (1 byte each)
// -> out [B, R, R].
extern "C" int hinv_launch(const float* g0, const float* g1,
                           const uint8_t* mask, float* out, int B, int R,
                           void* stream) {
  if (R < 1 || R > MAX_R) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)R * R * sizeof(float);
  int err = set_smem((const void*)hinv_kernel, smem);
  if (err) return err;
  hinv_kernel<<<B, EPI_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      g0, g1, mask, out, R);
  return (int)cudaGetLastError();
}

// g [B, I, R], hinv [B, R, R], iters/jk [B] int32 -> f [B, I, R],
// lam [B, R], gm [B, R, R] (raw U^T U), and t3hi/t3lo [B, R] if with_err.
extern "C" int apply_launch(const float* g, const float* hinv,
                            const int32_t* iters, const int32_t* jk, float* f,
                            float* lam, float* gm, float* t3hi, float* t3lo,
                            int B, int I, int R, int zero_jk, int with_err,
                            void* stream) {
  if (R < 1 || R > MAX_R) return (int)cudaErrorInvalidValue;
  // H^-1, U, and four R-vectors (ops/fused_epilogue.py: apply_smem_bytes).
  const size_t smem = ((size_t)R * R + (size_t)I * R + 4 * (size_t)R) * sizeof(float);
  int err = set_smem((const void*)apply_kernel, smem);
  if (err) return err;
  apply_kernel<<<B, EPI_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      g, hinv, iters, jk, f, lam, gm, t3hi, t3lo, I, R, zero_jk, with_err);
  return (int)cudaGetLastError();
}
