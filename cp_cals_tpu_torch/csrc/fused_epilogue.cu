// Fused per-mode ALS epilogue for Hopper (sm_90a): two CUDA C++ kernels.
//
// hinv (gj_elim.cuh's elimination behind HadamardLoad, launched by
//   hinv_launch) replaces cp_cals_tpu/ops/pallas_epilogue.py:_hinv_kernel:
//   H^-1 of padded_hadamard(grams[a] * grams[b], rank_mask) per model, a and
//   b the two other modes of a 3-D tensor.
// apply_kernel replaces cp_cals_tpu/ops/pallas_epilogue.py:_apply_kernel,
//   together with the two steps the JAX iteration runs right after it
//   (cp_cals_tpu/solvers/iteration.py: the gramian rescale and
//   ops/error.py:fast_error_from_cols): U = G H^-1, jackknife row zero,
//   gramian U^T U, lam (L2 from the gramian diagonal at iteration 1, signed
//   max after), F = U / safe(lam), the rescaled gramian
//   gm = (U^T U) / (safe_r * safe_s), and on the last mode the FastALS error
//   err = sqrt(max(0, |X|^2 + term2 - 2 term3)) per model, all in
//   double-float: term3 = sum_j lam_j sum_i F[i,j] G[i,j] and
//   term2 = sum_rs lam_r lam_s H_rs with H = (gram_a * gram_b) * gm, the
//   hadamard of all three rescaled gramians in mode order.
//
// What bounds them: neither bytes nor arithmetic. Each call moves well under
// 1 MB and does under 0.2 GFLOP at the engine's shapes, so both sit at the
// launch latency of the card, and the host's cost of each launch is larger
// still. hinv is the shared Gauss-Jordan elimination of gj_elim.cuh (which
// says what its design does about that) behind the hadamard front end:
// one warp per model with the matrix in registers for R <= 32, one block
// per model above. The apply spends one launch per call and one block per
// model, with everything between G and F kept in shared memory, and
// finishes the whole error on the card, which would otherwise take some
// hundred elementwise launches.
//
// apply, per model (one block of 512 threads):
// - H^-1 and G are staged in shared memory with coalesced loads, and
//   U = G H^-1 is formed in place over G, a round of whole rows at a time
//   (thread = row x 4-column piece, R FMAs per output in k order; float4
//   pieces where R is a multiple of 4, as at every bench bucket).
// - The gramian's I-sums are spread over all threads: thread = (row slice,
//   4 x 4 block of U^T U), each summing its slice's rows in registers; the
//   slices are then added in slice order. Column max and min: one warp per
//   column.
// - Shared memory is H^-1, G then U, and four R-vectors, R^2 + I R + 4 R
//   floats, so the largest I per R is what those alone allow. The first
//   slice's partial gramian (then the gramian) takes H^-1's place once U is
//   formed; the other slices take what the card has left beyond that, as
//   many as fit up to MAX_SLICES (one at the largest I). The error columns
//   reuse the max and min vectors, and the block sums reuse U's space.
// - The error columns sum_i F G: one warp per column, lanes over the rows,
//   exact TwoProd and double-float adds, then an xor butterfly. term3 and
//   term2 are per-thread double-float sums, each folded over the block in a
//   fixed order (butterfly within the warps, then the warps in order). That
//   fold order differs from the plain version's padded pairwise _df_sum;
//   both are double-float sums, so the results agree far below fp32
//   rounding. Every sum has a fixed order: the result does not depend on
//   scheduling.
//
// The double-float sums use the exact FMA TwoProd
// (p = a*b; e = fma(a, b, -p)) and the _rn intrinsics for every add and
// product in them: nvcc contracts a*b + c into an FMA by default, which
// would change the compensated terms, and the intrinsics are never
// contracted.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gj_elim.cuh"
#include "smem_attr.cuh"

namespace {

constexpr int MAX_R = 64;

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

// Exact product: p + e == a * b.
__device__ __forceinline__ void two_prod(float a, float b, float& p, float& e) {
  p = __fmul_rn(a, b);
  e = __fmaf_rn(a, b, -p);
}

// Double-float sum over the lanes of a warp (xor butterfly); every lane
// ends with a value, lane 0's is the one used.
__device__ __forceinline__ void warp_df_sum(float& hi, float& lo) {
  for (int off = 16; off > 0; off /= 2) {
    const float oh = __shfl_xor_sync(0xffffffffu, hi, off);
    const float ol = __shfl_xor_sync(0xffffffffu, lo, off);
    df_add(hi, lo, oh, ol);
  }
}

constexpr int APPLY_THREADS = 512;
constexpr int NWARPS = APPLY_THREADS / 32;
constexpr int MAX_SLICES = 16;  // row slices of the gramian's I-sums, at most

// Double-float sum of every thread's (hi, lo) over the block, in a fixed
// order: the warps' butterflies, then the warps in order. Valid in thread 0.
// red: 2 * NWARPS floats of shared memory.
__device__ void block_df_sum(float& hi, float& lo, float* red) {
  warp_df_sum(hi, lo);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    red[2 * warp] = hi;
    red[2 * warp + 1] = lo;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    hi = red[0];
    lo = red[1];
    for (int w = 1; w < NWARPS; ++w) df_add(hi, lo, red[2 * w], red[2 * w + 1]);
  }
  __syncthreads();
}

// Shared memory of apply_kernel in floats with `ns` row slices of the
// gramian: the slices' partial gramians [ns, R, R] (the first in H^-1's
// place), G then U [I, R] (at least the block sums' scratch), and four
// R-vectors. One slice: R^2 + I R + 4 R for every I R >= 2 * NWARPS.
__host__ __device__ constexpr long long apply_smem_floats(int I, int R, int ns) {
  return (long long)ns * R * R + ((long long)I * R > 2 * NWARPS ? (long long)I * R : 2 * NWARPS) +
         4LL * R;
}

// The row slices of the gramian at (I, R) with `optin` bytes of shared
// memory per block: as many as fit, up to MAX_SLICES and one 4 x 4 block of
// U^T U per thread; at least one.
int gram_slices(int I, int R, int optin) {
  const int nb = (R + 3) / 4;
  int ns = APPLY_THREADS / (nb * nb);
  ns = ns < MAX_SLICES ? ns : MAX_SLICES;
  const long long spare = optin / 4 - apply_smem_floats(I, R, 1);
  if (spare < (long long)(ns - 1) * R * R) ns = 1 + (int)(spare > 0 ? spare / (R * R) : 0);
  return ns > 1 ? ns : 1;
}

__global__ void __launch_bounds__(APPLY_THREADS)
apply_kernel(const float* __restrict__ g, const float* __restrict__ hinv,
             const int32_t* __restrict__ iters, const int32_t* __restrict__ jk,
             const float* __restrict__ x_norm, const float* __restrict__ gram_a,
             const float* __restrict__ gram_b, float* __restrict__ f,
             float* __restrict__ lam, float* __restrict__ gm,
             float* __restrict__ err, int I, int R, int NS, int zero_jk) {
  extern __shared__ __align__(16) float sm[];
  const int RR = R * R, IR = I * R;
  float* hs = sm;                        // [R, R]   H^-1, until U is formed
  float* part = sm;                      // [NS, R, R]  then the slices' partial gramians;
                                         //   the first ends as U^T U (rescaled in place)
  float* us = sm + (size_t)NS * RR;      // [I, R]   G, then U; then the block sums
  float* mxs = us + max(IR, 2 * NWARPS); // [R]      column max, then the error columns' hi
  float* mns = mxs + R;                  // [R]      column min, then their lo
  float* lams = mns + R;                 // [R]      lam
  float* safe = lams + R;                // [R]      lam with 0 -> 1
  const int b = blockIdx.x;
  const float* gb = g + (size_t)b * IR;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  // Stage H^-1 and G, both coalesced.
  for (int e = tid; e < RR; e += APPLY_THREADS) hs[e] = hinv[(size_t)b * RR + e];
  for (int e = tid; e < IR; e += APPLY_THREADS) us[e] = gb[e];
  __syncthreads();

  // U = G H^-1 in place, then the jackknife row zero. Each round takes whole
  // rows (thread = row x 4-column piece, R FMAs per output in k order): all
  // of a round's rows are read before any is overwritten. With R a multiple
  // of 4 (every row then 16-byte aligned) the pieces move as float4.
  const bool vec = R % 4 == 0;
  const int NB = (R + 3) / 4;
  const int fiber = zero_jk ? jk[b] : -1;
  const int rows = APPLY_THREADS / NB;
  for (int r0 = 0; r0 < I; r0 += rows) {
    const int i = r0 + tid / NB, c0 = 4 * (tid % NB);
    const bool act = tid < rows * NB && i < I;
    float u[4] = {0.f, 0.f, 0.f, 0.f};
    if (act) {
      const float* grow = us + (size_t)i * R;
      for (int k = 0; k < R; ++k) {
        const float gv = grow[k];
        const float* h = hs + k * R + c0;
        if (vec) {
          const float4 h4 = *reinterpret_cast<const float4*>(h);
          u[0] = fmaf(gv, h4.x, u[0]);
          u[1] = fmaf(gv, h4.y, u[1]);
          u[2] = fmaf(gv, h4.z, u[2]);
          u[3] = fmaf(gv, h4.w, u[3]);
        } else {
#pragma unroll
          for (int a = 0; a < 4; ++a) u[a] = fmaf(gv, h[min(a, R - 1 - c0)], u[a]);
        }
      }
      if (i == fiber) u[0] = u[1] = u[2] = u[3] = 0.f;
    }
    __syncthreads();
    if (act) {
      float* urow = us + (size_t)i * R + c0;
      if (vec) {
        *reinterpret_cast<float4*>(urow) = make_float4(u[0], u[1], u[2], u[3]);
      } else {
#pragma unroll
        for (int a = 0; a < 4; ++a)
          if (c0 + a < R) urow[a] = u[a];
      }
    }
    __syncthreads();
  }

  // Gramian U^T U: thread = (row slice q, 4 x 4 block), summing rows
  // q, q + NS, ... in registers (columns past R read column R - 1 and are
  // not written); the slices are added in order below. H^-1 is dead, so
  // slice 0 takes its place.
  const int nblk = NB * NB;
  if (tid < NS * nblk) {
    const int q = tid / nblk, blk = tid % nblk;
    const int br = 4 * (blk / NB), bs = 4 * (blk % NB);
    float acc[4][4] = {};
    for (int i = q; i < I; i += NS) {
      const float* row = us + (size_t)i * R;
      float xa[4], ya[4];
      if (vec) {
        const float4 x4 = *reinterpret_cast<const float4*>(row + br);
        const float4 y4 = *reinterpret_cast<const float4*>(row + bs);
        xa[0] = x4.x, xa[1] = x4.y, xa[2] = x4.z, xa[3] = x4.w;
        ya[0] = y4.x, ya[1] = y4.y, ya[2] = y4.z, ya[3] = y4.w;
      } else {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          xa[a] = row[min(br + a, R - 1)];
          ya[a] = row[min(bs + a, R - 1)];
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(xa[a], ya[c], acc[a][c]);
    }
    float* pq = part + (size_t)q * RR;
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (br + a < R && bs + c < R) pq[(br + a) * R + bs + c] = acc[a][c];
  }
  // Column max and min, one warp per column.
  for (int c = warp; c < R; c += NWARPS) {
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
  for (int e = tid; e < RR; e += APPLY_THREADS) {  // one thread per entry
    float s = part[e];
    for (int q = 1; q < NS; ++q) s += part[(size_t)q * RR + e];
    part[e] = s;
  }
  __syncthreads();

  const bool first = iters[b] == 1;
  for (int c = tid; c < R; c += APPLY_THREADS) {
    const float mx = mxs[c], mn = mns[c];
    const float maxval = mx >= -mn ? mx : mn;  // signed max, tie -> max
    const float l = first ? sqrtf(fabsf(part[c * R + c])) : maxval;
    lam[(size_t)b * R + c] = l;
    lams[c] = l;
    safe[c] = l != 0.f ? l : 1.f;
  }
  __syncthreads();

  // F = U / safe(lam), and the rescaled gramian: the product of the two
  // safes first, then one division.
  float* fb = f + (size_t)b * IR;
  for (int e = tid; e < IR; e += APPLY_THREADS) fb[e] = us[e] / safe[e % R];
  for (int e = tid; e < RR; e += APPLY_THREADS) {
    const int r = e / R, s = e % R;
    const float v = part[e] / __fmul_rn(safe[r], safe[s]);
    gm[(size_t)b * RR + e] = v;
    part[e] = v;  // one thread reads and writes each entry
  }
  if (err == nullptr) return;  // not the error mode (uniform over the block)

  // Error columns sum_i F[i,c] G[i,c] in double-float: one warp per column,
  // each lane folds its rows in order, then the butterfly. Max and min are
  // dead: their vectors take the columns.
  float* t3h = mxs;
  float* t3l = mns;
  for (int c = warp; c < R; c += NWARPS) {
    float hi = 0.f, lo = 0.f;
    for (int i = lane; i < I; i += 32) {
      float p, e;
      two_prod(us[i * R + c] / safe[c], gb[(size_t)i * R + c], p, e);
      df_add(hi, lo, p, e);
    }
    warp_df_sum(hi, lo);
    if (lane == 0) {
      t3h[c] = hi;
      t3l[c] = lo;
    }
  }
  __syncthreads();

  // term3 = sum_c lam_c t3_c. U is dead: its space takes the block sums.
  float* red = us;
  float hi = 0.f, lo = 0.f;
  if (tid < R) {
    const float l = lams[tid];
    float p, e;
    two_prod(l, t3h[tid], p, e);
    df_add(hi, lo, p, __fadd_rn(e, __fmul_rn(l, t3l[tid])));
  }
  block_df_sum(hi, lo, red);
  const float t3_hi = hi, t3_lo = lo;
  // term2 = sum_rs lam_r lam_s H_rs, H = (gram_a * gram_b) * gm.
  hi = lo = 0.f;
  for (int e = tid; e < RR; e += APPLY_THREADS) {
    const int r = e / R, s = e % R;
    const size_t o = (size_t)b * RR + e;
    const float h = __fmul_rn(__fmul_rn(gram_a[o], gram_b[o]), part[e]);
    float llh, lll, qh, ql;
    two_prod(lams[r], lams[s], llh, lll);
    two_prod(llh, h, qh, ql);
    df_add(hi, lo, qh, __fadd_rn(ql, __fmul_rn(lll, h)));
  }
  block_df_sum(hi, lo, red);
  if (tid == 0) {
    const float xn = x_norm[b];
    float ah, al;
    two_prod(xn, xn, ah, al);
    df_add(ah, al, hi, lo);
    df_add(ah, al, __fmul_rn(-2.f, t3_hi), __fmul_rn(-2.f, t3_lo));
    const float v = __fadd_rn(ah, al);
    err[b] = sqrtf(v < 0.f ? 0.f : v);  // clamp at 0; NaN stays NaN
  }
}

// The card's shared memory per block (opt-in), read once per device.
int smem_optin() {
  static int optin[MAX_DEVICES] = {};
  const int dev = current_device();
  int v = dev >= 0 ? optin[dev] : 0;
  if (v == 0) {
    int d = 0;
    if (cudaGetDevice(&d) != cudaSuccess ||
        cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, d) != cudaSuccess)
      return 0;
    if (dev >= 0) optin[dev] = v;
  }
  return v;
}

}  // namespace

// The two other modes' grams g0, g1 [B, R, R], mask [B, R] (1 byte each)
// -> out [B, R, R] (gj_elim.cuh: warp path for R <= 32, block path above).
extern "C" int hinv_launch(const float* g0, const float* g1,
                           const uint8_t* mask, float* out, int B, int R,
                           void* stream) {
  return gj_launch<DividePivot>(HadamardLoad{g0, g1, mask, R}, out, B, R,
                                static_cast<cudaStream_t>(stream));
}

// The least shared memory of one apply block at (I, R), in bytes (one
// gramian slice); the wrapper holds it against the card's limit.
extern "C" long long apply_smem_bytes(int I, int R) {
  return apply_smem_floats(I, R, 1) * (long long)sizeof(float);
}

// g [B, I, R], hinv [B, R, R], iters/jk [B] int32 -> f [B, I, R],
// lam [B, R], gm [B, R, R] (rescaled). With err non-null (the last mode),
// also err [B] from x_norm [B] and the two other modes' rescaled gramians
// gram_a, gram_b [B, R, R] in mode order.
extern "C" int apply_launch(const float* g, const float* hinv,
                            const int32_t* iters, const int32_t* jk,
                            const float* x_norm, const float* gram_a,
                            const float* gram_b, float* f, float* lam,
                            float* gm, float* err, int B, int I, int R,
                            int zero_jk, void* stream) {
  if (R < 1 || R > MAX_R || I < 0) return (int)cudaErrorInvalidValue;
  const int optin = smem_optin();
  const int ns = gram_slices(I, R, optin);
  const size_t smem = (size_t)apply_smem_floats(I, R, ns) * sizeof(float);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  static size_t smem_set[MAX_DEVICES] = {};
  int code = allow_smem((const void*)apply_kernel, smem, smem_set);
  if (code) return code;
  apply_kernel<<<B, APPLY_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      g, hinv, iters, jk, x_norm, gram_a, gram_b, f, lam, gm, err, I, R, ns,
      zero_jk);
  return (int)cudaGetLastError();
}
