// Batched unpivoted Gauss-Jordan inverse of small SPD matrices for Hopper
// (sm_90a), shared by the normal inverse (fused_epilogue.cu) and the SPD
// inverse (spd_inverse.cu).
//
// The elimination is that of ops/update.py:gj_inverse and
// ops/spd_inverse.py:spd_inverse_plain: for each pivot j, row j of A and of
// the inverse V is scaled by the pivot, and every other row r becomes
// row_r - A[r][j] * (scaled row j), with A[r][j] read before the step
// changes anything. SPD pivots are positive Schur-complement diagonals, so
// nothing is pivoted. Two things differ between the callers and come in as
// template arguments:
// - the front end (Loader): the element (r, c) of model b's matrix, the
//   masked hadamard of the K = N - 1 other modes' gramians of an N-mode
//   tensor (HadamardLoad, padded_hadamard; 2 <= K <= MAX_GRAMS; K = 2 has
//   its own instantiation) or a plain load (PlainLoad);
// - the pivot arithmetic (Pivot): gj_inverse divides the row by the pivot
//   (__fdiv_rn, with zero numerators kept off its slow path: div_rn),
//   spd_inverse_plain takes one reciprocal and multiplies (__frcp_rn,
//   __fmul_rn), as the TPU kernels do.
// Every row update is __fmaf_rn(-colj, prow, a): the operation nvcc
// contracted `a - colj * prow` to in the kernels before this header, so the
// results are theirs bit for bit, and written as an intrinsic no choice of
// the compiler can change them.
//
// What bounds it: neither bytes nor arithmetic. At the engine's shapes
// (B = 32-320, R = 4-20) a call reads and writes well under 1 MB and does
// under 1 MFLOP, so the time is the chain of R dependent steps plus the
// launch. The design therefore keeps every step off shared memory and
// barriers where it can:
//
// - R <= 32, the warp path: one warp per model, MODELS_PER_BLOCK models per
//   block. Lane c holds column c of A and of V in registers (2R floats);
//   lanes c >= R hold zero columns and store nothing. A step shuffles column
//   j from lane j to every lane (R shuffles, all issued before any use),
//   scales the lane's own pivot-row entries of A and V, and updates every
//   other row with two FMAs. The rows are kept rotated (slot s holds row
//   (j + s) mod R at step j, the scaled pivot row moves to the last slot),
//   so every register index is a compile-time constant while the step loop
//   stays a loop: code size grows with R, not R^2, and after R steps the
//   rotation is back where it started. R is a template parameter,
//   instantiated for every R from 1 to 32. Loads and stores are row by
//   row, lane c at column c: coalesced. Every lane loads (lanes past R a
//   real column, dropped after), so that no branch holds a load: a load
//   under `c < R` waited for its data before the next row's was issued,
//   one memory latency per row. That and the division's slow path on zero
//   numerators (div_rn) were the two largest costs of the first version
//   (tools/probe_gj_elim.py measures both).
// - 32 < R <= 64, the block path: one block of BLOCK_THREADS per model,
//   thread (c, g) holding column c at rows g, g + ROW_GROUPS, ... in
//   registers. The pivot row of A and V and the pivot column of A are staged
//   in shared memory, double-buffered: the threads that update row j + 1 or
//   column j + 1 during step j write the new values into the other buffer,
//   so each step ends with one barrier, and no index is computed by a
//   division or a modulo. No bench bucket uses it (MAX_R = 64 is the
//   engine's limit).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int GJ_MAX_R = 64;
constexpr int WARP_MAX_R = 32;       // the warp path's largest R
constexpr int MODELS_PER_BLOCK = 4;  // warps (models) per block on the warp path
constexpr int BLOCK_COLS = 64;       // block path: threads per row group (columns)
constexpr int ROW_GROUPS = 8;        // block path: row groups
constexpr int BLOCK_THREADS = BLOCK_COLS * ROW_GROUPS;
constexpr int BLOCK_ROWS = GJ_MAX_R / ROW_GROUPS;  // rows a block-path thread holds
constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int MAX_GRAMS = 7;  // other-mode gramians of a normal matrix: tensors of up to 8 modes

// K gramian pointers, passed by value in a kernel's arguments: a CUDA graph
// that captures the launch keeps them, and no launch uploads anything.
struct GramSet {
  const float* g[MAX_GRAMS];
  int k;
};

// GramSet of the K pointers in the host array `grams` (the rest null).
inline GramSet gram_set(const float* const* grams, int k) {
  GramSet s = {};
  for (int q = 0; q < k && q < MAX_GRAMS; ++q) s.g[q] = grams[q];
  s.k = k;
  return s;
}

// Element e of the hadamard of the set's gramians, multiplied in mode order
// (hadamard_but_one): K = 2 is __fmul_rn(g0, g1). The loop is unrolled, so
// every pointer is read from the argument at a constant index. K > 0: the
// set holds exactly K gramians, known at compile time; K = 0: s.k of them.
// The 3-D normal inverse (K = 2) has its own instantiation, which loads as
// the two-pointer kernel did: through the K = 0 loop, with its test of s.k
// per element, it took 160 registers against 128 and read 0.0040 against
// 0.0032 ms at the bench-tier mix on an H100 (tools/probe_gj_elim.py).
template <int K>
__device__ __forceinline__ float hadamard_of(const GramSet& s, size_t e) {
  float h = __ldg(s.g[0] + e);
#pragma unroll
  for (int q = 1; q < (K > 0 ? K : MAX_GRAMS); ++q)
    if (K > 0 || q < s.k) h = __fmul_rn(h, __ldg(s.g[q] + e));
  return h;
}

enum GjPath { GJ_WARP = 0, GJ_BLOCK = 1 };

struct GjPlan {
  int path, blocks, threads;
};

// Which path, how many blocks and threads a batch of B models at rank R
// takes (ops/spd_inverse.py:gj_plan mirrors it).
inline GjPlan gj_plan(int B, int R) {
  if (R <= WARP_MAX_R)
    return {GJ_WARP, (B + MODELS_PER_BLOCK - 1) / MODELS_PER_BLOCK, 32 * MODELS_PER_BLOCK};
  return {GJ_BLOCK, B, BLOCK_THREADS};
}

// x / d, correctly rounded, as __fdiv_rn. The pivot rows are full of zeros
// (A's eliminated columns, V's columns not reached yet), and __fdiv_rn of a
// zero x takes the division's slow path: dividing them made the normal
// inverse twice as slow (tools/probe_gj_elim.py, variant fdiv). For a
// finite nonzero d, 0 / d is the signed zero, set here directly; every
// other x is divided.
__device__ __forceinline__ float div_rn(float x, float d) {
  const bool zero = x == 0.f && d != 0.f && fabsf(d) <= 3.402823466e38f;
  const float q = __fdiv_rn(zero ? 1.f : x, d);
  return zero ? __int_as_float((__float_as_int(x) ^ __float_as_int(d)) & 0x80000000) : q;
}

// gj_inverse: the pivot row divided by the pivot.
struct DividePivot {
  __device__ static void scale(float d, float a, float v, float& pa, float& pv) {
    pa = div_rn(a, d);
    pv = div_rn(v, d);
  }
};

// spd_inverse_plain: one reciprocal of the pivot, then products.
struct ReciprocalPivot {
  __device__ static void scale(float d, float a, float v, float& pa, float& pv) {
    const float rd = __frcp_rn(d);
    pa = __fmul_rn(a, rd);
    pv = __fmul_rn(v, rd);
  }
};

// The normal inverse's front end: padded_hadamard(g_0 * ... * g_{K-1}, mask),
// element (r, c) of model b (K as in hadamard_of). With the mask bits 0 or 1
// this is the masked product or the identity entry exactly.
template <int K>
struct HadamardLoad {
  GramSet grams;
  const uint8_t* mask;
  int R;
  __device__ float operator()(int b, int r, int c) const {
    const size_t e = ((size_t)b * R + r) * R + c;
    const float h = hadamard_of<K>(grams, e);
    const float mr = __ldg(mask + (size_t)b * R + r) ? 1.f : 0.f;
    const float mc = __ldg(mask + (size_t)b * R + c) ? 1.f : 0.f;
    const float eye = r == c ? 1.f : 0.f;
    return __fadd_rn(__fmul_rn(h, __fmul_rn(mr, mc)), __fmul_rn(eye, __fsub_rn(1.f, mc)));
  }
};

// The SPD inverse's front end: the batch as it is.
struct PlainLoad {
  const float* h;
  int R;
  __device__ float operator()(int b, int r, int c) const {
    return __ldg(h + ((size_t)b * R + r) * R + c);
  }
};

template <int R, class Pivot, class Loader>
__global__ void __launch_bounds__(32 * MODELS_PER_BLOCK)
gj_warp_kernel(Loader load, float* __restrict__ out, int B) {
  const int b = blockIdx.x * MODELS_PER_BLOCK + threadIdx.x / 32;
  if (b >= B) return;  // whole warps only: no shuffle loses a lane
  const int c = threadIdx.x % 32;
  const int cl = c < R ? c : R - 1;  // lanes past R load a real column, then drop it
  float a[R], v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) a[r] = load(b, r, cl);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    a[r] = c < R ? a[r] : 0.f;
    v[r] = r == c ? 1.f : 0.f;
  }
#pragma unroll 1
  for (int j = 0; j < R; ++j) {
    // Slot 0 holds row j. Lane j holds column j, read by every lane before
    // the step changes it: colj[0] is the pivot.
    float colj[R];
#pragma unroll
    for (int s = 0; s < R; ++s) colj[s] = __shfl_sync(FULL_WARP, a[s], j);
    float pa, pv;
    Pivot::scale(colj[0], a[0], v[0], pa, pv);
#pragma unroll
    for (int s = 1; s < R; ++s) {  // row (j + s) mod R moves to slot s - 1
      a[s - 1] = __fmaf_rn(-colj[s], pa, a[s]);
      v[s - 1] = __fmaf_rn(-colj[s], pv, v[s]);
    }
    a[R - 1] = pa;
    v[R - 1] = pv;
  }
  if (c < R) {
    float* o = out + (size_t)b * R * R + c;
#pragma unroll
    for (int r = 0; r < R; ++r) o[r * R] = v[r];
  }
}

template <class Pivot, class Loader>
__global__ void __launch_bounds__(BLOCK_THREADS)
gj_block_kernel(Loader load, float* __restrict__ out, int R) {
  __shared__ float arow[2][GJ_MAX_R], vrow[2][GJ_MAX_R], acol[2][GJ_MAX_R];
  const int b = blockIdx.x;
  const int c = threadIdx.x % BLOCK_COLS, g = threadIdx.x / BLOCK_COLS;
  const bool live = c < R;
  float a[BLOCK_ROWS], v[BLOCK_ROWS];
#pragma unroll
  for (int k = 0; k < BLOCK_ROWS; ++k) {  // every thread loads a real element: no branch holds a load
    const int r = g + ROW_GROUPS * k;
    a[k] = load(b, r < R ? r : R - 1, live ? c : R - 1);
  }
#pragma unroll
  for (int k = 0; k < BLOCK_ROWS; ++k) {
    const int r = g + ROW_GROUPS * k;
    a[k] = live && r < R ? a[k] : 0.f;
    v[k] = r == c ? 1.f : 0.f;
    if (live && r == 0) {
      arow[0][c] = a[k];
      vrow[0][c] = v[k];
    }
    if (c == 0 && r < R) acol[0][r] = a[k];
  }
  __syncthreads();
  for (int j = 0; j < R; ++j) {
    const int p = j & 1, q = p ^ 1;
    float pa = 0.f, pv = 0.f;
    if (live) Pivot::scale(arow[p][j], arow[p][c], vrow[p][c], pa, pv);
#pragma unroll
    for (int k = 0; k < BLOCK_ROWS; ++k) {
      const int r = g + ROW_GROUPS * k;
      if (!live || r >= R) continue;
      if (r == j) {
        a[k] = pa;
        v[k] = pv;
      } else {
        const float colj = acol[p][r];
        a[k] = __fmaf_rn(-colj, pa, a[k]);
        v[k] = __fmaf_rn(-colj, pv, v[k]);
      }
      if (r == j + 1) {  // the next step's pivot row
        arow[q][c] = a[k];
        vrow[q][c] = v[k];
      }
      if (c == j + 1) acol[q][r] = a[k];  // and its pivot column
    }
    __syncthreads();
  }
  if (live) {
    float* o = out + (size_t)b * R * R + c;
#pragma unroll
    for (int k = 0; k < BLOCK_ROWS; ++k) {
      const int r = g + ROW_GROUPS * k;
      if (r < R) o[r * R] = v[k];
    }
  }
}

template <int R, class Pivot, class Loader>
void launch_warp(const Loader& load, float* out, int B, int r, int blocks, cudaStream_t s) {
  if (r == R) {
    gj_warp_kernel<R, Pivot, Loader><<<blocks, 32 * MODELS_PER_BLOCK, 0, s>>>(load, out, B);
  } else if constexpr (R > 1) {
    launch_warp<R - 1, Pivot, Loader>(load, out, B, r, blocks, s);
  }
}

// H^-1 of the B matrices `load` gives, into out [B, R, R], on stream s.
template <class Pivot, class Loader>
int gj_launch(const Loader& load, float* out, int B, int R, cudaStream_t s) {
  if (R < 1 || R > GJ_MAX_R || B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const GjPlan p = gj_plan(B, R);
  if (p.path == GJ_WARP)
    launch_warp<WARP_MAX_R, Pivot, Loader>(load, out, B, R, p.blocks, s);
  else
    gj_block_kernel<Pivot, Loader><<<p.blocks, p.threads, 0, s>>>(load, out, R);
  return (int)cudaGetLastError();
}

}  // namespace
