// Batched inverse of small SPD matrices for Hopper (sm_90a).
//
// Replaces cp_cals_tpu/ops/pallas_solve.py:_gj_kernel: H^-1 per model of a
// [B, R, R] float32 batch by unpivoted Gauss-Jordan elimination, one
// reciprocal of the pivot per step and then products (the TPU kernel's
// arithmetic, ops/spd_inverse.py:spd_inverse_plain). No pivoting: SPD pivots
// are positive Schur-complement diagonals. The engine's padded slots already
// carry identity rows and columns (ops/update.py:padded_hadamard), so
// nothing is padded here.
//
// It is the elimination of gj_elim.cuh, which says what bounds it and what
// its design does about that, behind a plain load: one warp per model with
// the matrix in registers for R <= 32 (J2 and J3: R = 8 and 5), one block
// per model above.

#include <cuda_runtime.h>

#include "gj_elim.cuh"

// h [B, R, R] float32 -> out [B, R, R].
extern "C" int spd_inverse_launch(const float* h, float* out, int B, int R,
                                  void* stream) {
  return gj_launch<ReciprocalPivot>(PlainLoad{h, R}, out, B, R,
                                    static_cast<cudaStream_t>(stream));
}

// The launch plan of both inverses at (B, R): returns the path (0 warp,
// 1 block) and writes the grid's blocks and threads per block;
// ops/spd_inverse.py:gj_plan is held equal to it.
extern "C" int gj_plan_of(int B, int R, int* blocks, int* threads) {
  const GjPlan p = gj_plan(B, R);
  *blocks = p.blocks;
  *threads = p.threads;
  return p.path;
}
