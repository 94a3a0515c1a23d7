// Independent C++/OpenMP MTTKRP: the host yardstick of the MTTKRP routes
// (a copy of cp_cals_tpu/native/mttkrp_ref.cpp; bound by
// native/mttkrp_native.py).
//
// Written directly from the definition, G(i_n, c) = sum over the other
// indices of X[i0,i1,i2] * prod_{m != n} F_m[i_m, c], with OpenMP over the
// output rows and vectorizable inner loops over the rank axis: per-mode
// fused loops, no Khatri-Rao workspace.
//
// Layout contract (matches NumPy C-order): X is [I0, I1, I2] row-major,
// factors are [I_m, R] row-major, out is [I_mode, R] row-major and is
// zero-initialized by the caller.

#include <cstddef>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

void mttkrp3_f64(const double *x, int64_t i0, int64_t i1, int64_t i2,
                 const double *f0, const double *f1, const double *f2,
                 int64_t r, int mode, double *out) {
  if (mode == 0) {
    // out[a, c] += X[a, b, d] * f1[b, c] * f2[d, c]; X reads are linear
    // within each (a) slab, rows of out are thread-private by the loop.
#pragma omp parallel for schedule(static)
    for (int64_t a = 0; a < i0; ++a) {
      double *oa = out + a * r;
      const double *xa = x + a * i1 * i2;
      for (int64_t b = 0; b < i1; ++b) {
        const double *w = f1 + b * r;
        const double *xb = xa + b * i2;
        for (int64_t d = 0; d < i2; ++d) {
          const double xv = xb[d];
          const double *v = f2 + d * r;
          for (int64_t c = 0; c < r; ++c) oa[c] += xv * w[c] * v[c];
        }
      }
    }
  } else if (mode == 1) {
    // out[b, c] += X[a, b, d] * f0[a, c] * f2[d, c]; parallel over b keeps
    // out rows private; X reads are contiguous d-runs.
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < i1; ++b) {
      double *ob = out + b * r;
      for (int64_t a = 0; a < i0; ++a) {
        const double *w = f0 + a * r;
        const double *xb = x + (a * i1 + b) * i2;
        for (int64_t d = 0; d < i2; ++d) {
          const double xv = xb[d];
          const double *v = f2 + d * r;
          for (int64_t c = 0; c < r; ++c) ob[c] += xv * w[c] * v[c];
        }
      }
    }
  } else {
    // out[d, c] += X[a, b, d] * f0[a, c] * f1[b, c]. The output mode is
    // the innermost (contiguous) X axis, so every thread scans its own
    // a-slabs linearly and accumulates into a private [i2, r] buffer;
    // buffers are reduced at the end (the reference's OpenMP two-phase
    // reduction idea applied to a different decomposition).
#ifdef _OPENMP
    const int nt = omp_get_max_threads();
#else
    const int nt = 1;
#endif
    std::vector<std::vector<double>> locals(
        (std::size_t)nt, std::vector<double>((std::size_t)(i2 * r), 0.0));
#pragma omp parallel
    {
#ifdef _OPENMP
      const int t = omp_get_thread_num();
#else
      const int t = 0;
#endif
      double *loc = locals[(std::size_t)t].data();
      std::vector<double> wt((std::size_t)r);
#pragma omp for schedule(static)
      for (int64_t a = 0; a < i0; ++a) {
        const double *u = f0 + a * r;
        for (int64_t b = 0; b < i1; ++b) {
          const double *v = f1 + b * r;
          for (int64_t c = 0; c < r; ++c) wt[(std::size_t)c] = u[c] * v[c];
          const double *xb = x + (a * i1 + b) * i2;
          for (int64_t d = 0; d < i2; ++d) {
            const double xv = xb[d];
            double *od = loc + d * r;
            for (int64_t c = 0; c < r; ++c) od[c] += xv * wt[(std::size_t)c];
          }
        }
      }
    }
    for (int t = 0; t < nt; ++t) {
      const double *loc = locals[(std::size_t)t].data();
      for (int64_t e = 0; e < i2 * r; ++e) out[e] += loc[e];
    }
  }
}

}  // extern "C"
