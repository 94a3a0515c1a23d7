// Rectangular linear sum assignment via shortest augmenting paths
// (Crouse 2016, DOI 10.1109/TAES.2016.140952).
//
// A copy of the JAX package's native solver (cp_cals_tpu/native/lsap.cpp),
// the equivalent of the one the reference vendors from SciPy, for the
// jackknife's column matching (R x R score matrices, on the host). Exposed
// through a C ABI for ctypes.
//
// Built with g++ at first use by cp_cals_tpu_torch/native/__init__.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

// Returns 0 on success, -1 if the problem is infeasible.
int lsap_impl(int64_t nr, int64_t nc, const double *cost, int64_t *col4row) {
  std::vector<double> u(nr, 0.0), v(nc, 0.0);
  std::vector<double> shortest(nc);
  std::vector<int64_t> path(nc), row4col(nc, -1);
  std::vector<char> done(nc);
  std::vector<int64_t> scanned;
  std::fill(col4row, col4row + nr, int64_t{-1});

  const double inf = std::numeric_limits<double>::infinity();

  for (int64_t cur = 0; cur < nr; ++cur) {
    std::fill(shortest.begin(), shortest.end(), inf);
    std::fill(path.begin(), path.end(), int64_t{-1});
    std::fill(done.begin(), done.end(), char{0});
    scanned.clear();

    double min_val = 0.0;
    int64_t i = cur, sink = -1;
    while (sink == -1) {
      scanned.push_back(i);
      int64_t jmin = -1;
      double lowest = inf;
      for (int64_t j = 0; j < nc; ++j) {
        if (done[j]) continue;
        double r = min_val + cost[i * nc + j] - u[i] - v[j];
        if (r < shortest[j]) {
          shortest[j] = r;
          path[j] = i;
        }
        if (shortest[j] < lowest ||
            (shortest[j] == lowest && row4col[j] == -1)) {
          lowest = shortest[j];
          jmin = j;
        }
      }
      if (jmin == -1 || lowest == inf) return -1;
      min_val = lowest;
      done[jmin] = 1;
      if (row4col[jmin] == -1)
        sink = jmin;
      else
        i = row4col[jmin];
    }

    u[cur] += min_val;
    for (int64_t s : scanned)
      if (s != cur) u[s] += min_val - shortest[col4row[s]];
    for (int64_t j = 0; j < nc; ++j)
      if (done[j]) v[j] -= min_val - shortest[j];

    int64_t j = sink;
    for (;;) {
      int64_t i2 = path[j];
      row4col[j] = i2;
      std::swap(col4row[i2], j);
      if (i2 == cur) break;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// cost is row-major [nr x nc], nr <= nc required (caller transposes).
// col4row out: length nr. maximize != 0 flips the objective.
int solve_lsap(int64_t nr, int64_t nc, const double *cost, int maximize,
               int64_t *col4row) {
  if (nr > nc) return -2;
  if (!maximize) return lsap_impl(nr, nc, cost, col4row);
  std::vector<double> neg(static_cast<size_t>(nr) * nc);
  for (size_t k = 0; k < neg.size(); ++k) neg[k] = -cost[k];
  return lsap_impl(nr, nc, neg.data(), col4row);
}

}  // extern "C"
