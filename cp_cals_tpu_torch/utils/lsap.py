"""Rectangular linear sum assignment (shortest augmenting path).

Port of ``cp_cals_tpu/utils/lsap.py``'s NumPy solver (Crouse 2016, DOI
10.1109/TAES.2016.140952, the solver the reference vendors from SciPy),
used only for the jackknife's column matching on small R x R score
matrices. ``solve_lsap`` runs the native C++ solver (``native/lsap.cpp``,
built at first use; a failed build raises), as the JAX package's does;
``solve_lsap_py`` is its plain NumPy version.
"""

from __future__ import annotations

import numpy as np

from ..native.lsap_native import solve_lsap  # noqa: F401  (the solver the jackknife runs)


def solve_lsap_py(cost: np.ndarray, maximize: bool = False) -> np.ndarray:
    """The NumPy solver (the plain version of ``solve_lsap``)."""
    cost = np.asarray(cost, dtype=np.float64)
    if maximize:
        cost = -cost
    nr, nc = cost.shape
    transposed = nr > nc
    if transposed:
        cost = cost.T
        nr, nc = nc, nr

    u = np.zeros(nr)
    v = np.zeros(nc)
    col4row = np.full(nr, -1, dtype=np.int64)
    row4col = np.full(nc, -1, dtype=np.int64)

    for cur_row in range(nr):
        # Dijkstra-style search for the shortest augmenting path from cur_row.
        shortest = np.full(nc, np.inf)
        path = np.full(nc, -1, dtype=np.int64)
        done_cols = np.zeros(nc, dtype=bool)
        scanned_rows: list[int] = []
        min_val = 0.0
        i = cur_row
        sink = -1
        while sink == -1:
            scanned_rows.append(i)
            red = min_val + cost[i] - u[i] - v
            upd = ~done_cols & (red < shortest)
            shortest[upd] = red[upd]
            path[upd] = i
            masked = np.where(done_cols, np.inf, shortest)
            j = int(np.argmin(masked))
            min_val = masked[j]
            if not np.isfinite(min_val):
                raise ValueError("infeasible assignment problem")
            done_cols[j] = True
            if row4col[j] == -1:
                sink = j
            else:
                i = int(row4col[j])
        # Dual updates.
        u[cur_row] += min_val
        for i2 in scanned_rows:
            if i2 != cur_row:
                u[i2] += min_val - shortest[col4row[i2]]
        v[done_cols] -= min_val - shortest[done_cols]
        # Augment along the alternating path.
        j = sink
        while True:
            i2 = int(path[j])
            row4col[j] = i2
            col4row[i2], j = j, col4row[i2]
            if i2 == cur_row:
                break

    if transposed:
        # col4row maps the transposed rows (original columns) to original
        # rows; invert it to original row -> original column.
        inv = np.full(nc, -1, dtype=np.int64)
        for r, c in enumerate(col4row):
            inv[c] = r
        return inv
    return col4row
