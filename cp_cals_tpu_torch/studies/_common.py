"""What the four studies share: the output directory, the JAX package's
committed float64 oracles, the baseline CPU rate, and the device line."""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ..ktensor import random_ktensor_host

from ..utils.analysis import DEFAULT_BENCH_DIR

# Where every study writes (git-ignored), and where benchmark_dashboard reads.
OUT_DIR = DEFAULT_BENCH_DIR

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# The JAX package's float64 oracles, run on the CPU ("device": "TFRT_CPU_0").
# Only these files of data/benchmarks/ are read: the others hold a TPU's
# numbers.
ORACLE_DIR = os.path.join(ROOT, "data", "benchmarks")
ORACLE_FILES = (
    "convergence_f64.json",
    "bench_tol_f64.json",
    "jk_fidelity_base.npz",
    "jk_fidelity_f64.npz",
    "external_cpd.json",
)

# The modelled effective FLOP rate of the reference's 32-core MKL machine,
# copied from bench.py:50 (bench.py imports jax).
BASELINE_CPU_FLOPS = 1.2e12


def committed_oracle_path(name: str) -> str:
    if name not in ORACLE_FILES:
        raise ValueError(f"{name!r} is not one of the committed float64 oracles {ORACLE_FILES}")
    return os.path.join(ORACLE_DIR, name)


def committed_oracle(name: str):
    """A committed float64 oracle: a JSON file as a dict, an ``.npz`` as a
    dict of arrays. Of ``external_cpd.json`` only the float64 contenders
    (the ``*_fp64`` rows; the file's float32 row ran on a TPU)."""
    path = committed_oracle_path(name)
    if name.endswith(".npz"):
        return load_npz(path)
    out = load_json(path)
    if name == "external_cpd.json":
        out["contenders"] = {k: v for k, v in out["contenders"].items() if k.endswith("_fp64")}
    return out


def oracle_source(name: str, out_dir: str, committed: bool = True) -> str | None:
    """The float64 reference of a comparison: the port's own oracle in
    ``out_dir`` where a ``--oracle`` run wrote it, else (with
    ``committed``: the run is at the committed oracle's workload) the
    committed JAX one, else None."""
    own = os.path.join(out_dir, name)
    if os.path.exists(own):
        return own
    return committed_oracle_path(name) if committed else None


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_npz(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def best_of(x, queue, params, device, reps: int, warm: bool = True) -> tuple:
    """``precompile_buckets`` and an untimed ``cp_cals`` (with ``warm``),
    then the best wall of ``reps`` timed runs: (results, report, wall) of
    the last."""
    from ..solvers import cp_cals
    from ..solvers.cals import precompile_buckets

    if warm:
        precompile_buckets(x, queue, params, device=device)
        cp_cals(x, queue, params, device=device)
    wall = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        results, rep = cp_cals(x, queue, params, device=device)
        wall = min(wall, time.perf_counter() - t0)
    return results, rep, wall


def write_json(out_dir: str, name: str, obj) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    return path



# NumPy's float32 reductions sum each buffer of BUFSIZE elements pairwise
# (8-way unrolled blocks of at most 128) and add the buffers in order.
BUFSIZE = 8192


def _pairwise_f32(a: np.ndarray) -> np.float32:
    """NumPy 2.0's pairwise sum of one float32 buffer (``pairwise_sum`` of
    its ``loops_utils.h``), element by element."""
    n = a.size
    if n < 8:
        res = np.float32(-0.0)
        for v in a:
            res = np.float32(res + v)
        return res
    if n <= 128:
        m = n - n % 8
        acc = a[:8].copy()
        for row in a[8:m].reshape(-1, 8):
            acc += row
        res = ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]))
        for v in a[m:]:
            res = np.float32(res + v)
        return np.float32(res)
    n2 = n // 2
    n2 -= n2 % 8
    return np.float32(_pairwise_f32(a[:n2]) + _pairwise_f32(a[n2:]))


def sum_f32(flat: np.ndarray) -> np.float32:
    """``np.sum`` of a contiguous float32 vector as NumPy 2.0 computes it:
    each full buffer's pairwise tree (64 blocks of 128) at once, then the
    buffers added in order."""
    full = flat.size // BUFSIZE
    parts = []
    if full:
        blocks = flat[: full * BUFSIZE].reshape(full, BUFSIZE // 128, 16, 8)
        acc = blocks[:, :, 0, :].copy()
        for k in range(1, 16):
            acc += blocks[:, :, k, :]
        s = ((acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])) + (
            (acc[..., 4] + acc[..., 5]) + (acc[..., 6] + acc[..., 7]))
        while s.shape[1] > 1:
            s = s[:, 0::2] + s[:, 1::2]
        parts = list(s[:, 0])
    if flat.size % BUFSIZE:
        parts.append(_pairwise_f32(flat[full * BUFSIZE:]))
    return np.add.accumulate(np.array(parts, np.float32))[-1]


def std_f32(x: np.ndarray) -> np.float32:
    """``x.std()`` of a float32 array as NumPy 2.0 computes it. NumPy 2.3
    sums float32 in another order (the bench tensor's std moves by 2e-7),
    and the committed oracles were made from this one."""
    flat = np.ascontiguousarray(x, np.float32).ravel()
    n = np.float32(flat.size)
    d = flat - np.float32(sum_f32(flat) / n)
    return np.sqrt(np.float32(sum_f32(d * d) / n))


def bench_tensor(rng, modes) -> np.ndarray:
    """The bench workload's tensor as the JAX scripts draw it from ``rng``
    (a float32 rank-5 model plus 5 % noise, float64), the same bits on any
    NumPy version: the model's elementwise products in their order, its
    std as NumPy 2.0 computes it, the noise scale in float32 (NumPy 2's
    promotion)."""
    kt = random_ktensor_host(rng, modes, 5, dtype=np.float32)
    a, b, c = kt.factors
    x = np.zeros(tuple(modes), np.float32)
    for r in range(kt.rank):
        x += a[:, None, None, r] * b[None, :, None, r] * c[None, None, :, r] * kt.lam[r]
    return x + np.float32(0.05) * std_f32(x) * rng.standard_normal(x.shape)
