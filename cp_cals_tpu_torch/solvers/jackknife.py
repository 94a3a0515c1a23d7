"""Jackknife resampling of CP decompositions (port of
``cp_cals_tpu/solvers/jackknife.py``).

* ``jk_cp_cals``: every leave-one-sample-out refit in ONE concurrent CALS
  run against the FULL tensor, with one row of the mode-0 factor re-zeroed
  after every mode-0 update (no subsampled tensor copies), then rescaled
  and column-matched to the fitted model by LSAP.
* ``jk_cp_batched_als``: the same through the task-parallel baseline, one
  exact-rank bucket per fitted model.
* ``jk_cp_als``: the oracle, one ALS fit per replicate on the explicit
  (I-1)-row subtensor.
* ``jackknife_norms``: per-fiber leave-one-out tensor norms as one device
  reduction.

Every driver takes ``device`` (None means the CUDA card, "cpu" the plain
PyTorch versions) and returns host NumPy replicates. ``jk_cp_cals`` calls
``precompile_buckets`` before its timed engine run, as the JAX package
does: ``solver_time`` excludes it, ``pre_time`` holds it, and a repeated
call in one process warms nothing anew.

``jk_cp_cals``'s spans (``utils/timers.py``): ``jk.prepare`` (the fitted
models to the host, the replicate queue), ``jk.precompile``
(``precompile_buckets``), ``jk.engine`` (the ``cp_cals`` call),
``jk.rescale`` and ``jk.lsap`` (per fitted model). ``pre_time`` is
``jk.prepare`` + ``jk.precompile`` and ``solver_time`` ``jk.engine``.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import AlsParams, CalsParams
from ..device import resolve_device
from ..ktensor import Ktensor, jk_to_regular
from ..utils import timers
from ..utils.lsap import solve_lsap
from .als import cp_als
from .cals import CalsReport, _to_numpy, cp_cals, precompile_buckets


def jackknife_norms(x: torch.Tensor) -> torch.Tensor:
    """norms[i] = |X with mode-0 fiber i removed|, in x's dtype.

    One squared-sum reduction over all non-leading axes and a total, in
    float64 (the subtraction is cancellation-prone), clamped at zero: when
    one fiber holds nearly all the energy, rounding can drive the
    difference slightly negative, and a NaN norm would poison the replicate.
    """
    x64 = x.to(torch.float64)
    row_sq = torch.sum(x64 * x64, dim=tuple(range(1, x.ndim)))
    total = torch.sum(row_sq)
    return torch.sqrt(torch.clamp(total - row_sq, min=0.0)).to(x.dtype)


def generate_jk_ktensors(kt: Ktensor) -> list[tuple[Ktensor, int]]:
    """One replicate per mode-0 fiber, tagged with its left-out fiber. The
    fiber row is NOT zeroed here: the solver zeroes it after each mode-0
    update, as the reference does."""
    i0 = kt.factors[0].shape[-2]
    if i0 <= 1:
        raise ValueError("can't jackknife with a single sample")
    return [(kt, i) for i in range(i0)]


def jk_permutation_adjustment(kt_ref: Ktensor, replicates: list[Ktensor]) -> list[Ktensor]:
    """Permute each replicate's columns to best match the reference model.

    Score M = sum over the modes other than the jackknifed mode 0 of
    U_ref^T U_m (mode 0's factor carries the NaN fiber row), maximized by
    LSAP on the host.
    """
    refs = [np.asarray(f) for f in kt_ref.factors[1:]]
    out = []
    for kt in replicates:
        m = sum(fr.T @ np.asarray(fm) for fr, fm in zip(refs, kt.factors[1:]))
        perm = solve_lsap(m, maximize=True)
        factors = tuple(f[..., perm] for f in kt.factors)
        out.append(Ktensor(factors, kt.lam[..., perm]))
    return out


@dataclass
class JKReport:
    pre_time: float = 0.0
    solver_time: float = 0.0
    results: list = field(default_factory=list)  # [model][fiber] -> Ktensor
    cals_report: CalsReport | None = None


def _rescale_replicate(kt: Ktensor, fiber: int) -> Ktensor:
    """Zero the fiber row, renormalize, then NaN the fiber row (reference
    cals.cpp:431-437). Host math: O(I*R) per replicate."""
    factors = [np.array(f) for f in kt.factors]
    lam = np.array(kt.lam)
    factors[0][..., fiber, :] = 0.0
    factors[0] = factors[0] * lam  # denormalize: fold lam into factor 0
    new_lam = np.ones_like(lam)
    for i, f in enumerate(factors):
        coeff = np.linalg.norm(f, axis=-2)
        safe = np.where(coeff != 0, coeff, 1.0)
        factors[i] = f / safe
        new_lam = new_lam * coeff
    factors[0][..., fiber, :] = np.nan
    return Ktensor(tuple(factors), new_lam)


def to_host_model(kt: Ktensor) -> Ktensor:
    """normalize_full(denormalize(kt)) on the host after one fetch."""
    factors = [_to_numpy(f) for f in kt.factors]
    lam0 = _to_numpy(kt.lam)
    factors[0] = factors[0] * lam0[..., None, :]
    lam = np.ones_like(lam0)
    new = []
    for f in factors:
        coeff = np.linalg.norm(f, axis=-2)
        safe = np.where(coeff != 0, coeff, 1.0)
        new.append(f / safe[..., None, :])
        lam = lam * coeff
    return Ktensor(tuple(new), lam)


def _pin_jk_fidelity(params: CalsParams, dev: torch.device) -> CalsParams:
    """The statistics-fidelity defaults of jackknife runs; explicit settings
    are honoured. Both rest on the jackknife standard-error study
    (``studies/jk_fidelity_study.py``): on an NVIDIA H100 (700 W) the p99
    over parameters of the float32 SE error over the jackknife scatter, by
    mode, read 0.003 / 0.008 / 0.054 at "high" with both pins
    (``f32_high``), 0.025 / 0.061 / 0.292 on the unfused epilogue
    (``f32_high_xla``) and 0.039 / 0.134 / 0.636 with the dimension tree
    (``f32_high_dimtree``; PERF.md §6, "Fidelity on the H100").

    - dimtree "auto" -> "off": the shared-TTM reduction order moves the
      bands. (The port's "auto" is off already, ``config.resolve_dimtree``;
      the pin keeps jackknife runs off should that rule change.)
    - epilogue "auto" -> "fused" on the card with the Gauss-Jordan solve
      only: a non-GJ solve_method must not be replaced by the kernels'
      Gauss-Jordan inverse. (The JAX package pins "fused" on the TPU only.)
      The iteration still takes the fused kernels mode by mode, only where
      ``ops/fused_epilogue.py:supports_fused_epilogue`` says they take the
      mode's shape, as the JAX iteration does.
    """
    if params.dimtree == "auto":
        params = dataclasses.replace(params, dimtree="off")
    if params.epilogue == "auto" and params.solve_method == "gj" and dev.type == "cuda":
        params = dataclasses.replace(params, epilogue="fused")
    return params


def jk_cp_cals(
    x,
    fitted: list[Ktensor],
    params: CalsParams = CalsParams(),
    checkpoint_dir: str | None = None,
    resume: bool = False,
    mesh=None,
    shard_mode0: bool = False,
    device=None,
) -> JKReport:
    """Jackknife every fitted model via ONE concurrent CALS run on the full
    tensor (reference cals.cpp:397-446). ``checkpoint_dir``/``resume`` go
    to ``cp_cals`` (the replicate queue is deterministic from ``fitted``,
    so a resumed call with the same inputs continues exactly);
    ``mesh``/``shard_mode0`` too: the replicates split over dp (the
    jackknife is data parallel over replicates) and mode 0 over tp, each
    rank of the mesh calling with the same arguments and getting every
    replicate. With a mesh the run is on its device."""
    dev = mesh.device if mesh is not None and device is None else resolve_device(device)
    tot = timers.Totals()
    with tot.span("jk.prepare"):
        params = _pin_jk_fidelity(params, dev)
        fitted = [to_host_model(kt) for kt in fitted]
        queue: list[Ktensor] = []
        fibers: list[int] = []
        spans: list[tuple[int, int]] = []
        for kt in fitted:
            reps = generate_jk_ktensors(kt)
            spans.append((len(queue), len(queue) + len(reps)))
            for kt_rep, fiber in reps:
                queue.append(kt_rep)
                fibers.append(fiber)
    # What the first engine call pays for, outside the timed run.
    with tot.span("jk.precompile"):
        precompile_buckets(x, queue, params, has_jk=True, mesh=mesh, shard_mode0=shard_mode0, device=dev)
    with tot.span("jk.engine"):
        results, cals_rep = cp_cals(
            x, queue, params, jk_fibers=fibers, device=dev, mesh=mesh, shard_mode0=shard_mode0,
            checkpoint_dir=checkpoint_dir, resume=resume,
        )
    report = JKReport(pre_time=tot.seconds("jk.prepare") + tot.seconds("jk.precompile"),
                      solver_time=tot.seconds("jk.engine"), cals_report=cals_rep)
    for kt_ref, (lo, hi) in zip(fitted, spans):
        with tot.span("jk.rescale"):
            reps = [_rescale_replicate(results[i], fibers[i]) for i in range(lo, hi)]
        with tot.span("jk.lsap"):
            report.results.append(jk_permutation_adjustment(kt_ref, reps))
    return report


def jk_cp_batched_als(x, fitted: list[Ktensor], params: AlsParams = AlsParams(), device=None) -> JKReport:
    """Jackknife via the batched-ALS baseline (reference ``jk_cp_omp_als``,
    als.cpp:415-501): a model's replicates share its rank, so they run as
    one exact-rank bucket of the concurrent engine against the FULL tensor
    with masked fibers. ``cals_report`` merges the engine runs' reports
    (model ids count within each fitted model's run)."""
    dev = resolve_device(device)
    # Every AlsParams field that CalsParams shares carries over.
    cals_fields = {f.name for f in dataclasses.fields(CalsParams)}
    shared = {f.name: getattr(params, f.name) for f in dataclasses.fields(params) if f.name in cals_fields}
    report = JKReport(cals_report=CalsReport())
    for kt_ref in fitted:
        t0 = time.perf_counter()
        kt_host = to_host_model(kt_ref)
        reps = generate_jk_ktensors(kt_host)
        queue = [k for k, _ in reps]
        fibers = [f for _, f in reps]
        p = _pin_jk_fidelity(CalsParams(**shared, bucket_ranks=(kt_host.rank,)), dev)
        t1 = time.perf_counter()
        report.pre_time += t1 - t0
        results, rep = cp_cals(x, queue, p, jk_fibers=fibers, device=dev)
        report.solver_time += time.perf_counter() - t1
        merged = report.cals_report
        merged.n_ktensors += rep.n_ktensors
        merged.ktensor_comp_sum += rep.ktensor_comp_sum
        merged.models.extend(rep.models)
        for r, n in rep.engine_iterations.items():
            merged.engine_iterations[r] = merged.engine_iterations.get(r, 0) + n
        for r, counts in rep.loop_counts.items():
            into = merged.loop_counts.setdefault(r, dict.fromkeys(counts, 0))
            for k, v in counts.items():
                into[k] += v
        out = [_rescale_replicate(kt, f) for kt, f in zip(results, fibers)]
        report.results.append(jk_permutation_adjustment(kt_host, out))
    return report


def jk_cp_als(x, fitted: list[Ktensor], params: AlsParams = AlsParams(), device=None) -> JKReport:
    """Oracle jackknife: one ALS fit per replicate on the explicit (I-1)-row
    subtensor (reference als.cpp:291-387). O(I * |X|) extra traffic: for
    testing."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    fitted = [to_host_model(kt) for kt in fitted]
    x_np = _to_numpy(x)
    report = JKReport()
    t1 = time.perf_counter()
    for kt_ref in fitted:
        reps = []
        for fiber in range(kt_ref.factors[0].shape[-2]):
            x_jk = np.delete(x_np, fiber, axis=0)
            kt0 = jk_to_regular(kt_ref, fiber)
            kt_fit, _ = cp_als(x_jk, kt0, params, device=dev)
            kt_fit = to_host_model(kt_fit)
            # Re-insert a NaN row at the fiber so the shapes match
            # jk_cp_cals's replicates (reference cals.cpp:431-437).
            f0 = np.insert(kt_fit.factors[0], fiber, np.nan, axis=0)
            reps.append(Ktensor((f0,) + tuple(kt_fit.factors[1:]), kt_fit.lam))
        report.results.append(jk_permutation_adjustment(kt_ref, reps))
    report.pre_time = t1 - t0
    report.solver_time = time.perf_counter() - t1
    return report
