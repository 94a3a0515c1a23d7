"""Single-model and batched CP-ALS drivers (port of ``cp_cals_tpu/solvers/als.py``).

``cp_batched_als`` fits many same-rank models in one batch (the reference's
task-parallel baseline): all models iterate in lock step until every one
has converged, and a converged model is frozen by a select, so each
trajectory is the one ``cp_als`` would give it. ``cp_als`` runs one model
through the unbatched iteration, as the JAX package does, which runs it
as a batch of one through the batched iteration, so on the card it goes
through the kernels. Both loop on the host with one small fetch per
iteration (the JAX package runs a device ``while_loop``; a captured ALS
loop is ROADMAP queue 1 item 3), stop per iteration or by the mixed-tier check
(``tol_check_interval``), take tensors of any order, and return host NumPy
Ktensors, fetched once at the end.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..config import AlsParams, UpdateMethod, check_supported
from ..device import resolve_device
from ..ktensor import Ktensor
from .cals import _DTYPES, _norms, _queue_dtype, _to_numpy
from .iteration import make_iteration
from .state import init_state, tree_map, tree_where


@dataclass
class AlsReport:
    """Per-fit metadata."""

    iters: int
    fit: float
    approx_error: float
    converged: bool


def _run(x, kt_b: Ktensor, params: AlsParams, dev, jk_fiber=None, x_norm_model=None, batched: bool = True):
    """Lock-step ALS of a [B]-batched host Ktensor until every model has
    converged; converged models are frozen. With ``batched=False`` one model
    without the batch axis, through the unbatched iteration. Returns the
    final state with every leaf on the host (NumPy)."""
    check_supported(params)
    np_dtype = _queue_dtype([kt_b])
    dt = _DTYPES[np_dtype]
    x = torch.as_tensor(x).to(device=dev, dtype=dt).contiguous()
    shapes = tuple(int(f.shape[-2]) for f in kt_b.factors)
    if shapes != tuple(x.shape):
        raise ValueError(f"model factor leading dims {shapes} do not match tensor shape {tuple(x.shape)}")
    x_norm, _ = _norms(x, False)
    kt = Ktensor(
        tuple(torch.as_tensor(_to_numpy(f), device=dev, dtype=dt).contiguous() for f in kt_b.factors),
        torch.as_tensor(_to_numpy(kt_b.lam), device=dev, dtype=dt),
    )
    has_jk = jk_fiber is not None and int(jk_fiber) >= 0
    state = init_state(kt, x_norm, jk_fiber=jk_fiber, x_norm_model=x_norm_model,
                       nnls=params.update_method == UpdateMethod.NNLS,
                       line_search=params.line_search, mixed_tol=params.tol_check_interval > 0)
    iteration = make_iteration(params, batched=batched, has_jk=has_jk)
    prepared = iteration.prepare(x)
    while not bool(state.converged.all()):
        new = iteration(x, state, x_norm, prepared)
        state = tree_where(state.converged, state, new)
    return tree_map(lambda t: t.cpu().numpy(), state)


def _report(state, i) -> AlsReport:
    """Model ``i`` of a final host state (``()`` for an unbatched state)."""
    return AlsReport(
        iters=int(state.iters[i]), fit=float(state.fit[i]),
        approx_error=float(state.approx_error[i]), converged=bool(state.converged[i]),
    )


def cp_als(
    x,
    kt0: Ktensor,
    params: AlsParams = AlsParams(),
    jk_fiber: int = -1,
    x_norm_model=None,
    device=None,
) -> tuple[Ktensor, AlsReport]:
    """Fit one CP model to ``x``. Returns the fitted (normalized) model as a
    host NumPy Ktensor and its report.

    jk_fiber >= 0 runs the jackknife variant against the FULL tensor: the
    fiber's row of factor 0 is re-zeroed after every mode-0 update, and the
    error uses the leave-one-out norm ``x_norm_model`` (the full norm when
    None). device: None means the CUDA card (raises without one); pass
    "cpu" to run the plain PyTorch versions of the kernels.
    """
    dev = resolve_device(device)
    kt = Ktensor(tuple(_to_numpy(f) for f in kt0.factors), _to_numpy(kt0.lam))
    xnm = None if x_norm_model is None else float(x_norm_model)
    final = _run(x, kt, params, dev, jk_fiber=jk_fiber, x_norm_model=xnm, batched=False)
    return final.kt, _report(final, ())


def cp_batched_als(
    x, kts: Sequence[Ktensor] | Ktensor, params: AlsParams = AlsParams(), device=None
) -> tuple[list[Ktensor], list[AlsReport]]:
    """Fit many same-rank models independently (reference ``cp_omp_als``).

    kts: a list of Ktensors, or one Ktensor with a leading batch dim. Each
    model follows the trajectory ``cp_als`` would give it. device: as in
    ``cp_als``.
    """
    dev = resolve_device(device)
    if isinstance(kts, Ktensor):
        kt_b = Ktensor(tuple(_to_numpy(f) for f in kts.factors), _to_numpy(kts.lam))
    else:
        kt_b = Ktensor(
            tuple(np.stack([_to_numpy(kt.factors[n]) for kt in kts]) for n in range(len(kts[0].factors))),
            np.stack([_to_numpy(kt.lam) for kt in kts]),
        )
    final = _run(x, kt_b, params, dev)
    b = final.iters.shape[0]
    results = [Ktensor(tuple(f[i] for f in final.kt.factors), final.kt.lam[i]) for i in range(b)]
    return results, [_report(final, i) for i in range(b)]
