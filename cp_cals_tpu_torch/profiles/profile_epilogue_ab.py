"""A/B of the fused epilogue kernels against the unfused path on the card,
component by component (the counterpart of ``scripts/profile_epilogue_ab.py``:
its flags and keys).

    python -m cp_cals_tpu_torch.profiles.profile_epilogue_ab [--modes 299-301-41]
        [--batch 96] [--rank 20] [--n-loop 20] [--device cuda]
        [--out chiprun_out/profiles/epilogue_ab.json]

Each time is ms per step replayed from a CUDA graph (``_timing``):

- ``iteration_{xla,fused}_ms``: the full iteration (precision "high",
  forced) with ``epilogue="xla"`` (the unfused path) and ``"fused"`` (the
  normal-inverse and apply kernels), chained on its state; the A/B behind
  the port's ``epilogue="auto"``. The fused leg needs the epilogue gate to
  take every mode (else it raises: the unfused path is not timed under the
  fused name); one step of each is held against the other first;
- ``inverse_pallas_ms``: ``ops/fused_epilogue.normal_inverse`` of mode 1,
  against ``inverse_xla_ms``: ``padded_hadamard(hadamard_but_one(...))``
  and ``gj_inverse``, chained through gramian 0;
- ``apply_pallas_err{0,1}_ms``: ``epilogue_apply`` on mode 0 without and
  with the FastALS error (the script's ``with_err``: here the kernel
  finishes the error from the model norms and the other modes' gramians),
  against ``apply_xla_ms``: ``update_factor_unconstrained``,
  ``scale_jk_rows`` and ``normalize_factor_fused``.

Each kernel is held against its plain version on the same inputs before it
is timed.
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..ktensor import Ktensor, normalize_factor_fused, scale_jk_rows
from ..ops.fused_epilogue import (
    epilogue_apply,
    epilogue_apply_plain,
    normal_inverse,
    normal_inverse_plain,
    supports_fused_epilogue,
)
from ..ops.gramians import gramians, hadamard_but_one
from ..ops.update import gj_inverse, padded_hadamard, update_factor_unconstrained
from ..prng import normal
from ..solvers.iteration import make_iteration
from ..solvers.state import init_state
from . import _timing as tm
from .profile_iteration import check_iteration, iteration_params, iteration_step


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--modes", default="299-301-41")
    p.add_argument("--batch", type=int, default=96)
    p.add_argument("--rank", type=int, default=20)
    p.add_argument("--n-loop", type=int, default=20)
    p.add_argument("--reps", type=int, default=4, help="timed replays, the best kept (the script's reps)")
    p.add_argument("--out", default=tm.out_path("epilogue_ab.json"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions, no times)")
    return p


def workload(modes, b: int, r: int, dev) -> dict:
    """The script's draw (key 0 split into N + 2: X, the factors x 0.1, and
    G [B, I_0, R] from the last key) and what it derives from it."""
    ks, x, factors = tm.draw(modes, b, r, len(modes) + 2, dev)
    return dict(
        x=x, kt=Ktensor(factors, torch.ones((b, r), device=dev)), x_norm=torch.linalg.vector_norm(x.reshape(-1)),
        grams=gramians(factors), mask=torch.ones((b, r), dtype=torch.bool, device=dev),
        iters=torch.full((b,), 5, dtype=torch.int32, device=dev),
        jk=torch.full((b,), -1, dtype=torch.int32, device=dev), g0=normal(ks[-1], (b, modes[0], r)),
    )


def inverse_kernel_step(grams, mask, weight: float = 1e-30):
    """``weight`` (here and in the other steps) is how much of the step's
    result the chain carries: the script's, or 1 for a test to read it."""
    return lambda gg: gg + normal_inverse((gg,) + tuple(grams[1:]), mask, 1) * weight


def inverse_unfused_step(grams, mask, weight: float = 1e-30):
    return lambda gg: gg + gj_inverse(padded_hadamard(hadamard_but_one((gg,) + tuple(grams[1:]), 1), mask)) * weight


def error_inputs(w: dict) -> tuple:
    """The apply's error inputs on mode 0: the model norms [B] and the other
    modes' gramians."""
    b = w["mask"].shape[0]
    return (w["x_norm"].expand(b).contiguous(), *w["grams"][1:])


def apply_kernel_step(hinv0, w: dict, with_err: bool, weight: float = 1e-30):
    err_inputs = error_inputs(w) if with_err else None

    def step(gg):
        f, lam, gm, err = epilogue_apply(gg, hinv0, w["iters"], w["jk"], True, err_inputs)
        extra = err[:, None, None] if with_err else 0.0
        return gg + f * weight + (gm[..., :1, :] + lam[..., None, :] + extra) * weight

    return step


def apply_unfused_step(w: dict, weight: float = 1e-30):
    h = padded_hadamard(hadamard_but_one(w["grams"], 0), w["mask"])

    def step(gg):
        u = scale_jk_rows(update_factor_unconstrained(gg, h), w["jk"], 0.0)
        f, lam, gm = normalize_factor_fused(u, w["iters"])
        return gg + f * weight + (gm[..., :1, :] + lam[..., None, :]) * weight

    return step


def check_epilogue(w: dict, hinv0) -> dict:
    """The normal inverse and the apply (without and with the error) against
    their plain versions on the profile's inputs."""
    grams, mask = w["grams"], w["mask"]
    out = {"inverse": tm.check_inverse("normal_inverse", normal_inverse(grams, mask, 1),
                                       normal_inverse_plain(grams, mask, 1),
                                       padded_hadamard(hadamard_but_one(grams, 1), mask))}
    for with_err in (False, True):
        err_inputs = error_inputs(w) if with_err else None
        got = epilogue_apply(w["g0"], hinv0, w["iters"], w["jk"], True, err_inputs)
        want = epilogue_apply_plain(w["g0"], hinv0, w["iters"], w["jk"], True, err_inputs)
        out[f"apply_err{int(with_err)}"] = max(
            tm.check_close(f"epilogue_apply {name}", a, b, tm.TOL["apply"])
            for name, a, b in zip(("f", "lam", "gm", "err"), got, want) if b is not None)
    return out


def require_fused_epilogue(shape, b: int, r: int, dev) -> None:
    """Raise unless the epilogue gate takes every mode at this shape."""
    refused = [n for n, i_n in enumerate(shape)
               if not supports_fused_epilogue(b, i_n, r, torch.float32, len(shape), dev)]
    if refused:
        raise ValueError(f"the fused epilogue's gate refuses modes {refused} at {tuple(shape)}, B={b}, R={r}: "
                         f"the fused iteration would run them unfused")


def run(args, checks: dict | None = None) -> dict:
    """The A/B as ``main`` runs it; the kernels' readings against their
    plain versions go to ``checks``."""
    checks = {} if checks is None else checks
    dev = resolve_device(args.device)
    modes = tuple(int(m) for m in args.modes.split("-"))
    b, r, n_loop, reps = args.batch, args.rank, args.n_loop, args.reps
    w = workload(modes, b, r, dev)
    x, x_norm = w["x"], w["x_norm"]
    head = tm.header(dev)
    print(f"device: {head['device']} modes {modes} B={b} R={r}", flush=True)
    res = {"modes": modes, "batch": b, "rank": r, **head, "null_ms": tm.null_ms(dev)}
    print(f"null {tm.fmt(res['null_ms'])}", flush=True)

    require_fused_epilogue(modes, b, r, dev)
    state0 = init_state(w["kt"], x_norm)
    for epi in ("xla", "fused"):
        params = iteration_params(epi)
        it = make_iteration(params, batched=True)
        prepared = it.prepare(x)
        checks[f"iteration_{epi}"] = check_iteration(params, x, state0, x_norm, it, prepared)
        t = tm.timed(iteration_step(it, x, x_norm, prepared), state0, n_loop, reps, dev)
        res[f"iteration_{epi}_ms"] = t
        print(f"iteration[{epi}]: {tm.fmt(t)}", flush=True)

    grams, mask = w["grams"], w["mask"]
    hinv0 = normal_inverse(grams, mask, 0)
    checks["epilogue"] = check_epilogue(w, hinv0)
    for key, step in (("inverse_pallas_ms", inverse_kernel_step(grams, mask)),
                      ("inverse_xla_ms", inverse_unfused_step(grams, mask))):
        res[key] = tm.timed(step, grams[0], n_loop, reps, dev)
        print(f"{key[:-3].replace('_', ' ')}: {tm.fmt(res[key])}", flush=True)
    for with_err in (False, True):
        key = f"apply_pallas_err{int(with_err)}_ms"
        res[key] = tm.timed(apply_kernel_step(hinv0, w, with_err), w["g0"], n_loop, reps, dev)
        print(f"apply pallas (err={with_err}): {tm.fmt(res[key])}", flush=True)
    res["apply_xla_ms"] = tm.timed(apply_unfused_step(w), w["g0"], n_loop, reps, dev)
    print(f"apply xla (no solve-h): {tm.fmt(res['apply_xla_ms'])}", flush=True)

    tm.write(args.out, res)
    print(f"wrote {args.out}")
    return res


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
