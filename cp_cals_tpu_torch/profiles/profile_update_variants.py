"""A/B of the factor update's small-op variants on the card (the
counterpart of ``scripts/profile_update_variants.py``: its flags and keys).

    python -m cp_cals_tpu_torch.profiles.profile_update_variants
        [--cases 96-20,80-4,80-8,240-20] [--modes 299-301-41] [--n-loop 50]
        [--device cuda] [--out chiprun_out/profiles/update_variants.json]

Per case (B, R), on H = A A^T + 2 R I (A [B, R, R] drawn from key 0) and
G [B, I_0, R], each time ms per step replayed from a CUDA graph
(``_timing``):

- ``update_{chol,gj,pallas}_b{B}_r{R}_ms``: the update U = G H^-1 through
  ``ops/update.update_factor_unconstrained`` with the Cholesky inverse, the
  Gauss-Jordan inverse in PyTorch, and the SPD-inverse kernel
  (``ops/spd_inverse.spd_inverse``, solve "pallas": the inverse, then the
  product, as the script composes it). The kernel is held against its
  plain version at every case before it is timed, and the script's catch
  of a failed kernel is not kept: at these shapes the kernel runs, or the
  run fails;
- ``tail_{current,fused}_b{B}_r{R}_ms``: the normalize + gramian tail, as
  ``normalize_mode`` then ``gramian``, and fused (the gramian of the raw
  update, the L2 norms from its diagonal, the gramian rescaled).
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..ktensor import Ktensor, normalize_mode
from ..ops.gramians import gramian
from ..ops.spd_inverse import spd_inverse, spd_inverse_plain
from ..ops.update import update_factor_unconstrained
from ..prng import normal, prng_key, split
from . import _timing as tm

SOLVES = ("chol", "gj", "pallas")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=tm.out_path("update_variants.json"))
    p.add_argument("--n-loop", type=int, default=50)
    p.add_argument("--reps", type=int, default=4, help="timed replays, the best kept (the script's reps)")
    p.add_argument("--modes", default="299-301-41")
    p.add_argument("--cases", default="96-20,80-4,80-8,240-20")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions, no times)")
    return p


def workload(b: int, r: int, i0: int, dev):
    """The script's draw of one case: H [B, R, R] and G [B, I_0, R]."""
    ks = split(prng_key(0, dev), 3)
    a = normal(ks[0], (b, r, r))
    h = torch.einsum("brs,bts->brt", a, a) + 2.0 * r * torch.eye(r, device=dev)
    return h, normal(ks[1], (b, i0, r))


def update_step(h, solve: str):
    return lambda g: update_factor_unconstrained(g, h, solve=solve) * 0.999 + 0.001


def tail_current_step(lam, iters, weight: float = 1e-30):
    """``weight`` (in both tails) is how much of the gramian and lam the
    chain carries: the script's, or 1 for a test to read them."""
    def step(u):
        kt2 = normalize_mode(Ktensor((u,), lam), 0, iters)
        gm = gramian(kt2.factors[0])
        return kt2.factors[0] + (torch.sum(gm, dim=-2) + kt2.lam)[..., None, :] * weight

    return step


def tail_fused_step(iters, weight: float = 1e-30):
    def step(u):
        gm_raw = gramian(u)
        l2 = torch.sqrt(torch.abs(torch.diagonal(gm_raw, dim1=-2, dim2=-1)))
        mx = torch.amax(u, dim=-2)
        mn = torch.amin(u, dim=-2)
        maxval = torch.where(mx >= -mn, mx, mn)
        lam_new = torch.where((iters == 1)[..., None], l2, maxval)
        safe = torch.where(lam_new != 0, lam_new, torch.ones_like(lam_new))
        f_new = u / safe[..., None, :]
        gm = gm_raw / (safe[..., :, None] * safe[..., None, :])
        return f_new + (torch.sum(gm, dim=-2) + lam_new)[..., None, :] * weight

    return step


def run(args, checks: dict | None = None) -> dict:
    """The A/B as ``main`` runs it; the SPD-inverse kernel's readings
    against its plain version go to ``checks``."""
    checks = {} if checks is None else checks
    dev = resolve_device(args.device)
    modes = tuple(int(m) for m in args.modes.split("-"))
    head = tm.header(dev)
    results = {**head, "modes": modes}
    print(results["device"], flush=True)
    results["null_roundtrip_ms"] = tm.null_ms(dev)
    print(f"null: {tm.fmt(results['null_roundtrip_ms'])}", flush=True)
    for case in args.cases.split(","):
        b, r = (int(v) for v in case.split("-"))
        h, g0 = workload(b, r, modes[0], dev)
        checks[f"spd_inverse_b{b}_r{r}"] = tm.check_inverse(f"spd_inverse B={b} R={r}", spd_inverse(h),
                                                            spd_inverse_plain(h), h)
        for solve in SOLVES:
            key = f"update_{solve}_b{b}_r{r}_ms"
            results[key] = tm.timed(update_step(h, solve), g0, args.n_loop, args.reps, dev)
            print(f"update {solve:6s} B={b:<4d} R={r:<3d} {tm.fmt(results[key])}", flush=True)
            tm.write(args.out, results)
        lam = torch.ones((b, r), device=dev)
        iters = torch.full((b,), 5, dtype=torch.int32, device=dev)
        for name, step in (("current", tail_current_step(lam, iters)), ("fused", tail_fused_step(iters))):
            key = f"tail_{name}_b{b}_r{r}_ms"
            results[key] = tm.timed(step, g0, args.n_loop, args.reps, dev)
            print(f"tail {name:8s} B={b:<4d} R={r:<3d} {tm.fmt(results[key])}", flush=True)
            tm.write(args.out, results)
    tm.write(args.out, results)
    print(f"wrote {args.out}")
    return results


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
