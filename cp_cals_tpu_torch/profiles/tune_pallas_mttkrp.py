"""Sweep the fused MTTKRP kernels' plans against the twostep on the card
(the counterpart of ``scripts/tune_pallas_mttkrp.py``: its flags but two,
and its keys).

    python -m cp_cals_tpu_torch.profiles.tune_pallas_mttkrp [--modes 299-301-41]
        [--rank 20] [--batch 96] [--reps 5] [--precisions high,default]
        [--n-loop 100] [--device cuda] [--out chiprun_out/profiles/pallas_tune.json]

The Pallas kernel's knobs, ``db`` (its lane block of models) and ``cj``
(its j unroll), and the script's ``--dbs`` and ``--cjs`` have no
counterpart: the port's knobs are its kernels' plans
(``ops/fused_mttkrp.py``): (tile, or column tile of the tensor-core
kernel; k per block; k splits; j splits; j per split). Per mode and tier
the cases are

- ``twostep/{tier}``, the baseline;
- the planner's pick, and at "highest" each built fp32 tile, at the bf16
  tiers each column tile of ``_TC_NC``, each with j splits at 1/2, 1 and 2
  times the planner's (the k ranges as the planner splits them), named by
  their plan: ``fused/t{tile}/k{kspan}x{ksplits}/j{jchunk}x{jsplits}/{tier}``,
  ``fused/nc{nc}/...`` for the tensor-core kernel;
- at the bf16 tiers, where the planner split j over more than one wave,
  the one-wave plan it passed over (``one_wave_tc``).

A plan the validator (``check_fp32_plan``, ``check_tc_plan``) refuses is
skipped and recorded with its reason, as the script skips a ``db`` that
does not divide B; a plan it takes that then fails to launch fails the
run. Each fused case's result is held against ``fused_mttkrp_plain`` at
the kernel tests' 2e-5 of its largest magnitude before it is timed. Every
case is ``n_loop`` chained steps replayed from a CUDA graph (``_timing``),
all of a mode captured first and then timed in turns, the best of
``--reps``. ``summary`` gives per mode and tier the twostep, the planner's
pick and the best plan, beside the least time the card could take for the
fused MTTKRP (``bound``). The sweep changes no plan the engine takes.

On the CPU the cases are planned for an NVIDIA H100 SXM (``H100``: its SMs
and shared memory, and the planners' Python copies of the kernels' tables)
and run once through the plain version.
"""

from __future__ import annotations

import argparse
from typing import NamedTuple

import numpy as np

from ..device import resolve_device
from ..ops import fused_mttkrp as fm
from ..ops.mttkrp import mttkrp_batched, prepare_batched
from . import _timing as tm

N_LOOP = 100


class Card(NamedTuple):
    """What the planners and validators read of a card: SMs, shared memory
    per block (opt-in) and per SM, the fp32 kernel's tile table and both
    kernels' shared memory per block."""

    n_sm: int
    smem_block: int
    smem_sm: int
    tiles: dict
    fp32_smem: object
    tc_smem: object


# An H100 SXM (132 SMs, 227 KB a block, 228 KB an SM), with the Python
# copies of the kernels' tables: the plans a CPU run names.
H100 = Card(132, 232448, 233472, fm.FP32_TILES, fm.fp32_smem, fm.tc_smem)


def card_of(dev) -> Card:
    if dev.type != "cuda":
        return H100
    import torch

    props = torch.cuda.get_device_properties(dev)
    return Card(props.multi_processor_count, props.shared_memory_per_block_optin,
                props.shared_memory_per_multiprocessor, fm.fp32_tiles_built(),
                fm._lib_fp32().fused_mttkrp_fp32_smem, fm._lib_tc().fused_mttkrp_tc_smem)


def case_name(plan, tier: str) -> str:
    lead = f"t{plan[0]}" if tier == "highest" else f"nc{plan[0]}"
    return f"fused/{lead}/k{plan[1]}x{plan[2]}/j{plan[4]}x{plan[3]}/{tier}"


def sweep(shape, mode: int, b: int, r: int, tier: str, card: Card) -> list[dict]:
    """The fused cases of one mode and tier (module docstring), the
    planner's pick first: ``{"name", "plan", "planner"}``, and
    ``"refused"`` (the validator's reason) for a plan it refuses."""
    small, big = fm.split_others(tuple(shape), mode)
    j, i, k, c = shape[small], shape[mode], shape[big], b * r
    if tier == "highest":
        pick = fm.plan_fp32(j, i, k, c, card.n_sm, card.smem_block, card.tiles, card.fp32_smem)
        # Each tile with the planner's k ranges for that tile.
        bases = [fm.plan_fp32(j, i, k, c, card.n_sm, card.smem_block, {t: card.tiles[t]}, card.fp32_smem)
                 for t in sorted(card.tiles)]

        def check(p):
            return fm.check_fp32_plan(p, j, i, k, card.smem_block, card.tiles, card.fp32_smem)
    else:
        planes, kp = fm.PLANES[tier], fm.padded_k(k)
        pick = fm.plan_tc(j, i, kp, c, planes, card.n_sm, card.smem_block, card.smem_sm, card.tc_smem)
        bases = [(nc,) + pick[1:] for nc in fm._TC_NC]

        def check(p):
            return fm.check_tc_plan(p, j, i, kp, planes, card.smem_block, card.tc_smem)
    plans = [pick]
    if tier != "highest":
        slots = fm.tc_slots(pick[0], planes, pick[1], card.n_sm, card.smem_sm, card.tc_smem)
        plans += [p for p in [fm.one_wave_tc(pick[:3], j, i, c, slots)] if p != pick]
    for base in bases:
        for js in (max(1, pick[3] // 2), pick[3], min(j, 2 * pick[3])):
            jchunk = -(-j // js)
            plan = base[:3] + (-(-j // jchunk), jchunk)
            if plan not in plans:
                plans.append(plan)
    out = []
    for plan in plans:
        case = {"name": case_name(plan, tier), "plan": list(plan), "planner": plan == pick}
        try:
            check(plan)
        except ValueError as e:
            case["refused"] = str(e)
        out.append(case)
    return out


def bound(held, shape, mode: int, b: int, r: int, tier: str, dev) -> tuple:
    """(ms, "operations" or "bytes"): the larger of the MTTKRP's operations
    (2 J I K C + 2 J I C, three bf16 products at "high") over the card's
    peak for their type, and its bytes (the held X, the two factors and G
    once each) over HBM, with ``utils/roofline.py``'s peaks, as
    chip_smoke.py bounds the kernel; (None, None) without the card's
    peaks."""
    from ..utils.roofline import device_peaks

    peaks = device_peaks(dev) if dev.type == "cuda" else None
    if peaks is None:
        return None, None
    small, big = fm.split_others(tuple(shape), mode)
    j, i, k = shape[small], shape[mode], shape[big]
    flops = (2 * j * i * k * b * r + 2 * j * i * b * r) * (3 if tier == "high" else 1)
    t_ops = flops / (peaks["fp32_tflops" if tier == "highest" else "bf16_tflops"] * 1e12) * 1e3
    t_bytes = (held.nbytes + 4 * b * (j + k + i) * r) / (peaks["hbm_tb_s"] * 1e12) * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--modes", default="299-301-41")
    p.add_argument("--rank", type=int, default=20)
    p.add_argument("--batch", type=int, default=96)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--precisions", default="high,default")
    p.add_argument("--n-loop", type=int, default=N_LOOP, help="chained steps per replay (the script's N_LOOP)")
    p.add_argument("--out", default=tm.out_path("pallas_tune.json"))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu (plain versions, no times)")
    return p


def chain_step(x, mode: int, call):
    other = tm.first_other(x.ndim, mode)

    def step(f):
        fo = f[other] + call(f).sum(dim=-2, keepdim=True) * 1e-20
        return f[:other] + (fo,) + f[other + 1:]

    return step


def summary(cases: list, bounds: dict) -> list:
    """Per mode and tier: the twostep's, the planner's pick's and the best
    fused plan's ms, and the fused MTTKRP's bound ``bounds[(mode, tier)]``
    (None on the CPU)."""
    out = []
    for mode, tier in dict.fromkeys((c["mode"], c["tier"]) for c in cases):
        mine = [c for c in cases if c["mode"] == mode and c["tier"] == tier and "ms" in c]
        fused = [c for c in mine if c["name"].startswith("fused/")]
        pick = next(c for c in fused if c["planner"])
        best = min(fused, key=lambda c: (c["ms"] is None, c["ms"] or 0.0))
        base = next(c for c in mine if c["name"].startswith("twostep/"))
        out.append({"mode": mode, "tier": tier, "twostep_ms": base["ms"], "planner_name": pick["name"],
                    "planner_ms": pick["ms"], "best_name": best["name"], "best_ms": best["ms"],
                    "bound_ms": bounds[(mode, tier)][0], "bound_by": bounds[(mode, tier)][1]})
    return out


def run(args, checks: dict | None = None) -> dict:
    """The sweep as ``main`` runs it; each fused case's reading against the
    plain version goes to ``checks``."""
    checks = {} if checks is None else checks
    dev = resolve_device(args.device)
    modes = tuple(int(m) for m in args.modes.split("-"))
    r, b, tiers = args.rank, args.batch, args.precisions.split(",")
    for tier in tiers:
        if tier not in fm.TIERS:
            raise ValueError(f"precision {tier!r}: expected one of {fm.TIERS}")
    _, x, factors = tm.draw(modes, b, r, 4, dev, scale=None)
    flops = 2 * int(np.prod(modes)) * b * r
    card = card_of(dev)
    results = {"modes": modes, "rank": r, "batch": b, **tm.header(dev), "null_roundtrip_ms": tm.null_ms(dev),
               "n_loop": args.n_loop, "reps": args.reps, "cases": []}
    print(f"device {results['device']} modes {modes} R={r} B={b} precs={tiers}", flush=True)
    bounds = {}
    for mode in range(len(modes)):
        prep_ts = prepare_batched(x, ("twostep",) * len(modes))[mode]
        steps, rows = {}, {}
        for tier in tiers:
            steps[f"twostep/{tier}"] = chain_step(
                x, mode, lambda f, t=tier: mttkrp_batched(x, f, mode, "twostep", t, prep_ts))
            rows[f"twostep/{tier}"] = {"mode": mode, "tier": tier, "name": f"twostep/{tier}"}
            held = fm.prepare_mode_tensor(x, mode, tier)
            bounds[(mode, tier)] = bound(held, modes, mode, b, r, tier, dev)
            for case in sweep(modes, mode, b, r, tier, card):
                row = {"mode": mode, "tier": tier, **case}
                if "refused" in case:
                    print(f"mode={mode} {case['name']}: refused ({case['refused']})", flush=True)
                    results["cases"].append(row)
                    continue
                plan = tuple(case["plan"])
                _, row["max_abs_err"] = tm.check_fused_mttkrp(f"mode {mode} {case['name']}", x, factors, mode,
                                                              held, tier, plan)
                checks[f"m{mode} {case['name']}"] = row["max_abs_err"]
                steps[case["name"]] = chain_step(
                    x, mode, lambda f, h=held, t=tier, p=plan: fm.mttkrp_batched_fused(x, f, mode, h, t, plan=p))
                rows[case["name"]] = row
        chains = {name: tm.Chain(step, factors, args.n_loop, dev) for name, step in steps.items()}
        best = {name: None for name in chains}
        for _ in range(args.reps):
            for name, chain in chains.items():  # in turns
                t = chain.once()
                if t is not None:
                    best[name] = t if best[name] is None else min(best[name], t)
        del chains
        for name in sorted(best, key=lambda n: (best[n] is None, best[n] or 0.0)):
            row = rows[name]
            row.update(ms=best[name], tflops=tm.rate(flops, best[name]))
            print(f"mode={mode} {name:36s} {tm.fmt(best[name])}"
                  + (" (planner)" if row.get("planner") else ""), flush=True)
            results["cases"].append(row)
        results["summary"] = summary(results["cases"], bounds)
        tm.write(args.out, results)
    print("wrote", args.out)
    return results


def main(argv=None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
