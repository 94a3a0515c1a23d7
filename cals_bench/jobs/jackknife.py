"""The jackknife: one call of ``cp_cals_tpu_torch.solvers.jk_cp_cals`` (the
driver that ``api.cp_cals_jk`` wraps; the API takes no ``precision``, so
the traffic's "high" tier is reached only here) on the configuration's
tensor, resampling a model that the benchmark fits in set-up with its own
float64 ALS (from the model the tensor was made of) and hands to the
program as float32: one replicate per mode-0 slice, tol-driven, polished,
rescaled and matched by LSAP.

The check compares every replicate of every job: its reported fit with
the fit of the reference's replicate (float64 ALS from the same model,
swept to convergence). For the sampled jobs it also compares each
returned replicate itself: the fit its factors give (its left-out row
taken as zero) with the fit reported beside it, and its distance from the
reference's replicate; it counts the replicates whose columns the
reference's own assignment would order otherwise than the program
returned them (an exact comparison). Iterations are not compared: a
tol-driven stop depends on the engine's batch (the mixed-tier check
follows the oldest live model). Last, it compares what a jackknife is
for, the standard error of every factor entry over the replicates, with
the reference's: ``se_ratio_gap``, how far from 1 the median over the
entries of every mode of the program's over the reference's lies. At 299
slices a replicate moves from the base model about as far as the float16
wire rounds it, so a replicate left where it started is within every
other number's limit: its standard errors are 0.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import arith, data
from ..reference import als
from ..reference import jackknife as ref_jk
from . import Out


def _worst(values) -> float:
    values = [float(v) for v in values]
    return max(values) if values else 0.0


class Job:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, override: dict | None = None):
        from cp_cals_tpu_torch import Ktensor
        from cp_cals_tpu_torch.convert import params_from_dict

        self.device = torch.device(device)
        self.modes = tuple(cfg["modes"])
        self.traffic = traffic
        self.x, (f0, _) = data.tensor(cfg, seed, self.device, with_model=True)
        base = traffic["base"]
        if f0[0].shape[1] != base["rank"]:
            raise ValueError("the jackknife's base rank must be the tensor's true rank")
        # The base model is the float64 ALS fit started from the model the
        # tensor was made of, so every seed resamples the best model of that
        # rank (a random start can stall in a swamp, which changes the
        # replicates' work).
        p = als.Problem(self.x.to(torch.float64))
        f, lam, self.base_fit, _ = als.sweeps(
            p, [u.unsqueeze(0) for u in f0], base["max_sweeps"], tol=base["tol"])
        # Each column's sign as the program's own fits leave it (the
        # largest entry of modes 1.. positive, mode 0 carrying the sign),
        # since the program's matching scores signed inner products.
        f = [u[0] for u in f]
        for n in range(1, 3):
            s = torch.sign(f[n].gather(0, f[n].abs().argmax(dim=0, keepdim=True)))
            f[n], f[0] = f[n] * s, f[0] * s
        self.base = ([u.float() for u in f], lam[0].float())  # what both sides get
        self.model = Ktensor(tuple(u.cpu().numpy() for u in self.base[0]), self.base[1].cpu().numpy())
        self.params = params_from_dict({**traffic["params"], **(override or {})})
        self.rows = self.modes[0]

    @property
    def n_models(self) -> int:
        return self.rows

    def run(self) -> Out:
        from cp_cals_tpu_torch.solvers import jk_cp_cals

        rep = jk_cp_cals(self.x, [self.model], self.params, device=self.device)
        return Out(report=rep.cals_report, results=rep.results[0], n_models=len(rep.results[0]),
                   solver_s=rep.solver_time, pre_s=rep.pre_time)

    def work(self, rec) -> dict:
        """Useful work of a job (``rec``: a ``runner.JobRecord``)."""
        p = self.params
        main = p.mttkrp_precision or p.precision
        return arith.job_work(self.modes, list(zip(rec.ranks.tolist(), rec.iters.tolist())), main, p.precision,
                              p.polish_iters if p.polish_tol == 0 else 0)

    # ------------------------------------------------------------ the check

    def answers(self, rec, full: bool) -> dict:
        """The reported fits by replicate (NaN where none was reported), and
        with ``full`` the replicates."""
        fits = np.full(self.rows, np.nan)
        fits[rec.ids] = rec.fits
        ans = dict(fits=fits, n=rec.n_models)
        if full:
            ans["models"] = [([np.asarray(f) for f in kt.factors], np.asarray(kt.lam)) for kt in rec.results]
        return ans

    def reference(self, dtype=torch.float64, operand=None) -> dict:
        ref = self.traffic["reference"]
        p = als.Problem(self.x.to(dtype), operand)
        base = [u.to(dtype) for u in self.base[0]]
        f, lam, fit, sweeps = ref_jk.replicates(p, base, list(range(self.rows)), ref["tol"], ref["max_sweeps"],
                                                ref["min_sweeps"])
        return dict(factors=f, lam=lam, fit=fit.cpu().numpy(), sweeps=sweeps,
                    order=ref_jk.lsap_orders([u.to(dtype) for u in self.base[0]], f))

    def control_answers(self, operand=None) -> dict:
        ref = self.reference(torch.float32, operand)
        order = torch.as_tensor(ref["order"], device=self.device)
        f = [torch.gather(u, 2, order[:, None, :].expand(-1, u.shape[1], -1)) for u in ref["factors"]]
        lam = torch.gather(ref["lam"], 1, order)
        f[0] = f[0].clone()
        f[0][torch.arange(self.rows), torch.arange(self.rows)] = float("nan")
        return dict(fits=ref["fit"], n=self.rows,
                    models=[([u[i].cpu().numpy() for u in f], lam[i].cpu().numpy()) for i in range(self.rows)])

    def _malformed(self, models) -> int:
        bad = 0
        rows = np.arange(self.rows)
        shapes = [(m, self.base[1].shape[0]) for m in self.modes]
        for fiber, (f, lam) in enumerate(models):
            if [u.shape for u in f] != shapes or lam.shape != shapes[0][1:]:
                bad += 1
                continue
            nan_rows = np.isnan(f[0]).any(axis=1)
            if (not np.array_equal(nan_rows, rows == fiber) or not np.isnan(f[0][fiber]).all()
                    or not all(np.isfinite(u).all() for u in f[1:]) or not np.isfinite(lam).all()):
                bad += 1
        return bad

    def readings(self, all_answers: list[dict], ref: dict) -> dict:
        fit_gap, bad = 0.0, 0
        for ans in all_answers:
            ok = np.isfinite(ans["fits"])
            bad += int(np.count_nonzero(~ok)) + abs(ans["n"] - self.rows)
            fit_gap = max(fit_gap, _worst(np.abs(ans["fits"][ok] - ref["fit"][ok])))
        fit_self, recon, lsap_off, se_ratio_gap = [], [], 0, 0.0
        p = als.Problem(self.x.to(torch.float64))
        rows = torch.arange(self.rows, device=self.device)
        base = [als.normalize(u.to(torch.float64).unsqueeze(0))[0][0] for u in self.base[0]]
        se_ref = ref_jk.standard_errors(ref_jk.aligned(base, ref["factors"], ref["order"]))
        for ans in (a for a in all_answers if "models" in a):
            n_bad = self._malformed(ans["models"])
            if n_bad or len(ans["models"]) != self.rows:
                bad += n_bad
                continue
            f = [torch.as_tensor(np.stack([m[0][n] for m in ans["models"]]), dtype=torch.float64,
                                 device=self.device) for n in range(3)]
            lam = torch.as_tensor(np.stack([m[1] for m in ans["models"]]), dtype=torch.float64, device=self.device)
            fit_self.extend(np.abs(als.model_fit(p, f, lam, rows=rows).cpu().numpy() - ans["fits"]))
            f[0] = f[0].nan_to_num(0.0)
            recon.extend(als.recon_gap(f, lam, ref["factors"], ref["lam"]).cpu().numpy())
            order = ref_jk.lsap_orders(self.base[0], [u.float() for u in f])
            lsap_off += int(np.count_nonzero((order != np.arange(order.shape[1])).any(axis=1)))
            se = ref_jk.standard_errors(ref_jk.aligned(base, f))
            ratio = torch.cat([(a / b)[b > 0] for a, b in zip(se, se_ref)])
            se_ratio_gap = max(se_ratio_gap, abs(float(ratio.median()) - 1.0))
        return dict(fit_gap=fit_gap, fit_self=_worst(fit_self), recon_gap=_worst(recon), lsap_off=lsap_off,
                    se_ratio_gap=se_ratio_gap, bad=bad)
