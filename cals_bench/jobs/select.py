"""Model selection: one call of ``cp_cals_tpu_torch.solvers.cp_cals`` (the
engine that ``api.cp_cals`` wraps and whose report it drops) on the
configuration's tensor, fitting the traffic's queue of ranks from initial
models drawn from the seed, at forced iterations.

The check compares every model of every job: its reported fit with the
reference's (float64 ALS from the same initial model, the same number of
sweeps: the forced iterations and the polish sweeps), and its reported
iterations with the forced count. For the sampled jobs it also compares
each returned model itself: the fit that its factors and weights give,
worked out in float64, with the fit the program reported beside it, and
its distance from the reference's model.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import arith, data
from ..reference import als
from . import Out


class Job:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device, override: dict | None = None):
        from cp_cals_tpu_torch import Ktensor
        from cp_cals_tpu_torch.convert import params_from_dict

        self.device = torch.device(device)
        self.modes = tuple(cfg["modes"])
        self.x = data.tensor(cfg, seed, self.device)
        self.ranks = data.queue_ranks(traffic)
        self.init = data.inits(self.modes, self.ranks, seed, self.device)
        self.queue = [Ktensor(tuple(f.cpu().numpy() for f in fs), lam.cpu().numpy()) for fs, lam in self.init]
        self.params = params_from_dict({**traffic["params"], **(override or {})})
        if not self.params.force_max_iter:
            raise ValueError("a select traffic mix runs forced iterations: its check needs the sweep count")
        self.sweeps = self.params.max_iterations + self.params.polish_iters

    @property
    def n_models(self) -> int:
        return len(self.queue)

    def run(self) -> Out:
        from cp_cals_tpu_torch.solvers import cp_cals

        results, report = cp_cals(self.x, self.queue, self.params, device=self.device)
        return Out(report=report, results=results, n_models=len(results))

    def work(self, rec) -> dict:
        """Useful work of a job (``rec``: a ``runner.JobRecord``)."""
        p = self.params
        main = p.mttkrp_precision or p.precision
        return arith.job_work(self.modes, list(zip(rec.ranks.tolist(), rec.iters.tolist())), main, p.precision,
                              p.polish_iters if p.polish_tol == 0 else 0)

    # ------------------------------------------------------------ the check

    def answers(self, rec, full: bool) -> dict:
        """The reported fits and iterations by queue position (NaN and -1
        where none was reported), and with ``full`` the fitted models."""
        fits, iters = np.full(self.n_models, np.nan), np.full(self.n_models, -1)
        fits[rec.ids], iters[rec.ids] = rec.fits, rec.iters
        ans = dict(fits=fits, iters=iters)
        if full:
            ans["models"] = [None if kt is None else ([np.asarray(f) for f in kt.factors], np.asarray(kt.lam))
                             for kt in rec.results]
        return ans

    def _groups(self):
        """Queue positions by rank."""
        groups: dict[int, list[int]] = {}
        for i, r in enumerate(self.ranks):
            groups.setdefault(r, []).append(i)
        return groups

    def reference(self, dtype=torch.float64, operand=None) -> dict:
        """Every model after the same sweeps in plain ALS: factors, lam and
        fit, by queue position (``operand``: ``als.Problem``'s)."""
        p = als.Problem(self.x.to(dtype), operand)
        out = {}
        for r, idx in self._groups().items():
            start = [torch.stack([self.init[i][0][n] for i in idx]).to(dtype) for n in range(3)]
            f, lam, fit, _ = als.sweeps(p, start, self.sweeps)
            for k, i in enumerate(idx):
                out[i] = ([u[k] for u in f], lam[k], float(fit[k]))
        return out

    def control_answers(self, operand=None) -> dict:
        """The reference in the program's place, in float32 with
        ``operand`` rounding its products' operands."""
        ref = self.reference(torch.float32, operand)
        return dict(
            fits=np.array([ref[i][2] for i in range(self.n_models)]),
            iters=np.full(self.n_models, self.params.max_iterations),
            models=[([u.cpu().numpy() for u in ref[i][0]], ref[i][1].cpu().numpy()) for i in range(self.n_models)],
        )

    def readings(self, all_answers: list[dict], ref: dict) -> dict:
        """Three gaps per model. ``fit_gap``: reported fit against the
        reference's (every job); ``fit_self``: reported fit against the fit
        of the returned factors and weights (the sampled jobs);
        ``recon_gap``: the returned model's distance from the reference's,
        relative (the sampled jobs). Of each, per job: the largest over
        its models, their median and 99th percentile, and ``_rank_q50``,
        the largest over ranks of the median over that rank's copies (a
        rank's bucket broken moves it however few models it holds); of
        those, the largest over the jobs. ``bad``: models missing, not
        finite, malformed, or not at the forced iterations."""
        ref_fit = np.array([ref[i][2] for i in range(self.n_models)])
        groups = self._groups()
        out = {f"{name}{s}": 0.0 for name in ("fit_gap", "fit_self", "recon_gap")
               for s in ("", "_q50", "_q99", "_rank_q50")}

        def worst(name, gaps):
            """``gaps``: one job's, by queue position (NaN where none)."""
            ok = np.isfinite(gaps)
            if not ok.any():
                return
            out[name] = max(out[name], float(gaps[ok].max()))
            for q in (50, 99):
                out[f"{name}_q{q}"] = max(out[f"{name}_q{q}"], float(np.quantile(gaps[ok], q / 100)))
            for idx in groups.values():
                g = gaps[idx][ok[idx]]
                if g.size:
                    out[f"{name}_rank_q50"] = max(out[f"{name}_rank_q50"], float(np.median(g)))

        bad = 0
        for ans in all_answers:
            ok = np.isfinite(ans["fits"])
            bad += int(np.count_nonzero(~ok | (ans["iters"] != self.params.max_iterations)))
            worst("fit_gap", np.abs(ans["fits"] - ref_fit))
        p = als.Problem(self.x.to(torch.float64))
        want = {r: [(m, r) for m in self.modes] for r in groups}
        for ans in (a for a in all_answers if "models" in a):
            fit_self, recon = np.full(self.n_models, np.nan), np.full(self.n_models, np.nan)
            for r, idx in groups.items():
                got = [ans["models"][i] for i in idx]
                malformed = sum(g is None or g[1].shape != (r,) or [f.shape for f in g[0]] != want[r]
                                or not all(np.isfinite(f).all() for f in g[0]) or not np.isfinite(g[1]).all()
                                for g in got)
                if malformed:
                    bad += malformed
                    continue
                f = [torch.as_tensor(np.stack([g[0][n] for g in got]), dtype=torch.float64, device=self.device)
                     for n in range(3)]
                lam = torch.as_tensor(np.stack([g[1] for g in got]), dtype=torch.float64, device=self.device)
                fit_self[idx] = np.abs(als.model_fit(p, f, lam).cpu().numpy() - ans["fits"][idx])
                rf = [torch.stack([ref[i][0][n] for i in idx]) for n in range(3)]
                rl = torch.stack([ref[i][1] for i in idx])
                recon[idx] = als.recon_gap(f, lam, rf, rl).cpu().numpy()
            worst("fit_self", fit_self)
            worst("recon_gap", recon)
        out["bad"] = bad
        return out
