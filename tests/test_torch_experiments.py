"""The port's experiment harness (``cp_cals_tpu_torch/experiments.py``)
against the JAX package's (``cp_cals_tpu/experiments.py``) on the CPU in
float64, at the shapes of tests/test_cli.py.

Each experiment runs in both packages from the same seeds. The engine
calls are wrapped (``monkeypatch`` on each package's ``solvers``) to
capture their reports: per-model iterations must be equal and errors
agree at 1e-10. The wrappers run every call at "highest": JAX's CPU
backend computes the bf16 tiers ("high", "default") as the exact float64
product, while the port's plain versions round the operands to bf16 as
the card does, so at "high" the two packages would compute different
functions. The experiments' timings are not compared.
"""

import csv
import dataclasses
import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_cals_tpu.config as jcfg
import cp_cals_tpu.experiments as jexp
import cp_cals_tpu.solvers as jsolvers
import cp_cals_tpu.solvers.jackknife as jjk
import cp_cals_tpu_torch.config as pcfg
import cp_cals_tpu_torch.experiments as pexp
import cp_cals_tpu_torch.solvers as psolvers

TOL = 1e-10
MODES = (10, 9, 8)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _highest(params):
    return dataclasses.replace(params, precision="highest")


class Capture:
    """Wraps a package's engine entry points: every call at "highest", and
    per call its models' (id, rank, iters, error) in id order, or with
    ``replicates`` the replicates' factors and lam (JAX's
    ``jk_cp_batched_als`` keeps no engine report)."""

    def __init__(self, monkeypatch, module, names, replicates=False):
        self.calls = []
        self.replicates = replicates
        for name in names:
            monkeypatch.setattr(module, name, self.wrap(getattr(module, name)))

    def wrap(self, fn):
        def run(x, queue, params, *args, **kw):
            out = fn(x, queue, _highest(params), *args, **kw)
            if self.replicates:
                self.calls.append([[np.asarray(f) for f in kt.factors] + [np.asarray(kt.lam)]
                                   for reps in out.results for kt in reps])
            else:
                rep = out[1] if isinstance(out, tuple) else out.cals_report
                self.calls.append(sorted((m.id, m.rank, m.iters, m.approx_error) for m in rep.models))
            return out

        return run


def capture_both(monkeypatch, names):
    return Capture(monkeypatch, jsolvers, names), Capture(monkeypatch, psolvers, names)


def assert_same_calls(cj, cp):
    assert len(cj.calls) == len(cp.calls) > 0
    for mj, mp in zip(cj.calls, cp.calls):
        assert len(mj) == len(mp) > 0
        for a, b in zip(mj, mp):
            assert a[:3] == b[:3]
            np.testing.assert_allclose(b[3], a[3], rtol=TOL, atol=TOL)


def read_csv(path):
    with open(path) as f:
        return list(csv.DictReader(f, delimiter=";"))


def assert_same_csv(path_j, path_p):
    rows_j, rows_p = read_csv(path_j), read_csv(path_p)
    assert len(rows_j) == len(rows_p) > 0
    for a, b in zip(rows_j, rows_p):
        assert (a["KTENSOR_ID"], a["RANK"], a["ITERS"]) == (b["KTENSOR_ID"], b["RANK"], b["ITERS"])
        np.testing.assert_allclose(float(b["ERROR"]), float(a["ERROR"]), rtol=TOL, atol=TOL)


def test_make_workload_matches_jax():
    """The target from JAX's threefry keys (the noise is within a few ulps
    of JAX's normal draw, not bit-equal) and the host queue bit for bit."""
    xj, qj = jexp.make_workload(MODES, 1, 3, 2, dtype=jnp.float64, seed=4)
    xp, qp = pexp.make_workload(MODES, 1, 3, 2, dtype=torch.float64, seed=4, device="cpu")
    assert xp.dtype == torch.float64 and xp.device.type == "cpu"
    xj = np.asarray(xj)
    assert np.abs(xp.numpy() - xj).max() <= 1e-12 * np.abs(xj).max()
    assert len(qj) == len(qp) == 6
    for kj, kp in zip(qj, qp):
        assert kj.rank == kp.rank
        for a, b in zip(kj.factors + (kj.lam,), kp.factors + (kp.lam,)):
            np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("update", ["unconstrained", "nnls"])
def test_compare_als_cals_matches_jax(tmp_path, update):
    """tests/test_cli.py's comparison, JAX's x given to both packages: the
    CSV rows agree (ids, ranks and iterations equal, errors at 1e-10), as
    do n_mismatched and the result's keys."""
    xj, queue = jexp.make_workload(MODES, 1, 2, 2, dtype=jnp.float64)
    kw = dict(max_iterations=5, force_max_iter=True)
    upd = dict(update_method="nnls") if update == "nnls" else {}
    res = {}
    for name, mod, cfg in (("j", jexp, jcfg), ("p", pexp, pcfg)):
        u = {k: cfg.UpdateMethod(v) for k, v in upd.items()}
        extra = dict(device="cpu") if name == "p" else {}
        res[name] = mod.compare_als_cals(
            np.asarray(xj) if name == "p" else xj, queue,
            cfg.CalsParams(bucket_ranks=(2,), **kw, **u), cfg.AlsParams(**kw, **u),
            out_dir=str(tmp_path / name), warm=False, **extra)
    assert set(res["p"]) == set(res["j"])
    assert res["p"]["n_models"] == res["j"]["n_models"] == 4
    assert res["p"]["n_mismatched"] == res["j"]["n_mismatched"] == 0
    assert res["p"]["cals_s"] > 0 and res["p"]["als_s"] > 0
    assert_same_csv(tmp_path / "j" / "cals_run.csv", tmp_path / "p" / "cals_run.csv")


def test_jackknife_experiment_matches_jax(monkeypatch):
    names = ("cp_cals", "jk_cp_cals")
    cj, cp = capture_both(monkeypatch, names)
    kw = dict(modes=(8, 7, 6), ranks=(2, 3, 5), max_iter=10)
    rj = jexp.jackknife_experiment(dtype=jnp.float64, **kw)
    rp = pexp.jackknife_experiment(dtype=torch.float64, device="cpu", **kw)
    assert set(rp) == set(rj)
    assert rp["n_replicates"] == rj["n_replicates"] == 3 * 8
    assert len(cp.calls) == 3  # the fit, the warm-up and the timed jackknife
    assert_same_calls(cj, cp)


def test_jackknife_real_experiment_matches_jax(monkeypatch, tmp_path):
    """tests/test_cli.py's file, written by each package's write_tensor."""
    from cp_cals_tpu.ktensor import random_ktensor_host
    from cp_cals_tpu.tensor_io import write_tensor as jwrite
    from cp_cals_tpu_torch.tensor_io import write_tensor as pwrite

    rng = np.random.default_rng(3)
    kt = random_ktensor_host(rng, (6, 8, 7), 3, dtype=jnp.float64)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam)
    x += 0.01 * x.std() * rng.standard_normal(x.shape)
    jwrite(str(tmp_path / "j.txt"), x)
    pwrite(str(tmp_path / "p.txt"), x)
    cj, cp = capture_both(monkeypatch, ("cp_cals", "jk_cp_cals"))
    aj = Capture(monkeypatch, jjk, ("jk_cp_batched_als",), replicates=True)
    ap = Capture(monkeypatch, psolvers, ("jk_cp_batched_als",), replicates=True)
    rj = jexp.jackknife_real_experiment(str(tmp_path / "j.txt"), ranks=(2, 3), max_iter=20, dtype=jnp.float64)
    rp = pexp.jackknife_real_experiment(str(tmp_path / "p.txt"), ranks=(2, 3), max_iter=20, dtype=torch.float64,
                                        device="cpu")
    assert set(rp) == set(rj)
    for key in ("modes", "ranks", "fits", "n_replicates"):
        assert rp[key] == rj[key], key
    assert rp["n_replicates"] == 2 * 6
    assert len(cp.calls) == 3  # the fit, the jackknife's warm-up and timed runs
    assert_same_calls(cj, cp)
    # The batched-ALS jackknife, twice: its replicates (a NaN row at each
    # left-out fiber) at 1e-10.
    assert len(ap.calls) == len(aj.calls) == 2
    for call_j, call_p in zip(aj.calls, ap.calls):
        assert len(call_j) == len(call_p) == 12
        for rep_j, rep_p in zip(call_j, call_p):
            for a, b in zip(rep_j, rep_p):
                np.testing.assert_allclose(b, a, rtol=TOL, atol=TOL, equal_nan=True)


def test_scale_sweep_matches_jax(monkeypatch):
    """The spec queue (models born from threefry seeds in both packages),
    forced iterations, the FLOP and HBM accounting."""
    cj, cp = capture_both(monkeypatch, ("cp_cals",))
    kw = dict(modes=(12, 10, 8), copies=2, rank_max=4, max_iter=3)
    rj = jexp.scale_sweep(dtype=jnp.float64, **kw)
    rp = pexp.scale_sweep(dtype=torch.float64, device="cpu", **kw)
    assert set(rp) == set(rj)  # no hbm_measured off the card
    for key in ("modes", "n_models", "mode_layouts", "mode_layouts_resolved", "hbm_model_bytes"):
        assert rp[key] == rj[key], key
    assert rp["n_models"] == 8 and rp["models_per_sec"] > 0 and rp["mttkrp_tflops"] >= 0
    assert sum(rp["lut_dispatch"].values()) > 0
    assert_same_calls(cj, cp)


def test_defrag_experiment_matches_jax(monkeypatch, tmp_path):
    """always_evict_first (the port's IterLoop) against the default policy,
    both runs of each twice (warm-up and timed)."""
    cj, cp = capture_both(monkeypatch, ("cp_cals",))
    kw = dict(modes=(12, 10, 8), rank_max=3, copies=2, max_iter=4)
    rj = jexp.defrag_experiment(out_dir=str(tmp_path / "j"), dtype=jnp.float64, **kw)
    rp = pexp.defrag_experiment(out_dir=str(tmp_path / "p"), dtype=torch.float64, device="cpu", **kw)
    assert set(rp) == set(rj) and set(rp["defrag"]) == set(rj["defrag"])
    for tag in ("defrag", "default"):
        assert rp[tag]["mean_iters"] == rj[tag]["mean_iters"]
        assert_same_csv(tmp_path / "j" / f"defrag_{tag}.csv", tmp_path / "p" / f"defrag_{tag}.csv")
    assert rp["default"]["mean_iters"] == 4
    assert len(cp.calls) == 4
    assert_same_calls(cj, cp)


def test_main_quick_merges_results(tmp_path, capsys):
    """main on the CPU: the quick defrag and scale-sweep legs, merged into
    an experiments.json that keeps an earlier run's key; nothing is written
    under data/benchmarks/ (the default --out is chiprun_out/experiments)."""
    bench_dir = os.path.join(REPO, "data", "benchmarks")
    before = {f: os.path.getmtime(os.path.join(bench_dir, f)) for f in os.listdir(bench_dir)}
    out = tmp_path / "exp"
    out.mkdir()
    (out / "experiments.json").write_text(json.dumps({"earlier": {"kept": 1}, "defrag": "old"}))
    pexp.main(["--quick", "--no-base", "--defrag", "--scale-sweep", "--device", "cpu", "--out", str(out)])
    merged = json.loads((out / "experiments.json").read_text())
    assert merged["earlier"] == {"kept": 1}
    assert merged["device"] == "cpu"
    assert merged["defrag"]["default"]["mean_iters"] == 5
    assert merged["scale_sweep"]["n_models"] == 18
    # Rounded to 2 places as JAX's: a loaded CPU's rate may read 0.0.
    assert merged["peak_bf16_tflops"] >= 0 and merged["peak_f32_tflops"] >= 0
    assert (out / "defrag_defrag.csv").exists() and (out / "defrag_default.csv").exists()
    assert {f: os.path.getmtime(os.path.join(bench_dir, f)) for f in os.listdir(bench_dir)} == before
    printed = capsys.readouterr().out
    assert "scale_sweep launches" in printed and "routes" in printed


def test_main_flags_and_default_out(monkeypatch):
    """Every flag of the JAX harness, plus --device; --out defaults to the
    git-ignored chiprun_out/experiments."""
    import argparse

    class Parsed(Exception):
        pass

    real = argparse.ArgumentParser.parse_args

    def parse_and_stop(self, args=None, namespace=None):
        raise Parsed(vars(real(self, args, namespace)))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_and_stop)
    flags = ["--quick", "--jk", "--jk-scale", "--scale-sweep", "--no-base", "--defrag", "--nnls", "--large",
             "--jk-file", "f.txt", "--jk-file-ranks", "20,20,20"]
    seen = {}
    for name, mod in (("j", jexp), ("p", pexp)):
        with pytest.raises(Parsed) as parsed:
            mod.main(flags)
        seen[name] = parsed.value.args[0]
    assert set(seen["p"]) == set(seen["j"]) | {"device"}
    assert {k: v for k, v in seen["p"].items() if k not in ("device", "out")} == \
        {k: v for k, v in seen["j"].items() if k != "out"}
    assert seen["p"]["device"] == "cuda"
    assert seen["p"]["out"] == os.path.join("chiprun_out", "experiments")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_peak_evaluator_runs(dtype):
    t = pexp.peak_evaluator(dtype, n=64, reps=3, device="cpu")
    assert np.isfinite(t) and t > 0


def test_entry_points_default_to_the_card():
    """device=None is the CUDA card: without one, the harness raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pexp.make_workload(MODES, 1, 1, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pexp.main(["--quick", "--no-base"])


def test_harness_imports_no_jax():
    """The port's harness imports neither JAX nor the JAX package."""
    with open(os.path.join(REPO, "cp_cals_tpu_torch", "experiments.py")) as f:
        src = f.read()
    imports = re.findall(r"^\s*(?:from|import)\s+([\w.]+)", src, re.M)
    assert imports and "torch" in imports
    assert not [m for m in imports if re.match(r"(jax|cp_cals_tpu)(\.|$)", m)]


def test_shipped_tables_cover_every_bucket_the_card_runs():
    """The committed H100 tables hold an exact entry (every mode, a known
    method) for each (bucket, batch, tier) chip_smoke.py and the harness run
    under AUTO (``chip_smoke.auto_tables``, measured by
    tools/lut_tables.py), so no run autotunes on the card."""
    import sys

    from cp_cals_tpu_torch.utils import lut

    sys.path.insert(0, REPO)
    import chip_smoke

    root = os.path.join(os.path.dirname(lut.__file__), "..", "lookup_tables", "cuda-NVIDIA_H100_80GB_HBM3")
    missing = []
    for modes, tier, batches in chip_smoke.auto_tables():
        path = os.path.join(root, "-".join(map(str, modes)) + ".json")
        table = json.load(open(path)) if os.path.exists(path) else {}
        for r, b in batches.items():
            missing += [(modes, tier, b, r, n) for n in range(len(modes))
                        if table.get(lut._key(b, r, n, tier)) not in lut.METHODS]
    assert not missing
