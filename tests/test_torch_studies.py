"""The port's fidelity studies (``cp_cals_tpu_torch/studies/``) against the
JAX repo's scripts they port (``scripts/convergence_run.py``,
``scripts/bench_tol.py``, ``scripts/jk_fidelity_study.py``,
``scripts/bench_external_cpd.py``), on the CPU.

The scripts are loaded by path. Their ``main`` runs with ``sys.argv`` set,
``jax.config.update`` recorded instead of applied (the test process's JAX
is already on the CPU in float64, and the scripts' compilation-cache
settings must not reach it) and their output directories pointed at
``tmp_path``; an engine call is replaced where a test needs only what the
script passes to it. Workloads are compared bit for bit (a float32 spec's
normalization to 5e-7 relative: its column norms sum in another order);
each float64 oracle stage at small sizes with equal iteration counts and
fits, bands or factors at 1e-10; each configuration's ``CalsParams``
field by field (``bucket_threads`` is the port's documented difference:
1 where JAX's is 4); the summaries on fabricated inputs.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib.util
import json
import os
import re
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_cals_tpu.config as jcfg
import cp_cals_tpu.ktensor as jkt
import cp_cals_tpu.solvers as jsolvers
import cp_cals_tpu.solvers.cals as jcals
import cp_cals_tpu_torch.solvers as psolvers
from cp_cals_tpu_torch import Ktensor
from cp_cals_tpu_torch.studies import _common
from cp_cals_tpu_torch.studies import bench_external_cpd as pbe
from cp_cals_tpu_torch.studies import bench_tol as pbt
from cp_cals_tpu_torch.studies import convergence_run as pcr
from cp_cals_tpu_torch.studies import external_cp_als as pext
from cp_cals_tpu_torch.studies import jk_fidelity_study as pjk
from cp_cals_tpu_torch.utils.analysis import benchmark_dashboard

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-10
SMALL = (13, 12, 11)


def load(path: Path, name: str):
    """A fresh module object of a file loaded by path."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def script(name: str):
    return load(ROOT / "scripts" / f"{name}.py", f"_jax_script_{name}")


class Captured(Exception):
    pass


@pytest.fixture
def run_main(monkeypatch):
    """Run a script's ``main`` with ``argv``; the jax.config updates it makes
    are recorded, not applied."""
    updates = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.append((k, v)))

    def run(mod, argv):
        monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
        return mod.main()

    run.updates = updates
    return run


def capture(monkeypatch, module, name, calls, passthrough=False):
    """Replace ``module.name`` by a recorder of its arguments that raises
    ``Captured`` (or, with ``passthrough``, calls the original and records
    its result too)."""
    real = getattr(module, name)

    def fake(*args, **kw):
        if not passthrough:
            calls.append((args, kw))
            raise Captured
        out = real(*args, **kw)
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(module, name, fake)


def fields(params) -> dict:
    return {f.name: (v.value if isinstance(v := getattr(params, f.name), enum.Enum) else v)
            for f in dataclasses.fields(params)}


def assert_params(port, ref, threads=(1, 4)):
    """Field by field; ``bucket_threads`` as ``threads`` (port's, JAX's)."""
    a, b = fields(port), fields(ref)
    assert (a.pop("bucket_threads"), b.pop("bucket_threads")) == threads
    assert a == b


def assert_models_equal(got, want):
    for a, b in zip(got, want, strict=True):
        for f, g in zip(a.factors + (a.lam,), b.factors + (b.lam,), strict=True):
            np.testing.assert_array_equal(np.asarray(f), np.asarray(g))


# ------------------------------------------------------------------ _common


def test_committed_oracles_and_baseline_rate():
    for name in _common.ORACLE_FILES:
        assert _common.committed_oracle(name)
    ext = _common.committed_oracle("external_cpd.json")["contenders"]
    assert ext and all(k.endswith("_fp64") for k in ext)
    with pytest.raises(ValueError):
        _common.committed_oracle("bench_tol_measured.json")  # a TPU's numbers
    line = (ROOT / "bench.py").read_text().splitlines()[49]
    assert float(re.fullmatch(r"BASELINE_CPU_FLOPS = (\S+)", line).group(1)) == _common.BASELINE_CPU_FLOPS


@pytest.mark.parametrize("n", [1, 7, 8, 127, 128, 129, 8191, 8192, 8193, 3 * 8192 + 5, 299 * 301 * 41])
def test_float32_sum_and_std_equal_numpy_2_0(n):
    """The bench tensor's std, written out (NumPy 2.3 sums float32 in
    another order): equal to this NumPy's (2.0, the committed oracles')
    bit for bit."""
    if not np.__version__.startswith("2.0."):
        pytest.skip(f"NumPy {np.__version__}: the reduction order written out is NumPy 2.0's")
    a = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    assert _common.sum_f32(a) == np.sum(a)
    assert _common.std_f32(a) == a.std()


def test_studies_need_the_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for mod, argv in ((pcr, []), (pbt, ["--oracle"]), (pjk, ["--oracle"]), (pbe, ["--card"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mod.main([*argv, "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_external_cp_als_is_the_tests_copy():
    ref = load(ROOT / "tests" / "external_cp_als.py", "_tests_external_cp_als")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 5, 4))
    f0 = [rng.uniform(-1, 1, (m, 3)) for m in x.shape]
    got, want = pext.cp_als_numpy(x, f0, np.ones(3), 4), ref.cp_als_numpy(x, f0, np.ones(3), 4)
    for a, b in zip(got[0] + [got[1]], want[0] + [want[1]]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pext.reconstruct(*got), ref.reconstruct(*want))


# ---------------------------------------------------------- jk_fidelity_study


def test_jk_build_inputs_bit_for_bit():
    np.testing.assert_array_equal(pjk.build_inputs(), script("jk_fidelity_study").build_inputs())


def _replicates(rng, modes, n):
    out = []
    for i in range(n):
        f = [rng.standard_normal((m, 3)) for m in modes]
        f[0][i % modes[0]] = np.nan
        out.append(types.SimpleNamespace(factors=f))
    return out


def test_jk_se_bands_and_compare_equal_the_script(tmp_path, monkeypatch):
    jks = script("jk_fidelity_study")
    rng = np.random.default_rng(1)
    modes = (7, 6, 5)
    bands = {}
    for tag in ("f64", "f32", "f32_high", "f32_default_polish_conv"):
        reps = _replicates(rng, modes, 9)
        got, want = pjk.se_bands(reps), jks.se_bands(reps)
        for a, b in zip(got, want, strict=True):
            np.testing.assert_array_equal(a, b)
        bands[tag] = got
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
        for tag, b in bands.items():
            np.savez_compressed(tmp_path / d / f"jk_fidelity_{tag}.npz", **{f"se{m}": v for m, v in enumerate(b)})
    monkeypatch.setattr(jks, "WORK", str(tmp_path / "jax"))
    monkeypatch.setattr(jks, "MODES", modes)
    monkeypatch.setattr(pjk, "MODES", modes)
    jks.compare()
    pjk.compare(str(tmp_path / "port"))
    want = json.loads((tmp_path / "jax" / "jk_fp32_vs_fp64.json").read_text())
    got = json.loads((tmp_path / "port" / "jk_fp32_vs_fp64.json").read_text())
    assert got["oracle"] == str(tmp_path / "port" / "jk_fidelity_f64.npz")
    assert {k: got[k] for k in want} == want


def _small_jk_script(monkeypatch, tmp_path):
    jks = script("jk_fidelity_study")
    monkeypatch.setattr(jks, "MODES", SMALL)
    monkeypatch.setattr(jks, "WORK", str(tmp_path))
    monkeypatch.setattr(jks, "BASE_NPZ", str(tmp_path / "jk_fidelity_base.npz"))
    monkeypatch.setattr(pjk, "MODES", SMALL)
    return jks


def test_jk_tier_params_equal_the_script(tmp_path, monkeypatch):
    jks = _small_jk_script(monkeypatch, tmp_path)
    rng = np.random.default_rng(2)
    np.savez_compressed(jks.BASE_NPZ, lam=np.ones(5), **{f"f{m}": rng.standard_normal((n, 5))
                                                         for m, n in enumerate(SMALL)})
    calls = []
    capture(monkeypatch, jsolvers, "jk_cp_cals", calls)
    cases = [(tier, False, None) for tier in pjk.TIERS.values()] + [("default", True, None), ("high", False, 7),
                                                                    ("default", False, 3)]
    for tier, is_f64, polish in cases:
        with pytest.raises(Captured):
            jks.run(jnp.float64 if is_f64 else jnp.float32, "t", tier=tier, polish=polish)
        assert_params(pjk.tier_params(tier, is_f64, polish), calls[-1][0][2])
    assert [pjk.tag_of(False, t) for t in pjk.TIERS.values()] == list(pjk.TIERS)


def test_jk_oracle_stages_equal_the_script(tmp_path, monkeypatch, run_main):
    """--prepare (cp_als from key 3, float64) and --oracle (jk_cp_cals,
    float64) at 13x12x11: the base model and the SE bands at 1e-10, every
    replicate's iterations equal."""
    jks = _small_jk_script(monkeypatch, tmp_path)
    run_main(jks, ["--prepare"])
    port_base = pjk.prepare("cpu", str(tmp_path / "port"))
    with np.load(jks.BASE_NPZ) as want, np.load(port_base) as got:
        assert sorted(want.files) == sorted(got.files)
        for k in want.files:
            np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL)
    calls = []
    capture(monkeypatch, jsolvers, "jk_cp_cals", calls, passthrough=True)
    jks.run(jnp.float64, "f64")
    got = pjk.run(torch.float64, "f64", base=jks.BASE_NPZ, device="cpu", out_dir=str(tmp_path / "port"))
    jrep = calls[-1][2]
    assert (sorted((m.id, m.iters) for m in got["report"].cals_report.models)
            == sorted((m.id, m.iters) for m in jrep.cals_report.models))
    assert got["n_replicates"] == SMALL[0]
    with np.load(tmp_path / "jk_fidelity_f64.npz") as want:
        for m, b in enumerate(got["bands"]):
            np.testing.assert_allclose(b, want[f"se{m}"], rtol=TOL, atol=TOL)


# ------------------------------------------------------------ convergence_run


def test_convergence_workload_and_params_equal_the_script(monkeypatch, run_main):
    crs = script("convergence_run")
    calls = []
    capture(monkeypatch, jsolvers, "cp_cals", calls)
    x64, queue64 = pcr.workload()
    argv = ["--mttkrp-precision", "default", "--tol-check", "5", "--polish", "2", "--precision", "high",
            "--tol", "1e-5", "--max-iter", "300"]
    for oracle, flags in ((True, []), (False, []), (False, argv)):
        with pytest.raises(Captured):
            run_main(crs, (["--oracle"] if oracle else []) + flags)
        x, queue, params = calls[-1][0]
        dtype = np.float64 if oracle else np.float32
        np.testing.assert_array_equal(np.asarray(x), x64.astype(dtype))
        assert_models_equal(queue, [Ktensor(tuple(f.astype(dtype) for f in kt.factors), kt.lam.astype(dtype))
                                    for kt in queue64])
        kw = dict(tol=1e-5, max_iter=300, precision="high", mttkrp_precision="default", polish=2,
                  tol_check=5) if flags else {}
        assert_params(pcr.params(**kw), params)
    assert ("jax_enable_x64", True) in run_main.updates


def test_convergence_oracle_stage_equals_the_script(tmp_path, monkeypatch, run_main):
    crs = script("convergence_run")
    monkeypatch.setattr(crs, "OUT_DIR", str(tmp_path / "jax"))
    run_main(crs, ["--oracle", "--modes", "13-12-11"])
    pcr.main(["--oracle", "--modes", "13-12-11", "--device", "cpu", "--out", str(tmp_path / "port")])
    want = json.loads((tmp_path / "jax" / "convergence_f64.json").read_text())
    got = json.loads((tmp_path / "port" / "convergence_f64.json").read_text())
    assert set(want) <= set(got) and got["dtype"] == want["dtype"] == "float64"
    assert [(m["id"], m["rank"], m["iters"]) for m in got["models"]] == [
        (m["id"], m["rank"], m["iters"]) for m in want["models"]]
    for a, b in zip(got["models"], want["models"]):
        np.testing.assert_allclose([a["fit"], a["error"]], [b["fit"], b["error"]], rtol=TOL, atol=TOL)


def _fake_models(rng, n, ids=None):
    return [types.SimpleNamespace(id=i, rank=int(rng.integers(1, 21)), iters=int(rng.integers(1, 60)),
                                  fit=float(rng.uniform(0.1, 0.95)), approx_error=float(rng.uniform(1, 9)))
            for i in (ids if ids is not None else range(n))]


def test_convergence_summary_equals_the_script(tmp_path, monkeypatch, run_main):
    crs = script("convergence_run")
    monkeypatch.setattr(crs, "OUT_DIR", str(tmp_path))
    rng = np.random.default_rng(3)
    models = _fake_models(rng, 6)
    oracle = [vars(m) for m in _fake_models(rng, 6, ids=[0, 1, 2, 4, 5])]
    oracle[2]["iters"] = 0
    (tmp_path / "convergence_f64.json").write_text(json.dumps({"models": oracle}))
    monkeypatch.setattr(jsolvers, "cp_cals", lambda *a, **k: (None, types.SimpleNamespace(models=models)))
    run_main(crs, ["--modes", "5-4-3"])
    want = json.loads((tmp_path / "convergence_tpu.json").read_text())
    got_models = [{"id": m.id, "rank": m.rank, "iters": m.iters, "fit": m.fit, "error": m.approx_error}
                  for m in models]
    got = pcr.compare(got_models, oracle)
    assert got == {k: want[k] for k in got}
    assert got_models == want["models"]


# ------------------------------------------------------------------ bench_tol


def test_bench_tol_workload_and_params_equal_the_script(monkeypatch, run_main):
    bts = script("bench_tol")
    for k in ("BENCH_BUFFER", "BENCH_THREADS", "BENCH_WIRE"):
        monkeypatch.delenv(k, raising=False)
    x_np, specs = pbt.workload()
    calls = []
    capture(monkeypatch, jcals, "precompile_buckets", calls)
    with pytest.raises(Captured):
        run_main(bts, [])
    x, queue, params = calls[-1][0]
    np.testing.assert_array_equal(np.asarray(x), x_np.astype(np.float32))
    assert [tuple(s) for s in queue] == [tuple(s) for s in specs]
    assert_params(pbt.card_params(environ={}), params)
    monkeypatch.setenv("BENCH_BUFFER", "1440")
    monkeypatch.setenv("BENCH_THREADS", "2")
    monkeypatch.setenv("BENCH_WIRE", "")
    argv = ["--tol-check", "0", "--polish", "1", "--polish-tol", "1e-6", "--mttkrp-tier", "", "--evict-batch", "8",
            "--max-iter", "500", "--tol", "1e-5", "--precision", "highest"]
    with pytest.raises(Captured):
        run_main(bts, argv)
    assert_params(pbt.card_params(1e-5, 500, 0, 1, 1e-6, "", "highest", 8, environ=os.environ), calls[-1][0][2],
                  threads=(2, 2))

    # The oracle leg: the float64 tensor and the params (its float32 inits
    # are stubbed here: test_bench_tol_oracle_queue holds them).
    stub = jkt.Ktensor((np.zeros((2, 1)),) * 3, np.ones(1))
    monkeypatch.setattr(jkt, "spec_to_ktensor", lambda s: stub)
    calls.clear()
    capture(monkeypatch, jsolvers, "cp_cals", calls)
    with pytest.raises(Captured):
        run_main(bts, ["--oracle", "--copies", "1"])
    x, queue, params = calls[-1][0]
    np.testing.assert_array_equal(np.asarray(x), x_np)
    assert len(queue) == 20
    assert_params(pbt.oracle_params(), params)


def test_bench_tol_oracle_queue():
    """The oracle's inits: each spec's float32 model (the port's column
    norms sum in another order than JAX's: 5e-7 relative) cast to float64."""
    specs = pbt.workload(SMALL, (1, 3), 1)[1]
    got = pbt.oracle_queue(specs, "cpu")
    for s, kt in zip(specs, got, strict=True):
        want = jkt.spec_to_ktensor(jkt.RandomKtensorSpec(*s))
        for a, b in zip(kt.factors + (kt.lam,), want.factors + (want.lam,)):
            b = np.asarray(b).astype(np.float64)
            assert a.dtype == np.float64 and a.shape == b.shape
            assert np.max(np.abs(a - b)) <= 5e-7 * np.max(np.abs(b))


def test_bench_tol_oracle_stage_equals_jax():
    """The float64 oracle at 13x12x11 (ranks 1-4, 2 copies) against JAX's
    cp_cals with the script's oracle params on the same inits."""
    x_np, specs = pbt.workload(SMALL, range(1, 5), 2)
    got = pbt.run_oracle(x_np, specs, pbt.oracle_params(), "cpu")
    queue = [jkt.Ktensor(tuple(jnp.asarray(f) for f in kt.factors), jnp.asarray(kt.lam))
             for kt in pbt.oracle_queue(specs, "cpu")]
    jp = jcfg.CalsParams(tol=1e-6, max_iterations=1000, bucket_ranks=(4, 8, 16, 20), buffer_size=2880,
                         sync_mode="evict", tail_compaction_depth=2)
    _, rep = jsolvers.cp_cals(jnp.asarray(x_np.astype(np.float64)), queue, jp)
    want = sorted(rep.models, key=lambda m: m.id)
    assert [(m["id"], m["rank"], m["iters"]) for m in got["models"]] == [(m.id, m.rank, m.iters) for m in want]
    np.testing.assert_allclose([m["fit"] for m in got["models"]], [m.fit for m in want], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("covered", [400, 300])
def test_bench_tol_summary_equals_the_script(tmp_path, monkeypatch, run_main, covered):
    """The card leg's summary on fabricated models and a fabricated oracle:
    every statistic the script's formula gives, ``vs_baseline`` from
    als_iteration_flops and BASELINE_CPU_FLOPS where the oracle covers
    every model, the coverage where it does not. Each of the script's
    three timed runs takes exactly 1 s (its clock is replaced)."""
    bts = script("bench_tol")
    for k in ("BENCH_BUFFER", "BENCH_THREADS", "BENCH_WIRE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(bts, "OUT_DIR", str(tmp_path))
    clock = iter(range(1000))
    monkeypatch.setattr(bts, "time", types.SimpleNamespace(perf_counter=lambda: float(next(clock))))
    rng = np.random.default_rng(4)
    models = _fake_models(rng, 400)
    oracle = [vars(m) for m in _fake_models(rng, covered)]
    (tmp_path / "bench_tol_f64.json").write_text(json.dumps({"models": oracle}))
    monkeypatch.setattr(jcals, "precompile_buckets", lambda *a, **k: None)
    monkeypatch.setattr(jsolvers, "cp_cals", lambda *a, **k: (None, types.SimpleNamespace(models=models)))
    run_main(bts, [])
    want = json.loads((tmp_path / "bench_tol_measured.json").read_text())
    got = pbt.compare([{"id": m.id, "rank": m.rank, "fit": m.fit, "iters": m.iters} for m in models], oracle,
                      pbt.MODES, 1.0)
    rounded = {"baseline_wall_s_same_rule", "vs_baseline"}
    assert {k for k in want if "f64" in k or k in rounded | {"n_delta_gt_1e-2", "worst_models",
                                                             "oracle_coverage"}} == set(got)
    for k, v in got.items():
        assert (round(v, 3) if k in rounded else v) == want[k], k
    assert ("vs_baseline" in got) == (covered == 400)


# --------------------------------------------------------- bench_external_cpd


def test_external_workload_and_torch_contender_equal_the_script():
    bes = script("bench_external_cpd")
    x, inits = pbe.build_workload()
    xj, initsj = bes.build_workload()
    np.testing.assert_array_equal(x, xj)
    for (f, l), (fj, lj) in zip(inits, initsj, strict=True):
        for a, b in zip(f + [l], fj + [lj]):
            np.testing.assert_array_equal(a, b)
    xs = torch.as_tensor(x[:9, :8, :7])
    f0 = [a[:n] for a, n in zip(inits[2][0], (9, 8, 7))]
    got, want = pbe.cp_als_torch(xs, f0, inits[2][1], 3), bes.cp_als_torch(xs, f0, inits[2][1], 3)
    for a, b in zip(got[0] + [got[1]], want[0] + [want[1]]):
        np.testing.assert_array_equal(a, b)


def test_external_cpu_phase_and_params_equal_the_script(tmp_path, monkeypatch, run_main):
    """The CPU phase at 13x12x11, ranks 1-3: every contender's fits and the
    port's float64 engine against JAX's (their fits at 1e-10 before the
    8-digit rounding), and the card row's params."""
    bes = script("bench_external_cpd")
    monkeypatch.setattr(bes, "MODES", SMALL)
    monkeypatch.setattr(bes, "RANKS", range(1, 4))
    monkeypatch.setattr(bes, "OUT", str(tmp_path / "external_cpd.json"))
    monkeypatch.setattr(pbe, "MODES", SMALL)
    monkeypatch.setattr(pbe, "RANKS", range(1, 4))
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    jcalls, pcalls, params = [], [], []
    capture(monkeypatch, jsolvers, "cp_cals", jcalls, passthrough=True)
    capture(monkeypatch, psolvers, "cp_cals", pcalls, passthrough=True)
    capture(monkeypatch, jcals, "precompile_buckets", params, passthrough=True)
    run_main(bes, [])
    want = json.loads((tmp_path / "external_cpd.json").read_text())
    x, inits = pbe.build_workload()
    got = pbe.cpu_phase(x, inits)
    assert got["workload"] == want["workload"]
    names = {"torch_cpu_fp64": "torch_cpu_fp64", "numpy_cpu_fp64": "numpy_cpu_fp64",
             "cp_cals_tpu_torch_on_cpu_fp64": "cp_cals_tpu_on_cpu_fp64"}
    for mine, theirs in names.items():
        np.testing.assert_allclose(got["contenders"][mine]["fits"], want["contenders"][theirs]["fits"], atol=1e-8)
    assert max(got["cross_check"].values()) < 1e-12
    pfits, jfits = pbe.fits_of(x, pcalls[-1][2][0]), bes.fit_of
    norm = float(np.linalg.norm(x))
    jfits = [jfits(x, [np.asarray(f) for f in kt.factors], np.asarray(kt.lam), norm) for kt in jcalls[-1][2][0]]
    np.testing.assert_allclose(pfits, jfits, rtol=TOL, atol=TOL)
    assert_params(pbe.port_params(), params[-1][0][2])
    assert_params(pbe.port_params(), pcalls[-1][0][2], threads=(1, 1))
    params.clear()
    capture(monkeypatch, jcals, "precompile_buckets", params)
    with pytest.raises(Captured):
        run_main(bes, ["--tpu"])
    assert_params(pbe.card_params(), params[-1][0][2])


# ----------------------------------------------------------------- dashboard


def test_dashboard_reads_every_study(tmp_path, monkeypatch):
    """Each study's stages through its ``main`` on the CPU at small sizes,
    into one directory; the files carry the JAX scripts' keys, and
    ``benchmark_dashboard`` reads them."""
    out = str(tmp_path)
    cpu = ["--device", "cpu", "--out", out]
    monkeypatch.setattr(pbt, "MODES", SMALL)
    monkeypatch.setattr(pbt, "RANKS", range(1, 4))
    monkeypatch.setattr(pjk, "MODES", SMALL)
    monkeypatch.setattr(pbe, "MODES", SMALL)
    monkeypatch.setattr(pbe, "RANKS", range(1, 4))
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    pcr.main(["--oracle", "--modes", "13-12-11", *cpu])
    conv = pcr.main(["--modes", "13-12-11", "--mttkrp-precision", "default", "--tol-check", "5", "--polish", "2",
                     *cpu])
    pbt.main(["--oracle", "--copies", "2", *cpu])
    tol = pbt.main(["--copies", "2", "--reps", "1", *cpu])
    base = pjk.main(["--prepare", *cpu])
    pjk.main(["--oracle", "--base", base, *cpu])
    for tier in ("high", "default_polish_conv"):
        pjk.main(["--tier", tier, "--base", base, *cpu])
    jk = pjk.main(["--compare", "--out", out])
    pbe.main(["--out", out])
    ext = pbe.main(["--card", *cpu])

    assert conv["oracle"] == os.path.join(out, "convergence_f64.json") and conv["max_abs_fit_delta"] < 1e-3
    script_keys = {"device", "dtype", "protocol", "tol", "max_iter", "tol_check_interval", "polish_iters",
                   "polish_tol", "evict_batch", "result_wire_dtype", "mttkrp_precision", "precision", "copies",
                   "wall_s", "models_per_sec", "mean_fit", "mean_iters", "n_max_iter_capped",
                   "max_abs_fit_delta_vs_f64", "mean_abs_fit_delta_vs_f64", "median_abs_fit_delta_vs_f64",
                   "p99_abs_fit_delta_vs_f64", "n_delta_gt_1e-2", "mean_iters_ratio_vs_f64",
                   "max_iters_ratio_vs_f64", "worst_models", "baseline_wall_s_same_rule", "vs_baseline"}
    assert script_keys <= set(tol) and tol["oracle"] == os.path.join(out, "bench_tol_f64.json")
    assert set(jk["tiers"]) == {"f32_high", "f32_default_polish_conv"}
    assert set(ext["contenders"]) == {"torch_cpu_fp64", "numpy_cpu_fp64", "cp_cals_tpu_torch_on_cpu_fp64",
                                      "cp_cals_tpu_torch_f32"}
    assert ext["contenders"]["cp_cals_tpu_torch_f32"]["reference"] == os.path.join(out, "external_cpd.json")

    dash = benchmark_dashboard(out)
    assert dash["tol_leg"] == {"models_per_sec": tol["models_per_sec"],
                               "iters_ratio_vs_f64": tol["mean_iters_ratio_vs_f64"],
                               "median_fit_delta_vs_f64": tol["median_abs_fit_delta_vs_f64"]}
    assert dash["jk_se_fidelity_p99"] == {t: [round(r["dtype_err_over_scatter_p99"], 2) for r in rows]
                                          for t, rows in jk["tiers"].items()}
    assert dash["external_cross_check"]["max_fit_diff"] == max(ext["cross_check"].values())
    assert set(dash["external_cross_check"]) == set(ext["contenders"]) | {"max_fit_diff"}
