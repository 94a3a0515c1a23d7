"""The port's user entry points against the JAX package, on the CPU in
float64: ``cp_cals`` on device-generated spec queues, the API
(``api.cp_cals``, ``cp_cals_jk``, ``cp_cals_hybrid``) with random and
explicit inits, and the CLI end to end. Both packages run the twostep
MTTKRP with the dimension tree off (the port's "auto" is off, JAX's is on
at this tier); engine results at 1e-10, the CLI's CSV errors at 1e-8."""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_cals_tpu.api as japi
import cp_cals_tpu.config as jcfg
from cp_cals_tpu.ktensor import RandomKtensorSpec as JSpec
from cp_cals_tpu.solvers.cals import cp_cals as jax_cp_cals
from cp_cals_tpu_torch import CalsParams, Ktensor, MttkrpMethod, RandomKtensorSpec, cp_cals, random_ktensor_host
from cp_cals_tpu_torch import api as papi
from cp_cals_tpu_torch.convert import host_ktensors, spec_from_jax
from cp_cals_tpu_torch.ktensor import spec_to_ktensor, to_tensor

TOL = 1e-10
MODES = (9, 8, 7)
OPTS = dict(mttkrp_method="twostep", dimtree="off")  # the API's option strings
OPTS_P = dict(mttkrp_method=MttkrpMethod.TWOSTEP, dimtree="off")
OPTS_J = dict(mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off")


def make_x(seed, rank=3, noise=1e-3):
    rng = np.random.default_rng(seed)
    kt = random_ktensor_host(rng, MODES, rank, dtype=np.float64)
    return np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam) + noise * rng.standard_normal(MODES)


def recon(kt):
    return to_tensor(Ktensor(tuple(torch.as_tensor(np.array(f)) for f in kt.factors),
                             torch.as_tensor(np.array(kt.lam)))).numpy()


def specs(ranks, seed0=100):
    return [RandomKtensorSpec(MODES, r, seed=seed0 + i, dtype="float64") for i, r in enumerate(ranks)]


def assert_close_runs(res_a, rep_a, res_b, rep_b, tol=TOL):
    for ka, kb, ma, mb in zip(res_a, res_b, rep_a.models, rep_b.models):
        assert (ma.id, ma.rank, ma.iters) == (mb.id, mb.rank, mb.iters)
        np.testing.assert_allclose(ma.approx_error, mb.approx_error, rtol=tol, atol=tol)
        np.testing.assert_allclose(recon(ka), recon(kb), atol=tol)


def test_spec_queue_matches_jax():
    """Spec models are born on the device in both packages from the same
    threefry keys; the runs agree at 1e-10 (the normalizations sum in
    other orders)."""
    x = make_x(1)
    queue = specs((1, 2, 3, 4, 5, 6, 3, 2))
    kw = dict(tol=1e-9, buffer_size=16, bucket_ranks=(2, 4, 8))
    res_p, rep_p = cp_cals(x, queue, CalsParams(**kw, **OPTS_P), device="cpu")
    jq = [JSpec(s.modes, s.rank, s.seed, s.dtype) for s in queue]
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), jq, jcfg.CalsParams(**kw, **OPTS_J))
    assert_close_runs(res_p, rep_p, res_j, rep_j)
    assert [spec_from_jax(s) for s in jq] == queue


def test_spec_queue_equals_materialized():
    """The JAX package's spec oracle (tests/test_cals.py) in the port: a
    spec queue's results equal its spec_to_ktensor queue's bit for bit,
    whatever bucket pads each model, a mixed spec/explicit block too; and
    through eviction and refill (a buffer smaller than the queue) at
    1e-10."""
    x = make_x(23)
    queue = specs((1, 2, 3, 4, 5, 6))
    params = CalsParams(tol=1e-9, buffer_size=24, bucket_ranks=(2, 4, 8))
    res_spec, rep_spec = cp_cals(x, queue, params, device="cpu")
    mats = [spec_to_ktensor(s, device="cpu") for s in queue]
    res_mat, rep_mat = cp_cals(x, mats, params, device="cpu")
    for a, b, ma, mb in zip(res_spec, res_mat, rep_spec.models, rep_mat.models):
        assert (ma.iters, ma.fit, ma.approx_error) == (mb.iters, mb.fit, mb.approx_error)
        for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
            np.testing.assert_array_equal(fa, fb)
    res_mix, _ = cp_cals(x, queue[:3] + mats[3:], params, device="cpu")
    for a, b in zip(res_mix, res_mat):
        for fa, fb in zip(a.factors, b.factors):
            np.testing.assert_array_equal(fa, fb)
    small = CalsParams(tol=1e-9, buffer_size=8, bucket_ranks=(2, 4, 8))
    res_small, rep_small = cp_cals(x, queue, small, device="cpu")
    assert_close_runs(res_small, rep_small, res_mat, rep_mat)


def test_spec_refills_build_by_window():
    """Refills take spec models generated a window of the queue at a time
    (cals.SpecAhead): 16 specs through a bucket of 4 slots, refilled at
    evictions of one or two models, build their models 3 times (the first
    batch with the next window, then two windows), not once per refill,
    and equal the spec_to_ktensor queue bit for bit; so does a queue of
    specs and explicit models interleaved."""
    x = make_x(5)
    queue = specs([1 + i % 2 for i in range(16)])
    params = CalsParams(tol=1e-9, buffer_size=8, bucket_ranks=(2,), max_iterations=60)
    mats = [spec_to_ktensor(s, device="cpu") for s in queue]
    res_mat, rep_mat = cp_cals(x, mats, params, device="cpu")
    mixed = [q if i % 3 else m for i, (q, m) in enumerate(zip(queue, mats))]
    for q in (queue, mixed):
        res, rep = cp_cals(x, q, params, device="cpu")
        assert rep.loop_counts[2]["stats_fetches"] > 8  # many rounds, most of them refilling
        assert rep.loop_counts[2]["spec_builds"] == 3
        for a, b, ma, mb in zip(res, res_mat, rep.models, rep_mat.models):
            assert (ma.iters, ma.fit, ma.approx_error) == (mb.iters, mb.fit, mb.approx_error)
            for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
                np.testing.assert_array_equal(fa, fb)


def test_spec_queue_checks():
    x = make_x(2)
    with pytest.raises(ValueError, match="spec modes"):
        cp_cals(x, [RandomKtensorSpec((9, 8, 6), 2, 0)], CalsParams(), device="cpu")
    with pytest.raises(TypeError, match="spec_from_jax"):
        cp_cals(x, [JSpec(MODES, 2, 0)], CalsParams(), device="cpu")
    # A spec's dtype sets the run's, as in the JAX engine; unset, float32.
    res, _ = cp_cals(x, [RandomKtensorSpec(MODES, 2, 0)],
                     CalsParams(max_iterations=2, force_max_iter=True), device="cpu")
    assert res[0].lam.dtype == np.float32


def _api_inits(ranks, seed):
    rng = np.random.default_rng(seed)
    kts = [random_ktensor_host(rng, MODES, r, dtype=np.float64) for r in ranks]
    return kts, [(kt.factors, kt.lam) for kt in kts]


@pytest.mark.parametrize("init", ["random", "explicit"])
def test_api_cp_cals_matches_jax(init):
    x = make_x(3)
    ranks = [2, 3, 3, 1]
    pinit, jinit = ("random", "random") if init == "random" else _api_inits(ranks, 4)
    got = papi.cp_cals(x, ranks, init=pinit, seed=5, device="cpu", dtype="float64", tol=1e-9, maxiters=80, **OPTS)
    want = japi.cp_cals(x, ranks, init=jinit, seed=5, tol=1e-9, maxiters=80, **OPTS)
    assert got.iters == want.iters
    np.testing.assert_allclose(got.errors, want.errors, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.fits, want.fits, atol=TOL)
    for a, b in zip(got.ktensors, host_ktensors(want)):
        np.testing.assert_allclose(recon(a), recon(b), atol=TOL)
    if init == "random":
        assert got.initial == [spec_from_jax(s) for s in want.initial]
        assert [s.seed for s in got.initial] == [5 * 100003 + i for i in range(4)]


def _replicates_close(a_sets, b_sets, tol):
    for a_reps, b_reps in zip(a_sets, b_sets):
        assert len(a_reps) == len(b_reps)
        for ra, rb in zip(a_reps, b_reps):
            for fa, fb in zip(ra.factors + (ra.lam,), rb.factors + (rb.lam,)):
                fa, fb = np.asarray(fa), np.asarray(fb)
                np.testing.assert_array_equal(np.isnan(fa), np.isnan(fb))
                np.testing.assert_allclose(fa[~np.isnan(fa)], fb[~np.isnan(fb)], atol=tol)


def test_api_cp_cals_jk_and_hybrid_match_jax():
    x = make_x(6, rank=2)
    kw = dict(maxiters=40, tol=1e-9, **OPTS)
    res_p, best_p, jk_p = papi.cp_cals_hybrid(x, [2, 2, 3], seed=1, device="cpu", dtype="float64", **kw)
    res_j, best_j, jk_j = japi.cp_cals_hybrid(x, [2, 2, 3], seed=1, **kw)
    assert res_p.iters == res_j.iters
    np.testing.assert_allclose(res_p.errors, res_j.errors, rtol=TOL, atol=TOL)
    assert [kt.rank for kt in best_p] == [kt.rank for kt in best_j] == [2, 3]
    for a, b in zip(best_p, host_ktensors(best_j)):
        np.testing.assert_allclose(recon(a), recon(b), atol=TOL)
    # The JK replicates are LSAP-matched, rescaled models; their entries
    # carry the runs' 1e-10 through a renormalization.
    _replicates_close(jk_p.results, jk_j.results, 1e-8)
    assert [len(r) for r in jk_p.results] == [MODES[0], MODES[0]]
    jk_again = papi.cp_cals_jk(x, best_p, device="cpu", **kw)
    _replicates_close(jk_again.results, jk_p.results, 0.0)


def test_api_defaults_and_dtype():
    """Defaults: the card (raises without one), float32."""
    x = make_x(7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            papi.cp_cals(x, [2])
    res = papi.cp_cals(x, [2], device="cpu", maxiters=3, force_max_iter=True)
    assert res.ktensors[0].lam.dtype == np.float32 and res.initial[0].dtype == "float32"
    with pytest.raises(ValueError, match="float32 or float64"):
        papi.cp_cals(x, [2], device="cpu", dtype="float16")


def _read_csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f, delimiter=";"))


def test_cli_end_to_end(tmp_path, capsys):
    """tests/test_cli.py's runs with the port's module."""
    from cp_cals_tpu_torch.cli import main

    out_csv = str(tmp_path / "out.csv")
    main(["-t", "12-10-8", "-c", "1:2:2", "--noise", "0.01", "--tol", "1e-5", "--compare-als",
          "--csv", out_csv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "CALS:" in out and "models/s" in out and "mean fit" in out
    assert "Batched ALS:" in out and "speedup" in out
    assert "Device: cpu" in out
    assert os.path.exists(out_csv)
    with open(out_csv) as f:
        assert f.readline().startswith("KTENSOR_ID")
    main(["-t", "8-7-6", "-c", "2:2:1", "--noise", "0.01", "--jk", "--max-iterations", "30",
          "--device", "cpu"])
    assert "Jackknife: 8 replicates" in capsys.readouterr().out


def test_cli_csv_matches_jax(tmp_path, capsys):
    """The same arguments through both CLIs in float64 without noise: the
    target tensors agree to rounding (the same threefry draws), the models
    are the same host draws; ids, ranks and iterations equal, errors at
    1e-8."""
    from cp_cals_tpu.cli import main as jmain
    from cp_cals_tpu_torch.cli import main as pmain

    args = ["-t", "12-10-8", "-c", "1:3:2", "--noise", "0", "--tol", "1e-8", "--f64", "--seed", "3",
            "--max-iterations", "150", "--dimtree", "off"]
    pmain(args + ["--csv", str(tmp_path / "p.csv"), "--device", "cpu"])
    jmain(args + ["--csv", str(tmp_path / "j.csv")])
    capsys.readouterr()
    rows_p, rows_j = _read_csv(tmp_path / "p.csv"), _read_csv(tmp_path / "j.csv")
    assert len(rows_p) == len(rows_j) == 6
    for a, b in zip(rows_p, rows_j):
        assert (a["KTENSOR_ID"], a["RANK"], a["ITERS"]) == (b["KTENSOR_ID"], b["RANK"], b["ITERS"])
        np.testing.assert_allclose(float(a["ERROR"]), float(b["ERROR"]), rtol=1e-8, atol=1e-8)


def test_cli_reads_tensor_files(tmp_path, capsys):
    """The CLI's generated target written with write_tensor (text, 17
    digits: exact in float64) and read back through --tensor-file gives the
    generated run's CSV, in the text format and as .npy."""
    from cp_cals_tpu_torch.cli import main
    from cp_cals_tpu_torch.ktensor import random_ktensor
    from cp_cals_tpu_torch.prng import prng_key, split
    from cp_cals_tpu_torch.tensor_io import write_tensor

    x = to_tensor(random_ktensor(split(prng_key(2), 3)[0], (10, 9, 8), 5, dtype=torch.float64)).numpy()
    write_tensor(str(tmp_path / "x.txt"), x)
    np.save(tmp_path / "x.npy", x)
    args = ["-c", "2:3:2", "--f64", "--seed", "2", "--tol", "1e-8", "--max-iterations", "60", "--device", "cpu"]
    main(["-t", "10-9-8"] + args + ["--csv", str(tmp_path / "gen.csv")])
    for name in ("x.txt", "x.npy"):
        main(["--tensor-file", str(tmp_path / name)] + args + ["--csv", str(tmp_path / f"{name}.csv")])
        assert _read_csv(tmp_path / f"{name}.csv") == _read_csv(tmp_path / "gen.csv")
    assert "Tensor (10, 9, 8), 4 models" in capsys.readouterr().out


def test_cli_multi_device_flags_raise(capsys):
    """The multi-device flags run (queue 1 item 10): on one process
    ``--distributed`` joins no group and says so, and ``--dp 1`` runs on a
    1 x 1 mesh; a mesh wider than the processes raises. The 2-process
    runs are in tests/test_torch_multiprocess.py."""
    from cp_cals_tpu_torch.cli import main

    for flags in (["--dp", "2"], ["--tp", "2"]):
        with pytest.raises(ValueError, match="does not cover"):
            main(["-t", "6-5-4", "-c", "1:1:1", "--device", "cpu"] + flags)
    main(["-t", "6-5-4", "-c", "1:2:1", "--device", "cpu", "--f64", "--distributed", "--dp", "1"])
    out = capsys.readouterr().out
    assert "host 0/1: cpu / 1 devices" in out and "Mesh: dp=1 x tp=1" in out and "CALS:" in out
