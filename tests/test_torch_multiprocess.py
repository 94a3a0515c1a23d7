"""Two fresh processes against one (counterpart of
``tests/test_multiprocess.py``): the port's ``cp_cals`` run as a
multi-process job starts it (``parallel.distributed.initialize`` on a
``file://`` store, over gloo on the CPU, then ``pod_mesh``), under a
(2, 1) and a (1, 2) mesh, equals the JAX package's single-process,
mesh-free run at 1e-11 in float64, with equal iteration counts; a run cut
after one eviction round per bucket and resumed from its snapshots by two
fresh processes equals it too. The CLI's ``--dp``/``--tp`` run in two
processes gives the single-process CLI's results, and only the
coordinator writes the CSV."""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
from _torch_mesh_worker import run_ranks

import cp_cals_tpu.config as jcfg
from cp_cals_tpu.ktensor import Ktensor as JKtensor
from cp_cals_tpu.solvers import cp_cals as jax_cp_cals
from cp_cals_tpu_torch import CalsParams, random_ktensor_host

MODES = (12, 10, 8)
RANKS = (1, 2, 3, 4) * 4
TOL = 1e-11
MESHES = {"dp": (2, 1), "tp": (1, 2)}
# A budget smaller than the queue: eviction and refill run on the mesh too.
PARAMS = dict(tol=1e-9, buffer_size=8, bucket_ranks=(2, 4))
CLI = ["-t", "9-8-7", "-c", "1:3:2", "--f64", "--seed", "4", "--tol", "1e-8", "--max-iterations", "60",
       "--noise", "0.01", "--buffer-size", "6", "--bucket-ranks", "2,4", "--device", "cpu"]


def workload():
    rng = np.random.default_rng(0)
    kt = random_ktensor_host(rng, MODES, 3, dtype=np.float64)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam) + 1e-3 * rng.standard_normal(MODES)
    return x, [random_ktensor_host(rng, MODES, r, dtype=np.float64) for r in RANKS]


@pytest.fixture(scope="module")
def oracle():
    """The JAX package's single-process, mesh-free run."""
    x, queue = workload()
    jq = [JKtensor(tuple(jnp.asarray(f) for f in kt.factors), jnp.asarray(kt.lam)) for kt in queue]
    params = jcfg.CalsParams(mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, dimtree="off", bucket_threads=1, **PARAMS)
    return jax_cp_cals(jnp.asarray(x), jq, params)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("multiprocess")


@pytest.fixture(scope="module")
def full_runs(tmp):
    """One spawn of two processes: cp_cals under each mesh, and the CLI
    under each (its CSV in a directory per mesh)."""
    x, queue = workload()
    cases = [dict(name=m, kind="cals", dp=dp, tp=tp, x=x, queue=queue, params=CalsParams(**PARAMS))
             for m, (dp, tp) in MESHES.items()]
    for m, (dp, tp) in MESHES.items():
        csv_path = os.path.join(str(tmp), f"cli-{m}.csv")
        cases.append(dict(name=f"cli-{m}", kind="cli", dp=dp, tp=tp,
                          argv=CLI + ["--dp", str(dp), "--tp", str(tp), "--csv", csv_path]))
    return run_ranks(tmp, 2, cases)


def assert_equals_oracle(got, oracle):
    res, rep = oracle
    assert [(m[0], m[2]) for m in got["models"]] == [(m.id, m.iters) for m in rep.models]
    np.testing.assert_allclose([m[4] for m in got["models"]], [m.approx_error for m in rep.models], atol=TOL)
    assert all(kt is not None for kt in got["results"])
    for a, b in zip(got["results"], res):  # queue order in both
        for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
            np.testing.assert_allclose(fa, np.asarray(fb), atol=TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_two_process_cals_equals_single_process(full_runs, oracle, mesh):
    for got in full_runs:
        assert_equals_oracle(got[mesh], oracle)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_two_process_checkpoint_resume(tmp, oracle, mesh):
    """Cut after one eviction round per bucket by two processes, resumed by
    two fresh ones: the coordinator's snapshots carry every rank's slots
    and rows."""
    dp, tp = MESHES[mesh]
    x, queue = workload()
    ckpt = os.path.join(str(tmp), f"ckpt-{mesh}")
    base = dict(kind="cals", dp=dp, tp=tp, x=x, queue=queue, params=CalsParams(**PARAMS), checkpoint_dir=ckpt)
    cut = run_ranks(tmp, 2, [dict(base, name="cut", max_rounds_per_bucket=1)])
    assert all(any(kt is None for kt in got["cut"]["results"]) for got in cut)
    assert os.path.exists(os.path.join(ckpt, "bucket_r2.meta.json"))
    for got in run_ranks(tmp, 2, [dict(base, name="resume", resume=True)]):
        assert_equals_oracle(got["resume"], oracle)


def read_csv(path):
    with open(path) as fh:
        return list(csv.reader(fh, delimiter=";"))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_two_process_cli_equals_single_process(full_runs, tmp, mesh, capsys):
    from cp_cals_tpu_torch.cli import main

    want = os.path.join(str(tmp), f"cli-single-{mesh}.csv")
    main(CLI + ["--csv", want])
    for rank, got in enumerate(full_runs):
        out = got[f"cli-{mesh}"]["stdout"]
        dp, tp = MESHES[mesh]
        assert f"Mesh: dp={dp} x tp={tp}" in out and "CALS:" in out
        assert ("wrote" in out) == (rank == 0)  # the coordinator alone writes
    rows, ref = read_csv(os.path.join(str(tmp), f"cli-{mesh}.csv")), read_csv(want)
    assert len(rows) == len(ref) > 1 and rows[0] == ref[0]
    for a, b in zip(rows[1:], ref[1:]):
        assert a[:2] == b[:2] and a[3] == b[3]  # id, rank, iterations
        assert abs(float(a[2]) - float(b[2])) < 1e-10  # error
