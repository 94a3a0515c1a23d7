"""The port's engine over a (dp, tp) mesh on the CPU over gloo (counterpart
of ``tests/test_sharded_cals.py``): ``cp_cals`` and ``jk_cp_cals`` in 2 and
4 fresh processes equal the JAX package's mesh-free runs at 1e-11 in
float64, with equal iteration counts, and every rank returns the whole
result list. Cases: a plain bucket, NNLS with and without each line search,
eviction and refill with a budget smaller than the queue, the jackknife,
a checkpoint cut after one eviction round and resumed, and both layout
policies; dp, tp and dp x tp. The plain buckets are also held to the JAX
package's own mesh runs on the virtual 8-device CPU mesh."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from _torch_mesh_worker import run_ranks

import cp_cals_tpu.config as jcfg
from cp_cals_tpu.ktensor import Ktensor as JKtensor
from cp_cals_tpu.parallel.sharding import make_mesh as jax_make_mesh
from cp_cals_tpu.solvers import cp_als as jax_cp_als
from cp_cals_tpu.solvers import cp_cals as jax_cp_cals
from cp_cals_tpu.solvers import jk_cp_cals as jax_jk_cp_cals
from cp_cals_tpu_torch import CalsParams, Ktensor, LineSearchMethod, UpdateMethod, random_ktensor_host

TOL = 1e-11
MODES = (8, 7, 6)


def make_problem(seed, n_models, modes=MODES, rank=4, nnls=False):
    rng = np.random.default_rng(seed)
    kt = random_ktensor_host(rng, modes, 3, dtype=np.float64)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam) + 1e-3 * rng.standard_normal(modes)
    if nnls:
        x = np.abs(x)
    return x, [random_ktensor_host(rng, modes, rank, dtype=np.float64) for _ in range(n_models)]


def jax_params(p: CalsParams) -> jcfg.CalsParams:
    """The JAX package's params of the same run: its twostep MTTKRP and
    unfused epilogue, the dimension tree as the port takes it."""
    kw = {}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        kw[f.name] = type(getattr(jcfg.CalsParams(), f.name))(v.value) if hasattr(v, "value") else v
    kw.update(mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, epilogue="xla", bucket_threads=1,
              dimtree="on" if p.dimtree == "on" else "off")
    return jcfg.CalsParams(**kw)


def jax_queue(queue):
    return [JKtensor(tuple(jnp.asarray(f) for f in kt.factors), jnp.asarray(kt.lam)) for kt in queue]


BASE = dict(tol=1e-9, bucket_ranks=(4,), buffer_size=32)
NNLS_LS = {
    "nnls-ls": dict(update_method=UpdateMethod.NNLS, line_search=True),
    "nnls": dict(update_method=UpdateMethod.NNLS),
    "ls-nec": dict(line_search=True),
    "ls-ec": dict(line_search=True, line_search_method=LineSearchMethod.ERROR_CHECKING),
}
MESH2 = {"dp": (2, 1), "tp": (1, 2)}


def cases():
    """{name: (dp, tp, kind, problem, params)}: every engine case of the
    file; ``problem`` makes (x, queue), or (x, fitted models) for "jk"."""
    out = {}
    for mesh, (dp, tp) in list(MESH2.items()) + [("dp-tp", (2, 2))]:
        out[f"plain-{mesh}"] = (dp, tp, "cals", functools.partial(make_problem, 0, 8), CalsParams(**BASE))
        # 12 models, 4 slots: at least 3 eviction and refill rounds.
        out[f"refill-{mesh}"] = (dp, tp, "cals", functools.partial(make_problem, 3, 12),
                                 CalsParams(tol=1e-9, bucket_ranks=(4,), buffer_size=16))
    for mesh, (dp, tp) in list(MESH2.items()) + [("dp-tp", (2, 2))]:
        for name, kw in NNLS_LS.items():
            if mesh == "dp-tp" and name not in ("nnls-ls", "ls-ec"):
                continue
            out[f"{name}-{mesh}"] = (dp, tp, "cals", functools.partial(make_problem, 5, 8, nnls="nnls" in name),
                                     CalsParams(**BASE, **kw))
        out[f"jk-{mesh}"] = (dp, tp, "jk", jk_problem,
                             CalsParams(max_iterations=10, force_max_iter=True, bucket_ranks=(2,)))
    for mesh, (dp, tp) in MESH2.items():
        for policy in ("materialized", "recompute"):
            out[f"{policy}-{mesh}"] = (
                dp, tp, "cals", functools.partial(make_problem, 0, 8, modes=(16, 7, 6), rank=3),
                CalsParams(tol=1e-9, bucket_ranks=(4,), buffer_size=16, mode_layouts=policy))
    return out


@functools.cache
def jk_problem():
    """The jackknife's tensor and its rank-2 model fitted by JAX's cp_als."""
    rng = np.random.default_rng(9)
    kt = random_ktensor_host(rng, MODES, 2, dtype=np.float64)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam) + 1e-3 * rng.standard_normal(MODES)
    kt0 = random_ktensor_host(rng, MODES, 2, dtype=np.float64)
    fit, _ = jax_cp_als(jnp.asarray(x), JKtensor(tuple(jnp.asarray(f) for f in kt0.factors), jnp.asarray(kt0.lam)),
                        jcfg.AlsParams(tol=1e-10, max_iterations=300))
    return x, [Ktensor(tuple(np.asarray(f) for f in fit.factors), np.asarray(fit.lam))]


CASES = cases()
RESUME = {"dp": (2, 1), "tp": (1, 2)}


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """Every case on every rank: the 2-rank cases (the checkpoint's cut run
    and then its resume among them) in one spawn, the 2 x 2 ones in
    another."""
    tmp = tmp_path_factory.mktemp("sharded_cals")
    jobs = {2: [], 4: []}
    for name, (dp, tp, kind, problem, params) in CASES.items():
        x, models = problem()
        jobs[dp * tp].append(dict(name=name, kind=kind, dp=dp, tp=tp, x=x, params=params,
                                  **{"queue" if kind == "cals" else "fitted": models}))
    x, queue = make_problem(13, 10)
    params = CalsParams(tol=1e-9, buffer_size=16, bucket_ranks=(4,))
    for mesh, (dp, tp) in RESUME.items():
        ckpt = os.path.join(str(tmp), f"ckpt-{mesh}")
        for phase, kw in (("cut", dict(max_rounds_per_bucket=1)), ("resume", dict(resume=True))):
            jobs[2].append(dict(name=f"ckpt-{phase}-{mesh}", kind="cals", dp=dp, tp=tp, x=x, queue=queue,
                                params=params, checkpoint_dir=ckpt, **kw))
    return {world: run_ranks(tmp, world, cases) for world, cases in jobs.items()}


def assert_matches(got, res, models, tol=TOL):
    """One rank's run against a reference's results and model reports."""
    assert [m[:3] for m in got["models"]] == [(m.id, m.rank, m.iters) for m in models]
    np.testing.assert_allclose([m[4] for m in got["models"]], [m.approx_error for m in models], atol=tol)
    assert len(got["results"]) == len(res)
    for a, b in zip(got["results"], res):
        for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
            np.testing.assert_allclose(fa, np.asarray(fb), atol=tol)


CALS_CASES = [n for n, c in CASES.items() if c[2] == "cals"]


@pytest.mark.parametrize("name", CALS_CASES)
def test_cp_cals_on_a_mesh_matches_jax_single_device(ranks_out, name):
    dp, tp, _, problem, params = CASES[name]
    x, queue = problem()
    res, rep = jax_cp_cals(jnp.asarray(x), jax_queue(queue), jax_params(params))
    for got in ranks_out[dp * tp]:
        assert_matches(got[name], res, rep.models)
        # tp sums inside the iteration; dp runs none there.
        assert (got[name]["counts"]["tp"] > 0) == (tp > 1)


@pytest.mark.parametrize("mesh", ["dp", "tp", "dp-tp"])
def test_jk_cp_cals_on_a_mesh_matches_jax_single_device(ranks_out, mesh):
    name = f"jk-{mesh}"
    dp, tp, _, problem, params = CASES[name]
    x, fitted = problem()
    jfit = [JKtensor(tuple(jnp.asarray(f) for f in kt.factors), jnp.asarray(kt.lam)) for kt in fitted]
    want = jax_jk_cp_cals(jnp.asarray(x), jfit, jax_params(params))
    for got in ranks_out[dp * tp]:
        reps = got[name]["results"][0]
        assert len(reps) == MODES[0]
        assert [m[2] for m in got[name]["models"]] == [m.iters for m in want.cals_report.models]
        for ka, kb in zip(reps, want.results[0]):
            for fa, fb in zip(ka.factors, kb.factors):
                fb = np.asarray(fb)
                mask = np.isfinite(fb)
                assert (mask == np.isfinite(fa)).all()
                np.testing.assert_allclose(fa[mask], fb[mask], atol=TOL)


@pytest.mark.parametrize("mesh", list(RESUME))
def test_checkpoint_cut_and_resumed_on_a_mesh(ranks_out, mesh):
    """A run cut after one eviction round per bucket, then resumed from its
    snapshots by the same ranks, equals JAX's uninterrupted mesh-free run;
    the cut run left models unfinished."""
    x, queue = make_problem(13, 10)
    params = CalsParams(tol=1e-9, buffer_size=16, bucket_ranks=(4,))
    res, rep = jax_cp_cals(jnp.asarray(x), jax_queue(queue), jax_params(params))
    for got in ranks_out[2]:
        assert any(kt is None for kt in got[f"ckpt-cut-{mesh}"]["results"])
        assert_matches(got[f"ckpt-resume-{mesh}"], res, rep.models)


@pytest.mark.parametrize("mesh", ["dp", "tp"])
def test_plain_bucket_matches_jax_mesh_run(ranks_out, mesh):
    """The JAX package's own run of the plain case on its (2, 1) or (1, 2)
    mesh of virtual devices, the port's ranks beside it."""
    dp, tp = MESH2[mesh]
    if len(jax.devices()) < dp * tp:
        pytest.skip("needs 2 virtual devices")
    _, _, _, problem, params = CASES[f"plain-{mesh}"]
    x, queue = problem()
    res, rep = jax_cp_cals(jnp.asarray(x), jax_queue(queue), jax_params(params),
                           mesh=jax_make_mesh(n_dp=dp, n_tp=tp), shard_mode0=tp > 1)
    for got in ranks_out[dp * tp]:
        assert_matches(got[f"plain-{mesh}"], res, rep.models)
