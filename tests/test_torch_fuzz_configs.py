"""A seeded sweep of engine settings on a (dp, tp) mesh (the port's
counterpart of ``tests/test_fuzz_configs.py``): configurations drawn from
that test's space, each run by the port's ``cp_cals`` in fresh processes
over gloo on the CPU under a (dp, tp) mesh, held to the JAX package's
mesh-free ``cp_cals`` of the same ``sync_mode`` and ``bucket_threads`` at
1e-10 in float64 with equal iteration counts. On a mesh the port runs its
buckets in one thread whatever ``bucket_threads`` says (the SPMD host
loop's collectives keep program order), as the JAX engine does under
several processes. The seeds are ones whose stops under
NO_ERROR_CHECKING line search do not move with rounding (a revert decided
by errors equal to 1e-13, where JAX's two loops part ways: ROADMAP queue 3,
"Checked at this re-anchor"). Seed 0 (NNLS with that line search, checks
every 5 iterations, 4-D) is such a seed: its model 8 stops after 34
iterations in the port's one-process run and 39 in JAX's, because at the
first iteration where the two part ways the revert test ``backup_err <
err`` compares errors within a few ulps of each other in both packages
(``test_seed_0_parts_from_jax_at_a_revert_tie`` steps that model in both
and holds it so)."""

import itertools
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_mesh_worker import run_ranks

import cp_cals_tpu.config as jcfg
from cp_cals_tpu.ktensor import Ktensor as JKtensor
from cp_cals_tpu.solvers import cp_cals as jax_cp_cals
from cp_cals_tpu.solvers.iteration import make_iteration as jax_make_iteration
from cp_cals_tpu.solvers.state import init_state as jax_init_state
from cp_cals_tpu_torch import CalsParams, Ktensor, LineSearchMethod, UpdateMethod, random_ktensor_host
from cp_cals_tpu_torch.solvers.iteration import make_iteration
from cp_cals_tpu_torch.solvers.state import init_state

TOL = 1e-10
SEEDS = (1, 2, 3, 4, 5)
MESHES = ((2, 1), (1, 2), (2, 2))


def sample_config(rng: random.Random) -> dict:
    """``tests/test_fuzz_configs.py:sample_config``'s space, in the port's
    params, and a mesh."""
    shape = rng.choice([(9, 8, 7), (11, 6, 5), (5, 6, 4, 3)])
    nnls = rng.random() < 0.3
    ls = rng.random() < 0.5
    return {
        "shape": shape,
        "n_models": rng.choice([5, 9, 14]),
        "ranks": rng.choice([(1, 2, 3), (2, 5), (3, 4, 6)]),
        "mesh": rng.choice(MESHES),
        "params": CalsParams(
            tol=rng.choice([1e-8, 1e-9]),
            max_iterations=rng.choice([40, 200]),
            update_method=UpdateMethod.NNLS if nnls else UpdateMethod.UNCONSTRAINED,
            line_search=ls,
            line_search_interval=rng.choice([3, 5]),
            line_search_method=rng.choice(list(LineSearchMethod)),
            buffer_size=rng.choice([10, 16, 4200]),
            bucket_ranks=rng.choice([(2, 4, 8), (4, 8), (8,)]),
            sync_mode=rng.choice(["evict", "iter"]),
            tail_compaction_depth=rng.choice([0, 2]),
            force_max_iter=rng.random() < 0.2,
            solve_method=rng.choice(["gj", "chol"]),
            tol_check_interval=rng.choice([0, 5]),
            evict_batch=rng.choice([1, 4, 16]),
            mode_layouts=rng.choice(["auto", "materialized", "recompute"]),
            dimtree=rng.choice(["auto", "on", "off"]),
            # Drawn last, so the earlier draws are those the seeds were chosen by.
            bucket_threads=rng.choice([1, 3]),
        ),
    }


def problem(seed: int, cfg: dict):
    rng = np.random.default_rng(seed)
    kt = random_ktensor_host(rng, cfg["shape"], 3, dtype=np.float64)
    x = np.einsum(",".join(f"{c}r" for c in "ijkl"[: len(cfg["shape"])]) + ",r->" + "ijkl"[: len(cfg["shape"])],
                  *kt.factors, kt.lam)
    x = x + 1e-3 * rng.standard_normal(cfg["shape"])
    ranks = itertools.cycle(cfg["ranks"])
    return x, [random_ktensor_host(rng, cfg["shape"], next(ranks), dtype=np.float64)
               for _ in range(cfg["n_models"])]


def jax_params(p: CalsParams) -> jcfg.CalsParams:
    """The JAX run of the same settings: its twostep and unfused epilogue,
    the dimension tree as the port takes it ("auto" is off in the port)."""
    return jcfg.CalsParams(
        tol=p.tol, max_iterations=p.max_iterations, update_method=jcfg.UpdateMethod(p.update_method.value),
        line_search=p.line_search, line_search_interval=p.line_search_interval,
        line_search_method=jcfg.LineSearchMethod(p.line_search_method.value), buffer_size=p.buffer_size,
        bucket_ranks=p.bucket_ranks, sync_mode=p.sync_mode, tail_compaction_depth=p.tail_compaction_depth,
        force_max_iter=p.force_max_iter, solve_method=p.solve_method, tol_check_interval=p.tol_check_interval,
        evict_batch=p.evict_batch, mode_layouts=p.mode_layouts, dimtree="on" if p.dimtree == "on" else "off",
        mttkrp_method=jcfg.MttkrpMethod.TWOSTEP, epilogue="xla", bucket_threads=p.bucket_threads)


def configs():
    return {seed: sample_config(random.Random(3000 + seed)) for seed in SEEDS}


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """Every seed's run on every rank, one spawn per world size."""
    tmp = tmp_path_factory.mktemp("fuzz")
    jobs: dict = {}
    for seed, cfg in configs().items():
        dp, tp = cfg["mesh"]
        x, queue = problem(seed, cfg)
        jobs.setdefault(dp * tp, []).append(dict(name=seed, kind="cals", dp=dp, tp=tp, x=x, queue=queue,
                                                 params=cfg["params"]))
    return {world: run_ranks(tmp, world, cases) for world, cases in jobs.items()}


@pytest.mark.parametrize("seed", SEEDS)
def test_random_config_on_a_mesh_matches_jax(ranks_out, seed):
    cfg = configs()[seed]
    dp, tp = cfg["mesh"]
    x, queue = problem(seed, cfg)
    jq = [JKtensor(tuple(jnp.asarray(f) for f in kt.factors), jnp.asarray(kt.lam)) for kt in queue]
    res, rep = jax_cp_cals(jnp.asarray(x), jq, jax_params(cfg["params"]))
    for got in ranks_out[dp * tp]:
        g = got[seed]
        assert [(m[0], m[2]) for m in g["models"]] == [(m.id, m.iters) for m in rep.models], cfg
        np.testing.assert_allclose([m[4] for m in g["models"]], [m.approx_error for m in rep.models], atol=TOL,
                                   err_msg=str(cfg))
        for a, b in zip(g["results"], res):
            for fa, fb in zip(a.factors + (a.lam,), b.factors + (b.lam,)):
                np.testing.assert_allclose(fa, np.asarray(fb), atol=TOL, err_msg=str(cfg))


@pytest.mark.parametrize("seed", SEEDS)
def test_a_mesh_runs_its_buckets_in_one_thread(ranks_out, seed):
    """Whatever ``bucket_threads`` the seed drew (1 or 3), every rank ran
    its bucket loops in its main thread: the SPMD host loop's collectives
    must keep program order on every rank."""
    cfg = configs()[seed]
    dp, tp = cfg["mesh"]
    for got in ranks_out[dp * tp]:
        assert got[seed]["threads"] == ["MainThread"], cfg


def test_seed_0_parts_from_jax_at_a_revert_tie():
    """Seed 0's model 8 (rank 6 in a bucket of rank 8), stepped alone from
    the same state by both packages' iterations as their engines run it:
    the two agree at 1e-11 until the first iteration where one reverts a
    line-search extrapolation and the other does not, and there each
    package's revert test compares two errors within four ulps (the errors
    of the whole model, about 3.25). A port fault would part the
    trajectories before such a tie, or by more than rounding."""
    cfg = sample_config(random.Random(3000))
    x, queue = problem(0, cfg)
    p = cfg["params"]
    assert p.line_search and p.line_search_method == LineSearchMethod.NO_ERROR_CHECKING, cfg
    kt, r_bucket = queue[8], 8
    pad = r_bucket - kt.lam.shape[0]
    factors = [np.pad(f, ((0, 0), (0, pad)))[None] for f in kt.factors]
    lam = np.pad(kt.lam, (0, pad))[None]
    mask = (np.arange(r_bucket) < kt.lam.shape[0])[None]
    kw = dict(nnls=True, line_search=True, mixed_tol=True)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    nj, nt = jnp.linalg.norm(xj.ravel()), torch.linalg.vector_norm(xt.reshape(-1))
    js = jax_init_state(JKtensor(tuple(map(jnp.asarray, factors)), jnp.asarray(lam)), nj,
                        rank_mask=jnp.asarray(mask), x_norm_model=nj[None], **kw)
    ts = init_state(Ktensor(tuple(map(torch.from_numpy, factors)), torch.from_numpy(lam)), nt,
                    rank_mask=torch.from_numpy(mask), x_norm_model=nt[None], **kw)
    jstep = jax.jit(jax_make_iteration(jax_params(p), batched=True))
    tstep = make_iteration(p, batched=True)
    for it in range(1, p.max_iterations + 1):
        nj_s, nt_s = jstep(xj, js, nj), tstep(xt, ts, nt)
        if int(nj_s.iters[0]) != int(nt_s.iters[0]):
            break
        js, ts = nj_s, nt_s
        for a, b in zip(ts.kt.factors + (ts.kt.lam, ts.approx_error), js.kt.factors + (js.kt.lam, js.approx_error)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-11)
        assert not bool(js.converged[0]), "seed 0 matches JAX to its stop: put it back in SEEDS"
    else:
        raise AssertionError("seed 0 matches JAX to max_iterations: put it back in SEEDS")
    # The sweep's error before the revert test: the same step with the
    # extrapolation flag cleared, which the test needs to revert.
    err_j = float(jstep(xj, js._replace(ls=js.ls._replace(updated_last=jnp.zeros_like(js.ls.updated_last))),
                        nj).approx_error[0])
    err_t = float(tstep(xt, ts._replace(ls=ts.ls._replace(updated_last=torch.zeros_like(ts.ls.updated_last))),
                        nt).approx_error[0])
    ulp = np.spacing(err_j)
    for err, backup in ((err_j, float(js.ls.backup_err[0])), (err_t, float(ts.ls.backup_err[0]))):
        assert abs(err - backup) <= 4 * ulp, (it, err, backup)
    assert abs(err_j - err_t) <= 4 * ulp, (it, err_j, err_t)
