"""One rank of the port's multi-process tests, and the launcher the tests
call (``run_ranks``).

A worker joins a gloo process group on a ``file://`` store (no port, so
parallel test workers cannot collide), builds the (dp, tp) mesh of each
case in its job and runs it on the CPU, then writes what it got. It
imports only the standard library, numpy, torch and the port, never JAX:

    python tests/_torch_mesh_worker.py RANK WORLD STORE JOB OUT

JOB is a pickle (written by ``run_ranks``) of a list of cases, each a dict
with a ``kind``: "step" (iterations of ``make_sharded_step``), "cals"
(``cp_cals``), "jk" (``jk_cp_cals``) or "cli" (``cli.main`` on
``argv``, in the process group already joined), and the mesh's ``dp`` and
``tp``.
OUT.RANK receives a pickle of {case name: result}.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(tmp_path, world: int, cases: list, timeout: float = 240.0) -> list:
    """Run ``cases`` in ``world`` fresh worker processes; returns each
    rank's {name: result}. A worker's non-zero exit, or one still running
    after ``timeout`` seconds, fails the caller."""
    os.makedirs(tmp_path, exist_ok=True)
    tag = f"{world}_{len(os.listdir(tmp_path))}"
    job, out, store = (os.path.join(str(tmp_path), f"{n}_{tag}") for n in ("job.pkl", "out", "store"))
    with open(job, "wb") as fh:
        pickle.dump(cases, fh)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world), store, job, out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {world} exited {p.returncode}:\n{log[-4000:]}")
    got = []
    for r in range(world):
        with open(f"{out}.{r}", "rb") as fh:
            got.append(pickle.load(fh))
    return got


def _host_kt(kt):
    import numpy as np

    return type(kt)(tuple(np.asarray(f) for f in kt.factors), np.asarray(kt.lam))


def _run_step(case, mesh):
    """``case["n"]`` iterations of the sharded step from a whole initial
    state; the whole final state's factors, lam, fit and error."""
    import numpy as np
    import torch

    from cp_cals_tpu_torch.ktensor import Ktensor
    from cp_cals_tpu_torch.parallel.sharding import Shard, make_sharded_step, tensor_rows
    from cp_cals_tpu_torch.solvers.state import init_state
    from cp_cals_tpu_torch.utils.checkpoint import rebuild

    x = torch.from_numpy(case["x"])
    kt = Ktensor(tuple(torch.from_numpy(f) for f in case["factors"]), torch.from_numpy(case["lam"]))
    x_norm = torch.linalg.vector_norm(x.reshape(-1))
    state = init_state(kt, x_norm, line_search=case["params"].line_search)
    step, x_loc, st = make_sharded_step(case["params"], mesh, x, state, shard_mode0=case["tp"] > 1)
    for _ in range(case["n"]):
        st = step(x_loc, st, x_norm)
    rows = tensor_rows(mesh, x.shape[0], case["tp"] > 1)
    shard = Shard(mesh, kt.lam.shape[0], (*rows, x.shape[0]))
    whole = rebuild(st, [torch.from_numpy(a) for a in shard.gather_state(st)])
    return dict(factors=[f.numpy() for f in whole.kt.factors], lam=whole.kt.lam.numpy(),
                fit=whole.fit.numpy(), approx_error=whole.approx_error.numpy(),
                local_rows=tuple(st.kt.factors[0].shape[:2]), counts=dict(mesh.counts),
                iters=np.asarray(whole.iters.numpy()))


def _run_cals(case, mesh):
    """``cp_cals`` on the mesh; with the names of the threads whose bucket
    loops packed eviction stats (``graph_loop.pack_evict_stats``)."""
    import threading

    from cp_cals_tpu_torch.solvers import graph_loop
    from cp_cals_tpu_torch.solvers.cals import cp_cals

    threads = set()
    real = graph_loop.pack_evict_stats

    def spy(state):
        threads.add(threading.current_thread().name)
        return real(state)

    kw = {k: case[k] for k in ("jk_fibers", "checkpoint_dir", "resume", "max_rounds_per_bucket") if k in case}
    graph_loop.pack_evict_stats = spy
    try:
        res, rep = cp_cals(case["x"], case["queue"], case["params"], mesh=mesh, shard_mode0=case["tp"] > 1, **kw)
    finally:
        graph_loop.pack_evict_stats = real
    return dict(results=[None if kt is None else _host_kt(kt) for kt in res],
                models=[(m.id, m.rank, m.iters, m.fit, m.approx_error) for m in rep.models],
                engine_iterations=dict(rep.engine_iterations),
                loop_counts={r: dict(c) for r, c in rep.loop_counts.items()}, counts=dict(mesh.counts),
                threads=sorted(threads))


def _run_jk(case, mesh):
    from cp_cals_tpu_torch.solvers.jackknife import jk_cp_cals

    rep = jk_cp_cals(case["x"], case["fitted"], case["params"], mesh=mesh, shard_mode0=case["tp"] > 1)
    return dict(results=[[_host_kt(kt) for kt in reps] for reps in rep.results],
                models=[(m.id, m.rank, m.iters, m.fit, m.approx_error) for m in rep.cals_report.models])


def _run_cli(case, mesh):
    """The CLI's output lines on this rank (its mesh is the CLI's own)."""
    import contextlib
    import io

    from cp_cals_tpu_torch.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(case["argv"])
    return dict(stdout=out.getvalue())


def main(argv) -> int:
    rank, world, store, job, out = int(argv[1]), int(argv[2]), argv[3], argv[4], argv[5]
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from cp_cals_tpu_torch.parallel import distributed

    distributed.initialize(init_method="file://" + store, backend="gloo", rank=rank, world_size=world,
                           device="cpu")
    with open(job, "rb") as fh:
        cases = pickle.load(fh)
    run = {"step": _run_step, "cals": _run_cals, "jk": _run_jk, "cli": _run_cli}
    got = {}
    for case in cases:
        mesh = distributed.pod_mesh(case["tp"], device="cpu")
        if mesh.n_dp != case["dp"]:
            raise ValueError(f"case {case['name']}: dp={case['dp']} x tp={case['tp']} on {world} processes")
        got[case["name"]] = run[case["kind"]](case, mesh)
    with open(f"{out}.{rank}", "wb") as fh:
        pickle.dump(got, fh)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
