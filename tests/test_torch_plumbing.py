"""Plumbing of the PyTorch/CUDA port: bucketing and budget against the JAX
engine, parameter structs, the result wire dtype, what is not ported yet,
the device rule, and the rule that the port imports nothing of JAX."""

import ast
import dataclasses
import enum
import pathlib

import numpy as np
import pytest
import torch

import cp_cals_tpu.config as jcfg
from cp_cals_tpu.solvers import cals as jcals
from cp_cals_tpu_torch import config as pcfg
from cp_cals_tpu_torch import (
    cp_als,
    cp_batched_als,
    cp_cals,
    jk_cp_als,
    jk_cp_batched_als,
    jk_cp_cals,
    random_ktensor_host,
)
from cp_cals_tpu_torch.solvers import cals as pcals

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize(
    "bucket_ranks", [(4, 8, 16, 32), (4, 8, 12, 16, 20), (2, 4, 8), (3,), (1, 5, 7)]
)
def test_bucket_rank_matches_jax(bucket_ranks):
    for rank in range(1, 90):
        assert pcals.bucket_rank(rank, bucket_ranks) == jcals.bucket_rank(rank, bucket_ranks)


@pytest.mark.parametrize(
    "demands,budget",
    [
        ({4: 80, 8: 80, 12: 80, 16: 80, 20: 80}, 2880),
        ({4: 80, 8: 80, 12: 80, 16: 80, 20: 80}, 5760),
        ({2: 3, 4: 5, 8: 7}, 12),
        ({2: 40, 4: 1}, 16),
        ({32: 2, 64: 3}, 40),
        ({8: 1000}, 4200),
        ({1: 1}, 1),
    ],
)
def test_allocate_bucket_batches_matches_jax(demands, budget):
    assert pcals.allocate_bucket_batches(demands, budget) == jcals.allocate_bucket_batches(
        demands, budget
    )


def test_bench_allocation():
    """The bench workload's buckets and batch sizes at buffer_size=2880."""
    waves = pcals.allocate_bucket_batches({4: 80, 8: 80, 12: 80, 16: 80, 20: 80}, 2880)
    assert waves == [{4: 96, 8: 64, 12: 64, 16: 32, 20: 32}]


def _field_map(cls):
    out = {}
    for f in dataclasses.fields(cls):
        d = f.default if f.default is not dataclasses.MISSING else f.default_factory()
        out[f.name] = d.value if isinstance(d, enum.Enum) else d
    return out


@pytest.mark.parametrize("name", ["AlsParams", "CalsParams"])
def test_params_fields_and_defaults_equal_jax(name):
    port, ref = _field_map(getattr(pcfg, name)), _field_map(getattr(jcfg, name))
    if name == "CalsParams":
        # The one intended difference: the port runs a wave's buckets in
        # one thread unless asked for more (threads are slower on the card).
        assert (port.pop("bucket_threads"), ref.pop("bucket_threads")) == (1, 4)
    assert port == ref


@pytest.mark.parametrize("name", ["UpdateMethod", "MttkrpMethod", "LineSearchMethod"])
def test_enums_equal_jax(name):
    assert {m.name: m.value for m in getattr(pcfg, name)} == {
        m.name: m.value for m in getattr(jcfg, name)
    }


def _problem(dtype=np.float32):
    rng = np.random.default_rng(5)
    modes = (8, 7, 6)
    kt = random_ktensor_host(rng, modes, 2, dtype=dtype)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam) + 0.01 * rng.standard_normal(modes)
    queue = [random_ktensor_host(rng, modes, r, dtype=dtype) for r in (1, 2, 3, 2)]
    return x.astype(dtype), queue


@pytest.mark.parametrize("wire", ["float16", "bfloat16"])
def test_result_wire_dtype(wire):
    """The wire rounds only the returned factors: fits, errors, iterations
    and lam are those of the full-width run."""
    x, queue = _problem()
    kw = dict(max_iterations=5, force_max_iter=True, bucket_ranks=(4,))
    full, rep_f = cp_cals(x, queue, pcfg.CalsParams(**kw), device="cpu")
    half, rep_h = cp_cals(x, queue, pcfg.CalsParams(result_wire_dtype=wire, **kw), device="cpu")
    rel = {"float16": 1e-3, "bfloat16": 8e-3}[wire]
    for a, b, ma, mb in zip(full, half, rep_f.models, rep_h.models):
        assert (ma.iters, ma.fit, ma.approx_error) == (mb.iters, mb.fit, mb.approx_error)
        np.testing.assert_array_equal(a.lam, b.lam)
        for fa, fb in zip(a.factors, b.factors):
            assert fb.dtype == np.float32
            np.testing.assert_allclose(fb, fa, rtol=rel, atol=rel)
            assert not np.array_equal(fa, fb)


@pytest.mark.parametrize(
    "kwargs", [dict(checkpoint_dir="ckpt"), dict(trace="trace")]
)
def test_unported_engine_options_raise(kwargs, tmp_path):
    """Checkpoints and the trace raised until they were ported (ROADMAP
    queue 1 item 8); now they run: the snapshot files are written, the
    trace takes one record per engine iteration, and neither moves a
    result."""
    from cp_cals_tpu_torch.utils.timers import RunTrace

    x, queue = _problem()
    params = pcfg.CalsParams(max_iterations=4, force_max_iter=True, bucket_ranks=(4,))
    plain, _ = cp_cals(x, queue, params, device="cpu")
    if "checkpoint_dir" in kwargs:
        kwargs = dict(checkpoint_dir=str(tmp_path / kwargs["checkpoint_dir"]))
    else:
        kwargs = dict(trace=RunTrace())
    got, rep = cp_cals(x, queue, params, device="cpu", **kwargs)
    if "checkpoint_dir" in kwargs:
        assert {"bucket_r4.npz", "bucket_r4.meta.json", "done_r4.npz"} <= set(
            p.name for p in (tmp_path / "ckpt").iterdir())
    else:
        assert len(kwargs["trace"].records) == sum(rep.engine_iterations.values()) == 4
    for a, b in zip(plain, got):
        for fa, fb in zip(a.factors, b.factors):
            np.testing.assert_array_equal(fa, fb)


def test_unported_queue_entries_raise():
    """Device-generated specs run since they were ported (queue 1 item 7):
    a JAX spec carried over by ``convert.spec_from_jax`` fits; the JAX
    object itself is refused with a pointer to it."""
    from cp_cals_tpu.ktensor import RandomKtensorSpec
    from cp_cals_tpu_torch.convert import spec_from_jax

    x, _ = _problem()
    spec = RandomKtensorSpec(x.shape, 2, 0)
    res, rep = cp_cals(x, [spec_from_jax(spec)], pcfg.CalsParams(max_iterations=3), device="cpu")
    assert res[0].lam.shape == (2,) and rep.models[0].iters >= 1
    with pytest.raises(TypeError, match="spec_from_jax"):
        cp_cals(x, [spec], pcfg.CalsParams(), device="cpu")


def test_cp_cals_needs_cuda_unless_asked_for_cpu():
    """Every entry point defaults to the card and raises without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    x, queue = _problem()
    calls = [
        lambda **kw: cp_cals(x, queue, pcfg.CalsParams(), **kw),
        lambda **kw: cp_als(x, queue[1], pcfg.AlsParams(max_iterations=2), **kw),
        lambda **kw: cp_batched_als(x, [queue[1], queue[3]], pcfg.AlsParams(max_iterations=2), **kw),
        lambda **kw: jk_cp_cals(x, [queue[1]], pcfg.CalsParams(max_iterations=2), **kw),
        lambda **kw: jk_cp_batched_als(x, [queue[1]], pcfg.AlsParams(max_iterations=2), **kw),
        lambda **kw: jk_cp_als(x, [queue[1]], pcfg.AlsParams(max_iterations=2), **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
        call(device="cpu")


def _imports(path: pathlib.Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
    return names


def _forbidden(name: str) -> bool:
    return (
        name == "jax" or name.startswith("jax.")
        or name == "cp_cals_tpu" or name.startswith("cp_cals_tpu.")
    )


def test_port_imports_no_jax_and_no_jax_package():
    files = sorted((ROOT / "cp_cals_tpu_torch").rglob("*.py")) + sorted((ROOT / "tools").glob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    names = {str(p.relative_to(ROOT)) for p in files}
    assert {"cp_cals_tpu_torch/probe_overhead.py", "cp_cals_tpu_torch/utils/lsap.py",
            "cp_cals_tpu_torch/solvers/jackknife.py"} <= names
    bad = {str(p.relative_to(ROOT)): n for p in files for n in _imports(p) if _forbidden(n)}
    assert not bad, bad
    # the check matches the module name, not the prefix of the port's name
    assert not _forbidden("cp_cals_tpu_torch.ops") and _forbidden("cp_cals_tpu.ops")
