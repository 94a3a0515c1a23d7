"""A run end to end on the CPU (the harness's look for a card skipped):
the result line's schema, the command's refusals, the import check."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, REPO

from cals_bench import runner

FORBIDDEN = {"jax", "jaxlib", "flax", "cp_cals_tpu"}


def check_schema(result, reg, cell, trace):
    assert list(result)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert isinstance(result["correct"], bool) and result["attempted"] > 0 and result["failed"] == 0
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev) and dev["count"] == 1
    kind = "per_layer" if trace else "end_to_end"
    units = {m["name"]: m["unit"] for m in reg.metrics_of(cell, kind)}
    for name, m in result["metrics"].items():
        assert m["unit"] == units[name] and m["value"] > 0
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(result)


@pytest.mark.parametrize("cell", ["tiny.select", "tiny.f32", "tiny.jk"])
def test_a_sound_run_is_correct_and_well_formed(tiny, cell):
    out = runner.run(cell, 2**31 + 977, 0.3, False, "cpu", registry=tiny, log=lambda m: None)
    result = out["result"]
    check_schema(result, tiny, cell, trace=False)
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in tiny.metrics_of(cell, "end_to_end")}
    assert set(result["metrics"]) == {"tiny.select": {"models_per_s", "setup_s", "job_p90_s"},
                                      "tiny.f32": {"models_per_s.highest", "setup_s"},
                                      "tiny.jk": {"models_per_s", "setup_s", "job_p90_s"}}[cell]
    assert out["extra"]["jobs"] == len(out["extra"]["job_walls_s"]) >= 1


def test_per_layer_metrics_from_program_spans(tiny):
    """A traced run on the CPU: the spans' and counters' metrics are there;
    the device's (trace, peaks) are left out, never written as 0."""
    out = runner.run("tiny.jk", 11, 0.3, True, "cpu", registry=tiny, log=lambda m: None)
    result = out["result"]
    check_schema(result, tiny, "tiny.jk", trace=True)
    assert {"jk_host_pct", "engine_evict_pct", "stats_fetches_per_iter"} <= set(result["metrics"])
    assert not {"device_idle_pct", "mttkrp_roofline_pct", "als_mfu_pct"} & set(result["metrics"])


@pytest.mark.parametrize("kind, mix", [("select", "tiny_select"), ("jackknife", "tiny_jk")])
def test_same_seed_same_inputs(tiny, kind, mix):
    """The seed makes the tensor (and the initial models, or the base
    model fitted from the tensor): the same seed the same, another seed
    others."""
    from cals_bench.jobs import job_class

    cfg, traffic = tiny.config("tiny"), tiny.traffic(mix)
    a, b, c = (job_class(kind)(cfg, traffic, s, "cpu") for s in (2**33 + 1, 2**33 + 1, 2**33 + 2))
    assert a.x.equal(b.x) and not a.x.equal(c.x)
    if kind == "select":
        assert all(u.equal(v) for (fa, _), (fb, _) in zip(a.init, b.init) for u, v in zip(fa, fb))
    else:
        assert all(u.equal(v) for u, v in zip(a.base[0], b.base[0])) and not a.base[1].equal(c.base[1])


def test_the_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "cals_bench/run.py", "--workload", "fluor.select50", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == "" and "CUDA" in p.stderr


def test_without_the_program_a_run_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and cals_bench/, the
    program is missing and a run cannot produce a result."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "cals_bench", ignore=shutil.ignore_patterns("out", "__pycache__"))
    code = ("import sys; sys.path.insert(0, '.'); from cals_bench import runner; "
            "runner.run('fluor.select50', 1, 0.1, False, 'cpu')")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": ""})
    assert p.returncode != 0 and "cp_cals_tpu_torch" in p.stderr


def imports_of(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            yield node.args[0].value


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    """Whole top-level names: cp_cals_tpu_torch is the program and allowed,
    cp_cals_tpu (the JAX package) is not."""
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    files += list((REPO / "cp_cals_tpu_torch").rglob("*.py"))
    found = {(str(p), m) for p in files for m in imports_of(p) if m.split(".")[0] in FORBIDDEN}
    assert not found
    assert runner.forbidden_modules(["cp_cals_tpu_torch.solvers", "jaxtyping", "flax.linen", "cp_cals_tpu"]) == [
        "cp_cals_tpu", "flax.linen"]


def test_the_reference_imports_nothing_of_the_program():
    for p in (BENCH / "reference").glob("*.py"):
        assert not {m for m in imports_of(p) if m.split(".")[0] in FORBIDDEN | {"cp_cals_tpu_torch"}}


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'cals_bench/tests'); import conftest; from pathlib import Path; "
            "import tempfile; from cals_bench import runner; from cals_bench.registry import Registry; "
            "root = Path(tempfile.mkdtemp()); reg = Registry(root, conftest.make_tiny(root)); "
            "runner.run('tiny.select', 3, 0.1, False, 'cpu', registry=reg, log=lambda m: None); "
            "print(runner.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_on_the_card(cuda):
    """The command itself on a card: a short run of the cheapest cell."""
    p = subprocess.run([sys.executable, "cals_bench/run.py", "--workload", "fluor.select50", "--seed", "7",
                        "--seconds", "2", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
