"""The port's external MTTKRP study
(``cp_cals_tpu_torch/studies/bench_mttkrp_external.py``) against the JAX
repo's ``scripts/bench_mttkrp_external.py`` and ``cp_cals_tpu.ops.mttkrp``,
on the CPU in float64.

The script is loaded by path (it imports JAX only inside ``main``). Each
copied contender, the port's krp_gemm and twostep, and the C++/OpenMP
contender (3-D) are held to JAX's ``mttkrp`` and to the script's NumPy
oracle at 1e-12 relative to the oracle's largest magnitude, on every mode of
a 3-D and a 4-D tensor at ranks 2 and 3. A ``--device cpu`` run writes the
committed file's keys; the float32 fused rows (on the card in the study)
run here through the kernels' plain versions.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp_cals_tpu.ops.mttkrp import mttkrp as jax_mttkrp
from cp_cals_tpu_torch.ops.mttkrp import mttkrp as port_mttkrp
from cp_cals_tpu_torch.studies import bench_mttkrp_external as ext

ROOT = Path(__file__).resolve().parent.parent
TOL = 1e-12


def _script():
    spec = importlib.util.spec_from_file_location("_jax_script_bench_mttkrp_external",
                                                  ROOT / "scripts" / "bench_mttkrp_external.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCRIPT = _script()
CASES = [(shape, rank, mode) for shape in ((6, 5, 4), (5, 4, 3, 3)) for rank in (2, 3)
         for mode in range(len(shape))]


def _problem(shape, rank):
    rng = np.random.default_rng(sum(shape) * 10 + rank)
    x = rng.standard_normal(shape)
    return x, [rng.standard_normal((m, rank)) for m in shape]


def _rel(out, ref) -> float:
    return float(np.max(np.abs(np.asarray(out) - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("shape,rank,mode", CASES)
def test_contenders_match_jax_and_the_script_oracle(shape, rank, mode):
    x, f = _problem(shape, rank)
    oracle = SCRIPT.np_mttkrp_krp(x, f, mode)
    want = np.asarray(jax_mttkrp(jnp.asarray(x), [jnp.asarray(a) for a in f], mode, "krp_gemm"))
    assert _rel(want, oracle) <= TOL
    assert _rel(ext.np_mttkrp_krp(x, f, mode), oracle) == 0.0  # the same code
    x_t, f_t = torch.from_numpy(x), [torch.from_numpy(a) for a in f]
    got = {
        "np_twostep": ext.np_mttkrp_twostep(x, f, mode),
        "torch_krp": ext.torch_mttkrp_krp(x_t, f_t, mode).numpy(),
        "torch_twostep": ext.torch_mttkrp_twostep(x_t, f_t, mode).numpy(),
        "ours_krp": port_mttkrp(x_t, f_t, mode, "krp_gemm", "highest").numpy(),
        "ours_twostep": port_mttkrp(x_t, f_t, mode, "twostep", "highest").numpy(),
    }
    np.testing.assert_array_equal(got["np_twostep"], SCRIPT.np_mttkrp_twostep(x, f, mode))
    np.testing.assert_array_equal(got["torch_krp"], SCRIPT.torch_mttkrp_krp(x_t, f_t, mode).numpy())
    np.testing.assert_array_equal(got["torch_twostep"], SCRIPT.torch_mttkrp_twostep(x_t, f_t, mode).numpy())
    if len(shape) == 3:
        got["cpp_omp"] = ext.cpp_mttkrp3(x, f, mode)
    for name, out in got.items():
        assert out.shape == oracle.shape, name
        assert _rel(out, oracle) <= TOL, name
        assert _rel(out, want) <= TOL, name


def test_cpu_run_writes_the_committed_keys(tmp_path):
    """``--device cpu``: every contender on the CPU, each row with the
    committed file's keys (cpp_omp on 3-D tensors), every contender within
    1e-10 of the oracle, and no float32 rows (they run on the card)."""
    summary = ext.main(["--tensors", "6-5-4,5-4-3-3", "--ranks", "2,3", "--reps", "1", "--device", "cpu",
                        "--out", str(tmp_path)])
    on_disk = json.loads((tmp_path / "external_mttkrp.json").read_text())
    assert on_disk == json.loads(json.dumps(summary))
    committed = json.loads((ROOT / "data" / "benchmarks" / "external_mttkrp.json").read_text())
    assert set(committed) <= set(on_disk)
    assert on_disk["card"] == "cpu" and on_disk["device"] == "cpu"
    rows = on_disk["rows"]
    assert [(r["tensor"], r["rank"], r["mode"]) for r in rows] == [
        (t, r, m) for t, n in (("6-5-4", 3), ("5-4-3-3", 4)) for r in (2, 3) for m in range(n)]
    keys3 = set(committed["rows"][0])
    for row in rows:
        want = keys3 if row["tensor"] == "6-5-4" else keys3 - {"cpp_omp_s", "cpp_omp_gflops"}
        assert want <= set(row)
        assert set(row["devices"].values()) == {"cpu"}
        assert max(row["vs_oracle"].values()) <= ext.TOL
        assert not any(k.startswith("ours_fused") for k in row)
        assert row["flops"] > 0 and all(row[c + "_s"] > 0 for c in row["devices"])


@pytest.mark.parametrize("tier", sorted(ext.FUSED_TIERS))
def test_fused_row_keys_and_checks(tier):
    """A fused row (plain versions on the CPU): its keys, no launch counted
    off the card, the check against the plain version, and its float32
    distance from the float64 oracle."""
    x, f = _problem((6, 5, 4), 3)
    x32 = torch.from_numpy(x).float()
    f32 = [torch.from_numpy(a).float() for a in f]
    for mode in range(3):
        oracle = SCRIPT.np_mttkrp_krp(x, f, mode)
        row = ext.fused_row(x32, f32, mode, tier, 1, oracle, 100)
        key = f"ours_fused_{tier}"
        assert row[f"{key}_gate"] == "taken" and row[f"{key}_launches"] == 0
        assert row[f"{key}_vs_plain"] == 0.0
        assert row[f"{key}_vs_f64"] < (1e-6 if tier == "highest" else 5e-2)
        assert row[f"{key}_gflops"] == pytest.approx(100 / row[f"{key}_s"] / 1e9)


def test_fused_row_refused_by_the_gate_is_null(monkeypatch):
    """Where the gate refuses, the row stores null times and the gate's
    word, and nothing runs."""
    monkeypatch.setattr(ext, "fused_mttkrp_supported", lambda *a: False)
    monkeypatch.setattr(ext, "mttkrp_batched", lambda *a, **k: pytest.fail("rerouted"))
    x32 = torch.zeros((6, 5, 4))
    row = ext.fused_row(x32, [torch.zeros((n, 2)) for n in (6, 5, 4)], 0, "highest", 1, np.ones((6, 2)), 1)
    assert row == {"ours_fused_highest_s": None, "ours_fused_highest_gflops": None,
                   "ours_fused_highest_gate": "refused"}


def test_a_disagreeing_contender_fails_the_run(monkeypatch):
    monkeypatch.setattr(ext, "np_mttkrp_twostep", lambda x, f, mode: ext.np_mttkrp_krp(x, f, mode) * (1 + 1e-8))
    with pytest.raises(AssertionError, match="np_twostep disagrees with oracle"):
        ext.run("6-5-4", "2", reps=0, device="cpu")


def test_the_study_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ext.main(["--tensors", "6-5-4", "--ranks", "2"])
