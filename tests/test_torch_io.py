"""The port's host tooling on the CPU: tensor files (native reader and
writer against their NumPy versions and against the JAX package's files),
the native LSAP solver against its NumPy version, the CSV writers read back
by the analysis helpers, and the native libraries' build."""

import filecmp
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from cp_cals_tpu import tensor_io as jio
from cp_cals_tpu_torch import native, tensor_io as pio
from cp_cals_tpu_torch.solvers.cals import CalsModelReport, CalsReport
from cp_cals_tpu_torch.utils import analysis
from cp_cals_tpu_torch.utils.lsap import solve_lsap, solve_lsap_py
from cp_cals_tpu_torch.utils.timers import IterationRecord, RunTrace, write_cals_report_csv, write_ktensor_results_csv

SHAPES = [(5, 4, 3), (2, 3, 4, 5), (7, 1, 2)]


def tensor(shape, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape)
    x.flat[0] = 1e-300  # extremes survive the 17-digit text round trip
    x.flat[-1] = -3.5e200
    return x


@pytest.mark.parametrize("shape", SHAPES)
def test_text_round_trip_and_layout(tmp_path, shape):
    x = tensor(shape)
    p = str(tmp_path / "t.txt")
    pio.write_tensor(p, x)
    np.testing.assert_array_equal(pio.read_tensor(p), x)
    with open(p) as f:  # column-major on disk: the first mode runs fastest
        assert f.readline().split() == [str(m) for m in shape]
        vals = [float(f.readline()) for _ in range(shape[0])]
    np.testing.assert_array_equal(vals, x[(slice(None),) + (0,) * (len(shape) - 1)])


@pytest.mark.parametrize("shape", SHAPES)
def test_native_against_plain(tmp_path, shape):
    """Native writer and reader against the NumPy versions: the same bytes
    on disk, the same bits back."""
    x = tensor(shape, 1)
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    pio.write_tensor(a, x)
    pio.write_tensor_py(b, x)
    assert filecmp.cmp(a, b, shallow=False)
    np.testing.assert_array_equal(pio.read_tensor(a), pio.read_tensor_py(a))


@pytest.mark.parametrize("shape", SHAPES)
def test_files_cross_with_jax(tmp_path, shape):
    x = tensor(shape, 2)
    j, p = str(tmp_path / "j.txt"), str(tmp_path / "p.txt")
    jio.write_tensor(j, x)
    pio.write_tensor(p, x)
    assert filecmp.cmp(j, p, shallow=False)
    np.testing.assert_array_equal(pio.read_tensor(j), x)
    np.testing.assert_array_equal(jio.read_tensor(p), x)


def test_npy_npz_and_torch_input(tmp_path):
    import torch

    x = tensor((5, 4, 3), 3)
    np.save(tmp_path / "t.npy", x)
    np.testing.assert_array_equal(pio.read_tensor(str(tmp_path / "t.npy")), x)
    np.savez(tmp_path / "t.npz", x=x, y=x + 1)
    np.testing.assert_array_equal(pio.read_tensor(str(tmp_path / "t.npz")), x)
    np.savez(tmp_path / "u.npz", x + 2)
    np.testing.assert_array_equal(pio.read_tensor(str(tmp_path / "u.npz")), x + 2)
    x32 = np.random.default_rng(5).standard_normal((3, 2, 2)).astype(np.float32)
    pio.write_tensor(str(tmp_path / "t.txt"), torch.from_numpy(x32))
    np.testing.assert_array_equal(pio.read_tensor(str(tmp_path / "t.txt")), x32)
    with pytest.raises(FileNotFoundError):
        pio.read_tensor(str(tmp_path / "missing.txt"))
    (tmp_path / "short.txt").write_text("2 2 2\n1\n2\n")
    with pytest.raises(IOError, match="truncated"):
        pio.read_tensor(str(tmp_path / "short.txt"))


@pytest.mark.parametrize("shape", [(1, 1), (4, 4), (8, 8), (3, 7), (7, 3), (20, 20), (5, 12)])
def test_native_lsap_against_plain(shape):
    rng = np.random.default_rng(sum(shape))
    for trial in range(20):
        cost = rng.standard_normal(shape)
        for maximize in (False, True):
            got = solve_lsap(cost, maximize)
            want = solve_lsap_py(cost, maximize)
            np.testing.assert_array_equal(got, want)
            assigned = got[got >= 0]
            assert len(set(assigned.tolist())) == len(assigned) == min(shape)


def test_csv_writers_read_back(tmp_path):
    models = [CalsModelReport(id=0, rank=3, iters=10, fit=0.9, approx_error=1.5),
              CalsModelReport(id=1, rank=3, iters=12, fit=0.95, approx_error=0.7),
              CalsModelReport(id=2, rank=5, iters=7, fit=0.99, approx_error=0.2)]
    p = str(tmp_path / "res.csv")
    write_ktensor_results_csv(p, models)
    back = analysis.read_results_csv(p)
    assert [(r.id, r.rank, r.error, r.iters) for r in back] == [(m.id, m.rank, m.approx_error, m.iters)
                                                                for m in models]
    s = analysis.summarize(back)
    assert s["n_models"] == 3 and s["total_iters"] == 29
    assert s["best_error_by_rank"] == {3: 0.7, 5: 0.2}
    assert analysis.speedup(3.0, 1.5) == 2.0

    rep = CalsReport(n_ktensors=3, ktensor_comp_sum=11, models=models, phase_times={4: {"setup": 0.5}})
    from cp_cals_tpu_torch import CalsParams

    p2 = str(tmp_path / "rep.csv")
    write_cals_report_csv(p2, rep, CalsParams(tol=1e-5))
    text = open(p2).read()
    assert "# tol=1e-05" in text and "# bucket_4_times=setup=0.5000" in text
    assert "KTENSOR_ID;RANK;ERROR;FIT;ITERS" in text

    tr = RunTrace()
    tr.add(IterationRecord(1, 4, 64, 1000, 0.01, bucket=4))
    tr.add(IterationRecord(2, 3, 48, 900, 0.009, bucket=4))
    p3 = str(tmp_path / "trace.csv")
    tr.write_csv(p3)
    assert tr.total_flops == 1900 and abs(tr.total_time - 0.019) < 1e-12
    rows = analysis.read_trace_csv(p3)
    assert rows[1] == {"ITER": "2", "MODELS": "3", "COLS": "48", "FLOPS": "900", "TIME": "0.009000000",
                       "BUCKET": "4"}


def test_native_build_is_safe_across_processes(tmp_path):
    """Four processes build the tensor-file library into one empty build
    directory at once; each loads a whole library and parses a file."""
    x = tensor((4, 3, 2), 4)
    path = str(tmp_path / "t.txt")
    pio.write_tensor_py(path, x)
    script = textwrap.dedent(f"""
        import numpy as np, pathlib
        from cp_cals_tpu_torch import native, tensor_io
        native.BUILD_ROOT = pathlib.Path({str(tmp_path / "build")!r})
        print(np.abs(tensor_io.read_tensor({path!r})).sum().hex())
    """)
    root = pathlib.Path(__file__).resolve().parent.parent
    procs = [subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=root) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    assert {o[0].strip() for o in outs} == {np.abs(x).sum().hex()}
    built = list((tmp_path / "build").rglob("*"))
    assert [p.name for p in built if p.is_file()] == ["libtensorio.so"]  # no temporary file left


def test_failed_build_raises(tmp_path, monkeypatch):
    """No quiet fallback: a source that does not compile raises."""
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", tmp_path)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ broken.cpp failed"):
        native.load("broken")
