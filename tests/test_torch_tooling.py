"""The port's MTTKRP measurement tooling on the CPU: the native OpenMP
MTTKRP (``native/mttkrp_native.py``), the ``bench_mttkrp`` CLI and the
roofline (``utils/roofline.py``)."""

import json

import numpy as np
import pytest
import torch

import cp_cals_tpu_torch.utils.lut as lut
from cp_cals_tpu_torch import bench_mttkrp
from cp_cals_tpu_torch.native import EXTRA_FLAGS, flags, library_path
from cp_cals_tpu_torch.native.mttkrp_native import mttkrp3
from cp_cals_tpu_torch.utils import roofline

SUBSCRIPTS = ("ijk,jr,kr->ir", "ijk,ir,kr->jr", "ijk,ir,jr->kr")


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_native_mttkrp_matches_einsum(mode):
    rng = np.random.default_rng(mode)
    x = rng.normal(size=(13, 11, 7))
    fs = [rng.normal(size=(m, 5)) for m in x.shape]
    got = mttkrp3(x, fs, mode)
    others = [torch.from_numpy(f) for n, f in enumerate(fs) if n != mode]
    want = torch.einsum(SUBSCRIPTS[mode], torch.from_numpy(x), *others).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_native_mttkrp_flags_and_shapes():
    """The MTTKRP builds with its own flags (the hash covers them), and
    refuses shapes it does not take."""
    assert flags("mttkrp_ref")[-len(EXTRA_FLAGS["mttkrp_ref"]):] == ("-O3", "-fopenmp")
    assert flags("lsap") == flags("tensorio") and "-fopenmp" not in flags("lsap")
    assert library_path("mttkrp_ref").parent != library_path("lsap").parent
    x = np.zeros((3, 4, 5))
    with pytest.raises(ValueError):
        mttkrp3(x, [np.zeros((3, 2)), np.zeros((4, 2)), np.zeros((5, 3))], 0)
    with pytest.raises(ValueError):
        mttkrp3(x, [np.zeros((3, 2))] * 3, 3)


def test_bench_mttkrp_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(lut, "_ROOT", str(tmp_path))
    bench_mttkrp.main(["-t", "6-5-4", "--ranks", "2,3", "--batches", "2,3", "--reps", "1", "--device", "cpu",
                       "--precision", "high,default"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 * 2 * 2 + 1 and lines[0].startswith("rank    2 batch    2 high:")
    table = json.loads(lines[-1])
    assert sorted(table) == sorted(f"{b}x{r}{t}" for b in (2, 3) for r in (2, 3) for t in ("", "@default"))
    stored = lut._load((6, 5, 4), "cpu")
    for core, winners in table.items():
        assert [stored[f"{core}:{m}"] for m in range(3)] == winners
        assert all(w in lut.METHODS for w in winners)


def test_roofline_peaks_and_fractions():
    h100 = "NVIDIA H100 80GB HBM3"
    assert roofline.device_peaks(h100) == dict(bf16_tflops=989.0, fp32_tflops=67.0, hbm_tb_s=3.35)
    assert roofline.device_peak_bf16_tflops(h100) == 989.0
    assert roofline.device_peaks("Some Other Card") is None
    assert roofline.mfu(98.9, "Some Other Card") is None
    assert roofline.mxu_utilization(1.0, "high", "Some Other Card") is None
    assert roofline.device_peaks("cpu") is None
    assert roofline.mfu(98.9, h100) == pytest.approx(0.1)
    assert roofline.mxu_utilization(98.9, "default", h100) == pytest.approx(0.1)
    assert roofline.mxu_utilization(98.9, "high", h100) == pytest.approx(0.3)
    assert roofline.mxu_utilization(33.5, "highest", h100) == pytest.approx(0.5)  # the fp32 CUDA cores
