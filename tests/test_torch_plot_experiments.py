"""The port's figures (``cp_cals_tpu_torch/plot_experiments.py``) against
the JAX repo's ``scripts/plot_experiments.py``, on the CPU.

Both are fed the same committed JAX files, each under the name its reader
expects (the port reads ``profile.json`` from ``--profiles`` and
``convergence_cuda.json`` where the script reads ``profile_r20_b96.json``
and ``convergence_tpu.json``), and must write the same PNG names, each
non-empty. The committed profile holds its MTTKRP rows at "default" only,
so a second case renames them to the "high" keys both read, and all six
figures are drawn. Without matplotlib the module prints its skip line.
"""

from __future__ import annotations

import builtins
import importlib.util
import json
import shutil
from pathlib import Path

import pytest

from cp_cals_tpu_torch import plot_experiments as pe

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "data" / "benchmarks"


def _script():
    pytest.importorskip("matplotlib")
    spec = importlib.util.spec_from_file_location("_jax_script_plot_experiments",
                                                  ROOT / "scripts" / "plot_experiments.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _profile(high: bool) -> dict:
    prof = json.loads((BENCH / "profile_r20_b96.json").read_text())
    if high:
        prof = {k.replace("_default", "_high") if k.startswith("mttkrp_m") else k: v for k, v in prof.items()}
    return prof


@pytest.mark.parametrize("high", [False, True], ids=["committed", "high-keys"])
def test_same_figures_as_the_script(tmp_path, high):
    script = _script()
    jax_in, port_data, port_prof = tmp_path / "jax_in", tmp_path / "data", tmp_path / "profiles"
    for d in (jax_in, port_data, port_prof):
        d.mkdir()
    prof = json.dumps(_profile(high))
    shutil.copy(BENCH / "experiments.json", jax_in / "experiments.json")
    shutil.copy(BENCH / "convergence_tpu.json", jax_in / "convergence_tpu.json")
    (jax_in / "profile_r20_b96.json").write_text(prof)
    shutil.copy(BENCH / "experiments.json", port_data / "experiments.json")
    shutil.copy(BENCH / "convergence_tpu.json", port_data / "convergence_cuda.json")
    (port_prof / "profile.json").write_text(prof)

    script.main(["--data", str(jax_in), "--out", str(tmp_path / "jax_out")])
    written = pe.main(["--data", str(port_data), "--profiles", str(port_prof), "--out", str(tmp_path / "port_out")])
    want = sorted(p.name for p in (tmp_path / "jax_out").glob("*.png"))
    got = sorted(p.name for p in (tmp_path / "port_out").glob("*.png"))
    assert got == want == sorted(Path(p).name for p in written)
    assert set(got) <= {"speedup.png", "jk_scale.png", "defrag.png", "mttkrp_methods.png", "roofline.png",
                        "convergence.png"}
    assert len(got) == (6 if high else 4)
    assert all((tmp_path / "port_out" / n).stat().st_size > 0 for n in got)


def test_an_absent_file_draws_nothing_and_a_stale_figure_goes(tmp_path):
    pytest.importorskip("matplotlib")
    out = tmp_path / "out"
    out.mkdir()
    (out / "speedup.png").write_bytes(b"stale")
    assert pe.main(["--data", str(tmp_path / "none"), "--profiles", str(tmp_path / "none"), "--out",
                    str(out)]) == []
    assert not list(out.glob("*.png"))


def test_without_matplotlib_prints_the_skip_line(tmp_path, monkeypatch, capsys):
    real = builtins.__import__

    def no_matplotlib(name, *a, **k):
        if name == "matplotlib" or name.startswith("matplotlib."):
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    assert pe.main(["--data", str(BENCH), "--out", str(tmp_path / "out")]) == []
    assert capsys.readouterr().out.strip() == pe.SKIP_LINE
    assert not (tmp_path / "out").exists()


def test_titles_name_the_card_line():
    assert pe.card_of({"card": "NVIDIA H100 80GB HBM3, 700.00 W", "device": "NVIDIA H100 80GB HBM3"}) == (
        "NVIDIA H100 80GB HBM3, 700.00 W")
    assert pe.card_of({}, {"device": "cpu"}) == "cpu"
    assert pe.card_of({}) == "the device"
