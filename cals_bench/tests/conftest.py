"""A benchmark at a size the CPU holds: a copy of ``cals_bench`` with a tiny
configuration, three tiny traffic mixes (model selection with the
program's lower precision as control, the same with the TF32 reference as
control, and the jackknife) and their limits, beside a ``BENCHMARK.json``
that names them. The program runs its plain PyTorch versions
(``device="cpu"``)."""

from __future__ import annotations

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path.insert(0, str(REPO))
os.environ["CP_CALS_NO_AUTOTUNE"] = "1"

TINY_CONFIG = {"source": "test", "modes": [12, 11, 10], "dtype": "float32", "true_rank": 3, "noise": 0.05,
               "assumed": [], "reduced": []}
SELECT = {
    "job": "select", "queue": {"ranks": [1, 4], "copies": 2},
    "params": {"tol": 1e-6, "max_iterations": 10, "force_max_iter": True, "buffer_size": 40, "bucket_ranks": [2, 4],
               "precision": "high", "mttkrp_precision": "default", "polish_iters": 1,
               "result_wire_dtype": "float16", "tail_compaction_depth": 0},
    "control": {"kind": "program", "override": {"precision": "default", "result_wire_dtype": "bfloat16"}},
}
SELECT_F32 = {
    "job": "select", "queue": {"ranks": [1, 4], "copies": 2},
    "params": {"tol": 1e-6, "max_iterations": 5, "force_max_iter": True, "buffer_size": 40, "bucket_ranks": [2, 4],
               "precision": "highest"},
    "control": {"kind": "reference", "tf32": True},
}
JK = {
    "job": "jackknife", "base": {"rank": 3, "tol": 1e-10, "max_sweeps": 500},
    "params": {"tol": 1e-6, "max_iterations": 50, "buffer_size": 100, "bucket_ranks": [4], "precision": "high",
               "mttkrp_precision": "default", "dimtree": "off", "tol_check_interval": 5, "polish_iters": 25,
               "polish_tol": 1e-6, "evict_batch": 4, "result_wire_dtype": "float16"},
    "reference": {"tol": 1e-12, "min_sweeps": 20, "max_sweeps": 500},
    "control": {"kind": "program", "override": {"precision": "default", "result_wire_dtype": "bfloat16"}},
}
# Limits for the tiny cells, set between the program's and the control's
# readings on the CPU (cals_bench/control.py; ten seeds and three):
# tiny.select fit_gap_rank_q50 1.4e-3 / 4.6e-3, fit_self_rank_q50 2.1e-5 /
# 3.5e-3, recon_gap_q50 5.8e-4 / 2.3e-3; tiny.f32 fit_gap_rank_q50 1.3e-6
# / 2.1e-4, fit_self_rank_q50 1.3e-6 / 1.7e-4, recon_gap_rank_q50 1.1e-6 /
# 3.2e-4; tiny.jk fit_gap 2.6e-5 / 7.6e-3, fit_self 2.5e-5 / 7.5e-3,
# recon_gap 4.7e-4 / 2.7e-3, se_ratio_gap 8.1e-4 / 4.9e-3.
LIMITS = {
    "tiny.select": {"fit_gap_rank_q50": 3e-3, "fit_self_rank_q50": 2e-4, "recon_gap_q50": 1.2e-3, "bad": 0},
    "tiny.f32": {"fit_gap_rank_q50": 2e-5, "fit_self_rank_q50": 2e-5, "recon_gap_rank_q50": 3e-5, "bad": 0},
    "tiny.jk": {"fit_gap": 3e-4, "fit_self": 3e-4, "recon_gap": 1.2e-3, "lsap_off": 0, "se_ratio_gap": 2e-3, "bad": 0},
}
CELLS = {"tiny.select": ("tiny", "tiny_select"), "tiny.f32": ("tiny", "tiny_f32"), "tiny.jk": ("tiny", "tiny_jk")}
# Each tiny cell stands in for the cell of its kind in BENCHMARK.json, and
# reports the metrics that cell reports.
STANDS_FOR = {"fluor.select50": "tiny.select", "cube300.select50": "tiny.f32", "fluor.jk299": "tiny.jk"}


def make_tiny(root: Path) -> Path:
    """The tiny benchmark under ``root``; returns its ``cals_bench`` copy."""
    bench = root / "cals_bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("tests", "out", "__pycache__"))
    (bench / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    for name, t in (("tiny_select", SELECT), ("tiny_f32", SELECT_F32), ("tiny_jk", JK)):
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(t))
    for cell, lim in LIMITS.items():
        (bench / "limits" / f"{cell}.json").write_text(json.dumps({k: {"limit": v} for k, v in lim.items()}))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"] = [dict(name=c, config=cfg, traffic=t, chips=1, why="test") for c, (cfg, t) in CELLS.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [STANDS_FOR[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    from cals_bench.registry import Registry

    root = tmp_path_factory.mktemp("tiny")
    bench = make_tiny(root)
    return Registry(root, bench)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
