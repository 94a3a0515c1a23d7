"""The layout-policy A/B (``tools/layout_policy_ab.py``) on the CPU.

At (12, 10, 8), 2 copies a rank (40 models of ranks 1-20), 3 forced
iterations in float64, "materialized" and "recompute" give equal iteration
counts and factors within 1e-12 (bit for bit, the tool's band), and the
file holds the committed JAX file's per-policy keys. The reckoning of the
held bytes follows ``ops/mttkrp.prepare_mode``. ``mode_layouts="auto"``
(``config.resolve_layouts``) holds the layouts on a CUDA card where they
fit a quarter of its memory (the card's memory given here), and keeps the
JAX package's 128 MB rule elsewhere.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cp_cals_tpu_torch import CalsParams, config
from cp_cals_tpu_torch.ops.mttkrp import prepare_mode

ROOT = Path(__file__).resolve().parent.parent
MODES = (12, 10, 8)


def _tool():
    spec = importlib.util.spec_from_file_location("tools_layout_policy_ab", ROOT / "tools" / "layout_policy_ab.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LAB = _tool()


@pytest.fixture(scope="module")
def ab_run():
    return LAB.ab(MODES, copies=2, max_iter=3, turns=1, dtype=torch.float64, device="cpu")


def test_policies_agree_in_float64(ab_run):
    out, last = ab_run
    (res_m, rep_m), (res_r, rep_r) = last["materialized"], last["recompute"]
    assert [m.iters for m in rep_m.models] == [m.iters for m in rep_r.models]
    assert len(res_m) == len(res_r) == 40
    for a, b in zip(res_m, res_r):
        for fa, fb in zip(a.factors, b.factors):
            np.testing.assert_allclose(np.asarray(fa), np.asarray(fb), rtol=0, atol=1e-12)
        np.testing.assert_allclose(np.asarray(a.lam), np.asarray(b.lam), rtol=1e-12, atol=0)
    assert out["checks"] == {"iteration_mismatches": 0, "max_abs_fit_diff": 0.0, "max_abs_factor_diff": 0.0}


def test_entries_have_the_committed_keys(ab_run):
    out, _ = ab_run
    committed = json.loads((ROOT / "data" / "benchmarks" / "scale_sweep_layout_policy.json").read_text())
    for policy in LAB.POLICIES:
        entry = out[policy]
        assert set(committed[policy]) <= set(entry)
        assert set(committed[policy]["hbm_model_bytes"]) <= set(entry["hbm_model_bytes"])
        assert entry["mode_layouts"] == entry["mode_layouts_resolved"] == policy
        assert entry["n_models"] == 40 and entry["modes"] == list(MODES)
        assert entry["walls_s"] == [entry["wall_s"]] and len(entry["warmups_s"]) == 1
        assert "hbm_measured" not in entry  # the card's allocator only
    assert out["card"] == "cpu"


def test_reckoned_bytes_follow_prepare_mode():
    x = torch.zeros(MODES, dtype=torch.float32)
    for tier in ("highest", "high", "default"):
        for mode in range(3):
            held = prepare_mode(x, mode, "pallas", tier)
            base = held if held._base is None else held._base
            assert LAB.layout_bytes(MODES, mode, "pallas", tier, 4) == base.numel() * base.element_size()
    assert LAB.layout_bytes(MODES, 1, "twostep", "high", 4) == 960 * 4
    rk = LAB.reckon((500, 500, 500), 250, torch.float32, "cpu")
    # On the CPU every bucket picks the fused kernels (the heuristic): one
    # hi/lo layout a mode, k padded to 504: 500 x 500 x 504 x 2 planes x 2 bytes.
    assert rk["materialized"]["tensor"] == 500_000_000
    assert rk["materialized"]["layouts"] == {f"mode {n} pallas": 500 * 500 * 504 * 4 for n in range(3)}
    assert rk["recompute"]["held_layouts"] == 0


def test_main_writes_the_file(tmp_path):
    out = LAB.main(["--modes", "6-5-4", "--copies", "1", "--max-iter", "2", "--turns", "2", "--device", "cpu",
                    "--out", str(tmp_path)])
    on_disk = json.loads((tmp_path / "scale_sweep_layout_policy.json").read_text())
    assert on_disk == json.loads(json.dumps(out))
    assert [len(on_disk[p]["walls_s"]) for p in LAB.POLICIES] == [2, 2]
    assert on_disk["materialized"]["wall_s"] == min(on_disk["materialized"]["walls_s"])


def test_a_parting_policy_fails_the_check(ab_run):
    _, last = ab_run
    results, rep = last["recompute"]
    bumped = dataclasses.replace(rep, models=[dataclasses.replace(m, iters=m.iters + 1) for m in rep.models])
    with pytest.raises(AssertionError, match="another iteration count"):
        LAB.check({"materialized": last["materialized"], "recompute": (results, bumped)}, {}, False)
    moved = dataclasses.replace(rep, models=[dataclasses.replace(m, fit=m.fit + 1e-9) for m in rep.models])
    with pytest.raises(AssertionError, match="fits 1e-09 apart"):
        LAB.check({"materialized": last["materialized"], "recompute": (results, moved)}, {}, False)


CARD = "cuda:0"
BENCH_TIERS = dict(precision="high", mttkrp_precision="default", tol_check_interval=5, polish_iters=25)


@pytest.mark.parametrize("params, shape, device, policy, reckoned", [
    (CalsParams(precision="high"), (500, 500, 500), CARD, "materialized", 3 * 2 * 500 * 500 * 504 * 2),
    (CalsParams(precision="high"), (1400, 1400, 1400), CARD, "recompute", 3 * 2 * 1400**3 * 2),
    (CalsParams(), (300, 300, 300), CARD, "materialized", 3 * 300 * 300 * 300 * 4),
    (CalsParams(**BENCH_TIERS), (299, 301, 41), CARD, "materialized", None),
    (CalsParams(), (100, 100, 100, 100), CARD, "materialized", 4 * 400_000_000),
    (CalsParams(), (1025, 1024, 32), "cpu", "recompute", None),
    (CalsParams(), (1024, 1024, 32), "cpu", "materialized", None),
    (CalsParams(precision="high"), (500, 500, 500), "cpu", "recompute", None),
    (CalsParams(mode_layouts="materialized"), (1400, 1400, 1400), CARD, "materialized", None),
    (CalsParams(mode_layouts="materialized"), (1025, 1024, 32), "cpu", "materialized", None),
    (CalsParams(mode_layouts="recompute"), (4, 4, 4), CARD, "recompute", None),
    (CalsParams(mode_layouts="recompute"), (4, 4, 4), "cpu", "recompute", None),
], ids=["500_high_card", "1400_high_card", "300_highest_card", "299x301x41_bench_tiers_card", "100^4_card",
        "cpu_above_128MB", "cpu_at_128MB", "500_high_cpu", "materialized_card", "materialized_cpu",
        "recompute_card", "recompute_cpu"])
def test_auto_layouts_follow_the_devices_budget(monkeypatch, params, shape, device, policy, reckoned):
    """"auto" on an 80 GB card holds the layouts where their reckoned bytes
    fit 20 GB, and off the card where X fits 128 MB; an explicit policy
    passes through. A meta tensor given the device resolves as the real
    tensor does."""
    monkeypatch.setattr(config, "card_memory", lambda index: 80 * 10**9)
    meta = torch.empty(shape, device="meta")
    assert config.resolve_layouts(params, meta, device) == policy
    if reckoned is not None:
        assert config.held_layout_bytes(params, shape, 4) == reckoned
    if device == "cpu":
        assert config.resolve_layouts(params, torch.empty(shape)) == policy
