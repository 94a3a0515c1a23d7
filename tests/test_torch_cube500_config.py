"""The 500^3 model-selection deployment (the benchmark's configuration
``cube500``, cell ``cube500.select50_high``) at a size the CPU holds.

The cell's traffic (``cals_bench/traffic/select50_high.json``) runs
``"high"`` with ``mode_layouts`` at ``"auto"``, which on an 80 GB card
holds the three hi/lo layouts (1.512 GB, within a quarter of the card) and
off the card, above 128 MB, derives every MTTKRP layout inside the loop.
Here the cube is 14 x 13 x 12, and ``config.LAYOUT_RECOMPUTE_BYTES`` is
lowered so that ``"auto"`` on the CPU takes the derived path, or raised so
that it holds; the queue is ranks 1-4 x 2 copies, buckets 4/8, 5 forced
iterations. The program (``solvers.cp_cals``, float32) is held against the
benchmark's float64 reference (``cals_bench/reference/als.py``) from the
same initial models, and its derived-layout counters against the bytes
the layouts take.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cals_bench import data
from cals_bench.reference import als
from cp_cals_tpu_torch import Ktensor, config
from cp_cals_tpu_torch.convert import params_from_dict
from cp_cals_tpu_torch.ops.fused_mttkrp import padded_k, split_others
from cp_cals_tpu_torch.solvers import cp_cals
from cp_cals_tpu_torch.utils import timers

ROOT = Path(__file__).resolve().parent.parent
TRAFFIC = json.loads((ROOT / "cals_bench" / "traffic" / "select50_high.json").read_text())
CONFIG = json.loads((ROOT / "cals_bench" / "configs" / "cube500.json").read_text())
CFG = dict(CONFIG, modes=[14, 13, 12])
SEED = 2**31 + 22
ITERS = 5
RANKS = [r for r in range(1, 5) for _ in range(2)]
SMALL = dict(max_iterations=ITERS, bucket_ranks=[4, 8], buffer_size=40)

# Tolerances against the float64 reference after 5 forced sweeps. "high"
# holds X and the factors as bf16 hi/lo pairs and drops the lo x lo
# product: each MTTKRP is off by about 2^-16 (1.5e-5) of its terms, which
# moves a fit by about 2e-5 here and a model, through the normal
# equations, by about 1e-4 of its norm. "default" keeps one bf16 plane
# (2^-8, 4e-3): a fit moves by about 1e-2 and a model by 5e-2.
FIT_TOL = 1e-4  # max |fit - reference fit|
MODEL_TOL = 1e-3  # max |model - reference model| / |reference model|


@pytest.fixture
def recompute(monkeypatch):
    """``mode_layouts="auto"`` resolves to "recompute" at the test's size."""
    monkeypatch.setattr(config, "LAYOUT_RECOMPUTE_BYTES", 1000)


def _problem():
    x = data.tensor(CFG, SEED, "cpu")
    init = data.inits(CFG["modes"], RANKS, SEED, "cpu")
    queue = [Ktensor(tuple(f.numpy() for f in fs), lam.numpy()) for fs, lam in init]
    return x, init, queue


def _gaps(params: dict) -> tuple[float, float]:
    """(largest fit gap, largest model gap) of the program's run against
    the float64 reference."""
    x, init, queue = _problem()
    res, rep = cp_cals(x, queue, params_from_dict(params), device="cpu")
    assert config.resolve_layouts(params_from_dict(params), x) == "recompute"
    fits = {m.id: m.fit for m in rep.models}
    assert sorted(fits) == list(range(len(RANKS))) and {m.iters for m in rep.models} == {ITERS}
    p = als.Problem(x.to(torch.float64))
    fit_gap = model_gap = 0.0
    for r in sorted(set(RANKS)):
        idx = [i for i, q in enumerate(RANKS) if q == r]
        start = [torch.stack([init[i][0][n] for i in idx]).double() for n in range(3)]
        f, lam, fit, _ = als.sweeps(p, start, ITERS)
        fit_gap = max(fit_gap, max(abs(fits[i] - float(fit[k])) for k, i in enumerate(idx)))
        got = [torch.as_tensor(np.stack([res[i].factors[n] for i in idx]), dtype=torch.float64) for n in range(3)]
        got_lam = torch.as_tensor(np.stack([res[i].lam for i in idx]), dtype=torch.float64)
        model_gap = max(model_gap, float(als.recon_gap(got, got_lam, f, lam).max()))
    return fit_gap, model_gap


def test_the_traffic_parses_and_holds_its_layouts_on_an_80_gb_card(monkeypatch):
    monkeypatch.setattr(config, "card_memory", lambda index: 80 * 10**9)
    p = params_from_dict(TRAFFIC["params"])
    assert (p.precision, p.mttkrp_precision, p.mode_layouts, p.polish_iters) == ("high", None, "auto", 0)
    assert (p.bucket_ranks, p.buffer_size, p.max_iterations, p.force_max_iter) == ((4, 8, 16, 20), 3840, 50, True)
    assert (p.result_wire_dtype, p.tail_compaction_depth) == (None, 2)
    x = torch.empty(tuple(CONFIG["modes"]), dtype=getattr(torch, CONFIG["dtype"]), device="meta")
    assert x.numel() * x.element_size() == 500_000_000
    # On the card the three hi/lo layouts (1.512 GB) fit a quarter of it.
    held = config.held_layout_bytes(p, tuple(x.shape), x.element_size())
    assert held == _layout_bytes(CONFIG["modes"]) == 1_512_000_000
    assert config.resolve_layouts(p, x, "cuda:0") == "materialized"
    # Off the card the JAX package's rule: 500 MB is above 128 MB.
    assert config.resolve_layouts(p, x, "cpu") == "recompute"
    # cube300 (108 MB) holds its layouts under both rules.
    cube300 = torch.empty((300, 300, 300), device="meta")
    assert config.resolve_layouts(p, cube300, "cpu") == "materialized"
    assert config.resolve_layouts(p, cube300, "cuda:0") == "materialized"
    assert data.queue_ranks(TRAFFIC) == [r for r in range(1, 21) for _ in range(20)]


def test_recompute_at_high_agrees_with_the_float64_reference(recompute):
    fit_gap, model_gap = _gaps(dict(TRAFFIC["params"], **SMALL))
    assert fit_gap < FIT_TOL and model_gap < MODEL_TOL, (fit_gap, model_gap)


def test_one_tier_lower_breaks_the_tolerances(recompute):
    """The cell's precision control ("default") on the same run."""
    fit_gap, model_gap = _gaps(dict(TRAFFIC["params"], **SMALL, **TRAFFIC["control"]["override"]))
    assert fit_gap > FIT_TOL or model_gap > MODEL_TOL, (fit_gap, model_gap)


def _layout_bytes(modes) -> int:
    """The bytes of one sweep's fused "high" layouts: per mode the bf16
    hi/lo pair of X as [2, J, I, Kp], J the small other mode, K the big one
    padded to a multiple of 8, 2 bytes an element."""
    total = 0
    for n in range(3):
        small, big = split_others(tuple(modes), n)
        total += 2 * modes[small] * modes[n] * padded_k(modes[big]) * 2
    return total


@pytest.mark.parametrize("threshold, policy", [(1000, "recompute"), (10**12, "materialized")])
def test_derived_bytes_are_the_reckoned_layouts_per_iteration(monkeypatch, threshold, policy):
    """Under "recompute" every bucket-iteration derives the three layouts
    (``layouts.derived``, ``layouts.derived_bytes``) and nothing is held;
    under "materialized" nothing is derived and the three are held once
    (``layouts.held_bytes``, a ``layouts.build`` span each)."""
    monkeypatch.setattr(config, "LAYOUT_RECOMPUTE_BYTES", threshold)
    x, _, queue = _problem()
    params = params_from_dict(dict(TRAFFIC["params"], **SMALL))
    assert config.resolve_layouts(params, x) == policy
    with timers.recording():
        _, rep = cp_cals(x, queue, params, device="cpu")
    counts, spans = timers.counters(), timers.spans()
    iters = sum(rep.engine_iterations.values())
    assert iters >= ITERS
    per_sweep = _layout_bytes(CFG["modes"])
    if policy == "recompute":
        assert counts["layouts.derived"] == 3 * iters
        assert counts["layouts.derived_bytes"] == per_sweep * iters
        assert "layouts.held_bytes" not in counts
    else:
        assert "layouts.derived" not in counts and "layouts.derived_bytes" not in counts
        assert counts["layouts.held_bytes"] == per_sweep
        assert sum(s.name == "layouts.build" for s in spans) == 3
