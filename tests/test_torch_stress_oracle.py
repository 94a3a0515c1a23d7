"""The JAX package's slow lane (``tests/test_stress_oracle.py``) for the
port, at full size on the CPU in float64 (``-m slow``; not part of the
default lane).

- SimpleCorrectness: 360 models of ranks 1-12 (30 each, shuffled) through
  a 30-column buffer, so the engine runs continuous eviction, refill and
  tail compaction: the port's cp_cals against its cp_als on every model
  and its cp_batched_als on every same-rank group, equal iteration counts,
  reconstructions within 1e-11; and the same 360 models through the port's
  cp_cals against JAX's.
- FunctionCorrectness at the reference's scale: 4 fitted rank-5 models of a
  10x21x20 target, 40 replicates through an 18-column buffer: the port's
  jk_cp_cals, jk_cp_als and jk_cp_batched_als within 1e-11 of each other,
  each replicate compared without its left-out row (``jk_to_regular``).

The workloads, settings and comparisons are chip_smoke.py's stress phase's,
which runs the same oracles on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import cp_cals_tpu.ktensor as jkt
from cp_cals_tpu import CalsParams as JCalsParams
from cp_cals_tpu.solvers import cp_cals as j_cp_cals
from cp_cals_tpu_torch import AlsParams, CalsParams, cp_cals, jk_cp_als, jk_cp_batched_als, jk_cp_cals

TOL = chip_smoke.STRESS_TOL
CPU = torch.device("cpu")


@pytest.mark.slow
def test_simple_correctness_full_scale():
    x, ranks, kts = chip_smoke.stress_workload()
    runs = chip_smoke.stress_paths(x, ranks, kts, chip_smoke.STRESS_ALS, CPU)
    assert runs["cp_cals"]["churn"]["compactions"] > 0 and runs["cp_cals"]["churn"]["refills"] > 0
    for other in ("cp_als", "cp_batched_als"):
        d = chip_smoke.path_diffs(runs["cp_cals"], runs[other])
        assert not d["iteration_mismatches"], (other, d)
        assert d["max_recon_diff"] < TOL, (other, d)


@pytest.mark.slow
def test_simple_correctness_full_scale_matches_jax():
    x, _, kts = chip_smoke.stress_workload()
    params = dict(**chip_smoke.STRESS_ALS, **chip_smoke.STRESS_ENGINE)
    got, rep = cp_cals(x, kts, CalsParams(**params), device=CPU)
    want, jrep = j_cp_cals(jnp.asarray(x), [jkt.Ktensor(tuple(jnp.asarray(f) for f in k.factors), jnp.asarray(k.lam))
                                            for k in kts], JCalsParams(**params))
    assert [m.iters for m in rep.models] == [m.iters for m in sorted(jrep.models, key=lambda m: m.id)]
    worst = max(float(np.linalg.norm(chip_smoke.dense(g) - chip_smoke.dense(jkt.Ktensor(
        tuple(np.asarray(f) for f in w.factors), np.asarray(w.lam))))) for g, w in zip(got, want))
    assert worst < TOL, worst


@pytest.mark.slow
def test_jk_function_correctness_full_scale():
    x, fitted = chip_smoke.jk_stress_problem(CPU)
    engine = CalsParams(**chip_smoke.JK_STRESS, **chip_smoke.JK_STRESS_ENGINE)
    als = AlsParams(**chip_smoke.JK_STRESS)
    rep_cals = jk_cp_cals(x, fitted, engine, device=CPU)
    rep_als = jk_cp_als(x, fitted, als, device=CPU)
    rep_bat = jk_cp_batched_als(x, fitted, als, device=CPU)
    assert sum(len(r) for r in rep_cals.results) == 4 * chip_smoke.JK_STRESS_MODES[0]
    worst = max(chip_smoke.s3_reading(rep_cals, rep_als), chip_smoke.s3_reading(rep_als, rep_bat))
    assert worst < TOL, worst
