"""The port's jackknife export helpers and a reduced stress oracle, against
the JAX package on the CPU in float64.

- ``set_jk_fiber``, ``jk_to_regular`` and ``concatenate_ktensors``
  (``cp_cals_tpu_torch/ktensor.py``) equal the JAX package's functions
  exactly on the same NumPy inputs: batched leading dims, ``fiber = -1``,
  one fiber per model, a scale other than 0, and the host (NumPy) models
  the jackknife drivers return.
- The reference's SimpleCorrectness (``tests/test_stress_oracle.py``, the
  slow lane) cut to 48 models (ranks 1-12 x 4, shuffled by
  ``random.Random(0)``) with the slow lane's settings: the port's
  ``cp_cals`` against JAX's, equal iteration counts, reconstructions within
  1e-11. The 360-model run and the port's own three paths are in
  ``tests/test_torch_stress_oracle.py`` (``-m slow``).

The workloads are chip_smoke.py's stress phase's (``stress_workload``,
``jk_stress_problem``): every draw is the port's threefry with JAX's keys
(the uniform draws bit for bit, the normalization within a few ulps of
JAX's; JAX's eager draws would take most of the tests' time), in float64,
and both packages take the same NumPy inputs.
- The reference-scale jackknife (4 fitted rank-5 models of a 10x21x20
  target, 40 replicates through an 18-column buffer): the port's
  ``jk_cp_cals`` against JAX's, replicates compared through
  ``jk_to_regular``, at 1e-11.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import cp_cals_tpu.ktensor as jkt
from cp_cals_tpu import CalsParams as JCalsParams
from cp_cals_tpu.solvers import cp_cals as j_cp_cals
from cp_cals_tpu.solvers import jk_cp_cals as j_jk_cp_cals
from cp_cals_tpu_torch import CalsParams, cp_cals, jk_cp_cals
from cp_cals_tpu_torch.ktensor import Ktensor, concatenate_ktensors, jk_to_regular, set_jk_fiber, to_tensor

TOL = chip_smoke.STRESS_TOL  # reference MODEL_DIFF_ACC (tests/test_stress_oracle.py)


def host_model(rng, modes, rank, batch=()):
    f = tuple(rng.standard_normal(batch + (m, rank)) for m in modes)
    return Ktensor(f, rng.standard_normal(batch + (rank,)))


def as_jax(kt):
    return jkt.Ktensor(tuple(jnp.asarray(f) for f in kt.factors), jnp.asarray(kt.lam))


def as_torch(kt):
    return Ktensor(tuple(torch.from_numpy(np.array(f)) for f in kt.factors), torch.from_numpy(np.array(kt.lam)))


def assert_same(got, want):
    """Equal bits, leaf by leaf (NaN where the other has NaN)."""
    assert len(got.factors) == len(want.factors)
    for g, w in zip(got.factors + (got.lam,), want.factors + (want.lam,)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def recon(kt) -> np.ndarray:
    return to_tensor(as_torch(kt)).numpy()


@pytest.mark.parametrize(
    "batch,fiber,value",
    [((), 3, 0.0), ((), -1, 0.0), ((), 0, 2.5), ((), 5, np.nan), ((4,), 2, 0.0),
     ((4,), [0, -1, 5, 3], 0.0), ((2, 3), [[1, 2, -1], [0, 5, 4]], -0.5)],
)
@pytest.mark.parametrize("host", [False, True], ids=["torch", "numpy"])
def test_set_jk_fiber_matches_jax(batch, fiber, value, host):
    kt = host_model(np.random.default_rng(1), (6, 5, 4), 3, batch)
    want = jkt.set_jk_fiber(as_jax(kt), jnp.asarray(fiber), value)
    got = set_jk_fiber(kt if host else as_torch(kt), np.asarray(fiber) if host else torch.as_tensor(fiber), value)
    assert isinstance(got.factors[0], np.ndarray if host else torch.Tensor)
    assert_same(got, want)


@pytest.mark.parametrize("batch", [(), (3,), (2, 2)])
@pytest.mark.parametrize("fiber", [0, 2, 5])
@pytest.mark.parametrize("host", [False, True], ids=["torch", "numpy"])
def test_jk_to_regular_matches_jax(batch, fiber, host):
    kt = host_model(np.random.default_rng(2), (6, 5, 4), 3, batch)
    want = jkt.jk_to_regular(as_jax(kt), fiber)
    got = jk_to_regular(kt if host else as_torch(kt), fiber)
    assert isinstance(got.factors[0], np.ndarray if host else torch.Tensor)
    assert got.factors[0].shape == batch + (5, 3)
    assert_same(got, want)


def test_jk_to_regular_exports_a_jackknife_replicate():
    """A driver's host replicate (NaN on its fiber's row) becomes a finite
    (I0-1)-row model, equal to JAX's export of the same model."""
    rng = np.random.default_rng(3)
    kt = host_model(rng, (6, 5, 4), 2)
    kt.factors[0][4] = np.nan
    got = jk_to_regular(kt, 4)
    assert np.isfinite(got.factors[0]).all() and got.modes == (5, 5, 4)
    assert_same(got, jkt.jk_to_regular(as_jax(kt), 4))


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("ranks", [(2, 2, 2), (1, 4), (3,)])
def test_concatenate_ktensors_matches_jax(batch, ranks):
    rng = np.random.default_rng(4)
    kts = [host_model(rng, (5, 4, 3), r, batch) for r in ranks]
    want = jkt.concatenate_ktensors([as_jax(kt) for kt in kts])
    got = concatenate_ktensors([as_torch(kt) for kt in kts])
    assert got.rank == sum(ranks)
    assert_same(got, want)
    assert_same(concatenate_ktensors(kts), want)  # host models too


def test_concatenate_ktensors():
    """The port's counterpart of tests/test_utils.py::test_concatenate_ktensors:
    the wide model's reconstruction is the sum of its parts'."""
    kts = [as_torch(host_model(np.random.default_rng(i), (5, 4, 3), 2)) for i in range(3)]
    cat = concatenate_ktensors(kts)
    assert cat.rank == 6
    np.testing.assert_allclose(to_tensor(cat).numpy(), sum(to_tensor(kt).numpy() for kt in kts), atol=1e-12)


STRESS = dict(**chip_smoke.STRESS_ALS, **chip_smoke.STRESS_ENGINE)
JK_CALS = dict(**chip_smoke.JK_STRESS, **chip_smoke.JK_STRESS_ENGINE)


def test_reduced_stress_matches_jax():
    """48 models through the 30-column buffer: the port's engine against
    JAX's, model by model."""
    x, _, kts = chip_smoke.stress_workload(4)
    got, rep = cp_cals(x, kts, CalsParams(**STRESS), device="cpu")
    want, jrep = j_cp_cals(jnp.asarray(x), [as_jax(k) for k in kts], JCalsParams(**STRESS))
    assert rep.n_ktensors == len(kts) and all(k is not None for k in got)
    assert [(m.id, m.iters) for m in rep.models] == [(m.id, m.iters) for m in sorted(jrep.models, key=lambda m: m.id)]
    worst = max(float(np.linalg.norm(recon(g) - recon(w))) for g, w in zip(got, want))
    assert worst < TOL, worst


def test_jk_function_correctness_matches_jax():
    """40 replicates through an 18-column buffer: the port's jk_cp_cals
    against JAX's, each replicate's reconstruction without its left-out
    row (``jk_to_regular``, JAX's ``_drop_row_recon``)."""
    x, fitted = chip_smoke.jk_stress_problem("cpu")
    got = jk_cp_cals(x, fitted, CalsParams(**JK_CALS), device="cpu")
    want = j_jk_cp_cals(jnp.asarray(x), [as_jax(k) for k in fitted], JCalsParams(**JK_CALS))
    worst = 0.0
    for p in range(len(fitted)):
        for f in range(chip_smoke.JK_STRESS_MODES[0]):
            g = jk_to_regular(got.results[p][f], f)
            assert np.isfinite(g.factors[0]).all()
            w = jkt.jk_to_regular(as_jax(want.results[p][f]), f)
            worst = max(worst, float(np.linalg.norm(recon(g) - recon(w))))
    assert worst < TOL, worst
