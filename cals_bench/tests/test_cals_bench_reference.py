"""The plain reference against NumPy closed forms at a tiny size."""

import itertools

import numpy as np
import pytest
import torch

from cals_bench.reference import als
from cals_bench.reference import jackknife as ref_jk

RNG = np.random.default_rng(3)


def dense(factors, lam):
    return np.einsum("ir,jr,kr,r->ijk", *factors, lam)


def problem(shape=(7, 6, 5), rank=2, noise=0.05):
    fs = [RNG.uniform(-1, 1, (m, rank)) for m in shape]
    x = dense(fs, np.ones(rank))
    return x + noise * x.std() * RNG.standard_normal(shape)


def batch(factors):
    return [torch.as_tensor(f)[None] for f in factors]


def test_mttkrp_matches_the_unfolding_times_khatri_rao():
    x = problem()
    fs = [RNG.standard_normal((m, 3)) for m in x.shape]
    for mode in range(3):
        others = [fs[m] for m in range(3) if m != mode]
        krp = np.einsum("ir,jr->ijr", *others).reshape(-1, 3)
        want = np.moveaxis(x, mode, 0).reshape(x.shape[mode], -1) @ krp
        got = als.mttkrp(torch.as_tensor(x), batch(fs), mode)[0].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def numpy_sweep(x, fs, drop_row=None):
    """One ALS sweep by least squares on the unfoldings (closed form)."""
    fs = [f.copy() for f in fs]
    for mode in range(3):
        others = [fs[m] for m in range(3) if m != mode]
        krp = np.einsum("ir,jr->ijr", *others).reshape(-1, fs[0].shape[1])
        unf = np.moveaxis(x, mode, 0).reshape(x.shape[mode], -1)
        fs[mode] = np.linalg.lstsq(krp, unf.T, rcond=None)[0].T
        if mode == 0 and drop_row is not None:
            fs[0][drop_row] = 0
    return fs


def test_sweeps_match_least_squares_and_their_fit_the_dense_one():
    x = problem()
    start = [RNG.uniform(-1, 1, (m, 3)) for m in x.shape]
    want = start
    for _ in range(3):
        want = numpy_sweep(x, want)
    f, lam, fit, n = als.sweeps(als.Problem(torch.as_tensor(x)), batch(start), 3)
    got = dense([u[0].numpy() for u in f], lam[0].numpy())
    np.testing.assert_allclose(got, dense(want, np.ones(3)), rtol=1e-9, atol=1e-9)
    assert n == 3
    assert float(fit[0]) == pytest.approx(1 - np.linalg.norm(x - got) / np.linalg.norm(x), abs=1e-12)


def test_a_noiseless_tensor_is_recovered():
    x = problem(noise=0.0)
    start = [RNG.uniform(-1, 1, (m, 2)) for m in x.shape]
    _, _, fit, n = als.sweeps(als.Problem(torch.as_tensor(x)), batch(start), 2000, tol=1e-15)
    assert float(fit[0]) > 1 - 1e-6 and n < 2000


def test_a_replicate_is_als_on_the_tensor_without_its_row():
    """Zeroing row f of mode 0 after each mode-0 update is ALS on X without
    slice f: the same sweeps on the explicit subtensor agree, and the fit
    counts the left-out tensor's error over the full norm."""
    x = problem()
    base = [RNG.uniform(-1, 1, (m, 2)) for m in x.shape]
    rows = [0, 3, 6]
    p = als.Problem(torch.as_tensor(x))
    f, lam, fit, _ = ref_jk.replicates(p, [torch.as_tensor(u) for u in base], rows, 0.0, 4)
    for b, row in enumerate(rows):
        sub = np.delete(x, row, axis=0)
        want = [np.delete(base[0], row, axis=0), base[1], base[2]]
        for _ in range(4):
            want = numpy_sweep(sub, want)
        got = [np.delete(f[0][b].numpy(), row, axis=0), f[1][b].numpy(), f[2][b].numpy()]
        assert np.abs(f[0][b, row].numpy()).max() == 0
        model = dense(got, lam[b].numpy())
        np.testing.assert_allclose(model, dense(want, np.ones(2)), rtol=1e-9, atol=1e-9)
        err = np.linalg.norm(sub - model)
        assert float(fit[b]) == pytest.approx(1 - err / np.linalg.norm(x), abs=1e-12)
        nan0 = f[0][b].clone()
        nan0[row] = float("nan")
        mf = als.model_fit(p, [nan0[None], f[1][b:b + 1], f[2][b:b + 1]], lam[b:b + 1],
                           rows=torch.tensor([row]))
        assert float(mf[0]) == pytest.approx(float(fit[b]), abs=1e-12)


def test_recon_gap_matches_the_dense_difference():
    a = [RNG.standard_normal((m, 3)) for m in (5, 4, 3)]
    b = [u + 0.01 * RNG.standard_normal(u.shape) for u in a]
    la, lb = RNG.uniform(1, 2, 3), RNG.uniform(1, 2, 3)
    want = np.linalg.norm(dense(a, la) - dense(b, lb)) / np.linalg.norm(dense(b, lb))
    got = als.recon_gap(batch(a), torch.as_tensor(la)[None], batch(b), torch.as_tensor(lb)[None])
    assert float(got[0]) == pytest.approx(want, rel=1e-6)


def test_lsap_order_undoes_a_permutation():
    base = [torch.as_tensor(RNG.standard_normal((m, 4))) for m in (6, 7, 8)]
    perms = list(itertools.permutations(range(4)))[:5]
    reps = [torch.stack([u[:, list(p)] for p in perms]) for u in base]
    orders = ref_jk.lsap_orders(base, reps)
    for p, o in zip(perms, orders):
        assert [p[i] for i in o] == [0, 1, 2, 3]


def test_tf32_keeps_ten_mantissa_bits_rounded_to_nearest():
    t = torch.tensor([1.0, 1 + 2**-11, 1 + 2**-12, 1 + 3 * 2**-12, -2.0 - 2**-10 - 2**-12, 3.0e-20])
    got = als.tf32(t)
    # the ulp is 2**-10 on [1, 2) and 2**-9 on [2, 4)
    assert got.tolist()[:5] == [1.0, 1 + 2**-10, 1.0, 1 + 2**-10, -2.0 - 2**-9]
    rel = ((got.double() - t.double()) / t.double()).abs()
    assert float(rel.max()) <= 2**-11
