"""The port's threefry PRNG (``cp_cals_tpu_torch/prng.py``) and its spec
models against ``jax.random`` and the JAX package's ``ktensor.py``, on the
CPU: keys, ``fold_in``, ``split``, random bits and ``uniform`` bit for
bit; ``normal`` in ulps; ``spec_to_ktensor``'s draws bit for bit and its
normalization (summed in another order) to 1e-15 of the largest entry in
float64 (5e-7, four float32 roundings, in float32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp_cals_tpu import ktensor as jkt
from cp_cals_tpu_torch import ktensor as pkt
from cp_cals_tpu_torch import prng

SEEDS = [0, 1, 7, 123, 99991, 2**31 - 1, 2**31 + 5, 2**32 - 1]
DTYPES = [(jnp.float32, torch.float32), (jnp.float64, torch.float64)]


def words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_fold_in_split_bits(seed):
    key = jax.random.PRNGKey(seed)
    pkey = prng.prng_key(seed)
    np.testing.assert_array_equal(words(key), pkey.numpy())
    for data in (0, 1, 5, 2**32 - 1):
        np.testing.assert_array_equal(words(jax.random.fold_in(key, data)), prng.fold_in(pkey, data).numpy())
    for n in (1, 2, 3, 8):
        np.testing.assert_array_equal(words(jax.random.split(key, n)), prng.split(pkey, n).numpy())
    np.testing.assert_array_equal(words(jax.random.split(key, (2, 3))), prng.split(pkey, (2, 3)).numpy())
    k2 = jax.random.fold_in(jax.random.fold_in(key, 2), 5)
    p2 = prng.fold_in(prng.fold_in(pkey, 2), 5)
    np.testing.assert_array_equal(words(jax.random.bits(k2, (9,), jnp.uint32)), prng.random_bits(p2, 32, (9,)).numpy())
    np.testing.assert_array_equal(np.asarray(jax.random.bits(k2, (4, 3), jnp.uint64)).view(np.int64),
                                  prng.random_bits(p2, 64, (4, 3)).numpy())


@pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "float64"])
@pytest.mark.parametrize("shape", [(7,), (13, 4)])
def test_uniform_bit_for_bit(dtypes, shape):
    jdt, pdt = dtypes
    for seed in SEEDS:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
        pkey = prng.fold_in(prng.prng_key(seed), 3)
        for lo, hi in ((-1.0, 1.0), (0.0, 1.0), (2.5, 3.0)):
            want = np.asarray(jax.random.uniform(key, shape, dtype=jdt, minval=lo, maxval=hi))
            got = prng.uniform(pkey, shape, pdt, lo, hi).numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_batched_keys_draw_what_each_key_draws():
    """A [K, 2] key batch draws each key's own values (the engine draws all
    of a bucket's columns at once)."""
    keys = prng.fold_in(prng.prng_key(11)[None, :], torch.arange(5))
    batch = prng.uniform(keys, (6,), torch.float64, -1.0, 1.0)
    for j in range(5):
        torch.testing.assert_close(batch[j], prng.uniform(keys[j], (6,), torch.float64, -1.0, 1.0), rtol=0, atol=0)


def ulps(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want))))


@pytest.mark.parametrize("dtypes,limit", [(DTYPES[0], 4), (DTYPES[1], 32)], ids=["float32", "float64"])
def test_normal_in_ulps(dtypes, limit):
    """float32 within 4 ulps of JAX. float64 within 32: XLA's float64
    log1p rounds 1 - u^2 before the log (up to 128 ulps of w from an exact
    log1p), which moves a draw by up to 21 ulps over 220,000 draws; the
    ErfInv polynomial itself is XLA's (prng.erfinv)."""
    jdt, pdt = dtypes
    worst = 0.0
    for seed in SEEDS:
        key, pkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
        for shape in ((7,), (50, 20)):
            want = np.asarray(jax.random.normal(key, shape, dtype=jdt))
            got = prng.normal(pkey, shape, pdt).numpy()
            assert got.dtype == want.dtype
            worst = max(worst, ulps(got, want))
    assert worst <= limit, worst


def test_erfinv_is_xlas_polynomial():
    """The polynomial alone, on XLA's own w: float32 within 2 ulps over the
    whole range (torch.erfinv reads up to 61)."""
    u = np.random.default_rng(0).uniform(-1, 1, 20000).astype(np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    assert ulps(prng.erfinv(torch.from_numpy(u)).numpy(), want) <= 2


@pytest.mark.parametrize("modes", [(12, 10, 8), (5, 4, 3, 6)])
@pytest.mark.parametrize("rank", [1, 3, 7])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_spec_to_ktensor_matches_jax(modes, rank, dtype):
    seed = 100 + 7 * rank
    spec = jkt.RandomKtensorSpec(modes, rank, seed=seed, dtype=dtype)
    want = jkt.spec_to_ktensor(spec)
    got = pkt.spec_to_ktensor(pkt.RandomKtensorSpec(*spec), device="cpu")
    for a, b in zip(want.factors + (want.lam,), got.factors + (got.lam,)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        rel = np.max(np.abs(a - b)) / np.max(np.abs(a))
        # lam is a product of one norm per mode: up to N roundings apart
        assert rel <= {"float32": 5e-7, "float64": 1e-15}[dtype], rel
    # The raw draws, column by column, bit for bit.
    tdt = getattr(torch, dtype)
    for n, m in enumerate(modes):
        cols = np.asarray(jkt._spec_columns(jax.random.PRNGKey(seed), n, m, rank, jnp.dtype(dtype)))
        np.testing.assert_array_equal(cols, pkt._spec_columns(prng.prng_key(seed), n, m, rank, tdt).numpy().T)


def test_spec_block_is_padding_independent():
    """A spec slot in a padded bucket holds spec_to_ktensor's model bit for
    bit, its columns past the rank zero with lam 0; all modes drawn at
    once at the longest mode's length give each mode's own draws."""
    modes = (12, 10, 8)
    all_modes = pkt._spec_columns(prng.prng_key(9), torch.arange(3), 12, 4, torch.float32)
    for n, m in enumerate(modes):
        assert torch.equal(all_modes[n, :, :m], pkt._spec_columns(prng.prng_key(9), n, m, 4, torch.float32))
    seeds = torch.tensor([3, 5, 2**32 - 1])
    ranks = (2, 4, 1)
    mask = torch.tensor([[c < r for c in range(4)] for r in ranks])
    block = pkt.spec_block(seeds, mask, modes, torch.float64)
    for i, r in enumerate(ranks):
        one = pkt.spec_to_ktensor(pkt.RandomKtensorSpec(modes, r, int(seeds[i]), "float64"), device="cpu")
        for f, g in zip(block.factors, one.factors):
            assert torch.equal(f[i, :, :r], g) and not f[i, :, r:].any()
        assert torch.equal(block.lam[i, :r], one.lam) and not block.lam[i, r:].any()


def test_random_ktensor_matches_jax():
    """The CLI's target model: split keys, uniform draws bit for bit, the
    normalization to 1e-15."""
    key = jax.random.split(jax.random.PRNGKey(4), 3)[0]
    want = jkt.random_ktensor(key, (9, 8, 7), 3, dtype=jnp.float64)
    got = pkt.random_ktensor(prng.split(prng.prng_key(4), 3)[0], (9, 8, 7), 3, dtype=torch.float64)
    for a, b in zip(want.factors + (want.lam,), got.factors + (got.lam,)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-14, atol=1e-15)
