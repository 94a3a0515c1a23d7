"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of ``cp_cals_tpu_torch/ops/fused_*.py`` runs its
plain PyTorch version; the JAX side runs the Pallas kernels in interpret
mode, as the JAX suite's own tests do. Bands are the JAX suite's:
MTTKRP rtol 2e-5 / atol 1e-4 (tests/test_pallas.py), epilogue 2e-4
(tests/test_pallas_epilogue.py). tests/test_torch_cuda.py holds the CUDA
kernels against the same plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp_cals_tpu.ops.error import fast_error_from_cols as jax_fast_error_from_cols
from cp_cals_tpu.ops.pallas_epilogue import epilogue_apply_pallas, normal_inverse_pallas
from cp_cals_tpu.ops.pallas_mttkrp import mttkrp_batched_pallas
from cp_cals_tpu_torch.ops import fused_epilogue as fe
from cp_cals_tpu_torch.ops import fused_mttkrp as fm
from cp_cals_tpu_torch.ops.gramians import gramians


def _mttkrp_problem(modes, b, r, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=modes).astype(np.float32)
    factors = [rng.normal(size=(b, m, r)).astype(np.float32) for m in modes]
    return x, factors


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_mttkrp_plain_matches_pallas(mode, precision):
    """Odd rank (5), and a target mode longer than the TPU row tile."""
    x, factors = _mttkrp_problem((20, 13, 9), b=3, r=5, seed=mode)
    want = mttkrp_batched_pallas(
        jnp.asarray(x), tuple(jnp.asarray(f) for f in factors), mode,
        precision=precision, ti=8, cj=4, interpret=True,
    )
    got = fm.mttkrp_batched_fused(
        torch.from_numpy(x), [torch.from_numpy(f) for f in factors], mode,
        precision=precision,
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-4)


def test_mttkrp_layout_and_split():
    """The layouts put ties of the other modes' sizes on the lowest index as
    the big (contracted) mode, like the TPU kernel; the "highest" layout
    holds X as [J, K, I] with rows padded to a multiple of 4."""
    assert fm.split_others((10, 10, 10), 2) == (1, 0)
    assert fm.split_others((299, 301, 41), 0) == (2, 1)
    assert fm.split_others((299, 301, 41), 2) == (0, 1)
    x = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 4)
    x3 = fm.prepare_mode_tensor(x, 1)
    assert tuple(x3.shape) == (2, 4, 3) and x3.stride() == (16, 4, 1)
    assert torch.equal(x3, x.permute(0, 2, 1))
    # every split covers all of J exactly once
    for j, i, c, n_sm in [(41, 299, 640, 132), (299, 41, 384, 132), (41, 301, 768, 114), (5, 7, 3, 1)]:
        _, _, _, s, chunk = fm.plan_fp32(j, i, 301, c, n_sm, 232448)
        assert (s - 1) * chunk < j <= s * chunk


def _epilogue_problem(b=6, modes=(9, 8, 7), r=5, pad=2, seed=0):
    """Padded ranks, and slot b-1 dead (rank mask all False, zero data)."""
    rng = np.random.default_rng(seed)
    rr = r + pad
    mask = np.broadcast_to(np.arange(rr) < r, (b, rr)).copy()
    mask[-1] = False
    factors = []
    for m in modes:
        f = rng.normal(size=(b, m, rr)).astype(np.float32) * mask[:, None, :]
        factors.append(f)
    g = (rng.normal(size=(b, modes[1], rr)).astype(np.float32) * mask[:, None, :])
    return factors, mask, g


@pytest.mark.parametrize("skip", [0, 1, 2])
def test_normal_inverse_plain_matches_pallas(skip):
    factors, mask, _ = _epilogue_problem()
    grams_t = gramians([torch.from_numpy(f) for f in factors])
    grams_j = tuple(jnp.asarray(g.numpy()) for g in grams_t)
    want = normal_inverse_pallas(grams_j, jnp.asarray(mask), skip, interpret=True)
    got = fe.normal_inverse(grams_t, torch.from_numpy(mask), skip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    # the dead slot's normal matrix is the identity
    np.testing.assert_array_equal(got[-1].numpy(), np.eye(mask.shape[1]))


@pytest.mark.parametrize("with_err", [False, True])
@pytest.mark.parametrize("zero_jk", [False, True])
@pytest.mark.parametrize("iters_val", [1, 5])
def test_apply_plain_matches_pallas(iters_val, zero_jk, with_err):
    """The JAX apply kernel's outputs (F, lam, raw gramian, error columns),
    and the port's apply: those with the gramian rescaled and, on the error
    mode, the error finished by JAX's fast_error_from_cols."""
    factors, mask, g = _epilogue_problem(seed=3)
    b = g.shape[0]
    grams_t = gramians([torch.from_numpy(f) for f in factors])
    hinv = fe.normal_inverse(grams_t, torch.from_numpy(mask), 0 if zero_jk else 1)
    iters = np.full((b,), iters_val, np.int32)
    jk = np.asarray([2, -1, 0, -1, 4, -1], np.int32)
    x_norm = np.linspace(20.0, 30.0, b).astype(np.float32)

    want = epilogue_apply_pallas(
        jnp.asarray(g), jnp.asarray(hinv.numpy()), jnp.asarray(iters), jnp.asarray(jk),
        zero_jk=zero_jk, with_err=with_err, interpret=True,
    )
    raw = fe._apply_raw_plain(
        torch.from_numpy(g), hinv, torch.from_numpy(iters), torch.from_numpy(jk),
        zero_jk, with_err,
    )
    for a, w in zip(raw[:3], want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)
    f, lam = raw[0].numpy(), raw[1].numpy()
    assert not f[-1].any() and not lam[-1].any()  # dead slot stays inert
    if zero_jk:
        assert not f[0, 2].any() and not f[2, 0].any() and not f[4, 4].any()
    if with_err:
        t3 = raw[3][0].double() + raw[3][1].double()
        ref = np.einsum("bir,bir->br", f.astype(np.float64), g.astype(np.float64))
        np.testing.assert_allclose(t3.numpy(), ref, rtol=1e-6, atol=1e-6)
        jt3 = np.asarray(want[3][0], np.float64) + np.asarray(want[3][1], np.float64)
        np.testing.assert_allclose(t3.numpy(), jt3, rtol=2e-4, atol=2e-4)
    else:
        assert raw[3] is None and want[3] is None

    err_inputs = (torch.from_numpy(x_norm), grams_t[0], grams_t[2]) if with_err else None
    got = fe.epilogue_apply(
        torch.from_numpy(g), hinv, torch.from_numpy(iters), torch.from_numpy(jk),
        zero_jk, err_inputs,
    )
    safe = jnp.where(want[1] != 0, want[1], 1.0)
    gm_want = want[2] / (safe[..., :, None] * safe[..., None, :])
    for a, w in zip(got[:3], (want[0], want[1], gm_want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=2e-4, atol=2e-4)
    if with_err:
        h = jnp.asarray(grams_t[0].numpy()) * jnp.asarray(grams_t[2].numpy()) * gm_want
        err_want = jax_fast_error_from_cols(jnp.asarray(x_norm), want[1], want[3][0], want[3][1], h)
        np.testing.assert_allclose(got[3].numpy(), np.asarray(err_want), rtol=2e-4, atol=2e-4)
    else:
        assert got[3] is None


@pytest.mark.parametrize("which", ["mttkrp", "mttkrp_tc", "hinv", "apply"])
def test_wrappers_raise_off_cpu_and_cuda(which):
    """A wrapper runs its plain version only for CPU tensors: any other
    device gets the kernel or an error, never the plain version."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if which == "mttkrp":
            fm.fused_mttkrp(
                torch.empty(3, 4, 5, device=meta), torch.empty(2, 3, 2, device=meta),
                torch.empty(2, 5, 2, device=meta),
            )
        elif which == "mttkrp_tc":
            fm.fused_mttkrp(
                torch.empty(3, 4, 8, dtype=torch.bfloat16, device=meta),
                torch.empty(2, 3, 2, device=meta), torch.empty(2, 5, 2, device=meta), "default",
            )
        elif which == "hinv":
            g = torch.empty(2, 3, 3, device=meta)
            fe.normal_inverse((g, g, g), torch.ones(2, 3, dtype=torch.bool, device=meta), 0)
        else:
            fe.epilogue_apply(
                torch.empty(2, 4, 3, device=meta), torch.empty(2, 3, 3, device=meta),
                torch.ones(2, dtype=torch.int32, device=meta),
                torch.ones(2, dtype=torch.int32, device=meta), False, None,
            )
