"""The port's (dp, tp) mesh on the CPU over gloo (counterpart of
``tests/test_sharding.py``): iterations of ``make_sharded_step`` in 2 and 4
fresh processes, each rank holding its share of the batch (dp) and its rows
of mode 0 (tp), gathered whole and held to the JAX package's single-device
iteration on the same state at 1e-11 in float64; and the placement rules
themselves (which slots and rows a rank holds) on their own."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_mesh_worker import run_ranks

import cp_cals_tpu.config as jcfg
from cp_cals_tpu.ktensor import Ktensor as JKtensor
from cp_cals_tpu.solvers.iteration import make_iteration as jax_make_iteration
from cp_cals_tpu.solvers.state import init_state as jax_init_state
from cp_cals_tpu_torch import CalsParams, Ktensor, random_ktensor_host
from cp_cals_tpu_torch.parallel.sharding import (
    Shard,
    _axis_if_divisible,
    mode0_leaves,
    state_rows,
    tensor_rows,
)
from cp_cals_tpu_torch.solvers.state import init_state, tree_leaves

TOL = 1e-11
N_ITERS = 6  # past the line search's first extrapolation (interval 5)
# (dp, tp) meshes; batches 8 (every dp divides it) and 5 (dp does not:
# replicated); mode 0 of 8 rows (tp divides it) and of 7 (near-equal split).
MESHES = [(2, 1), (1, 2), (2, 2)]
CASES = [(dp, tp, b, modes) for dp, tp in MESHES for b in (8, 5) for modes in ((8, 7, 6), (7, 8, 6))
         if modes[0] == 8 or tp > 1]


def case_name(dp, tp, b, modes):
    return f"dp{dp}-tp{tp}-b{b}-i{modes[0]}"


def problem(b, modes):
    rng = np.random.default_rng(b * 100 + modes[0])
    kt = random_ktensor_host(rng, modes, 3, dtype=np.float64)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam) + 1e-3 * rng.standard_normal(modes)
    kts = [random_ktensor_host(rng, modes, 4, dtype=np.float64) for _ in range(b)]
    return x, [np.stack([k.factors[n] for k in kts]) for n in range(3)], np.stack([k.lam for k in kts])


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    """Every case's result on every rank: the 2-rank meshes in one spawn,
    the 2 x 2 mesh in another."""
    tmp = tmp_path_factory.mktemp("sharding")
    params = CalsParams(line_search=True)
    jobs = {2: [], 4: []}
    for dp, tp, b, modes in CASES:
        x, factors, lam = problem(b, modes)
        jobs[dp * tp].append(dict(name=case_name(dp, tp, b, modes), kind="step", dp=dp, tp=tp, x=x,
                                  factors=factors, lam=lam, params=params, n=N_ITERS))
    return {world: run_ranks(tmp, world, cases) for world, cases in jobs.items()}


def jax_reference(b, modes):
    x, factors, lam = problem(b, modes)
    xj = jnp.asarray(x)
    x_norm = jnp.linalg.norm(xj.ravel())
    state = jax_init_state(JKtensor(tuple(jnp.asarray(f) for f in factors), jnp.asarray(lam)), x_norm,
                           line_search=True)
    step = jax.jit(jax_make_iteration(jcfg.CalsParams(line_search=True, dimtree="off"), batched=True))
    for _ in range(N_ITERS):
        state = step(xj, state, x_norm)
    return state


@pytest.mark.parametrize("dp,tp,b,modes", CASES, ids=[case_name(*c) for c in CASES])
def test_sharded_iteration_matches_jax_single_device(ranks_out, dp, tp, b, modes):
    ref = jax_reference(b, modes)
    ranks = ranks_out[dp * tp]
    for rank, got in enumerate(ranks):
        g = got[case_name(dp, tp, b, modes)]
        np.testing.assert_array_equal(g["iters"], np.asarray(ref.iters))
        np.testing.assert_allclose(g["fit"], np.asarray(ref.fit), atol=TOL)
        np.testing.assert_allclose(g["approx_error"], np.asarray(ref.approx_error), atol=TOL)
        for fg, fr in zip(g["factors"], ref.kt.factors):
            np.testing.assert_allclose(fg, np.asarray(fr), atol=TOL)
        np.testing.assert_allclose(g["lam"], np.asarray(ref.kt.lam), atol=TOL)
        # What the rank held: its dp share of the batch (all of it where dp
        # does not divide b) and its tp block of mode 0.
        d, t = divmod(rank, tp)
        mesh = types.SimpleNamespace(n_dp=dp, n_tp=tp, dp_index=d, tp_index=t, shape={"dp": dp, "tp": tp})
        lo, hi = state_rows(mesh, b)
        r0, r1 = tensor_rows(mesh, modes[0], tp > 1)
        assert g["local_rows"] == (hi - lo, r1 - r0)
        assert (hi - lo < b) == (b % dp == 0 and dp > 1)
        # tp sums inside the iteration; dp none.
        assert (g["counts"]["tp"] > 0) == (tp > 1)


def fake_mesh(dp, tp, rank):
    d, t = divmod(rank, tp)
    return types.SimpleNamespace(n_dp=dp, n_tp=tp, dp_index=d, tp_index=t, shape={"dp": dp, "tp": tp}, size=dp * tp)


@pytest.mark.parametrize("dp,b", [(2, 8), (4, 8), (2, 5), (4, 2), (3, 96)])
def test_state_rows_split_divisible_batches_only(dp, b):
    """JAX's rule: a batch dp divides is split in equal contiguous shares,
    one per dp index; any other is replicated."""
    shares = [state_rows(fake_mesh(dp, 1, r), b) for r in range(dp)]
    if b % dp:
        assert _axis_if_divisible(fake_mesh(dp, 1, 0), "dp", b) is None
        assert shares == [(0, b)] * dp
    else:
        assert shares == [(r * b // dp, (r + 1) * b // dp) for r in range(dp)]


@pytest.mark.parametrize("i0,tp", [(8, 2), (299, 2), (7, 3), (1, 2)])
def test_tensor_rows_cover_mode0_once(i0, tp):
    """tp blocks of mode 0 are contiguous, differ by at most one row and
    cover it once; a mode shorter than tp is replicated; without
    shard_mode0 every rank holds every row."""
    blocks = [tensor_rows(fake_mesh(1, tp, t), i0, True) for t in range(tp)]
    if i0 < tp:
        assert blocks == [(0, i0)] * tp
    else:
        assert blocks[0][0] == 0 and blocks[-1][1] == i0
        assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
        sizes = [b - a for a, b in blocks]
        assert max(sizes) - min(sizes) <= 1
    assert tensor_rows(fake_mesh(1, tp, tp - 1), i0, False) == (0, i0)


@pytest.mark.parametrize("carries", [{}, dict(nnls=True, line_search=True, mixed_tol=True)],
                         ids=["plain", "nnls-ls-hi"])
def test_mode0_leaves_and_shard_take(carries):
    """The leaves tp splits are exactly every Ktensor's factor 0 and the
    NNLS active sets of mode 0 (JAX's state_pspecs); ``Shard.take`` cuts
    each leaf to the rank's slots and those leaves to its rows, and the
    placement puts them back where they came from."""
    rng = np.random.default_rng(1)
    modes = (6, 5, 4)
    kt = Ktensor(tuple(torch.from_numpy(rng.standard_normal((4, m, 3))) for m in modes),
                 torch.from_numpy(rng.standard_normal((4, 3))))
    st = init_state(kt, torch.tensor(3.0, dtype=torch.float64), **carries)
    leaves = tree_leaves(st)
    flags = mode0_leaves(st)
    assert len(flags) == len(leaves)
    rows0 = [i for i, f in enumerate(flags) if f]
    want = [id(st.kt.factors[0])]
    if carries:
        want += [id(st.active[0]), id(st.ls.prev.factors[0]), id(st.ls.backup.factors[0]),
                 id(st.ls.backup_active[0])]
    assert sorted(id(leaves[i]) for i in rows0) == sorted(want)
    mesh = fake_mesh(2, 2, 3)  # dp index 1, tp index 1
    shard = Shard.__new__(Shard)
    shard.mesh, shard.b, shard.lo, shard.hi = mesh, 4, 2, 4
    shard.r0, shard.r1, shard.i0 = 3, 6, 6
    shard.lead = shard.rows_lead = True
    part = shard.take(st)
    for leaf, cut, f in zip(leaves, tree_leaves(part), flags):
        want_leaf = leaf[2:4, 3:6] if f else leaf[2:4]
        assert torch.equal(cut, want_leaf)
    placed = shard.place_state([t.numpy() for t in tree_leaves(part)], flags)
    for leaf, full, f in zip(leaves, placed, flags):
        assert full.shape == tuple(leaf.shape)
        np.testing.assert_array_equal(full[2:4, 3:6] if f else full[2:4], (leaf[2:4, 3:6] if f else leaf[2:4]).numpy())
