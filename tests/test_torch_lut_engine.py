"""The engine's per-bucket MTTKRP dispatch under ``mttkrp_method=AUTO``
(``solvers/cals.py:_resolve_bucket_methods``) on the CPU, against the JAX
package's engine reading the same table.

JAX's float64 products on the CPU ignore the precision tier, while the
port's emulate the tier's bf16 roundings (``ops/mttkrp.py:tier_matmul``);
so the parity run patches the port's tier rule to the exact product, and
the tiers then choose only the table's entries. The table picks the
twostep and krp_gemm (JAX's fused kernel has no CPU mode outside its
interpret flag).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cp_cals_tpu.config as jcfg
import cp_cals_tpu.utils.lut as jlut
import cp_cals_tpu_torch.utils.lut as lut
from cp_cals_tpu.ktensor import Ktensor as JKtensor
from cp_cals_tpu.solvers.cals import cp_cals as jax_cp_cals
from cp_cals_tpu_torch import CalsParams, MttkrpMethod, cp_cals, launches, random_ktensor_host
from cp_cals_tpu_torch.ops import mttkrp as mt
from cp_cals_tpu_torch.solvers.cals import allocate_bucket_batches, bucket_rank

TOL = 1e-10
MODES = (9, 8, 7)
RANKS = (1, 2, 3, 4, 2, 1, 4, 3, 2, 1)
BUCKETS, BUFFER = (2, 4), 12
SETTINGS = dict(tol=1e-8, max_iterations=30, bucket_ranks=BUCKETS, buffer_size=BUFFER, precision="high",
                mttkrp_precision="default", polish_iters=2, epilogue="xla", dimtree="off")
# Each bucket's picks per mode at the fast tier ("default") and the polish
# tier ("high"): the two buckets differ in every mode, and each bucket's
# polish picks differ from its fast ones.
PICKS = {
    2: {"default": ("krp_gemm", "twostep", "krp_gemm"), "high": ("twostep", "twostep", "krp_gemm")},
    4: {"default": ("twostep", "krp_gemm", "twostep"), "high": ("krp_gemm", "krp_gemm", "twostep")},
}


def make_problem(seed=5, dtype=np.float64):
    rng = np.random.default_rng(seed)
    kt = random_ktensor_host(rng, MODES, 3, dtype=dtype)
    x = np.einsum("ir,jr,kr,r->ijk", *kt.factors, kt.lam)
    x = (x + 1e-2 * rng.standard_normal(MODES)).astype(dtype)
    return x, [random_ktensor_host(rng, MODES, r, dtype=dtype) for r in RANKS]


def batches() -> dict:
    demands = {}
    for r in RANKS:
        demands[bucket_rank(r, BUCKETS)] = demands.get(bucket_rank(r, BUCKETS), 0) + 1
    (wave,) = allocate_bucket_batches(demands, BUFFER)
    return wave


@pytest.fixture
def shared_table(tmp_path, monkeypatch):
    """The PICKS table at each bucket's allocated batch, read by both
    packages from one directory."""
    monkeypatch.setattr(lut, "_ROOT", str(tmp_path))
    monkeypatch.setattr(jlut, "_ROOT", str(tmp_path))
    monkeypatch.setattr(lut, "_device_tag", lambda device=None: "shared")
    monkeypatch.setattr(jlut, "_device_tag", lambda: "shared")
    table = {}
    for r, b in batches().items():
        for tier, methods in PICKS[r].items():
            for mode, m in enumerate(methods):
                table[lut._key(b, r, mode, tier)] = m
    lut._store(MODES, table, "cpu")
    lut.reset_lookup_stats()
    return table


def recon(kt):
    return np.einsum("ir,jr,kr,r->ijk", *(np.asarray(f) for f in kt.factors), np.asarray(kt.lam))


def test_cp_cals_per_bucket_table_matches_jax(shared_table, monkeypatch):
    """Two buckets of different methods per mode, polish picks other than
    the fast tier's: the port equals JAX's cp_cals at 1e-10 in float64,
    and its MTTKRP results by route are the table's picks per bucket."""
    monkeypatch.setattr(mt, "tier_matmul", lambda a, b, precision="highest", out_dtype=None: torch.matmul(a, b))
    x, kts = make_problem()
    jparams = jcfg.CalsParams(**SETTINGS)
    res_j, rep_j = jax_cp_cals(jnp.asarray(x), [JKtensor(tuple(map(jnp.asarray, k.factors)), jnp.asarray(k.lam))
                                                 for k in kts], jparams)
    launches.reset()
    res_p, rep_p = cp_cals(x, kts, CalsParams(**SETTINGS), device="cpu")
    assert lut.LOOKUP_STATS == {"exact": 12, "nearest": 0, "heuristic": 0}  # 2 buckets x 2 tiers x 3 modes
    for kp, kj, mp, mj in zip(res_p, res_j, rep_p.models, rep_j.models):
        assert (mp.id, mp.rank, mp.iters) == (mj.id, mj.rank, mj.iters)
        np.testing.assert_allclose(mp.fit, mj.fit, atol=TOL)
        np.testing.assert_allclose(recon(kp), recon(kj), atol=TOL)
    want = dict.fromkeys(launches.routes(), 0)
    for r in BUCKETS:
        iters, sweeps = rep_p.engine_iterations[r], rep_p.loop_counts[r]["polish_sweeps"]
        assert iters > 0 and sweeps > 0
        for n in range(3):
            want[PICKS[r]["default"][n]] += iters
            want[PICKS[r]["high"][n]] += sweeps
    assert launches.routes() == want


@pytest.mark.parametrize("shape", [MODES, MODES + (3,)], ids=["3d", "4d"])
def test_auto_without_a_table_equals_explicit_pallas(tmp_path, monkeypatch, shape):
    """AUTO with no table is today's resolution (the heuristic: the fused
    kernels where the gate takes the mode, the twostep elsewhere) and
    computes the explicit PALLAS run's bits, checks and polish included."""
    monkeypatch.setattr(lut, "_ROOT", str(tmp_path))
    rng = np.random.default_rng(7)
    x = rng.normal(size=shape).astype(np.float32)
    kts = [random_ktensor_host(rng, shape, r, dtype=np.float32) for r in RANKS]
    kw = dict(SETTINGS, epilogue="auto", tol_check_interval=3, tol=1e-5)
    lut.reset_lookup_stats()
    launches.reset()
    res_a, rep_a = cp_cals(x, kts, CalsParams(**kw), device="cpu")
    routes_a = launches.routes()
    assert lut.LOOKUP_STATS["heuristic"] == 2 * 2 * len(shape) and lut.LOOKUP_STATS["exact"] == 0
    launches.reset()
    res_p, rep_p = cp_cals(x, kts, CalsParams(mttkrp_method=MttkrpMethod.PALLAS, **kw), device="cpu")
    assert launches.routes() == routes_a
    assert routes_a["fused" if len(shape) == 3 else "twostep"] > 0
    for kp, ka, mp, ma in zip(res_p, res_a, rep_p.models, rep_a.models):
        assert (mp.id, mp.iters, mp.fit, mp.approx_error) == (ma.id, ma.iters, ma.fit, ma.approx_error)
        for fp, fa in zip(kp.factors + (kp.lam,), ka.factors + (ka.lam,)):
            assert np.array_equal(fp, fa)
