"""The port's component profiles and kernel A/Bs
(``cp_cals_tpu_torch/profiles/``) against the JAX repo's scripts they port
(``scripts/profile_iteration.py``, ``profile_ablation.py``,
``profile_epilogue_ab.py``, ``profile_update_variants.py``,
``bench_pallas_ab.py``, ``tune_pallas_mttkrp.py``), on the CPU.

- Each port output under ``--device cpu`` has the committed JAX file's keys
  (``data/benchmarks/``), apart from the port's ``device``, every time None.
  ``profile_r20_b96.json`` also holds a ``protocol_note`` written by hand,
  which the script does not write.
- Each workload is the JAX script's draw within 4 ulps in float32, the
  bound tests/test_torch_prng.py holds ``prng.normal`` to (its docstring's
  2 ulps are the log1p's alone; X at 13x12x11 reads 3).
- One step of each body against the JAX package's functions, composed as
  the script composes them, on the same NumPy inputs: 1e-10 in float64;
  the Pallas kernels (interpret mode, as tests/test_pallas*.py run them) at
  the kernel tests' float32 bands (tests/test_torch_kernels.py). A step's
  chain weight is set to 1 where the script's would hide the step's result.
- The fused MTTKRP's plan validator refuses each kind of illegal plan and
  takes the planners' own, and the sweep's cases.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cp_cals_tpu.ops.mttkrp import mttkrp_batched as j_mttkrp_batched
from cp_cals_tpu.ops.mttkrp import prepare_batched as j_prepare_batched
from cp_cals_tpu.config import CalsParams as JCalsParams
from cp_cals_tpu.ktensor import Ktensor as JKtensor
from cp_cals_tpu.ktensor import normalize_factor_fused as j_normalize_factor_fused
from cp_cals_tpu.ktensor import normalize_mode as j_normalize_mode
from cp_cals_tpu.ktensor import scale_jk_rows as j_scale_jk_rows
from cp_cals_tpu.ops.error import fast_error as j_fast_error
from cp_cals_tpu.ops.error import fast_error_from_cols as j_fast_error_from_cols
from cp_cals_tpu.ops.gramians import gramian as j_gramian
from cp_cals_tpu.ops.gramians import gramians as j_gramians
from cp_cals_tpu.ops.gramians import hadamard_all as j_hadamard_all
from cp_cals_tpu.ops.gramians import hadamard_but_one as j_hadamard_but_one
from cp_cals_tpu.ops.pallas_epilogue import epilogue_apply_pallas, normal_inverse_pallas
from cp_cals_tpu.ops.pallas_mttkrp import mttkrp_batched_pallas
from cp_cals_tpu.ops.pallas_solve import spd_inverse_pallas
from cp_cals_tpu.ops.update import gj_inverse as j_gj_inverse
from cp_cals_tpu.ops.update import padded_hadamard as j_padded_hadamard
from cp_cals_tpu.ops.update import update_factor_unconstrained as j_update
from cp_cals_tpu.solvers.iteration import make_iteration as j_make_iteration
from cp_cals_tpu.solvers.state import init_state as j_init_state
from cp_cals_tpu_torch import Ktensor
from cp_cals_tpu_torch.ops import fused_mttkrp as fm
from cp_cals_tpu_torch.ops.fused_epilogue import normal_inverse
from cp_cals_tpu_torch.ops.gramians import gramians
from cp_cals_tpu_torch.ops.mttkrp import prepare_batched
from cp_cals_tpu_torch.profiles import _timing as tm
from cp_cals_tpu_torch.profiles import bench_pallas_ab as pab
from cp_cals_tpu_torch.profiles import profile_ablation as pabl
from cp_cals_tpu_torch.profiles import profile_epilogue_ab as pepi
from cp_cals_tpu_torch.profiles import profile_iteration as pit
from cp_cals_tpu_torch.profiles import profile_update_variants as pupd
from cp_cals_tpu_torch.profiles import tune_pallas_mttkrp as ptune
from cp_cals_tpu_torch.solvers.iteration import make_iteration
from cp_cals_tpu_torch.solvers.state import init_state

ROOT = Path(__file__).resolve().parent.parent
SMALL = (6, 5, 4)
B, R = 3, 2
TOL = 1e-10
HIGHEST = jax.lax.Precision.HIGHEST
CPU = torch.device("cpu")
ULPS = 4  # prng.normal against jax.random.normal in float32 (tests/test_torch_prng.py)
COMPONENT_KEYS = {"update_cholesky_solve_ms", "gramian_ms", "normalize_ms", "fast_error_df_ms"}


def committed(name: str) -> dict:
    with open(ROOT / "data" / "benchmarks" / name) as f:
        return json.load(f)


def run_cpu(mod, argv, tmp_path) -> dict:
    out = tmp_path / "out.json"
    res = mod.run(mod.parser().parse_args(argv + ["--device", "cpu", "--out", str(out)]))
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    return res


def times(obj) -> list:
    """Every value under a key ending in ``_ms`` or named ``ms``/``tflops``."""
    if isinstance(obj, dict):
        out = []
        for k, v in obj.items():
            if k.endswith("_ms") or k in ("ms", "tflops") or k.endswith("_tflops"):
                out.append(v)
            elif isinstance(v, (dict, list)):
                out += times(v)
        return out
    if isinstance(obj, list):
        return [t for v in obj for t in times(v)]
    return []


def ulps(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.max(np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want))))


def rng_problem(seed: int = 0, modes=SMALL, b: int = B, r: int = R, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=modes).astype(dtype)
    factors = [(rng.normal(size=(b, m, r)) * 0.3).astype(dtype) for m in modes]
    return x, factors


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return jnp.asarray(np.asarray(a))


def close(got, want, tol=TOL, atol=None):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol if atol is None else atol)


# ------------------------------------------------------------- key sets


@pytest.mark.parametrize("components", [False, True], ids=["plain", "components"])
def test_profile_iteration_keys_equal_the_committed_file(tmp_path, components):
    """profile_r20_b96.json ran with --precisions default, without
    --components; with it, the script's four component keys are added."""
    argv = ["--modes", "6-5-4", "--batch", "3", "--rank", "2", "--n-loop", "2", "--precisions", "default"]
    res = run_cpu(pit, argv + (["--components"] if components else []), tmp_path)
    want = set(committed("profile_r20_b96.json")) - {"protocol_note"}
    assert set(res) == want | (COMPONENT_KEYS if components else set())
    assert res["device"] == "cpu"
    assert all(v is None for v in times(res)) and res["null_roundtrip_ms"] is None


def test_ablation_keys_equal_the_committed_file(tmp_path):
    res = run_cpu(pabl, ["--modes", "6-5-4", "--batch", "3", "--rank", "2", "--n-loop", "2"], tmp_path)
    assert set(res) - {"device"} == set(committed("ablation.json"))
    assert res["precision"] == "high" and res["apply_precision"] is None
    assert all(v is None for v in times(res))


def test_epilogue_ab_keys_equal_the_committed_file(tmp_path):
    res = run_cpu(pepi, ["--modes", "6-5-4", "--batch", "3", "--rank", "2", "--n-loop", "2"], tmp_path)
    assert set(res) - {"device"} == set(committed("epilogue_ab.json"))
    assert all(v is None for v in times(res))


def test_update_variants_keys_equal_the_committed_file(tmp_path):
    """The script's four cases at full (B, R), on a short mode 0."""
    res = run_cpu(pupd, ["--modes", "6-5-4", "--n-loop", "2"], tmp_path)
    assert set(res) == set(committed("update_variants.json"))
    assert all(v is None for v in times(res))


def test_tune_and_bench_write_the_script_keys(tmp_path, monkeypatch):
    """pallas_tune.json's keys and its cases' keys; the names are the port's
    plans (an intended difference). bench_pallas_ab's script writes no
    file: one row per mode."""
    res = run_cpu(ptune, ["--modes", "6-5-4", "--rank", "2", "--batch", "3", "--reps", "1",
                          "--precisions", "highest,high,default", "--n-loop", "2"], tmp_path)
    want = committed("pallas_tune.json")
    assert set(want) <= set(res)
    timed = [c for c in res["cases"] if "refused" not in c]
    assert all(set(want["cases"][0]) <= set(c) for c in timed)
    assert {c["name"].split("/")[0] for c in timed} == {"twostep", "fused"}
    assert len(res["summary"]) == 9 and all(v is None for v in times(res))
    monkeypatch.setattr(pab, "MODES", SMALL)
    ab = run_cpu(pab, ["2", "3", "1", "high"], tmp_path)
    assert [row["mode"] for row in ab["results"]] == [0, 1, 2] and all(v is None for v in times(ab))


# ------------------------------------------------------------- workloads


def jax_draw(modes, b, r, n_keys, scale=0.1):
    ks = jax.random.split(jax.random.PRNGKey(0), n_keys)
    x = jax.random.normal(ks[0], modes, jnp.float32)
    factors = [jax.random.normal(k, (b, m, r), jnp.float32) for k, m in zip(ks[1:], modes)]
    if scale is not None:
        factors = [f * scale for f in factors]
    return ks, np.asarray(x), [np.asarray(f) for f in factors]


@pytest.mark.parametrize("n_keys,scale", [(4, 0.1), (5, 0.1), (4, None)],
                         ids=["iteration_ablation", "epilogue_ab", "pallas_ab_tune"])
def test_draws_are_the_scripts_within_4_ulps(n_keys, scale):
    modes = (13, 12, 11)
    ks, x, factors = jax_draw(modes, 5, 4, n_keys, scale)
    _, px, pf = tm.draw(modes, 5, 4, n_keys, CPU, scale)
    assert ulps(px.numpy(), x) <= ULPS
    for a, w in zip(pf, factors, strict=True):
        assert ulps(a.numpy(), w) <= ULPS


def test_profile_workloads_are_the_scripts_within_4_ulps():
    """profile_iteration's component inputs, epilogue_ab's G and
    update_variants' case (H from its draw A, summed in another order)."""
    modes = (13, 12, 11)
    ks = jax.random.split(jax.random.PRNGKey(0), 4)
    _, kt, g_comp, g_last = pit.workload(modes, 5, 4, CPU)
    assert ulps(g_comp.numpy(), np.asarray(jax.random.normal(ks[1], (5, 12, 4), jnp.float32))) <= ULPS
    assert ulps(g_last.numpy(), np.asarray(jax.random.normal(ks[2], (5, 11, 4), jnp.float32))) <= ULPS
    assert torch.equal(kt.lam, torch.ones(5, 4))
    ks5 = jax.random.split(jax.random.PRNGKey(0), 5)
    w = pepi.workload(modes, 5, 4, CPU)
    assert ulps(w["g0"].numpy(), np.asarray(jax.random.normal(ks5[-1], (5, 13, 4), jnp.float32))) <= ULPS
    ks3 = jax.random.split(jax.random.PRNGKey(0), 3)
    a = jax.random.normal(ks3[0], (7, 4, 4), jnp.float32)
    h_want = jnp.einsum("brs,bts->brt", a, a) + 8.0 * jnp.eye(4, dtype=jnp.float32)
    h, g0 = pupd.workload(7, 4, 13, CPU)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), rtol=2e-6, atol=2e-6)
    assert ulps(g0.numpy(), np.asarray(jax.random.normal(ks3[1], (7, 13, 4), jnp.float32))) <= ULPS


# ---------------------------------------------------------- the ablation


def jax_stage_step(stage, x, x_norm, prepared, mask, iters, prec, aprec):
    """scripts/profile_ablation.py: body(stage)'s step, as written there."""
    n_modes = x.ndim

    def step(carry):
        fs, lam, grams, acc = carry
        g_last = None
        for n in range(n_modes):
            g = j_mttkrp_batched(x, fs, n, "twostep", prec, prepared[n])
            if n == n_modes - 1:
                g_last = g
            if stage == 1:
                fs = tuple(f if m != n else f * 0.999 + g * 1e-12 for m, f in enumerate(fs))
                continue
            h = j_padded_hadamard(j_hadamard_but_one(grams, n), mask)
            u = j_update(g, h, aprec)
            if stage == 2:
                fs = tuple(f if m != n else u * 1e-12 + f * 0.999 for m, f in enumerate(fs))
                continue
            f_new, lam_new, gm = j_normalize_factor_fused(u, iters, prec)
            fs = tuple(f_new if m == n else f for m, f in enumerate(fs))
            lam = lam_new
            grams = tuple(gm if m == n else gg for m, gg in enumerate(grams))
        if stage >= 4:
            err = j_fast_error(x_norm, lam, fs[-1], g_last, j_hadamard_all(grams))
            acc = acc + jnp.sum(err) * 1e-20
        return fs, lam, grams, acc

    return step


@pytest.mark.parametrize("apply_precision", [None, "highest"], ids=["update", "tier_matmul"])
@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_ablation_stage_step_matches_the_script(stage, apply_precision):
    """Float64 at "highest" (the JAX package's CPU computes every tier
    exactly; the port's plain bf16 tiers round): two steps."""
    x, factors = rng_problem(stage)
    lam0 = np.ones((B, R))
    mask = np.ones((B, R), bool)
    iters = np.full((B,), 5, np.int32)
    xt = t(x)
    x_norm = torch.linalg.vector_norm(xt.reshape(-1))
    step = pabl.stage_step(stage, xt, x_norm, prepare_batched(xt, ("twostep",) * 3), t(mask), t(iters),
                           "highest", apply_precision)
    carry = pabl.initial_carry(tuple(t(f) for f in factors), t(lam0))
    xj = j(x)
    jstep = jax_stage_step(stage, xj, jnp.linalg.norm(xj.ravel()), j_prepare_batched(xj, ("twostep",) * 3),
                           j(mask), j(iters), HIGHEST, HIGHEST)
    jfs = tuple(j(f) for f in factors)
    jcarry = (jfs, j(lam0), j_gramians(jfs), jnp.zeros(()))
    for _ in range(2):
        carry, jcarry = step(carry), jstep(jcarry)
    for a, w in zip(carry[0] + (carry[1],) + carry[2], jcarry[0] + (jcarry[1],) + jcarry[2], strict=True):
        close(a, w)
    close(carry[3], jcarry[3], atol=0)


# ------------------------------------------------------- the iteration


def jax_params(epilogue: str) -> JCalsParams:
    return JCalsParams(precision="highest", force_max_iter=True, max_iterations=10**9, epilogue=epilogue)


@pytest.mark.parametrize("epilogue", ["xla", "fused"])
def test_iteration_step_matches_jax(epilogue):
    """The profiled iteration (forced, epilogue xla or fused) chained on its
    state, two steps against JAX's: float64 for the unfused path; the
    fused one in float32 at the epilogue kernels' band (JAX's Pallas
    kernels in interpret mode off a TPU)."""
    dtype = np.float64 if epilogue == "xla" else np.float32
    tol = TOL if epilogue == "xla" else 2e-4
    x, factors = rng_problem(7, dtype=dtype)
    params = dataclasses.replace(pit.iteration_params(epilogue), precision="highest")
    it = make_iteration(params, batched=True)
    xt = t(x)
    x_norm = torch.linalg.vector_norm(xt.reshape(-1))
    step = pit.iteration_step(it, xt, x_norm, it.prepare(xt))
    state = init_state(Ktensor(tuple(t(f) for f in factors), torch.ones(B, R, dtype=xt.dtype)), x_norm)
    jit = j_make_iteration(jax_params(epilogue), batched=True)
    xj = j(x)
    jx_norm = jnp.linalg.norm(xj.ravel())
    jprep = jit.prepare(xj)
    jstate = j_init_state(JKtensor(tuple(j(f) for f in factors), jnp.ones((B, R), xj.dtype)), jx_norm)
    for _ in range(2):
        state, jstate = step(state), jit(xj, jstate, jx_norm, jprep)
    for a, w in zip(state.kt.factors + (state.kt.lam, state.fit, state.approx_error),
                    jstate.kt.factors + (jstate.kt.lam, jstate.fit, jstate.approx_error), strict=True):
        close(a, w, tol)
    assert state.iters.tolist() == np.asarray(jstate.iters).tolist()


def test_check_iteration_holds_fused_against_unfused():
    """The check the card runs before timing the iteration: on the CPU the
    fused path's plain versions against the unfused path."""
    x, factors = rng_problem(8, dtype=np.float32)
    params = pit.iteration_params("fused")
    it = make_iteration(params, batched=True)
    xt = t(x)
    x_norm = torch.linalg.vector_norm(xt.reshape(-1))
    prepared = it.prepare(xt)
    state0 = init_state(Ktensor(tuple(t(f) for f in factors), torch.ones(B, R)), x_norm)
    out = pit.check_iteration(params, xt, state0, x_norm, it, prepared)
    assert set(out) == {"mttkrp_m0", "mttkrp_m1", "mttkrp_m2", "fused_vs_xla"}
    assert out["fused_vs_xla"] <= tm.TOL["iteration"]
    flipped = (state0.kt.factors[0], torch.flip(state0.kt.factors[1], dims=[1]), state0.kt.factors[2])
    bad = state0._replace(kt=Ktensor(flipped, state0.kt.lam))
    with pytest.raises(AssertionError):
        tm.check_states("doubled", it(xt, bad, x_norm, prepared), it(xt, state0, x_norm, prepared))


@pytest.mark.parametrize("method", ["krp_gemm", "twostep"])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_mttkrp_step_matches_the_script(mode, method):
    x, factors = rng_problem(10 + mode)
    xt, xj = t(x), j(x)
    fs = tuple(t(f) for f in factors)
    other, step = pit.mttkrp_step(xt, fs, mode, method, "highest",
                                  prepare_batched(xt, (method,) * 3)[mode], weight=1.0)
    jprep = j_prepare_batched(xj, (method,) * 3)
    jfs = [j(f) for f in factors]
    g = j_mttkrp_batched(xj, tuple(jfs), mode, method, HIGHEST, jprep[mode])
    close(step(fs[other]), jfs[other] + jnp.sum(g, axis=-2, keepdims=True))


def test_component_steps_match_the_script():
    """--components: the update (the script's default solve), the gramian,
    normalize_mode at iteration 5, the FastALS error; float64."""
    x, factors = rng_problem(20)
    lam = np.linspace(0.5, 2.0, B * R).reshape(B, R)
    kt, jkt = Ktensor(tuple(t(f) for f in factors), t(lam)), JKtensor(tuple(j(f) for f in factors), j(lam))
    h0 = np.eye(R) + 0.01 * np.ones((R, R))
    g = factors[1] * 1.7
    close(pit.update_step(t(np.broadcast_to(h0, (B, R, R))))(t(g)),
          j_update(j(g), jnp.broadcast_to(j(h0), (B, R, R)), HIGHEST) * 0.999 + 0.001)
    close(pit.gramian_step(1.0)(t(g)), j(g) + jnp.sum(j_gramian(j(g), HIGHEST), axis=-2)[..., None, :])
    it5 = torch.tensor(5, dtype=torch.int32)
    kt3 = j_normalize_mode(JKtensor((j(g),) + jkt.factors[1:], jkt.lam), 0, jnp.int32(5))
    close(pit.normalize_step(kt, it5, 1.0)(t(g)), kt3.factors[0] + kt3.lam[..., :1, None])
    gh = np.broadcast_to(np.eye(R), (B, R, R))
    gl = factors[2] * 0.5
    x_norm = float(np.linalg.norm(x))
    close(pit.error_step(torch.tensor(x_norm, dtype=torch.float64), kt, t(gh), 1.0)(t(gl)),
          j(gl) + j_fast_error(jnp.asarray(x_norm), jkt.lam, jkt.factors[-1], j(gl), j(gh))[..., None, None])


def test_matmul_probe_step_matches_the_script():
    rng = np.random.default_rng(3)
    a, krp = rng.normal(size=(6, 20)), rng.normal(size=(20, 6))
    close(pit.matmul_step(t(krp), "highest", 1.0)(t(a)),
          j(a) + jnp.sum(jnp.matmul(j(a), j(krp), precision=HIGHEST), axis=1, keepdims=True))


# ------------------------------------------------- the epilogue A/B


def epilogue_problem(dtype=np.float32, seed: int = 30):
    x, factors = rng_problem(seed, modes=(9, 8, 7), b=4, r=5, dtype=dtype)
    rng = np.random.default_rng(seed + 1)
    w = dict(
        kt=Ktensor(tuple(t(f) for f in factors), torch.ones(4, 5, dtype=t(x).dtype)),
        x_norm=torch.tensor(float(np.linalg.norm(x)), dtype=t(x).dtype),
        grams=gramians([t(f) for f in factors]), mask=torch.ones(4, 5, dtype=torch.bool),
        iters=torch.full((4,), 5, dtype=torch.int32), jk=torch.tensor([1, -1, 3, -1], dtype=torch.int32),
        g0=t(rng.normal(size=(4, 9, 5)).astype(dtype)),
    )
    return w


def test_inverse_steps_match_the_script():
    """The unfused inverse in float64 at 1e-10; the kernel's plain version
    against JAX's hinv kernel (interpret) at the float32 band."""
    w = epilogue_problem(np.float64)
    grams_j = tuple(j(g.numpy()) for g in w["grams"])
    mask_j = j(w["mask"].numpy())
    gg = w["grams"][0]
    want = grams_j[0] + j_gj_inverse(j_padded_hadamard(j_hadamard_but_one(grams_j, 1), mask_j))
    close(pepi.inverse_unfused_step(w["grams"], w["mask"], 1.0)(gg), want)
    w32 = epilogue_problem(np.float32)
    grams32 = tuple(j(g.numpy()) for g in w32["grams"])
    want = grams32[0] + normal_inverse_pallas(grams32, mask_j, 1, interpret=True)
    close(pepi.inverse_kernel_step(w32["grams"], w32["mask"], 1.0)(w32["grams"][0]), want, 2e-4)


@pytest.mark.parametrize("with_err", [False, True], ids=["err0", "err1"])
def test_apply_kernel_step_matches_jax_pallas(with_err):
    """The apply of the script's body on mode 0 (jackknife rows zeroed)
    against JAX's apply kernel in interpret mode, the gramian rescaled and
    the error finished as JAX's iteration does (fast_error_from_cols on the
    other modes' gramians and the new one); float32 band."""
    w = epilogue_problem(np.float32)
    hinv0 = normal_inverse(w["grams"], w["mask"], 0)
    b = w["mask"].shape[0]
    f, lam, gm_raw, t3 = epilogue_apply_pallas(j(w["g0"].numpy()), j(hinv0.numpy()), j(w["iters"].numpy()),
                                               j(w["jk"].numpy()), zero_jk=True, with_err=with_err,
                                               interpret=True)
    safe = jnp.where(lam != 0, lam, 1.0)
    gm = gm_raw / (safe[..., :, None] * safe[..., None, :])
    extra = 0.0
    if with_err:
        others = tuple(j(g.numpy()) for g in w["grams"][1:])
        x_norm = jnp.full((b,), float(w["x_norm"]), jnp.float32)
        extra = j_fast_error_from_cols(x_norm, lam, t3[0], t3[1], j_hadamard_all(others + (gm,)))[:, None, None]
    g0 = j(w["g0"].numpy())
    want = g0 + f + (gm[..., :1, :] + lam[..., None, :] + extra)
    close(pepi.apply_kernel_step(hinv0, w, with_err, 1.0)(w["g0"]), want, 2e-4)


def test_apply_unfused_step_matches_the_script():
    w = epilogue_problem(np.float64)
    grams_j = tuple(j(g.numpy()) for g in w["grams"])
    h = j_padded_hadamard(j_hadamard_but_one(grams_j, 0), j(w["mask"].numpy()))
    gg = j(w["g0"].numpy())
    u = j_scale_jk_rows(j_update(gg, h, HIGHEST), j(w["jk"].numpy()), 0.0)
    f, lam, gm = j_normalize_factor_fused(u, j(w["iters"].numpy()), HIGHEST)
    close(pepi.apply_unfused_step(w, 1.0)(w["g0"]), gg + f + (gm[..., :1, :] + lam[..., None, :]))


def test_check_epilogue_reads_the_plain_versions():
    w = epilogue_problem(np.float32)
    out = pepi.check_epilogue(w, normal_inverse(w["grams"], w["mask"], 0))
    assert out == {"inverse": 0.0, "apply_err0": 0.0, "apply_err1": 0.0}


# ---------------------------------------------- update variants and tails


@pytest.mark.parametrize("solve", pupd.SOLVES)
def test_update_step_matches_the_script(solve):
    """chol and gj through JAX's update at 1e-10 in float64; "pallas" (the
    SPD-inverse kernel's plain version, then the product) against JAX's
    Pallas inverse in interpret mode, then its einsum, at the float32
    band."""
    dtype, tol = (np.float32, 2e-4) if solve == "pallas" else (np.float64, TOL)
    rng = np.random.default_rng(40)
    a = rng.normal(size=(5, 4, 4))
    h = (np.einsum("brs,bts->brt", a, a) + 8.0 * np.eye(4)).astype(dtype)
    g = rng.normal(size=(5, 7, 4)).astype(dtype)
    got = pupd.update_step(t(h), solve)(t(g))
    if solve == "pallas":
        want = jnp.einsum("bir,brt->bit", j(g), spd_inverse_pallas(j(h), interpret=True), precision=HIGHEST)
    else:
        want = j_update(j(g), j(h), HIGHEST, solve=solve)
    close(got, want * 0.999 + 0.001, tol)


@pytest.mark.parametrize("iteration", [1, 5])
def test_tails_match_the_script(iteration):
    """Both tails at 1e-10 in float64, with the gramian and lam carried
    whole; at iteration 1 the L2 norms, after it the signed max."""
    rng = np.random.default_rng(50 + iteration)
    u = rng.normal(size=(4, 7, 3))
    lam = np.ones((4, 3))
    iters = np.full((4,), iteration, np.int32)
    kt2 = j_normalize_mode(JKtensor((j(u),), j(lam)), 0, j(iters))
    gm = j_gramian(kt2.factors[0], HIGHEST)
    want = kt2.factors[0] + (jnp.sum(gm, axis=-2) + kt2.lam)[..., None, :]
    close(pupd.tail_current_step(t(lam), t(iters), 1.0)(t(u)), want)
    gm_raw = j_gramian(j(u), HIGHEST)
    l2 = jnp.sqrt(jnp.abs(jnp.diagonal(gm_raw, axis1=-2, axis2=-1)))
    mx, mn = jnp.max(j(u), axis=-2), jnp.min(j(u), axis=-2)
    lam_new = jnp.where((j(iters) == 1)[..., None], l2, jnp.where(mx >= -mn, mx, mn))
    safe = jnp.where(lam_new != 0, lam_new, 1.0)
    gm = gm_raw / (safe[..., :, None] * safe[..., None, :])
    want = j(u) / safe[..., None, :] + (jnp.sum(gm, axis=-2) + lam_new)[..., None, :]
    close(pupd.tail_fused_step(t(iters), 1.0)(t(u)), want)
    close(pupd.tail_fused_step(t(iters), 1.0)(t(u)), pupd.tail_current_step(t(lam), t(iters), 1.0)(t(u)))


# --------------------------------------------- the fused MTTKRP A/B


@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_pallas_ab_fused_step_matches_jax_pallas(tier):
    """bench_pallas_ab's fused step (the kernel's plain version) against
    JAX's Pallas MTTKRP in interpret mode, every mode, at the MTTKRP band
    (rtol 2e-5, atol 1e-4 a row of G, summed over the mode's rows)."""
    x, factors = rng_problem(60, modes=(20, 13, 9), b=3, r=5, dtype=np.float32)
    xt = t(x)
    fs = tuple(t(f) for f in factors)
    jfs = tuple(j(f) for f in factors)
    for mode in range(3):
        g = mttkrp_batched_pallas(j(x), jfs, mode, precision=tier, ti=8, cj=4, interpret=True)
        other = tm.first_other(3, mode)
        _, step = pab.make_step(xt, mode, "fused", tier, weight=1.0)
        out = step(fs)
        np.testing.assert_allclose(out[other].numpy(), np.asarray(jfs[other] + jnp.sum(g, axis=-2, keepdims=True)),
                                   rtol=2e-5, atol=1e-4 * x.shape[mode])
        assert all(out[m] is fs[m] for m in range(3) if m != other)


def test_pallas_ab_twostep_step_matches_the_script():
    """bench_pallas_ab's twostep step against JAX's, float64 at "highest"."""
    x, factors = rng_problem(61, modes=(20, 13, 9), b=3, r=5)
    xt, xj = t(x), j(x)
    fs, jfs = tuple(t(f) for f in factors), tuple(j(f) for f in factors)
    jprep = j_prepare_batched(xj, ("twostep",) * 3)
    for mode in range(3):
        other = tm.first_other(3, mode)
        g = j_mttkrp_batched(xj, jfs, mode, "twostep", HIGHEST, jprep[mode])
        _, step = pab.make_step(xt, mode, "twostep", "highest", weight=1.0)
        close(step(fs)[other], jfs[other] + jnp.sum(g, axis=-2, keepdims=True))


# ------------------------------------------------- plans and their sweep

J, I, K, C = 41, 301, 299, 1920  # mode 1 of 299x301x41 at B = 96, R = 20
SMEM = ptune.H100.smem_block


@pytest.mark.parametrize("plan,why", [
    ((5, 304, 1, 1, 41), "not one of the built tiles"),
    ((0, 300, 1, 1, 41), "not a multiple of the stage"),
    ((0, 16, 1, 1, 41), "do not cover K"),
    ((0, 304, 2, 1, 41), "do not cover K"),
    ((0, 304, 1, 4, 10), "do not cover J"),
    ((0, 304, 1, 5, 11), "do not cover J"),
    ((0, 4096, 1, 1, 41), "shared memory"),
    ((0, 304, 1, 1, 41, 0), "five integers"),
    ((0, 304, 1, 1.5, 41), "five integers"),
    (None, "five integers"),
], ids=["tile", "stage", "k_short", "k_empty", "j_short", "j_empty", "smem", "length", "float", "none"])
def test_fp32_plan_validator_refuses(plan, why):
    with pytest.raises(ValueError, match=why):
        fm.check_fp32_plan(plan, J, I, K, SMEM)


@pytest.mark.parametrize("plan,why", [
    ((96, 320, 1, 1, 41), "column tile"),
    ((128, 304, 1, 1, 41), "not a multiple of the stage"),
    ((128, 256, 1, 1, 41), "do not cover K"),
    ((128, 320, 1, 2, 41), "do not cover J"),
    ((128, 1024, 1, 1, 41), "shared memory"),
], ids=["nc", "stage", "k_short", "j_empty", "smem"])
def test_tc_plan_validator_refuses(plan, why):
    with pytest.raises(ValueError, match=why):
        fm.check_tc_plan(plan, J, I, fm.padded_k(K), 2, SMEM)


def test_plan_validators_refuse_a_grid_beyond_the_launch_limit():
    with pytest.raises(ValueError, match="launch limit"):
        fm.check_fp32_plan((1, 16, 1, 70_000, 1), 70_000, 7, 10, SMEM)
    with pytest.raises(ValueError, match="launch limit"):
        fm.check_tc_plan((16, 64, 1, 1, 3), 3, 64 * 70_000, 8, 1, SMEM)


@pytest.mark.parametrize("shape,b,r", [((299, 301, 41), 96, 20), ((299, 301, 41), 80, 4), ((20, 13, 9), 3, 5),
                                       ((500, 500, 500), 25, 20), ((7, 5, 3), 1, 1)])
def test_plan_validators_take_the_planners_own(shape, b, r):
    card = ptune.H100
    for mode in range(3):
        small, big = fm.split_others(shape, mode)
        jj, ii, kk = shape[small], shape[mode], shape[big]
        plan = fm.plan_fp32(jj, ii, kk, b * r, card.n_sm, card.smem_block)
        assert fm.check_fp32_plan(plan, jj, ii, kk, card.smem_block) == plan
        for planes in (1, 2):
            kp = fm.padded_k(kk)
            plan = fm.plan_tc(jj, ii, kp, b * r, planes, card.n_sm, card.smem_block, card.smem_sm)
            assert fm.check_tc_plan(plan, jj, ii, kp, planes, card.smem_block) == plan


@pytest.mark.parametrize("tier", ["highest", "high", "default"])
def test_sweep_cases(tier):
    """The planner's pick first; every tile (column tile) at 1/2, 1 and 2
    times its j splits; names unique and from the plan; every case covers
    J with its splits; on 299x301x41 at B = 96, R = 20 an H100 takes all."""
    for mode in range(3):
        cases = ptune.sweep((299, 301, 41), mode, 96, 20, tier, ptune.H100)
        assert cases[0]["planner"] and not any(c["planner"] for c in cases[1:])
        assert len({c["name"] for c in cases}) == len(cases)
        assert all(c["name"] == ptune.case_name(c["plan"], tier) and "refused" not in c for c in cases)
        lead = {c["plan"][0] for c in cases}
        assert lead == (set(fm.FP32_TILES) if tier == "highest" else set(fm._TC_NC))
        js = cases[0]["plan"][3]
        assert {c["plan"][3] for c in cases} == {max(1, js // 2), js, 2 * js}
        j = (299, 301, 41)[fm.split_others((299, 301, 41), mode)[0]]
        assert all((c["plan"][3] - 1) * c["plan"][4] < j <= c["plan"][3] * c["plan"][4] for c in cases)


def test_sweep_records_a_refused_plan():
    """A card whose blocks hold less shared memory refuses the widest
    column tile at "high": recorded with the validator's reason."""
    small = ptune.H100._replace(smem_block=160_000)
    cases = ptune.sweep((299, 301, 41), 0, 96, 20, "high", small)
    refused = [c for c in cases if "refused" in c]
    assert refused and all("shared memory" in c["refused"] for c in refused)
    assert not any(c["planner"] for c in refused)
