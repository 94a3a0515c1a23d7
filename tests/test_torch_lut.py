"""The port's MTTKRP lookup tables (``cp_cals_tpu_torch/utils/lut.py``) on
the CPU, against the JAX package's (``cp_cals_tpu/utils/lut.py``).

Nothing here tunes on the card: ``autotune`` runs on tiny shapes with the
host's clock, or with a patched timer. Every table lives in a temporary
root.
"""

import numpy as np
import pytest
import torch

import cp_cals_tpu.utils.lut as jlut
import cp_cals_tpu_torch.utils.lut as lut
from cp_cals_tpu_torch import CalsParams, cp_cals, random_ktensor_host
from cp_cals_tpu_torch.ops import fused_mttkrp as fm
from cp_cals_tpu_torch.ops import mttkrp as mt
from cp_cals_tpu_torch.solvers import cals as pcals

MODES = (10, 9, 8)


@pytest.fixture
def root(tmp_path, monkeypatch):
    monkeypatch.setattr(lut, "_ROOT", str(tmp_path))
    lut.reset_lookup_stats()
    return tmp_path


def test_lut_store_and_lookup(root):
    """tests/test_utils.py:test_lut_store_and_lookup, on the port: the
    stored entries are read back; a mode without any entry takes the
    heuristic (the fused kernels, which take every 3-D mode on the CPU)."""
    lut._store(MODES, {"16x4:0": "twostep", "16x4:1": "krp_gemm"}, "cpu")
    got = lut.lookup_methods(MODES, rank=4, batch=16, device="cpu")
    assert got == ("twostep", "krp_gemm", "pallas")
    assert lut.LOOKUP_STATS == {"exact": 2, "nearest": 0, "heuristic": 1}
    assert (root / "cpu-cpu" / "10-9-8.json").exists()


def test_heuristic_methods():
    """The card's rule: the fused kernels where their gate takes the mode,
    the twostep elsewhere (every N-D mode); today's AUTO resolution."""
    from cp_cals_tpu_torch.config import resolve_mttkrp_method

    assert lut.heuristic_methods((299, 301, 41)) == ("pallas",) * 3
    assert lut.heuristic_methods((5, 5, 5, 5)) == ("twostep",) * 4
    for shape in ((299, 301, 41), (5, 5, 5, 5)):
        for dtype in (torch.float32, torch.float64):
            assert lut.heuristic_methods(shape, 8, 16, "default", dtype, "cpu") == resolve_mttkrp_method(
                CalsParams(), shape, dtype, "cpu")


def test_keys_and_tiers():
    """JAX's key format; "highest" has its own suffix in the port, where
    JAX folds it into "high"."""
    assert lut._key(16, 4, 2) == jlut._key(16, 4, 2) == "16x4:2"
    assert lut._key(16, 4, 0, "default") == jlut._key(16, 4, 0, "default") == "16x4@default:0"
    assert lut._key(16, 4, 1, "highest") == "16x4@highest:1"
    assert jlut._key(16, 4, 1, "highest") == "16x4:1"
    assert lut._tier(None) == "high"


def test_device_tag():
    assert lut._device_tag("cpu") == "cpu-cpu"
    assert lut._table_path((3, 4, 5), "cpu").endswith("cpu-cpu/3-4-5.json")


def _parity_table():
    """Entries at both tiers for a few (B, R) per mode, mixed methods, and
    "@highest" entries that neither package's high/default lookups take."""
    rng = np.random.default_rng(0)
    table = {}
    for mode in range(3):
        for b, r in ((8, 4), (32, 8), (64, 16), (16, 20)):
            for tier in ("high", "default", "highest"):
                if rng.random() < 0.75:
                    table[jlut._key(b, r, mode, tier) if tier != "highest" else f"{b}x{r}@highest:{mode}"] = \
                        str(rng.choice(lut.METHODS))
    table["1x1:1"] = "not_a_method"  # ignored by both
    return table


@pytest.mark.parametrize("precision", ["high", "default"])
def test_lookup_parity_with_jax(tmp_path, monkeypatch, precision):
    """One table written once and read by both packages (roots and device
    tags patched to one directory): the same picks over a grid of (B, R,
    mode), exact and nearest entries alike."""
    monkeypatch.setattr(lut, "_ROOT", str(tmp_path))
    monkeypatch.setattr(jlut, "_ROOT", str(tmp_path))
    monkeypatch.setattr(lut, "_device_tag", lambda device=None: "shared")
    monkeypatch.setattr(jlut, "_device_tag", lambda: "shared")
    lut._store(MODES, _parity_table(), "cpu")
    lut.reset_lookup_stats()
    jlut.reset_lookup_stats()
    n = 0
    for b in (1, 4, 8, 16, 32, 64, 96):
        for r in (2, 4, 8, 16, 20):
            got = lut.lookup_methods(MODES, r, b, precision, device="cpu")
            want = jlut.lookup_methods(MODES, r, b, precision)
            assert got == want, (b, r)
            n += 1
    assert lut.LOOKUP_STATS == jlut.LOOKUP_STATS
    assert lut.LOOKUP_STATS["exact"] > 0 and lut.LOOKUP_STATS["nearest"] > 0
    assert lut.LOOKUP_STATS["heuristic"] == 0 and sum(lut.LOOKUP_STATS.values()) == 3 * n


def test_screen_refuses_what_the_gate_refuses(root, monkeypatch):
    """A fused pick the gate refuses goes to the twostep: on an N-D tensor,
    and where a nearest entry measured at a smaller (B, R) is inherited by
    a (B, R) the gate refuses (gate patched: mode 1 above B*R = 64)."""
    lut._store((4, 5, 6, 3), {"8x4:0": "pallas", "8x4:1": "krp_gemm", "8x4:2": "pallas", "8x4:3": "twostep"},
               "cpu")
    assert lut.lookup_methods((4, 5, 6, 3), 4, 8, device="cpu") == ("twostep", "krp_gemm", "twostep", "twostep")
    real = fm.fused_mttkrp_supported

    def gate(shape, mode, b, r, dtype, device):
        return real(shape, mode, b, r, dtype, device) and not (mode == 1 and b * r > 64)

    monkeypatch.setattr(fm, "fused_mttkrp_supported", gate)
    lut._store(MODES, {f"8x4:{m}": "pallas" for m in range(3)}, "cpu")
    assert lut.lookup_methods(MODES, 4, 8, device="cpu") == ("pallas",) * 3
    assert lut.lookup_methods(MODES, 8, 32, device="cpu") == ("pallas", "twostep", "pallas")
    assert lut.LOOKUP_STATS["nearest"] == 3
    assert lut._screen("pallas", MODES, 1, 8, 32) == "twostep"
    assert lut._screen("krp_gemm", MODES, 1, 8, 32) == "krp_gemm"


def test_autotune_writes_every_mode_and_ensure_hits_exactly(root):
    from cp_cals_tpu_torch import launches

    before = launches.read(), launches.routes()
    got = lut.autotune((6, 5, 4), rank=2, batch=3, reps=1, precision="default", device="cpu")
    assert len(got) == 3 and all(m in lut.METHODS for m in got)
    table = lut._load((6, 5, 4), "cpu")
    assert {k: table[k] for k in sorted(table)} == {f"3x2@default:{m}": got[m] for m in range(3)}
    for m in range(3):
        assert set(lut.LAST_TIMES[f"3x2@default:{m}"]) == set(lut.METHODS)
    assert (launches.read(), launches.routes()) == before  # the autotune's calls leave no counts
    lut.reset_lookup_stats()
    assert lut.ensure_methods((6, 5, 4), 2, 3, precision="default", device="cpu") == got
    assert lut.LOOKUP_STATS == {"exact": 3, "nearest": 0, "heuristic": 0}


@pytest.mark.parametrize("times, want", [
    ({"krp_gemm": 1.0, "twostep": 1.05, "pallas": 1.2}, "twostep"),  # within the 10 % margin
    ({"krp_gemm": 1.2, "twostep": 1.3, "pallas": 1.0}, "pallas"),
    ({"krp_gemm": 1.0, "twostep": 1.2, "pallas": 1.5}, "krp_gemm"),
])
def test_autotune_margin_keeps_the_twostep(root, monkeypatch, times, want):
    seen = []

    def timer(fns, reps, device):
        seen.append(sorted(fns))
        return {m: times[m] for m in fns}

    monkeypatch.setattr(lut, "_time_candidates", timer)
    assert lut.autotune((6, 5, 4), 2, 3, device="cpu") == (want,) * 3
    assert seen == [sorted(lut.METHODS)] * 3
    # N-D: the gate refuses the fused kernels, two candidates per mode.
    seen.clear()
    lut.autotune((4, 3, 3, 2), 2, 3, device="cpu")
    assert seen == [["krp_gemm", "twostep"]] * 4


def test_autotune_raises_where_a_candidate_fails(root, monkeypatch):
    """No quiet fallback: a candidate the gate takes and that fails raises,
    where the JAX package skips it."""
    def broken(*a, **k):
        raise RuntimeError("kernel failed to launch")

    monkeypatch.setattr(mt, "mttkrp_batched_fused", broken)
    with pytest.raises(RuntimeError, match="failed to launch"):
        lut.autotune((6, 5, 4), 2, 3, reps=1, device="cpu")
    assert lut._load((6, 5, 4), "cpu") == {}


def _engine_problem():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(7, 6, 5))
    return x, [random_ktensor_host(rng, x.shape, r) for r in (1, 2, 3, 4, 2, 1)]


def test_engine_never_autotunes_on_the_cpu(root, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("autotune called on the CPU")

    monkeypatch.setattr(lut, "autotune", refuse)
    monkeypatch.setattr(lut, "ensure_methods", refuse)
    monkeypatch.setattr(lut, "_time_candidates", refuse)
    x, queue = _engine_problem()
    params = CalsParams(max_iterations=3, force_max_iter=True, bucket_ranks=(2, 4), buffer_size=8,
                        precision="highest", mttkrp_precision="default", polish_iters=1)
    _, rep = cp_cals(x, queue, params, device="cpu")
    assert len(rep.models) == len(queue)
    assert lut.LOOKUP_STATS["heuristic"] > 0 and lut.LOOKUP_STATS["exact"] == 0


@pytest.mark.parametrize("no_autotune", [False, True])
def test_bucket_methods_tune_on_the_card_only(monkeypatch, no_autotune):
    """``_resolve_bucket_methods``: on a CUDA device the table is ensured
    (autotuned on a miss) unless CP_CALS_NO_AUTOTUNE is set; on the CPU it
    is read; fast and polish tiers; None for an explicit method."""
    calls = []

    def fake(name):
        def get(modes, rank, batch, precision="high", dtype=torch.float32, device=None, **kw):
            calls.append((name, precision, torch.device(device).type))
            return ("twostep",) * 3 if precision == "default" else ("krp_gemm",) * 3
        return get

    monkeypatch.setattr(lut, "ensure_methods", fake("ensure"))
    monkeypatch.setattr(lut, "lookup_methods", fake("lookup"))
    if no_autotune:
        monkeypatch.setenv("CP_CALS_NO_AUTOTUNE", "1")
    else:
        monkeypatch.delenv("CP_CALS_NO_AUTOTUNE", raising=False)
    p = CalsParams(precision="high", mttkrp_precision="default", polish_iters=2)
    got = pcals._resolve_bucket_methods(MODES, 4, 16, p, torch.float32, "cuda")
    assert got == (("twostep",) * 3, ("krp_gemm",) * 3)
    name = "lookup" if no_autotune else "ensure"
    assert calls == [(name, "default", "cuda"), (name, "high", "cuda")]
    calls.clear()
    assert pcals._resolve_bucket_methods(MODES, 4, 16, p, torch.float32, "cpu")[0] == ("twostep",) * 3
    assert [c[0] for c in calls] == ["lookup", "lookup"]
    calls.clear()
    same = CalsParams(precision="default", mttkrp_precision="default", polish_iters=2)
    assert pcals._resolve_bucket_methods(MODES, 4, 16, same, torch.float32, "cpu") == (("twostep",) * 3, None)
    from cp_cals_tpu_torch import MttkrpMethod

    assert pcals._resolve_bucket_methods(MODES, 4, 16, CalsParams(mttkrp_method=MttkrpMethod.PALLAS),
                                         torch.float32, "cuda") == (None, None)
