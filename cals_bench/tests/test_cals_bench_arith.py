"""The frozen arithmetic of the yardstick against hand counts."""

import math
from types import SimpleNamespace

import pytest

from cals_bench import arith, trace


def test_mttkrp_and_iteration_flops_by_hand():
    # Mode 0 of 4x5x6 at rank 2: the KRP (5*6 rows x 2) and the GEMM 2*4*30*2.
    assert arith.mttkrp_flops((4, 5, 6), 2, 0) == 30 * 2 + 2 * 4 * 30 * 2
    assert arith.mttkrp_flops((4, 5, 6), 2, 2, batch=3) == 3 * (20 * 2 + 2 * 6 * 20 * 2)
    it = sum(arith.mttkrp_flops((4, 5, 6), 2, n) for n in range(3)) + sum(3 * m * 4 + 8 // 3 for m in (4, 5, 6))
    assert arith.als_iteration_flops((4, 5, 6), 2) == it


def test_job_work_counts_own_ranks_iterations_and_polish():
    modes = (10, 20, 30)
    w = arith.job_work(modes, [(3, 50), (5, 50)], "default", "high", 1)
    per = lambda r: sum(arith.mttkrp_flops(modes, r, n) for n in range(3))  # noqa: E731
    assert w["mttkrp_flops"] == {"default": 50 * (per(3) + per(5)), "high": per(3) + per(5)}
    assert w["als_flops"] == 51 * (arith.als_iteration_flops(modes, 3) + arith.als_iteration_flops(modes, 5))
    x = 6000 * 3  # the tensor, once per sweep and mode
    factors = 4 * 3 * 60 * 51 * (3 + 5)
    assert w["mttkrp_bytes"] == x * (2 * 50 + 4 * 1) + factors
    same = arith.job_work(modes, [(3, 7)], "highest", "highest", 0)
    assert same["mttkrp_flops"] == {"highest": 7 * per(3)}


def test_bound_is_the_larger_time_at_each_tiers_peak():
    peaks = arith.PEAKS["NVIDIA H100 80GB HBM3"]
    t, by = arith.bound_seconds({"default": 989e12, "highest": 67e12}, 3.35e12, peaks)
    assert (t, by) == (pytest.approx(2.0), "operations")
    t, by = arith.bound_seconds({"high": 989e9}, 3.35e12 * 2, peaks)
    assert (t, by) == (pytest.approx(2.0), "bytes")


def _run(jobs, family_s, window_s=1.0, tiers=("highest", "highest")):
    tr = trace.TraceData(busy_s=0.5, window_s=window_s, kernel_s={}, family_s=family_s)
    return SimpleNamespace(jobs=jobs, trace=tr, peaks=arith.PEAKS["NVIDIA H100 80GB HBM3"], window_s=window_s,
                           tiers=tiers)


def test_roofline_share_of_a_kernel_at_its_bound_is_100(tiny):
    work = arith.job_work((100, 100, 100), [(10, 50)], "highest", "highest", 0)
    bound, _ = arith.bound_seconds(work["mttkrp_flops"], work["mttkrp_bytes"], arith.PEAKS["NVIDIA H100 80GB HBM3"])
    job = SimpleNamespace(work=work)
    read = tiny.metric("mttkrp_roofline_pct").read
    assert read(_run([job, job], {"mttkrp": 2 * bound})) == pytest.approx(100.0)
    assert read(_run([job], {"mttkrp": 4 * bound})) == pytest.approx(25.0)
    assert read(_run([job], {})) is None
    mfu = tiny.metric("als_mfu_pct").read(_run([job], {}, window_s=2.0))
    assert mfu == pytest.approx(100 * work["als_flops"] / (2.0 * 67e12))


def test_trace_reduction_by_hand():
    events = [("Memcpy HtoD (Pageable -> Device)", 100.0, 101.0), ("mttkrp_tc_kernel", 102.0, 110.0),
              ("apply_kernel", 105.0, 112.0), ("sm90_xmma_gemm_f32", 150.0, 160.0), ("reduce_splits", 400.0, 401.0)]
    fams = {"mttkrp": ["mttkrp_kernel", "mttkrp_tc_kernel", "reduce_splits", "gemm"], "epilogue": ["apply_kernel"]}
    spans = [("engine (cp_cals)", 0.0, 200.0), ("rescale and LSAP", 200.0, 500.0)]
    t = trace.read(events, 1e-3, fams, spans, "Memcpy HtoD", host_start_us=0.0, n_gaps=2)
    assert t.busy_s == pytest.approx((1 + 10 + 10 + 1) / 1e6)
    assert t.family_s["mttkrp"] == pytest.approx((8 + 10 + 1) / 1e6)
    assert t.family_s["epilogue"] == pytest.approx(7e-6)
    assert [g[1] for g in t.idle_gaps] == [pytest.approx(240e-6), pytest.approx(38e-6)]
    assert t.idle_gaps[0][0].startswith("engine (cp_cals) | before reduce_splits")
    assert trace.union([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert math.isclose(trace.read([], 1.0, fams).busy_s, 0.0)


def test_a_kernel_that_two_families_name_stops_the_reading():
    fams = {"mttkrp": ["mttkrp_kernel", "gemm"], "wide": ["xmma_gemm"]}
    assert trace.family_of("mttkrp_kernel<64>", fams) == "mttkrp"
    assert trace.family_of("apply_kernel", fams) is None
    with pytest.raises(ValueError, match="sm90_xmma_gemm"):
        trace.read([("sm90_xmma_gemm_f32", 0.0, 1.0)], 1e-3, fams)
