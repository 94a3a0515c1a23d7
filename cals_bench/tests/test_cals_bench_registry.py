"""Every piece of the benchmark is found by name, and a new one is found
as files of its own, with no file edited."""

import json
import shutil

import pytest
from conftest import BENCH, LIMITS, REPO, make_tiny

from cals_bench import runner
from cals_bench.registry import Registry


def test_every_named_piece_loads():
    reg = Registry()
    spec = reg.benchmark
    assert [w["name"] for w in spec["workloads"]] == ["fluor.jk299", "cube300.select50", "fluor.select50"]
    for w in spec["workloads"]:
        assert w["chips"] == 1
        cfg, traffic = reg.config(w["config"]), reg.traffic(w["traffic"])
        assert {"source", "assumed", "reduced", "modes", "dtype"} <= set(cfg)
        assert traffic["job"] in ("select", "jackknife")
        limits = reg.limits(w["name"])
        assert limits and all("limit" in v and "lower" in v and "upper" in v for v in limits.values())
    for c in spec["configs"]:
        assert (REPO / c["file"]).is_file() and reg.config(c["name"])["reduced"] == c["reduced"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(reg.metric(m["name"]).read)
    assert set(reg.kernel_families()) == {"mttkrp"}
    with pytest.raises(KeyError):
        reg.traffic("no_such_mix")


def test_metrics_of_follows_the_workloads_lists():
    reg = Registry()
    e2e = {m["name"] for m in reg.metrics_of("cube300.select50", "end_to_end")}
    assert e2e == {"models_per_s.highest", "setup_s"}
    layers = {m["name"] for m in reg.metrics_of("fluor.jk299", "per_layer")}
    assert "jk_host_pct" in layers and len(layers) == 6
    for w in reg.benchmark["workloads"]:
        reported = {m["name"] for m in reg.metrics_of(w["name"], "end_to_end")}
        layers = reg.metrics_of(w["name"], "per_layer")
        assert len(layers) >= 5 and all(m["moves"] in reported for m in layers)
    split = reg.metric("device_idle_pct.highest")
    assert split is reg.metric("device_idle_pct.highest") and split.read is not None
    with pytest.raises(KeyError):
        reg.metric("no_such_metric.highest")


def test_a_new_cell_is_files_of_its_own(tmp_path):
    """A configuration, a traffic mix, a metric, a kernel family and a
    cell's limits added as new files (and the cell and metric as entries)
    are found and run, and no file that was there changes."""
    bench = make_tiny(tmp_path)
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "configs" / "wide.json").write_text(json.dumps(
        {"source": "test", "modes": [10, 9, 8], "dtype": "float32", "true_rank": 2, "noise": 0.05,
         "assumed": [], "reduced": []}))
    shutil.copy(bench / "traffic" / "tiny_select.json", bench / "traffic" / "select_new.json")
    (bench / "metrics" / "jobs_done.py").write_text("def read(run):\n    return float(len(run.jobs))\n")
    (bench / "kernels" / "copies.json").write_text(json.dumps({"patterns": ["Memcpy"]}))
    (bench / "limits" / "wide.select.json").write_text((bench / "limits" / "tiny.select.json").read_text())
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append(dict(name="wide.select", config="wide", traffic="select_new", chips=1, why="t"))
    spec["end_to_end"].append(dict(name="jobs_done", unit="jobs", better="higher", bound=0.01,
                                   source="host_clock", workloads=["wide.select"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    reg = Registry(tmp_path, bench)
    assert "copies" in reg.kernel_families()
    out = runner.run("wide.select", 5, 0.2, False, "cpu", registry=reg, log=lambda m: None)
    assert out["result"]["metrics"]["jobs_done"]["value"] == out["result"]["attempted"] / 8
    assert set(out["result"]["checks"]) == set(LIMITS["tiny.select"])
    after = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
    assert not (BENCH / "configs" / "wide.json").exists()
