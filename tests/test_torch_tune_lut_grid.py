"""The port's grid tuner (``cp_cals_tpu_torch/profiles/tune_lut_grid.py``)
against the JAX repo's ``scripts/tune_lut_grid.py``, on the CPU.

The program list is the script's enumeration: a JAX queue of
``RandomKtensorSpec`` through JAX's ``_bucket_demands`` and
``allocate_bucket_batches``, each allocation with the script's halving
ladder (its ``main`` times the TPU table, so the enumeration is restated
here line for line). A ``--device cpu`` run on a small tensor into an empty
root fills every entry and then finds every lookup exact.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from cp_cals_tpu.config import CalsParams as JaxCalsParams
from cp_cals_tpu.ktensor import RandomKtensorSpec
from cp_cals_tpu.solvers.cals import _bucket_demands, allocate_bucket_batches
from cp_cals_tpu_torch.profiles import tune_lut_grid as tg
from cp_cals_tpu_torch.utils import lut

ROOT = Path(__file__).resolve().parent.parent
MODES = (6, 5, 4)


def jax_programs(modes, ranks: str, buckets: str, buffer: int, tail_depth: int) -> list:
    """``scripts/tune_lut_grid.py:main``'s job list."""
    lo, hi, copies = (int(v) for v in ranks.split(":"))
    queue = [RandomKtensorSpec(modes, r, seed=1000 * r + c, dtype="float32")
             for r in range(lo, hi + 1) for c in range(copies)]
    params = JaxCalsParams(buffer_size=buffer, bucket_ranks=tuple(int(r) for r in buckets.split(",")))
    waves = allocate_bucket_batches(_bucket_demands(queue, params), params.buffer_size)
    jobs = set()
    for wave in waves:
        for r, b in wave.items():
            bb = b
            jobs.add((r, bb))
            for _ in range(tail_depth):
                if bb <= 1:
                    break
                bb //= 2
                jobs.add((r, bb))
    return sorted(jobs)


QUEUES = [
    ("1:20:20", "4,8,16,20", 5760, 2),  # the script's defaults
    ("1:20:20", "4,8,12,16,20", 2880, 2),  # the bench workload
    ("1:20:250", "4,8,16,20", 3840, 2),  # the 500^3 sweep's queue
    ("1:12:30", "2,4,8,12", 30, 3),  # the stress budget: several waves
    ("3:9:1", "5", 18, 0),  # one bucket, no ladder
]


@pytest.mark.parametrize("ranks,buckets,buffer,depth", QUEUES)
def test_programs_equal_the_scripts_enumeration(ranks, buckets, buffer, depth):
    got = tg.programs(ranks, tuple(int(r) for r in buckets.split(",")), buffer, depth)
    assert got == jax_programs((299, 301, 41), ranks, buckets, buffer, depth)
    engine = {(r, b) for wave in tg.allocations(ranks, tuple(int(r) for r in buckets.split(",")), buffer)
              for r, b in wave.items()}
    assert engine <= set(got)


def test_defaults_are_the_scripts():
    args = tg.parser().parse_args([])
    assert (args.tensor, args.ranks, args.buckets, args.buffer, args.precision, args.tail_depth, args.reps) == (
        "299-301-41", "1:20:20", "4,8,16,20", 5760, "default", 2, 3)
    assert args.device == "cuda" and args.tables == lut._ROOT


@pytest.mark.parametrize("tier", ["default", "high"])
def test_cpu_run_fills_every_entry(tmp_path, monkeypatch, tier):
    """Into an empty root: every lookup falls to the heuristic before, every
    entry is autotuned and stored, every lookup is exact after; the file has
    the committed file's keys; the committed root is left as it was."""
    committed_root = lut._ROOT
    tables = tmp_path / "tables"
    args = tg.parser().parse_args(["-t", "-".join(map(str, MODES)), "--reps", "1", "--tables", str(tables),
                                   "--device", "cpu", "--out", str(tmp_path), "--precision", tier])
    res = tg.run(args)
    assert lut._ROOT == committed_root
    jobs = jax_programs(MODES, "1:20:20", "4,8,16,20", 5760, 2)
    n = len(MODES) * len(jobs)
    assert sorted(res["programs"]) == sorted(f"{b}x{r}" for r, b in jobs)
    assert res["lookup_stats_before"] == {"exact": 0, "nearest": 0, "heuristic": n}
    assert res["lookup_stats_after"] == {"exact": n, "nearest": 0, "heuristic": 0}
    table = json.loads((tables / "cpu-cpu" / "6-5-4.json").read_text())
    for r, b in jobs:
        for mode in range(len(MODES)):
            assert table[lut._key(b, r, mode, tier)] == res["programs"][f"{b}x{r}"][mode]
    assert len(table) == n
    on_disk = json.loads((tmp_path / f"lut_grid_6-5-4_{tier}.json").read_text())
    committed = json.loads((ROOT / "data" / "benchmarks" / "lut_grid_299-301-41_default.json").read_text())
    assert set(committed) <= set(on_disk) and on_disk["device"] == "cpu" and on_disk["card"] == "cpu"
    assert set(on_disk["seconds"]) == set(on_disk["programs"])
    assert set(on_disk["engine_programs"]) <= set(on_disk["programs"])

    # A second run tunes nothing: every entry is present.
    monkeypatch.setattr(lut, "autotune", lambda *a, **k: pytest.fail("an entry was measured again"))
    again = tg.run(args)
    assert again["lookup_stats_before"] == again["lookup_stats_after"] == res["lookup_stats_after"]
    assert again["programs"] == res["programs"]


def test_an_existing_entry_is_not_measured_again(tmp_path, monkeypatch):
    """Only the (B, R, tier) the table lacks are tuned: a present entry,
    even one another tuner would not pick, stays as it is."""
    monkeypatch.setattr(lut, "_ROOT", str(tmp_path))
    lut._store(MODES, {lut._key(24, 4, m, "default"): "krp_gemm" for m in range(3)}, "cpu")
    tuned = []
    real = lut.autotune

    def counted(modes, rank, batch, **kw):
        tuned.append((rank, batch))
        return real(modes, rank, batch, **kw)

    monkeypatch.setattr(lut, "autotune", counted)
    args = tg.parser().parse_args(["-t", "6-5-4", "--reps", "1", "--device", "cpu", "--out", str(tmp_path)])
    res = tg.run(args)
    assert res["programs"]["24x4"] == ["krp_gemm"] * 3
    assert (4, 24) not in tuned and len(tuned) == len(res["programs"]) - 1
    assert res["lookup_stats_before"]["exact"] == 3
