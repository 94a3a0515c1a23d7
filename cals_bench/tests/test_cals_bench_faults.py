"""The check against a broken program: a run drives everything but the
look for a card, with the timed path broken underneath, and ``correct``
comes out false for each fault a cell can have. (The exchange between
chips cannot be left out: every cell runs on one chip.) The precision
control, the test's other half, comes out not correct too."""

import pytest

from cals_bench import control, faults, runner


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", ["tiny.select", "tiny.f32", "tiny.jk"])
def test_a_broken_program_is_not_correct(tiny, monkeypatch, cell, fault):
    faults.FAULTS[fault](monkeypatch.setattr)
    out = runner.run(cell, 2**31 + 5, 0.2, False, "cpu", registry=tiny, log=lambda m: None)
    assert not out["result"]["correct"], out["result"]["checks"]


@pytest.mark.parametrize("cell", ["tiny.select", "tiny.f32", "tiny.jk"])
def test_the_precision_control_and_the_faults_are_not_correct(tiny, cell):
    """The control (the program's lower-precision path, or the reference
    with TF32 operands) read at this size on two seeds, and each fault
    planted on one, judged by the cell's limits as a run judges: each
    reads not correct, the program on its own seeds correct, and the
    control fails by three times the program's reading on some number."""
    lines = []
    got = control.main(["--workload", cell, "--seeds", "21,22", "--control-seeds", "21,22",
                        "--faults", ",".join(faults.FAULTS), "--fault-seeds", "23", "--device", "cpu"],
                       registry=tiny, out=lines.append)
    assert got["correct"]["program"] == [True, True] and got["correct"]["control"] == [False, False]
    assert all(got["correct"][f"fault:{f}"] == [False] for f in faults.FAULTS) and got["sound"]
    limits = {k: v["limit"] for k, v in tiny.limits(cell).items()}
    compared = {k: s for k, s in got["summary"].items() if k in limits}
    assert any(s["upper"] > limits[k] and s["upper"] >= 3 * s["lower"] for k, s in compared.items())
    assert len(lines) == 2 + 2 + len(faults.FAULTS) + 1
