"""The comparison, driven through a whole rehearsed run on the CPU: a clean
run is correct, and a run whose timed path is broken underneath is not."""

import pytest

from benchmark import harness, rehearse

CELLS = [cell["name"] for cell in harness.load_spec()["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_clean_run_is_correct(workload):
    out = rehearse.rehearse(workload, 11, 1.0)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("control", ["alter", "half"])
@pytest.mark.parametrize("workload", CELLS)
def test_broken_output_is_not_correct(workload, control):
    out = rehearse.rehearse(workload, 12, 1.0, control=control)
    assert not out["correct"], out["compared"]
