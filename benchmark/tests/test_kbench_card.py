"""One short run of each cell on the card (marker `cuda`): the command the
benchmark's checks run, its result line and its comparison."""

import json
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["gcm.tiering", "zstd-gcm.tiering"])
def test_short_run_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card only")
    res = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload", workload,
         "--seed", str(2**31 + 99), "--seconds", "5", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=harness.ROOT)
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "compared"


def test_run_refuses_without_a_card_or_with_an_unknown_cell():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the refusal path, which needs a machine without a card")
    for workload in ("gcm.tiering", "no-such-cell"):
        res = subprocess.run(
            [sys.executable, str(harness.HERE / "run.py"), "--workload", workload,
             "--seed", "1", "--seconds", "1"], capture_output=True, text=True, timeout=300,
            cwd=harness.ROOT)
        assert res.returncode == 3 and not res.stdout.strip()
