"""Run a JAX gate and its port twin side by side, as children, and load
their reports (the tests/test_torch_gate_*.py helper).

The JAX gate runs with `JAX_PLATFORMS=cpu`; the twin with `--device cpu`
and one torch intra-op thread (the plain versions run thousands of small
ops). Both start at once, so a test takes the longer of the two.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _start(argv: list, env: dict, log: Path) -> subprocess.Popen:
    return subprocess.Popen(argv, cwd=REPO, env=env, stdout=log.open("w"),
                            stderr=subprocess.STDOUT)


def run_pair(jax_argv: list, twin_argv: list, jax_out: Path, twin_out: Path,
             timeout: float = 240) -> tuple[dict, dict]:
    """Start `python <jax_argv>` and `python <twin_argv> --device cpu`
    (each writing its report where its argv says), wait for both, and
    return (JAX report, twin report). A child that fails fails the test
    with its output."""
    base = dict(os.environ, PYTHONPATH=str(REPO))
    jenv = dict(base, JAX_PLATFORMS="cpu")
    tenv = dict(base, OMP_NUM_THREADS="1")
    tenv.pop("XLA_FLAGS", None)
    logs = (twin_out.with_suffix(".jax.log"), twin_out.with_suffix(".twin.log"))
    procs = (_start([sys.executable, *jax_argv], jenv, logs[0]),
             _start([sys.executable, *twin_argv, "--device", "cpu"], tenv, logs[1]))
    try:
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for code, log, what in zip(codes, logs, ("JAX gate", "twin")):
        assert code == 0, f"{what} exited {code}:\n{log.read_text()[-4000:]}"
    return json.loads(jax_out.read_text()), json.loads(twin_out.read_text())
