"""Run a JAX gate and its port twin side by side, as children, and load
their reports (the tests/test_torch_gate_*.py helper).

The JAX gate runs with `JAX_PLATFORMS=cpu` and one XLA CPU thread; the
twin with `--device cpu`. Both children get one intra-op thread (the plain
versions run thousands of small ops, and the suite runs several workers at
once, each starting a pair). They start at once, so a test takes the
longer of the two, unless `sequential` runs them one after the other (for
pairs that start processes of their own).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

#: Appended to the JAX child's XLA_FLAGS: one Eigen thread and one
#: intra-op thread on XLA's CPU backend.
XLA_ONE_THREAD = "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"


def _start(argv: list, env: dict, log: Path) -> subprocess.Popen:
    return subprocess.Popen(argv, cwd=REPO, env=env, stdout=log.open("w"),
                            stderr=subprocess.STDOUT)


def _wait(procs: tuple, timeout: float) -> list:
    try:
        return [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def run_pair(jax_argv: list, twin_argv: list, jax_out: Path, twin_out: Path,
             timeout: float = 240, env: dict | None = None,
             sequential: bool = False) -> tuple[dict, dict]:
    """Start `python <jax_argv>` and `python <twin_argv> --device cpu`
    (each writing its report where its argv says, with `env` added to
    both), wait for both, and return (JAX report, twin report). With
    `sequential` the twin starts when the JAX gate has ended, each within
    `timeout`. A child that fails fails the test with its output."""
    base = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **(env or {}))
    jenv = dict(base, JAX_PLATFORMS="cpu",
                XLA_FLAGS=f"{base.get('XLA_FLAGS', '')} {XLA_ONE_THREAD}".strip())
    tenv = dict(base)
    tenv.pop("XLA_FLAGS", None)
    logs = (twin_out.with_suffix(".jax.log"), twin_out.with_suffix(".twin.log"))
    starts = ((lambda: _start([sys.executable, *jax_argv], jenv, logs[0])),
              (lambda: _start([sys.executable, *twin_argv, "--device", "cpu"], tenv, logs[1])))
    if sequential:
        codes = [_wait((start(),), timeout)[0] for start in starts]
    else:
        codes = _wait(tuple(start() for start in starts), timeout)
    for code, log, what in zip(codes, logs, ("JAX gate", "twin")):
        assert code == 0, f"{what} exited {code}:\n{log.read_text()[-4000:]}"
    return json.loads(jax_out.read_text()), json.loads(twin_out.read_text())


def leaves(report, prefix: str = "") -> dict:
    """Every leaf of a JSON report by its path ("a/b/0"), lists indexed."""
    if isinstance(report, dict):
        items = report.items()
    elif isinstance(report, list):
        items = enumerate(report)
    else:
        return {prefix: report}
    out: dict = {}
    for key, value in items:
        out.update(leaves(value, f"{prefix}/{key}" if prefix else str(key)))
    return out
