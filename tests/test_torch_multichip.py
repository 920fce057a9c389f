"""The port's multi-device drill (parallel/multichip.py) against the JAX
package's, at small shapes.

The JAX drill runs on the conftest's 8-device virtual CPU mesh; the port's on
8 virtual CPU members, pinned by a fixture that restores the unpinned state.
Both draw the same seeded rows (numpy, seed 42), so everything in the report
that does not depend on the random data key must match.
"""

from __future__ import annotations

import numpy as np
import pytest

from tieredstorage_tpu.parallel import mesh as jax_mesh
from tieredstorage_tpu.parallel import multichip as jax_multichip
from tieredstorage_tpu_torch.parallel import mesh, multichip
from tieredstorage_tpu_torch.utils import platforms

N = 8


@pytest.fixture
def pinned():
    platforms.unpin()
    platforms.pin_virtual_cpu(N)
    yield
    platforms.unpin()


def _shape(report: dict) -> dict:
    """Everything of a report but the figures that depend on the data key."""
    out = {k: report[k] for k in ("n_devices", "mesh_shape", "chunk_bytes", "ok",
                                  "failed_checks")}
    for part in ("fixed", "varlen"):
        out[part] = {k: v for k, v in report[part].items() if k != "index_collective"}
        out[part]["index_collective"] = report[part]["index_collective"]
    out["host_oracle_skipped"] = "host_oracle_skipped" in report
    return out


@pytest.mark.parametrize("chunk_bytes,window", [(4096, 16), (1000, 11)])
def test_drill_report_equals_jax(pinned, chunk_bytes, window):
    port = multichip.run_drill(N, chunk_bytes=chunk_bytes, window=window)
    jax = jax_multichip.run_drill(N, chunk_bytes=chunk_bytes, window=window)
    assert port["ok"], port["failed_checks"]
    assert _shape(port) == _shape(jax)
    assert sorted(port["fixed"]["checks"]) == sorted(jax["fixed"]["checks"])
    assert multichip.summary_line(port) == jax_multichip.summary_line(jax)
    assert port["varlen"]["pad_rows"] > 0 and port["fixed"]["rows_per_device"] == \
        port["fixed"]["rows"] // N


def test_index_collective_matches_host_sizes_as_jax(pinned):
    sizes = list(np.random.default_rng(5).integers(1, 5000, 13))
    port = multichip._index_collective(mesh.MeshPlan.from_spec(N), sizes)
    jax = jax_multichip._index_collective(jax_mesh.MeshPlan.from_spec(N), sizes)
    assert port == jax and port["ok"] and port["total_bytes"] == sum(int(s) for s in sizes)


def test_drill_on_an_explicit_plan_of_repeated_members(pinned):
    report = multichip.run_drill(
        2, chunk_bytes=2048, window=8, plan=mesh.MeshPlan.wrap(["cpu", "cpu"]))
    assert report["ok"] and report["mesh_shape"] == {mesh.DATA_AXIS: 2}


def test_drill_refuses_a_plan_of_another_size(pinned):
    with pytest.raises(RuntimeError, match="mesh plan resolved to 4 devices, wanted 2"):
        multichip.run_drill(2, chunk_bytes=2048, window=8, plan=mesh.MeshPlan.from_spec(4))
    platforms.unpin()
    with pytest.raises(RuntimeError, match="mesh plan resolved to 1 devices, wanted 8"):
        multichip.run_drill(N, chunk_bytes=2048, window=8, plan=mesh.MeshPlan(None))
