"""tools/torch_multichip_demo.py against tools/multichip_demo.py on the CPU.

The JAX gate runs its drill on 8 virtual CPU devices (its own pin sets
`XLA_FLAGS`); the twin on 8 virtual CPU members through the port's pin.
Their reports must agree on the failed checks (none), the mesh shape, the
window shapes and the per-window dispatch accounting.
"""

from __future__ import annotations

from tests.torch_gates import run_pair


def _shape(report: dict) -> dict:
    keys = ("rows", "mesh_size", "rows_per_device", "dispatches_per_window", "pad_rows")
    return {section: {k: report[section].get(k) for k in keys}
            for section in ("fixed", "varlen")}


def test_multichip_twin_matches_the_jax_gate(tmp_path):
    jax_out, twin_out = tmp_path / "jax.json", tmp_path / "twin.json"
    jax, twin = run_pair(
        ["tools/multichip_demo.py", "--out", str(jax_out)],
        ["tools/torch_multichip_demo.py", "--out", str(twin_out)],
        jax_out, twin_out,
    )
    assert jax["failed_checks"] == twin["failed_checks"] == []
    assert jax["mesh_shape"] == twin["mesh_shape"] == {"data": 8}
    assert jax["n_devices"] == twin["n_devices"] == 8
    assert _shape(jax) == _shape(twin)
    assert {k for k in jax["fixed"]["checks"]} == {k for k in twin["fixed"]["checks"]}
