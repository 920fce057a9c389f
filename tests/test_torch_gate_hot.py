"""tools/torch_hot_demo.py against tools/hot_demo.py on the CPU.

Both gates run the same seeded store (64 chunks of 64 KiB), the same
Zipfian replay (seed 7) and the same budget drill. Their reports must
agree on every deterministic field: hits, misses and requests of the
replay, resident windows, zero-copy serves, the budget drill's counts and
every check. The JAX gate's `is_deleted()` donation probe has the twin's
storage-identity probe as its counterpart under the same check name
(`retained_buffers_never_donated`); throughputs are exempt.
"""

from __future__ import annotations

from tests.torch_gates import run_pair

FIELDS = ("replay_requests", "replay_hits", "replay_misses", "resident_windows",
          "zero_copy_serves", "hot_hit_rate", "budget_pressure", "checks", "ok")


def test_hot_twin_matches_the_jax_gate(tmp_path):
    jax_out, twin_out = tmp_path / "jax.json", tmp_path / "twin.json"
    jax, twin = run_pair(
        ["tools/hot_demo.py", "--out", str(jax_out)],
        ["tools/torch_hot_demo.py", "--out", str(twin_out)],
        jax_out, twin_out,
    )
    assert jax["ok"] and twin["ok"], (jax["checks"], twin["checks"])
    assert {k: jax[k] for k in FIELDS} == {k: twin[k] for k in FIELDS}
    assert twin["replay_hits"] == twin["replay_requests"] == 200
