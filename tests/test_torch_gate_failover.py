"""tools/torch_failover_demo.py against tools/failover_demo.py on the CPU.

Both gates run the same schedule (`upload:raise@from=13;
fetch:raise@from=6`), seed and deadline budget over two in-memory
replicas. Their reports must agree on every deterministic field: fetches,
failed fetches, payload mismatches, failovers, quorum failures, orphans on
the surviving replica, and both anti-entropy passes (their timings
exempt).
"""

from __future__ import annotations

from tests.torch_gates import run_pair

FIELDS = ("schedule", "deadline_budget_ms", "segments", "fetches", "failed_fetches",
          "payload_mismatches", "failovers", "failover_trace_events", "quorum_failures",
          "surviving_replica_orphans", "replicas_byte_identical")
TIMED = ("started_at", "duration_s")


def test_failover_twin_matches_the_jax_gate(tmp_path):
    jax_out, twin_out = tmp_path / "jax.json", tmp_path / "twin.json"
    jax, twin = run_pair(
        ["tools/failover_demo.py", "--out", str(jax_out)],
        ["tools/torch_failover_demo.py", "--out", str(twin_out)],
        jax_out, twin_out,
    )
    assert {k: jax[k] for k in FIELDS} == {k: twin[k] for k in FIELDS}
    for name in ("antientropy_pass1", "antientropy_pass2"):
        strip = lambda d: {k: v for k, v in d.items() if k not in TIMED}  # noqa: E731
        assert strip(jax[name]) == strip(twin[name])
    assert twin["failed_fetches"] == twin["payload_mismatches"] == 0
    assert twin["failovers"] >= 1 and twin["quorum_failures"] >= 1
    assert twin["antientropy_pass2"]["in_sync"] is True
    assert twin["failover_p99_ms"] < twin["deadline_budget_ms"]
