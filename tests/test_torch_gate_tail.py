"""tools/torch_tail_demo.py against tools/tail_demo.py on the CPU.

Both gates run the same seeded tail (`fetch:delay=120..200@every=4`, seed
20260804), a 20 ms hedge and admission at 1 + 0 over an in-memory store.
Their reports must agree on every field the workload fixes: the schedule,
the hedge settings, the hedger's primaries, the shed evidence, the
deadline's status and exception, the phases' fetch counts and the zero
correctness diffs. The timed fields (latencies, percentiles, the
deadline's elapsed ms) and the hedges that fired (an unstalled fetch on a
loaded host can outlast the 20 ms delay) are held on the twin by itself
to the JAX gate's own checks.
"""

from __future__ import annotations

from tests.torch_gates import run_pair

EQUAL = ("schedule", "hedge", "shed", "correctness_diffs")


def test_tail_twin_matches_the_jax_gate(tmp_path):
    jax_out, twin_out = tmp_path / "jax.json", tmp_path / "twin.json"
    jax, twin = run_pair(
        ["tools/tail_demo.py", "--out", str(jax_out)],
        ["tools/torch_tail_demo.py", "--out", str(twin_out)],
        jax_out, twin_out,
    )
    assert {k: jax[k] for k in EQUAL} == {k: twin[k] for k in EQUAL}
    assert jax["hedger"]["primaries"] == twin["hedger"]["primaries"]
    for name in ("status", "exception"):
        assert jax["deadline"][name] == twin["deadline"][name]
    for phase in ("unhedged", "hedged"):
        assert jax["phases"][phase]["count"] == twin["phases"][phase]["count"] == 12
    # The JAX gate's timed checks, on the twin.
    assert twin["correctness_diffs"] == 0
    assert twin["hedger"]["launched"] > 0 and twin["hedger"]["wins"] > 0
    assert twin["phases"]["hedged"]["p99_ms"] < twin["phases"]["unhedged"]["p99_ms"]
    assert (twin["shed"]["status"], twin["shed"]["retry_after"]) == (429, "2")
    assert twin["shed"]["served_after_release"] and twin["shed"]["shed_total"] >= 1
    assert twin["deadline"]["status"] == 504
    assert twin["deadline"]["elapsed_ms"] < 1000.0
