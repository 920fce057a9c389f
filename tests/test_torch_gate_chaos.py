"""tools/torch_chaos_matrix.py against tools/chaos_matrix.py on the CPU.

Both matrices run their 23 cells at seed 1234. Per cell, their reports
must agree on the site, kind and rule, the fault plane's calls, fired
rules and injections, the corruptions, the ok/total op counts and every
gate's verdict; and on the determinism and disarmed self-checks. Timings
(shed walls, ledger deltas' seconds, SLO burn rates) are exempt.
"""

from __future__ import annotations

from tests.torch_gates import run_pair


def _cells(report: dict) -> list:
    return [
        (c["site"], c["kind"], c["rule"], c["ok"], c["gates"],
         c["evidence"]["plane"], c["evidence"]["corruptions"], c["evidence"]["ops"])
        for c in report["cells"]
    ]


def test_chaos_twin_matches_the_jax_gate(tmp_path):
    jax_out, twin_out = tmp_path / "jax.json", tmp_path / "twin.json"
    jax, twin = run_pair(
        ["tools/chaos_matrix.py", "--seed", "1234", "--out", str(jax_out)],
        ["tools/torch_chaos_matrix.py", "--seed", "1234", "--out", str(twin_out)],
        jax_out, twin_out,
    )
    assert len(twin["cells"]) == 23
    assert _cells(jax) == _cells(twin)
    for key in ("seed", "determinism", "disarmed", "ok"):
        assert jax[key] == twin[key]
    assert twin["ok"] and twin["device"] == "cpu"
