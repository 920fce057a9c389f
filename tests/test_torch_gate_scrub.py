"""tools/torch_scrub_demo.py against tools/scrub_demo.py on the CPU.

Both gates upload three `tpu-huff-v1` segments with per-chunk CRC32C to a
filesystem store, play the seeded damage (`fetch:corrupt=6000@2;
fetch:truncate=1500@3; delete:raise@1` plus an orphan) and scrub twice.
Their reports must agree on every leaf but the pass clocks (`started_at`,
`duration_s`, `next_pass_in_s`): the injected ground truth, every finding
with its chunk id and detail, the repairs, the chunks and bytes verified,
and the gateway's `GET /scrub` status.
"""

from __future__ import annotations

from tests.torch_gates import leaves, run_pair

TIMED = ("started_at", "duration_s", "next_pass_in_s")


def _deterministic(report: dict) -> dict:
    return {path: v for path, v in leaves(report).items()
            if path != "device" and path.rsplit("/", 1)[-1] not in TIMED}


def test_scrub_twin_matches_the_jax_gate(tmp_path):
    jax_out, twin_out = tmp_path / "jax.json", tmp_path / "twin.json"
    jax, twin = run_pair(
        ["tools/scrub_demo.py", "--out", str(jax_out)],
        ["tools/torch_scrub_demo.py", "--out", str(twin_out)],
        jax_out, twin_out,
    )
    assert _deterministic(jax) == _deterministic(twin)
    assert len(_deterministic(twin)) >= 77
    pass1 = twin["pass1"]
    assert (len(twin["injected"]), len(pass1["findings"]), pass1["repaired"]) == (4, 4, 4)
    assert (pass1["chunks_verified"], pass1["bytes_scanned"]) == (24, 56_036)
    assert twin["baseline"]["clean"] and twin["pass2"]["clean"]
    assert twin["gateway_status"]["passes"] == 3
