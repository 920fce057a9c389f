"""tools/torch_fleet_demo.py against tools/fleet_demo.py on the CPU, both
under `TSTPU_LOCK_WITNESS=1` (as the JAX gate's CI target runs it).

Both gates run three in-process gateways over one store (64 vnodes), a
24-client burst, 240 Zipfian requests with g0 killed at request 120, and
a greedy and a polite tenant. Their reports must agree on every leaf
(ring owners and ownership, kill schedule, zipf counts and rates, fair
share, byte diffs, the lock witness's edges and the race witness's
observed and validated sites) but two:

- the burst's split between leaders and joiners. Its one backend read is
  held equal; how many of the other 23 requests joined the in-flight load
  rather than reading the loaded chunk after it is where threads land
  (the JAX gate says so), 21 in most runs of either package. Both are
  held to the gate's own check (> 0) and to at most the 24 clients less
  their leaders. Each non-owner's leader forwards to the owner, and that
  forward can itself join the owner's in-flight load or lead it. The
  twin's report counts what its forwarded serves did
  (`forward_inflight_joins`, `forward_loads`, 2 and 0 in most runs), so
  its client joins and client leaders are held exactly. The JAX report
  counts the forwards with the clients (22 joins in some runs, 19-21 in
  most), so it is held to 24 less its leaders plus its at most
  leaders - 1 forwards;
- the race witness's unobserved guards of the transform backend, which
  are each package's own (`tpu.TpuTransformBackend` against
  `cuda.CudaTransformBackend` and `cuda._StagingPool`). Every other
  unobserved guard is held equal.
"""

from __future__ import annotations

from tests.torch_gates import leaves, run_pair

SPLIT = ("burst/singleflight_coalesced", "burst/cache_inflight_joins",
         "burst/coalesced_fetches", "burst/coalescing_ratio",
         "burst/forward_inflight_joins", "burst/forward_loads")


def _backend_guard(guard: str) -> bool:
    return guard.startswith(("tpu.", "cuda."))


def _held(report: dict) -> dict:
    out = {path: v for path, v in leaves(report).items()
           if path != "device" and path not in SPLIT
           and not path.startswith("race_witness/unobserved_guards/")}
    out["unobserved_guards"] = sorted(
        g for g in report["race_witness"]["unobserved_guards"] if not _backend_guard(g))
    return out


def test_fleet_twin_matches_the_jax_gate(tmp_path):
    jax_out, twin_out = tmp_path / "jax.json", tmp_path / "twin.json"
    jax, twin = run_pair(
        ["tools/fleet_demo.py", "--out", str(jax_out)],
        ["tools/torch_fleet_demo.py", "--out", str(twin_out)],
        jax_out, twin_out, env={"TSTPU_LOCK_WITNESS": "1"},
    )
    assert _held(jax) == _held(twin)
    for report in (jax, twin):
        burst = report["burst"]
        assert burst["hot_chunk_backend_fetches"] == 1
        # Client joins and client leaders: the twin's less its forwarded
        # serves' joins and loads; JAX's with its forwards in them.
        counted = "forward_inflight_joins" in burst
        joins = burst["coalesced_fetches"] - burst.get("forward_inflight_joins", 0)
        leaders = burst["singleflight_leaders"] - burst.get("forward_loads", 0)
        forwards = 0 if counted else burst["singleflight_leaders"] - 1
        assert 0 < joins <= burst["clients"] - leaders + forwards
    forwards = twin["burst"]["forward_inflight_joins"] + twin["burst"]["forward_loads"]
    assert forwards <= twin["burst"]["singleflight_leaders"] - 1  # a forward per non-owner leader
    assert (twin["kill"]["victim"], twin["kill"]["at_request"]) == ("g0", 120)
    assert twin["byte_diffs"] == 0 and twin["zipf"]["cache_tier_rate"] >= 0.8
    assert twin["lock_witness"]["enabled"] and twin["lock_witness"]["edges"] > 0
    assert twin["lock_witness"]["violations"] == twin["race_witness"]["violations"] == []
    assert sorted(g for g in twin["race_witness"]["unobserved_guards"] if _backend_guard(g)) == [
        "cuda.CudaTransformBackend._pool (guard cuda.CudaTransformBackend._pool_lock)",
        "cuda.CudaTransformBackend.dispatch_stats (guard cuda.CudaTransformBackend._stats_lock,"
        " lock never acquired)",
        "cuda._StagingPool.allocations (guard cuda._StagingPool._lock, lock never acquired)",
    ]
