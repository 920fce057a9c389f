"""tools/torch_fleet_soak.py against tools/fleet_soak.py on the CPU.

Each gate starts three sidecar processes of its own package, restarts one
and runs them with the lock witness armed, so the pair runs one after the
other: six sidecars never run at once. Both use the same seed, ring,
gossip timing (250 ms, R=2), load, SIGKILL and manifest-write stall.
Their reports must agree on every leaf but the gossip clocks:

- `kill/convergence_periods`, `kill/convergence_wall_s` and
  `rejoin/convergence_periods` are each member's own period counts and a
  wall time; they are held on the twin to the gate's bound (3 + 3 + 8
  periods);
- `witness/<member>/race_sites_observed` lists which shared attributes
  the witness sampled, and whether a member skipped a probe
  (`gossip.GossipAgent.probe_skips`) depends on where the 250 ms periods
  fall against the kill. It is held to the sites the load forces on every
  member (gossip probes and acks); the violations are held equal (none).
"""

from __future__ import annotations

from tests.torch_gates import leaves, run_pair

CLOCKS = ("kill/convergence_periods/", "kill/convergence_wall_s",
          "rejoin/convergence_periods/")


def _held(report: dict) -> dict:
    return {path: v for path, v in leaves(report).items()
            if path != "device" and not path.startswith(CLOCKS)
            and "/race_sites_observed/" not in path}


def test_fleet_soak_twin_matches_the_jax_gate(tmp_path):
    jax_out, twin_out = tmp_path / "jax.json", tmp_path / "twin.json"
    jax, twin = run_pair(
        ["tools/fleet_soak.py", "--out", str(jax_out)],
        ["tools/torch_fleet_soak.py", "--out", str(twin_out)],
        jax_out, twin_out, sequential=True,
    )
    assert _held(jax) == _held(twin)
    assert len(_held(twin)) == 44
    bound = twin["gossip"]["convergence_bound_periods"]
    assert bound == 3 + 3 + 8
    for phase in ("kill", "rejoin"):
        periods = twin[phase]["convergence_periods"]
        assert periods and all(0 <= p <= bound for p in periods.values())
    assert twin["byte_diffs"] == 0 and twin["failover"]["failover_hits"] > 0
    assert twin["lifecycle_drill"]["orphans_after_restart_sweep"] == []
    assert twin["lifecycle_drill"]["listing_equals_manifest_reachable"] is True
    for member, w in twin["witness"].items():
        assert w["enabled"] and w["lock_violations"] == w["race_violations"] == []
        assert {"gossip.GossipAgent.probes_sent", "gossip.GossipAgent.acks"} <= set(
            w["race_sites_observed"]), member
