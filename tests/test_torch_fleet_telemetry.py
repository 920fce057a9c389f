"""The port's fleet telemetry against the JAX package's, on the same inputs.

Exact equality: ``aggregation_of`` on suffixed names; ``export_samples`` on
registries built alike in each package from one seed (totals, counts,
sampled stats, histograms on the default and a custom ladder, gauges, one
failing gauge, tags, a series duplicated across registries);
``merge_samples`` on the members' samples (sum, max, min, histogram merge
per bound, a foreign ladder, a kind clash); ``FleetTelemetry.scrape`` over
a router with reachable, unreachable and malformed peers and the ping
counters folded in; ``stitch_trace`` on seeded evidence (origin records,
peer serves, ``gcm.batch:<id>`` markers joined to retained flushes) and
``assemble_trace`` through its ``fetch_json`` seam; then the port RSM's
payloads.
"""

from __future__ import annotations

import numpy as np
import pytest

from tieredstorage_tpu.fleet import telemetry as jax_telemetry
from tieredstorage_tpu.fleet.ring import FleetRouter as JaxFleetRouter
from tieredstorage_tpu.metrics import core as jax_core
from tieredstorage_tpu.metrics import timeline as jax_timeline
from tieredstorage_tpu_torch.fleet import telemetry as port_telemetry
from tieredstorage_tpu_torch.fleet.ring import FleetRouter
from tieredstorage_tpu_torch.metrics import core as port_core
from tieredstorage_tpu_torch.metrics import timeline as port_timeline
from tieredstorage_tpu_torch.rsm import RemoteStorageManager

PACKAGES = {
    "jax": (jax_telemetry, jax_core, JaxFleetRouter, jax_timeline),
    "port": (port_telemetry, port_core, FleetRouter, port_timeline),
}


@pytest.mark.parametrize("name", [
    "peer-hits-total", "fleet-forwards-rate", "segment-copy-time-max", "breaker-state",
    "replica-health-min", "anything-else", "x-state-total", "-max", "min", "state"])
def test_aggregation_of_equals_jax(name):
    assert port_telemetry.aggregation_of(name) == jax_telemetry.aggregation_of(name)


def _registries(core, seed: int):
    """Two registries built from `seed`, alike in either package."""
    rng = np.random.default_rng(seed)
    registries = [core.MetricsRegistry(), core.MetricsRegistry()]
    for i in range(12):
        registry = registries[int(rng.integers(0, 2))]
        kind = ["total", "count", "avg", "max", "hist", "hist-custom", "gauge"][i % 7]
        suffix = ["-total", "-max", "-min", "-state", "-ms", ""][int(rng.integers(0, 6))]
        tags = {"replica": f"r{int(rng.integers(0, 3))}"} if rng.random() < 0.3 else {}
        name = core.MetricName.of(f"m{i}{suffix}", f"g{i % 3}", tags=tags)
        values = [float(v) for v in rng.uniform(0, 500, int(rng.integers(1, 9)))]
        if kind == "gauge":
            registry.add_gauge(name, lambda v=values[0]: v)
            continue
        stat = {"total": core.Total, "count": core.Count, "avg": core.Avg,
                "max": core.Max, "hist": core.Histogram,
                "hist-custom": lambda: core.Histogram(buckets=(10.0, 100.0, 250.0))}[kind]()
        for v in values:
            stat.record(v, 1000.0)
        registry.register(name, stat)
    registries[0].add_gauge(core.MetricName.of("broken", "g0"), lambda: 1 / 0)
    dup = core.Total()
    dup.record(99.0, 0.0)
    registries[1].register(core.MetricName.of("m0-total", "g0"), dup)
    return registries


@pytest.mark.parametrize("seed", range(4))
def test_export_samples_equals_jax(seed):
    got = {name: pkg[0].export_samples(_registries(pkg[1], seed))
           for name, pkg in PACKAGES.items()}
    assert got["port"] == got["jax"]
    assert any(s["kind"] == "histogram" for s in got["port"])
    assert got["port"][-1]["name"] == "telemetry-skipped-gauges-total"


@pytest.mark.parametrize("seed", range(4))
def test_merge_samples_equals_jax(seed):
    members = {f"g{m}": port_telemetry.export_samples(_registries(port_core, seed * 10 + m))
               for m in range(3)}
    members["g1"].append({"group": "g0", "name": "m4-ms", "tags": {}, "kind": "histogram",
                          "buckets": [["7", 1], ["+Inf", 3]], "sum": 12.0, "count": 3})
    members["g2"].append({"group": "g0", "name": "m0-total", "tags": {},
                          "kind": "histogram", "buckets": [], "sum": 0.0, "count": 0})
    got = {name: pkg[0].merge_samples(members) for name, pkg in PACKAGES.items()}
    assert got["port"] == got["jax"]
    aggregations = {e["aggregation"] for e in got["port"].values()}
    assert {"sum", "histogram-merge"} <= aggregations


def _scrape(package: str) -> dict:
    telemetry, core, router_cls, _ = PACKAGES[package]
    router = router_cls("g0", vnodes=8)
    router.set_membership({"g1": "http://g1", "g2": "http://g2", "g3": "http://g3",
                           "g4": None})
    payloads = {
        "http://g1": {"instance": "g1", "samples": [
            {"group": "g0", "name": "m0-total", "tags": {}, "kind": "value", "value": 41.0},
            {"group": "g", "name": "breaker-state", "tags": {}, "kind": "value",
             "value": 2.0}]},
        "http://g3": {"not": "samples"},
    }

    def transport(url):
        if url not in payloads:
            raise ConnectionError(f"{url} down")
        return payloads[url]

    ping = {"instance": "g0", "generation": 3, "view_epoch": 1, "ring_instances": ["g0"],
            "peer_cache": {"forwards": 10, "failover_hits": 2}, "gossip": {"periods": 4},
            "storage_fetch_calls": 7, "witness": True}
    fleet = telemetry.FleetTelemetry(
        _registries(core, 3), instance_id="g0", router=router, ping=lambda: ping,
        transport=transport)
    out = {"local": fleet.local_payload(), "scrape": fleet.scrape()}
    out["again"] = fleet.scrape()
    out["failures"] = fleet.peer_scrape_failures
    solo = telemetry.FleetTelemetry(_registries(core, 4), instance_id="solo",
                                    ping=lambda: 1 / 0)
    out["solo"] = solo.scrape()
    return out


def test_fleet_scrape_equals_jax():
    got = {name: _scrape(name) for name in PACKAGES}
    assert got["port"] == got["jax"]
    scrape = got["port"]["scrape"]
    assert scrape["unreachable"] == [["g2", "ConnectionError: http://g2 down"]]
    assert scrape["members"]["g3"] == {"reachable": True, "local": False, "samples": 0}
    # g4 has no address, so it is read in process like g0 (JAX semantics).
    assert scrape["members"]["g4"]["local"] is True
    assert scrape["fleet"]["fleet-ping:peer_cache-forwards-total"]["value"] == 20.0


def _evidence(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    instances = {}
    for m, name in enumerate(("a", "b", "c")):
        launches = [{"kind": "flush", "batch_id": b, "work_class": "foreground",
                     "begin_s": 10.0 + b, "end_s": 10.5 + b, "occupancy": int(rng.integers(1, 4)),
                     "rows": 2, "bytes": 1 << 20}
                    for b in range(int(rng.integers(0, 4)))]
        launches.append({"kind": "expired", "begin_s": 11.0, "work_class": "background"})
        records = []
        for r in range(int(rng.integers(0, 3))):
            stages = [["chunk.fetch", 0.5, None]]
            stages += [[f"gcm.batch:{int(b)}", 1.0 + i, 100.0]
                       for i, b in enumerate(rng.integers(0, 4, 2))]
            records.append({"name": "gateway.chunk" if (m + r) % 2 else "gateway.fetch",
                            "trace_id": "t1", "start_s": 10.0 + r,
                            "duration_ms": float(rng.uniform(1, 50)), "error": None,
                            "stages": stages, "tiers": {"backend": 1}})
        instances[name] = {"local": m == 0, "records": records, "launches": launches,
                           "epoch": {"wall_s": 1000.0 + m, "mono_s": 5.0}}
    return instances


@pytest.mark.parametrize("seed", range(4))
def test_stitch_trace_equals_jax(seed):
    evidence = _evidence(seed)
    got = {name: pkg[0].stitch_trace("t1", evidence, [["d", "ConnectionError: down"]])
           for name, pkg in PACKAGES.items()}
    assert got["port"] == got["jax"]
    assert port_timeline.validate_chrome_events(got["port"]["chrome_trace"]["traceEvents"]) > 0


def test_assemble_trace_through_the_fetch_seam_equals_jax():
    evidence = _evidence(7)

    def run(package):
        telemetry, core, router_cls, _ = PACKAGES[package]
        router = router_cls("a", vnodes=8)
        router.set_membership({"b": "http://b", "c": "http://c", "d": "http://d"})
        paths = []

        def fetch_json(url, path):
            paths.append((url, path))
            member = url.split("//")[1]
            if member == "d":
                raise ConnectionError("down")
            if path.startswith("/debug/requests"):
                return {"slowest": evidence[member]["records"]} \
                    if evidence[member]["records"] else None
            return {"events": evidence[member]["launches"],
                    "epoch": evidence[member]["epoch"]}

        fleet = telemetry.FleetTelemetry([core.MetricsRegistry()], instance_id="a",
                                         router=router, fetch_json=fetch_json)
        with pytest.raises(ValueError):
            fleet.assemble_trace("")
        return fleet.assemble_trace("t1"), paths

    assert run("port") == run("jax")


def test_rsm_serves_its_payload_and_the_merged_scrape():
    rsm = RemoteStorageManager()
    rsm.configure({"storage.backend.class": "tieredstorage_tpu_torch.storage.memory.InMemoryStorage",
                   "chunk.size": 1024, "transform.device": "cpu", "fleet.enabled": True,
                   "fleet.instance.id": "g0", "flight.enabled": True})
    try:
        payload = rsm.fleet_telemetry_payload()
        assert payload["instance"] == "g0"
        names = {s["name"] for s in payload["samples"]}
        assert {"generation", "fleet-instances", "peer_cache-forwards-total"} <= names
        scrape = rsm.fleet_telemetry_payload(aggregate=True)
        assert scrape["members"]["g0"] == {"reachable": True, "local": True,
                                           "samples": len(payload["samples"])}
        assert rsm.fleet_telemetry.assemble_trace("nothing")["span_instances"] == []
    finally:
        rsm.close()
