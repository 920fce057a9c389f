"""The fleet in the port: each module against its JAX twin, the RSM and
gateway wiring, and a fleet of one JAX member and one port member.

Exact equality on seeded inputs, no tolerance:

- the ring: owners and ``owners(key, n)`` of 10 000 seeded keys over seeded
  memberships, the ownership fractions, and the keys a join or a leave
  moves; ``parse_instances``; the router's epoch-numbered views;
- the chunk frames byte for byte, and every torn frame refused with JAX's
  message;
- single flight: counts and error propagation on one schedule, and the
  deadline-bounded follower;
- the peer tier against stub peers (one per owner): counters, breaker
  states and transitions, the delegate's calls and the bytes served, for a
  hit, a 404, a dead peer and its cooldown, a torn frame, a pinned key,
  ordered failover at R=2, both owners down, R=1, the deadline and trace
  headers and the ``peer.forward`` fault seam;
- the ``fleet-metrics`` group's names and values;
- the fleet's config keys: types, defaults, validators and cross-key
  errors.

Then the port's RSM wiring (router, peer tier, metrics, ``fleet_ping``,
whose witness half holds only the lock verdict), the gateway's fleet routes
with and without a fleet, a three-member port fleet on the CPU whose owner
dies, and the mixed fleet: a JAX member (``python -m
tieredstorage_tpu.sidecar`` in a child, ``TpuTransformBackend`` on the CPU,
without ``XLA_FLAGS``) and a port member (``transform.device=cpu``) over one
filesystem store and one RSA pair, each owning one segment, read through
either member with a forward in each direction, their ``GET /chunk``
answers byte for byte and their fleet routes' errors.
"""

from __future__ import annotations

import http.client
import http.server
import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from urllib.parse import quote

import numpy as np
import pytest

from tieredstorage_tpu import fleet as jax_fleet
from tieredstorage_tpu.config import configdef as jax_configdef
from tieredstorage_tpu.config.rsm_config import RemoteStorageManagerConfig as JaxConfig
from tieredstorage_tpu.config.rsm_config import _base_def as jax_base_def
from tieredstorage_tpu.metrics.core import MetricsRegistry as JaxMetricsRegistry
from tieredstorage_tpu.rsm import RemoteStorageManager as JaxRemoteStorageManager
from tieredstorage_tpu.storage.core import ObjectKey as JaxObjectKey
from tieredstorage_tpu.utils import deadline as jax_deadline
from tieredstorage_tpu.utils import faults as jax_faults
from tieredstorage_tpu.utils.tracing import Tracer as JaxTracer
from tieredstorage_tpu_torch import fleet as port_fleet
from tieredstorage_tpu_torch import metadata
from tieredstorage_tpu_torch.config.configdef import ConfigException
from tieredstorage_tpu_torch.config.rsm_config import RemoteStorageManagerConfig
from tieredstorage_tpu_torch.config.rsm_config import _base_def
from tieredstorage_tpu_torch.metrics.core import MetricsRegistry
from tieredstorage_tpu_torch.object_key import ObjectKeyFactory, Suffix
from tieredstorage_tpu_torch.rsm import RemoteStorageManager
from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
from tieredstorage_tpu_torch.sidecar import shimwire
from tieredstorage_tpu_torch.sidecar.http_gateway import SidecarHttpGateway
from tieredstorage_tpu_torch.storage.core import ObjectKey
from tieredstorage_tpu_torch.utils import deadline as port_deadline
from tieredstorage_tpu_torch.utils import faults as port_faults
from tieredstorage_tpu_torch.utils.tracing import Tracer

REPO = Path(__file__).resolve().parents[1]
FS = "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage"
JAX_FS = "tieredstorage_tpu.storage.filesystem.FileSystemStorage"
CHUNK = 256 << 10
SEGMENT_SIZE = 2 * (1 << 20) + 777

PACKAGES = {
    "jax": {"fleet": jax_fleet, "key": JaxObjectKey, "deadline": jax_deadline,
            "faults": jax_faults, "tracer": JaxTracer, "registry": JaxMetricsRegistry},
    "port": {"fleet": port_fleet, "key": ObjectKey, "deadline": port_deadline,
             "faults": port_faults, "tracer": Tracer, "registry": MetricsRegistry},
}


def _both(fn):
    """`fn(package)` for each package: {"jax": ..., "port": ...}."""
    return {name: fn(pkg) for name, pkg in PACKAGES.items()}


# ----------------------------------------------------------------- the ring
def _keys(seed: int, n: int = 10_000) -> list[str]:
    rng = np.random.default_rng(seed)
    topics = rng.integers(0, 500, n)
    parts = rng.integers(0, 64, n)
    offsets = rng.integers(0, 10**12, n)
    return [f"fleet/topic{t}-{p}/{o:020d}-{rng.bytes(8).hex()}.log"
            for t, p, o in zip(topics, parts, offsets)]


def _membership(seed: int) -> tuple[list[str], int]:
    rng = np.random.default_rng(1000 + seed)
    names = sorted({f"broker-{int(i)}" for i in rng.integers(0, 100, int(rng.integers(3, 9)))})
    return names, int(rng.choice([1, 8, 64, 256]))


@pytest.mark.parametrize("seed", range(4))
def test_ring_places_every_key_as_jax(seed):
    names, vnodes = _membership(seed)
    keys = _keys(seed)
    jax, port = jax_fleet.HashRing(names, vnodes), port_fleet.HashRing(names, vnodes)
    assert port.instances == jax.instances
    assert [port.owner(k) for k in keys] == [jax.owner(k) for k in keys]
    for n in (1, 2, 3, len(names) + 1):
        assert [port.owners(k, n) for k in keys] == [jax.owners(k, n) for k in keys]
    assert [port.ownership_fraction(n) for n in names + ["absent"]] == \
        [jax.ownership_fraction(n) for n in names + ["absent"]]


@pytest.mark.parametrize("seed", range(4))
def test_keys_moved_by_a_join_or_a_leave_equal_jax(seed):
    names, vnodes = _membership(seed)
    keys = _keys(seed + 50)
    joined = names + ["joiner"]
    left = names[1:]

    def moved(pkg):
        ring = pkg["fleet"].HashRing(names, vnodes)
        before = [ring.owner(k) for k in keys]
        out = {}
        for what, members in (("join", joined), ("leave", left)):
            ring = pkg["fleet"].HashRing(members, vnodes)
            after = [ring.owner(k) for k in keys]
            out[what] = [(k, a, b) for k, a, b in zip(keys, before, after) if a != b]
        return out

    got = _both(moved)
    assert got["port"] == got["jax"]
    # The consistent-hashing contract, in the port: only the joiner gains
    # keys, and only the leaver's keys move.
    assert all(b == "joiner" for _, _, b in got["port"]["join"])
    assert all(a == names[0] for _, a, _ in got["port"]["leave"])
    assert got["port"]["join"] and got["port"]["leave"]


@pytest.mark.parametrize("entries", [
    ["a=http://h:1", "b", " c = http://h:3 "],
    ["a=", "b=http://x"],
    [""],
    ["=http://nameless"],
    ["a=http://1", "a=http://2"],
    ["x=y=z"],
])
def test_parse_instances_equals_jax(entries):
    def parse(pkg):
        try:
            return ("ok", pkg["fleet"].parse_instances(entries))
        except ValueError as e:
            return ("error", str(e))

    got = _both(parse)
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("names, vnodes", [([], 4), (["a", "b", "a"], 4), (["a"], 0)])
def test_ring_refusals_equal_jax(names, vnodes):
    def build(pkg):
        with pytest.raises(ValueError) as err:
            pkg["fleet"].HashRing(names, vnodes)
        return str(err.value)

    got = _both(build)
    assert got["port"] == got["jax"]


def test_router_views_and_routes_equal_jax():
    keys = _keys(7, 200)

    def drive(pkg):
        tracer = pkg["tracer"](enabled=True)
        router = pkg["fleet"].FleetRouter("me", vnodes=16, tracer=tracer)
        trace = []

        def snap(applied=None):
            trace.append((applied, router.generation, router.view_epoch,
                          router.peers, router.instances,
                          [router.route(k) for k in keys],
                          [router.route_owners(k, 2) for k in keys],
                          [router.is_local(k) for k in keys[:20]],
                          router.local_ownership_fraction()))

        snap()
        snap(router.set_membership({"a": "http://a", "b": "http://b"}))
        snap(router.set_membership({"a": "http://a", "b": "http://b", "c": None}, epoch=3))
        snap(router.set_membership({"a": "http://a"}, epoch=2))  # stale: refused
        snap(router.set_membership({"a": "http://a"}, epoch=3))  # equal: refused
        router.remove_instance("b")
        snap()
        router.remove_instance("me")  # the local instance is never removed
        router.remove_instance("absent")
        snap(router.set_membership({"d": "http://d", "e": "http://e"}, epoch=9))
        return trace, [(s.name, s.attributes) for s in tracer.spans()]

    got = _both(drive)
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]


# ----------------------------------------------------------- chunk frames
@pytest.mark.parametrize("seed", range(3))
def test_chunk_frames_equal_jax_byte_for_byte(seed):
    rng = np.random.default_rng(seed)
    chunks = [rng.bytes(int(n)) for n in rng.integers(0, 5000, int(rng.integers(0, 9)))]
    chunks.append(b"")
    blobs = _both(lambda pkg: pkg["fleet"].encode_chunk_frames(chunks))
    assert blobs["port"] == blobs["jax"]
    assert port_fleet.decode_chunk_frames(blobs["port"], expected=len(chunks)) == chunks


MANGLES = {
    "truncated body": lambda b: b[:-1],
    "truncated count": lambda b: b[:3],
    "empty": lambda b: b"",
    "truncated length": lambda b: b[:4 + 4 + 3 + 2],
    "trailing bytes": lambda b: b + b"\x00",
    "count too high": lambda b: b"\x00\x00\x00\x03" + b[4:],
    "count too low": lambda b: b"\x00\x00\x00\x01" + b[4:],
    "length past the end": lambda b: b[:4] + b"\x00\x00\x10\x00" + b[8:],
}


@pytest.mark.parametrize("mangle", sorted(MANGLES))
def test_torn_frames_refused_as_jax(mangle):
    blob = port_fleet.encode_chunk_frames([b"abc", b"defg"])

    def decode(pkg):
        with pytest.raises(ValueError) as err:
            pkg["fleet"].decode_chunk_frames(MANGLES[mangle](blob), expected=2)
        return str(err.value)

    got = _both(decode)
    assert got["port"] == got["jax"]


# ----------------------------------------------------------- single flight
def _single_flight_schedule(pkg) -> dict:
    """One schedule: 8 callers on key k behind a held leader, then a failing
    flight with one follower, then a fresh flight after it, then distinct
    keys, then a follower whose deadline runs out."""
    flight = pkg["fleet"].SingleFlight()
    out: dict = {}
    calls = []
    entered, release = threading.Event(), threading.Event()

    def work():
        calls.append(1)
        entered.set()
        release.wait(timeout=10)
        return "answer"

    results = []
    leader = threading.Thread(target=lambda: results.append(flight.do("k", work)))
    leader.start()
    assert entered.wait(timeout=10)
    followers = [threading.Thread(target=lambda: results.append(flight.do("k", work)))
                 for _ in range(7)]
    for t in followers:
        t.start()
    deadline = time.monotonic() + 10
    while flight.coalesced < 7 and time.monotonic() < deadline:
        time.sleep(0.005)
    out["pending_while_held"] = flight.pending
    release.set()
    for t in [leader, *followers]:
        t.join(timeout=10)
        assert not t.is_alive()
    out["first"] = (results, len(calls), flight.leaders, flight.coalesced,
                    flight.failures, flight.pending)

    entered.clear()
    release.clear()
    errors = []

    def boom():
        entered.set()
        release.wait(timeout=10)
        raise OSError("backend down")

    def caller():
        try:
            flight.do("k", boom)
        except OSError as e:
            errors.append(str(e))

    first = threading.Thread(target=caller)
    first.start()
    assert entered.wait(timeout=10)
    second = threading.Thread(target=caller)
    second.start()
    while flight.coalesced < 8 and time.monotonic() < deadline:
        time.sleep(0.005)
    release.set()
    for t in (first, second):
        t.join(timeout=10)
        assert not t.is_alive()
    out["failed"] = (sorted(errors), flight.leaders, flight.coalesced, flight.failures,
                     flight.pending)
    out["after"] = (flight.do("k", lambda: "recovered"), flight.do("a", lambda: 1),
                    flight.do("b", lambda: 2), flight.leaders, flight.coalesced)

    entered.clear()
    release.clear()
    held = threading.Thread(target=lambda: flight.do("slow", work))
    held.start()
    assert entered.wait(timeout=10)
    dl = pkg["deadline"]
    try:
        with dl.deadline_scope(dl.Deadline.after(0.05)):
            with pytest.raises(dl.DeadlineExceededException) as err:
                flight.do("slow", work)
        out["expired"] = str(err.value)
    finally:
        release.set()
        held.join(timeout=10)
    out["end"] = (flight.leaders, flight.coalesced, flight.failures, flight.pending)
    return out


def test_single_flight_counts_and_errors_equal_jax():
    got = _both(_single_flight_schedule)
    assert got["port"] == got["jax"]
    assert got["port"]["first"][0] == ["answer"] * 8 and got["port"]["first"][1] == 1
    assert got["port"]["end"][-1] == 0


# ------------------------------------------------------------- peer tier
class _Delegate:
    """The local chunk path: per-chunk fill bytes, calls recorded."""

    def __init__(self):
        self.calls = []

    def get_chunks(self, key, manifest, chunk_ids):
        self.calls.append((key.value, tuple(chunk_ids)))
        return [bytes([cid % 251]) * 16 for cid in chunk_ids]

    def get_chunk(self, key, manifest, chunk_id):
        raise NotImplementedError


class _StubPeer:
    """An owner's gateway answering ``GET /chunk`` with a scripted status
    and chunk list, after `delay` seconds; records each request's path and
    headers."""

    def __init__(self, status=200, chunks=(b"peer-" * 4,), delay=0.0):
        stub = self
        self.status, self.chunks, self.requests = status, list(chunks), []

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                stub.requests.append((self.path, {k.lower(): v for k, v in self.headers.items()}))
                time.sleep(delay)
                body = (port_fleet.encode_chunk_frames(stub.chunks)
                        if stub.status == 200 else b"nope")
                self.send_response(stub.status)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self._server.server_address[1]}"
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


def _dead_url() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"http://127.0.0.1:{s.getsockname()[1]}"


def _key_owned_in_order(order: list[str]) -> str:
    """A segment key whose ring walk over `order`'s names is `order`."""
    ring = port_fleet.HashRing(order, 64)
    for i in range(10_000):
        key = f"seg/k{i}.log"
        if ring.owners(key, len(order)) == order:
            return key
    raise AssertionError("no key with that owner order")


KEY = _key_owned_in_order(["o1", "o2", "me"])

#: scenario: (owners' behaviour, replication, steps). A behaviour is "dead"
#: or (status, chunks); a step is ("read", ids), ("clock", t), ("pinned",
#: ids), ("deadline", ids), ("trace", ids) or ("fault", spec, ids).
SCENARIOS = {
    "hit": ({"o1": (200, [b"A" * 16, b"B" * 16])}, 1, [("read", [0, 1])]),
    "sparse window": ({"o1": (200, [b"A", b"B", b"C"])}, 1, [("read", [0, 2])]),
    "404 falls back": ({"o1": (404, [])}, 1, [("read", [3]), ("read", [4])]),
    "dead peer and cooldown": ({"o1": "dead"}, 1, [
        ("read", [1]), ("read", [2]), ("clock", 6.0), ("read", [4]), ("clock", 13.0),
        ("read", [5])]),
    "torn frame": ({"o1": (200, [b"only-one"])}, 1, [("read", [0, 1])]),
    "http 500": ({"o1": (500, [])}, 1, [("read", [0]), ("read", [1])]),
    "pinned key": ({"o1": (200, [b"peer"])}, 1, [("pinned", [0]), ("read", [1])]),
    "failover at R=2": ({"o1": "dead", "o2": (200, [b"replica" * 3])}, 2, [
        ("read", [0]), ("read", [1]), ("clock", 6.0), ("read", [2])]),
    "both owners down": ({"o1": "dead", "o2": "dead"}, 2, [("read", [3]), ("read", [4])]),
    # The owner killed and the second owner slower than the 2 s forward
    # timeout on its first serve: both forwards fail, both breakers open and
    # the window is served locally; the next read skips both owners.
    "second owner past the forward timeout": (
        {"o1": "dead", "o2": (200, [b"late" * 4], 2.3)}, 2, [("read", [0]), ("read", [1])]),
    "R=1 ignores the second owner": ({"o1": "dead", "o2": (200, [b"never"])}, 1, [
        ("read", [2])]),
    "deadline and trace headers": ({"o1": (200, [b"x"])}, 1, [
        ("deadline", [0]), ("trace", [0]), ("read", [0])]),
    "peer.forward error": ({"o1": (200, [b"x" * 8])}, 1, [
        ("fault", "peer.forward:error@1", [0]), ("read", [0])]),
    "peer.forward partial": ({"o1": (200, [b"x" * 8])}, 1, [
        ("fault", "peer.forward:partial=6", [0])]),
}


def _drive_peer_tier(pkg, urls: dict, replication: int, steps) -> dict:
    fleet = pkg["fleet"]
    clock = [0.0]
    tracer = pkg["tracer"](enabled=True)
    router = fleet.FleetRouter("me", vnodes=64)
    router.set_membership(urls)
    delegate = _Delegate()
    cache = fleet.PeerChunkCache(
        delegate, router, replication=replication, forward_timeout_s=2.0,
        down_cooldown_s=5.0, tracer=tracer, time_source=lambda: clock[0])
    key = pkg["key"](KEY)
    trace, traceparents = [], []
    try:
        for step in steps:
            kind, arg = step[0], step[1]
            result = None
            if kind == "clock":
                clock[0] = arg
            elif kind == "read":
                result = cache.get_chunks(key, None, arg)
            elif kind == "pinned":
                with cache.serving_locally(KEY):
                    result = cache.get_chunks(key, None, arg)
            elif kind == "deadline":
                dl = pkg["deadline"]
                with dl.deadline_scope(dl.Deadline.after(5.0)):
                    result = cache.get_chunks(key, None, arg)
            elif kind == "trace":
                with tracer.span("read"):
                    result = cache.get_chunks(key, None, arg)
                    traceparents.append(tracer.current_traceparent())
            elif kind == "fault":
                plane = pkg["faults"].FaultPlane.parse([arg], seed=3)
                pkg["faults"].install(plane)
                try:
                    result = cache.get_chunks(key, None, step[2])
                finally:
                    pkg["faults"].install(None)
                result = (result, plane.snapshot())
            trace.append((step, result, cache.forwards, cache.peer_hits, cache.peer_misses,
                          cache.forward_failures, cache.failover_hits, cache.peers_down,
                          {t: s.name for t, s in cache.breakers.targets().items()},
                          (cache.breakers.opened, cache.breakers.half_opened,
                           cache.breakers.closed),
                          list(delegate.calls), cache.singleflight.leaders,
                          cache.singleflight.pending))
        events = [(s.name, s.attributes) for s in tracer.spans() if s.name.startswith("fleet.")]
    finally:
        cache.close()
    return {"trace": trace, "events": events, "traceparents": traceparents}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_peer_tier_equals_jax(scenario):
    behaviour, replication, steps = SCENARIOS[scenario]
    stubs, urls = {}, {}
    for owner, how in behaviour.items():
        if how == "dead":
            urls[owner] = _dead_url()
        else:
            stubs[owner] = _StubPeer(*how)
            urls[owner] = stubs[owner].url
    try:
        got, requests = {}, {}
        for name, pkg in PACKAGES.items():
            got[name] = _drive_peer_tier(pkg, urls, replication, steps)
            requests[name] = {o: list(s.requests) for o, s in stubs.items()}
            for s in stubs.values():
                s.requests.clear()
    finally:
        for s in stubs.values():
            s.stop()
    # Trace ids are random: each package's header is held against its own span.
    traceparents = {name: got[name].pop("traceparents") for name in PACKAGES}
    assert got["port"] == got["jax"]
    paths = {n: [(o, p) for o, reqs in r.items() for p, _ in reqs] for n, r in requests.items()}
    assert paths["port"] == paths["jax"]
    for name in PACKAGES:
        for owner, reqs in requests[name].items():
            for path, headers in reqs:
                assert path.startswith(f"/chunk?key={quote(KEY, safe='')}&chunks=")
                if "x-deadline-ms" in headers:
                    assert 0 < int(headers["x-deadline-ms"]) <= 5000
    if scenario == "second owner past the forward timeout":
        (_, _, forwards, hits, _, failures, failovers, down, states, *_), second = (
            got["port"]["trace"])
        assert (forwards, hits, failures, failovers, down) == (2, 0, 2, 0, 2)
        assert states == {"o1": "OPEN", "o2": "OPEN"}
        assert second[2] == 2 and second[10] == [(KEY, (0,)), (KEY, (1,))]
    if scenario == "deadline and trace headers":
        for name in PACKAGES:
            first, second, third = (h for _, h in requests[name]["o1"])
            assert "x-deadline-ms" in first and "traceparent" not in first
            assert second["traceparent"] == traceparents[name][0]
            assert "x-deadline-ms" not in third and "traceparent" not in third


def test_peer_tier_refuses_replication_0_as_jax():
    def build(pkg):
        with pytest.raises(ValueError) as err:
            pkg["fleet"].PeerChunkCache(_Delegate(), pkg["fleet"].FleetRouter("me"),
                                        replication=0)
        return str(err.value)

    got = _both(build)
    assert got["port"] == got["jax"]


# ---------------------------------------------------------- fleet metrics
def _fleet_metric_values(pkg) -> dict:
    fleet = pkg["fleet"]
    registry = pkg["registry"]()
    router = fleet.FleetRouter("me", vnodes=8)
    router.set_membership({"a": "http://a", "b": None}, epoch=4)
    cache = fleet.PeerChunkCache(_Delegate(), router, replication=3)
    for i, name in enumerate(("forwards", "peer_hits", "peer_misses", "forward_failures",
                              "failover_hits")):
        setattr(cache, name, 3 * i + 1)
    cache.breakers.for_target("a").on_failure()
    cache.singleflight.do("x", lambda: 1)
    gossip = fleet.GossipAgent(router, transport=lambda u, p: p, time_source=lambda: 0.0)
    for i, name in enumerate(("periods", "probes_sent", "acks", "probe_failures",
                              "refutations", "deltas_applied", "probe_skips",
                              "retried_probes")):
        setattr(gossip, name, 5 * i + 2)
    gossip.merge({"members": [{"name": "c", "url": None, "incarnation": 1,
                               "status": "suspect", "heartbeat": 3}]})
    fleet.register_fleet_metrics(registry, router=router, peer_cache=cache, gossip=gossip)
    recorder = fleet.FleetMetrics(registry)
    for ms in (0.5, 3.0, 12.25, 700.0):
        recorder.record_forward(ms)
    out = {}
    for metric_name in registry.metric_names:
        stat = registry.stat(metric_name)
        value = (stat.buckets(), stat.sum, stat.count) if hasattr(stat, "buckets") \
            else registry.value(metric_name)
        out[(metric_name.group, metric_name.name, metric_name.description,
             tuple(sorted(dict(metric_name.tags).items())))] = value
    cache.close()
    return out


def test_fleet_metric_group_equals_jax():
    got = _both(_fleet_metric_values)
    assert got["port"] == got["jax"]
    assert {g for g, *_ in got["port"]} == {"fleet-metrics"}
    assert port_fleet.FLEET_METRIC_GROUP == jax_fleet.FLEET_METRIC_GROUP
    assert len(got["port"]) == 5 + 11 + 10 + 3  # router, gossip, peer tier, latency


def test_fleet_package_exports_equal_jax():
    assert port_fleet.__all__ == jax_fleet.__all__


# ------------------------------------------------------------------ config
FLEET_KEY_PROBES = {
    "fleet.enabled": (True, "maybe"),
    "fleet.instance.id": ("a", ""),
    "fleet.instances": (["a=http://h:1", "b"], ["a", "a"]),
    "fleet.vnodes": (64, 0),
    "fleet.forward.timeout.ms": (2000, 0),
    "fleet.peer.down.cooldown.ms": (5000, 0),
    "fleet.replication.factor": (2, 17),
    "fleet.gossip.enabled": (False, None),
    "fleet.gossip.interval.ms": (1000, 9),
    "fleet.gossip.probe.timeout.ms": (750, 0),
    "fleet.gossip.suspect.periods": (3, 0),
    "fleet.gossip.dead.periods": (3, 0),
    "breaker.peer.failure.threshold": (1, 0),
    "breaker.gossip.failure.threshold": (2, 0),
    "retry.gossip.probe.attempts": (2, 0),
}


def test_probes_cover_every_fleet_key():
    fleet_keys = {k for k in jax_base_def().keys if k.startswith("fleet.")} | {
        "breaker.peer.failure.threshold", "breaker.gossip.failure.threshold",
        "retry.gossip.probe.attempts"}
    assert set(FLEET_KEY_PROBES) == fleet_keys


@pytest.mark.parametrize("key", sorted(FLEET_KEY_PROBES))
def test_fleet_keys_have_jax_definitions_and_errors(key):
    port, jax = _base_def().keys[key], jax_base_def().keys[key]
    assert (port.type, port.default, port.importance, port.doc) == \
        (jax.type, jax.default, jax.importance, jax.doc)
    assert getattr(port.validator, "description", None) == \
        getattr(jax.validator, "description", None)
    good, bad = FLEET_KEY_PROBES[key]
    base = {"storage.backend.class": "tieredstorage_tpu_torch.storage.memory.InMemoryStorage",
            "chunk.size": 1024, "fleet.instance.id": "me"}
    jax_base = {**base, "storage.backend.class": "tieredstorage_tpu.storage.memory.InMemoryStorage"}
    assert RemoteStorageManagerConfig({**base, key: good}).raw_props()[key] == good
    JaxConfig({**jax_base, key: good})
    if bad is not None:
        with pytest.raises(ConfigException) as port_err:
            RemoteStorageManagerConfig({**base, key: bad})
        with pytest.raises(jax_configdef.ConfigException) as jax_err:
            JaxConfig({**jax_base, key: bad})
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("props", [
    {"fleet.enabled": True},
    {"fleet.gossip.enabled": True},
    {"fleet.gossip.enabled": True, "fleet.instance.id": "me"},
])
def test_fleet_cross_key_errors_equal_jax(props):
    def build(backend, exc):
        with pytest.raises(exc) as err:
            (RemoteStorageManagerConfig if exc is ConfigException else JaxConfig)(
                {"storage.backend.class": backend, "chunk.size": 1024, **props})
        return str(err.value)

    assert build("tieredstorage_tpu_torch.storage.memory.InMemoryStorage", ConfigException) \
        == build("tieredstorage_tpu.storage.memory.InMemoryStorage",
                 jax_configdef.ConfigException)


def test_fleet_config_accessors_equal_jax():
    props = {"chunk.size": 1024, "fleet.enabled": True, "fleet.instance.id": "me",
             "fleet.instances": ["me", "b=http://b:1"], "fleet.gossip.enabled": True,
             "fleet.vnodes": 12, "fleet.replication.factor": 3,
             "breaker.gossip.failure.threshold": 4, "retry.gossip.probe.attempts": 5}
    port = RemoteStorageManagerConfig(
        {**props, "storage.backend.class": "tieredstorage_tpu_torch.storage.memory.InMemoryStorage"})
    jax = JaxConfig({**props, "storage.backend.class":
                     "tieredstorage_tpu.storage.memory.InMemoryStorage"})
    names = [n for n in dir(JaxConfig) if n.startswith(("fleet_", "breaker_peer", "breaker_gossip",
                                                         "retry_gossip"))]
    assert len(names) == 15
    assert [getattr(port, n) for n in names] == [getattr(jax, n) for n in names]


# --------------------------------------------------------------- RSM wiring
@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    """One RSA pair generated by the port (read by both packages)."""
    return generate_key_pair_pem_files(tmp_path_factory.mktemp("keys"), prefix="fleet")


def _configs(store: Path, keys, backend: str, extra=None) -> dict:
    pub, priv = keys
    return {
        "storage.backend.class": backend,
        "storage.root": str(store),
        "chunk.size": CHUNK,
        "key.prefix": "fleet/",
        "encryption.enabled": True,
        "encryption.key.pair.id": "k1",
        "encryption.key.pairs": "k1",
        "encryption.key.pairs.k1.public.key.file": str(pub),
        "encryption.key.pairs.k1.private.key.file": str(priv),
        **(extra or {}),
    }


def _member(store: Path, keys, name: str, extra=None) -> RemoteStorageManager:
    rsm = RemoteStorageManager()
    rsm.configure(_configs(store, keys, FS, {
        "transform.device": "cpu", "fleet.enabled": True, "fleet.instance.id": name,
        **(extra or {})}))
    return rsm


def _segment(root: Path, seed: int):
    """A segment of SEGMENT_SIZE seeded bytes under its own segment id."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    files = {}
    for name, size in (("log", SEGMENT_SIZE), ("index", 48), ("timeindex", 72),
                       ("snapshot", 40)):
        path = root / f"00000000000000000023.{name}"
        path.write_bytes(rng.bytes(size))
        files[name] = path
    tip = metadata.TopicIdPartition(metadata.KafkaUuid(b"\x01" * 16),
                                    metadata.TopicPartition("topic", 7))
    md = metadata.RemoteLogSegmentMetadata(
        remote_log_segment_id=metadata.RemoteLogSegmentId(
            tip, metadata.KafkaUuid(rng.bytes(16))),
        start_offset=23, end_offset=2000, segment_size_in_bytes=SEGMENT_SIZE,
    )
    sd = metadata.LogSegmentData(
        log_segment=files["log"], offset_index=files["index"],
        time_index=files["timeindex"], producer_snapshot_index=files["snapshot"],
        transaction_index=None, leader_epoch_index=b"0\n1\n0 23\n",
    )
    return md, sd, files["log"].read_bytes()


def _log_key(md) -> str:
    return ObjectKeyFactory("fleet/", False).key(md, Suffix.LOG).value


def _get(port: int, path: str, headers=None) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _post(port: int, path: str, body: bytes) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _fetch(port: int, md, start: int = 0, end=None) -> bytes:
    status, body = _post(port, "/v1/fetch",
                         shimwire.encode_metadata(md) + shimwire.encode_fetch_tail(start, end))
    assert status == 200, body[:300]
    return body


def test_rsm_wires_router_peer_tier_metrics_and_ping(tmp_path, keys):
    rsm = _member(tmp_path, keys, "me", {
        "fleet.instances": ["me", "b=http://127.0.0.1:1"], "fleet.replication.factor": 3,
        "fleet.vnodes": 16, "fleet.gossip.enabled": True, "fault.injection.enabled": True,
        "fault.schedule": []})
    try:
        assert rsm.fleet_router.instances == ("b", "me") and rsm.fleet_router.vnodes == 16
        cache = rsm.peer_chunk_cache
        assert cache.replication == 3 and rsm._innermost_chunk_manager(rsm._chunk_manager) \
            is cache.delegate
        assert rsm.gossip_agent is not None and rsm.fleet_telemetry is not None
        names = {m.name for m in rsm.metrics.registry.metric_names if m.group == "fleet-metrics"}
        assert {"fleet-instances", "fleet-peer-hits-total", "fleet-members-alive",
                "fleet-forward-time-avg"} - names == {"fleet-forward-time-avg"}
        retry = {m.name for m in rsm.metrics.registry.metric_names if m.group == "retry-metrics"}
        assert {"breaker-board-peer-open", "breaker-board-gossip-open"} <= retry
        ping = rsm.fleet_ping()
        assert set(ping) == {"instance", "generation", "view_epoch", "ring_instances",
                             "gossip", "peer_cache", "storage_fetch_calls"}
        # The witness half holds the lock verdict and the race model's
        # cross-check, JAX's four keys.
        assert set(rsm.fleet_ping(include_witness=True)["witness"]) == \
            {"enabled", "lock_violations", "race_violations", "race_sites_observed"}
        rsm.set_fleet_peers({"c": "http://127.0.0.1:2"})
        assert "c" in rsm.gossip_agent.members() and "c" in rsm.fleet_router.instances
        assert rsm.start_fleet_gossip() is rsm.gossip_agent
    finally:
        rsm.close()
    assert rsm.gossip_agent._thread is None


def test_fleet_ping_keys_equal_jax(tmp_path, keys):
    extra = {"fleet.enabled": True, "fleet.instance.id": "me", "fleet.gossip.enabled": True,
             "fault.injection.enabled": True, "fault.schedule": []}
    port = _member(tmp_path, keys, "me", extra)
    jax = JaxRemoteStorageManager()
    jax.configure(_configs(tmp_path, keys, JAX_FS, extra))
    try:
        got = {"port": port.fleet_ping(), "jax": jax.fleet_ping()}
        assert got["port"] == got["jax"]
    finally:
        port.close()
        jax.close()


def test_rsm_without_fleet_has_none(tmp_path, keys):
    rsm = RemoteStorageManager()
    rsm.configure(_configs(tmp_path, keys, FS, {"transform.device": "cpu"}))
    try:
        assert rsm.fleet_router is None and rsm.peer_chunk_cache is None
        assert rsm.gossip_agent is None and rsm.fleet_telemetry is None
        assert rsm.start_fleet_gossip() is None
        for call in (lambda: rsm.set_fleet_peers({}), rsm.fleet_ping,
                     lambda: rsm.fleet_gossip({}), lambda: rsm.fleet_fetch_chunks("a.log", 0, 0),
                     rsm.fleet_telemetry_payload):
            with pytest.raises(Exception, match="not enabled"):
                call()
        gw = SidecarHttpGateway(rsm).start()
        try:
            for path in ("/chunk?key=a.log&chunks=0-0", "/v1/chunk?key=a.log&chunks=0-0",
                         "/fleet/ping", "/v1/fleet/ping?witness=1", "/fleet/telemetry",
                         "/v1/fleet/telemetry?aggregate=1"):
                assert _get(gw.port, path) == (404, b"fleet mode disabled")
            for path in ("/fleet/gossip", "/v1/fleet/gossip"):
                assert _post(gw.port, path, b"{}") == (404, b"fleet gossip disabled")
        finally:
            gw.stop()
    finally:
        rsm.close()


# ------------------------------------------------ a port fleet on the CPU
def test_three_member_port_fleet_reads_through_owner_death(tmp_path, keys):
    """Three port members over one store, R=2: the non-owner's reads are
    forwarded (the owner decrypts), a herd of identical windows on both
    non-owners reaches the owner's store once per window, and after the
    owner's gateway stops a survivor reads byte-identically through the
    second owner and the dead owner's breaker is open."""
    store = tmp_path / "store"
    store.mkdir()
    # The survivor reads its nine chunks one forward at a time; on a loaded
    # host that outlasts the default 5 s cooldown, the dead owner's breaker
    # goes half-open mid-read and its probe is a second forward failure. A
    # cooldown longer than the test keeps the breaker open for the whole
    # read, and a long forward timeout keeps a slow owner decrypt a forward.
    extra = {"fault.injection.enabled": True, "fault.schedule": [],
             "fetch.chunk.cache.class": "tieredstorage_tpu_torch.fetch.cache.memory.MemoryChunkCache",
             "fetch.chunk.cache.size": 4 * SEGMENT_SIZE,
             "fleet.peer.down.cooldown.ms": 600_000, "fleet.forward.timeout.ms": 60_000}
    rsms = {n: _member(store, keys, n, extra) for n in ("a", "b", "c")}
    gws = {n: SidecarHttpGateway(r).start() for n, r in rsms.items()}
    try:
        peers = {n: f"http://127.0.0.1:{g.port}" for n, g in gws.items()}
        for r in rsms.values():
            r.set_fleet_peers(peers)
        md, sd, source = _segment(tmp_path / "seg", 5)
        rsms["a"].copy_log_segment_data(md, sd)
        (owner, _), (second, _) = rsms["a"].fleet_router.route_owners(_log_key(md), 2)
        third = next(n for n in rsms if n not in (owner, second))
        rsms[owner].fetch_segment_manifest(md)  # the herd then reads chunks only
        base = rsms[owner].fleet_ping()["storage_fetch_calls"]
        results = []

        def read(name):
            results.append(_fetch(gws[name].port, md))

        threads = [threading.Thread(target=read, args=(n,))
                   for n in (second, third) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        assert results == [source] * 8
        # Each chunk is a window of its own: one store read each on the
        # owner, however many herd members asked.
        assert rsms[owner].fleet_ping()["storage_fetch_calls"] - base == -(-SEGMENT_SIZE // CHUNK)
        assert rsms[third].peer_chunk_cache.peer_hits > 0
        assert rsms[second].peer_chunk_cache.peer_hits > 0
        assert rsms[owner].peer_chunk_cache.forwards == 0

        gws[owner].stop()
        md2, sd2, source2 = next(
            seg for seg in (_segment(tmp_path / f"seg{s}", s) for s in range(6, 200))
            if [o for o, _ in rsms[third].fleet_router.route_owners(_log_key(seg[0]), 2)]
            == [owner, second])
        rsms[second].copy_log_segment_data(md2, sd2)
        # A stopped gateway still answers on its open keep-alive connections,
        # so the survivor that reads is a fresh member (no connection to the
        # dead owner): its forward is refused, as after a kill.
        survivor = _member(store, keys, third, extra)
        try:
            survivor.set_fleet_peers(peers)
            with survivor.fetch_log_segment(md2, 0) as stream:
                assert stream.read() == source2
            cache = survivor.peer_chunk_cache
            assert cache.failover_hits >= 1 and cache.forward_failures == 1
            assert cache.breakers.targets()[owner].name == "OPEN"
        finally:
            survivor.close()
    finally:
        for g in gws.values():
            g.stop()
        for r in rsms.values():
            r.close()


# ------------------------------------------------------------ mixed fleet
def _owned_segments(root: Path, names: list[str]) -> dict:
    """{member: (md, sd, source)}: the first seeded segment each member owns."""
    ring = port_fleet.HashRing(names, 64)
    out = {}
    for seed in range(100, 400):
        seg = _segment(root / f"seg{seed}", seed)
        out.setdefault(ring.owner(_log_key(seg[0])), seg)
        if len(out) == len(names):
            return out
    raise AssertionError("no segment ids give every member one segment")


@pytest.fixture(scope="module")
def mixed(tmp_path_factory, keys):
    """A JAX member (the JAX sidecar in a child, TpuTransformBackend on the
    CPU, XLA_FLAGS dropped) and a port member (in this process) over one
    store, gossip on at 100 ms. The forward timeout covers the JAX member's
    first decrypt, which compiles."""
    root = tmp_path_factory.mktemp("mixed")
    store = root / "store"
    store.mkdir()
    gossip = {"fleet.enabled": True, "fleet.gossip.enabled": True,
              "fleet.gossip.interval.ms": 100, "fleet.forward.timeout.ms": 60_000,
              "fault.injection.enabled": True, "fault.schedule": []}
    port_rsm = _member(store, keys, "port", gossip)
    port_gw = SidecarHttpGateway(port_rsm).start()
    cfg = root / "jax.json"
    cfg.write_text(json.dumps(_configs(store, keys, JAX_FS, {
        **gossip, "fleet.instance.id": "jax",
        "transform.backend.class": "tieredstorage_tpu.transform.tpu.TpuTransformBackend"})))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    err = open(root / "jax.stderr", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tieredstorage_tpu.sidecar", "--config", str(cfg),
         "--http-port", "0", "--fleet-peers", f"jax,port=http://127.0.0.1:{port_gw.port}"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=err, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("SIDECAR_READY"), (line, (root / "jax.stderr").read_text()[-3000:])
        jax_port = int(dict(f.split("=") for f in line.split()[1:])["http_port"])
        port_rsm.set_fleet_peers({"port": None, "jax": f"http://127.0.0.1:{jax_port}"})
        port_rsm.start_fleet_gossip()
        segments = _owned_segments(root, ["jax", "port"])
        for md, sd, _ in segments.values():
            port_rsm.copy_log_segment_data(md, sd)
        yield {"ports": {"port": port_gw.port, "jax": jax_port}, "rsm": port_rsm,
               "segments": segments}
    finally:
        # The port member's pooled connections hold the child's workers:
        # close them (and its gossip) before the child is asked to stop.
        port_rsm.close()
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        err.close()
        port_gw.stop()


def _ping(port: int) -> dict:
    status, body = _get(port, "/fleet/ping")
    assert status == 200, body
    return json.loads(body)


def test_mixed_fleet_reads_through_either_member_with_forwards_both_ways(mixed):
    ports, segments = mixed["ports"], mixed["segments"]
    for owner, (md, _, source) in segments.items():
        other = "port" if owner == "jax" else "jax"
        assert _fetch(ports[other], md) == source
        assert _fetch(ports[owner], md) == source
        start = SEGMENT_SIZE // 3
        assert _fetch(ports[other], md, start, start + CHUNK) == source[start:start + CHUNK + 1]
    hits = {name: _ping(port)["peer_cache"]["peer_hits"] for name, port in ports.items()}
    assert hits["jax"] > 0 and hits["port"] > 0
    assert mixed["rsm"].peer_chunk_cache.forward_failures == 0


def test_mixed_fleet_chunk_route_answers_byte_identically(mixed):
    ports, segments = mixed["ports"], mixed["segments"]
    for md, _, source in segments.values():
        key = quote(_log_key(md), safe="")
        for window in ("0-0", "1-3", f"0-{SEGMENT_SIZE // CHUNK}"):
            got = {name: _get(port, f"/chunk?key={key}&chunks={window}")
                   for name, port in ports.items()}
            assert got["port"] == got["jax"] and got["port"][0] == 200
        lo, hi = 0, SEGMENT_SIZE // CHUNK
        chunks = port_fleet.decode_chunk_frames(got["port"][1], expected=hi - lo + 1)
        assert b"".join(chunks) == source


FLEET_ROUTE_ERRORS = {
    "no params": ("GET", "/chunk", {}),
    "only key": ("GET", "/chunk?key=only", {}),
    "bad window": ("GET", "/v1/chunk?key=a.log&chunks=x-y", {}),
    "not a log object": ("GET", "/chunk?key={idx}&chunks=0-0", {}),
    "inverted window": ("GET", "/chunk?key={log}&chunks=3-1", {}),
    "window beyond the segment": ("GET", "/chunk?key={log}&chunks=0-999", {}),
    "unknown segment": ("GET", "/chunk?key=fleet%2Fnone-0%2F0%2Fx.log&chunks=0-0", {}),
    "expired deadline": ("GET", "/chunk?key={log}&chunks=0-0", {"x-deadline-ms": "0"}),
    "gossip not an object": ("POST", "/fleet/gossip", b"[]"),
    "gossip without members": ("POST", "/v1/fleet/gossip", b"{}"),
    "gossip not json": ("POST", "/fleet/gossip", b"{"),
}


@pytest.mark.parametrize("case", sorted(FLEET_ROUTE_ERRORS))
def test_mixed_fleet_route_errors_equal_jax(mixed, case):
    method, path, extra = FLEET_ROUTE_ERRORS[case]
    md = next(iter(mixed["segments"].values()))[0]
    path = path.format(log=quote(_log_key(md), safe=""),
                       idx=quote(ObjectKeyFactory("fleet/", False).key(md, Suffix.INDEXES).value,
                                 safe=""))
    got = {}
    for name, port in mixed["ports"].items():
        if method == "GET":
            got[name] = _get(port, path, headers=extra)
        else:
            got[name] = _post(port, path, extra)
    assert got["port"] == got["jax"]
    assert got["port"][0] in (400, 404, 504)


def test_mixed_fleet_ping_telemetry_and_gossip_agree(mixed):
    ports = mixed["ports"]
    deadline = time.monotonic() + 30
    while True:
        pings = {name: _ping(port) for name, port in ports.items()}
        views = {name: {m: v["status"] for m, v in p["gossip"]["members"].items()}
                 for name, p in pings.items()}
        if all(v == {"jax": "alive", "port": "alive"} for v in views.values()) and \
                all(p["gossip"]["periods"] >= 3 for p in pings.values()):
            break
        assert time.monotonic() < deadline, views
        time.sleep(0.1)
    assert {name: set(p) for name, p in pings.items()}["port"] == set(pings["jax"])
    assert pings["port"]["ring_instances"] == pings["jax"]["ring_instances"] == ["jax", "port"]
    witness = {name: json.loads(_get(port, "/fleet/ping?witness=1")[1])["witness"]
               for name, port in ports.items()}
    # The port's witness holds JAX's keys: the lock half and the race
    # model's cross-check.
    assert set(witness["port"]) == set(witness["jax"]) == {
        "enabled", "lock_violations", "race_violations", "race_sites_observed"}
    local = {name: json.loads(_get(port, "/fleet/telemetry")[1]) for name, port in ports.items()}
    assert {name: set(p) for name, p in local.items()}["port"] == {"instance", "samples"}
    assert {n: p["instance"] for n, p in local.items()} == {"jax": "jax", "port": "port"}
    fleet = {name: json.loads(_get(port, "/fleet/telemetry?aggregate=1")[1])
             for name, port in ports.items()}
    for name, scrape in fleet.items():
        assert set(scrape) == set(fleet["jax"])
        assert scrape["unreachable"] == [] and set(scrape["members"]) == {"jax", "port"}
