"""The port's locks and mutation sites carry their JAX twins' witness names.

A subprocess arms the witness (`TSTPU_LOCK_WITNESS=1`) before either
package is imported, then runs one seeded drive through each package:

- a whole RSM (filesystem store, encryption, the window batcher, the disk
  chunk cache, readahead, the hot tier, the scrubber with a byte rate and
  checksums) that
  copies a segment, replays it in 40 KiB reads, reads it whole and
  scrubs it; the JAX RSM runs `TpuTransformBackend` (JAX on one CPU device), the
  port's `CudaTransformBackend` with `transform.device=cpu`, and the pools
  of the chunk cache and readahead run inline, so the drive is the same;
- the modules the RSM does not reach on that drive: a `LoadingCache` whose
  removal listener raises, a `TokenBucket`, a `ManifestLookahead` that
  joins one flight and loses another, an `HttpClient` request against a
  loopback server, an `InMemoryStorage` and a replicated store of two;
- a seeded fleet drive: a router whose membership changes, a single flight
  that coalesces a follower, a peer tier that forwards to a loopback owner
  (a hit, then a dead owner whose breaker opens), three gossip agents on a
  fake clock over an in-process transport that drops seeded attempts (a
  member killed, suspected and declared dead), a fleet telemetry scrape
  with one unreachable member, and the fleet metrics.

For every module of the table below, the lock names each witness saw
acquired, the mutation sites the race witness recorded and the lock held at
each site must be the JAX package's, with the port-only names of
`transform/cuda.py` mapped to their `transform/tpu.py` twins. Port-only
locks with no twin must be seen under their own names. No lock-order
violation may be recorded, and each package's race model
(`analysis.races.runtime_crosscheck`) must hold against what its witness
saw, validating the same sites.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

#: Port name -> JAX twin name, where the port's module has another name.
PORT_TO_JAX = {
    "cuda.CudaTransformBackend._stats_lock": "tpu.TpuTransformBackend._stats_lock",
    "cuda.CudaTransformBackend.dispatch_stats": "tpu.TpuTransformBackend.dispatch_stats",
}
#: Locks of port-only code (no JAX twin) and the drive that reaches them.
PORT_ONLY = ("cuda._StagingPool._lock", "cuda.CudaTransformBackend._pool_lock",
             "gcm._CONSTS_MU", "gcm._ContextCache._lock", "crc32c._CONSTS_MU", "_cuda._LOCK")
#: The modules whose plain locks became witnessed ones (module stems of the
#: names; the port's `cuda` is compared as the JAX `tpu`).
MODULES = ("caching", "ratelimit", "batcher", "chunk_manager", "manifest_cache",
           "readahead", "chunk_cache", "device_hot", "httpclient", "memory",
           "replicated", "gcm", "tpu", "ring", "singleflight", "peer_cache", "gossip",
           "telemetry", "retry")
#: The fleet's locks and mutation sites, which the fleet drive must reach.
FLEET_LOCKS = ("ring.FleetRouter._lock", "singleflight.SingleFlight._lock",
               "peer_cache.PeerChunkCache._lock", "gossip.GossipAgent._lock",
               "telemetry.FleetTelemetry._lock", "retry.BreakerBoard._lock")
FLEET_SITES = ("peer_cache.PeerChunkCache.forwards", "peer_cache.PeerChunkCache.peer_hits",
               "peer_cache.PeerChunkCache.forward_failures", "gossip.GossipAgent._members",
               "gossip.GossipAgent.probes_sent", "gossip.GossipAgent.acks",
               "gossip.GossipAgent.probe_failures", "gossip.GossipAgent.retried_probes",
               "telemetry.FleetTelemetry.scrapes",
               "telemetry.FleetTelemetry.peer_scrape_failures", "retry.BreakerBoard.opened")

_DRIVE = r'''
import concurrent.futures, http.server, importlib, io, json, sys, tempfile, threading
from pathlib import Path

import tests.test_torch_fetch_caches as fc
from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

PKGS = {"jax": "tieredstorage_tpu", "port": "tieredstorage_tpu_torch"}
tmp = Path(tempfile.mkdtemp())
keys = generate_key_pair_pem_files(tmp, prefix="names")


class Quiet(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"ok")

    def log_message(self, *args):
        pass


server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Quiet)
threading.Thread(target=server.serve_forever, daemon=True).start()


class Owner(http.server.BaseHTTPRequestHandler):
    def do_GET(self):
        body = b"\x00\x00\x00\x01\x00\x00\x00\x02ok"
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


def fleet_drive(mod, key_cls, server):
    """The fleet's locks and mutation sites, seeded, the same in each package."""
    fleet = mod("fleet")
    router = fleet.FleetRouter("me", vnodes=8)
    owner = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Owner)
    threading.Thread(target=owner.serve_forever, daemon=True).start()
    router.set_membership({"o": f"http://127.0.0.1:{owner.server_address[1]}"})
    router.route("seg/x.log")
    router.route_owners("seg/x.log", 2)

    flight = fleet.SingleFlight()
    entered, release = threading.Event(), threading.Event()
    def held():
        entered.set()
        release.wait(30)
        return 1
    leader = threading.Thread(target=flight.do, args=("k", held))
    leader.start()
    entered.wait(30)
    follower = threading.Thread(target=flight.do, args=("k", held))
    follower.start()
    while flight.coalesced == 0:
        entered.wait(0.001)
    release.set()
    leader.join(30)
    follower.join(30)

    class Local:
        def get_chunks(self, key, manifest, ids):
            return [b"x"] * len(ids)

        def get_chunk(self, key, manifest, cid):
            raise NotImplementedError

    class AllOwner:
        instances = ("me", "o")

        def owner(self, key):
            return "o"

        def owners(self, key, n):
            return ["o", "me"][:n]

    router._ring = AllOwner()
    metrics_registry = mod("metrics.core").MetricsRegistry()
    recorder = fleet.FleetMetrics(metrics_registry)
    cache = fleet.PeerChunkCache(Local(), router, replication=1,
                                 on_forward=recorder.record_forward)
    cache.get_chunks(key_cls("seg/x.log"), None, [0])
    owner.shutdown()
    owner.server_close()
    router.set_membership({"o": f"http://127.0.0.1:{server.server_address[1] + 1}"})
    router._ring = AllOwner()
    cache.get_chunks(key_cls("seg/x.log"), None, [1])
    with cache.serving_locally("seg/x.log"):
        cache.get_chunks(key_cls("seg/x.log"), None, [2])

    clock = [0.0]
    alive = {"a", "b", "c"}
    seeds = {n: f"http://{n}" for n in alive}
    agents, attempts = {}, [0]
    def transport_for(src):
        def transport(url, payload):
            dst = url.split("//")[1]
            attempts[0] += 1
            if dst not in alive or attempts[0] % 7 == 0:
                raise ConnectionRefusedError(dst)
            return agents[dst].on_gossip(payload)
        return transport
    for n in sorted(alive):
        r = fleet.FleetRouter(n, vnodes=8)
        r.set_membership(seeds)
        agents[n] = fleet.GossipAgent(r, interval_s=1.0, transport=transport_for(n),
                                      time_source=lambda: clock[0], sleeper=lambda s: None)
    for period in range(14):
        if period == 4:
            alive.discard("c")
        clock[0] += 1.0
        for n in sorted(alive):
            agents[n].run_period()
    fleet.register_fleet_metrics(metrics_registry, router=router, peer_cache=cache,
                                 gossip=agents["a"])

    def scrape_transport(url):
        raise ConnectionError(url)
    telemetry = fleet.FleetTelemetry([metrics_registry], instance_id="me", router=router,
                                     transport=scrape_transport)
    telemetry.scrape()
    telemetry.close()
    for agent in agents.values():
        agent.stop()
    cache.close()


def drive(name, P):
    mod = lambda m: importlib.import_module(f"{P}.{m}")
    for m in ("fetch.cache.chunk_cache", "fetch.readahead"):
        setattr(mod(m), "ThreadPoolExecutor", fc.InlineExecutor)
    root = tmp / name
    root.mkdir()
    store, cache_dir = root / "store", root / "cache"
    store.mkdir()
    extra = {"transform.batch.enabled": True, "scrub.enabled": True,
             "scrub.interval.ms": 3_600_000, "scrub.rate.bytes": 1 << 20,
             "scrub.checksums.enabled": True}
    if name == "jax":
        extra["transform.backend.class"] = "tieredstorage_tpu.transform.tpu.TpuTransformBackend"
    rsm = fc._rsm(mod("rsm").RemoteStorageManager, store, keys, P, cache_dir, extra)
    md, sd, log, _ = fc._segment(root, mod("metadata"))
    rsm.copy_log_segment_data(md, sd)
    fc._replay(rsm, md, log)
    rsm.scrubber.scrub_once()
    rsm.close()

    caching = mod("utils.caching")
    def boom(*_):
        raise RuntimeError("listener")
    cache = caching.LoadingCache(executor=fc.InlineExecutor(), max_weight=1,
                                 removal_listener=boom)
    cache.get("a", lambda: 1)
    cache.get("b", lambda: 2)
    mod("utils.ratelimit").TokenBucket(1 << 20).consume(4096)

    manifest_cache = mod("fetch.manifest_cache")
    key_cls = mod("storage.core").ObjectKey

    class Through:
        def get(self, key, loader, timeout=None):
            return loader()

    lookahead = manifest_cache.ManifestLookahead(Through())
    gate = threading.Event()
    lookahead.prefetch(key_cls("k1"), lambda: gate.wait(30) and "m1")
    joined = threading.Thread(target=lookahead.get, args=(key_cls("k1"), lambda: "m1"))
    joined.start()
    while lookahead.joins == 0:
        gate.wait(0.001)
    gate.set()
    joined.join(30)
    def fail():
        raise RuntimeError("lost")
    lookahead.prefetch(key_cls("k2"), fail)
    while lookahead.failures == 0:
        gate.wait(0.001)

    client = mod("storage.httpclient").HttpClient(f"http://127.0.0.1:{server.server_address[1]}")
    client.request("GET", "/x")

    memory = mod("storage.memory").InMemoryStorage()
    memory.upload(io.BytesIO(b"abc"), key_cls("m"))
    memory.fetch(key_cls("m")).read()
    replicated = mod("storage.replicated").ReplicatedStorageBackend()
    replicated.configure({
        "replication.replicas": "a,b",
        "replication.replica.a.backend.class": f"{P}.storage.memory.InMemoryStorage",
        "replication.replica.b.backend.class": f"{P}.storage.memory.InMemoryStorage",
    })
    replicated.upload(io.BytesIO(b"abc"), key_cls("r"))
    replicated.fetch(key_cls("r")).read()
    replicated.close()

    fleet_drive(mod, key_cls, server)

    locks = mod("utils.locks")
    return {
        "locks": sorted(locks.witness().acquired_names()),
        "sites": {s: v["held"] for s, v in locks.race_witness().snapshot()["sites"].items()},
        "unguarded": locks.race_witness().snapshot()["unguarded_names"],
        "violations": list(locks.witness().violations),
        "crosscheck": mod("analysis.races").runtime_crosscheck(),
    }


out = {name: drive(name, P) for name, P in PKGS.items()}
from tieredstorage_tpu_torch.ops import _cuda
_cuda.launch_counts()
from tieredstorage_tpu_torch.utils import locks
out["port"]["locks"] = sorted(locks.witness().acquired_names())
server.shutdown()
print("DRIVE " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def witnessed():
    # One JAX device, as the port has one: a virtual mesh would pad the JAX
    # backend's windows and move the hot tier's admissions.
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update({"TSTPU_LOCK_WITNESS": "1", "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(REPO)})
    res = subprocess.run([sys.executable, "-c", _DRIVE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    line = next(x for x in res.stdout.splitlines() if x.startswith("DRIVE "))
    return json.loads(line[len("DRIVE "):])


def _stem(name: str) -> str:
    return name.split(".")[0]


def _mapped(names):
    return {PORT_TO_JAX.get(n, n) for n in names}


@pytest.mark.parametrize("module", MODULES)
def test_acquired_lock_names_equal_jax(witnessed, module):
    jax = {n for n in witnessed["jax"]["locks"] if _stem(n) == module}
    port = {n for n in _mapped(witnessed["port"]["locks"]) if _stem(n) == module}
    port -= set(PORT_ONLY)
    assert port == jax


@pytest.mark.parametrize("module", MODULES)
def test_mutation_sites_and_their_held_locks_equal_jax(witnessed, module):
    jax = {s: set(held) for s, held in witnessed["jax"]["sites"].items() if _stem(s) == module}
    port = {PORT_TO_JAX.get(s, s): _mapped(held) for s, held in witnessed["port"]["sites"].items()
            if _stem(PORT_TO_JAX.get(s, s)) == module}
    assert port == jax


def test_every_part0_module_was_reached(witnessed):
    """The drive reached a lock of every module, in both packages, and the
    batcher, the caches and the backend recorded their mutation sites."""
    stems = {_stem(n) for n in witnessed["jax"]["locks"]}
    assert set(MODULES) - {"native"} <= stems
    sites = set(witnessed["jax"]["sites"])
    for site in ("batcher.WindowBatcher.launches", "batcher.WindowBatcher.fast_path_windows",
                 "readahead.ReadaheadManager.promotions", "device_hot.DeviceHotCache.admissions",
                 "manifest_cache.ManifestLookahead.joins", "caching.LoadingCache.stats",
                 "tpu.TpuTransformBackend.dispatch_stats"):
        assert site in sites


def test_fleet_drive_reached_every_fleet_lock_and_site(witnessed):
    """The fleet drive reached each fleet lock and mutation site, in both
    packages (their equality is the per-module tests' job)."""
    for side in ("jax", "port"):
        assert set(FLEET_LOCKS) <= set(witnessed[side]["locks"])
        assert set(FLEET_SITES) <= set(witnessed[side]["sites"])


def test_port_only_locks_are_witnessed_under_their_own_names(witnessed):
    assert set(PORT_ONLY) <= set(witnessed["port"]["locks"])


def test_unguarded_names_equal_jax(witnessed):
    assert witnessed["port"]["unguarded"] == witnessed["jax"]["unguarded"]


def test_no_lock_order_violation(witnessed):
    assert witnessed["port"]["violations"] == []
    assert witnessed["jax"]["violations"] == []


#: Guarded sites of port-only state, which the drive never mutates: they
#: stay unobserved in the port's cross-check and have no JAX twin.
PORT_ONLY_UNOBSERVED = {
    "cuda.CudaTransformBackend._pool (guard cuda.CudaTransformBackend._pool_lock)",
    "cuda._StagingPool.allocations (guard cuda._StagingPool._lock)",
}


def test_runtime_crosscheck_has_no_violation(witnessed):
    """Each package's race model holds against what its witness saw."""
    assert witnessed["port"]["crosscheck"]["violations"] == []
    assert witnessed["jax"]["crosscheck"]["violations"] == []


def test_runtime_crosscheck_validates_jaxs_sites(witnessed):
    """The port validates exactly JAX's observed sites, after the site map."""
    from tests.test_torch_static_analysis import map_site

    jax = {map_site(s) for s in witnessed["jax"]["crosscheck"]["validated"]}
    port = set(witnessed["port"]["crosscheck"]["validated"])
    assert port == jax
    assert {"cuda.CudaTransformBackend.dispatch_stats", "batcher.WindowBatcher.launches",
            "peer_cache.PeerChunkCache.forwards"} <= port


def test_runtime_crosscheck_unobserved_is_jaxs_plus_port_only(witnessed):
    from tests.test_torch_static_analysis import map_site

    jax = {map_site(s) for s in witnessed["jax"]["crosscheck"]["unobserved"]}
    port = set(witnessed["port"]["crosscheck"]["unobserved"])
    assert port - jax == PORT_ONLY_UNOBSERVED and jax <= port


_MODULE_LOCKS = r'''
import json
import tieredstorage_tpu.native as jn, tieredstorage_tpu.ops.gcm as jg
import tieredstorage_tpu_torch.native as pn, tieredstorage_tpu_torch.ops.gcm as pg
print(json.dumps({"native": [jn._lock.name, pn._lock.name],
                  "gcm": [jg._DISPATCH_MU.name, pg._DISPATCH_MU.name]}))
'''


def test_module_locks_carry_the_jax_names():
    """Module-level locks are made at import, so the witness must be armed
    before it: `native._lock` (taken only when the host library loads) and
    `gcm._DISPATCH_MU`."""
    env = {**os.environ, "TSTPU_LOCK_WITNESS": "1", "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", _MODULE_LOCKS], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    names = json.loads(res.stdout.strip().splitlines()[-1])
    assert names == {"native": ["native._lock"] * 2, "gcm": ["gcm._DISPATCH_MU"] * 2}
