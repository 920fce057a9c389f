"""Deterministic chaos matrix of the PyTorch/CUDA port over its failure-policy
plane.

Counterpart of tools/chaos_matrix.py over `tieredstorage_tpu_torch`: the
same 23 cells, seed (1234), per-cell rules, harnesses and gates, with the
port's `FaultPlane`, retry ledger, breakers, fleet, gossip, SLO engine and
lifecycle plane. The storage cells run a real port RSM with `tpu-huff-v1`
as the torn-byte oracle and the lifecycle cells a real port RSM, both on
`cuda:0` (`transform.device`; `--device cpu` runs the plain versions); the
device cells drive merged GCM launches of the port's `WindowBatcher` over a
`CudaTransformBackend` on the same device (AES and the GHASH tree kernels
on the card). The report adds `device` and the kernels' `launches` over
the run. The JAX gate's docstring follows; its checks are the twin's.

Sweeps every fault kind the ``FaultPlane`` speaks (``error`` / ``latency``
/ ``partial`` / ``flaky``; ``partial`` on the data-bearing sites only)
across every I/O seam the retry plane guards — the storage read and write
chokepoints, the peer-forward hop, the gossip probe round trip, the
merged GCM device launch, and the crash-consistent lifecycle plane's
journal-append and recovery-sweep seams — and gates each cell
on the policy invariants, judged with real component harnesses, not mocks:

- **integrity** — zero byte corruption: every byte a harness serves while
  its seam is being torn/failed must equal the source bytes, and torn
  reads must surface as clean exceptions (the GCM tag check / frame
  decoder refusing), never as wrong data.
- **amplification** — the process retry ledger's per-site delta over the
  cell must satisfy ``attempts / originating calls <= policy cap``: one
  policy layer means a fault storm cannot multiply itself through stacked
  ad-hoc retries.
- **breaker** — for failing kinds, a fake-clock drill drives the cell's
  exact rule through ``call_with_retry`` + a ``CircuitBreaker``: the
  breaker must open under the sustained fault, fast-fail while open, and
  re-close behind the heal; the peer and gossip cells additionally assert
  their live per-target boards opened during the storm and ended closed.
- **shed-not-hang** — the seam's user-facing operation runs once under a
  small ambient ``deadline_scope`` and must return (success or clean
  failure) within a hard wall bound; the retry loop never schedules a retry
  past the deadline.
- **slo** — a per-cell ``SloEngine`` spec over the harness's
  good/total counters must report ``ok`` with real samples after the heal:
  recovery traffic refills the error budget the fault phase burned.

A pre-matrix self-check replays a probabilistic rule twice with the same
seed and requires identical injection sequences (the determinism the
``@p=`` trigger promises), and a post-matrix probe asserts the disarmed
module-level ``fire`` is back to the zero-work ``None`` check.

Writes ``artifacts/torch_chaos_matrix_report.json`` (re-read +
re-validated).

    python3 tools/torch_chaos_matrix.py --out artifacts/torch_chaos_matrix_report.json
    python3 tools/torch_chaos_matrix.py --device cpu

Without CUDA, and without `--device cpu`, it exits 2 and runs nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import http.server
import io
import json
import pathlib
import random
import struct
import sys
import tempfile
import threading
import time

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO_ROOT))

from tieredstorage_tpu_torch.fleet import FleetRouter, PeerChunkCache, encode_chunk_frames  # noqa: E402
from tieredstorage_tpu_torch.fleet.gossip import ALIVE, DEAD, GossipAgent  # noqa: E402
from tieredstorage_tpu_torch.metadata import (  # noqa: E402
    KafkaUuid,
    LogSegmentData,
    RemoteLogSegmentId,
    RemoteLogSegmentMetadata,
    TopicIdPartition,
    TopicPartition,
)
from tieredstorage_tpu_torch.metrics.slo import RatioSource, SloEngine, SloSpec  # noqa: E402
from tieredstorage_tpu_torch.rsm import RemoteStorageManager  # noqa: E402
from tieredstorage_tpu_torch.storage.core import ObjectKey  # noqa: E402
from tieredstorage_tpu_torch.utils import faults  # noqa: E402
from tieredstorage_tpu_torch.utils.deadline import Deadline, deadline_scope  # noqa: E402
from tieredstorage_tpu_torch.utils.retry import (  # noqa: E402
    CircuitBreaker,
    CircuitOpenException,
    RetryPolicy,
    call_with_retry,
)
from tieredstorage_tpu_torch.utils.retry import ledger as retry_ledger  # noqa: E402

CHUNK_SIZE = 1024
SEGMENT_SIZE = 4 * 1024 + 133
#: Hard wall bound for the shed-not-hang gate (the deadline-scoped op).
SHED_WALL_BOUND_S = 5.0
#: Global retry-amplification ceiling: no seam policy allows more.
AMPLIFICATION_CAP = 3.0 + 1e-9

#: The matrix: every (site, kind) pair the fault grammar accepts, with the
#: concrete rule each cell arms (latency args in ms; flaky args sized to
#: heal inside the cell's fault phase only where the kind demands it).
CELLS = [
    ("storage.read", "error", "storage.read:error"),
    ("storage.read", "latency", "storage.read:latency=40"),
    ("storage.read", "partial", "storage.read:partial=9"),
    ("storage.read", "flaky", "storage.read:flaky=3"),
    ("storage.write", "error", "storage.write:error"),
    ("storage.write", "latency", "storage.write:latency=40"),
    ("storage.write", "flaky", "storage.write:flaky=2"),
    ("peer.forward", "error", "peer.forward:error"),
    ("peer.forward", "latency", "peer.forward:latency=30"),
    ("peer.forward", "partial", "peer.forward:partial=5"),
    ("peer.forward", "flaky", "peer.forward:flaky=2"),
    ("gossip.probe", "error", "gossip.probe:error"),
    ("gossip.probe", "latency", "gossip.probe:latency=1"),
    ("gossip.probe", "flaky", "gossip.probe:flaky=24"),
    ("device.launch", "error", "device.launch:error"),
    ("device.launch", "latency", "device.launch:latency=20"),
    ("device.launch", "flaky", "device.launch:flaky=1"),
    # Crash-consistent lifecycle plane. Every lifecycle cell's
    # recovery phase also runs the kill-mid-copy drill at each of the
    # three upload stages (after .log, after .indexes, mid-manifest) and
    # gates on ONE recovery sweep leaving zero permanent orphans.
    ("lifecycle.journal", "error", "lifecycle.journal:error"),
    ("lifecycle.journal", "latency", "lifecycle.journal:latency=5"),
    ("lifecycle.journal", "flaky", "lifecycle.journal:flaky=2"),
    ("lifecycle.sweep", "error", "lifecycle.sweep:error"),
    ("lifecycle.sweep", "latency", "lifecycle.sweep:latency=5"),
    ("lifecycle.sweep", "flaky", "lifecycle.sweep:flaky=1"),
]


#: Where the RSMs' transform and the device cells' backend run (`main`
#: sets it from `--device`).
DEVICE = {"name": "cuda:0"}


def say(msg: str) -> None:
    print(f"[torch-chaos-matrix] {msg}", flush=True)


# --------------------------------------------------------------- plane helpers
def arm(rule: str, seed: int, sleeper=time.sleep) -> faults.FaultPlane:
    plane = faults.FaultPlane.parse(rule, seed=seed, sleeper=sleeper)
    faults.install(plane)
    return plane


def heal() -> None:
    faults.install(None)


def ledger_delta(before: dict) -> dict:
    """Per-site counter deltas of the process retry ledger over a cell."""
    delta = {}
    for site, rec in retry_ledger().snapshot().items():
        prior = before.get(site, {})
        d = {k: v - prior.get(k, 0.0) for k, v in rec.items()}
        if d.get("attempts", 0.0) > 0:
            delta[site] = d
    return delta


def max_amplification(delta: dict) -> float:
    worst = 1.0
    for d in delta.values():
        calls = d["attempts"] - d["retries"]
        if calls > 0:
            worst = max(worst, d["attempts"] / calls)
    return worst


# --------------------------------------------------------------- breaker drill
def breaker_drill(site: str, rule: str, seed: int) -> tuple[bool, dict]:
    """Fake-clock composition drill: the cell's exact rule, the shared
    retry loop, one breaker. Open under sustained faults -> fast-fail
    while open -> re-close behind the heal. ``partial`` counts as a
    failure here because the downstream integrity check refuses torn
    bytes — the breaker sees the same verdict the real seam produces."""
    clock = [0.0]
    breaker = CircuitBreaker(
        failure_threshold=3, cooldown_s=5.0, time_source=lambda: clock[0]
    )
    if ":flaky" in rule:
        # The live harness proves the cell rule's OWN heal window; the
        # drill needs the flakiness sustained past the breaker threshold,
        # so stretch the window and let the explicit heal end it.
        rule = f"{site}:flaky=50"
    armed: list = [faults.FaultPlane.parse(rule, seed=seed, sleeper=lambda s: None)]
    policy = RetryPolicy(
        max_attempts=2, base_backoff_s=0.001, max_backoff_s=0.002,
        retryable=(faults.FaultInjectedError,),
    )

    def op() -> bool:
        plane = armed[0]
        if plane is not None:
            torn = plane.fire(site, "drill")
            if torn:
                raise faults.FaultInjectedError(site, "drill", torn[0].spec())
        return True

    def attempt():
        try:
            call_with_retry(
                op, policy=policy, site=f"drill.{site}", breaker=breaker,
                sleep=lambda s: None,
            )
            return None
        except BaseException as exc:  # noqa: BLE001 - the drill inspects it
            return exc

    for _ in range(8):
        attempt()
    opened = breaker.refusing and breaker.opens >= 1
    fast_failed = isinstance(attempt(), CircuitOpenException) and breaker.fast_fails >= 1
    armed[0] = None  # the heal
    clock[0] += 6.0  # past the cooldown: half-open admits one probe
    reclosed = attempt() is None and breaker.closes >= 1 and not breaker.refusing
    evidence = {
        "opened": opened, "fast_failed": fast_failed, "reclosed": reclosed,
        "opens": breaker.opens, "fast_fails": breaker.fast_fails,
        "closes": breaker.closes,
    }
    return opened and fast_failed and reclosed, evidence


# ------------------------------------------------------------- cell scaffolding
class Cell:
    """Counters + verdict assembly shared by every harness."""

    def __init__(self, site: str, kind: str, rule: str) -> None:
        self.site, self.kind, self.rule = site, kind, rule
        self.ok_ops = 0
        self.total_ops = 0
        self.corruptions = 0
        self.shed_wall_s: float | None = None
        self.breaker_ok: bool | None = None
        self.evidence: dict = {}

    def count(self, ok: bool) -> None:
        self.total_ops += 1
        if ok:
            self.ok_ops += 1

    def slo_verdict(self) -> dict:
        engine = SloEngine(
            specs=[SloSpec(
                name=f"chaos-{self.site}-{self.kind}",
                description=f"good ops through the {self.site} seam under "
                            f"{self.kind} faults, across heal",
                objective=0.55,
                source=RatioSource(
                    good=lambda: float(self.ok_ops),
                    total=lambda: float(self.total_ops),
                ),
            )],
            short_window_s=1.0, long_window_s=10.0,
        )
        return engine.evaluate()

    def verdict(self, ledger_d: dict, plane_snap: dict) -> dict:
        slo = self.slo_verdict()
        amplification = max_amplification(ledger_d)
        gates = {
            "integrity": self.corruptions == 0,
            "amplification": amplification <= AMPLIFICATION_CAP,
            "breaker": self.breaker_ok,
            "shed": (
                None if self.shed_wall_s is None
                else self.shed_wall_s <= SHED_WALL_BOUND_S
            ),
            "slo": bool(slo["ok"]) and all(
                v["samples"] > 0 for v in slo["specs"].values()
            ),
        }
        ok = all(v for v in gates.values() if v is not None)
        return {
            "site": self.site, "kind": self.kind, "rule": self.rule,
            "ok": ok, "gates": gates,
            "evidence": {
                "ops": {"ok": self.ok_ops, "total": self.total_ops},
                "corruptions": self.corruptions,
                "amplification": amplification,
                "ledger_delta": ledger_d,
                "shed_wall_s": self.shed_wall_s,
                "plane": plane_snap,
                "slo": slo["specs"],
                **self.evidence,
            },
        }


# ------------------------------------------------------------- storage harness
def make_segment(tmp: pathlib.Path, tag: int) -> tuple:
    """(metadata, LogSegmentData, original bytes) with a unique segment id."""
    header = struct.pack(">qiibih", 0, SEGMENT_SIZE - 12, 0, 2, 0, 0)
    body = (b"chaos matrix payload " * 97)[: SEGMENT_SIZE // 2]
    rnd = bytes((i * 131 + tag) % 256 for i in range(SEGMENT_SIZE - len(header) - len(body)))
    original = header + body + rnd
    base = tmp / f"0000000000000000{tag:04d}.log"
    base.write_bytes(original)
    offset_index = base.with_suffix(".index")
    offset_index.write_bytes(b"OFFSETIDX" * 16)
    time_index = base.with_suffix(".timeindex")
    time_index.write_bytes(b"TIMEIDX" * 24)
    snapshot = base.with_suffix(".snapshot")
    snapshot.write_bytes(b"PRODSNAP" * 4)
    data = LogSegmentData(
        log_segment=base,
        offset_index=offset_index,
        time_index=time_index,
        producer_snapshot_index=snapshot,
        transaction_index=None,
        leader_epoch_index=b"leader-epoch-checkpoint",
    )
    tip = TopicIdPartition(KafkaUuid(b"\x01" * 16), TopicPartition("chaos", tag))
    metadata = RemoteLogSegmentMetadata(
        remote_log_segment_id=RemoteLogSegmentId(
            tip, KafkaUuid(bytes([tag % 251 + 1]) * 16)
        ),
        start_offset=0,
        end_offset=2000,
        segment_size_in_bytes=SEGMENT_SIZE,
    )
    return metadata, data, original


class StorageHarness:
    """One compressing RSM over ``InMemoryStorage``, shared across the
    storage cells (fresh segment ids per phase keep cells independent —
    a ``partial`` cell's quarantined key never pollutes its recovery).
    The device codec is the integrity oracle: its framed decompress must
    refuse torn stored bytes with ``CorruptChunkException``, never serve
    them (the JAX harness's oracle, kept so the cells stay equal; the
    port's RSA key-wrap needs no optional package)."""

    def __init__(self, workdir: pathlib.Path) -> None:
        self.workdir = workdir
        self.rsm = RemoteStorageManager()
        self.rsm.configure({
            "storage.backend.class": "tieredstorage_tpu_torch.storage.memory.InMemoryStorage",
            "transform.device": DEVICE["name"],
            "chunk.size": CHUNK_SIZE,
            "key.prefix": "chaos/",
            "compression.enabled": True,
            "compression.codec": "tpu-huff-v1",
            "retry.budget.enabled": True,
            "retry.budget.max.attempts": 3,
            "retry.budget.backoff.ms": 1,
        })
        self._next_tag = 1

    def segment(self) -> tuple:
        tag = self._next_tag
        self._next_tag += 1
        return make_segment(self.workdir, tag)

    def fetch_ok(self, cell: Cell, metadata, original: bytes,
                 start: int = 0, end: int | None = None) -> bool:
        """One ranged fetch, integrity-compared. Clean failures count as
        not-ok ops; wrong bytes count as corruption."""
        want = original[start:] if end is None else original[start: end + 1]
        try:
            with (self.rsm.fetch_log_segment(metadata, start) if end is None
                  else self.rsm.fetch_log_segment(metadata, start, end)) as s:
                got = s.read()
        except Exception:  # noqa: BLE001 - clean failure is the contract
            cell.count(False)
            return False
        if got != want:
            cell.corruptions += 1
            cell.count(False)
            return False
        cell.count(True)
        return True

    def copy_ok(self, cell: Cell, metadata, data) -> bool:
        try:
            self.rsm.copy_log_segment_data(metadata, data)
        except Exception:  # noqa: BLE001 - clean failure is the contract
            cell.count(False)
            return False
        cell.count(True)
        return True


def run_storage_read_cell(storage: StorageHarness, cell: Cell, seed: int) -> dict:
    before = retry_ledger().snapshot()
    metadata, data, original = storage.segment()
    storage.rsm.copy_log_segment_data(metadata, data)  # pre-fault upload
    plane = arm(cell.rule, seed)
    try:
        for start, end in [(0, CHUNK_SIZE - 1), (100, 2048), (0, None), (512, 700)]:
            storage.fetch_ok(cell, metadata, original, start, end)
        t0 = time.monotonic()
        with deadline_scope(Deadline.after_ms(150)):
            storage.fetch_ok(cell, metadata, original, 0, CHUNK_SIZE - 1)
        cell.shed_wall_s = time.monotonic() - t0
    finally:
        heal()
    # Recovery on a FRESH segment: the torn segment may be quarantined —
    # that refusal is the integrity story, not a liveness regression.
    metadata2, data2, original2 = storage.segment()
    storage.rsm.copy_log_segment_data(metadata2, data2)
    for _ in range(3):
        for start, end in [(0, None), (0, 1023), (CHUNK_SIZE, 2 * CHUNK_SIZE - 1)]:
            storage.fetch_ok(cell, metadata2, original2, start, end)
    if cell.kind in ("error", "partial", "flaky"):
        cell.breaker_ok, cell.evidence["drill"] = breaker_drill(
            cell.site, cell.rule, seed
        )
    return cell.verdict(ledger_delta(before), plane.snapshot())


def run_storage_write_cell(storage: StorageHarness, cell: Cell, seed: int) -> dict:
    before = retry_ledger().snapshot()
    plane = arm(cell.rule, seed)
    try:
        uploads = []
        for _ in range(2):
            metadata, data, original = storage.segment()
            if storage.copy_ok(cell, metadata, data):
                uploads.append((metadata, original))
        t0 = time.monotonic()
        with deadline_scope(Deadline.after_ms(250)):
            metadata, data, original = storage.segment()
            if storage.copy_ok(cell, metadata, data):
                uploads.append((metadata, original))
        cell.shed_wall_s = time.monotonic() - t0
    finally:
        heal()
    for _ in range(4):
        metadata, data, original = storage.segment()
        if storage.copy_ok(cell, metadata, data):
            uploads.append((metadata, original))
    # Every copy that REPORTED success must round-trip byte-identically,
    # including ones that landed mid-fault (latency/flaky survivors).
    for metadata, original in uploads:
        storage.fetch_ok(cell, metadata, original, 0, None)
    if cell.kind in ("error", "flaky"):
        cell.breaker_ok, cell.evidence["drill"] = breaker_drill(
            cell.site, cell.rule, seed
        )
    return cell.verdict(ledger_delta(before), plane.snapshot())


# ---------------------------------------------------------------- peer harness
class _PeerStub:
    """Minimal HTTP peer serving one scripted /chunk window."""

    def __init__(self, chunks: list) -> None:
        stub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                body = encode_chunk_frames(stub.chunks)
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.chunks = chunks
        self._server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()


class _LocalDelegate:
    """Fallback ChunkManager serving the same deterministic fill bytes the
    stub peer serves — so forwarded and local answers are byte-identical
    and the integrity compare needs no provenance."""

    def get_chunks(self, key, manifest, chunk_ids):
        return [expected_chunk(cid) for cid in chunk_ids]

    def get_chunk(self, key, manifest, chunk_id):
        raise NotImplementedError


def expected_chunk(cid: int) -> bytes:
    return bytes([cid % 251]) * 16


def _all_owner_router(owner_url: str) -> FleetRouter:
    router = FleetRouter("me", vnodes=4)
    router.set_membership({"owner": owner_url})

    class _AllOwner:
        instances = ("me", "owner")

        def owner(self, key):
            return "owner"

        def owners(self, key, n):
            return ["owner", "me"][:n]

    router._ring = _AllOwner()  # deterministic: every key is peer-owned
    return router


def run_peer_cell(cell: Cell, seed: int) -> dict:
    before = retry_ledger().snapshot()
    clock = [0.0]
    stub = _PeerStub([expected_chunk(0), expected_chunk(1)])
    cache = PeerChunkCache(
        _LocalDelegate(), _all_owner_router(f"http://127.0.0.1:{stub.port}"),
        replication=1, forward_timeout_s=2.0, down_cooldown_s=5.0,
        breaker_threshold=1, time_source=lambda: clock[0],
    )
    key = ObjectKey("chaos/seg.log")

    def get_ok() -> bool:
        try:
            got = cache.get_chunks(key, None, [0, 1])
        except Exception:  # noqa: BLE001 - clean failure is the contract
            cell.count(False)
            return False
        if got != [expected_chunk(0), expected_chunk(1)]:
            cell.corruptions += 1
            cell.count(False)
            return False
        cell.count(True)
        return True

    plane = arm(cell.rule, seed)
    try:
        for _ in range(3):
            get_ok()
        t0 = time.monotonic()
        with deadline_scope(Deadline.after_ms(200)):
            get_ok()
        cell.shed_wall_s = time.monotonic() - t0
    finally:
        heal()
    clock[0] += 6.0  # past the breaker cooldown: half-open probes readmit
    for _ in range(2):
        get_ok()
    clock[0] += 6.0  # a flaky probe may have re-opened; admit another
    for _ in range(4):
        get_ok()
    board = cache.breakers
    if cell.kind in ("error", "partial", "flaky"):
        drill_ok, cell.evidence["drill"] = breaker_drill(cell.site, cell.rule, seed)
        live_ok = board.opened >= 1 and board.open_count() == 0
        cell.breaker_ok = drill_ok and live_ok
    cell.evidence["board"] = {
        "opened": board.opened, "closed": board.closed,
        "open_now": board.open_count(),
    }
    cell.evidence["counters"] = {
        "forwards": cache.forwards, "peer_hits": cache.peer_hits,
        "forward_failures": cache.forward_failures,
    }
    # The heal must restore actual forwarding, not just local fallback.
    restored = cache.peer_hits > 0
    cell.evidence["forwarding_restored"] = restored
    if not restored:
        cell.breaker_ok = False
    cache.close()
    stub.stop()
    return cell.verdict(ledger_delta(before), plane.snapshot())


# -------------------------------------------------------------- gossip harness
class _GossipCluster:
    """Three agents joined by an in-process transport on one fake clock."""

    def __init__(self, names=("a", "b", "c")) -> None:
        self.clock = [0.0]
        self.agents: dict[str, GossipAgent] = {}
        seeds = {n: f"http://{n}" for n in names}
        for name in names:
            router = FleetRouter(name, vnodes=16)
            router.set_membership(seeds)
            self.agents[name] = GossipAgent(
                router, interval_s=1.0, suspect_periods=2, dead_periods=60,
                transport=self._transport_for(name),
                time_source=lambda: self.clock[0],
                sleeper=lambda s: None,
            )

    def _transport_for(self, src: str):
        def transport(url, payload):
            return self.agents[url.split("//")[1]].on_gossip(payload)

        return transport

    def tick(self, periods: int = 1) -> None:
        for _ in range(periods):
            self.clock[0] += 1.0
            for name in sorted(self.agents):
                self.agents[name].run_period()

    def totals(self) -> dict:
        return {
            "probes": sum(a.probes_sent for a in self.agents.values()),
            "acks": sum(a.acks for a in self.agents.values()),
            "failures": sum(a.probe_failures for a in self.agents.values()),
            "opened": sum(a.breakers.opened for a in self.agents.values()),
            "open_now": sum(a.breakers.open_count() for a in self.agents.values()),
        }


def run_gossip_cell(cell: Cell, seed: int) -> dict:
    before = retry_ledger().snapshot()
    cluster = _GossipCluster()
    cluster.tick(2)  # converge pre-fault
    base = cluster.totals()
    # Latency rules ride the plane's injected no-op sleeper: the fake-clock
    # cluster must not block the tool on real sleeps.
    plane = arm(cell.rule, seed, sleeper=lambda s: None)
    try:
        cluster.tick(4)
    finally:
        heal()
    mid = cluster.totals()
    cluster.tick(15)
    after = cluster.totals()
    # Service counters: a probe round trip is the "op"; an ack is "good".
    cell.ok_ops = after["acks"] - base["acks"]
    cell.total_ops = after["probes"] - base["probes"]
    # Integrity for a control-plane seam: no false deaths, full re-convergence.
    alive_everywhere = all(
        a.count_status(ALIVE) == 3 and a.count_status(DEAD) == 0
        for a in cluster.agents.values()
    )
    if not alive_everywhere:
        cell.corruptions += 1
    if cell.kind in ("error", "flaky"):
        drill_ok, cell.evidence["drill"] = breaker_drill(cell.site, cell.rule, seed)
        live_ok = after["opened"] >= 1 and after["open_now"] == 0
        cell.breaker_ok = drill_ok and live_ok
    cell.evidence["cluster"] = {
        "fault_phase": {k: mid[k] - base[k] for k in base},
        "total": {k: after[k] - base[k] for k in base},
        "alive_everywhere": alive_everywhere,
    }
    return cell.verdict(ledger_delta(before), plane.snapshot())


# -------------------------------------------------------------- device harness
class DeviceHarness:
    """A non-started ``WindowBatcher`` over the port's GCM transform backend:
    the fast path is parked so every submit queues, and ``flush_now`` on
    the tool thread drives the merged launch (and its bounded re-dispatch)
    deterministically (the test-suite idiom), on the configured device."""

    def __init__(self) -> None:
        import numpy as np

        from tieredstorage_tpu_torch.security.aes import (
            IV_SIZE,
            TAG_SIZE,
            AesEncryptionProvider,
        )
        from tieredstorage_tpu_torch.transform.api import TransformOptions
        from tieredstorage_tpu_torch.transform.batcher import WindowBatcher
        from tieredstorage_tpu_torch.transform.cuda import CudaTransformBackend

        self.np = np
        self.iv_size, self.tag_size = IV_SIZE, TAG_SIZE
        self.dk = AesEncryptionProvider.create_data_key_and_aad()
        self.backend = CudaTransformBackend()
        self.backend.configure({"device": DEVICE["name"]})
        self.batcher = WindowBatcher(
            self.backend, wait_ms=5.0, max_windows=4,
            launch_attempts=2, launch_backoff_s=0.0,
        )
        rng = random.Random(424242)
        self.chunks = [
            bytes(rng.getrandbits(8) for _ in range(512)) for _ in range(4)
        ]
        ivs = [(i + 1).to_bytes(4, "big") * 3 for i in range(4)]
        self.wire = self.backend.transform(
            self.chunks, TransformOptions(encryption=self.dk, ivs=ivs)
        )

    def close(self) -> None:
        self.backend.close()

    def round(self, deadline_s: float | None = None,
              timeout_s: float = 60.0) -> tuple[str, object]:
        """One queued window through a merged flush: ('ok', plaintext),
        ('error', exc), or ('hang', None)."""
        np = self.np
        ivs = np.stack(
            [np.frombuffer(c[: self.iv_size], np.uint8) for c in self.wire]
        )
        tags = [c[-self.tag_size:] for c in self.wire]
        sizes = [len(c) - self.iv_size - self.tag_size for c in self.wire]
        payloads = [c[self.iv_size: -self.tag_size] for c in self.wire]
        with self.batcher._cond:
            self.batcher._inflight += 1  # park the inline fast path
        box: list = [None, None]

        def submit() -> None:
            try:
                scope = (
                    deadline_scope(Deadline.after(deadline_s))
                    if deadline_s is not None else contextlib.nullcontext()
                )
                with scope:
                    box[0] = self.batcher.submit(
                        self.dk, payloads, sizes, ivs, tags
                    )
            except BaseException as exc:  # noqa: BLE001 - reported upward
                box[1] = exc

        thread = threading.Thread(target=submit, daemon=True)
        thread.start()
        queued_by = time.monotonic() + 10.0
        while time.monotonic() < queued_by:
            with self.batcher._cond:
                if sum(len(v) for v in self.batcher._buckets.values()) >= 1:
                    break
            time.sleep(0.001)
        self.batcher.flush_now()
        thread.join(timeout=timeout_s)
        with self.batcher._cond:
            self.batcher._inflight -= 1
        if thread.is_alive():
            return "hang", None
        if box[1] is not None:
            return "error", box[1]
        return "ok", box[0]


def run_device_cell(device: DeviceHarness, cell: Cell, seed: int) -> dict:
    before = retry_ledger().snapshot()

    def round_ok(deadline_s: float | None = None) -> bool:
        status, result = device.round(deadline_s=deadline_s)
        if status == "hang":
            cell.count(False)
            cell.evidence["hang"] = True
            return False
        if status == "error":
            cell.count(False)
            return False
        if result != device.chunks:
            cell.corruptions += 1
            cell.count(False)
            return False
        cell.count(True)
        return True

    plane = arm(cell.rule, seed)
    try:
        for _ in range(2):
            round_ok()
        t0 = time.monotonic()
        round_ok(deadline_s=1.0)
        cell.shed_wall_s = time.monotonic() - t0
    finally:
        heal()
    for _ in range(4):
        round_ok()
    if cell.kind in ("error", "flaky"):
        cell.breaker_ok, cell.evidence["drill"] = breaker_drill(
            cell.site, cell.rule, seed
        )
    cell.evidence["batcher"] = {
        "launches": device.batcher.launches,
        "launch_failures": device.batcher.launch_failures,
        "launch_retries": device.batcher.launch_retries,
    }
    if cell.kind == "flaky" and device.batcher.launch_retries < 1:
        # The whole point of the flaky cell: the bounded re-dispatch
        # absorbed the transient, visibly.
        cell.evidence["retry_absorbed"] = False
        cell.count(False)
    return cell.verdict(ledger_delta(before), plane.snapshot())


# ----------------------------------------------------------- lifecycle harness
class _Kill(BaseException):
    """Escapes ``except Exception`` in copy_log_segment_data: the tool's
    in-process SIGKILL stand-in (same idiom as tests/test_recovery_sweeper)."""


class LifecycleHarness:
    """An RSM with the crash-consistent lifecycle plane armed (intent
    journal + recovery sweeper) over ``InMemoryStorage``.  Ops are whole
    copy→fetch round trips; the recovery phase of every lifecycle cell runs
    the kill-mid-copy drill at all three upload stages and gates each on
    one sweep converging the store to the manifest-reachable set."""

    PREFIX = "lifecycle/"

    def __init__(self, workdir: pathlib.Path) -> None:
        self.workdir = workdir
        self.rsm = RemoteStorageManager()
        self.rsm.configure({
            "storage.backend.class": "tieredstorage_tpu_torch.storage.memory.InMemoryStorage",
            "transform.device": DEVICE["name"],
            "chunk.size": CHUNK_SIZE,
            "key.prefix": self.PREFIX,
            "lifecycle.enabled": True,
            "lifecycle.journal.path": str(workdir / "intent-journal.jsonl"),
            "lifecycle.sweep.on.start": False,
            "lifecycle.sweep.interval.ms": 3_600_000,
            "lifecycle.grace.ms": 3_600_000,
        })
        self._next_tag = 1

    def close(self) -> None:
        self.rsm.close()

    def segment(self) -> tuple:
        tag = self._next_tag
        self._next_tag += 1
        return make_segment(self.workdir, tag)

    def _listing(self) -> list[str]:
        return sorted(
            k.value for k in self.rsm._storage.list_objects(self.PREFIX)
        )

    def _manifest_reachable(self) -> list[str]:
        present = set(self._listing())
        reachable = set()
        for key in present:
            if key.endswith(".rsm-manifest"):
                stem = key[: -len(".rsm-manifest")]
                reachable.update(
                    k for k in (key, stem + ".log", stem + ".indexes")
                    if k in present
                )
        return sorted(reachable)

    def copy_fetch_ok(self, cell: Cell) -> bool:
        metadata, data, original = self.segment()
        try:
            self.rsm.copy_log_segment_data(metadata, data)
            with self.rsm.fetch_log_segment(metadata, 0) as s:
                got = s.read()
        except Exception:  # noqa: BLE001 - clean failure is the contract
            cell.count(False)
            return False
        if got != original:
            cell.corruptions += 1
            cell.count(False)
            return False
        cell.count(True)
        return True

    def sweep_ok(self, cell: Cell) -> bool:
        try:
            self.rsm.recovery_sweeper.sweep_once()
        except Exception:  # noqa: BLE001 - clean failure is the contract
            cell.count(False)
            return False
        cell.count(True)
        return True

    def crash_drill_ok(self, cell: Cell, kill_call: int,
                       torn_bytes: int | None) -> bool:
        """kill -9 mid-copy at upload #``kill_call`` (optionally landing a
        torn object first), then the gate: ONE recovery sweep leaves zero
        permanent orphans (listing == manifest-reachable set, no pending
        intent) and the retried copy round-trips byte-identically."""
        metadata, data, original = self.segment()
        real_upload = self.rsm._storage.upload
        calls = [0]

        def dying_upload(stream, key):
            calls[0] += 1
            if calls[0] == kill_call:
                if torn_bytes is not None:
                    real_upload(io.BytesIO(stream.read()[:torn_bytes]), key)
                raise _Kill(f"kill -9 during upload #{kill_call}")
            return real_upload(stream, key)

        self.rsm._storage.upload = dying_upload
        try:
            try:
                self.rsm.copy_log_segment_data(metadata, data)
            except _Kill:
                pass
            except Exception:  # noqa: BLE001 - journal faults preempt the kill
                cell.count(False)
                return False
            else:
                cell.count(False)  # the kill did not fire: not a drill
                return False
        finally:
            self.rsm._storage.upload = real_upload
        if not self.sweep_ok(cell):
            return False
        if (self._listing() != self._manifest_reachable()
                or self.rsm.lifecycle_journal.pending()):
            cell.corruptions += 1  # permanent orphan / unresolved intent
            cell.count(False)
            return False
        try:
            self.rsm.copy_log_segment_data(metadata, data)  # the retry
            self.rsm.recovery_sweeper.sweep_once()  # heals any quarantine
            with self.rsm.fetch_log_segment(metadata, 0) as s:
                got = s.read()
        except Exception:  # noqa: BLE001 - clean failure is the contract
            cell.count(False)
            return False
        if got != original:
            cell.corruptions += 1
            cell.count(False)
            return False
        cell.count(True)
        return True

    def evidence(self) -> dict:
        sweeper = self.rsm.recovery_sweeper
        return {
            "journal": self.rsm.lifecycle_journal.status(),
            "sweeper": {
                "sweeps": sweeper.sweeps,
                "orphans_deleted_total": sweeper.orphans_deleted_total,
                "quarantines_total": sweeper.quarantines_total,
                "journal_resolved_total": sweeper.journal_resolved_total,
                "invariant_blocks_total": sweeper.invariant_blocks_total,
                "sweep_failures_total": sweeper.sweep_failures_total,
            },
        }


#: (kill at upload #N, torn bytes): after .log, after .indexes, mid-manifest.
CRASH_STAGES = ((2, None), (3, None), (3, 17))


def run_lifecycle_cell(lc: LifecycleHarness, cell: Cell, seed: int) -> dict:
    before = retry_ledger().snapshot()
    plane = arm(cell.rule, seed)
    try:
        for _ in range(3):
            lc.copy_fetch_ok(cell)
        lc.sweep_ok(cell)  # the lifecycle.sweep cells fail HERE, cleanly
        t0 = time.monotonic()
        with deadline_scope(Deadline.after_ms(250)):
            lc.copy_fetch_ok(cell)
        cell.shed_wall_s = time.monotonic() - t0
    finally:
        heal()
    # Recovery: the crash matrix — kill at each upload stage x one sweep.
    drills_ok = all(
        [lc.crash_drill_ok(cell, kill_call, torn)
         for kill_call, torn in CRASH_STAGES]
    )
    cell.evidence["crash_drills_ok"] = drills_ok
    for _ in range(2):
        lc.copy_fetch_ok(cell)
    if cell.kind in ("error", "flaky"):
        cell.breaker_ok, cell.evidence["drill"] = breaker_drill(
            cell.site, cell.rule, seed
        )
    if not drills_ok:
        cell.corruptions += 1  # a failed drill is an integrity failure
    cell.evidence["lifecycle"] = lc.evidence()
    return cell.verdict(ledger_delta(before), plane.snapshot())


# ------------------------------------------------------------------ self-checks
def determinism_check(seed: int) -> bool:
    """Same seed + same call sequence => identical injection schedule."""

    def run_once() -> list:
        plane = faults.FaultPlane.parse(
            "storage.read:error@p=0.4; storage.read:latency=1@p=0.5",
            seed=seed, sleeper=lambda s: None,
        )
        for i in range(40):
            try:
                plane.fire("storage.read", f"k{i}")
            except faults.FaultInjectedError:
                pass
        return [tuple(x) for x in plane.injections]

    first, second = run_once(), run_once()
    return bool(first) and first == second


def disarmed_check() -> bool:
    """With no plane installed the seam hook is zero work: no counters, no
    injections, None back."""
    return (
        not faults.enabled()
        and faults.fire("storage.read", "post-matrix") is None
        and faults.mutate(b"abc", None) == b"abc"
    )


# ------------------------------------------------------------------------ main
def run_matrix(out_path: pathlib.Path, seed: int, device: str = "cuda:0") -> dict:
    from tieredstorage_tpu_torch.ops import _cuda

    if faults.plane() is not None:
        raise SystemExit("a fault plane is already installed; refusing to run")
    DEVICE["name"] = device
    launches_before = _cuda.launch_counts()
    say(f"{len(CELLS)} cells, seed {seed}, device {device}")
    determinism = determinism_check(seed)
    say(f"determinism self-check: {'ok' if determinism else 'FAILED'}")

    cells: list[dict] = []
    with tempfile.TemporaryDirectory(prefix="torch-chaos-matrix-") as tmp:
        workdir = pathlib.Path(tmp)
        (workdir / "storage").mkdir(exist_ok=True)
        storage = StorageHarness(workdir / "storage")
        device: DeviceHarness | None = None
        lifecycle: LifecycleHarness | None = None
        try:
            for site, kind, rule in CELLS:
                cell = Cell(site, kind, rule)
                if site == "storage.read":
                    result = run_storage_read_cell(storage, cell, seed)
                elif site == "storage.write":
                    result = run_storage_write_cell(storage, cell, seed)
                elif site == "peer.forward":
                    result = run_peer_cell(cell, seed)
                elif site == "gossip.probe":
                    result = run_gossip_cell(cell, seed)
                elif site.startswith("lifecycle."):
                    if lifecycle is None:
                        lifecycle_dir = workdir / "lifecycle"
                        lifecycle_dir.mkdir(exist_ok=True)
                        lifecycle = LifecycleHarness(lifecycle_dir)
                    result = run_lifecycle_cell(lifecycle, cell, seed)
                else:
                    if device is None:
                        device = DeviceHarness()
                    result = run_device_cell(device, cell, seed)
                cells.append(result)
                gates = " ".join(
                    f"{name}={'-' if v is None else ('ok' if v else 'FAIL')}"
                    for name, v in result["gates"].items()
                )
                say(f"{site} x {kind}: {'ok' if result['ok'] else 'FAIL'} [{gates}]")
        finally:
            heal()
            if device is not None:
                device.close()
            if lifecycle is not None:
                lifecycle.close()
            storage.rsm.close()
    disarmed = disarmed_check()
    say(f"disarmed zero-work check: {'ok' if disarmed else 'FAILED'}")

    report = {
        "seed": seed,
        "device": DEVICE["name"],
        "launches": {k: v - launches_before.get(k, 0)
                     for k, v in _cuda.launch_counts().items()},
        "determinism": determinism,
        "disarmed": disarmed,
        "cells": cells,
        "ok": determinism and disarmed and all(c["ok"] for c in cells),
    }
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=2, sort_keys=True) + "\n")
    validate_report(out_path)
    say(f"report written + re-validated: {out_path}")
    return report


def validate_report(path: pathlib.Path) -> None:
    """Re-read the artifact and re-derive the top-level verdict."""
    report = json.loads(path.read_text())
    for field in ("seed", "determinism", "disarmed", "cells", "ok"):
        if field not in report:
            raise SystemExit(f"report missing field {field!r}")
    expected = {(site, kind) for site, kind, _ in CELLS}
    got = {(c["site"], c["kind"]) for c in report["cells"]}
    if got != expected:
        raise SystemExit(f"report cell set mismatch: missing {expected - got}")
    for c in report["cells"]:
        for gate in ("integrity", "amplification", "breaker", "shed", "slo"):
            if gate not in c["gates"]:
                raise SystemExit(f"cell {c['site']}x{c['kind']} missing gate {gate!r}")
    rederived = (
        report["determinism"] and report["disarmed"]
        and all(c["ok"] for c in report["cells"])
    )
    if rederived != report["ok"]:
        raise SystemExit("report verdict does not re-derive from its cells")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--out", default="artifacts/torch_chaos_matrix_report.json",
        help="report path (default: artifacts/torch_chaos_matrix_report.json)",
    )
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--device", default="cuda:0",
                        help="cuda:N (default cuda:0) or cpu for the plain versions")
    args = parser.parse_args(argv)
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("torch_chaos_matrix: CUDA is not available; pass --device cpu to run "
              "the plain versions on the CPU", file=sys.stderr)
        return 2
    report = run_matrix(pathlib.Path(args.out), args.seed, args.device)
    failed = [c for c in report["cells"] if not c["ok"]]
    if report["ok"]:
        say(f"ALL {len(report['cells'])} cells passed")
        return 0
    say(f"{len(failed)} cell(s) FAILED: "
        + ", ".join(f"{c['site']}x{c['kind']}" for c in failed))
    return 1


if __name__ == "__main__":
    sys.exit(main())
