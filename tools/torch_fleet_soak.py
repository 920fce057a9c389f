"""Fleet soak of the PyTorch/CUDA port: real sidecar processes, gossip
membership, and a kill -9.

Counterpart of tools/fleet_soak.py over `tieredstorage_tpu_torch`, with its
seed, instances, ring, gossip timing, load, kill, fault rule, bounds and
checks. It launches three real port sidecar processes (``python -m
tieredstorage_tpu_torch.sidecar --http-port N --fleet-peers ...``) over one
shared filesystem store, each with `transform.device` `cuda:0` (or the CPU
with `--device cpu`), joins them into a gossip-membership fleet (250 ms
periods) with R=2 replicated ownership, drives a seeded Zipfian fetch load
through their HTTP gateways, then ``SIGKILL``s one instance mid-load and
later restarts it.

Gates (all recorded in ``artifacts/torch_fleet_soak_report.json``):

1. **Zero byte diffs**: every fetched range, before, during and after the
   kill and the rejoin, matches the uploaded source bytes (requests that
   hit the dying gateway are retried against survivors, like any
   load-balanced client).
2. **Bounded gossip convergence**: survivors converge to the post-kill
   view within ``suspect.periods + dead.periods + 8`` protocol periods,
   and back to the full view after the restart within the same bound
   (each survivor's own period counter, via ``GET /fleet/ping``).
3. **No cache arc lost (R=2)**: segments first touched after the kill fail
   over to their surviving replica owner (``failover_hits`` > 0), and a
   repeat pass over them is served by the cache tier (rate >= 0.9).
4. **Zero witness violations**: every process runs with
   ``TSTPU_LOCK_WITNESS=1``; at the end each process reports zero lock and
   zero race violations (``GET /fleet/ping?witness=1``).
5. **Crash-consistent copy**: the victim dies with a copy in flight, its
   manifest write stalled by ``storage.write:latency~.rsm-manifest``; after
   the restart its journal-led startup sweep leaves zero permanent orphans
   (the store's listing equals its manifest-reachable set).

Every check is the JAX gate's own, in the same terms: none needed a torch
counterpart. Each child waits up to 60 s to print ``SIDECAR_READY``, as
the JAX gate's do. The store holds plain bytes, so the children run no
kernel; on the card each child's RSM still lives on `cuda:0`.

    python3 tools/torch_fleet_soak.py --out artifacts/torch_fleet_soak_report.json
    python3 tools/torch_fleet_soak.py --device cpu

Without CUDA, and without `--device cpu`, it exits 2 and runs nothing.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import pathlib
import random
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))

from tieredstorage_tpu_torch.metadata import (  # noqa: E402
    KafkaUuid,
    LogSegmentData,
    RemoteLogSegmentId,
    RemoteLogSegmentMetadata,
    TopicIdPartition,
    TopicPartition,
)
from tieredstorage_tpu_torch.fleet import HashRing  # noqa: E402
from tieredstorage_tpu_torch.object_key import ObjectKeyFactory, Suffix  # noqa: E402
from tieredstorage_tpu_torch.sidecar import shimwire  # noqa: E402

CHUNK = 4096
CHUNKS_PER_SEGMENT = 8
#: Segments fetched before the kill (warm everywhere) vs. first touched
#: after it (the ordered-owner failover evidence).
WARM_SEGMENTS = 4
COLD_SEGMENTS = 2
SEGMENTS = WARM_SEGMENTS + COLD_SEGMENTS
INSTANCES = ("s0", "s1", "s2")
VNODES = 64
REPLICATION = 2
KEY_PREFIX = "fleetsoak/"
SEED = 20260805

GOSSIP_INTERVAL_MS = 250
SUSPECT_PERIODS = 3
DEAD_PERIODS = 3
#: Extra protocol periods allowed on top of suspect+dead for probe
#: rotation, HTTP timing, and the last pre-kill heartbeat's age.
CONVERGENCE_SLACK = 8
CONVERGENCE_BOUND = SUSPECT_PERIODS + DEAD_PERIODS + CONVERGENCE_SLACK

WARM_REQUESTS = 90
KILL_PHASE_REQUESTS = 60
RECOVERY_REQUESTS = 60
FINAL_REQUESTS = 45


def free_ports(n: int) -> list[int]:
    """Reserve n distinct free loopback ports (bind-then-release; the gap
    until the sidecar re-binds is the usual pre-fork race, fine for CI)."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def make_segment(i: int, tmp: pathlib.Path):
    payload = b"".join(
        b"soak seg=%02d off=%012d zipfian-fetch-body|" % (i, j)
        for j in range(CHUNK * CHUNKS_PER_SEGMENT // 40 + 1)
    )[: CHUNK * CHUNKS_PER_SEGMENT]
    seg = tmp / f"{i:020d}.log"
    seg.write_bytes(payload)
    (tmp / f"{i}.index").write_bytes(b"\x00" * 64)
    (tmp / f"{i}.timeindex").write_bytes(b"\x00" * 32)
    (tmp / f"{i}.snapshot").write_bytes(b"\x00" * 16)
    tip = TopicIdPartition(KafkaUuid(b"\x0e" * 16), TopicPartition("fleetsoak", 0))
    metadata = RemoteLogSegmentMetadata(
        remote_log_segment_id=RemoteLogSegmentId(tip, KafkaUuid(bytes([i + 1]) * 16)),
        start_offset=i * 1000,
        end_offset=i * 1000 + 999,
        segment_size_in_bytes=len(payload),
    )
    data = LogSegmentData(
        log_segment=seg,
        offset_index=tmp / f"{i}.index",
        time_index=tmp / f"{i}.timeindex",
        producer_snapshot_index=tmp / f"{i}.snapshot",
        transaction_index=None,
        leader_epoch_index=b"epoch-checkpoint",
    )
    return metadata, data, payload


class Sidecar:
    """One real sidecar process plus the harness's view of it."""

    def __init__(self, name: str, config_path: pathlib.Path, http_port: int,
                 peers_arg: str, log_path: pathlib.Path):
        self.name = name
        self.config_path = config_path
        self.http_port = http_port
        self.peers_arg = peers_arg
        self.log_path = log_path
        self.proc: subprocess.Popen | None = None
        #: Log offset at the latest launch — a restart appends to the same
        #: log, so readiness must only match output of THIS incarnation.
        self._log_offset = 0

    def launch(self) -> None:
        self._log_offset = (
            self.log_path.stat().st_size if self.log_path.exists() else 0
        )
        env = dict(os.environ)
        env.update({
            "TSTPU_LOCK_WITNESS": "1",
            "TSTPU_RACE_SAMPLE": "1",
            "PYTHONPATH": str(REPO_ROOT),
            "PYTHONUNBUFFERED": "1",
        })
        log_file = open(self.log_path, "ab")
        self.proc = subprocess.Popen(
            [
                sys.executable, "-m", "tieredstorage_tpu_torch.sidecar",
                "--config", str(self.config_path),
                "--port", "0",
                "--http-port", str(self.http_port),
                "--fleet-peers", self.peers_arg,
            ],
            cwd=str(REPO_ROOT), env=env,
            stdout=log_file, stderr=subprocess.STDOUT,
        )
        log_file.close()

    def wait_ready(self, timeout_s: float = 60.0) -> None:
        """Scrape SIDECAR_READY from the process log (stdout is redirected
        to a file so the process can never block on a full pipe)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"{self.name} exited rc={self.proc.returncode}:\n"
                    + self.log_path.read_text()[-2000:]
                )
            if b"SIDECAR_READY" in self.log_path.read_bytes()[self._log_offset:]:
                return
            time.sleep(0.05)
        raise RuntimeError(f"{self.name} never printed SIDECAR_READY")

    def sigkill(self) -> None:
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=30)

    def stop(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)


def http_fetch(port: int, metadata, start: int, end, *, timeout: float = 30.0):
    body = shimwire.encode_metadata(metadata) + shimwire.encode_fetch_tail(start, end)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/v1/fetch", body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def ping(port: int, *, witness: bool = False, timeout: float = 30.0) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", "/fleet/ping" + ("?witness=1" if witness else ""))
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"ping {resp.status}: {body[:200]!r}")
        return json.loads(body)
    finally:
        conn.close()


def await_view(ports: dict[str, int], expect_ring: set[str], *,
               periods_bound: int, label: str) -> dict[str, int]:
    """Poll every live member's /fleet/ping until its ring equals
    `expect_ring`, asserting each converges within `periods_bound` gossip
    periods of its own counter. Returns periods-taken per member."""
    baseline = {n: ping(p)["gossip"]["periods"] for n, p in ports.items()}
    taken: dict[str, int] = {}
    hard_deadline = time.monotonic() + 120.0
    pending = dict(ports)
    while pending:
        if time.monotonic() > hard_deadline:
            raise AssertionError(
                f"{label}: {sorted(pending)} never reached view "
                f"{sorted(expect_ring)}"
            )
        for name, port in list(pending.items()):
            status = ping(port)
            if set(status["ring_instances"]) == expect_ring:
                taken[name] = status["gossip"]["periods"] - baseline[name]
                del pending[name]
        time.sleep(GOSSIP_INTERVAL_MS / 1000.0 / 4)
    for name, periods in taken.items():
        assert periods <= periods_bound, (
            f"{label}: {name} took {periods} gossip periods to converge, "
            f"bound is {periods_bound}"
        )
    return taken


def run(out_path: pathlib.Path, device: str = "cuda:0") -> int:
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="torch-fleet-soak-"))
    print(f"torch-fleet-soak scratch: {tmp}", flush=True)
    store = tmp / "store"
    store.mkdir()

    segments = [make_segment(i, tmp) for i in range(SEGMENTS)]

    # Upload through an in-process loader RSM so the children start with a
    # fully-populated shared store and clean serving-side counters.
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager

    loader = RemoteStorageManager()
    loader.configure({
        "storage.backend.class":
            "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        "storage.root": str(store),
        "chunk.size": CHUNK,
        "key.prefix": KEY_PREFIX,
        "transform.device": device,
    })
    for md, data, _ in segments:
        loader.copy_log_segment_data(md, data)
    loader.close()

    # The ring is a pure function of names + vnodes, so the victim is known
    # BEFORE launch — which lets its config carry the manifest-write
    # stall (gate 5) from the first boot.
    ring = HashRing(INSTANCES, VNODES)
    key_factory = ObjectKeyFactory(KEY_PREFIX, False)
    primer_seg = WARM_SEGMENTS
    primer_key = key_factory.key(segments[primer_seg][0], Suffix.LOG).value
    victim, second_owner = ring.owners(primer_key, REPLICATION)

    ports = dict(zip(INSTANCES, free_ports(len(INSTANCES))))
    peers_arg = ",".join(f"{n}=http://127.0.0.1:{p}" for n, p in ports.items())
    sidecars: dict[str, Sidecar] = {}
    for name in INSTANCES:
        config = {
            "storage.backend.class":
                "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
            "storage.root": str(store),
            "chunk.size": CHUNK,
            "key.prefix": KEY_PREFIX,
            "transform.device": device,
            "fetch.chunk.cache.class":
                "tieredstorage_tpu_torch.fetch.cache.memory.MemoryChunkCache",
            "fetch.chunk.cache.size": -1,
            "fetch.chunk.cache.thread.pool.size": 8,
            "fleet.enabled": True,
            "fleet.instance.id": name,
            "fleet.vnodes": VNODES,
            "fleet.replication.factor": REPLICATION,
            "fleet.gossip.enabled": True,
            "fleet.gossip.interval.ms": GOSSIP_INTERVAL_MS,
            "fleet.gossip.probe.timeout.ms": 200,
            "fleet.gossip.suspect.periods": SUSPECT_PERIODS,
            "fleet.gossip.dead.periods": DEAD_PERIODS,
            "fleet.peer.down.cooldown.ms": 1_000,
            "deadline.default.ms": 15_000,
            # Empty schedule: injection is enabled ONLY for its per-op call
            # counter, which /fleet/ping exports as storage_fetch_calls —
            # the cross-process ground truth for "did this read hit the
            # backend or a cache tier".
            "fault.injection.enabled": True,
            "fault.schedule": [],
            # Every member journals its uploads and sweeps on
            # start. The huge interval/grace means the ONLY sweep that can
            # delete the drill's stranded objects is the victim's own
            # journal-led startup recovery after the restart.
            "lifecycle.enabled": True,
            "lifecycle.journal.path": str(tmp / f"{name}-journal.jsonl"),
            "lifecycle.sweep.interval.ms": 3_600_000,
            "lifecycle.grace.ms": 3_600_000,
        }
        if name == victim:
            # Stall ONLY the manifest write (the sole commit point), so the
            # kill -9 lands after .log/.indexes but before the commit.
            config["faults.spec"] = [
                "storage.write:latency=120000~.rsm-manifest"
            ]
        config_path = tmp / f"{name}.json"
        config_path.write_text(json.dumps(config, indent=1))
        sidecars[name] = Sidecar(
            name, config_path, ports[name], peers_arg, tmp / f"{name}.log"
        )

    report: dict = {
        "device": device,
        "instances": list(INSTANCES),
        "replication_factor": REPLICATION,
        "gossip": {
            "interval_ms": GOSSIP_INTERVAL_MS,
            "suspect_periods": SUSPECT_PERIODS,
            "dead_periods": DEAD_PERIODS,
            "convergence_bound_periods": CONVERGENCE_BOUND,
        },
    }
    byte_diffs = 0
    retried_requests = 0
    rng = random.Random(SEED)

    def backend_fetches(names) -> int:
        return sum(ping(ports[n])["storage_fetch_calls"] for n in names)

    def zipf_pass(n_requests: int, segment_ids, alive: list[str],
                  victim: str | None = None) -> int:
        """Seeded Zipfian fetch load round-robined over `alive` gateways;
        returns how many requests had to be retried on a survivor (the
        victim dying mid-request). Byte-diffs accumulate in the outer
        counter."""
        nonlocal byte_diffs, retried_requests
        population = [
            (s, c) for s in segment_ids for c in range(CHUNKS_PER_SEGMENT)
        ]
        weights = [1.0 / (rank + 1) ** 1.2 for rank in range(len(population))]
        retries = 0
        for i in range(n_requests):
            seg, chunk = population[
                rng.choices(range(len(population)), weights=weights)[0]
            ]
            md, _, payload = segments[seg]
            start = chunk * CHUNK
            end = min(start + CHUNK - 1, len(payload) - 1)
            target = alive[i % len(alive)]
            try:
                status, got = http_fetch(ports[target], md, start, end)
            except OSError:
                # The gateway died under us (that IS the drill): retry on a
                # survivor, exactly like a load-balanced client would.
                if victim is None:
                    raise
                survivor = next(n for n in alive if n != victim)
                status, got = http_fetch(ports[survivor], md, start, end)
                retries += 1
                retried_requests += 1
            assert status == 200, f"fetch via {target} failed: {status}"
            if got != payload[start : end + 1]:
                byte_diffs += 1
        return retries

    try:
        for sidecar in sidecars.values():
            sidecar.launch()
        for sidecar in sidecars.values():
            sidecar.wait_ready()

        # Every member must agree on the full ring before load starts.
        await_view(
            ports, set(INSTANCES),
            periods_bound=CONVERGENCE_BOUND, label="bootstrap",
        )

        # ------------------------------------------------ phase 1: warm load
        warm_ids = list(range(WARM_SEGMENTS))
        zipf_pass(WARM_REQUESTS, warm_ids, list(INSTANCES))
        warm_backend = backend_fetches(INSTANCES)
        report["warm"] = {
            "requests": WARM_REQUESTS,
            "backend_fetches": warm_backend,
        }

        # --------------------------------------- phase 2: kill -9 mid-load
        # The victim was picked deterministically above as the first owner
        # of the first cold segment: reads of that segment right after the
        # kill (before gossip re-rings) MUST fail over to its second
        # replica owner — the R=2 guarantee under test.
        survivors = [n for n in INSTANCES if n != victim]
        primer_client = next(n for n in survivors if n != second_owner)
        kill_at = KILL_PHASE_REQUESTS // 3

        # First third of the phase still includes the victim in rotation.
        zipf_pass(kill_at, warm_ids, list(INSTANCES))

        # The lifecycle drill: die with a copy IN FLIGHT. The victim's config
        # stalls manifest writes, so this /v1/copy uploads .log and
        # .indexes, then parks on the commit point — the SIGKILL below
        # lands exactly in the torn-upload window the intent journal covers.
        drill_md, drill_data, _ = make_segment(SEGMENTS, tmp)
        drill_keys = {
            suffix: key_factory.key(drill_md, suffix).value
            for suffix in (Suffix.LOG, Suffix.INDEXES, Suffix.MANIFEST)
        }
        drill_body = shimwire.encode_metadata(drill_md) + shimwire.encode_sections({
            "log_segment": drill_data.log_segment.read_bytes(),
            "offset_index": drill_data.offset_index.read_bytes(),
            "time_index": drill_data.time_index.read_bytes(),
            "producer_snapshot": drill_data.producer_snapshot_index.read_bytes(),
            "transaction_index": None,
            "leader_epoch_index": drill_data.leader_epoch_index,
        })
        drill_errors: list[BaseException] = []

        def _drill_copy() -> None:
            try:
                conn = http.client.HTTPConnection(
                    "127.0.0.1", ports[victim], timeout=300.0
                )
                conn.request("POST", "/v1/copy", body=drill_body)
                conn.getresponse().read()
            except OSError:
                pass  # the kill -9 severs this connection — expected
            except BaseException as exc:  # diagnostics for the report
                drill_errors.append(exc)

        def _in_store(key: str) -> bool:
            return (store / key).exists()

        copy_thread = threading.Thread(target=_drill_copy, daemon=True)
        copy_thread.start()
        # Only kill once the copy is demonstrably MID-FLIGHT: .log and
        # .indexes durable in the shared store, manifest parked on the stall.
        drill_deadline = time.monotonic() + 60.0
        while not (_in_store(drill_keys[Suffix.LOG])
                   and _in_store(drill_keys[Suffix.INDEXES])):
            assert time.monotonic() < drill_deadline, (
                "drill copy never reached mid-flight (no stranded objects)"
            )
            time.sleep(0.05)
        assert not _in_store(drill_keys[Suffix.MANIFEST]), (
            "drill manifest committed before the kill — the stall rule is inert"
        )
        stranded = sorted(
            (drill_keys[Suffix.LOG], drill_keys[Suffix.INDEXES])
        )
        sidecars[victim].sigkill()
        kill_wall = time.monotonic()
        copy_thread.join(timeout=30.0)
        # Ordered-owner failover, in the window BEFORE gossip re-rings:
        # a non-owner's forward to the dead first owner fails (peer marked
        # down), the next owner serves — one extra hop, no cache arc lost.
        primer_md, _, primer_payload = segments[primer_seg]
        status, got = http_fetch(ports[primer_client], primer_md, 0, CHUNK - 1)
        assert status == 200, f"failover primer failed: {status}"
        if got != primer_payload[:CHUNK]:
            byte_diffs += 1
        primer_failover_hits = ping(ports[primer_client])["peer_cache"][
            "failover_hits"
        ]
        assert primer_failover_hits >= 1, (
            "first-owner death did not fail over to the second replica owner"
        )
        # The remaining load continues immediately — against the full
        # rotation for one request (exercising the mid-flight retry path),
        # then the survivors.
        zipf_pass(1, warm_ids, list(INSTANCES), victim=victim)
        zipf_pass(KILL_PHASE_REQUESTS - kill_at - 1, warm_ids, survivors)
        survivor_ports = {n: ports[n] for n in survivors}
        converged = await_view(
            survivor_ports, set(survivors),
            periods_bound=CONVERGENCE_BOUND, label="post-kill",
        )
        report["kill"] = {
            "victim": victim,
            "signal": "SIGKILL",
            "mid_load_retries": retried_requests,
            "convergence_periods": converged,
            "convergence_wall_s": round(time.monotonic() - kill_wall, 3),
            "survivor_views": {
                n: ping(p)["ring_instances"] for n, p in survivor_ports.items()
            },
        }

        # --------------------- phase 3: failover onto the replica owners
        # Segments never fetched before the kill: their first-owner may be
        # the dead victim, in which case the read must fail over to the
        # NEXT ring owner (one extra hop at most) — and a repeat pass must
        # then be served by the warmed surviving arc, not the backend.
        cold_ids = list(range(WARM_SEGMENTS, SEGMENTS))
        before_cold = backend_fetches(survivors)
        zipf_pass(RECOVERY_REQUESTS, cold_ids, survivors)
        cold_backend = backend_fetches(survivors) - before_cold
        before_repeat = backend_fetches(survivors)
        zipf_pass(RECOVERY_REQUESTS, cold_ids, survivors)
        repeat_backend = backend_fetches(survivors) - before_repeat
        repeat_rate = 1.0 - repeat_backend / RECOVERY_REQUESTS
        failover_hits = sum(
            ping(p)["peer_cache"]["failover_hits"] for p in survivor_ports.values()
        )
        peer_hits = sum(
            ping(p)["peer_cache"]["peer_hits"] for p in survivor_ports.values()
        )
        report["failover"] = {
            "primer_segment": primer_seg,
            "primer_client": primer_client,
            "second_owner": second_owner,
            "cold_requests": RECOVERY_REQUESTS,
            "cold_backend_fetches": cold_backend,
            "repeat_requests": RECOVERY_REQUESTS,
            "repeat_backend_fetches": repeat_backend,
            "repeat_cache_tier_rate": round(repeat_rate, 4),
            "peer_hits": peer_hits,
            "failover_hits": failover_hits,
        }
        assert repeat_rate >= 0.9, (
            f"cache tier served only {repeat_rate:.0%} of the repeat pass — "
            "the dead instance's arcs were lost"
        )

        # -------------------------------------- phase 4: restart + rejoin
        sidecars[victim].launch()
        sidecars[victim].wait_ready()

        # Gate 5: the victim's journal-led startup sweep (it runs
        # during configure, before SIDECAR_READY) must have erased the torn
        # upload — journal-named orphans are deleted with no grace wait.
        sweep_deadline = time.monotonic() + 30.0
        while any(_in_store(k) for k in stranded):
            assert time.monotonic() < sweep_deadline, (
                "startup recovery sweep left permanent orphans: "
                + repr([k for k in stranded if _in_store(k)])
            )
            time.sleep(0.1)
        # Zero permanent orphans, fleet-wide: the shared store's listing is
        # exactly its manifest-reachable set (each committed segment is the
        # .log/.indexes/.rsm-manifest triple; nothing else survives).
        listing = sorted(
            str(p.relative_to(store)) for p in store.rglob("*") if p.is_file()
        )
        reachable = sorted(
            m[: -len(".rsm-manifest")] + suffix
            for m in listing if m.endswith(".rsm-manifest")
            for suffix in (".log", ".indexes", ".rsm-manifest")
        )
        report["lifecycle_drill"] = {
            "victim": victim,
            "drill_segment": SEGMENTS,
            "manifest_stall_rule": "storage.write:latency=120000~.rsm-manifest",
            "stranded_at_kill": stranded,
            "orphans_after_restart_sweep": [
                k for k in stranded if _in_store(k)
            ],
            "listing_equals_manifest_reachable": listing == reachable,
            "store_objects": len(listing),
            "drill_copy_harness_errors": [repr(e) for e in drill_errors],
        }
        assert listing == reachable, (
            "post-sweep store listing diverges from the manifest-reachable "
            f"set: {sorted(set(listing) ^ set(reachable))}"
        )

        rejoined = await_view(
            ports, set(INSTANCES),
            periods_bound=CONVERGENCE_BOUND, label="rejoin",
        )
        zipf_pass(FINAL_REQUESTS, list(range(SEGMENTS)), list(INSTANCES))
        victim_status = ping(ports[victim])
        report["rejoin"] = {
            "convergence_periods": rejoined,
            "victim_incarnation": max(
                m["incarnation"]
                for name, m in ping(ports[survivors[0]])["gossip"]["members"].items()
                if name == victim
            ),
            "final_requests": FINAL_REQUESTS,
            "victim_view": victim_status["ring_instances"],
        }

        # ------------------------------------------- phase 5: witness gates
        witness_reports = {}
        for name, port in ports.items():
            status = ping(port, witness=True, timeout=120.0)
            witness_reports[name] = status["witness"]
        report["witness"] = witness_reports
        for name, w in witness_reports.items():
            assert w["enabled"], f"{name} ran without the lock witness armed"
            assert w["lock_violations"] == [], (
                f"{name} lock-order violations: {w['lock_violations']}"
            )
            assert w["race_violations"] == [], (
                f"{name} guarded-by violations: {w['race_violations']}"
            )

        report["byte_diffs"] = byte_diffs
        report["retried_requests"] = retried_requests
        assert byte_diffs == 0, f"{byte_diffs} responses diverged from source"
    finally:
        for sidecar in sidecars.values():
            sidecar.stop()
    # Kept when a check failed: the members' logs are under it.
    shutil.rmtree(tmp, ignore_errors=True)

    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=1))

    # ------------------------------------------------ artifact re-validation
    parsed = json.loads(out_path.read_text())
    assert parsed["byte_diffs"] == 0
    assert parsed["kill"]["victim"] in parsed["instances"]
    bound = parsed["gossip"]["convergence_bound_periods"]
    assert all(
        p <= bound for p in parsed["kill"]["convergence_periods"].values()
    )
    assert all(
        p <= bound for p in parsed["rejoin"]["convergence_periods"].values()
    )
    assert parsed["failover"]["failover_hits"] >= 1
    assert parsed["failover"]["repeat_cache_tier_rate"] >= 0.9
    assert parsed["rejoin"]["victim_incarnation"] >= 1
    assert all(
        w["lock_violations"] == [] and w["race_violations"] == []
        for w in parsed["witness"].values()
    )
    drill = parsed["lifecycle_drill"]
    assert len(drill["stranded_at_kill"]) >= 2
    assert drill["orphans_after_restart_sweep"] == []
    assert drill["listing_equals_manifest_reachable"] is True
    assert drill["drill_copy_harness_errors"] == []
    print(
        f"TORCH_FLEET_SOAK_OK instances={len(parsed['instances'])} "
        f"killed={parsed['kill']['victim']}(SIGKILL) "
        f"converge_periods={max(parsed['kill']['convergence_periods'].values())} "
        f"rejoin_periods={max(parsed['rejoin']['convergence_periods'].values())} "
        f"failover_hits={parsed['failover']['failover_hits']} "
        f"repeat_cache_rate={parsed['failover']['repeat_cache_tier_rate']} "
        f"lifecycle_orphans={len(drill['orphans_after_restart_sweep'])} "
        f"byte_diffs={parsed['byte_diffs']} out={out_path}"
    )
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--out", default=str(REPO_ROOT / "artifacts" / "torch_fleet_soak_report.json"),
        help="soak report JSON output path",
    )
    parser.add_argument("--device", default="cuda:0",
                        help="cuda:N (default cuda:0) or cpu for the plain versions")
    args = parser.parse_args(argv)
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("torch_fleet_soak: CUDA is not available; pass --device cpu to run "
              "the plain versions on the CPU", file=sys.stderr)
        return 2
    return run(pathlib.Path(args.out), args.device)


if __name__ == "__main__":
    sys.exit(main())
