"""Load harness and SLO chaos gate of the PyTorch/CUDA port: everything at
once, judged by the SLO engine.

Counterpart of tools/load_demo.py over `tieredstorage_tpu_torch`, with its
seed, constants, fleet config, phase order and checks. A seeded closed-loop
Zipfian produce/fetch workload drives a 3-instance fleet (consistent-hash
routing, peer cache, static membership) over a 2-replica filesystem store,
each instance's `transform.device` `cuda:0` (or the CPU with `--device
cpu`), while the chaos schedule kills a storage replica (its directory
vanishes mid-run) and a fleet instance (gateway stopped, survivors re-ring).
Then, in the JAX gate's order: the SLO verdicts, an admission-saturating
overload burst and its recovery, the fleet telemetry, the flight records,
the scrub and anti-entropy daemons' progress inside the chaos window, a
fleet-stitched exemplar timeline, a `PROBE_STREAMS`-stream consumer-replay
capacity probe through the batched decrypt chain against an unbatched
control and with background scrub racing it, a cold-replay readahead A/B,
and the lock and race witness's verdict.

Every check is the JAX gate's own, in the same terms. Where a check names
JAX machinery, its torch counterpart:

- the jit warm-up of the JAX gate (`_stage_packed` / `_launch_packed` over
  `ops.gcm` contexts) is a warm-up of the port's GCM contexts and kernels at
  the same shapes (`warm_decrypt_shapes`), for the same reason: the gate
  does not judge one-time costs (here the context build and the first
  launch of each kernel);
- `TpuTransformBackend` is `transform.cuda.CudaTransformBackend` on
  `DEVICE`, and its `dispatch_stats` count the port's window programs;
- the probe's batched round trips a window `<= 1.0` (JAX's window program
  writes one intermediate) becomes `<=` the unbatched control's (the
  port's fixed window writes 2, so the control reads 2.0), as the
  transform twin's `batched_hbm_roundtrips_per_window_le_unbatched`;
- the fleet always runs encrypted: the port generates its RSA pair itself,
  so the JAX gate's unencrypted branch (no `cryptography`) has no twin, and
  `drive_exemplar_launch` is kept for callers but the timeline never needs
  it;
- the JAX gate's `--bench-out` / `BENCH_LOAD.json` and the check on it are
  gone: the port writes no bench file.

The report adds `device` and `launches`: each phase's launches of each CUDA
kernel (`ops/_cuda.launch_counts()`), and `launch_rows`, the rows a launch
carried, so a caller can tell which GHASH kernel ran at the fleet's and the
probe's 4 KiB chunks and at the readahead's 1 KiB chunks.

`capacity_probe_modes` and `readahead_ab_modes` are the two phases' arms
without their checks (the CPU parity tests hold the port's plain versions
to the counts, not to the latency verdicts, which need the card).
`--phases capacity_probe,readahead_ab` runs only the phases that build
their own chains (`ALONE`), each with its checks, at the gate's constants,
then the witness verdict. The whole gate stops at its SLO section's
`fetch-latency` `burn_rate_long` check wherever the closed loop outlasts
the 2.4 s long window after its last cold chunk fetch: the memory chunk
cache serves every later read, so the window holds no event and the burn
rate is None. The JAX gate does the same on a CPU host; the phases alone
pass in both.

    python3 tools/torch_load_demo.py --out artifacts/torch_load_report.json
    python3 tools/torch_load_demo.py --device cpu
    python3 tools/torch_load_demo.py --phases capacity_probe,readahead_ab

Without CUDA, and without `--device cpu`, it exits 2 and runs nothing. Arm
the lock witness with `TSTPU_LOCK_WITNESS=1` in the environment.
"""

from __future__ import annotations

import argparse
import http.client
import json
import pathlib
import random
import sys
import tempfile
import threading
import time

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))

from collections import Counter  # noqa: E402

from tieredstorage_tpu_torch.metadata import (  # noqa: E402
    KafkaUuid,
    LogSegmentData,
    RemoteLogSegmentId,
    RemoteLogSegmentMetadata,
    TopicIdPartition,
    TopicPartition,
)
from tieredstorage_tpu_torch.rsm import RemoteStorageManager  # noqa: E402
from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files  # noqa: E402
from tieredstorage_tpu_torch.sidecar import shimwire  # noqa: E402
from tieredstorage_tpu_torch.sidecar.http_gateway import SidecarHttpGateway  # noqa: E402

import torch  # noqa: E402

from tieredstorage_tpu_torch.ops import _cuda  # noqa: E402

#: Where every backend of the gate runs: `cuda:0`, or `cpu` for the plain
#: versions (set by `run()`, or by a caller before it calls a phase).
DEVICE = "cuda:0"

CHUNK = 4096
CHUNKS_PER_SEGMENT = 8
BASE_SEGMENTS = 4
PRODUCED_SEGMENTS = 3
INSTANCES = ("g0", "g1", "g2")
VNODES = 64
KEY_PREFIX = "load/"
WORKERS = 6
REQUESTS_PER_WORKER = 100
TOTAL_REQUESTS = WORKERS * REQUESTS_PER_WORKER
#: Closed-loop pacing per worker iteration: long enough that the run spans
#: the SLO engine's LONG burn-rate window (so the two-window math is
#: exercised on real data), short enough to stay a sub-minute CI gate.
PACING_S = 0.008
#: Global request counts at which the chaos events fire (any worker
#: crossing the threshold performs the kill under the coordinator lock).
KILL_REPLICA_AT = TOTAL_REQUESTS // 3
KILL_INSTANCE_AT = (2 * TOTAL_REQUESTS) // 3
VICTIM_INSTANCE = "g2"
DEADLINE_MS = 15_000
SHED_MAX_PERCENT = 5
SEED = 20260805
ZIPF_EXPONENT = 1.2

#: Overload phase: a synchronized burst this much larger than
#: the admission window (max.concurrent + max.queue below) must shed.
ADMISSION_MAX_CONCURRENT = 8
ADMISSION_MAX_QUEUE = 8
OVERLOAD_BURST = 64
#: Recovery traffic batches: ordinary fetches that refill the shed-rate
#: error budget until the cumulative verdict is ok again (bounded).
RECOVERY_BATCH = 100
RECOVERY_MAX_BATCHES = 40

#: Scaled capacity probe: massed consumer-group replay.
PROBE_STREAMS = 1024
PROBE_SEGMENTS = 8
PROBE_CHUNK = 4096
PROBE_CHUNKS_PER_SEGMENT = 32
PROBE_WINDOW = 8          # chunks per consumer read = one decrypt window
PROBE_READS_PER_STREAM = 2
PROBE_SLO_THRESHOLD_MS = 15_000.0

#: Scrub under chaos: the integrity daemons run INSIDE the
#: chaos window on every instance — periods small enough that passes land
#: between the kills and keep landing through overload + recovery.
SCRUB_INTERVAL_MS = 1_000
SCRUB_RATE_BYTES = 4 * 1024 * 1024
ANTIENTROPY_INTERVAL_MS = 1_500

#: Capacity-probe isolation phase: this many
#: closed-loop background-class verification threads decrypt through the
#: SAME batched backend while the fetch storm replays; the scheduler must
#: keep the fetch SLO verdict ok while their throughput stays > 0.
PROBE_SCRUB_STREAMS = 4
PROBE_SCRUB_RATE_BYTES = 8 * 1024 * 1024

#: Fleet-stitched timeline phase: concurrent full-segment
#: fetches of a fresh ENCRYPTED segment through one origin gateway — the
#: fan-out gives the device scheduler concurrent decrypt windows to merge
#: (fast-path singletons carry no batch id) and the per-chunk ownership
#: forwards give the trace its cross-instance hops.
TIMELINE_FETCHERS = 12
#: How deep into the slowest-first flight dump the exemplar search looks
#: when no SLO breach nominated one (the overload phase leaves slow
#: UNencrypted records that span instances but carry no launch evidence).
TIMELINE_CANDIDATES = 128

#: Readahead A/B phase: concurrent consumers each replay their
#: OWN chain of segments front to back — the pure sequential cold-replay
#: shape the readahead tier exists for — once with the tier on and once
#: with the identical chain without it. Foreground reads are small
#: windows; the speculation window is larger so one background launch
#: merges several foreground windows into one ranged GET + one batched
#: decrypt.
#: Sized to the host, not to the fleet: concurrent consumer threads
#: beyond the core count only inflate every dispatch (GIL + scheduler
#: thrash) without adding device pressure — the launch-merging and
#: latency-hiding effects under test are per-stream, not per-thread.
RA_CONSUMERS = 4
#: Chains are LONG on purpose: promotion hysteresis makes the first
#: 3 reads of every chain reactive, and p99 over the whole replay must
#: measure the steady state, not the warm-up (12 promotion reads out of
#: 3072 keeps the cold block strictly under the 1% tail).
RA_SEGMENTS_PER_CONSUMER = 96
#: Chunks small enough that per-dispatch overhead dominates the decrypt:
#: that is the regime where merging foreground windows into one
#: speculative launch actually buys device time (a 16-row window costs
#: ~2x a 4-row one, not 4x), mirroring the many-small-chunks shape of
#: index/timestamp fetches.
RA_CHUNK = 1024
RA_CHUNKS_PER_SEGMENT = 32
RA_FG_WINDOW = 4           # chunks per foreground consumer read
RA_SPEC_WINDOW = 16        # readahead.window.chunks (4x merge factor)
RA_BUDGET_BYTES = 16 * 1024 * 1024
RA_HIT_RATE_FLOOR = 0.9
#: Modeled object-store RTT per ranged GET, identical in both modes: the
#: reactive chain pays it serially on every cold window read; readahead
#: overlaps it with serving and amortizes it across merged windows.
RA_FETCH_LATENCY_S = 0.015
#: Modeled per-read record apply/deserialize cost, identical in both
#: modes and OUTSIDE the read-latency timer. This is the slack
#: speculation hides behind: a consumer that applies records for ~40ms
#: between window reads gives an in-flight background launch (RTT +
#: batched decrypt, submitted 4+ reads = ~160ms ahead of first use)
#: time to land before the stream reaches it, so steady-state reads are
#: cache hits. The reactive chain pays the full fetch+decrypt serially
#: on EVERY read no matter how long the consumer spends applying —
#: overlap, not raw device speed, is the effect under test (a tight-loop
#: consumer with zero apply time would give prefetch nothing to overlap
#: and measure only dispatch contention).
RA_CONSUME_MS = 40.0


def segment_payload(i: int) -> bytes:
    blob = b"".join(
        b"seg=%02d off=%012d load-demo-record-body|" % (i, j)
        for j in range(CHUNK * CHUNKS_PER_SEGMENT // 40 + 1)
    )
    return blob[: CHUNK * CHUNKS_PER_SEGMENT]


def make_segment(i: int, tmp: pathlib.Path):
    payload = segment_payload(i)
    seg = tmp / f"{i:020d}.log"
    seg.write_bytes(payload)
    (tmp / f"{i}.index").write_bytes(b"\x00" * 64)
    (tmp / f"{i}.timeindex").write_bytes(b"\x00" * 32)
    (tmp / f"{i}.snapshot").write_bytes(b"\x00" * 16)
    tip = TopicIdPartition(KafkaUuid(b"\x1d" * 16), TopicPartition("loaddemo", 0))
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


def storage_configs(tmp: pathlib.Path) -> dict:
    """The shared 2-replica store: both replicas are plain filesystem
    roots, shared by every instance, so 'replica a dies' is one directory
    rename visible fleet-wide."""
    return {
        "storage.backend.class":
            "tieredstorage_tpu_torch.storage.replicated.ReplicatedStorageBackend",
        "storage.replication.replicas": "a,b",
        "storage.replication.replica.a.backend.class":
            "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        "storage.replication.replica.a.root": str(tmp / "replica-a"),
        "storage.replication.replica.a.overwrite.enabled": True,
        "storage.replication.replica.b.backend.class":
            "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        "storage.replication.replica.b.root": str(tmp / "replica-b"),
        "storage.replication.replica.b.overwrite.enabled": True,
        # Quorum 1: produce keeps succeeding through the replica outage
        # (the surviving replica takes the copy).
        "storage.replication.write.quorum": 1,
        # Health from live traffic only: deterministic call sequences.
        "storage.replication.probe.interval.ms": None,
    }


def make_rsm(
    name: str, tmp: pathlib.Path,
    keys: tuple[pathlib.Path, pathlib.Path] | None,
) -> RemoteStorageManager:
    # The fleet serves REAL encrypted traffic through the batched device
    # scheduler, so produced-segment fetches decrypt via merged GCM
    # launches and flight records carry the ``gcm.batch:<id>`` markers the
    # stitched timeline joins on. `run()` always passes keys; None keeps
    # the JAX gate's unencrypted configuration for a caller that asks.
    if keys is not None:
        pub, priv = keys
        encryption_configs = {
            "encryption.enabled": True,
            "encryption.key.pair.id": "key1",
            "encryption.key.pairs": "key1",
            "encryption.key.pairs.key1.public.key.file": str(pub),
            "encryption.key.pairs.key1.private.key.file": str(priv),
        }
    else:
        encryption_configs = {"encryption.enabled": False}
    rsm = RemoteStorageManager()
    rsm.configure({
        **storage_configs(tmp),
        "chunk.size": CHUNK,
        "key.prefix": KEY_PREFIX,
        **encryption_configs,
        "transform.backend.class":
            "tieredstorage_tpu_torch.transform.cuda.CudaTransformBackend",
        "transform.device": DEVICE,
        "transform.batch.enabled": True,
        "transform.batch.wait.ms": 6,
        # The device-scheduler timeline ring under test.
        "timeline.enabled": True,
        "timeline.ring.size": 512,
        "fetch.chunk.cache.class":
            "tieredstorage_tpu_torch.fetch.cache.memory.MemoryChunkCache",
        "fetch.chunk.cache.size": -1,
        "fetch.chunk.cache.thread.pool.size": 16,
        "fleet.enabled": True,
        "fleet.instance.id": name,
        "fleet.vnodes": VNODES,
        "deadline.default.ms": DEADLINE_MS,
        "admission.enabled": True,
        "admission.max.concurrent": ADMISSION_MAX_CONCURRENT,
        "admission.max.queue": ADMISSION_MAX_QUEUE,
        "admission.queue.timeout.ms": 5_000,
        # Enough HTTP workers that the overload burst reaches the admission
        # gate concurrently instead of serializing in the accept loop.
        "sidecar.http.max.workers": 96,
        "hedge.enabled": True,
        "hedge.delay.ms": 200,
        "tracing.enabled": True,
        # The observability plane under test. The flight ring is sized so
        # the timeline phase's cross-instance serve records survive the
        # overload/recovery churn that precedes the exemplar search.
        "flight.enabled": True,
        "flight.ring.size": 128,
        "slo.enabled": True,
        "slo.window.short.ms": 800,
        "slo.window.long.ms": 2_400,
        "slo.fetch.latency.objective.percent": 99,
        "slo.error.rate.objective.percent": 99,
        "slo.shed.rate.max.percent": SHED_MAX_PERCENT,
        # The integrity daemons share the fleet with the chaos
        # load. The scrub walk CRC32C-verifies every chunk (checksums are
        # recorded at upload) on a 1s period; anti-entropy converges the
        # 2-replica store on a 1.5s period. Storage IO is token-bucketed
        # host-side; any device GCM verification submits under the
        # scheduler's background admission class. Repair stays off: a
        # produce in flight (log up, manifest not yet) is a transient
        # orphan finding, never a deletion.
        "scrub.enabled": True,
        "scrub.interval.ms": SCRUB_INTERVAL_MS,
        "scrub.rate.bytes": SCRUB_RATE_BYTES,
        "scrub.checksums.enabled": True,
        "replication.antientropy.enabled": True,
        "replication.antientropy.interval.ms": ANTIENTROPY_INTERVAL_MS,
        "replication.antientropy.rate.bytes": SCRUB_RATE_BYTES,
    })
    return rsm


def http_fetch(port: int, metadata, start: int, end):
    body = shimwire.encode_metadata(metadata) + shimwire.encode_fetch_tail(start, end)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/v1/fetch", body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def http_copy(port: int, metadata, data: LogSegmentData):
    body = shimwire.encode_metadata(metadata) + shimwire.encode_sections({
        "log_segment": pathlib.Path(data.log_segment).read_bytes(),
        "offset_index": pathlib.Path(data.offset_index).read_bytes(),
        "time_index": pathlib.Path(data.time_index).read_bytes(),
        "producer_snapshot": pathlib.Path(data.producer_snapshot_index).read_bytes(),
        "transaction_index": None,
        "leader_epoch_index": data.leader_epoch_index,
    })
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", "/v1/copy", body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def http_json(port: int, path: str):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        body = resp.read()
        return resp.status, (json.loads(body) if resp.status == 200 else body)
    finally:
        conn.close()


class Coordinator:
    """Shared workload state: the request counter, the chaos triggers, the
    alive-gateway view, and the client-observed evidence."""

    def __init__(self, gateways, rsms, tmp: pathlib.Path):
        self.lock = threading.Lock()
        self.gateways = gateways
        self.rsms = rsms
        self.tmp = tmp
        self.alive = list(INSTANCES)
        self.requests = 0
        self.replica_killed_at = None
        self.instance_killed_at = None
        #: Scrub/anti-entropy counters snapshotted the instant the chaos
        #: window opens (replica kill): the end-of-run gate asserts the
        #: daemons made strict progress AFTER this point.
        self.scrub_at_chaos = None
        self.byte_diffs = 0
        self.retries = 0
        self.client_errors = 0
        self.statuses: Counter = Counter()
        self.latencies_ms: list[float] = []

    def next_request(self) -> int:
        """Bump the global counter; fire a due chaos event exactly once."""
        with self.lock:
            self.requests += 1
            n = self.requests
            if n == KILL_REPLICA_AT and self.replica_killed_at is None:
                self.replica_killed_at = n
                # The chaos window opens: snapshot each instance's scrub /
                # anti-entropy progress so the end-of-run gate can prove
                # the daemons kept verifying THROUGH the kills.
                self.scrub_at_chaos = {
                    name: {
                        "chunks_verified": self.rsms[name].scrubber.chunks_verified_total,
                        "antientropy_passes": self.rsms[name].antientropy.passes,
                    }
                    for name in self.alive
                }
                # Replica a's data vanishes fleet-wide: every pre-kill
                # object on it becomes a failover to replica b.
                (self.tmp / "replica-a").rename(self.tmp / "replica-a.dead")
            if n == KILL_INSTANCE_AT and self.instance_killed_at is None:
                self.instance_killed_at = n
                self.alive = [x for x in self.alive if x != VICTIM_INSTANCE]
                survivors = {
                    x: f"http://127.0.0.1:{self.gateways[x].port}"
                    for x in self.alive
                }
                self.gateways[VICTIM_INSTANCE].stop()
                for x in self.alive:
                    self.rsms[x].set_fleet_peers(survivors)
            return n

    def alive_port(self, rng: random.Random) -> int:
        with self.lock:
            name = rng.choice(self.alive)
            return self.gateways[name].port

    def record(self, status: int, ok_bytes: bool, elapsed_ms: float,
               retried: bool) -> None:
        with self.lock:
            self.statuses[status] += 1
            self.latencies_ms.append(elapsed_ms)
            if status == 200 and not ok_bytes:
                self.byte_diffs += 1
            if retried:
                self.retries += 1


def overload_phase(gateways, rsms, target: str, md, payload) -> dict:
    """Deliberately saturate `target`'s admission window (
    satellite): a barrier-synchronized burst of OVERLOAD_BURST concurrent
    fetches against a window of ADMISSION_MAX_CONCURRENT +
    ADMISSION_MAX_QUEUE slots. The gate is the SLO engine's own reaction:
    >0 sheds, and the shed-rate spec must report the damage (budget
    exhausted and/or both burn windows alight)."""
    port = gateways[target].port
    admission = rsms[target].admission
    sheds_before = admission.shed_total
    lock = threading.Lock()
    statuses: Counter = Counter()
    # Full-segment fetches: each admitted request holds its slot for the
    # whole 8-chunk serve, so the synchronized burst finds the window
    # genuinely full instead of racing a fast drain.
    body = shimwire.encode_metadata(md) + shimwire.encode_fetch_tail(
        0, CHUNK * CHUNKS_PER_SEGMENT - 1
    )
    # A scrape immediately before the burst pins a fresh snapshot, so the
    # engine's short burn window brackets exactly the overload interval.
    http_json(port, "/slo")

    def blast(conn: http.client.HTTPConnection, barrier) -> None:
        # The connection is already parked in a gateway worker (opened
        # below, paced past the TCP accept backlog); every burst thread
        # fires its REQUEST at the barrier, so all of them hit the
        # admission gate inside one service interval.
        try:
            barrier.wait(timeout=30)
            conn.request("POST", "/v1/fetch", body=body)
            status = conn.getresponse().status
        except (OSError, threading.BrokenBarrierError):
            status = -1
        finally:
            conn.close()
        with lock:
            statuses[status] += 1

    for _round in range(2):
        barrier = threading.Barrier(OVERLOAD_BURST)
        conns = []
        for _ in range(OVERLOAD_BURST):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            for _attempt in range(50):
                try:
                    conn.connect()
                    break
                except OSError:
                    time.sleep(0.02)  # accept backlog full: pace the dial-in
            conns.append(conn)
            time.sleep(0.002)
        threads = [
            threading.Thread(target=blast, args=(conn, barrier))
            for conn in conns
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    sheds = admission.shed_total - sheds_before
    status, verdicts = http_json(port, "/slo")
    assert status == 200, verdicts
    shed_verdict = verdicts["specs"]["shed-rate"]
    return {
        "burst": 2 * OVERLOAD_BURST,
        "statuses": dict(statuses),
        "sheds": sheds,
        "shed_verdict_during": {
            k: shed_verdict.get(k)
            for k in ("ok", "burning", "compliance", "burn_rate_short",
                      "burn_rate_long", "error_budget_remaining")
        },
    }


def recovery_phase(gateways, rsms, target: str, md, payload) -> dict:
    """Refill `target`'s shed-rate error budget with ordinary traffic
    until the cumulative verdict is ok again (bounded batches) — the SLO
    model of recovery: good events dilute the burst, nothing is reset."""
    port = gateways[target].port
    admission = rsms[target].admission
    batches = 0
    expected = payload[:CHUNK]
    while batches < RECOVERY_MAX_BATCHES:
        shed_fraction = admission.shed_total / max(
            1, admission.shed_total + admission.admitted_total
        )
        # Recover past a hysteresis margin below the objective so the
        # final all-ok verdict isn't balancing on the budget edge.
        if shed_fraction <= 0.8 * SHED_MAX_PERCENT / 100.0:
            break
        batches += 1
        for _ in range(RECOVERY_BATCH):
            status, got = http_fetch(port, md, 0, CHUNK - 1)
            assert status == 200 and got == expected, status
    status, verdicts = http_json(port, "/slo")
    assert status == 200, verdicts
    return {
        "recovery_batches": batches,
        "recovery_fetches": batches * RECOVERY_BATCH,
        "shed_verdict_after": {
            k: verdicts["specs"]["shed-rate"].get(k)
            for k in ("ok", "compliance", "error_budget_remaining")
        },
    }


def warm_decrypt_shapes(backend, chunk_bytes: int, fixed_rows=(), varlen_rows=()) -> None:
    """Warm the port's GCM contexts and kernels at the decrypt shapes a
    phase launches (the JAX gate's jit warm-up, in torch terms): one fixed
    window program for each row count in `fixed_rows` and one merged
    varlen program for each in `varlen_rows`, over zero rows of a
    throwaway key, through the backend's own staging and launch. The
    caller resets the backend's dispatch stats after."""
    from tieredstorage_tpu_torch.ops import gcm as gcm_ops
    from tieredstorage_tpu_torch.security.aes import IV_SIZE, TAG_SIZE, AesEncryptionProvider

    dk = AesEncryptionProvider.create_data_key_and_aad()
    fixed_ctx = gcm_ops.make_context(dk.data_key, dk.aad, chunk_bytes)
    var_ctx = gcm_ops.make_varlen_context(dk.data_key, dk.aad, chunk_bytes)
    cuda = backend.device.type == "cuda"
    shapes = [(fixed_ctx, rows, False) for rows in fixed_rows]
    shapes += [(var_ctx, rows, True) for rows in varlen_rows]
    for ctx, rows, varlen in shapes:
        width = (var_ctx.max_bytes if varlen else chunk_bytes) + TAG_SIZE
        host = torch.zeros((rows, width), dtype=torch.uint8, pin_memory=cuda)
        if varlen:
            host[:, width - TAG_SIZE + IV_SIZE] = 16  # one 16-byte block a row
        if cuda:
            with torch.cuda.device(backend.device):
                staged = backend._stage_packed(host, varlen)
                backend._launch_packed(ctx, host, staged, varlen, decrypt=True)
            torch.cuda.synchronize(backend.device)
        else:
            staged = backend._stage_packed(host, varlen)
            backend._launch_packed(ctx, host, staged, varlen, decrypt=True)


# ---------------------------------------------------------- capacity probe
class _ProbeFetcher:
    """ObjectFetcher over in-memory transformed segment blobs."""

    def __init__(self) -> None:
        self.blobs: dict[str, bytes] = {}
        self.reads = 0
        self._lock = threading.Lock()

    def fetch(self, key, r):
        import io

        with self._lock:
            self.reads += 1
        blob = self.blobs[key.value]
        return io.BytesIO(blob[r.from_position : r.to_position + 1])


def _build_probe_chain(batch: bool):
    """The full decrypt fetch chain over PROBE_SEGMENTS encrypted
    segments (one data key each — the real consumer-replay shape: windows
    of the same segment share a key and can coalesce): a deliberately
    tiny always-evicting chunk cache in front of DefaultChunkManager over
    a CudaTransformBackend on DEVICE, with the observability plane armed (the
    chunk-fetch histogram feeds a fetch-latency SloSpec; a FlightRecorder
    captures per-stream batch evidence)."""
    import numpy as np

    from tieredstorage_tpu_torch.fetch.cache.memory import MemoryChunkCache
    from tieredstorage_tpu_torch.fetch.chunk_manager import DefaultChunkManager
    from tieredstorage_tpu_torch.manifest.chunk_index import FixedSizeChunkIndex
    from tieredstorage_tpu_torch.manifest.encryption_metadata import (
        SegmentEncryptionMetadataV1,
    )
    from tieredstorage_tpu_torch.manifest.segment_indexes import (
        IndexType,
        SegmentIndexesV1Builder,
    )
    from tieredstorage_tpu_torch.manifest.segment_manifest import SegmentManifestV1
    from tieredstorage_tpu_torch.metrics.core import MetricConfig
    from tieredstorage_tpu_torch.metrics.rsm_metrics import Metrics
    from tieredstorage_tpu_torch.metrics.slo import (
        HistogramLatencySource,
        SloEngine,
        SloSpec,
    )
    from tieredstorage_tpu_torch.security.aes import AesEncryptionProvider
    from tieredstorage_tpu_torch.storage.core import ObjectKey
    from tieredstorage_tpu_torch.transform.api import TransformOptions
    from tieredstorage_tpu_torch.transform.cuda import CudaTransformBackend
    from tieredstorage_tpu_torch.utils.flightrecorder import FlightRecorder

    rng = random.Random(SEED ^ 0xCAFE)
    backend = CudaTransformBackend(device=DEVICE)
    if batch:
        backend.enable_batching(wait_ms=4, max_windows=16)
    fetcher = _ProbeFetcher()
    segments = []
    n_bytes = PROBE_CHUNK * PROBE_CHUNKS_PER_SEGMENT
    index_builder = SegmentIndexesV1Builder()
    for t in (IndexType.OFFSET, IndexType.TIMESTAMP,
              IndexType.PRODUCER_SNAPSHOT, IndexType.LEADER_EPOCH):
        index_builder.add(t, 0)
    for s in range(PROBE_SEGMENTS):
        chunks = [
            bytes(rng.getrandbits(8) for _ in range(PROBE_CHUNK))
            for _ in range(PROBE_CHUNKS_PER_SEGMENT)
        ]
        dk = AesEncryptionProvider.create_data_key_and_aad()
        ivs = [
            np.uint32(s * 1000 + i + 1).tobytes().ljust(12, b"\x17")
            for i in range(PROBE_CHUNKS_PER_SEGMENT)
        ]
        blob = b"".join(
            backend.transform(chunks, TransformOptions(encryption=dk, ivs=ivs))
        )
        key = ObjectKey(f"probe/topic-probe/0/{s:020d}-seg.log")
        fetcher.blobs[key.value] = blob
        manifest = SegmentManifestV1(
            chunk_index=FixedSizeChunkIndex(
                original_chunk_size=PROBE_CHUNK,
                original_file_size=n_bytes,
                transformed_chunk_size=PROBE_CHUNK + 28,
                final_transformed_chunk_size=PROBE_CHUNK + 28,
            ),
            segment_indexes=index_builder.build(),
            compression=False,
            encryption=SegmentEncryptionMetadataV1(dk.data_key, dk.aad),
            remote_log_segment_metadata=None,
        )
        segments.append((key, manifest, chunks))

    # Warm the contexts and kernels for every shape the probe can launch
    # (fixed 8-row windows on the direct path; the power-of-two row ladder
    # of merged varlen flushes when batching): a one-time cost inside the
    # timed phase would make the latency SLO judge the warm-up, not the
    # serving path. Throwaway stats are reset below.
    ladder = []
    rows = 8
    while batch and rows <= 16 * PROBE_WINDOW:
        ladder.append(rows)
        rows *= 2
    warm_decrypt_shapes(backend, PROBE_CHUNK, (PROBE_WINDOW,), ladder)
    backend.reset_dispatch_stats()

    metrics = Metrics(MetricConfig())
    manager = DefaultChunkManager(fetcher, backend)
    manager.on_fetch = metrics.record_chunk_fetch
    cache = MemoryChunkCache(manager)
    # One-chunk cache = always evicting: every replay read re-decrypts,
    # which is exactly the storm the batcher exists for (warm-cache serves
    # are the hot tier's job, gated by tools/torch_hot_demo.py).
    cache.configure({
        "size": PROBE_CHUNK,
        "prefetch.max.size": 0,
        "get.timeout.ms": 120_000,
        "thread.pool.size": 64,
    })
    recorder = FlightRecorder(enabled=True, ring_size=64)
    engine = SloEngine(
        [SloSpec(
            name="probe-fetch-latency",
            description=(
                f"p99 probe chunk fetch within {PROBE_SLO_THRESHOLD_MS} ms"
            ),
            objective=0.99,
            source=HistogramLatencySource(
                metrics, "chunk-fetch-time", PROBE_SLO_THRESHOLD_MS
            ),
        )],
        short_window_s=1.0,
        long_window_s=4.0,
    )
    return backend, cache, segments, recorder, engine, fetcher


def capacity_probe_modes(streams: int, checked: bool = False) -> dict:
    """The three modes of `capacity_probe` (batched, batched under
    background scrub, the unbatched control): {"batched": ...,
    "batched_with_scrub": ..., "unbatched_control": ...}. Each mode's own
    checks (no byte diff, the SLO verdict ok with samples) only when
    `checked`."""

    def run_mode(batch: bool, scrub_streams: int = 0) -> dict:
        backend, cache, segments, recorder, engine, fetcher = (
            _build_probe_chain(batch)
        )
        windows_per_segment = PROBE_CHUNKS_PER_SEGMENT // PROBE_WINDOW
        errors: list = []
        latencies_ms: list[float] = []
        started = threading.Barrier(min(streams, 256))

        def consumer(c: int) -> None:
            try:
                started.wait(timeout=60)
            except threading.BrokenBarrierError:
                pass
            key, manifest, chunks = segments[c % PROBE_SEGMENTS]
            start_w = (c // PROBE_SEGMENTS) % windows_per_segment
            for r in range(PROBE_READS_PER_STREAM):
                w = (start_w + r) % windows_per_segment
                ids = list(range(w * PROBE_WINDOW, (w + 1) * PROBE_WINDOW))
                t0 = time.monotonic()
                with recorder.request("probe.fetch", trace_id=f"p-{c}-{r}"):
                    got = cache.get_chunks(key, manifest, ids)
                latencies_ms.append((time.monotonic() - t0) * 1000.0)
                if got != chunks[ids[0] : ids[-1] + 1]:
                    errors.append((c, w))

        # closed-loop scrub-verification workers
        # decrypting through the SAME backend under the BACKGROUND work
        # class while the fetch storm runs — the scheduler's admission
        # class + starvation watchdog pace them, never the fetch buckets.
        scrub_stop = threading.Event()
        scrub_errors: list = []
        scrub_counts = Counter()
        t_chunk = PROBE_CHUNK + 28  # transformed chunk: 12B IV + 16B tag

        def scrub_worker(w: int) -> None:
            from tieredstorage_tpu_torch.transform.api import DetransformOptions
            from tieredstorage_tpu_torch.transform.scheduler import (
                BACKGROUND,
                work_class_scope,
            )

            i = w
            while not scrub_stop.is_set():
                key, manifest, chunks = segments[i % PROBE_SEGMENTS]
                wi = (i // PROBE_SEGMENTS) % windows_per_segment
                ids = list(range(wi * PROBE_WINDOW, (wi + 1) * PROBE_WINDOW))
                blob = scrub_blobs[key.value]
                stored = [
                    blob[c * t_chunk : (c + 1) * t_chunk] for c in ids
                ]
                opts = DetransformOptions.from_manifest(manifest)
                with work_class_scope(BACKGROUND):
                    out = backend.detransform(stored, opts)
                if out != chunks[ids[0] : ids[-1] + 1]:
                    scrub_errors.append((w, wi))
                scrub_counts["chunks"] += len(ids)
                scrub_counts["bytes"] += sum(len(b) for b in stored)
                i += scrub_streams

        scrub_threads = []
        scrub_blobs: dict[str, bytes] = dict(fetcher.blobs)
        if scrub_streams:
            from tieredstorage_tpu_torch.transform.scheduler import BACKGROUND

            # The background class is rate-limited exactly the way the rsm
            # wires `scrub.rate.bytes`: scheduler admission, not a
            # host-side token bucket.
            backend.batcher.set_class_rate(BACKGROUND, PROBE_SCRUB_RATE_BYTES)
            scrub_threads = [
                threading.Thread(
                    target=scrub_worker, args=(w,), name=f"probe-scrub-{w}"
                )
                for w in range(scrub_streams)
            ]

        ticking = threading.Event()

        def ticker() -> None:
            while not ticking.wait(0.25):
                engine.evaluate()

        tick_thread = threading.Thread(target=ticker, daemon=True)
        threads = [
            threading.Thread(target=consumer, args=(c,), name=f"probe-{c}")
            for c in range(streams)
        ]
        t0 = time.monotonic()
        tick_thread.start()
        for t in scrub_threads:
            t.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        elapsed_s = time.monotonic() - t0
        scrub_stop.set()
        for t in scrub_threads:
            t.join(timeout=60)
        ticking.set()
        tick_thread.join(timeout=10)
        verdicts = engine.evaluate()
        stats = backend.dispatch_stats
        served_bytes = streams * PROBE_READS_PER_STREAM * PROBE_WINDOW * PROBE_CHUNK
        batch_records = sum(
            1
            for rec in recorder.slowest() + recorder.failures()
            if rec.counters.get("gcm.batched_windows")
        )
        batcher = backend.batcher
        sorted_lat = sorted(latencies_ms)
        mode = {
            "streams": streams,
            "reads": streams * PROBE_READS_PER_STREAM,
            "byte_errors": len(errors),
            "elapsed_s": round(elapsed_s, 2),
            "fetch_p50_ms": round(percentile(sorted_lat, 0.50), 2),
            "fetch_p99_ms": round(percentile(sorted_lat, 0.99), 2),
            "aggregate_gibs": round(
                served_bytes / (1 << 30) / max(elapsed_s, 1e-9), 4
            ),
            "decrypt_windows": stats.windows,
            "launches": stats.dispatches,
            "dispatches_per_window": stats.dispatches_per_window,
            "hbm_roundtrips_per_window": stats.hbm_roundtrips_per_window,
            "slo_ok": verdicts["ok"],
            "slo_samples": verdicts["specs"]["probe-fetch-latency"]["samples"],
            "flight_records_with_batch_evidence": batch_records,
        }
        if batcher is not None:
            mode.update({
                "batch_mean_occupancy": round(batcher.mean_occupancy, 3),
                "coalesced_windows": batcher.batched_windows,
                "batched_launches": batcher.launches,
                "fast_path_windows": batcher.fast_path_windows,
                "expired_windows": batcher.expired_windows,
            })
        if scrub_streams:
            from tieredstorage_tpu_torch.transform.scheduler import BACKGROUND

            mode["scrub"] = {
                "streams": scrub_streams,
                "chunks_verified": scrub_counts["chunks"],
                "bytes_verified": scrub_counts["bytes"],
                "verify_mibs": round(
                    scrub_counts["bytes"] / (1 << 20) / max(elapsed_s, 1e-9), 3
                ),
                "byte_errors": len(scrub_errors),
                "background_windows_flushed": (
                    batcher.class_flushed_windows[BACKGROUND]
                ),
                "background_launches": batcher.class_launches[BACKGROUND],
            }
        cache.close()
        backend.close()
        if checked:
            assert errors == [], f"byte diffs from probe streams {errors[:5]}"
            assert verdicts["ok"], verdicts
            assert mode["slo_samples"] > 0, "probe SLO judged with no samples"
        return mode

    return {
        "batched": run_mode(batch=True),
        "batched_with_scrub": run_mode(batch=True, scrub_streams=PROBE_SCRUB_STREAMS),
        "unbatched_control": run_mode(batch=False),
    }


def capacity_probe(streams: int) -> dict:
    """Massed consumer-group replay at probe scale: `streams` concurrent
    consumers re-read the probe segments in windowed reads (rebalance
    shape: start offsets staggered across each segment), batching ON, then
    the identical workload against a batching-OFF control chain."""
    probe = capacity_probe_modes(streams, checked=True)
    batched = probe["batched"]
    isolated = probe["batched_with_scrub"]
    control = probe["unbatched_control"]
    # The tentpole gates: coalescing engaged, and
    # strictly fewer launches per window than the control in the SAME run.
    assert batched["batch_mean_occupancy"] > 1.0, batched
    assert batched["coalesced_windows"] > 0, batched
    assert (
        batched["dispatches_per_window"] < control["dispatches_per_window"]
    ), (batched, control)
    assert control["dispatches_per_window"] == 1.0, control
    # JAX's `<= 1.0` is its window program's plan (one round trip, the
    # GHASH tree path); the port's fixed window writes 2 intermediates, so
    # in torch terms a merged launch must write no more a window than the
    # unbatched control's program does.
    assert (
        batched["hbm_roundtrips_per_window"]
        <= control["hbm_roundtrips_per_window"]
    ), (batched, control)
    assert batched["flight_records_with_batch_evidence"] > 0, batched
    # with background-class scrub verification
    # racing the same device queue, the judge is the SLO engine's OWN
    # verdict over the live fetch histogram (not a hardcoded threshold) —
    # it must stay ok while verification throughput stays > 0 and the
    # background windows demonstrably flowed through the shared scheduler.
    scrub = isolated["scrub"]
    assert isolated["slo_ok"], isolated
    assert isolated["byte_errors"] == 0, isolated
    assert scrub["byte_errors"] == 0, scrub
    assert scrub["chunks_verified"] > 0, scrub
    assert scrub["background_windows_flushed"] > 0, scrub
    probe["isolation"] = {
        "fetch_p99_ms_without_scrub": batched["fetch_p99_ms"],
        "fetch_p99_ms_with_scrub": isolated["fetch_p99_ms"],
        "scrub_verify_mibs_during_storm": scrub["verify_mibs"],
        "scrub_chunks_verified_during_storm": scrub["chunks_verified"],
    }
    return probe


# ------------------------------------------- readahead A/B phase
class _LatencyFetcher:
    """ObjectFetcher over in-memory transformed blobs with a modeled
    object-store RTT per ranged GET (identical in both A/B modes)."""

    def __init__(self) -> None:
        self.blobs: dict[str, bytes] = {}
        self.reads = 0
        self._lock = threading.Lock()

    def fetch(self, key, r):
        import io

        with self._lock:
            self.reads += 1
        time.sleep(RA_FETCH_LATENCY_S)
        blob = self.blobs[key.value]
        return io.BytesIO(blob[r.from_position : r.to_position + 1])


def readahead_ab_modes() -> dict:
    """The two arms of `readahead_ab_phase`, readahead on then off over
    identical stores, without its checks: {"readahead_on": ...,
    "readahead_off": ...}."""
    import numpy as np

    from tieredstorage_tpu_torch.fetch.cache.memory import MemoryChunkCache
    from tieredstorage_tpu_torch.fetch.chunk_manager import DefaultChunkManager
    from tieredstorage_tpu_torch.fetch.readahead import ReadaheadManager
    from tieredstorage_tpu_torch.manifest.chunk_index import FixedSizeChunkIndex
    from tieredstorage_tpu_torch.manifest.encryption_metadata import (
        SegmentEncryptionMetadataV1,
    )
    from tieredstorage_tpu_torch.manifest.segment_indexes import (
        IndexType,
        SegmentIndexesV1Builder,
    )
    from tieredstorage_tpu_torch.manifest.segment_manifest import SegmentManifestV1
    from tieredstorage_tpu_torch.metrics.slo import RatioSource, SloEngine, SloSpec
    from tieredstorage_tpu_torch.security.aes import AesEncryptionProvider
    from tieredstorage_tpu_torch.storage.core import ObjectKey
    from tieredstorage_tpu_torch.transform.api import TransformOptions
    from tieredstorage_tpu_torch.transform.cuda import CudaTransformBackend
    from tieredstorage_tpu_torch.utils.flightrecorder import FlightRecorder

    # ---- build the store ONCE (shared by both modes: same bytes, same
    # keys, same manifests — the only variable is the readahead tier).
    npr = np.random.default_rng(SEED ^ 0x5EA)
    build_backend = CudaTransformBackend(device=DEVICE)
    index = FixedSizeChunkIndex(
        original_chunk_size=RA_CHUNK,
        original_file_size=RA_CHUNK * RA_CHUNKS_PER_SEGMENT,
        transformed_chunk_size=RA_CHUNK + 28,
        final_transformed_chunk_size=RA_CHUNK + 28,
    )
    index_builder = SegmentIndexesV1Builder()
    for t in (IndexType.OFFSET, IndexType.TIMESTAMP,
              IndexType.PRODUCER_SNAPSHOT, IndexType.LEADER_EPOCH):
        index_builder.add(t, 0)
    indexes = index_builder.build()
    blobs: dict[str, bytes] = {}
    manifests: dict[str, SegmentManifestV1] = {}
    plaintext: dict[str, list[bytes]] = {}
    chains: list[list[ObjectKey]] = []
    for c in range(RA_CONSUMERS):
        # One encrypted blob per CONSUMER, shared by every segment of its
        # chain: the fetch chain is keyed by object key end to end, so
        # byte-uniqueness across a chain's segments buys nothing but
        # encrypt time at build (chunk-count-proportional — the dominant
        # phase cost on a small host).
        raw = npr.integers(
            0, 256, RA_CHUNK * RA_CHUNKS_PER_SEGMENT, np.uint8
        ).tobytes()
        chunks = [
            raw[i * RA_CHUNK : (i + 1) * RA_CHUNK]
            for i in range(RA_CHUNKS_PER_SEGMENT)
        ]
        dk = AesEncryptionProvider.create_data_key_and_aad()
        ivs = [
            np.uint32(c * 100_000 + i + 1).tobytes().ljust(12, b"\x2a")
            for i in range(RA_CHUNKS_PER_SEGMENT)
        ]
        blob = b"".join(build_backend.transform(
            chunks, TransformOptions(encryption=dk, ivs=ivs)
        ))
        manifest = SegmentManifestV1(
            chunk_index=index, segment_indexes=indexes,
            compression=False,
            encryption=SegmentEncryptionMetadataV1(dk.data_key, dk.aad),
            remote_log_segment_metadata=None,
        )
        chain = []
        for s in range(RA_SEGMENTS_PER_CONSUMER):
            # Consumer id in the FILE name: the readahead stream key is
            # the segment file name, so chains must not collide.
            key = ObjectKey(
                f"ra/topic-ra/{c}/{c:04d}-{s:020d}-seg.log"
            )
            blobs[key.value] = blob
            manifests[key.value] = manifest
            plaintext[key.value] = chunks
            chain.append(key)
        chains.append(chain)
    build_backend.close()
    successor = {
        chain[i].value: chain[i + 1]
        for chain in chains for i in range(len(chain) - 1)
    }

    def run_mode(readahead: bool) -> dict:
        backend = CudaTransformBackend(device=DEVICE)
        # Warm the contexts and kernels for the two decrypt shapes this
        # phase launches (foreground and speculative windows), same
        # reasoning as the probe.
        warm_decrypt_shapes(backend, RA_CHUNK, sorted({RA_FG_WINDOW, RA_SPEC_WINDOW}))
        backend.reset_dispatch_stats()

        fetcher = _LatencyFetcher()
        fetcher.blobs.update(blobs)
        cache = MemoryChunkCache(DefaultChunkManager(fetcher, backend))
        # Roomy cache (never evicts within the phase): readahead
        # pre-admits verified plaintext through it, and the OFF control
        # replays every chunk exactly once anyway — cold either way.
        cache.configure({
            "size": RA_CHUNK * RA_CHUNKS_PER_SEGMENT
            * RA_SEGMENTS_PER_CONSUMER * RA_CONSUMERS * 2,
            "prefetch.max.size": 0,
        })
        recorder = FlightRecorder(enabled=True, ring_size=64)
        tier = cache
        manager = None
        engine = None
        if readahead:
            manager = ReadaheadManager(
                cache,
                window_chunks=RA_SPEC_WINDOW,
                streams_max=RA_CONSUMERS * RA_SEGMENTS_PER_CONSUMER * 2,
                budget_bytes=RA_BUDGET_BYTES,
                # Pool sized to the host, not the stream count: steady
                # state keeps well under one launch in flight per
                # consumer (2 windows per RA_CONSUME_MS*8 segment
                # period), and every EXTRA thread spinning in a device
                # dispatch multiplies the per-launch floor for all of
                # them — more slots here make speculation slower, not
                # faster. One slot per consumer also absorbs the
                # promotion burst (first in-segment window + first
                # continuation land together).
                max_workers=RA_CONSUMERS,
            )
            manager.flight_recorder = recorder
            manager.next_segment_resolver = lambda key: (
                (successor[key.value],
                 lambda k=successor[key.value]: manifests[k.value])
                if key.value in successor else None
            )
            tier = manager
            # The exact SLO spec the rsm wires for the tier
            # (readahead-misprediction): good bytes ratio objective is
            # 1 - readahead.misprediction.max.ratio.
            bound = manager.misprediction_max_ratio
            engine = SloEngine(
                [SloSpec(
                    name="readahead-misprediction",
                    description=(
                        "speculated decrypt bytes later consumed by the "
                        f"stream (wasted bounded at {bound:.0%})"
                    ),
                    objective=1.0 - bound,
                    source=RatioSource(
                        good=lambda: float(
                            manager.bytes_speculated - manager.wasted_bytes
                        ),
                        total=lambda: float(manager.bytes_speculated),
                    ),
                )],
                short_window_s=1.0,
                long_window_s=4.0,
            )

        errors: list = []
        latencies_ms: list[float] = []
        started = threading.Barrier(RA_CONSUMERS)

        def consumer(c: int) -> None:
            try:
                started.wait(timeout=60)
            except threading.BrokenBarrierError:
                pass
            for si, key in enumerate(chains[c]):
                manifest = manifests[key.value]
                chunks = plaintext[key.value]
                for lo in range(0, RA_CHUNKS_PER_SEGMENT, RA_FG_WINDOW):
                    ids = list(range(lo, lo + RA_FG_WINDOW))
                    t0 = time.monotonic()
                    with recorder.request(
                        "replay.fetch", trace_id=f"ra-{c}-{si}-{lo}"
                    ):
                        got = tier.get_chunks(key, manifest, ids)
                    latencies_ms.append((time.monotonic() - t0) * 1000.0)
                    if got != chunks[lo : lo + RA_FG_WINDOW]:
                        errors.append((c, si, lo))
                    # Modeled record-apply time between reads (untimed,
                    # both modes): the overlap window speculation fills.
                    time.sleep(RA_CONSUME_MS / 1000.0)

        ticking = threading.Event()

        def ticker() -> None:
            while not ticking.wait(0.25):
                engine.evaluate()

        tick_thread = None
        if engine is not None:
            tick_thread = threading.Thread(target=ticker, daemon=True)
            tick_thread.start()
        threads = [
            threading.Thread(target=consumer, args=(c,), name=f"ra-{c}")
            for c in range(RA_CONSUMERS)
        ]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        elapsed_s = time.monotonic() - t0
        if manager is not None:
            # Drain in-flight speculation before counting device launches.
            manager.close()
        else:
            cache.close()
        if tick_thread is not None:
            ticking.set()
            tick_thread.join(timeout=10)
        assert errors == [], f"byte diffs from replay streams {errors[:5]}"
        stats = backend.dispatch_stats
        sorted_lat = sorted(latencies_ms)
        total_reads = (
            RA_CONSUMERS * RA_SEGMENTS_PER_CONSUMER
            * (RA_CHUNKS_PER_SEGMENT // RA_FG_WINDOW)
        )
        assert len(latencies_ms) == total_reads, len(latencies_ms)
        mode = {
            "streams": RA_CONSUMERS,
            "reads": total_reads,
            "elapsed_s": round(elapsed_s, 2),
            "replay_p50_ms": round(percentile(sorted_lat, 0.50), 3),
            "replay_p99_ms": round(percentile(sorted_lat, 0.99), 3),
            "gcm_launches": stats.dispatches,
            "decrypt_windows": stats.windows,
            "ranged_gets": fetcher.reads,
        }
        if manager is not None:
            ring = recorder.slowest() + recorder.failures()
            verdicts = engine.evaluate()
            spec = verdicts["specs"]["readahead-misprediction"]
            mode.update({
                "windows_launched": manager.windows_launched,
                "chunks_speculated": manager.chunks_speculated,
                "hit_rate": round(manager.hit_rate, 4),
                "misprediction_ratio": round(manager.misprediction_ratio, 4),
                "misprediction_max_ratio": manager.misprediction_max_ratio,
                "wasted_bytes": manager.wasted_bytes,
                "budget_deferrals": manager.budget_deferrals,
                "ratio_throttles": manager.ratio_throttles,
                "cross_segment_continuations": (
                    manager.cross_segment_continuations
                ),
                "mean_pre_admit_age_ms": round(
                    manager.mean_pre_admit_age_ms, 2
                ),
                "slo_ok": verdicts["ok"],
                "slo_samples": spec["samples"],
                "slo_compliance": spec["compliance"],
                "flight_readahead_window_records": sum(
                    1 for rec in ring if rec.name == "readahead.window"
                ),
            })
        backend.close()
        return mode

    return {"readahead_on": run_mode(readahead=True),
            "readahead_off": run_mode(readahead=False)}


def readahead_ab_phase() -> dict:
    """Cold massed sequential replay, readahead ON vs OFF over identical
    stores: RA_CONSUMERS concurrent consumers each
    replay a chain of RA_SEGMENTS_PER_CONSUMER segments front to back in
    RA_FG_WINDOW-chunk reads, with NO warm pass. The readahead run must
    win on BOTH replay p99 and total GCM launches (speculative
    RA_SPEC_WINDOW-chunk windows merge foreground windows into fewer
    ranged GETs and fewer batched decrypts), keep the cold steady-state
    hit rate >= RA_HIT_RATE_FLOOR, keep wasted speculative decrypt bytes
    within readahead.misprediction.max.ratio, and the
    readahead-misprediction SLO spec (the exact RatioSource the rsm
    wires) must verdict ok with real samples. Launch visibility:
    the flight recorder must retain synthetic ``readahead.window``
    records from the background launches."""
    ab = readahead_ab_modes()
    on, off = ab["readahead_on"], ab["readahead_off"]
    # readahead must WIN on both latency and
    # total device launches in the same run over identical stores...
    assert on["replay_p99_ms"] < off["replay_p99_ms"], (on, off)
    assert on["gcm_launches"] < off["gcm_launches"], (on, off)
    assert on["ranged_gets"] < off["ranged_gets"], (on, off)
    # ...with a cold steady-state hit rate above the floor (NO warm pass
    # happened: every consumed chunk was speculated before first use)...
    assert on["windows_launched"] > 0, on
    assert on["hit_rate"] >= RA_HIT_RATE_FLOOR, on
    # ...wasted speculative decrypt bytes within the configured bound,
    # judged by the SLO engine's own verdict over the live ratio...
    assert on["misprediction_ratio"] <= on["misprediction_max_ratio"], on
    assert on["slo_ok"], on
    assert on["slo_samples"] > 0, "readahead SLO judged with no samples"
    # ...chains continued across every segment boundary, and the
    # launches are attributable (synthetic readahead.window records).
    assert on["cross_segment_continuations"] == (
        RA_CONSUMERS * (RA_SEGMENTS_PER_CONSUMER - 1)
    ), on
    assert on["flight_readahead_window_records"] > 0, on
    ab["p99_speedup"] = round(
        off["replay_p99_ms"] / max(on["replay_p99_ms"], 1e-9), 2
    )
    ab["launch_reduction"] = round(
        1.0 - on["gcm_launches"] / max(off["gcm_launches"], 1), 4
    )
    return ab


# ------------------------------------------- fleet-stitched timeline phase
def assert_disabled_timeline_zero_work() -> bool:
    """``timeline.enabled=false`` must be ZERO work on the flush path (the
    LockWitness pattern): poison the recorder's lock so ANY acquisition
    raises, drive the whole recording surface, and require untouched
    counters and an empty ring."""
    from tieredstorage_tpu_torch.metrics.timeline import TimelineRecorder

    class _PoisonLock:
        def __enter__(self):
            raise AssertionError("disabled timeline acquired its lock")

        def __exit__(self, *exc):  # pragma: no cover — never entered
            return False

    recorder = TimelineRecorder(enabled=False)
    recorder._lock = _PoisonLock()
    recorder.record_flush(
        batch_id=7, work_class="latency", decrypt=True, bucket_bytes=4096,
        rows=2, n_bytes=8192, occupancy=2, queued_age_ms=1.0,
        begin_s=0.0, end_s=0.001,
    )
    recorder.record_expired("background", 1)
    assert recorder.events_recorded == 0, recorder.events_recorded
    assert recorder.launches_recorded == 0
    assert recorder.expired_recorded == 0
    assert len(recorder._ring) == 0
    return True


def drive_exemplar_launch(rsm, trace_id: str) -> None:
    """The JAX gate's degraded mode (a fleet made with `make_rsm(..., None)`,
    unencrypted): no fetch decrypts ride the device scheduler, so the
    exemplar's launch evidence is produced by the SAME machinery directly —
    one real GCM
    window submitted through this instance's live batcher under an
    ambient flight record carrying the exemplar's trace id. The batcher
    captures the trace id at enqueue, the merged flush records a real
    timeline event, and the record gets the ``gcm.batch:<id>`` stage the
    stitcher joins on; only the RSA key-wrap is skipped."""
    import numpy as np

    from tieredstorage_tpu_torch.security.aes import (
        IV_SIZE,
        TAG_SIZE,
        AesEncryptionProvider,
    )
    from tieredstorage_tpu_torch.transform.api import TransformOptions
    from tieredstorage_tpu_torch.utils import flightrecorder

    recorder = rsm.flight_recorder
    backend = rsm._transform_backend
    batcher = backend.batcher
    dk = AesEncryptionProvider.create_data_key_and_aad()
    plain = bytes(range(256)) * 8
    (wire,) = backend.transform(
        [plain], TransformOptions(encryption=dk, ivs=[b"\x01" * IV_SIZE])
    )
    # Park the fast path so the submit queues and flushes as a MERGED
    # launch with a batch id (the idle fast path dispatches inline,
    # id-less). Nothing else uses the batcher when encryption is off.
    with batcher._cond:
        batcher._inflight += 1

    def submit() -> None:
        with recorder.request("gcm.exemplar", trace_id=trace_id):
            out = batcher.submit(
                dk, [wire[IV_SIZE:-TAG_SIZE]],
                [len(wire) - IV_SIZE - TAG_SIZE],
                np.stack([np.frombuffer(wire[:IV_SIZE], np.uint8)]),
                [wire[-TAG_SIZE:]],
            )
            assert out == [plain], "exemplar decrypt round-trip failed"
            flushes = [
                e for e in rsm.timeline.events() if e["kind"] == "flush"
            ]
            flightrecorder.stage(f"gcm.batch:{flushes[-1]['batch_id']}")
            # The slow ring keeps the slowest ring_size records; outlast
            # its fastest so this evidence is retained (unencrypted
            # fetches are all sub-launch fast, so the floor is tiny).
            retained = recorder.slowest()
            if len(retained) >= recorder.ring_size:
                time.sleep(min(retained[-1].duration_ms / 1000 + 0.005, 0.5))

    worker = threading.Thread(target=submit, name="timeline-exemplar")
    worker.start()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        with batcher._cond:
            if sum(len(v) for v in batcher._buckets.values()):
                break
        time.sleep(0.001)
    assert batcher.flush_now() == 1, "exemplar launch did not flush"
    with batcher._cond:
        batcher._inflight -= 1
    worker.join(timeout=30)


def timeline_phase(
    gateways, rsms, survivors, tmp: pathlib.Path, breaches: list,
    artifact_path: pathlib.Path,
) -> dict:
    """Assemble ONE real request's fleet-wide
    timeline and prove it spans instances and joins a merged device launch.

    A fresh ENCRYPTED segment is produced, then TIMELINE_FETCHERS
    concurrent full-segment fetches through one origin gateway fan
    per-chunk ``/chunk`` forwards across the survivors (cross-instance
    hops sharing the traceparent) while the cold chunks decrypt through
    the batched device scheduler (concurrent windows -> merged launches
    with batch ids). The exemplar is the fetch-latency SLO's
    breach-evidence trace when a breach happened, else the slowest
    retained flight record that stitches; its assembled timeline must
    span >= 2 instances and carry >= 1 request->launch flow edge, and the
    Chrome trace it exports is schema-validated before being written as
    the committed artifact."""
    origin = survivors[0]
    port = gateways[origin].port

    md, data, payload = make_segment(BASE_SEGMENTS + PRODUCED_SEGMENTS, tmp)
    status, body = http_copy(port, md, data)
    assert status in (200, 204), (status, body)

    errors: list = []
    barrier = threading.Barrier(TIMELINE_FETCHERS)

    def fetch_full(i: int) -> None:
        try:
            barrier.wait(timeout=30)
        except threading.BrokenBarrierError:
            pass
        try:
            st, got = http_fetch(port, md, 0, len(payload) - 1)
        except OSError:
            st, got = -1, b""
        if st != 200 or got != payload:
            errors.append((i, st))

    threads = [
        threading.Thread(target=fetch_full, args=(i,), name=f"timeline-{i}")
        for i in range(TIMELINE_FETCHERS)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert errors == [], f"timeline burst byte/status errors: {errors[:5]}"

    # Candidate exemplars in order of preference: SLO
    # breach-evidence traces first (there are none when the gates above
    # passed, but a breaching run must still produce its timeline), then
    # the slowest-first flight dump. The overload phase leaves slow
    # UNencrypted records (instances-spanning, launch-free), so the search
    # walks until one candidate satisfies BOTH gates.
    candidates: list[str] = []
    for breach in breaches:
        for e in breach["verdict"].get("evidence", {}).get(
            "exemplars_over_threshold", []
        ):
            candidates.append(e["trace_id"])
    breach_traces = set(candidates)
    status, dump = http_json(
        port, f"/debug/requests?slowest={TIMELINE_CANDIDATES}"
    )
    assert status == 200, dump
    candidates.extend(r["trace_id"] for r in dump["slowest"])

    telemetry = rsms[origin].fleet_telemetry
    chosen = assembled = None
    considered = 0
    seen: set = set()
    for trace_id in candidates:
        if not trace_id or trace_id in seen:
            continue
        seen.add(trace_id)
        considered += 1
        stitched = telemetry.assemble_trace(trace_id)
        if len(stitched["span_instances"]) >= 2 and stitched["flow_edges"]:
            chosen, assembled = trace_id, stitched
            break
    assert assembled is not None, (
        f"no exemplar stitched across >=2 instances with launch evidence "
        f"among {considered} candidates"
    )

    from tieredstorage_tpu_torch.metrics.timeline import validate_chrome_events

    n_events = validate_chrome_events(assembled["chrome_trace"]["traceEvents"])
    assert n_events > 0

    # The origin's scheduler timeline is live over HTTP too (the route the
    # stitcher used against the peers).
    status, tl = http_json(port, "/debug/timeline")
    assert status == 200 and tl["enabled"], tl
    assert tl["launches_recorded"] > 0, tl

    artifact_path.parent.mkdir(parents=True, exist_ok=True)
    artifact_path.write_text(json.dumps(assembled, indent=1))

    return {
        "exemplar_trace": chosen,
        "exemplar_source": (
            "breach-evidence" if chosen in breach_traces
            else "slowest-flight-record"
        ),
        "candidates_considered": considered,
        "origin": origin,
        "span_instances": assembled["span_instances"],
        "hop_edges": len(assembled["hop_edges"]),
        "flow_edges": len(assembled["flow_edges"]),
        "chrome_events": n_events,
        "scheduler_launches_recorded": tl["launches_recorded"],
        "unreachable": assembled["unreachable"],
        "disabled_mode_zero_work": assert_disabled_timeline_zero_work(),
        "artifact": str(artifact_path),
    }


def percentile(sorted_values: list[float], q: float) -> float:
    if not sorted_values:
        raise ValueError("percentile of an empty sample set is undefined")
    rank = max(1, int(round(q * len(sorted_values) + 0.5)))
    return sorted_values[min(rank, len(sorted_values)) - 1]


def _launches_since(before: dict) -> dict:
    return {name: n - before.get(name, 0) for name, n in _cuda.launch_counts().items()}


def run(out_path: pathlib.Path, device: str = "cuda:0") -> int:
    global DEVICE
    DEVICE = device
    launches_at_start = _cuda.launch_counts()
    rows_at_start = _cuda.launch_rows()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="torch-load-demo-"))
    (tmp / "replica-a").mkdir()
    (tmp / "replica-b").mkdir()

    all_segments = [
        make_segment(i, tmp) for i in range(BASE_SEGMENTS + PRODUCED_SEGMENTS)
    ]
    base_segments = all_segments[:BASE_SEGMENTS]
    to_produce = all_segments[BASE_SEGMENTS:]

    # Seed the store through a plain loader (no fleet/SLO counters burned).
    loader = RemoteStorageManager()
    loader.configure({
        **storage_configs(tmp), "chunk.size": CHUNK, "key.prefix": KEY_PREFIX,
        "transform.device": DEVICE,
    })
    for md, data, _ in base_segments:
        loader.copy_log_segment_data(md, data)
    loader.close()

    keys = generate_key_pair_pem_files(tmp, prefix="load")
    rsms = {name: make_rsm(name, tmp, keys) for name in INSTANCES}

    # Warm the contexts and kernels for the decrypt shapes the encrypted
    # fleet path can launch (the capacity probe's idiom, same reasoning):
    # fixed 1-row fast-path windows plus the 8/16-row merged varlen ladder
    # (transform.batch.windows=16, 1-row chunk windows); a one-time cost
    # inside the judged window would make the fetch-latency SLO judge the
    # warm-up. The context cache and the kernels are process-wide, so one
    # backend warms all.
    warm_backend = rsms[INSTANCES[0]]._transform_backend
    warm_decrypt_shapes(warm_backend, CHUNK, (1, CHUNKS_PER_SEGMENT), (8, 16))
    warm_backend.reset_dispatch_stats()
    launches: dict = {}
    fleet_launches_from = _cuda.launch_counts()

    gateways = {n: SidecarHttpGateway(r).start() for n, r in rsms.items()}
    peers = {n: f"http://127.0.0.1:{g.port}" for n, g in gateways.items()}
    for r in rsms.values():
        r.set_fleet_peers(peers)

    coord = Coordinator(gateways, rsms, tmp)
    # The fetchable population grows as the producer lands new segments.
    population_lock = threading.Lock()
    population: list[tuple[RemoteLogSegmentMetadata, bytes]] = [
        (md, payload) for md, _, payload in base_segments
    ]

    def producer() -> None:
        """The produce stream: upload new segments through the gateways
        while the fetch load runs (closed-loop: next upload starts when
        the previous finished)."""
        rng = random.Random(SEED ^ 0xBEEF)
        for md, data, payload in to_produce:
            # Pace produces across the run (one per ~sixth of the load).
            while coord.requests < TOTAL_REQUESTS // (PRODUCED_SEGMENTS + 1):
                time.sleep(0.05)
            for attempt in range(4):
                port = coord.alive_port(rng)
                try:
                    status, _ = http_copy(port, md, data)
                except OSError:
                    status = -1
                if status in (200, 204):
                    break
            else:
                raise AssertionError(f"produce failed after retries: {status}")
            with population_lock:
                population.append((md, payload))

    def worker(wid: int) -> None:
        rng = random.Random(SEED + wid)
        for _ in range(REQUESTS_PER_WORKER):
            time.sleep(PACING_S)
            coord.next_request()
            with population_lock:
                pop = list(population)
            weights = [
                1.0 / (rank + 1) ** ZIPF_EXPONENT
                for rank in range(len(pop) * CHUNKS_PER_SEGMENT)
            ]
            flat = rng.choices(
                range(len(pop) * CHUNKS_PER_SEGMENT), weights=weights
            )[0]
            md, payload = pop[flat // CHUNKS_PER_SEGMENT]
            chunk = flat % CHUNKS_PER_SEGMENT
            start = chunk * CHUNK
            end = min(start + CHUNK - 1, len(payload) - 1)
            expected = payload[start:end + 1]
            t0 = time.monotonic()
            retried = False
            for attempt in (1, 2):
                port = coord.alive_port(rng)
                try:
                    status, got = http_fetch(port, md, start, end)
                except OSError:
                    # The dying gateway dropped us mid-kill: retry once on
                    # a survivor (the client-side failover contract).
                    status, got = -1, b""
                if status == 200:
                    break
                retried = True
                with coord.lock:
                    coord.client_errors += 1
            coord.record(
                status, got == expected,
                (time.monotonic() - t0) * 1000.0, retried,
            )

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(WORKERS)]
    threads.append(threading.Thread(target=producer))
    run_started = time.monotonic()
    for t in threads:
        t.start()
    # The scrape loop: the SLO engines tick on every /slo read (the
    # Prometheus model — scrapes drive the burn-rate windows).
    scrape_count = 0
    while any(t.is_alive() for t in threads):
        time.sleep(0.25)
        with coord.lock:
            alive = list(coord.alive)
        for name in alive:
            try:
                http_json(gateways[name].port, "/slo")
                scrape_count += 1
            except OSError:
                pass
    for t in threads:
        t.join(timeout=120)
    run_elapsed_s = time.monotonic() - run_started

    report: dict = {
        "workload": {
            "workers": WORKERS,
            "requests": TOTAL_REQUESTS,
            "produced_segments": PRODUCED_SEGMENTS,
            "zipf_exponent": ZIPF_EXPONENT,
            "seed": SEED,
            "deadline_ms": DEADLINE_MS,
        },
        "chaos": {
            "replica_killed_at_request": coord.replica_killed_at,
            "instance_killed": VICTIM_INSTANCE,
            "instance_killed_at_request": coord.instance_killed_at,
        },
        "slo_scrapes": scrape_count,
        "device": DEVICE,
        "launches": launches,
    }
    try:
        # ------------------------------------------------- client evidence
        assert coord.statuses.get(200, 0) == TOTAL_REQUESTS, dict(coord.statuses)
        assert coord.byte_diffs == 0, f"{coord.byte_diffs} byte diffs"
        assert len(population) == BASE_SEGMENTS + PRODUCED_SEGMENTS
        latencies = sorted(coord.latencies_ms)
        p50 = percentile(latencies, 0.50)
        p99 = percentile(latencies, 0.99)
        report["client"] = {
            "statuses": dict(coord.statuses),
            "byte_diffs": coord.byte_diffs,
            "retries": coord.retries,
            "client_errors": coord.client_errors,
            "p50_ms": round(p50, 2),
            "p99_ms": round(p99, 2),
        }
        assert p99 <= DEADLINE_MS, f"client p99 {p99:.0f}ms over budget"

        survivors = [n for n in INSTANCES if n != VICTIM_INSTANCE]

        # ---------------------------------------------------- SLO verdicts
        breaches: list[dict] = []
        slo_section: dict = {}
        for name in survivors:
            status, verdicts = http_json(gateways[name].port, "/slo")
            assert status == 200, (name, verdicts)
            specs = verdicts["specs"]
            # The p99 gate is the ENGINE's own verdict over the real
            # histogram — samples prove it wasn't computed from thin air.
            latency = specs["fetch-latency"]
            assert latency["samples"] > 0, f"{name}: no latency samples"
            # The burn-rate math engaged on real data: the run is paced to
            # span the long window, which covers the cold-fetch phase. The
            # SHORT window may legitimately be None at the end of the run —
            # a warm cache means zero chunk-fetch events in the last 800 ms,
            # and the degenerate contract says "no events" is None, never a
            # fabricated 0.0.
            assert latency["burn_rate_long"] is not None, latency
            shed = specs["shed-rate"]
            slo_section[name] = {
                "ok": verdicts["ok"],
                "burning": verdicts["burning"],
                "fetch_latency": {
                    "samples": latency["samples"],
                    "compliance": latency["compliance"],
                    "error_budget_remaining": latency["error_budget_remaining"],
                    "burn_rate_short": latency["burn_rate_short"],
                    "burn_rate_long": latency["burn_rate_long"],
                },
                "shed_rate_compliance": shed["compliance"],
            }
            for spec_name, verdict in specs.items():
                if not verdict["ok"]:
                    # Breach: attach the engine's evidence AND resolve its
                    # exemplar trace ids against the flight recorder —
                    # directly via the ?trace= filter, not by
                    # dumping everything and grepping client-side.
                    exemplars = verdict.get("evidence", {}).get(
                        "exemplars_over_threshold", []
                    )
                    matching = []
                    for e in exemplars:
                        status, hit = http_json(
                            gateways[name].port,
                            "/debug/requests?trace=" + e["trace_id"],
                        )
                        if status == 200:
                            matching.extend(hit["slowest"])
                    breaches.append({
                        "instance": name,
                        "spec": spec_name,
                        "verdict": verdict,
                        "flight_records": matching,
                    })
        report["slo"] = slo_section
        report["breaches"] = breaches
        assert not breaches, json.dumps(breaches, indent=1)

        # ------------------------------------------- overload + recovery
        # saturate one survivor's admission window so
        # the shed-rate SLO BITES (>0 sheds, the engine reports the
        # burn/budget damage), then refill the budget with ordinary
        # traffic and prove every survivor's verdicts are all-ok AGAIN —
        # overload is an SLO event, not an outage. (This runs AFTER the
        # main verdicts above, whose burn-rate-engaged assertions are
        # only meaningful right at the end of the workload.)
        overload_target = survivors[0]
        overload_md, overload_payload = population[0]
        overload = overload_phase(
            gateways, rsms, overload_target, overload_md, overload_payload
        )
        assert overload["sheds"] > 0, overload
        bite = overload["shed_verdict_during"]
        assert (
            not bite["ok"]
            or bite["burning"]
            or (bite["burn_rate_short"] or 0.0) > 1.0
            or (bite["burn_rate_long"] or 0.0) > 1.0
        ), f"shed-rate SLO did not bite: {bite}"
        overload.update(recovery_phase(
            gateways, rsms, overload_target, overload_md, overload_payload
        ))
        assert overload["shed_verdict_after"]["ok"], overload
        # Recovery gate: every survivor's cumulative verdicts all-ok
        # again (burn windows may be event-free this long after the run —
        # the degenerate contract reports those as None, not breaches).
        recovered = {}
        for name in survivors:
            status, verdicts = http_json(gateways[name].port, "/slo")
            assert status == 200, (name, verdicts)
            recovered[name] = verdicts["ok"]
        overload["recovered_all_ok"] = recovered
        assert all(recovered.values()), recovered
        report["overload"] = overload

        # ------------------------------------------------- fleet telemetry
        status, scrape = http_json(
            gateways[survivors[0]].port, "/fleet/telemetry?aggregate=1"
        )
        assert status == 200, scrape
        fleet = scrape["fleet"]
        failovers = fleet.get(
            "replication-metrics:replica-failovers-total", {}
        ).get("value", 0.0)
        assert failovers >= 1, "replica kill produced no failovers"
        hits = fleet.get(
            "cache-metrics:cache-hits-total{cache=chunk-cache}", {}
        ).get("value", 0.0)
        misses = fleet.get(
            "cache-metrics:cache-misses-total{cache=chunk-cache}", {}
        ).get("value", 0.0)
        cache_tier_rate = hits / (hits + misses) if hits + misses else 0.0
        sheds = fleet.get(
            "resilience-metrics:admission-shed-total", {}
        ).get("value", 0.0)
        admitted = fleet.get(
            "resilience-metrics:admission-admitted-total", {}
        ).get("value", 0.0)
        shed_rate = sheds / (sheds + admitted) if sheds + admitted else 0.0
        report["fleet_telemetry"] = {
            "members": scrape["members"],
            # a dead gateway is diagnosable from the
            # scrape artifact alone — (member, reason) pairs, not a count.
            "unreachable": scrape["unreachable"],
            "replica_failovers_total": failovers,
            "chunk_cache_hits": hits,
            "chunk_cache_misses": misses,
            "cache_tier_rate": round(cache_tier_rate, 4),
            "admission_shed_total": sheds,
            "shed_rate": round(shed_rate, 4),
            "aggregated_stats": len(fleet),
        }
        assert cache_tier_rate >= 0.5, f"cache tier {cache_tier_rate:.0%}"
        assert shed_rate <= SHED_MAX_PERCENT / 100.0, f"shed rate {shed_rate:.1%}"
        # The dead member either left the membership view (re-ring) or
        # shows as unreachable — never as a healthy contributor.
        victim_status = scrape["members"].get(VICTIM_INSTANCE)
        assert victim_status is None or victim_status["reachable"] is False, (
            victim_status
        )
        # And when it IS still in the view, the scrape names it with the
        # failure reason — diagnosable from the artifact alone.
        if victim_status is not None:
            assert any(
                member == VICTIM_INSTANCE and reason
                for member, reason in scrape["unreachable"]
            ), scrape["unreachable"]

        # -------------------------------------------------- flight records
        flight_section = {}
        for name in survivors:
            # ?slowest=: ask for exactly the N slowest instead
            # of dumping both rings and trimming client-side.
            status, dump = http_json(
                gateways[name].port, "/debug/requests?slowest=3"
            )
            assert status == 200, (name, dump)
            assert dump["requests_seen"] > 0
            slowest = dump["slowest"]
            assert slowest and any(r["tiers"] for r in slowest), (
                f"{name}: no tier evidence in flight records"
            )
            flight_section[name] = {
                "requests_seen": dump["requests_seen"],
                "requests_failed": dump["requests_failed"],
                "top_slowest": [
                    {
                        "name": r["name"],
                        "duration_ms": r["duration_ms"],
                        "tiers": r["tiers"],
                        "deadline_entry_ms": r["deadline_entry_ms"],
                    }
                    for r in slowest
                ],
            }
        report["flight"] = flight_section

        # -------------------------------------- scrub under chaos
        # The integrity daemons ran INSIDE the chaos window: every survivor
        # must show scrub + anti-entropy progress strictly AFTER the
        # replica kill opened the window, with zero corruption found and —
        # established above — every SLO verdict still all-ok. The victim's
        # daemons are irrelevant: its gateway is dead, its counters frozen.
        assert coord.scrub_at_chaos is not None, "chaos window never opened"
        scrub_section = {}
        for name in survivors:
            scrubber = rsms[name].scrubber
            ae = rsms[name].antientropy
            at_kill = coord.scrub_at_chaos[name]
            scrub_section[name] = {
                "passes": scrubber.passes,
                "chunks_verified_total": scrubber.chunks_verified_total,
                "chunks_verified_at_chaos": at_kill["chunks_verified"],
                "bytes_scanned_total": scrubber.bytes_scanned_total,
                "corrupt_chunks_total": scrubber.corrupt_chunks_total,
                "missing_objects_total": scrubber.missing_objects_total,
                "antientropy_passes": ae.passes,
                "antientropy_passes_at_chaos": at_kill["antientropy_passes"],
                "antientropy_repairs_total": ae.repairs_total,
                "antientropy_diffs_total": ae.diffs_total,
            }
            assert scrubber.passes > 0, f"{name}: scrubber never ran"
            assert (
                scrubber.chunks_verified_total > at_kill["chunks_verified"]
            ), f"{name}: no scrub verification inside the chaos window"
            assert ae.passes > at_kill["antientropy_passes"], (
                f"{name}: no anti-entropy pass inside the chaos window"
            )
            # The store is healthy modulo the staged kill: the scrubber
            # must not cry corruption (transient orphan findings from
            # produces in flight are expected and benign — repair is off).
            assert scrubber.corrupt_chunks_total == 0, scrub_section[name]
        report["scrub_under_chaos"] = scrub_section

        # ---------------------------------------- fleet-stitched timeline
        launches["fleet"] = _launches_since(fleet_launches_from)
        phase_from = _cuda.launch_counts()
        report["timeline"] = timeline_phase(
            gateways, rsms, survivors, tmp, breaches,
            out_path.parent / "torch_timeline.json",
        )
        launches["timeline"] = _launches_since(phase_from)
        assert len(report["timeline"]["span_instances"]) >= 2, report["timeline"]
        assert report["timeline"]["flow_edges"] >= 1, report["timeline"]
        assert report["timeline"]["disabled_mode_zero_work"] is True

        # ------------------------------------------------ capacity probe
        # The massed consumer-group-replay phase at >= 512 concurrent
        # streams with cross-request batching on vs the batching-off
        # control (asserts its own gates; the probe's batcher lock sites
        # also feed the witness verdict below).
        phase_from = _cuda.launch_counts()
        report["capacity_probe"] = capacity_probe(PROBE_STREAMS)
        launches["capacity_probe"] = _launches_since(phase_from)

        # -------------------------------------------- readahead A/B
        # Cold massed sequential replay with the predictive-readahead tier
        # on vs off over identical stores: on must win BOTH replay p99 and
        # total GCM launches, with the hit-rate / misprediction / SLO
        # gates asserted inside the phase.
        phase_from = _cuda.launch_counts()
        report["readahead_ab"] = readahead_ab_phase()
        launches["readahead_ab"] = _launches_since(phase_from)
        launches["total"] = _launches_since(launches_at_start)
        rows_now = _cuda.launch_rows()
        report["launch_rows"] = {
            name: {str(rows): n - rows_at_start[name].get(rows, 0)
                   for rows, n in by_rows.items() if n > rows_at_start[name].get(rows, 0)}
            for name, by_rows in rows_now.items()
        }

        # ------------------------------------------------- witness verdict
        report["witness"] = witness_verdict()

        report["run_elapsed_s"] = round(run_elapsed_s, 2)
        report["throughput_rps"] = round(
            TOTAL_REQUESTS / max(run_elapsed_s, 1e-9), 1
        )
    finally:
        for g in gateways.values():
            try:
                g.stop()  # idempotent: the victim's is already down
            except Exception:
                pass
        for r in rsms.values():
            r.close()

    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=1))

    # ------------------------------------------------ artifact re-validation
    parsed = json.loads(out_path.read_text())
    assert parsed["client"]["byte_diffs"] == 0
    assert parsed["breaches"] == []
    assert all(v["ok"] for v in parsed["slo"].values())
    assert all(
        v["fetch_latency"]["samples"] > 0 for v in parsed["slo"].values()
    )
    assert parsed["fleet_telemetry"]["replica_failovers_total"] >= 1
    assert parsed["fleet_telemetry"]["shed_rate"] <= SHED_MAX_PERCENT / 100.0
    assert parsed["witness"]["lock_violations"] == []
    assert parsed["witness"]["race_violations"] == []
    assert all(f["requests_seen"] > 0 for f in parsed["flight"].values())
    assert parsed["chaos"]["replica_killed_at_request"] == KILL_REPLICA_AT
    assert parsed["chaos"]["instance_killed_at_request"] == KILL_INSTANCE_AT
    assert parsed["overload"]["sheds"] > 0
    assert parsed["overload"]["shed_verdict_after"]["ok"]
    probe = parsed["capacity_probe"]
    assert probe["batched"]["streams"] >= 512
    assert probe["batched"]["byte_errors"] == 0
    assert probe["unbatched_control"]["byte_errors"] == 0
    assert probe["batched"]["batch_mean_occupancy"] > 1.0
    assert (
        probe["batched"]["dispatches_per_window"]
        < probe["unbatched_control"]["dispatches_per_window"]
    )
    assert probe["batched"]["slo_ok"] and probe["unbatched_control"]["slo_ok"]
    assert probe["batched_with_scrub"]["slo_ok"]
    assert probe["batched_with_scrub"]["scrub"]["chunks_verified"] > 0
    assert probe["batched_with_scrub"]["scrub"]["byte_errors"] == 0
    assert probe["batched_with_scrub"]["scrub"]["background_windows_flushed"] > 0
    ab = parsed["readahead_ab"]
    assert (
        ab["readahead_on"]["replay_p99_ms"]
        < ab["readahead_off"]["replay_p99_ms"]
    )
    assert (
        ab["readahead_on"]["gcm_launches"]
        < ab["readahead_off"]["gcm_launches"]
    )
    assert ab["readahead_on"]["hit_rate"] >= RA_HIT_RATE_FLOOR
    assert (
        ab["readahead_on"]["misprediction_ratio"]
        <= ab["readahead_on"]["misprediction_max_ratio"]
    )
    assert ab["readahead_on"]["slo_ok"]
    assert ab["readahead_on"]["flight_readahead_window_records"] > 0
    scrub_chaos = parsed["scrub_under_chaos"]
    assert all(
        v["chunks_verified_total"] > v["chunks_verified_at_chaos"]
        for v in scrub_chaos.values()
    )
    assert all(
        v["antientropy_passes"] > v["antientropy_passes_at_chaos"]
        for v in scrub_chaos.values()
    )
    assert all(v["corrupt_chunks_total"] == 0 for v in scrub_chaos.values())
    # The fleet-stitched timeline artifact: re-read,
    # re-validate the Chrome schema, re-check the acceptance gates.
    from tieredstorage_tpu_torch.metrics.timeline import validate_chrome_events

    timeline_artifact = json.loads(
        (out_path.parent / "torch_timeline.json").read_text()
    )
    assert timeline_artifact["trace_id"] == parsed["timeline"]["exemplar_trace"]
    assert len(timeline_artifact["span_instances"]) >= 2, timeline_artifact
    assert len(timeline_artifact["flow_edges"]) >= 1, timeline_artifact
    assert validate_chrome_events(
        timeline_artifact["chrome_trace"]["traceEvents"]
    ) > 0
    assert parsed["timeline"]["disabled_mode_zero_work"] is True
    assert parsed["fleet_telemetry"]["unreachable"] is not None
    print(
        f"TORCH_LOAD_DEMO_OK requests={TOTAL_REQUESTS} "
        f"p50={parsed['client']['p50_ms']}ms p99={parsed['client']['p99_ms']}ms "
        f"failovers={parsed['fleet_telemetry']['replica_failovers_total']} "
        f"cache_tier={parsed['fleet_telemetry']['cache_tier_rate']} "
        f"shed_rate={parsed['fleet_telemetry']['shed_rate']} "
        f"slo_ok={all(v['ok'] for v in parsed['slo'].values())} "
        f"overload_sheds={parsed['overload']['sheds']} "
        f"probe_streams={probe['batched']['streams']} "
        f"probe_occupancy={probe['batched']['batch_mean_occupancy']} "
        f"probe_dpw={probe['batched']['dispatches_per_window']} "
        f"(control {probe['unbatched_control']['dispatches_per_window']}) "
        f"scrub_chunks="
        f"{sum(v['chunks_verified_total'] for v in scrub_chaos.values())} "
        f"isolation_p99="
        f"{probe['isolation']['fetch_p99_ms_with_scrub']}ms"
        f"(no-scrub {probe['isolation']['fetch_p99_ms_without_scrub']}ms) "
        f"scrub_mibs={probe['isolation']['scrub_verify_mibs_during_storm']} "
        f"timeline_span={len(parsed['timeline']['span_instances'])} "
        f"timeline_flow_edges={parsed['timeline']['flow_edges']} "
        f"byte_diffs=0 out={out_path}"
    )
    return 0


#: The phases `--phases` can run alone, in the gate's order: those that
#: build their own chains and pass on their own in the JAX gate.
ALONE = ("capacity_probe", "readahead_ab")


def witness_verdict() -> dict:
    """The gate's last section: the lock-order witness and the race
    checker's runtime cross-check; fails on any violation."""
    from tieredstorage_tpu_torch.analysis import races
    from tieredstorage_tpu_torch.utils.locks import witness, witness_enabled

    crosscheck = races.runtime_crosscheck()
    verdict = {
        "enabled": witness_enabled(),
        "lock_edges": len(witness().edges()),
        "lock_violations": list(witness().violations),
        "race_sites_validated": len(crosscheck["validated"]),
        "race_violations": crosscheck["violations"],
    }
    assert not witness().violations, witness().violations
    assert not crosscheck["violations"], crosscheck["violations"]
    return verdict


def run_phases(out_path: pathlib.Path, device: str, phases) -> int:
    """Run only `phases` (of ALONE, in the gate's order, each with its own
    checks) at the gate's constants, then the witness verdict; the report
    holds their sections, `launches` and `launch_rows` as `run()`'s does."""
    global DEVICE
    DEVICE = device
    at_start, rows_at_start = _cuda.launch_counts(), _cuda.launch_rows()
    report: dict = {"device": DEVICE, "phases": list(phases), "launches": {}}
    calls = {"capacity_probe": lambda: capacity_probe(PROBE_STREAMS),
             "readahead_ab": readahead_ab_phase}
    for phase in ALONE:
        if phase in phases:
            t0 = time.monotonic()
            phase_from = _cuda.launch_counts()
            report[phase] = calls[phase]()
            report["launches"][phase] = _launches_since(phase_from)
            report[f"{phase}_s"] = round(time.monotonic() - t0, 2)
    report["launches"]["total"] = _launches_since(at_start)
    report["launch_rows"] = {
        name: {str(rows): n - rows_at_start[name].get(rows, 0)
               for rows, n in by_rows.items() if n > rows_at_start[name].get(rows, 0)}
        for name, by_rows in _cuda.launch_rows().items()
    }
    report["witness"] = witness_verdict()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=1))
    print(f"TORCH_LOAD_DEMO_PHASES_OK phases={','.join(report['phases'])} out={out_path}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--out", default=str(REPO_ROOT / "artifacts" / "torch_load_report.json"),
        help="load report JSON output path",
    )
    parser.add_argument("--device", default="cuda:0",
                        help="cuda:N (default cuda:0) or cpu for the plain versions")
    parser.add_argument("--phases", help="run only these phases, comma-separated, of "
                        + ", ".join(ALONE) + " (default: the whole gate)")
    args = parser.parse_args(argv)
    phases = args.phases.split(",") if args.phases else None
    if phases and not set(phases) <= set(ALONE):
        parser.error(f"--phases takes {', '.join(ALONE)}")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("torch_load_demo: CUDA is not available; pass --device cpu to run "
              "the plain versions on the CPU", file=sys.stderr)
        return 2
    if phases:
        return run_phases(pathlib.Path(args.out), args.device, phases)
    return run(pathlib.Path(args.out), args.device)


if __name__ == "__main__":
    sys.exit(main())
