"""Fleet demo of the PyTorch/CUDA port: 3 sharded gateways, hot-key
coalescing, a kill mid-run.

Counterpart of tools/fleet_demo.py over `tieredstorage_tpu_torch`, with its
seed, ring (64 vnodes), burst, Zipfian workload, kill schedule, tenants and
checks. Three in-process sidecar instances (own RSM + chunk cache + HTTP
gateway each, `transform.device` `cuda:0`, or the CPU with `--device cpu`)
share one filesystem-backed object store behind the port's consistent-hash
segment routing (fleet/ring.py), its peer chunk-cache tier over the
shim-wire ``GET /chunk`` route (fleet/peer_cache.py), and its
cross-instance single flight (fleet/singleflight.py).

1. **burst**: 24 concurrent cold fetches of one hot chunk, spread across
   all three gateways, must produce exactly one backend ranged fetch of
   that chunk, and byte-identical payloads.
2. **warm + zipf**: a seeded Zipfian hot-key workload (240 requests)
   round-robins the fleet; reads are served from the owner/peer cache tier
   (rate >= 80 %), with live peer hits from the sibling caches.
3. **kill**: at request 120 one instance is hard-killed: its storage is
   dead from call N onward via a ``fetch:raise@from=N`` FaultSchedule (N is
   the exact number of storage fetches the scripted pre-kill workload
   performs on it, asserted) and its gateway stops; survivors re-ring and
   every remaining response stays byte-identical.
4. **fair share**: a greedy tenant saturating the survivor's admission
   gate is shed with 429 while a polite tenant still gets served.

Run with ``TSTPU_LOCK_WITNESS=1`` (as the JAX gate's CI target runs it),
the port's lock-order witness and race witness (utils/locks.py) wrap every
factory lock of the three instances; the drill must end with zero
lock-order violations and zero guarded-by violations against the port's
static race inference (analysis/races.py ``runtime_crosscheck``). Every
check is the JAX gate's own, in the same terms: none needed a torch
counterpart. The store holds plain bytes, so no kernel runs on the card.

Writes ``artifacts/torch_fleet_report.json``, re-reads it, and validates
the shape.

    TSTPU_LOCK_WITNESS=1 python3 tools/torch_fleet_demo.py \
        --out artifacts/torch_fleet_report.json
    TSTPU_LOCK_WITNESS=1 python3 tools/torch_fleet_demo.py --device cpu

Without CUDA, and without `--device cpu`, it exits 2 and runs nothing.
"""

from __future__ import annotations

import argparse
import http.client
import json
import pathlib
import random
import shutil
import sys
import tempfile
import threading
import time

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))

from collections import Counter  # noqa: E402

from tieredstorage_tpu_torch.faults import FaultInjectedException  # noqa: E402
from tieredstorage_tpu_torch.fleet import HashRing  # noqa: E402
from tieredstorage_tpu_torch.metadata import (  # noqa: E402
    KafkaUuid,
    LogSegmentData,
    RemoteLogSegmentId,
    RemoteLogSegmentMetadata,
    TopicIdPartition,
    TopicPartition,
)
from tieredstorage_tpu_torch.object_key import ObjectKeyFactory, Suffix  # noqa: E402
from tieredstorage_tpu_torch.rsm import RemoteStorageManager  # noqa: E402
from tieredstorage_tpu_torch.sidecar import shimwire  # noqa: E402
from tieredstorage_tpu_torch.sidecar.http_gateway import SidecarHttpGateway  # noqa: E402
from tieredstorage_tpu_torch.storage.core import ObjectKey  # noqa: E402
from tieredstorage_tpu_torch.storage.filesystem import FileSystemStorage  # noqa: E402
from tieredstorage_tpu_torch.utils import flightrecorder as flight  # noqa: E402

CHUNK = 4096
CHUNKS_PER_SEGMENT = 8
SEGMENTS = 4
VNODES = 64
INSTANCES = ("g0", "g1", "g2")
KEY_PREFIX = "fleet/"
BURST_CLIENTS = 24
ZIPF_REQUESTS = 240
KILL_AT = 120
SEED = 20260804
#: Holds the cold hot-chunk storage read open long enough that every
#: concurrent burst client demonstrably coalesces behind it (the 2nd storage
#: fetch on each instance is the first .log read; the 1st is the manifest).
HOT_FETCH_DELAY_MS = 50


class CountingFsStorage(FileSystemStorage):
    """Shared-root filesystem store counting ranged .log fetches per
    (key, range) — the demo's ground truth for 'how many backend reads did
    chunk X cost, fleet-wide'."""

    fetch_log: Counter = Counter()
    _count_lock = threading.Lock()

    def fetch(self, key, byte_range=None):
        if key.value.endswith(".log") and byte_range is not None:
            entry = (key.value, (byte_range.from_position, byte_range.to_position))
            with CountingFsStorage._count_lock:
                CountingFsStorage.fetch_log[entry] += 1
        return super().fetch(key, byte_range)


def segment_payload(i: int) -> bytes:
    blob = b"".join(
        b"seg=%02d off=%012d fleet-demo-record-body|" % (i, j)
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
    tip = TopicIdPartition(KafkaUuid(b"\x0f" * 16), TopicPartition("fleetdemo", 0))
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


def make_rsm(name: str, store: pathlib.Path, device: str, *, fault_schedule=None) -> RemoteStorageManager:
    rsm = RemoteStorageManager()
    configs = {
        "storage.backend.class": CountingFsStorage,
        "storage.root": str(store),
        "chunk.size": CHUNK,
        "key.prefix": KEY_PREFIX,
        "transform.device": device,
        "fetch.chunk.cache.class":
            "tieredstorage_tpu_torch.fetch.cache.memory.MemoryChunkCache",
        "fetch.chunk.cache.size": -1,
        # Enough loader parallelism that a concurrent burst's misses overlap
        # (queued loaders would resolve after the flight closed).
        "fetch.chunk.cache.thread.pool.size": 32,
        "fleet.enabled": True,
        "fleet.instance.id": name,
        "fleet.vnodes": VNODES,
        "deadline.default.ms": 15_000,
        "admission.enabled": True,
        "admission.max.concurrent": 8,
        "admission.max.queue": 16,
        "admission.queue.timeout.ms": 5_000,
        "admission.retry.after.ms": 2_000,
        "fault.injection.enabled": True,
        "fault.schedule": fault_schedule or f"fetch:delay={HOT_FETCH_DELAY_MS}@2",
        "fault.seed": SEED,
    }
    rsm.configure(configs)
    return rsm


def tally_forward_serves(rsms: dict) -> list:
    """Count what each forwarded `/chunk` serve did in the chunk cache: its
    chunks joined to an in-flight load (`tier.inflight_join`), served from
    the cache (`tier.chunk_cache`) and loaded (the rest). Each serve runs
    under the gateway's request record, else one of its own, on which the
    chunk cache notes them. A forward is not a client request: it is how a
    non-owner's leader reaches the owner, so the burst's client joins and
    leaders are the totals less these. Appends (joined, loaded) per serve
    to the returned list until `untally_forward_serves`."""
    serves: list = []
    for rsm in rsms.values():
        inner = rsm.fleet_fetch_chunks

        def serve(object_key_value, first, last, _inner=inner):
            record = flight.current_record() or flight.RequestRecord(
                "fleet.chunk", "", time.perf_counter())
            before = dict(record.counters)
            with flight.bound(record):
                try:
                    return _inner(object_key_value, first, last)
                finally:
                    moved = {k: record.counters.get(k, 0.0) - before.get(k, 0.0)
                             for k in ("tier.inflight_join", "tier.chunk_cache")}
                    joined = int(moved["tier.inflight_join"])
                    serves.append((joined, last - first + 1 - joined
                                   - int(moved["tier.chunk_cache"])))

        rsm.fleet_fetch_chunks = serve
    return serves


def untally_forward_serves(rsms: dict) -> None:
    for rsm in rsms.values():
        del rsm.fleet_fetch_chunks  # the class's method again


def http_fetch(port: int, metadata, start: int, end, *, headers=None):
    body = shimwire.encode_metadata(metadata) + shimwire.encode_fetch_tail(start, end)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("POST", "/v1/fetch", body=body, headers=headers or {})
    resp = conn.getresponse()
    payload = resp.read()
    status = resp.status
    conn.close()
    return status, payload


def run(out_path: pathlib.Path, device: str = "cuda:0") -> int:
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="torch-fleet-demo-"))
    store = tmp / "store"
    store.mkdir()
    CountingFsStorage.fetch_log.clear()

    segments = [make_segment(i, tmp) for i in range(SEGMENTS)]
    key_factory = ObjectKeyFactory(KEY_PREFIX, False)
    log_keys = [key_factory.key(md, Suffix.LOG).value for md, _, _ in segments]

    # Ring decisions are derivable BEFORE any instance exists (the ring is a
    # pure function of names + vnodes) — that determinism is what makes the
    # @from=N kill schedule exact.
    ring = HashRing(INSTANCES, VNODES)
    owners = {log_keys[i]: ring.owner(log_keys[i]) for i in range(SEGMENTS)}
    hot_idx = 0
    hot_owner = owners[log_keys[hot_idx]]
    victim = next(n for n in INSTANCES if n != hot_owner)
    victim_owned = sum(1 for k in log_keys if owners[k] == victim)
    # Scripted pre-kill storage fetches on the victim: one manifest per
    # segment (burst fetches the hot one, its warm pass the rest) plus one
    # ranged read per owned chunk (non-owned chunks are forwarded). The NEXT
    # storage fetch — call N — and everything after it raises: hard-dead.
    kill_call = SEGMENTS + victim_owned * CHUNKS_PER_SEGMENT + 1
    victim_schedule = (
        f"fetch:delay={HOT_FETCH_DELAY_MS}@2, fetch:raise@from={kill_call}"
    )

    report: dict = {
        "device": device,
        "instances": list(INSTANCES),
        "ring": {
            "vnodes": VNODES,
            "owners": {k.rsplit('/', 1)[-1]: v for k, v in owners.items()},
            "ownership": {n: round(ring.ownership_fraction(n), 4) for n in INSTANCES},
        },
        "kill": {"victim": victim, "storage_dead_from_call": kill_call,
                 "at_request": KILL_AT},
    }

    # Upload through a plain (non-fleet) loader so serving-side counters
    # start clean.
    loader = RemoteStorageManager()
    loader.configure({
        "storage.backend.class": CountingFsStorage,
        "storage.root": str(store),
        "chunk.size": CHUNK,
        "key.prefix": KEY_PREFIX,
        "transform.device": device,
    })
    for md, data, _ in segments:
        loader.copy_log_segment_data(md, data)
    loader.close()
    CountingFsStorage.fetch_log.clear()

    rsms = {
        name: make_rsm(
            name, store, device,
            fault_schedule=victim_schedule if name == victim else None,
        )
        for name in INSTANCES
    }
    gateways = {n: SidecarHttpGateway(r).start() for n, r in rsms.items()}
    peers = {n: f"http://127.0.0.1:{g.port}" for n, g in gateways.items()}
    for r in rsms.values():
        r.set_fleet_peers(peers)

    byte_diffs = 0
    try:
        # ---------------------------------------------- phase 1: cold burst
        hot_md, _, hot_payload = segments[hot_idx]
        expected_hot = hot_payload[:CHUNK]
        forward_serves = tally_forward_serves(rsms)
        barrier = threading.Barrier(BURST_CLIENTS)
        results: list = [None] * BURST_CLIENTS

        def burst(i: int) -> None:
            port = gateways[INSTANCES[i % len(INSTANCES)]].port
            barrier.wait()
            results[i] = http_fetch(port, hot_md, 0, CHUNK - 1)

        threads = [threading.Thread(target=burst, args=(i,)) for i in range(BURST_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        untally_forward_serves(rsms)
        for status, payload in results:
            assert status == 200, f"burst fetch failed: {status}"
            if payload != expected_hot:
                byte_diffs += 1
        hot_backend_fetches = sum(
            n for (key, rng), n in CountingFsStorage.fetch_log.items()
            if key == log_keys[hot_idx] and rng[0] == 0
        )
        assert hot_backend_fetches == 1, (
            f"{BURST_CLIENTS} concurrent cold fetches of the hot chunk cost "
            f"{hot_backend_fetches} backend reads, expected exactly 1"
        )
        # Coalescing happens at two tiers: same-instance
        # duplicates join the chunk cache's per-chunk in-flight load
        # (inflight_joins) before they can ever reach the fleet
        # singleflight, which now only sees cross-instance races inside the
        # registration window. Count both — where the sharing lands is
        # scheduling-dependent; THAT it lands (1 backend read above) is the
        # invariant.
        sf_coalesced = sum(
            r.peer_chunk_cache.singleflight.coalesced for r in rsms.values()
        )
        cache_joins = sum(
            getattr(r._chunk_manager, "inflight_joins", 0) for r in rsms.values()
        )
        coalesced = sf_coalesced + cache_joins
        leaders = sum(
            r.peer_chunk_cache.singleflight.leaders for r in rsms.values()
        )
        report["burst"] = {
            "clients": BURST_CLIENTS,
            "hot_chunk_backend_fetches": hot_backend_fetches,
            "singleflight_leaders": leaders,
            "singleflight_coalesced": sf_coalesced,
            "cache_inflight_joins": cache_joins,
            "coalesced_fetches": coalesced,
            "coalescing_ratio": round(coalesced / BURST_CLIENTS, 3),
            # What the forwarded serves at the owner added to the counts
            # above (tally_forward_serves): their joins, and their loads,
            # which made leaders.
            "forward_inflight_joins": sum(j for j, _ in forward_serves),
            "forward_loads": sum(n for _, n in forward_serves),
        }
        assert coalesced > 0, "burst produced no coalesced fetches"

        # ------------------------------- phase 2: victim warm pass (scripted)
        # The victim reads every segment once: owned chunks from storage,
        # non-owned via the peer tier — consuming exactly its pre-kill
        # storage-fetch budget.
        for md, _, payload in segments:
            status, got = http_fetch(gateways[victim].port, md, 0, None)
            assert status == 200 and got == payload
        victim_calls = rsms[victim]._fault_schedule.calls("fetch")
        assert victim_calls == kill_call - 1, (
            f"victim performed {victim_calls} storage fetches pre-kill, "
            f"schedule expected {kill_call - 1}"
        )

        # --------------------------------------------- phase 3: zipf + kill
        rng = random.Random(SEED)
        population = [(hot_idx, 0)] + [
            (s, c) for s in range(SEGMENTS) for c in range(CHUNKS_PER_SEGMENT)
            if (s, c) != (hot_idx, 0)
        ]
        weights = [1.0 / (rank + 1) ** 1.2 for rank in range(len(population))]
        zipf_before = sum(CountingFsStorage.fetch_log.values())
        alive = list(INSTANCES)
        peer_hits_before = sum(r.peer_chunk_cache.peer_hits for r in rsms.values())
        forwards_before = sum(r.peer_chunk_cache.forwards for r in rsms.values())
        statuses = Counter()
        for i in range(ZIPF_REQUESTS):
            if i == KILL_AT:
                # Hard kill: the victim's storage is dead from call N (the
                # @from schedule armed above) and its gateway goes away;
                # survivors re-ring without it (bounded key movement).
                gateways[victim].stop()
                alive = [n for n in INSTANCES if n != victim]
                survivors = {n: peers[n] for n in alive}
                for n in alive:
                    rsms[n].set_fleet_peers(survivors)
                probe_key = ObjectKey(
                    log_keys[hot_idx].replace(".log", ".rsm-manifest")
                )
                try:
                    rsms[victim]._storage.fetch(probe_key)
                    raise AssertionError("victim storage still alive after kill")
                except FaultInjectedException:
                    pass  # hard-dead, as scheduled
            seg, chunk = population[
                rng.choices(range(len(population)), weights=weights)[0]
            ]
            md, _, payload = segments[seg]
            start = chunk * CHUNK
            end = min(start + CHUNK - 1, len(payload) - 1)
            port = gateways[rng.choice(alive)].port
            status, got = http_fetch(port, md, start, end)
            statuses[status] += 1
            if got != payload[start : end + 1]:
                byte_diffs += 1
        assert statuses == Counter({200: ZIPF_REQUESTS}), dict(statuses)
        zipf_backend = sum(CountingFsStorage.fetch_log.values()) - zipf_before
        cache_tier_rate = 1.0 - zipf_backend / ZIPF_REQUESTS
        peer_hits = sum(
            r.peer_chunk_cache.peer_hits for r in rsms.values()
        ) - peer_hits_before
        forwards = sum(
            r.peer_chunk_cache.forwards for r in rsms.values()
        ) - forwards_before
        report["zipf"] = {
            "requests": ZIPF_REQUESTS,
            "backend_chunk_fetches": zipf_backend,
            "cache_tier_rate": round(cache_tier_rate, 4),
            "peer_hits": peer_hits,
            "forwards": forwards,
            "peer_hit_rate": round(peer_hits / forwards, 4) if forwards else None,
        }
        assert cache_tier_rate >= 0.8, (
            f"cache tier served only {cache_tier_rate:.0%} of zipf reads"
        )
        # No stored chunk was read from the backend more than twice, ever
        # (once cold at its owner; at most once more re-ringed post-kill).
        worst = max(CountingFsStorage.fetch_log.values())
        assert worst <= 2, f"some chunk cost {worst} backend reads"
        report["max_backend_fetches_per_chunk"] = worst

        # ------------------------------------------- phase 4: tenant shares
        survivor = next(n for n in INSTANCES if n != victim)
        admission = rsms[survivor].admission
        for _ in range(8):
            admission.acquire("greedy-flood", tenant="greedy")
        try:
            greedy_status, _ = http_fetch(
                gateways[survivor].port, segments[1][0], 0, CHUNK - 1,
                headers={"x-tenant": "greedy"},
            )
            polite: dict = {}

            def polite_fetch():
                polite["result"] = http_fetch(
                    gateways[survivor].port, segments[1][0], 0, CHUNK - 1,
                    headers={"x-tenant": "polite"},
                )

            t = threading.Thread(target=polite_fetch)
            t.start()
            time.sleep(0.2)
            admission.release(tenant="greedy")  # one slot frees: polite's turn
            t.join(timeout=30)
        finally:
            for _ in range(7):
                admission.release(tenant="greedy")
        polite_status, polite_payload = polite["result"]
        report["fair_share"] = {
            "greedy_status": greedy_status,
            "polite_status": polite_status,
            "greedy_sheds": admission.tenant_sheds.get("greedy", 0),
            "polite_sheds": admission.tenant_sheds.get("polite", 0),
        }
        assert greedy_status == 429, f"greedy tenant not shed: {greedy_status}"
        assert polite_status == 200 and polite_payload == segments[1][2][:CHUNK]
        assert admission.tenant_sheds.get("polite", 0) == 0

        report["byte_diffs"] = byte_diffs
        assert byte_diffs == 0, f"{byte_diffs} responses diverged from source bytes"

        # ------------------------------------------ lock-order witness gate
        # Under TSTPU_LOCK_WITNESS=1 every lock in the
        # three instances' gateways/caches/pools/single-flight is wrapped;
        # the acquisition orders observed across this drill must form a DAG,
        # validating the static lock-order checker against real executions.
        from tieredstorage_tpu_torch.utils.locks import witness, witness_enabled

        report["lock_witness"] = {
            "enabled": witness_enabled(),
            "edges": len(witness().edges()),
            "violations": list(witness().violations),
        }
        assert not witness().violations, (
            "lock-order violations observed at runtime:\n  "
            + "\n  ".join(witness().violations)
        )

        # -------------------------------------------- race witness gate
        # The same flag arms the RaceWitness: every sampled mutation of a
        # hooked shared attribute (peer-cache counters, cache stats,
        # transform DispatchStats) must have held the lock the guarded-by
        # race checker statically inferred for it: the static against
        # runtime cross-check, on the richest interleaving any suite
        # produces.
        from tieredstorage_tpu_torch.analysis import races
        from tieredstorage_tpu_torch.utils.locks import race_witness

        crosscheck = races.runtime_crosscheck()
        report["race_witness"] = {
            "enabled": witness_enabled(),
            "sites_observed": race_witness().sites(),
            "validated": crosscheck["validated"],
            "unobserved_guards": crosscheck["unobserved"],
            "violations": crosscheck["violations"],
        }
        assert not crosscheck["violations"], (
            "guarded-by cross-check violations:\n  "
            + "\n  ".join(crosscheck["violations"])
        )
    finally:
        for g in gateways.values():
            try:
                g.stop()  # idempotent: the victim's is already down
            except Exception:
                pass
        for r in rsms.values():
            r.close()
        shutil.rmtree(tmp, ignore_errors=True)

    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=1))

    # ------------------------------------------------ artifact re-validation
    parsed = json.loads(out_path.read_text())
    assert parsed["byte_diffs"] == 0
    assert parsed["burst"]["hot_chunk_backend_fetches"] == 1
    assert parsed["burst"]["coalesced_fetches"] > 0
    assert parsed["zipf"]["cache_tier_rate"] >= 0.8
    assert parsed["zipf"]["peer_hits"] > 0
    assert parsed["fair_share"]["greedy_status"] == 429
    assert parsed["fair_share"]["polite_status"] == 200
    assert parsed["kill"]["victim"] in parsed["instances"]
    assert parsed["lock_witness"]["violations"] == []
    assert not parsed["lock_witness"]["enabled"] or parsed["lock_witness"]["edges"] > 0
    assert parsed["race_witness"]["violations"] == []
    # The zipf phase forwards between instances, so the peer-cache counter
    # sites must actually have been sampled when the witness is armed.
    assert not parsed["race_witness"]["enabled"] or any(
        s.startswith("peer_cache.") for s in parsed["race_witness"]["sites_observed"]
    )
    print(
        f"TORCH_FLEET_DEMO_OK hot_backend_fetches={parsed['burst']['hot_chunk_backend_fetches']} "
        f"coalesced={parsed['burst']['coalesced_fetches']} "
        f"cache_tier_rate={parsed['zipf']['cache_tier_rate']} "
        f"peer_hits={parsed['zipf']['peer_hits']} "
        f"killed={parsed['kill']['victim']}@req{parsed['kill']['at_request']} "
        f"greedy_shed={parsed['fair_share']['greedy_sheds']} "
        f"byte_diffs={parsed['byte_diffs']} out={out_path}"
    )
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--out", default=str(REPO_ROOT / "artifacts" / "torch_fleet_report.json"),
        help="fleet report JSON output path",
    )
    parser.add_argument("--device", default="cuda:0",
                        help="cuda:N (default cuda:0) or cpu for the plain versions")
    args = parser.parse_args(argv)
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("torch_fleet_demo: CUDA is not available; pass --device cpu to run "
              "the plain versions on the CPU", file=sys.stderr)
        return 2
    return run(pathlib.Path(args.out), args.device)


if __name__ == "__main__":
    sys.exit(main())
