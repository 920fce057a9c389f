"""Failover demo of the PyTorch/CUDA port: kill a replica mid-run, lose zero
reads, converge back.

Counterpart of tools/failover_demo.py over `tieredstorage_tpu_torch`, with
its seed, schedule, deadline budget and checks. It drives the availability
loop of the port's replicated storage layer (storage/replicated.py +
scrub/antientropy.py) against a 2-replica RSM (primary = fault-injected
in-memory store, secondary = clean in-memory store) whose
`transform.device` is `cuda:0` (or the CPU with `--device cpu`): the upload
checksums and the anti-entropy arbitration's CRC32C run there.

1. upload segments through the quorum-write fan-out (per-chunk CRC32C
   checksums recorded via ``scrub.checksums.enabled`` — anti-entropy's
   arbitration ground truth);
2. run seeded fetch traffic while a ``*:raise@from=N`` fault schedule
   HARD-KILLS the primary replica mid-run (every call fails from the Nth
   onward, permanently) — every fetch must still succeed with
   byte-identical payloads, served by health-probed failover, and the
   observed failover p99 must fit the configured end-to-end deadline
   budget;
3. attempt an upload during the outage: it must miss the write quorum,
   roll back, and leave ZERO orphan objects on the surviving replica;
4. revive the primary, damage it at rest (delete one object, flip a byte
   inside a ``.log`` object), and run one anti-entropy pass: the corrupt
   copy is arbitrated away by the manifest's chunkChecksums, the missing
   copy restored, and both replicas end byte-identical; a second pass
   reports zero diffs.

Writes ``artifacts/torch_failover_report.json``, re-reads it, and
validates the shape.

    python3 tools/torch_failover_demo.py --out artifacts/torch_failover_report.json
    python3 tools/torch_failover_demo.py --device cpu

Without CUDA, and without `--device cpu`, it exits 2 and runs nothing.
"""

from __future__ import annotations

import argparse
import io
import json
import pathlib
import random
import sys
import time

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))

from tieredstorage_tpu_torch.errors import RemoteStorageException  # noqa: E402
from tieredstorage_tpu_torch.faults import FaultSchedule  # noqa: E402
from tieredstorage_tpu_torch.metadata import (  # noqa: E402
    KafkaUuid,
    LogSegmentData,
    RemoteLogSegmentId,
    RemoteLogSegmentMetadata,
    TopicIdPartition,
    TopicPartition,
)
from tieredstorage_tpu_torch.rsm import RemoteStorageManager  # noqa: E402

CHUNK_SIZE = 4096
SEGMENTS = 4
SEGMENT_BYTES = 24_000
FETCH_ROUNDS = 10
SEED = 20260804
DEADLINE_BUDGET_MS = 2_000
#: The hard kill, as a fault schedule (per-op call counters): uploads die
#: right after the seed segments' fan-out (3 objects per segment), fetches
#: die a few calls into the traffic phase — the replica drops MID-run with
#: reads in flight and never comes back until the demo revives it.
KILL_UPLOAD_FROM = 3 * SEGMENTS + 1
KILL_FETCH_FROM = 6
FAULT_SPEC = (
    f"upload:raise@from={KILL_UPLOAD_FROM}; fetch:raise@from={KILL_FETCH_FROM}"
)


def make_segment(i: int, tmp: pathlib.Path):
    payload = b"".join(
        b"seg=%02d offset=%010d replica-failover-demo-record|" % (i, j)
        for j in range(SEGMENT_BYTES // 45)
    )
    seg = tmp / f"{i:020d}.log"
    seg.write_bytes(payload)
    (tmp / f"{i}.index").write_bytes(b"\x00" * 64)
    (tmp / f"{i}.timeindex").write_bytes(b"\x00" * 32)
    (tmp / f"{i}.snapshot").write_bytes(b"\x00" * 16)
    tip = TopicIdPartition(KafkaUuid(b"\x09" * 16), TopicPartition("failoverdemo", 0))
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


def object_map(memory_backend) -> dict[str, bytes]:
    return {k: memory_backend.object(k) for k in memory_backend.keys()}


def run(out_path: pathlib.Path, device: str = "cuda:0") -> int:
    import tempfile

    tmp_dir = tempfile.TemporaryDirectory(prefix="torch-failover-demo-")
    tmp = pathlib.Path(tmp_dir.name)
    rsm = RemoteStorageManager()
    rsm.configure({
        "storage.backend.class":
            "tieredstorage_tpu_torch.storage.replicated.ReplicatedStorageBackend",
        "storage.replication.replicas": "primary,secondary",
        "storage.replication.replica.primary.backend.class":
            "tieredstorage_tpu_torch.faults.backend.FaultInjectingBackend",
        "storage.replication.replica.primary.fault.delegate.class":
            "tieredstorage_tpu_torch.storage.memory.InMemoryStorage",
        "storage.replication.replica.primary.fault.schedule": FAULT_SPEC,
        "storage.replication.replica.secondary.backend.class":
            "tieredstorage_tpu_torch.storage.memory.InMemoryStorage",
        # Call counts must stay deterministic: health comes from live
        # traffic, not the background prober.
        "storage.replication.probe.interval.ms": None,
        "transform.device": device,
        "chunk.size": CHUNK_SIZE,
        "key.prefix": "demo/",
        "deadline.default.ms": DEADLINE_BUDGET_MS,
        "scrub.checksums.enabled": True,
        "replication.antientropy.enabled": True,
        "replication.antientropy.interval.ms": 3_600_000,  # driven manually
        "tracing.enabled": True,
    })
    try:
        replicated = rsm.replicated_storage
        assert replicated is not None and len(replicated.replica_states) == 2
        primary_wrapper = replicated.replica_states[0].backend
        primary_store = primary_wrapper.delegate
        secondary_store = replicated.replica_states[1].backend

        # ---------------------------------------------------- 1. uploads
        segments = []
        for i in range(SEGMENTS):
            metadata, data, payload = make_segment(i, tmp)
            rsm.copy_log_segment_data(metadata, data)
            segments.append((metadata, payload))
        assert object_map(primary_store) == object_map(secondary_store), (
            "replicas must be identical after quorum writes"
        )
        keys_after_upload = secondary_store.keys()
        assert len(keys_after_upload) == 3 * SEGMENTS

        # --------------------------- 2. seeded traffic through the kill
        rng = random.Random(SEED)
        fetches = failed = 0
        mismatches = 0
        for _ in range(FETCH_ROUNDS):
            order = list(range(SEGMENTS))
            rng.shuffle(order)
            for i in order:
                metadata, payload = segments[i]
                start = rng.randrange(0, len(payload) // 2)
                end = rng.randrange(start, len(payload) - 1)
                fetches += 1
                try:
                    with rsm.fetch_log_segment(metadata, start, end) as s:
                        got = s.read()
                except Exception:  # noqa: BLE001 — counted, asserted zero below
                    failed += 1
                    continue
                if got != payload[start : end + 1]:
                    mismatches += 1
        primary_calls = primary_wrapper.schedule.calls("fetch")
        assert failed == 0, f"{failed}/{fetches} fetches failed during the outage"
        assert mismatches == 0, f"{mismatches} payload mismatches"
        assert replicated.failovers >= 1, "the kill never forced a failover"
        assert primary_calls >= 1, "primary was never exercised"
        p99 = rsm.metrics.latency_quantile("replica-failover-time", 0.99)
        assert p99 is not None and p99 < DEADLINE_BUDGET_MS, (
            f"failover p99 {p99}ms outside the {DEADLINE_BUDGET_MS}ms deadline budget"
        )

        # ------------------------- 3. sub-quorum write rolls back clean
        metadata, data, _ = make_segment(SEGMENTS, tmp)
        rollback_error = None
        try:
            rsm.copy_log_segment_data(metadata, data)
        except RemoteStorageException as e:
            rollback_error = f"{type(e).__name__}: {e}"
        assert rollback_error is not None, (
            "upload with a dead replica must miss the write quorum"
        )
        assert secondary_store.keys() == keys_after_upload, (
            "sub-quorum rollback left orphans on the surviving replica: "
            f"{set(secondary_store.keys()) - set(keys_after_upload)}"
        )

        # ----------------- 4. revive, damage at rest, anti-entropy heals
        primary_wrapper._schedule = FaultSchedule([])  # the replica comes back
        log_keys = [k for k in keys_after_upload if k.endswith(".log")]
        deleted_key = log_keys[0]
        corrupted_key = log_keys[1]
        with primary_store._lock:
            del primary_store._objects[deleted_key]
            blob = primary_store._objects[corrupted_key]
            primary_store._objects[corrupted_key] = (
                blob[:100] + bytes([blob[100] ^ 0xFF]) + blob[101:]
            )
        pass1 = rsm.antientropy.run_once()
        assert pass1.missing_copies == 1, pass1.to_json()
        assert pass1.divergent_keys == 1, pass1.to_json()
        assert pass1.repairs == 2, pass1.to_json()
        identical = object_map(primary_store) == object_map(secondary_store)
        assert identical, "replicas not byte-identical after anti-entropy"
        assert primary_store.object(corrupted_key) == secondary_store.object(
            corrupted_key
        ), "chunkChecksums arbitration kept the corrupt copy"
        pass2 = rsm.antientropy.run_once()
        assert pass2.in_sync, f"second pass found diffs: {pass2.to_json()}"

        failover_events = len(rsm.tracer.spans("storage.failover"))
        repair_events = len(rsm.tracer.spans("replication.repair"))
        assert repair_events == 2

        doc = {
            "device": device,
            "schedule": {"spec": FAULT_SPEC, "seed": SEED},
            "deadline_budget_ms": DEADLINE_BUDGET_MS,
            "segments": SEGMENTS,
            "fetches": fetches,
            "failed_fetches": failed,
            "payload_mismatches": mismatches,
            "failovers": replicated.failovers,
            "failover_p99_ms": p99,
            "failover_trace_events": failover_events,
            "quorum_failures": replicated.quorum_failures,
            "sub_quorum_error": rollback_error,
            "surviving_replica_orphans": 0,
            "replica_health": replicated.replica_health(),
            "antientropy_pass1": pass1.to_json(),
            "antientropy_pass2": pass2.to_json(),
            "replicas_byte_identical": identical,
            "generated_at": time.time(),
        }
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(doc, indent=1))

        # ------------------------------------------- artifact re-validation
        parsed = json.loads(out_path.read_text())
        assert parsed["failed_fetches"] == 0 and parsed["payload_mismatches"] == 0
        assert parsed["failovers"] >= 1
        assert parsed["failover_p99_ms"] < parsed["deadline_budget_ms"]
        assert parsed["quorum_failures"] >= 1
        assert parsed["replicas_byte_identical"] is True
        assert parsed["antientropy_pass1"]["repairs"] == 2
        assert parsed["antientropy_pass2"]["in_sync"] is True
        print(
            f"TORCH_FAILOVER_DEMO_OK fetches={fetches} failovers={replicated.failovers} "
            f"p99={p99:.1f}ms quorum_failures={replicated.quorum_failures} "
            f"repairs={pass1.repairs} out={out_path}"
        )
        return 0
    finally:
        rsm.close()
        tmp_dir.cleanup()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--out", default=str(REPO_ROOT / "artifacts" / "torch_failover_report.json"),
        help="failover report JSON output path",
    )
    parser.add_argument("--device", default="cuda:0",
                        help="cuda:N (default cuda:0) or cpu for the plain versions")
    args = parser.parse_args(argv)
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("torch_failover_demo: CUDA is not available; pass --device cpu to run "
              "the plain versions on the CPU", file=sys.stderr)
        return 2
    return run(pathlib.Path(args.out), args.device)


if __name__ == "__main__":
    sys.exit(main())
