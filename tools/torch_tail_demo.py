"""Tail-tolerance demo of the PyTorch/CUDA port: hedging beats a seeded
tail, overload sheds, deadlines fail fast.

Counterpart of tools/tail_demo.py over `tieredstorage_tpu_torch`, with its
fault spec, seed, hedge delay, admission limits and checks. It drives the
port's resilience layer (fetch/hedge.py, utils/admission.py,
utils/deadline.py) end to end against an in-memory RSM whose
`transform.device` is `cuda:0` (or the CPU with `--device cpu`) and whose
storage injects a seeded, jittered tail (``fetch:delay=120..200@every=4``:
every 4th storage fetch stalls for a uniform seeded draw):

1. upload three segments, then run the identical fetch workload twice,
   hedging off and hedging on (same FaultSchedule spec + seed), recording
   per-fetch latency and a digest of every payload;
2. hedged p99 < unhedged p99 (the hedge turns each injected stall into
   about hedge.delay), with zero correctness diffs between the phases'
   fetched bytes, and the hedges fired and won;
3. the shim-wire gateway sheds with HTTP 429 + Retry-After once the
   admission gate (1 + 0) is held, and serves normally after release;
4. a request arriving with an expired deadline (x-deadline-ms: 0) fails in
   well under one attempt timeout with DeadlineExceededException mapped to
   504, before any storage round trip.

Every check is the JAX gate's own, in the same terms: none needed a torch
counterpart. The store holds plain bytes (no encryption, no compression),
so the fetches launch no kernel on the card; the device only hosts the
RSM's transform backend.

Writes ``artifacts/torch_tail_report.json``, re-reads it, and validates
the shape.

    python3 tools/torch_tail_demo.py --out artifacts/torch_tail_report.json
    python3 tools/torch_tail_demo.py --device cpu

Without CUDA, and without `--device cpu`, it exits 2 and runs nothing.
"""

from __future__ import annotations

import argparse
import hashlib
import http.client
import json
import pathlib
import sys
import tempfile
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
from tieredstorage_tpu_torch.rsm import RemoteStorageManager  # noqa: E402
from tieredstorage_tpu_torch.sidecar import shimwire  # noqa: E402
from tieredstorage_tpu_torch.sidecar.http_gateway import SidecarHttpGateway  # noqa: E402

CHUNK_SIZE = 4096
SEGMENTS = 3
SEGMENT_BYTES = 20_000  # 5 chunks per segment
MEASURED_FETCHES = 12
#: Seeded jittered tail: every 4th storage fetch stalls 120..200 ms (uniform
#: draw from the schedule's RNG). Hedges launch after 20 ms and — because a
#: hedge is issued immediately after its delayed primary (call #c ≡ 0 mod 4,
#: hedge at #c+1) — the hedge itself never lands on a delayed call.
FAULT_SPEC = "fetch:delay=120..200@every=4"
FAULT_SEED = 20260804
HEDGE_DELAY_MS = 20


def make_segment(i: int, tmp: pathlib.Path):
    payload = b"".join(
        b"seg=%02d offset=%010d tail-tolerance-demo-record|" % (i, j)
        for j in range(SEGMENT_BYTES // 45)
    )
    seg = tmp / f"{i:020d}.log"
    seg.write_bytes(payload)
    (tmp / f"{i}.index").write_bytes(b"\x00" * 64)
    (tmp / f"{i}.timeindex").write_bytes(b"\x00" * 32)
    (tmp / f"{i}.snapshot").write_bytes(b"\x00" * 16)
    tip = TopicIdPartition(KafkaUuid(b"\x09" * 16), TopicPartition("taildemo", 0))
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
    return metadata, data


def make_rsm(tmp: pathlib.Path, *, hedged: bool, device: str) -> tuple[RemoteStorageManager, list]:
    rsm = RemoteStorageManager()
    rsm.configure({
        "storage.backend.class": "tieredstorage_tpu_torch.storage.memory.InMemoryStorage",
        "transform.device": device,
        "chunk.size": CHUNK_SIZE,
        "key.prefix": "demo/",
        "fault.injection.enabled": True,
        "fault.schedule": FAULT_SPEC,
        "fault.seed": FAULT_SEED,
        "hedge.enabled": hedged,
        "hedge.delay.ms": HEDGE_DELAY_MS,
        # Keep the delay static (the two phases must race the same clock);
        # the p95-driven delay is exercised by the unit suite.
        "hedge.delay.min.samples": 1_000_000,
        "hedge.budget.percent": 50,
        "admission.enabled": True,
        "admission.max.concurrent": 1,
        "admission.max.queue": 0,
        "admission.retry.after.ms": 2_000,
    })
    uploaded = []
    for i in range(SEGMENTS):
        metadata, data = make_segment(i, tmp)
        rsm.copy_log_segment_data(metadata, data)
        uploaded.append(metadata)
    return rsm, uploaded


def percentile(samples: list[float], q: float) -> float:
    """Nearest-rank percentile (the tracer summary's convention)."""
    import math

    ordered = sorted(samples)
    rank = max(1, math.ceil(q * len(ordered)))
    return ordered[min(rank, len(ordered)) - 1]


def run_phase(rsm, segments) -> tuple[list[float], list[str]]:
    """Warm the manifest cache, then measure full-segment fetch latency."""
    for metadata in segments:  # warmup: identical call shape in both phases
        with rsm.fetch_log_segment(metadata, 0) as stream:
            stream.read()
    latencies, digests = [], []
    for i in range(MEASURED_FETCHES):
        metadata = segments[i % len(segments)]
        start = time.monotonic()
        with rsm.fetch_log_segment(metadata, 0) as stream:
            payload = stream.read()
        latencies.append((time.monotonic() - start) * 1000.0)
        digests.append(hashlib.sha256(payload).hexdigest())
        assert len(payload) == metadata.segment_size_in_bytes
    return latencies, digests


def check_shed(rsm, gateway, metadata) -> dict:
    """Saturate the admission gate deterministically; the next request must
    shed with 429 + Retry-After, and be served normally after release."""
    body = shimwire.encode_metadata(metadata) + shimwire.encode_fetch_tail(0, None)
    rsm.admission.acquire("demo-holder")
    try:
        conn = http.client.HTTPConnection("127.0.0.1", gateway.port, timeout=10)
        conn.request("POST", "/v1/fetch", body=body)
        resp = conn.getresponse()
        shed_payload = resp.read()
        shed_status, retry_after = resp.status, resp.getheader("Retry-After")
        conn.close()
    finally:
        rsm.admission.release()
    assert shed_status == 429, f"expected 429 shed, got {shed_status}"
    assert retry_after == "2", f"expected Retry-After: 2, got {retry_after!r}"
    assert b"AdmissionRejectedException" in shed_payload
    conn = http.client.HTTPConnection("127.0.0.1", gateway.port, timeout=30)
    conn.request("POST", "/v1/fetch", body=body)
    resp = conn.getresponse()
    served = resp.read()
    conn.close()
    assert resp.status == 200 and len(served) == metadata.segment_size_in_bytes
    return {
        "status": shed_status,
        "retry_after": retry_after,
        "served_after_release": True,
        "shed_total": rsm.admission.shed_total,
    }


def check_deadline(gateway, metadata) -> dict:
    """An expired caller deadline must fail fast (no storage round trip:
    well under one attempt-timeout, and far less than one injected stall)
    with DeadlineExceededException mapped to 504."""
    body = shimwire.encode_metadata(metadata) + shimwire.encode_fetch_tail(0, None)
    conn = http.client.HTTPConnection("127.0.0.1", gateway.port, timeout=10)
    start = time.monotonic()
    conn.request("POST", "/v1/fetch", body=body,
                 headers={shimwire.DEADLINE_HEADER: "0"})
    resp = conn.getresponse()
    payload = resp.read()
    elapsed_ms = (time.monotonic() - start) * 1000.0
    conn.close()
    assert resp.status == 504, f"expected 504, got {resp.status}"
    assert b"DeadlineExceededException" in payload, payload
    assert elapsed_ms < 1000.0, f"deadline fail took {elapsed_ms:.0f} ms"
    return {"status": resp.status, "elapsed_ms": round(elapsed_ms, 2),
            "exception": "DeadlineExceededException"}


def run(out_path: pathlib.Path, device: str = "cuda:0") -> int:
    report: dict = {
        "device": device,
        "schedule": {"spec": FAULT_SPEC, "seed": FAULT_SEED},
        "hedge": {"delay_ms": HEDGE_DELAY_MS, "budget_percent": 50},
    }

    with tempfile.TemporaryDirectory(prefix="torch-tail-demo-") as tmp_a:
        rsm, segments = make_rsm(pathlib.Path(tmp_a), hedged=False, device=device)
        try:
            unhedged, unhedged_digests = run_phase(rsm, segments)
        finally:
            rsm.close()
    with tempfile.TemporaryDirectory(prefix="torch-tail-demo-") as tmp_b:
        rsm, segments = make_rsm(pathlib.Path(tmp_b), hedged=True, device=device)
        gateway = SidecarHttpGateway(rsm).start()
        try:
            hedged, hedged_digests = run_phase(rsm, segments)
            hedger = rsm.hedger
            report["hedger"] = {
                "primaries": hedger.primaries,
                "launched": hedger.launched,
                "wins": hedger.wins,
                "suppressed": hedger.suppressed,
            }
            report["shed"] = check_shed(rsm, gateway, segments[0])
            report["deadline"] = check_deadline(gateway, segments[0])
        finally:
            gateway.stop()
            rsm.close()

    # ---------------------------------------------------------- validation
    # 1. Zero correctness diffs: both phases returned identical bytes.
    assert unhedged_digests == hedged_digests, "hedged fetch changed payloads"
    # 2. The hedges actually fired and won against the injected stalls.
    assert report["hedger"]["launched"] > 0 and report["hedger"]["wins"] > 0
    # 3. Tail improvement: hedged p99 strictly beats unhedged p99.
    stats = {}
    for name, samples in (("unhedged", unhedged), ("hedged", hedged)):
        stats[name] = {
            "count": len(samples),
            "p50_ms": round(percentile(samples, 0.50), 2),
            "p95_ms": round(percentile(samples, 0.95), 2),
            "p99_ms": round(percentile(samples, 0.99), 2),
            "max_ms": round(max(samples), 2),
            "latencies_ms": [round(s, 2) for s in samples],
        }
    report["phases"] = stats
    report["correctness_diffs"] = 0
    assert stats["hedged"]["p99_ms"] < stats["unhedged"]["p99_ms"], (
        f"hedging did not improve p99: {stats['hedged']['p99_ms']} >= "
        f"{stats['unhedged']['p99_ms']}"
    )

    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(report, indent=1))

    # ------------------------------------------------ artifact re-validation
    parsed = json.loads(out_path.read_text())
    assert parsed["correctness_diffs"] == 0
    assert parsed["phases"]["hedged"]["p99_ms"] < parsed["phases"]["unhedged"]["p99_ms"]
    assert parsed["shed"]["status"] == 429 and parsed["shed"]["retry_after"]
    assert parsed["deadline"]["status"] == 504
    assert parsed["deadline"]["elapsed_ms"] < 1000.0
    for phase in parsed["phases"].values():
        assert {"count", "p50_ms", "p95_ms", "p99_ms", "max_ms"} <= set(phase)
    print(
        f"TORCH_TAIL_DEMO_OK unhedged_p99={parsed['phases']['unhedged']['p99_ms']}ms "
        f"hedged_p99={parsed['phases']['hedged']['p99_ms']}ms "
        f"hedges={parsed['hedger']['launched']} wins={parsed['hedger']['wins']} "
        f"shed={parsed['shed']['status']} retry_after={parsed['shed']['retry_after']} "
        f"deadline={parsed['deadline']['elapsed_ms']}ms out={out_path}"
    )
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--out", default=str(REPO_ROOT / "artifacts" / "torch_tail_report.json"),
        help="tail report JSON output path",
    )
    parser.add_argument("--device", default="cuda:0",
                        help="cuda:N (default cuda:0) or cpu for the plain versions")
    args = parser.parse_args(argv)
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("torch_tail_demo: CUDA is not available; pass --device cpu to run "
              "the plain versions on the CPU", file=sys.stderr)
        return 2
    return run(pathlib.Path(args.out), args.device)


if __name__ == "__main__":
    sys.exit(main())
