"""Export a live port gateway's device-scheduler timeline as a Chrome trace.

Counterpart of tools/timeline_export.py over `tieredstorage_tpu_torch`.
With ``--url`` it does what the JAX tool does: it fetches ``GET
/debug/timeline`` (the scheduler's merged-launch event ring) from a running
sidecar gateway, plus, when ``--trace`` is given, the matching flight
records from ``GET /debug/requests?trace=<id>``, and writes Chrome
trace-event JSON: one track per work class, one slice per merged GCM
launch, flow arrows joining each request's flight record to the launches
that served it (the ``gcm.batch:<id>`` stage markers). ``build_trace`` is
the JAX tool's pure converter, over the port's `metrics/timeline.py`.

    python3 tools/torch_timeline_export.py --url http://127.0.0.1:8090 \\
        --trace 4bf92f3577b34da6a3ce929d0e0e4736 -o artifacts/timeline.json

Without ``--url`` it drives a gateway of its own first: an in-process RSM
on a filesystem store with encryption on, ``timeline.enabled``,
``flight.enabled`` and the window batcher (16 windows, 64 MiB, 2 ms), its
``transform.device`` `cuda:0` (or the CPU with ``--device cpu``), behind
the shim-wire gateway. It copies one seeded segment (64 MiB of 4 MiB
chunks by default) and reads it back through the gateway whole and in
seeded ranges, all reads at once (so that their windows merge), each under
its own W3C ``traceparent``. Then it exports the timeline with the flight
record of the first read whose window rode a merged launch, and checks:

- ``launches_equal_batcher``: the export's ``otherData.launches`` equals
  the batcher's merged launches, and is above 0;
- ``chrome_events_valid``: ``validate_chrome_events`` passes on every event;
- ``flow_joins_record_to_launch``: at least one flow start (``s``) has its
  finish (``f``): a flight record joined to a launch that served it;
- ``bytes_equal``: every read equals the source;
- on the card, ``kernels_launched``: the AES keystream and the GHASH tree
  kernels were launched during the drive.

The drive's facts and checks go into the export's ``otherData.drive``.
Without CUDA, and without ``--device cpu`` or ``--url``, it exits 2 and
runs nothing.

    python3 tools/torch_timeline_export.py -o artifacts/torch_timeline.json
    python3 tools/torch_timeline_export.py --device cpu --segment-bytes 262144 \\
        --chunk-bytes 32768
"""

from __future__ import annotations

import argparse
import http.client
import json
import pathlib
import sys
import tempfile
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT))

from tieredstorage_tpu_torch.metrics.timeline import (  # noqa: E402
    chrome_trace_events,
    validate_chrome_events,
)

SEGMENT_BYTES = 64 << 20
CHUNK_BYTES = 4 << 20
WHOLE_READS = 2
RANGED_READS = 6
SEED = 20260804
#: The window batcher's settings of the port's concurrent-consumer path
#: (transform/batcher.py), and rings large enough to hold every launch.
DRIVE_CONFIGS = {
    "transform.batch.enabled": True,
    "transform.batch.wait.ms": 2,
    "transform.batch.windows": 16,
    "transform.batch.bytes": 64 << 20,
    "timeline.enabled": True,
    "timeline.ring.size": 65536,
    "flight.enabled": True,
    "flight.ring.size": 4096,
    "tracing.enabled": True,
}
GCM_KERNELS = ("aes_ctr_keystream", "ghash_tree")


def build_trace(
    timeline_payload: dict,
    requests_payload: dict | None = None,
    *,
    instance: str = "gateway",
) -> dict:
    """Pure converter: debug-route payloads in, Chrome trace JSON out.

    ``timeline_payload`` is the ``/debug/timeline`` body (``events`` +
    ``epoch``); ``requests_payload`` is an optional ``/debug/requests``
    body whose ``slowest`` records get their own track with flow arrows
    into the launches that served them. Raises ValueError if the result
    would not load in Perfetto (schema-checked, not hoped)."""
    events = timeline_payload.get("events", [])
    epoch = timeline_payload.get("epoch") or {"wall_s": 0.0, "mono_s": 0.0}
    records = (requests_payload or {}).get("slowest", [])
    trace_events = chrome_trace_events(
        events, records, pid=1, epoch=epoch, instance=instance,
    )
    validate_chrome_events(trace_events)
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {
            "instance": instance,
            "launches": sum(1 for e in events if e.get("kind") == "flush"),
            "records": len(records),
        },
    }


def _get_json(base: str, path: str) -> dict | None:
    url = base.rstrip("/") + path
    try:
        with urllib.request.urlopen(url, timeout=10.0) as resp:  # noqa: S310
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return None
        raise


def export(url: str, trace: str | None, out_path: pathlib.Path) -> int:
    """Read a live gateway's debug routes and write the Chrome trace."""
    timeline = _get_json(url, "/debug/timeline")
    if timeline is None:
        print(f"FAIL: {url}/debug/timeline returned 404 — is "
              "timeline.enabled=true on the gateway's RSM?", file=sys.stderr)
        return 1
    requests_payload = None
    if trace:
        requests_payload = _get_json(
            url, "/debug/requests?trace=" + urllib.parse.quote(trace, safe=""))
        if requests_payload is None:
            print(f"FAIL: no retained flight record for trace {trace!r}",
                  file=sys.stderr)
            return 1
    doc = build_trace(timeline, requests_payload, instance=url)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(doc, indent=1, sort_keys=True))
    other = doc["otherData"]
    print(f"wrote {out_path} ({len(doc['traceEvents'])} events, "
          f"{other['launches']} launches, {other['records']} records) — "
          "open in https://ui.perfetto.dev")
    return 0


def _segment(tmp: pathlib.Path, size: int, rng):
    """One seeded segment with small indexes, as the RSM's copy takes it."""
    from tieredstorage_tpu_torch.metadata import (
        KafkaUuid,
        LogSegmentData,
        RemoteLogSegmentId,
        RemoteLogSegmentMetadata,
        TopicIdPartition,
        TopicPartition,
    )

    source = rng.bytes(size)
    (tmp / "seg.log").write_bytes(source)
    for name, n in (("seg.index", 64), ("seg.timeindex", 96), ("seg.snapshot", 16)):
        (tmp / name).write_bytes(rng.bytes(n))
    tip = TopicIdPartition(KafkaUuid(rng.bytes(16)), TopicPartition("timeline", 0))
    md = RemoteLogSegmentMetadata(
        remote_log_segment_id=RemoteLogSegmentId(tip, KafkaUuid(rng.bytes(16))),
        start_offset=0, end_offset=size // 1024, segment_size_in_bytes=size,
    )
    sd = LogSegmentData(
        log_segment=tmp / "seg.log", offset_index=tmp / "seg.index",
        time_index=tmp / "seg.timeindex", producer_snapshot_index=tmp / "seg.snapshot",
        transaction_index=None, leader_epoch_index=b"0\n1\n0 0\n",
    )
    return md, sd, source


def _traced_fetch(port: int, md_frame: bytes, start: int, end: int, trace_id: str) -> bytes:
    from tieredstorage_tpu_torch.sidecar import shimwire

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request("POST", "/v1/fetch", body=md_frame + shimwire.encode_fetch_tail(start, end),
                     headers={"traceparent": f"00-{trace_id}-00f067aa0ba902b7-01"})
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise RuntimeError(f"fetch {start}-{end} answered {resp.status}: {body[:200]!r}")
        return body
    finally:
        conn.close()


def _rode_a_launch(url: str, trace_id: str) -> bool:
    """Whether a retained flight record of `trace_id` carries a
    ``gcm.batch:<id>`` stage (its window rode a merged launch)."""
    payload = _get_json(url, "/debug/requests?trace=" + trace_id) or {}
    return any(str(stage[0]).startswith("gcm.batch:")
               for rec in payload.get("slowest", []) for stage in rec.get("stages", []))


def run(out_path: pathlib.Path, device: str = "cuda:0", segment_bytes: int = SEGMENT_BYTES,
        chunk_bytes: int = CHUNK_BYTES) -> int:
    """Drive an in-process port gateway on `device`, export its timeline to
    `out_path`, and check the export against the batcher (module doc)."""
    import numpy as np
    import torch

    from tieredstorage_tpu_torch.ops import _cuda
    from tieredstorage_tpu_torch.rsm import RemoteStorageManager
    from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
    from tieredstorage_tpu_torch.sidecar import shimwire
    from tieredstorage_tpu_torch.sidecar.http_gateway import SidecarHttpGateway

    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory(prefix="torch-timeline-export-") as tmp_name:
        tmp = pathlib.Path(tmp_name)
        (tmp / "store").mkdir()
        pub, priv = generate_key_pair_pem_files(tmp, prefix="timeline")
        md, sd, source = _segment(tmp, segment_bytes, rng)
        rsm = RemoteStorageManager()
        rsm.configure({
            "storage.backend.class":
                "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
            "storage.root": str(tmp / "store"),
            "chunk.size": chunk_bytes,
            "key.prefix": "timeline/",
            "transform.device": device,
            "encryption.enabled": True,
            "encryption.key.pair.id": "k1",
            "encryption.key.pairs": "k1",
            "encryption.key.pairs.k1.public.key.file": str(pub),
            "encryption.key.pairs.k1.private.key.file": str(priv),
            **DRIVE_CONFIGS,
        })
        gateway = None
        try:
            before = _cuda.launch_counts()
            rsm.copy_log_segment_data(md, sd)
            gateway = SidecarHttpGateway(rsm).start()
            md_frame = shimwire.encode_metadata(md)
            reads = [(0, segment_bytes - 1)] * WHOLE_READS
            for _ in range(RANGED_READS):
                start = int(rng.integers(0, segment_bytes - 1))
                reads.append((start, int(rng.integers(start, min(segment_bytes, start + chunk_bytes)))))
            traces = [rng.bytes(16).hex() for _ in reads]
            with ThreadPoolExecutor(len(reads)) as pool:
                bodies = list(pool.map(
                    lambda read, trace_id: _traced_fetch(gateway.port, md_frame, *read, trace_id),
                    reads, traces))
            mismatched = [read for read, body in zip(reads, bodies)
                          if body != source[read[0]:read[1] + 1]]
            launched = {name: n - before.get(name, 0) for name, n in _cuda.launch_counts().items()}
            url = f"http://127.0.0.1:{gateway.port}"
            exported = next((t for t in traces if _rode_a_launch(url, t)), traces[0])
            code = export(url, exported, out_path)
            if code != 0:
                return code
            batcher = rsm.transform_backend.batcher
            merged_launches, windows = batcher.launches, batcher.windows_submitted
        finally:
            if gateway is not None:
                gateway.stop()
            rsm.close()

    doc = json.loads(out_path.read_text())
    events = doc["traceEvents"]
    starts = {e["id"] for e in events if e["ph"] == "s"}
    finishes = {e["id"] for e in events if e["ph"] == "f"}
    checks = {
        "launches_equal_batcher": doc["otherData"]["launches"] == merged_launches > 0,
        "chrome_events_valid": validate_chrome_events(events) == len(events),
        "flow_joins_record_to_launch": bool(starts & finishes),
        "bytes_equal": not mismatched,
    }
    if torch.device(device).type == "cuda":
        checks["kernels_launched"] = all(launched.get(k, 0) > 0 for k in GCM_KERNELS)
    doc["otherData"]["drive"] = {
        "device": device,
        "segment_bytes": segment_bytes,
        "chunk_bytes": chunk_bytes,
        "whole_reads": WHOLE_READS,
        "ranged_reads": RANGED_READS,
        "exported_trace": exported,
        "batcher_launches": merged_launches,
        "batcher_windows": windows,
        "kernel_launches": launched,
        "flows_joined": len(starts & finishes),
        "mismatched_reads": mismatched,
        "checks": checks,
        "ok": all(checks.values()),
    }
    out_path.write_text(json.dumps(doc, indent=1, sort_keys=True))
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        print(f"TORCH_TIMELINE_EXPORT_FAILED {failed}: {json.dumps(doc['otherData'])}",
              file=sys.stderr)
        return 1
    print(f"TORCH_TIMELINE_EXPORT_OK launches={merged_launches} windows={windows} "
          f"flows={len(starts & finishes)} events={len(events)} out={out_path}")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--url", default=None,
                        help="gateway base URL to export from; without it the tool "
                             "drives a gateway of its own on --device")
    parser.add_argument("--trace", default=None,
                        help="flight-recorder trace id to overlay as a "
                             "request track with launch flow arrows (with --url)")
    parser.add_argument("-o", "--out", type=pathlib.Path,
                        default=pathlib.Path("artifacts/torch_timeline.json"),
                        help="output path (default %(default)s)")
    parser.add_argument("--device", default="cuda:0",
                        help="cuda:N (default cuda:0) or cpu for the plain versions")
    parser.add_argument("--segment-bytes", type=int, default=SEGMENT_BYTES)
    parser.add_argument("--chunk-bytes", type=int, default=CHUNK_BYTES)
    args = parser.parse_args(argv)
    if args.url is not None:
        return export(args.url, args.trace, args.out)
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("torch_timeline_export: CUDA is not available; pass --device cpu to run "
              "the plain versions on the CPU, or --url to export a live gateway",
              file=sys.stderr)
        return 2
    return run(args.out, args.device, args.segment_bytes, args.chunk_bytes)


if __name__ == "__main__":
    raise SystemExit(main())
