"""Trace demo of the PyTorch/CUDA port: one upload + fetch round trip,
exported as a Chrome trace.

Counterpart of tools/trace_demo.py over `tieredstorage_tpu_torch`, with its
segment, chunk size and checks. It drives the port's shim-wire HTTP gateway
against an RSM on the in-memory backend with tracing enabled and
`transform.device` `cuda:0` (or the CPU with `--device cpu`), exactly like a
broker-side client would: the client leg runs under its own Tracer and
forwards W3C ``traceparent`` headers, so the result is one trace tree
(client -> gateway -> RSM -> storage).

Writes the merged client + sidecar timeline as Chrome trace-event JSON
(default ``artifacts/torch_trace.json``; open it in https://ui.perfetto.dev
or ``chrome://tracing``), then re-parses the file and checks it: every
event has the trace-event keys, the fetch's sidecar spans share the
client's trace id, and the gateway span's parent is the client span. Every
check is the JAX gate's own, in the same terms: none needed a torch
counterpart. The store holds plain bytes, so no kernel runs on the card.

    python3 tools/torch_trace_demo.py --out artifacts/torch_trace.json
    python3 tools/torch_trace_demo.py --device cpu

Without CUDA, and without `--device cpu`, it exits 2 and runs nothing.
"""

from __future__ import annotations

import argparse
import http.client
import json
import pathlib
import sys

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
from tieredstorage_tpu_torch.utils.tracing import Tracer  # noqa: E402

SEGMENT = b"".join(
    b"offset=%019d key=user-%06d trace-demo-payload|" % (i, i % 997)
    for i in range(2000)
)


def make_metadata() -> RemoteLogSegmentMetadata:
    tip = TopicIdPartition(KafkaUuid(b"\x01" * 16), TopicPartition("demo", 0))
    return RemoteLogSegmentMetadata(
        remote_log_segment_id=RemoteLogSegmentId(tip, KafkaUuid(b"\x02" * 16)),
        start_offset=0,
        end_offset=1999,
        segment_size_in_bytes=len(SEGMENT),
    )


def make_segment_data(tmp: pathlib.Path) -> LogSegmentData:
    seg = tmp / "demo.log"
    seg.write_bytes(SEGMENT)
    for name, blob in (("demo.index", b"\x00" * 48), ("demo.timeindex", b"\x00" * 24),
                       ("demo.snapshot", b"\x00" * 8)):
        (tmp / name).write_bytes(blob)
    return LogSegmentData(
        log_segment=seg,
        offset_index=tmp / "demo.index",
        time_index=tmp / "demo.timeindex",
        producer_snapshot_index=tmp / "demo.snapshot",
        transaction_index=None,
        leader_epoch_index=b"epoch-checkpoint",
    )


def run(out_path: pathlib.Path, device: str = "cuda:0") -> int:
    import tempfile

    rsm = RemoteStorageManager()
    rsm.configure({
        "storage.backend.class": "tieredstorage_tpu_torch.storage.memory.InMemoryStorage",
        "transform.device": device,
        "chunk.size": 16384,
        "tracing.enabled": True,
    })
    client_tracer = Tracer(enabled=True)
    gateway = SidecarHttpGateway(rsm).start()
    md = make_metadata()
    try:
        with tempfile.TemporaryDirectory(prefix="torch-trace-demo-") as tmp:
            data = make_segment_data(pathlib.Path(tmp))
            with client_tracer.span("client.copy_log_segment_data"):
                conn = http.client.HTTPConnection("127.0.0.1", gateway.port, timeout=60)
                body = shimwire.encode_metadata(md) + shimwire.encode_sections({
                    "log_segment": SEGMENT,
                    "offset_index": data.offset_index.read_bytes(),
                    "time_index": data.time_index.read_bytes(),
                    "producer_snapshot": data.producer_snapshot_index.read_bytes(),
                    "transaction_index": None,
                    "leader_epoch_index": bytes(data.leader_epoch_index),
                })
                conn.request("POST", "/v1/copy", body=body,
                             headers=shimwire.trace_headers(client_tracer))
                resp = conn.getresponse()
                assert resp.status in (200, 204), resp.read()
                resp.read()
                conn.close()
        with client_tracer.span("client.fetch_log_segment") as client_span:
            conn = http.client.HTTPConnection("127.0.0.1", gateway.port, timeout=60)
            conn.request(
                "POST", "/v1/fetch",
                body=shimwire.encode_metadata(md) + shimwire.encode_fetch_tail(0, None),
                headers=shimwire.trace_headers(client_tracer),
            )
            resp = conn.getresponse()
            assert resp.status == 200, resp.read()
            fetched = resp.read()
            conn.close()
        assert fetched == SEGMENT, "round-trip bytes diverged"
    finally:
        gateway.stop()
        rsm.close()

    # Merge the client and sidecar timelines into one Chrome trace document
    # (timestamps are wall-clock µs, so the legs interleave correctly).
    doc = rsm.tracer.export_chrome_trace()
    doc["traceEvents"].extend(client_tracer.chrome_trace_events())
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(doc, indent=1))

    # ------------------------------------------------------------ validation
    parsed = json.loads(out_path.read_text())
    events = parsed["traceEvents"]
    assert events, "trace must contain events"
    for event in events:
        assert {"name", "ph", "ts", "pid", "tid"} <= set(event), event
        assert event["ph"] in ("X", "i"), event
        if event["ph"] == "X":
            assert event["dur"] >= 0

    # One tree: every sidecar-side span of the fetch shares the client's
    # trace_id, and the gateway leg parents directly under the client span.
    fetch_trace = client_span.trace_id
    sidecar_fetch = [
        s for s in rsm.tracer.spans() if s.trace_id == fetch_trace
    ]
    names = {s.name for s in sidecar_fetch}
    assert {"gateway.fetch", "rsm.fetch_log_segment", "rsm.fetch_manifest",
            "storage.fetch_chunks", "chunk.detransform"} <= names, names
    gateway_span = next(s for s in sidecar_fetch if s.name == "gateway.fetch")
    assert gateway_span.parent_id == client_span.span_id

    summary = rsm.tracer.summary()
    print(f"TORCH_TRACE_DEMO_OK events={len(events)} trace_id={fetch_trace} "
          f"out={out_path}")
    for name in sorted(summary):
        s = summary[name]
        print(f"  {name:32s} n={int(s['count']):3d} p50={s['p50_s'] * 1e3:8.3f}ms "
              f"p95={s['p95_s'] * 1e3:8.3f}ms p99={s['p99_s'] * 1e3:8.3f}ms")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--out", default=str(REPO_ROOT / "artifacts" / "torch_trace.json"),
        help="Chrome trace-event JSON output path",
    )
    parser.add_argument("--device", default="cuda:0",
                        help="cuda:N (default cuda:0) or cpu for the plain versions")
    args = parser.parse_args(argv)
    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("torch_trace_demo: CUDA is not available; pass --device cpu to run "
              "the plain versions on the CPU", file=sys.stderr)
        return 2
    return run(pathlib.Path(args.out), args.device)


if __name__ == "__main__":
    sys.exit(main())
