"""The sidecar server: the port's RemoteStorageManager behind gRPC.

Counterpart of tieredstorage_tpu/sidecar/server.py: the same service,
status mapping, admission and deadline adoption. The RSM runs the CUDA
transform on ``transform.device`` (``cuda:0`` unless the config asks for
``cpu``) in its own process; brokers (or the Python SidecarRsmClient of
either package) drive copy/fetch/fetch-index/delete over the
RemoteStorageSidecar service. RSM error types map onto gRPC status codes so
clients can distinguish missing segments (NOT_FOUND) from bad requests
(INVALID_ARGUMENT), overload (RESOURCE_EXHAUSTED), late requests
(DEADLINE_EXCEEDED) and runtime failures (INTERNAL).

Start standalone:  python -m tieredstorage_tpu_torch.sidecar --config cfg.json
(`--port 0` picks a free port; the bound port is printed as
`SIDECAR_READY port=<n>` for supervising processes to scrape; on a CUDA
device with encryption on, the line comes after `warm_up_device` has made
the device's context, kernels and one chunk's buffers.) The config
names this package's classes (``storage.backend.class`` =
``tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage``, ...).
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import tempfile
from concurrent import futures
from typing import Optional

import grpc

from tieredstorage_tpu_torch.errors import RemoteResourceNotFoundException
from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType
from tieredstorage_tpu_torch.metadata import LogSegmentData
from tieredstorage_tpu_torch.sidecar import rpc
from tieredstorage_tpu_torch.sidecar import sidecar_pb2 as pb
from tieredstorage_tpu_torch.utils.admission import AdmissionRejectedException
from tieredstorage_tpu_torch.utils.deadline import (
    DeadlineExceededException,
    deadline_scope,
    ensure_deadline,
    parse_deadline_ms,
)
from tieredstorage_tpu_torch.utils.flightrecorder import NOOP_RECORDER
from tieredstorage_tpu_torch.utils.tracing import NOOP_TRACER


class SidecarServer:
    def __init__(
        self, rsm, *, port: int = 0, host: str = "127.0.0.1",
        max_workers: Optional[int] = None,
    ):
        self._rsm = rsm
        self._tracer = getattr(rsm, "tracer", NOOP_TRACER)
        if max_workers is None:
            # `sidecar.grpc.max.workers` (config/rsm_config.py); 8 matches
            # the previously hardcoded pool for unconfigured RSM doubles.
            max_workers = getattr(rsm, "sidecar_grpc_max_workers", 8)
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=rpc.channel_options(),
        )
        self._server.add_generic_rpc_handlers((self._handler(),))
        # Loopback by default (tests, co-located brokers); containers pass
        # --host 0.0.0.0 so the published port actually answers.
        self.port = self._server.add_insecure_port(f"{host}:{port}")

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "SidecarServer":
        self._server.start()
        return self

    def stop(self, grace: Optional[float] = 1.0) -> None:
        self._server.stop(grace).wait()
        self._rsm.close()

    # ------------------------------------------------------------- handlers
    def _handler(self):
        impls = {
            "Copy": self._copy,
            "Fetch": self._fetch,
            "FetchIndex": self._fetch_index,
            "Delete": self._delete,
            "Health": lambda req, ctx: pb.Empty(),
        }
        handlers = {}
        for name, method in rpc.METHODS.items():
            make = (
                grpc.unary_stream_rpc_method_handler
                if method.server_streaming
                else grpc.unary_unary_rpc_method_handler
            )
            handlers[name] = make(
                self._guard(impls[name], name=name,
                            streaming=method.server_streaming),
                request_deserializer=method.request.FromString,
                response_serializer=method.response.SerializeToString,
            )
        return grpc.method_handlers_generic_handler(rpc.SERVICE, handlers)

    def _guard(self, fn, *, name: str, streaming: bool):
        """Map RSM exceptions to gRPC status codes (also mid-stream), join
        the caller's trace (`traceparent` invocation metadata parents the
        server-side span under the client's), adopt the caller's deadline
        (`x-deadline-ms` metadata, remaining budget — falling back to the
        RSM's `deadline.default.ms`), and gate every RPC through the RSM's
        AdmissionController: excess load is shed with RESOURCE_EXHAUSTED +
        a `retry-after` trailer before any storage work happens."""
        tracer = self._tracer
        rsm = self._rsm

        def classify(exc: Exception):
            if isinstance(exc, DeadlineExceededException):
                return grpc.StatusCode.DEADLINE_EXCEEDED
            if isinstance(exc, RemoteResourceNotFoundException):
                return grpc.StatusCode.NOT_FOUND
            if isinstance(exc, (ValueError, KeyError)):
                return grpc.StatusCode.INVALID_ARGUMENT
            return grpc.StatusCode.INTERNAL

        def metadata_value(context, wanted_key):
            for key, value in context.invocation_metadata() or ():
                if key == wanted_key:
                    return value
            return None

        def admit(context):
            """Admission slot, or None after aborting with RESOURCE_EXHAUSTED."""
            admission = getattr(rsm, "admission", None)
            if admission is None:
                return lambda: None
            try:
                admission.acquire(name)
            except AdmissionRejectedException as exc:
                tracer.event("admission.shed", method=name)
                context.set_trailing_metadata(
                    (("retry-after", str(max(1, round(exc.retry_after_s)))),)
                )
                context.abort(
                    grpc.StatusCode.RESOURCE_EXHAUSTED,
                    f"{type(exc).__name__}: {exc}",
                )
            return admission.release

        if streaming:
            def wrapped(request, context):
                release = admit(context)
                recorder = getattr(rsm, "flight_recorder", NOOP_RECORDER)
                try:
                    # The flight record spans the streamed drain (the
                    # generator body), like the span and deadline scopes.
                    with deadline_scope(
                            parse_deadline_ms(
                                metadata_value(context, rpc.DEADLINE_KEY))), \
                            ensure_deadline(
                                getattr(rsm, "default_deadline_s", None)), \
                            tracer.continue_trace(
                                metadata_value(context, rpc.TRACEPARENT_KEY)), \
                            tracer.span(f"sidecar.{name}") as span, \
                            recorder.request(
                                f"sidecar.{name}",
                                trace_id=span.trace_id if span else None,
                            ):
                        try:
                            yield from fn(request, context)
                        except Exception as exc:  # noqa: BLE001 — boundary translation
                            context.abort(classify(exc), f"{type(exc).__name__}: {exc}")
                finally:
                    release()

        else:
            def wrapped(request, context):
                release = admit(context)
                recorder = getattr(rsm, "flight_recorder", NOOP_RECORDER)
                try:
                    with deadline_scope(
                            parse_deadline_ms(
                                metadata_value(context, rpc.DEADLINE_KEY))), \
                            ensure_deadline(
                                getattr(rsm, "default_deadline_s", None)), \
                            tracer.continue_trace(
                                metadata_value(context, rpc.TRACEPARENT_KEY)), \
                            tracer.span(f"sidecar.{name}") as span, \
                            recorder.request(
                                f"sidecar.{name}",
                                trace_id=span.trace_id if span else None,
                            ):
                        try:
                            return fn(request, context)
                        except Exception as exc:  # noqa: BLE001 — boundary translation
                            context.abort(classify(exc), f"{type(exc).__name__}: {exc}")
                finally:
                    release()

        return wrapped

    def _copy(self, request: pb.CopyRequest, context) -> pb.CopyResponse:
        md = rpc.metadata_from_proto(request.metadata)
        # LogSegmentData carries paths; materialize the shipped bytes in a
        # scratch dir for the duration of the copy.
        with tempfile.TemporaryDirectory(prefix="sidecar-copy-") as tmp:
            base = pathlib.Path(tmp) / "segment"
            files = {
                "log": request.log_segment,
                "index": request.offset_index,
                "timeindex": request.time_index,
                "snapshot": request.producer_snapshot,
            }
            paths = {}
            for suffix, blob in files.items():
                p = base.with_suffix("." + suffix)
                p.write_bytes(blob)
                paths[suffix] = p
            txn = None
            if request.has_transaction_index:
                txn = base.with_suffix(".txnindex")
                txn.write_bytes(request.transaction_index)
            data = LogSegmentData(
                log_segment=paths["log"],
                offset_index=paths["index"],
                time_index=paths["timeindex"],
                producer_snapshot_index=paths["snapshot"],
                transaction_index=txn,
                leader_epoch_index=bytes(request.leader_epoch_index),
            )
            custom = self._rsm.copy_log_segment_data(md, data)
        return pb.CopyResponse(custom_metadata=custom or b"")

    def _fetch(self, request: pb.FetchRequest, context):
        md = rpc.metadata_from_proto(request.metadata)
        end = request.end_position if request.has_end else None
        with contextlib.closing(
            self._rsm.fetch_log_segment(md, request.start_position, end)
        ) as stream:
            while True:
                block = stream.read(rpc.STREAM_CHUNK_BYTES)
                if not block:
                    return
                yield pb.FetchChunk(data=block)

    def _fetch_index(self, request: pb.FetchIndexRequest, context):
        md = rpc.metadata_from_proto(request.metadata)
        index_type = IndexType[request.index_type]
        with contextlib.closing(self._rsm.fetch_index(md, index_type)) as stream:
            while True:
                block = stream.read(rpc.STREAM_CHUNK_BYTES)
                if not block:
                    return
                yield pb.FetchChunk(data=block)

    def _delete(self, request: pb.DeleteRequest, context) -> pb.Empty:
        self._rsm.delete_log_segment_data(rpc.metadata_from_proto(request.metadata))
        return pb.Empty()


def main(argv: Optional[list[str]] = None) -> None:
    import argparse
    import signal
    import sys
    import threading

    parser = argparse.ArgumentParser(description="tieredstorage_tpu_torch gRPC sidecar")
    parser.add_argument("--config", required=True, help="JSON file of RSM configs")
    parser.add_argument("--port", type=int, default=0)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument(
        "--metrics-port", type=int, default=None,
        help="Serve Prometheus /metrics for the RSM registry on this port "
             "(the compose demo stack's scrape target).",
    )
    parser.add_argument(
        "--http-port", type=int, default=None,
        help="Also serve the shim-wire HTTP gateway (the boundary the "
             "dependency-free JVM broker shim in kafka-shim/ speaks) on "
             "this port; 0 picks a free port.",
    )
    parser.add_argument(
        "--fleet-peers", default=None, metavar="NAME=URL,...",
        help="Fleet membership override applied after configure(): "
             "comma-separated 'name=http://host:port' entries (bare 'name' "
             "for address-less members). Replaces fleet.instances — for "
             "deployments whose gateway ports are only known at launch. "
             "Requires fleet.enabled in the config.",
    )
    parser.add_argument(
        "--virtual-cpu-devices", type=int, default=None, metavar="N",
        help="Pin the port to the CPU with N virtual CPU members before "
             "serving (host-only deployments): the transform runs on the "
             "CPU (transform.device=cpu) and its windows split over the N "
             "members (transform.mesh.devices, default all).",
    )
    args = parser.parse_args(argv)

    configs = json.loads(pathlib.Path(args.config).read_text())
    if args.virtual_cpu_devices is not None:
        from tieredstorage_tpu_torch.utils.platforms import pin_virtual_cpu

        pin_virtual_cpu(args.virtual_cpu_devices)
        configs["transform.device"] = "cpu"

    from tieredstorage_tpu_torch.rsm import RemoteStorageManager

    rsm = RemoteStorageManager()
    rsm.configure(configs)
    if args.fleet_peers:
        from tieredstorage_tpu_torch.fleet import parse_instances

        rsm.set_fleet_peers(parse_instances(args.fleet_peers.split(",")))
    # Ready means ready to serve within a peer's forward timeout: the
    # device's start-up is paid here, not by the first request.
    rsm.warm_up_device()
    exporter = None
    if args.metrics_port is not None:
        from tieredstorage_tpu_torch.metrics.prometheus import PrometheusExporter

        # Bind the exporter to the same interface as the gRPC side: a
        # loopback-only sidecar must not expose metrics network-wide.
        # The RSM's tracer rides along so /varz serves the span summary
        # (p50/p95/p99 per name) next to /metrics and /healthz; the flight
        # recorder adds the per-request `flight` section.
        exporter = PrometheusExporter(
            [rsm.metrics.registry], port=args.metrics_port, host=args.host,
            tracer=rsm.tracer, flight_recorder=rsm.flight_recorder,
        ).start()
    gateway = None
    if args.http_port is not None:
        from tieredstorage_tpu_torch.sidecar.http_gateway import SidecarHttpGateway

        gateway = SidecarHttpGateway(rsm, port=args.http_port, host=args.host).start()
    # Gossip membership starts only once the gateway can answer inbound
    # /fleet/gossip probes (fleet.gossip.enabled is a no-op otherwise).
    if gateway is not None:
        rsm.start_fleet_gossip()
    server = SidecarServer(rsm, port=args.port, host=args.host).start()
    print(
        f"SIDECAR_READY port={server.port}"
        + (f" metrics_port={exporter.port}" if exporter else "")
        + (f" http_port={gateway.port}" if gateway else ""),
        flush=True,
    )

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    stop.wait()
    if exporter is not None:
        exporter.stop()
    if gateway is not None:
        gateway.stop()
    server.stop()
    sys.exit(0)
