"""Client side of the sidecar boundary.

Counterpart of tieredstorage_tpu/sidecar/client.py. `SidecarRsmClient`
exposes the RemoteStorageManager method surface
(copy/fetch/fetch_index/delete/close) over gRPC, so callers are drop-in
independent of whether the RSM runs in-process or behind the wire; it
speaks to either package's server.

`FailoverRemoteStorageManager` implements the timeout fallback: each call
goes to the sidecar with a deadline; DEADLINE_EXCEEDED/UNAVAILABLE reroutes
that call to the RSM the caller passes as `fallback` (this package adds no
default of its own), so a wedged sidecar process degrades to that path
instead of failing reads and writes. Real answers (NOT_FOUND, bad
arguments) propagate untouched.
"""

from __future__ import annotations

import io
from typing import BinaryIO, Optional

import grpc

from tieredstorage_tpu_torch.errors import (
    RemoteResourceNotFoundException,
    RemoteStorageException,
)
from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType
from tieredstorage_tpu_torch.metadata import LogSegmentData, RemoteLogSegmentMetadata
from tieredstorage_tpu_torch.sidecar import rpc
from tieredstorage_tpu_torch.sidecar import sidecar_pb2 as pb
from tieredstorage_tpu_torch.utils.tracing import NOOP_TRACER

#: gRPC codes that mean "the sidecar can't serve right now" — the failover
#: triggers; anything else is a real answer and must propagate.
FAILOVER_CODES = (
    grpc.StatusCode.DEADLINE_EXCEEDED,
    grpc.StatusCode.UNAVAILABLE,
)


class SidecarUnavailableError(RemoteStorageException):
    """Deadline/connectivity failure — the failover wrapper's trigger."""


def _raise_mapped(err: grpc.RpcError):
    code = err.code()
    detail = err.details() or str(code)
    if code in FAILOVER_CODES:
        raise SidecarUnavailableError(detail) from None
    if code == grpc.StatusCode.NOT_FOUND:
        raise RemoteResourceNotFoundException(detail) from None
    if code == grpc.StatusCode.INVALID_ARGUMENT:
        raise ValueError(detail) from None
    raise RemoteStorageException(detail) from None


class SidecarRsmClient:
    def __init__(self, target: str, *, timeout: Optional[float] = None,
                 tracer=None):
        self._channel = grpc.insecure_channel(target, options=rpc.channel_options())
        self._timeout = timeout
        # Client-side spans + traceparent metadata: a fetch through the
        # sidecar shows up as ONE tree (client.fetch → sidecar.Fetch →
        # rsm.fetch_log_segment → storage.*) instead of two disjoint traces.
        self._tracer = tracer if tracer is not None else NOOP_TRACER
        self._stubs = {}
        for name, m in rpc.METHODS.items():
            make = (
                self._channel.unary_stream
                if m.server_streaming
                else self._channel.unary_unary
            )
            self._stubs[name] = make(
                m.path,
                request_serializer=m.request.SerializeToString,
                response_deserializer=m.response.FromString,
            )

    def _effective_timeout(self, timeout: Optional[float]) -> Optional[float]:
        """Per-call gRPC timeout clamped to the ambient Deadline's remaining
        budget, so a late call in a deadlined request can't take a full
        fresh timeout (cross-layer deadline semantics)."""
        from tieredstorage_tpu_torch.utils.deadline import remaining_s

        candidates = [t for t in (timeout or self._timeout, remaining_s())
                      if t is not None]
        return max(0.001, min(candidates)) if candidates else None

    def _invoke(self, name: str, req, timeout: Optional[float] = None):
        """Unary call inside a client span; traceparent + deadline metadata
        attached (computed INSIDE the span so the server parents under it)."""
        with self._tracer.span(f"client.{name}"):
            return self._stubs[name](
                req, timeout=self._effective_timeout(timeout),
                metadata=rpc.invocation_metadata(self._tracer),
            )

    # ------------------------------------------------------------- surface
    def health(self, timeout: Optional[float] = None) -> None:
        self._invoke("Health", pb.Empty(), timeout=timeout)

    def copy_log_segment_data(
        self, metadata: RemoteLogSegmentMetadata, data: LogSegmentData
    ) -> bytes:
        req = pb.CopyRequest(
            metadata=rpc.metadata_to_proto(metadata),
            log_segment=data.log_segment.read_bytes(),
            offset_index=data.offset_index.read_bytes(),
            time_index=data.time_index.read_bytes(),
            producer_snapshot=data.producer_snapshot_index.read_bytes(),
            leader_epoch_index=bytes(data.leader_epoch_index),
        )
        if data.transaction_index is not None:
            req.transaction_index = data.transaction_index.read_bytes()
            req.has_transaction_index = True
        try:
            resp = self._invoke("Copy", req)
        except grpc.RpcError as err:
            _raise_mapped(err)
        return bytes(resp.custom_metadata)

    def fetch_log_segment(
        self,
        metadata: RemoteLogSegmentMetadata,
        start_position: int,
        end_position: Optional[int] = None,
    ) -> BinaryIO:
        req = pb.FetchRequest(
            metadata=rpc.metadata_to_proto(metadata),
            start_position=start_position,
            end_position=end_position if end_position is not None else 0,
            has_end=end_position is not None,
        )
        return self._drain("Fetch", req)

    def fetch_index(
        self, metadata: RemoteLogSegmentMetadata, index_type: IndexType
    ) -> BinaryIO:
        req = pb.FetchIndexRequest(
            metadata=rpc.metadata_to_proto(metadata), index_type=index_type.name
        )
        return self._drain("FetchIndex", req)

    def delete_log_segment_data(self, metadata: RemoteLogSegmentMetadata) -> None:
        try:
            self._invoke(
                "Delete", pb.DeleteRequest(metadata=rpc.metadata_to_proto(metadata))
            )
        except grpc.RpcError as err:
            _raise_mapped(err)

    def close(self) -> None:
        self._channel.close()

    # ------------------------------------------------------------ internals
    def _drain(self, name: str, req) -> BinaryIO:
        buf = io.BytesIO()
        try:
            with self._tracer.span(f"client.{name}") as span:
                for chunk in self._stubs[name](
                    req, timeout=self._effective_timeout(None),
                    metadata=rpc.invocation_metadata(self._tracer),
                ):
                    buf.write(chunk.data)
                if span is not None:
                    span.attributes["bytes"] = buf.tell()
        except grpc.RpcError as err:
            _raise_mapped(err)
        buf.seek(0)
        return buf


class FailoverRemoteStorageManager:
    """Sidecar-first RSM: per-call deadline, fallback to the caller's RSM.

    `fallback` is any object with the RSM surface, over the same storage,
    so data written by either path is readable by both (same wire
    format)."""

    def __init__(self, client: SidecarRsmClient, fallback, *, timeout: float):
        self._client = client
        self._fallback = fallback
        self._timeout = timeout
        client._timeout = timeout
        self.fallback_calls = 0

    def _route(self, method: str, *args):
        try:
            return getattr(self._client, method)(*args)
        except SidecarUnavailableError:
            self.fallback_calls += 1
            return getattr(self._fallback, method)(*args)

    def copy_log_segment_data(self, metadata, data):
        return self._route("copy_log_segment_data", metadata, data)

    def fetch_log_segment(self, metadata, start_position, end_position=None):
        return self._route("fetch_log_segment", metadata, start_position, end_position)

    def fetch_index(self, metadata, index_type):
        return self._route("fetch_index", metadata, index_type)

    def delete_log_segment_data(self, metadata):
        return self._route("delete_log_segment_data", metadata)

    def close(self) -> None:
        self._client.close()
        self._fallback.close()
