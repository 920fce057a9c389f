"""Shared method table for the hand-bound gRPC service.

Counterpart of tieredstorage_tpu/sidecar/rpc.py, whole: the same service
name, method paths and metadata keys, so the two packages' clients and
servers interoperate.

grpc_tools (the protoc gRPC plugin) is not in this image, so the service
is registered from this table on both sides: the server via
`grpc.method_handlers_generic_handler`, the client via
`channel.unary_unary`/`unary_stream` with the generated message classes'
serializers. protoc itself generates sidecar_pb2 (see sidecar.proto).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from tieredstorage_tpu_torch.sidecar import sidecar_pb2 as pb

SERVICE = "tieredstorage.sidecar.v1.RemoteStorageSidecar"


@dataclasses.dataclass(frozen=True)
class Method:
    name: str
    request: type
    response: type
    server_streaming: bool = False

    @property
    def path(self) -> str:
        return f"/{SERVICE}/{self.name}"


METHODS = {
    m.name: m
    for m in (
        Method("Copy", pb.CopyRequest, pb.CopyResponse),
        Method("Fetch", pb.FetchRequest, pb.FetchChunk, server_streaming=True),
        Method(
            "FetchIndex", pb.FetchIndexRequest, pb.FetchChunk, server_streaming=True
        ),
        Method("Delete", pb.DeleteRequest, pb.Empty),
        Method("Health", pb.Empty, pb.Empty),
    )
}

#: gRPC invocation-metadata key carrying the W3C trace context — the gRPC
#: twin of the HTTP gateway's `traceparent` header (shimwire.TRACEPARENT_HEADER).
TRACEPARENT_KEY = "traceparent"

#: gRPC invocation-metadata key carrying the remaining end-to-end budget in
#: integer milliseconds — the gRPC twin of shimwire.DEADLINE_HEADER.
DEADLINE_KEY = "x-deadline-ms"


def trace_metadata(tracer) -> Optional[tuple[tuple[str, str], ...]]:
    """Invocation metadata joining a call to the active trace, or None when
    there is nothing to propagate (tracing disabled / no active span)."""
    traceparent = tracer.current_traceparent() if tracer is not None else None
    return ((TRACEPARENT_KEY, traceparent),) if traceparent else None


def invocation_metadata(tracer) -> Optional[tuple[tuple[str, str], ...]]:
    """Trace + deadline invocation metadata for an outgoing sidecar call;
    None when neither is active."""
    from tieredstorage_tpu_torch.utils.deadline import current_deadline

    out = list(trace_metadata(tracer) or ())
    deadline = current_deadline()
    if deadline is not None:
        out.append((DEADLINE_KEY, deadline.header_value()))
    return tuple(out) or None


#: Per-message ceiling for unary payloads (whole segments ride CopyRequest).
MAX_MESSAGE_BYTES = 512 << 20

#: Fetch/FetchIndex stream frame size.
STREAM_CHUNK_BYTES = 1 << 20


def channel_options() -> list[tuple[str, int]]:
    return [
        ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
        ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
    ]


def metadata_to_proto(md, *, include_custom: bool = True) -> pb.SegmentMetadata:
    """RemoteLogSegmentMetadata -> proto."""
    rid = md.remote_log_segment_id
    tip = rid.topic_id_partition
    out = pb.SegmentMetadata(
        id=pb.SegmentId(
            topic_id=bytes(tip.topic_id.raw),
            topic=tip.topic_partition.topic,
            partition=tip.topic_partition.partition,
            segment_id=bytes(rid.id.raw),
        ),
        start_offset=md.start_offset,
        end_offset=md.end_offset,
        max_timestamp_ms=md.max_timestamp_ms,
        broker_id=md.broker_id,
        event_timestamp_ms=md.event_timestamp_ms,
        segment_size_bytes=md.segment_size_in_bytes,
    )
    for epoch, offset in md.segment_leader_epochs.items():
        out.leader_epochs[int(epoch)] = int(offset)
    if include_custom and md.custom_metadata is not None:
        out.custom_metadata = bytes(md.custom_metadata)
        out.has_custom_metadata = True
    return out


def metadata_from_proto(msg: pb.SegmentMetadata):
    from tieredstorage_tpu_torch.metadata import (
        KafkaUuid,
        RemoteLogSegmentId,
        RemoteLogSegmentMetadata,
        TopicIdPartition,
        TopicPartition,
    )

    return RemoteLogSegmentMetadata(
        remote_log_segment_id=RemoteLogSegmentId(
            TopicIdPartition(
                KafkaUuid(bytes(msg.id.topic_id)),
                TopicPartition(msg.id.topic, msg.id.partition),
            ),
            KafkaUuid(bytes(msg.id.segment_id)),
        ),
        start_offset=msg.start_offset,
        end_offset=msg.end_offset,
        max_timestamp_ms=msg.max_timestamp_ms,
        broker_id=msg.broker_id,
        event_timestamp_ms=msg.event_timestamp_ms,
        segment_leader_epochs=dict(msg.leader_epochs),
        segment_size_in_bytes=msg.segment_size_bytes,
        custom_metadata=(
            bytes(msg.custom_metadata) if msg.has_custom_metadata else None
        ),
    )
