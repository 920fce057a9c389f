"""Shim wire format v1 — the JDK-only encoding of the sidecar boundary.

Counterpart of tieredstorage_tpu/sidecar/shimwire.py, whole: the same bytes
for every frame, so the broker shim speaks to either package's gateway.

The broker-side JVM shim (`kafka-shim/`) must be deployable with ZERO
third-party jars: a broker operator drops one class (plus
`kafka-storage-api`, already on the broker classpath) next to the broker
and points it at the sidecar. grpc-java + protobuf-java + netty would be a
shaded-jar dependency train, and `java.net.http` cannot read the HTTP/2
trailers gRPC carries its status in — so the sidecar exposes this second,
deliberately boring boundary for the shim: HTTP/1.1 + a fixed big-endian
binary framing that `java.io.DataOutputStream` writes naturally. The gRPC
service (sidecar/server.py) remains the boundary for Python clients; both
front the same RemoteStorageManager in the same process.

All integers big-endian (Java DataOutput order). The metadata block mirrors
KIP-405 RemoteLogSegmentMetadata (reference:
storage/api/.../RemoteLogSegmentMetadata semantics via
core/.../RemoteStorageManager.java:106):

    u8   version (1)
    16B  topic_id          (Kafka Uuid, msb||lsb)
    16B  segment_id
    u16  topic_len | utf8 topic
    i32  partition
    i64  start_offset | i64 end_offset | i64 max_timestamp_ms
    i32  broker_id | i64 event_timestamp_ms
    i32  n_epochs | n x (i32 leader_epoch, i64 start_offset)
    i64  segment_size_bytes
    u8   has_custom | [u32 len | bytes]

Requests (POST bodies; responses are raw bytes or empty):

    /v1/copy         metadata + 6 sections (log, offset_index, time_index,
                     producer_snapshot, transaction_index,
                     leader_epoch_index), each u8 present | u64 len | bytes
                     -> 200 custom-metadata bytes | 204 none
    /v1/fetch        metadata + i64 start + u8 has_end + i64 end
                     -> 200 raw segment byte stream
    /v1/fetch-index  metadata + u16 len | utf8 IndexType name
                     -> 200 raw index byte stream
    /v1/delete       metadata -> 204
    GET /v1/health   -> 200

Errors: 404 = RemoteResourceNotFoundException, 400 = invalid argument,
500 = anything else; the body is a UTF-8 message. The Java shim maps these
back onto the KIP-405 exception types.

Trace context deliberately rides the standard W3C ``traceparent`` HTTP
header, NOT the binary frame: wire version 1 stays byte-stable, and the JVM
shim can join broker-side traces with one `setHeader` (java.net.http passes
unknown headers through untouched, so older shims interoperate unchanged).
"""

from __future__ import annotations

import io
import struct
from typing import BinaryIO, Optional

from tieredstorage_tpu_torch.metadata import (
    KafkaUuid,
    RemoteLogSegmentId,
    RemoteLogSegmentMetadata,
    TopicIdPartition,
    TopicPartition,
)

VERSION = 1

#: W3C trace-context header joining shim requests to the caller's trace
#: (see module docstring: headers, not frame bytes, carry trace identity).
TRACEPARENT_HEADER = "traceparent"

#: Remaining end-to-end budget in integer milliseconds — the deadline twin
#: of the traceparent header (utils/deadline.py). Like trace context, it
#: rides a header rather than the binary frame so wire version 1 stays
#: byte-stable and older shims interoperate unchanged.
DEADLINE_HEADER = "x-deadline-ms"


def trace_headers(tracer) -> dict[str, str]:
    """Headers a shim-wire client should attach to join the active trace;
    empty when there is nothing to propagate (tracing disabled / no span)."""
    traceparent = tracer.current_traceparent() if tracer is not None else None
    return {TRACEPARENT_HEADER: traceparent} if traceparent else {}


def deadline_headers() -> dict[str, str]:
    """Header propagating the ambient Deadline's remaining budget; empty
    when the calling context is unconstrained."""
    from tieredstorage_tpu_torch.utils.deadline import current_deadline

    deadline = current_deadline()
    return {DEADLINE_HEADER: deadline.header_value()} if deadline else {}


def request_headers(tracer) -> dict[str, str]:
    """Everything a shim-wire client should attach: trace + deadline."""
    return {**trace_headers(tracer), **deadline_headers()}


COPY_SECTIONS = (
    "log_segment",
    "offset_index",
    "time_index",
    "producer_snapshot",
    "transaction_index",
    "leader_epoch_index",
)


class ShimWireError(ValueError):
    """Malformed shim-wire payload."""


def _read(buf: BinaryIO, n: int) -> bytes:
    data = buf.read(n)
    if len(data) != n:
        raise ShimWireError(f"truncated payload: wanted {n} bytes, got {len(data)}")
    return data


def encode_metadata(md: RemoteLogSegmentMetadata) -> bytes:
    rid = md.remote_log_segment_id
    topic = rid.topic_id_partition.topic_partition.topic.encode("utf-8")
    out = io.BytesIO()
    out.write(struct.pack(">B", VERSION))
    out.write(rid.topic_id_partition.topic_id.raw)
    out.write(rid.id.raw)
    out.write(struct.pack(">H", len(topic)))
    out.write(topic)
    out.write(
        struct.pack(
            ">iqqqiq",
            rid.topic_id_partition.topic_partition.partition,
            md.start_offset,
            md.end_offset,
            md.max_timestamp_ms,
            md.broker_id,
            md.event_timestamp_ms,
        )
    )
    epochs = sorted(md.segment_leader_epochs.items())
    out.write(struct.pack(">i", len(epochs)))
    for epoch, offset in epochs:
        out.write(struct.pack(">iq", epoch, offset))
    out.write(struct.pack(">q", md.segment_size_in_bytes))
    if md.custom_metadata is None:
        out.write(b"\x00")
    else:
        out.write(struct.pack(">BI", 1, len(md.custom_metadata)))
        out.write(md.custom_metadata)
    return out.getvalue()


def decode_metadata(buf: BinaryIO) -> RemoteLogSegmentMetadata:
    (version,) = struct.unpack(">B", _read(buf, 1))
    if version != VERSION:
        raise ShimWireError(f"unsupported shim wire version {version}")
    topic_id = KafkaUuid(_read(buf, 16))
    segment_id = KafkaUuid(_read(buf, 16))
    (topic_len,) = struct.unpack(">H", _read(buf, 2))
    topic = _read(buf, topic_len).decode("utf-8")
    partition, start, end, max_ts, broker, event_ts = struct.unpack(
        ">iqqqiq", _read(buf, 4 + 8 * 3 + 4 + 8)
    )
    (n_epochs,) = struct.unpack(">i", _read(buf, 4))
    if n_epochs < 0 or n_epochs > 1 << 20:
        raise ShimWireError(f"implausible epoch count {n_epochs}")
    epochs = {}
    for _ in range(n_epochs):
        epoch, offset = struct.unpack(">iq", _read(buf, 12))
        epochs[epoch] = offset
    (size,) = struct.unpack(">q", _read(buf, 8))
    (has_custom,) = struct.unpack(">B", _read(buf, 1))
    custom: Optional[bytes] = None
    if has_custom:
        (clen,) = struct.unpack(">I", _read(buf, 4))
        custom = _read(buf, clen)
    return RemoteLogSegmentMetadata(
        remote_log_segment_id=RemoteLogSegmentId(
            TopicIdPartition(topic_id, TopicPartition(topic, partition)), segment_id
        ),
        start_offset=start,
        end_offset=end,
        max_timestamp_ms=max_ts,
        broker_id=broker,
        event_timestamp_ms=event_ts,
        segment_leader_epochs=epochs,
        segment_size_in_bytes=size,
        custom_metadata=custom,
    )


def encode_sections(sections: dict) -> bytes:
    """COPY_SECTIONS name -> Optional[bytes], in wire order (the Python-side
    encoder mirror of the Java shim's copyBody; symmetry-pinned against the
    independent test encoder in tests/test_sidecar_http_gateway.py, held against this module
    in tests/test_torch_shimwire.py)."""
    out = io.BytesIO()
    for name in COPY_SECTIONS:
        blob = sections.get(name)
        if blob is None:
            out.write(b"\x00")
        else:
            out.write(struct.pack(">BQ", 1, len(blob)))
            out.write(blob)
    return out.getvalue()


def decode_sections_to_dir(
    buf: BinaryIO, directory, *, max_section: int = 2 << 30
) -> dict:
    """Like decode_sections, but streams each present section straight into
    `directory`/<name> so a whole segment never has to sit in sidecar RAM.
    Returns COPY_SECTIONS name -> Optional[pathlib.Path]."""
    import pathlib
    import shutil

    directory = pathlib.Path(directory)
    sections: dict = {}
    for name in COPY_SECTIONS:
        (present,) = struct.unpack(">B", _read(buf, 1))
        if not present:
            sections[name] = None
            continue
        (length,) = struct.unpack(">Q", _read(buf, 8))
        if length > max_section:
            raise ShimWireError(f"section {name} of {length} bytes over the cap")
        path = directory / name
        with open(path, "wb") as out:
            shutil.copyfileobj(io.BytesIO(_read(buf, length)) if length < (1 << 20)
                               else _SectionReader(buf, length), out)
        if path.stat().st_size != length:
            raise ShimWireError(f"section {name} truncated")
        sections[name] = path
    return sections


class _SectionReader(io.RawIOBase):
    """Bounded view over `buf` for streaming one section to disk."""

    def __init__(self, buf: BinaryIO, length: int):
        self._buf = buf
        self._remaining = length

    def readable(self) -> bool:
        return True

    def read(self, size: int = -1) -> bytes:
        if self._remaining == 0:
            return b""
        if size is None or size < 0:
            size = self._remaining
        data = self._buf.read(min(size, self._remaining))
        if not data:
            raise ShimWireError("truncated section payload")
        self._remaining -= len(data)
        return data


def encode_fetch_tail(start: int, end: Optional[int]) -> bytes:
    return struct.pack(
        ">qBq", start, 1 if end is not None else 0, end if end is not None else 0
    )


def decode_fetch_tail(buf: BinaryIO) -> tuple[int, Optional[int]]:
    start, has_end, end = struct.unpack(">qBq", _read(buf, 17))
    return start, end if has_end else None


def encode_index_type(name: str) -> bytes:
    raw = name.encode("utf-8")
    return struct.pack(">H", len(raw)) + raw


def decode_index_type(buf: BinaryIO) -> str:
    (length,) = struct.unpack(">H", _read(buf, 2))
    return _read(buf, length).decode("utf-8")
