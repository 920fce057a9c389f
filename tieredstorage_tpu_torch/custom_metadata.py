"""KIP-405 custom segment metadata: tagged fields stored by the broker.

Reference: core/.../metadata/{SegmentCustomMetadataField.java (fields
REMOTE_SIZE(0, varlong), OBJECT_PREFIX(1, compact string),
OBJECT_KEY(2, compact string) — indexes are wire compatibility-critical),
SegmentCustomMetadataBuilder.java:30-64, SegmentCustomMetadataSerde.java:28-58}.

Wire format is Kafka's tagged-fields section: uvarint field count, then per
field in ascending tag order: uvarint tag, uvarint payload size, payload.
VARLONG payloads are zigzag varlongs; COMPACT_STRING payloads are
uvarint(len+1) + UTF-8 bytes.
"""

from __future__ import annotations

import enum
from typing import Callable, Mapping

from tieredstorage_tpu_torch.metadata import RemoteLogSegmentMetadata
from tieredstorage_tpu_torch.object_key import Suffix, main_path
from tieredstorage_tpu_torch.utils.varint import (
    read_unsigned_varint,
    read_varlong,
    write_unsigned_varint,
    write_varlong,
)


class _FieldType(enum.Enum):
    VARLONG = "varlong"
    COMPACT_STRING = "compact_string"


class SegmentCustomMetadataField(enum.Enum):
    REMOTE_SIZE = (0, _FieldType.VARLONG)
    OBJECT_PREFIX = (1, _FieldType.COMPACT_STRING)
    OBJECT_KEY = (2, _FieldType.COMPACT_STRING)

    def __init__(self, index: int, field_type: _FieldType):
        self.index = index
        self.field_type = field_type

    @staticmethod
    def by_index(index: int) -> "SegmentCustomMetadataField":
        for f in SegmentCustomMetadataField:
            if f.index == index:
                return f
        raise ValueError(f"Unknown custom metadata field index {index}")

    @staticmethod
    def names() -> list[str]:
        return [f.name for f in SegmentCustomMetadataField]


def _encode_payload(field: SegmentCustomMetadataField, value: object) -> bytes:
    out = bytearray()
    if field.field_type is _FieldType.VARLONG:
        write_varlong(int(value), out)
    else:
        data = str(value).encode("utf-8")
        write_unsigned_varint(len(data) + 1, out)
        out += data
    return bytes(out)


def _decode_payload(field: SegmentCustomMetadataField, data: bytes) -> object:
    if field.field_type is _FieldType.VARLONG:
        value, _ = read_varlong(data, 0)
        return value
    length_plus_one, pos = read_unsigned_varint(data, 0)
    return data[pos : pos + length_plus_one - 1].decode("utf-8")


def serialize_custom_metadata(fields: Mapping[int, object]) -> bytes:
    if not fields:
        return b""
    out = bytearray()
    write_unsigned_varint(len(fields), out)
    for tag in sorted(fields):
        payload = _encode_payload(SegmentCustomMetadataField.by_index(tag), fields[tag])
        write_unsigned_varint(tag, out)
        write_unsigned_varint(len(payload), out)
        out += payload
    return bytes(out)


def deserialize_custom_metadata(data: bytes | None) -> dict[int, object]:
    if not data:
        return {}
    count, pos = read_unsigned_varint(data, 0)
    fields: dict[int, object] = {}
    for _ in range(count):
        tag, pos = read_unsigned_varint(data, pos)
        size, pos = read_unsigned_varint(data, pos)
        fields[tag] = _decode_payload(
            SegmentCustomMetadataField.by_index(tag), data[pos : pos + size]
        )
        pos += size
    return fields


class SegmentCustomMetadataBuilder:
    """Accumulates per-suffix upload byte counts; emits the configured field subset."""

    def __init__(
        self,
        include_fields: list[SegmentCustomMetadataField],
        object_key_prefix: str,
        segment_metadata: RemoteLogSegmentMetadata,
    ):
        self._include = include_fields
        self._prefix = object_key_prefix
        self._metadata = segment_metadata
        self._sizes: dict[Suffix, int] = {}

    def add_upload_result(self, suffix: Suffix, bytes_uploaded: int) -> "SegmentCustomMetadataBuilder":
        if suffix in self._sizes:
            raise ValueError(f"Upload result for {suffix} already added")
        self._sizes[suffix] = bytes_uploaded
        return self

    def total_size(self) -> int:
        return sum(self._sizes.values())

    def build(self) -> dict[int, object]:
        providers: dict[SegmentCustomMetadataField, Callable[[], object]] = {
            SegmentCustomMetadataField.REMOTE_SIZE: self.total_size,
            SegmentCustomMetadataField.OBJECT_PREFIX: lambda: self._prefix,
            SegmentCustomMetadataField.OBJECT_KEY: lambda: main_path(self._metadata),
        }
        return {f.index: providers[f]() for f in self._include}
