"""The port's wire codecs against the JAX package's, byte for byte.

`manifest/codec.py` (the chunk-size codec), `utils/varint.py` (Kafka's
unsigned varint and zigzag varlong), `custom_metadata.py` (KIP-405 tagged
fields), `kafka_records.py` (the first batch's compression codec) and
`fetch/enumeration.py` (an original-byte range over chunk streams) and
`object_key.py` (the stored objects' names): each
case runs the same seeded input through both packages and holds the bytes,
the values and the errors equal. These are the owners of those modules in
tools/torch_mutation_test.py.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest

from tieredstorage_tpu import custom_metadata as jax_custom_metadata
from tieredstorage_tpu import kafka_records as jax_kafka_records
from tieredstorage_tpu import metadata as jax_metadata
from tieredstorage_tpu import object_key as jax_object_key
from tieredstorage_tpu.manifest import codec as jax_codec
from tieredstorage_tpu.utils import varint as jax_varint
from tieredstorage_tpu_torch import custom_metadata, kafka_records, object_key
from tieredstorage_tpu_torch.errors import RemoteResourceNotFoundException
from tieredstorage_tpu_torch.fetch.enumeration import FetchChunkEnumeration
from tieredstorage_tpu_torch.manifest import codec
from tieredstorage_tpu_torch.manifest.chunk_index import FixedSizeChunkIndex
from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType, SegmentIndexesV1Builder
from tieredstorage_tpu_torch.manifest.segment_manifest import SegmentManifestV1
from tieredstorage_tpu_torch.metadata import (
    KafkaUuid,
    RemoteLogSegmentId,
    RemoteLogSegmentMetadata,
    TopicIdPartition,
    TopicPartition,
)
from tieredstorage_tpu_torch.object_key import ObjectKeyFactory, Suffix
from tieredstorage_tpu_torch.storage.core import BytesRange, KeyNotFoundException, ObjectKey
from tieredstorage_tpu_torch.utils import varint

# ------------------------------------------------------------ chunk sizes
#: Lists whose de-based maximum sits on each bytes-per-value boundary, plus
#: the degenerate lengths and seeded random ones.
_SIZE_CASES = [
    [], [0], [7], [5, 5], [4096, 4096, 4096, 100], [10, 265, 3], [10, 266, 3],
    [1, 65536, 9], [1, 65537, 9], [0, (1 << 24) - 1, 2], [0, 1 << 24, 2],
    [3, 0x7FFFFFFF, 0x7FFFFFFF],
] + [
    [int(v) for v in np.random.default_rng(seed).integers(0, hi, n)]
    for seed, (n, hi) in enumerate([(2, 200), (17, 300), (64, 70_000), (129, 1 << 20),
                                    (300, 1 << 30)])
]


@pytest.mark.parametrize("values", _SIZE_CASES, ids=range(len(_SIZE_CASES)))
def test_chunk_sizes_encode_like_jax_and_round_trip(values):
    wire = codec.encode_chunk_sizes(values)
    assert wire == jax_codec.encode_chunk_sizes(values)
    assert codec.decode_chunk_sizes(wire) == values == jax_codec.decode_chunk_sizes(wire)


@pytest.mark.parametrize("values", [[-1], [3, -2, 4], [2, 5, -1], [0x80000000, 1],
                                    [1, 0x80000000]])
def test_chunk_sizes_refuse_what_jax_refuses(values):
    with pytest.raises(ValueError):
        jax_codec.encode_chunk_sizes(values)
    with pytest.raises(ValueError):
        codec.encode_chunk_sizes(values)


# ----------------------------------------------------------------- varints
_UNSIGNED = [0, 1, 127, 128, 255, 16383, 16384, (1 << 21) - 1, 1 << 21, 0x7FFFFFFF,
             0xFFFFFFFF, (1 << 63) - 1, (1 << 64) - 1]
_SIGNED = [0, 1, -1, 63, -64, 64, -65, 8191, -8192, 0x7FFFFFFF, -0x80000000,
           (1 << 63) - 1, -(1 << 63)]


@pytest.mark.parametrize("value", _UNSIGNED)
def test_unsigned_varint_matches_jax(value):
    out, jax_out = bytearray(b"\x09"), bytearray(b"\x09")
    varint.write_unsigned_varint(value, out)
    jax_varint.write_unsigned_varint(value, jax_out)
    assert out == jax_out
    assert varint.read_unsigned_varint(bytes(out) + b"\x55", 1) == (value, len(out))


@pytest.mark.parametrize("value", _SIGNED)
def test_varlong_matches_jax(value):
    out, jax_out = bytearray(), bytearray()
    varint.write_varlong(value, out)
    jax_varint.write_varlong(value, jax_out)
    assert out == jax_out
    assert varint.read_varlong(bytes(out), 0) == (value, len(out))
    assert jax_varint.read_varlong(bytes(out), 0) == (value, len(out))


@pytest.mark.parametrize("data, pos", [(b"", 0), (b"\x80", 0), (b"\x01\xff\xff", 1),
                                       (b"\xff" * 10 + b"\x01", 0)])
def test_bad_varints_fail_in_both(data, pos):
    with pytest.raises(ValueError):
        jax_varint.read_unsigned_varint(data, pos)
    with pytest.raises(ValueError):
        varint.read_unsigned_varint(data, pos)
    with pytest.raises(ValueError):
        varint.write_unsigned_varint(-1, bytearray())


# ---------------------------------------------------------- custom metadata
_FIELDS = [
    {},
    {0: 0},
    {0: 123_456_789},
    {1: "prefix/"},
    {2: "topic-AAAA/0/00000000000000000099-BBBB"},
    {0: 1 << 40, 1: "p/", 2: "k/ünïcödé"},
    {2: "x" * 300, 0: 77},
]


@pytest.mark.parametrize("fields", _FIELDS, ids=range(len(_FIELDS)))
def test_custom_metadata_serde_matches_jax(fields):
    wire = custom_metadata.serialize_custom_metadata(fields)
    assert wire == jax_custom_metadata.serialize_custom_metadata(fields)
    assert custom_metadata.deserialize_custom_metadata(wire) == fields
    assert jax_custom_metadata.deserialize_custom_metadata(wire) == fields


def test_custom_metadata_fields_and_builder():
    field = custom_metadata.SegmentCustomMetadataField
    assert field.names() == jax_custom_metadata.SegmentCustomMetadataField.names()
    assert [field.by_index(i).name for i in range(3)] == field.names()
    with pytest.raises(ValueError):
        field.by_index(3)
    with pytest.raises(ValueError):
        custom_metadata.serialize_custom_metadata({5: 1})
    assert custom_metadata.deserialize_custom_metadata(None) == {}
    tip = TopicIdPartition(KafkaUuid(b"\x03" * 16), TopicPartition("topic", 7))
    md = RemoteLogSegmentMetadata(RemoteLogSegmentId(tip, KafkaUuid(b"\x04" * 16)), 9, 10, 1234)
    builder = custom_metadata.SegmentCustomMetadataBuilder(
        [field.REMOTE_SIZE, field.OBJECT_KEY], "pre/", md)
    builder.add_upload_result(Suffix.LOG, 1000).add_upload_result(Suffix.INDEXES, 20)
    with pytest.raises(ValueError):
        builder.add_upload_result(Suffix.LOG, 1)
    assert builder.total_size() == 1020
    built = builder.build()
    assert sorted(built) == [0, 2] and built[0] == 1020 and built[2].endswith("-BAQEBAQEBAQEBAQEBAQEBA")
    everything = custom_metadata.SegmentCustomMetadataBuilder(list(field), "pre/", md).build()
    assert everything == {0: 0, 1: "pre/", 2: built[2]}


# ------------------------------------------------------------ record batches
def _v2_header(attributes: int, magic: int = 2) -> bytes:
    return struct.pack(">qiibih", 0, 100, 0, magic, 0, attributes) + b"\x00" * 40


_HEADERS = [
    _v2_header(0), _v2_header(1), _v2_header(2), _v2_header(3), _v2_header(4),
    _v2_header(0x10), _v2_header(0x13), _v2_header(0x7FF8),
    b"\x00" * 16 + bytes([0, 0x01]) + b"\x00" * 20,
    b"\x00" * 16 + bytes([1, 0x0A]) + b"\x00" * 20,
    b"\x00" * 16 + bytes([1, 0x00]),
]
_BAD_HEADERS = [b"", b"\x00" * 17, _v2_header(0)[:22], b"\x00" * 16 + bytes([3]) + b"\x00" * 10,
                b"\x00" * 16 + bytes([255]) + b"\x00" * 10]


@pytest.mark.parametrize("header", _HEADERS, ids=range(len(_HEADERS)))
def test_first_batch_codec_matches_jax(tmp_path, header):
    seg = tmp_path / "s.log"
    seg.write_bytes(header)
    got = kafka_records.first_batch_compression_codec(seg)
    assert got == jax_kafka_records.first_batch_compression_codec(seg)
    assert kafka_records.segment_looks_compressed(seg) == (got != 0)
    assert kafka_records.segment_looks_compressed(seg) == jax_kafka_records.segment_looks_compressed(seg)


@pytest.mark.parametrize("header", _BAD_HEADERS, ids=range(len(_BAD_HEADERS)))
def test_unreadable_first_batch_fails_in_both(tmp_path, header):
    seg = tmp_path / "s.log"
    seg.write_bytes(header)
    with pytest.raises(jax_kafka_records.InvalidRecordBatchException):
        jax_kafka_records.first_batch_compression_codec(seg)
    with pytest.raises(kafka_records.InvalidRecordBatchException):
        kafka_records.first_batch_compression_codec(seg)
    with pytest.raises(kafka_records.InvalidRecordBatchException):
        kafka_records.first_batch_compression_codec(tmp_path / "missing.log")


# ------------------------------------------------------------- enumeration
_CHUNK = 100
_SIZE = 1030  # ten whole chunks and a 30-byte tail
_SOURCE = np.random.default_rng(5).integers(0, 256, _SIZE, np.uint8).tobytes()


class _Chunks:
    """A chunk manager over the plain source: counts the chunks it served."""

    def __init__(self, missing: bool = False):
        self.served: list[int] = []
        self.missing = missing

    def get_chunks(self, key, manifest, ids):
        if self.missing:
            raise KeyNotFoundException(None, key)
        self.served.extend(ids)
        return [_SOURCE[i * _CHUNK : (i + 1) * _CHUNK] for i in ids]


def _manifest() -> SegmentManifestV1:
    builder = SegmentIndexesV1Builder()
    for t in (IndexType.OFFSET, IndexType.TIMESTAMP, IndexType.PRODUCER_SNAPSHOT,
              IndexType.LEADER_EPOCH):
        builder.add(t, 0)
    index = FixedSizeChunkIndex(original_chunk_size=_CHUNK, original_file_size=_SIZE,
                                transformed_chunk_size=_CHUNK, final_transformed_chunk_size=30)
    return SegmentManifestV1(chunk_index=index, segment_indexes=builder.build(),
                             compression=False, encryption=None,
                             remote_log_segment_metadata=None)


_RANGES = [(0, 0), (0, 99), (0, 100), (99, 100), (150, 450), (999, 1029), (1000, 1029),
           (1029, 1029), (0, _SIZE - 1), (512, 5000), (37, 10_000)]


@pytest.mark.parametrize("start, end", _RANGES)
def test_enumeration_reads_the_range(start, end):
    chunks = _Chunks()
    stream = FetchChunkEnumeration(chunks, ObjectKey("k"), _manifest(),
                                   BytesRange(start, end)).to_stream()
    assert stream.read() == _SOURCE[start : end + 1]
    assert chunks.served == list(range(start // _CHUNK, min(end, _SIZE - 1) // _CHUNK + 1))


def test_enumeration_is_lazy_and_refuses_what_it_cannot_read():
    chunks = _Chunks()
    stream = FetchChunkEnumeration(chunks, ObjectKey("k"), _manifest(),
                                   BytesRange(50, 900)).to_stream()
    assert stream.read(10) == _SOURCE[50:60]
    assert chunks.served == [0]
    with pytest.raises(ValueError):
        FetchChunkEnumeration(chunks, ObjectKey("k"), _manifest(), BytesRange(_SIZE, _SIZE + 5))
    gone = FetchChunkEnumeration(_Chunks(missing=True), ObjectKey("k"), _manifest(),
                                 BytesRange(0, 10)).to_stream()
    with pytest.raises(RemoteResourceNotFoundException):
        gone.read()


# -------------------------------------------------------------- object keys
_SEGMENTS = [("topic", 0, 0, b"\x01"), ("t.with-dots_", 7, 99, b"\x02"),
             ("orders", 123, 10**15, b"\xfe"), ("x", 2**31 - 1, 2**63 - 1, b"\x7f")]


def _segment(pkg, topic: str, partition: int, offset: int, fill: bytes):
    tip = pkg.TopicIdPartition(pkg.KafkaUuid(b"\x1d" * 16), pkg.TopicPartition(topic, partition))
    return pkg.RemoteLogSegmentMetadata(
        pkg.RemoteLogSegmentId(tip, pkg.KafkaUuid(fill * 16)), offset, offset + 10, 1000)


@pytest.mark.parametrize("segment", _SEGMENTS, ids=range(len(_SEGMENTS)))
@pytest.mark.parametrize("prefix, mask", [(None, False), ("", False), ("pre/", False),
                                          ("masked/", True)])
def test_object_keys_match_jax(segment, prefix, mask):
    from tieredstorage_tpu_torch import metadata

    md, jax_md = _segment(metadata, *segment), _segment(jax_metadata, *segment)
    factory = ObjectKeyFactory(prefix, mask_prefix=mask)
    jax_factory = jax_object_key.ObjectKeyFactory(prefix, mask_prefix=mask)
    assert object_key.main_path(md) == jax_object_key.main_path(jax_md)
    assert object_key.filename_prefix_from_offset(segment[2]) == f"{segment[2]:020d}"
    for suffix, jax_suffix in zip(Suffix, jax_object_key.Suffix):
        key, jax_key = factory.key(md, suffix), jax_factory.key(jax_md, jax_suffix)
        assert (key.value, str(key)) == (jax_key.value, str(jax_key))
        fields = {1: "moved/", 2: "old-main"}
        moved = factory.key_from_fields(fields, md, suffix)
        jax_moved = jax_factory.key_from_fields(fields, jax_md, jax_suffix)
        assert (moved.value, str(moved)) == (jax_moved.value, str(jax_moved))
        assert factory.key_from_fields({}, md, suffix).value == key.value
