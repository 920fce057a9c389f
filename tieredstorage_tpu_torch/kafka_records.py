"""Minimal Kafka log-segment record-batch inspection for the compression heuristic.

Reference: core/.../SegmentCompressionChecker.java:30-38 — open the segment,
inspect only the FIRST record batch; if its compression type != NONE the whole
segment is treated as already compressed. The reference delegates to Kafka's
FileRecords; here the batch header is parsed directly: the magic byte sits at
offset 16 for both modern (v2) batches and legacy (v0/v1) message sets, and
the compression codec is the low 3 bits of the attributes field (offset 21,
int16, for v2; offset 17, int8, for v0/v1).
"""

from __future__ import annotations

import struct
from pathlib import Path


class InvalidRecordBatchException(Exception):
    """First batch is unreadable/truncated (reference:
    core/.../InvalidRecordBatchException.java; caught by the RSM to fall back
    to uploading uncompressed, RemoteStorageManager.java:389-392)."""


_V2_HEADER_LEN = 23  # through the attributes field
_LEGACY_HEADER_LEN = 18

COMPRESSION_NONE = 0


def first_batch_compression_codec(segment_path: str | Path) -> int:
    """Returns the compression codec id (0 = NONE) of the first record batch."""
    try:
        with open(segment_path, "rb") as f:
            header = f.read(_V2_HEADER_LEN)
    except OSError as e:
        raise InvalidRecordBatchException(f"Cannot read segment: {e}") from e

    if len(header) < _LEGACY_HEADER_LEN:
        raise InvalidRecordBatchException(
            f"Segment too short for a record batch header: {len(header)} bytes"
        )
    magic = header[16]
    if magic == 2:
        if len(header) < _V2_HEADER_LEN:
            raise InvalidRecordBatchException("Truncated v2 record batch header")
        (attributes,) = struct.unpack_from(">h", header, 21)
    elif magic in (0, 1):
        attributes = header[17]
    else:
        raise InvalidRecordBatchException(f"Unknown record batch magic: {magic}")
    return attributes & 0x07


def segment_looks_compressed(segment_path: str | Path) -> bool:
    return first_batch_compression_codec(segment_path) != COMPRESSION_NONE
