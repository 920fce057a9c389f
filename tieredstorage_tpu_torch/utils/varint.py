"""Kafka-protocol varint primitives (unsigned varint, zigzag varlong).

Used by the custom-metadata tagged-field serde; byte-compatible with Kafka's
ByteUtils encoding (the reference delegates to Kafka's protocol types,
core/.../metadata/SegmentCustomMetadataSerde.java:28-58).
"""

from __future__ import annotations


def write_unsigned_varint(value: int, out: bytearray) -> None:
    if value < 0:
        raise ValueError("unsigned varint cannot be negative")
    while (value & ~0x7F) != 0:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)


def read_unsigned_varint(data: bytes, pos: int) -> tuple[int, int]:
    value = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("Truncated varint")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not (b & 0x80):
            return value, pos
        shift += 7
        if shift > 63:
            raise ValueError("Varint too long")


def write_varlong(value: int, out: bytearray) -> None:
    """Zigzag-encoded signed varlong (Kafka Type.VARLONG)."""
    zz = (value << 1) ^ (value >> 63)
    write_unsigned_varint(zz & 0xFFFFFFFFFFFFFFFF, out)


def read_varlong(data: bytes, pos: int) -> tuple[int, int]:
    zz, pos = read_unsigned_varint(data, pos)
    return (zz >> 1) ^ -(zz & 1), pos
