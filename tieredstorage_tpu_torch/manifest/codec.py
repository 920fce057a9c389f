"""Compact binary codec for lists of transformed chunk sizes.

Wire-compatible with the reference's encoding
(core/.../manifest/index/serde/ChunkSizesBinaryCodec.java:98-203; layout doc
:63-96): big-endian `[count:4][base:4][bytesPerValue:1][(count-1)*bpv][last:4]`,
where base = min over all-but-last values and each stored value is (v - base)
in bytesPerValue bytes. Zero values -> count only; one value -> count + value.

Implemented vectorized with numpy (the reference loops per value): the de-based
value array is rendered to its big-endian byte matrix in one shot.
"""

from __future__ import annotations

import struct
from typing import Sequence

import numpy as np


def encode_chunk_sizes(values: Sequence[int]) -> bytes:
    count = len(values)
    if count == 0:
        return struct.pack(">i", 0)
    last = int(values[-1])
    if last < 0:
        raise ValueError("Values cannot be negative")
    if count == 1:
        return struct.pack(">ii", 1, last)

    body = np.asarray(values[:-1], dtype=np.int64)
    if (body < 0).any():
        raise ValueError("Values cannot be negative")
    if (body > 0x7FFFFFFF).any() or last > 0x7FFFFFFF:
        raise ValueError("Values must fit in a signed 32-bit int")
    base = int(body.min())
    debased = (body - base).astype(np.uint32)
    max_debased = int(debased.max())
    bytes_per_value = next(b for b in (1, 2, 3, 4) if max_debased <= (1 << (8 * b)) - 1)

    # Big-endian byte matrix of all de-based values, then keep the low
    # `bytes_per_value` columns.
    byte_matrix = debased[:, None] >> np.array([24, 16, 8, 0], dtype=np.uint32)[None, :]
    byte_matrix = (byte_matrix & 0xFF).astype(np.uint8)[:, 4 - bytes_per_value :]

    return (
        struct.pack(">iiB", count, base, bytes_per_value)
        + byte_matrix.tobytes()
        + struct.pack(">i", last)
    )


def decode_chunk_sizes(data: bytes) -> list[int]:
    (count,) = struct.unpack_from(">i", data, 0)
    if count == 0:
        return []
    if count == 1:
        (value,) = struct.unpack_from(">i", data, 4)
        return [value]

    base, bytes_per_value = struct.unpack_from(">iB", data, 4)
    offset = 4 + 4 + 1
    n_body = count - 1
    raw = np.frombuffer(data, dtype=np.uint8, count=n_body * bytes_per_value, offset=offset)
    byte_matrix = raw.reshape(n_body, bytes_per_value).astype(np.uint32)
    shifts = np.arange(bytes_per_value - 1, -1, -1, dtype=np.uint32) * 8
    body = (byte_matrix << shifts[None, :]).sum(axis=1, dtype=np.uint32).astype(np.int64) + base
    (last,) = struct.unpack_from(">i", data, offset + n_body * bytes_per_value)
    return [int(v) for v in body] + [last]
