"""Kafka v2 record-batch codec for the port's broker simulator.

Counterpart of tests/e2e/records.py, byte for byte: the same batch header
(baseOffset(8) batchLength(4) partitionLeaderEpoch(4) magic(1) crc(4)
attributes(2) lastOffsetDelta(4) baseTimestamp(8) maxTimestamp(8)
producerId(8) producerEpoch(2) baseSequence(4) recordCount(4)) and records
in zigzag varints, written with the port's `utils.varint`.

The batch CRC32C (attributes..end) is a callable that takes a list of
byte strings and returns their CRCs: `host_crc` (the port's host table) in
the CPU tests, `device_crc(device)` (the port's batched CRC32C op,
`ops/crc32c.crc32c_batch`) on the card. Both give the same values.

Beside the per-batch codec of the JAX module there is a bulk one for
segment-scale traffic: `encode_uniform_batches` builds many batches of the
same shape (one record count, key length and value length, shared
timestamp deltas) with numpy and computes all their CRCs in one call, and
`decode_uniform` decodes such batches into columns, checking every CRC in
one call. Both are held against the per-batch codec in the tests.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Callable, Optional, Sequence

import numpy as np

from tieredstorage_tpu_torch.ops.crc32c import crc32c_batch, crc32c_host
from tieredstorage_tpu_torch.utils.varint import (
    read_unsigned_varint,
    read_varlong,
    write_unsigned_varint,
    write_varlong,
)

_HEADER = struct.Struct(">qiibIhiqqqhii")
HEADER_SIZE = _HEADER.size  # 61
#: The CRC covers the batch from the attributes field to its end.
CRC_FROM = 21

#: A batch CRC32C: byte strings in, one CRC each out.
CrcFn = Callable[[Sequence[bytes]], Sequence[int]]


def host_crc(payloads: Sequence[bytes]) -> list[int]:
    """CRC32C of each payload with the port's host table."""
    return [crc32c_host(p) for p in payloads]


def device_crc(device) -> CrcFn:
    """CRC32C of each payload with the port's batched op on `device`
    (`cuda:0` on the card; same-length payloads go in one call)."""

    def crc(payloads: Sequence[bytes]) -> list[int]:
        return crc32c_batch(payloads, device)

    return crc


@dataclasses.dataclass(frozen=True)
class Record:
    offset: int
    timestamp: int
    key: bytes | None
    value: bytes


def encode_batch(
    base_offset: int,
    records: list[tuple[int, bytes | None, bytes]],
    crc: CrcFn = host_crc,
) -> bytes:
    """records: (timestamp, key, value) triples; offsets are sequential."""
    if not records:
        raise ValueError("empty batch")
    base_ts = records[0][0]
    max_ts = max(ts for ts, _, _ in records)
    body = bytearray()
    for delta, (ts, key, value) in enumerate(records):
        rec = bytearray()
        rec.append(0)  # attributes
        write_varlong(ts - base_ts, rec)
        write_varlong(delta, rec)
        if key is None:
            write_varlong(-1, rec)
        else:
            write_varlong(len(key), rec)
            rec += key
        write_varlong(len(value), rec)
        rec += value
        write_unsigned_varint(0, rec)  # headers count
        write_varlong(len(rec), body)
        body += rec

    attrs_on = struct.pack(
        ">hiqqqhii",
        0,                       # attributes: no compression
        len(records) - 1,        # lastOffsetDelta
        base_ts,
        max_ts,
        -1, -1, -1,              # producerId/epoch/baseSequence
        len(records),
    )
    checksum = int(crc([attrs_on + bytes(body)])[0])
    batch_length = 4 + 1 + 4 + len(attrs_on) + len(body)  # epoch..end
    return (
        struct.pack(">qi", base_offset, batch_length)
        + struct.pack(">ibI", 0, 2, checksum)
        + attrs_on
        + bytes(body)
    )


def decode_batches(data: bytes, crc: Optional[CrcFn] = None) -> list[Record]:
    """Decode all complete record batches in `data` (trailing partial batch
    bytes are ignored: ranged fetches may cut mid-batch). With `crc`, every
    batch's stored CRC32C is checked (one call for all batches)."""
    out: list[Record] = []
    checked: list[tuple[int, int, int]] = []
    pos = 0
    while pos + 12 <= len(data):
        base_offset, batch_length = struct.unpack_from(">qi", data, pos)
        end = pos + 12 + batch_length
        if end > len(data):
            break
        fields = _HEADER.unpack_from(data, pos)
        magic = fields[3]
        if magic != 2:
            raise ValueError(f"Unsupported batch magic {magic}")
        checked.append((pos, end, fields[4]))
        base_ts = fields[7]
        count = fields[12]
        rpos = pos + HEADER_SIZE
        for _ in range(count):
            rec_len, rpos = read_varlong(data, rpos)
            rend = rpos + rec_len
            rpos += 1  # attributes
            ts_delta, rpos = read_varlong(data, rpos)
            off_delta, rpos = read_varlong(data, rpos)
            key_len, rpos = read_varlong(data, rpos)
            if key_len >= 0:
                key = data[rpos : rpos + key_len]
                rpos += key_len
            else:
                key = None
            val_len, rpos = read_varlong(data, rpos)
            value = data[rpos : rpos + val_len]
            rpos += val_len
            n_headers, rpos = read_unsigned_varint(data, rpos)
            for _ in range(n_headers):
                klen, rpos = read_unsigned_varint(data, rpos)
                rpos += klen
                vlen, rpos = read_unsigned_varint(data, rpos)
                rpos += vlen
            if rpos != rend:
                raise ValueError("record length mismatch")
            out.append(
                Record(
                    offset=base_offset + off_delta,
                    timestamp=base_ts + ts_delta,
                    key=key,
                    value=value,
                )
            )
        pos = end
    if crc is not None and checked:
        view = memoryview(data)
        got = crc([view[s + CRC_FROM : e] for s, e, _ in checked])
        bad = [s for (s, _, want), have in zip(checked, got) if int(have) != want]
        if bad:
            raise ValueError(f"batch CRC32C mismatch at byte positions {bad[:8]}")
    return out


# ------------------------------------------------------------ bulk codec
def _varlong_bytes(value: int) -> bytes:
    out = bytearray()
    write_varlong(value, out)
    return bytes(out)


def _be(values: np.ndarray, dtype: str) -> np.ndarray:
    """int64[n] -> uint8[n, itemsize] big-endian."""
    arr = np.ascontiguousarray(np.asarray(values).astype(dtype))
    return arr.view(np.uint8).reshape(len(arr), -1)


def _uniform_layout(n_records: int, key_len: Optional[int], value_len: int,
                    ts_deltas: Sequence[int]) -> tuple[np.ndarray, list[int], list[int]]:
    """(template body uint8[L - 61] with zeroed key and value slots, each
    record's key start, each record's value start), starts relative to the
    batch start."""
    body = bytearray()
    key_starts, value_starts = [], []
    for delta in range(n_records):
        rec = bytearray([0])
        rec += _varlong_bytes(int(ts_deltas[delta]))
        rec += _varlong_bytes(delta)
        rec += _varlong_bytes(-1 if key_len is None else key_len)
        key_at = len(rec)
        rec += bytes(key_len or 0)
        rec += _varlong_bytes(value_len)
        value_at = len(rec)
        rec += bytes(value_len)
        write_unsigned_varint(0, rec)
        prefix = _varlong_bytes(len(rec))
        start = HEADER_SIZE + len(body) + len(prefix)
        key_starts.append(start + key_at)
        value_starts.append(start + value_at)
        body += prefix + rec
    return np.frombuffer(bytes(body), np.uint8), key_starts, value_starts


def encode_uniform_batches(
    base_offsets: np.ndarray,
    base_timestamps: np.ndarray,
    keys: Optional[np.ndarray],
    values: np.ndarray,
    ts_deltas: Optional[Sequence[int]] = None,
    crc: CrcFn = host_crc,
) -> np.ndarray:
    """uint8[n, L]: n batches of r records each, byte for byte what
    `encode_batch` makes of them.

    values: uint8[n, r, V]; keys: uint8[n, r, K] or None (null keys);
    record i of batch b has offset base_offsets[b] + i and timestamp
    base_timestamps[b] + ts_deltas[i] (default i). All n CRCs go through
    one `crc` call."""
    values = np.asarray(values, np.uint8)
    n, r, value_len = values.shape
    key_len = None if keys is None else int(keys.shape[2])
    deltas = list(range(r)) if ts_deltas is None else [int(d) for d in ts_deltas]
    if len(deltas) != r or deltas[0] != 0 or min(deltas) < 0:
        raise ValueError("ts_deltas: one per record, the first 0, none negative")
    template, key_starts, value_starts = _uniform_layout(r, key_len, value_len, deltas)
    length = HEADER_SIZE + len(template)
    out = np.empty((n, length), np.uint8)
    out[:, HEADER_SIZE:] = template
    base_ts = np.asarray(base_timestamps, np.int64)
    out[:, 0:8] = _be(base_offsets, ">i8")
    out[:, 8:12] = _be(np.full(n, length - 12), ">i4")
    out[:, 12:16] = 0                                    # partitionLeaderEpoch
    out[:, 16] = 2                                       # magic
    out[:, 21:23] = 0                                    # attributes
    out[:, 23:27] = _be(np.full(n, r - 1), ">i4")        # lastOffsetDelta
    out[:, 27:35] = _be(base_ts, ">i8")
    out[:, 35:43] = _be(base_ts + max(deltas), ">i8")
    out[:, 43:57] = 0xFF                                 # producerId/epoch/baseSequence = -1
    out[:, 57:61] = _be(np.full(n, r), ">i4")
    for i in range(r):
        if keys is not None:
            out[:, key_starts[i] : key_starts[i] + key_len] = keys[:, i]
        out[:, value_starts[i] : value_starts[i] + value_len] = values[:, i]
    crcs = crc([row[CRC_FROM:].data for row in out])
    out[:, 17:21] = _be(np.asarray(crcs, np.int64), ">u4")
    return out


@dataclasses.dataclass
class RecordColumns:
    """Decoded uniform batches: one row per record, in log order."""

    offsets: np.ndarray           # int64[N]
    timestamps: np.ndarray        # int64[N]
    keys: Optional[np.ndarray]    # uint8[N, K], None for null keys
    values: np.ndarray            # uint8[N, V]
    batches: int
    crc_checked: int              # batches whose CRC was checked (all, with a crc)

    def __len__(self) -> int:
        return len(self.offsets)


def decode_uniform(data: bytes, crc: Optional[CrcFn] = None) -> RecordColumns:
    """Decode the complete batches of `data` into columns, as
    `decode_batches` would decode them record by record. Every record must
    have the same key length (or a null key) and value length; every
    batch's framing is checked against the layout of its group's first
    batch (batches group by length and record count), so a record that
    differs in shape raises instead of decoding wrongly. With `crc`, every
    stored CRC32C is checked, each group's in one call."""
    buf = np.frombuffer(data, np.uint8)
    heads = []
    pos = 0
    while pos + 12 <= len(data):
        _, batch_length = struct.unpack_from(">qi", data, pos)
        end = pos + 12 + batch_length
        if end > len(data):
            break
        heads.append((pos, batch_length + 12))
        pos = end
    groups: dict[tuple[int, int], list[int]] = {}
    for p, length in heads:
        count = struct.unpack_from(">i", data, p + 57)[0]
        groups.setdefault((length, count), []).append(p)
    parts = []
    shapes = set()
    crc_checked = 0
    for (length, count), starts in groups.items():
        starts_a = np.asarray(starts, np.int64)
        rows = np.stack([buf[p : p + length] for p in starts])
        if np.any(rows[:, 16] != 2):
            raise ValueError(f"Unsupported batch magic {int(rows[rows[:, 16] != 2][0, 16])}")
        first = decode_batches(rows[0].tobytes())
        key_lens = {None if rec.key is None else len(rec.key) for rec in first}
        value_lens = {len(rec.value) for rec in first}
        if len(key_lens) != 1 or len(value_lens) != 1:
            raise ValueError("records of one batch differ in shape")
        key_len, value_len = key_lens.pop(), value_lens.pop()
        shapes.add((key_len, value_len))
        base_ts = rows[:, 27:35].copy().view(">i8").reshape(-1).astype(np.int64)
        ts_deltas = [rec.timestamp - int(base_ts[0]) for rec in first]
        template, key_starts, value_starts = _uniform_layout(
            count, key_len, value_len, ts_deltas)
        slots = [(v, value_len) for v in value_starts]
        if key_len is not None:
            slots += [(k, key_len) for k in key_starts]
        framing = rows[:, HEADER_SIZE:].copy()
        for start, n in slots:
            framing[:, start - HEADER_SIZE : start - HEADER_SIZE + n] = 0
        if not np.array_equal(framing, np.broadcast_to(template, framing.shape)):
            raise ValueError("a batch's record framing differs from its group's layout")
        if crc is not None:
            got = np.asarray(crc([row[CRC_FROM:].data for row in rows]), np.int64)
            stored = rows[:, 17:21].copy().view(">u4").reshape(-1).astype(np.int64)
            if not np.array_equal(got, stored):
                bad = starts_a[got != stored]
                raise ValueError(f"batch CRC32C mismatch at byte positions {bad[:8].tolist()}")
            crc_checked += len(rows)
        base_off = rows[:, 0:8].copy().view(">i8").reshape(-1).astype(np.int64)
        deltas = np.asarray([rec.offset - int(base_off[0]) for rec in first], np.int64)
        ts_d = np.asarray(ts_deltas, np.int64)
        parts.append((
            starts_a,
            (base_off[:, None] + deltas[None, :]).reshape(-1),
            (base_ts[:, None] + ts_d[None, :]).reshape(-1),
            None if key_len is None else np.stack(
                [rows[:, k : k + key_len] for k in key_starts], axis=1).reshape(-1, key_len),
            np.stack([rows[:, v : v + value_len] for v in value_starts],
                     axis=1).reshape(-1, value_len),
            count,
        ))
    if len(shapes) > 1:
        raise ValueError(f"records differ in shape across batches: {sorted(shapes, key=str)}")
    if not parts:
        return RecordColumns(np.zeros(0, np.int64), np.zeros(0, np.int64), None,
                             np.zeros((0, 0), np.uint8), 0, 0)
    # Back into log order: sort the batches by position, records keep theirs.
    order = np.concatenate([np.repeat(p[0], p[5]) for p in parts]).argsort(kind="stable")
    keys = None if parts[0][3] is None else np.concatenate([p[3] for p in parts])[order]
    return RecordColumns(
        offsets=np.concatenate([p[1] for p in parts])[order],
        timestamps=np.concatenate([p[2] for p in parts])[order],
        keys=keys,
        values=np.concatenate([p[4] for p in parts])[order],
        batches=len(heads),
        crc_checked=crc_checked,
    )
