"""Seeded Kafka log segments of producer-perf-test records, kept in memory-backed files.

The log is what a broker writes for `kafka-producer-perf-test --record-size
<record.size>` (Apache Kafka's `ProducerPerformance`): records with a null
key whose value bytes are each drawn uniformly from 'A'-'Z', sent with the
producer's defaults (`batch.size` 16384, `compression.type` none,
idempotence on), so each v2 record batch holds as many records as fit in
`batch.size`. The segment rolls before a batch would pass
`log.segment.bytes`. The offset and time indexes hold an entry for every
batch past the first (each batch is longer than `log.index.interval.bytes`),
the producer snapshot holds the one producer, and the leader-epoch
checkpoint moves to epoch 1 halfway. Two fields are made up where their
arithmetic would cost set-up and change no byte's compressibility: each
batch's CRC-32C is seeded noise, and batch `i` carries the timestamp
`t0 + i` ms for every record (one batch a millisecond).

The value bytes are drawn on the run's device from the seed; the headers are
laid over them there and the whole copied once into anonymous memory
(`memfd_create`), reached by its `/proc/self/fd` path, so a run writes no
segment to disk. `Segment.log` is a read-only numpy view of the log's bytes
for the comparison.
"""

from __future__ import annotations

import dataclasses
import mmap
import os
from pathlib import Path

import numpy as np

BATCH_HEADER = np.dtype([
    ("base_offset", ">i8"), ("length", ">i4"), ("leader_epoch", ">i4"), ("magic", "i1"),
    ("crc", ">u4"), ("attributes", ">i2"), ("last_offset_delta", ">i4"),
    ("base_timestamp", ">i8"), ("max_timestamp", ">i8"), ("producer_id", ">i8"),
    ("producer_epoch", ">i2"), ("base_sequence", ">i4"), ("records", ">i4"),
])
OFFSET_ENTRY = np.dtype([("relative_offset", ">i4"), ("position", ">i4")])
TIME_ENTRY = np.dtype([("timestamp", ">i8"), ("relative_offset", ">i4")])
SNAPSHOT = np.dtype([
    ("version", ">i2"), ("crc", ">u4"), ("entries", ">i4"), ("producer_id", ">i8"),
    ("producer_epoch", ">i2"), ("last_sequence", ">i4"), ("last_offset", ">i8"),
    ("offset_delta", ">i4"), ("timestamp", ">i8"), ("coordinator_epoch", ">i4"),
    ("txn_first_offset", ">i8"),
])


def varint(n: int) -> bytes:
    """Kafka's signed varint: zigzag, then base-128 little-endian groups."""
    z = (n << 1) ^ (n >> 63)
    out = bytearray()
    while z > 0x7F:
        out.append((z & 0x7F) | 0x80)
        z >>= 7
    out.append(z)
    return bytes(out)


@dataclasses.dataclass(frozen=True)
class Layout:
    """The byte layout of a segment of equal batches of equal records."""
    record_size: int
    records_per_batch: int
    batches: int

    @property
    def prefix(self) -> list[bytes]:
        """Each record's bytes before its value, by offset delta: length,
        attributes, timestamp delta, offset delta, a null key, value length."""
        out = []
        for r in range(self.records_per_batch):
            tail = b"\x00\x00" + varint(r) + varint(-1) + varint(self.record_size)
            body = len(tail) + self.record_size + 1            # + headers count
            out.append(varint(body) + tail)
        return out

    @property
    def record_bytes(self) -> int:
        return len(self.prefix[0]) + self.record_size + 1

    @property
    def batch_bytes(self) -> int:
        return BATCH_HEADER.itemsize + self.records_per_batch * self.record_bytes

    @property
    def size(self) -> int:
        return self.batches * self.batch_bytes

    @property
    def records(self) -> int:
        return self.batches * self.records_per_batch


def layout(segment_bytes: int, record_size: int, batch_size: int) -> Layout:
    probe = Layout(record_size, 1, 1)
    per_batch = (batch_size - BATCH_HEADER.itemsize) // probe.record_bytes
    lay = Layout(record_size, max(1, per_batch), 1)
    if len(set(map(len, lay.prefix))) != 1:
        raise ValueError("records of one batch must have one length (at most 64 a batch)")
    return Layout(record_size, lay.records_per_batch, segment_bytes // lay.batch_bytes)


@dataclasses.dataclass
class Segment:
    size: int
    last_offset: int
    files: dict            # name -> Path of a memory-backed file
    log: np.ndarray        # uint8[size], read-only view of the log file
    indexes: dict          # name -> bytes (offset, time, snapshot, leader_epoch)
    _fds: list
    _maps: list

    def close(self) -> None:
        self.log = None
        for m in self._maps:
            try:
                m.close()
            except BufferError:  # a view is still held; the map goes with it
                pass
        for fd in self._fds:
            os.close(fd)
        self._fds, self._maps = [], []


def headers(seed: int, lay: Layout) -> dict:
    """Batch headers, indexes, producer snapshot and leader-epoch checkpoint."""
    rng = np.random.default_rng([seed, 0x1DE])
    nb, per = lay.batches, lay.records_per_batch
    i = np.arange(nb, dtype=np.int64)
    t0 = 1_700_000_000_000 + int(rng.integers(0, 1 << 30))
    producer_id = int(rng.integers(0, 1 << 40))
    epoch_from = nb // 2
    h = np.zeros(nb, BATCH_HEADER)
    h["base_offset"] = i * per
    h["length"] = lay.batch_bytes - 12
    h["leader_epoch"] = (i >= epoch_from).astype(np.int32)
    h["magic"] = 2
    h["crc"] = rng.integers(0, 1 << 32, size=nb, dtype=np.uint32)
    h["last_offset_delta"] = per - 1
    h["base_timestamp"] = h["max_timestamp"] = t0 + i
    h["producer_id"] = producer_id
    h["base_sequence"] = (i * per) % (1 << 31)
    h["records"] = per
    last = i[1:] * per + per - 1
    off = np.zeros(nb - 1, OFFSET_ENTRY)
    off["relative_offset"], off["position"] = last, i[1:] * lay.batch_bytes
    tim = np.zeros(nb - 1, TIME_ENTRY)
    tim["timestamp"], tim["relative_offset"] = t0 + i[1:], last
    snap = np.zeros(1, SNAPSHOT)
    snap["version"], snap["crc"], snap["entries"] = 1, rng.integers(0, 1 << 32), 1
    snap["producer_id"], snap["last_sequence"] = producer_id, (lay.records - 1) % (1 << 31)
    snap["last_offset"], snap["offset_delta"] = lay.records - 1, per - 1
    snap["timestamp"], snap["coordinator_epoch"], snap["txn_first_offset"] = t0 + nb - 1, -1, -1
    return {
        "batch_headers": h.view(np.uint8).reshape(nb, BATCH_HEADER.itemsize),
        "offset": off.tobytes(), "time": tim.tobytes(), "snapshot": snap.tobytes(),
        "leader_epoch": b"0\n2\n0 0\n1 %d\n" % (epoch_from * per),
    }


def _memfd(name: str, size: int) -> tuple[int, Path]:
    fd = os.memfd_create(name, 0)
    os.ftruncate(fd, size)
    return fd, Path(f"/proc/self/fd/{fd}")


def make(seed: int, segment: dict, device) -> Segment:
    """One segment and its indexes, all from `seed`, as the configuration's
    `segment` sizes them; the values are drawn on `device`."""
    import torch

    lay = layout(segment["log.segment.bytes"], segment["record.size"], segment["batch.size"])
    parts = headers(seed, lay)
    nb, per = lay.batches, lay.records_per_batch
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, 0x5E6]).generate_state(1, np.uint64)[0] >> 1))
    buf = torch.randint(ord("A"), ord("Z") + 1, (nb, lay.batch_bytes), dtype=torch.uint8,
                        device=device, generator=gen)
    records = buf[:, BATCH_HEADER.itemsize:].view(nb, per, lay.record_bytes)
    prefix = np.frombuffer(b"".join(lay.prefix), np.uint8).reshape(per, -1)
    records[:, :, : prefix.shape[1]] = torch.from_numpy(prefix.copy()).to(device)
    records[:, :, -1] = 0
    buf[:, : BATCH_HEADER.itemsize] = torch.from_numpy(parts["batch_headers"]).to(device)
    fds, files, maps = [], {}, []
    fd, files["log"] = _memfd("log", lay.size)
    fds.append(fd)
    m = mmap.mmap(fd, lay.size)
    torch.from_numpy(np.frombuffer(m, dtype=np.uint8)).copy_(buf.view(-1))
    del buf, records
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    m.close()
    indexes = {k: parts[k] for k in ("offset", "time", "snapshot", "leader_epoch")}
    for name in ("offset", "time", "snapshot"):
        fd, files[name] = _memfd(name, 0)
        view = memoryview(indexes[name])
        while view:
            view = view[os.write(fd, view):]
        fds.append(fd)
    m = mmap.mmap(fds[0], lay.size, prot=mmap.PROT_READ)
    maps.append(m)
    return Segment(lay.size, lay.records - 1, files, np.frombuffer(m, dtype=np.uint8), indexes,
                   fds, maps)
