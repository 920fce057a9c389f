"""The generated segment is a Kafka log of producer-perf-test records, and
the tiering driver keeps a first copy and a last copy for the comparison."""

import struct
import tempfile
from pathlib import Path

import numpy as np
import pytest

from benchmark import harness, program, rehearse, segments
from benchmark.reference import rsa_oaep

SEGMENT = {"log.segment.bytes": 2 << 20, "record.size": 1024, "batch.size": 16384}


@pytest.fixture(scope="module")
def seg():
    s = segments.make(2**31 + 17, SEGMENT, "cpu")
    yield s
    s.close()


def _varint(buf, pos):
    z = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        z |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return (z >> 1) ^ -(z & 1), pos


def _batches(log):
    pos = 0
    while pos < len(log):
        base, length = struct.unpack_from(">qi", log, pos)
        yield pos, base, log[pos: pos + 12 + length]
        pos += 12 + length


def test_layout_fills_batch_size_and_rolls_before_the_segment_size():
    lay = segments.layout(1 << 30, 1024, 16384)
    assert lay.records_per_batch == 15 and lay.record_bytes == 1033
    assert lay.batch_bytes == 61 + 15 * 1033 <= 16384
    assert lay.size <= 1 << 30 < lay.size + lay.batch_bytes


def test_batches_parse_as_kafka_v2_records_of_uppercase_values(seg):
    log = seg.log.tobytes()
    per = segments.layout(SEGMENT["log.segment.bytes"], 1024, 16384).records_per_batch
    n = 0
    for pos, base, batch in _batches(log):
        magic, = struct.unpack_from(">b", batch, 16)
        last_delta, = struct.unpack_from(">i", batch, 23)
        count, = struct.unpack_from(">i", batch, 57)
        assert magic == 2 and base == n * per and last_delta == per - 1 and count == per
        p = 61
        for r in range(per):
            length, p = _varint(batch, p)
            end = p + length
            assert batch[p] == 0                     # attributes
            p += 1
            ts_delta, p = _varint(batch, p)
            offset_delta, p = _varint(batch, p)
            key_len, p = _varint(batch, p)
            value_len, p = _varint(batch, p)
            assert (ts_delta, offset_delta, key_len, value_len) == (0, r, -1, 1024)
            value = np.frombuffer(batch[p: p + value_len], np.uint8)
            assert value.min() >= ord("A") and value.max() <= ord("Z")
            headers, p = _varint(batch, p + value_len)
            assert headers == 0 and p == end
        n += 1
    assert n * per - 1 == seg.last_offset and pos + len(batch) == seg.size


def test_indexes_point_at_every_batch_past_the_first(seg):
    log = seg.log.tobytes()
    batches = list(_batches(log))
    off = np.frombuffer(seg.indexes["offset"], segments.OFFSET_ENTRY)
    tim = np.frombuffer(seg.indexes["time"], segments.TIME_ENTRY)
    assert len(off) == len(tim) == len(batches) - 1
    for (pos, base, batch), o, t in zip(batches[1:], off, tim):
        max_ts, = struct.unpack_from(">q", batch, 35)
        assert o["position"] == pos and o["relative_offset"] == base + 14
        assert t["timestamp"] == max_ts and t["relative_offset"] == base + 14
    snap = np.frombuffer(seg.indexes["snapshot"], segments.SNAPSHOT)[0]
    assert snap["last_offset"] == seg.last_offset
    assert seg.indexes["leader_epoch"].startswith(b"0\n2\n0 0\n1 ")


def test_the_same_seed_gives_the_same_segment_and_another_seed_another(seg):
    again = segments.make(2**31 + 17, SEGMENT, "cpu")
    other = segments.make(5, SEGMENT, "cpu")
    try:
        assert np.array_equal(again.log, seg.log) and again.indexes == seg.indexes
        assert not np.array_equal(other.log, seg.log)
    finally:
        again.close()
        other.close()


def test_the_values_are_uniform_over_26_letters(seg):
    counts = np.bincount(seg.log, minlength=256)[ord("A"): ord("Z") + 1]
    assert counts.min() > 0.95 * counts.mean() and counts.max() < 1.05 * counts.mean()


def test_the_driver_keeps_copy_0_of_one_copier_and_the_last_copy_of_another():
    ctx = harness.context("gcm.tiering", 23, 2.0, False, "cpu", overrides=rehearse.TINY)
    ctx.scratch = Path(tempfile.mkdtemp())
    pair = rsa_oaep.generate(23)
    driver = harness.load_module("drivers", "tiering").Driver(
        ctx, rsa_oaep.write_pem_files(pair, ctx.scratch), pair)
    try:
        driver.setup()
        window = driver.run_window()
        kept = {kind: (c, k) for c, k, kind, _ in driver.kept}
        assert sorted(kept) == ["first", "last"] and kept["first"][0] != kept["last"][0]
        assert kept["first"][1] == 0
        c, k = kept["last"]
        assert k == max(kk for cc, kk, *_ in window["copies"] if cc == c)
        logs = [key for key in program.store_of(driver.rsm)._objects if key.endswith(".log")]
        assert len(logs) == 2
        assert driver.compare(window)["checked_copies"] == {"value": 2, "min": 2}
    finally:
        driver.close()
        for p in ctx.scratch.iterdir():
            p.unlink()
        ctx.scratch.rmdir()
