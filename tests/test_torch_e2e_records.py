"""The port's Kafka v2 batch codec (tests/torch_e2e/records.py) against the
JAX package's (tests/e2e/records.py) on seeded records, its bulk codec
against its per-batch one, and the host against the torch CRC32C path.

The device CRC32C path is held on the card by chip_smoke.py's gates phase.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.e2e import records as jax_records
from tests.torch_e2e import records
from tests.torch_e2e.broker import PartitionSim
from tieredstorage_tpu_torch.metadata import KafkaUuid, TopicIdPartition, TopicPartition


def _seeded_batches(seed: int, n_batches: int = 12):
    """(base offset, records) with varied keys (null ones too), values and
    timestamps that go back and forth, from a seeded generator."""
    rng = np.random.default_rng(seed)
    out, offset = [], 0
    for _ in range(n_batches):
        count = int(rng.integers(1, 40))
        base_ts = 1_700_000_000_000 + int(rng.integers(0, 1 << 30))
        recs = []
        for _ in range(count):
            key = None if rng.random() < 0.2 else rng.bytes(int(rng.integers(0, 40)))
            recs.append((base_ts + int(rng.integers(-500, 5000)), key,
                         rng.bytes(int(rng.integers(0, 3000)))))
        out.append((offset, recs))
        offset += count
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_batch_bytes_equal_the_jax_codec(seed):
    batches = _seeded_batches(seed)
    blob = b""
    for base, recs in batches:
        mine = records.encode_batch(base, recs)
        assert mine == jax_records.encode_batch(base, recs)
        blob += mine
    cut = blob[:-7]  # a ranged fetch that ends mid-batch
    for data in (blob, cut):
        theirs = jax_records.decode_batches(data)
        mine = records.decode_batches(data, crc=records.host_crc)
        assert [(r.offset, r.timestamp, r.key, r.value) for r in mine] == [
            (r.offset, r.timestamp, r.key, r.value) for r in theirs]


def test_host_and_torch_crc32c_paths_agree():
    rng = np.random.default_rng(7)
    # Equal lengths over the op's host threshold go through the torch tree
    # in one call; a lone short payload takes the host table inside the op.
    same = [rng.bytes(15_535) for _ in range(8)]
    mixed = same + [rng.bytes(100), b""]
    assert records.device_crc("cpu")(mixed) == records.host_crc(mixed)
    base = 1_700_000_000_000
    recs = [(base + i, b"k%03d" % i, rng.bytes(1000)) for i in range(15)]
    assert (records.encode_batch(5, recs, crc=records.device_crc("cpu"))
            == records.encode_batch(5, recs) == jax_records.encode_batch(5, recs))


@pytest.mark.parametrize("keyed", [True, False])
def test_bulk_batches_equal_per_batch_encoding_and_decode_to_columns(keyed):
    rng = np.random.default_rng(11)
    n, r = 20, 15
    values = rng.integers(0, 256, (n, r, 1008), dtype=np.uint8)
    keys = rng.integers(0, 256, (n, r, 16), dtype=np.uint8) if keyed else None
    offsets = 100 + np.arange(n) * r
    stamps = 1_700_000_000_000 + np.arange(n) * 1000
    rows = records.encode_uniform_batches(offsets, stamps, keys, values,
                                          crc=records.device_crc("cpu"))
    for b in range(n):
        recs = [(int(stamps[b]) + i, None if keys is None else keys[b, i].tobytes(),
                 values[b, i].tobytes()) for i in range(r)]
        assert rows[b].tobytes() == jax_records.encode_batch(int(offsets[b]), recs)
    tail = records.encode_batch(int(offsets[-1]) + r, [
        (5, None if keys is None else b"x" * 16, b"y" * 1008)] * 3)
    data = rows.tobytes() + tail + b"\x00" * 9
    cols = records.decode_uniform(data, crc=records.host_crc)
    ref = jax_records.decode_batches(data)
    assert cols.batches == cols.crc_checked == n + 1
    assert cols.offsets.tolist() == [x.offset for x in ref]
    assert cols.timestamps.tolist() == [x.timestamp for x in ref]
    assert [v.tobytes() for v in cols.values] == [x.value for x in ref]
    if keyed:
        assert [k.tobytes() for k in cols.keys] == [x.key for x in ref]
    else:
        assert cols.keys is None and all(x.key is None for x in ref)


def test_bulk_decode_refuses_a_bad_crc_and_a_misshapen_batch():
    rng = np.random.default_rng(3)
    values = rng.integers(0, 256, (4, 5, 40), dtype=np.uint8)
    rows = records.encode_uniform_batches(np.arange(4) * 5, np.zeros(4, np.int64) + 10,
                                          None, values)
    flipped = rows.copy()
    flipped[2, 200] ^= 1
    with pytest.raises(ValueError, match="CRC32C mismatch"):
        records.decode_uniform(flipped.tobytes(), crc=records.host_crc)
    with pytest.raises(ValueError, match="CRC32C mismatch"):
        records.decode_batches(flipped.tobytes(), crc=records.host_crc)
    # A batch of the same length and count whose first record's value is
    # one byte longer and second one byte shorter: its framing differs.
    recs = [(10 + i, None, bytes(41 if i == 0 else 39 if i == 1 else 40)) for i in range(5)]
    odd = records.encode_batch(20, recs)
    assert len(odd) == rows.shape[1]
    with pytest.raises(ValueError):
        records.decode_uniform(rows.tobytes() + odd)


def test_bulk_append_rolls_where_batch_appends_roll(tmp_path):
    rng = np.random.default_rng(5)
    tip = TopicIdPartition(KafkaUuid(b"\x01" * 16), TopicPartition("t", 0))
    values = rng.integers(0, 256, (9, 4, 300), dtype=np.uint8)
    keys = rng.integers(0, 256, (9, 4, 16), dtype=np.uint8)
    stamps = 1_700_000_000_000 + np.arange(9) * 10
    one = PartitionSim(tmp_path / "one", tip, 3000)
    bulk = PartitionSim(tmp_path / "bulk", tip, 3000)
    for b in range(9):
        one.append([(int(stamps[b]) + i, keys[b, i].tobytes(), values[b, i].tobytes())
                    for i in range(4)])
    bulk.append_uniform(stamps[:4], keys[:4], values[:4])
    bulk.append_uniform(stamps[4:], keys[4:], values[4:])
    assert [(s.base_offset, s.end_offset, s.record_count, s.path.read_bytes())
            for s in one.segments] == [
        (s.base_offset, s.end_offset, s.record_count, s.path.read_bytes())
        for s in bulk.segments]
    assert len(one.segments) > 2
