"""Ordered single-broker e2e scenario over the port, across the storage
backend matrix, and partitions cross-read between the two packages.

Counterpart of tests/e2e/test_single_broker.py: remoteCopy → remoteRead →
remoteManualDelete → retention cleanup → topicDelete, 1 KiB chunks,
chunk-unaligned segment sizes, compression and encryption on, once per
backend (S3, GCS, Azure, S3 through SOCKS5, and S3 with the tpu-lzhuff-v1
codec), the broker simulator of tests/torch_e2e driving the port's
RemoteStorageManager with `transform.device=cpu`. Every batch CRC32C is
checked on the consume path.

Cut to size for the CPU: the plain GCM costs 0.03-0.1 s a window there, so
the JAX scenario's 10 000 records in 100.5 KiB segments (about 1 300
windows a pass) become 660 records in 4.5 KiB segments, one batch of 50 a
segment. Each partition still rolls four segments and keeps a local active
one, so the manual delete takes two remote segments of partition 0 and
retention two of each other partition, as in the JAX scenario; the mid-log
reads start at the same batch borders and in the last remote segment.

The cross-read tests tier a partition with one package's broker and RSM
and consume it record for record through the other package's RSM, over
one filesystem store and one key pair.
"""

from __future__ import annotations

import pathlib
import tempfile

import pytest

from tests.torch_e2e.broker import BrokerSim, SegmentState
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_e2e.records import decode_batches, host_crc
from tieredstorage_tpu_torch.rsm import RemoteStorageManager
from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

TOPIC = "tiered-topic"
PARTITIONS = 3
N_RECORDS = 660
CHUNK_SIZE = 1024  # 1 KiB chunks like the reference's e2e workload
SEGMENT_BYTES = 4 * 1024 + 513  # chunk-unaligned, like the JAX scenario's


def _backend_setup(kind: str, stops: list):
    """Start the emulator (and proxy) for one backend matrix entry; the
    port's twin of tests/e2e/test_single_broker.py's `_backend_setup`.
    Returns (storage configs naming the port's backends, object-key lister)."""
    if kind.startswith("s3"):
        from tests.emulators.s3_emulator import S3Emulator

        emulator = S3Emulator().start()
        stops.append(emulator.stop)
        configs = {
            "storage.backend.class": "tieredstorage_tpu_torch.storage.s3:S3Storage",
            "storage.s3.bucket.name": "e2e-bucket",
            "storage.s3.endpoint.url": emulator.endpoint,
            "storage.aws.access.key.id": "e2e",
            "storage.aws.secret.access.key": "secret",
        }
        if kind == "s3-socks5":
            from tests.emulators.socks5_server import Socks5Server

            proxy = Socks5Server().start()
            stops.append(proxy.stop)
            host, port = proxy.address
            configs["storage.proxy.host"] = host
            configs["storage.proxy.port"] = port

            def list_keys():
                with emulator.state.lock:
                    assert proxy.connections >= 1, "traffic bypassed the proxy"
                    return sorted(k for _, k in emulator.state.objects)

        else:
            def list_keys():
                with emulator.state.lock:
                    return sorted(k for _, k in emulator.state.objects)

    elif kind == "gcs":
        from tests.emulators.gcs_emulator import GcsEmulator

        emulator = GcsEmulator().start()
        stops.append(emulator.stop)
        configs = {
            "storage.backend.class": "tieredstorage_tpu_torch.storage.gcs:GcsStorage",
            "storage.gcs.bucket.name": "e2e-bucket",
            "storage.gcs.endpoint.url": emulator.endpoint,
        }

        def list_keys():
            with emulator.state.lock:
                return sorted(k for _, k in emulator.state.objects)

    elif kind == "azure":
        from tests.emulators.azure_emulator import AzureEmulator

        emulator = AzureEmulator(
            account="devaccount",
            account_key="ZGV2LWtleS1kZXYta2V5LWRldi1rZXktZGV2LWtleSE=",
        ).start()
        stops.append(emulator.stop)
        configs = {
            "storage.backend.class": "tieredstorage_tpu_torch.storage.azure:AzureBlobStorage",
            "storage.azure.container.name": "e2e-container",
            "storage.azure.account.name": "devaccount",
            "storage.azure.account.key": "ZGV2LWtleS1kZXYta2V5LWRldi1rZXktZGV2LWtleSE=",
            "storage.azure.endpoint.url": emulator.endpoint,
        }

        def list_keys():
            with emulator.state.lock:
                return sorted(k for _, k in emulator.state.blobs)

    else:  # pragma: no cover
        raise AssertionError(kind)
    return configs, list_keys


@pytest.fixture(scope="module")
def key_pair():
    """One RSA pair for the module (the port generates it in pure Python)."""
    tmp = pathlib.Path(tempfile.mkdtemp())
    return generate_key_pair_pem_files(tmp)


def _encryption(pub, priv) -> dict:
    return {
        "encryption.enabled": True,
        "encryption.key.pair.id": "k1",
        "encryption.key.pairs": ["k1"],
        "encryption.key.pairs.k1.public.key.file": str(pub),
        "encryption.key.pairs.k1.private.key.file": str(priv),
    }


@pytest.fixture(
    scope="module",
    params=["s3", "gcs", "azure", "s3-socks5", "s3-lzhuff"],
)
def env(request, key_pair):
    stops: list = []
    try:
        yield from _env_impl(request, stops, key_pair)
    finally:
        # Runs on setup failure too: a half-built matrix entry must not
        # leak emulator/proxy threads into the remaining params.
        for stop in reversed(stops):
            try:
                stop()
            except Exception:
                pass


def _env_impl(request, stops, key_pair):
    # The "-lzhuff" matrix entry replays the whole ordered scenario with the
    # device LZ codec instead of zstd (same storage backend path).
    backend_kind = request.param
    codec = "zstd"
    if backend_kind.endswith("-lzhuff"):
        backend_kind = backend_kind[: -len("-lzhuff")]
        codec = "tpu-lzhuff-v1"
    storage_configs, list_keys = _backend_setup(backend_kind, stops)
    tmp = pathlib.Path(tempfile.mkdtemp())
    pub, priv = key_pair
    rsm = RemoteStorageManager()
    stops.append(rsm.close)
    rsm.configure(
        {
            **storage_configs,
            "transform.device": "cpu",
            "chunk.size": CHUNK_SIZE,
            "key.prefix": "e2e/",
            "compression.enabled": True,
            "compression.codec": codec,
            **_encryption(pub, priv),
            "fetch.chunk.cache.class":
                "tieredstorage_tpu_torch.fetch.cache.memory.MemoryChunkCache",
            "fetch.chunk.cache.size": 64 * 1024 * 1024,
            "fetch.chunk.cache.prefetch.max.size": 16 * CHUNK_SIZE,
        }
    )
    broker = BrokerSim(tmp / "logs", rsm, segment_bytes=SEGMENT_BYTES)
    broker.create_topic(TOPIC, PARTITIONS)
    yield {"broker": broker, "list_keys": list_keys, "rsm": rsm}


def _workload(n_records: int, partitions: int):
    """The JAX scenario's records, round-robin over partitions, batches of
    50: yields (partition, batch) and fills `values`."""
    values: dict[int, list[bytes]] = {p: [] for p in range(partitions)}
    batches: list[tuple[int, list]] = []
    batch: dict[int, list] = {p: [] for p in range(partitions)}
    for i in range(n_records):
        p = i % partitions
        key = b"key-%06d" % i
        value = (b"value-%06d-" % i) + bytes((i * 31 + j) % 256 for j in range(100))
        values[p].append(value)
        batch[p].append((1_700_000_000_000 + i, key, value))
        if len(batch[p]) == 50:
            batches.append((p, batch[p]))
            batch[p] = []
    for p, records in batch.items():
        if records:
            batches.append((p, records))
    return values, batches


def _produce_workload(broker: BrokerSim) -> dict[int, list[bytes]]:
    """N_RECORDS records round-robin across partitions, batches of 50."""
    values, batches = _workload(N_RECORDS, PARTITIONS)
    for p, records in batches:
        broker.produce(TOPIC, p, records)
    return values


def test_1_remote_copy(env):
    broker = env["broker"]
    env["values"] = _produce_workload(broker)
    tiered = broker.run_tiering()
    assert tiered > 0
    env["tiered_count"] = tiered
    # Remote object set matches the metadata topic: every live segment has
    # exactly .log + .indexes + .rsm-manifest in the store.
    object_keys = env["list_keys"]()
    live = broker.tracker.remote_segments()
    assert len(live) == tiered
    assert len(object_keys) == 3 * tiered
    for suffix in ("log", "indexes", "rsm-manifest"):
        assert sum(1 for k in object_keys if k.endswith(suffix)) == tiered
    # Local retention kicked in: tiered offsets are gone locally.
    assert any(p.local_log_start > 0 for p in broker.partitions.values())


def test_2_remote_read(env):
    broker = env["broker"]
    for p in range(PARTITIONS):
        expected = env["values"][p]
        # Read everything from offset 0: crosses remote segments, the
        # remote/local boundary, and batch borders; every CRC checked.
        columns = broker.scan(TOPIC, p, 0, crc=host_crc)
        assert all(cols.crc_checked == cols.batches for _, cols in columns)
        assert "remote" in {source for source, _ in columns}
        records = broker.consume(TOPIC, p, 0, len(expected))
        assert len(records) == len(expected)
        assert [r.offset for r in records] == list(range(len(expected)))
        assert [r.value for r in records] == expected
    # Reads starting mid-log (batch-border and mid-batch offsets).
    for start in (1, 49, 50, 51, 150, 190):
        records = broker.consume(TOPIC, 0, start, 10)
        assert [r.offset for r in records] == list(range(start, start + 10))


def test_3_remote_manual_delete(env):
    broker = env["broker"]
    live_before = [
        m
        for m in broker.tracker.remote_segments()
        if m.remote_log_segment_id.topic_id_partition.topic_partition.partition == 0
    ]
    cut = live_before[1].end_offset + 1  # drop the first two remote segments
    deleted = broker.delete_records(TOPIC, 0, cut)
    assert deleted == 2
    remaining = env["list_keys"]()
    # Objects of the deleted segments are gone from the store.
    assert len(remaining) == 3 * (env["tiered_count"] - deleted)
    # Consuming from 0 snaps to the new log start offset (Kafka's
    # OFFSET_OUT_OF_RANGE → earliest reset behavior).
    records = broker.consume(TOPIC, 0, 0, 5)
    assert records and records[0].offset == cut


def test_4_retention_cleanup(env):
    broker = env["broker"]
    per_part = {
        p: [
            m
            for m in broker.tracker.remote_segments()
            if m.remote_log_segment_id.topic_id_partition.topic_partition.partition == p
        ]
        for p in range(PARTITIONS)
    }
    deleted = broker.retention_cleanup(max_remote_segments_per_partition=2)
    expected_deleted = sum(max(0, len(v) - 2) for v in per_part.values())
    assert deleted == expected_deleted
    for p in range(PARTITIONS):
        live = [
            m
            for m in broker.tracker.remote_segments()
            if m.remote_log_segment_id.topic_id_partition.topic_partition.partition == p
        ]
        assert len(live) <= 2


def test_5_topic_delete(env):
    broker = env["broker"]
    live = len(broker.tracker.remote_segments())
    deleted = broker.delete_topic(TOPIC)
    assert deleted == live
    assert broker.tracker.remote_segments() == []
    assert not env["list_keys"]()  # store empty
    # Every tracked segment ended in DELETE_SEGMENT_FINISHED.
    finished = {
        e.segment_id.id
        for e in broker.tracker.events
        if e.state == SegmentState.DELETE_SEGMENT_FINISHED
    }
    started = {
        e.segment_id.id
        for e in broker.tracker.events
        if e.state == SegmentState.COPY_SEGMENT_FINISHED
    }
    assert started == finished
    assert set(broker.tracker.states().values()) == {SegmentState.DELETE_SEGMENT_FINISHED}


# ------------------------------------------------------------- cross reads
CROSS_RECORDS = 220


def _fs_configs(root: pathlib.Path, pub, priv, package: str) -> dict:
    configs = {
        "storage.backend.class": f"{package}.storage.filesystem.FileSystemStorage",
        "storage.root": str(root),
        "chunk.size": CHUNK_SIZE,
        "key.prefix": "cross/",
        "compression.enabled": True,
        **_encryption(pub, priv),
    }
    if package == "tieredstorage_tpu_torch":
        configs["transform.device"] = "cpu"
    else:
        configs["transform.backend.class"] = (
            "tieredstorage_tpu.transform.cpu:CpuTransformBackend")
    return configs


def _port_metadata(m):
    """A JAX RemoteLogSegmentMetadata as the port's."""
    from tieredstorage_tpu_torch import metadata as pm

    mid = m.remote_log_segment_id
    tip = mid.topic_id_partition
    return pm.RemoteLogSegmentMetadata(
        remote_log_segment_id=pm.RemoteLogSegmentId(
            pm.TopicIdPartition(pm.KafkaUuid(tip.topic_id.raw),
                                pm.TopicPartition(tip.topic_partition.topic,
                                                  tip.topic_partition.partition)),
            pm.KafkaUuid(mid.id.raw)),
        start_offset=m.start_offset, end_offset=m.end_offset,
        segment_size_in_bytes=m.segment_size_in_bytes,
    )


def _jax_metadata(m):
    """A port RemoteLogSegmentMetadata as the JAX package's."""
    from tieredstorage_tpu import metadata as jm

    mid = m.remote_log_segment_id
    tip = mid.topic_id_partition
    return jm.RemoteLogSegmentMetadata(
        remote_log_segment_id=jm.RemoteLogSegmentId(
            jm.TopicIdPartition(jm.KafkaUuid(tip.topic_id.raw),
                                jm.TopicPartition(tip.topic_partition.topic,
                                                  tip.topic_partition.partition)),
            jm.KafkaUuid(mid.id.raw)),
        start_offset=m.start_offset, end_offset=m.end_offset,
        segment_size_in_bytes=m.segment_size_in_bytes,
    )


def _read_all(rsm, metadatas, decode) -> list:
    records = []
    for m in metadatas:
        with rsm.fetch_log_segment(m, 0) as stream:
            records.extend(decode(stream.read()))
    return records


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_partition_tiered_by_one_package_reads_through_the_other(writer, key_pair, tmp_path):
    """One package's broker tiers a partition through its RSM; the other
    package's RSM fetches every remote segment, and its records (offset,
    timestamp, key, value, CRC) equal the producer's, record for record."""
    from tests.e2e.broker import BrokerSim as JaxBrokerSim
    from tests.e2e.records import decode_batches as jax_decode
    from tieredstorage_tpu.rsm import RemoteStorageManager as JaxRsm

    pub, priv = key_pair
    store = tmp_path / "remote"
    store.mkdir()
    port_rsm, jax_rsm = RemoteStorageManager(), JaxRsm()
    port_rsm.configure(_fs_configs(store, pub, priv, "tieredstorage_tpu_torch"))
    jax_rsm.configure(_fs_configs(store, pub, priv, "tieredstorage_tpu"))
    try:
        sim = (JaxBrokerSim(tmp_path / "logs", jax_rsm, SEGMENT_BYTES) if writer == "jax"
               else BrokerSim(tmp_path / "logs", port_rsm, SEGMENT_BYTES))
        sim.create_topic(TOPIC, 1)
        values, batches = _workload(CROSS_RECORDS, 1)
        for _, records in batches:
            sim.produce(TOPIC, 0, records)
        assert sim.run_tiering() >= 3
        remote = sim.tracker.remote_segments()
        if writer == "jax":
            got = _read_all(port_rsm, [_port_metadata(m) for m in remote],
                            lambda data: decode_batches(data, crc=host_crc))
        else:
            got = _read_all(jax_rsm, [_jax_metadata(m) for m in remote], jax_decode)
        end = remote[-1].end_offset + 1
        assert [r.offset for r in got] == list(range(end))
        assert [r.value for r in got] == values[0][:end]
        assert [r.key for r in got] == [b"key-%06d" % i for i in range(end)]
        assert [r.timestamp for r in got] == [1_700_000_000_000 + i for i in range(end)]
        # And the rest still reads locally, stitched after the remote part.
        tail = sim.consume(TOPIC, 0, end, CROSS_RECORDS)
        assert [r.offset for r in tail] == list(range(end, CROSS_RECORDS))
    finally:
        port_rsm.close()
        jax_rsm.close()
