"""The port's RemoteStorageManager over the object-store backends.

Segments cross-read both ways between the JAX package's RSM and the port's
(transform.device=cpu) over the S3, GCS and Azure emulators; the
compression × encryption lifecycle matrix of tests/test_rsm_lifecycle.py
runs against the port's RSM over the signature-verifying S3 emulator, with
every pooled connection back in the pool at the end (the object-store form
of that suite's closed-files check); and a replicated store of S3 and the
filesystem keeps serving fetches after the S3 endpoint goes away.
"""

from __future__ import annotations

import json
import struct

import pytest

from tests.emulators.azure_emulator import AzureEmulator
from tests.emulators.gcs_emulator import GcsEmulator
from tests.emulators.s3_emulator import S3Emulator
from tests.test_torch_rsm import _read_everything, _write_segment
from tests.test_torch_storage_contract import (
    AZURE_ACCOUNT,
    AZURE_KEY,
    S3_CREDENTIALS,
    azure_configs,
    gcs_configs,
    s3_configs,
)
from tieredstorage_tpu import metadata as jax_metadata
from tieredstorage_tpu.manifest.segment_indexes import IndexType as JaxIndexType
from tieredstorage_tpu.rsm import RemoteStorageManager as JaxRemoteStorageManager
from tieredstorage_tpu_torch import metadata
from tieredstorage_tpu_torch.errors import RemoteResourceNotFoundException
from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType
from tieredstorage_tpu_torch.rsm import RemoteStorageManager
from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
from tieredstorage_tpu_torch.storage.core import ObjectKey

BACKENDS = {
    "s3": ("S3Storage", s3_configs),
    "gcs": ("GcsStorage", gcs_configs),
    "azure": ("AzureBlobStorage", azure_configs),
}


@pytest.fixture(scope="module")
def emulators():
    emus = {
        "s3": S3Emulator(credentials=S3_CREDENTIALS).start(),
        "gcs": GcsEmulator().start(),
        "azure": AzureEmulator(account=AZURE_ACCOUNT, account_key=AZURE_KEY).start(),
    }
    yield emus
    for emu in emus.values():
        emu.stop()


@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    """One RSA pair generated by the port (read by both packages)."""
    return generate_key_pair_pem_files(tmp_path_factory.mktemp("keys"), prefix="rsm")


def rsm_configs(package: str, kind: str, endpoint: str, keys, chunk_size: int = 4096,
                encryption: bool = True, extra=None) -> dict:
    cls, backend_configs = BACKENDS[kind]
    configs = {
        "storage.backend.class": f"{package}.storage.{kind}:{cls}",
        **{f"storage.{k}": v for k, v in backend_configs(endpoint).items()},
        "chunk.size": chunk_size,
        "key.prefix": "test/",
        "encryption.enabled": encryption,
    }
    if encryption:
        pub, priv = keys
        configs.update({
            "encryption.key.pair.id": "key1",
            "encryption.key.pairs": "key1",
            "encryption.key.pairs.key1.public.key.file": str(pub),
            "encryption.key.pairs.key1.private.key.file": str(priv),
        })
    if package == "tieredstorage_tpu_torch":
        configs["transform.device"] = "cpu"
    configs.update(extra or {})
    return configs


def _stored_keys(rsm) -> list[str]:
    return [k.value for k in rsm._storage.list_objects("test/")]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("kind", ["s3", "gcs", "azure"])
def test_segments_cross_read_between_packages(kind, writer, emulators, keys, tmp_path):
    endpoint = emulators[kind].endpoint
    md_port, sd_port, contents = _write_segment(tmp_path, metadata)
    md_jax, sd_jax, _ = _write_segment(tmp_path, jax_metadata)
    jax_rsm = JaxRemoteStorageManager()
    jax_rsm.configure(rsm_configs("tieredstorage_tpu", kind, endpoint, keys))
    port_rsm = RemoteStorageManager()
    port_rsm.configure(rsm_configs("tieredstorage_tpu_torch", kind, endpoint, keys))
    if writer == "jax":
        jax_rsm.copy_log_segment_data(md_jax, sd_jax)
        reader, md, index_type = port_rsm, md_port, IndexType
    else:
        port_rsm.copy_log_segment_data(md_port, sd_port)
        reader, md, index_type = jax_rsm, md_jax, JaxIndexType
    assert [k.rsplit(".", 1)[1] for k in _stored_keys(port_rsm)] == [
        "indexes", "log", "rsm-manifest"]
    _read_everything(reader, md, index_type, contents)
    reader.delete_log_segment_data(md)
    assert _stored_keys(port_rsm) == []
    for rsm in (jax_rsm, port_rsm):
        rsm.close()


@pytest.mark.parametrize("kind", ["memory", "filesystem", "s3", "gcs", "azure", "replicated"])
def test_every_backend_loads_as_the_rsms_storage_backend_class(kind, emulators, keys, tmp_path):
    """Each backend of the port, named by `storage.backend.class` and
    configured by the JAX package's keys under `storage.`, carries a copy,
    a ranged fetch, an index and a delete."""
    (tmp_path / "store").mkdir()
    if kind in BACKENDS:
        configs = rsm_configs("tieredstorage_tpu_torch", kind, emulators[kind].endpoint, keys)
    else:
        configs = rsm_configs("tieredstorage_tpu_torch", "s3", "http://unused", keys)
        configs = {k: v for k, v in configs.items() if not k.startswith("storage.")}
        configs.update({
            "memory": {"storage.backend.class":
                       "tieredstorage_tpu_torch.storage.memory.InMemoryStorage"},
            "filesystem": {"storage.backend.class":
                           "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
                           "storage.root": str(tmp_path / "store")},
            "replicated": {
                "storage.backend.class":
                    "tieredstorage_tpu_torch.storage.replicated:ReplicatedStorageBackend",
                "storage.replication.replicas": "a,b",
                "storage.replication.replica.a.backend.class":
                    "tieredstorage_tpu_torch.storage.memory.InMemoryStorage",
                "storage.replication.replica.b.backend.class":
                    "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
                "storage.replication.replica.b.root": str(tmp_path / "store"),
                "storage.replication.probe.interval.ms": None,
            },
        }[kind])
    md, sd, contents = _write_segment(tmp_path, metadata)
    rsm = RemoteStorageManager()
    rsm.configure(configs)
    rsm.copy_log_segment_data(md, sd)
    with rsm.fetch_log_segment(md, 100, 9000) as stream:
        assert stream.read() == contents["log"][100:9001]
    assert rsm.fetch_index(md, IndexType.TRANSACTION).read() == contents["txn"]
    rsm.delete_log_segment_data(md)
    assert list(rsm._storage.list_objects("test/")) == []
    assert (rsm.replicated_storage is not None) == (kind == "replicated")
    rsm.close()


# The lifecycle matrix of tests/test_rsm_lifecycle.py, over S3.
SEGMENT_SIZE = 10 * 1024 + 133
CHUNK_SIZE = 1024
EXPECTED_MAIN = "topic-AQEBAQEBAQEBAQEBAQEBAQ/7/00000000000000000023-AgICAgICAgICAgICAgICAg"


def _lifecycle_segment(tmp_path):
    header = struct.pack(">qiibih", 0, SEGMENT_SIZE - 12, 0, 2, 0, 0)
    body = (b"kafka tiered storage payload " * 200)[: SEGMENT_SIZE // 2]
    rnd = bytes((i * 131 + 17) % 256 for i in range(SEGMENT_SIZE - len(header) - len(body)))
    files = {
        "log": header + body + rnd, "index": b"OFFSETIDX" * 16, "timeindex": b"TIMEIDX" * 24,
        "snapshot": b"PRODSNAP" * 4, "txnindex": b"TXN" * 11,
    }
    for suffix, data in files.items():
        (tmp_path / f"00000000000000000023.{suffix}").write_bytes(data)
    tip = metadata.TopicIdPartition(metadata.KafkaUuid(b"\x01" * 16),
                                    metadata.TopicPartition("topic", 7))
    md = metadata.RemoteLogSegmentMetadata(
        remote_log_segment_id=metadata.RemoteLogSegmentId(tip, metadata.KafkaUuid(b"\x02" * 16)),
        start_offset=23, end_offset=2000, segment_size_in_bytes=SEGMENT_SIZE,
    )
    sd = metadata.LogSegmentData(
        log_segment=tmp_path / "00000000000000000023.log",
        offset_index=tmp_path / "00000000000000000023.index",
        time_index=tmp_path / "00000000000000000023.timeindex",
        producer_snapshot_index=tmp_path / "00000000000000000023.snapshot",
        transaction_index=tmp_path / "00000000000000000023.txnindex",
        leader_epoch_index=b"leader-epoch-checkpoint-content",
    )
    return md, sd, files


@pytest.mark.parametrize("compression", [False, True])
@pytest.mark.parametrize("encryption", [False, True])
def test_lifecycle_over_s3(compression, encryption, emulators, keys, tmp_path):
    md, sd, files = _lifecycle_segment(tmp_path)
    rsm = RemoteStorageManager()
    rsm.configure(rsm_configs(
        "tieredstorage_tpu_torch", "s3", emulators["s3"].endpoint, keys,
        chunk_size=CHUNK_SIZE, encryption=encryption,
        extra={"compression.enabled": compression},
    ))
    rsm.copy_log_segment_data(md, sd)
    assert _stored_keys(rsm) == [f"test/{EXPECTED_MAIN}.{s}"
                                 for s in ("indexes", "log", "rsm-manifest")]

    with rsm._storage.fetch(ObjectKey(f"test/{EXPECTED_MAIN}.rsm-manifest")) as s:
        manifest = json.loads(s.read())
    chunk_index = manifest["chunkIndex"]
    assert chunk_index["originalChunkSize"] == CHUNK_SIZE
    assert chunk_index["originalFileSize"] == SEGMENT_SIZE
    assert chunk_index["type"] == ("variable" if compression else "fixed")
    assert manifest["compression"] is compression
    assert ("encryption" in manifest) is encryption
    assert manifest["remoteLogSegmentMetadata"]["startOffset"] == 23

    original = files["log"]
    with rsm.fetch_log_segment(md, 0) as s:
        assert s.read() == original
    for start, end in [(0, 0), (0, 99), (100, 2047), (1023, 1025),
                       (CHUNK_SIZE, 2 * CHUNK_SIZE - 1), (SEGMENT_SIZE - 5, SEGMENT_SIZE - 1),
                       (SEGMENT_SIZE - 5, SEGMENT_SIZE + 100)]:
        with rsm.fetch_log_segment(md, start, end) as s:
            assert s.read() == original[start : end + 1], (start, end)
    with rsm.fetch_log_segment(md, 5000) as s:
        assert s.read() == original[5000:]
    abandoned = rsm.fetch_log_segment(md, 0)
    abandoned.read(100)
    abandoned.close()

    for index_type, name in ((IndexType.OFFSET, "index"), (IndexType.TIMESTAMP, "timeindex"),
                             (IndexType.PRODUCER_SNAPSHOT, "snapshot"),
                             (IndexType.TRANSACTION, "txnindex")):
        assert rsm.fetch_index(md, index_type).read() == files[name]
    assert rsm.fetch_index(md, IndexType.LEADER_EPOCH).read() == b"leader-epoch-checkpoint-content"

    rsm.delete_log_segment_data(md)
    assert _stored_keys(rsm) == []
    with pytest.raises(RemoteResourceNotFoundException):
        with rsm.fetch_log_segment(md, 0) as s:
            s.read()
    pool = rsm._storage.client.http.pool
    rsm.close()
    assert pool.in_use == 0  # every streamed body was closed


def test_replicated_store_fails_over_when_s3_goes_away(keys, tmp_path):
    """Leg (c) of chip_smoke.py's storage phase at a small size: quorum 2
    over S3 and the filesystem. A broker restarted after the copy (a fresh
    RSM, so no health history: S3, listed first, is the primary) reads the
    segment after the S3 endpoint went away, and fails over."""
    emu = S3Emulator(credentials=S3_CREDENTIALS).start()
    stopped = False
    try:
        md, sd, contents = _write_segment(tmp_path, metadata)
        (tmp_path / "fs").mkdir()
        configs = {
            **rsm_configs("tieredstorage_tpu_torch", "s3", emu.endpoint, keys),
            "storage.backend.class":
                "tieredstorage_tpu_torch.storage.replicated.ReplicatedStorageBackend",
            "storage.replication.replicas": "s3,fs",
            "storage.replication.replica.s3.backend.class":
                "tieredstorage_tpu_torch.storage.s3.S3Storage",
            **{f"storage.replication.replica.s3.{k}": v
               for k, v in s3_configs(emu.endpoint).items()},
            "storage.replication.replica.s3.s3.api.call.timeout": 2000,
            "storage.replication.replica.fs.backend.class":
                "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
            "storage.replication.replica.fs.root": str(tmp_path / "fs"),
            "storage.replication.write.quorum": 2,
            # The prober's first round comes after the fetch below, so the
            # fetch itself meets the dead replica first.
            "storage.replication.probe.interval.ms": 30_000,
        }
        configs = {k: v for k, v in configs.items() if not k.startswith("storage.s3.")}
        writer = RemoteStorageManager()
        writer.configure(configs)
        rep = writer.replicated_storage
        assert rep is not None and rep.write_quorum == 2
        writer.copy_log_segment_data(md, sd)
        for state in rep.replica_states:
            assert len(list(state.backend.list_objects("test/"))) == 3
        writer.close()
        assert rep.prober is None

        reader = RemoteStorageManager()
        reader.configure(configs)
        emu.stop()
        stopped = True
        with reader.fetch_log_segment(md, 0) as stream:
            assert stream.read() == contents["log"]
        rep = reader.replicated_storage
        assert rep.failovers > 0
        assert rep.read_fetchers()[0] is rep.replica_states[1].backend
        reader.close()
    finally:
        if not stopped:
            emu.stop()
