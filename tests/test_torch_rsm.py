"""The port's RemoteStorageManager end to end on the CPU, and segments that
cross-read with the JAX package's RSM in both directions.

chunk.size=4096 with an odd tail; encryption on, compression off (the
slice's configuration). The port runs with transform.device=cpu; the JAX
RSM uses its default CPU backend, whose wire format is the TPU backend's.
Both need `cryptography` only on the JAX side (the JAX RSM's RSA keys).
"""

from __future__ import annotations

import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tieredstorage_tpu import metadata as jax_metadata
from tieredstorage_tpu.manifest.segment_indexes import IndexType as JaxIndexType
from tieredstorage_tpu.rsm import RemoteStorageManager as JaxRemoteStorageManager
from tieredstorage_tpu_torch import metadata
from tieredstorage_tpu_torch.config.configdef import ConfigException
from tieredstorage_tpu_torch.errors import RemoteResourceNotFoundException
from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType
from tieredstorage_tpu_torch.rsm import RemoteStorageManager
from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
from tieredstorage_tpu_torch.transform.api import AuthenticationError

CHUNK = 4096
SEGMENT_SIZE = 5 * CHUNK + 777


def _write_segment(root: Path, mod, seed: int = 0):
    rng = np.random.default_rng(seed)
    files = {
        "log": (root / "00000000000000000023.log", rng.bytes(SEGMENT_SIZE)),
        "offset": (root / "00000000000000000023.index", rng.bytes(8 * 6)),
        "time": (root / "00000000000000000023.timeindex", rng.bytes(12 * 6)),
        "snapshot": (root / "00000000000000000023.snapshot", rng.bytes(40)),
        "txn": (root / "00000000000000000023.txnindex", rng.bytes(33)),
    }
    for path, data in files.values():
        path.write_bytes(data)
    tip = mod.TopicIdPartition(mod.KafkaUuid(b"\x01" * 16), mod.TopicPartition("topic", 7))
    md = mod.RemoteLogSegmentMetadata(
        remote_log_segment_id=mod.RemoteLogSegmentId(tip, mod.KafkaUuid(b"\x02" * 16)),
        start_offset=23, end_offset=2000, segment_size_in_bytes=SEGMENT_SIZE,
    )
    sd = mod.LogSegmentData(
        log_segment=files["log"][0], offset_index=files["offset"][0],
        time_index=files["time"][0], producer_snapshot_index=files["snapshot"][0],
        transaction_index=files["txn"][0], leader_epoch_index=b"0\n1\n0 23\n",
    )
    contents = {k: v[1] for k, v in files.items()}
    contents["leader_epoch"] = b"0\n1\n0 23\n"
    return md, sd, contents


INDEXES = {
    "offset": "OFFSET", "time": "TIMESTAMP", "snapshot": "PRODUCER_SNAPSHOT",
    "leader_epoch": "LEADER_EPOCH", "txn": "TRANSACTION",
}


@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    """One RSA pair generated by the port (read by both packages)."""
    return generate_key_pair_pem_files(tmp_path_factory.mktemp("keys"), prefix="rsm")


def _configs(store: Path, keys, backend_class: str, extra=None) -> dict:
    pub, priv = keys
    configs = {
        "storage.backend.class": backend_class,
        "storage.root": str(store),
        "chunk.size": CHUNK,
        "key.prefix": "test/",
        "encryption.enabled": True,
        "encryption.key.pair.id": "key1",
        "encryption.key.pairs": "key1",
        "encryption.key.pairs.key1.public.key.file": str(pub),
        "encryption.key.pairs.key1.private.key.file": str(priv),
    }
    configs.update(extra or {})
    return configs


def _port_rsm(store: Path, keys) -> RemoteStorageManager:
    rsm = RemoteStorageManager()
    rsm.configure(_configs(
        store, keys, "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        {"transform.device": "cpu"},
    ))
    return rsm


def _jax_rsm(store: Path, keys) -> JaxRemoteStorageManager:
    rsm = JaxRemoteStorageManager()
    rsm.configure(_configs(store, keys, "tieredstorage_tpu.storage.filesystem.FileSystemStorage"))
    return rsm


def _read_everything(rsm, md, index_type, contents):
    with rsm.fetch_log_segment(md, 0) as stream:
        assert stream.read() == contents["log"]
    for start, end in ((0, 99), (CHUNK - 5, 2 * CHUNK + 10), (SEGMENT_SIZE - 300, None)):
        with rsm.fetch_log_segment(md, start, end) as stream:
            stop = SEGMENT_SIZE if end is None else end + 1
            assert stream.read() == contents["log"][start:stop]
    for name, enum_name in INDEXES.items():
        assert rsm.fetch_index(md, getattr(index_type, enum_name)).read() == contents[name]


def test_port_rsm_lifecycle(tmp_path, keys):
    store = tmp_path / "store"
    store.mkdir()
    md, sd, contents = _write_segment(tmp_path, metadata)
    rsm = _port_rsm(store, keys)
    assert rsm.copy_log_segment_data(md, sd) is None
    files = sorted(p.name.rsplit(".", 1)[1] for p in store.rglob("*") if p.is_file())
    assert files == ["indexes", "log", "rsm-manifest"]
    [manifest_path] = store.rglob("*.rsm-manifest")
    manifest = json.loads(manifest_path.read_text())
    assert manifest["chunkIndex"] == {
        "type": "fixed", "originalChunkSize": CHUNK, "originalFileSize": SEGMENT_SIZE,
        "transformedChunkSize": CHUNK + 28, "finalTransformedChunkSize": 777 + 28,
    }
    assert manifest["encryption"]["dataKey"].startswith("key1:")
    _read_everything(rsm, md, IndexType, contents)
    assert rsm.transform_backend.dispatch_stats.windows > 0

    # A flipped ciphertext byte fails the fetch with the tag check as cause.
    [log_obj] = store.rglob("*.log")
    raw = bytearray(log_obj.read_bytes())
    raw[(CHUNK + 28) + 12 + 5] ^= 0x01
    log_obj.write_bytes(bytes(raw))
    with pytest.raises(Exception) as info:
        with rsm.fetch_log_segment(md, CHUNK, CHUNK + 10) as stream:
            stream.read()
    assert isinstance(info.value.__cause__, AuthenticationError)

    rsm.delete_log_segment_data(md)
    assert [p for p in store.rglob("*") if p.is_file()] == []
    rsm.close()
    # The manifest cache keeps a deleted segment's manifest, as the JAX
    # package's does; an RSM that never read it finds nothing.
    fresh = _port_rsm(store, keys)
    with pytest.raises(RemoteResourceNotFoundException):
        fresh.fetch_segment_manifest(md)
    fresh.close()


def test_failed_copy_rolls_back_uploaded_objects(tmp_path, keys, monkeypatch):
    store = tmp_path / "store"
    store.mkdir()
    md, sd, _ = _write_segment(tmp_path, metadata)
    rsm = _port_rsm(store, keys)

    def boom(*args, **kwargs):
        raise OSError("manifest upload failed")

    monkeypatch.setattr(rsm, "_upload_manifest", boom)
    with pytest.raises(Exception, match="Failed to copy segment"):
        rsm.copy_log_segment_data(md, sd)
    assert [p for p in store.rglob("*") if p.is_file()] == []


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_segments_cross_read_between_packages(tmp_path, keys, writer):
    store = tmp_path / "store"
    store.mkdir()
    md_port, sd_port, contents = _write_segment(tmp_path, metadata)
    md_jax, sd_jax, _ = _write_segment(tmp_path, jax_metadata)
    if writer == "jax":
        _jax_rsm(store, keys).copy_log_segment_data(md_jax, sd_jax)
        reader, md, index_type = _port_rsm(store, keys), md_port, IndexType
    else:
        _port_rsm(store, keys).copy_log_segment_data(md_port, sd_port)
        reader, md, index_type = _jax_rsm(store, keys), md_jax, JaxIndexType
    _read_everything(reader, md, index_type, contents)
    reader.delete_log_segment_data(md)
    assert [p for p in store.rglob("*") if p.is_file()] == []


@pytest.mark.parametrize(
    "key", ["fleet.enabled", "breaker.peer.failure.threshold",
            "breaker.gossip.failure.threshold", "retry.gossip.probe.attempts"],
)
def test_unported_keys_are_refused_by_name(tmp_path, keys, key):
    """The keys the port refused by name until the fleet was ported: each is
    now accepted and validated as the JAX package validates it (the same
    value gives the same answer, and an error the same message)."""
    from tieredstorage_tpu.config.configdef import ConfigException as JaxConfigException
    from tieredstorage_tpu.config.rsm_config import RemoteStorageManagerConfig as JaxConfig

    outcomes = []
    for value in ("1", "0"):
        configs = _configs(
            tmp_path, keys, "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
            {"transform.device": "cpu", key: value},
        )
        try:
            rsm = RemoteStorageManager()
            rsm.configure(configs)
            rsm.close()
            port = "accepted"
        except ConfigException as e:
            port = str(e)
        try:
            JaxConfig(_configs(
                tmp_path, keys, "tieredstorage_tpu.storage.filesystem.FileSystemStorage",
                {key: value}))
            jax = "accepted"
        except JaxConfigException as e:
            jax = str(e)
        assert port == jax and "not yet ported" not in port
        outcomes.append(port)
    assert "accepted" in outcomes and len(set(outcomes)) == 2


FAULT_LIFECYCLE_REPLICATION_KEYS = [
    "fault.injection.enabled", "fault.schedule", "fault.seed", "faults.spec", "faults.seed",
    "replication.antientropy.enabled", "replication.antientropy.interval.ms",
    "replication.antientropy.rate.bytes", "lifecycle.enabled", "lifecycle.journal.path",
    "lifecycle.sweep.interval.ms", "lifecycle.sweep.on.start", "lifecycle.grace.ms",
]
#: One value each key accepts and one its validator refuses (None: the type
#: accepts every value of it).
KEY_PROBES = {
    "fault.injection.enabled": (False, None), "fault.schedule": (["upload:raise@3"], ["upload:explode"]),
    "fault.seed": (7, None), "faults.spec": (["storage.read:error@2"], ["bogus.site:error"]),
    "faults.seed": (7, None), "replication.antientropy.enabled": (False, None),
    "replication.antientropy.interval.ms": (1, 0), "replication.antientropy.rate.bytes": (16 * 1024, 1024),
    "lifecycle.enabled": (False, None), "lifecycle.journal.path": ("/j.wal", " "),
    "lifecycle.sweep.interval.ms": (1, 0), "lifecycle.sweep.on.start": (True, None),
    "lifecycle.grace.ms": (0, -1),
}


SIDECAR_KEYS = {"sidecar.grpc.max.workers": "sidecar_grpc_max_workers",
                "sidecar.http.max.workers": "sidecar_http_max_workers"}


@pytest.mark.parametrize("key", sorted(SIDECAR_KEYS))
def test_sidecar_keys_are_jax_keys(tmp_path, keys, key):
    """The sidecar's pool sizes: JAX's type, default, validator, importance
    and doc, and the RSM property the server and gateway read."""
    from tieredstorage_tpu.config.configdef import ConfigException as JaxConfigException
    from tieredstorage_tpu.config.rsm_config import _base_def as jax_base_def
    from tieredstorage_tpu_torch.config.rsm_config import NOT_YET_PORTED, _base_def

    assert key not in NOT_YET_PORTED
    port, jax = _base_def().keys[key], jax_base_def().keys[key]
    assert (port.type, port.default, port.importance, port.doc) == (
        jax.type, jax.default, jax.importance, jax.doc)
    assert getattr(port.validator, "description", None) == getattr(jax.validator, "description", None)
    port.validator(key, 1)
    with pytest.raises(ConfigException) as port_err:
        port.validator(key, 0)
    with pytest.raises(JaxConfigException) as jax_err:
        jax.validator(key, 0)
    assert str(port_err.value) == str(jax_err.value)
    prop = SIDECAR_KEYS[key]
    assert getattr(RemoteStorageManager(), prop) == jax.default
    rsm = RemoteStorageManager()
    rsm.configure(_configs(
        tmp_path, keys, "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        {"transform.device": "cpu", key: 3},
    ))
    assert getattr(rsm, prop) == 3
    rsm.close()


@pytest.mark.parametrize("key", FAULT_LIFECYCLE_REPLICATION_KEYS)
def test_fault_lifecycle_and_replication_keys_are_jax_keys(key):
    from tieredstorage_tpu.config.configdef import ConfigException as JaxConfigException
    from tieredstorage_tpu.config.rsm_config import _base_def as jax_base_def
    from tieredstorage_tpu_torch.config.rsm_config import NOT_YET_PORTED, _base_def

    assert key not in NOT_YET_PORTED
    port, jax = _base_def().keys[key], jax_base_def().keys[key]
    assert (port.type, port.default, port.importance) == (jax.type, jax.default, jax.importance)
    assert getattr(port.validator, "description", None) == getattr(jax.validator, "description", None)
    good, bad = KEY_PROBES[key]
    for validator in (port.validator, jax.validator):
        if validator is not None:
            validator(key, good)
    if bad is not None:
        with pytest.raises(ConfigException) as port_err:
            port.validator(key, bad)
        with pytest.raises(JaxConfigException) as jax_err:
            jax.validator(key, bad)
        assert str(port_err.value) == str(jax_err.value)


def test_unported_codec_is_refused(tmp_path, keys):
    """Both device codecs are ported; a codec neither package has is
    refused by name, with the JAX package's message."""
    configs = _configs(
        tmp_path, keys, "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        {"transform.device": "cpu", "compression.enabled": True,
         "compression.codec": "tpu-huff-v2"},
    )
    with pytest.raises(ConfigException, match="'tpu-huff-v2'.*must be one of"):
        RemoteStorageManager().configure(configs)


def test_default_device_without_gpu_fails_configure(tmp_path, keys, monkeypatch):
    """No fallback: without a GPU the default transform device refuses."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    configs = _configs(
        tmp_path, keys, "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage"
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RemoteStorageManager().configure(configs)


def test_custom_metadata_keeps_fetches_working_after_a_prefix_change(tmp_path, keys):
    store = tmp_path / "store"
    store.mkdir()
    md, sd, contents = _write_segment(tmp_path, metadata)
    backend = "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage"
    include = {"transform.device": "cpu",
               "custom.metadata.fields.include": "REMOTE_SIZE,OBJECT_PREFIX,OBJECT_KEY"}
    writer = RemoteStorageManager()
    writer.configure(_configs(store, keys, backend, include))
    custom = writer.copy_log_segment_data(md, sd)
    assert custom
    reader = RemoteStorageManager()
    reader.configure(_configs(store, keys, backend, {**include, "key.prefix": "moved/"}))
    with reader.fetch_log_segment(md.with_custom_metadata(custom), 10, 5000) as stream:
        assert stream.read() == contents["log"][10:5001]
    with pytest.raises(RemoteResourceNotFoundException):
        reader.fetch_segment_manifest(md)  # without the fields, the new prefix misses


@pytest.mark.parametrize("on_cuda,encrypted,warms", [
    (True, True, True), (False, True, False), (True, False, False)],
    ids=["cuda", "cpu", "unencrypted"])
def test_warm_up_device_warms_a_cuda_backend_that_encrypts(tmp_path, keys, on_cuda,
                                                            encrypted, warms):
    """The sidecar's start-up warm-up: one chunk through the backend's
    `warm_up` where encryption is on and the device is a CUDA one, else
    nothing (the CUDA case takes the backend's device as a card's)."""
    rsm = RemoteStorageManager()
    rsm.configure(_configs(
        tmp_path, keys, "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        {"transform.device": "cpu", "encryption.enabled": encrypted},
    ))
    backend = rsm.transform_backend
    calls: list = []
    backend.warm_up = calls.append
    if on_cuda:
        backend._device = torch.device("cuda", 0)
    try:
        assert rsm.warm_up_device() is warms
    finally:
        backend._device = torch.device("cpu")
        rsm.close()
    assert calls == ([CHUNK] if warms else [])


def test_unencrypted_copy_round_trips(tmp_path, keys):
    store = tmp_path / "store"
    store.mkdir()
    md, sd, contents = _write_segment(tmp_path, metadata)
    rsm = RemoteStorageManager()
    rsm.configure({
        "storage.backend.class": "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        "storage.root": str(store), "chunk.size": CHUNK, "transform.device": "cpu",
    })
    rsm.copy_log_segment_data(md, sd)
    with rsm.fetch_log_segment(md, 10, 5000) as stream:
        assert stream.read() == contents["log"][10:5001]
    assert rsm.fetch_index(md, IndexType.LEADER_EPOCH).read() == contents["leader_epoch"]
    assert isinstance(rsm.fetch_index(md, IndexType.OFFSET), io.BytesIO)
