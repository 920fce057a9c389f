"""RSM segments compressed with the device codecs, and with zstd, cross-read
between the packages, both ways, byte for byte.

A JAX RSM writes a log-shaped segment (text records, so the codecs code
every chunk rather than RAW-framing it) with `tpu-huff-v1` + encryption,
with `tpu-lzhuff-v1`, and with `zstd` + encryption on its native route
(its NativeTransformBackend); the port's RSM (the CUDA backend class,
transform.device=cpu, whose zstd runs through the port's own native
library) fetches each whole and in ranges, and every index; then the port
writes and the JAX RSM reads. The manifests record the codec (zstd as the
reference does, by leaving the id out).
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_rsm import INDEXES
from tests.torch_threads import one_torch_thread  # noqa: F401
from tieredstorage_tpu import metadata as jax_metadata
from tieredstorage_tpu.manifest.segment_indexes import IndexType as JaxIndexType
from tieredstorage_tpu.rsm import RemoteStorageManager as JaxRemoteStorageManager
from tieredstorage_tpu_torch import metadata
from tieredstorage_tpu_torch.config.configdef import ConfigException
from tieredstorage_tpu_torch.config.rsm_config import RemoteStorageManagerConfig, _codec_id
from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType
from tieredstorage_tpu_torch.rsm import RemoteStorageManager
from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files

CHUNK = 8192
SEGMENT_SIZE = 4 * CHUNK + 1234


def _log_bytes(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    out = bytearray()
    i = 0
    while len(out) < SEGMENT_SIZE:
        out += b"offset=%d key=user-%d value=" % (1000 + i, rng.integers(0, 500))
        out += rng.bytes(int(rng.integers(4, 24)))
        i += 1
    return bytes(out[:SEGMENT_SIZE])


def _write_segment(root: Path, mod, seed: int):
    rng = np.random.default_rng(seed)
    files = {
        "log": (root / "00000000000000000042.log", _log_bytes(seed)),
        "offset": (root / "00000000000000000042.index", rng.bytes(8 * 9)),
        "time": (root / "00000000000000000042.timeindex", rng.bytes(12 * 9)),
        "snapshot": (root / "00000000000000000042.snapshot", rng.bytes(40)),
        "txn": (root / "00000000000000000042.txnindex", rng.bytes(33)),
    }
    for path, data in files.values():
        path.write_bytes(data)
    tip = mod.TopicIdPartition(mod.KafkaUuid(b"\x05" * 16), mod.TopicPartition("logs", 3))
    md = mod.RemoteLogSegmentMetadata(
        remote_log_segment_id=mod.RemoteLogSegmentId(tip, mod.KafkaUuid(b"\x06" * 16)),
        start_offset=42, end_offset=4000, segment_size_in_bytes=SEGMENT_SIZE,
    )
    sd = mod.LogSegmentData(
        log_segment=files["log"][0], offset_index=files["offset"][0],
        time_index=files["time"][0], producer_snapshot_index=files["snapshot"][0],
        transaction_index=files["txn"][0], leader_epoch_index=b"0\n1\n0 42\n",
    )
    contents = {k: v[1] for k, v in files.items()}
    contents["leader_epoch"] = b"0\n1\n0 42\n"
    return md, sd, contents


@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    return generate_key_pair_pem_files(tmp_path_factory.mktemp("keys"), prefix="codec")


def _configs(store: Path, keys, backend: str, codec: str, encryption: bool, extra=None) -> dict:
    pub, priv = keys
    configs = {
        "storage.backend.class": backend,
        "storage.root": str(store),
        "chunk.size": CHUNK,
        "key.prefix": "codec/",
        "compression.enabled": True,
        "compression.codec": codec,
        "encryption.enabled": encryption,
    }
    if encryption:
        configs.update({
            "encryption.key.pair.id": "key1",
            "encryption.key.pairs": "key1",
            "encryption.key.pairs.key1.public.key.file": str(pub),
            "encryption.key.pairs.key1.private.key.file": str(priv),
        })
    configs.update(extra or {})
    return configs


#: The JAX RSM's zstd runs on its native route (its host library).
JAX_NATIVE_BACKEND = "tieredstorage_tpu.transform.native_backend.NativeTransformBackend"


def _rsm(kind: str, store: Path, keys, codec: str, encryption: bool):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)  # tpu-lzhuff-v1
        if kind == "port":
            rsm = RemoteStorageManager()
            rsm.configure(_configs(
                store, keys, "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
                codec, encryption, {"transform.device": "cpu"}))
        else:
            rsm = JaxRemoteStorageManager()
            rsm.configure(_configs(
                store, keys, "tieredstorage_tpu.storage.filesystem.FileSystemStorage",
                codec, encryption,
                {"transform.backend.class": JAX_NATIVE_BACKEND} if codec == "zstd" else None))
    return rsm


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("codec,encryption", [
    ("tpu-huff-v1", True), ("tpu-lzhuff-v1", False), ("zstd", True)])
def test_codec_segments_cross_read_between_packages(tmp_path, keys, writer, codec, encryption):
    store = tmp_path / "store"
    store.mkdir()
    seed = {"tpu-huff-v1": 3, "tpu-lzhuff-v1": 4, "zstd": 5}[codec]
    md_port, sd_port, contents = _write_segment(tmp_path, metadata, seed)
    md_jax, sd_jax, _ = _write_segment(tmp_path, jax_metadata, seed)
    reader_kind = "port" if writer == "jax" else "jax"
    if writer == "jax":
        _rsm("jax", store, keys, codec, encryption).copy_log_segment_data(md_jax, sd_jax)
        md, index_type = md_port, IndexType
    else:
        _rsm("port", store, keys, codec, encryption).copy_log_segment_data(md_port, sd_port)
        md, index_type = md_jax, JaxIndexType
    [manifest_path] = store.rglob("*.rsm-manifest")
    manifest = json.loads(manifest_path.read_text())
    assert manifest["compression"] is True
    assert manifest.get("compressionCodec", "zstd") == codec
    assert ("encryption" in manifest and manifest["encryption"] is not None) == encryption
    [log_obj] = store.rglob("*.log")
    assert log_obj.stat().st_size < 0.9 * SEGMENT_SIZE  # the codec coded the chunks

    reader = _rsm(reader_kind, store, keys, codec, encryption)
    log = contents["log"]
    with reader.fetch_log_segment(md, 0) as stream:
        assert stream.read() == log
    for start, end in ((0, 99), (CHUNK - 5, 2 * CHUNK + 10), (3 * CHUNK, 4 * CHUNK - 1),
                       (SEGMENT_SIZE - 300, None)):
        with reader.fetch_log_segment(md, start, end) as stream:
            stop = SEGMENT_SIZE if end is None else end + 1
            assert stream.read() == log[start:stop]
    for name, enum_name in INDEXES.items():
        assert reader.fetch_index(md, getattr(index_type, enum_name)).read() == contents[name]
    reader.delete_log_segment_data(md)
    assert [p for p in store.rglob("*") if p.is_file()] == []


def test_codec_config_equals_jax():
    """The three codec ids pass, anything else is refused with JAX's
    message, and tpu-lzhuff-v1 warns as in the JAX package."""
    from tieredstorage_tpu.config.configdef import ConfigException as JaxConfigException
    from tieredstorage_tpu.config.rsm_config import _codec_id as jax_codec_id

    for codec in ("zstd", "tpu-huff-v1"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            _codec_id("compression.codec", codec)
    with pytest.warns(DeprecationWarning, match="tpu-lzhuff-v1") as ours:
        _codec_id("compression.codec", "tpu-lzhuff-v1")
    with pytest.warns(DeprecationWarning) as theirs:
        jax_codec_id("compression.codec", "tpu-lzhuff-v1")
    assert str(ours[0].message) == str(theirs[0].message)
    for bad in ("tpu-lzhuff-v2", "lz4", ""):
        with pytest.raises(JaxConfigException) as j:
            jax_codec_id("compression.codec", bad)
        with pytest.raises(ConfigException) as p:
            _codec_id("compression.codec", bad)
        assert str(p.value) == str(j.value)
    config = RemoteStorageManagerConfig({
        "storage.backend.class": "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
        "chunk.size": 1024, "compression.enabled": True, "compression.codec": "tpu-huff-v1",
    })
    assert config.compression_codec == "tpu-huff-v1"
