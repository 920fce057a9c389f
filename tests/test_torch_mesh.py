"""The port's mesh (parallel/mesh.py, utils/platforms.py) and the split
window path against the JAX package's sharded one.

The JAX side runs on the conftest's 8-device virtual CPU mesh; the port is
pinned to 8 virtual CPU members by the `pinned` fixture, which restores the
unpinned state afterwards (the pin is process-wide, and later tests in the
same worker must see one CPU member). The same seeded chunks, key, AAD and
IVs go through both; wire bytes must match with no tolerance.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from tieredstorage_tpu import metadata as jax_metadata
from tieredstorage_tpu.parallel import mesh as jax_mesh
from tieredstorage_tpu.rsm import RemoteStorageManager as JaxRemoteStorageManager
from tieredstorage_tpu.security.aes import DataKeyAndAAD as JaxDataKeyAndAAD
from tieredstorage_tpu.transform.api import DetransformOptions as JaxDetransformOptions
from tieredstorage_tpu.transform.api import TransformOptions as JaxTransformOptions
from tieredstorage_tpu.transform.tpu import TpuTransformBackend
from tieredstorage_tpu_torch import metadata
from tieredstorage_tpu_torch.config.configdef import ConfigException
from tieredstorage_tpu_torch.object_key import ObjectKeyFactory, Suffix
from tieredstorage_tpu_torch.ops import gcm
from tieredstorage_tpu_torch.parallel import mesh
from tieredstorage_tpu_torch.rsm import RemoteStorageManager
from tieredstorage_tpu_torch.security.aes import DataKeyAndAAD
from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
from tieredstorage_tpu_torch.transform.api import (
    AuthenticationError,
    DetransformOptions,
    TransformOptions,
)
from tieredstorage_tpu_torch.transform.cuda import CudaTransformBackend
from tieredstorage_tpu_torch.utils import platforms

N = 8


@pytest.fixture
def pinned():
    """The port pinned to N virtual CPU members for one test, then unpinned."""
    platforms.unpin()
    platforms.pin_virtual_cpu(N)
    yield
    platforms.unpin()


def _error(fn) -> tuple:
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


# ------------------------------------------------------------------ MeshPlan
@pytest.mark.parametrize(
    "rows,devices", [(11, 8), (16, 8), (1, 8), (8, 8), (3, 4), (9, 2)])
def test_pad_batch_equals_jax(pinned, rows, devices):
    assert mesh.pad_batch(rows, mesh.data_mesh(devices)) == \
        jax_mesh.pad_batch(rows, jax_mesh.data_mesh(devices))
    assert mesh.pad_batch(rows, None) == jax_mesh.pad_batch(rows, None) == 0


@pytest.mark.parametrize("spec", [None, 0, "0", "all", "ALL", "", 1, "1", 2, 4, "8"])
def test_from_spec_equals_jax(pinned, spec):
    port, jax = mesh.MeshPlan.from_spec(spec), jax_mesh.MeshPlan.from_spec(spec)
    assert port.size == jax.size
    assert port.describe() == jax.describe()
    assert (port.mesh is None) == (jax.mesh is None)
    assert port.members == ((torch.device("cpu"),) * port.size if port.mesh else ())
    for rows in (1, 11, 16, 64):
        assert port.pad_rows(rows) == jax.pad_rows(rows)
        assert port.rows_per_device(rows) == jax.rows_per_device(rows)


@pytest.mark.parametrize("spec", [N + 1, -2, "-1"])
def test_from_spec_errors_equal_jax(pinned, spec):
    assert _error(lambda: mesh.MeshPlan.from_spec(spec)) == \
        _error(lambda: jax_mesh.MeshPlan.from_spec(spec))
    assert _error(lambda: mesh.data_mesh(N + 1)) == _error(lambda: jax_mesh.data_mesh(N + 1))


def test_wrap_normalizes_as_jax(pinned):
    assert mesh.MeshPlan.wrap(mesh.data_mesh(1)).mesh is None
    assert jax_mesh.MeshPlan.wrap(jax_mesh.data_mesh(1)).mesh is None
    assert mesh.MeshPlan.wrap(None).mesh is None
    plan = mesh.MeshPlan.from_spec(4)
    assert mesh.MeshPlan.wrap(plan) is plan
    assert mesh.MeshPlan.wrap(mesh.data_mesh(2)).size == jax_mesh.MeshPlan.wrap(
        jax_mesh.data_mesh(2)).size == 2
    # A member list, one device repeated: the split on one card.
    repeated = mesh.MeshPlan.wrap(["cpu"] * 3)
    assert repeated.size == 3 and repeated.describe() == {mesh.DATA_AXIS: 3}
    assert mesh.MeshPlan.wrap(["cpu"]).mesh is None


def test_shard_rows_splits_in_row_order(pinned):
    arr = np.arange(8 * 4, dtype=np.uint8).reshape(8, 4)
    shards = mesh.shard_rows(mesh.data_mesh(N), arr)
    assert len(shards) == N and all(s.shape == (1, 4) for s in shards)
    assert np.array_equal(torch.cat(shards).numpy(), arr)
    assert np.array_equal(mesh.MeshPlan(None).shard(arr).numpy(), arr)
    with pytest.raises(ValueError, match="do not split"):
        mesh.shard_rows(mesh.data_mesh(3), arr)


def test_run_on_members_runs_each_member_on_its_rows(pinned):
    m = mesh.data_mesh(4)
    shards = mesh.shard_rows(m, np.arange(8, dtype=np.int64))
    assert [int(t) for t in mesh.run_on_members(m, lambda s: s.sum(), shards)] == [1, 5, 9, 13]
    with pytest.raises(ValueError, match="3 shards for 4 members"):
        mesh.run_on_members(m, lambda s: s, shards[:3])


# ------------------------------------------------------------------- the pin
def test_pin_raises_jax_error_after_a_smaller_plan(pinned):
    platforms.unpin()
    platforms.pin_virtual_cpu(2)
    assert mesh.MeshPlan.from_spec(None).size == 2
    platforms.pin_virtual_cpu(2)  # raising to what it already is: fine
    with pytest.raises(RuntimeError, match=r"^virtual CPU mesh has 2 devices, need 8; "):
        platforms.pin_virtual_cpu(8)


def test_unpinned_cpu_platform_has_one_member():
    platforms.unpin()
    assert not platforms.pinned()
    assert mesh.local_devices("cpu") == [torch.device("cpu")]
    assert mesh.MeshPlan.from_spec(None, platform="cpu").mesh is None
    with pytest.raises(ValueError, match="Requested 2 devices, have 1"):
        mesh.MeshPlan.from_spec(2, platform="cpu")
    platforms.unpin()


# ------------------------------------------------------ the split backend
def _chunks(kind: str, rows: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    if kind == "fixed":
        return [rng.bytes(4096) for _ in range(rows)]
    sizes = rng.integers(300, 4096, rows)
    sizes[-1] = 17  # a short tail chunk
    return [rng.bytes(int(n)) for n in sizes]


def _backends():
    jax = TpuTransformBackend()
    jax.configure({"mesh.devices": N})
    port = CudaTransformBackend()
    port.configure({"device": "cpu", "mesh.devices": N})
    return jax, port


_STATS = ("windows", "dispatches", "h2d_transfers", "d2h_fetches", "bytes_in",
          "donated_buffers", "mesh_size", "rows_per_device", "dispatches_per_window")


@pytest.mark.parametrize("kind,rows", [("fixed", 16), ("fixed", 11), ("varlen", 11),
                                       ("varlen", 16)])
def test_split_wire_bytes_and_stats_equal_jax(pinned, kind, rows):
    chunks = _chunks(kind, rows, rows)
    rng = np.random.default_rng(99)
    key, aad = rng.bytes(32), rng.bytes(32)
    ivs = [rng.bytes(12) for _ in chunks]
    jax, port = _backends()
    want = jax.transform(chunks, JaxTransformOptions(encryption=JaxDataKeyAndAAD(key, aad), ivs=ivs))
    got = port.transform(chunks, TransformOptions(encryption=DataKeyAndAAD(key, aad), ivs=ivs))
    assert got == want
    jstats, pstats = jax.reset_dispatch_stats(), port.reset_dispatch_stats()
    assert {k: getattr(pstats, k) for k in _STATS} == {k: getattr(jstats, k) for k in _STATS}
    assert pstats.mesh_size == N and pstats.donated_buffers == 1
    back = port.detransform(got, DetransformOptions(encryption=DataKeyAndAAD(key, aad)))
    assert back == chunks == jax.detransform(
        want, JaxDetransformOptions(encryption=JaxDataKeyAndAAD(key, aad)))
    jstats, pstats = jax.reset_dispatch_stats(), port.reset_dispatch_stats()
    assert {k: getattr(pstats, k) for k in _STATS} == {k: getattr(jstats, k) for k in _STATS}


def test_split_decrypt_refuses_a_forged_tag(pinned):
    chunks = _chunks("fixed", 11, 5)
    dk = DataKeyAndAAD(bytes(range(32)), bytes(32))
    _, port = _backends()
    wire = port.transform(chunks, TransformOptions(encryption=dk))
    wire[9] = wire[9][:-1] + bytes([wire[9][-1] ^ 1])
    with pytest.raises(AuthenticationError, match=r"chunks \[9\]"):
        port.detransform(wire, DetransformOptions(encryption=dk))


def test_split_op_is_one_logical_dispatch_and_needs_tail_metadata(pinned):
    rng = np.random.default_rng(3)
    ctx = gcm.make_context(rng.bytes(32), rng.bytes(32), 4096)
    packed = rng.integers(0, 256, (N * 2, 4096 + 16), dtype=np.uint8)
    m = mesh.data_mesh(N)
    whole = gcm.gcm_window_packed(ctx, None, torch.from_numpy(packed.copy()), decrypt=False)
    before = gcm.device_dispatches()
    outs = gcm.gcm_window_packed(ctx, None, torch.from_numpy(packed.copy()), decrypt=False, mesh=m)
    assert gcm.device_dispatches() - before == 1
    assert len(outs) == N and np.array_equal(torch.cat(outs).numpy(), whole.numpy())
    jax_msg = "sharded packed windows read per-row metadata from the packed tail columns"
    with pytest.raises(ValueError, match=jax_msg):
        gcm.gcm_window_packed(ctx, packed[:, 4096:4108], torch.from_numpy(packed), decrypt=False,
                              mesh=m)
    with pytest.raises(ValueError, match=jax_msg):
        gcm.gcm_varlen_window_packed(ctx, None, torch.from_numpy(packed), [1] * (N * 2),
                                     decrypt=False, mesh=m)


def test_device_and_a_plan_that_does_not_start_there_are_refused(pinned):
    backend = CudaTransformBackend(device="cpu", mesh=["meta", "meta"])
    with pytest.raises(ConfigException, match="transform.mesh.devices.*transform.device=cpu"):
        backend.mesh_plan()
    assert CudaTransformBackend(mesh=["cpu"] * 2).device == torch.device("cpu")


def test_configure_takes_all_and_resolves_lazily(pinned):
    backend = CudaTransformBackend()
    backend.configure({"device": "cpu", "mesh.devices": "all"})
    assert backend._plan is None
    assert backend.mesh_plan().size == N
    backend.configure({"device": "cpu", "mesh.devices": N + 1})
    with pytest.raises(ValueError, match=f"Requested {N + 1} devices, have {N}"):
        backend.mesh_plan()


# ------------------------------------------------------- the RSM over a mesh
CHUNK = 4096
SEGMENT_SIZE = 5 * CHUNK + 777


@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    return generate_key_pair_pem_files(tmp_path_factory.mktemp("keys"), prefix="mesh")


def _segment(root: Path, mod, seed: int):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    files = {}
    for name, size in (("log", SEGMENT_SIZE), ("index", 48), ("timeindex", 72),
                       ("snapshot", 40)):
        path = root / f"00000000000000000023.{name}"
        path.write_bytes(rng.bytes(size))
        files[name] = path
    tip = mod.TopicIdPartition(mod.KafkaUuid(b"\x01" * 16), mod.TopicPartition("topic", 7))
    md = mod.RemoteLogSegmentMetadata(
        remote_log_segment_id=mod.RemoteLogSegmentId(tip, mod.KafkaUuid(bytes([seed + 2]) * 16)),
        start_offset=23, end_offset=2000, segment_size_in_bytes=SEGMENT_SIZE,
    )
    sd = mod.LogSegmentData(
        log_segment=files["log"], offset_index=files["index"], time_index=files["timeindex"],
        producer_snapshot_index=files["snapshot"], transaction_index=None,
        leader_epoch_index=b"0\n1\n0 23\n",
    )
    return md, sd, files["log"].read_bytes()


def _configs(store: Path, keys, package: str, extra=None) -> dict:
    pub, priv = keys
    return {
        "storage.backend.class": f"{package}.storage.filesystem.FileSystemStorage",
        "storage.root": str(store), "chunk.size": CHUNK, "key.prefix": "test/",
        "encryption.enabled": True, "encryption.key.pair.id": "k",
        "encryption.key.pairs": "k",
        "encryption.key.pairs.k.public.key.file": str(pub),
        "encryption.key.pairs.k.private.key.file": str(priv),
        **(extra or {}),
    }


def _read(rsm, md, start=0, end=None) -> bytes:
    with rsm.fetch_log_segment(md, start, end) as stream:
        return stream.read()


def test_mesh_rsm_segments_cross_read_with_jax(pinned, tmp_path, keys):
    store = tmp_path / "store"
    store.mkdir()
    port = RemoteStorageManager()
    port.configure(_configs(store, keys, "tieredstorage_tpu_torch", {
        "transform.device": "cpu", "transform.mesh.devices": N}))
    jax = JaxRemoteStorageManager()
    jax.configure(_configs(store, keys, "tieredstorage_tpu"))
    try:
        md, sd, log = _segment(tmp_path / "a", metadata, 1)
        port.copy_log_segment_data(md, sd)
        assert port.transform_backend.mesh_plan().size == N
        jmd, jsd, jlog = _segment(tmp_path / "b", jax_metadata, 2)
        jax.copy_log_segment_data(jmd, jsd)
        md_of_jax, _, _ = _segment(tmp_path / "c", metadata, 2)
        jmd_of_port, _, _ = _segment(tmp_path / "d", jax_metadata, 1)
        assert _read(jax, jmd_of_port) == log
        assert _read(port, md_of_jax) == jlog
        assert _read(port, md_of_jax, CHUNK - 5, 3 * CHUNK + 9) == jlog[CHUNK - 5 : 3 * CHUNK + 10]
        assert port.transform_backend.dispatch_stats.mesh_size == N
    finally:
        port.close()
        jax.close()


def test_hot_window_retained_from_a_mesh_serves_its_rows(pinned, tmp_path, keys):
    store = tmp_path / "store"
    store.mkdir()
    rsm = RemoteStorageManager()
    configs = _configs(store, keys, "tieredstorage_tpu_torch", {
        "transform.device": "cpu", "transform.mesh.devices": N, "readahead.enabled": False,
        "cache.device.bytes": 1 << 20})
    rsm.configure(configs)
    hot = rsm.device_hot_cache
    md, sd, log = _segment(tmp_path / "seg", metadata, 3)
    log_key = ObjectKeyFactory("test/", False).key(md, Suffix.LOG)
    try:
        rsm.copy_log_segment_data(md, sd)
        n_chunks = -(-SEGMENT_SIZE // CHUNK)
        for _ in range(2):  # first touch decrypts, the second admits
            assert _read(rsm, md) == log
        # Without a chunk cache each chunk is a window of its own: one row,
        # padded to one row a member.
        assert hot.admissions == hot.device_windows == n_chunks
        rows = hot.device_rows(log_key, list(range(n_chunks)))
        for cid, row in enumerate(rows):
            chunk = log[cid * CHUNK : (cid + 1) * CHUNK]
            assert row[: len(chunk)].numpy().tobytes() == chunk
        windows = list(hot._windows.values())
        assert all(w.mesh_size == N and len(w.device) == N for w in windows)
        # One budget for the mesh: every member's padded rows count.
        assert hot.resident_device_bytes == sum(
            int(t.nbytes) for w in windows for t in w.device)
        before = gcm.device_dispatches()
        assert _read(rsm, md) == log
        assert gcm.device_dispatches() == before
    finally:
        rsm.close()

