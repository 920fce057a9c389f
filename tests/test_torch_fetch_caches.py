"""The port's fetch plane against the JAX package's, on the CPU.

Each cache module is driven by one seeded numpy access trace through the JAX
module and the port's, over fake delegates that return the same bytes; the
returned bytes, every counter and the window each delegate saw must be
identical (no tolerance). Thread pools are swapped for an inline executor in
both packages, so the async prefetch and speculation run at a fixed point of
the trace. Then whole RSMs: a small encrypted segment written by either
package reads back through the other's cached chain (chunk cache, readahead,
hot tier), the hot tier's retained tensor survives later windows of the same
shape (the retention probe), and the fetch-plane keys carry the JAX names,
types and defaults.
"""

from __future__ import annotations

import concurrent.futures
import io
import time
import types
from pathlib import Path

import numpy as np
import pytest

from tieredstorage_tpu import metadata as jax_metadata
from tieredstorage_tpu.config import cache_config as jax_cache_config
from tieredstorage_tpu.fetch import factory as jax_factory
from tieredstorage_tpu.fetch import readahead as jax_readahead
from tieredstorage_tpu.fetch.cache import chunk_cache as jax_chunk_cache
from tieredstorage_tpu.fetch.cache import device_hot as jax_device_hot
from tieredstorage_tpu.fetch.cache.disk import DiskChunkCache as JaxDiskChunkCache
from tieredstorage_tpu.fetch.cache.memory import MemoryChunkCache as JaxMemoryChunkCache
from tieredstorage_tpu.fetch.chunk_manager import ChunkManager as JaxChunkManager
from tieredstorage_tpu.fetch.index_cache import MemorySegmentIndexesCache as JaxIndexesCache
from tieredstorage_tpu.fetch.manifest_cache import MemorySegmentManifestCache as JaxManifestCache
from tieredstorage_tpu.manifest.chunk_index import FixedSizeChunkIndex as JaxChunkIndex
from tieredstorage_tpu.manifest.segment_indexes import IndexType as JaxIndexType
from tieredstorage_tpu.rsm import RemoteStorageManager as JaxRemoteStorageManager
from tieredstorage_tpu.storage.core import ObjectKey as JaxObjectKey
from tieredstorage_tpu.utils import caching as jax_caching
from tieredstorage_tpu_torch import metadata
from tieredstorage_tpu_torch.config import cache_config
from tieredstorage_tpu_torch.config.configdef import ConfigException
from tieredstorage_tpu_torch.fetch import factory, readahead
from tieredstorage_tpu_torch.fetch.cache import chunk_cache, device_hot
from tieredstorage_tpu_torch.fetch.cache.disk import DiskChunkCache
from tieredstorage_tpu_torch.fetch.cache.memory import MemoryChunkCache
from tieredstorage_tpu_torch.fetch.chunk_manager import ChunkManager, DefaultChunkManager
from tieredstorage_tpu_torch.fetch.index_cache import MemorySegmentIndexesCache
from tieredstorage_tpu_torch.fetch.manifest_cache import MemorySegmentManifestCache
from tieredstorage_tpu_torch.manifest.chunk_index import FixedSizeChunkIndex
from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType
from tieredstorage_tpu_torch.object_key import ObjectKeyFactory, Suffix
from tieredstorage_tpu_torch.ops import gcm
from tieredstorage_tpu_torch.rsm import RemoteStorageManager
from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
from tieredstorage_tpu_torch.storage.core import ObjectKey
from tieredstorage_tpu_torch.storage.filesystem import FileSystemStorage
from tieredstorage_tpu_torch.utils import caching
from tieredstorage_tpu_torch.utils.deadline import (
    Deadline,
    DeadlineExceededException,
    deadline_scope,
)

SEGMENTS = (
    "pre/topic-a/3/00000000000000000042-uuid.log",
    "pre/topic-a/3/00000000000000000099-uuid.log",
)
CHUNK = 64
N_CHUNKS = 40


class InlineExecutor(concurrent.futures.Executor):
    """Runs each task at submit: async prefetch and speculation happen at a
    fixed point of the trace, the same in both packages."""

    def __init__(self, *args, **kwargs) -> None:
        pass

    def submit(self, fn, *args, **kwargs):
        future = concurrent.futures.Future()
        try:
            future.set_result(fn(*args, **kwargs))
        except BaseException as e:  # noqa: BLE001 - stored, as a pool does
            future.set_exception(e)
        return future


@pytest.fixture
def inline_pools(monkeypatch):
    for mod in (jax_chunk_cache, chunk_cache, jax_readahead, readahead):
        monkeypatch.setattr(mod, "ThreadPoolExecutor", InlineExecutor)


def _fake_manager(base):
    class Recording(base):
        """Chunk i of any segment is bytes([i % 251 + seg]) * CHUNK (the last
        chunk shorter); every window asked for is recorded."""

        def __init__(self):
            self.calls: list[tuple[str, tuple[int, ...]]] = []

        def get_chunk(self, objects_key, manifest, chunk_id):
            return io.BytesIO(self.get_chunks(objects_key, manifest, [chunk_id])[0])

        def get_chunks(self, objects_key, manifest, chunk_ids):
            self.calls.append((objects_key.value, tuple(chunk_ids)))
            return [_chunk_bytes(objects_key.value, cid) for cid in chunk_ids]

    return Recording()


def _chunk_bytes(key: str, cid: int) -> bytes:
    size = CHUNK - 17 if cid == N_CHUNKS - 1 else CHUNK
    return bytes([(cid + SEGMENTS.index(key)) % 251]) * size


def _manifest(index_cls):
    size = N_CHUNKS * CHUNK - 17
    index = index_cls(CHUNK, size, CHUNK + 28, CHUNK + 28 - 17)
    return types.SimpleNamespace(chunk_index=index)


def _window_trace(seed: int, steps: int, *, sequential: float = 0.6):
    """(segment, chunk ids) windows: runs of sequential windows (the
    consumer's replay), re-reads, and seeks."""
    rng = np.random.default_rng(seed)
    seg, pos, out = 0, 0, []
    for _ in range(steps):
        u = rng.random()
        width = int(rng.integers(1, 4))
        if u < sequential:
            start = pos
        elif u < sequential + 0.1 and out:
            start = out[-1][1][0]  # re-read of the previous window
        else:
            seg = int(rng.integers(0, len(SEGMENTS)))
            start = int(rng.integers(0, N_CHUNKS))
        ids = tuple(range(start, min(start + width, N_CHUNKS)))
        pos = ids[-1] + 1 if ids[-1] + 1 < N_CHUNKS else 0
        out.append((seg, ids))
    return out


def _as_bytes(chunks) -> list[bytes]:
    return [bytes(c) for c in chunks]


# ---------------------------------------------------------------- LoadingCache
def _drive_loading_cache(mod, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    now = [0.0]
    removed: list = []
    cache = mod.LoadingCache(
        executor=InlineExecutor(), max_weight=200, weigher=len,
        expire_after_access_s=5.0, time_source=lambda: now[0],
        removal_listener=lambda k, v, cause: removed.append((k, len(v), cause.value)),
    )
    results: list = []
    for _ in range(300):
        now[0] += float(rng.random())
        key = int(rng.integers(0, 20))
        op = rng.random()
        if op < 0.6:
            size = int(rng.integers(1, 60))
            fail = rng.random() < 0.05

            def loader(size=size, fail=fail, key=key):
                if fail:
                    raise ValueError(f"load {key} failed")
                return bytes([key]) * size

            try:
                results.append(("get", cache.get(key, loader)))
            except ValueError as e:
                results.append(("error", str(e)))
        elif op < 0.75:
            future = cache.get_if_present(key)
            results.append(("present", None if future is None else future.result()))
        elif op < 0.85:
            future = cache.peek(key)
            results.append(("peek", None if future is None else future.result()))
        else:
            cache.invalidate(key)
    stats = cache.stats
    return dict(
        results=results, removed=removed, len=len(cache), weight=cache.total_weight,
        stats=(stats.hits, stats.misses, stats.load_successes, stats.load_failures,
               {c.value: n for c, n in stats.evictions.items()}, stats.eviction_weight,
               stats.listener_failures),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_loading_cache_trace_matches_jax(seed):
    assert _drive_loading_cache(caching, seed) == _drive_loading_cache(jax_caching, seed)


# ------------------------------------------------------------- FrequencySketch
@pytest.mark.parametrize("width,decay_every", [(64, None), (16, 50)])
def test_frequency_sketch_trace_matches_jax(width, decay_every):
    rng = np.random.default_rng(width)
    keys = [f"seg-{int(k)}#{int(k) * 3}-{int(k) * 3 + 2}" for k in rng.zipf(1.3, 3000) % 400]
    probes = [f"seg-{k}#{k * 3}-{k * 3 + 2}" for k in range(0, 400, 7)]
    out = []
    for mod in (jax_device_hot, device_hot):
        sketch = mod.FrequencySketch(width, decay_every)
        touched = [sketch.touch(k) for k in keys]
        out.append((sketch.width, touched, [sketch.estimate(k) for k in probes]))
    assert out[0] == out[1]
    assert max(out[1][1]) > 2  # the trace is skewed enough to count past admission


# -------------------------------------------------------------- DeviceHotCache
_HOT_COUNTERS = (
    "hits", "misses", "chunks_served", "zero_copy_serves", "admissions", "rejections",
    "evictions", "device_windows", "resident_windows", "resident_bytes",
    "resident_device_bytes",
)


def _drive_hot(mod, base, key_cls, index_cls, seed: int, budget: int) -> dict:
    delegate = _fake_manager(base)
    hot = mod.DeviceHotCache(delegate, budget_bytes=budget, admission_hits=2, sketch_width=64)
    manifest = _manifest(index_cls)
    served = []
    rng = np.random.default_rng(seed)
    hot_set = [(0, (4, 5)), (1, (10,)), (0, (20, 21, 22))]
    for seg, ids in _window_trace(seed, 300, sequential=0.3):
        if rng.random() < 0.5:  # a Zipf-ish hot set among the scans
            seg, ids = hot_set[int(rng.integers(0, len(hot_set)))]
        served.append(_as_bytes(hot.get_chunks(key_cls(SEGMENTS[seg]), manifest, list(ids))))
    return dict(served=served, calls=delegate.calls,
                counters={name: getattr(hot, name) for name in _HOT_COUNTERS})


@pytest.mark.parametrize("budget", [4 * CHUNK, 12 * CHUNK], ids=["tight", "roomy"])
def test_device_hot_cache_trace_matches_jax(budget):
    want = _drive_hot(jax_device_hot, JaxChunkManager, JaxObjectKey, JaxChunkIndex, 3, budget)
    got = _drive_hot(device_hot, ChunkManager, ObjectKey, FixedSizeChunkIndex, 3, budget)
    assert got == want
    assert got["counters"]["admissions"] > 0 and got["counters"]["hits"] > 0
    assert got["counters"]["evictions"] > 0 or budget > 4 * CHUNK


# ------------------------------------------------------------------ ChunkCache
def _drive_chunk_cache(cls, base, key_cls, index_cls, seed: int, configs: dict) -> dict:
    delegate = _fake_manager(base)
    cache = cls(delegate)
    cache.configure(configs)
    manifest = _manifest(index_cls)
    served = []
    for seg, ids in _window_trace(seed, 120):
        key = key_cls(SEGMENTS[seg])
        got = _as_bytes(cache.get_chunks(key, manifest, list(ids)))
        assert got == [_chunk_bytes(key.value, c) for c in ids]
        served.append(got)
    stats = cache.stats
    out = dict(
        served=served, calls=delegate.calls, size=cache.size, weight=cache.total_weight,
        counters=(cache.degradations, cache.prefetch_failures, cache.inflight_joins),
        stats=(stats.hits, stats.misses, stats.load_successes, stats.load_failures,
               {c.value: n for c, n in stats.evictions.items()}, stats.eviction_weight),
    )
    cache.close()
    return out


@pytest.mark.parametrize("kind", ["memory", "disk"])
@pytest.mark.parametrize("prefetch", [(0, 2), (5 * CHUNK, 2), (7 * CHUNK, 0)],
                         ids=["no-prefetch", "prefetch-subwindows", "prefetch-one-batch"])
def test_chunk_cache_trace_matches_jax(inline_pools, tmp_path, kind, prefetch):
    size, window = prefetch
    configs = {"size": 16 * CHUNK, "retention.ms": -1, "prefetch.max.size": size,
               "prefetch.window.chunks": window}
    classes = {"memory": (JaxMemoryChunkCache, MemoryChunkCache),
               "disk": (JaxDiskChunkCache, DiskChunkCache)}[kind]
    runs, files = [], []
    for name, cls, base, key_cls, index_cls in (
        ("jax", classes[0], JaxChunkManager, JaxObjectKey, JaxChunkIndex),
        ("port", classes[1], ChunkManager, ObjectKey, FixedSizeChunkIndex),
    ):
        extra = {}
        if kind == "disk":
            (tmp_path / name).mkdir()
            extra = {"path": str(tmp_path / name)}
        runs.append(_drive_chunk_cache(cls, base, key_cls, index_cls, 5, {**configs, **extra}))
        if kind == "disk":
            files.append(sorted(p.name for p in (tmp_path / name / "cache").iterdir()))
    assert runs[1] == runs[0]
    assert files[:1] == files[1:]
    evicted = runs[1]["stats"][4]["size"]
    assert evicted > 0  # the 16-chunk bound was hit
    if kind == "disk":
        assert len(files[1]) == runs[1]["size"]  # eviction deleted the files
    # A foreground window asks the delegate for its missing chunks only; a
    # prefetch asks for chunks past the window, in sub-windows.
    foreground = [(SEGMENTS[seg], set(ids)) for seg, ids in _window_trace(5, 120)]
    prefetched = [
        ids for key, ids in runs[1]["calls"]
        if not any(key == k and set(ids) <= f for k, f in foreground)
    ]
    assert bool(prefetched) == bool(size)
    if size:
        widest = max(len(ids) for ids in prefetched)
        assert widest == 2 if window else widest > 3


# ------------------------------------------------------------- ReadaheadManager
_READAHEAD_COUNTERS = (
    "promotions", "demotions", "strikes", "stream_evictions", "windows_launched",
    "chunks_speculated", "bytes_speculated", "inflight_bytes", "used_chunks", "used_bytes",
    "wasted_bytes", "budget_deferrals", "ratio_throttles", "cross_segment_continuations",
    "speculation_failures", "pre_admit_age_ms_sum", "pre_admit_age_samples",
    "tracked_streams", "outstanding_chunks",
)


def _drive_readahead(mod, base, key_cls, index_cls, seed: int, params: dict) -> dict:
    delegate = _fake_manager(base)
    now = [0.0]
    manager = mod.ReadaheadManager(delegate, time_source=lambda: now[0], **params)
    manifest = _manifest(index_cls)
    manager.next_segment_resolver = (
        lambda key: (key_cls(SEGMENTS[1]), lambda: manifest)
        if key.value == SEGMENTS[0] else None
    )
    served = []
    for seg, ids in _window_trace(seed, 200, sequential=0.8):
        now[0] += 0.003
        served.append(_as_bytes(manager.get_chunks(key_cls(SEGMENTS[seg]), manifest, list(ids))))
    out = dict(served=served, calls=delegate.calls,
               counters={name: getattr(manager, name) for name in _READAHEAD_COUNTERS})
    manager.close()
    return out


@pytest.mark.parametrize("params", [
    dict(window_chunks=4, budget_bytes=1 << 20),
    dict(window_chunks=3, budget_bytes=150, streams_max=1, misprediction_max_ratio=0.05),
], ids=["roomy", "tight"])
def test_readahead_trace_matches_jax(inline_pools, params):
    want = _drive_readahead(jax_readahead, JaxChunkManager, JaxObjectKey, JaxChunkIndex, 7, params)
    got = _drive_readahead(readahead, ChunkManager, ObjectKey, FixedSizeChunkIndex, 7, params)
    assert got == want
    counters = got["counters"]
    assert counters["promotions"] > 0 and counters["strikes"] > 0
    if params["budget_bytes"] > 1000:
        assert counters["windows_launched"] > 0 and counters["used_chunks"] > 0
        assert counters["wasted_bytes"] > 0
    else:
        assert counters["budget_deferrals"] > 0


# --------------------------------------------------------------- configuration
def _key_table(config_def) -> dict:
    return {
        k.name: (k.type, "required" if k.required else k.default,
                 getattr(k.validator, "description", None))
        for k in config_def.keys.values()
    }


@pytest.mark.parametrize("name", [
    "_cache_def", "_chunk_cache_extra", "_disk_cache_extra", "device_hot", "readahead",
])
def test_fetch_plane_keys_match_jax(name):
    """Names, types, defaults and validators of the JAX ConfigDefs."""
    defs = {
        "_cache_def": (jax_cache_config._cache_def, cache_config._cache_def),
        "_chunk_cache_extra": (jax_cache_config._chunk_cache_extra, cache_config._chunk_cache_extra),
        "_disk_cache_extra": (jax_cache_config._disk_cache_extra, cache_config._disk_cache_extra),
        "device_hot": (jax_device_hot._definition, device_hot._definition),
        "readahead": (jax_readahead._definition, readahead._definition),
    }[name]
    want, got = (_key_table(d()) for d in defs)
    assert got == want and got


def test_factory_and_metadata_cache_defaults_match_jax():
    assert factory.ChunkManagerFactoryConfig({})._values == (
        jax_factory.ChunkManagerFactoryConfig({})._values
    )
    for ours, theirs in ((MemorySegmentManifestCache(), JaxManifestCache()),
                         (MemorySegmentIndexesCache(), JaxIndexesCache())):
        ours.configure({})
        theirs.configure({})
        assert ours._config._values == theirs._config._values
        ours.close()
        theirs.close()


def test_chunk_cache_class_must_be_a_chunk_cache():
    with pytest.raises(ConfigException, match="subclass of ChunkCache"):
        factory.ChunkManagerFactoryConfig({"fetch.chunk.cache.class": FileSystemStorage})


# ------------------------------------------------------------------ whole RSMs
SEG_CHUNK = 64 * 1024
SEG_SIZE = 5 * SEG_CHUNK + 777


@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    return generate_key_pair_pem_files(tmp_path_factory.mktemp("keys"), prefix="fetch")


def _segment(root: Path, mod):
    rng = np.random.default_rng(11)
    log = rng.bytes(SEG_SIZE)
    files = {}
    for name, data in (("log", log), ("index", rng.bytes(48)), ("timeindex", rng.bytes(72)),
                       ("snapshot", rng.bytes(40))):
        files[name] = root / f"00000000000000000023.{name}"
        files[name].write_bytes(data)
    tip = mod.TopicIdPartition(mod.KafkaUuid(b"\x01" * 16), mod.TopicPartition("topic", 7))
    md = mod.RemoteLogSegmentMetadata(
        remote_log_segment_id=mod.RemoteLogSegmentId(tip, mod.KafkaUuid(b"\x02" * 16)),
        start_offset=23, end_offset=2000, segment_size_in_bytes=SEG_SIZE,
    )
    sd = mod.LogSegmentData(
        log_segment=files["log"], offset_index=files["index"], time_index=files["timeindex"],
        producer_snapshot_index=files["snapshot"], transaction_index=None,
        leader_epoch_index=b"0\n1\n0 23\n",
    )
    return md, sd, log, files["index"].read_bytes()


def _configs(store: Path, keys, package: str, cache_dir: Path, extra=None) -> dict:
    pub, priv = keys
    configs = {
        "storage.backend.class": f"{package}.storage.filesystem.FileSystemStorage",
        "storage.root": str(store),
        "chunk.size": SEG_CHUNK,
        "key.prefix": "test/",
        "encryption.enabled": True,
        "encryption.key.pair.id": "key1",
        "encryption.key.pairs": "key1",
        "encryption.key.pairs.key1.public.key.file": str(pub),
        "encryption.key.pairs.key1.private.key.file": str(priv),
        "fetch.chunk.cache.class": f"{package}.fetch.cache.disk.DiskChunkCache",
        "fetch.chunk.cache.path": str(cache_dir),
        "fetch.chunk.cache.size": 3 * SEG_CHUNK,
        "fetch.chunk.cache.prefetch.max.size": 2 * SEG_CHUNK,
        "fetch.chunk.cache.prefetch.window.chunks": 2,
        "readahead.enabled": True,
        "readahead.window.chunks": 2,
        "cache.device.bytes": 8 * SEG_CHUNK,
    }
    if package == "tieredstorage_tpu_torch":
        configs["transform.device"] = "cpu"
    configs.update(extra or {})
    return configs


def _rsm(cls, store, keys, package, cache_dir, extra=None, drop=()):
    cache_dir.mkdir(exist_ok=True)
    configs = _configs(store, keys, package, cache_dir, extra)
    for name in drop:
        del configs[name]
    rsm = cls()
    rsm.configure(configs)
    return rsm


def _replay(rsm, md, log: bytes) -> None:
    """Front to back in 40 KiB reads (not chunk aligned), twice, then the
    whole segment and a few ranges."""
    for _ in range(2):
        for start in range(0, SEG_SIZE, 40 * 1024):
            end = min(start + 40 * 1024, SEG_SIZE) - 1
            with rsm.fetch_log_segment(md, start, end) as stream:
                assert stream.read() == log[start : end + 1]
    with rsm.fetch_log_segment(md, 0) as stream:
        assert stream.read() == log
    for start, end in ((SEG_CHUNK - 5, 3 * SEG_CHUNK + 10), (SEG_SIZE - 300, SEG_SIZE - 1)):
        with rsm.fetch_log_segment(md, start, end) as stream:
            assert stream.read() == log[start : end + 1]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_segments_cross_read_through_cached_chains(tmp_path, keys, writer):
    store = tmp_path / "store"
    store.mkdir()
    md_port, sd_port, log, offset_index = _segment(tmp_path, metadata)
    md_jax, sd_jax, _, _ = _segment(tmp_path, jax_metadata)
    if writer == "jax":
        writer_rsm = _rsm(JaxRemoteStorageManager, store, keys, "tieredstorage_tpu",
                          tmp_path / "wcache")
        writer_rsm.copy_log_segment_data(md_jax, sd_jax)
        reader = _rsm(RemoteStorageManager, store, keys, "tieredstorage_tpu_torch",
                      tmp_path / "rcache")
        md, index_type = md_port, IndexType
    else:
        writer_rsm = _rsm(RemoteStorageManager, store, keys, "tieredstorage_tpu_torch",
                          tmp_path / "wcache")
        writer_rsm.copy_log_segment_data(md_port, sd_port)
        reader = _rsm(JaxRemoteStorageManager, store, keys, "tieredstorage_tpu",
                      tmp_path / "rcache")
        md, index_type = md_jax, JaxIndexType
    try:
        _replay(reader, md, log)
        assert reader.fetch_index(md, index_type.OFFSET).read() == offset_index
        assert reader.readahead_manager.promotions > 0
        assert reader.readahead_manager.windows_launched > 0
        hot = reader.device_hot_cache
        assert hot.admissions + hot.rejections > 0  # windows reached the hot tier
        if writer == "jax":  # the port's reader: its chain and its disk cache
            assert isinstance(reader._chunk_manager, readahead.ReadaheadManager)
            assert list((tmp_path / "rcache" / "cache").iterdir())
    finally:
        reader.close()
        writer_rsm.close()


class _CountingStorage(FileSystemStorage):
    """Counts whole-object fetches by key suffix."""

    fetches: dict = {}

    def fetch(self, key, byte_range=None):
        suffix = key.value.rsplit(".", 1)[-1]
        _CountingStorage.fetches[suffix] = _CountingStorage.fetches.get(suffix, 0) + 1
        return super().fetch(key, byte_range)


def test_manifest_and_indexes_are_loaded_once(tmp_path, keys):
    store = tmp_path / "store"
    store.mkdir()
    md, sd, log, offset_index = _segment(tmp_path, metadata)
    _CountingStorage.fetches = {}
    pub, priv = keys
    rsm = RemoteStorageManager()
    rsm.configure({
        "storage.backend.class": _CountingStorage, "storage.root": str(store),
        "chunk.size": SEG_CHUNK, "transform.device": "cpu", "encryption.enabled": True,
        "encryption.key.pair.id": "k", "encryption.key.pairs": "k",
        "encryption.key.pairs.k.public.key.file": str(pub),
        "encryption.key.pairs.k.private.key.file": str(priv),
    })
    try:
        rsm.copy_log_segment_data(md, sd)
        rng = np.random.default_rng(4)
        for start in rng.integers(0, SEG_SIZE - 1000, 8):
            with rsm.fetch_log_segment(md, int(start), int(start) + 999) as stream:
                assert stream.read() == log[int(start) : int(start) + 1000]
        for _ in range(3):
            assert rsm.fetch_index(md, IndexType.OFFSET).read() == offset_index
        assert _CountingStorage.fetches["rsm-manifest"] == 1
        assert _CountingStorage.fetches["indexes"] == 1
        assert _CountingStorage.fetches["log"] >= 8
        # No chunk cache, hot tier or readahead unless configured.
        assert isinstance(rsm._chunk_manager, DefaultChunkManager)
        assert rsm.device_hot_cache is None and rsm.readahead_manager is None
    finally:
        rsm.close()


def test_expired_deadline_fails_before_the_storage_read(tmp_path, keys):
    rsm = _rsm(RemoteStorageManager, tmp_path, keys, "tieredstorage_tpu_torch",
               tmp_path / "cache", {"readahead.enabled": False})
    md, sd, _, _ = _segment(tmp_path, metadata)
    try:
        rsm.copy_log_segment_data(md, sd)
        # At the RSM entry, which checks the ambient deadline first.
        with deadline_scope(Deadline.after(-1.0)):
            with pytest.raises(DeadlineExceededException, match="before rsm.fetch_log_segment"):
                rsm.fetch_log_segment(md, 0, 99)
        # Past the entry, in the lazy drain: the chunk cache's window read.
        with rsm.fetch_log_segment(md, 0, 99) as stream:
            with deadline_scope(Deadline.after(-1.0)):
                with pytest.raises(DeadlineExceededException, match="cache window read"):
                    stream.read()
    finally:
        rsm.close()


def test_segment_successor_continues_readahead_into_the_next_segment(tmp_path, keys):
    """A replay crossing a segment end: the readahead resolves the next
    segment's manifest through the lookahead (once) and speculates its first
    window before the consumer asks."""
    store = tmp_path / "store"
    store.mkdir()
    rsm = _rsm(RemoteStorageManager, store, keys, "tieredstorage_tpu_torch", tmp_path / "c",
               {"fetch.chunk.cache.prefetch.max.size": 0})
    segments = []
    for n in range(2):
        (tmp_path / f"s{n}").mkdir()
        md, sd, log, _ = _segment(tmp_path / f"s{n}", metadata)
        seg_id = metadata.RemoteLogSegmentId(
            md.remote_log_segment_id.topic_id_partition, metadata.KafkaUuid(bytes([n + 3]) * 16))
        md = metadata.RemoteLogSegmentMetadata(
            remote_log_segment_id=seg_id, start_offset=23 + 5000 * n,
            end_offset=4999 + 5000 * n, segment_size_in_bytes=SEG_SIZE)
        rsm.copy_log_segment_data(md, sd)
        segments.append((md, log))
    keys_ = [ObjectKeyFactory("test/", False).key(md, Suffix.LOG) for md, _ in segments]
    rsm.set_segment_successor(lambda key: keys_[1] if key == keys_[0] else None)
    try:
        md, log = segments[0]
        for start in range(0, SEG_SIZE, SEG_CHUNK):
            with rsm.fetch_log_segment(md, start, min(start + SEG_CHUNK, SEG_SIZE) - 1) as stream:
                assert stream.read() == log[start : start + SEG_CHUNK]
        manager = rsm.readahead_manager
        deadline = time.monotonic() + 60
        while manager.cross_segment_continuations == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert manager.cross_segment_continuations == 1
        assert rsm.manifest_lookahead.launches == 1
        md, log = segments[1]
        with rsm.fetch_log_segment(md, 0) as stream:
            assert stream.read() == log
    finally:
        rsm.close()
    plain = _rsm(RemoteStorageManager, store, keys, "tieredstorage_tpu_torch", tmp_path / "d",
                 {"readahead.enabled": False})
    with pytest.raises(Exception, match="readahead is not enabled"):
        plain.set_segment_successor(lambda key: None)
    plain.close()


# ---------------------------------------------------------------- retention
def test_hot_window_survives_later_windows_of_its_shape(tmp_path, keys):
    """The retention probe: a window admitted to the hot tier keeps its
    plaintext after more windows of the same shape (one 64 KiB row each)
    were decrypted through the same staging pool; its third read makes no
    GCM launch."""
    store = tmp_path / "store"
    store.mkdir()
    md, sd, log, _ = _segment(tmp_path, metadata)
    rsm = _rsm(
        RemoteStorageManager, store, keys, "tieredstorage_tpu_torch", tmp_path / "c",
        {"readahead.enabled": False, "cache.device.bytes": 4 * (SEG_CHUNK + 16) * 2},
        drop=("fetch.chunk.cache.class",),
    )
    hot = rsm.device_hot_cache
    log_key = ObjectKeyFactory("test/", False).key(md, Suffix.LOG)
    try:
        rsm.copy_log_segment_data(md, sd)
        for _ in range(2):  # first touch decrypts, the second admits
            with rsm.fetch_log_segment(md, 0, 99) as stream:
                assert stream.read() == log[:100]
        assert hot.admissions == 1 and hot.device_windows == 1
        for cid in (1, 2, 3):  # three more one-row windows of the same shape
            with rsm.fetch_log_segment(md, cid * SEG_CHUNK, cid * SEG_CHUNK + 99) as stream:
                assert stream.read() == log[cid * SEG_CHUNK : cid * SEG_CHUNK + 100]
        [row] = hot.device_rows(log_key, [0])
        assert row.shape == (SEG_CHUNK + 16,)
        assert row[:SEG_CHUNK].numpy().tobytes() == log[:SEG_CHUNK]
        assert hot.resident_device_bytes == SEG_CHUNK + 16
        before = gcm.device_dispatches()
        with rsm.fetch_log_segment(md, 0, SEG_CHUNK - 1) as stream:
            assert stream.read() == log[:SEG_CHUNK]
        assert gcm.device_dispatches() == before
        assert hot.hits == 1
    finally:
        rsm.close()
