"""The port's scrub plane on the CPU against the JAX package's: CRC32C as
torch ops, the pipeline's upload checksums, the chunk manager's quarantine
hook, the scrubber and its scheduler, and the RSM wiring of `scrub.*`,
`retry.launch.*` and `upload.rate.limit.bytes.per.second`.

Segments are written by the RSMs of both packages over one filesystem store
(chunk.size=4096 with an odd tail, encryption on, checksums on); the port
runs with transform.device=cpu. The scheduler tests wait on events set by
the passes themselves, and the throttle test runs the token bucket on a
fake clock, so no test sleeps on wall-clock timing.
"""

from __future__ import annotations

import io
import threading
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_rsm import CHUNK, _configs, _write_segment
from tieredstorage_tpu import metadata as jax_metadata
from tieredstorage_tpu.fetch.chunk_manager import (
    CorruptChunkException as JaxCorruptChunkException,
)
from tieredstorage_tpu.fetch.chunk_manager import DefaultChunkManager as JaxChunkManager
from tieredstorage_tpu.ops import crc32c as jax_crc
from tieredstorage_tpu.rsm import RemoteStorageManager as JaxRemoteStorageManager
from tieredstorage_tpu.security.aes import DataKeyAndAAD as JaxDataKeyAndAAD
from tieredstorage_tpu.storage.core import ObjectKey as JaxObjectKey
from tieredstorage_tpu.transform.api import TransformOptions as JaxTransformOptions
from tieredstorage_tpu.transform.pipeline import SegmentTransformation as JaxTransformation
from tieredstorage_tpu.transform.tpu import TpuTransformBackend
from tieredstorage_tpu_torch import metadata
from tieredstorage_tpu_torch.fetch.chunk_manager import CorruptChunkException, DefaultChunkManager
from tieredstorage_tpu_torch.object_key import Suffix
from tieredstorage_tpu_torch.ops import crc32c
from tieredstorage_tpu_torch.ops.crc32c import (
    crc32c_batch,
    crc32c_chunks,
    crc32c_host,
    crc32c_reference,
)
from tieredstorage_tpu_torch.rsm import RemoteStorageManager
from tieredstorage_tpu_torch.scrub import ScrubScheduler, Scrubber
from tieredstorage_tpu_torch.scrub.scrubber import (
    CORRUPT_CHUNK,
    MANIFEST_UNREADABLE,
    MISSING_OBJECT,
    ORPHAN_OBJECT,
    OVERSIZED_OBJECT,
    TRUNCATED_OBJECT,
)
from tieredstorage_tpu_torch.security.aes import DataKeyAndAAD
from tieredstorage_tpu_torch.security.rsa import generate_key_pair_pem_files
from tieredstorage_tpu_torch.storage.core import ObjectKey
from tieredstorage_tpu_torch.storage.filesystem import FileSystemStorage
from tieredstorage_tpu_torch.transform.api import TransformOptions
from tieredstorage_tpu_torch.transform.cuda import CudaTransformBackend
from tieredstorage_tpu_torch.transform.pipeline import SegmentTransformation
from tieredstorage_tpu_torch.transform.scheduler import BACKGROUND
from tieredstorage_tpu_torch.utils import ratelimit
from tieredstorage_tpu_torch.utils.ratelimit import TokenBucket

PORT_FS = "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage"
JAX_FS = "tieredstorage_tpu.storage.filesystem.FileSystemStorage"
SCRUB = {
    "scrub.enabled": True,
    "scrub.interval.ms": 3_600_000,  # passes are driven by scrub_once()
    "scrub.rate.bytes": None,
    "scrub.checksums.enabled": True,
}


# ------------------------------------------------------------------ CRC32C


def test_check_values_and_host_table():
    assert crc32c_reference(b"123456789") == 0xE3069283
    assert crc32c_host(b"123456789") == 0xE3069283
    rng = np.random.default_rng(11)
    for n in (0, 1, 15, 16, 63, 1024):
        blob = rng.bytes(n)
        assert crc32c_host(blob) == crc32c_reference(blob) == jax_crc.crc32c_host(blob)


@pytest.mark.parametrize("chunk_bytes", [16, 64, 256, 1024, 4096 + 16])
def test_chunks_match_reference_and_jax(chunk_bytes):
    data = np.frombuffer(np.random.default_rng(chunk_bytes).bytes(3 * chunk_bytes),
                         np.uint8).reshape(3, chunk_bytes)
    got = crc32c_chunks(data, "cpu")
    assert list(got) == [crc32c_reference(row.tobytes()) for row in data]
    assert list(got) == list(jax_crc.crc32c_chunks(data))
    zeros = np.zeros((2, chunk_bytes), np.uint8)
    assert (crc32c_chunks(zeros, "cpu") == crc32c_reference(bytes(chunk_bytes))).all()


@pytest.mark.parametrize("sizes", [
    (0, 1, 15, 16, 17, 255, 1024, 1024, 4095),  # host table only
    (4096,) * 32,  # one aligned device group (32 x 4 KiB >= 64 KiB)
    (4100,) * 32,  # a left-padded device group
    (0, 100, 5000, 70_000, 70_000, 4100, 4100, 65_537),  # mixed: both paths
], ids=["small", "aligned", "left-padded", "mixed"])
def test_batch_matches_reference_and_jax(sizes):
    rng = np.random.default_rng(len(sizes) * 7 + sizes[-1])
    chunks = [rng.bytes(n) for n in sizes]
    got = crc32c_batch(chunks, "cpu")
    assert got == [crc32c_host(c) for c in chunks]
    assert got == jax_crc.crc32c_batch(chunks)


def test_slabbed_tree_matches_the_unslabbed_one(monkeypatch):
    """Slabs of 3 blocks cut every leaf and level pass mid-row, and 5 rows of
    9 blocks make odd counts on every level."""
    data = np.frombuffer(np.random.default_rng(5).bytes(5 * 144), np.uint8).reshape(5, 144)
    want = list(crc32c_chunks(data, "cpu"))
    monkeypatch.setattr(crc32c, "_SLAB_BLOCKS", 3)
    assert list(crc32c_chunks(data, "cpu")) == want == [crc32c_reference(r.tobytes()) for r in data]


def test_batch_edge_cases():
    assert crc32c_batch([], "cpu") == []
    blob = np.random.default_rng(4).bytes(2048)
    flipped = blob[:100] + bytes([blob[100] ^ 0x01]) + blob[101:]
    a, b = crc32c_batch([blob, flipped], "cpu")
    assert a != b
    with pytest.raises(ValueError, match="multiple of 16"):
        crc32c_chunks(np.zeros((1, 20), np.uint8), "cpu")


# ---------------------------------------------------- pipeline checksums


def _transform_both(chunk_size: int, data: bytes, encrypted: bool):
    """Both pipelines over the same chunks and IVs, one varlen window each."""
    rng = np.random.default_rng(len(data))
    key, aad = rng.bytes(32), rng.bytes(32)
    n = -(-len(data) // chunk_size)
    ivs = [rng.bytes(12) for _ in range(n)]
    port_opts = TransformOptions(encryption=DataKeyAndAAD(key, aad) if encrypted else None,
                                 ivs=ivs if encrypted else None)
    jax_opts = JaxTransformOptions(encryption=JaxDataKeyAndAAD(key, aad) if encrypted else None,
                                   ivs=ivs if encrypted else None)
    backend = CudaTransformBackend()
    backend.configure({"device": "cpu"})
    jax_backend = TpuTransformBackend()
    out = []
    for cls, be, opts in ((SegmentTransformation, backend, port_opts),
                          (JaxTransformation, jax_backend, jax_opts)):
        tr = cls(io.BytesIO(data), len(data), chunk_size, be, opts, collect_checksums=True)
        blob = tr.stream().read()
        out.append((blob, tr.chunk_checksums))
    off = SegmentTransformation(io.BytesIO(data), len(data), chunk_size, backend, port_opts)
    off.stream().read()
    assert off.chunk_checksums is None
    return out


@pytest.mark.parametrize("encrypted", [True, False], ids=["gcm", "identity"])
def test_pipeline_checksums_equal_jax(encrypted):
    data = np.random.default_rng(9).bytes(7 * 4096 + 333)
    (blob, sums), (jax_blob, jax_sums) = _transform_both(4096, data, encrypted)
    assert blob == jax_blob
    assert sums == jax_sums and len(sums) == 8
    stride = 4096 + (28 if encrypted else 0)
    assert sums == [crc32c_host(blob[i : i + stride]) for i in range(0, len(blob), stride)]


def test_checksums_complete_only_after_the_stream():
    backend = CudaTransformBackend()
    backend.configure({"device": "cpu"})
    tr = SegmentTransformation(io.BytesIO(b"x" * 100), 100, 64, backend,
                               TransformOptions(), collect_checksums=True)
    with pytest.raises(RuntimeError, match="not built"):
        tr.chunk_checksums  # noqa: B018
    tr.stream().read()
    assert tr.chunk_checksums == [crc32c_host(b"x" * 64), crc32c_host(b"x" * 36)]


# ------------------------------------------------------- quarantine hook


def test_quarantine_hook_matches_jax_under_a_fake_clock():
    clock = [0.0]
    now = lambda: clock[0]  # noqa: E731
    managers = [
        (DefaultChunkManager(None, None, quarantine_ttl_s=10.0, time_source=now),
         CorruptChunkException, ObjectKey),
        (JaxChunkManager(None, None, quarantine_ttl_s=10.0, time_source=now),
         JaxCorruptChunkException, JaxObjectKey),
    ]
    steps = [("q", "a", 0.0), ("check", "a", 1.0), ("check", "b", 2.0), ("q", "b", 3.0),
             ("check", "a", 10.0), ("check", "b", 12.9), ("check", "b", 13.0),
             ("q", "a", 14.0), ("q", "a", 15.0), ("check", "a", 24.9), ("check", "a", 25.0)]
    traces = []
    for cm, exc_type, key_type in managers:
        clock[0] = 0.0
        trace = []
        for op, name, t in steps:
            clock[0] = t
            key = key_type(f"seg/{name}.log")
            if op == "q":
                cm.quarantine(key, f"scrub: CRC32C mismatch on chunk {int(t)}")
                trace.append(("q", cm.quarantined_keys, cm.corruptions))
                continue
            try:
                cm._check_quarantine(key)
                trace.append(("ok", cm.quarantined_keys))
            except exc_type as e:
                trace.append(("refused", str(e), cm.quarantined_keys))
        traces.append(trace)
    assert traces[0] == traces[1]
    assert sum(1 for t in traces[0] if t[0] == "refused") == 3


# ---------------------------------------------------------------- stores


@pytest.fixture(scope="module")
def keys(tmp_path_factory):
    return generate_key_pair_pem_files(tmp_path_factory.mktemp("scrub-keys"), prefix="scrub")


def _port_rsm(store: Path, keys, extra=None) -> RemoteStorageManager:
    rsm = RemoteStorageManager()
    rsm.configure(_configs(store, keys, PORT_FS,
                           {"transform.device": "cpu", **SCRUB, **(extra or {})}))
    return rsm


def _jax_rsm(store: Path, keys, extra=None) -> JaxRemoteStorageManager:
    rsm = JaxRemoteStorageManager()
    rsm.configure(_configs(store, keys, JAX_FS, {**SCRUB, **(extra or {})}))
    return rsm


def _segment_files(root: Path, mod, seed: int):
    seg = root / f"seg-{seed}-{mod.__name__.split('.')[0]}"
    seg.mkdir()
    md, sd, contents = _write_segment(seg, mod, seed)
    rid = md.remote_log_segment_id
    md = type(md)(
        remote_log_segment_id=type(rid)(rid.topic_id_partition, mod.KafkaUuid(bytes([seed]) * 16)),
        start_offset=md.start_offset, end_offset=md.end_offset,
        segment_size_in_bytes=md.segment_size_in_bytes,
    )
    return md, sd, contents


def _store(tmp_path: Path, keys, writers) -> tuple[Path, list]:
    """One filesystem store with a segment per writer ("port" or "jax");
    returns the store and, per segment, (port metadata, contents)."""
    store = tmp_path / "store"
    store.mkdir()
    out = []
    for seed, writer in enumerate(writers, start=1):
        md, sd, contents = _segment_files(tmp_path, metadata, seed)
        jmd, jsd, _ = _segment_files(tmp_path, jax_metadata, seed)
        rsm = _port_rsm(store, keys) if writer == "port" else _jax_rsm(store, keys)
        rsm.copy_log_segment_data(md if writer == "port" else jmd, sd if writer == "port" else jsd)
        rsm.close()
        out.append((md, contents))
    return store, out


def _objects(store: Path, suffix: str) -> list[Path]:
    return sorted(store.rglob(f"*.{suffix}"))


def _flip(path: Path, pos: int) -> None:
    raw = bytearray(path.read_bytes())
    raw[pos] ^= 0xFF
    path.write_bytes(bytes(raw))


def _damage(store: Path) -> None:
    """A flipped byte in chunk 3 of the first .log, a truncated second .log,
    a missing third .indexes and an orphan."""
    logs = _objects(store, "log")
    _flip(logs[0], 3 * (CHUNK + 28) + 12 + 17)
    logs[1].write_bytes(logs[1].read_bytes()[: 2 * (CHUNK + 28) + 5])
    _objects(store, "indexes")[2].unlink()
    orphan = logs[0].parent / "orphan.part"
    orphan.write_bytes(b"debris")


def _report(rsm) -> dict:
    out = rsm.scrubber.scrub_once().to_json()
    del out["started_at"], out["duration_s"]
    return out


def test_scrub_report_equals_jax_on_a_damaged_store(tmp_path, keys):
    store, _ = _store(tmp_path, keys, ["port", "jax", "port", "jax"])
    port, jax = _port_rsm(store, keys), _jax_rsm(store, keys)
    clean = _report(port)
    assert clean["clean"] and clean["manifests"] == 4 and clean["chunks_verified"] == 24
    assert clean == _report(jax)
    _damage(store)
    got, want = _report(port), _report(jax)
    assert got == want
    assert got["counts"] == {CORRUPT_CHUNK: 1, TRUNCATED_OBJECT: 1, MISSING_OBJECT: 1,
                             ORPHAN_OBJECT: 1}
    [corrupt] = [f for f in got["findings"] if f["kind"] == CORRUPT_CHUNK]
    assert corrupt["chunk_id"] == 3 and "CRC32C mismatch" in corrupt["detail"]
    port.close()
    jax.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_scrubs_what_the_other_wrote(tmp_path, keys, writer):
    store, _ = _store(tmp_path, keys, [writer, writer])
    reader = _port_rsm(store, keys) if writer == "jax" else _jax_rsm(store, keys)
    report = reader.scrubber.scrub_once()
    assert report.clean and report.chunks_verified == 12
    _flip(_objects(store, "log")[1], 5 * (CHUNK + 28) + 40)  # the odd tail chunk
    [finding] = reader.scrubber.scrub_once().findings
    assert (finding.kind, finding.chunk_id) == (CORRUPT_CHUNK, 5)
    reader.close()


# ------------------------------------------------------ scrubber detection


@pytest.fixture
def uploaded(tmp_path, keys):
    """A port RSM with repair on over a store of two port-written segments
    (overwrite on, so a re-upload may replace a damaged object)."""
    store, segments = _store(tmp_path, keys, ["port", "port"])
    rsm = _port_rsm(store, keys, {"scrub.repair.enabled": True,
                                  "storage.overwrite.enabled": True})
    yield rsm, store, segments
    rsm.close()


def test_clean_store_scrubs_clean(uploaded):
    rsm, store, _ = uploaded
    report = rsm.scrubber.scrub_once()
    assert report.clean, report.to_json()
    assert (report.manifests, report.chunks_verified) == (2, 12)
    assert report.objects_listed == len([p for p in store.rglob("*") if p.is_file()])
    assert report.bytes_scanned > 2 * (5 * (CHUNK + 28) + 777 + 28)  # both logs and more


def test_corrupt_byte_is_pinned_to_its_chunk_and_quarantined(uploaded):
    rsm, store, segments = uploaded
    _flip(_objects(store, "log")[0], 2 * (CHUNK + 28) + 12 + 99)
    report = rsm.scrubber.scrub_once()
    [finding] = report.findings
    assert (finding.kind, finding.chunk_id, finding.repaired) == (CORRUPT_CHUNK, 2, False)
    inner = rsm._innermost_chunk_manager(rsm._chunk_manager)
    assert inner.quarantined_keys == 1
    md_bad = next(md for md, _ in segments if rsm._object_key(md, Suffix.LOG).value == finding.key)
    with pytest.raises(Exception) as info:
        with rsm.fetch_log_segment(md_bad, 0, 10) as stream:
            stream.read()
    cause = info.value.__cause__ or info.value
    assert isinstance(cause, CorruptChunkException) and "quarantined" in str(cause)
    md_ok, contents = next((md, c) for md, c in segments if md is not md_bad)
    with rsm.fetch_log_segment(md_ok, 0) as stream:
        assert stream.read() == contents["log"]


@pytest.mark.parametrize("damage,kind", [
    (lambda p: p.write_bytes(p.read_bytes()[:-10]), TRUNCATED_OBJECT),
    (lambda p: p.write_bytes(p.read_bytes() + b"EXTRA"), OVERSIZED_OBJECT),
    (lambda p: p.unlink(), MISSING_OBJECT),
    (lambda p: p.with_suffix(".rsm-manifest").write_bytes(b"{not json"), MANIFEST_UNREADABLE),
], ids=["truncated", "oversized", "missing", "unreadable-manifest"])
def test_damage_is_found_on_its_object_only(uploaded, damage, kind):
    """Each kind of damage to the first segment yields exactly that finding,
    on that segment alone: no false positive on the untouched one."""
    rsm, store, _ = uploaded
    first = _objects(store, "log")[0]
    rsm.scrubber.repair_source = None
    damage(first)
    report = rsm.scrubber.scrub_once()
    assert report.counts() == {kind: 1}, report.to_json()
    assert all(f.key.rsplit(".", 1)[0] == str(first.relative_to(store)).rsplit(".", 1)[0]
               for f in report.findings)


def test_orphans_are_cleaned_inside_the_prefix_only(uploaded):
    rsm, store, _ = uploaded
    inside = _objects(store, "log")[0].parent / "orphan.part"
    inside.write_bytes(b"debris")
    outside = store / "elsewhere" / "obj"
    outside.parent.mkdir()
    outside.write_bytes(b"other tenant")
    [orphan] = rsm.scrubber.scrub_once().findings
    assert orphan.kind == ORPHAN_OBJECT and orphan.repaired
    assert not inside.exists() and outside.exists()
    assert rsm.scrubber.scrub_once().clean


def test_repair_reuploads_from_source_and_next_pass_is_clean(uploaded):
    rsm, store, _ = uploaded
    shadow = {str(p.relative_to(store)): p.read_bytes() for p in store.rglob("*") if p.is_file()}
    rsm.scrubber.repair_source = lambda key: (
        io.BytesIO(shadow[key.value]) if key.value in shadow else None
    )
    logs = _objects(store, "log")
    logs[0].write_bytes(logs[0].read_bytes()[:10])
    logs[1].unlink()
    report = rsm.scrubber.scrub_once()
    assert report.repaired == len(report.findings) >= 2
    assert [p.read_bytes() for p in logs] == [shadow[str(p.relative_to(store))] for p in logs]
    assert rsm.scrubber.scrub_once().clean


def test_scrub_status_counters(uploaded):
    rsm, store, _ = uploaded
    rsm.scrubber.scrub_once()
    logs = _objects(store, "log")
    logs[0].write_bytes(logs[0].read_bytes()[:-1])
    rsm.scrubber.repair_source = None
    rsm.scrubber.scrub_once()
    status = rsm.scrub_status()
    assert status["enabled"] and status["passes"] == 2
    # The truncated log's one window fails whole: 12 + 6 chunks verified.
    assert status["findings_total"] == 1 and status["chunks_verified_total"] == 18
    assert status["last_pass"]["counts"] == {TRUNCATED_OBJECT: 1}
    assert "findings" not in status["last_pass"]


class _RejectingBackend:
    """Transform stub: detransform raises on any chunk containing POISON."""

    POISON = b"\xde\xad"

    def detransform(self, chunks, opts):
        for c in chunks:
            if self.POISON in c:
                raise ValueError("tag mismatch (stub)")
        return list(chunks)


@pytest.mark.parametrize("poison_chunk", [None, 2], ids=["clean", "poisoned"])
def test_detransform_failure_is_isolated_to_its_chunk(tmp_path, poison_chunk):
    from tieredstorage_tpu_torch.manifest.chunk_index import FixedSizeChunkIndex
    from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType, SegmentIndexesV1Builder
    from tieredstorage_tpu_torch.manifest.segment_manifest import SegmentManifestV1, manifest_to_json

    storage = FileSystemStorage()
    storage.configure({"root": str(tmp_path)})
    n_chunks, chunk = 4, 64
    data = bytearray(bytes(range(256)) * 2)[: n_chunks * chunk]
    if poison_chunk is not None:
        pos = poison_chunk * chunk + 5
        data[pos : pos + 2] = _RejectingBackend.POISON
    builder = SegmentIndexesV1Builder()
    for index_type in IndexType:
        builder.add(index_type, 0)
    manifest = SegmentManifestV1(
        chunk_index=FixedSizeChunkIndex(chunk, n_chunks * chunk, chunk, chunk),
        segment_indexes=builder.build(), compression=True,  # forces the round trip
    )
    storage.upload(io.BytesIO(bytes(data)), ObjectKey("s/0.log"))
    storage.upload(io.BytesIO(manifest_to_json(manifest).encode()), ObjectKey("s/0.rsm-manifest"))
    report = Scrubber(storage, transform_backend=_RejectingBackend(), device="cpu").scrub_once()
    assert [f.chunk_id for f in report.findings if f.kind == CORRUPT_CHUNK] == (
        [] if poison_chunk is None else [2])


# ---------------------------------------------------- throttle + scheduler


class _FakeTime:
    """`time` for the token bucket: sleep advances the clock."""

    def __init__(self) -> None:
        self.now = 100.0

    def monotonic(self) -> float:
        return self.now

    def sleep(self, s: float) -> None:
        self.now += s


def test_throttle_slices_oversized_batches(monkeypatch):
    """A 48 KiB batch behind a 16 KiB/s bucket: the burst covers the first
    16 KiB, the rest takes two seconds, in capacity slices (a single
    consume would clamp at capacity and under-throttle)."""
    fake = _FakeTime()
    monkeypatch.setattr(ratelimit, "time", fake)
    scrubber = Scrubber(FileSystemStorage(), rate_bucket=TokenBucket(16 * 1024), device="cpu")
    scrubber._throttle(48 * 1024)
    assert fake.now - 100.0 == pytest.approx(2.0)
    with pytest.raises(ValueError, match="at least"):
        TokenBucket(1024)


class _CountingScrubber(Scrubber):
    def __init__(self, target: int, fail: bool = False) -> None:
        super().__init__(FileSystemStorage(), device="cpu")
        self.reached = threading.Event()
        self._target, self._fail = target, fail

    def scrub_once(self):
        self.passes += 1
        if self.passes >= self._target:
            self.reached.set()
        if self._fail:
            raise RuntimeError("pass exploded")


@pytest.mark.parametrize("fail", [False, True], ids=["periodic", "survives-failure"])
def test_scheduler_runs_periodic_passes_and_stops(fail):
    scrubber = _CountingScrubber(3, fail)
    scheduler = ScrubScheduler(scrubber, interval_ms=1, jitter_seed=0).start()
    assert scrubber.reached.wait(timeout=30)
    status = scheduler.status()
    scheduler.stop()
    assert not scheduler._thread.is_alive()
    assert scheduler.status()["state"] == "stopped"
    settled = scrubber.passes
    assert settled >= 3 and scrubber.passes == settled
    assert ("pass exploded" in (status["last_error"] or "")) == fail


def test_run_now_skips_the_sleep_and_status_shape():
    scrubber = _CountingScrubber(1)
    scheduler = ScrubScheduler(scrubber, interval_ms=3_600_000, jitter_seed=1).start()
    try:
        scheduler.run_now()
        assert scrubber.reached.wait(timeout=30)
    finally:
        scheduler.stop()
    status = ScrubScheduler(Scrubber(FileSystemStorage(), device="cpu"), interval_ms=1000).status()
    assert {"state", "interval_ms", "passes", "findings_total", "repairs_total",
            "bytes_scanned_total", "chunks_verified_total"} <= set(status)
    assert status["state"] == "stopped" and "last_pass" not in status


# --------------------------------------------------------------- RSM wiring


def test_rsm_wires_batcher_retry_rate_and_quarantine(tmp_path, keys):
    store = tmp_path / "store"
    store.mkdir()
    rsm = _port_rsm(store, keys, {
        "transform.batch.enabled": True, "transform.batch.background.max.age.ms": 75,
        "scrub.rate.bytes": 1 << 20, "retry.launch.attempts": 3,
        "retry.launch.backoff.ms": 7, "upload.rate.limit.bytes.per.second": 2 << 20,
    })
    batcher = rsm.transform_backend.batcher
    assert batcher._class_rate[BACKGROUND] == float(1 << 20)
    assert batcher.background_max_age_ms == 75.0
    assert (batcher._launch_policy.max_attempts, batcher._launch_policy.base_backoff_s) == (3, 0.007)
    assert rsm.scrubber._rate_bucket.capacity == 1 << 20
    assert rsm._rate_bucket.capacity == 2 << 20
    inner = rsm._innermost_chunk_manager(rsm._chunk_manager)
    assert rsm.scrubber._quarantine == inner.quarantine
    assert rsm.scrub_status()["state"] == "idle"
    md, sd, contents = _segment_files(tmp_path, metadata, 1)
    rsm.copy_log_segment_data(md, sd)  # through the rate-limited upload
    report = rsm.scrubber.scrub_once()
    assert report.clean and report.chunks_verified == 6
    # The scrub's verification decrypts rode the background class.
    assert batcher.class_flushed_windows[BACKGROUND] >= 1
    with rsm.fetch_log_segment(md, 0) as stream:
        assert stream.read() == contents["log"]
    scheduler = rsm.scrub_scheduler
    rsm.close()
    assert scheduler.status()["state"] == "stopped"
    assert batcher._thread is None


def test_scrub_disabled_by_default(tmp_path, keys):
    rsm = RemoteStorageManager()
    rsm.configure(_configs(tmp_path, keys, PORT_FS, {"transform.device": "cpu"}))
    assert rsm.scrubber is None and rsm.scrub_scheduler is None
    assert rsm.scrub_status() == {"enabled": False}
    md, sd, _ = _segment_files(tmp_path, metadata, 2)
    rsm.copy_log_segment_data(md, sd)
    [manifest] = (tmp_path).rglob("*.rsm-manifest")
    assert "chunkChecksums" not in manifest.read_text()
    rsm.close()
