"""CudaTransformBackend (on the CPU) against the JAX package's TpuTransformBackend.

Same chunks, same fixed IVs, same key: the wire bytes must be identical and
must read back through either backend. The port's backend runs with
device="cpu", where every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from cryptography.hazmat.primitives.ciphers.aead import AESGCM

from tieredstorage_tpu.security.aes import DataKeyAndAAD as JaxDataKeyAndAAD
from tieredstorage_tpu.transform.api import DetransformOptions as JaxDetransformOptions
from tieredstorage_tpu.transform.api import TransformOptions as JaxTransformOptions
from tieredstorage_tpu.transform.tpu import TpuTransformBackend
from tieredstorage_tpu_torch.config.configdef import ConfigException
from tieredstorage_tpu_torch.ops import gcm
from tieredstorage_tpu_torch.security.aes import DataKeyAndAAD
from tieredstorage_tpu_torch.transform.api import (
    AuthenticationError,
    DetransformOptions,
    TransformOptions,
)
from tieredstorage_tpu_torch.transform.cuda import CudaTransformBackend
from tieredstorage_tpu_torch.utils.tracing import Tracer


def _inputs(seed: int, sizes: list[int]):
    rng = np.random.default_rng(seed)
    key, aad = rng.bytes(32), rng.bytes(32)
    chunks = [rng.bytes(n) for n in sizes]
    ivs = [rng.bytes(12) for _ in sizes]
    return key, aad, chunks, ivs


def _cpu_backend(**configs) -> CudaTransformBackend:
    backend = CudaTransformBackend()
    backend.configure({"device": "cpu", **configs})
    return backend


def test_transform_matches_tpu_backend_and_cross_reads():
    """Two fixed windows, then a varlen one (a short final chunk); the
    whole-list detransform is one varlen window on both sides."""
    sizes = [4096] * 5 + [1000]
    key, aad, chunks, ivs = _inputs(len(sizes), sizes)
    jax_backend = TpuTransformBackend()
    jax_backend.preferred_batch_chunks = 2
    ours = _cpu_backend(**{"batch.chunks": 2})
    windows = [chunks[i : i + 2] for i in range(0, len(chunks), 2)]

    want = [
        c for w in jax_backend.transform_windows(
            windows, JaxTransformOptions(encryption=JaxDataKeyAndAAD(key, aad), ivs=ivs)
        ) for c in w
    ]
    got = [
        c for w in ours.transform_windows(
            windows, TransformOptions(encryption=DataKeyAndAAD(key, aad), ivs=ivs)
        ) for c in w
    ]
    assert got == want
    assert ours.dispatch_stats.windows == len(windows)
    assert ours.dispatch_stats.donated_buffers == len(windows)
    assert ours.dispatch_stats.dispatches_per_window == 1.0

    assert ours.detransform(want, DetransformOptions(encryption=DataKeyAndAAD(key, aad))) == chunks
    assert jax_backend.detransform(
        got, JaxDetransformOptions(encryption=JaxDataKeyAndAAD(key, aad))
    ) == chunks


def test_tampered_tag_raises_authentication_error():
    key, aad, chunks, ivs = _inputs(7, [4096, 4096])
    ours = _cpu_backend()
    enc = DataKeyAndAAD(key, aad)
    stored = ours.transform(chunks, TransformOptions(encryption=enc, ivs=ivs))
    bad = bytearray(stored[1])
    bad[-1] ^= 0x80
    with pytest.raises(AuthenticationError, match=r"chunks \[1\]"):
        ours.detransform([stored[0], bytes(bad)], DetransformOptions(encryption=enc))
    flipped = bytearray(stored[0])
    flipped[100] ^= 0x01
    with pytest.raises(AuthenticationError):
        ours.detransform([bytes(flipped)], DetransformOptions(encryption=enc))


def test_staging_buffers_are_reused_across_windows():
    key, aad, chunks, ivs = _inputs(8, [4096] * 8)
    ours = _cpu_backend(**{"batch.chunks": 2})
    windows = [chunks[i : i + 2] for i in range(0, len(chunks), 2)]
    opts = TransformOptions(encryption=DataKeyAndAAD(key, aad), ivs=ivs)
    list(ours.transform_windows(windows, opts))
    first = ours._staging.allocations
    list(ours.transform_windows(windows, opts))
    assert ours._staging.allocations == first  # the second pass allocates nothing
    assert first <= ours.pipeline_depth + 1


def test_warm_up_pools_a_chunk_buffer_and_leaves_the_stats_as_they_were():
    key, aad, chunks, ivs = _inputs(12, [4096] * 3)
    ours = _cpu_backend(**{"batch.enabled": "true"})
    enc = DataKeyAndAAD(key, aad)
    stored = ours.transform(chunks, TransformOptions(encryption=enc, ivs=ivs))
    before, allocations = ours.dispatch_stats.as_dict(), ours._staging.allocations
    submitted = ours.batcher.windows_submitted
    ours.warm_up(4096)
    assert ours.dispatch_stats.as_dict() == before
    assert ours.batcher.windows_submitted == submitted  # the direct path
    assert ours._staging.allocations == allocations + 1
    assert len(ours._staging._free[(1, 4096 + 16)]) == 1
    ours.warm_up(4096)
    assert ours._staging.allocations == allocations + 1  # pooled
    assert ours.detransform(stored, DetransformOptions(encryption=enc)) == chunks
    ours.close()


@pytest.mark.parametrize(
    "configs,match",
    [({"batch.enabled": "true", "batch.windows": 1}, "at least 2"),
     ({"mesh.devices": -1}, "mesh.devices: Value must be at least 0")],
    ids=["batch", "mesh"],
)
def test_unported_backend_options_are_refused(configs, match):
    with pytest.raises(ConfigException, match=match):
        CudaTransformBackend().configure({"device": "cpu", **configs})


def test_batch_enabled_starts_a_batcher_and_close_stops_it():
    backend = CudaTransformBackend()
    backend.configure({"device": "cpu", "batch.enabled": "true", "batch.wait.ms": 3,
                       "batch.windows": 5})
    batcher = backend.batcher
    assert batcher is not None and batcher._thread.is_alive()
    assert (batcher.wait_ms, batcher.max_windows) == (3.0, 5)
    key, aad, chunks, ivs = _inputs(10, [4096, 4096, 100])
    enc = DataKeyAndAAD(key, aad)
    stored = backend.transform(chunks, TransformOptions(encryption=enc, ivs=ivs))
    assert backend.detransform(stored, DetransformOptions(encryption=enc)) == chunks
    assert batcher.fast_path_windows == 2  # serial calls take the idle fast path
    backend.close()
    assert backend.batcher is None and batcher._thread is None


def test_default_device_without_gpu_raises_at_configure(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CudaTransformBackend().configure({})


def test_identity_and_compression_paths():
    key, aad, chunks, _ = _inputs(9, [4096, 100])
    ours = _cpu_backend()
    assert ours.transform(chunks, TransformOptions()) == chunks
    with pytest.raises(ValueError, match="'lz4' not implemented"):
        ours.transform(chunks, TransformOptions(compression=True, compression_codec="lz4"))
    huff = TransformOptions(compression=True, compression_codec="tpu-huff-v1",
                            encryption=DataKeyAndAAD(key, aad))
    assert ours.detransform(ours.transform(chunks, huff), DetransformOptions(
        compression=True, compression_codec="tpu-huff-v1", encryption=DataKeyAndAAD(key, aad),
        max_original_chunk_size=4096,
    )) == chunks
    pytest.importorskip("zstandard")
    opts = TransformOptions(compression=True, encryption=DataKeyAndAAD(key, aad))
    stored = ours.transform(chunks, opts)
    back = ours.detransform(stored, DetransformOptions(
        compression=True, encryption=DataKeyAndAAD(key, aad), max_original_chunk_size=4096,
    ))
    assert back == chunks


def _oracle_encrypt(key: bytes, aad: bytes, chunks: list[bytes], rng) -> list[bytes]:
    """Wire chunks (IV || ct || tag) from the host AES-GCM oracle, so no
    context of the port is built before the threads below start."""
    out = []
    for chunk in chunks:
        iv = rng.bytes(12)
        out.append(iv + AESGCM(key).encrypt(iv, chunk, aad))
    return out


def test_device_dispatches_counts_launches_on_pool_threads():
    """The process-wide count sees a pool thread's window; the calling
    thread's own count does not."""
    rng = np.random.default_rng(21)
    key, aad = rng.bytes(32), rng.bytes(32)
    chunks = [rng.bytes(2048), rng.bytes(2048)]
    stored = _oracle_encrypt(key, aad, chunks, rng)
    ours = _cpu_backend()
    opts = DetransformOptions(encryption=DataKeyAndAAD(key, aad))
    total, mine = gcm.device_dispatches(), gcm.thread_dispatches()
    with ThreadPoolExecutor(max_workers=1) as pool:
        assert pool.submit(ours.detransform, stored, opts).result(timeout=60) == chunks
    assert gcm.device_dispatches() == total + 1
    assert gcm.thread_dispatches() == mine
    assert ours.detransform(stored, opts) == chunks
    assert gcm.device_dispatches() == total + 2
    assert gcm.thread_dispatches() == mine + 1


def test_concurrent_detransform_is_byte_exact():
    """8 threads detransform at once through one backend: two keys shared by
    all threads and one key per thread, every context first built under
    contention, fixed and varlen windows of one shape in the staging pool.
    Every plaintext must come back exactly and every window be counted."""
    threads, rounds = 8, 3
    rng = np.random.default_rng(22)
    shared = [(rng.bytes(32), rng.bytes(32)) for _ in range(2)]
    jobs = []
    for t in range(threads):
        keys = shared + [(rng.bytes(32), rng.bytes(32))]
        for r in range(rounds):
            key, aad = keys[(t + r) % len(keys)]
            sizes = [1024, 1024] if (t + r) % 2 else [1024, 600]
            chunks = [rng.bytes(n) for n in sizes]
            jobs.append((t, key, aad, chunks, _oracle_encrypt(key, aad, chunks, rng)))
    ours = _cpu_backend()
    barrier = threading.Barrier(threads)
    errors: list = []

    def worker(t: int) -> int:
        barrier.wait(timeout=60)
        done = 0
        for owner, key, aad, chunks, stored in jobs:
            if owner != t:
                continue
            got = ours.detransform(stored, DetransformOptions(encryption=DataKeyAndAAD(key, aad)))
            if got != chunks:
                errors.append((t, len(chunks)))
            done += 1
        return done

    before = gcm.device_dispatches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=threads) as pool:
            done = [f.result(timeout=300) for f in [pool.submit(worker, t) for t in range(threads)]]
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    assert sum(done) == len(jobs)
    assert gcm.device_dispatches() - before == len(jobs)
    assert ours.dispatch_stats.windows == len(jobs)
    assert ours.dispatch_stats.d2h_fetches == len(jobs)


# --------------------------------------------------- spans of the window path
def _traced_backend(**configs) -> CudaTransformBackend:
    backend = _cpu_backend(**configs)
    backend.tracer = Tracer(enabled=True)
    return backend


def _parent_names(tracer) -> dict[str, list]:
    """Each span's name -> the names of its parents, in ring order."""
    spans = tracer.spans()
    name_of = {s.span_id: s.name for s in spans}
    out: dict[str, list] = {}
    for s in spans:
        out.setdefault(s.name, []).append(name_of.get(s.parent_id))
    return out


def _one(tracer, name):
    (span,) = tracer.spans(name)
    return span


@pytest.mark.parametrize("sizes", [[4096] * 3, [4096, 4096, 1000]], ids=["fixed", "varlen"])
def test_encrypt_window_spans_nest_under_their_stage_spans(sizes):
    """One window: the context, the staging and the launch inside
    `transform.encrypt_dispatch`, the wait and the wire assembly inside
    `transform.encrypt_finish`, each once, with its attributes; a second
    window under the same key and shape builds no context and allocates no
    staging buffer."""
    _, _, chunks, _ = _inputs(31, sizes)
    enc = DataKeyAndAAD(os.urandom(32), b"aad")  # a key no cache holds
    ours = _traced_backend()
    wire = ours.transform(chunks, TransformOptions(encryption=enc))
    tracer = ours.tracer
    parents = _parent_names(tracer)
    for name in ("gcm.context", "transform.stage", "transform.launch"):
        assert parents[name] == ["transform.encrypt_dispatch"], name
    for name in ("transform.wait", "transform.assemble"):
        assert parents[name] == ["transform.encrypt_finish"], name
    varlen = len(set(sizes)) > 1
    n_bytes = gcm.bucket_max_bytes(max(sizes)) if varlen else sizes[0]
    context = _one(tracer, "gcm.context").attributes
    assert {k: context[k] for k in ("built", "varlen", "bytes")} == {
        "built": 1, "varlen": int(varlen), "bytes": n_bytes}
    stage = _one(tracer, "transform.stage").attributes
    assert {k: stage[k] for k in ("allocated", "rows", "bytes")} == {
        "allocated": 1, "rows": len(sizes), "bytes": sum(sizes)}
    assert _one(tracer, "transform.launch").attributes["rows"] == len(sizes)
    assemble = _one(tracer, "transform.assemble").attributes
    assert (assemble["chunks"], assemble["bytes"]) == (len(sizes), sum(len(c) for c in wire))
    for s in tracer.spans():
        assert 0.0 <= s.attributes["cpu_s"], s.name

    tracer.clear()
    ours.transform(chunks, TransformOptions(encryption=enc))
    assert _one(tracer, "gcm.context").attributes["built"] == 0
    assert _one(tracer, "transform.stage").attributes["allocated"] == 0
    assert ours.detransform(wire, DetransformOptions(encryption=enc)) == chunks


def test_decrypt_window_spans_and_decompress_apart_from_decrypt():
    """A compressed and encrypted window read back: the context, staging,
    launch and wait inside `transform.decrypt` (no wire assembly), and
    `transform.decompress` beside it, not inside it."""
    rng = np.random.default_rng(32)
    chunks = [bytes(rng.integers(0, 4, 3000, dtype=np.uint8)) for _ in range(3)]
    enc = DataKeyAndAAD(rng.bytes(32), b"aad")
    ours = _traced_backend()
    wire = ours.transform(chunks, TransformOptions(compression=True, encryption=enc))
    ours.tracer.clear()
    back = ours.detransform(wire, DetransformOptions(
        compression=True, encryption=enc, max_original_chunk_size=3000))
    assert back == chunks
    parents = _parent_names(ours.tracer)
    for name in ("gcm.context", "transform.stage", "transform.launch", "transform.wait"):
        assert parents[name] == ["transform.decrypt"], name
    assert "transform.assemble" not in parents
    assert parents["transform.decompress"] == [None] and parents["transform.decrypt"] == [None]
    decompress = _one(ours.tracer, "transform.decompress").attributes
    assert (decompress["chunks"], decompress["bytes_out"]) == (3, 9000)
    assert decompress["bytes_in"] == _one(ours.tracer, "transform.decrypt").attributes["bytes_out"]
    assert decompress["cpu_s"] >= 0.0


def test_batched_flush_opens_the_same_spans():
    """Two encrypt windows merged into one flush by the batcher: one
    context, staging, launch, wait and wire assembly for the flush."""
    from tieredstorage_tpu_torch.transform.batcher import WindowBatcher

    ours = _traced_backend()
    b = WindowBatcher(ours)
    b._inflight += 1  # the fast path parked: both windows queue
    enc = DataKeyAndAAD(os.urandom(32), b"aad")
    _, _, chunks, _ = _inputs(33, [4096, 4096, 2048, 4096])
    opts = TransformOptions(encryption=enc)
    handles = [b.submit_encrypt(chunks[:2], opts), b.submit_encrypt(chunks[2:], opts)]
    assert b.flush_now() == 1
    wire = [c for h in handles for c in h.wait()]
    names = [s.name for s in ours.tracer.spans()]
    for name in ("gcm.context", "transform.stage", "transform.launch", "transform.wait",
                 "transform.assemble"):
        assert names.count(name) == 1, name
    assert _one(ours.tracer, "gcm.context").attributes["built"] == 1
    stage = _one(ours.tracer, "transform.stage").attributes
    assert (stage["allocated"], stage["rows"], stage["bytes"]) == (1, 4, sum(map(len, chunks)))
    assemble = _one(ours.tracer, "transform.assemble").attributes
    assert (assemble["chunks"], assemble["bytes"]) == (4, sum(map(len, wire)))
    assert ours.detransform(wire, DetransformOptions(encryption=enc)) == chunks


def test_disabled_tracer_computes_nothing_on_the_window_path(monkeypatch):
    """With the tracer off a window reaches neither the tracer's lock nor
    the thread clock: the spans cost their disabled `span()` calls alone."""

    class Poison:
        def __enter__(self):
            raise AssertionError("a disabled tracer took its lock")

        def __exit__(self, *exc):  # pragma: no cover - never entered
            return False

    def refuse(*args):
        raise AssertionError("a disabled tracer read a clock")

    # The backend's one zstd worker is started before the poison: a thread
    # reads its native id as it starts. The window itself stays cold.
    monkeypatch.setattr("tieredstorage_tpu_torch.transform.cuda.usable_cpus", lambda: 1)
    ours = _cpu_backend()
    ours._zstd_pool().submit(int).result()
    ours.tracer = Tracer(enabled=False)
    ours.tracer._lock = Poison()
    monkeypatch.setattr(time, "thread_time", refuse)
    monkeypatch.setattr(threading, "get_native_id", refuse)
    rng = np.random.default_rng(34)
    chunks = [bytes(rng.integers(0, 4, 2000, dtype=np.uint8)) for _ in range(2)]
    enc = DataKeyAndAAD(rng.bytes(32), b"")
    wire = ours.transform(chunks, TransformOptions(compression=True, encryption=enc))
    assert ours.detransform(wire, DetransformOptions(
        compression=True, encryption=enc, max_original_chunk_size=2000)) == chunks


def test_context_cache_keeps_the_64_most_recently_used():
    """The lookup says whether it built; a hit refreshes a key's recency,
    and the 65th distinct key evicts the least recently used one."""
    key = os.urandom(32)
    first, built = gcm.lookup_context(key, b"", 16)
    assert built and gcm.lookup_context(key, b"", 16) == (first, False)
    for n in range(2, 65):
        assert gcm.lookup_context(key, b"", 16 * n)[1]
    assert gcm.lookup_context(key, b"", 16) == (first, False)  # now the newest
    assert gcm.lookup_context(key, b"", 16 * 65)[1]           # evicts 16 * 2
    assert gcm.lookup_context(key, b"", 16) == (first, False)
    assert gcm.lookup_context(key, b"", 32)[1]
    assert gcm.make_context(key, b"", 16) is first


def test_context_cache_hands_every_thread_one_context():
    """Threads that miss one key at once each report their build, and all
    get the one context the cache kept."""
    key = os.urandom(32)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=8) as pool:
            got = list(pool.map(lambda _: gcm.lookup_varlen_context(key, b"a", 3000), range(32)))
    finally:
        sys.setswitchinterval(switch)
    assert len({id(ctx) for ctx, _ in got}) == 1
    assert 1 <= sum(built for _, built in got) <= 8
    assert gcm.lookup_varlen_context(key, b"a", 3000) == (got[0][0], False)


# ------------------------------------------- host zstd one window ahead
from tieredstorage_tpu_torch import native  # noqa: E402
from tieredstorage_tpu_torch.transform import cuda as cuda_backend  # noqa: E402
from tieredstorage_tpu_torch.transform import host_zstd  # noqa: E402


@pytest.fixture
def native_zstd():
    if native.load() is None:
        pytest.skip(f"native transform library unavailable: {native.load_error()}")


def _windows(seed: int, n_windows: int, per: int = 4, size: int = 20000):
    rng = np.random.default_rng(seed)
    return [[bytes([w, c]) + rng.integers(0, 8, size, dtype=np.uint8).tobytes()
             for c in range(per)] for w in range(n_windows)]


def _wire_reference(windows, key, aad, ivs, level=3):
    """The synchronous path: the batch call's frames, sealed by `cryptography`."""
    frames = [f for w in windows for f in native.zstd_compress_batch(w, level=level)]
    return [iv + AESGCM(key).encrypt(iv, f, aad) for iv, f in zip(ivs, frames)]


class _Calls:
    """`native.zstd_compress_into` counted: calls by window tag, and the
    most that ran at once."""

    def __init__(self, monkeypatch, gate=None):
        self.lock = threading.Lock()
        self.running = self.most = 0
        self.tags: list = []
        self.entered = threading.Semaphore(0)
        inner = native.zstd_compress_into

        def counted(chunk, *args):
            tag = bytes(chunk[:1])
            with self.lock:
                self.running += 1
                self.most = max(self.most, self.running)
                self.tags.append(tag)
            try:
                self.entered.release()
                if gate is not None and gate[0](tag):
                    assert gate[1].wait(30)
                return inner(chunk, *args)
            finally:
                with self.lock:
                    self.running -= 1

        monkeypatch.setattr(native, "zstd_compress_into", counted)


def test_compressed_windows_record_their_wait_and_the_worker_count(native_zstd, monkeypatch):
    monkeypatch.setattr(cuda_backend, "usable_cpus", lambda: 4)
    ours = _cpu_backend()
    ours.tracer = Tracer(enabled=True)
    windows = _windows(40, 3)
    rng = np.random.default_rng(40)
    key, ivs = rng.bytes(32), [rng.bytes(12) for _ in range(12)]
    opts = TransformOptions(compression=True, encryption=DataKeyAndAAD(key, b""), ivs=ivs)
    wire = [c for w in ours.transform_windows(iter(windows), opts) for c in w]
    assert wire == _wire_reference(windows, key, b"", ivs)
    waits = ours.tracer.spans("transform.compress_wait")
    assert [s.attributes["ahead"] for s in waits] == [0, 1, 1]
    assert all(s.attributes["ready"] in (0, 1) and "cpu_s" in s.attributes for s in waits)
    spans = ours.tracer.spans("transform.compress")
    assert len(spans) == 3 and {s.attributes["workers"] for s in spans} == {3}
    assert all(s.attributes["cpu_s"] >= 0 and s.duration_s > 0 for s in spans)
    assert sorted(s.attributes["bytes_in"] for s in spans) == [sum(map(len, w)) for w in windows]
    assert sum(s.attributes["bytes_out"] for s in spans) == sum(len(c) - 28 for c in wire)
    assert all(s.attributes["chunks"] == 4 for s in spans)
    ours.close()


@pytest.mark.parametrize("failing", [1, 2])
def test_a_failing_window_raises_its_error_when_it_is_reached(native_zstd, monkeypatch, failing):
    """Window k+1's compression fails while window k is sealed: the
    backend's NativeTransformError surfaces at window k+1's turn, after
    window k was dispatched and before window k+1 was."""
    inner = native.zstd_compress_into

    def failing_window(chunk, level, out, offset, capacity):
        if bytes(chunk[:1]) == bytes([failing]):
            return inner(chunk, level, out, offset, 8)  # too small for any frame
        return inner(chunk, level, out, offset, capacity)

    monkeypatch.setattr(native, "zstd_compress_into", failing_window)
    ours = _cpu_backend(**{"pipeline.depth": 1})
    windows = _windows(41, 4)
    opts = TransformOptions(compression=True, encryption=DataKeyAndAAD(os.urandom(32), b""))
    gen = ours.transform_windows(iter(windows), opts)
    got = []
    with pytest.raises(native.NativeTransformError, match="zstd compress failed on chunk 0"):
        for w in gen:
            got.append(w)
    assert ours.dispatch_stats.windows == failing and len(got) == failing - 1


def test_a_missing_codec_raises_jaxs_error_at_the_first_window(monkeypatch):
    monkeypatch.setattr(CudaTransformBackend, "_use_native", staticmethod(lambda: False))
    monkeypatch.setattr(cuda_backend, "zstandard", None)
    ours = _cpu_backend()
    opts = TransformOptions(compression=True, encryption=DataKeyAndAAD(os.urandom(32), b""))
    with pytest.raises(ModuleNotFoundError, match="'zstandard' package is required"):
        list(ours.transform_windows(iter(_windows(42, 3)), opts))
    assert ours.dispatch_stats.windows == 0


def test_closing_after_the_first_window_leaves_no_worker_task(native_zstd, monkeypatch):
    """The copy is closed while window 2's chunks are compressing on both
    workers: the close waits for those two, drops the two no worker began,
    and afterwards no task of any window is queued or running."""
    monkeypatch.setattr(cuda_backend, "usable_cpus", lambda: 3)
    gate = threading.Event()
    calls = _Calls(monkeypatch, gate=(lambda tag: tag == b"\x02", gate))
    made: list = []
    init = host_zstd.WindowCompression.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)

    monkeypatch.setattr(host_zstd.WindowCompression, "__init__", record)
    ours = _cpu_backend(**{"pipeline.depth": 1})
    opts = TransformOptions(compression=True, encryption=DataKeyAndAAD(os.urandom(32), b""))
    gen = ours.transform_windows(iter(_windows(43, 4)), opts)
    assert len(next(gen)) == 4  # window 0, sealed while window 2 compresses
    assert len(made) == 3
    while calls.tags.count(b"\x02") < 2:  # both workers are inside window 2
        assert calls.entered.acquire(timeout=30)
    closer = threading.Thread(target=gen.close)
    closer.start()
    closer.join(timeout=0.3)
    assert closer.is_alive()  # it waits for the two chunks begun
    gate.set()
    closer.join(timeout=30)
    assert not closer.is_alive()
    time.sleep(0.1)
    assert calls.running == 0 and calls.tags.count(b"\x02") == 2
    assert b"\x03" not in calls.tags  # window 3 was never read
    for compression in made:
        assert all(f.done() for f in compression._frames)
    ours.close()


def test_concurrent_copies_share_the_bounded_workers(native_zstd, monkeypatch):
    """More concurrent copies than workers, under a short switch interval:
    every copy's wire chunks are the synchronous path's, in order, and no
    more chunks compress at once than the workers the backend was given
    (the usable CPUs but one)."""
    monkeypatch.setattr(cuda_backend, "usable_cpus", lambda: 3)
    calls = _Calls(monkeypatch)
    before = set(threading.enumerate())
    ours = _cpu_backend(**{"pipeline.depth": 2})
    copies = 5
    inputs = []
    for c in range(copies):
        rng = np.random.default_rng(100 + c)
        key, aad = rng.bytes(32), rng.bytes(8)
        windows = _windows(100 + c, 5, per=3, size=6000)
        ivs = [rng.bytes(12) for _ in range(15)]
        inputs.append((windows, key, aad, ivs))
    results: dict = {}

    def copy(c: int) -> None:
        windows, key, aad, ivs = inputs[c]
        opts = TransformOptions(compression=True, encryption=DataKeyAndAAD(key, aad), ivs=ivs)
        results[c] = [list(w) for w in ours.transform_windows(iter(windows), opts)]

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=copy, args=(c,)) for c in range(copies)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    for c, (windows, key, aad, ivs) in enumerate(inputs):
        want = _wire_reference(windows, key, aad, ivs)
        assert results[c] == [want[i : i + 3] for i in range(0, len(want), 3)]
    assert 1 <= calls.most <= 2 and len(calls.tags) == copies * 15
    started = [t for t in threading.enumerate() if t not in before]
    assert 1 <= len(started) <= 2 and all(t.name.startswith("zstd") for t in started)
    ours.close()


def test_windows_are_submitted_once_the_window_before_is_dispatched(native_zstd, monkeypatch):
    """Window k+1's chunks go to the workers right after window k is
    dispatched, not while the copier stages window k; the device codecs
    and the uncompressed windows never reach the workers."""
    events: list = []
    submit, dispatch = CudaTransformBackend._compress_ahead, CudaTransformBackend._dispatch_encrypt_window

    def submitted(self, chunks, opts):
        events.append(("submit", chunks[0][:1]))
        return submit(self, chunks, opts)

    def dispatched(self, chunks, opts):
        events.append(("dispatch", bytes(chunks[0][:0])))
        return dispatch(self, chunks, opts)

    monkeypatch.setattr(CudaTransformBackend, "_compress_ahead", submitted)
    monkeypatch.setattr(CudaTransformBackend, "_dispatch_encrypt_window", dispatched)
    ours = _cpu_backend(**{"pipeline.depth": 2})
    enc = DataKeyAndAAD(os.urandom(32), b"")
    assert len(list(ours.transform_windows(
        iter(_windows(44, 3)), TransformOptions(compression=True, encryption=enc)))) == 3
    assert events == [("submit", b"\x00"), ("dispatch", b""), ("submit", b"\x01"), ("dispatch", b""),
                      ("submit", b"\x02"), ("dispatch", b"")]
    events.clear()
    assert len(list(ours.transform_windows(iter(_windows(44, 2)), TransformOptions(encryption=enc)))) == 2
    assert events == [("dispatch", b"")] * 2
    ours.close()


@pytest.mark.parametrize("usable,workers", [(1, 1), (2, 1), (8, 7)])
def test_the_workers_leave_the_copier_a_cpu(monkeypatch, usable, workers):
    monkeypatch.setattr(cuda_backend, "usable_cpus", lambda: usable)
    ours = _cpu_backend()
    assert ours.zstd_workers == workers and ours._zstd_pool()._max_workers == workers
    ours.close()


@pytest.mark.parametrize("cpu_max,cpus,expected", [
    ("max 100000\n", 8, 8), ("200000 100000\n", 8, 2), ("150000 100000", 8, 2),
    ("50000 100000", 8, 1), ("800000 100000", 3, 3), (None, 5, 5), ("", 4, 4),
])
def test_usable_cpus_are_the_affinity_capped_by_the_cpu_quota(cpu_max, cpus, expected):
    assert host_zstd.usable_cpu_count(set(range(cpus)), cpu_max) == expected


def test_usable_cpus_read_the_affinity_and_cpu_max(monkeypatch, tmp_path):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: {0, 2, 5})
    monkeypatch.setattr(host_zstd, "CPU_MAX", tmp_path / "missing")
    assert host_zstd.usable_cpus() == 3
    (tmp_path / "cpu.max").write_text("200000 100000\n")
    monkeypatch.setattr(host_zstd, "CPU_MAX", tmp_path / "cpu.max")
    assert host_zstd.usable_cpus() == 2
