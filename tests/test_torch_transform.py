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

    ours = _cpu_backend()
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
