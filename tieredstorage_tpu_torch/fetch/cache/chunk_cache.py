"""Caching chunk manager with single-flight population and async prefetch.

Counterpart of tieredstorage_tpu/fetch/cache/chunk_cache.py: its spans, the
`on_get` latency hook, its flight notes, and the pool hop that re-binds the
request's flight record and trace context to the worker that loads for it.

Reference: core/.../fetch/cache/ChunkCache.java — `getChunk` computes through
the async cache (miss → delegate fetch+detransform → `cacheChunk`; hit →
`cachedChunkToInputStream`), bounded by `get.timeout.ms` (:76-131); on every
access it asynchronously populates all chunks covering the next
`prefetch.max.size` original bytes (`startPrefetching` :159-184); the cache is
weight-bounded with expire-after-access and a removal listener (:139-157),
running on its own pool (`thread.pool.size`).

Extended device-first: `get_chunks` serves whole chunk windows — missing
chunks in a window are fetched with ONE ranged request and detransformed in
ONE batched backend call (one GCM window program on the card), then cached
individually.
"""

from __future__ import annotations

import abc
import concurrent.futures
import contextlib
import dataclasses
import io
import logging
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, BinaryIO, Generic, Mapping, Optional, Sequence, TypeVar

from tieredstorage_tpu_torch.config.cache_config import ChunkCacheConfig
from tieredstorage_tpu_torch.fetch.chunk_manager import ChunkManager
from tieredstorage_tpu_torch.manifest.segment_manifest import SegmentManifestV1
from tieredstorage_tpu_torch.storage.core import ObjectKey
from tieredstorage_tpu_torch.transform.scheduler import (
    current_work_class,
    is_speculative,
    speculative_scope,
    work_class_scope,
)
from tieredstorage_tpu_torch.utils import flightrecorder as flight
from tieredstorage_tpu_torch.utils.caching import LoadingCache, RemovalCause
from tieredstorage_tpu_torch.utils.deadline import check_deadline, remaining_s
from tieredstorage_tpu_torch.utils.locks import new_lock, new_unguarded
from tieredstorage_tpu_torch.utils.tracing import NOOP_TRACER

log = logging.getLogger(__name__)

T = TypeVar("T")


@dataclasses.dataclass(frozen=True)
class ChunkKey:
    """Cache key: segment object file name + chunk id (reference
    fetch/ChunkKey.java:22-64); `path` is the on-disk cache file name."""

    segment_file_name: str
    chunk_id: int

    @classmethod
    def of(cls, object_key: ObjectKey, chunk_id: int) -> "ChunkKey":
        return cls(object_key.value.rsplit("/", 1)[-1], chunk_id)

    @property
    def path(self) -> str:
        return f"{self.segment_file_name}-{self.chunk_id}"


class ChunkCacheTimeoutException(RuntimeError):
    pass


class ChunkCache(ChunkManager, Generic[T], abc.ABC):
    """Wraps a delegate ChunkManager; subclasses define the cached form T
    (bytes in memory, Path on disk)."""

    #: Span recorder; the RSM swaps in its configured tracer.
    tracer = NOOP_TRACER
    #: Optional latency hook `(elapsed_ms)` per window read; the RSM wires it
    #: to Metrics.record_cache_get.
    on_get = None
    #: Synthetic-record source for pool-side prefetch loads; the RSM wires
    #: its configured FlightRecorder so prefetch windows are attributable to
    #: the stream that triggered them.
    flight_recorder = flight.NOOP_RECORDER

    def __init__(self, delegate: ChunkManager) -> None:
        self._delegate = delegate
        self._config: Optional[ChunkCacheConfig] = None
        self._cache: Optional[LoadingCache[ChunkKey, T]] = None
        self._executor: Optional[ThreadPoolExecutor] = None
        #: Times a cache failure (I/O error or wedged load) was bypassed by
        #: fetching straight from the delegate instead of failing the read.
        #: Best-effort tallies bumped on reader and pool threads without a
        #: lock (declared with new_unguarded): a torn update under-counts one
        #: rare failure.
        self.degradations = new_unguarded("chunk_cache.ChunkCache.degradations", 0)
        #: Background prefetch loads that failed; never propagated.
        self.prefetch_failures = new_unguarded(
            "chunk_cache.ChunkCache.prefetch_failures", 0
        )
        #: Per-chunk single-flight across readers AND the async prefetch:
        #: a chunk whose fetch+detransform is in flight (delegate call
        #: issued, cache entry not yet registered) has a Future[bytes]
        #: here, so a concurrent reader JOINS the in-flight decode instead
        #: of duplicating it (without the join, a foreground read of a chunk
        #: the prefetch was already decoding decoded it again).
        self._inflight: dict[ChunkKey, "concurrent.futures.Future[bytes]"] = {}
        self._inflight_lock = new_lock("chunk_cache.ChunkCache._inflight_lock")
        #: Readers that joined another reader's in-flight chunk load.
        self.inflight_joins = 0

    # ------------------------------------------------------------------ setup
    def configure(self, configs: Mapping[str, Any]) -> None:
        self._config = self._parse_config(configs)
        self._executor = ThreadPoolExecutor(
            max_workers=self._config.thread_pool_size or None,
            thread_name_prefix="chunk-cache",
        )
        self._cache = LoadingCache(
            executor=self._executor,
            max_weight=self._config.cache_size,
            weigher=self.weight_of,
            expire_after_access_s=self._config.retention_s,
            removal_listener=self.on_removal,
        )

    def _parse_config(self, configs: Mapping[str, Any]) -> ChunkCacheConfig:
        return ChunkCacheConfig(configs)

    @property
    def stats(self):
        return self._cache.stats

    @property
    def size(self) -> int:
        return len(self._cache)

    @property
    def total_weight(self) -> int:
        return self._cache.total_weight

    @property
    def executor(self) -> ThreadPoolExecutor:
        return self._executor

    def close(self) -> None:
        # Drain in-flight loads before returning: callers close the transform
        # backend right after, and a loader thread must not reach a closed
        # backend (delegate.get_chunks -> backend.detransform).
        if self._executor is not None:
            self._executor.shutdown(wait=True, cancel_futures=True)
        # Chain down the tier stack (DeviceHotCache releases its retained
        # device buffers); lower tiers' close() is idempotent.
        if hasattr(self._delegate, "close"):
            self._delegate.close()

    # ------------------------------------------------------------------ reads
    def get_chunk(
        self, objects_key: ObjectKey, manifest: SegmentManifestV1, chunk_id: int
    ) -> BinaryIO:
        data = self.get_chunks(objects_key, manifest, [chunk_id])[0]
        return io.BytesIO(data)

    def get_chunks(
        self, objects_key: ObjectKey, manifest: SegmentManifestV1, chunk_ids: Sequence[int]
    ) -> list[bytes]:
        """Window read: missing chunks of the window load through ONE delegate
        batch (single ranged GET + one batched detransform), cached chunks are
        served from the cache; single-flight is preserved per chunk and the
        whole window is bounded by ONE `get.timeout.ms` deadline."""
        if not chunk_ids:
            return []
        start = time.monotonic()
        with self.tracer.span("cache.get_chunks", chunks=len(chunk_ids)):
            out = self._get_chunks_timed(objects_key, manifest, chunk_ids)
        if self.on_get is not None:
            self.on_get((time.monotonic() - start) * 1000.0)
        return out

    def _get_chunks_timed(
        self, objects_key: ObjectKey, manifest: SegmentManifestV1, chunk_ids: Sequence[int]
    ) -> list[bytes]:
        # The window wait is bounded by the tighter of `get.timeout.ms` and
        # the ambient end-to-end Deadline; an already-expired deadline fails
        # fast before any loader is scheduled.
        check_deadline(f"cache window read of {objects_key}")
        deadline = time.monotonic() + self._config.get_timeout_s
        ambient = remaining_s()
        if ambient is not None:
            deadline = min(deadline, time.monotonic() + ambient)
        self._start_prefetching(objects_key, manifest, chunk_ids[-1])
        futures = self._populate_window(objects_key, manifest, chunk_ids, deadline)
        out: dict[int, bytes] = {}
        fallback: list[int] = []
        for cid in chunk_ids:
            chunk_key = ChunkKey.of(objects_key, cid)
            kind, future = futures[cid]
            if kind == "bytes":
                # Joined another reader's in-flight fetch+detransform (most
                # often the async prefetch): the future resolves straight to
                # plaintext bytes. A wedged or failed owner must not fail
                # THIS read — degrade to a direct fetch, where the
                # authoritative error (if any) surfaces on our own call.
                try:
                    out[cid] = self._await(future, deadline, cid, objects_key)
                except ChunkCacheTimeoutException:
                    self.degradations += 1
                    fallback.append(cid)
                except Exception:
                    fallback.append(cid)
                continue
            try:
                value = self._await(future, deadline, cid, objects_key)
            except ChunkCacheTimeoutException:
                # Another reader's wedged population (the delegate fetch of
                # THIS window is bounded separately in _populate_window) must
                # not fail this read: degrade to a direct fetch.
                self.degradations += 1
                fallback.append(cid)
                continue
            except OSError:
                # The loader only persists already-fetched bytes, so an error
                # here is cache-storage I/O (unwritable disk cache directory,
                # full disk): bypass the cache for this chunk.
                log.warning("Chunk cache store failed for %s; bypassing cache",
                            chunk_key, exc_info=True)
                self._cache.invalidate(chunk_key)
                self.degradations += 1
                fallback.append(cid)
                continue
            try:
                data = self._read_cached(value)
            except OSError:
                log.warning("Chunk cache read failed for %s; bypassing cache",
                            chunk_key, exc_info=True)
                self.degradations += 1
                data = None
            if data is None:  # evicted + unlinked between resolve and open
                self._cache.invalidate(chunk_key)
                fallback.append(cid)
            else:
                out[cid] = data
        if fallback:
            # Eviction races and degraded cache I/O both land here: re-fetch
            # the affected chunks straight from the delegate, without
            # re-caching — going through the cache again would just re-race
            # with its own evictions (or re-hit the broken disk).
            flight.note("cache.fallback", len(fallback))
            refetched = self._delegate.get_chunks(objects_key, manifest, fallback)
            out.update(zip(fallback, refetched))
        return [out[cid] for cid in chunk_ids]

    def _await(self, future, deadline: float, cid: int, objects_key: ObjectKey) -> T:
        try:
            return future.result(max(0.0, deadline - time.monotonic()))
        except concurrent.futures.TimeoutError:
            raise ChunkCacheTimeoutException(
                f"Loading chunk {cid} of {objects_key} timed out"
            ) from None

    def _read_cached(self, value: T) -> Optional[bytes]:
        try:
            with self.cached_chunk_to_stream(value) as stream:
                return stream.read()
        except FileNotFoundError:
            return None

    def _populate_window(
        self,
        objects_key: ObjectKey,
        manifest: SegmentManifestV1,
        chunk_ids: Sequence[int],
        deadline: Optional[float],
    ) -> dict[int, tuple[str, "concurrent.futures.Future"]]:
        """Batch-fetch every not-yet-cached, not-yet-in-flight chunk of the
        window with ONE delegate call, then register per-chunk cache loaders
        that only persist the already-fetched bytes (no network under an
        executor lock). Returns cid -> ("cache", Future[T]) for cached/owned
        chunks and cid -> ("bytes", Future[bytes]) for chunks joined from
        another reader's in-flight load (single-flight: the prefetch and
        concurrent readers share one fetch+detransform per chunk; joiners
        never wait on more than the owner's sub-window).

        With a deadline (synchronous reads) the delegate fetch runs on the
        pool and is awaited with the remaining budget, so `get.timeout.ms`
        bounds a hung storage backend — on timeout the flight stays
        registered and resolves when the delegate returns, so later readers
        still join it instead of piling on. Without a deadline (prefetch —
        already on a pool worker) the fetch runs inline."""
        futures: dict[int, tuple[str, "concurrent.futures.Future"]] = {}
        missing: list[int] = []
        for cid in chunk_ids:
            key = ChunkKey.of(objects_key, cid)
            present = self._cache.peek(key)
            if present is not None:
                futures[cid] = ("cache", present)
                self._cache.get_if_present(key)  # hit + recency
            else:
                missing.append(cid)
        if len(chunk_ids) > len(missing):
            flight.note("tier.chunk_cache", len(chunk_ids) - len(missing))
        own: list[int] = []
        if missing:
            with self._inflight_lock:
                for cid in missing:
                    key = ChunkKey.of(objects_key, cid)
                    in_flight = self._inflight.get(key)
                    if in_flight is not None:
                        futures[cid] = ("bytes", in_flight)
                        self.inflight_joins += 1
                    else:
                        self._inflight[key] = concurrent.futures.Future()
                        own.append(cid)
        joined = len(missing) - len(own)
        if joined:
            flight.note("tier.inflight_join", joined)
        if own:
            if deadline is None:
                futures.update(
                    self._load_owned(objects_key, manifest, own)
                )
            else:
                # The pool worker loads on behalf of THIS request: re-bind
                # its flight record, trace context, work class and
                # speculative flag across the hop (the request thread blocks
                # right below), so the lower tiers' outcomes land on its
                # record and its span tree, and a readahead window's decrypt
                # keeps its BACKGROUND class and speculative label instead
                # of silently becoming latency-class work on the pool
                # thread. The prefetch branch (deadline=None, already on a
                # pool worker) deliberately carries none of these — it
                # outlives the request that triggered it.
                record = flight.current_record()
                traceparent = self.tracer.current_traceparent()
                task = self._executor.submit(
                    self._load_owned_bound, record, traceparent,
                    current_work_class(), is_speculative(),
                    objects_key, manifest, own,
                )
                try:
                    futures.update(
                        task.result(max(0.0, deadline - time.monotonic()))
                    )
                except concurrent.futures.TimeoutError:
                    raise ChunkCacheTimeoutException(
                        f"Fetching chunks {own} of {objects_key} timed out"
                    ) from None
        return futures

    def _load_owned_bound(
        self, record, traceparent, work_class, speculative,
        objects_key, manifest, own,
    ):
        with contextlib.ExitStack() as stack:
            stack.enter_context(flight.bound(record))
            stack.enter_context(self.tracer.continue_trace(traceparent))
            if work_class is not None:
                stack.enter_context(work_class_scope(work_class))
            if speculative:
                stack.enter_context(speculative_scope())
            return self._load_owned(objects_key, manifest, own)

    def _load_owned(
        self, objects_key: ObjectKey, manifest: SegmentManifestV1, own: list[int]
    ) -> dict[int, tuple[str, "concurrent.futures.Future"]]:
        """Fetch+detransform the owned chunks with one delegate call, then
        register cache loaders and resolve the in-flight futures (success or
        error) so joiners wake — runs to completion even when the submitting
        reader's window deadline has already expired."""
        try:
            fetched = self._delegate.get_chunks(objects_key, manifest, own)
        except BaseException as e:
            self._finish_flights(objects_key, own, None, e)
            raise
        futures: dict[int, tuple[str, "concurrent.futures.Future"]] = {}
        for cid, data in zip(own, fetched):
            key = ChunkKey.of(objects_key, cid)
            futures[cid] = ("cache", self._cache.get_future(
                key, lambda k=key, d=data: self.cache_chunk(k, d)
            ))
        # Resolve flights AFTER the cache entries exist, so a reader that
        # misses the flight window finds the chunk in the cache.
        self._finish_flights(objects_key, own, dict(zip(own, fetched)), None)
        return futures

    def _finish_flights(
        self,
        objects_key: ObjectKey,
        own: list[int],
        results: Optional[dict[int, bytes]],
        error: Optional[BaseException],
    ) -> None:
        popped: list[tuple[int, "concurrent.futures.Future"]] = []
        with self._inflight_lock:
            for cid in own:
                flight = self._inflight.pop(ChunkKey.of(objects_key, cid), None)
                if flight is not None:
                    popped.append((cid, flight))
        # Wake joiners outside the lock.
        for cid, flight in popped:
            if error is not None:
                flight.set_exception(error)
            else:
                flight.set_result(results[cid])

    # --------------------------------------------------------------- prefetch
    def _start_prefetching(
        self, objects_key: ObjectKey, manifest: SegmentManifestV1, current_chunk_id: int
    ) -> None:
        prefetch_bytes = self._config.prefetch_max_size
        if prefetch_bytes <= 0:
            return
        index = manifest.chunk_index
        current = index._chunk_at(current_chunk_id)
        start = current.original_position + current.original_size
        if start >= index.original_file_size:
            return
        end = min(start + prefetch_bytes - 1, index.original_file_size - 1)
        first = index.find_chunk_for_original_offset(start)
        last = index.find_chunk_for_original_offset(end)
        ids = [
            cid
            for cid in range(first.id, last.id + 1)
            if self._cache.peek(ChunkKey.of(objects_key, cid)) is None
        ]
        if not ids:
            return
        # Fire-and-forget: one batched load covers the whole prefetch window
        # (deadline=None — already on a pool worker, fetch runs inline there).
        # The originating request's trace id rides along so the pool-side
        # load's synthetic flight record is attributable to its stream.
        self._executor.submit(
            self._prefetch_window, objects_key, manifest, ids,
            flight.current_trace_id() or "",
        )

    def _prefetch_window(
        self, objects_key: ObjectKey, manifest: SegmentManifestV1,
        ids: Sequence[int], origin_trace_id: str = "",
    ) -> None:
        """Isolation boundary: a failed prefetch is counted, never raised —
        and the LoadingCache drops failed loads, so the entries stay clean
        for the next foreground get.

        The range is decoded in `prefetch.window.chunks`-sized sub-windows
        rather than one monolithic batch: each sub-window's chunks become
        servable (cache entries + resolved flights) as soon as IT finishes,
        and a foreground read that joins an in-flight prefetch chunk waits
        for one sub-window's fetch+detransform, not the whole prefetch
        range."""
        try:
            # Prefetch runs on a pool worker: its spans are roots of their own
            # trace and it does not re-bind the request's record (it outlives
            # the request). But the work is NOT anonymous: it opens a
            # synthetic flight record stamped with the originating stream's
            # trace id.
            window = self._config.prefetch_window_chunks or len(ids)
            with self.flight_recorder.request(
                "cache.prefetch", trace_id=origin_trace_id
            ):
                flight.note("prefetch.chunks", len(ids))
                flight.stage(
                    f"prefetch.segment:{objects_key.value.rsplit('/', 1)[-1]}"
                )
                with self.tracer.span("cache.prefetch", chunks=len(ids)):
                    for i in range(0, len(ids), max(1, window)):
                        self._populate_window(
                            objects_key, manifest, ids[i : i + max(1, window)],
                            None,
                        )
        except Exception:
            self.prefetch_failures += 1
            self.tracer.event("cache.prefetch_failure", chunks=len(ids))
            log.debug("Prefetch of chunks %s of %s failed", list(ids), objects_key,
                      exc_info=True)

    # ------------------------------------------------------------- subclasses
    @abc.abstractmethod
    def cache_chunk(self, chunk_key: ChunkKey, chunk: bytes) -> T:
        """Persist the plaintext chunk in the cached form."""

    @abc.abstractmethod
    def cached_chunk_to_stream(self, cached: T) -> BinaryIO:
        """Reopen a cached chunk as a readable stream."""

    @abc.abstractmethod
    def weight_of(self, cached: T) -> int:
        """Weight of a cached chunk for the size bound."""

    def on_removal(self, chunk_key: ChunkKey, cached: T, cause: RemovalCause) -> None:
        """Removal listener; disk cache deletes the file here."""
