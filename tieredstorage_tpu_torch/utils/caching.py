"""Single-flight async loading cache — the Caffeine-equivalent primitive.

Counterpart of tieredstorage_tpu/utils/caching.py.

The reference leans on Caffeine `AsyncCache`s for all three fetch-side caches
(chunks: core/.../fetch/cache/ChunkCache.java:76-157; segment indexes:
fetch/index/MemorySegmentIndexesCache.java:93-120; manifests:
fetch/manifest/MemorySegmentManifestCache.java:67-117). This module provides
the same semantics natively:

- single-flight population: concurrent `get`s of one key share one load
  (Caffeine's `asMap().compute` atomicity, ChunkCache.java:85-112);
- weigher + maximum total weight with LRU eviction;
- expire-after-access retention;
- removal listener with the eviction cause (SIZE / EXPIRED / EXPLICIT /
  REPLACED) — the disk cache deletes files from it;
- a stats counter (hits/misses/load success+failure/evictions by cause)
  mirroring Caffeine's `StatsCounter` so the metrics layer can export the
  same families (core/.../metrics/CaffeineStatsCounter.java).

Loads run on a caller-supplied executor; `get` blocks up to `timeout`
(ChunkCache `get.timeout.ms`, config/CacheConfig.java:120-138).
"""

from __future__ import annotations

import enum
import time
from collections import OrderedDict
from concurrent.futures import Executor, Future
from dataclasses import dataclass, field
from typing import Any, Callable, Generic, Hashable, Optional, TypeVar

from tieredstorage_tpu_torch.utils.locks import new_lock, note_mutation

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


class RemovalCause(enum.Enum):
    EXPLICIT = "explicit"
    REPLACED = "replaced"
    SIZE = "size"
    EXPIRED = "expired"


@dataclass
class CacheStats:
    """Mutable counter set in the shape of Caffeine's StatsCounter."""

    hits: int = 0
    misses: int = 0
    load_successes: int = 0
    load_failures: int = 0
    total_load_time_ns: int = 0
    evictions: dict[RemovalCause, int] = field(
        default_factory=lambda: {c: 0 for c in RemovalCause}
    )
    eviction_weight: int = 0
    #: Removal-listener callbacks that raised (must not poison the cache,
    #: but must not vanish either).
    listener_failures: int = 0


class _Entry(Generic[V]):
    __slots__ = ("future", "weight", "last_access")

    def __init__(self, future: "Future[V]", now: float) -> None:
        self.future = future
        self.weight = 0
        self.last_access = now


class LoadingCache(Generic[K, V]):
    def __init__(
        self,
        *,
        executor: Executor,
        max_weight: Optional[int] = None,
        weigher: Callable[[V], int] = lambda v: 1,
        expire_after_access_s: Optional[float] = None,
        removal_listener: Optional[Callable[[K, V, RemovalCause], None]] = None,
        time_source: Callable[[], float] = time.monotonic,
    ) -> None:
        if max_weight is not None and max_weight < 0:
            max_weight = None  # -1 ⇒ unbounded (CacheConfig.java `size`)
        self._executor = executor
        self._max_weight = max_weight
        self._weigher = weigher
        self._expire = expire_after_access_s
        self._listener = removal_listener
        self._now = time_source
        self._lock = new_lock("caching.LoadingCache._lock")
        # Ordered oldest-access-first for LRU eviction.
        self._entries: "OrderedDict[K, _Entry[V]]" = OrderedDict()
        self._total_weight = 0
        self.stats = CacheStats()

    # ------------------------------------------------------------------ reads
    def get(
        self, key: K, loader: Callable[[], V], timeout: Optional[float] = None
    ) -> V:
        """Return the cached value, loading it at most once across threads."""
        return self.get_future(key, loader).result(timeout)

    def get_future(self, key: K, loader: Callable[[], V]) -> "Future[V]":
        load: Optional[tuple] = None
        with self._lock:
            expired = self._expire_stale_locked()
            entry = self._entries.get(key)
            if entry is not None:
                entry.last_access = self._now()
                self._entries.move_to_end(key)
                self.stats.hits += 1
                future = entry.future
            else:
                self.stats.misses += 1
                future = Future()
                self._entries[key] = _Entry(future, self._now())
                # Dispatch AFTER release: Executor.submit synchronizes on the
                # pool's own queue lock, and an inline executor (tests) would
                # run the whole load under _lock. Concurrent getters of the
                # key already share this future, so only the creator submits.
                load = (key, loader, future)
        self._dispatch_expired(expired)
        if load is not None:
            self._executor.submit(self._load, *load)
        return future

    def get_if_present(self, key: K) -> Optional["Future[V]"]:
        with self._lock:
            expired = self._expire_stale_locked()
            entry = self._entries.get(key)
            if entry is None:
                self.stats.misses += 1
                future = None
            else:
                entry.last_access = self._now()
                self._entries.move_to_end(key)
                self.stats.hits += 1
                future = entry.future
        self._dispatch_expired(expired)
        return future

    def peek(self, key: K) -> Optional["Future[V]"]:
        """Presence probe that records NO stats and does not refresh recency —
        for internal prefetch/window planning, so exported hit rates reflect
        only real accesses."""
        with self._lock:
            expired = self._expire_stale_locked()
            entry = self._entries.get(key)
            future = None if entry is None else entry.future
        self._dispatch_expired(expired)
        return future

    # ----------------------------------------------------------------- writes
    def _load(self, key: K, loader: Callable[[], V], future: "Future[V]") -> None:
        start = time.monotonic_ns()
        try:
            value = loader()
        except BaseException as e:  # noqa: BLE001 — failure recorded, then surfaced
            with self._lock:
                self.stats.load_failures += 1
                self.stats.total_load_time_ns += time.monotonic_ns() - start
                entry = self._entries.get(key)
                if entry is not None and entry.future is future:
                    del self._entries[key]
            future.set_exception(e)
            return
        evicted: list[tuple[K, V, RemovalCause]] = []
        orphaned = False
        with self._lock:
            self.stats.load_successes += 1
            self.stats.total_load_time_ns += time.monotonic_ns() - start
            entry = self._entries.get(key)
            if entry is not None and entry.future is future:
                entry.weight = self._weigher(value)
                self._total_weight += entry.weight
                evicted = self._evict_over_weight_locked(keep=key)
            else:
                # The entry was invalidated while loading: the value was never
                # accounted, so clean it up (disk caches unlink the file here).
                orphaned = True
        future.set_result(value)
        self._notify(evicted)
        if orphaned:
            self._notify([(key, value, RemovalCause.EXPLICIT)])

    def invalidate(self, key: K) -> None:
        self._remove(key, RemovalCause.EXPLICIT)

    def invalidate_all(self) -> None:
        for key in list(self._entries):
            self._remove(key, RemovalCause.EXPLICIT)

    def _remove(self, key: K, cause: RemovalCause) -> None:
        removed = None
        with self._lock:
            entry = self._entries.pop(key, None)
            if entry is not None:
                self._total_weight -= entry.weight
                removed = entry
                self.stats.evictions[cause] += 1
                self.stats.eviction_weight += entry.weight
        if removed is not None:
            self._notify([(key, removed.future, cause)])

    # --------------------------------------------------------------- internal
    def _evict_over_weight_locked(self, keep: K) -> list[tuple[K, Any, RemovalCause]]:
        if self._max_weight is None or self._total_weight <= self._max_weight:
            return []  # under weight: skip the O(n) key-list materialization
        evicted: list[tuple[K, Any, RemovalCause]] = []
        for key in list(self._entries):
            if self._total_weight <= self._max_weight:
                break
            if key == keep:
                continue
            entry = self._entries[key]
            if not entry.future.done():
                continue  # weight of in-flight loads is 0; nothing to reclaim
            del self._entries[key]
            self._total_weight -= entry.weight
            self.stats.evictions[RemovalCause.SIZE] += 1
            self.stats.eviction_weight += entry.weight
            evicted.append((key, entry.future, RemovalCause.SIZE))
        return evicted

    def _expire_stale_locked(self) -> list[tuple[K, Any, RemovalCause]]:
        """Drop expired entries; returns them for the CALLER to hand to
        `_dispatch_expired` after releasing `_lock` (Executor.submit takes
        the pool's queue lock — nothing blocking may run under `_lock`)."""
        if self._expire is None:
            return []
        deadline = self._now() - self._expire
        # `_entries` is recency-ordered (insertion stamps `last_access`,
        # every read refreshes it via move_to_end, and nothing else mutates
        # the stamp), so `last_access` is nondecreasing along the dict:
        # stop at the first fresh entry instead of scanning the whole
        # table. Without the early break this scan is O(entries) on EVERY
        # get — under a cold sequential replay that pre-admits tens of
        # thousands of chunks (fetch/readahead.py) it was the dominant
        # per-read cost, serialized under `_lock`. In-flight loads (future
        # not done) are skipped, not expired, exactly as before.
        stale = []
        for key, entry in self._entries.items():
            if entry.last_access >= deadline:
                break
            if entry.future.done():
                stale.append(key)
        expired = []
        for key in stale:
            entry = self._entries.pop(key)
            self._total_weight -= entry.weight
            self.stats.evictions[RemovalCause.EXPIRED] += 1
            self.stats.eviction_weight += entry.weight
            expired.append((key, entry.future, RemovalCause.EXPIRED))
        return expired

    def _dispatch_expired(self, expired: list) -> None:
        """Enqueue expiry notifications (outside `_lock`; listeners run on
        pool threads as before)."""
        if expired:
            self._executor.submit(self._notify, expired)

    def _notify(self, removed: list) -> None:
        if self._listener is None:
            return
        for key, future_or_value, cause in removed:
            value = future_or_value
            if isinstance(future_or_value, Future):
                if not future_or_value.done() or future_or_value.exception() is not None:
                    continue
                value = future_or_value.result()
            try:
                self._listener(key, value, cause)
            except Exception:  # noqa: BLE001 — listener failures must not poison the cache
                with self._lock:
                    self.stats.listener_failures += 1
                    note_mutation("caching.LoadingCache.stats")

    # ------------------------------------------------------------- inspection
    @property
    def total_weight(self) -> int:
        with self._lock:
            return self._total_weight

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
