"""Segment manifest cache: object key -> parsed SegmentManifest.

Counterpart of tieredstorage_tpu/fetch/manifest_cache.py.

Reference: core/.../fetch/manifest/SegmentManifestCache.java:26-29 (interface)
and MemorySegmentManifestCache.java (Caffeine AsyncLoadingCache; defaults
1000 entries / 1 h retention :51-52; `get` with timeout :67-89). Sized by
entry count (the manifests are ~KB JSON), unlike the byte-weighed chunk and
index caches.

``ManifestLookahead`` rides on top: a keyed single-flight
prefetch seam so a sequential read crossing a segment boundary finds the
NEXT segment's manifest already resolving (or resolved) instead of paying
the fetch+parse stall inline — and N readahead streams crossing the same
boundary resolve it ONCE.
"""

from __future__ import annotations

import abc
import concurrent.futures
import logging
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Mapping, Optional

from tieredstorage_tpu_torch.config.cache_config import CacheConfig
from tieredstorage_tpu_torch.manifest.segment_manifest import SegmentManifestV1
from tieredstorage_tpu_torch.storage.core import ObjectKey
from tieredstorage_tpu_torch.utils.caching import LoadingCache
from tieredstorage_tpu_torch.utils.locks import new_lock, note_mutation

log = logging.getLogger(__name__)


class SegmentManifestCache(abc.ABC):
    @abc.abstractmethod
    def get(
        self, key: ObjectKey, loader: Callable[[], SegmentManifestV1]
    ) -> SegmentManifestV1:
        """Cached parsed manifest; loads through `loader` at most once."""


class MemorySegmentManifestCache(SegmentManifestCache):
    DEFAULT_MAX_SIZE = 1000
    DEFAULT_RETENTION_MS = 3_600_000  # 1 h

    def __init__(self) -> None:
        self._cache: Optional[LoadingCache[str, SegmentManifestV1]] = None
        self._config: Optional[CacheConfig] = None
        self._executor: Optional[ThreadPoolExecutor] = None

    def configure(self, configs: Mapping[str, Any]) -> None:
        self._config = CacheConfig(
            configs,
            size_default=self.DEFAULT_MAX_SIZE,
            retention_ms_default=self.DEFAULT_RETENTION_MS,
        )
        self._executor = ThreadPoolExecutor(
            max_workers=self._config.thread_pool_size or None,
            thread_name_prefix="manifest-cache",
        )
        self._cache = LoadingCache(
            executor=self._executor,
            max_weight=self._config.cache_size,
            weigher=lambda _m: 1,  # sized by entry count
            expire_after_access_s=self._config.retention_s,
        )

    @property
    def stats(self):
        return self._cache.stats

    @property
    def size(self) -> int:
        return len(self._cache)

    def get(
        self, key: ObjectKey, loader: Callable[[], SegmentManifestV1]
    ) -> SegmentManifestV1:
        try:
            return self._cache.get(key.value, loader, timeout=self._config.get_timeout_s)
        except concurrent.futures.TimeoutError:
            raise TimeoutError(f"Loading manifest {key.value} timed out") from None

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True, cancel_futures=True)


class ManifestLookahead:
    """Keyed single-flight manifest prefetch over a ``SegmentManifestCache``.

    The manifest cache deduplicates *cached* lookups, but a segment-boundary
    crossing still pays the first fetch+parse of the next segment's manifest
    inline on the foreground read. This seam lets whoever can predict the
    crossing (the readahead tier's next-segment resolver, the RSM's fetch
    path) ``prefetch()`` the manifest onto a background worker; ``get()``
    then JOINS the in-flight resolution instead of starting a second one —
    and concurrent prefetches of the same key collapse to one load, keyed
    single-flight, exactly like the chunk cache's per-chunk flights.

    The flight table only holds keys from submit until the load settles
    (the result itself lives in the manifest cache; a failed flight is
    dropped so the next get retries through the cache's own loader).
    """

    def __init__(
        self, cache: SegmentManifestCache, *, max_workers: int = 1
    ) -> None:
        self._cache = cache
        self._executor = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="manifest-lookahead"
        )
        self._lock = new_lock("manifest_cache.ManifestLookahead._lock")
        self._flights: dict[str, "Future[SegmentManifestV1]"] = {}
        # Counters (guarded by _lock).
        self.launches = 0
        self.joins = 0
        self.failures = 0

    def prefetch(
        self, key: ObjectKey, loader: Callable[[], SegmentManifestV1]
    ) -> None:
        """Start resolving ``key``'s manifest in the background (at most one
        flight per key; repeat calls while it resolves are no-ops)."""
        with self._lock:
            if key.value in self._flights:
                return
            future: "Future[SegmentManifestV1]" = Future()
            self._flights[key.value] = future
            self.launches += 1
            note_mutation("manifest_cache.ManifestLookahead.launches")
        self._executor.submit(self._resolve, key, loader, future)

    def _resolve(
        self, key: ObjectKey, loader: Callable[[], SegmentManifestV1],
        future: "Future[SegmentManifestV1]",
    ) -> None:
        try:
            manifest = self._cache.get(key, loader)
        except Exception as e:
            # Drop the failed flight BEFORE resolving it: a get() that
            # arrives later retries through the cache loader instead of
            # inheriting a stale error.
            with self._lock:
                self._flights.pop(key.value, None)
                self.failures += 1
                note_mutation("manifest_cache.ManifestLookahead.failures")
            future.set_exception(e)
            log.debug("Manifest lookahead of %s failed", key.value, exc_info=True)
            return
        with self._lock:
            self._flights.pop(key.value, None)
        future.set_result(manifest)

    def get(
        self, key: ObjectKey, loader: Callable[[], SegmentManifestV1],
        timeout: Optional[float] = None,
    ) -> SegmentManifestV1:
        """The manifest for ``key`` — joining an in-flight prefetch when one
        is resolving, else through the cache (which is where a COMPLETED
        prefetch's result already lives)."""
        with self._lock:
            future = self._flights.get(key.value)
            if future is not None:
                self.joins += 1
                note_mutation("manifest_cache.ManifestLookahead.joins")
        if future is not None:
            try:
                return future.result(timeout=timeout)
            except concurrent.futures.TimeoutError:
                raise TimeoutError(
                    f"Joining manifest lookahead of {key.value} timed out"
                ) from None
            except Exception:
                # The prefetch failed; fall through to an authoritative
                # load of our own (the error, if persistent, surfaces here).
                log.debug(
                    "Joined manifest lookahead of %s failed; retrying "
                    "through the cache loader", key.value, exc_info=True,
                )
        return self._cache.get(key, loader)

    def close(self) -> None:
        self._executor.shutdown(wait=True, cancel_futures=True)
