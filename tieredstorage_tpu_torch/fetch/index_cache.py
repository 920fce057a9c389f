"""Segment indexes cache: (indexes object key, index type) -> raw index bytes.

Counterpart of tieredstorage_tpu/fetch/index_cache.py.

Reference: core/.../fetch/index/SegmentIndexesCache.java:28-34 (interface),
SegmentIndexKey.java (key pair), MemorySegmentIndexesCache.java (Caffeine
byte-weighed cache, 10 MiB default cap :55, single-flight `get` through the
ranged-fetch+decrypt supplier :93-120).
"""

from __future__ import annotations

import abc
import concurrent.futures
import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Mapping, Optional

from tieredstorage_tpu_torch.config.cache_config import CacheConfig
from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType
from tieredstorage_tpu_torch.storage.core import ObjectKey
from tieredstorage_tpu_torch.utils.caching import LoadingCache


@dataclasses.dataclass(frozen=True)
class SegmentIndexKey:
    indexes_key: str
    index_type: IndexType


class SegmentIndexesCache(abc.ABC):
    @abc.abstractmethod
    def get(
        self, key: ObjectKey, index_type: IndexType, loader: Callable[[], bytes]
    ) -> bytes:
        """Cached raw index bytes; loads through `loader` at most once."""


class MemorySegmentIndexesCache(SegmentIndexesCache):
    DEFAULT_MAX_SIZE_BYTES = 10 * 1024 * 1024

    def __init__(self) -> None:
        self._cache: Optional[LoadingCache[SegmentIndexKey, bytes]] = None
        self._config: Optional[CacheConfig] = None
        self._executor: Optional[ThreadPoolExecutor] = None

    def configure(self, configs: Mapping[str, Any]) -> None:
        self._config = CacheConfig(
            configs, size_default=self.DEFAULT_MAX_SIZE_BYTES
        )
        self._executor = ThreadPoolExecutor(
            max_workers=self._config.thread_pool_size or None,
            thread_name_prefix="indexes-cache",
        )
        self._cache = LoadingCache(
            executor=self._executor,
            max_weight=self._config.cache_size,
            weigher=len,
            expire_after_access_s=self._config.retention_s,
        )

    @property
    def stats(self):
        return self._cache.stats

    @property
    def size(self) -> int:
        return len(self._cache)

    @property
    def total_weight(self) -> int:
        return self._cache.total_weight

    def get(
        self, key: ObjectKey, index_type: IndexType, loader: Callable[[], bytes]
    ) -> bytes:
        cache_key = SegmentIndexKey(key.value, index_type)
        try:
            return self._cache.get(cache_key, loader, timeout=self._config.get_timeout_s)
        except concurrent.futures.TimeoutError:
            raise TimeoutError(f"Loading index {cache_key} timed out") from None

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True, cancel_futures=True)
