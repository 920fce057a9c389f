"""On-disk chunk cache: write-to-temp + atomic move, delete on eviction.

Counterpart of tieredstorage_tpu/fetch/cache/disk.py, without the metrics
taps (the metrics plane is not ported).

Reference: core/.../fetch/cache/DiskChunkCache.java — `cacheChunk` writes to
`{path}/temp/{key}` then ATOMIC_MOVEs to `{path}/cache/{key}` (:70-87) so
readers never observe partial files; the removal listener deletes the file
(:98-115); weigher = file size; the directory pair is
wiped on startup (config/DiskChunkCacheConfig.java:62-73).
"""

from __future__ import annotations

import itertools
import logging
import os
from pathlib import Path
from typing import Any, BinaryIO, Mapping

from tieredstorage_tpu_torch.config.cache_config import DiskChunkCacheConfig
from tieredstorage_tpu_torch.fetch.cache.chunk_cache import ChunkCache, ChunkKey
from tieredstorage_tpu_torch.utils.caching import RemovalCause

log = logging.getLogger(__name__)


class DiskChunkCache(ChunkCache[Path]):
    _config: DiskChunkCacheConfig

    def __init__(self, delegate) -> None:
        super().__init__(delegate)
        self._generation = itertools.count()

    def _parse_config(self, configs: Mapping[str, Any]) -> DiskChunkCacheConfig:
        return DiskChunkCacheConfig(configs)

    def cache_chunk(self, chunk_key: ChunkKey, chunk: bytes) -> Path:
        # The generation suffix makes every cache insertion a distinct file:
        # a late removal listener (expiry/eviction runs async) can then never
        # unlink a file belonging to a NEWER entry re-cached under the same
        # ChunkKey — it only ever deletes the exact path it owns.
        name = f"{chunk_key.path}.{next(self._generation)}"
        temp = self._config.temp_path / name
        final = self._config.cache_path / name
        try:
            with open(temp, "wb") as f:
                f.write(chunk)
            os.replace(temp, final)  # atomic within the cache filesystem
        except OSError:
            # Cache-write I/O errors degrade to cache-bypass upstream
            # (ChunkCache.get_chunks); don't leak the partial temp file.
            try:
                temp.unlink(missing_ok=True)
            except OSError:
                pass
            raise
        return final

    def cached_chunk_to_stream(self, cached: Path) -> BinaryIO:
        return open(cached, "rb")

    def weight_of(self, cached: Path) -> int:
        return cached.stat().st_size

    def on_removal(self, chunk_key: ChunkKey, cached: Path, cause: RemovalCause) -> None:
        try:
            cached.unlink()
        except FileNotFoundError:
            pass
        except OSError:
            log.warning("Failed to delete cached chunk file %s", cached, exc_info=True)
