"""In-memory chunk cache: cached form is the plaintext bytes themselves.

Counterpart of tieredstorage_tpu/fetch/cache/memory.py. Reference:
core/.../fetch/cache/MemoryChunkCache.java (weigher = byte length).
"""

from __future__ import annotations

import io
from typing import BinaryIO

from tieredstorage_tpu_torch.fetch.cache.chunk_cache import ChunkCache, ChunkKey


class MemoryChunkCache(ChunkCache[bytes]):
    def cache_chunk(self, chunk_key: ChunkKey, chunk: bytes) -> bytes:
        return chunk

    def cached_chunk_to_stream(self, cached: bytes) -> BinaryIO:
        return io.BytesIO(cached)

    def weight_of(self, cached: bytes) -> int:
        return len(cached)
