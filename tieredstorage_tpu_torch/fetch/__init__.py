"""Fetch path: chunk manager and ranged chunk enumeration."""

from tieredstorage_tpu_torch.fetch.chunk_manager import ChunkManager, DefaultChunkManager
from tieredstorage_tpu_torch.fetch.enumeration import FetchChunkEnumeration

__all__ = ["ChunkManager", "DefaultChunkManager", "FetchChunkEnumeration"]
