"""Chunk cache tiers: memory and disk chunk caches, the device hot-window tier."""

from tieredstorage_tpu_torch.fetch.cache.chunk_cache import ChunkCache, ChunkKey
from tieredstorage_tpu_torch.fetch.cache.device_hot import DeviceHotCache, FrequencySketch
from tieredstorage_tpu_torch.fetch.cache.disk import DiskChunkCache
from tieredstorage_tpu_torch.fetch.cache.memory import MemoryChunkCache

__all__ = [
    "ChunkCache",
    "ChunkKey",
    "DeviceHotCache",
    "DiskChunkCache",
    "FrequencySketch",
    "MemoryChunkCache",
]
