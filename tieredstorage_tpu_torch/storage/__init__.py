"""Storage backend SPI and the filesystem backend."""

from tieredstorage_tpu_torch.storage.core import (
    BytesRange,
    InvalidRangeException,
    KeyNotFoundException,
    ObjectDeleter,
    ObjectFetcher,
    ObjectKey,
    ObjectUploader,
    StorageBackend,
    StorageBackendException,
)

__all__ = [
    "BytesRange",
    "InvalidRangeException",
    "KeyNotFoundException",
    "ObjectDeleter",
    "ObjectFetcher",
    "ObjectKey",
    "ObjectUploader",
    "StorageBackend",
    "StorageBackendException",
]
