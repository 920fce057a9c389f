"""Storage backend SPI and the concrete backends: memory, filesystem, S3, GCS,
Azure Blob and the replicated composite.

Counterpart of tieredstorage_tpu/storage/.
"""

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

# The replicated backend's names are re-exported lazily (PEP 562), as in the
# JAX package: replicated.py imports utils/deadline.py, which imports
# storage.core, so an eager import here would make utils.deadline
# unimportable as a process's first import of the package.
_REPLICATED_EXPORTS = (
    "AllReplicasFailedException",
    "QuorumWriteException",
    "ReplicatedStorageBackend",
)


def __getattr__(name: str):
    if name in _REPLICATED_EXPORTS:
        from tieredstorage_tpu_torch.storage import replicated

        return getattr(replicated, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AllReplicasFailedException",
    "BytesRange",
    "InvalidRangeException",
    "KeyNotFoundException",
    "ObjectDeleter",
    "ObjectFetcher",
    "ObjectKey",
    "ObjectUploader",
    "QuorumWriteException",
    "ReplicatedStorageBackend",
    "StorageBackend",
    "StorageBackendException",
]
