"""Storage backend SPI: keys, byte ranges, upload/fetch/delete contracts.

Behavior parity with the reference's storage-core module
(reference: storage/core/src/main/java/io/aiven/kafka/tieredstorage/storage/
 StorageBackend.java:21, ObjectFetcher.java:21-35, ObjectUploader.java:21-27,
 ObjectDeleter.java:21-38, BytesRange.java:21-101, ObjectKey.java:18-20),
re-designed as Python protocols so backends are duck-typed and reflectively
instantiable from config (`storage.backend.class`).
"""

from __future__ import annotations

import abc
import dataclasses
import importlib
from typing import BinaryIO, Iterable, Mapping, Optional


class StorageBackendException(Exception):
    """Base error for storage backend failures.

    Reference: storage/core/.../StorageBackendException.java.
    """


class KeyNotFoundException(StorageBackendException):
    """Requested object key does not exist in the backend.

    Reference: storage/core/.../KeyNotFoundException.java (S3 404 mapping at
    storage/s3/.../S3Storage.java:115-141).
    """

    def __init__(self, backend: object, key: "ObjectKey", cause: Exception | None = None):
        super().__init__(f"Key {key} does not exists in storage {backend}")
        self.key = key
        self.__cause__ = cause


class InvalidRangeException(StorageBackendException):
    """Requested byte range cannot be satisfied (e.g. offset beyond object size).

    Reference: storage/core/.../InvalidRangeException.java (S3 416 mapping).
    """


@dataclasses.dataclass(frozen=True)
class ObjectKey:
    """Opaque object key; `value` is the full key string in the store.

    Reference: storage/core/.../ObjectKey.java:18-20.
    """

    value: str

    def __str__(self) -> str:  # match reference's ObjectKey.value() display
        return self.value


@dataclasses.dataclass(frozen=True)
class BytesRange:
    """Inclusive byte range [from_position, to_position].

    Reference: storage/core/.../BytesRange.java:21-101 (inclusive semantics,
    `ofFromPositionAndSize` constructor, validation).
    """

    from_position: int
    to_position: int

    def __post_init__(self) -> None:
        if self.from_position < 0:
            raise ValueError(f"from cannot be negative, {self.from_position} given")
        if self.to_position < self.from_position:
            raise ValueError(
                f"to cannot be less than from, from={self.from_position}, to={self.to_position} given"
            )

    @staticmethod
    def of(from_position: int, to_position: int) -> "BytesRange":
        return BytesRange(from_position, to_position)

    @staticmethod
    def of_from_position_and_size(position: int, size: int) -> "BytesRange":
        if size <= 0:
            raise ValueError(f"size must be positive, {size} given")
        return BytesRange(position, position + size - 1)

    @property
    def size(self) -> int:
        return self.to_position - self.from_position + 1

    def __str__(self) -> str:
        return f"BytesRange{{{self.from_position}..{self.to_position}}}"


def iter_chunks(stream: BinaryIO, chunk_size: int, *, read_size: int = 1 << 20):
    """Yield successive `chunk_size` slices of `stream` (last may be short).

    Single-sources the accumulate-and-slice EOF handling used by the block/
    resumable upload paths of the cloud backends.
    """
    pending = b""
    eof = False
    while True:
        while len(pending) < chunk_size and not eof:
            block = stream.read(read_size)
            if not block:
                eof = True
                break
            pending += block
        if eof and not pending:
            return
        chunk, pending = pending[:chunk_size], pending[chunk_size:]
        if chunk:
            yield chunk
        if eof and not pending:
            return


class ObjectUploader(abc.ABC):
    """Reference: storage/core/.../ObjectUploader.java:21-27."""

    @abc.abstractmethod
    def upload(self, input_stream: BinaryIO, key: ObjectKey) -> int:
        """Upload the stream under `key`; returns the number of bytes stored."""


class ObjectFetcher(abc.ABC):
    """Reference: storage/core/.../ObjectFetcher.java:21-35."""

    @abc.abstractmethod
    def fetch(self, key: ObjectKey, byte_range: Optional[BytesRange] = None) -> BinaryIO:
        """Open a stream over the object (optionally a ranged read).

        Raises KeyNotFoundException for missing keys and InvalidRangeException
        when the range start is beyond the object size. Like the reference,
        a range extending past the end returns the available suffix.
        """


class ObjectDeleter(abc.ABC):
    """Reference: storage/core/.../ObjectDeleter.java:21-38."""

    @abc.abstractmethod
    def delete(self, key: ObjectKey) -> None:
        """Delete one object; missing keys are not an error."""

    def delete_all(self, keys: Iterable[ObjectKey]) -> None:
        """Default multi-delete loops over `delete`; backends with a native
        bulk call (S3 DeleteObjects) override. Reference: ObjectDeleter.java:30-37."""
        for key in keys:
            self.delete(key)


class ObjectLister:
    """Key enumeration — the foundation of the integrity scrubber (scrub/).

    No reference counterpart: the reference never enumerates the store (it
    trusts uploads forever), which is exactly the gap the scrubber closes.
    """

    def list_objects(self, prefix: str = "") -> Iterable[ObjectKey]:
        """Yield every object key starting with `prefix`, in lexicographic
        order. An empty store (or unmatched prefix) yields nothing — never
        KeyNotFoundException. Cloud backends page internally (S3
        ListObjectsV2 continuation tokens, GCS pageToken, Azure marker), so
        iteration over millions of keys stays O(page) in memory."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support object listing"
        )


class StorageBackend(ObjectUploader, ObjectFetcher, ObjectDeleter, ObjectLister):
    """A configurable uploader+fetcher+deleter+lister.

    Reference: storage/core/.../StorageBackend.java:21 (Configurable +
    ObjectUploader + ObjectFetcher + ObjectDeleter); `list_objects` is this
    build's extension for the background scrubber.
    """

    def configure(self, configs: Mapping[str, object]) -> None:  # noqa: B027
        """Configure from the `storage.`-prefixed config subset."""


def load_backend_class(class_path: str) -> type:
    """Resolve a `module:Class` or dotted `module.Class` path to a class.

    The reflective analogue of the reference's `storage.backend.class`
    instantiation (core/.../config/RemoteStorageManagerConfig.java:315-320).
    """
    if ":" in class_path:
        module_name, _, class_name = class_path.partition(":")
    else:
        module_name, _, class_name = class_path.rpartition(".")
    if not module_name:
        raise ValueError(f"Invalid backend class path: {class_path!r}")
    module = importlib.import_module(module_name)
    try:
        cls = getattr(module, class_name)
    except AttributeError as e:
        raise ValueError(f"Class {class_name!r} not found in {module_name!r}") from e
    return cls
