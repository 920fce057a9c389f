"""In-memory storage backend for tests and as a fast local fake.

Counterpart of tieredstorage_tpu/storage/memory.py. The
analogue of the reference test tree's fake backends
(reference: core/src/test/java/.../config/NoopStorageBackend.java:30-60 is a
no-op used for config plumbing; this one actually stores bytes so the full
contract suite and the RSM lifecycle tests can run in-process).
"""

from __future__ import annotations

import io
from typing import BinaryIO, Dict, Mapping, Optional

from tieredstorage_tpu_torch.storage.core import (
    BytesRange,
    InvalidRangeException,
    KeyNotFoundException,
    ObjectKey,
    StorageBackend,
)
from tieredstorage_tpu_torch.utils.locks import new_lock


class InMemoryStorage(StorageBackend):
    def __init__(self) -> None:
        self._objects: Dict[str, bytes] = {}
        self._lock = new_lock("memory.InMemoryStorage._lock")

    def configure(self, configs: Mapping[str, object]) -> None:
        pass

    def upload(self, input_stream: BinaryIO, key: ObjectKey) -> int:
        data = input_stream.read()
        with self._lock:
            self._objects[key.value] = data
        return len(data)

    def fetch(self, key: ObjectKey, byte_range: Optional[BytesRange] = None) -> BinaryIO:
        with self._lock:
            data = self._objects.get(key.value)
        if data is None:
            raise KeyNotFoundException(self, key)
        if byte_range is None:
            return io.BytesIO(data)
        if byte_range.from_position >= len(data):
            raise InvalidRangeException(
                f"Range start position {byte_range.from_position} is outside object, "
                f"size = {len(data)}, range = {byte_range}"
            )
        return io.BytesIO(data[byte_range.from_position : byte_range.to_position + 1])

    def delete(self, key: ObjectKey) -> None:
        with self._lock:
            self._objects.pop(key.value, None)

    def list_objects(self, prefix: str = ""):
        with self._lock:
            matched = sorted(k for k in self._objects if k.startswith(prefix))
        for k in matched:
            yield ObjectKey(k)

    # --- test helpers ---
    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._objects)

    def object(self, key: str) -> bytes:
        with self._lock:
            return self._objects[key]

    def __str__(self) -> str:
        return "InMemoryStorage"
