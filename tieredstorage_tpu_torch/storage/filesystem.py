"""Local-filesystem storage backend (testing/demo, like the reference's).

Reference: storage/filesystem/.../FileSystemStorage.java:38-115 and
FileSystemStorageConfig.java (`root`, `overwrite.enabled`).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import BinaryIO, Mapping, Optional

from tieredstorage_tpu_torch.storage.core import (
    BytesRange,
    InvalidRangeException,
    KeyNotFoundException,
    ObjectKey,
    StorageBackend,
    StorageBackendException,
)
from tieredstorage_tpu_torch.utils.streams import BoundedStream, copy_stream


class FileSystemStorage(StorageBackend):
    """Objects are plain files under `root`; key path separators map to dirs."""

    def __init__(self) -> None:
        self.fs_root: Path | None = None
        self.overwrite_enabled = False

    def configure(self, configs: Mapping[str, object]) -> None:
        root = configs.get("root")
        if root is None:
            raise ValueError("root must be provided")
        self.fs_root = Path(str(root))
        if not self.fs_root.is_dir() or not os.access(self.fs_root, os.W_OK):
            # Reference validates root is an existing writable directory.
            raise ValueError(f"root {self.fs_root} must be a writable directory")
        self.overwrite_enabled = _as_bool(configs.get("overwrite.enabled", False))

    def _path(self, key: ObjectKey) -> Path:
        assert self.fs_root is not None, "backend not configured"
        p = (self.fs_root / key.value).resolve()
        if self.fs_root.resolve() not in p.parents and p != self.fs_root.resolve():
            raise StorageBackendException(f"Key {key} escapes storage root")
        return p

    def upload(self, input_stream: BinaryIO, key: ObjectKey) -> int:
        path = self._path(key)
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            if not self.overwrite_enabled and path.exists():
                raise StorageBackendException(
                    f"File {path} already exists and overwriting is disabled"
                )
            tmp = path.with_name(path.name + ".part")
            try:
                with open(tmp, "wb") as out:
                    written = copy_stream(input_stream, out)
                os.replace(tmp, path)
            finally:
                if tmp.exists():
                    tmp.unlink(missing_ok=True)
            return written
        except OSError as e:
            raise StorageBackendException(f"Failed to upload {key}", ) from e

    def fetch(self, key: ObjectKey, byte_range: Optional[BytesRange] = None) -> BinaryIO:
        path = self._path(key)
        try:
            file_size = path.stat().st_size
        except FileNotFoundError as e:
            raise KeyNotFoundException(self, key, e) from e
        try:
            if byte_range is None:
                return open(path, "rb")
            # Reference semantics (FileSystemStorage.java:69-92): start beyond
            # EOF is InvalidRange; a range overrunning EOF returns the suffix.
            if byte_range.from_position >= file_size:
                raise InvalidRangeException(
                    f"Range start position {byte_range.from_position} is outside file content. "
                    f"file size = {file_size}, range = {byte_range}"
                )
            f = open(path, "rb")
            f.seek(byte_range.from_position)
            size = min(byte_range.size, file_size - byte_range.from_position)
            return BoundedStream(f, size)
        except OSError as e:
            raise StorageBackendException(f"Failed to fetch {key}") from e

    def delete(self, key: ObjectKey) -> None:
        path = self._path(key)
        try:
            path.unlink(missing_ok=True)
            # Prune now-empty parent directories up to the root
            # (reference: FileSystemStorage.java:95-109).
            assert self.fs_root is not None
            parent = path.parent
            root = self.fs_root.resolve()
            while parent.resolve() != root:
                try:
                    parent.rmdir()
                except OSError:
                    break
                parent = parent.parent
        except OSError as e:
            raise StorageBackendException(f"Failed to delete {key}") from e

    def list_objects(self, prefix: str = ""):
        assert self.fs_root is not None, "backend not configured"
        root = self.fs_root.resolve()
        keys: list[str] = []
        try:
            for dirpath, _dirnames, filenames in os.walk(root):
                for name in filenames:
                    rel = os.path.relpath(os.path.join(dirpath, name), root)
                    key = rel.replace(os.sep, "/")
                    if key.startswith(prefix):
                        keys.append(key)
        except OSError as e:
            raise StorageBackendException("Failed to list storage root") from e
        for key in sorted(keys):
            yield ObjectKey(key)

    def __str__(self) -> str:
        return f"FileSystemStorage{{root={self.fs_root}, overwriteEnabled={self.overwrite_enabled}}}"


def _as_bool(v: object) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("true", "1", "yes")
