"""Cache configuration schemas.

Counterpart of tieredstorage_tpu/config/cache_config.py: the same keys,
types and defaults.

Reference: core/.../config/CacheConfig.java:28-145 (shared keys `size`,
`retention.ms`, `thread.pool.size`, `get.timeout.ms` with per-cache default
overrides via a builder), ChunkCacheConfig.java:24-52 (`prefetch.max.size`),
DiskChunkCacheConfig.java:30-85 (`path` required, validated writable, wiped on
startup).
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any, Mapping, Optional

from tieredstorage_tpu_torch.config.configdef import (
    ConfigDef,
    ConfigException,
    ConfigKey,
    in_range,
)

NO_OVERRIDE = object()


def _cache_def(
    *, size_default=NO_OVERRIDE, retention_ms_default: Any = 600_000
) -> ConfigDef:
    d = ConfigDef()
    size_key = ConfigKey(
        "size", "long",
        validator=in_range(-1, None), importance="medium",
        doc="Cache size in bytes, where \"-1\" represents unbounded cache.",
    )
    if size_default is not NO_OVERRIDE:
        size_key.default = size_default
    d.define(size_key)
    d.define(ConfigKey(
        "retention.ms", "long", default=retention_ms_default,
        validator=in_range(-1, None), importance="medium",
        doc="Cache retention time in milliseconds, where \"-1\" represents "
            "infinite retention.",
    ))
    d.define(ConfigKey(
        "thread.pool.size", "int", default=0,
        validator=in_range(0, None), importance="low",
        doc="Size for the thread pool used to schedule asynchronous fetching "
            "tasks, default to number of processors.",
    ))
    d.define(ConfigKey(
        "get.timeout.ms", "long", default=10_000,
        validator=in_range(1, None), importance="low",
        doc="When getting an object from the fetch, how long to wait before "
            "timing out. Defaults to 10 sec.",
    ))
    return d


class CacheConfig:
    """Shared cache keys; subclasses/builders override per-cache defaults."""

    def __init__(
        self,
        props: Mapping[str, Any],
        *,
        size_default=NO_OVERRIDE,
        retention_ms_default: Any = 600_000,
        extra_def: Optional[ConfigDef] = None,
    ) -> None:
        base = _cache_def(
            size_default=size_default, retention_ms_default=retention_ms_default
        )
        if extra_def is not None:
            for key in extra_def.keys.values():
                base.define(key)
        self._values = base.parse(props)
        self._def = base

    @property
    def cache_size(self) -> Optional[int]:
        """None ⇒ unbounded (config value -1)."""
        size = self._values["size"]
        return None if size == -1 else size

    @property
    def retention_s(self) -> Optional[float]:
        """None ⇒ infinite retention (config value -1)."""
        ms = self._values["retention.ms"]
        return None if ms == -1 else ms / 1000.0

    @property
    def thread_pool_size(self) -> Optional[int]:
        """None ⇒ executor default parallelism (config value 0)."""
        n = self._values["thread.pool.size"]
        return None if n == 0 else n

    @property
    def get_timeout_s(self) -> float:
        return self._values["get.timeout.ms"] / 1000.0

    def value(self, name: str) -> Any:
        return self._values[name]


def _chunk_cache_extra() -> ConfigDef:
    d = ConfigDef()
    d.define(ConfigKey(
        "prefetch.max.size", "int", default=0,
        validator=in_range(0, None), importance="medium",
        doc="The amount of data that should be eagerly prefetched and cached, "
            "in bytes. Defaults to 0 (no prefetching).",
    ))
    d.define(ConfigKey(
        "prefetch.window.chunks", "int", default=2,
        validator=in_range(0, None), importance="low",
        doc="Chunks per batched fetch+detransform sub-window of the prefetch "
            "range. Smaller windows surface prefetched chunks sooner and "
            "bound how long a foreground read that joins an in-flight "
            "prefetch decode waits (important for slow decodes, e.g. "
            "tpu-lzhuff-v1 frames); larger windows amortize storage round "
            "trips and device dispatches. 0 decodes the whole prefetch "
            "range in one batch. Defaults to 2.",
    ))
    return d


class ChunkCacheConfig(CacheConfig):
    def __init__(self, props: Mapping[str, Any], *, extra_def: Optional[ConfigDef] = None):
        d = _chunk_cache_extra()
        if extra_def is not None:
            for key in extra_def.keys.values():
                d.define(key)
        super().__init__(props, extra_def=d)

    @property
    def prefetch_max_size(self) -> int:
        return self._values["prefetch.max.size"]

    @property
    def prefetch_window_chunks(self) -> int:
        """0 ⇒ one batch over the whole prefetch range."""
        return self._values["prefetch.window.chunks"]


def _disk_cache_extra() -> ConfigDef:
    d = ConfigDef()
    d.define(ConfigKey(
        "path", "string", importance="high",
        doc="Path to the directory where cached chunk files are stored. "
            "The directory must exist and be writable; its contents are "
            "reset on startup (cache loss is not a correctness event).",
    ))
    return d


class DiskChunkCacheConfig(ChunkCacheConfig):
    def __init__(self, props: Mapping[str, Any]):
        super().__init__(props, extra_def=_disk_cache_extra())
        self._base_path = Path(self._values["path"])
        if not self._base_path.is_dir():
            raise ConfigException(
                f"{self._base_path} must be an existing directory"
            )
        if not os.access(self._base_path, os.W_OK):
            raise ConfigException(f"{self._base_path} must be writable")
        self._reset_cache_directory()

    def _reset_cache_directory(self) -> None:
        """Wipe temp/ and cache/ on startup — the disk cache never trusts
        leftovers (reference DiskChunkCacheConfig.resetCacheDirectory
        :62-73)."""
        for sub in (self.temp_path, self.cache_path):
            shutil.rmtree(sub, ignore_errors=True)
            sub.mkdir(parents=True, exist_ok=True)

    @property
    def base_path(self) -> Path:
        return self._base_path

    @property
    def temp_path(self) -> Path:
        return self._base_path / "temp"

    @property
    def cache_path(self) -> Path:
        return self._base_path / "cache"
