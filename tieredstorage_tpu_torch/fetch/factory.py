"""ChunkManagerFactory: optionally wrap the default manager in cache tiers.

Counterpart of tieredstorage_tpu/fetch/factory.py. Reference:
core/.../fetch/ChunkManagerFactory.java:36-52 (reflective wrap of
DefaultChunkManager in the configured ChunkCache subclass) and
config/ChunkManagerFactoryConfig.java:29-55 (`fetch.chunk.cache.class`,
subclass-of-ChunkCache validated, no cache when unset).

Extended device-first with the hot-window tier: when ``cache.device.bytes``
> 0 a `DeviceHotCache` is inserted below the chunk cache; with
``readahead.enabled`` the predictive readahead tier wraps OUTERMOST — it
must see the raw foreground read stream (cache hits included) to detect
sequentiality, and its speculative loads go through the full tier stack
below so pre-admission IS a cache population. The full chain reads::

    [ReadaheadManager] -> ChunkCache -> DeviceHotCache -> DefaultChunkManager
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

from tieredstorage_tpu_torch.config.configdef import (
    ConfigDef,
    ConfigKey,
    subclass_of,
    subset_with_prefix,
)
from tieredstorage_tpu_torch.config.rsm_config import FETCH_CHUNK_CACHE_PREFIX
from tieredstorage_tpu_torch.fetch import readahead as readahead_mod
from tieredstorage_tpu_torch.fetch.cache import device_hot
from tieredstorage_tpu_torch.fetch.cache.chunk_cache import ChunkCache
from tieredstorage_tpu_torch.fetch.cache.device_hot import DeviceHotCache
from tieredstorage_tpu_torch.fetch.chunk_manager import ChunkManager, DefaultChunkManager
from tieredstorage_tpu_torch.fetch.readahead import ReadaheadManager
from tieredstorage_tpu_torch.storage.core import ObjectFetcher
from tieredstorage_tpu_torch.transform.api import TransformBackend


class ChunkManagerFactoryConfig:
    def __init__(self, props: Mapping[str, Any]):
        d = ConfigDef()
        d.define(ConfigKey(
            "fetch.chunk.cache.class", "class", default=None,
            validator=subclass_of(ChunkCache), importance="medium",
            doc="Chunk cache implementation. There are 2 implementations "
                "included: MemoryChunkCache and DiskChunkCache. Unset means "
                "no chunk caching.",
        ))
        for key in device_hot._definition().keys.values():
            d.define(key)
        for key in readahead_mod._definition().keys.values():
            d.define(key)
        self._values = d.parse(props)
        self._props = dict(props)

    @property
    def chunk_cache_class(self) -> Optional[type]:
        return self._values["fetch.chunk.cache.class"]

    @property
    def device_cache_bytes(self) -> int:
        """Byte budget of the hot-window tier; 0 disables it."""
        return self._values["cache.device.bytes"]

    @property
    def device_admission_hits(self) -> int:
        return self._values["cache.device.admission.hits"]

    @property
    def device_sketch_width(self) -> int:
        return self._values["cache.device.sketch.width"]

    @property
    def readahead_enabled(self) -> bool:
        return self._values["readahead.enabled"]

    @property
    def readahead_window_chunks(self) -> int:
        return self._values["readahead.window.chunks"]

    @property
    def readahead_streams_max(self) -> int:
        return self._values["readahead.streams.max"]

    @property
    def readahead_budget_bytes(self) -> int:
        return self._values["readahead.budget.bytes"]

    @property
    def readahead_misprediction_max_ratio(self) -> float:
        return self._values["readahead.misprediction.max.ratio"]

    def chunk_cache_configs(self) -> dict[str, Any]:
        # The stray "class" key the strip produces is ignored by the cache's
        # ConfigDef (undefined keys are skipped by parse).
        return subset_with_prefix(self._props, FETCH_CHUNK_CACHE_PREFIX)


class ChunkManagerFactory:
    def __init__(self) -> None:
        self._config: Optional[ChunkManagerFactoryConfig] = None
        #: The hot tier built by the last `init_chunk_manager` call (None
        #: when `cache.device.bytes` is 0).
        self.device_hot_cache: Optional[DeviceHotCache] = None
        #: The readahead tier built by the last `init_chunk_manager` call
        #: (None unless ``readahead.enabled``); the RSM wires its
        #: next-segment resolver through this handle.
        self.readahead_manager: Optional[ReadaheadManager] = None

    def configure(self, configs: Mapping[str, Any]) -> None:
        self._config = ChunkManagerFactoryConfig(configs)

    def init_chunk_manager(
        self, fetcher: ObjectFetcher, transform_backend: TransformBackend,
        inner_wrapper=None,
    ) -> ChunkManager:
        """`inner_wrapper`, when given, wraps the DefaultChunkManager BELOW
        the cache tiers (the JAX package's fleet mode inserts its peer tier
        there: local cache first, then the hot tier, then route-to-owner,
        then backend)."""
        default = DefaultChunkManager(fetcher, transform_backend)
        inner: ChunkManager = (
            inner_wrapper(default) if inner_wrapper is not None else default
        )
        self.device_hot_cache = None
        if self._config.device_cache_bytes > 0:
            # Below the ChunkCache: a local chunk-cache miss tries the
            # resident decrypted window BEFORE paying a storage fetch +
            # detransform.
            self.device_hot_cache = DeviceHotCache(
                inner,
                transform_backend,
                innermost=default,
                budget_bytes=self._config.device_cache_bytes,
                admission_hits=self._config.device_admission_hits,
                sketch_width=self._config.device_sketch_width,
            )
            inner = self.device_hot_cache
        cache_class = self._config.chunk_cache_class
        if cache_class is not None:
            cache: ChunkCache = cache_class(inner)
            cache.configure(self._config.chunk_cache_configs())
            inner = cache
        self.readahead_manager = None
        if self._config.readahead_enabled:
            # Outermost: the detector must observe every foreground read
            # (including the ones the cache below will serve as hits), and
            # its speculation goes through the whole chain so verified
            # plaintext lands in the cache tiers before the consumer asks.
            self.readahead_manager = ReadaheadManager(
                inner,
                window_chunks=self._config.readahead_window_chunks,
                streams_max=self._config.readahead_streams_max,
                budget_bytes=self._config.readahead_budget_bytes,
                misprediction_max_ratio=(
                    self._config.readahead_misprediction_max_ratio
                ),
            )
            inner = self.readahead_manager
        return inner
