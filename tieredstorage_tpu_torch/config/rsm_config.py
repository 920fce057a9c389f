"""RemoteStorageManager configuration schema, cut to the keys this package implements.

Counterpart of tieredstorage_tpu/config/rsm_config.py. Implemented keys:
`storage.*` (with the required `storage.backend.class`), `key.prefix`,
`key.prefix.mask`, `chunk.size`, `compression.*`, `encryption.*` (keyring
with the two-phase `encryption.key.pairs.<id>.*` define),
`custom.metadata.fields.include`, `transform.backend.class` (default: this
package's CudaTransformBackend) and the `transform.*` subtree its backend
reads, and the fetch plane's keys, which their own modules parse:
`fetch.chunk.cache.*`, `fetch.manifest.cache.*`, `fetch.indexes.cache.*`
(config/cache_config.py), `fetch.chunk.cache.class`, `cache.device.*` and
`readahead.*` (fetch/factory.py). Every other key of the JAX package's
configuration raises a ConfigException naming it as not yet ported: a
setting is never ignored silently.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

from tieredstorage_tpu_torch.config.configdef import (
    ConfigDef,
    ConfigException,
    ConfigKey,
    in_range,
    non_empty_string,
    subset_with_prefix,
)

INT_MAX = 2**31 - 1

STORAGE_PREFIX = "storage."
TRANSFORM_PREFIX = "transform."
FETCH_CHUNK_CACHE_PREFIX = "fetch.chunk.cache."
FETCH_INDEXES_CACHE_PREFIX = "fetch.indexes.cache."
FETCH_MANIFEST_CACHE_PREFIX = "fetch.manifest.cache."

#: Keys of the JAX package's configuration that this package has not ported.
NOT_YET_PORTED = frozenset({
    "tracing.enabled", "tracing.jax.profiler.enabled", "tracing.max.spans",
    "tracing.export.path", "upload.rate.limit.bytes.per.second",
    "fault.injection.enabled", "fault.schedule", "fault.seed",
    "breaker.enabled", "breaker.failure.threshold", "breaker.cooldown.ms",
    "deadline.default.ms", "hedge.enabled", "hedge.delay.ms",
    "hedge.delay.min.samples", "hedge.budget.percent", "retry.budget.enabled",
    "retry.budget.percent", "retry.budget.capacity", "retry.budget.max.attempts",
    "retry.budget.backoff.ms", "breaker.peer.failure.threshold",
    "breaker.gossip.failure.threshold", "retry.gossip.probe.attempts",
    "retry.launch.attempts", "retry.launch.backoff.ms", "faults.spec",
    "faults.seed", "admission.enabled", "admission.max.concurrent",
    "admission.max.queue", "admission.queue.timeout.ms",
    "admission.retry.after.ms", "sidecar.grpc.max.workers",
    "sidecar.http.max.workers", "fleet.enabled", "fleet.instance.id",
    "fleet.instances", "fleet.vnodes", "fleet.forward.timeout.ms",
    "fleet.peer.down.cooldown.ms", "fleet.replication.factor",
    "fleet.gossip.enabled", "fleet.gossip.interval.ms",
    "fleet.gossip.probe.timeout.ms", "fleet.gossip.suspect.periods",
    "fleet.gossip.dead.periods", "replication.antientropy.enabled",
    "replication.antientropy.interval.ms", "replication.antientropy.rate.bytes",
    "scrub.enabled", "scrub.interval.ms", "scrub.rate.bytes",
    "scrub.repair.enabled", "scrub.checksums.enabled", "lifecycle.enabled",
    "lifecycle.journal.path", "lifecycle.sweep.interval.ms",
    "lifecycle.sweep.on.start", "lifecycle.grace.ms", "flight.enabled",
    "flight.ring.size", "timeline.enabled", "timeline.ring.size", "slo.enabled",
    "slo.window.short.ms", "slo.window.long.ms", "slo.fetch.latency.threshold.ms",
    "slo.fetch.latency.objective.percent", "slo.error.rate.objective.percent",
    "slo.shed.rate.max.percent", "slo.cache.hit.floor.percent",
    "metrics.num.samples", "metrics.sample.window.ms", "metrics.recording.level",
})

ZSTD = "zstd"


def _codec_id(name: str, value) -> None:
    if value != ZSTD:
        raise ConfigException(
            f"Invalid value {value!r} for configuration {name}: only {ZSTD!r} is "
            "ported to tieredstorage_tpu_torch (the device codecs are not yet ported)"
        )


_codec_id.description = "[zstd]"


def _base_def() -> ConfigDef:
    d = ConfigDef()
    d.define(ConfigKey(
        "storage.backend.class", "class", importance="high",
        doc="The storage backend implementation class.",
    ))
    d.define(ConfigKey(
        "transform.backend.class", "class",
        default="tieredstorage_tpu_torch.transform.cuda.CudaTransformBackend",
        importance="high",
        doc="The transform backend implementation class (the CUDA backend, "
            "whose transform.device selects the GPU or the CPU).",
    ))
    d.define(ConfigKey(
        "key.prefix", "string", default="", validator=None, importance="high",
        doc="The object storage path prefix.",
    ))
    d.define(ConfigKey(
        "key.prefix.mask", "bool", default=False, importance="low",
        doc="Whether to mask the prefix in logs.",
    ))
    d.define(ConfigKey(
        "chunk.size", "int", validator=in_range(1, INT_MAX // 2), importance="high",
        doc="Segment files are chunked into chunks of this size, transformed "
            "chunk-wise, and range-fetched chunk-wise.",
    ))
    d.define(ConfigKey(
        "compression.enabled", "bool", default=False, importance="high",
        doc="Whether to compress chunks before storing.",
    ))
    d.define(ConfigKey(
        "compression.heuristic.enabled", "bool", default=False, importance="high",
        doc="Only compress segments whose first record batch is not already "
            "compressed (requires compression.enabled).",
    ))
    d.define(ConfigKey(
        "compression.codec", "string", default=ZSTD, importance="medium",
        validator=_codec_id,
        doc="Compression codec id recorded in the manifest: 'zstd' (needs the "
            "zstandard package).",
    ))
    d.define(ConfigKey(
        "encryption.enabled", "bool", default=False, importance="high",
        doc="Whether to encrypt chunks with per-segment AES-256-GCM data keys.",
    ))
    d.define(ConfigKey(
        "encryption.key.pair.id", "string", default=None, validator=non_empty_string,
        importance="high",
        doc="The active RSA key-encryption-key pair id.",
    ))
    d.define(ConfigKey(
        "encryption.key.pairs", "list", default=[], importance="high",
        doc="The list of RSA key pair ids in the keyring.",
    ))
    d.define(ConfigKey(
        "custom.metadata.fields.include", "list", default=[], importance="low",
        doc="Custom metadata fields to persist with the broker "
            "(REMOTE_SIZE, OBJECT_PREFIX, OBJECT_KEY).",
    ))
    return d


def _check_ported(props: Mapping[str, Any]) -> None:
    for name in props:
        if name in NOT_YET_PORTED:
            raise ConfigException(
                f"Configuration {name} is not yet ported to tieredstorage_tpu_torch"
            )


class RemoteStorageManagerConfig:
    def __init__(self, props: Mapping[str, Any]):
        _check_ported(props)
        self._props = dict(props)
        self._values = _base_def().parse(props)
        self._validate_cross_keys()
        self._key_pair_paths = self._parse_key_pairs()

    def _validate_cross_keys(self) -> None:
        if self.compression_heuristic_enabled and not self.compression_enabled:
            raise ConfigException(
                "compression.enabled must be enabled if compression.heuristic.enabled is"
            )
        if self.encryption_enabled:
            if not self._values["encryption.key.pair.id"]:
                raise ConfigException(
                    "encryption.key.pair.id must be provided if encryption is enabled"
                )
            if not self._values["encryption.key.pairs"]:
                raise ConfigException(
                    "encryption.key.pairs must be provided if encryption is enabled"
                )

    def _parse_key_pairs(self) -> dict[str, tuple[str, str]]:
        """Two-phase dynamic define: each id in `encryption.key.pairs`
        requires `encryption.key.pairs.<id>.public.key.file` and
        `...private.key.file`."""
        if not self.encryption_enabled:
            return {}
        paths: dict[str, tuple[str, str]] = {}
        for key_id in self._values["encryption.key.pairs"]:
            pub = self._props.get(f"encryption.key.pairs.{key_id}.public.key.file")
            priv = self._props.get(f"encryption.key.pairs.{key_id}.private.key.file")
            if not pub or not priv:
                raise ConfigException(
                    f"Both public and private key files must be provided for key pair {key_id!r}"
                )
            paths[key_id] = (str(pub), str(priv))
        active = self._values["encryption.key.pair.id"]
        if active not in paths:
            raise ConfigException(
                f"Encryption key {active!r} must be provided in encryption.key.pairs"
            )
        return paths

    # --- accessors ---
    def raw_props(self) -> dict[str, Any]:
        return dict(self._props)

    @property
    def storage_backend_class(self) -> type:
        return self._values["storage.backend.class"]

    def storage_configs(self) -> dict[str, Any]:
        return subset_with_prefix(self._props, STORAGE_PREFIX)

    @property
    def transform_backend_class(self) -> type:
        return self._values["transform.backend.class"]

    def transform_configs(self) -> dict[str, Any]:
        """The `transform.`-prefixed subtree handed to the backend's
        `configure()` (prefix stripped; transform/cuda.py `_definition`)."""
        return {
            k: v for k, v in subset_with_prefix(self._props, TRANSFORM_PREFIX).items()
            if k != "backend.class"
        }

    @property
    def key_prefix(self) -> str:
        return self._values["key.prefix"]

    @property
    def key_prefix_mask(self) -> bool:
        return self._values["key.prefix.mask"]

    @property
    def chunk_size(self) -> int:
        return self._values["chunk.size"]

    @property
    def compression_enabled(self) -> bool:
        return self._values["compression.enabled"]

    @property
    def compression_heuristic_enabled(self) -> bool:
        return self._values["compression.heuristic.enabled"]

    @property
    def compression_codec(self) -> str:
        return self._values["compression.codec"]

    @property
    def encryption_enabled(self) -> bool:
        return self._values["encryption.enabled"]

    @property
    def encryption_key_pair_id(self) -> Optional[str]:
        return self._values["encryption.key.pair.id"]

    @property
    def encryption_key_pair_paths(self) -> dict[str, tuple[str, str]]:
        return dict(self._key_pair_paths)

    @property
    def custom_metadata_fields_include(self) -> list[str]:
        return list(self._values["custom.metadata.fields.include"])

    def fetch_indexes_cache_configs(self) -> dict[str, Any]:
        return subset_with_prefix(self._props, FETCH_INDEXES_CACHE_PREFIX)

    def fetch_manifest_cache_configs(self) -> dict[str, Any]:
        return subset_with_prefix(self._props, FETCH_MANIFEST_CACHE_PREFIX)
