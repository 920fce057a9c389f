"""RemoteStorageManager configuration schema, cut to the keys this package implements.

Counterpart of tieredstorage_tpu/config/rsm_config.py. Implemented keys:
`storage.*` (with the required `storage.backend.class`), `key.prefix`,
`key.prefix.mask`, `chunk.size`, `compression.*`, `encryption.*` (keyring
with the two-phase `encryption.key.pairs.<id>.*` define),
`custom.metadata.fields.include`, `upload.rate.limit.bytes.per.second`,
`retry.launch.*` (the window batcher's launch retry), `scrub.*` (the
scrubber, its scheduler and the upload checksums), `fault.*` and `faults.*`
(the fault-injecting backend and the fault plane), `lifecycle.*` (the
intent journal and the recovery sweeper), `replication.antientropy.*`
(anti-entropy repair of a replicated store), `transform.backend.class`
(default: this package's CudaTransformBackend) and the `transform.*` subtree
its backend reads, and the fetch plane's keys, which their own modules parse:
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
    null_or,
    parseable_by,
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
    "tracing.export.path",
    "breaker.enabled", "breaker.failure.threshold", "breaker.cooldown.ms",
    "deadline.default.ms", "hedge.enabled", "hedge.delay.ms",
    "hedge.delay.min.samples", "hedge.budget.percent", "retry.budget.enabled",
    "retry.budget.percent", "retry.budget.capacity", "retry.budget.max.attempts",
    "retry.budget.backoff.ms", "breaker.peer.failure.threshold",
    "breaker.gossip.failure.threshold", "retry.gossip.probe.attempts",
    "admission.enabled", "admission.max.concurrent",
    "admission.max.queue", "admission.queue.timeout.ms",
    "admission.retry.after.ms", "sidecar.grpc.max.workers",
    "sidecar.http.max.workers", "fleet.enabled", "fleet.instance.id",
    "fleet.instances", "fleet.vnodes", "fleet.forward.timeout.ms",
    "fleet.peer.down.cooldown.ms", "fleet.replication.factor",
    "fleet.gossip.enabled", "fleet.gossip.interval.ms",
    "fleet.gossip.probe.timeout.ms", "fleet.gossip.suspect.periods",
    "fleet.gossip.dead.periods", "flight.enabled",
    "flight.ring.size", "timeline.enabled", "timeline.ring.size", "slo.enabled",
    "slo.window.short.ms", "slo.window.long.ms", "slo.fetch.latency.threshold.ms",
    "slo.fetch.latency.objective.percent", "slo.error.rate.objective.percent",
    "slo.shed.rate.max.percent", "slo.cache.hit.floor.percent",
    "metrics.num.samples", "metrics.sample.window.ms", "metrics.recording.level",
})

def _codec_id(name: str, value) -> None:
    import warnings

    from tieredstorage_tpu_torch.transform.api import THUFF, TLZHUFF, ZSTD

    if value not in (ZSTD, THUFF, TLZHUFF):
        raise ConfigException(
            f"Invalid value {value!r} for configuration {name}: "
            f"must be one of [{ZSTD!r}, {THUFF!r}, {TLZHUFF!r}]"
        )
    if value == TLZHUFF:
        # Demoted behind tpu-huff-v1 in the JAX package, with the same
        # warning: still supported for reading existing manifests; new
        # uploads should use tpu-huff-v1.
        warnings.warn(
            f"{TLZHUFF!r} is deprecated as a configured codec: its device LZ "
            f"stage is two orders of magnitude slower than every alternative "
            f"(BENCH_r05). Use {THUFF!r} (device) or {ZSTD!r} (host) instead; "
            f"existing {TLZHUFF!r} segments remain readable.",
            DeprecationWarning,
            stacklevel=2,
        )


_codec_id.description = "[zstd, tpu-huff-v1, tpu-lzhuff-v1]"


def _parse_fault_rules(value) -> None:
    from tieredstorage_tpu_torch.faults.schedule import FaultSchedule

    FaultSchedule.parse(value)


_valid_fault_schedule = parseable_by(
    _parse_fault_rules, "fault rules 'op:action[=arg][@trigger]'"
)


def _parse_fault_spec(value) -> None:
    from tieredstorage_tpu_torch.utils.faults import FaultPlane

    FaultPlane.parse(value)


_valid_fault_spec = parseable_by(
    _parse_fault_spec, "fault rules 'site:kind[=arg][@trigger][~match]'"
)


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
        "compression.codec", "string", default="zstd", importance="medium",
        validator=_codec_id,
        doc="Compression codec id recorded in the manifest: 'zstd' "
            "(reference-compatible) or 'tpu-huff-v1' (order-0 device codec, "
            "the preferred device choice). 'tpu-lzhuff-v1' (device LZ + "
            "Huffman) is DEPRECATED — demoted behind tpu-huff-v1 in the JAX "
            "package after its benchmark (BENCH_r05) measured it two orders "
            "of magnitude slower on both compress and ranged fetch; "
            "configuring it emits a DeprecationWarning, existing segments "
            "remain readable.",
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
    d.define(ConfigKey(
        "fault.injection.enabled", "bool", default=False, importance="low",
        doc="Wrap the storage backend in a FaultInjectingBackend executing "
            "fault.schedule (chaos/soak runs only; never enable in "
            "production).",
    ))
    d.define(ConfigKey(
        "fault.schedule", "list", default=[], validator=_valid_fault_schedule,
        importance="low",
        doc="Deterministic fault rules 'op:action[=arg][@trigger]' with op in "
            "[upload, fetch, delete, list, *], action in [raise, key-not-found, "
            "delay, truncate, corrupt], trigger '@N' (Nth call), '@every=K', "
            "'@from=N' (every call from the Nth onward — a hard failure that "
            "starts mid-run and never recovers), "
            "or '@p=P' (seeded probability). delay accepts a jittered range "
            "'delay=lo..hi' (uniform seeded draw per firing, in ms) for "
            "realistic tail-latency distributions. E.g. 'upload:raise@3, "
            "fetch:corrupt=7@1, fetch:delay=10..250@p=0.2'.",
    ))
    d.define(ConfigKey(
        "fault.seed", "long", default=0, importance="low",
        doc="Seed for probabilistic fault triggers (deterministic for a "
            "given seed and call sequence).",
    ))
    d.define(ConfigKey(
        "upload.rate.limit.bytes.per.second", "int", default=None,
        validator=null_or(in_range(1024 * 1024, INT_MAX)),
        importance="medium",
        doc="Upper bound on segment upload bytes/s per manager instance.",
    ))
    d.define(ConfigKey(
        "retry.launch.attempts", "int", default=2,
        validator=in_range(1, None), importance="low",
        doc="Attempts per merged GCM launch of the window batcher (including "
            "the first) before it fails that class's waiters. A retry starts "
            "again from the packed input, which no launch writes; classes "
            "never share a launch, so a failure stays inside its class.",
    ))
    d.define(ConfigKey(
        "retry.launch.backoff.ms", "long", default=5,
        validator=in_range(0, None), importance="low",
        doc="Base backoff (ms) before a merged-launch re-dispatch; the "
            "actual sleep is decorrelated-jitter up to 4x this value.",
    ))
    d.define(ConfigKey(
        "faults.spec", "list", default=[], validator=_valid_fault_spec,
        importance="low",
        doc="Fault-plane rules 'site:kind[=arg][@trigger][~match]' "
            "(utils/faults.py) armed at RSM configure time — the same "
            "grammar as the TSTPU_FAULTS env var. site in [storage.read, "
            "storage.write, peer.forward, gossip.probe, device.launch, "
            "lifecycle.journal, lifecycle.sweep, *]; "
            "kind in [error, latency, partial, flaky]; trigger '@N', "
            "'@every=K', '@from=N', '@p=P'; '~match' restricts to keys "
            "containing the substring. Empty (the default) installs "
            "nothing: every seam's fire() stays a single attribute read.",
    ))
    d.define(ConfigKey(
        "faults.seed", "long", default=0, importance="low",
        doc="Seed for the fault plane's probabilistic triggers and latency "
            "ranges (deterministic for a given seed and call sequence).",
    ))
    d.define(ConfigKey(
        "replication.antientropy.enabled", "bool", default=False, importance="medium",
        doc="Run the background anti-entropy repairer when the storage "
            "backend is a ReplicatedStorageBackend: periodic passes diff "
            "the replicas by prefix, arbitrate divergent copies (manifest "
            "chunkChecksums for .log objects, majority/health otherwise), "
            "and copy missing/divergent objects back toward quorum.",
    ))
    d.define(ConfigKey(
        "replication.antientropy.interval.ms", "long", default=600_000,
        validator=in_range(1, None), importance="medium",
        doc="Period between anti-entropy passes.",
    ))
    d.define(ConfigKey(
        "replication.antientropy.rate.bytes", "int", default=8 * 1024 * 1024,
        validator=null_or(in_range(16 * 1024, INT_MAX)), importance="low",
        doc="Anti-entropy read/copy budget in bytes/s (token bucket) so "
            "replica diffing never starves foreground traffic; null "
            "disables throttling.",
    ))
    d.define(ConfigKey(
        "scrub.enabled", "bool", default=False, importance="medium",
        doc="Run the background integrity scrubber (scrub/): periodic "
            "passes enumerate stored objects, cross-check them against "
            "manifests, verify chunk CRC32C / GCM round-trips, and "
            "quarantine or repair what fails.",
    ))
    d.define(ConfigKey(
        "scrub.interval.ms", "long", default=300_000,
        validator=in_range(1, None), importance="medium",
        doc="Period between scrub passes; the first pass starts after a "
            "random jitter in [0, interval) so restarting fleets don't "
            "synchronize their scrub load.",
    ))
    d.define(ConfigKey(
        "scrub.rate.bytes", "int", default=8 * 1024 * 1024,
        validator=null_or(in_range(16 * 1024, INT_MAX)), importance="medium",
        doc="Scrub budget in bytes/s so scrubbing never starves foreground "
            "fetches; null disables throttling. Paces both halves of a "
            "pass: storage-IO walks through a host token bucket, and — "
            "when cross-request batching runs — device GCM verification "
            "through the window scheduler's background admission class.",
    ))
    d.define(ConfigKey(
        "scrub.repair.enabled", "bool", default=False, importance="medium",
        doc="Let the scrubber heal what it can: orphan objects are deleted, "
            "corrupt/missing objects are re-uploaded when a repair source "
            "is wired (Scrubber.repair_source).",
    ))
    d.define(ConfigKey(
        "scrub.checksums.enabled", "bool", default=False, importance="medium",
        doc="Record CRC32C of every transformed chunk in the manifest "
            "(chunkChecksums) at upload, giving scrub passes at-rest ground "
            "truth without detransforming. Adds one batched CRC pass per "
            "upload window (ops/crc32c), on the transform device.",
    ))
    d.define(ConfigKey(
        "lifecycle.enabled", "bool", default=False, importance="medium",
        doc="Arm the crash-consistent segment lifecycle plane: "
            "an upload intent journal (storage/lifecycle.py) records "
            "{segment, expected keys} before the first uploaded byte and "
            "marks commit when the manifest lands; delete tombstones make "
            "retried/crash-interrupted deletes converge; the recovery "
            "sweeper (scrub/sweeper.py) reconciles journal + store listing "
            "against manifest reachability on startup and on a paced "
            "period. Requires lifecycle.journal.path.",
    ))
    d.define(ConfigKey(
        "lifecycle.journal.path", "string", default=None,
        validator=non_empty_string, importance="medium",
        doc="Filesystem path of the upload intent journal (append-only "
            "JSONL WAL, fsynced per intent record, compacted in place). "
            "Must survive process restarts — put it next to the broker's "
            "log dirs, NOT on tmpfs. Required when lifecycle.enabled.",
    ))
    d.define(ConfigKey(
        "lifecycle.sweep.interval.ms", "long", default=300_000,
        validator=in_range(1, None), importance="medium",
        doc="Period between recovery sweeps; the first scheduled sweep "
            "starts after a random jitter in [0, interval) so restarting "
            "fleets don't synchronize their listing load.",
    ))
    d.define(ConfigKey(
        "lifecycle.sweep.on.start", "bool", default=True, importance="medium",
        doc="Run one synchronous recovery sweep during configure(), before "
            "serving — the crash-recovery path: anything the journal names "
            "as stranded by a previous process is deleted in this first "
            "sweep (zero permanent orphans after one sweep).",
    ))
    d.define(ConfigKey(
        "lifecycle.grace.ms", "long", default=14_400_000,
        validator=in_range(0, None), importance="medium",
        doc="Grace window for orphan candidates the journal does NOT name "
            "(another broker's in-flight upload on the fleet-shared "
            "prefix, a foreign journal's crash): deleted only after "
            "staying manifest-unreachable this long past the sweeper "
            "first seeing them. MUST comfortably exceed the slowest "
            "end-to-end segment upload (.log + .indexes + manifest) any "
            "fleet member can perform — the sweeper lists the shared "
            "prefix, so a peer's uncommitted objects are protected ONLY "
            "by this window, and a too-small value lets a sweep delete "
            "them mid-upload (cross-process data loss: the peer's "
            "manifest then lands referencing missing keys). The default "
            "is 4 hours; values under 10 minutes are warned about at "
            "startup. This process's own in-flight uploads are exempt "
            "via the journal's in-flight tracking, and journal-named "
            "orphans of finished operations need no grace — the journal "
            "proves no commit happened.",
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

    @property
    def upload_rate_limit(self) -> Optional[int]:
        return self._values["upload.rate.limit.bytes.per.second"]

    @property
    def retry_launch_attempts(self) -> int:
        return self._values["retry.launch.attempts"]

    @property
    def retry_launch_backoff_ms(self) -> int:
        return self._values["retry.launch.backoff.ms"]

    @property
    def scrub_enabled(self) -> bool:
        return self._values["scrub.enabled"]

    @property
    def scrub_interval_ms(self) -> int:
        return self._values["scrub.interval.ms"]

    @property
    def scrub_rate_bytes(self) -> Optional[int]:
        return self._values["scrub.rate.bytes"]

    @property
    def scrub_repair_enabled(self) -> bool:
        return self._values["scrub.repair.enabled"]

    @property
    def scrub_checksums_enabled(self) -> bool:
        return self._values["scrub.checksums.enabled"]

    @property
    def fault_injection_enabled(self) -> bool:
        return self._values["fault.injection.enabled"]

    @property
    def fault_schedule(self) -> list[str]:
        return self._values["fault.schedule"]

    @property
    def fault_seed(self) -> int:
        return self._values["fault.seed"]

    @property
    def faults_spec(self) -> list[str]:
        return self._values["faults.spec"]

    @property
    def faults_seed(self) -> int:
        return self._values["faults.seed"]

    @property
    def replication_antientropy_enabled(self) -> bool:
        return self._values["replication.antientropy.enabled"]

    @property
    def replication_antientropy_interval_ms(self) -> int:
        return self._values["replication.antientropy.interval.ms"]

    @property
    def replication_antientropy_rate_bytes(self) -> Optional[int]:
        return self._values["replication.antientropy.rate.bytes"]

    @property
    def lifecycle_enabled(self) -> bool:
        return self._values["lifecycle.enabled"]

    @property
    def lifecycle_journal_path(self) -> Optional[str]:
        return self._values["lifecycle.journal.path"]

    @property
    def lifecycle_sweep_interval_ms(self) -> int:
        return self._values["lifecycle.sweep.interval.ms"]

    @property
    def lifecycle_sweep_on_start(self) -> bool:
        return self._values["lifecycle.sweep.on.start"]

    @property
    def lifecycle_grace_ms(self) -> int:
        return self._values["lifecycle.grace.ms"]

    def fetch_indexes_cache_configs(self) -> dict[str, Any]:
        return subset_with_prefix(self._props, FETCH_INDEXES_CACHE_PREFIX)

    def fetch_manifest_cache_configs(self) -> dict[str, Any]:
        return subset_with_prefix(self._props, FETCH_MANIFEST_CACHE_PREFIX)
