"""RemoteStorageManager: the KIP-405-shaped orchestration layer.

Counterpart of tieredstorage_tpu/rsm.py (its `configure`,
`copy_log_segment_data`, `fetch_segment_manifest`, `fetch_log_segment`,
`fetch_index`, `delete_log_segment_data`, `set_segment_successor`, the
scrub, lifecycle and anti-entropy accessors, the observability payloads and
`close`), the failure policy, the SLO engine and fleet mode.

Fleet mode, as in the JAX package (`fleet.*`): a consistent-hash router
(fleet/ring.py) gives every segment object key R owners, and the chunk
chain gains a `PeerChunkCache` tier below the local caches that resolves a
miss with one `GET /chunk` hop to the first live owner (whose
`fleet_fetch_chunks` serves it through its own chunk path and card) before
falling back to the local store. `fleet.gossip.enabled` runs the SWIM-style
membership daemon (fleet/gossip.py, started by `start_fleet_gossip`), and
the fleet's telemetry (fleet/telemetry.py) serves this member's samples
and the merged fleet-wide scrape.

Failure policy, as in the JAX package: each KIP-405 operation runs under an
end-to-end deadline (`_traced`: the caller's ambient one, else
`deadline.default.ms`), and an expired one fails before any storage call.
`breaker.enabled` and `retry.budget.enabled` wrap the store in a
`ResilientStorageBackend` (storage/resilient.py) above the fault-injecting
backend: a circuit breaker that fails fast once the store has failed
`breaker.failure.threshold` times in a row, and budgeted retries.
`hedge.enabled` races a straggling chunk-window GET against a second one
(fetch/hedge.py), below the decrypt; `admission.enabled` builds the entry
gate (utils/admission.py) that a service boundary acquires around each
request; `slo.enabled` runs the SLO engine (metrics/slo.py) over the
operation metrics, served by `slo_status`.

Observability, as in the JAX package: `configure` always creates the
operation metrics (`Metrics`, metrics/rsm_metrics.py) and the tracer, flight
recorder and scheduler timeline of `tracing.*`, `flight.*` and `timeline.*`
(each zero-work when disabled). The four KIP-405 operations run under a
span and a flight record (`_traced`); copies, fetches and deletes record
their metric families; the fetch tiers, the batcher, the scrubber, the
lifecycle plane, the replicated store and the cloud backends publish their
groups into the one registry `metrics.registry` (or, for the backends'
request metrics, their own). `metrics/prometheus.PrometheusExporter` serves
them; `close()` writes `tracing.export.path`.

Fault injection, as in the JAX package: `fault.injection.enabled` wraps the
store in a `FaultInjectingBackend` running `fault.schedule`, and
`faults.spec` installs the process fault plane (utils/faults.py), whose
seams here are `storage.write` (`_storage_upload`, the one upload
chokepoint), `storage.read` (chunk windows and index reads),
`device.launch` (the batcher's merged launch) and the lifecycle sites.

With `lifecycle.enabled` an upload intent journal (storage/lifecycle.py)
names a copy's three keys before its first byte and a delete's before its
first delete; a recovery sweeper (scrub/sweeper.py) reconciles journal and
store against manifest reachability at start and on a period, and its
quarantined manifests are never served. With
`replication.antientropy.enabled` over a replicated store, the
anti-entropy repairer (scrub/antientropy.py) converges the replicas, its
CRC32C arbitration on the transform backend's device.

With `transform.batch.enabled` the backend runs the window batcher; the RSM
hands it the launch retry policy (`retry.launch.*`). With `scrub.enabled` it
builds the scrubber and its scheduler: `scrub.rate.bytes` paces the pass's
storage reads through a token bucket and, when the batcher runs, becomes
its background admission rate; corrupt objects go through the chunk
manager's quarantine. `scrub.checksums.enabled` records each transformed
chunk's CRC32C in the manifest at copy, and
`upload.rate.limit.bytes.per.second` paces the `.log` upload.

Fetches go through the fetch plane, as in the JAX package: the manifest and
indexes caches are on in every configuration, and the chunk path is the
factory's chain `[Readahead] → [ChunkCache] → [DeviceHotCache] →
DefaultChunkManager` (fetch/factory.py).

A copy uploads three objects — the transformed segment (`.log`), the
concatenated transformed indexes (`.indexes`) and the manifest
(`.rsm-manifest`, last: its presence commits the segment) — and deletes the
ones already uploaded when a later step fails. The wire format (chunks of
`IV || ciphertext || tag`, manifest JSON, object keys) is the JAX package's,
so a segment written by either package reads back through the other.
"""

from __future__ import annotations

import contextlib
import functools
import io
import logging
import time
from pathlib import Path
from typing import BinaryIO, Mapping, Optional

from tieredstorage_tpu_torch.config.rsm_config import RemoteStorageManagerConfig
from tieredstorage_tpu_torch.custom_metadata import (
    SegmentCustomMetadataBuilder,
    SegmentCustomMetadataField,
    deserialize_custom_metadata,
    serialize_custom_metadata,
)
from tieredstorage_tpu_torch.errors import (
    RemoteResourceNotFoundException,
    RemoteStorageException,
)
from tieredstorage_tpu_torch.fetch.cache.chunk_cache import ChunkCache
from tieredstorage_tpu_torch.fetch.cache.device_hot import DeviceHotCache
from tieredstorage_tpu_torch.fetch.chunk_manager import ChunkManager, DefaultChunkManager
from tieredstorage_tpu_torch.fetch.enumeration import FetchChunkEnumeration
from tieredstorage_tpu_torch.fetch.factory import ChunkManagerFactory
from tieredstorage_tpu_torch.fetch.hedge import HedgeBudget, Hedger
from tieredstorage_tpu_torch.fetch.index_cache import MemorySegmentIndexesCache
from tieredstorage_tpu_torch.fetch.manifest_cache import (
    ManifestLookahead,
    MemorySegmentManifestCache,
)
from tieredstorage_tpu_torch.fetch.readahead import ReadaheadManager
from tieredstorage_tpu_torch.fleet import (
    FleetMetrics,
    FleetRouter,
    GossipAgent,
    PeerChunkCache,
    parse_instances,
    register_fleet_metrics,
)
from tieredstorage_tpu_torch.kafka_records import (
    InvalidRecordBatchException,
    segment_looks_compressed,
)
from tieredstorage_tpu_torch.manifest.encryption_metadata import SegmentEncryptionMetadataV1
from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType, SegmentIndexesV1Builder
from tieredstorage_tpu_torch.manifest.segment_manifest import (
    SegmentManifestV1,
    manifest_from_json,
    manifest_to_json,
)
from tieredstorage_tpu_torch.metadata import LogSegmentData, RemoteLogSegmentMetadata
from tieredstorage_tpu_torch.metrics.cache_metrics import (
    DiskCacheMetrics,
    register_cache_metrics,
    register_thread_pool_metrics,
)
from tieredstorage_tpu_torch.metrics.core import MetricConfig
from tieredstorage_tpu_torch.metrics.rsm_metrics import (
    Metrics,
    register_resilience_metrics,
    register_tracer_metrics,
)
from tieredstorage_tpu_torch.metrics.timeline import NOOP_TIMELINE, TimelineRecorder
from tieredstorage_tpu_torch.object_key import ObjectKeyFactory, Suffix
from tieredstorage_tpu_torch.security.aes import AesEncryptionProvider, DataKeyAndAAD
from tieredstorage_tpu_torch.security.rsa import RsaEncryptionProvider
from tieredstorage_tpu_torch.storage.core import (
    BytesRange,
    KeyNotFoundException,
    ObjectKey,
    StorageBackend,
    StorageBackendException,
)
from tieredstorage_tpu_torch.storage.replicated import ReplicatedStorageBackend
from tieredstorage_tpu_torch.storage.resilient import (
    CircuitBreaker,
    ResilientStorageBackend,
    RetryBudget,
)
from tieredstorage_tpu_torch.transform.api import (
    DEFAULT_DEVICE,
    DetransformOptions,
    TransformOptions,
    checksum_device,
)
from tieredstorage_tpu_torch.transform.pipeline import SegmentTransformation
from tieredstorage_tpu_torch.utils import deadline as deadline_util
from tieredstorage_tpu_torch.utils import faults, flightrecorder as flight
from tieredstorage_tpu_torch.utils.admission import AdmissionController
from tieredstorage_tpu_torch.utils.deadline import check_deadline, ensure_deadline
from tieredstorage_tpu_torch.utils.flightrecorder import NOOP_RECORDER, FlightRecorder
from tieredstorage_tpu_torch.utils.ratelimit import RateLimitedStream, TokenBucket
from tieredstorage_tpu_torch.utils.streams import ClosableStreamHolder
from tieredstorage_tpu_torch.utils.tracing import NOOP_TRACER, Tracer

log = logging.getLogger(__name__)


def _traced(name: str):
    """Span around an RSM operation, tagged with topic/partition and the
    calling thread's CPU time (`cpu_s`); the spans also open torch.profiler
    ranges when `tracing.jax.profiler.enabled`.

    Also the deadline entry point: the operation adopts the caller's
    ambient end-to-end Deadline or starts one from `deadline.default.ms`,
    and an already-expired budget fails fast here — before any storage
    work.

    The flight recorder opens its per-request record here too, keyed by the
    span's trace id — reentrant, so an outer layer that already opened one
    for the whole request keeps one record."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, metadata, *args, **kwargs):
            tp = metadata.remote_log_segment_id.topic_id_partition.topic_partition
            with ensure_deadline(self.default_deadline_s), \
                    self.tracer.span(
                        name, thread_cpu=True, topic=tp.topic, partition=tp.partition
                    ) as span, \
                    self.flight_recorder.request(
                        name, trace_id=span.trace_id if span else None
                    ):
                check_deadline(name)
                return fn(self, metadata, *args, **kwargs)

        return wrapper

    return deco


class RemoteStorageManager:
    """Configure once, then copy/fetch/delete segments."""

    def __init__(self) -> None:
        self._config: Optional[RemoteStorageManagerConfig] = None
        self._storage: Optional[StorageBackend] = None
        self._transform_backend = None
        self._object_key_factory: Optional[ObjectKeyFactory] = None
        self._rsa: Optional[RsaEncryptionProvider] = None
        self._chunk_manager: Optional[ChunkManager] = None
        self._device_hot: Optional[DeviceHotCache] = None
        self._readahead: Optional[ReadaheadManager] = None
        self._manifest_cache: Optional[MemorySegmentManifestCache] = None
        self._manifest_lookahead: Optional[ManifestLookahead] = None
        self._indexes_cache: Optional[MemorySegmentIndexesCache] = None
        self._rate_bucket: Optional[TokenBucket] = None
        self._scrubber = None
        self._scrub_scheduler = None
        self._fault_schedule = None
        self._replicated: Optional[ReplicatedStorageBackend] = None
        self._antientropy = None
        self._antientropy_scheduler = None
        self._lifecycle_journal = None
        self._sweeper = None
        self._sweep_scheduler = None
        self._metrics: Optional[Metrics] = None
        self._breaker: Optional[CircuitBreaker] = None
        self._retry_budget: Optional[RetryBudget] = None
        self._hedger: Optional[Hedger] = None
        #: SLO engine (`slo.enabled`): burn rates and verdicts (`slo_status`).
        self._slo = None
        #: Entry-gate admission controller (`admission.enabled`); a service
        #: boundary acquires and releases it around each request.
        self.admission: Optional[AdmissionController] = None
        self.tracer = NOOP_TRACER
        #: Per-request flight recorder (`flight.enabled`); the RSM entries
        #: open records, the fetch tiers enrich them.
        self.flight_recorder: FlightRecorder = NOOP_RECORDER
        #: Device-scheduler timeline ring (`timeline.enabled`): merged-launch
        #: attribution served by `timeline_status` (metrics/timeline.py).
        self.timeline: TimelineRecorder = NOOP_TIMELINE
        #: Fleet-wide telemetry aggregator (fleet mode).
        self._fleet_telemetry = None
        #: Fleet mode (`fleet.*`): consistent-hash router + peer cache tier.
        self.fleet_router: Optional[FleetRouter] = None
        self._peer_cache: Optional[PeerChunkCache] = None
        self._fleet_metrics: Optional[FleetMetrics] = None
        self._gossip: Optional[GossipAgent] = None

    # ------------------------------------------------------------------ setup
    def configure(self, configs: Mapping[str, object]) -> None:
        config = RemoteStorageManagerConfig(configs)
        self._metrics = Metrics(MetricConfig(
            num_samples=config.metrics_num_samples,
            sample_window_ms=config.metrics_sample_window_ms,
            recording_level=config.metrics_recording_level,
        ))
        self.tracer = Tracer(
            enabled=config.tracing_enabled,
            use_jax_profiler=config.tracing_jax_profiler_enabled,
            max_spans=config.tracing_max_spans,
        )
        self.flight_recorder = FlightRecorder(
            enabled=config.flight_enabled,
            ring_size=config.flight_ring_size,
        )
        storage = config.storage_backend_class()
        storage.configure(config.storage_configs())
        storage = self._wrap_storage_resilience(config, storage)
        backend = config.transform_backend_class()
        backend.configure(config.transform_configs())
        backend.tracer = self.tracer
        self.timeline = TimelineRecorder(
            enabled=config.timeline_enabled,
            ring_size=config.timeline_ring_size,
        )
        batcher = getattr(backend, "batcher", None)
        if batcher is not None:
            batcher.timeline = self.timeline
            batcher.set_launch_retry(
                config.retry_launch_attempts, config.retry_launch_backoff_ms / 1000.0
            )
        rsa = None
        if config.encryption_enabled:
            rsa = RsaEncryptionProvider.from_pem_files(
                config.encryption_key_pair_id, config.encryption_key_pair_paths
            )
        self._config = config
        self._storage = storage
        self._transform_backend = backend
        self._object_key_factory = ObjectKeyFactory(config.key_prefix, config.key_prefix_mask)
        self._rsa = rsa
        if config.upload_rate_limit is not None:
            self._rate_bucket = TokenBucket(config.upload_rate_limit)
        self._wire_fleet_router(config)
        self._chunk_manager = self._build_chunk_manager(backend)
        self._wire_fetch_observability()
        self._wire_tail_tolerance(config)
        self._manifest_cache = MemorySegmentManifestCache()
        self._manifest_cache.configure(config.fetch_manifest_cache_configs())
        self._manifest_lookahead = ManifestLookahead(self._manifest_cache)
        self._indexes_cache = MemorySegmentIndexesCache()
        self._indexes_cache.configure(config.fetch_indexes_cache_configs())
        self._register_cache_metrics()
        self._register_resilience_metrics()
        register_tracer_metrics(self._metrics.registry, self.tracer)
        self._wire_replication(config)
        self._wire_scrubber(config)
        self._wire_lifecycle(config)
        self._wire_slo(config)
        self._wire_fleet_telemetry(config)

    def _transform_device(self):
        """The configured `transform.device` (`cuda:0` by default)."""
        return self._config.transform_configs().get("device", DEFAULT_DEVICE)

    def _checksum_device(self):
        """Where this RSM's CRC32C runs: the transform backend's device, or
        `transform.device` for a host backend (api.checksum_device)."""
        return checksum_device(self._transform_backend, self._transform_device())

    def _wrap_storage_resilience(
        self, config: RemoteStorageManagerConfig, storage: StorageBackend
    ) -> StorageBackend:
        """Layering (innermost first): backend → fault injection
        (`fault.injection.enabled` runs `fault.schedule`) → circuit breaker
        + retry budget, so injected faults exercise the breaker and the
        budgeted retries the same way real outages do. `faults.spec`
        installs the process-wide fault plane (utils/faults.py) across the
        I/O seams; its `storage.read` seam fires in the chunk manager,
        above this stack, so its errors never reach the breaker."""
        if config.fault_injection_enabled:
            from tieredstorage_tpu_torch.faults import FaultInjectingBackend, FaultSchedule

            self._fault_schedule = FaultSchedule.parse(
                config.fault_schedule, seed=config.fault_seed
            )
            storage = FaultInjectingBackend(storage, self._fault_schedule)
            log.warning(
                "Fault injection ENABLED with %d rule(s); storage calls will "
                "be deliberately failed/corrupted/slowed", len(self._fault_schedule),
            )
        if config.faults_spec:
            plane = faults.FaultPlane.parse(
                config.faults_spec, seed=config.faults_seed
            )
            faults.install(plane)
            log.warning(
                "Fault plane ENABLED with %d rule(s) across the I/O seams; "
                "calls will be deliberately failed/torn/slowed",
                len(plane.rules),
            )
        if config.breaker_enabled:
            self._breaker = CircuitBreaker(
                failure_threshold=config.breaker_failure_threshold,
                cooldown_s=config.breaker_cooldown_ms / 1000.0,
                on_transition=lambda old, new: self.tracer.event(
                    "storage.breaker.transition", from_state=old.name, to_state=new.name
                ),
            )
        if config.retry_budget_enabled:
            self._retry_budget = RetryBudget(
                config.retry_budget_percent,
                capacity=float(config.retry_budget_capacity),
            )
        if self._breaker is not None or self._retry_budget is not None:
            storage = ResilientStorageBackend(
                storage,
                self._breaker,
                retry_budget=self._retry_budget,
                max_attempts=config.retry_budget_max_attempts,
                backoff_s=config.retry_budget_backoff_ms / 1000.0,
                tracer=self.tracer,
            )
        return storage

    def _wire_replication(self, config: RemoteStorageManagerConfig) -> None:
        """When the storage backend is (or wraps) a ReplicatedStorageBackend:
        hand it the tracer and the failover-time histogram hook, export the
        replication-metrics gauges, and start the anti-entropy repair daemon
        (`replication.antientropy.*`)."""
        self._replicated = self._find_replicated(self._storage)
        if self._replicated is None:
            return
        from tieredstorage_tpu_torch.metrics.rsm_metrics import (
            register_replication_metrics,
        )

        self._replicated.tracer = self.tracer
        record_failover = self._metrics.record_replica_failover

        def on_failover(ms: float) -> None:
            # Histogram + the ambient flight record (one failover hop of
            # THIS request) — the recorder helper is a no-op without one.
            record_failover(ms)
            flight.note("replica.failover_hops")

        self._replicated.on_failover = on_failover
        if config.replication_antientropy_enabled:
            from tieredstorage_tpu_torch.scrub.antientropy import (
                AntiEntropyRepairer,
                AntiEntropyScheduler,
            )

            rate = config.replication_antientropy_rate_bytes
            self._antientropy = AntiEntropyRepairer(
                self._replicated,
                prefix=config.key_prefix,
                rate_bucket=TokenBucket(rate) if rate is not None else None,
                tracer=self.tracer,
                device=self._checksum_device(),
            )
            self._antientropy_scheduler = AntiEntropyScheduler(
                self._antientropy,
                interval_ms=config.replication_antientropy_interval_ms,
            ).start()
            log.info(
                "Anti-entropy repair enabled: interval=%dms rate=%s",
                config.replication_antientropy_interval_ms, rate,
            )
        register_replication_metrics(
            self._metrics.registry,
            replicated=self._replicated,
            antientropy=self._antientropy,
        )

    @staticmethod
    def _find_replicated(storage) -> Optional[ReplicatedStorageBackend]:
        """Unwrap the resilience/fault decorators (each exposes `delegate`)
        down to a ReplicatedStorageBackend, if one is in the stack."""
        seen = 0
        while storage is not None and seen < 8:
            if isinstance(storage, ReplicatedStorageBackend):
                return storage
            storage = getattr(storage, "delegate", None)
            seen += 1
        return None

    @property
    def antientropy(self):
        """The anti-entropy repairer (None unless
        ``replication.antientropy.enabled`` over a replicated store)."""
        return self._antientropy

    @property
    def antientropy_scheduler(self):
        return self._antientropy_scheduler

    def _wire_fleet_router(self, config: RemoteStorageManagerConfig) -> None:
        """Fleet mode (`fleet.*`): build the consistent-hash router BEFORE
        the chunk manager — `_build_chunk_manager` inserts the
        PeerChunkCache tier (route → forward-to-owner → local single-flight
        backend fetch) between the local chunk cache and the default
        manager. Static membership comes from `fleet.instances`; dynamic
        deployments call `set_fleet_peers` once gateway ports are known."""
        if not config.fleet_enabled:
            return
        self.fleet_router = FleetRouter(
            config.fleet_instance_id,
            vnodes=config.fleet_vnodes,
            tracer=self.tracer,
        )
        static = parse_instances(config.fleet_instances)
        if static:
            self.fleet_router.set_membership(static)
        if config.fleet_gossip_enabled:
            # Seeded from the static list (which becomes the SEED set only:
            # gossip owns membership from here). Started explicitly via
            # start_fleet_gossip once the gateway is up — probing peers
            # before this instance can answer them would just spread
            # suspicion of ourselves.
            self._gossip = GossipAgent(
                self.fleet_router,
                interval_s=config.fleet_gossip_interval_ms / 1000.0,
                probe_timeout_s=config.fleet_gossip_probe_timeout_ms / 1000.0,
                suspect_periods=config.fleet_gossip_suspect_periods,
                dead_periods=config.fleet_gossip_dead_periods,
                probe_retries=config.retry_gossip_probe_attempts - 1,
                breaker_threshold=config.breaker_gossip_failure_threshold,
                tracer=self.tracer,
            )
        self._fleet_metrics = FleetMetrics(self._metrics.registry)
        log.info(
            "Fleet mode enabled: instance=%s vnodes=%d replication=%d "
            "gossip=%s members=%s",
            config.fleet_instance_id, config.fleet_vnodes,
            config.fleet_replication_factor, config.fleet_gossip_enabled,
            sorted(self.fleet_router.peers) or [config.fleet_instance_id],
        )

    @property
    def peer_chunk_cache(self) -> Optional[PeerChunkCache]:
        return self._peer_cache

    @property
    def gossip_agent(self) -> Optional[GossipAgent]:
        return self._gossip

    def set_fleet_peers(self, peers: Mapping[str, Optional[str]]) -> None:
        """Replace fleet membership with {name: base_url|None} — the
        bootstrap hook for deployments whose gateway ports are only known
        after bind, and the demotion hook when a member is declared dead
        (bounded key movement: only the arcs of the changed instances
        move). Under gossip this reseeds the agent: the entries join the
        probe set, and membership is gossip's from there."""
        if self.fleet_router is None:
            raise RemoteStorageException("fleet mode is not enabled")
        self.fleet_router.set_membership(peers)
        if self._gossip is not None:
            self._gossip.seed(peers)

    def warm_up_device(self) -> bool:
        """Make the transform backend's device ready before the first
        request (`CudaTransformBackend.warm_up`: the CUDA context, the
        kernel library, allocator blocks and a staging buffer of one
        chunk), where encryption is on and the backend runs on a CUDA
        device; else nothing. Without it a process's first decrypt pays for
        them, seconds on the card: past a fleet peer's
        `fleet.forward.timeout.ms` when that decrypt is a failover's. The
        sidecar CLI calls it before SIDECAR_READY. Returns whether it
        warmed."""
        backend = self._transform_backend
        warm_up = getattr(backend, "warm_up", None)
        if warm_up is None or not self._config.encryption_enabled:
            return False
        if backend.device.type != "cuda":
            return False
        warm_up(self._config.chunk_size)
        return True

    def start_fleet_gossip(self) -> Optional[GossipAgent]:
        """Start the gossip membership daemon (`fleet.gossip.enabled`).
        Called once the HTTP gateway is bound — the sidecar CLI does this
        after SIDECAR_READY so inbound /fleet/gossip probes can be
        answered from the first period."""
        if self._gossip is not None:
            self._gossip.start()
        return self._gossip

    def fleet_gossip(self, payload: Mapping) -> dict:
        """Serve one inbound gossip exchange (the gateway's POST
        /fleet/gossip): merge the sender's view, answer with ours."""
        if self._gossip is None:
            raise RemoteStorageException("fleet gossip is not enabled")
        return self._gossip.on_gossip(payload)

    def fleet_ping(self, *, include_witness: bool = False) -> dict:
        """Liveness/status body for the gateway's GET /fleet/ping: ring
        state, the gossip view, peer-tier counters, the store's fetch calls
        when `fault.injection.enabled` counts them, and (on request) the
        runtime witness's verdict: the lock-order violations, and the race
        model's cross-check of the static guarded-by inference against the
        mutations the race witness saw (analysis/races.py)."""
        if self.fleet_router is None:
            raise RemoteStorageException("fleet mode is not enabled")
        router = self.fleet_router
        status: dict = {
            "instance": router.instance_id,
            "generation": router.generation,
            "view_epoch": router.view_epoch,
            "ring_instances": sorted(router.instances),
        }
        if self._gossip is not None:
            status["gossip"] = {
                "epoch": self._gossip.epoch,
                "periods": self._gossip.periods,
                "members": {
                    name: {"status": m.status, "incarnation": m.incarnation}
                    for name, m in self._gossip.members().items()
                },
            }
        if self._peer_cache is not None:
            cache = self._peer_cache
            status["peer_cache"] = {
                "replication": cache.replication,
                "forwards": cache.forwards,
                "peer_hits": cache.peer_hits,
                "peer_misses": cache.peer_misses,
                "forward_failures": cache.forward_failures,
                "failover_hits": cache.failover_hits,
            }
        if self._fault_schedule is not None:
            status["storage_fetch_calls"] = self._fault_schedule.calls("fetch")
        if include_witness:
            from tieredstorage_tpu_torch.analysis import races
            from tieredstorage_tpu_torch.utils.locks import witness, witness_enabled

            crosscheck = races.runtime_crosscheck()
            status["witness"] = {
                "enabled": witness_enabled(),
                "lock_violations": list(witness().violations),
                "race_violations": crosscheck["violations"],
                "race_sites_observed": crosscheck["validated"],
            }
        return status

    def fleet_fetch_chunks(
        self, object_key_value: str, first: int, last: int
    ) -> list[bytes]:
        """Serve a window of plaintext chunks of a locally-owned segment to
        a fleet sibling (the gateway's GET /chunk route). Runs through this
        instance's FULL chunk path — local cache hit, else single-flight
        backend fetch and the decrypt on this instance's device — with the
        key pinned local so a forwarded request is never re-forwarded,
        even under transient ring disagreement."""
        if self.fleet_router is None:
            raise RemoteStorageException("fleet mode is not enabled")
        base, _, suffix = object_key_value.rpartition(".")
        if not base or suffix != Suffix.LOG.value:
            raise ValueError(
                f"peer chunk reads serve .log objects only, got {object_key_value!r}"
            )
        if first < 0 or last < first:
            raise ValueError(f"invalid chunk window {first}-{last}")
        manifest_key = ObjectKey(f"{base}.{Suffix.MANIFEST.value}")
        with ensure_deadline(self.default_deadline_s):
            check_deadline("fleet chunk serve")
            self._check_not_quarantined(manifest_key)
            manifest = self._manifest_lookahead.get(
                manifest_key, lambda: self._fetch_manifest_by_key(manifest_key)
            )
            if last >= manifest.chunk_index.chunk_count:
                raise ValueError(
                    f"chunk window {first}-{last} beyond "
                    f"{manifest.chunk_index.chunk_count} chunks"
                )
            pin = (
                self._peer_cache.serving_locally(object_key_value)
                if self._peer_cache is not None
                else contextlib.nullcontext()
            )
            with pin:
                return self._chunk_manager.get_chunks(
                    ObjectKey(object_key_value), manifest,
                    list(range(first, last + 1)),
                )

    def _wire_lifecycle(self, config: RemoteStorageManagerConfig) -> None:
        """Crash-consistent lifecycle plane (`lifecycle.*`): the upload
        intent journal names what a crash may strand BEFORE the first
        uploaded byte; the recovery sweeper reconciles journal + store
        listing against manifest reachability — synchronously once at
        startup (the crash-recovery path), then on a paced period.
        Manifest-last upload stays the sole commit point; the sweeper may
        only ever delete manifest-UNreachable objects."""
        if not config.lifecycle_enabled:
            return
        from tieredstorage_tpu_torch.config.configdef import ConfigException
        from tieredstorage_tpu_torch.metrics.lifecycle_metrics import (
            register_lifecycle_metrics,
        )
        from tieredstorage_tpu_torch.scrub.sweeper import RecoverySweeper, SweepScheduler
        from tieredstorage_tpu_torch.storage.lifecycle import UploadIntentJournal

        if not config.lifecycle_journal_path:
            raise ConfigException(
                "lifecycle.enabled requires lifecycle.journal.path"
            )
        self._lifecycle_journal = UploadIntentJournal(
            Path(config.lifecycle_journal_path)
        )
        if config.lifecycle_grace_ms < 600_000:
            # The grace window is the ONLY protection for a fleet peer's
            # in-progress upload on the shared prefix (this process's own
            # are exempt via in-flight tracking); below the slowest
            # end-to-end segment upload it becomes cross-process data loss.
            log.warning(
                "lifecycle.grace.ms=%d is under 10 minutes: any fleet "
                "peer's segment upload outlasting it can have its "
                "uncommitted objects swept mid-upload. Size it above the "
                "slowest end-to-end upload (default 4h).",
                config.lifecycle_grace_ms,
            )

        def load_manifest(manifest_key: str) -> SegmentManifestV1:
            return self._fetch_manifest_raw(ObjectKey(manifest_key))

        self._sweeper = RecoverySweeper(
            self._storage,
            self._lifecycle_journal,
            prefix=config.key_prefix,
            grace_s=config.lifecycle_grace_ms / 1000.0,
            manifest_loader=load_manifest,
            tracer=self.tracer,
        )
        if config.lifecycle_sweep_on_start:
            try:
                report = self._sweeper.sweep_once()
                if report.orphans_deleted or report.quarantined:
                    log.info(
                        "Startup recovery sweep: %d orphan(s) deleted, "
                        "%d manifest(s) quarantined",
                        len(report.orphans_deleted), len(report.quarantined),
                    )
            except Exception:  # noqa: BLE001 — recovery must not block startup
                log.warning("Startup recovery sweep failed; the paced "
                            "scheduler will retry", exc_info=True)
        self._sweep_scheduler = SweepScheduler(
            self._sweeper, interval_ms=config.lifecycle_sweep_interval_ms
        ).start()
        register_lifecycle_metrics(
            self._metrics.registry, self._lifecycle_journal, self._sweeper,
            self._sweep_scheduler,
        )
        log.info(
            "Lifecycle plane enabled: journal=%s sweep_interval=%dms "
            "grace=%dms",
            config.lifecycle_journal_path, config.lifecycle_sweep_interval_ms,
            config.lifecycle_grace_ms,
        )

    @property
    def lifecycle_journal(self):
        return self._lifecycle_journal

    @property
    def recovery_sweeper(self):
        return self._sweeper

    @property
    def sweep_scheduler(self):
        return self._sweep_scheduler

    def lifecycle_status(self) -> dict:
        """JSON-shaped lifecycle plane status (journal + sweeper)."""
        if self._lifecycle_journal is None:
            raise RemoteStorageException("lifecycle plane is not enabled")
        out = {"journal": self._lifecycle_journal.status()}
        if self._sweep_scheduler is not None:
            out["sweeper"] = self._sweep_scheduler.status()
        return out

    def _wire_slo(self, config: RemoteStorageManagerConfig) -> None:
        """SLO engine (`slo.*`): declarative objectives over the histograms
        and counters the earlier wiring just built — fetch latency against
        the deadline budget, request-visible error rate, the admission shed
        rate, (opt-in) a chunk-cache hit floor and the readahead
        misprediction bound. Gauges land in the slo-metrics group;
        `slo_status` serves the verdicts."""
        if not config.slo_enabled:
            return
        from tieredstorage_tpu_torch.metrics.slo import (
            HistogramLatencySource,
            RatioSource,
            SloEngine,
            SloSpec,
        )

        metrics = self._metrics
        specs: list = []
        threshold_ms = config.slo_fetch_latency_threshold_ms
        if threshold_ms is None:
            threshold_ms = config.deadline_default_ms
        if threshold_ms is not None:
            objective = config.slo_fetch_latency_objective_percent / 100.0
            specs.append(SloSpec(
                name="fetch-latency",
                description=(
                    f"p{config.slo_fetch_latency_objective_percent} chunk "
                    f"fetch within {threshold_ms} ms (the deadline budget)"
                ),
                objective=objective,
                source=HistogramLatencySource(
                    metrics, "chunk-fetch-time", float(threshold_ms)
                ),
            ))
        inner = self._innermost_chunk_manager(self._chunk_manager)

        def fetch_errors() -> float:
            bad = float(deadline_util.exceeded_total())
            if inner is not None:
                bad += float(inner.corruptions)
            return bad

        def fetch_events() -> float:
            return float(
                metrics.histogram_count("chunk-fetch-time")
            ) + fetch_errors()

        specs.append(SloSpec(
            name="fetch-errors",
            description=(
                "chunk fetches without a request-visible failure "
                "(detransform corruption, deadline expiry)"
            ),
            objective=config.slo_error_rate_objective_percent / 100.0,
            source=RatioSource(
                good=lambda: fetch_events() - fetch_errors(),
                total=fetch_events,
            ),
        ))
        if self.admission is not None:
            admission = self.admission
            specs.append(SloSpec(
                name="shed-rate",
                description=(
                    f"requests admitted past the entry gate (sheds bounded "
                    f"at {config.slo_shed_rate_max_percent}%)"
                ),
                objective=1.0 - config.slo_shed_rate_max_percent / 100.0,
                source=RatioSource(
                    good=lambda: float(admission.admitted_total),
                    total=lambda: float(
                        admission.admitted_total + admission.shed_total
                    ),
                ),
            ))
        floor = config.slo_cache_hit_floor_percent
        chunk_cache = self._chunk_cache_tier(self._chunk_manager)
        if floor > 0 and chunk_cache is not None:
            stats = chunk_cache.stats
            specs.append(SloSpec(
                name="cache-hit",
                description=f"chunk-cache hit rate floor ({floor}%)",
                objective=floor / 100.0,
                source=RatioSource(
                    good=lambda: float(stats.hits),
                    total=lambda: float(stats.hits + stats.misses),
                ),
            ))
        if self._readahead is not None:
            readahead = self._readahead
            bound = readahead.misprediction_max_ratio
            specs.append(SloSpec(
                name="readahead-misprediction",
                description=(
                    "speculated decrypt bytes later consumed by the stream "
                    f"(wasted bytes bounded at {bound:.0%} — "
                    "readahead.misprediction.max.ratio)"
                ),
                objective=1.0 - bound,
                source=RatioSource(
                    good=lambda: float(
                        readahead.bytes_speculated - readahead.wasted_bytes
                    ),
                    total=lambda: float(readahead.bytes_speculated),
                ),
            ))
        self._slo = SloEngine(
            specs,
            short_window_s=config.slo_window_short_ms / 1000.0,
            long_window_s=config.slo_window_long_ms / 1000.0,
        )
        self._slo.register_gauges(self._metrics.registry)
        log.info(
            "SLO engine enabled: specs=%s windows=%d/%dms",
            [s.name for s in specs], config.slo_window_short_ms,
            config.slo_window_long_ms,
        )

    @property
    def slo_engine(self):
        return self._slo

    def slo_status(self) -> dict:
        """Verdict payload (evaluates: every read is also a burn-rate window
        tick, the Prometheus model)."""
        if self._slo is None:
            raise RemoteStorageException("SLO engine is not enabled")
        return {"enabled": True, **self._slo.evaluate()}

    def _wire_scrubber(self, config: RemoteStorageManagerConfig) -> None:
        """Background integrity scrubbing (scrub/): enumerate + verify +
        quarantine/repair on a jittered period. `scrub.rate.bytes` paces
        both halves of a pass: the host TokenBucket throttles its storage
        reads, and, when the transform backend runs the window batcher, the
        same rate becomes the batcher's background admission class (the
        scrubber's verification decrypts submit under
        `work_class_scope(BACKGROUND)`)."""
        if not config.scrub_enabled:
            return
        from tieredstorage_tpu_torch.scrub import ScrubMetrics, ScrubScheduler, Scrubber
        from tieredstorage_tpu_torch.scrub.metrics import register_scrub_metrics

        rate = config.scrub_rate_bytes
        if rate is not None:
            batcher = getattr(self._transform_backend, "batcher", None)
            if batcher is not None:
                from tieredstorage_tpu_torch.transform.scheduler import BACKGROUND

                batcher.set_class_rate(BACKGROUND, rate)
        inner = self._innermost_chunk_manager(self._chunk_manager)
        self._scrubber = Scrubber(
            self._storage,
            prefix=config.key_prefix,
            transform_backend=self._transform_backend,
            data_key_decoder=self._rsa.data_key_decoder if self._rsa else None,
            rate_bucket=TokenBucket(rate) if rate is not None else None,
            repair_enabled=config.scrub_repair_enabled,
            quarantine=inner.quarantine if inner is not None else None,
            tracer=self.tracer,
            metrics=ScrubMetrics(self._metrics.registry),
            device=self._checksum_device(),
        )
        self._scrub_scheduler = ScrubScheduler(
            self._scrubber, interval_ms=config.scrub_interval_ms
        )
        register_scrub_metrics(
            self._metrics.registry, self._scrubber, self._scrub_scheduler
        )
        self._scrub_scheduler.start()
        log.info(
            "Integrity scrubber enabled: interval=%dms rate=%s repair=%s",
            config.scrub_interval_ms, rate, config.scrub_repair_enabled,
        )

    @staticmethod
    def _innermost_chunk_manager(cm) -> Optional[DefaultChunkManager]:
        """Unwrap the chunk-manager tiers (each exposes `_delegate`) down to
        the backend-fetching manager that holds the quarantine."""
        seen = 0
        while cm is not None and not isinstance(cm, DefaultChunkManager) and seen < 8:
            cm = getattr(cm, "_delegate", None)
            seen += 1
        return cm if isinstance(cm, DefaultChunkManager) else None

    def _build_chunk_manager(self, backend) -> ChunkManager:
        factory = ChunkManagerFactory()
        factory.configure(self._config.raw_props())
        wrapper = None
        if self.fleet_router is not None:
            config = self._config

            def wrapper(default):
                self._peer_cache = PeerChunkCache(
                    default,
                    self.fleet_router,
                    replication=config.fleet_replication_factor,
                    forward_timeout_s=config.fleet_forward_timeout_ms / 1000.0,
                    down_cooldown_s=config.fleet_peer_down_cooldown_ms / 1000.0,
                    breaker_threshold=config.breaker_peer_failure_threshold,
                    tracer=self.tracer,
                    on_forward=self._fleet_metrics.record_forward,
                )
                return self._peer_cache

        manager = factory.init_chunk_manager(self._storage, backend, wrapper)
        self._device_hot = factory.device_hot_cache
        self._readahead = factory.readahead_manager
        return manager

    @staticmethod
    def _chunk_cache_tier(cm) -> Optional[ChunkCache]:
        """The ChunkCache tier of the fetch chain, seen through the optional
        readahead wrapper (which sits OUTERMOST so its detector observes
        cache hits too)."""
        if isinstance(cm, ReadaheadManager):
            cm = cm._delegate
        return cm if isinstance(cm, ChunkCache) else None

    def _wire_fetch_observability(self) -> None:
        """Hand the configured tracer + latency hooks to the fetch tier so
        chunk-fetch/detransform/cache-get land in traces and histograms."""
        cm = self._chunk_manager
        inner = self._innermost_chunk_manager(cm)
        if inner is not None:
            inner.tracer = self.tracer
            inner.on_fetch = self._metrics.record_chunk_fetch
        cache = self._chunk_cache_tier(cm)
        if cache is not None:
            cache.tracer = self.tracer
            cache.on_get = self._metrics.record_cache_get
            # Pool-side prefetch loads open synthetic flight records.
            cache.flight_recorder = self.flight_recorder
        if self._device_hot is not None:
            self._device_hot.tracer = self.tracer
        if self._readahead is not None:
            self._readahead.tracer = self.tracer
            self._readahead.flight_recorder = self.flight_recorder

    def _wire_tail_tolerance(self, config: RemoteStorageManagerConfig) -> None:
        """Hedged chunk fetches (`hedge.*`) and entry admission control
        (`admission.*`) — the tail-at-scale pair: hedge the stragglers,
        shed the overload (Dean & Barroso 2013; DAGOR, SOSP 2018)."""
        if config.hedge_enabled:
            static_s = config.hedge_delay_ms / 1000.0
            min_samples = config.hedge_delay_min_samples
            metrics = self._metrics

            def hedge_delay_s() -> float:
                # Observed p95 of the chunk-fetch histogram once it holds
                # enough samples; the static config value until then.
                if metrics.histogram_count("chunk-fetch-time") >= min_samples:
                    p95_ms = metrics.latency_quantile("chunk-fetch-time", 0.95)
                    if p95_ms is not None:
                        return p95_ms / 1000.0
                return static_s

            self._hedger = Hedger(
                hedge_delay_s,
                HedgeBudget(config.hedge_budget_percent),
                tracer=self.tracer,
                on_win=self._metrics.record_hedge_win,
            )
            inner = self._innermost_chunk_manager(self._chunk_manager)
            if inner is not None:
                inner.hedger = self._hedger
        if config.admission_enabled:
            self.admission = AdmissionController(
                config.admission_max_concurrent,
                config.admission_max_queue,
                queue_timeout_s=config.admission_queue_timeout_ms / 1000.0,
                retry_after_s=config.admission_retry_after_ms / 1000.0,
                on_wait=self._metrics.record_admission_wait,
            )

    @property
    def default_deadline_s(self) -> Optional[float]:
        """`deadline.default.ms` in seconds; the sidecar boundaries and
        `_traced` install it when the caller brought no deadline."""
        if self._config is None or self._config.deadline_default_ms is None:
            return None
        return self._config.deadline_default_ms / 1000.0

    @property
    def sidecar_grpc_max_workers(self) -> int:
        """`sidecar.grpc.max.workers` (SidecarServer reads this when no
        explicit max_workers is passed)."""
        return (
            self._config.sidecar_grpc_max_workers if self._config is not None else 8
        )

    @property
    def sidecar_http_max_workers(self) -> int:
        """`sidecar.http.max.workers` (SidecarHttpGateway reads this when no
        explicit max_workers is passed)."""
        return (
            self._config.sidecar_http_max_workers if self._config is not None else 32
        )

    @property
    def hedger(self) -> Optional[Hedger]:
        return self._hedger

    @property
    def retry_budget(self) -> Optional[RetryBudget]:
        return self._retry_budget

    def _register_resilience_metrics(self) -> None:
        """The resilience-metrics gauges of every wired component (None for
        a plane that is off), the fleet-metrics group in fleet mode, then
        the retry-metrics group with the storage breaker and the fleet's
        `peer` and `gossip` breaker boards."""
        register_resilience_metrics(
            self._metrics.registry,
            breaker=self._breaker,
            fault_schedule=self._fault_schedule,
            chunk_cache=self._chunk_cache_tier(self._chunk_manager),
            chunk_manager=self._innermost_chunk_manager(self._chunk_manager),
            hedger=self._hedger,
            retry_budget=self._retry_budget,
            admission=self.admission,
            deadline_exceeded_supplier=deadline_util.exceeded_total,
        )
        if self.fleet_router is not None:
            register_fleet_metrics(
                self._metrics.registry,
                router=self.fleet_router,
                peer_cache=self._peer_cache,
                gossip=self._gossip,
            )
        from tieredstorage_tpu_torch.metrics.retry_metrics import register_retry_metrics

        boards = {}
        if self._peer_cache is not None:
            boards["peer"] = self._peer_cache.breakers
        if self._gossip is not None:
            boards["gossip"] = self._gossip.breakers
        register_retry_metrics(
            self._metrics.registry,
            breakers={"storage": self._breaker} if self._breaker is not None else None,
            boards=boards,
        )

    def _register_cache_metrics(self) -> None:
        registry = self._metrics.registry
        register_cache_metrics(
            registry, "segment-manifest-cache", self._manifest_cache.stats,
            size_supplier=lambda: self._manifest_cache.size,
        )
        register_cache_metrics(
            registry, "segment-indexes-cache", self._indexes_cache.stats,
            size_supplier=lambda: self._indexes_cache.size,
            weight_supplier=lambda: self._indexes_cache.total_weight,
        )
        chunk_cache = self._chunk_cache_tier(self._chunk_manager)
        if chunk_cache is not None and hasattr(chunk_cache, "stats"):
            register_cache_metrics(
                registry, "chunk-cache", chunk_cache.stats,
                size_supplier=lambda: chunk_cache.size,
                weight_supplier=lambda: chunk_cache.total_weight,
            )
            register_thread_pool_metrics(
                registry, "chunk-cache-pool", chunk_cache.executor
            )
            from tieredstorage_tpu_torch.fetch.cache.disk import DiskChunkCache

            if isinstance(chunk_cache, DiskChunkCache):
                chunk_cache.set_metrics_recorder(DiskCacheMetrics(registry))
        if self._device_hot is not None:
            from tieredstorage_tpu_torch.metrics.cache_metrics import (
                register_hot_cache_metrics,
            )

            register_hot_cache_metrics(registry, self._device_hot)
        if self._readahead is not None:
            from tieredstorage_tpu_torch.metrics.cache_metrics import (
                register_readahead_metrics,
            )

            register_readahead_metrics(registry, self._readahead)
        if self._manifest_lookahead is not None:
            from tieredstorage_tpu_torch.metrics.cache_metrics import (
                register_manifest_lookahead_metrics,
            )

            register_manifest_lookahead_metrics(
                registry, self._manifest_lookahead
            )
        batcher = getattr(self._transform_backend, "batcher", None)
        if batcher is not None:
            from tieredstorage_tpu_torch.metrics.batch_metrics import (
                register_batch_metrics,
            )

            register_batch_metrics(registry, batcher)
        from tieredstorage_tpu_torch.metrics.timeline import (
            register_timeline_metrics,
        )

        register_timeline_metrics(registry, self.timeline)

    @property
    def metrics(self) -> Metrics:
        return self._metrics

    def flight_status(
        self,
        *,
        limit: Optional[int] = None,
        trace: Optional[str] = None,
        slowest: Optional[int] = None,
    ) -> dict:
        """Slowest-first retained flight records plus the failure ring.
        ``trace`` filters to one trace id's records and raises not-found
        when nothing retained carries it; ``slowest`` returns just the N
        slowest completed records."""
        if not self.flight_recorder.enabled:
            raise RemoteStorageException("flight recorder is not enabled")
        if trace is not None and not self.flight_recorder.find_all(trace):
            raise RemoteResourceNotFoundException(
                f"no retained flight record for trace {trace!r}"
            )
        return self.flight_recorder.dump(
            limit=limit, trace=trace, slowest=slowest
        )

    def timeline_status(self) -> dict:
        """The scheduler ring's counters, epoch pin, and retained events."""
        if not self.timeline.enabled:
            raise RemoteStorageException("timeline recorder is not enabled")
        return self.timeline.status()

    def _wire_fleet_telemetry(self, config: RemoteStorageManagerConfig) -> None:
        """Fleet-wide telemetry (fleet/telemetry.py): this member serves
        its metric samples on GET /fleet/telemetry and can aggregate the
        whole membership view into one scrape (?aggregate=1)."""
        if self.fleet_router is None:
            return
        from tieredstorage_tpu_torch.fleet.telemetry import FleetTelemetry

        self._fleet_telemetry = FleetTelemetry(
            [self._metrics.registry],
            instance_id=config.fleet_instance_id,
            router=self.fleet_router,
            ping=self.fleet_ping,
            timeout_s=config.fleet_forward_timeout_ms / 1000.0,
            flight_recorder=self.flight_recorder,
            timeline=self.timeline,
        )

    @property
    def fleet_telemetry(self):
        return self._fleet_telemetry

    def fleet_telemetry_payload(self, *, aggregate: bool = False) -> dict:
        """The gateway's GET /fleet/telemetry body: this member's samples,
        or the merged fleet-wide scrape when ``aggregate`` is set."""
        if self._fleet_telemetry is None:
            raise RemoteStorageException("fleet mode is not enabled")
        if aggregate:
            return self._fleet_telemetry.scrape()
        return self._fleet_telemetry.local_payload()

    @property
    def transform_backend(self):
        return self._transform_backend

    @property
    def device_hot_cache(self) -> Optional[DeviceHotCache]:
        """The device hot-window tier, or None when `cache.device.bytes`
        is 0 (fetch/cache/device_hot.py)."""
        return self._device_hot

    @property
    def readahead_manager(self) -> Optional[ReadaheadManager]:
        """The readahead tier (None unless ``readahead.enabled``)."""
        return self._readahead

    @property
    def manifest_lookahead(self) -> Optional[ManifestLookahead]:
        return self._manifest_lookahead

    @property
    def scrubber(self):
        """The integrity scrubber (None unless ``scrub.enabled``)."""
        return self._scrubber

    @property
    def scrub_scheduler(self):
        return self._scrub_scheduler

    @property
    def replicated_storage(self) -> Optional[ReplicatedStorageBackend]:
        """The storage backend when it is (or wraps) a
        ReplicatedStorageBackend (replica health, failover and quorum
        counters), else None."""
        return self._replicated

    def scrub_status(self) -> dict:
        """The scrub scheduler's status, or ``{"enabled": False}``."""
        if self._scrub_scheduler is None:
            return {"enabled": False}
        return {"enabled": True, **self._scrub_scheduler.status()}

    def set_segment_successor(self, successor) -> None:
        """Teach the readahead tier segment replay order: ``successor`` maps
        a segment's ``ObjectKey`` to the NEXT segment's key (or None at the
        log head). Segment ordering is broker-side knowledge (base offsets),
        so the embedding broker wires it; the resolved manifest loads ride
        the keyed single-flight manifest lookahead, so N streams crossing
        one boundary resolve the next manifest once."""
        if self._readahead is None:
            raise RemoteStorageException("readahead is not enabled")
        lookahead = self._manifest_lookahead

        def resolver(key: ObjectKey):
            next_key = successor(key)
            if next_key is None:
                return None
            manifest_key = ObjectKey(
                f"{next_key.value.rsplit('.', 1)[0]}.{Suffix.MANIFEST.value}"
            )
            loader = lambda: self._fetch_manifest_by_key(manifest_key)  # noqa: E731
            # Start resolving immediately; the returned thunk joins it.
            lookahead.prefetch(manifest_key, loader)
            return next_key, lambda: lookahead.get(manifest_key, loader)

        self._readahead.next_segment_resolver = resolver

    def _require_configured(self) -> RemoteStorageManagerConfig:
        if self._config is None:
            raise RemoteStorageException("RemoteStorageManager is not configured")
        return self._config

    # ----------------------------------------------------------------- upload
    @_traced("rsm.copy_log_segment_data")
    def copy_log_segment_data(
        self, metadata: RemoteLogSegmentMetadata, segment_data: LogSegmentData
    ) -> Optional[bytes]:
        """Uploads `.log`, `.indexes`, `.rsm-manifest`; returns custom metadata
        bytes (or None if no fields configured)."""
        config = self._require_configured()
        start = time.monotonic()
        log.debug("Copying log segment data: %s", metadata)

        requires_compression = self._requires_compression(segment_data)
        data_key: Optional[DataKeyAndAAD] = None
        if config.encryption_enabled:
            data_key = AesEncryptionProvider.create_data_key_and_aad()

        include = [
            SegmentCustomMetadataField[name]
            for name in config.custom_metadata_fields_include
        ]
        custom_builder = SegmentCustomMetadataBuilder(
            include, self._object_key_factory.prefix, metadata
        )

        uploaded_keys: list[ObjectKey] = []
        # Intent BEFORE the first uploaded byte: a kill -9 anywhere past
        # this line leaves a journal entry naming exactly the keys the
        # recovery sweeper may find stranded.  Manifest-last stays the sole
        # commit point — the journal only names, it never commits.
        txn = self._journal_begin_upload(metadata)
        try:
            chunk_index, chunk_checksums = self._upload_segment_log(
                metadata, segment_data, requires_compression, data_key,
                custom_builder, uploaded_keys,
            )
            self._journal_stage(txn, "log-uploaded")
            segment_indexes = self._upload_indexes(
                metadata, segment_data, data_key, custom_builder, uploaded_keys
            )
            self._journal_stage(txn, "indexes-uploaded")
            self._upload_manifest(
                metadata, chunk_index, segment_indexes, requires_compression,
                data_key, custom_builder, uploaded_keys,
                chunk_checksums=chunk_checksums,
            )
            self._journal_commit(txn)
        except Exception as e:
            # Orphan cleanup: a failed copy must not leave partial objects;
            # the broker retries the whole copy.
            if uploaded_keys:
                topic, partition = self._topic_partition(metadata)
                self._metrics.record_upload_rollback(topic, partition)
                self.tracer.event(
                    "rsm.upload_rollback", topic=topic, partition=partition,
                    keys=len(uploaded_keys),
                )
                try:
                    self._delete_keys(uploaded_keys)
                    self._journal_rollback(txn)
                except Exception:
                    # Cleanup failure is visible, not just logged: counted
                    # per scope, noted on the ambient flight record, and the
                    # journal entry stays PENDING so the recovery sweeper
                    # converges the stranded objects on its next pass.
                    self._metrics.record_upload_rollback_cleanup_failure(
                        topic, partition
                    )
                    flight.note("upload.rollback_cleanup_failures")
                    log.warning(
                        "Failed to clean up partial upload for %s", metadata, exc_info=True
                    )
            else:
                self._journal_rollback(txn)
            if isinstance(e, RemoteStorageException):
                raise
            raise RemoteStorageException(f"Failed to copy segment {metadata}") from e
        finally:
            # This copy is no longer in flight (committed, rolled back, or
            # left pending by a failed cleanup): release the txn so the
            # recovery sweeper may converge whatever it left behind.
            self._journal_release(txn)

        elapsed = time.monotonic() - start
        topic, partition = self._topic_partition(metadata)
        self._metrics.record_segment_copy_time(topic, partition, elapsed * 1000.0)
        log.debug("Copied %s in %.3fs", metadata, elapsed)
        if not include:
            return None
        return serialize_custom_metadata(custom_builder.build())

    @staticmethod
    def _topic_partition(metadata: RemoteLogSegmentMetadata) -> tuple[str, int]:
        tp = metadata.remote_log_segment_id.topic_id_partition.topic_partition
        return tp.topic, tp.partition

    def _record_upload(self, metadata, suffix: Suffix, n_bytes: int) -> None:
        topic, partition = self._topic_partition(metadata)
        self._metrics.record_object_upload(topic, partition, suffix.value, n_bytes)

    # ------------------------------------------------- lifecycle journal hooks
    def _journal_begin_upload(self, metadata) -> Optional[int]:
        """Record upload intent (`lifecycle.enabled`); None when disabled.
        A failed intent append fails the copy while the store is still
        clean — the store must never hold state the journal cannot name."""
        if self._lifecycle_journal is None:
            return None
        from tieredstorage_tpu_torch.storage.lifecycle import JournalAppendError

        keys = [
            self._object_key_factory.key(metadata, suffix).value
            for suffix in Suffix
        ]
        segment = str(metadata.remote_log_segment_id.id)
        try:
            return self._lifecycle_journal.begin_upload(segment, keys)
        except JournalAppendError as e:
            raise RemoteStorageException(
                f"Upload intent journal append failed for {metadata}"
            ) from e

    def _journal_stage(self, txn: Optional[int], stage: str) -> None:
        if txn is not None and self._lifecycle_journal is not None:
            self._lifecycle_journal.stage(txn, stage)

    def _journal_commit(self, txn: Optional[int]) -> None:
        if txn is not None and self._lifecycle_journal is not None:
            self._lifecycle_journal.commit(txn)

    def _journal_rollback(self, txn: Optional[int]) -> None:
        if txn is not None and self._lifecycle_journal is not None:
            self._lifecycle_journal.rollback(txn)

    def _journal_release(self, txn: Optional[int]) -> None:
        """Mark ``txn`` no longer in flight (the owning copy/delete has
        returned); the sweeper may then act on anything still pending."""
        if txn is not None and self._lifecycle_journal is not None:
            self._lifecycle_journal.release(txn)

    def _storage_upload(self, stream: BinaryIO, key: ObjectKey) -> int:
        """Segment-object upload chokepoint: the ``storage.write`` injection
        seam (utils/faults.py) sits here, before the stream is consumed, so a
        fault run can fail/stall writes without corrupting partially-consumed
        uploads. Spanned `storage.upload`: the segment's stream is lazy, so
        its transform spans nest inside, and the span's own time is the
        store's work and the source reads."""
        with self.tracer.span("storage.upload", thread_cpu=True, key=key.value) as span:
            faults.fire("storage.write", str(key))
            uploaded = self._storage.upload(stream, key)
            if span is not None:
                span.attributes["bytes"] = uploaded
        return uploaded

    def _requires_compression(self, segment_data: LogSegmentData) -> bool:
        config = self._require_configured()
        if not config.compression_enabled:
            return False
        if not config.compression_heuristic_enabled:
            return True
        try:
            return not segment_looks_compressed(segment_data.log_segment)
        except InvalidRecordBatchException:
            log.warning(
                "Failed to check compression on log segment: %s", segment_data.log_segment,
                exc_info=True,
            )
            return False

    def _transform_opts(
        self, requires_compression: bool, data_key: Optional[DataKeyAndAAD]
    ) -> TransformOptions:
        return TransformOptions(
            compression=requires_compression,
            compression_codec=self._require_configured().compression_codec,
            encryption=data_key,
        )

    def _upload_segment_log(
        self, metadata, segment_data, requires_compression, data_key,
        custom_builder, uploaded_keys,
    ):
        key = self._object_key_factory.key(metadata, Suffix.LOG)
        file_size = Path(segment_data.log_segment).stat().st_size
        with self.tracer.span(
            "rsm.upload.segment", bytes=file_size, key=key.value,
        ) as span, open(segment_data.log_segment, "rb") as source:
            transformation = SegmentTransformation(
                source, file_size, self._config.chunk_size,
                self._transform_backend,
                self._transform_opts(requires_compression, data_key),
                collect_checksums=self._config.scrub_checksums_enabled,
                device=self._transform_device(),
            )
            stream: BinaryIO = transformation.stream()
            if self._rate_bucket is not None:
                stream = RateLimitedStream(stream, self._rate_bucket)
            uploaded_keys.append(key)
            uploaded = self._storage_upload(stream, key)
            if span is not None:
                span.attributes["bytes_uploaded"] = uploaded
        custom_builder.add_upload_result(Suffix.LOG, uploaded)
        self._record_upload(metadata, Suffix.LOG, uploaded)
        log.debug("Uploaded segment log for %s, size: %d", metadata, uploaded)
        return transformation.chunk_index, transformation.chunk_checksums

    def _upload_indexes(
        self, metadata, segment_data: LogSegmentData, data_key, custom_builder, uploaded_keys
    ):
        """Each index is transformed as a single chunk (encrypt-only), then all
        are concatenated into one `.indexes` object (empty indexes record
        size 0 and upload no bytes)."""
        with self.tracer.span("rsm.upload.indexes"):
            return self._upload_indexes_traced(
                metadata, segment_data, data_key, custom_builder, uploaded_keys
            )

    def _upload_indexes_traced(
        self, metadata, segment_data: LogSegmentData, data_key, custom_builder, uploaded_keys
    ):
        builder = SegmentIndexesV1Builder()
        parts: list[bytes] = []

        def transform_one(index_type: IndexType, stream: BinaryIO, size: int) -> None:
            if size > 0:
                tr = SegmentTransformation(
                    stream, size, self._config.chunk_size,
                    self._transform_backend,
                    self._transform_opts(False, data_key),
                    chunking_disabled=True,
                )
                blob = tr.stream().read()
                parts.append(blob)
                builder.add(index_type, len(blob))
            else:
                builder.add(index_type, 0)

        with ClosableStreamHolder() as holder:
            for index_type, path in (
                (IndexType.OFFSET, segment_data.offset_index),
                (IndexType.TIMESTAMP, segment_data.time_index),
                (IndexType.PRODUCER_SNAPSHOT, segment_data.producer_snapshot_index),
            ):
                size = Path(path).stat().st_size
                transform_one(index_type, holder.add(open(path, "rb")), size)
            transform_one(
                IndexType.LEADER_EPOCH,
                io.BytesIO(segment_data.leader_epoch_index),
                len(segment_data.leader_epoch_index),
            )
            if segment_data.transaction_index is not None:
                size = Path(segment_data.transaction_index).stat().st_size
                transform_one(
                    IndexType.TRANSACTION,
                    holder.add(open(segment_data.transaction_index, "rb")),
                    size,
                )

        key = self._object_key_factory.key(metadata, Suffix.INDEXES)
        uploaded_keys.append(key)
        uploaded = self._storage_upload(io.BytesIO(b"".join(parts)), key)
        custom_builder.add_upload_result(Suffix.INDEXES, uploaded)
        self._record_upload(metadata, Suffix.INDEXES, uploaded)
        log.debug("Uploaded indexes file for %s, size: %d", metadata, uploaded)
        return builder.build()

    def _upload_manifest(
        self, metadata, chunk_index, segment_indexes, requires_compression,
        data_key, custom_builder, uploaded_keys, chunk_checksums=None,
    ) -> None:
        encryption_metadata = None
        encoder = None
        if data_key is not None:
            encryption_metadata = SegmentEncryptionMetadataV1(data_key.data_key, data_key.aad)
            encoder = self._rsa.data_key_encoder
        manifest = SegmentManifestV1(
            chunk_index=chunk_index,
            segment_indexes=segment_indexes,
            compression=requires_compression,
            encryption=encryption_metadata,
            remote_log_segment_metadata=metadata,
            compression_codec=self._config.compression_codec if requires_compression else None,
            chunk_checksums=chunk_checksums,
        )
        text = manifest_to_json(manifest, data_key_encoder=encoder)
        key = self._object_key_factory.key(metadata, Suffix.MANIFEST)
        uploaded_keys.append(key)
        with self.tracer.span("rsm.upload.manifest", bytes=len(text)):
            uploaded = self._storage_upload(io.BytesIO(text.encode("utf-8")), key)
        custom_builder.add_upload_result(Suffix.MANIFEST, uploaded)
        self._record_upload(metadata, Suffix.MANIFEST, uploaded)
        log.debug("Uploaded segment manifest for %s, size: %d", metadata, uploaded)

    # ------------------------------------------------------------------ fetch
    def _object_key(self, metadata: RemoteLogSegmentMetadata, suffix: Suffix) -> ObjectKey:
        """Custom metadata (if stored) overrides prefix/key so fetches survive
        `key.prefix` changes."""
        fields = deserialize_custom_metadata(metadata.custom_metadata)
        if fields:
            return self._object_key_factory.key_from_fields(fields, metadata, suffix)
        return self._object_key_factory.key(metadata, suffix)

    def fetch_segment_manifest(self, metadata: RemoteLogSegmentMetadata) -> SegmentManifestV1:
        self._require_configured()
        key = self._object_key(metadata, Suffix.MANIFEST)
        # Request-thread span: covers the cache hit or the wait on the
        # cache's loader pool (the storage GET itself runs on that pool and
        # records its own storage.fetch_manifest root span).
        with self.tracer.span("rsm.fetch_manifest", key=key.value):
            # Quarantine gate BEFORE the cache: a manifest cached while
            # healthy stops being served the moment the sweeper flags it.
            self._check_not_quarantined(key)
            # Through the lookahead: a boundary crossing whose manifest a
            # readahead continuation already started resolving JOINS that
            # flight instead of stalling on a second fetch+parse.
            return self._manifest_lookahead.get(
                key, lambda: self._fetch_manifest_by_key(key)
            )

    def _fetch_manifest_by_key(self, key: ObjectKey) -> SegmentManifestV1:
        self._check_not_quarantined(key)
        return self._fetch_manifest_raw(key)

    def _fetch_manifest_raw(self, key: ObjectKey) -> SegmentManifestV1:
        """Fetch + parse WITHOUT the quarantine gate — the recovery
        sweeper's loader: quarantine is recomputed from readability every
        sweep, so a healed manifest must be loadable to un-quarantine."""
        try:
            with self.tracer.span("storage.fetch_manifest", key=key.value), \
                    self._storage.fetch(key) as stream:
                text = stream.read()
        except KeyNotFoundException as e:
            raise RemoteResourceNotFoundException(str(e)) from e
        decoder = self._rsa.data_key_decoder if self._rsa is not None else None
        return manifest_from_json(text, data_key_decoder=decoder)

    def _check_not_quarantined(self, key: ObjectKey) -> None:
        """Quarantined manifests (unreadable, or referencing missing
        objects — see scrub/sweeper.py) are NEVER served: a half-present
        segment must fail fast and loud, not half-serve."""
        if self._sweeper is not None and self._sweeper.is_quarantined(key.value):
            raise RemoteStorageException(
                f"Manifest {key.value} is quarantined by the recovery "
                "sweeper (incomplete or unreadable segment); refusing to "
                "serve it"
            )

    @_traced("rsm.fetch_log_segment")
    def fetch_log_segment(
        self,
        metadata: RemoteLogSegmentMetadata,
        start_position: int,
        end_position: Optional[int] = None,
    ) -> BinaryIO:
        """Ranged read of the original segment bytes as a lazy stream: chunk
        N+1 is fetched and decrypted only when the reader gets past chunk N,
        and closing the stream stops the enumeration."""
        self._require_configured()
        if start_position < 0:
            raise ValueError(f"startPosition must be non-negative, {start_position} given")
        if end_position is not None and end_position < start_position:
            raise ValueError(
                f"endPosition {end_position} must be >= startPosition {start_position}"
            )
        start = time.monotonic()
        try:
            manifest = self.fetch_segment_manifest(metadata)
            file_size = manifest.chunk_index.original_file_size
            if start_position >= file_size:
                raise InvalidStartPosition(
                    f"Start position {start_position} is outside segment of size {file_size}"
                )
            effective_end = min(
                end_position if end_position is not None else file_size - 1,
                file_size - 1,
            )
            byte_range = BytesRange.of(start_position, effective_end)
            topic, partition = self._topic_partition(metadata)
            self._metrics.record_segment_fetch_requested_bytes(
                topic, partition, byte_range.size
            )
            key = self._object_key(metadata, Suffix.LOG)
            stream = FetchChunkEnumeration(
                self._chunk_manager, key, manifest, byte_range
            ).to_stream()
            # Latency of the synchronous request path (manifest + range
            # mapping); the lazy chunk transfer lands in chunk-fetch-time.
            self._metrics.record_segment_fetch_time(
                topic, partition, (time.monotonic() - start) * 1000.0
            )
            return stream
        except RemoteStorageException:
            raise
        except KeyNotFoundException as e:
            raise RemoteResourceNotFoundException(str(e)) from e
        except StorageBackendException as e:
            raise RemoteStorageException(str(e)) from e

    @_traced("rsm.fetch_index")
    def fetch_index(self, metadata: RemoteLogSegmentMetadata, index_type: IndexType) -> BinaryIO:
        self._require_configured()
        try:
            manifest = self.fetch_segment_manifest(metadata)
            segment_index = manifest.segment_indexes.segment_index(index_type)
            if segment_index is None:
                raise RemoteResourceNotFoundException(
                    f"Index {index_type.name} not found on {self._object_key(metadata, Suffix.INDEXES)}"
                )
            if segment_index.size == 0:
                return io.BytesIO(b"")
            key = self._object_key(metadata, Suffix.INDEXES)
            return io.BytesIO(
                self._indexes_cache.get(
                    key,
                    index_type,
                    lambda: self._fetch_index_bytes(key, segment_index.range(), manifest),
                )
            )
        except KeyNotFoundException as e:
            raise RemoteResourceNotFoundException(str(e)) from e
        except StorageBackendException as e:
            raise RemoteStorageException(str(e)) from e

    def _fetch_index_bytes(
        self, key: ObjectKey, byte_range: BytesRange, manifest: SegmentManifestV1
    ) -> bytes:
        # The chunk path's `storage.read` seam (chunk_manager._fetch_stored):
        # `error` propagates as a backend failure, `partial` tears the bytes
        # so the encrypted detransform's tag check must refuse them.
        torn = faults.fire("storage.read", key.value)
        with self._storage.fetch(key, byte_range) as stream:
            blob = stream.read()
        if torn:
            blob = faults.mutate(blob, torn)
        opts = DetransformOptions(
            compression=False,
            encryption=(
                DataKeyAndAAD(manifest.encryption.data_key, manifest.encryption.aad)
                if manifest.encryption is not None
                else None
            ),
        )
        return self._transform_backend.detransform([blob], opts)[0]

    # ----------------------------------------------------------------- delete
    @_traced("rsm.delete_log_segment_data")
    def delete_log_segment_data(self, metadata: RemoteLogSegmentMetadata) -> None:
        """Delete the segment's objects, manifest first: every interruption
        past it leaves only objects no manifest reaches."""
        self._require_configured()
        log.debug("Deleting log segment data for %s", metadata)
        topic, partition = self._topic_partition(metadata)
        self._metrics.record_segment_delete(
            topic, partition, metadata.segment_size_in_bytes
        )
        start = time.monotonic()
        txn: Optional[int] = None
        try:
            keys = [self._object_key(metadata, s) for s in Suffix]
            # Tombstone BEFORE the first delete (`lifecycle.enabled`): a
            # crash-interrupted delete converges because the recovery
            # sweeper finishes what the tombstone names.
            txn = self._journal_begin_delete(metadata, keys)
            manifest_keys = [k for k in keys if k.value.endswith(Suffix.MANIFEST.value)]
            data_keys = [k for k in keys if not k.value.endswith(Suffix.MANIFEST.value)]
            self._delete_keys(manifest_keys, total=len(keys))
            self._delete_keys(data_keys, total=len(keys))
            self._journal_commit_delete(txn)
        except RemoteStorageException:
            self._metrics.record_segment_delete_error(topic, partition)
            raise
        except StorageBackendException as e:
            self._metrics.record_segment_delete_error(topic, partition)
            raise RemoteStorageException(f"Failed to delete {metadata}") from e
        finally:
            # The delete is no longer in flight; a tombstone left pending
            # by a partial failure is now the sweeper's to finish.
            self._journal_release(txn)
        self._metrics.record_segment_delete_time(
            topic, partition, (time.monotonic() - start) * 1000.0
        )

    def _journal_begin_delete(self, metadata, keys: list[ObjectKey]) -> Optional[int]:
        """Record delete intent; a failed tombstone append fails the delete
        before any object is removed (the broker retries)."""
        if self._lifecycle_journal is None:
            return None
        from tieredstorage_tpu_torch.storage.lifecycle import JournalAppendError

        segment = str(metadata.remote_log_segment_id.id)
        try:
            return self._lifecycle_journal.begin_delete(
                segment, [k.value for k in keys]
            )
        except JournalAppendError as e:
            raise RemoteStorageException(
                f"Delete tombstone append failed for {metadata}"
            ) from e

    def _journal_commit_delete(self, txn: Optional[int]) -> None:
        if txn is not None and self._lifecycle_journal is not None:
            self._lifecycle_journal.commit_delete(txn)

    def _delete_keys(
        self, keys: list[ObjectKey], *, total: Optional[int] = None
    ) -> None:
        """Idempotent multi-delete: bulk fast path, then a per-key sweep on
        failure — missing keys are fine, every other per-key failure is
        collected into ONE RemoteStorageException after the sweep."""
        if self._storage is None or not keys:
            return
        with self.tracer.span("storage.delete_keys", keys=len(keys)):
            self._delete_keys_traced(keys, len(keys) if total is None else total)

    def _delete_keys_traced(self, keys: list[ObjectKey], total: int) -> None:
        try:
            self._storage.delete_all(keys)
            return
        except StorageBackendException:
            log.debug("Bulk delete failed; sweeping per key", exc_info=True)
        failures: list[tuple[ObjectKey, StorageBackendException]] = []
        for key in keys:
            try:
                self._storage.delete(key)
            except KeyNotFoundException:
                continue
            except StorageBackendException as e:
                failures.append((key, e))
        if failures:
            detail = "; ".join(f"{key}: {e}" for key, e in failures)
            raise RemoteStorageException(
                f"Failed to delete {len(failures)}/{total} keys: {detail}"
            ) from failures[0][1]

    def close(self) -> None:
        # As in the JAX package: the fleet's telemetry clients and the
        # gossip daemon, the anti-entropy scheduler, the scrub scheduler and
        # the sweep scheduler (their passes read through the store and the
        # transform backend), then the journal, then the replicated store's
        # prober and write pool, the hedger's pool; then the Chrome trace
        # export (`tracing.export.path`); then the chunk chain: its close
        # drains the readahead and cache pools, whose loads reach the peer
        # tier's clients and the transform backend closed last.
        if self._fleet_telemetry is not None:
            self._fleet_telemetry.close()
        if self._gossip is not None:
            self._gossip.stop()
        if self._antientropy_scheduler is not None:
            self._antientropy_scheduler.stop()
        if self._scrub_scheduler is not None:
            self._scrub_scheduler.stop()
        if self._sweep_scheduler is not None:
            self._sweep_scheduler.stop()
        if self._lifecycle_journal is not None:
            self._lifecycle_journal.close()
        if self._replicated is not None:
            self._replicated.close()
        if self._hedger is not None:
            self._hedger.close()
        if self._config is not None and self._config.tracing_export_path:
            try:
                self.tracer.write_chrome_trace(self._config.tracing_export_path)
            except OSError:
                log.warning(
                    "Failed to export Chrome trace to %s",
                    self._config.tracing_export_path, exc_info=True,
                )
        if self._chunk_manager is not None and hasattr(self._chunk_manager, "close"):
            self._chunk_manager.close()
        if self._peer_cache is not None:
            self._peer_cache.close()
        for cache in (self._manifest_lookahead, self._manifest_cache, self._indexes_cache):
            if cache is not None:
                cache.close()
        if self._transform_backend is not None:
            self._transform_backend.close()


class InvalidStartPosition(RemoteStorageException):
    """Requested fetch start beyond segment size."""
