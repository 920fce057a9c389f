"""RemoteStorageManager: the KIP-405-shaped orchestration layer.

Counterpart of tieredstorage_tpu/rsm.py (its `configure`,
`copy_log_segment_data`, `fetch_segment_manifest`, `fetch_log_segment`,
`fetch_index`, `delete_log_segment_data`, `set_segment_successor`, the
scrub, lifecycle and anti-entropy accessors and `close`), without the planes
this package has not ported yet: metrics, tracing spans, the flight
recorder, the default deadline, the breaker and retry budget, hedging and
fleet mode. Where the JAX package registers a metrics group, this RSM
leaves a None hook.

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

import io
import logging
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
from tieredstorage_tpu_torch.fetch.cache.device_hot import DeviceHotCache
from tieredstorage_tpu_torch.fetch.chunk_manager import ChunkManager, DefaultChunkManager
from tieredstorage_tpu_torch.fetch.enumeration import FetchChunkEnumeration
from tieredstorage_tpu_torch.fetch.factory import ChunkManagerFactory
from tieredstorage_tpu_torch.fetch.index_cache import MemorySegmentIndexesCache
from tieredstorage_tpu_torch.fetch.manifest_cache import (
    ManifestLookahead,
    MemorySegmentManifestCache,
)
from tieredstorage_tpu_torch.fetch.readahead import ReadaheadManager
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
from tieredstorage_tpu_torch.transform.api import (
    DEFAULT_DEVICE,
    DetransformOptions,
    TransformOptions,
    checksum_device,
)
from tieredstorage_tpu_torch.transform.pipeline import SegmentTransformation
from tieredstorage_tpu_torch.utils import faults
from tieredstorage_tpu_torch.utils.ratelimit import RateLimitedStream, TokenBucket
from tieredstorage_tpu_torch.utils.streams import ClosableStreamHolder

log = logging.getLogger(__name__)


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

    # ------------------------------------------------------------------ setup
    def configure(self, configs: Mapping[str, object]) -> None:
        config = RemoteStorageManagerConfig(configs)
        storage = config.storage_backend_class()
        storage.configure(config.storage_configs())
        storage = self._wrap_storage_faults(config, storage)
        backend = config.transform_backend_class()
        backend.configure(config.transform_configs())
        batcher = getattr(backend, "batcher", None)
        if batcher is not None:
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
        self._chunk_manager = self._build_chunk_manager(backend)
        self._manifest_cache = MemorySegmentManifestCache()
        self._manifest_cache.configure(config.fetch_manifest_cache_configs())
        self._manifest_lookahead = ManifestLookahead(self._manifest_cache)
        self._indexes_cache = MemorySegmentIndexesCache()
        self._indexes_cache.configure(config.fetch_indexes_cache_configs())
        self._wire_replication(config)
        self._wire_scrubber(config)
        self._wire_lifecycle(config)

    def _transform_device(self):
        """The configured `transform.device` (`cuda:0` by default)."""
        return self._config.transform_configs().get("device", DEFAULT_DEVICE)

    def _checksum_device(self):
        """Where this RSM's CRC32C runs: the transform backend's device, or
        `transform.device` for a host backend (api.checksum_device)."""
        return checksum_device(self._transform_backend, self._transform_device())

    def _wrap_storage_faults(
        self, config: RemoteStorageManagerConfig, storage: StorageBackend
    ) -> StorageBackend:
        """The fault half of the JAX package's `_wrap_storage_resilience`:
        `fault.injection.enabled` wraps the backend in a
        FaultInjectingBackend executing `fault.schedule`, and `faults.spec`
        installs the process-wide fault plane (utils/faults.py) across the
        I/O seams. The breaker and the retry budget are not ported."""
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
        return storage

    def _wire_replication(self, config: RemoteStorageManagerConfig) -> None:
        """When the storage backend is (or wraps) a ReplicatedStorageBackend,
        start the anti-entropy repair daemon (`replication.antientropy.*`).
        The replication gauges (JAX `register_replication_metrics`) wait
        for the metrics groups: `replication_metrics` stays None."""
        self._replicated = self._find_replicated(self._storage)
        if self._replicated is None or not config.replication_antientropy_enabled:
            return
        from tieredstorage_tpu_torch.scrub.antientropy import (
            AntiEntropyRepairer,
            AntiEntropyScheduler,
        )

        rate = config.replication_antientropy_rate_bytes
        self._antientropy = AntiEntropyRepairer(
            self._replicated,
            prefix=config.key_prefix,
            rate_bucket=TokenBucket(rate) if rate is not None else None,
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

    #: The metrics groups are not ported: where the JAX RSM registers the
    #: replication and lifecycle gauges, these hooks stay None.
    replication_metrics = None
    lifecycle_metrics = None

    @staticmethod
    def _find_replicated(storage) -> Optional[ReplicatedStorageBackend]:
        """Unwrap the fault decorator (it exposes `delegate`) down to a
        ReplicatedStorageBackend, if one is in the stack."""
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
        from tieredstorage_tpu_torch.scrub import ScrubScheduler, Scrubber

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
            device=self._checksum_device(),
        )
        self._scrub_scheduler = ScrubScheduler(
            self._scrubber, interval_ms=config.scrub_interval_ms
        ).start()
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
        manager = factory.init_chunk_manager(self._storage, backend)
        self._device_hot = factory.device_hot_cache
        self._readahead = factory.readahead_manager
        return manager

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
    def copy_log_segment_data(
        self, metadata: RemoteLogSegmentMetadata, segment_data: LogSegmentData
    ) -> Optional[bytes]:
        """Uploads `.log`, `.indexes`, `.rsm-manifest`; returns custom metadata
        bytes (or None if no fields configured)."""
        config = self._require_configured()
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
                try:
                    self._delete_keys(uploaded_keys)
                    self._journal_rollback(txn)
                except Exception:
                    # The journal entry stays PENDING, so the recovery
                    # sweeper converges the stranded objects on its next pass.
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

        if not include:
            return None
        return serialize_custom_metadata(custom_builder.build())

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
        uploads."""
        faults.fire("storage.write", str(key))
        return self._storage.upload(stream, key)

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
        with open(segment_data.log_segment, "rb") as source:
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
        custom_builder.add_upload_result(Suffix.LOG, uploaded)
        log.debug("Uploaded segment log for %s, size: %d", metadata, uploaded)
        return transformation.chunk_index, transformation.chunk_checksums

    def _upload_indexes(
        self, metadata, segment_data: LogSegmentData, data_key, custom_builder, uploaded_keys
    ):
        """Each index is transformed as a single chunk (encrypt-only), then all
        are concatenated into one `.indexes` object (empty indexes record
        size 0 and upload no bytes)."""
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
        uploaded = self._storage_upload(io.BytesIO(text.encode("utf-8")), key)
        custom_builder.add_upload_result(Suffix.MANIFEST, uploaded)
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
        # Quarantine gate BEFORE the cache: a manifest cached while healthy
        # stops being served the moment the sweeper flags it.
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
            with self._storage.fetch(key) as stream:
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
            key = self._object_key(metadata, Suffix.LOG)
            return FetchChunkEnumeration(
                self._chunk_manager, key, manifest, BytesRange.of(start_position, effective_end)
            ).to_stream()
        except RemoteStorageException:
            raise
        except KeyNotFoundException as e:
            raise RemoteResourceNotFoundException(str(e)) from e
        except StorageBackendException as e:
            raise RemoteStorageException(str(e)) from e

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
    def delete_log_segment_data(self, metadata: RemoteLogSegmentMetadata) -> None:
        """Delete the segment's objects, manifest first: every interruption
        past it leaves only objects no manifest reaches."""
        self._require_configured()
        log.debug("Deleting log segment data for %s", metadata)
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
        except StorageBackendException as e:
            raise RemoteStorageException(f"Failed to delete {metadata}") from e
        finally:
            # The delete is no longer in flight; a tombstone left pending
            # by a partial failure is now the sweeper's to finish.
            self._journal_release(txn)

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
        total = len(keys) if total is None else total
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
        # As in the JAX package: the anti-entropy scheduler, the scrub
        # scheduler and the sweep scheduler (their passes read through the
        # store and the transform backend), then the journal, then the
        # replicated store's prober and write pool; then the chunk chain:
        # its close drains the readahead and cache pools, whose loads reach
        # the transform backend closed last.
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
        if self._chunk_manager is not None and hasattr(self._chunk_manager, "close"):
            self._chunk_manager.close()
        for cache in (self._manifest_lookahead, self._manifest_cache, self._indexes_cache):
            if cache is not None:
                cache.close()
        if self._transform_backend is not None:
            self._transform_backend.close()


class InvalidStartPosition(RemoteStorageException):
    """Requested fetch start beyond segment size."""
