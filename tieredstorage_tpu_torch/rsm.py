"""RemoteStorageManager: the KIP-405-shaped orchestration layer.

Counterpart of tieredstorage_tpu/rsm.py (its `configure`,
`copy_log_segment_data`, `fetch_segment_manifest`, `fetch_log_segment`,
`fetch_index`, `delete_log_segment_data`, `set_segment_successor`, the
scrub accessors and `close`), without the planes this package has not
ported yet: metrics, tracing spans, the flight recorder, the default
deadline, fault injection, resilience wrappers, fleet mode, anti-entropy and
the lifecycle journal.

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
from tieredstorage_tpu_torch.transform.api import DetransformOptions, TransformOptions
from tieredstorage_tpu_torch.transform.pipeline import SegmentTransformation
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

    # ------------------------------------------------------------------ setup
    def configure(self, configs: Mapping[str, object]) -> None:
        config = RemoteStorageManagerConfig(configs)
        storage = config.storage_backend_class()
        storage.configure(config.storage_configs())
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
        self._wire_scrubber(config)

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
        try:
            chunk_index, chunk_checksums = self._upload_segment_log(
                metadata, segment_data, requires_compression, data_key,
                custom_builder, uploaded_keys,
            )
            segment_indexes = self._upload_indexes(
                metadata, segment_data, data_key, custom_builder, uploaded_keys
            )
            self._upload_manifest(
                metadata, chunk_index, segment_indexes, requires_compression,
                data_key, custom_builder, uploaded_keys,
                chunk_checksums=chunk_checksums,
            )
        except Exception as e:
            # Orphan cleanup: a failed copy must not leave partial objects;
            # the broker retries the whole copy.
            if uploaded_keys:
                try:
                    self._delete_keys(uploaded_keys)
                except Exception:
                    log.warning(
                        "Failed to clean up partial upload for %s", metadata, exc_info=True
                    )
            if isinstance(e, RemoteStorageException):
                raise
            raise RemoteStorageException(f"Failed to copy segment {metadata}") from e

        if not include:
            return None
        return serialize_custom_metadata(custom_builder.build())

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
            )
            stream: BinaryIO = transformation.stream()
            if self._rate_bucket is not None:
                stream = RateLimitedStream(stream, self._rate_bucket)
            uploaded_keys.append(key)
            uploaded = self._storage.upload(stream, key)
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
        uploaded = self._storage.upload(io.BytesIO(b"".join(parts)), key)
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
        uploaded = self._storage.upload(io.BytesIO(text.encode("utf-8")), key)
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
        # Through the lookahead: a boundary crossing whose manifest a
        # readahead continuation already started resolving JOINS that
        # flight instead of stalling on a second fetch+parse.
        return self._manifest_lookahead.get(
            key, lambda: self._fetch_manifest_by_key(key)
        )

    def _fetch_manifest_by_key(self, key: ObjectKey) -> SegmentManifestV1:
        try:
            with self._storage.fetch(key) as stream:
                text = stream.read()
        except KeyNotFoundException as e:
            raise RemoteResourceNotFoundException(str(e)) from e
        decoder = self._rsa.data_key_decoder if self._rsa is not None else None
        return manifest_from_json(text, data_key_decoder=decoder)

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
        with self._storage.fetch(key, byte_range) as stream:
            blob = stream.read()
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
        try:
            keys = [self._object_key(metadata, s) for s in Suffix]
            manifest_keys = [k for k in keys if k.value.endswith(Suffix.MANIFEST.value)]
            data_keys = [k for k in keys if not k.value.endswith(Suffix.MANIFEST.value)]
            self._delete_keys(manifest_keys, total=len(keys))
            self._delete_keys(data_keys, total=len(keys))
        except StorageBackendException as e:
            raise RemoteStorageException(f"Failed to delete {metadata}") from e

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
        # The scrub scheduler first (its passes read through the store and
        # the transform backend), then the chunk chain: its close drains the
        # readahead and cache pools, whose loads reach the transform backend
        # closed last.
        if self._scrub_scheduler is not None:
            self._scrub_scheduler.stop()
        if self._chunk_manager is not None and hasattr(self._chunk_manager, "close"):
            self._chunk_manager.close()
        for cache in (self._manifest_lookahead, self._manifest_cache, self._indexes_cache):
            if cache is not None:
                cache.close()
        if self._transform_backend is not None:
            self._transform_backend.close()


class InvalidStartPosition(RemoteStorageException):
    """Requested fetch start beyond segment size."""
