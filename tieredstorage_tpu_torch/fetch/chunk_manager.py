"""Chunk managers: resolve (object key, manifest, chunk id) -> plaintext chunk.

Counterpart of tieredstorage_tpu/fetch/chunk_manager.py without the planes
this package has not ported yet (tracing spans, the flight recorder,
hedging). `_fetch_stored` is the fault plane's `storage.read` seam
(utils/faults.py). The quarantine has the JAX package's external hook
(`quarantine`), through which the scrubber gates objects it found corrupt.
`get_chunks` fetches a window of chunks with ONE ranged request (chunks are
contiguous on the stored side) and detransforms them in ONE backend call.
"""

from __future__ import annotations

import abc
import io
import logging
import threading
import time
from typing import BinaryIO, Callable, Optional, Sequence

from tieredstorage_tpu_torch.manifest.segment_manifest import SegmentManifestV1
from tieredstorage_tpu_torch.storage.core import (
    BytesRange,
    ObjectFetcher,
    ObjectKey,
    StorageBackendException,
)
from tieredstorage_tpu_torch.transform.api import DetransformOptions, TransformBackend
from tieredstorage_tpu_torch.utils import faults
from tieredstorage_tpu_torch.utils.deadline import check_deadline
from tieredstorage_tpu_torch.utils.streams import read_exactly

log = logging.getLogger(__name__)


class CorruptChunkException(StorageBackendException):
    """Detransform failed on fetched bytes (GCM tag / frame mismatch): the
    stored object is corrupt or forged. The object key is quarantined so
    broker retry storms can't hammer a poisoned object."""


class ChunkManager(abc.ABC):
    @abc.abstractmethod
    def get_chunk(
        self, objects_key: ObjectKey, manifest: SegmentManifestV1, chunk_id: int
    ) -> BinaryIO:
        """Plaintext stream of one original-side chunk."""

    def get_chunks(
        self, objects_key: ObjectKey, manifest: SegmentManifestV1, chunk_ids: Sequence[int]
    ) -> list[bytes]:
        """Plaintext bytes of several chunks; default loops over get_chunk."""
        return [
            self.get_chunk(objects_key, manifest, cid).read() for cid in chunk_ids
        ]


class DefaultChunkManager(ChunkManager):
    #: How long a key stays quarantined after a detransform failure.
    DEFAULT_QUARANTINE_TTL_S = 60.0
    #: Optional pre-detransform hook `(opts)` — the device hot-window tier
    #: (fetch/cache/device_hot.py `note_detransform`) records the window's
    #: DetransformOptions so admission can tell whether the decrypt output
    #: rows ARE the final plaintext (encryption-only segments) and the
    #: device tensor may be retained for hot serving.
    on_detransform = None

    def __init__(
        self,
        fetcher: ObjectFetcher,
        transform_backend: TransformBackend,
        *,
        quarantine_ttl_s: Optional[float] = None,
        time_source: Callable[[], float] = time.monotonic,
    ):
        self._fetcher = fetcher
        self._backend = transform_backend
        self.quarantine_ttl_s = (
            self.DEFAULT_QUARANTINE_TTL_S if quarantine_ttl_s is None else quarantine_ttl_s
        )
        self._now = time_source
        self._quarantine: dict[str, tuple[float, str]] = {}
        self._quarantine_lock = threading.Lock()
        #: Total detransform corruption detections.
        self.corruptions = 0

    @property
    def quarantined_keys(self) -> int:
        with self._quarantine_lock:
            return len(self._quarantine)

    def _check_quarantine(self, key: ObjectKey) -> None:
        with self._quarantine_lock:
            entry = self._quarantine.get(key.value)
            if entry is None:
                return
            expires_at, reason = entry
            if self._now() >= expires_at:
                del self._quarantine[key.value]
                return
        raise CorruptChunkException(
            f"Object {key} is quarantined after a detransform failure: {reason}"
        )

    def _quarantine_key(self, key: ObjectKey, reason: str) -> None:
        with self._quarantine_lock:
            self.corruptions += 1
            self._quarantine[key.value] = (self._now() + self.quarantine_ttl_s, reason)
        log.warning("Quarantining %s for %.0fs: %s", key, self.quarantine_ttl_s, reason)

    def quarantine(self, key: ObjectKey, reason: str) -> None:
        """External quarantine hook: the scrubber routes objects it finds
        corrupt at rest through the same gate a detransform failure takes,
        so fetches fail fast instead of re-reading poisoned bytes."""
        self._quarantine_key(key, reason)

    def get_chunk(
        self, objects_key: ObjectKey, manifest: SegmentManifestV1, chunk_id: int
    ) -> BinaryIO:
        return io.BytesIO(self.get_chunks(objects_key, manifest, [chunk_id])[0])

    def get_chunks(
        self, objects_key: ObjectKey, manifest: SegmentManifestV1, chunk_ids: Sequence[int]
    ) -> list[bytes]:
        if len(chunk_ids) == 0:
            return []
        self._check_quarantine(objects_key)
        # Fast-fail BEFORE the ranged GET: a request whose end-to-end
        # deadline already expired must not spend a storage round trip.
        check_deadline(f"chunk fetch of {objects_key}")
        index = manifest.chunk_index
        chunks = [index._chunk_at(cid) for cid in chunk_ids]
        contiguous = all(
            chunks[i + 1].id == chunks[i].id + 1 for i in range(len(chunks) - 1)
        )
        stored = self._fetch_stored(objects_key, chunks, contiguous)
        opts = DetransformOptions.from_manifest(manifest)
        if self.on_detransform is not None:
            self.on_detransform(opts)
        try:
            return self._backend.detransform(stored, opts)
        except Exception as e:
            # Any detransform failure (AuthenticationError on a GCM tag
            # mismatch, frame errors from the codec) means the stored bytes
            # are poisoned — re-fetching won't fix them, so quarantine the
            # key instead of letting retries hammer the backend.
            self._quarantine_key(objects_key, f"{type(e).__name__}: {e}")
            raise CorruptChunkException(
                f"Detransform failed for chunks {list(chunk_ids)} of {objects_key}"
            ) from e

    def _fetch_stored(
        self, objects_key: ObjectKey, chunks, contiguous: bool
    ) -> list[bytes]:
        """Read the stored (transformed) bytes of a chunk window.

        The fault plane's `storage.read` seam: an `error` fault propagates
        as a backend failure; `partial` tears the fetched bytes, so the GCM
        tag check of the detransform must refuse them."""
        torn = faults.fire("storage.read", str(objects_key))
        if contiguous:
            # One ranged GET covering the window on the transformed side.
            whole = BytesRange.of(
                chunks[0].transformed_position,
                chunks[-1].transformed_position + chunks[-1].transformed_size - 1,
            )
            with self._fetcher.fetch(objects_key, whole) as stream:
                stored = [read_exactly(stream, c.transformed_size) for c in chunks]
        else:
            stored = []
            for c in chunks:
                with self._fetcher.fetch(objects_key, c.range()) as stream:
                    stored.append(read_exactly(stream, c.transformed_size))
        if torn:
            stored = [faults.mutate(b, torn) for b in stored]
        return stored
