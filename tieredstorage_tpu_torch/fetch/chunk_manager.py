"""Chunk managers: resolve (object key, manifest, chunk id) -> plaintext chunk.

Counterpart of tieredstorage_tpu/fetch/chunk_manager.py. Spans, the
`on_fetch` latency hook and the flight notes (tier, GCM window accounting,
the merged launch a window rode) are the JAX package's. `_fetch_stored` is
the fault plane's `storage.read` seam (utils/faults.py). The quarantine has
the JAX package's external hook (`quarantine`), through which the scrubber
gates objects it found corrupt. `get_chunks` fetches a window of chunks with
ONE ranged request (chunks are contiguous on the stored side) and
detransforms them in ONE backend call. With a `hedger` (fetch/hedge.py,
`hedge.enabled`) the ranged GET is raced against a delayed second attempt,
against a distinct replica when the fetcher is a replicated store; the
detransform runs once, on the winner's bytes.
"""

from __future__ import annotations

import abc
import io
import logging
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
from tieredstorage_tpu_torch.utils import faults, flightrecorder as flight
from tieredstorage_tpu_torch.utils.deadline import check_deadline
from tieredstorage_tpu_torch.utils.locks import new_lock
from tieredstorage_tpu_torch.utils.streams import read_exactly
from tieredstorage_tpu_torch.utils.tracing import NOOP_TRACER

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

    #: Span recorder; the RSM swaps in its configured tracer so the storage
    #: GET and detransform stages land in the request's trace tree.
    tracer = NOOP_TRACER
    #: Optional latency hook `(elapsed_ms, plaintext_bytes)` per batch; the
    #: RSM wires it to Metrics.record_chunk_fetch.
    on_fetch: Optional[Callable[[float, int], None]] = None
    #: Optional tail-tolerance hedger (fetch/hedge.py); when set, the ranged
    #: storage GET of a chunk window is raced against a delayed second
    #: attempt and the first success wins (`hedge.enabled`).
    hedger = None
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
        self._quarantine_lock = new_lock("chunk_manager.DefaultChunkManager._quarantine_lock")
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
        self.tracer.event("chunk.quarantine", key=key.value, reason=reason)
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
        start = time.monotonic()
        index = manifest.chunk_index
        chunks = [index._chunk_at(cid) for cid in chunk_ids]
        contiguous = all(
            chunks[i + 1].id == chunks[i].id + 1 for i in range(len(chunks) - 1)
        )
        with self.tracer.span(
            "storage.fetch_chunks", key=objects_key.value, chunks=len(chunks),
        ) as fetch_span:
            if self.hedger is not None:
                stored = self.hedger.call(
                    lambda: self._fetch_stored(objects_key, chunks, contiguous),
                    what=objects_key.value,
                    hedge_fn=self._hedge_attempt(objects_key, chunks, contiguous),
                )
            else:
                stored = self._fetch_stored(objects_key, chunks, contiguous)
            stored_bytes = sum(len(b) for b in stored)
            if fetch_span is not None:
                fetch_span.attributes["bytes"] = stored_bytes
        # Flight-record the backend serve: this window's chunks came from
        # remote storage (every tier above missed), with the deadline budget
        # left after the ranged GET.
        flight.note("tier.backend", len(chunk_ids))
        flight.stage(f"backend.fetched:{objects_key.value.rsplit('/', 1)[-1]}")
        opts = DetransformOptions.from_manifest(manifest)
        if self.on_detransform is not None:
            self.on_detransform(opts)
        # GCM window accounting for the record: the CUDA backend exposes its
        # per-thread launch/round-trip counters (host backends don't —
        # duck-typed).
        thread_counters = getattr(self._backend, "thread_dispatch_counters", None)
        counters_before = thread_counters() if thread_counters is not None else None
        # Batch evidence: with the window batcher on, this request's launches
        # ride the flusher thread — the per-thread counters above stay 0 by
        # design, and the batcher's own evidence (coalesced windows,
        # occupancy, shared batch id) shows which launch the request shared.
        batch_seam = getattr(self._backend, "thread_batch_evidence", None)
        batch_before = batch_seam() if batch_seam is not None else None
        try:
            with self.tracer.span(
                "chunk.detransform", chunks=len(stored), bytes_in=stored_bytes,
            ) as span:
                out = self._backend.detransform(stored, opts)
                if span is not None:
                    span.attributes["bytes_out"] = sum(len(b) for b in out)
        except Exception as e:
            # Any detransform failure (AuthenticationError on a GCM tag
            # mismatch, frame errors from the codec) means the stored bytes
            # are poisoned — re-fetching won't fix them, so quarantine the
            # key instead of letting retries hammer the backend.
            self._quarantine_key(objects_key, f"{type(e).__name__}: {e}")
            raise CorruptChunkException(
                f"Detransform failed for chunks {list(chunk_ids)} of {objects_key}"
            ) from e
        if counters_before is not None:
            dispatches, roundtrips = (
                a - b for a, b in zip(thread_counters(), counters_before)
            )
            flight.note("gcm.windows")
            flight.note("gcm.dispatches", dispatches)
            flight.note("gcm.hbm_roundtrips", roundtrips)
            # Which work class this request's GCM windows submitted under
            # (transform/scheduler.py); unscoped fetch threads default to
            # latency.
            from tieredstorage_tpu_torch.transform.scheduler import (
                LATENCY,
                current_work_class,
            )

            flight.stage(f"gcm.class:{current_work_class() or LATENCY}")
        if batch_before is not None:
            windows, occupancy_sum, last_batch_id = batch_seam()
            batched = windows - batch_before[0]
            if batched:
                flight.note("gcm.batched_windows", batched)
                flight.note(
                    "gcm.batch_occupancy", occupancy_sum - batch_before[1]
                )
                # The shared-launch marker: records carrying the same
                # gcm.batch:<id> stage rode the SAME device launch.
                flight.stage(f"gcm.batch:{last_batch_id}")
        flight.stage("backend.detransformed")
        if self.on_fetch is not None:
            self.on_fetch(
                (time.monotonic() - start) * 1000.0, sum(len(b) for b in out)
            )
        return out

    def _hedge_attempt(self, objects_key: ObjectKey, chunks, contiguous: bool):
        """Replica-aware hedge: when the fetcher is replicated
        (ReplicatedStorageBackend.read_fetchers), the hedge reads the same
        window from the second-healthiest replica DIRECTLY, so a straggling
        primary replica is raced by a distinct one instead of being hit
        twice. Single-store fetchers (a resilience or fault decorator
        included) return None: the hedge replays the primary."""
        read_fetchers = getattr(self._fetcher, "read_fetchers", None)
        if read_fetchers is None:
            return None
        ordered = read_fetchers()
        if len(ordered) < 2:
            return None
        alternate = ordered[1]
        return lambda: self._fetch_stored(
            objects_key, chunks, contiguous, fetcher=alternate
        )

    def _fetch_stored(
        self, objects_key: ObjectKey, chunks, contiguous: bool, *, fetcher=None
    ) -> list[bytes]:
        """Read the stored (transformed) bytes of a chunk window.

        Self-contained and replay-safe — opens, fully reads, and closes its
        own stream(s) — which is the contract the hedger needs: a discarded
        losing attempt cannot tear the winner's bytes. `fetcher` overrides
        the configured fetcher for replica-aware hedge attempts.

        The fault plane's `storage.read` seam, per *attempt* (hedge attempts
        each count): an `error` fault propagates as a backend failure;
        `partial` tears the fetched bytes, so the GCM tag check of the
        detransform must refuse them."""
        if fetcher is None:
            fetcher = self._fetcher
        torn = faults.fire("storage.read", str(objects_key))
        if contiguous:
            # One ranged GET covering the window on the transformed side.
            whole = BytesRange.of(
                chunks[0].transformed_position,
                chunks[-1].transformed_position + chunks[-1].transformed_size - 1,
            )
            with fetcher.fetch(objects_key, whole) as stream:
                stored = [read_exactly(stream, c.transformed_size) for c in chunks]
        else:
            stored = []
            for c in chunks:
                with fetcher.fetch(objects_key, c.range()) as stream:
                    stored.append(read_exactly(stream, c.transformed_size))
        if torn:
            stored = [faults.mutate(b, torn) for b in stored]
        return stored
