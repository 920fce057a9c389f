"""Predictive sequential readahead: speculate FUTURE windows, pre-admit them.

Counterpart of tieredstorage_tpu/fetch/readahead.py. Speculative launches
carry synthetic flight records (``readahead.window``) stamped with the
originating stream's trace id, the background work class and the
speculative tag: with `transform.batch.enabled` the window batcher
(transform/batcher.py) admits them as background-class work; without it
they launch on the card as they come.

Kafka consumers replay log segments front to back, so the fetch stream of a
replaying consumer is near-perfectly predictable — yet without this tier a
cold massed replay is served as a reactive cache-miss storm: every window
pays storage latency + a latency-class decrypt right on the consumer's
critical path. The informed-prefetching line of work (Patterson et al.,
TIP, SOSP '95) says the fix is to turn disclosed/detected sequentiality
into *scheduled* background work; the continuous-batching lever (Orca,
OSDI '22) says speculated
windows should keep the device queue full between foreground arrivals.

``ReadaheadManager`` is the outermost fetch tier (above the chunk cache,
inserted by ``fetch/factory.py`` when ``readahead.enabled``)::

    ReadaheadManager -> ChunkCache -> DeviceHotCache
                     -> DefaultChunkManager -> storage

Per segment stream it runs a small detector state machine:

- ``IDLE`` — every stream starts here. Consecutive *sequential* window
  reads (window N+1 starts exactly where window N ended) accumulate a
  run; ``promote_after`` consecutive sequential reads promote the stream
  (hysteresis: one sequential read is not a pattern).
- ``READAHEAD`` — the manager speculates ``readahead.window.chunks``
  chunks past the stream's frontier on every foreground read, issuing
  them through the *delegate chain* on its own small pool under
  ``work_class_scope(BACKGROUND)`` + ``speculative_scope()`` so the
  decrypts join the batcher's background admission class and can never
  out-rank a latency-class fetch. The loads populate the chunk cache /
  hot tier exactly like foreground loads do — pre-admission IS a cache
  population — and the chunk cache's per-chunk single-flight guarantees
  a foreground read that arrives mid-speculation JOINS the in-flight
  decode instead of double-decrypting.
- Mispredictions (a non-sequential jump while promoted) are strikes;
  ``max_strikes`` strikes demote the stream back to ``IDLE`` and charge
  every unused speculated byte to ``wasted_bytes`` (strike-based
  demotion, not single-miss: one seek in an otherwise sequential replay
  must not kill the pipeline).

Speculation is bounded by a HARD in-flight byte budget
(``readahead.budget.bytes``) and self-throttles when the observed
wasted-decrypt-bytes ratio exceeds ``readahead.misprediction.max.ratio``,
so a wrong prediction model degrades to the reactive baseline instead of
burning the device.

Cross-segment continuation: a segment's chunk index ends, but the replay
does not — when the frontier crosses the segment end and a
``next_segment_resolver`` is wired (harness/broker-side knowledge of
segment ordering; the resolver typically rides the RSM's keyed
single-flight ``ManifestLookahead`` so N streams crossing one boundary
resolve the next manifest once), the first window of the NEXT segment is
speculated and its stream is pre-promoted, so the consumer crosses the
boundary into an already-warm cache.

Every counter here is guarded by ``_lock``, with ``note_mutation`` at each
write site under the JAX twin's names.
"""

from __future__ import annotations

import dataclasses
import io
import logging
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import BinaryIO, Callable, Optional, Sequence

from tieredstorage_tpu_torch.config.configdef import ConfigDef, ConfigKey, in_range
from tieredstorage_tpu_torch.fetch.cache.chunk_cache import ChunkKey
from tieredstorage_tpu_torch.fetch.chunk_manager import ChunkManager
from tieredstorage_tpu_torch.manifest.segment_manifest import SegmentManifestV1
from tieredstorage_tpu_torch.storage.core import ObjectKey
from tieredstorage_tpu_torch.transform.scheduler import BACKGROUND, work_class_scope
from tieredstorage_tpu_torch.transform.scheduler import speculative_scope
from tieredstorage_tpu_torch.utils import flightrecorder as flight
from tieredstorage_tpu_torch.utils.locks import new_lock, note_mutation
from tieredstorage_tpu_torch.utils.tracing import NOOP_TRACER

log = logging.getLogger(__name__)

#: Consecutive sequential window reads before a stream is promoted to
#: READAHEAD (hysteresis: one sequential pair is coincidence, two are a
#: pattern — TIP's "sequential detection" default).
DEFAULT_PROMOTE_AFTER = 2
#: Mispredictions while promoted before the stream is demoted back to
#: IDLE (strike-based: a single seek must not kill the pipeline).
DEFAULT_MAX_STRIKES = 2

IDLE = "idle"
READAHEAD = "readahead"

#: A resolver maps the CURRENT segment's object key to the next segment in
#: replay order: ``(next_object_key, manifest_loader)`` or None at the log
#: head. Segment ordering is broker-side knowledge (base offsets), so the
#: RSM/harness wires this seam; the loader should ride the manifest
#: lookahead (fetch/manifest_cache.py) for keyed single-flight resolution.
NextSegmentResolver = Callable[
    [ObjectKey], Optional[tuple[ObjectKey, Callable[[], SegmentManifestV1]]]
]


def _definition() -> ConfigDef:
    """Top-level ``readahead.*`` keys, read by the ChunkManagerFactory (the
    JAX package's names, types and defaults)."""
    d = ConfigDef()
    d.define(ConfigKey(
        "readahead.enabled", "bool", default=False, importance="medium",
        doc="Insert the predictive sequential-readahead tier above the "
            "chunk cache: streams detected as sequential get future "
            "windows speculated as background-class work and pre-admitted "
            "into the chunk cache / device hot tier before the consumer "
            "asks. Disabled is zero-work (the tier is not built).",
    ))
    d.define(ConfigKey(
        "readahead.window.chunks", "int", default=8,
        validator=in_range(1, 4096), importance="medium",
        doc="Chunks speculated per readahead launch: each launch covers "
            "this many chunks past the stream's frontier with ONE delegate "
            "window read (one ranged GET + one batched detransform).",
    ))
    d.define(ConfigKey(
        "readahead.streams.max", "int", default=64,
        validator=in_range(1, None), importance="low",
        doc="Per-segment streams tracked by the sequential detector; the "
            "least-recently-observed stream is evicted beyond this (its "
            "unused speculated bytes are charged as wasted).",
    ))
    d.define(ConfigKey(
        "readahead.budget.bytes", "long", default=16 * 1024 * 1024,
        validator=in_range(0, None), importance="medium",
        doc="HARD in-flight speculation budget in original (plaintext) "
            "bytes across all streams: a launch that would exceed it is "
            "deferred to the next foreground read, so speculation can "
            "never starve latency-class fetches or run away on the "
            "device. 0 disables speculation while keeping the detector.",
    ))
    d.define(ConfigKey(
        "readahead.misprediction.max.ratio", "double", default=0.2,
        validator=in_range(0.0, 1.0), importance="medium",
        doc="Bound on wasted speculative decrypt bytes as a fraction of "
            "all speculated bytes: the manager self-throttles (stops "
            "launching) while the observed ratio exceeds it.",
    ))
    return d


@dataclasses.dataclass
class _Speculated:
    """One speculated chunk, from launch until used/wasted/failed."""

    stream: str
    n_bytes: int
    completed_at: Optional[float] = None
    #: Stream was demoted/evicted while this chunk's load was in flight:
    #: charge it as wasted when the load completes.
    doomed: bool = False


class _Stream:
    """Per-segment detector state (guarded by the manager's ``_lock``)."""

    __slots__ = (
        "state", "expected_next", "runs", "strikes", "frontier",
        "outstanding", "continued",
    )

    def __init__(self, expected_next: int) -> None:
        self.state = IDLE
        #: Chunk id a sequential continuation would start at.
        self.expected_next = expected_next
        self.runs = 0
        self.strikes = 0
        #: Next chunk id to speculate (never behind the foreground read).
        self.frontier = expected_next
        #: ChunkKeys speculated for this stream and not yet used/wasted.
        self.outstanding: set[ChunkKey] = set()
        #: Cross-segment continuation already planned for this segment.
        self.continued = False


class ReadaheadManager(ChunkManager):
    """Outermost fetch tier: detect sequential streams, speculate ahead."""

    #: Span recorder; the RSM swaps in its configured tracer.
    tracer = NOOP_TRACER
    #: Synthetic-record source for speculative launches; the RSM wires its
    #: configured FlightRecorder so readahead windows are attributable to
    #: their stream.
    flight_recorder = flight.NOOP_RECORDER
    #: Cross-segment continuation seam (see NextSegmentResolver).
    next_segment_resolver: Optional[NextSegmentResolver] = None

    def __init__(
        self,
        delegate: ChunkManager,
        *,
        window_chunks: int = 8,
        streams_max: int = 64,
        budget_bytes: int = 16 * 1024 * 1024,
        misprediction_max_ratio: float = 0.2,
        promote_after: int = DEFAULT_PROMOTE_AFTER,
        max_strikes: int = DEFAULT_MAX_STRIKES,
        time_source: Callable[[], float] = time.monotonic,
        max_workers: int = 2,
    ) -> None:
        if window_chunks < 1:
            raise ValueError(f"window_chunks must be >= 1, got {window_chunks}")
        if streams_max < 1:
            raise ValueError(f"streams_max must be >= 1, got {streams_max}")
        if budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, got {budget_bytes}")
        if not 0.0 <= misprediction_max_ratio <= 1.0:
            raise ValueError(
                "misprediction_max_ratio must be in [0, 1], "
                f"got {misprediction_max_ratio}"
            )
        self._delegate = delegate
        self.window_chunks = int(window_chunks)
        self.streams_max = int(streams_max)
        self.budget_bytes = int(budget_bytes)
        self.misprediction_max_ratio = float(misprediction_max_ratio)
        self.promote_after = int(promote_after)
        self.max_strikes = int(max_strikes)
        self._now = time_source
        self._executor = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="readahead"
        )
        self._lock = new_lock("readahead.ReadaheadManager._lock")
        #: LRU of per-segment detector states (segment file name -> _Stream).
        self._streams: "OrderedDict[str, _Stream]" = OrderedDict()
        #: Every speculated chunk not yet used/wasted/failed.
        self._speculated: dict[ChunkKey, _Speculated] = {}
        # --- counters (all guarded by _lock) ---
        self.promotions = 0
        self.demotions = 0
        self.strikes = 0
        self.stream_evictions = 0
        self.windows_launched = 0
        self.chunks_speculated = 0
        self.bytes_speculated = 0
        self.inflight_bytes = 0
        self.used_chunks = 0
        self.used_bytes = 0
        self.wasted_bytes = 0
        self.budget_deferrals = 0
        self.ratio_throttles = 0
        self.cross_segment_continuations = 0
        self.speculation_failures = 0
        #: Pre-admit-to-use age accounting (completed speculation -> first
        #: foreground use), for the freshness gauge.
        self.pre_admit_age_ms_sum = 0.0
        self.pre_admit_age_samples = 0

    # ---------------------------------------------------------- observability
    @property
    def tracked_streams(self) -> int:
        with self._lock:
            return len(self._streams)

    @property
    def outstanding_chunks(self) -> int:
        with self._lock:
            return len(self._speculated)

    @property
    def hit_rate(self) -> float:
        """Speculated chunks later consumed by a foreground read."""
        with self._lock:
            if self.chunks_speculated == 0:
                return 0.0
            return self.used_chunks / self.chunks_speculated

    @property
    def misprediction_ratio(self) -> float:
        """Wasted speculative decrypt bytes / all speculated bytes."""
        with self._lock:
            return self._misprediction_ratio_locked()

    @property
    def mean_pre_admit_age_ms(self) -> float:
        with self._lock:
            if self.pre_admit_age_samples == 0:
                return 0.0
            return self.pre_admit_age_ms_sum / self.pre_admit_age_samples

    def _misprediction_ratio_locked(self) -> float:
        if self.bytes_speculated == 0:
            return 0.0
        return self.wasted_bytes / self.bytes_speculated

    # ----------------------------------------------------------------- reads
    def get_chunk(
        self, objects_key: ObjectKey, manifest: SegmentManifestV1, chunk_id: int
    ) -> BinaryIO:
        return io.BytesIO(self.get_chunks(objects_key, manifest, [chunk_id])[0])

    def get_chunks(
        self, objects_key: ObjectKey, manifest: SegmentManifestV1,
        chunk_ids: Sequence[int],
    ) -> list[bytes]:
        if not chunk_ids:
            return []
        launches = self._observe(objects_key, manifest, chunk_ids)
        # Launch speculation BEFORE the foreground read so the speculative
        # window's fetch+decrypt overlaps with it (the windows are disjoint;
        # shared chunks would coalesce in the cache's single-flight anyway).
        for launch in launches:
            self._executor.submit(self._speculate, *launch)
        return self._delegate.get_chunks(objects_key, manifest, chunk_ids)

    # -------------------------------------------------------------- detector
    def _observe(
        self, objects_key: ObjectKey, manifest: SegmentManifestV1,
        chunk_ids: Sequence[int],
    ) -> list[tuple]:
        """Advance the stream's detector state for one foreground window
        read and return the speculation launches to submit (possibly
        empty). Runs entirely under ``_lock``; launches run the storage
        and device work OUTSIDE it."""
        first, last = chunk_ids[0], chunk_ids[-1]
        stream_key = ChunkKey.of(objects_key, first).segment_file_name
        trace_id = flight.current_trace_id() or ""
        with self._lock:
            stream = self._streams.get(stream_key)
            if stream is None:
                stream = _Stream(expected_next=last + 1)
                self._streams[stream_key] = stream
                self._evict_streams_locked()
            else:
                self._streams.move_to_end(stream_key)
                self._advance_locked(stream, first, last)
            # Consume pre-admitted chunks covered by this read (their use
            # is what the whole subsystem exists for).
            self._consume_locked(stream, objects_key, chunk_ids)
            if stream.state != READAHEAD:
                return []
            flight.note("readahead.stream_hits" if stream.outstanding else
                        "readahead.stream", 1)
            return self._plan_locked(stream, objects_key, manifest, last, trace_id)

    def _advance_locked(self, stream: _Stream, first: int, last: int) -> None:
        if first == stream.expected_next:
            stream.runs += 1
            if stream.state == IDLE and stream.runs >= self.promote_after:
                stream.state = READAHEAD
                stream.strikes = 0
                stream.frontier = max(stream.frontier, last + 1)
                self.promotions += 1
                note_mutation("readahead.ReadaheadManager.promotions")
        elif last + 1 == stream.expected_next:
            # Re-read ending at the current frontier (broker retry of the
            # previous window): neither a run nor a strike — idempotent
            # retries are not seeks.
            pass
        else:
            stream.runs = 0
            if stream.state == READAHEAD:
                stream.strikes += 1
                self.strikes += 1
                note_mutation("readahead.ReadaheadManager.strikes")
                if stream.strikes >= self.max_strikes:
                    self._demote_locked(stream)
        stream.expected_next = last + 1
        if stream.state == READAHEAD:
            stream.frontier = max(stream.frontier, last + 1)

    def _demote_locked(self, stream: _Stream) -> None:
        stream.state = IDLE
        stream.runs = 0
        stream.strikes = 0
        self.demotions += 1
        note_mutation("readahead.ReadaheadManager.demotions")
        self._discard_outstanding_locked(stream)

    def _discard_outstanding_locked(self, stream: _Stream) -> None:
        """Charge a stream's unused predictions as wasted; in-flight loads
        are doomed in place (charged on completion)."""
        for key in stream.outstanding:
            entry = self._speculated.get(key)
            if entry is None:
                continue
            if entry.completed_at is not None:
                del self._speculated[key]
                self.wasted_bytes += entry.n_bytes
                note_mutation("readahead.ReadaheadManager.wasted_bytes")
            else:
                entry.doomed = True
        stream.outstanding.clear()

    def _evict_streams_locked(self) -> None:
        while len(self._streams) > self.streams_max:
            _, evicted = self._streams.popitem(last=False)
            self.stream_evictions += 1
            note_mutation("readahead.ReadaheadManager.stream_evictions")
            self._discard_outstanding_locked(evicted)

    def _consume_locked(
        self, stream: _Stream, objects_key: ObjectKey,
        chunk_ids: Sequence[int],
    ) -> None:
        used = 0
        now = self._now()
        for cid in chunk_ids:
            key = ChunkKey.of(objects_key, cid)
            entry = self._speculated.pop(key, None)
            if entry is None:
                continue
            stream.outstanding.discard(key)
            used += 1
            self.used_chunks += 1
            note_mutation("readahead.ReadaheadManager.used_chunks")
            self.used_bytes += entry.n_bytes
            note_mutation("readahead.ReadaheadManager.used_bytes")
            if entry.completed_at is not None:
                self.pre_admit_age_ms_sum += (now - entry.completed_at) * 1000.0
                note_mutation("readahead.ReadaheadManager.pre_admit_age_ms_sum")
                self.pre_admit_age_samples += 1
                note_mutation("readahead.ReadaheadManager.pre_admit_age_samples")
        # Predictions the stream ran PAST without using are mispredicted
        # bytes even without a demotion (the consumer skipped them).
        superseded = [
            key for key in stream.outstanding if key.chunk_id < chunk_ids[0]
        ]
        for key in superseded:
            entry = self._speculated.get(key)
            stream.outstanding.discard(key)
            if entry is None:
                continue
            if entry.completed_at is not None:
                del self._speculated[key]
                self.wasted_bytes += entry.n_bytes
                note_mutation("readahead.ReadaheadManager.wasted_bytes")
            else:
                entry.doomed = True
        if used:
            flight.note("tier.readahead", used)

    # -------------------------------------------------------------- planning
    def _plan_locked(
        self, stream: _Stream, objects_key: ObjectKey,
        manifest: SegmentManifestV1, last: int, trace_id: str,
    ) -> list[tuple]:
        launches: list[tuple] = []
        if self.budget_bytes <= 0:
            return launches
        if self._misprediction_ratio_locked() > self.misprediction_max_ratio:
            # Self-throttle: the prediction model is provably wrong right
            # now — stop speculating until used bytes pull the ratio back
            # under the bound (degrades to the reactive baseline).
            self.ratio_throttles += 1
            note_mutation("readahead.ReadaheadManager.ratio_throttles")
            return launches
        index = manifest.chunk_index
        stream_key = ChunkKey.of(objects_key, last).segment_file_name
        start = max(stream.frontier, last + 1)
        if start < index.chunk_count:
            ids = list(range(start, min(start + self.window_chunks,
                                        index.chunk_count)))
            planned = self._admit_locked(stream, objects_key, index, ids)
            if planned:
                stream.frontier = ids[-1] + 1
                launches.append(
                    (objects_key, manifest, ids, planned, trace_id, stream_key)
                )
        if (
            stream.frontier >= index.chunk_count
            and not stream.continued
            and self.next_segment_resolver is not None
        ):
            # The frontier crossed the segment end: continue into the next
            # segment (resolved + planned on the pool — the resolver may
            # fetch a manifest and must not run under this lock).
            stream.continued = True
            launches.append((objects_key, None, None, None, trace_id, stream_key))
        return launches

    def _admit_locked(
        self, stream: _Stream, objects_key: ObjectKey, index, ids: list[int]
    ) -> Optional[int]:
        """Budget admission for one speculative window: returns its byte
        cost and registers its chunks, or None when deferred."""
        ids[:] = [
            cid for cid in ids
            if ChunkKey.of(objects_key, cid) not in self._speculated
        ]
        if not ids:
            return None
        n_bytes = sum(index._chunk_at(cid).original_size for cid in ids)
        if self.inflight_bytes + n_bytes > self.budget_bytes:
            self.budget_deferrals += 1
            note_mutation("readahead.ReadaheadManager.budget_deferrals")
            return None
        stream_key = ChunkKey.of(objects_key, ids[0]).segment_file_name
        for cid in ids:
            key = ChunkKey.of(objects_key, cid)
            self._speculated[key] = _Speculated(
                stream=stream_key,
                n_bytes=index._chunk_at(cid).original_size,
            )
            stream.outstanding.add(key)
        self.inflight_bytes += n_bytes
        note_mutation("readahead.ReadaheadManager.inflight_bytes")
        self.bytes_speculated += n_bytes
        note_mutation("readahead.ReadaheadManager.bytes_speculated")
        self.windows_launched += 1
        note_mutation("readahead.ReadaheadManager.windows_launched")
        self.chunks_speculated += len(ids)
        note_mutation("readahead.ReadaheadManager.chunks_speculated")
        return n_bytes

    # ------------------------------------------------------------ speculation
    def _speculate(
        self, objects_key: ObjectKey, manifest, ids, n_bytes,
        trace_id: str, stream_key: str,
    ) -> None:
        """Pool entry point for one speculative launch. ``manifest is
        None`` marks a cross-segment continuation: resolve the next
        segment first, then plan + load its first window."""
        try:
            if manifest is None:
                resolved = self._continue_next_segment(objects_key)
                if resolved is None:
                    return
                objects_key, manifest, ids, n_bytes, stream_key = resolved
            self._load_window(objects_key, manifest, ids, n_bytes, trace_id,
                              stream_key)
        except Exception:
            # Isolation boundary: speculation must never propagate into (or
            # wedge) anything — it is a bet, and a failed bet just means
            # the foreground read pays the reactive price later.
            log.debug("Readahead speculation failed for %s", objects_key,
                      exc_info=True)

    def _continue_next_segment(self, objects_key: ObjectKey):
        resolved = self.next_segment_resolver(objects_key)
        if resolved is None:
            return None
        next_key, manifest_loader = resolved
        with self.tracer.span("readahead.next_segment", key=next_key.value):
            manifest = manifest_loader()
        index = manifest.chunk_index
        ids = list(range(0, min(self.window_chunks, index.chunk_count)))
        if not ids:
            return None
        next_stream_key = ChunkKey.of(next_key, 0).segment_file_name
        with self._lock:
            stream = self._streams.get(next_stream_key)
            if stream is None:
                # Pre-promote the continuation stream: the consumer will
                # start the next segment at chunk 0, already sequential.
                stream = _Stream(expected_next=0)
                self._streams[next_stream_key] = stream
                self._evict_streams_locked()
            stream.state = READAHEAD
            stream.runs = self.promote_after
            planned = self._admit_locked(stream, next_key, index, ids)
            if planned is None:
                return None
            stream.frontier = ids[-1] + 1
            self.cross_segment_continuations += 1
            note_mutation(
                "readahead.ReadaheadManager.cross_segment_continuations"
            )
        return next_key, manifest, ids, planned, next_stream_key

    def _load_window(
        self, objects_key: ObjectKey, manifest: SegmentManifestV1,
        ids: list[int], n_bytes: int, trace_id: str, stream_key: str,
    ) -> None:
        """Load one speculative window through the delegate chain under a
        synthetic flight record + background work class. The delegate IS
        the chunk cache, so the verified plaintext lands in the cache (and
        offers itself to the hot tier) exactly like a foreground load —
        and any concurrent foreground read single-flight-joins it."""
        keys = [ChunkKey.of(objects_key, cid) for cid in ids]
        try:
            # Pool workers carry no ambient record, so this opens a REAL
            # synthetic record (request() is reentrant) attributed to the
            # originating stream's trace id — readahead flows are visible
            # work, not anonymous background load.
            with self.flight_recorder.request("readahead.window",
                                              trace_id=trace_id):
                flight.note("readahead.chunks", len(ids))
                flight.stage(f"readahead.segment:{stream_key}")
                with work_class_scope(BACKGROUND), speculative_scope():
                    with self.tracer.span(
                        "readahead.window", key=objects_key.value,
                        chunks=len(ids),
                    ):
                        self._delegate.get_chunks(objects_key, manifest, ids)
        except Exception:
            self._resolve_failed(keys, n_bytes)
            raise
        self._resolve_completed(keys, n_bytes)

    def _resolve_completed(self, keys: list[ChunkKey], n_bytes: int) -> None:
        now = self._now()
        with self._lock:
            self.inflight_bytes -= n_bytes
            note_mutation("readahead.ReadaheadManager.inflight_bytes")
            for key in keys:
                entry = self._speculated.get(key)
                if entry is None:
                    continue  # consumed (single-flight join) mid-load
                if entry.doomed:
                    del self._speculated[key]
                    self.wasted_bytes += entry.n_bytes
                    note_mutation("readahead.ReadaheadManager.wasted_bytes")
                else:
                    entry.completed_at = now

    def _resolve_failed(self, keys: list[ChunkKey], n_bytes: int) -> None:
        with self._lock:
            self.inflight_bytes -= n_bytes
            note_mutation("readahead.ReadaheadManager.inflight_bytes")
            self.speculation_failures += 1
            note_mutation("readahead.ReadaheadManager.speculation_failures")
            for key in keys:
                entry = self._speculated.pop(key, None)
                if entry is None:
                    continue
                # Never decrypted: not wasted decrypt bytes — back the
                # failed window out of the speculated total entirely.
                self.bytes_speculated -= entry.n_bytes
                note_mutation("readahead.ReadaheadManager.bytes_speculated")
                stream = self._streams.get(entry.stream)
                if stream is not None:
                    stream.outstanding.discard(key)

    # ----------------------------------------------------------------- close
    def close(self) -> None:
        # Drain speculation before the tiers below close: an in-flight
        # speculative decode must not reach a closed transform backend.
        self._executor.shutdown(wait=True, cancel_futures=True)
        if hasattr(self._delegate, "close"):
            self._delegate.close()
