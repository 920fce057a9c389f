"""Per-request flight recorder: Dapper-style request-scoped evidence.

Counterpart of tieredstorage_tpu/utils/flightrecorder.py. A trace tells you
*that* a fetch was slow; the flight recorder tells you *why this one* was:
which cache tier served each chunk window (chunk cache / device hot tier /
remote backend), how many replica failover hops the storage layer took, what
the GCM window accounting looked like (``dispatches``/``hbm_roundtrips`` per
window, the merged launch a window rode), and how much of the end-to-end
deadline budget remained at each stage (Sigelman et al., "Dapper", 2010).

Mechanics mirror the deadline and tracing contexts (utils/deadline.py,
utils/tracing.py):

- a ``RequestRecord`` is installed in a thread-local by
  ``FlightRecorder.request(...)`` at the request entry (the RSM's traced
  operations);
- layers below enrich the ambient record through the module-level ``note``
  / ``stage`` helpers without plumbing an argument through every
  signature — no active record means the helpers return after one
  thread-local read;
- pool hops that stay within one request (the chunk cache's bounded window
  load) re-install the record explicitly via ``bound`` (the prefetch
  deliberately does NOT — it outlives the request that triggered it);
- the record is keyed by the request's ``trace_id``, so a histogram
  exemplar (metrics/core.py) resolves to the full per-request evidence via
  ``FlightRecorder.find``.

Retention is a bounded ring: the ``ring_size`` SLOWEST completed requests
(min-heap on duration — a fast request never evicts a slow one) plus the
``ring_size`` most recent FAILED requests. Disabled mode is zero-work like
``LockWitness``: ``request`` yields without allocating and the module
helpers see no ambient record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import heapq
import threading
import time
from collections import deque
from typing import Iterator, Optional

from tieredstorage_tpu_torch.utils.locks import new_lock, note_mutation

_local = threading.local()


def _deadline_remaining_s() -> Optional[float]:
    # Deferred: utils.deadline pulls in the storage package (its exception
    # base class), and this module must stay importable from metrics/core.py
    # before any storage module has loaded.
    from tieredstorage_tpu_torch.utils import deadline as deadline_util

    return deadline_util.remaining_s()


@dataclasses.dataclass
class RequestRecord:
    """One request's evidence. Mutated only by the request's own thread and
    the pool workers it explicitly ``bound`` the record to while it blocks
    on them; counters are best-effort by design (a torn increment from a
    worker that outlived its window deadline under-counts one tier serve,
    it never corrupts the ring)."""

    name: str
    trace_id: str
    start_s: float
    end_s: float = 0.0
    error: Optional[str] = None
    #: Deadline budget remaining at entry/exit (ms); None = unconstrained.
    deadline_entry_ms: Optional[float] = None
    deadline_exit_ms: Optional[float] = None
    #: Accumulated evidence counters ("tier.chunk_cache", "hedge.won", ...).
    counters: dict = dataclasses.field(default_factory=dict)
    #: (stage name, ms since request start, deadline remaining ms | None).
    stages: list = dataclasses.field(default_factory=list)

    @property
    def duration_ms(self) -> float:
        return max(0.0, (self.end_s - self.start_s) * 1000.0)

    def tier_breakdown(self) -> dict[str, float]:
        """Chunks served per cache tier (the ``tier.*`` counter family)."""
        return {
            k[len("tier."):]: v
            for k, v in self.counters.items()
            if k.startswith("tier.")
        }

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "trace_id": self.trace_id,
            #: perf_counter at entry — CLOCK_MONOTONIC on Linux, the same
            #: clock the device-scheduler timeline stamps, so an exported
            #: record lands on the launch slices' time axis.
            "start_s": round(self.start_s, 6),
            "duration_ms": round(self.duration_ms, 3),
            "error": self.error,
            "deadline_entry_ms": self.deadline_entry_ms,
            "deadline_exit_ms": self.deadline_exit_ms,
            "tiers": self.tier_breakdown(),
            "counters": dict(self.counters),
            "stages": [list(s) for s in self.stages],
        }
        windows = self.counters.get("gcm.windows", 0.0)
        if windows:
            out["gcm_dispatches_per_window"] = round(
                self.counters.get("gcm.dispatches", 0.0) / windows, 3
            )
            out["gcm_hbm_roundtrips_per_window"] = round(
                self.counters.get("gcm.hbm_roundtrips", 0.0) / windows, 3
            )
        batched = self.counters.get("gcm.batched_windows", 0.0)
        if batched:
            # Mean occupancy of the shared launches this request's windows
            # rode; the per-launch identity is the
            # `gcm.batch:<id>` stage marker.
            out["gcm_batch_occupancy"] = round(
                self.counters.get("gcm.batch_occupancy", 0.0) / batched, 3
            )
        return out


# ------------------------------------------------------------ ambient record
def current_record() -> Optional[RequestRecord]:
    return getattr(_local, "record", None)


def current_trace_id() -> Optional[str]:
    """Trace id of the ambient request record, or None — the exemplar
    source for Histogram buckets (metrics/core.py)."""
    record = current_record()
    return record.trace_id or None if record is not None else None


def note(counter: str, n: float = 1.0) -> None:
    """Add ``n`` to a counter on the ambient record (no-op without one)."""
    record = current_record()
    if record is None:
        return
    record.counters[counter] = record.counters.get(counter, 0.0) + n


def stage(name: str) -> None:
    """Mark a stage on the ambient record: elapsed ms since request start
    and the deadline budget remaining at this point (no-op without one)."""
    record = current_record()
    if record is None:
        return
    remaining = _deadline_remaining_s()
    record.stages.append((
        name,
        round((time.perf_counter() - record.start_s) * 1000.0, 3),
        None if remaining is None else round(remaining * 1000.0, 3),
    ))


@contextlib.contextmanager
def bound(record: Optional[RequestRecord]) -> Iterator[None]:
    """Re-install ``record`` as the ambient record for the block — the
    cross-thread hop for pool work that stays within one request (the chunk
    cache's window load). ``None`` is a no-op, so call sites can pass
    ``current_record()`` captured on the request thread unconditionally."""
    if record is None:
        yield
        return
    prior = current_record()
    _local.record = record
    try:
        yield
    finally:
        _local.record = prior


class FlightRecorder:
    """Bounded recorder of the slowest and the failed requests.

    All shared state (rings + counters) mutates under one lock; records
    themselves are owned by their request thread until archived. Disabled
    recorders never install a record, so every module helper is a single
    thread-local read on the hot path."""

    def __init__(
        self,
        enabled: bool = False,
        *,
        ring_size: int = 64,
        time_source=time.perf_counter,
    ) -> None:
        if ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {ring_size}")
        self.enabled = enabled
        self.ring_size = ring_size
        self._now = time_source
        self._lock = new_lock("flightrecorder.FlightRecorder._lock")
        #: min-heap of (duration_ms, seq, record): the ROOT is the fastest
        #: retained record, so a new slow request evicts it in O(log n).
        self._slow: list[tuple[float, int, RequestRecord]] = []
        self._failed: deque[RequestRecord] = deque(maxlen=ring_size)
        self._seq = 0
        #: Requests archived (exported in /varz's flight section).
        self.requests_seen = 0
        self.requests_failed = 0

    # ------------------------------------------------------------ recording
    @contextlib.contextmanager
    def request(
        self, name: str, *, trace_id: Optional[str] = None
    ) -> Iterator[Optional[RequestRecord]]:
        """Install a fresh record for the block (the request entry point).

        Reentrant like ``ensure_deadline``: when a record is already
        ambient (an outer layer opened one and the RSM operation under it
        enters again) the existing record is yielded untouched, so one
        request is one record regardless of how many layers enter."""
        if not self.enabled or current_record() is not None:
            yield current_record()
            return
        record = RequestRecord(
            name=name, trace_id=trace_id or "", start_s=self._now()
        )
        remaining = _deadline_remaining_s()
        if remaining is not None:
            record.deadline_entry_ms = round(remaining * 1000.0, 3)
        _local.record = record
        try:
            yield record
        except BaseException as e:
            record.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            _local.record = None
            record.end_s = self._now()
            remaining = _deadline_remaining_s()
            if remaining is not None:
                record.deadline_exit_ms = round(remaining * 1000.0, 3)
            self._archive(record)

    def _archive(self, record: RequestRecord) -> None:
        with self._lock:
            self.requests_seen += 1
            note_mutation("flightrecorder.FlightRecorder.requests_seen")
            if record.error is not None:
                self.requests_failed += 1
                note_mutation("flightrecorder.FlightRecorder.requests_failed")
                self._failed.append(record)  # deque maxlen = ring semantics
            entry = (record.duration_ms, self._seq, record)
            self._seq += 1
            if len(self._slow) < self.ring_size:
                heapq.heappush(self._slow, entry)
            elif entry[0] > self._slow[0][0]:
                heapq.heappushpop(self._slow, entry)

    # -------------------------------------------------------------- readers
    def slowest(self, n: Optional[int] = None) -> list[RequestRecord]:
        """Retained records, slowest first."""
        with self._lock:
            ordered = sorted(self._slow, key=lambda e: (-e[0], e[1]))
        records = [record for _, _, record in ordered]
        return records if n is None else records[:n]

    def failures(self) -> list[RequestRecord]:
        """Retained failed records, most recent last."""
        with self._lock:
            return list(self._failed)

    def find(self, trace_id: str) -> Optional[RequestRecord]:
        """Resolve an exemplar/breach trace id to its retained record."""
        matches = self.find_all(trace_id)
        return matches[0] if matches else None

    def find_all(self, trace_id: str) -> list[RequestRecord]:
        """EVERY retained record carrying ``trace_id`` (slow ring first,
        then failed), deduplicated. One trace id can own several records on
        one instance (a prefetch or readahead window stamped with the
        originating stream's id beside the request itself), and a caller
        joining them wants all of them."""
        if not trace_id:
            return []
        out: list[RequestRecord] = []
        with self._lock:
            for _, _, record in self._slow:
                if record.trace_id == trace_id:
                    out.append(record)
            for record in self._failed:
                if record.trace_id == trace_id and not any(
                    r is record for r in out
                ):
                    out.append(record)
        return out

    @property
    def ring_occupancy(self) -> int:
        with self._lock:
            return len(self._slow)

    def summary(self) -> dict:
        """The /varz flight section: totals, ring occupancy, top-3 slowest
        with their tier breakdowns."""
        with self._lock:
            seen, failed = self.requests_seen, self.requests_failed
            occupancy = len(self._slow)
        return {
            "enabled": self.enabled,
            "requests_seen": seen,
            "requests_failed": failed,
            "ring_occupancy": occupancy,
            "ring_size": self.ring_size,
            "top_slowest": [
                {
                    "name": r.name,
                    "trace_id": r.trace_id,
                    "duration_ms": round(r.duration_ms, 3),
                    "tiers": r.tier_breakdown(),
                }
                for r in self.slowest(3)
            ],
        }

    def dump(
        self,
        *,
        limit: Optional[int] = None,
        trace: Optional[str] = None,
        slowest: Optional[int] = None,
    ) -> dict:
        """The ``flight_status`` payload: slowest-first retained records
        plus the failure ring.

        Filters: ``trace`` keeps only records carrying that trace id (both
        rings);
        ``slowest`` returns just the N slowest completed records with an
        empty failure list (the exemplar-selection query)."""
        if trace is not None:
            matches = [r.to_dict() for r in self.find_all(trace)]
            return {
                "enabled": self.enabled,
                "requests_seen": self.requests_seen,
                "requests_failed": self.requests_failed,
                "trace": trace,
                "slowest": matches,
                "failed": [],
            }
        if slowest is not None:
            return {
                "enabled": self.enabled,
                "requests_seen": self.requests_seen,
                "requests_failed": self.requests_failed,
                "slowest": [r.to_dict() for r in self.slowest(slowest)],
                "failed": [],
            }
        slow = self.slowest(limit)
        failed = self.failures()
        if limit is not None:
            failed = failed[-limit:]
        return {
            "enabled": self.enabled,
            "requests_seen": self.requests_seen,
            "requests_failed": self.requests_failed,
            "slowest": [r.to_dict() for r in slow],
            "failed": [r.to_dict() for r in failed],
        }

    def reset(self) -> None:
        with self._lock:
            self._slow.clear()
            self._failed.clear()
            self.requests_seen = 0
            self.requests_failed = 0


#: Process-wide default recorder; the RSM wires a real one from
#: `flight.enabled` (mirrors NOOP_TRACER).
NOOP_RECORDER = FlightRecorder(enabled=False)
