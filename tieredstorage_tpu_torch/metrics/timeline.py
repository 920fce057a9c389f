"""Device-scheduler timeline: Perfetto-exportable launch attribution.

Counterpart of tieredstorage_tpu/metrics/timeline.py. The work-class
scheduler proves isolation in aggregate — class gauges, occupancy
histograms — but none of that answers "why was THIS request slow?". This
module records the scheduler's individual decisions as a bounded event ring
and exports them in the Chrome trace-event format, so one merged GCM launch
is a visible slice on its work class's track and a request's flight record
joins the launches that served it through an explicit flow edge:

- ``TimelineRecorder.record_flush`` is fed by the batcher at the end of
  every merged flush (``WindowBatcher._flush_group``) with the full
  scheduler context: work class, bucket shape, rows/bytes, waiter count,
  queued age, launch begin/end, occupancy, the per-class queue depths at
  launch, and the waiters' flight-recorder trace ids (captured at enqueue
  on the request thread — the flusher has no ambient record). On the card
  the launch's begin/end run from before the host-to-device stage to after
  the output's event synchronised, so the slice covers the device work.
  ``record_expired`` marks deadline-expired windows the flusher dropped
  (the scheduler's fail-fast; an instant event, not a slice).
- Export joins two clock domains that are the SAME Linux clock: the
  batcher stamps ``time.monotonic`` and the flight recorder
  ``time.perf_counter`` (CLOCK_MONOTONIC on Linux), so a launch slice and
  the request slice it served share one time axis within a process. The
  recorder pins a (wall, monotonic) epoch pair at construction, as the
  tracer does (both map through ``utils.tracing.wall_ts_us``), so exported
  ``ts`` values are wall-clock microseconds Perfetto can align across
  processes on one host, and with the tracer's spans and a Kineto export:
  ``utils.tracing.merge_profiler_trace`` merges this export and the
  tracer's spans into a ``torch.profiler`` trace, whichever threads
  recorded them (the tracer's ``record_function`` forwarding reaches the
  profile only from the profiler session's own thread).
- **Flow join**: the chunk manager stamps ``gcm.batch:<id>`` stages on
  flight records (fetch/chunk_manager.py). ``chrome_trace_events`` emits
  a flow-start (``ph: "s"``) at that stage on the request's track and a
  flow-finish (``ph: "f"``) inside the matching launch slice; Perfetto
  draws the arrow. Flow identity is ``(cat, name, id)`` per the trace
  format, so stitched multi-instance exports scope ``cat`` per instance
  (batch ids are per-process sequences and WOULD collide).

Disabled mode is zero-work like ``LockWitness`` and the flight recorder:
every record method returns after one attribute read, before the lock —
asserted by the tests with a poisoned-lock probe. Retention is a strict
FIFO ring with explicit eviction accounting (``events_evicted``), unlike
the flight recorder's keep-the-slowest heap: the timeline's value is
recency (what the device JUST did), not extremes.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Callable, Iterable, Mapping, Optional

from tieredstorage_tpu_torch.utils.locks import new_lock, note_mutation
from tieredstorage_tpu_torch.utils.tracing import wall_ts_us

TIMELINE_METRIC_GROUP = "timeline-metrics"

#: Stable Perfetto track (tid) per work class; request tracks start above.
CLASS_TIDS = {"latency": 1, "throughput": 2, "background": 3}
REQUEST_TID_BASE = 10

#: The flight-recorder stage prefix that names the merged launch a request
#: rode (stamped by fetch/chunk_manager.py) — the flow-join key.
BATCH_STAGE_PREFIX = "gcm.batch:"

#: Chrome trace-event phases this module emits (the schema checker's
#: allowlist): complete slices, instants, flow start/finish, metadata.
_ALLOWED_PHASES = frozenset({"X", "i", "s", "f", "M"})


def batch_ids_of(record: Mapping) -> list[int]:
    """The merged-launch ids a flight record (``to_dict`` shape) rode,
    parsed from its ``gcm.batch:<id>`` stage markers, in stage order."""
    out: list[int] = []
    for stage in record.get("stages", ()):
        name = stage[0]
        if isinstance(name, str) and name.startswith(BATCH_STAGE_PREFIX):
            raw = name[len(BATCH_STAGE_PREFIX):]
            if raw.isdigit():
                out.append(int(raw))
    return out


class TimelineRecorder:
    """Bounded FIFO ring of device-scheduler events.

    All shared state (ring + counters) mutates under one witnessed lock;
    events are plain JSON-safe dicts so ``timeline_status`` serves them
    without a translation layer. A disabled
    recorder never touches the lock (zero-work contract)."""

    def __init__(
        self,
        enabled: bool = False,
        *,
        ring_size: int = 512,
        time_source: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
    ) -> None:
        if ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {ring_size}")
        self.enabled = enabled
        self.ring_size = ring_size
        self._now = time_source
        self._lock = new_lock("timeline.TimelineRecorder._lock")
        self._ring: deque[dict] = deque()
        #: Epoch pin (the tracer's, through `wall_ts_us`): monotonic
        #: instants export as wall-clock microseconds via one linear map
        #: fixed at construction,
        #: so two processes on one host land on one Perfetto axis. Wall
        #: clock is injectable (and read exactly once, here): durations and
        #: ordering stay monotonic; only the export axis is wall-pinned.
        self._epoch_wall = wall_clock()
        self._epoch_mono = time_source()
        # Counters (exported by register_timeline_metrics).
        self.events_recorded = 0
        self.events_evicted = 0
        self.launches_recorded = 0
        self.expired_recorded = 0

    # ------------------------------------------------------------- recording
    def record_flush(
        self,
        *,
        batch_id: int,
        work_class: str,
        decrypt: bool,
        bucket_bytes: int,
        rows: int,
        n_bytes: int,
        occupancy: int,
        queued_age_ms: float,
        begin_s: float,
        end_s: float,
        queue_depths: Optional[Mapping[str, int]] = None,
        trace_ids: Optional[Iterable[Optional[str]]] = None,
    ) -> None:
        """One merged launch: the batcher calls this at the end of
        ``_flush_group`` (outside its condition — the ring has its own
        lock, and a slow timeline reader must never stall submitters)."""
        if not self.enabled:
            return
        event = {
            "kind": "flush",
            "batch_id": int(batch_id),
            "work_class": work_class,
            "direction": "decrypt" if decrypt else "encrypt",
            "bucket_bytes": int(bucket_bytes),
            "rows": int(rows),
            "bytes": int(n_bytes),
            "occupancy": int(occupancy),
            "waiters": int(occupancy),
            "queued_age_ms": round(float(queued_age_ms), 3),
            "begin_s": float(begin_s),
            "end_s": float(end_s),
            "queue_depths": dict(queue_depths or {}),
            "trace_ids": [t for t in (trace_ids or ()) if t],
        }
        self._append(event, launch=True)

    def record_expired(
        self, work_class: str, count: int, at_s: Optional[float] = None
    ) -> None:
        """Deadline-expired windows the flusher failed fast (excluded from
        the pack) — an instant marker on the class's track."""
        if not self.enabled:
            return
        event = {
            "kind": "expired",
            "work_class": work_class,
            "count": int(count),
            "begin_s": float(self._now() if at_s is None else at_s),
        }
        self._append(event, expired=True)

    def _append(self, event: dict, *, launch: bool = False,
                expired: bool = False) -> None:
        with self._lock:
            self._ring.append(event)
            self.events_recorded += 1
            note_mutation("timeline.TimelineRecorder.events_recorded")
            if launch:
                self.launches_recorded += 1
                note_mutation("timeline.TimelineRecorder.launches_recorded")
            if expired:
                self.expired_recorded += 1
                note_mutation("timeline.TimelineRecorder.expired_recorded")
            while len(self._ring) > self.ring_size:
                self._ring.popleft()
                self.events_evicted += 1
                note_mutation("timeline.TimelineRecorder.events_evicted")

    # --------------------------------------------------------------- readers
    def events(self) -> list[dict]:
        """Retained events, oldest first (copies — callers may annotate)."""
        with self._lock:
            return [dict(e) for e in self._ring]

    @property
    def ring_occupancy(self) -> int:
        with self._lock:
            return len(self._ring)

    def epoch(self) -> dict:
        """The (wall, monotonic) epoch pin — exported so a stitcher maps a
        PEER's monotonic timestamps onto the shared wall-clock axis."""
        return {"wall_s": self._epoch_wall, "mono_s": self._epoch_mono}

    def ts_us(self, mono_s: float) -> float:
        """A monotonic instant as wall-clock microseconds (epoch-pinned)."""
        return wall_ts_us(mono_s, self._epoch_wall, self._epoch_mono)

    def status(self) -> dict:
        """The ``timeline_status`` payload: counters, epoch, events."""
        with self._lock:
            events = [dict(e) for e in self._ring]
            recorded, evicted = self.events_recorded, self.events_evicted
            launches, expired = self.launches_recorded, self.expired_recorded
        return {
            "enabled": self.enabled,
            "ring_size": self.ring_size,
            "ring_occupancy": len(events),
            "events_recorded": recorded,
            "events_evicted": evicted,
            "launches_recorded": launches,
            "expired_recorded": expired,
            "epoch": self.epoch(),
            "events": events,
        }

    def export_chrome_trace(self, records: Iterable[Mapping] = ()) -> dict:
        """This recorder's ring (plus optional local flight records) as a
        Chrome-trace JSON object (the RSM and the tests)."""
        epoch = self.epoch()
        events = chrome_trace_events(
            self.events(), records, pid=os.getpid(), epoch=epoch
        )
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"events_evicted": self.events_evicted},
        }


#: Process-wide disabled default (mirrors NOOP_RECORDER / NOOP_TRACER).
NOOP_TIMELINE = TimelineRecorder(enabled=False)


# ------------------------------------------------------------------ metrics
def register_timeline_metrics(registry, recorder: TimelineRecorder) -> None:
    """Publish a recorder's counters as supplier gauges (the
    ``timeline-metrics`` group)."""
    from tieredstorage_tpu_torch.metrics.core import MetricName

    def gauge(name: str, supplier, description: str = "") -> None:
        registry.add_gauge(
            MetricName.of(name, TIMELINE_METRIC_GROUP, description), supplier
        )

    gauge("timeline-enabled", lambda: 1.0 if recorder.enabled else 0.0,
          "Whether the device-scheduler timeline ring is armed "
          "(timeline.enabled)")
    gauge("timeline-events-recorded-total",
          lambda: float(recorder.events_recorded),
          "Scheduler events appended to the timeline ring")
    gauge("timeline-events-evicted-total",
          lambda: float(recorder.events_evicted),
          "Events evicted FIFO once the ring exceeded timeline.ring.size")
    gauge("timeline-launches-recorded-total",
          lambda: float(recorder.launches_recorded),
          "Merged-launch flush events recorded (one per shared launch)")
    gauge("timeline-expired-recorded-total",
          lambda: float(recorder.expired_recorded),
          "Deadline-expiry markers recorded (windows the flusher dropped)")
    gauge("timeline-ring-occupancy",
          lambda: float(recorder.ring_occupancy),
          "Events currently retained in the timeline ring")


# ------------------------------------------------------------- chrome export
def _wall_ts_us(mono_s: float, epoch: Mapping) -> float:
    return wall_ts_us(mono_s, epoch["wall_s"], epoch["mono_s"])


def flow_cat(instance: Optional[str] = None) -> str:
    """Flow-event category. Flow identity is ``(cat, name, id)`` and batch
    ids are per-process sequences, so a stitched export scopes the category
    per instance to keep two instances' batch #7 from joining."""
    return "gcm-batch" if instance is None else f"gcm-batch.{instance}"


def launch_chrome_events(
    timeline_events: Iterable[Mapping], *, pid: int, epoch: Mapping,
    instance: Optional[str] = None,
) -> list[dict]:
    """Scheduler ring events as per-class track slices + flow finishes."""
    out: list[dict] = []
    cat = flow_cat(instance)
    for ev in timeline_events:
        tid = CLASS_TIDS.get(ev.get("work_class"), 0)
        ts = _wall_ts_us(ev["begin_s"], epoch)
        if ev.get("kind") == "flush":
            args = {
                k: ev[k]
                for k in (
                    "batch_id", "work_class", "direction", "bucket_bytes",
                    "rows", "bytes", "occupancy", "waiters", "queued_age_ms",
                    "queue_depths", "trace_ids",
                )
                if k in ev
            }
            dur = max(0.0, (ev["end_s"] - ev["begin_s"]) * 1e6)
            out.append({
                "name": f"gcm.batch:{ev['batch_id']}",
                "cat": "device-scheduler", "ph": "X",
                "ts": ts, "dur": dur, "pid": pid, "tid": tid, "args": args,
            })
            # Flow finish INSIDE the slice (bp:"e" binds to the enclosing
            # slice); the matching "s" sits on the request's track.
            out.append({
                "name": "gcm.batch", "cat": cat, "ph": "f", "bp": "e",
                "id": int(ev["batch_id"]), "ts": ts + dur / 2.0,
                "pid": pid, "tid": tid, "args": {},
            })
        else:
            out.append({
                "name": f"gcm.{ev.get('kind', 'event')}",
                "cat": "device-scheduler", "ph": "i", "s": "t",
                "ts": ts, "pid": pid, "tid": tid,
                "args": {k: v for k, v in ev.items()
                         if k not in ("begin_s", "kind")},
            })
    return out


def request_chrome_events(
    records: Iterable[Mapping], *, pid: int, epoch: Mapping,
    known_batches: Optional[set] = None, instance: Optional[str] = None,
    tid_base: int = REQUEST_TID_BASE,
) -> list[dict]:
    """Flight records (``to_dict`` shape) as request-track slices, stage
    instants, and flow starts at their ``gcm.batch:<id>`` markers.

    ``known_batches`` bounds the flow starts to launches the paired
    scheduler ring actually retained — a dangling flow start renders as an
    arrow to nowhere. Records missing ``start_s`` (records of an older exporter) are
    skipped: without an absolute start the slice has no place on the axis."""
    out: list[dict] = []
    cat = flow_cat(instance)
    for i, rec in enumerate(records):
        start_s = rec.get("start_s")
        if start_s is None:
            continue
        tid = tid_base + i
        ts = _wall_ts_us(start_s, epoch)
        args = {
            "trace_id": rec.get("trace_id", ""),
            "error": rec.get("error"),
            "tiers": rec.get("tiers", {}),
        }
        out.append({
            "name": rec.get("name", "request"), "cat": "request", "ph": "X",
            "ts": ts, "dur": float(rec.get("duration_ms", 0.0)) * 1e3,
            "pid": pid, "tid": tid, "args": args,
        })
        for stage in rec.get("stages", ()):
            name, at_ms = stage[0], float(stage[1])
            stage_ts = ts + at_ms * 1e3
            out.append({
                "name": name, "cat": "request-stage", "ph": "i", "s": "t",
                "ts": stage_ts, "pid": pid, "tid": tid,
                "args": {"deadline_remaining_ms": stage[2]},
            })
            if name.startswith(BATCH_STAGE_PREFIX):
                raw = name[len(BATCH_STAGE_PREFIX):]
                if raw.isdigit() and (
                    known_batches is None or int(raw) in known_batches
                ):
                    out.append({
                        "name": "gcm.batch", "cat": cat, "ph": "s",
                        "id": int(raw), "ts": stage_ts,
                        "pid": pid, "tid": tid, "args": {},
                    })
    return out


def chrome_trace_events(
    timeline_events: Iterable[Mapping], records: Iterable[Mapping] = (),
    *, pid: int, epoch: Mapping, instance: Optional[str] = None,
) -> list[dict]:
    """One instance's combined event list, sorted by ``ts`` (which makes
    every per-track sequence monotonic — the schema checker's contract)."""
    timeline_events = list(timeline_events)
    known = {
        ev["batch_id"] for ev in timeline_events if ev.get("kind") == "flush"
    }
    events = launch_chrome_events(
        timeline_events, pid=pid, epoch=epoch, instance=instance
    ) + request_chrome_events(
        records, pid=pid, epoch=epoch, known_batches=known, instance=instance
    )
    events.sort(key=lambda e: e["ts"])
    if instance is not None:
        events.insert(0, {
            "name": "process_name", "cat": "__metadata", "ph": "M",
            "ts": 0.0, "pid": pid, "tid": 0,
            "args": {"name": instance},
        })
    return events


def validate_chrome_events(events: Iterable[Mapping]) -> int:
    """Schema-check a Chrome trace-event list (the tests' and the smoke's gate):
    required ``ph``/``ts``/``pid``/``tid`` keys, known phases, ``dur`` on
    complete events, flow events carrying an ``id``, and per-track
    monotonic timestamps. Returns the event count; raises ``ValueError``
    on the first violation."""
    last_ts: dict[tuple, float] = {}
    count = 0
    for ev in events:
        for key in ("ph", "ts", "pid", "tid", "name"):
            if key not in ev:
                raise ValueError(f"trace event missing {key!r}: {ev!r}")
        ph = ev["ph"]
        if ph not in _ALLOWED_PHASES:
            raise ValueError(f"unknown phase {ph!r}: {ev!r}")
        if ph == "X" and "dur" not in ev:
            raise ValueError(f"complete event missing dur: {ev!r}")
        if ph in ("s", "f") and "id" not in ev:
            raise ValueError(f"flow event missing id: {ev!r}")
        if ph == "M":
            count += 1
            continue
        track = (ev["pid"], ev["tid"])
        ts = float(ev["ts"])
        if ts < last_ts.get(track, float("-inf")):
            raise ValueError(
                f"track {track} timestamps not monotonic at {ev!r}"
            )
        last_ts[track] = ts
        count += 1
    return count
