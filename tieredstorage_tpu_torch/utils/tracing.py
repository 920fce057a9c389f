"""Distributed tracing: Dapper-style spans across the RSM, fetch and storage tiers.

Counterpart of tieredstorage_tpu/utils/tracing.py:

- nested spans with wall-time accounting and `trace_id`/`span_id`/`parent_id`
  identity, propagated through a thread-local context stack;
- W3C ``traceparent`` propagation (`current_traceparent` / `continue_trace`)
  so one request shows up as a single tree across process boundaries, and
  across the chunk cache's pool hop;
- optional forwarding into `torch.profiler` (``use_jax_profiler``, the
  config key `tracing.jax.profiler.enabled` keeps the JAX package's name):
  each span opens a ``torch.profiler.record_function`` range and each event
  a zero-length one. Kineto records such a range only on a thread that
  existed when the profiler session started (the session's own thread, in
  practice): the RSM's callers run on the broker's pools, started earlier,
  so their ranges are missing from the profile. `merge_profiler_trace`
  is the route for those threads;
- optional per-span CPU time (``span(..., thread_cpu=True)``): the calling
  thread's ``time.thread_time()`` over the span, as the ``cpu_s``
  attribute. Wall time far above it means the thread waited (on the GIL, a
  lock, the device or the store);
- a bounded ring-buffer recorder (newest spans win; evictions are counted in
  `dropped_spans`) with per-name p50/p95/p99 summaries and a Chrome
  trace-event JSON exporter (loadable in Perfetto / ``chrome://tracing``).
  The export's ``ts`` is wall-clock microseconds (a (wall, perf_counter)
  epoch pinned at construction) and its ``tid`` the native thread id: the
  axis and the thread ids of a Kineto export and of the scheduler timeline
  (metrics/timeline.py), so `merge_profiler_trace` lays the spans, the
  timeline's slices and the device's kernels on one axis.

Usage:
    tracer = Tracer(enabled=True)
    with tracer.span("copy_log_segment_data", topic="t", partition=3):
        with tracer.span("transform"):
            ...
    tracer.write_chrome_trace("artifacts/trace.json")

    with torch.profiler.profile(...) as prof:   # spans on any thread
        ...
    prof.export_chrome_trace("profile.json")
    merged = merge_profiler_trace("profile.json", tracer)
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import threading
import time
from typing import Callable, Iterator, Optional

import torch

from tieredstorage_tpu_torch.utils.locks import new_lock

#: Header/metadata key carrying W3C trace context across process boundaries.
TRACEPARENT_HEADER = "traceparent"

_TRACEPARENT_VERSION = "00"
_HEX = set("0123456789abcdef")


def _gen_trace_id() -> str:
    return os.urandom(16).hex()


def _gen_span_id() -> str:
    return os.urandom(8).hex()


def format_traceparent(trace_id: str, span_id: str) -> str:
    """W3C trace-context header value (always sampled: this tracer records
    everything it is enabled for)."""
    return f"{_TRACEPARENT_VERSION}-{trace_id}-{span_id}-01"


def parse_traceparent(header: Optional[str]) -> Optional[tuple[str, str]]:
    """(trace_id, parent_span_id) from a ``traceparent`` value, or None.

    Lenient per the W3C spec: unknown versions are accepted as long as the
    00-version prefix fields parse; malformed values are ignored (tracing
    must never fail a request)."""
    if not header:
        return None
    parts = header.strip().lower().split("-")
    if len(parts) < 4:
        return None
    version, trace_id, span_id = parts[0], parts[1], parts[2]
    if len(version) != 2 or not set(version) <= _HEX or version == "ff":
        return None
    if len(trace_id) != 32 or not set(trace_id) <= _HEX or trace_id == "0" * 32:
        return None
    if len(span_id) != 16 or not set(span_id) <= _HEX or span_id == "0" * 16:
        return None
    return trace_id, span_id


@dataclasses.dataclass
class Span:
    name: str
    start_s: float
    end_s: float = 0.0
    depth: int = 0
    attributes: dict = dataclasses.field(default_factory=dict)
    trace_id: str = ""
    span_id: str = ""
    parent_id: Optional[str] = None
    thread_id: int = 0
    #: ``threading.get_native_id()`` of the recording thread: the export's
    #: ``tid``, which is the thread id Kineto writes.
    native_thread_id: int = 0

    @property
    def duration_s(self) -> float:
        return max(0.0, self.end_s - self.start_s)


def wall_ts_us(clock_s: float, epoch_wall_s: float, epoch_clock_s: float) -> float:
    """An instant of a monotonic clock (``perf_counter``, ``monotonic``: one
    Linux clock) as wall-clock microseconds, through a (wall, clock) epoch
    pinned once: durations and order stay the monotonic clock's, the axis is
    the wall clock's, which Kineto's exports and other processes share."""
    return (epoch_wall_s + (clock_s - epoch_clock_s)) * 1e6


def _percentile(sorted_durations: list[float], q: float) -> float:
    """Nearest-rank percentile over an ascending-sorted NON-EMPTY list.

    Part of the degenerate-case contract: an empty sample set
    has NO percentile — callers must not see a fabricated 0.0 — so the
    empty list is a programming error here (``summary()`` never builds an
    entry without at least one span). A single sample is every percentile
    of itself (nearest rank: rank 1 of 1)."""
    if not sorted_durations:
        raise ValueError("percentile of an empty sample set is undefined")
    rank = max(1, math.ceil(q * len(sorted_durations)))
    return sorted_durations[min(rank, len(sorted_durations)) - 1]


class Tracer:
    """Nested span recorder; thread-safe, cheap when disabled.

    Spans recorded while another span is active on the same thread (or while
    a remote context installed by `continue_trace` is active) are parented
    under it and share its `trace_id`; otherwise a span starts a new trace.
    The recorder is a ring buffer: once `max_spans` is reached the OLDEST
    span is evicted (and counted in `dropped_spans`), so long soak runs keep
    the newest spans instead of silently freezing the recorder."""

    def __init__(self, enabled: bool = False, *, use_jax_profiler: bool = False,
                 max_spans: int = 10_000, wall_clock: Callable[[], float] = time.time):
        #: ``use_jax_profiler`` keeps the JAX package's name (the config key
        #: `tracing.jax.profiler.enabled`); here it opens torch.profiler
        #: ranges.
        self.enabled = enabled
        self.use_jax_profiler = use_jax_profiler
        self.max_spans = max_spans
        self._spans: collections.deque[Span] = collections.deque(maxlen=max_spans)
        #: Spans evicted from the ring buffer (exported as a counter metric).
        self.dropped_spans = 0
        self._lock = new_lock("tracing.Tracer._lock")
        self._local = threading.local()
        # Pinned once: exported timestamps are wall-clock microseconds (the
        # axis of a Kineto export and of the scheduler timeline), mapped
        # from perf_counter by this one pair, so a wall-clock step mid-run
        # cannot skew span starts against their perf_counter durations. The
        # wall clock is injectable and read here alone, as the timeline's.
        self._epoch_wall = wall_clock()
        self._epoch_perf = time.perf_counter()

    # ---------------------------------------------------------------- context
    def _stack(self) -> list[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _parent_context(self) -> tuple[str, Optional[str]]:
        """(trace_id, parent_span_id) for a new span on this thread."""
        stack = self._stack()
        if stack:
            return stack[-1].trace_id, stack[-1].span_id
        remote = getattr(self._local, "remote", None)
        if remote is not None:
            return remote
        return _gen_trace_id(), None

    def current_traceparent(self) -> Optional[str]:
        """``traceparent`` value for the active context, for injection into
        outgoing HTTP headers / gRPC metadata; None when there is nothing to
        propagate (tracing disabled or no active span)."""
        if not self.enabled:
            return None
        stack = self._stack()
        if stack:
            return format_traceparent(stack[-1].trace_id, stack[-1].span_id)
        remote = getattr(self._local, "remote", None)
        if remote is not None:
            return format_traceparent(remote[0], remote[1])
        return None

    @contextlib.contextmanager
    def continue_trace(self, traceparent: Optional[str]) -> Iterator[None]:
        """Adopt a remote parent context for the duration of the block: spans
        opened inside join the caller's trace instead of starting a new one.
        Malformed/absent headers degrade to a no-op (new root trace)."""
        parsed = parse_traceparent(traceparent) if self.enabled else None
        if parsed is None:
            yield
            return
        prior = getattr(self._local, "remote", None)
        self._local.remote = parsed
        try:
            yield
        finally:
            self._local.remote = prior

    # ---------------------------------------------------------------- record
    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self.dropped_spans += 1
            self._spans.append(span)

    @contextlib.contextmanager
    def span(self, name: str, *, thread_cpu: bool = False,
             **attributes) -> Iterator[Optional[Span]]:
        """Record a span around the block. With ``thread_cpu`` the span also
        gets ``cpu_s``: this thread's CPU time (``time.thread_time()``) over
        the block. A disabled tracer reads no clock."""
        if not self.enabled:
            yield None
            return
        stack = self._stack()
        trace_id, parent_id = self._parent_context()
        s = Span(
            name=name, start_s=time.perf_counter(), depth=len(stack),
            attributes=attributes, trace_id=trace_id, span_id=_gen_span_id(),
            parent_id=parent_id, thread_id=threading.get_ident(),
            native_thread_id=threading.get_native_id(),
        )
        cpu0 = time.thread_time() if thread_cpu else None
        stack.append(s)
        ctx = None
        if self.use_jax_profiler:
            # A torch.profiler range around the span: the Kineto trace shows
            # it on this thread's track, enclosing the kernel launches made
            # inside it.
            ctx = torch.profiler.record_function(name)
            ctx.__enter__()
        try:
            yield s
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)
            s.end_s = time.perf_counter()
            if cpu0 is not None:
                s.attributes["cpu_s"] = time.thread_time() - cpu0
            stack.pop()
            self._record(s)

    def current_span(self) -> Optional[Span]:
        """The innermost span open on this thread (None when disabled)."""
        if not self.enabled:
            return None
        stack = self._stack()
        return stack[-1] if stack else None

    def record(self, name: str, start_s: float, end_s: float, *,
               parent: Optional[Span] = None, **attributes) -> Optional[Span]:
        """Record a span whose ``perf_counter`` start and end were read
        elsewhere (work spread over several threads), as a child of
        ``parent`` when one is given, else of this thread's context."""
        if not self.enabled:
            return None
        if parent is not None:
            trace_id, parent_id, depth = parent.trace_id, parent.span_id, parent.depth + 1
        else:
            (trace_id, parent_id), depth = self._parent_context(), len(self._stack())
        s = Span(
            name=name, start_s=start_s, end_s=end_s, depth=depth,
            attributes=attributes, trace_id=trace_id, span_id=_gen_span_id(),
            parent_id=parent_id, thread_id=threading.get_ident(),
            native_thread_id=threading.get_native_id(),
        )
        self._record(s)
        return s

    def event(self, name: str, **attributes) -> Optional[Span]:
        """Record an instantaneous (zero-duration) span — state transitions
        like circuit-breaker trips or upload rollbacks that have no useful
        extent but must show up on the timeline."""
        if not self.enabled:
            return None
        now = time.perf_counter()
        trace_id, parent_id = self._parent_context()
        s = Span(
            name=name, start_s=now, end_s=now, depth=len(self._stack()),
            attributes=attributes, trace_id=trace_id, span_id=_gen_span_id(),
            parent_id=parent_id, thread_id=threading.get_ident(),
            native_thread_id=threading.get_native_id(),
        )
        if self.use_jax_profiler:
            # Zero-length range: timeline parity with span(), so events land
            # in the profiler trace next to the kernels they interleave with.
            with torch.profiler.record_function(name):
                pass
        self._record(s)
        return s

    # --------------------------------------------------------------- readers
    def spans(self, name: Optional[str] = None) -> list[Span]:
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    @property
    def recorded_spans(self) -> int:
        with self._lock:
            return len(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped_spans = 0

    def summary(self) -> dict[str, dict[str, float]]:
        """Per-name count/total/avg/max plus p50/p95/p99 durations (seconds).

        Degenerate-case contract: no recorded spans means an
        EMPTY dict — a name never appears with fabricated zero percentiles,
        so consumers (``/varz``, the SLO engine's evidence path) can treat
        "absent" as "no data" without a sentinel check. A name with exactly
        one span reports that span's duration as count=1, avg, max, and
        every percentile (nearest-rank: one sample is every quantile of
        itself)."""
        agg: dict[str, list[float]] = {}
        for s in self.spans():
            agg.setdefault(s.name, []).append(s.duration_s)
        out: dict[str, dict[str, float]] = {}
        for name, ds in agg.items():
            ds.sort()
            out[name] = {
                "count": len(ds),
                "total_s": sum(ds),
                "avg_s": sum(ds) / len(ds),
                "max_s": ds[-1],
                "p50_s": _percentile(ds, 0.50),
                "p95_s": _percentile(ds, 0.95),
                "p99_s": _percentile(ds, 0.99),
            }
        return out

    # ---------------------------------------------------------------- export
    def _ts_us(self, perf_s: float) -> float:
        return wall_ts_us(perf_s, self._epoch_wall, self._epoch_perf)

    def chrome_trace_events(self) -> list[dict]:
        """Spans as Chrome trace-event dicts: complete events (``ph: "X"``)
        for timed spans, instant events (``ph: "i"``) for zero-duration
        events; `args` carries the span identity so trees survive the export.
        ``ts`` is wall-clock microseconds, ``tid`` the native thread id."""
        events: list[dict] = []
        pid = os.getpid()
        for s in self.spans():
            args = {
                "trace_id": s.trace_id,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
                **{k: str(v) for k, v in s.attributes.items()},
            }
            base = {
                "name": s.name,
                "cat": "tieredstorage",
                "ts": self._ts_us(s.start_s),
                "pid": pid,
                "tid": s.native_thread_id,
                "args": args,
            }
            if s.duration_s > 0.0:
                events.append({**base, "ph": "X", "dur": s.duration_s * 1e6})
            else:
                events.append({**base, "ph": "i", "s": "t"})
        return events

    def export_chrome_trace(self) -> dict:
        """JSON-object-format Chrome trace (Perfetto / ``chrome://tracing``)."""
        return {
            "traceEvents": self.chrome_trace_events(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": self.dropped_spans},
        }

    def write_chrome_trace(self, path) -> pathlib.Path:
        out = pathlib.Path(path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(self.export_chrome_trace(), indent=1))
        return out


def _cupti_thread_id(ident: int) -> int:
    """The ``tid`` Kineto writes for a CUDA call of the thread whose
    ``pthread_self()`` is ``ident``: its low 32 bits as an int32, without
    the sign (a thread whose low half has the top bit set shows as 2**32
    less that half)."""
    low = ident & 0xFFFFFFFF
    return low if low < 1 << 31 else (1 << 32) - low


def merge_profiler_trace(profile, tracer: Tracer, timeline_events=()) -> dict:
    """A ``torch.profiler`` Chrome export with the tracer's spans (and the
    scheduler timeline's events, when given: a `TimelineRecorder`'s
    ``export_chrome_trace()["traceEvents"]``) merged in, for Perfetto.

    ``profile`` is the export's path or its parsed dict (not modified).
    Kineto writes ``ts`` relative to the file's ``baseTimeNanoseconds`` on
    the wall clock, and native thread ids as the ``tid`` of its CPU events;
    the tracer and the timeline export wall-clock microseconds, so rebasing
    them by the base puts spans, timeline slices and kernels on one axis,
    and a span on the track of the thread that recorded it. On a thread
    the profiler session never registered (one started before it), Kineto
    writes a CUDA runtime or driver call's ``tid`` as CUPTI's thread id,
    ``pthread_self()`` cut to 32 bits, read as a signed number and written
    without its sign: the calls of a thread the tracer saw move to that
    thread's native track, beside the spans around them.
    Unlike ``use_jax_profiler`` this covers spans of threads the profiler
    session never saw."""
    if isinstance(profile, dict):
        doc = dict(profile)
    else:
        doc = json.loads(pathlib.Path(profile).read_text())
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    spans = tracer.spans()
    native_of = {_cupti_thread_id(s.thread_id): s.native_thread_id for s in spans}
    events = []
    for ev in doc.get("traceEvents", ()):
        if ev.get("cat") in ("cuda_runtime", "cuda_driver") and ev.get("tid") in native_of:
            ev = {**ev, "tid": native_of[ev["tid"]]}
        events.append(ev)
    for ev in [*tracer.chrome_trace_events(), *timeline_events]:
        ev = dict(ev)
        if ev.get("ph") != "M":  # metadata carries no instant
            ev["ts"] = float(ev["ts"]) - base_us
        events.append(ev)
    doc["traceEvents"] = events
    return doc


#: Process-wide default tracer; RSM wires it from `tracing.enabled` config.
NOOP_TRACER = Tracer(enabled=False)
