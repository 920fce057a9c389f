"""The port's tracer against the JAX package's.

Span and trace ids are random, so trees compare after renumbering: each
span by its position in the ring, each trace by its first appearance.
Under one fake `time.perf_counter`/`time.monotonic` the durations, the
summaries and the Chrome export (timestamps included) are equal too: the
port exports wall-clock timestamps and native thread ids, so the fake
clock is also the port tracer's wall clock, and the native thread id reads
`threading.get_ident()`, the JAX export's `tid`. The port forwards spans
into `torch.profiler` where the JAX package forwards into `jax.profiler`.

The port's own: per-span CPU time (`thread_cpu`), and the merge of its
spans and of the scheduler timeline into a `torch.profiler` export on the
profile's axis (`merge_profiler_trace`).
"""

from __future__ import annotations

import functools
import json
import threading
import time
import types

import pytest
import torch

import tieredstorage_tpu.utils.tracing as jax_tracing
import tieredstorage_tpu_torch.utils.tracing as port_tracing

JAX = types.SimpleNamespace(tracing=jax_tracing)
PORT = types.SimpleNamespace(tracing=port_tracing)


class FakeClock:
    def __init__(self) -> None:
        self.at = 1000.0

    def __call__(self) -> float:
        return self.at


@pytest.fixture
def clock(monkeypatch):
    fake = FakeClock()
    monkeypatch.setattr(time, "perf_counter", fake)
    monkeypatch.setattr(time, "monotonic", fake)
    monkeypatch.setattr(port_tracing, "Tracer",
                        functools.partial(port_tracing.Tracer, wall_clock=fake))
    monkeypatch.setattr(threading, "get_native_id", threading.get_ident)
    return fake


def _tree(tracer):
    """Spans with ids renumbered: (name, depth, parent position, trace
    number, attributes, start, end)."""
    spans = tracer.spans()
    pos = {s.span_id: i for i, s in enumerate(spans)}
    traces: dict[str, int] = {}
    out = []
    for s in spans:
        trace = traces.setdefault(s.trace_id, len(traces))
        parent = pos.get(s.parent_id, None if s.parent_id is None else s.parent_id)
        out.append((s.name, s.depth, parent, trace, s.attributes, s.start_s, s.end_s))
    return out


def _chrome(tracer):
    doc = tracer.export_chrome_trace()
    ids: dict[str, str] = {}

    def renumber(v):
        return None if v is None else ids.setdefault(v, f"id{len(ids)}")

    for e in doc["traceEvents"]:
        for k in ("trace_id", "span_id", "parent_id"):
            e["args"][k] = renumber(e["args"][k])
    return doc


# ----------------------------------------------------------------- sequences
def seq_nested(m, clock):
    tracer = m.tracing.Tracer(enabled=True)
    with tracer.span("root", topic="t", partition=3):
        clock.at += 0.5
        with tracer.span("child", n=1):
            tracer.event("leaf", why="x")
            clock.at += 0.25
        with tracer.span("child", n=2):
            clock.at += 0.125
    with tracer.span("sibling"):
        clock.at += 0.0625
    return _tree(tracer), tracer.summary(), _chrome(tracer)


def seq_ring(m, clock):
    tracer = m.tracing.Tracer(enabled=True, max_spans=5)
    for i in range(8):
        tracer.event(f"e{i}")
    before = (_tree(tracer), tracer.recorded_spans, tracer.dropped_spans)
    tracer.clear()
    return before, tracer.recorded_spans, tracer.dropped_spans


def seq_summary(m, clock):
    tracer = m.tracing.Tracer(enabled=True)
    for i in range(100):
        s = tracer.event("op")
        s.end_s = s.start_s + (i + 1) / 1000.0
    solo = tracer.event("solo")
    solo.end_s = solo.start_s + 0.042
    with pytest.raises(ValueError) as err:
        m.tracing._percentile([], 0.5)
    return (
        tracer.summary(), m.tracing.Tracer(enabled=True).summary(),
        m.tracing.Tracer(enabled=False).summary(), str(err.value),
    )


def seq_traceparent(m, clock):
    t = m.tracing
    good = t.format_traceparent("ab" * 16, "cd" * 8)
    headers = [
        good, good.upper(), good + "-extra", f"01-{'ab' * 16}-{'cd' * 8}-00", None, "",
        "00-short-id-01", f"00-{'0' * 32}-{'cd' * 8}-01", f"00-{'ab' * 16}-{'0' * 16}-01",
        f"ff-{'ab' * 16}-{'cd' * 8}-01", "zz-not-hex-at-all", f" {good} ",
    ]
    return good, [t.parse_traceparent(h) for h in headers], t.TRACEPARENT_HEADER


def seq_continue_trace(m, clock):
    tracer = m.tracing.Tracer(enabled=True)
    remote = m.tracing.format_traceparent("12" * 16, "34" * 8)
    with tracer.continue_trace(remote):
        inside = tracer.current_traceparent()
        with tracer.span("server.op"):
            pass
    with tracer.continue_trace("totally-not-a-traceparent"):
        with tracer.span("op"):
            pass
    with tracer.span("later"):
        pass
    spans = {s.name: s for s in tracer.spans()}
    return (
        inside, spans["server.op"].trace_id, spans["server.op"].parent_id,
        spans["op"].parent_id, spans["later"].trace_id == "12" * 16,
        tracer.current_traceparent(), m.tracing.Tracer(enabled=False).current_traceparent(),
    )


def seq_disabled(m, clock):
    tracer = m.tracing.Tracer(enabled=False)
    with tracer.span("op", a=1) as s:
        ev = tracer.event("e")
        with tracer.continue_trace(m.tracing.format_traceparent("12" * 16, "34" * 8)):
            tp = tracer.current_traceparent()
    return s, ev, tp, tracer.spans(), tracer.recorded_spans, m.tracing.NOOP_TRACER.enabled


SEQUENCES = [seq_nested, seq_ring, seq_summary, seq_traceparent, seq_continue_trace, seq_disabled]


@pytest.mark.parametrize("seq", SEQUENCES, ids=lambda f: f.__name__[4:])
def test_sequence_equals_jax(seq, clock):
    jax_out = seq(JAX, clock)
    clock.at = 1000.0
    assert seq(PORT, clock) == jax_out


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_each_package_continues_the_others_traceparent(direction):
    a, b = (jax_tracing, port_tracing) if direction == "jax_to_port" else (port_tracing, jax_tracing)
    caller, callee = a.Tracer(enabled=True), b.Tracer(enabled=True)
    with caller.span("client.fetch") as client:
        header = caller.current_traceparent()
    with callee.continue_trace(header):
        with callee.span("rsm.fetch_log_segment"):
            with callee.span("storage.fetch_chunks"):
                pass
    served = {s.name: s for s in callee.spans()}
    assert served["rsm.fetch_log_segment"].trace_id == client.trace_id
    assert served["rsm.fetch_log_segment"].parent_id == client.span_id
    assert served["storage.fetch_chunks"].parent_id == served["rsm.fetch_log_segment"].span_id
    assert b.parse_traceparent(header) == a.parse_traceparent(header) == (client.trace_id, client.span_id)


def test_chrome_trace_file_has_jax_shape(tmp_path, clock):
    docs = []
    for name, m in (("jax", JAX), ("port", PORT)):
        clock.at = 1000.0
        tracer = m.tracing.Tracer(enabled=True)
        with tracer.span("fetch", topic="t"):
            clock.at += 0.001
            tracer.event("breaker.trip")
        path = tracer.write_chrome_trace(tmp_path / name / "artifacts" / "trace.json")
        doc = json.loads(path.read_text())
        ids: dict = {}
        for e in doc["traceEvents"]:
            for k in ("trace_id", "span_id", "parent_id"):
                v = e["args"][k]
                e["args"][k] = None if v is None else ids.setdefault(v, len(ids))
        docs.append(doc)
    assert docs[1] == docs[0]
    assert {e["ph"] for e in docs[1]["traceEvents"]} == {"X", "i"}


def test_spans_and_events_appear_in_a_cpu_torch_profiler_trace():
    """`use_jax_profiler` (the `tracing.jax.profiler.enabled` key) opens a
    torch.profiler range per span and a zero-length one per event."""
    tracer = port_tracing.Tracer(enabled=True, use_jax_profiler=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer.span("rsm.fetch_log_segment", topic="t"):
            with tracer.span("chunk.detransform"):
                torch.ones(64).sum()
            tracer.event("hot.hit")
    names = {e.name for e in prof.events()}
    assert {"rsm.fetch_log_segment", "chunk.detransform", "hot.hit"} <= names
    outer = next(e for e in prof.events() if e.name == "rsm.fetch_log_segment")
    inner = next(e for e in prof.events() if e.name == "chunk.detransform")
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert [s.name for s in tracer.spans()] == ["chunk.detransform", "hot.hit", "rsm.fetch_log_segment"]


def test_profiler_ranges_only_when_asked(monkeypatch):
    """Without `use_jax_profiler` a span opens no torch.profiler range."""

    def refuse(name):
        raise AssertionError(f"record_function opened for {name}")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    tracer = port_tracing.Tracer(enabled=True)
    with tracer.span("op"):
        tracer.event("e")
    assert tracer.recorded_spans == 2


class _Poison:
    def __enter__(self):
        raise AssertionError("disabled tracer took its lock")

    def __exit__(self, *exc):  # pragma: no cover - never entered
        return False


@pytest.mark.parametrize("m", [JAX, PORT], ids=["jax", "port"])
def test_disabled_tracer_does_no_work(m, monkeypatch):
    """A disabled tracer never reaches its ring's lock, opens no profiler
    range even with `use_jax_profiler`, and records nothing."""
    tracer = m.tracing.Tracer(enabled=False, use_jax_profiler=True)
    tracer._lock = _Poison()
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: _Poison())
    for _ in range(3):
        with tracer.span("op", a=1) as s:
            assert s is None
            assert tracer.event("e") is None
            with tracer.continue_trace(m.tracing.format_traceparent("12" * 16, "34" * 8)):
                assert tracer.current_traceparent() is None
    assert tracer.dropped_spans == 0


# ------------------------------------------------------- the port's own
def _busy(seconds: float) -> None:
    end = time.perf_counter() + seconds
    n = 0
    while time.perf_counter() < end:
        n += 1


@pytest.mark.parametrize("work", ["busy", "sleep"])
def test_thread_cpu_records_the_threads_cpu_time(work):
    tracer = port_tracing.Tracer(enabled=True)
    with tracer.span("op", thread_cpu=True, a=1) as span:
        _busy(0.05) if work == "busy" else time.sleep(0.05)
    cpu = span.attributes["cpu_s"]
    assert span.attributes["a"] == 1
    if work == "busy":
        assert 0.5 * span.duration_s < cpu <= span.duration_s + 0.01
    else:
        assert 0.0 <= cpu < 0.2 * span.duration_s


def test_plain_spans_and_events_record_no_cpu_time():
    tracer = port_tracing.Tracer(enabled=True)
    with tracer.span("op", a=1):
        tracer.event("e")
    assert [s.attributes for s in tracer.spans()] == [{}, {"a": 1}]


def test_disabled_tracer_reads_no_clock_with_thread_cpu(monkeypatch):
    """`thread_cpu` on a disabled tracer reaches neither the ring's lock nor
    the thread clock nor the native thread id."""

    def refuse(*args):
        raise AssertionError("a disabled tracer read a clock")

    tracer = port_tracing.Tracer(enabled=False)
    tracer._lock = _Poison()
    monkeypatch.setattr(time, "thread_time", refuse)
    monkeypatch.setattr(threading, "get_native_id", refuse)
    for _ in range(3):
        with tracer.span("op", thread_cpu=True, a=1) as s:
            assert s is None
            assert tracer.current_span() is None and tracer.record("r", 0.0, 1.0) is None
    assert tracer.dropped_spans == 0


def test_a_recorded_span_keeps_its_times_and_joins_the_given_parent():
    """`record` keeps the start and end it was given; from another thread
    it becomes a child of the `parent` it was handed, else of the recording
    thread's own context."""
    tracer = port_tracing.Tracer(enabled=True)
    with tracer.span("copy") as copy:
        assert tracer.current_span() is copy
        with tracer.span("wait"):
            inside = tracer.record("here", 1.0, 2.5, a=1)
            under_copy = tracer.record("window", 0.5, 3.0, parent=copy)
    assert tracer.current_span() is None
    got = {}

    def worker():
        got["joined"] = tracer.record("window", 3.0, 4.0, parent=copy, b=2)
        got["alone"] = tracer.record("alone", 5.0, 6.0)

    thread = threading.Thread(target=worker)
    thread.start()
    thread.join(timeout=10)
    assert (inside.start_s, inside.end_s, inside.attributes, inside.depth) == (1.0, 2.5, {"a": 1}, 2)
    assert inside.trace_id == copy.trace_id and inside.parent_id != copy.span_id
    for s in (under_copy, got["joined"]):
        assert (s.trace_id, s.parent_id, s.depth) == (copy.trace_id, copy.span_id, 1)
    joined, alone = got["joined"], got["alone"]
    assert joined.duration_s == 1.0 and joined.attributes == {"b": 2}
    assert joined.thread_id == thread.ident
    assert alone.trace_id != copy.trace_id and alone.parent_id is None and alone.depth == 0
    assert [s.name for s in tracer.spans()] == ["here", "window", "wait", "copy", "window", "alone"]


def test_export_is_on_the_wall_clock_with_native_thread_ids():
    tracer = port_tracing.Tracer(enabled=True)
    seen = {}

    def work():
        seen["native"] = threading.get_native_id()
        with tracer.span("worker.op"):
            pass

    before = time.time() * 1e6
    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    after = time.time() * 1e6
    (event,) = tracer.chrome_trace_events()
    assert event["tid"] == seen["native"] != threading.get_native_id()
    assert before - 1e3 <= event["ts"] <= after + 1e3


def test_tracer_and_timeline_share_one_wall_axis():
    """A span and a timeline launch at the same monotonic instants export
    the same `ts` (both epochs are wall-clock pins of that clock)."""
    from tieredstorage_tpu_torch.metrics.timeline import TimelineRecorder

    timeline = TimelineRecorder(enabled=True)
    tracer = port_tracing.Tracer(enabled=True)
    with tracer.span("op") as span:
        pass
    epoch = timeline.epoch()
    assert timeline.ts_us(span.start_s) == port_tracing.wall_ts_us(
        span.start_s, epoch["wall_s"], epoch["mono_s"])
    (event,) = tracer.chrome_trace_events()
    assert abs(event["ts"] - timeline.ts_us(span.start_s)) < 2e3


def _profiled(tmp_path, body) -> dict:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        body()
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())


def test_merged_profile_puts_a_span_around_its_profiler_range(tmp_path):
    """A main-thread span forwarded into the profiler lands, after the
    merge, around its own `record_function` range: within 0.5 ms at each
    edge and on the same track."""
    tracer = port_tracing.Tracer(enabled=True, use_jax_profiler=True)

    def body():
        with tracer.span("rsm.fetch_log_segment"):
            torch.ones(1024).sum()
            time.sleep(0.005)

    profile = _profiled(tmp_path, body)
    merged = port_tracing.merge_profiler_trace(tmp_path / "profile.json", tracer)
    assert merged["baseTimeNanoseconds"] == profile["baseTimeNanoseconds"]
    assert len(merged["traceEvents"]) == len(profile["traceEvents"]) + 1
    (rng,) = [e for e in merged["traceEvents"]
              if e.get("cat") == "user_annotation" and e["name"] == "rsm.fetch_log_segment"]
    (span,) = [e for e in merged["traceEvents"] if e.get("cat") == "tieredstorage"]
    assert span["tid"] == rng["tid"] and span["pid"] == rng["pid"]
    assert abs(span["ts"] - rng["ts"]) <= 500.0
    assert abs((span["ts"] + span["dur"]) - (rng["ts"] + rng["dur"])) <= 500.0


def test_merged_profile_holds_spans_of_threads_the_profiler_never_saw(tmp_path):
    """A thread started before the profiler session: its forwarded range is
    missing from the profile, and the merge puts its span on its own track,
    between the main thread's ranges before and after it."""
    tracer = port_tracing.Tracer(enabled=True, use_jax_profiler=True)
    go, done = threading.Event(), threading.Event()
    native = {}

    def worker():
        go.wait(timeout=30)
        native["tid"] = threading.get_native_id()
        with tracer.span("rsm.copy_log_segment_data", thread_cpu=True):
            time.sleep(0.003)
        done.set()

    t = threading.Thread(target=worker)
    t.start()

    def body():
        with torch.profiler.record_function("main.before"):
            time.sleep(0.002)
        go.set()
        assert done.wait(timeout=30)
        with torch.profiler.record_function("main.after"):
            time.sleep(0.002)

    try:
        profile = _profiled(tmp_path, body)
    finally:
        go.set()
        t.join(timeout=30)
    assert not t.is_alive()
    assert "rsm.copy_log_segment_data" not in {e.get("name") for e in profile["traceEvents"]}
    merged = port_tracing.merge_profiler_trace(profile, tracer)
    ranges = {e["name"]: e for e in merged["traceEvents"] if e.get("cat") == "user_annotation"}
    (span,) = [e for e in merged["traceEvents"] if e.get("cat") == "tieredstorage"]
    assert span["tid"] == native["tid"]
    assert float(span["args"]["cpu_s"]) >= 0.0
    before, after = ranges["main.before"], ranges["main.after"]
    assert before["ts"] + before["dur"] <= span["ts"]
    assert span["ts"] + span["dur"] <= after["ts"]


def test_merge_rebases_spans_and_timeline_events_to_the_profile_base():
    from tieredstorage_tpu_torch.metrics.timeline import TimelineRecorder

    tracer = port_tracing.Tracer(enabled=True)
    timeline = TimelineRecorder(enabled=True)
    with tracer.span("op") as span:
        pass
    timeline.record_flush(
        batch_id=1, work_class="latency", decrypt=True, bucket_bytes=1024, rows=2,
        n_bytes=2048, occupancy=2, queued_age_ms=0.5, begin_s=span.start_s, end_s=span.end_s)
    exported = timeline.export_chrome_trace()["traceEvents"]
    base_ns = 1_700_000_000 * 10**9
    profile = {"baseTimeNanoseconds": base_ns, "traceEvents": [{"name": "k", "ph": "X"}]}
    merged = port_tracing.merge_profiler_trace(profile, tracer, exported)
    assert profile["traceEvents"] == [{"name": "k", "ph": "X"}]  # the input is left as it was
    events = merged["traceEvents"]
    assert events[0] == {"name": "k", "ph": "X"}
    (ours,) = [e for e in events if e.get("cat") == "tieredstorage"]
    assert ours["ts"] == pytest.approx(tracer.chrome_trace_events()[0]["ts"] - base_ns / 1e3)
    slices = [e for e in events if e.get("cat") == "device-scheduler"]
    assert [e["ts"] for e in slices] == pytest.approx(
        [e["ts"] - base_ns / 1e3 for e in exported if e.get("cat") == "device-scheduler"])
    assert abs(slices[0]["ts"] - ours["ts"]) < 2e3


def test_merge_moves_cuda_calls_onto_the_native_track_of_a_traced_thread():
    """Kineto writes a CUDA runtime call's `tid` as CUPTI's 32-bit
    `pthread_self()`, a signed number written without its sign: the merge
    moves the calls of a thread the tracer saw onto that thread's native
    track, and leaves every other event as is."""
    tracer = port_tracing.Tracer(enabled=True)
    with tracer.span("transform.launch"):
        pass
    low = threading.get_ident() & 0xFFFFFFFF
    cupti_tid = low if low < 1 << 31 else (1 << 32) - low
    other = {"name": "cudaMemcpyAsync", "cat": "cuda_runtime", "ph": "X", "ts": 1.0,
             "dur": 1.0, "pid": 1, "tid": cupti_tid + 1}
    call = {**other, "name": "cudaLaunchKernel", "tid": cupti_tid}
    op = {**other, "name": "aten::copy_", "cat": "cpu_op", "tid": cupti_tid}
    merged = port_tracing.merge_profiler_trace(
        {"baseTimeNanoseconds": 0, "traceEvents": [call, other, op]}, tracer)
    moved, kept, cpu, span = merged["traceEvents"]
    assert moved == {**call, "tid": threading.get_native_id()} and span["tid"] == moved["tid"]
    assert (kept, cpu) == (other, op)


@pytest.mark.parametrize("ident,written", [(0x7F12_623FE6C0, 0x623FE6C0),
                                           (0x7F12_C3FFF6C0, 0x3C000940)],
                         ids=["low_half_positive", "low_half_negative"])
def test_merge_finds_a_thread_whose_32_bit_id_kineto_wrote_without_its_sign(ident, written):
    """Kineto writes CUPTI's 32-bit thread id as a signed number without its
    sign, as a card run showed (a copier whose `pthread_self()` ended in
    0xC3FFF6C0 had its CUDA calls under tid 0x3C000940): the merge finds
    the thread's calls either way."""
    tracer = port_tracing.Tracer(enabled=True)
    with tracer.span("transform.launch") as traced:
        pass
    traced.thread_id, traced.native_thread_id = ident, 4242
    call = {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ph": "X", "ts": 1.0,
            "dur": 1.0, "pid": 1, "tid": written}
    stray = {**call, "tid": ident & 0xFFFFFFFF} if written != ident & 0xFFFFFFFF else None
    events = [call] + ([stray] if stray else [])
    merged = port_tracing.merge_profiler_trace({"baseTimeNanoseconds": 0, "traceEvents": events},
                                               tracer)
    assert merged["traceEvents"][0] == {**call, "tid": 4242}
    if stray:
        assert merged["traceEvents"][1] == stray
