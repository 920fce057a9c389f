"""The port's tracer against the JAX package's.

Span and trace ids are random, so trees compare after renumbering: each
span by its position in the ring, each trace by its first appearance.
Under one fake `time.perf_counter`/`time.monotonic` the durations, the
summaries and the Chrome export (timestamps included) are equal too. The
port forwards spans into `torch.profiler` where the JAX package forwards
into `jax.profiler`.
"""

from __future__ import annotations

import json
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
