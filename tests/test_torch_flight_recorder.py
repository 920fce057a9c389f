"""The port's flight recorder against the JAX package's.

One sequence of requests, notes, stages, pool hops and failures runs
through both packages' recorders under one fake clock (the recorder's
time source, and `time.perf_counter`/`time.monotonic` for the stage
offsets and deadline budgets); the retained rings, `find`, `summary`,
`dump` and every record's `to_dict` must be equal.
"""

from __future__ import annotations

import threading
import time
import types

import numpy as np
import pytest

import tieredstorage_tpu.utils.deadline as jax_deadline
import tieredstorage_tpu.utils.flightrecorder as jax_flight
import tieredstorage_tpu_torch.utils.deadline as port_deadline
import tieredstorage_tpu_torch.utils.flightrecorder as port_flight

JAX = types.SimpleNamespace(flight=jax_flight, deadline=jax_deadline)
PORT = types.SimpleNamespace(flight=port_flight, deadline=port_deadline)


class FakeClock:
    def __init__(self, at: float = 100.0) -> None:
        self.at = at

    def __call__(self) -> float:
        return self.at

    def advance(self, s: float) -> None:
        self.at += s


@pytest.fixture
def clock(monkeypatch):
    fake = FakeClock()
    monkeypatch.setattr(time, "perf_counter", fake)
    monkeypatch.setattr(time, "monotonic", fake)
    return fake


def _dicts(records):
    return [r.to_dict() for r in records]


def _state(recorder):
    return {
        "slowest": _dicts(recorder.slowest()),
        "failures": _dicts(recorder.failures()),
        "seen": recorder.requests_seen,
        "failed": recorder.requests_failed,
        "occupancy": recorder.ring_occupancy,
        "summary": recorder.summary(),
    }


# ----------------------------------------------------------------- sequences
def seq_lifecycle(m, clock):
    f = m.flight
    recorder = f.FlightRecorder(enabled=True, time_source=clock)
    with recorder.request("op", trace_id="t1") as record:
        assert f.current_record() is record and f.current_trace_id() == "t1"
        f.note("tier.backend", 3)
        f.note("tier.backend", 2)
        f.note("hedge.won")
        clock.advance(0.125)
        f.stage("backend.fetched:seg")
        clock.advance(0.125)
    assert f.current_record() is None and f.current_trace_id() is None
    return _state(recorder), record.tier_breakdown(), record.duration_ms


def seq_error(m, clock):
    f = m.flight
    recorder = f.FlightRecorder(enabled=True, time_source=clock)
    with pytest.raises(ValueError, match="boom"):
        with recorder.request("op"):
            clock.advance(0.01)
            raise ValueError("boom")
    return _state(recorder), recorder.find("") is None


def seq_deadline(m, clock):
    f, d = m.flight, m.deadline
    recorder = f.FlightRecorder(enabled=True, time_source=clock)
    with d.deadline_scope(d.Deadline.after(10.0)):
        with recorder.request("op"):
            clock.advance(2.5)
            f.stage("mid")
            clock.advance(1.0)
    with recorder.request("no-deadline"):
        f.stage("mid")
    return _state(recorder)


def seq_reentrant(m, clock):
    f = m.flight
    recorder = f.FlightRecorder(enabled=True, time_source=clock)
    with recorder.request("outer", trace_id="t-out") as outer:
        with recorder.request("inner", trace_id="t-in") as inner:
            assert inner is outer
            f.note("tier.peer", 1)
    return _state(recorder)


def seq_gcm_accounting(m, clock):
    f = m.flight
    recorder = f.FlightRecorder(enabled=True, time_source=clock)
    with recorder.request("fetch", trace_id="t"):
        for dispatches in (1, 1, 3):
            f.note("gcm.windows")
            f.note("gcm.dispatches", dispatches)
            f.note("gcm.hbm_roundtrips", 2)
        f.note("gcm.batched_windows", 4)
        f.note("gcm.batch_occupancy", 11)
        f.stage("gcm.class:latency")
        f.stage("gcm.batch:7")
        clock.advance(0.003)
    return _state(recorder)


def seq_threads_and_bound(m, clock):
    f = m.flight
    recorder = f.FlightRecorder(enabled=True, time_source=clock)
    seen_on_worker: list = []
    with recorder.request("op", trace_id="hop") as record:
        captured = f.current_record()

        def plain():
            seen_on_worker.append(f.current_record())

        def bound():
            with f.bound(captured):
                f.note("tier.backend", 4)
                seen_on_worker.append(f.current_trace_id())
            seen_on_worker.append(f.current_record())

        for target in (plain, bound):
            t = threading.Thread(target=target)
            t.start()
            t.join()
    with f.bound(None):
        seen_on_worker.append(f.current_record())
    return record.to_dict(), seen_on_worker


def seq_retention(m, clock):
    """Seeded durations and failures through a ring of 4: the slowest four
    completed, the four most recent failures, `find`/`find_all`, `dump`
    with each filter, then `reset`."""
    f = m.flight
    recorder = f.FlightRecorder(enabled=True, ring_size=4, time_source=clock)
    rng = np.random.default_rng(11)
    for i in range(40):
        fail = bool(rng.random() < 0.3)
        try:
            with recorder.request(f"op{i % 5}", trace_id=f"t{i % 9}"):
                f.note("tier.backend", int(rng.integers(1, 5)))
                if rng.random() < 0.5:
                    f.note("tier.chunk_cache", 1)
                clock.advance(float(rng.uniform(0.0, 0.5)))
                if fail:
                    raise RuntimeError(f"fail {i}")
        except RuntimeError:
            pass
    out = {
        "state": _state(recorder),
        "find": [(t, recorder.find(t) and recorder.find(t).to_dict()) for t in ("t0", "t4", "nope", "")],
        "find_all": [_dicts(recorder.find_all(f"t{k}")) for k in range(9)],
        "dumps": [
            recorder.dump(),
            recorder.dump(limit=2),
            recorder.dump(trace="t3"),
            recorder.dump(slowest=1),
        ],
    }
    recorder.reset()
    out["after_reset"] = _state(recorder)
    return out


def seq_ring_size_one(m, clock):
    f = m.flight
    recorder = f.FlightRecorder(enabled=True, ring_size=1, time_source=clock)
    for name in ("first", "tie"):
        with recorder.request(name):
            clock.advance(0.1)
    with pytest.raises(ValueError) as err:
        f.FlightRecorder(ring_size=0)
    return _state(recorder), str(err.value)


def seq_disabled(m, clock):
    f = m.flight
    recorder = f.FlightRecorder(enabled=False, time_source=clock)
    with recorder.request("op", trace_id="t") as record:
        f.note("tier.backend")
        f.stage("s")
        inside = (record, f.current_record(), f.current_trace_id())
    return (
        inside, _state(recorder), f.NOOP_RECORDER.enabled,
        recorder.dump(), f.current_record(),
    )


SEQUENCES = [
    seq_lifecycle, seq_error, seq_deadline, seq_reentrant, seq_gcm_accounting,
    seq_threads_and_bound, seq_retention, seq_ring_size_one, seq_disabled,
]


@pytest.mark.parametrize("seq", SEQUENCES, ids=lambda f: f.__name__[4:])
def test_sequence_equals_jax(seq, clock):
    start = clock.at
    jax_out = seq(JAX, clock)
    clock.at = start
    port_out = seq(PORT, clock)
    assert port_out == jax_out


def test_disabled_recorder_never_takes_its_lock():
    """Zero-work contract: a disabled recorder's request never reaches the
    ring's lock (a poisoned lock would raise)."""

    class Poison:
        def __enter__(self):
            raise AssertionError("disabled recorder took its lock")

        def __exit__(self, *exc):  # pragma: no cover - never entered
            return False

    recorder = port_flight.FlightRecorder(enabled=False)
    recorder._lock = Poison()
    for _ in range(3):
        with recorder.request("op") as record:
            port_flight.note("tier.backend")
            port_flight.stage("s")
    assert record is None and recorder.requests_seen == 0


def test_record_fields_equal_jax():
    import dataclasses

    fields = [(f.name, str(f.type)) for f in dataclasses.fields(port_flight.RequestRecord)]
    assert fields == [(f.name, str(f.type)) for f in dataclasses.fields(jax_flight.RequestRecord)]
