"""The port's device-scheduler timeline against the JAX package's.

One `record_flush` / `record_expired` sequence (seeded with numpy, the
monotonic and wall clocks injected) gives equal `status()`, equal eviction
accounting and equal Chrome events (epoch and pid pinned); the schema
checker accepts and refuses the same lists with the same messages. Then a
real merged flush of each package's batcher on the CPU feeds its timeline,
with the waiters' trace ids captured at enqueue.
"""

from __future__ import annotations

import threading
import types

import numpy as np
import pytest
from cryptography.hazmat.primitives.ciphers.aead import AESGCM

import tieredstorage_tpu.metrics.timeline as jax_timeline
import tieredstorage_tpu.utils.flightrecorder as jax_flight
import tieredstorage_tpu_torch.metrics.timeline as port_timeline
import tieredstorage_tpu_torch.utils.flightrecorder as port_flight

JAX = types.SimpleNamespace(timeline=jax_timeline, flight=jax_flight)
PORT = types.SimpleNamespace(timeline=port_timeline, flight=port_flight)

EPOCH = {"wall_s": 1000.0, "mono_s": 50.0}
CLASSES = ("latency", "throughput", "background")


class Clock:
    def __init__(self, t: float = 50.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


def _recorder(m, clock, ring_size=8, enabled=True):
    return m.timeline.TimelineRecorder(
        enabled=enabled, ring_size=ring_size, time_source=clock,
        wall_clock=lambda: 1000.0,
    )


def _feed(recorder, clock, n=30, seed=13):
    rng = np.random.default_rng(seed)
    for i in range(n):
        clock.t += float(rng.uniform(0.0, 0.02))
        if rng.random() < 0.2:
            recorder.record_expired(CLASSES[i % 3], int(rng.integers(1, 4)),
                                    None if i % 2 else clock.t)
            continue
        occ = int(rng.integers(1, 9))
        begin = clock.t
        clock.t += float(rng.uniform(0.0005, 0.01))
        recorder.record_flush(
            batch_id=i + 1, work_class=CLASSES[int(rng.integers(3))],
            decrypt=bool(rng.random() < 0.7), bucket_bytes=int(1 << int(rng.integers(10, 23))),
            rows=int(rng.integers(occ, 2 * occ + 1)), n_bytes=int(rng.integers(1, 1 << 24)),
            occupancy=occ, queued_age_ms=float(rng.uniform(0, 30)),
            begin_s=begin, end_s=clock.t,
            queue_depths={c: int(rng.integers(0, 5)) for c in CLASSES},
            trace_ids=[f"t{i}-{k}" if k % 3 else None for k in range(occ)],
        )


def _records(n=6, seed=14):
    """Flight records in `to_dict` shape, some riding launches of the feed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        stages = [["backend.fetched:seg", 0.5, None], ["gcm.class:latency", 0.9, 12.5]]
        for b in rng.integers(1, 40, int(rng.integers(0, 3))):
            stages.append([f"gcm.batch:{int(b)}", float(rng.uniform(1, 5)), None])
        stages.append(["gcm.batch:not-a-number", 5.5, None])
        record = {
            "name": "rsm.fetch_log_segment", "trace_id": f"t{i}", "error": None,
            "duration_ms": float(rng.uniform(1, 40)), "tiers": {"backend": 1.0},
            "stages": stages,
        }
        if i != 2:  # one record without a start: skipped by the export
            record["start_s"] = 50.0 + float(rng.uniform(0, 0.5))
        out.append(record)
    return out


# ----------------------------------------------------------------- sequences
def seq_status_and_eviction(m):
    clock = Clock()
    recorder = _recorder(m, clock)
    _feed(recorder, clock)
    return (
        recorder.status(), recorder.events(), recorder.ring_occupancy,
        recorder.epoch(), recorder.ts_us(51.25),
        (recorder.events_recorded, recorder.events_evicted,
         recorder.launches_recorded, recorder.expired_recorded),
    )


def seq_chrome_events(m):
    clock = Clock()
    recorder = _recorder(m, clock, ring_size=64)
    _feed(recorder, clock)
    events, records = recorder.events(), _records()
    return [
        m.timeline.chrome_trace_events(events, records, pid=7, epoch=EPOCH),
        m.timeline.chrome_trace_events(events, records, pid=7, epoch=EPOCH, instance="a"),
        m.timeline.launch_chrome_events(events, pid=7, epoch=EPOCH),
        m.timeline.request_chrome_events(records, pid=7, epoch=EPOCH, known_batches=None),
        m.timeline.request_chrome_events(records, pid=7, epoch=EPOCH, known_batches={3, 5}),
        m.timeline.flow_cat(), m.timeline.flow_cat("b"),
        [m.timeline.batch_ids_of(r) for r in records], m.timeline.batch_ids_of({}),
    ]


def seq_export_and_validate(m):
    clock = Clock()
    recorder = _recorder(m, clock, ring_size=16)
    _feed(recorder, clock)
    doc = recorder.export_chrome_trace(_records())
    for e in doc["traceEvents"]:
        e["pid"] = 0
    return doc, m.timeline.validate_chrome_events(doc["traceEvents"])


BAD_EVENT_LISTS = [
    [{"ph": "X", "ts": 1.0, "pid": 1, "tid": 1}],  # no name
    [{"name": "a", "ph": "Q", "ts": 1.0, "pid": 1, "tid": 1}],
    [{"name": "a", "ph": "X", "ts": 1.0, "pid": 1, "tid": 1}],  # no dur
    [{"name": "a", "ph": "s", "ts": 1.0, "pid": 1, "tid": 1}],  # flow without id
    [{"name": "a", "ph": "i", "ts": 2.0, "pid": 1, "tid": 1},
     {"name": "b", "ph": "i", "ts": 1.0, "pid": 1, "tid": 1}],  # not monotonic
    [{"name": "m", "ph": "M", "ts": 9.0, "pid": 1, "tid": 0},
     {"name": "a", "ph": "i", "ts": 1.0, "pid": 1, "tid": 0},
     {"name": "b", "ph": "f", "id": 3, "ts": 1.0, "pid": 2, "tid": 0}],  # valid
]


def seq_validator_messages(m):
    out = []
    for events in BAD_EVENT_LISTS:
        try:
            out.append(("ok", m.timeline.validate_chrome_events(events)))
        except ValueError as e:
            out.append(("error", str(e)))
    return out


def seq_ctor_and_noop(m):
    with pytest.raises(ValueError) as err:
        m.timeline.TimelineRecorder(ring_size=0)
    noop = m.timeline.NOOP_TIMELINE
    return str(err.value), noop.enabled, noop.ring_size, noop.status()["events"]


SEQUENCES = [seq_status_and_eviction, seq_chrome_events, seq_export_and_validate,
             seq_validator_messages, seq_ctor_and_noop]


@pytest.mark.parametrize("seq", SEQUENCES, ids=lambda f: f.__name__[4:])
def test_sequence_equals_jax(seq):
    assert seq(PORT) == seq(JAX)


class _PoisonLock:
    def __enter__(self):
        raise AssertionError("disabled timeline acquired its lock")

    def __exit__(self, *exc):  # pragma: no cover - never entered
        return False


def test_disabled_timeline_is_zero_work():
    clock = Clock()
    recorder = _recorder(PORT, clock, enabled=False)
    recorder._lock = _PoisonLock()
    _feed(recorder, clock, n=10)
    assert (recorder.events_recorded, recorder.launches_recorded) == (0, 0)


# ------------------------------------------------- a real merged flush each
KEY, AAD = bytes(range(32)), bytes(range(32, 64))


def _wire(n=3, size=700):
    rng = np.random.default_rng(15)
    chunks = [rng.bytes(size + 10 * i) for i in range(n)]
    ivs = [(i + 1).to_bytes(4, "big") * 3 for i in range(n)]
    return chunks, [iv + AESGCM(KEY).encrypt(iv, c, AAD) for iv, c in zip(ivs, chunks)]


def _merged_flush(batcher_mod, backend, dk, flight_mod, timeline_mod):
    """Park the fast path, submit one window per thread under a flight
    record with its own trace id, flush once; returns (results, timeline
    events, flight records, batcher)."""
    chunks, wire = _wire()
    clock = Clock(200.0)
    b = batcher_mod.WindowBatcher(backend, wait_ms=50, max_windows=8, time_source=clock)
    timeline = timeline_mod.TimelineRecorder(
        enabled=True, time_source=clock, wall_clock=lambda: 1000.0,
    )
    b.timeline = timeline
    recorder = flight_mod.FlightRecorder(enabled=True)
    with b._cond:
        b._inflight += 1
    box: list = [None] * len(wire)

    def submit(i):
        c = wire[i]
        with recorder.request(f"req-{i}", trace_id=f"trace-{i}"):
            box[i] = b.submit(
                dk, [c[12:-16]], [len(c) - 28],
                np.stack([np.frombuffer(c[:12], np.uint8)]), [c[-16:]],
            )

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(len(wire))]
    for t in threads:
        t.start()
    with b._cond:
        assert b._cond.wait_for(
            lambda: sum(len(v) for v in b._buckets.values()) >= len(wire), timeout=30
        )
    assert b.flush_now() == 1
    with b._cond:
        b._inflight -= 1
    for t in threads:
        t.join(timeout=60)
    assert box == [[c] for c in chunks]
    return timeline.events(), b


def test_merged_flush_feeds_the_timeline_like_jax():
    from tieredstorage_tpu.security.aes import DataKeyAndAAD as JaxDK
    from tieredstorage_tpu.transform import batcher as jax_batcher
    from tieredstorage_tpu.transform.tpu import TpuTransformBackend
    from tieredstorage_tpu_torch.security.aes import DataKeyAndAAD
    from tieredstorage_tpu_torch.transform import batcher
    from tieredstorage_tpu_torch.transform.cuda import CudaTransformBackend

    port_backend = CudaTransformBackend()
    port_backend.configure({"device": "cpu"})
    jax_events, _ = _merged_flush(jax_batcher, TpuTransformBackend(), JaxDK(KEY, AAD),
                                  jax_flight, jax_timeline)
    port_events, b = _merged_flush(batcher, port_backend, DataKeyAndAAD(KEY, AAD),
                                   port_flight, port_timeline)

    def comparable(events):
        # Trace ids arrive in submission order, which the threads race on.
        return [{**e, "trace_ids": sorted(e["trace_ids"])} for e in events]

    assert comparable(port_events) == comparable(jax_events)
    [ev] = port_events
    assert ev["trace_ids"] and sorted(ev["trace_ids"]) == ["trace-0", "trace-1", "trace-2"]
    assert ev["occupancy"] == 3 and ev["batch_id"] == b.launches == 1
    port_backend.close()
