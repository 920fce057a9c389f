"""The port's window batcher (transform/batcher.py) on the CPU, against the JAX
package's WindowBatcher on the same seeded inputs.

Coalescing is driven deterministically, as in the JAX suite: the batcher is
not started, the fast path is parked by holding `_inflight`, submitters
queue, and the test thread drains with `flush_now()`. Submitting threads are
awaited on the batcher's own condition (every enqueue notifies it), never by
sleeping; the flush policy runs on a fake clock. Wire chunks come from the
`cryptography` AES-GCM oracle, so no device context is built to make them.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
from cryptography.hazmat.primitives.ciphers.aead import AESGCM

from tieredstorage_tpu.security.aes import DataKeyAndAAD as JaxDataKeyAndAAD
from tieredstorage_tpu.transform import batcher as jax_batcher
from tieredstorage_tpu.transform.tpu import TpuTransformBackend
from tieredstorage_tpu_torch.ops import gcm
from tieredstorage_tpu_torch.security.aes import IV_SIZE, TAG_SIZE, DataKeyAndAAD
from tieredstorage_tpu_torch.storage.core import StorageBackendException
from tieredstorage_tpu_torch.transform import batcher
from tieredstorage_tpu_torch.transform.api import (
    AuthenticationError,
    DetransformOptions,
    TransformOptions,
)
from tieredstorage_tpu_torch.transform.batcher import (
    BatcherStoppedError,
    WindowBatcher,
    bucket_rows,
)
from tieredstorage_tpu_torch.transform.cuda import CudaTransformBackend
from tieredstorage_tpu_torch.transform.scheduler import (
    BACKGROUND,
    DEFAULT_SHARES,
    LATENCY,
    THROUGHPUT,
    work_class_scope,
)
from tieredstorage_tpu_torch.utils.deadline import (
    Deadline,
    DeadlineExceededException,
    deadline_scope,
)

_RNG = np.random.default_rng(2026)
KEY, AAD = _RNG.bytes(32), _RNG.bytes(32)
DK = DataKeyAndAAD(KEY, AAD)
JAX_DK = JaxDataKeyAndAAD(KEY, AAD)
D_OPTS = DetransformOptions(encryption=DK)
#: A synthetic latency-class decrypt bucket key for flush-policy tests.
SYNTH_KEY = (LATENCY, True, b"k", b"a", 1024)


def det_ivs(seed: int, n: int) -> list[bytes]:
    return [(seed * 64 + i + 1).to_bytes(4, "big") * 3 for i in range(n)]


def make_window(seed: int, sizes, key: bytes = KEY, aad: bytes = AAD):
    """(plaintext chunks, wire chunks IV || ct || tag) from the host oracle."""
    rng = np.random.default_rng(seed)
    chunks = [rng.bytes(s) for s in sizes]
    wire = [iv + AESGCM(key).encrypt(iv, c, aad) for iv, c in zip(det_ivs(seed, len(sizes)), chunks)]
    return chunks, wire


def parse_wire(wire):
    """(payloads, sizes, ivs, tags) — what _decrypt_batch hands submit."""
    ivs = np.stack([np.frombuffer(c[:IV_SIZE], np.uint8) for c in wire])
    tags = [c[-TAG_SIZE:] for c in wire]
    sizes = [len(c) - IV_SIZE - TAG_SIZE for c in wire]
    payloads = [c[IV_SIZE:-TAG_SIZE] for c in wire]
    return payloads, sizes, ivs, tags


def cpu_backend(**configs) -> CudaTransformBackend:
    backend = CudaTransformBackend()
    backend.configure({"device": "cpu", **configs})
    return backend


def parked(backend=None, **kw) -> WindowBatcher:
    """A non-started batcher whose fast path is parked: every submit queues."""
    b = WindowBatcher(backend or cpu_backend(), **kw)
    b._inflight += 1
    return b


def queued(b) -> int:
    return sum(len(v) for v in b._buckets.values())


def wait_queued(b, n: int) -> None:
    with b._cond:
        assert b._cond.wait_for(lambda: queued(b) >= n, timeout=30), f"never saw {n} queued"


def submit_in_thread(b, wire, work_class=None, enc=DK):
    """Decrypt submit on a thread (under a work-class scope); returns
    (thread, box) with box = [result, error]."""
    payloads, sizes, ivs, tags = parse_wire(wire)
    box: list = [None, None]

    def run():
        try:
            if work_class is None:
                box[0] = b.submit(enc, payloads, sizes, ivs, tags)
            else:
                with work_class_scope(work_class):
                    box[0] = b.submit(enc, payloads, sizes, ivs, tags)
        except BaseException as exc:  # noqa: BLE001 - asserted by tests
            box[1] = exc

    t = threading.Thread(target=run)
    t.start()
    return t, box


def join_all(jobs):
    for t, _ in jobs:
        t.join(timeout=60)
        assert not t.is_alive()


def entry(wire, now=0.0, deadline_at=None, work_class=LATENCY, mod=batcher):
    payloads, sizes, ivs, tags = parse_wire(wire)
    return mod._PendingWindow(
        payloads=payloads, sizes=sizes, ivs=ivs, tags=tags, n_bytes=sum(sizes),
        enqueued_at=now, deadline_at=deadline_at, work_class=work_class,
    )


# ------------------------------------------------------------------ ladder


def test_bucket_rows_matches_jax_ladder():
    for n in range(1, 300):
        assert bucket_rows(n) == jax_batcher.bucket_rows(n)
    assert [bucket_rows(n) for n in (1, 8, 9, 16, 17, 64, 65)] == [8, 8, 16, 16, 32, 64, 128]
    with pytest.raises(ValueError):
        bucket_rows(0)


@pytest.mark.parametrize("kwargs", [
    {"wait_ms": -1}, {"max_windows": 1}, {"max_bytes": 0},
    {"background_max_age_ms": -1}, {"class_shares": {BACKGROUND: 0}},
    {"class_shares": {"bulk": 2}},
], ids=["wait", "windows", "bytes", "bg-age", "share-zero", "share-class"])
def test_ctor_refuses_out_of_range_knobs(kwargs):
    with pytest.raises(ValueError):
        WindowBatcher(object(), **kwargs)


def test_ctor_boundary_values_are_legal():
    ok = WindowBatcher(object(), wait_ms=0, max_windows=2, max_bytes=1,
                       background_max_age_ms=0, class_shares={BACKGROUND: 3})
    assert (ok.wait_ms, ok.max_windows, ok.max_bytes) == (0.0, 2, 1)
    assert ok.background_max_age_ms == 0.0
    assert ok.class_shares[BACKGROUND] == 3.0
    assert ok.class_shares[LATENCY] == DEFAULT_SHARES[LATENCY]


# ------------------------------------------------------------ flush policy


class _Clocked:
    """Both packages' batchers on one fake clock."""

    def __init__(self, **kw):
        self.clock = [0.0]
        kw.setdefault("wait_ms", 10.0)
        kw.setdefault("max_windows", 4)
        kw.setdefault("max_bytes", 10_000)
        now = lambda: self.clock[0]  # noqa: E731
        self.port = WindowBatcher(object(), time_source=now, **kw)
        self.jax = jax_batcher.WindowBatcher(object(), time_source=now, **kw)

    def due(self, b, now):
        with b._cond:
            return b._due_keys_locked(now)


def test_due_keys_match_jax_on_a_seeded_schedule():
    """A seeded schedule of arrivals (three classes, two data keys, some with
    deadlines), launch samples, takes and a background admission rate: at
    every step both packages decide the same due keys, in the same order,
    with the same wake timeout and the same admission allowance."""
    rng = np.random.default_rng(17)
    c = _Clocked(background_max_age_ms=50.0)
    for b in (c.port, c.jax):
        b.set_class_rate(BACKGROUND, 4096.0)
    classes = (LATENCY, THROUGHPUT, BACKGROUND)
    decisions = 0
    for step in range(80):
        c.clock[0] += float(rng.uniform(0.0, 0.02))
        now = c.clock[0]
        action = int(rng.integers(0, 4))
        if action <= 1:
            cls = classes[int(rng.integers(0, 3))]
            key = (cls, True, b"k%d" % rng.integers(0, 2), b"a", 1024)
            n = int(rng.integers(100, 3000))
            dl = now + float(rng.uniform(0.005, 0.2)) if rng.random() < 0.3 else None
            for b, mod in ((c.port, batcher), (c.jax, jax_batcher)):
                e = mod._PendingWindow(payloads=[], sizes=[n], ivs=None, tags=None,
                                       n_bytes=n, enqueued_at=now, deadline_at=dl,
                                       work_class=cls)
                with b._cond:
                    b._buckets.setdefault(key, []).append(e)
        elif action == 2:
            sample = float(rng.uniform(0.001, 0.03))
            for b in (c.port, c.jax):
                b._launch_s.append(sample)
        got = [c.due(b, now) for b in (c.port, c.jax)]
        assert got[0] == got[1], step
        assert c.port._class_allowance == c.jax._class_allowance
        due = got[0][0]
        decisions += bool(due)
        if action == 3 and due:
            with c.port._cond, c.jax._cond:
                taken = [[e.n_bytes for e in b._take_locked(due[0])] for b in (c.port, c.jax)]
            assert taken[0] == taken[1]
            assert c.port._served_bytes == c.jax._served_bytes
    assert decisions > 10


def test_age_trigger_and_wake_time():
    c = _Clocked()
    _, wire = make_window(2, [512] * 2)
    c.port._buckets[SYNTH_KEY] = [entry(wire, now=0.0)]
    due, timeout = c.due(c.port, 0.004)
    assert due == [] and timeout == pytest.approx(0.006)
    assert c.due(c.port, 0.010) == ([SYNTH_KEY], None)


@pytest.mark.parametrize("kw,sizes,count", [
    ({"max_windows": 3}, [512, 512], 3), ({"max_bytes": 1500}, [900], 2),
], ids=["windows", "bytes"])
def test_cap_triggers_fire_before_age(kw, sizes, count):
    c = _Clocked(**kw)
    _, wire = make_window(3, sizes)
    c.port._buckets[SYNTH_KEY] = [entry(wire) for _ in range(count)]
    assert c.due(c.port, 0.0)[0] == [SYNTH_KEY]


def test_deadline_floor_trigger_uses_launch_p95():
    c = _Clocked(wait_ms=10_000.0)
    _, wire = make_window(5, [512] * 2)
    c.port._launch_s.extend([0.040] * 20)
    c.port._buckets[SYNTH_KEY] = [entry(wire, deadline_at=0.100)]
    # wake = deadline - p95 - floor = 100 - 40 - 5 = 55 ms
    due, timeout = c.due(c.port, 0.050)
    assert due == [] and timeout == pytest.approx(0.005)
    assert c.due(c.port, 0.056)[0] == [SYNTH_KEY]


def test_launch_p95_nearest_rank_and_wait_timeout():
    c = _Clocked()
    b = c.port
    assert b._launch_p95_s() == 0.0
    b._launch_s.extend([0.001, 0.002, 0.003])
    assert b._launch_p95_s() == pytest.approx(0.002)
    b._launch_s[:] = [i / 1000.0 for i in range(1, 21)]
    assert b._launch_p95_s() == pytest.approx(0.019)
    b.WAIT_GRACE_S = 0.5
    c.clock[0] = 2.0
    wire = make_window(8, [256])[1]
    assert b._wait_timeout_s(entry(wire, deadline_at=5.0)) == pytest.approx(3.5)
    assert b._wait_timeout_s(entry(wire, deadline_at=1.0)) == pytest.approx(0.5)
    assert b._wait_timeout_s(entry(wire)) is None


def test_background_watchdog_and_latency_first():
    c = _Clocked(wait_ms=10.0, background_max_age_ms=50.0)
    _, wire = make_window(102, [512])
    bg_key = (BACKGROUND, True, b"k", b"a", 1024)
    c.port._buckets[bg_key] = [entry(wire, work_class=BACKGROUND)]
    due, timeout = c.due(c.port, 0.020)
    assert due == [] and timeout == pytest.approx(0.030)  # past wait_ms, not due
    assert c.due(c.port, 0.050)[0] == [bg_key]  # the watchdog bound is hard
    c.port._buckets[SYNTH_KEY] = [entry(wire, now=0.05)]
    assert c.due(c.port, 1.0)[0] == [SYNTH_KEY, bg_key]


def test_weighted_deficit_orders_throughput_vs_background():
    c = _Clocked()
    _, wire = make_window(103, [512])
    thr = (THROUGHPUT, True, b"k", b"a", 1024)
    bg = (BACKGROUND, True, b"k", b"a", 1024)
    c.port._buckets[thr] = [entry(wire, work_class=THROUGHPUT)]
    c.port._buckets[bg] = [entry(wire, work_class=BACKGROUND)]
    assert c.due(c.port, 1.0)[0] == [thr, bg]
    c.port._served_bytes[THROUGHPUT] = 4000  # deficit 1000
    c.port._served_bytes[BACKGROUND] = 500  # deficit 500
    assert c.due(c.port, 1.0)[0] == [bg, thr]


def test_admission_rate_paces_background():
    c = _Clocked(background_max_age_ms=50.0)
    b = c.port
    b.set_class_rate(BACKGROUND, 1024.0)
    _, wire = make_window(104, [1024])
    bg = (BACKGROUND, True, b"k", b"a", 1024)
    b._buckets[bg] = [entry(wire, work_class=BACKGROUND)]
    b._class_allowance[BACKGROUND] = 0.0
    b._class_refill_at[BACKGROUND] = 0.0
    due, timeout = c.due(b, 0.060)
    assert due == [] and timeout == pytest.approx(0.940)
    assert c.due(b, 1.0)[0] == [bg]
    with b._cond:
        b._take_locked(bg)
    assert b._class_allowance[BACKGROUND] == pytest.approx(0.0)
    assert b._served_bytes[BACKGROUND] == 1024


def test_unrated_class_admits_and_rate_clears():
    c = _Clocked()
    _, wire = make_window(105, [512])
    c.port._buckets[SYNTH_KEY] = [entry(wire)]
    assert c.due(c.port, 0.010)[0] == [SYNTH_KEY]
    c.port.set_class_rate(BACKGROUND, 1.0)
    c.port.set_class_rate(BACKGROUND, None)
    assert BACKGROUND not in c.port._class_rate
    with pytest.raises(ValueError):
        c.port.set_class_rate("bulk", 1.0)


def test_take_locked_caps_windows_and_bytes_fifo():
    _, wire = make_window(6, [512] * 2)
    entries = [entry(wire, now=float(i)) for i in range(5)]
    b = _Clocked(max_windows=2, max_bytes=10_000).port
    b._buckets[SYNTH_KEY] = list(entries)
    assert b._take_locked(SYNTH_KEY) == entries[:2]
    assert b._buckets[SYNTH_KEY] == entries[2:]
    b = _Clocked(max_windows=16, max_bytes=1500).port
    b._buckets[SYNTH_KEY] = list(entries)
    assert b._take_locked(SYNTH_KEY) == entries[:2]  # the second pop crosses max_bytes


# -------------------------------------------------------- merged launches


def _jax_flush(wires, decrypt=True, chunks=None):
    """The JAX package's merged flush of the same windows (queued through
    `_enqueue`, drained by `flush_now`); returns (entries, backend)."""
    backend = TpuTransformBackend()
    b = jax_batcher.WindowBatcher(backend, wait_ms=50, max_windows=8)
    entries = []
    for i, wire in enumerate(wires):
        if decrypt:
            payloads, sizes, ivs, tags = parse_wire(wire)
        else:
            payloads, sizes, tags = chunks[i], [len(p) for p in chunks[i]], None
            ivs = np.stack([np.frombuffer(iv, np.uint8) for iv in wire])
        entries.append(b._enqueue(JAX_DK, payloads, sizes, ivs, tags,
                                  LATENCY if decrypt else THROUGHPUT, decrypt=decrypt))
    assert b.flush_now() == 1
    return entries, backend


def test_merged_flush_demuxes_per_caller_and_matches_jax():
    backend = cpu_backend()
    b = parked(backend, wait_ms=50, max_windows=8)
    windows = [make_window(10 + i, [700, 650 + 10 * i]) for i in range(3)]
    jobs = [submit_in_thread(b, w) for _, w in windows]
    wait_queued(b, 3)
    assert b.flush_now() == 1  # one bucket, one merged launch
    join_all(jobs)
    for (_, box), (plain, _) in zip(jobs, windows):
        assert box == [plain, None]
    assert (b.launches, b.batched_windows, b.windows_submitted, b.fast_path_windows) == (1, 3, 3, 0)
    assert b.mean_occupancy == 3.0
    stats = backend.dispatch_stats
    assert stats.dispatches_per_window == pytest.approx(1 / 3, abs=1e-3)
    assert stats.donated_buffers == 1

    jax_entries, jax_backend = _jax_flush([w for _, w in windows])
    assert [e.result for e in jax_entries] == [box[0] for _, box in jobs]
    js = jax_backend.dispatch_stats
    for field in ("windows", "dispatches", "h2d_transfers", "d2h_fetches", "bytes_in",
                  "rows_per_device"):
        assert getattr(stats, field) == getattr(js, field), field
    assert stats.rows_per_device == 8  # bucket_rows(6)


@pytest.mark.parametrize("uniform", [True, False], ids=["one-size", "mixed-sizes"])
def test_merged_launch_writes_no_more_intermediates_than_its_windows(uniform):
    """Windows of one chunk size merge into the fixed window program, mixed
    sizes into the varlen one; either way the merged launch writes no more
    device intermediates than its windows would one by one, and its bytes
    are the unbatched path's."""
    sizes = [640, 640] if uniform else [640, 600]
    windows = [make_window(140 + i, sizes) for i in range(3)]
    control = cpu_backend()
    assert [control.detransform(w, D_OPTS) for _, w in windows] == [p for p, _ in windows]
    backend = cpu_backend()
    b = parked(backend, wait_ms=50, max_windows=8)
    jobs = [submit_in_thread(b, w) for _, w in windows]
    wait_queued(b, 3)
    assert b.flush_now() == 1
    join_all(jobs)
    assert [box for _, box in jobs] == [[p, None] for p, _ in windows]
    ctx = (gcm.make_context(KEY, AAD, 640) if uniform
           else gcm.make_varlen_context(KEY, AAD, gcm.bucket_max_bytes(640)))
    merged = backend.dispatch_stats.hbm_roundtrips
    assert merged == gcm.planned_hbm_roundtrips(ctx, bucket_rows(6))
    assert merged <= control.dispatch_stats.hbm_roundtrips


def test_per_row_error_isolation_matches_jax():
    plain_ok, wire_ok = make_window(30, [600, 600])
    _, wire_bad = make_window(31, [600, 600])
    bad = list(wire_bad)
    bad[1] = bad[1][:-1] + bytes([bad[1][-1] ^ 1])  # the SECOND row's tag
    b = parked(wait_ms=50, max_windows=8)
    jobs = [submit_in_thread(b, wire_ok), submit_in_thread(b, bad)]
    wait_queued(b, 2)
    assert b.flush_now() == 1  # ONE shared launch
    join_all(jobs)
    assert jobs[0][1] == [plain_ok, None]  # batch-mate unharmed
    err = jobs[1][1][1]
    assert isinstance(err, AuthenticationError) and "[1]" in str(err)
    assert (b.launches, b.batched_windows) == (1, 2)
    jax_entries, _ = _jax_flush([wire_ok, bad])
    assert jax_entries[0].result == plain_ok
    assert str(jax_entries[1].error) == str(err)


def test_bucket_ladder_and_keys_never_mix():
    """1000 -> bucket 1024, 5000 -> bucket 5120, and a second data key at
    the same bucket: three buckets, three launches, occupancy 1."""
    other = (_RNG.bytes(32), _RNG.bytes(32))
    a = make_window(20, [1000, 900])
    c = make_window(21, [5000, 4800])
    d = make_window(22, [800], *other)
    b = parked(wait_ms=50, max_windows=8)
    jobs = [submit_in_thread(b, a[1]), submit_in_thread(b, c[1]),
            submit_in_thread(b, d[1], enc=DataKeyAndAAD(*other))]
    wait_queued(b, 3)
    assert len(b._buckets) == 3
    assert b.flush_now() == 3
    join_all(jobs)
    assert [box[0] for _, box in jobs] == [a[0], c[0], d[0]]
    assert (b.launches, b.mean_occupancy) == (3, 1.0)


@pytest.mark.parametrize("boundary", [False, True], ids=["expired", "exactly-now"])
def test_expired_waiter_fails_fast_without_poisoning(boundary):
    """deadline_at <= now is expired: the late entry never joins the pack,
    its batch-mate launches, and only launched windows count."""
    clock = [3.5]
    backend = cpu_backend()
    b = WindowBatcher(backend, wait_ms=50, time_source=lambda: clock[0])
    plain_ok, wire_ok = make_window(32, [640])
    _, wire_late = make_window(33, [640])
    on_time = entry(wire_ok, deadline_at=4.0)
    late = entry(wire_late, deadline_at=3.5 if boundary else 1.0)
    b._buckets[(LATENCY, True, KEY, AAD, 1024)] = [on_time, late]
    assert b.flush_now() == 1
    assert isinstance(late.error, DeadlineExceededException)
    assert late.result is None and late.batch_id == 0
    assert on_time.error is None and on_time.result == plain_ok
    assert (b.expired_windows, b.batched_windows, b.launches) == (1, 1, 1)
    assert backend.dispatch_stats.windows == 1


def test_wait_grace_outlives_an_expired_deadline():
    """A waiter whose 20 ms budget expires in queue (the fake clock moves
    past it) still outlives it by WAIT_GRACE_S and gets the flusher's
    verdict: DeadlineExceeded, never BatcherStoppedError."""
    clock = [0.0]
    b = parked(wait_ms=50, time_source=lambda: clock[0])
    b.WAIT_GRACE_S = 30.0
    _, wire = make_window(35, [600])
    payloads, sizes, ivs, tags = parse_wire(wire)
    box: list = [None, None]

    def run():
        try:
            with deadline_scope(Deadline.after(0.02)):
                box[0] = b.submit(DK, payloads, sizes, ivs, tags)
        except BaseException as exc:  # noqa: BLE001
            box[1] = exc

    t = threading.Thread(target=run)
    t.start()
    wait_queued(b, 1)
    clock[0] = 10.0
    b.flush_now()
    join_all([(t, box)])
    assert isinstance(box[1], DeadlineExceededException), box
    assert b.expired_windows == 1


def test_launch_failure_wakes_every_waiter_of_the_class_only():
    """A device failure in a background flush reaches background waiters
    alone; the queued latency window still decrypts after."""
    backend = cpu_backend()
    b = parked(backend, wait_ms=50)
    plain_ok, wire_ok = make_window(112, [640])
    _, wire_bg = make_window(113, [640])
    job_lat = submit_in_thread(b, wire_ok)
    jobs_bg = [submit_in_thread(b, wire_bg, BACKGROUND) for _ in range(2)]
    wait_queued(b, 3)
    with b._cond:
        bg_key = next(k for k in b._buckets if k[0] == BACKGROUND)
        bg_entries = b._take_locked(bg_key)
    boom = RuntimeError("device fell over mid-scrub")

    def exploding_stage(host):
        raise boom

    b.set_launch_retry(1, 0.0)
    backend._stage_packed = exploding_stage
    b._flush_group(bg_key, bg_entries)
    del backend._stage_packed
    join_all(jobs_bg)
    assert all(box[1] is boom for _, box in jobs_bg)
    assert job_lat[0].is_alive() and job_lat[1] == [None, None]
    assert b.flush_now() == 1
    join_all([job_lat])
    assert job_lat[1] == [plain_ok, None]
    assert (b.launch_failures, b.launches) == (1, 1)


def test_retry_replays_from_an_untouched_input():
    """The first launch decrypts its staged buffer (the CPU launch works in
    place) and then fails; the retry must start again from the ciphertext,
    not from what the failed attempt left, and return correct bytes."""
    backend = cpu_backend()
    b = parked(backend, wait_ms=50, launch_attempts=2, launch_backoff_s=0.0)
    windows = [make_window(130 + i, [640, 300]) for i in range(2)]
    jobs = [submit_in_thread(b, w) for _, w in windows]
    wait_queued(b, 2)
    real = backend._launch_packed
    calls = [0]

    def launch_then_fail(ctx, host, staged, varlen, *, decrypt):
        calls[0] += 1
        out = real(ctx, host, staged, varlen, decrypt=decrypt)
        if calls[0] == 1:
            raise StorageBackendException("transient device fault after the write")
        return out

    backend._launch_packed = launch_then_fail
    assert b.flush_now() == 1
    join_all(jobs)
    assert [box for _, box in jobs] == [[p, None] for p, _ in windows]
    assert calls[0] == 2
    assert (b.launch_retries, b.launch_failures, b.launches) == (1, 0, 1)


def test_waiters_fail_after_the_retry_cap_then_recover():
    backend = cpu_backend()
    b = parked(backend, wait_ms=50, launch_attempts=2, launch_backoff_s=0.0)
    plain, wire = make_window(132, [640])
    job = submit_in_thread(b, wire)
    wait_queued(b, 1)
    boom = StorageBackendException("device down")

    def dead(host):
        raise boom

    backend._stage_packed = dead
    assert b.flush_now() == 1
    join_all([job])
    assert job[1][1] is boom
    assert (b.launch_retries, b.launch_failures) == (1, 1)
    del backend._stage_packed
    job2 = submit_in_thread(b, wire)
    wait_queued(b, 1)
    assert b.flush_now() == 1
    join_all([job2])
    assert job2[1] == [plain, None]


# -------------------------------------------------------------- fast path


def test_single_waiter_dispatches_inline_and_feeds_the_hot_tier():
    backend = cpu_backend()
    b = backend.enable_batching(wait_ms=200)
    offered = []
    backend.on_decrypt_window = lambda out, sizes, n_bytes, mesh_size: offered.append(
        (list(sizes), mesh_size))
    plain, wire = make_window(40, [900, 900])
    assert backend.detransform(list(wire), D_OPTS) == plain
    assert (b.windows_submitted, b.fast_path_windows, b.batched_windows, b.launches) == (1, 1, 0, 0)
    assert backend.dispatch_stats.dispatches == 1
    assert offered == [([900, 900], 1)]  # one window, offered with its mesh size
    backend.close()


@pytest.mark.parametrize("direction", ["decrypt", "encrypt"])
def test_zero_length_rows_bypass_the_batcher(direction):
    backend = cpu_backend()
    backend.enable_batching()
    plain, wire = make_window(42, [0, 512])
    if direction == "decrypt":
        assert backend.detransform(list(wire), D_OPTS) == plain
    else:
        got = backend.transform(plain, TransformOptions(encryption=DK, ivs=det_ivs(42, 2)))
        assert got == wire
    assert backend.batcher.windows_submitted == 0
    backend.close()


def test_background_never_takes_the_fast_path():
    backend = cpu_backend()
    b = WindowBatcher(backend, wait_ms=50)  # idle, not parked
    plain, wire = make_window(114, [600])
    job = submit_in_thread(b, wire, BACKGROUND)
    wait_queued(b, 1)  # queued despite zero contention
    assert b.flush_now() == 1
    join_all([job])
    assert job[1] == [plain, None]
    assert (b.fast_path_windows, b.batched_windows) == (0, 1)


def test_classes_never_mix_in_one_merged_launch():
    b = parked(wait_ms=50, max_windows=8)
    a = make_window(110, [700])
    c = make_window(111, [700])
    jobs = [submit_in_thread(b, a[1]), submit_in_thread(b, c[1], BACKGROUND)]
    wait_queued(b, 2)
    classes: list = []
    b.on_flush = lambda occ, added, cls, *rest: classes.append((cls, occ))
    assert len(b._buckets) == 2
    assert b.flush_now() == 2
    join_all(jobs)
    assert [box for _, box in jobs] == [[a[0], None], [c[0], None]]
    assert classes == [(LATENCY, 1), (BACKGROUND, 1)]
    assert b.class_launches == {LATENCY: 1, THROUGHPUT: 0, BACKGROUND: 1}
    assert b.class_flushed_windows[BACKGROUND] == 1


def test_background_scope_reaches_the_batcher_through_detransform():
    backend = cpu_backend()
    backend.enable_batching(wait_ms=10)
    plain, wire = make_window(115, [800])
    with work_class_scope(BACKGROUND):
        assert backend.detransform(list(wire), D_OPTS) == plain
    assert backend.batcher.fast_path_windows == 0
    assert backend.batcher.class_flushed_windows[BACKGROUND] == 1
    backend.close()


# ---------------------------------------------------------------- encrypt


def test_concurrent_copies_merge_byte_identically_and_match_jax():
    n = 4
    windows = [[np.random.default_rng(120 + i).bytes(600 + 40 * i),
                np.random.default_rng(220 + i).bytes(700)] for i in range(n)]
    opts = [TransformOptions(encryption=DK, ivs=det_ivs(120 + i, 2)) for i in range(n)]
    control = cpu_backend()
    expect = [control.transform(w, o) for w, o in zip(windows, opts)]
    backend = cpu_backend()
    b = parked(backend, wait_ms=25, max_windows=8)
    backend.batcher = b
    results: list = [None] * n
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(
        i, backend.transform(windows[i], opts[i]))) for i in range(n)]
    for t in threads:
        t.start()
    wait_queued(b, n)
    assert b.flush_now() == 1  # ONE merged encrypt launch
    for t in threads:
        t.join(timeout=60)
    assert results == expect
    stats = backend.dispatch_stats
    assert (stats.windows, stats.dispatches, stats.d2h_fetches) == (n, 1, 1)
    assert (b.launches, b.mean_occupancy, b.class_flushed_windows[THROUGHPUT]) == (1, float(n), n)
    jax_entries, _ = _jax_flush([o.ivs for o in opts], decrypt=False, chunks=windows)
    assert [e.result for e in jax_entries] == expect


def test_idle_encrypt_takes_the_fast_path_and_pipelines():
    windows = [make_window(130 + i, [512, 512])[0] for i in range(3)]
    opts = TransformOptions(encryption=DK, ivs=[iv for i in range(3) for iv in det_ivs(130 + i, 2)])
    expect = list(cpu_backend().transform_windows(windows, opts))
    backend = cpu_backend()
    backend.enable_batching(wait_ms=25)
    assert list(backend.transform_windows(windows, opts)) == expect
    b = backend.batcher
    assert (b.windows_submitted, b.fast_path_windows, b.launches) == (3, 3, 0)
    assert backend.dispatch_stats.dispatches_per_window == 1.0
    backend.close()


def test_encrypt_and_decrypt_never_share_a_bucket():
    backend = cpu_backend()
    b = parked(backend, wait_ms=50)
    backend.batcher = b
    plain, wire = make_window(140, [700])
    job = submit_in_thread(b, wire)
    chunk = np.random.default_rng(141).bytes(700)
    handle = b.submit_encrypt([chunk], TransformOptions(encryption=DK, ivs=det_ivs(141, 1)))
    wait_queued(b, 2)
    assert sorted(k[1] for k in b._buckets) == [False, True]
    assert b.flush_now() == 2
    join_all([job])
    assert job[1] == [plain, None]
    [stored] = handle.wait()
    iv = det_ivs(141, 1)[0]
    assert stored == iv + AESGCM(KEY).encrypt(iv, chunk, AAD)


def test_encrypt_launch_failure_reaches_its_waiters():
    backend = cpu_backend()
    b = parked(backend, wait_ms=50, launch_attempts=1)
    handle = b.submit_encrypt([b"x" * 512], TransformOptions(encryption=DK))
    boom = RuntimeError("encrypt launch failed")

    def dead(host):
        raise boom

    backend._stage_packed = dead
    assert b.flush_now() == 1
    with pytest.raises(RuntimeError, match="encrypt launch failed"):
        handle.wait()
    assert b.launch_failures == 1


# ----------------------------------------------------------- evidence + config


def test_thread_evidence_seam():
    backend = cpu_backend()
    b = parked(backend, wait_ms=50)
    backend.batcher = b
    assert backend.thread_batch_evidence() == (0, 0.0, 0)
    plain, wire = make_window(60, [512])
    payloads, sizes, ivs, tags = parse_wire(wire)
    box: list = [None, None]

    def run():
        before = b.thread_evidence()
        box[0] = b.submit(DK, payloads, sizes, ivs, tags)
        box[1] = (before, b.thread_evidence())

    t = threading.Thread(target=run)
    t.start()
    wait_queued(b, 1)
    b.flush_now()
    join_all([(t, box)])
    assert box[0] == plain
    assert box[1] == ((0, 0.0, 0), (1, 1.0, 1))  # one window, occupancy 1, batch 1
    assert b.thread_evidence() == (0, 0.0, 0)  # thread-local
    assert backend.thread_dispatch_counters() == (gcm.thread_dispatches(),
                                                  gcm.thread_hbm_roundtrips())


def test_configure_starts_the_batcher_and_close_stops_it():
    backend = cpu_backend(**{"batch.enabled": "true", "batch.wait.ms": 7, "batch.windows": 4,
                             "batch.bytes": 1 << 20, "batch.background.max.age.ms": 75})
    b = backend.batcher
    assert (b.wait_ms, b.max_windows, b.max_bytes, b.background_max_age_ms) == (7.0, 4, 1 << 20, 75.0)
    assert b._thread is not None and b._thread.is_alive()
    backend.close()
    assert backend.batcher is None and b._thread is None
    with pytest.raises(BatcherStoppedError):
        b.submit(DK, [b"x" * 32], [32], np.zeros((1, 12), np.uint8), [b"t" * 16])
    default = cpu_backend(**{"batch.enabled": True})
    assert default.batcher.background_max_age_ms == 50.0
    assert default.batcher.max_bytes == default.preferred_batch_bytes
    default.close()
    off = cpu_backend(**{"batch.enabled": "false"})
    assert off.batcher is None


def test_started_flusher_coalesces_and_matches_the_unbatched_path():
    """Through the daemon: 12 threads decrypt windows of one key at once;
    every plaintext comes back, and every window was either inline or
    coalesced, each counted once."""
    n = 12
    windows = [make_window(70 + i, [768 + (i % 3) * 40] * 2) for i in range(n)]
    backend = cpu_backend()
    backend.enable_batching(wait_ms=30, max_windows=8)
    results: list = [None] * n
    barrier = threading.Barrier(n)

    def fetch(i):
        barrier.wait(timeout=30)
        results[i] = backend.detransform(list(windows[i][1]), D_OPTS)

    threads = [threading.Thread(target=fetch, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert results == [p for p, _ in windows]
    b = backend.batcher
    assert b.windows_submitted == n
    assert b.fast_path_windows + b.batched_windows == n
    assert backend.dispatch_stats.windows == n
    assert backend.dispatch_stats.dispatches_per_window <= 1.0
    backend.close()


def test_retry_policy_and_loop_match_jax():
    """Classification, the seeded decorrelated-jitter schedule, and the
    `call_with_retry`'s ledger accounting (attempts, retries, give-ups, backoff) on a
    flaky call, in both packages."""
    import random

    from tieredstorage_tpu.storage.core import StorageBackendException as JaxStorageError
    from tieredstorage_tpu.utils import retry as jax_retry
    from tieredstorage_tpu.utils.deadline import DeadlineExceededException as JaxDeadline
    from tieredstorage_tpu_torch.utils import retry

    def run(mod, storage_error, deadline_error):
        policy = mod.RetryPolicy(max_attempts=3, base_backoff_s=0.01, max_backoff_s=0.05,
                                 terminal=(KeyError,), healthy=(LookupError,))
        kinds = [policy.classify(e).value for e in (
            storage_error("x"), deadline_error("late"), KeyError("k"), IndexError("i"),
            ValueError("v"), mod.CircuitOpenException("open"), KeyboardInterrupt())]
        rng = random.Random(7)
        prev, schedule = None, []
        for _ in range(6):
            prev = policy.backoff_s(prev, rng)
            schedule.append(prev)
        led, slept, calls = mod.RetryLedger(), [], [0]

        def flaky():
            calls[0] += 1
            if calls[0] % 4 != 0:
                raise storage_error("transient")
            return calls[0]

        results = []
        for _ in range(3):
            try:
                results.append(mod.call_with_retry(flaky, policy=policy, site="device.launch",
                                                   rng=random.Random(3), sleep=slept.append,
                                                   ledger=led))
            except storage_error:
                results.append("gave up")
        return kinds, schedule, results, slept, led.snapshot(), led.amplification("device.launch")

    got = run(retry, StorageBackendException, DeadlineExceededException)
    assert got == run(jax_retry, JaxStorageError, JaxDeadline)
    assert got[2] == ["gave up", 4, "gave up"]
    assert got[4]["device.launch"]["giveups"] == 2.0
