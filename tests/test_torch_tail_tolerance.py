"""Tail tolerance and overload control in the port, and each module against
its JAX twin.

The JAX suite (tests/test_tail_tolerance.py) runs against the port's
modules, bottom-up: deadline math and scopes; the HTTP transport consuming
the ambient deadline; the Hedger and its budget, and a hedged fetch whose
corrupt straggler cannot tear the winner; the RetryBudget under the
ResilientStorageBackend; the AdmissionController; the sidecar gateway's
shed; jittered fault delays; the hedger inside a single-flight resolve of
the fleet's peer tier.

Then parity, exact equality on seeded inputs: Hedger counters on one
slow-call schedule, RetryBudget balances, AdmissionController admit/shed
sequences with tenants, a ResilientStorageBackend over the in-memory store
with one FaultSchedule (outcomes, retries, breaker and budget state), and a
replicated store whose replica holds an OPEN breaker.
"""

from __future__ import annotations

import io
import random
import threading
import time

import pytest

from tieredstorage_tpu.faults import FaultInjectingBackend as JaxFaultInjectingBackend
from tieredstorage_tpu.faults import FaultSchedule as JaxFaultSchedule
from tieredstorage_tpu.fetch import hedge as jax_hedge
from tieredstorage_tpu.storage import memory as jax_memory
from tieredstorage_tpu.storage import replicated as jax_replicated
from tieredstorage_tpu.storage import resilient as jax_resilient
from tieredstorage_tpu.storage.core import ObjectKey as JaxObjectKey
from tieredstorage_tpu.utils import admission as jax_admission
from tieredstorage_tpu.utils import retry as jax_retry
from tieredstorage_tpu_torch.faults import (
    FaultInjectedException,
    FaultInjectingBackend,
    FaultRule,
    FaultSchedule,
)
from tieredstorage_tpu_torch.fetch import hedge as port_hedge
from tieredstorage_tpu_torch.fetch.chunk_manager import DefaultChunkManager
from tieredstorage_tpu_torch.fetch.hedge import HedgeBudget, Hedger
from tieredstorage_tpu_torch.manifest.chunk_index import FixedSizeChunkIndex
from tieredstorage_tpu_torch.manifest.segment_indexes import IndexType, SegmentIndexesV1Builder
from tieredstorage_tpu_torch.manifest.segment_manifest import SegmentManifestV1
from tieredstorage_tpu_torch.storage import memory as port_memory
from tieredstorage_tpu_torch.storage import replicated as port_replicated
from tieredstorage_tpu_torch.storage import resilient as port_resilient
from tieredstorage_tpu_torch.storage.core import KeyNotFoundException, ObjectKey
from tieredstorage_tpu_torch.storage.httpclient import HttpClient, HttpError
from tieredstorage_tpu_torch.storage.memory import InMemoryStorage
from tieredstorage_tpu_torch.storage.resilient import (
    BreakerState,
    CircuitBreaker,
    ResilientStorageBackend,
    RetryBudget,
)
from tieredstorage_tpu_torch.transform.api import (
    AuthenticationError,
    DetransformOptions,
    TransformBackend,
    TransformOptions,
)
from tieredstorage_tpu_torch.utils import admission as port_admission
from tieredstorage_tpu_torch.utils import retry as port_retry
from tieredstorage_tpu_torch.utils.admission import (
    AdmissionController,
    AdmissionRejectedException,
)
from tieredstorage_tpu_torch.utils.deadline import (
    Deadline,
    DeadlineExceededException,
    check_deadline,
    current_deadline,
    deadline_scope,
    ensure_deadline,
    parse_deadline_ms,
)


# ------------------------------------------------------------------ Deadline
class TestDeadline:
    def test_remaining_and_expiry(self):
        d = Deadline.after(0.05)
        assert 0.0 < d.remaining_s() <= 0.05
        assert not d.expired
        assert Deadline.after(-0.001).expired

    def test_wire_roundtrip(self):
        d = Deadline.after_ms(5000)
        parsed = parse_deadline_ms(d.header_value())
        assert parsed is not None
        assert abs(parsed.remaining_s() - d.remaining_s()) < 0.05

    @pytest.mark.parametrize("bad", [None, "", "  ", "abc", "-5", "+5", "1_0",
                                     "٥٠", "1.5"])
    def test_malformed_wire_values_ignored(self, bad):
        assert parse_deadline_ms(bad) is None

    def test_zero_parses_to_expired(self):
        d = parse_deadline_ms("0")
        assert d is not None and d.expired

    def test_scope_none_is_noop(self):
        with deadline_scope(None):
            assert current_deadline() is None
        d = Deadline.after(1.0)
        with deadline_scope(d), deadline_scope(None):
            assert current_deadline() is d

    def test_ensure_deadline_prefers_caller(self):
        caller = Deadline.after(5.0)
        with deadline_scope(caller), ensure_deadline(60.0) as effective:
            assert effective is caller
        with ensure_deadline(60.0) as effective:
            assert 59.0 < effective.remaining_s() <= 60.0
        with ensure_deadline(None) as effective:
            assert effective is None

    def test_check_deadline_raises_only_when_expired(self):
        check_deadline("unconstrained")
        with deadline_scope(Deadline.after(10.0)):
            check_deadline("plenty of budget")
        with deadline_scope(Deadline.after(-0.01)):
            with pytest.raises(DeadlineExceededException):
                check_deadline("expired")


# ---------------------------------------------------- transport consumption
class _RefusingConn:
    timeout = None
    sock = None

    def __init__(self, seen):
        self._seen = seen

    def request(self, *a, **k):
        self._seen.append((time.monotonic(), self.timeout))
        raise OSError("refused")

    def close(self):
        pass


class TestHttpClientDeadline:
    def test_expired_deadline_fails_before_any_network(self, monkeypatch):
        client = HttpClient("http://test.invalid")
        monkeypatch.setattr(client, "_new_connection", lambda: pytest.fail("network touched"))
        with deadline_scope(Deadline.after(-0.01)):
            with pytest.raises(DeadlineExceededException):
                client.request("GET", "/a")
            with pytest.raises(DeadlineExceededException):
                client.request_stream("GET", "/a")

    def test_attempt_timeout_clamped_to_remaining_budget(self, monkeypatch):
        client = HttpClient("http://test.invalid", timeout=30.0)
        seen = []
        monkeypatch.setattr(client, "_new_connection", lambda: _RefusingConn(seen))
        with deadline_scope(Deadline.after(0.2)):
            with pytest.raises((HttpError, DeadlineExceededException)):
                client.request("GET", "/a")
        assert seen and seen[0][1] is not None and seen[0][1] <= 0.2

    def test_retries_stop_when_budget_cannot_fit_backoff(self, monkeypatch):
        client = HttpClient("http://test.invalid")
        seen = []
        monkeypatch.setattr(client, "_new_connection", lambda: _RefusingConn(seen))
        start = time.monotonic()
        with deadline_scope(Deadline.after(0.15)):
            with pytest.raises((HttpError, DeadlineExceededException)):
                client.request("GET", "/retryable")
        assert time.monotonic() - start < 1.0


# ------------------------------------------------------------------ hedging
class _SlowCall:
    """Callable whose Nth invocation (1-based) sleeps; returns its call no."""

    def __init__(self, slow_calls: set[int], slow_s: float = 0.3):
        self.calls = 0
        self._lock = threading.Lock()
        self._slow_calls = slow_calls
        self._slow_s = slow_s

    def __call__(self):
        with self._lock:
            self.calls += 1
            n = self.calls
        if n in self._slow_calls:
            time.sleep(self._slow_s)
        return n


class TestHedger:
    def make_hedger(self, delay_s=0.02, percent=100, **kwargs):
        return Hedger(lambda: delay_s, HedgeBudget(percent), **kwargs)

    def test_fast_primary_never_hedges(self):
        hedger = self.make_hedger()
        try:
            fn = _SlowCall(set())
            assert hedger.call(fn) == 1
            assert (hedger.launched, hedger.wins, fn.calls) == (0, 0, 1)
        finally:
            hedger.close()

    def test_hedge_wins_over_straggler(self):
        wins_ms = []
        hedger = self.make_hedger(on_win=wins_ms.append)
        try:
            fn = _SlowCall({1}, slow_s=0.5)
            start = time.monotonic()
            assert hedger.call(fn) == 2
            assert time.monotonic() - start < 0.4
            assert hedger.launched == 1 and hedger.wins == 1
            assert len(wins_ms) == 1 and wins_ms[0] < 400.0
        finally:
            hedger.close()

    def test_budget_suppresses_hedges(self):
        hedger = self.make_hedger(percent=1)
        try:
            fn = _SlowCall({1, 3}, slow_s=0.15)
            assert hedger.call(fn) == 2
            assert hedger.call(fn) == 3
            assert hedger.call(fn) == 4
            assert hedger.launched == 1 and hedger.suppressed == 1
        finally:
            hedger.close()

    def test_first_success_wins_over_failing_fast_attempt(self):
        state = {"calls": 0}
        lock = threading.Lock()

        def fn():
            with lock:
                state["calls"] += 1
                n = state["calls"]
            if n == 1:
                time.sleep(0.1)
                raise OSError("straggler also failed")
            return "hedge-ok"

        hedger = self.make_hedger()
        try:
            assert hedger.call(fn) == "hedge-ok"
        finally:
            hedger.close()

    def test_both_attempts_failing_propagates(self):
        def fn():
            time.sleep(0.05)
            raise KeyNotFoundException("backend", ObjectKey("k"))

        hedger = self.make_hedger(delay_s=0.01)
        try:
            with pytest.raises(KeyNotFoundException):
                hedger.call(fn)
        finally:
            hedger.close()

    def test_ambient_deadline_crosses_into_hedge_threads(self):
        hedger = self.make_hedger()
        seen = {}

        def fn():
            seen["deadline"] = current_deadline()
            return 1

        try:
            with deadline_scope(Deadline.after(5.0)) as d:
                hedger.call(fn)
            assert seen["deadline"].at_monotonic == d.at_monotonic
        finally:
            hedger.close()

    def test_pool_threads_carry_the_hedge_prefix(self):
        hedger = self.make_hedger()
        try:
            assert hedger.call(lambda: threading.current_thread().name).startswith("hedge")
        finally:
            hedger.close()


class ParityTransformBackend(TransformBackend):
    """Identity transform whose detransform validates that every chunk is a
    constant fill — the stand-in for the GCM tag check."""

    def transform(self, chunks, opts: TransformOptions):
        return list(chunks)

    def detransform(self, chunks, opts: DetransformOptions):
        for chunk in chunks:
            if chunk and any(b != chunk[0] for b in chunk):
                raise AuthenticationError("chunk bytes fail integrity check")
        return list(chunks)


def _upload_one_segment(storage, chunk=256, n_chunks=8):
    payload = b"".join(bytes([i]) * chunk for i in range(n_chunks))
    key = ObjectKey("seg/tail.log")
    storage.upload(io.BytesIO(payload), key)
    indexes = SegmentIndexesV1Builder()
    for t in (IndexType.OFFSET, IndexType.TIMESTAMP,
              IndexType.PRODUCER_SNAPSHOT, IndexType.LEADER_EPOCH):
        indexes.add(t, 0)
    manifest = SegmentManifestV1(
        chunk_index=FixedSizeChunkIndex(
            original_chunk_size=chunk, original_file_size=len(payload),
            transformed_chunk_size=chunk, final_transformed_chunk_size=chunk,
        ),
        segment_indexes=indexes.build(),
        compression=False,
        encryption=None,
    )
    return key, manifest, payload, ParityTransformBackend()


class TestHedgedFetchUnderFaults:
    def test_corrupt_straggling_loser_cannot_tear_the_winner(self):
        """The FIRST backend attempt is both slow and corrupt; the hedge is
        clean and fast, wins, and the plaintext is byte-identical — the
        discarded loser's bytes never reach the detransform."""
        storage = InMemoryStorage()
        key, manifest, payload, backend = _upload_one_segment(storage)
        schedule = FaultSchedule.parse("fetch:delay=300@1; fetch:corrupt=13@1", seed=7)
        manager = DefaultChunkManager(FaultInjectingBackend(storage, schedule), backend)
        hedger = Hedger(lambda: 0.02, HedgeBudget(100))
        manager.hedger = hedger
        try:
            assert b"".join(manager.get_chunks(key, manifest, list(range(8)))) == payload
            assert hedger.launched == 1 and hedger.wins == 1
            assert schedule.calls("fetch") == 2
            assert manager.corruptions == 0
        finally:
            hedger.close()

    def test_replicated_fetcher_hedges_against_a_distinct_replica(self):
        """Over a replicated store the hedge reads the second replica
        directly: the straggling first replica serves one request."""
        slow = FaultSchedule.parse("fetch:delay=300", seed=1)
        first = FaultInjectingBackend(InMemoryStorage(), slow)
        second = InMemoryStorage()
        replicated = port_replicated.ReplicatedStorageBackend([first, second])
        key, manifest, payload, backend = _upload_one_segment(replicated)
        manager = DefaultChunkManager(replicated, backend)
        seen = []
        hedger = Hedger(lambda: 0.02, HedgeBudget(100))
        hedger.tracer = type("T", (), {"event": staticmethod(
            lambda name, **kw: seen.append((name, kw)))})()
        manager.hedger = hedger
        try:
            assert b"".join(manager.get_chunks(key, manifest, list(range(8)))) == payload
            assert hedger.wins == 1 and slow.calls("fetch") == 1
            assert ("fetch.hedged", {"what": key.value, "distinct_replica": True}) in seen
        finally:
            hedger.close()
            replicated.close()


class TestHedgeSingleFlightInteraction:
    """The hedger races attempts WITHIN one single-flight resolve
    (fleet/singleflight.py wraps the chunk manager whose storage GET the
    hedger hedges). A hedge that loses to the coalesced primary must not
    count as a win, and the flight slot must never leak — followers get the
    winner's bytes and the registry returns to empty."""

    def _fleet_manager(self, schedule_spec: str, *, hedge_delay_s: float):
        from tieredstorage_tpu_torch.fleet import FleetRouter, PeerChunkCache

        storage = InMemoryStorage()
        key, manifest, payload, backend = _upload_one_segment(storage)
        schedule = FaultSchedule.parse(schedule_spec, seed=11)
        manager = DefaultChunkManager(FaultInjectingBackend(storage, schedule), backend)
        hedger = Hedger(lambda: hedge_delay_s, HedgeBudget(100))
        manager.hedger = hedger
        peer = PeerChunkCache(manager, FleetRouter("solo", vnodes=4))
        return peer, hedger, schedule, key, manifest, payload

    def _concurrent_reads(self, peer, key, manifest, n=4):
        results: list = [None] * n
        barrier = threading.Barrier(n)

        def read(i):
            barrier.wait()
            results[i] = b"".join(peer.get_chunks(key, manifest, list(range(8))))

        threads = [threading.Thread(target=read, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        return results

    def test_hedge_losing_to_coalesced_primary_no_win_no_leaked_slot(self):
        # EVERY storage fetch stalls 80 ms; the hedge (launched at 20 ms)
        # restarts the same 80 ms clock, so the primary always finishes
        # first and the hedge is a pure loser.
        peer, hedger, schedule, key, manifest, payload = self._fleet_manager(
            "fetch:delay=80", hedge_delay_s=0.02
        )
        try:
            results = self._concurrent_reads(peer, key, manifest)
            assert results == [payload] * 4
            flight = peer.singleflight
            assert flight.leaders == 1 and flight.coalesced == 3
            assert flight.pending == 0
            assert hedger.launched == 1 and hedger.wins == 0
            assert schedule.calls("fetch") == 2
        finally:
            hedger.close()
            peer.close()

    def test_hedge_winning_inside_a_flight_counts_once_and_serves_followers(self):
        # Only the FIRST storage fetch stalls (300 ms); the hedge is clean
        # and fast, wins, and every coalesced follower gets its bytes.
        peer, hedger, schedule, key, manifest, payload = self._fleet_manager(
            "fetch:delay=300@1", hedge_delay_s=0.02
        )
        try:
            results = self._concurrent_reads(peer, key, manifest)
            assert results == [payload] * 4
            flight = peer.singleflight
            assert flight.leaders == 1 and flight.coalesced == 3
            assert flight.pending == 0
            assert hedger.launched == 1 and hedger.wins == 1
            assert schedule.calls("fetch") == 2
        finally:
            hedger.close()
            peer.close()

    def test_failed_flight_leaves_registry_clean_for_retry(self):
        # Both attempts stall THEN fail (a fast-failing primary would raise
        # before the hedge even launches): the error reaches the caller,
        # the slot is gone, and a later read (faults exhausted) succeeds.
        peer, hedger, schedule, key, manifest, payload = self._fleet_manager(
            "fetch:delay=50@1, fetch:raise@1, fetch:delay=50@2, fetch:raise@2",
            hedge_delay_s=0.005,
        )
        try:
            with pytest.raises(FaultInjectedException):
                peer.get_chunks(key, manifest, list(range(8)))
            assert peer.singleflight.pending == 0
            assert peer.singleflight.failures == 1
            out = b"".join(peer.get_chunks(key, manifest, list(range(8))))
            assert out == payload
        finally:
            hedger.close()
            peer.close()


# ------------------------------------------------------------- retry budget
class _FlakyBackend(InMemoryStorage):
    """fetch fails `fail_first` times, then succeeds."""

    def __init__(self, fail_first: int):
        super().__init__()
        self.fail_first = fail_first
        self.fetches = 0

    def fetch(self, key, byte_range=None):
        self.fetches += 1
        if self.fetches <= self.fail_first:
            raise FaultInjectedException(f"flake #{self.fetches}")
        return super().fetch(key, byte_range)


class TestRetryBudget:
    def test_earn_spend_and_denial(self):
        budget = RetryBudget(50, capacity=2.0)
        assert budget.try_spend() and budget.try_spend()
        assert not budget.try_spend()
        assert budget.denied == 1
        for _ in range(2):
            budget.deposit()
        assert budget.try_spend()
        assert budget.spent == 3

    def test_budgeted_retry_recovers_transient_failure(self):
        inner = _FlakyBackend(fail_first=1)
        inner.upload(io.BytesIO(b"payload"), ObjectKey("k"))
        backend = ResilientStorageBackend(
            inner, retry_budget=RetryBudget(100), max_attempts=3, backoff_s=0.001,
        )
        with backend.fetch(ObjectKey("k")) as stream:
            assert stream.read() == b"payload"
        assert inner.fetches == 2 and backend.retry_budget.spent == 1
        assert backend.delegate is inner

    def test_no_budget_means_no_retries(self):
        inner = _FlakyBackend(fail_first=1)
        backend = ResilientStorageBackend(inner)
        with pytest.raises(FaultInjectedException):
            backend.fetch(ObjectKey("k"))
        assert inner.fetches == 1

    def test_upload_is_never_replayed(self):
        calls = []

        class FailingUpload(InMemoryStorage):
            def upload(self, stream, key):
                calls.append(1)
                raise FaultInjectedException("upload broke")

        backend = ResilientStorageBackend(
            FailingUpload(), retry_budget=RetryBudget(100), max_attempts=3
        )
        with pytest.raises(FaultInjectedException):
            backend.upload(io.BytesIO(b"x"), ObjectKey("k"))
        assert calls == [1]

    def test_expired_deadline_is_not_retried_and_spares_the_breaker(self):
        class DeadlineRaiser(InMemoryStorage):
            def fetch(self, key, byte_range=None):
                raise DeadlineExceededException("budget gone")

        breaker = CircuitBreaker(failure_threshold=1)
        backend = ResilientStorageBackend(
            DeadlineRaiser(), breaker, retry_budget=RetryBudget(100)
        )
        with pytest.raises(DeadlineExceededException):
            backend.fetch(ObjectKey("k"))
        assert breaker.state is BreakerState.CLOSED
        assert backend.retry_budget.spent == 0

    def test_contract_answers_count_as_healthy(self):
        breaker = CircuitBreaker(failure_threshold=1)
        backend = ResilientStorageBackend(
            InMemoryStorage(), breaker, retry_budget=RetryBudget(100, capacity=1.0)
        )
        backend.retry_budget.try_spend()
        with pytest.raises(KeyNotFoundException):
            backend.fetch(ObjectKey("missing"))
        assert breaker.state is BreakerState.CLOSED
        assert backend.retry_budget.balance == 1.0  # the answer deposited

    def test_list_objects_is_materialised_under_the_breaker(self):
        class BrokenPages(InMemoryStorage):
            def list_objects(self, prefix=""):
                yield ObjectKey("a")
                raise FaultInjectedException("page 2 failed")

        breaker = CircuitBreaker(failure_threshold=1)
        backend = ResilientStorageBackend(BrokenPages(), breaker)
        with pytest.raises(FaultInjectedException):
            backend.list_objects("")
        assert breaker.state is BreakerState.OPEN

    def test_amplification_capped_under_sustained_outage(self):
        primaries = 200
        percent, capacity = 10, 5.0
        schedule = FaultSchedule.parse("fetch:raise", seed=42)
        backend = ResilientStorageBackend(
            FaultInjectingBackend(InMemoryStorage(), schedule),
            CircuitBreaker(failure_threshold=10_000),
            retry_budget=RetryBudget(percent, capacity=capacity),
            max_attempts=3,
            backoff_s=0.0001,
        )
        for i in range(primaries):
            with pytest.raises(FaultInjectedException):
                backend.fetch(ObjectKey(f"k{i}"))
        attempts = schedule.calls("fetch")
        assert primaries <= attempts <= primaries + (percent / 100.0) * primaries + capacity
        assert attempts == primaries + int(capacity)
        assert backend.retry_budget.denied > 0

    def test_retry_recloses_breaker_accounting(self):
        inner = _FlakyBackend(fail_first=10)
        breaker = CircuitBreaker(failure_threshold=3)
        backend = ResilientStorageBackend(
            inner, breaker, retry_budget=RetryBudget(100, capacity=10),
            max_attempts=5, backoff_s=0.0001,
        )
        with pytest.raises(Exception):
            backend.fetch(ObjectKey("k"))
        assert breaker.state is BreakerState.OPEN
        assert inner.fetches == 3


# -------------------------------------------------------- admission control
class TestAdmissionController:
    def test_admits_up_to_limit_then_sheds(self):
        controller = AdmissionController(2, 0, retry_after_s=3.0)
        controller.acquire("a")
        controller.acquire("b")
        with pytest.raises(AdmissionRejectedException) as exc_info:
            controller.acquire("c")
        assert exc_info.value.retry_after_s == 3.0
        assert (controller.active, controller.shed_total) == (2, 1)
        controller.release()
        controller.acquire("d")
        assert controller.admitted_total == 3

    def test_bounded_queue_admits_after_release(self):
        waits = []
        controller = AdmissionController(1, 1, queue_timeout_s=5.0, on_wait=waits.append)
        controller.acquire("first")
        admitted = threading.Event()

        def queued():
            controller.acquire("second")
            admitted.set()

        t = threading.Thread(target=queued)
        t.start()
        time.sleep(0.05)
        assert controller.queued == 1 and not admitted.is_set()
        controller.release()
        t.join(timeout=2)
        assert admitted.is_set() and len(waits) == 1 and waits[0] >= 40.0

    def test_queue_timeout_sheds(self):
        controller = AdmissionController(1, 4, queue_timeout_s=0.05)
        controller.acquire("holder")
        start = time.monotonic()
        with pytest.raises(AdmissionRejectedException):
            controller.acquire("stuck")
        assert 0.04 <= time.monotonic() - start < 1.0
        assert controller.queued == 0

    def test_validation(self):
        with pytest.raises(ValueError, match="max_concurrent"):
            AdmissionController(0, 1)
        with pytest.raises(ValueError, match="max_queue"):
            AdmissionController(1, -1)


# ------------------------------------------------- jittered fault schedules
class TestGatewaySheds:
    def test_shed_returns_429_with_retry_after_before_reading_body(self, tmp_path):
        import http.client

        from tests.test_torch_rsm import _write_segment
        from tieredstorage_tpu_torch import metadata
        from tieredstorage_tpu_torch.rsm import RemoteStorageManager
        from tieredstorage_tpu_torch.sidecar import shimwire
        from tieredstorage_tpu_torch.sidecar.http_gateway import SidecarHttpGateway

        store = tmp_path / "store"
        store.mkdir()
        rsm = RemoteStorageManager()
        rsm.configure({
            "storage.backend.class": "tieredstorage_tpu_torch.storage.filesystem.FileSystemStorage",
            "storage.root": str(store),
            "chunk.size": 4096,
            "transform.device": "cpu",
            "admission.enabled": True,
            "admission.max.concurrent": 1,
            "admission.max.queue": 0,
            "admission.retry.after.ms": 2_000,
        })
        md, sd, _ = _write_segment(tmp_path, metadata)
        rsm.copy_log_segment_data(md, sd)
        gateway = SidecarHttpGateway(rsm).start()
        try:
            # Deterministically occupy the single slot, then hit the gate.
            rsm.admission.acquire("test-holder")
            try:
                conn = http.client.HTTPConnection("127.0.0.1", gateway.port, timeout=10)
                body = shimwire.encode_metadata(md) + shimwire.encode_fetch_tail(0, None)
                conn.request("POST", "/v1/fetch", body=body)
                resp = conn.getresponse()
                payload = resp.read()
                conn.close()
                assert resp.status == 429
                assert resp.getheader("Retry-After") == "2"
                assert b"AdmissionRejectedException" in payload
            finally:
                rsm.admission.release()
            # Slot freed: the same request is served normally.
            conn = http.client.HTTPConnection("127.0.0.1", gateway.port, timeout=30)
            conn.request("POST", "/v1/fetch", body=body)
            resp = conn.getresponse()
            served = resp.read()
            conn.close()
            assert resp.status == 200
            assert len(served) == md.segment_size_in_bytes
            assert rsm.admission.shed_total == 1
        finally:
            gateway.stop()
            rsm.close()


class TestJitteredDelays:
    def test_grammar_parses_ranges(self):
        rule = FaultSchedule.parse("fetch:delay=10..250@p=0.5").rules[0]
        assert rule == FaultRule("fetch", "delay", arg=10, probability=0.5, arg_hi=250)

    @pytest.mark.parametrize("bad", ["fetch:delay=250..10", "fetch:corrupt=1..5",
                                     "fetch:truncate=1..5@1"])
    def test_grammar_rejects_bad_ranges(self, bad):
        with pytest.raises(ValueError):
            FaultSchedule.parse(bad)

    def test_draws_are_within_bounds_and_seed_deterministic(self):
        def draws(seed):
            schedule = FaultSchedule.parse("fetch:delay=10..250", seed=seed)
            return [schedule.delay_ms(schedule.rules[0]) for _ in range(50)]

        first = draws(123)
        assert all(10.0 <= d <= 250.0 for d in first) and len(set(first)) > 1
        assert first == draws(123) and first != draws(124)

    def test_injected_jittered_delay_slows_the_call(self):
        schedule = FaultSchedule.parse("fetch:delay=30..60@1", seed=9)
        backend = FaultInjectingBackend(InMemoryStorage(), schedule)
        backend.upload(io.BytesIO(b"x"), ObjectKey("k"))
        start = time.monotonic()
        with backend.fetch(ObjectKey("k")) as stream:
            stream.read()
        assert time.monotonic() - start >= 0.03


# ====================================================== parity with JAX
class _HeldCall:
    """Callable whose Nth invocation (1-based) is held until released or
    for `hold_s`; returns its call number. A fast call returns at once, so
    with a hedge delay of 0.25 s no scheduling hiccup turns it into a
    straggler."""

    def __init__(self, slow_calls: set[int], hold_s: float = 0.6):
        self.calls = 0
        self._lock = threading.Lock()
        self._slow_calls = slow_calls
        self._hold_s = hold_s
        self.release = threading.Event()

    def __call__(self):
        with self._lock:
            self.calls += 1
            n = self.calls
        if n in self._slow_calls:
            self.release.wait(self._hold_s)
        return n


def _hedger_counters(hedge, slow: set[int], calls: int) -> tuple:
    hedger = hedge.Hedger(lambda: 0.25, hedge.HedgeBudget(34))
    fn = _HeldCall(slow)
    results = []
    try:
        for _ in range(calls):
            fn.release.clear()
            results.append(hedger.call(fn, what="w"))
            fn.release.set()  # a losing straggler ends now
    finally:
        hedger.close()
    return (results, hedger.primaries, hedger.launched, hedger.wins, hedger.suppressed,
            round(hedger.budget.balance, 9))


@pytest.mark.parametrize("seed", [0, 1])
def test_hedger_counters_equal_jax(seed):
    """The same seeded schedule of straggling invocations: the same answers,
    primaries, launched hedges, wins and budget suppressions."""
    rng = random.Random(seed)
    slow = set(rng.sample(range(1, 10), 3))
    port = _hedger_counters(port_hedge, slow, 8)
    jax = _hedger_counters(jax_hedge, slow, 8)
    assert port == jax
    assert port[2] >= 1  # at least one hedge launched


@pytest.mark.parametrize("seed", range(4))
def test_retry_budget_balances_equal_jax(seed):
    rng = random.Random(seed)
    percent, capacity = rng.choice((5, 10, 50, 100)), rng.choice((1.0, 3.0, 10.0))
    ops = [rng.choice(("deposit", "spend", "spend")) for _ in range(200)]
    traces = {}
    for name, mod in (("port", port_resilient), ("jax", jax_resilient)):
        budget = mod.RetryBudget(percent, capacity=capacity)
        trace = []
        for op in ops:
            got = budget.deposit() if op == "deposit" else budget.try_spend()
            trace.append((got, budget.balance, budget.spent, budget.denied))
        traces[name] = trace
    assert traces["port"] == traces["jax"]
    for mod in (port_resilient, jax_resilient):
        with pytest.raises(ValueError, match="retry budget percent"):
            mod.RetryBudget(0)
    for mod in (port_hedge, jax_hedge):
        with pytest.raises(ValueError, match="hedge budget percent"):
            mod.HedgeBudget(101)


def _admission_trace(mod, seed: int, max_concurrent: int) -> list:
    rng = random.Random(seed)
    controller = mod.AdmissionController(max_concurrent, 0, retry_after_s=2.5)
    held: list = []
    trace = []
    for _ in range(120):
        if held and rng.random() < 0.4:
            tenant = held.pop(rng.randrange(len(held)))
            controller.release(tenant=tenant)
            trace.append(("release", tenant))
        else:
            tenant = rng.choice((None, "greedy", "greedy", "polite", "other"))
            try:
                controller.acquire(f"req-{len(trace)}", tenant=tenant)
                held.append(tenant)
                trace.append(("admitted", tenant))
            except mod.AdmissionRejectedException as e:
                trace.append(("shed", tenant, str(e), e.retry_after_s))
        trace.append((controller.active, controller.queued, controller.admitted_total,
                      controller.shed_total, dict(controller.tenant_sheds),
                      {t: controller.tenant_active(t) for t in ("greedy", "polite", "other")}))
    return trace


@pytest.mark.parametrize("max_concurrent", [1, 3, 4])
@pytest.mark.parametrize("seed", range(3))
def test_admission_sequences_with_tenants_equal_jax(seed, max_concurrent):
    port = _admission_trace(port_admission, seed, max_concurrent)
    jax = _admission_trace(jax_admission, seed, max_concurrent)
    assert port == jax
    outcomes = {step[0] for step in port if isinstance(step[0], str)}
    assert {"admitted", "shed"} <= outcomes


def test_admission_queue_timeout_message_equals_jax():
    messages = []
    for mod in (port_admission, jax_admission):
        controller = mod.AdmissionController(1, 1, queue_timeout_s=0.03)
        controller.acquire("holder")
        with pytest.raises(mod.AdmissionRejectedException) as err:
            controller.acquire("late")
        messages.append((str(err.value), controller.shed_total, controller.queued))
    assert messages[0] == messages[1]
    assert messages[0][0] == "queued 30 ms without a slot: late shed"


class _Events:
    def __init__(self):
        self.events = []

    def event(self, name, **attrs):
        self.events.append((name, attrs))


_RESILIENT_SPEC = "fetch:raise@p=0.45; upload:raise@p=0.2; delete:raise@p=0.3; list:raise@p=0.3"


def _resilient_trace(pkg: str, seed: int) -> dict:
    resilient, memory, schedule_cls, injecting, key_cls, retry = {
        "port": (port_resilient, port_memory, FaultSchedule, FaultInjectingBackend,
                 ObjectKey, port_retry),
        "jax": (jax_resilient, jax_memory, JaxFaultSchedule, JaxFaultInjectingBackend,
                JaxObjectKey, jax_retry),
    }[pkg]
    rng = random.Random(seed)
    store = memory.InMemoryStorage()
    store.configure({})
    schedule = schedule_cls.parse(_RESILIENT_SPEC, seed=seed)
    clock = [0.0]
    breaker = resilient.CircuitBreaker(3, 1.0, time_source=lambda: clock[0])
    events = _Events()
    backend = resilient.ResilientStorageBackend(
        injecting(store, schedule), breaker, retry_budget=resilient.RetryBudget(50, capacity=3.0),
        max_attempts=3, backoff_s=0.0001, tracer=events,
    )
    keys: list[str] = []
    trace = []
    for i in range(90):
        clock[0] += rng.choice((0.1, 0.4, 1.5))
        op = rng.choice(("upload", "fetch", "fetch", "fetch_missing", "delete", "list"))
        try:
            if op == "upload":
                name = f"k/{i}"
                backend.upload(io.BytesIO(name.encode() * 3), key_cls(name))
                keys.append(name)
                got = "uploaded"
            elif op == "fetch" and keys:
                with backend.fetch(key_cls(rng.choice(keys))) as stream:
                    got = stream.read().decode()
            elif op == "delete" and keys:
                backend.delete(key_cls(keys.pop(rng.randrange(len(keys)))))
                got = "deleted"
            elif op == "list":
                got = sorted(k.value for k in backend.list_objects("k/"))
            else:
                with backend.fetch(key_cls(f"missing/{i}")):
                    got = "found?"
        except Exception as e:  # noqa: BLE001 — the outcome is the datum
            got = (type(e).__name__, str(e))
        trace.append((op, got, breaker.state.name, breaker.opens, breaker.fast_fails,
                      backend.retry_budget.balance, backend.retry_budget.spent,
                      backend.retry_budget.denied))
    calls = {op: schedule.calls(op) for op in ("upload", "fetch", "delete", "list")}
    return {"trace": trace, "calls": calls, "events": events.events}


@pytest.mark.parametrize("seed", range(4))
def test_resilient_backend_with_one_fault_schedule_equals_jax(seed):
    port, jax = _resilient_trace("port", seed), _resilient_trace("jax", seed)
    assert port == jax
    outcomes = [step[1] for step in port["trace"]]
    assert any(isinstance(o, tuple) and o[0] == "CircuitOpenException" for o in outcomes)
    assert any(name == "storage.retry" for name, _ in port["events"])


def _replicas_with_open_breaker(replicated, resilient, memory):
    stores = [memory.InMemoryStorage(), memory.InMemoryStorage(), memory.InMemoryStorage()]
    breaker = resilient.CircuitBreaker(failure_threshold=1, cooldown_s=60.0)
    breaker.on_failure()
    guarded = resilient.ResilientStorageBackend(stores[0], breaker)
    backend = replicated.ReplicatedStorageBackend(
        [("a", guarded), ("b", stores[1]), ("c", stores[2])]
    )
    return backend, guarded


def test_replica_with_an_open_breaker_scores_zero_and_is_read_last():
    got = {}
    for name, replicated, resilient, memory in (
        ("port", port_replicated, port_resilient, port_memory),
        ("jax", jax_replicated, jax_resilient, jax_memory),
    ):
        backend, guarded = _replicas_with_open_breaker(replicated, resilient, memory)
        try:
            scores = {state.name: state.health_score() for state in backend.replica_states}
            order = [next(s.name for s in backend.replica_states if s.backend is b)
                     for b in backend.read_fetchers()]
            assert backend.read_fetchers()[-1] is guarded
            got[name] = (scores, order)
        finally:
            backend.close()
    assert got["port"] == got["jax"]
    assert got["port"][0]["a"] == 0.0 and got["port"][1] == ["b", "c", "a"]
