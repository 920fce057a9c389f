"""The port's circuit breakers, retry loop and retry-metrics group against
the JAX package's (tieredstorage_tpu_torch/utils/retry.py,
metrics/retry_metrics.py).

Every case runs the same seeded script through both packages on injected
clocks, RNGs and sleepers, and requires exact equality: the breaker's
transitions, `opens` and the other counters, `state_code` and `refusing`
after every step, and the half-open single probe; a `BreakerBoard` over
several targets; `call_with_retry` with a breaker (attempts, ledger,
sleeps, the exception raised); and the `retry-metrics` gauges. The JAX
suite's breaker cases run against the port too. The new locks are
`utils/locks` factory locks under the JAX names.
"""

from __future__ import annotations

import importlib.util
import random
import sys

import pytest

from tieredstorage_tpu.metrics import core as jax_core
from tieredstorage_tpu.metrics import retry_metrics as jax_retry_metrics
from tieredstorage_tpu.utils import deadline as jax_deadline
from tieredstorage_tpu.utils import faults as jax_faults
from tieredstorage_tpu.utils import retry as jax_retry
from tieredstorage_tpu_torch.metrics import core as port_core
from tieredstorage_tpu_torch.metrics import retry_metrics as port_retry_metrics
from tieredstorage_tpu_torch.utils import deadline as port_deadline
from tieredstorage_tpu_torch.utils import faults as port_faults
from tieredstorage_tpu_torch.utils import locks
from tieredstorage_tpu_torch.utils import retry as port_retry
from tieredstorage_tpu_torch.utils.retry import (
    BreakerBoard,
    BreakerState,
    CircuitBreaker,
    CircuitOpenException,
    RetryPolicy,
)

PACKAGES = {
    "jax": (jax_retry, jax_deadline, jax_core, jax_retry_metrics, jax_faults),
    "port": (port_retry, port_deadline, port_core, port_retry_metrics, port_faults),
}
SEEDS = range(8)


# ---------------------------------------------------------------- breaker
def _breaker_script(seed: int, steps: int = 120) -> list[tuple[str, float]]:
    rng = random.Random(seed)
    ops = ["acquire", "success", "failure", "failure", "neutral", "tick"]
    return [(rng.choice(ops), rng.choice((0.5, 2.0, 7.5))) for _ in range(steps)]


def _run_breaker(retry, script, threshold: int, cooldown: float) -> list:
    clock = [0.0]
    transitions = []
    breaker = retry.CircuitBreaker(
        threshold, cooldown, time_source=lambda: clock[0],
        on_transition=lambda old, new: transitions.append((old.name, new.name)),
    )
    trace = []
    for op, dt in script:
        outcome = None
        if op == "tick":
            clock[0] += dt
        elif op == "acquire":
            try:
                breaker.acquire()
                outcome = "admitted"
            except retry.CircuitOpenException as e:
                outcome = f"refused: {e}"
        else:
            getattr(breaker, f"on_{op}")()
        trace.append((
            op, outcome, breaker.state.name, breaker.state_code, breaker.refusing,
            breaker.opens, breaker.half_opens, breaker.closes, breaker.fast_fails,
        ))
    return [trace, transitions, breaker.observer_failures]


@pytest.mark.parametrize("threshold,cooldown", [(1, 5.0), (3, 5.0), (2, 1.0)])
@pytest.mark.parametrize("seed", SEEDS)
def test_breaker_sequences_equal_jax(seed, threshold, cooldown):
    script = _breaker_script(seed)
    port = _run_breaker(port_retry, script, threshold, cooldown)
    jax = _run_breaker(jax_retry, script, threshold, cooldown)
    assert port == jax
    states = {step[2] for step in port[0]}
    assert "OPEN" in states  # every script drives the breaker open at least once


@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_half_open_admits_exactly_one_probe(package):
    retry = PACKAGES[package][0]
    clock = [0.0]
    breaker = retry.CircuitBreaker(1, 10.0, time_source=lambda: clock[0])
    breaker.on_failure()
    clock[0] += 10.0
    breaker.acquire()  # the probe
    assert breaker.state is retry.BreakerState.HALF_OPEN and breaker.refusing
    for _ in range(3):
        with pytest.raises(retry.CircuitOpenException, match="probe already in flight"):
            breaker.acquire()
    breaker.on_neutral()  # caller impatience frees the slot, state stays
    assert breaker.state is retry.BreakerState.HALF_OPEN and not breaker.refusing
    breaker.acquire()
    breaker.on_success()
    assert (breaker.state, breaker.opens, breaker.half_opens, breaker.closes,
            breaker.fast_fails) == (retry.BreakerState.CLOSED, 1, 1, 1, 3)


def test_breaker_validation_and_state_codes_equal_jax():
    for retry in (port_retry, jax_retry):
        with pytest.raises(ValueError, match="failure_threshold must be >= 1"):
            retry.CircuitBreaker(failure_threshold=0)
    assert [s.value for s in port_retry.BreakerState] == [s.value for s in jax_retry.BreakerState]
    assert [s.name for s in port_retry.BreakerState] == [s.name for s in jax_retry.BreakerState]
    port_policy, jax_policy = port_retry.RetryPolicy(max_attempts=5), jax_retry.RetryPolicy(max_attempts=5)
    assert port_policy.single().max_attempts == jax_policy.single().max_attempts == 1
    assert port_policy.single().retryable == port_policy.retryable


def test_transition_observer_failures_are_counted():
    clock = [0.0]

    def explode(old, new):
        raise RuntimeError("observer fell over")

    breaker = CircuitBreaker(1, 10.0, time_source=lambda: clock[0], on_transition=explode)
    breaker.on_failure()
    assert breaker.state is BreakerState.OPEN and breaker.observer_failures == 1


def test_failed_probe_reopens_immediately():
    clock = [0.0]
    breaker = CircuitBreaker(3, 10.0, time_source=lambda: clock[0])
    for _ in range(3):
        breaker.on_failure()
    clock[0] += 10.0
    breaker.acquire()
    breaker.on_failure()
    assert breaker.state is BreakerState.OPEN and breaker.opens == 2
    with pytest.raises(CircuitOpenException):
        breaker.acquire()


# ----------------------------------------------------------------- board
def _run_board(retry, seed: int) -> list:
    rng = random.Random(seed)
    clock = [0.0]
    seen = []
    board = retry.BreakerBoard(
        failure_threshold=2, cooldown_s=3.0, time_source=lambda: clock[0],
        on_transition=lambda t, old, new: seen.append((t, old.name, new.name)),
    )
    trace = []
    for _ in range(150):
        target = rng.choice(("a", "b", "c", "d"))
        op = rng.choice(("acquire", "success", "failure", "failure", "tick"))
        if op == "tick":
            clock[0] += rng.choice((0.5, 1.0, 4.0))
            continue
        breaker = board.for_target(target)
        if op == "acquire":
            try:
                breaker.acquire()
            except retry.CircuitOpenException:
                pass
        else:
            getattr(breaker, f"on_{op}")()
        trace.append((
            {t: s.name for t, s in board.targets().items()}, board.open_count(),
            board.known_count(), board.opened, board.half_opened, board.closed,
        ))
    return [trace, seen]


@pytest.mark.parametrize("seed", SEEDS)
def test_board_sequences_equal_jax(seed):
    port, jax = _run_board(port_retry, seed), _run_board(jax_retry, seed)
    assert port == jax
    assert port[0][-1][3] >= 1  # some target opened


def test_board_targets_are_isolated_and_stable():
    clock = [0.0]
    board = BreakerBoard(failure_threshold=1, cooldown_s=5.0, time_source=lambda: clock[0])
    board.for_target("bad").on_failure()
    board.for_target("good").on_success()
    assert board.for_target("good") is board.for_target("good")
    assert board.targets() == {"bad": BreakerState.OPEN, "good": BreakerState.CLOSED}
    assert (board.open_count(), board.known_count()) == (1, 2)


# ------------------------------------------------------- call_with_retry
class _Flaky:
    """A call whose outcome per invocation comes from a seeded script."""

    KINDS = ("ok", "retryable", "retryable", "healthy", "terminal", "deadline")

    def __init__(self, seed: int, retry, deadline, storage_exc, key_exc):
        self._rng = random.Random(seed)
        self._retry, self._deadline = retry, deadline
        self._storage_exc, self._key_exc = storage_exc, key_exc
        self.calls = 0

    def __call__(self):
        self.calls += 1
        kind = self._rng.choice(self.KINDS)
        if kind == "ok":
            return f"ok-{self.calls}"
        if kind == "retryable":
            raise self._storage_exc(f"flap {self.calls}")
        if kind == "healthy":
            raise self._key_exc(f"missing {self.calls}")
        if kind == "terminal":
            raise ValueError(f"bad request {self.calls}")
        raise self._deadline.DeadlineExceededException(f"late {self.calls}")


def _run_calls(package: str, seed: int) -> dict:
    retry, deadline = PACKAGES[package][:2]
    storage_exc = retry.StorageBackendException
    clock = [0.0]
    breaker = retry.CircuitBreaker(3, 2.0, time_source=lambda: clock[0])
    policy = retry.RetryPolicy(
        max_attempts=4, base_backoff_s=0.01, max_backoff_s=0.5,
        retryable=(storage_exc,), terminal=(ValueError,), healthy=(KeyError,),
    )
    ledger = retry.RetryLedger()
    rng = random.Random(seed + 100)
    fn = _Flaky(seed, retry, deadline, storage_exc, KeyError)
    sleeps, observed, outcomes = [], [], []
    gate_rng = random.Random(seed + 200)
    for _ in range(40):
        clock[0] += 0.5
        try:
            result = retry.call_with_retry(
                fn, policy=policy, site="storage.fetch", breaker=breaker,
                retry_gate=lambda: gate_rng.random() < 0.8,
                on_retry=lambda a, d, e: observed.append((a, d, type(e).__name__, str(e))),
                rng=rng, sleep=sleeps.append, ledger=ledger,
            )
            outcomes.append(("ok", result))
        except BaseException as e:  # noqa: BLE001 — the outcome is the datum
            outcomes.append((type(e).__name__, str(e)))
        outcomes.append((breaker.state.name, breaker.opens, breaker.fast_fails))
    return {"outcomes": outcomes, "calls": fn.calls, "sleeps": sleeps,
            "observed": observed, "ledger": ledger.snapshot(),
            "amplification": ledger.amplification("storage.fetch")}


@pytest.mark.parametrize("seed", SEEDS)
def test_call_with_retry_with_a_breaker_equals_jax(seed):
    port, jax = _run_calls("port", seed), _run_calls("jax", seed)
    assert port == jax
    names = {o[0] for o in port["outcomes"]}
    assert "CircuitOpenException" in names and "ok" in names


def test_retry_loop_cannot_outrun_an_opening_breaker():
    clock = [0.0]
    breaker = CircuitBreaker(2, 10.0, time_source=lambda: clock[0])
    calls = []

    def always_fails():
        calls.append(1)
        raise port_retry.StorageBackendException("down")

    with pytest.raises(CircuitOpenException):
        port_retry.call_with_retry(
            always_fails, policy=RetryPolicy(max_attempts=5, base_backoff_s=0.001,
                                             max_backoff_s=0.001),
            site="storage.fetch", breaker=breaker, sleep=lambda s: None,
            ledger=port_retry.RetryLedger(),
        )
    assert len(calls) == 2 and breaker.state is BreakerState.OPEN


def test_deadline_truncates_retries_in_both_packages():
    """A backoff that does not fit the ambient deadline is a give-up, not a
    sleep; the breaker counts the failure, the ledger the give-up."""
    for package in ("port", "jax"):
        retry, deadline = PACKAGES[package][:2]
        ledger = retry.RetryLedger()
        breaker = retry.CircuitBreaker(5, 1.0)

        def fails():
            raise retry.StorageBackendException("down")

        with deadline.deadline_scope(deadline.Deadline.after(0.0005)):
            with pytest.raises(retry.StorageBackendException):
                retry.call_with_retry(
                    fails, policy=retry.RetryPolicy(base_backoff_s=0.01, max_backoff_s=0.02),
                    site="s", breaker=breaker, sleep=lambda s: pytest.fail("slept"),
                    ledger=ledger,
                )
        assert ledger.snapshot()["s"] == {"attempts": 1.0, "retries": 0.0,
                                          "giveups": 1.0, "backoff_ms": 0.0}


def test_ledger_on_backoff_hook_and_failures():
    led = port_retry.RetryLedger()
    seen = []
    led.on_backoff = seen.append
    led.note_retry("s", 0.5)
    assert seen == [pytest.approx(500.0)]
    led.on_backoff = lambda ms: (_ for _ in ()).throw(RuntimeError("x"))
    led.note_retry("s", 0.5)
    assert led.value("s", "retries") == 2.0 and led.observer_failures == 1


# -------------------------------------------------------- retry-metrics
def _registered(package: str) -> dict:
    retry, _, core, retry_metrics, faults = PACKAGES[package]
    clock = [0.0]
    breaker = retry.CircuitBreaker(2, 5.0, time_source=lambda: clock[0])
    board = retry.BreakerBoard(failure_threshold=1, cooldown_s=5.0, time_source=lambda: clock[0])
    ledger = retry.RetryLedger()
    registry = core.MetricsRegistry()
    retry_metrics.register_retry_metrics(
        registry, ledger=ledger, breakers={"storage": breaker}, boards={"peer": board},
    )
    for site, n in (("storage.fetch", 5), ("storage.upload", 2), ("device.launch", 1)):
        for _ in range(n):
            ledger.note_attempt(site)
    ledger.note_retry("storage.fetch", 0.004)
    ledger.note_retry("storage.fetch", 0.25)
    ledger.note_giveup("storage.fetch")
    breaker.on_failure()
    breaker.on_failure()
    for _ in range(3):
        with pytest.raises(retry.CircuitOpenException):
            breaker.acquire()
    clock[0] += 5.0
    breaker.acquire()
    breaker.on_success()
    board.for_target("x").on_failure()
    board.for_target("y").on_success()
    values = {str(name): registry.value(name) for name in registry.metric_names}
    descriptions = {str(name): name.description for name in registry.metric_names}
    return {"values": values, "descriptions": descriptions, "faults": faults}


def test_retry_metrics_gauges_equal_jax():
    port, jax = _registered("port"), _registered("jax")
    assert port["descriptions"].keys() == jax["descriptions"].keys()
    # The fault-plane gauges read each package's own process-wide plane.
    plane_gauges = ("retry-metrics:faults-armed", "retry-metrics:faults-seam-calls-total",
                    "retry-metrics:faults-injections-total")
    for got in (port, jax):
        armed = got["faults"].enabled()
        assert got["values"].pop(plane_gauges[0]) == (1.0 if armed else 0.0)
        snap = got["faults"].plane().snapshot() if armed else None
        assert got["values"].pop(plane_gauges[1]) == (
            float(sum(snap["calls"].values())) if armed else 0.0)
        assert got["values"].pop(plane_gauges[2]) == (float(snap["injections"]) if armed else 0.0)
    assert port["values"] == jax["values"]
    values = port["values"]
    assert values["retry-metrics:retry-storage-fetch-attempts-total"] == 5.0
    assert values["retry-metrics:retry-storage-fetch-amplification"] == pytest.approx(5.0 / 3.0)
    assert values["retry-metrics:breaker-storage-opens-total"] == 1.0
    assert values["retry-metrics:breaker-storage-fast-fails-total"] == 3.0
    assert values["retry-metrics:breaker-storage-state"] == 0.0
    assert values["retry-metrics:breaker-board-peer-open"] == 1.0
    assert values["retry-metrics:breaker-board-peer-known"] == 2.0
    assert values["retry-metrics:retry-backoff-time-ms"] == 2.0  # the count of backoffs


# ------------------------------------------------------------------ locks
LOCK_NAMES = {
    "retry.CircuitBreaker._lock": lambda: CircuitBreaker()._lock,
    "retry.BreakerBoard._lock": lambda: BreakerBoard()._lock,
    "retry.RetryLedger._lock": lambda: port_retry.RetryLedger()._lock,
    "resilient.RetryBudget._lock": lambda: _resilient().RetryBudget(10)._lock,
    "hedge.HedgeBudget._lock": lambda: _hedge().HedgeBudget(10)._lock,
    "hedge.Hedger._lock": lambda: _closed_hedger()._lock,
    "admission.AdmissionController._cond": lambda: _admission()._cond._lock,
    "slo.SloEngine._lock": lambda: _slo_engine()._lock,
}


def _resilient():
    from tieredstorage_tpu_torch.storage import resilient

    return resilient


def _hedge():
    from tieredstorage_tpu_torch.fetch import hedge

    return hedge


def _closed_hedger():
    hedge = _hedge()
    hedger = hedge.Hedger(lambda: 0.01, hedge.HedgeBudget(10))
    hedger.close()
    return hedger


def _admission():
    from tieredstorage_tpu_torch.utils.admission import AdmissionController

    return AdmissionController(1, 0)


def _slo_engine():
    from tieredstorage_tpu_torch.metrics.slo import RatioSource, SloEngine, SloSpec

    return SloEngine([SloSpec("s", "d", 0.9, RatioSource(lambda: 1.0, lambda: 1.0))])


@pytest.mark.parametrize("name", sorted(LOCK_NAMES))
def test_new_locks_are_witnessed_under_the_jax_names(monkeypatch, name):
    monkeypatch.setenv(locks.ENV_FLAG, "1")
    lock = LOCK_NAMES[name]()
    assert isinstance(lock, locks._WitnessedLock)
    assert lock.name == name


def test_deadline_counter_lock_is_witnessed(monkeypatch):
    """The module-level lock is made at import: load a fresh copy of the
    module under the flag."""
    monkeypatch.setenv(locks.ENV_FLAG, "1")
    spec = importlib.util.spec_from_file_location("_deadline_copy", port_deadline.__file__)
    copy = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "_deadline_copy", copy)
    spec.loader.exec_module(copy)
    assert isinstance(copy._exceeded_lock, locks._WitnessedLock)
    assert copy._exceeded_lock.name == "deadline._exceeded_lock"
