"""Typed retry policy, the one retry loop and the circuit breakers.

Counterpart of tieredstorage_tpu/utils/retry.py, whole. Retries without a
shared policy *amplify* outages instead of absorbing them ("Overload Control
for Scaling WeChat Microservices", SOSP 2018; Dean & Barroso, "The Tail at
Scale", CACM 2013), so this module is the single owner of backoff:

- ``RetryPolicy`` — a typed, frozen policy: attempt cap, exponential backoff
  with *decorrelated jitter* (each sleep is uniform(base, prev*3), capped),
  and error classification (retryable / terminal / healthy-contract-answer /
  neutral).
- ``call_with_retry`` — the one retry loop every seam uses. It is
  *deadline-aware*: an attempt is never scheduled past the ambient request
  deadline (utils/deadline), so a doomed request sheds instead of sleeping.
  Every attempt and backoff lands in the process ``RetryLedger`` (exported
  by the ``retry-metrics`` group, metrics/retry_metrics.py) and on the
  ambient flight record (``retry.attempts``, ``retry.backoff_ms``).
- ``CircuitBreaker`` — closed → open → half-open with single-probe
  admission (storage/resilient.py re-exports it); ``BreakerBoard`` keys
  breakers per target so one bad target cannot open the breaker for the
  healthy rest.

Classification semantics shared by every seam: *healthy* errors are
contract answers from a live target (404, invalid range) — breaker success,
never retried; ``DeadlineExceededException`` is caller impatience — breaker
neutral, never retried; *terminal* errors indict the call, not the target's
availability — breaker failure, never retried; everything retryable is
breaker failure and eligible for another attempt while the cap, the
optional ``retry_gate`` (storage's token-bucket RetryBudget) and the
deadline allow.
"""

from __future__ import annotations

import dataclasses
import enum
import random
import time
from typing import Callable, Dict, Optional, Tuple, Type, TypeVar

from tieredstorage_tpu_torch.storage.core import StorageBackendException
from tieredstorage_tpu_torch.utils import flightrecorder as flight
from tieredstorage_tpu_torch.utils.deadline import DeadlineExceededException, remaining_s
from tieredstorage_tpu_torch.utils.locks import new_lock, note_mutation

_T = TypeVar("_T")

#: Process-default jitter source. Seams that need reproducible schedules
#: (tests) pass their own seeded ``random.Random``.
_RNG = random.Random()


class BreakerState(enum.Enum):
    CLOSED = 0
    HALF_OPEN = 1
    OPEN = 2


class CircuitOpenException(StorageBackendException):
    """Fast-fail: the breaker is open and the call never reached the target."""


class Outcome(enum.Enum):
    """How a raised exception is treated by policy + breaker accounting."""

    RETRYABLE = "retryable"  # breaker failure; another attempt may follow
    TERMINAL = "terminal"  # breaker failure; re-raised immediately
    HEALTHY = "healthy"  # contract answer from a live target; breaker success
    NEUTRAL = "neutral"  # proves nothing (deadline, interrupt); breaker neutral
    FAST_FAIL = "fast_fail"  # a nested breaker refused; no accounting here


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Typed retry policy: attempt cap + decorrelated-jitter backoff +
    exception classification. Frozen so a policy can be shared across
    threads and seams without defensive copies."""

    max_attempts: int = 3
    base_backoff_s: float = 0.01
    max_backoff_s: float = 1.0
    #: Exception types eligible for another attempt (breaker failures).
    retryable: Tuple[Type[BaseException], ...] = (StorageBackendException,)
    #: Never retried even if also retryable (checked first): the call is
    #: indicted, not the target's availability.
    terminal: Tuple[Type[BaseException], ...] = ()
    #: Contract answers from a healthy target (404, invalid range): breaker
    #: success, re-raised without retry.
    healthy: Tuple[Type[BaseException], ...] = ()
    #: Neither proves nor indicts the target (beyond the always-neutral
    #: DeadlineExceededException): breaker neutral, re-raised.
    neutral: Tuple[Type[BaseException], ...] = ()

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.base_backoff_s < 0.0:
            raise ValueError("base_backoff_s must be >= 0")
        if self.max_backoff_s < self.base_backoff_s:
            raise ValueError("max_backoff_s must be >= base_backoff_s")

    def single(self) -> "RetryPolicy":
        """This policy with retries disabled (e.g. non-replayable uploads:
        the first attempt consumes the stream)."""
        return dataclasses.replace(self, max_attempts=1)

    def classify(self, exc: BaseException) -> Outcome:
        """Map a raised exception to its policy outcome. Precedence:
        fast-fail > healthy > neutral > terminal > retryable > terminal."""
        if not isinstance(exc, Exception):
            return Outcome.NEUTRAL  # KeyboardInterrupt/SystemExit: hands off
        if isinstance(exc, CircuitOpenException):
            return Outcome.FAST_FAIL
        if self.healthy and isinstance(exc, self.healthy):
            return Outcome.HEALTHY
        if isinstance(exc, DeadlineExceededException) or (
            self.neutral and isinstance(exc, self.neutral)
        ):
            return Outcome.NEUTRAL
        if self.terminal and isinstance(exc, self.terminal):
            return Outcome.TERMINAL
        if self.retryable and isinstance(exc, self.retryable):
            return Outcome.RETRYABLE
        return Outcome.TERMINAL

    def backoff_s(self, prev_s: Optional[float], rng: random.Random) -> float:
        """Next sleep via decorrelated jitter:
        ``min(cap, uniform(base, max(base, prev*3)))``."""
        floor = self.base_backoff_s
        ceil = max(floor, (floor if prev_s is None else prev_s) * 3.0)
        return min(self.max_backoff_s, rng.uniform(floor, ceil))


class RetryLedger:
    """Process-wide per-site retry accounting (the ``retry-metrics`` source).

    Sites are dotted seam names (``storage.fetch``, ``device.launch``). Per
    site: total attempts, retries (attempts beyond a call's first), give-ups
    (calls that exhausted the policy), and cumulative backoff ms.
    Amplification per site is derivable as ``attempts / (attempts -
    retries)``.
    """

    def __init__(self) -> None:
        self._lock = new_lock("retry.RetryLedger._lock")
        self._sites: Dict[str, Dict[str, float]] = {}
        #: Optional backoff observer (the retry-metrics histogram); called
        #: OUTSIDE the ledger lock with the delay in ms.
        self.on_backoff: Optional[Callable[[float], None]] = None
        #: Observer calls that raised (swallowed — an observer must not
        #: break a retry — but the failure stays countable).
        self.observer_failures = 0

    def _rec(self, site: str) -> Dict[str, float]:
        rec = self._sites.get(site)
        if rec is None:
            rec = self._sites[site] = {
                "attempts": 0.0,
                "retries": 0.0,
                "giveups": 0.0,
                "backoff_ms": 0.0,
            }
        return rec

    def note_attempt(self, site: str) -> None:
        with self._lock:
            self._rec(site)["attempts"] += 1.0
            note_mutation("retry.RetryLedger._sites")

    def note_retry(self, site: str, delay_s: float) -> None:
        delay_ms = delay_s * 1000.0
        with self._lock:
            rec = self._rec(site)
            rec["retries"] += 1.0
            rec["backoff_ms"] += delay_ms
            note_mutation("retry.RetryLedger._sites")
            hook = self.on_backoff
        if hook is not None:
            try:
                hook(delay_ms)
            except Exception:  # noqa: BLE001 — observers must not break retries
                with self._lock:
                    self.observer_failures += 1
                    note_mutation("retry.RetryLedger.observer_failures")

    def note_giveup(self, site: str) -> None:
        with self._lock:
            self._rec(site)["giveups"] += 1.0
            note_mutation("retry.RetryLedger._sites")

    def value(self, site: str, field: str) -> float:
        with self._lock:
            rec = self._sites.get(site)
            return 0.0 if rec is None else rec.get(field, 0.0)

    def amplification(self, site: str) -> float:
        """attempts per originating call at `site` (1.0 = no retries)."""
        with self._lock:
            rec = self._sites.get(site)
            if rec is None:
                return 1.0
            calls = rec["attempts"] - rec["retries"]
            return rec["attempts"] / calls if calls > 0 else 1.0

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {site: dict(rec) for site, rec in self._sites.items()}


_LEDGER = RetryLedger()


def ledger() -> RetryLedger:
    """The process-wide ledger (one accounting plane across every seam)."""
    return _LEDGER


class CircuitBreaker:
    """Closed → open → half-open breaker with single-probe admission.

    After ``failure_threshold`` consecutive failures the breaker opens and
    ``acquire`` fails fast with CircuitOpenException (no network) until
    ``cooldown_s`` passes; then exactly ONE half-open probe is admitted —
    success closes, failure re-opens. ``on_neutral`` releases a probe slot
    without moving the state machine (caller impatience is not evidence).
    """

    def __init__(
        self,
        failure_threshold: int = 5,
        cooldown_s: float = 30.0,
        *,
        time_source: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[BreakerState, BreakerState], None]] = None,
    ) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self._threshold = failure_threshold
        self._cooldown_s = cooldown_s
        self._now = time_source
        self._on_transition = on_transition
        self._lock = new_lock("retry.CircuitBreaker._lock")
        self._state = BreakerState.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        #: Cumulative transition/fast-fail counters, exported as gauges.
        self.opens = 0
        self.half_opens = 0
        self.closes = 0
        self.fast_fails = 0
        #: Transition-observer callbacks that raised (swallowed-exception
        #: checker: a failing observer must not break the breaker, but the
        #: failure must still be countable).
        self.observer_failures = 0

    @property
    def state(self) -> BreakerState:
        with self._lock:
            return self._state

    @property
    def state_code(self) -> int:
        return self.state.value

    @property
    def refusing(self) -> bool:
        """True while acquire() would fail fast right now: open inside its
        cooldown, or half-open with the probe slot taken. A non-destructive
        peek for target *selection* — it does not admit or consume a
        probe."""
        with self._lock:
            if self._state is BreakerState.OPEN:
                return self._now() - self._opened_at < self._cooldown_s
            return self._state is BreakerState.HALF_OPEN and self._probe_in_flight

    def _transition_locked(self, new: BreakerState) -> None:
        old, self._state = self._state, new
        if old is new:
            return
        if new is BreakerState.OPEN:
            self.opens += 1
            note_mutation("retry.CircuitBreaker.opens")
        elif new is BreakerState.HALF_OPEN:
            self.half_opens += 1
            note_mutation("retry.CircuitBreaker.half_opens")
        else:
            self.closes += 1
            note_mutation("retry.CircuitBreaker.closes")
        flight.note(f"breaker.state.{new.name.lower()}")
        if self._on_transition is not None:
            try:
                self._on_transition(old, new)
            except Exception:  # noqa: BLE001 — observers must not break the breaker
                self.observer_failures += 1

    def acquire(self) -> None:
        """Gate a call; raises CircuitOpenException while open."""
        with self._lock:
            if self._state is BreakerState.OPEN:
                if self._now() - self._opened_at >= self._cooldown_s:
                    self._transition_locked(BreakerState.HALF_OPEN)
                else:
                    self.fast_fails += 1
                    note_mutation("retry.CircuitBreaker.fast_fails")
                    raise CircuitOpenException(
                        f"Circuit breaker open ({self._consecutive_failures} "
                        "consecutive failures); failing fast"
                    )
            if self._state is BreakerState.HALF_OPEN:
                if self._probe_in_flight:
                    self.fast_fails += 1
                    note_mutation("retry.CircuitBreaker.fast_fails")
                    raise CircuitOpenException(
                        "Circuit breaker half-open; probe already in flight"
                    )
                self._probe_in_flight = True

    def on_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            self._probe_in_flight = False
            self._transition_locked(BreakerState.CLOSED)

    def on_neutral(self) -> None:
        """The call neither proves nor indicts the target (e.g. the caller's
        deadline expired client-side): release a half-open probe slot without
        moving the state machine either way."""
        with self._lock:
            self._probe_in_flight = False

    def on_failure(self) -> None:
        with self._lock:
            self._consecutive_failures += 1
            was_probe = self._probe_in_flight
            self._probe_in_flight = False
            if was_probe or self._consecutive_failures >= self._threshold:
                self._opened_at = self._now()
                self._transition_locked(BreakerState.OPEN)


class BreakerBoard:
    """Per-target circuit breakers sharing one policy configuration.

    One bad target must not open the breaker for the healthy rest, so a
    caller that talks to many targets keys a breaker per target, created
    lazily here. Transition totals are aggregated across targets for the
    ``retry-metrics`` gauges.

    Lock order: a breaker's transition observer increments the board
    counters, so the only cross-lock edge is CircuitBreaker._lock →
    BreakerBoard._lock; board methods never touch a breaker's lock while
    holding their own (state reads snapshot the breaker list first).
    """

    def __init__(
        self,
        failure_threshold: int = 5,
        cooldown_s: float = 30.0,
        *,
        time_source: Callable[[], float] = time.monotonic,
        on_transition: Optional[
            Callable[[str, BreakerState, BreakerState], None]
        ] = None,
    ) -> None:
        self._threshold = failure_threshold
        self._cooldown_s = cooldown_s
        self._now = time_source
        self._observer = on_transition
        self._lock = new_lock("retry.BreakerBoard._lock")
        self._breakers: Dict[str, CircuitBreaker] = {}
        #: Aggregated transition totals across all targets.
        self.opened = 0
        self.half_opened = 0
        self.closed = 0

    def _on_transition(self, target: str, old: BreakerState, new: BreakerState) -> None:
        with self._lock:
            if new is BreakerState.OPEN:
                self.opened += 1
                note_mutation("retry.BreakerBoard.opened")
            elif new is BreakerState.HALF_OPEN:
                self.half_opened += 1
                note_mutation("retry.BreakerBoard.half_opened")
            else:
                self.closed += 1
                note_mutation("retry.BreakerBoard.closed")
        if self._observer is not None:
            self._observer(target, old, new)

    def for_target(self, target: str) -> CircuitBreaker:
        with self._lock:
            breaker = self._breakers.get(target)
            if breaker is None:
                breaker = CircuitBreaker(
                    self._threshold,
                    self._cooldown_s,
                    time_source=self._now,
                    on_transition=lambda old, new, t=target: self._on_transition(
                        t, old, new
                    ),
                )
                self._breakers[target] = breaker
                note_mutation("retry.BreakerBoard._breakers")
            return breaker

    def _snapshot(self) -> Dict[str, CircuitBreaker]:
        with self._lock:
            return dict(self._breakers)

    def targets(self) -> Dict[str, BreakerState]:
        return {t: b.state for t, b in self._snapshot().items()}

    def open_count(self) -> int:
        """Targets currently refusing calls."""
        return sum(1 for b in self._snapshot().values() if b.refusing)

    def known_count(self) -> int:
        with self._lock:
            return len(self._breakers)


def call_with_retry(
    fn: Callable[[], _T],
    *,
    policy: RetryPolicy,
    site: str,
    breaker: Optional[CircuitBreaker] = None,
    retry_gate: Optional[Callable[[], bool]] = None,
    on_retry: Optional[Callable[[int, float, BaseException], None]] = None,
    rng: Optional[random.Random] = None,
    sleep: Callable[[float], None] = time.sleep,
    ledger: Optional[RetryLedger] = None,
) -> _T:
    """The one retry loop every I/O seam uses.

    Per attempt: breaker gate → ``fn()`` → classify. Retries happen only
    while the attempt cap, the optional ``retry_gate`` (storage's shared
    RetryBudget: retries are an *earned* resource) and the ambient deadline
    all allow — an attempt is NEVER scheduled past the deadline; the
    original error is re-raised instead of sleeping into certain doom.
    Each retry re-takes the breaker gate, so a retry loop cannot bypass an
    opening breaker. Attempts/backoffs land in the ledger (site-keyed) and
    on the ambient flight record.
    """
    led = ledger if ledger is not None else _LEDGER
    jitter = rng if rng is not None else _RNG
    prev_delay: Optional[float] = None
    attempt = 0
    while True:
        attempt += 1
        if breaker is not None:
            try:
                breaker.acquire()
            except CircuitOpenException:
                flight.note("breaker.fast_fail")
                raise
        led.note_attempt(site)
        flight.note("retry.attempts")
        try:
            result = fn()
        except BaseException as exc:
            outcome = policy.classify(exc)
            if breaker is not None:
                if outcome is Outcome.HEALTHY:
                    breaker.on_success()
                elif outcome in (Outcome.NEUTRAL, Outcome.FAST_FAIL):
                    breaker.on_neutral()
                else:
                    breaker.on_failure()
            if outcome is not Outcome.RETRYABLE:
                raise
            if attempt >= policy.max_attempts:
                led.note_giveup(site)
                raise
            if retry_gate is not None and not retry_gate():
                led.note_giveup(site)
                raise
            delay = policy.backoff_s(prev_delay, jitter)
            prev_delay = delay
            budget = remaining_s()
            if budget is not None and delay >= budget:
                led.note_giveup(site)
                raise  # the deadline can't fit the backoff + another attempt
            led.note_retry(site, delay)
            flight.note("retry.backoff_ms", delay * 1000.0)
            if on_retry is not None:
                on_retry(attempt, delay, exc)
            sleep(delay)
            continue
        if breaker is not None:
            breaker.on_success()
        return result
