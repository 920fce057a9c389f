"""Typed retry policy and the one retry loop.

Counterpart of tieredstorage_tpu/utils/retry.py, policy half: `Outcome`,
`RetryPolicy` (attempt cap, decorrelated-jitter backoff, error
classification), the process `RetryLedger` and `call_with_retry`. The
circuit breakers (`CircuitBreaker`, `BreakerBoard`) belong to the
failure-policy plane, which is not yet ported; `call_with_retry` keeps its
`breaker` / `retry_gate` parameters, and callers pass None. The flight
recorder and the retry-metrics observer are not ported either, so attempts
land in the ledger only.

Classification: *healthy* errors are contract answers from a live target
(never retried); `DeadlineExceededException` is caller impatience (never
retried); *terminal* errors indict the call (never retried); everything
retryable may get another attempt while the cap, the optional `retry_gate`
and the ambient deadline allow.
"""

from __future__ import annotations

import dataclasses
import enum
import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple, Type, TypeVar

from tieredstorage_tpu_torch.storage.core import StorageBackendException
from tieredstorage_tpu_torch.utils.deadline import DeadlineExceededException, remaining_s

_T = TypeVar("_T")

#: Process-default jitter source. Seams that need reproducible schedules
#: (tests) pass their own seeded ``random.Random``.
_RNG = random.Random()


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
    """Process-wide per-site retry accounting.

    Sites are dotted seam names (``device.launch``). Per site: total
    attempts, retries (attempts beyond a call's first), give-ups (calls
    that exhausted the policy), and cumulative backoff ms. Amplification
    per site is ``attempts / (attempts - retries)``.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sites: Dict[str, Dict[str, float]] = {}

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

    def note_retry(self, site: str, delay_s: float) -> None:
        with self._lock:
            rec = self._rec(site)
            rec["retries"] += 1.0
            rec["backoff_ms"] += delay_s * 1000.0

    def note_giveup(self, site: str) -> None:
        with self._lock:
            self._rec(site)["giveups"] += 1.0

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


def call_with_retry(
    fn: Callable[[], _T],
    *,
    policy: RetryPolicy,
    site: str,
    breaker=None,
    retry_gate: Optional[Callable[[], bool]] = None,
    on_retry: Optional[Callable[[int, float, BaseException], None]] = None,
    rng: Optional[random.Random] = None,
    sleep: Callable[[float], None] = time.sleep,
    ledger: Optional[RetryLedger] = None,
) -> _T:
    """The one retry loop.

    Per attempt: breaker gate → ``fn()`` → classify. Retries happen only
    while the attempt cap, the optional ``retry_gate`` and the ambient
    deadline all allow — an attempt is NEVER scheduled past the deadline;
    the original error is re-raised instead of sleeping into certain doom.
    ``breaker`` is any object with ``acquire`` / ``on_success`` /
    ``on_neutral`` / ``on_failure`` (None here until the breakers are
    ported). Attempts and backoffs land in the ledger, keyed by site.
    """
    led = ledger if ledger is not None else _LEDGER
    jitter = rng if rng is not None else _RNG
    prev_delay: Optional[float] = None
    attempt = 0
    while True:
        attempt += 1
        if breaker is not None:
            breaker.acquire()
        led.note_attempt(site)
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
            if on_retry is not None:
                on_retry(attempt, delay, exc)
            sleep(delay)
            continue
        if breaker is not None:
            breaker.on_success()
        return result
