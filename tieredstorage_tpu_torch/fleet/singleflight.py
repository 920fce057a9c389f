"""Single-flight request coalescing: N identical in-flight calls, one execution.

Counterpart of tieredstorage_tpu/fleet/singleflight.py, whole.

Nishtala et al. ("Scaling Memcache at Facebook", NSDI '13 §3.2.1, "leases"):
under a thundering herd on a hot key, every concurrent miss issuing its own
backend read multiplies load exactly when the backend is least able to absorb
it. The cure is to elect one LEADER per key — the first caller executes the
fetch; every concurrent duplicate (local threads, or requests forwarded from
sibling instances, which land on the owner and take this same gate) blocks as
a FOLLOWER and receives the leader's result. N concurrent fetches of one hot
chunk collapse to exactly one backend read.

Failure semantics: the leader's exception propagates to every follower of
that flight (they asked the same question; they get the same answer), and the
flight slot is removed before followers wake — the NEXT caller starts a fresh
flight, so a transient failure is retryable and a slot can never leak.
Followers clamp their wait to the ambient end-to-end Deadline; a follower
timing out does not disturb the flight (the leader still completes and
populates the cache for later readers).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, TypeVar

from tieredstorage_tpu_torch.utils.deadline import (
    DeadlineExceededException,
    remaining_s,
)
from tieredstorage_tpu_torch.utils.locks import new_lock
from tieredstorage_tpu_torch.utils.tracing import NOOP_TRACER

T = TypeVar("T")


class _Flight:
    __slots__ = ("done", "result", "error")

    def __init__(self) -> None:
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class SingleFlight:
    """Per-key in-flight call registry; thread-safe, allocation-light."""

    def __init__(self, tracer=NOOP_TRACER) -> None:
        self.tracer = tracer
        self._lock = new_lock("singleflight.SingleFlight._lock")
        self._flights: dict[str, _Flight] = {}
        #: Calls that executed the work (one per flight).
        self.leaders = 0
        #: Calls that joined an existing flight instead of executing.
        self.coalesced = 0
        #: Flights that completed with an error (propagated to all joiners).
        self.failures = 0

    @property
    def pending(self) -> int:
        """In-flight keys right now (0 when idle — leaked slots would show
        here, which is what the hedge-interaction tests pin)."""
        with self._lock:
            return len(self._flights)

    def do(self, key: str, fn: Callable[[], T], *, what: str = "") -> T:
        """Run `fn` once per concurrently-requested `key`.

        The first caller for a key executes `fn` on ITS OWN thread (so the
        ambient deadline/trace context apply unchanged); concurrent callers
        with the same key wait and share the leader's result or exception."""
        with self._lock:
            flight = self._flights.get(key)
            if flight is None:
                flight = _Flight()
                self._flights[key] = flight
                leader = True
                self.leaders += 1
            else:
                leader = False
                self.coalesced += 1
        if not leader:
            self.tracer.event("fleet.coalesced", key=what or key)
            return self._await(key, flight)
        try:
            flight.result = fn()
        except BaseException as e:
            flight.error = e
            with self._lock:
                self.failures += 1
            raise
        finally:
            # Unregister BEFORE waking followers: a caller arriving after
            # completion must start a fresh flight, never read a stale one.
            with self._lock:
                self._flights.pop(key, None)
            flight.done.set()
        return flight.result

    def _await(self, key: str, flight: _Flight) -> T:
        budget = remaining_s()
        if not flight.done.wait(timeout=budget):
            raise DeadlineExceededException(
                f"Deadline exceeded waiting on coalesced fetch of {key}"
            )
        if flight.error is not None:
            raise flight.error
        return flight.result
