"""Hedged requests: a second chance for straggling backend fetches.

Counterpart of tieredstorage_tpu/fetch/hedge.py. Dean & Barroso ("The Tail
at Scale", CACM 2013 §Hedged requests): when a request has been outstanding
longer than the typical p9x latency, send the same request again and take
whichever answer lands first. The tail of the latency distribution is
dominated by rare per-request stalls (connection resets, throttled replicas)
that a fresh attempt almost never repeats, so a hedge converts a p99 stall
into roughly p50 + hedge delay — at the cost of a bounded amount of extra
load.

Two pieces keep the extra load bounded and the semantics safe:

- ``HedgeBudget``: a token bucket earning a fraction of a token per primary
  call and spending one per hedge, so hedges can never exceed the configured
  percentage of primary traffic (``hedge.budget.percent``) — under a
  systemic slowdown hedging self-limits instead of doubling the load on an
  already-struggling backend.
- first-*success*-wins: the loser is cancelled if still queued, and simply
  discarded if already running — each attempt fully reads and closes its own
  response before returning, so a discarded loser can never tear the
  winner's bytes. If the first completion failed, the other attempt's result
  is awaited; only when both fail does the last error propagate.

The hedger races the *stored* bytes only (fetch/chunk_manager.py hedges the
ranged GET of a window, not its detransform), so a window is decrypted once
on the device however many attempts fetched it. The hedge delay is a
callable so the RSM can wire the observed p95 of the
``chunk-fetch-time-ms`` histogram, with a static ``hedge.delay.ms`` until
enough samples exist.
"""

from __future__ import annotations

import concurrent.futures
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, TypeVar

from tieredstorage_tpu_torch.utils import flightrecorder as flight
from tieredstorage_tpu_torch.utils.deadline import current_deadline, deadline_scope
from tieredstorage_tpu_torch.utils.tracing import NOOP_TRACER
from tieredstorage_tpu_torch.utils.locks import new_lock

T = TypeVar("T")


class HedgeBudget:
    """Token bucket bounding hedges to a percentage of primary traffic.

    Earns ``percent/100`` tokens per primary call (capped at `capacity`),
    spends one whole token per hedge; starts with one token so the very
    first straggler can already be hedged."""

    def __init__(self, percent: int, capacity: float = 10.0) -> None:
        if not 0 < percent <= 100:
            raise ValueError(f"hedge budget percent must be in (0, 100], got {percent}")
        self._earn = percent / 100.0
        self._capacity = max(1.0, capacity)
        self._balance = 1.0
        self._lock = new_lock("hedge.HedgeBudget._lock")

    @property
    def balance(self) -> float:
        with self._lock:
            return self._balance

    def deposit(self) -> None:
        with self._lock:
            self._balance = min(self._capacity, self._balance + self._earn)

    def try_spend(self) -> bool:
        with self._lock:
            if self._balance >= 1.0:
                self._balance -= 1.0
                return True
            return False


class Hedger:
    """Runs callables with tail-latency hedging on a private thread pool.

    `delay_s` is consulted per call (so a histogram-driven delay adapts as
    traffic accumulates). Counters are plain ints exported as resilience
    gauges; `on_win` is an optional `(elapsed_ms)` hook the RSM wires to the
    hedge-win-time histogram."""

    def __init__(
        self,
        delay_s: Callable[[], float],
        budget: HedgeBudget,
        *,
        max_workers: int = 8,
        tracer=NOOP_TRACER,
        on_win: Optional[Callable[[float], None]] = None,
    ) -> None:
        self._delay_s = delay_s
        self._budget = budget
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="hedge"
        )
        self.tracer = tracer
        self.on_win = on_win
        #: Primary calls routed through the hedger.
        self.primaries = 0
        #: Hedges actually launched after the delay elapsed.
        self.launched = 0
        #: Calls won by the hedge (the primary was the straggler).
        self.wins = 0
        #: Hedges suppressed because the budget was exhausted.
        self.suppressed = 0
        self._lock = new_lock("hedge.Hedger._lock")

    @property
    def budget(self) -> HedgeBudget:
        return self._budget

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)

    def call(
        self,
        fn: Callable[[], T],
        *,
        what: str = "",
        hedge_fn: Optional[Callable[[], T]] = None,
    ) -> T:
        """Run `fn`, hedging with a second run after the delay.

        `fn` must be self-contained and replay-safe (a ranged GET that reads
        and closes its own stream) — both attempts may run to completion, and
        exactly one result is returned. The ambient Deadline and the caller's
        trace identity do NOT cross into the pool threads automatically; the
        deadline is re-installed explicitly (it must bound both attempts).

        `hedge_fn`, when given, is what the hedge runs instead of a second
        `fn` — replica-aware hedging hands the equivalent read against a
        *distinct* replica here (ReplicatedStorageBackend.read_fetchers), so
        a straggling replica is raced by a different one rather than being
        hit twice. It must return byte-identical results to `fn`."""
        with self._lock:
            self.primaries += 1
        self._budget.deposit()
        deadline = current_deadline()

        def run(attempt_fn: Callable[[], T] = fn) -> T:
            with deadline_scope(deadline):
                return attempt_fn()

        start = time.monotonic()
        primary = self._pool.submit(run)
        try:
            return primary.result(timeout=max(0.0, self._delay_s()))
        except concurrent.futures.TimeoutError:
            pass
        # Primary is straggling. Spend a hedge token, or wait it out.
        if not self._budget.try_spend():
            with self._lock:
                self.suppressed += 1
            self.tracer.event("fetch.hedge_suppressed", what=what)
            flight.note("hedge.suppressed")
            return primary.result()
        with self._lock:
            self.launched += 1
        # call() runs on the request's (record-bound) thread; only the
        # attempts ride the pool, so the notes land on the right record.
        flight.note("hedge.launched")
        distinct = hedge_fn is not None
        self.tracer.event("fetch.hedged", what=what, distinct_replica=distinct)
        hedge = self._pool.submit(run, hedge_fn) if distinct else self._pool.submit(run)
        pending = {primary, hedge}
        last_error: Optional[BaseException] = None
        while pending:
            done, pending = concurrent.futures.wait(
                pending, return_when=concurrent.futures.FIRST_COMPLETED
            )
            for future in done:
                try:
                    result = future.result()
                except BaseException as e:  # noqa: BLE001 — first SUCCESS wins
                    last_error = e
                    continue
                for loser in pending:
                    # Queued losers are cancelled; a running loser completes
                    # and its result is discarded (its stream is owned and
                    # closed inside fn, so nothing leaks or tears).
                    loser.cancel()
                if future is hedge:
                    with self._lock:
                        self.wins += 1
                    elapsed_ms = (time.monotonic() - start) * 1000.0
                    self.tracer.event("fetch.hedge_won", what=what)
                    flight.note("hedge.won")
                    if self.on_win is not None:
                        self.on_win(elapsed_ms)
                return result
        assert last_error is not None  # both attempts failed
        raise last_error
