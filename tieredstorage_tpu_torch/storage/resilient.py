"""Per-backend circuit breaker + retry budget: fail fast, retry bounded.

Counterpart of tieredstorage_tpu/storage/resilient.py. The HTTP transport
already retries transient 5xx/429 with jittered backoff
(storage/httpclient.py); this layer sits above it and contains *sustained*
backend outages two ways:

- **Circuit breaker**: after `breaker.failure.threshold` consecutive
  StorageBackendExceptions the breaker opens and every call fails
  immediately with CircuitOpenException (no request), until a
  `breaker.cooldown.ms` period passes and a single half-open probe is
  allowed through — success closes the breaker, failure re-opens it.
  KeyNotFoundException / InvalidRangeException are contract responses from
  a healthy backend and count as successes. The state machine lives in the
  policy plane (utils/retry.py) and is re-exported here; this module keeps
  the storage-specific wiring.
- **Retry budget** (`retry.budget.*`): a token bucket that earns a fraction
  of a token per *successful* call and spends one whole token per retry, so
  the retry amplification factor is capped at 1 + percent/100 (plus a fixed
  initial allowance). Unbounded per-call retry policies multiply: during an
  outage every caller retries, turning a backend brownout into a
  self-sustaining retry storm ("Overload Control for Scaling WeChat
  Microservices", SOSP 2018). A budget makes retries a *shared, earned*
  resource: when nothing succeeds, the bucket drains and the layer degrades
  to single attempts — which is what lets the breaker see the true failure
  rate and open.

The retry loop itself is `utils.retry.call_with_retry` with a typed
`RetryPolicy` — backoff, deadline-aware scheduling, and ledger/flight
accounting are owned there. The budget plugs in as the loop's
`retry_gate`.

Both are wired by the RSM behind `breaker.enabled` / `retry.budget.enabled`
(config/rsm_config.py), above the fault-injecting backend; state and
counters are exported as gauges (metrics/rsm_metrics.register_resilience_metrics
and metrics/retry_metrics.py) and transitions are recorded as tracer events.
"""

from __future__ import annotations

from typing import BinaryIO, Mapping, Optional

from tieredstorage_tpu_torch.storage.core import (
    BytesRange,
    InvalidRangeException,
    KeyNotFoundException,
    ObjectKey,
    StorageBackend,
    StorageBackendException,
)
from tieredstorage_tpu_torch.utils.locks import new_lock
from tieredstorage_tpu_torch.utils.retry import (  # noqa: F401 — re-exported compat names
    BreakerState,
    CircuitBreaker,
    CircuitOpenException,
    RetryPolicy,
    call_with_retry,
)


class RetryBudget:
    """Token bucket capping retry amplification across the whole backend.

    Earns ``percent/100`` tokens per successful call (capped at `capacity`,
    which is also the initial balance — a fixed allowance so cold starts and
    short blips can still retry), spends one token per retry. With ratio r,
    long-run retries ≤ r × successes + capacity: under a sustained 100%
    outage the bucket drains and stays empty, so amplification converges to
    exactly 1.0 instead of `max_attempts`."""

    def __init__(self, percent: int, capacity: float = 10.0) -> None:
        if not 0 < percent <= 100:
            raise ValueError(f"retry budget percent must be in (0, 100], got {percent}")
        self._earn = percent / 100.0
        self._capacity = max(1.0, capacity)
        self._balance = self._capacity
        self._lock = new_lock("resilient.RetryBudget._lock")
        #: Retries granted / denied (exported as resilience gauges).
        self.spent = 0
        self.denied = 0

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
                self.spent += 1
                return True
            self.denied += 1
            return False


class ResilientStorageBackend(StorageBackend):
    """StorageBackend decorator: circuit breaker + budgeted retries.

    Layering per call (replay-safe ops only — upload streams are consumed by
    the first attempt and are never replayed here; the RSM's orphan cleanup
    + broker re-copy own that path): breaker gate → delegate call → on
    failure, retry only while the budget has tokens, the deadline has room
    for the backoff, and `max_attempts` isn't exhausted. Each retry re-takes
    the breaker gate, so a retry storm can never bypass an opening breaker."""

    def __init__(
        self,
        delegate: StorageBackend,
        breaker: Optional[CircuitBreaker] = None,
        *,
        retry_budget: Optional[RetryBudget] = None,
        max_attempts: int = 3,
        backoff_s: float = 0.01,
        tracer=None,
    ) -> None:
        self._delegate = delegate
        self.breaker = breaker
        self.retry_budget = retry_budget
        self._policy = RetryPolicy(
            max_attempts=max(1, max_attempts),
            base_backoff_s=backoff_s,
            max_backoff_s=max(backoff_s, backoff_s * 8.0),
            retryable=(StorageBackendException,),
            healthy=(KeyNotFoundException, InvalidRangeException),
        )
        self._single = self._policy.single()
        self._tracer = tracer

    @property
    def delegate(self) -> StorageBackend:
        return self._delegate

    def configure(self, configs: Mapping[str, object]) -> None:
        self._delegate.configure(configs)

    def _on_retry(self, attempt: int, delay_s: float, exc: BaseException) -> None:
        if self._tracer is not None:
            self._tracer.event("storage.retry", attempt=attempt)

    def _call(self, fn, *args, op: str, replayable: bool = True):
        # No budget = no retries: the budget is what makes retries a shared,
        # earned resource; without one this layer degrades to the breaker
        # gate plus single attempts.
        retryable = replayable and self.retry_budget is not None
        policy = self._policy if retryable else self._single
        try:
            result = call_with_retry(
                lambda: fn(*args),
                policy=policy,
                site=f"storage.{op}",
                breaker=self.breaker,
                retry_gate=self.retry_budget.try_spend if retryable else None,
                on_retry=self._on_retry,
            )
        except (KeyNotFoundException, InvalidRangeException):
            if self.retry_budget is not None:
                self.retry_budget.deposit()  # contract answer = healthy
            raise
        if self.retry_budget is not None:
            self.retry_budget.deposit()
        return result

    def upload(self, input_stream: BinaryIO, key: ObjectKey) -> int:
        # Not replayable: the first attempt consumes the stream.
        return self._call(
            self._delegate.upload, input_stream, key, op="upload", replayable=False
        )

    def fetch(self, key: ObjectKey, byte_range: Optional[BytesRange] = None) -> BinaryIO:
        return self._call(self._delegate.fetch, key, byte_range, op="fetch")

    def delete(self, key: ObjectKey) -> None:
        return self._call(self._delegate.delete, key, op="delete")

    def delete_all(self, keys) -> None:
        # Materialized so a budgeted replay re-deletes the same key list.
        return self._call(self._delegate.delete_all, list(keys), op="delete")

    def list_objects(self, prefix: str = ""):
        # Materialized under the breaker so mid-iteration page failures count
        # as backend failures instead of escaping the accounting.
        return iter(
            self._call(
                lambda p: list(self._delegate.list_objects(p)), prefix, op="list"
            )
        )

    def __str__(self) -> str:
        return f"ResilientStorageBackend{{delegate={self._delegate}}}"
