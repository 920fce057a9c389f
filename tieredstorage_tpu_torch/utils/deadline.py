"""End-to-end request deadlines: one absolute budget for the whole call tree.

Counterpart of tieredstorage_tpu/utils/deadline.py, whole. A broker fetch
that has already burned its patience in the chunk cache must not get a full
fresh timeout at the storage read, so the slowest requests are not the ones
that hold resources the longest (Dean & Barroso, "The Tail at Scale", CACM
2013): the entry point fixes an absolute budget, every layer below clamps its
own waiting to what is left, and an expired budget fails *before* touching
storage.

- a ``Deadline`` is an absolute point on the monotonic clock, created at the
  RSM entry (``deadline.default.ms``, through ``ensure_deadline``) or adopted
  from the caller;
- it propagates through a thread-local scope (``deadline_scope`` /
  ``current_deadline``) so the storage transport and the chunk path consume
  it without plumbing an argument through every signature;
- across a process boundary it travels as *remaining milliseconds*
  (``header_value`` / ``parse_deadline_ms``, the ``x-deadline-ms`` header):
  absolute monotonic time is process-local, so the wire carries the budget,
  not the instant — the scheme gRPC itself uses;
- expired deadlines raise ``DeadlineExceededException`` — a distinct type so
  a boundary can map it to 504 / ``DEADLINE_EXCEEDED`` and the circuit
  breaker treats it as caller impatience rather than backend failure.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Iterator, Optional

from tieredstorage_tpu_torch.storage.core import StorageBackendException
from tieredstorage_tpu_torch.utils.locks import new_lock

#: Header / metadata key carrying the remaining budget in integer
#: milliseconds (the deadline twin of the ``traceparent`` key).
DEADLINE_HEADER = "x-deadline-ms"

_local = threading.local()
_exceeded_lock = new_lock("deadline._exceeded_lock")
_exceeded_total = 0


class DeadlineExceededException(StorageBackendException):
    """The end-to-end deadline expired: the request fails fast, before (or
    instead of) another storage read. Subclasses StorageBackendException so
    it propagates through the storage stack, but stays distinct so a
    boundary maps it to 504 / DEADLINE_EXCEEDED and the circuit breaker does
    not count caller impatience as a backend failure."""

    def __init__(self, message: str):
        super().__init__(message)
        global _exceeded_total
        with _exceeded_lock:
            _exceeded_total += 1


def exceeded_total() -> int:
    """Process-wide count of DeadlineExceededException raises (exported as
    the `deadline-exceeded-total` resilience gauge)."""
    with _exceeded_lock:
        return _exceeded_total


@dataclasses.dataclass(frozen=True)
class Deadline:
    """An absolute point on the monotonic clock."""

    at_monotonic: float

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + seconds)

    @classmethod
    def after_ms(cls, ms: float) -> "Deadline":
        return cls.after(ms / 1000.0)

    def remaining_s(self) -> float:
        return self.at_monotonic - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.remaining_s() <= 0.0

    def header_value(self) -> str:
        """Remaining budget as the wire form (integer ms, floored at 0)."""
        return str(max(0, int(math.ceil(self.remaining_s() * 1000.0))))


def parse_deadline_ms(value: Optional[str]) -> Optional[Deadline]:
    """A ``Deadline`` from an ``x-deadline-ms`` wire value, or None.

    Strict ASCII-digit grammar (int() alone accepts '+5', '1_0' and
    non-ASCII digits); malformed values are ignored — deadline propagation
    must never fail a request. '0' parses to an already-expired deadline
    (the fast-fail path)."""
    if value is None:
        return None
    text = value.strip()
    if not text or not all(c in "0123456789" for c in text):
        return None
    return Deadline.after_ms(int(text))


def current_deadline() -> Optional[Deadline]:
    return getattr(_local, "deadline", None)


def remaining_s() -> Optional[float]:
    """Remaining budget of the ambient deadline, or None when unconstrained."""
    deadline = current_deadline()
    return None if deadline is None else deadline.remaining_s()


@contextlib.contextmanager
def deadline_scope(deadline: Optional[Deadline]) -> Iterator[Optional[Deadline]]:
    """Install `deadline` as the ambient deadline for the block.

    A nested scope can only tighten: the effective deadline is the minimum of
    the new and any enclosing one (a sub-operation must not outlive its
    parent's budget). `None` is a no-op (keeps the enclosing scope)."""
    prior = current_deadline()
    if deadline is None:
        yield prior
        return
    effective = (
        deadline
        if prior is None or deadline.at_monotonic < prior.at_monotonic
        else prior
    )
    _local.deadline = effective
    try:
        yield effective
    finally:
        _local.deadline = prior


@contextlib.contextmanager
def ensure_deadline(default_s: Optional[float]) -> Iterator[Optional[Deadline]]:
    """Entry-point helper: adopt the ambient deadline if one exists, else
    install a fresh one of `default_s` (None ⇒ unconstrained). The caller's
    explicit deadline always wins over the configured default."""
    if default_s is None or current_deadline() is not None:
        yield current_deadline()
        return
    with deadline_scope(Deadline.after(default_s)) as d:
        yield d


def check_deadline(what: str) -> None:
    """Fail fast when the ambient deadline has expired — called at layer
    entries so a doomed request never reaches storage."""
    deadline = current_deadline()
    if deadline is not None and deadline.expired:
        raise DeadlineExceededException(
            f"Deadline exceeded before {what} "
            f"(over budget by {-deadline.remaining_s() * 1000.0:.0f} ms)"
        )
