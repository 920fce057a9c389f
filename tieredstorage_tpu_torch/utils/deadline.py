"""End-to-end request deadlines: one absolute budget for the whole call tree.

Counterpart of tieredstorage_tpu/utils/deadline.py, cut to what the fetch
path reads: the `Deadline`, its thread-local scope, and the checks the chunk
cache and the chunk manager make. The RSM key `deadline.default.ms` and the
sidecar's wire form of a deadline are not yet ported, so in this package a
deadline comes only from a caller's `deadline_scope`.

A broker fetch that has already burned its patience in the chunk cache must
not get a full fresh timeout at the storage read, so the slowest requests are
not the ones that hold resources the longest (Dean & Barroso, "The Tail at
Scale", CACM 2013): the entry point fixes an absolute budget, every layer
below clamps its own waiting to what is left, and an expired budget fails
*before* touching storage.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Iterator, Optional

from tieredstorage_tpu_torch.storage.core import StorageBackendException

_local = threading.local()
_exceeded_lock = threading.Lock()
_exceeded_total = 0


class DeadlineExceededException(StorageBackendException):
    """The end-to-end deadline expired: the request fails fast, before (or
    instead of) another storage read. Subclasses StorageBackendException so
    it propagates through the storage stack, but stays distinct so callers
    can tell caller impatience from a backend failure."""

    def __init__(self, message: str):
        super().__init__(message)
        global _exceeded_total
        with _exceeded_lock:
            _exceeded_total += 1


def exceeded_total() -> int:
    """Process-wide count of DeadlineExceededException raises."""
    with _exceeded_lock:
        return _exceeded_total


@dataclasses.dataclass(frozen=True)
class Deadline:
    """An absolute point on the monotonic clock."""

    at_monotonic: float

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + seconds)

    def remaining_s(self) -> float:
        return self.at_monotonic - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.remaining_s() <= 0.0


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


def check_deadline(what: str) -> None:
    """Fail fast when the ambient deadline has expired — called at layer
    entries so a doomed request never reaches storage."""
    deadline = current_deadline()
    if deadline is not None and deadline.expired:
        raise DeadlineExceededException(
            f"Deadline exceeded before {what} "
            f"(over budget by {-deadline.remaining_s() * 1000.0:.0f} ms)"
        )
